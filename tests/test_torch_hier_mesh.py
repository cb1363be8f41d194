"""The port's hierarchical ``dp x ep x patch`` mesh, on the CPU with gloo
ranks.

* ``ep=2 x dp=2`` (4 ranks), the five schedules of
  ``tests/test_mesh_hierarchy.py``, against the reference's
  ``make_mesh(ep=2, dp=2)`` run, which a subprocess makes with 4 forced
  XLA host devices, at ``capacity_factor`` 1.25 so that per-rank capacity
  drops happen on both sides; per-rank bytes exactly.
* ``ep2 x patch2``, ``dp2 x patch2`` and ``ep2 x dp2 x patch2`` (8 ranks),
  dice + ``int8_residual`` at guidance 1.5, against the reference's
  single-device ``patch_compose=True`` run at ``patch_parallel_ndev=2``,
  drop-free (``capacity_factor`` 8).  Never against the reference's patch
  mesh, whose sharded step raises (ROADMAP C.7).
* dp-invariance: dp=2 on replica-identical batches equals dp=1 bit for
  bit, for ``load_balance_loss`` and the served-counts mean.
* ``make_mesh`` validation and layout, ``serve_continuous`` over
  ``ep2 x dp2`` (against the single-process run) and its refusal of a
  patch axis, the CLI with ``--ep 2 --dp 2``, the ring in the topology
  order of ``devices_per_host=2`` at ep=4 against blocking, and the
  two-tier latency model against the reference's.

Tolerances: TOL_F32 (rtol = atol = 1e-4) for samples; the ring against
blocking within 1e-4, the bound of ``tests/test_overlap.py``.  Time
limits: the reference subprocess 400 s, each spawn of ranks 120 s, the
CLI 180 s.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core.schedules import DiceConfig as JaxDice
from repro.launch import serve as jax_serve
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.common import sharding as shard_lib
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import plan as plan_lib
from repro_torch.core.schedules import DiceConfig, Schedule
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = jobs.STEPS
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_RING = 1e-4
REF_TIMEOUT_S = 400
RANK_TIMEOUT_S = 120
CLI_TIMEOUT_S = 180
SCHEDULES = ("sync", "displaced", "interweaved", "selective", "dice")
PATCH_MESHES = {"ep2xpatch2": dict(n=4, dp=1, patch=2),
                "dp2xpatch2": dict(n=4, dp=2, patch=2),
                "ep2xdp2xpatch2": dict(n=8, dp=2, patch=2)}

REF_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.dit_moe_xl import tiny
    from repro.core.schedules import DiceConfig, Schedule
    from repro.launch.mesh import make_mesh
    from repro.models.dit_moe import init_dit
    from repro.sampling.rectified_flow import rf_sample

    cfg = tiny().replace(num_layers=2, d_model=64, moe_d_ff=64, d_ff=256,
                         num_heads=4, num_kv_heads=4, head_dim=16,
                         patch_tokens=16, capacity_factor=1.25)
    params = init_dit(jax.random.PRNGKey(0), cfg)
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    classes = jnp.arange(8) % cfg.num_classes
    key = jax.random.PRNGKey(7)
    mesh = make_mesh(ep=2, dp=2)
    runs = {
        "sync": DiceConfig.sync_ep(),
        "displaced": DiceConfig.displaced(),
        "interweaved": DiceConfig.interweaved(),
        "selective": DiceConfig(schedule=Schedule.DICE, sync_policy="deep",
                                cond_comm=False),
        "dice": DiceConfig.dice(sync_policy="deep"),
    }
    out = {}
    for name, dcfg in runs.items():
        x, st = rf_sample(params, cfg, dcfg, num_steps=6, classes=classes,
                          key=key, guidance=1.0, mesh=mesh)
        out[name + "/samples"] = np.asarray(x)
        for s in ("dispatch_bytes", "raw_bytes", "buffer_bytes"):
            out[name + "/" + s] = np.asarray(st[s])
        out[name + "/jit_cache_size"] = np.asarray(st["jit_cache_size"])
    np.savez(sys.argv[1], **out)
""")


def _jax_cfg(cf):
    return jax_configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=cf)


def _cfg(cf):
    return configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=cf)


def _dcfg(name, overlap="blocking"):
    return {
        "sync": lambda: DiceConfig.sync_ep(overlap=overlap),
        "displaced": lambda: DiceConfig.displaced(overlap=overlap),
        "interweaved": lambda: DiceConfig.interweaved(overlap=overlap),
        "selective": lambda: DiceConfig(schedule=Schedule.DICE,
                                        sync_policy="deep", cond_comm=False,
                                        overlap=overlap),
        "dice": lambda: DiceConfig.dice(sync_policy="deep", overlap=overlap),
        "dice_int8": lambda: DiceConfig.dice(
            compress=CompressConfig("int8_residual"), overlap=overlap),
    }[name]()


@pytest.fixture(scope="module")
def jax_params():
    params = jax_init_dit(jax.random.PRNGKey(0), _jax_cfg(1.25))
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return params


@pytest.fixture(scope="module")
def tree(jax_params):
    return jax.device_get(jax_params)


@pytest.fixture(scope="module")
def inputs():
    cfg = _jax_cfg(1.25)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (8, cfg.patch_tokens, cfg.in_channels)))
    return noise, np.arange(8) % cfg.num_classes


@pytest.fixture(scope="module")
def dp_ep(tmp_path_factory, tree, inputs):
    """The reference's ep2 x dp2 runs (a subprocess) and the port's (one
    spawn of 4 gloo ranks), side by side."""
    path = tmp_path_factory.mktemp("hier_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, str(path)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        noise, classes = inputs
        runs = [(name, _cfg(1.25), _dcfg(name)) for name in SCHEDULES]
        runs += [("ring_dice", _cfg(1.25), _dcfg("dice", "ring"))]
        port, counts = mesh_lib.spawn(jobs.sample_runs, 4, dp=2,
                                      backend="gloo", device="cpu",
                                      timeout_s=RANK_TIMEOUT_S,
                                      args=(tree, runs, noise, classes))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert counts == [{k: 0 for k in counts[0]}] * 4     # plain versions
    with np.load(path) as f:
        return {k: f[k] for k in f.files}, port


@pytest.mark.parametrize("name", SCHEDULES)
def test_ep2_dp2_matches_the_reference_mesh(name, dp_ep):
    ref, port = dp_ep
    x, st, keys = port[name]
    np.testing.assert_allclose(x.numpy(), ref[f"{name}/samples"], **TOL_F32)
    for k in ("dispatch_bytes", "raw_bytes", "buffer_bytes"):
        assert st[k] == [float(b) for b in ref[f"{name}/{k}"]], k
    splan = plan_lib.compile_step_plans(_dcfg(name), 2, STEPS,
                                        experts_per_token=2)
    assert keys == [splan.num_variants] * 4 == \
        [int(ref[f"{name}/jit_cache_size"])] * 4


def test_ep2_dp2_drops_pairs_and_runs_the_ring(dp_ep):
    """Capacity drops happen per rank (the parity covers them), and the
    ring over each dp replica's ep group equals its blocking run."""
    _, port = dp_ep
    assert max(f for n in SCHEDULES for f in port[n][1]["dropped_frac"]) > 0
    x, st, _ = port["ring_dice"]
    assert float((x - port["dice"][0]).abs().max()) <= TOL_RING
    assert st["hops"] == [2] * STEPS                   # 2 (ep - 1)
    assert st["dispatch_bytes"] == port["dice"][1]["dispatch_bytes"]


@pytest.fixture(scope="module")
def patch_ref(jax_params, inputs):
    """The reference's single-device patch_compose run, the numerics
    reference of the sharded patch axis."""
    noise, classes = inputs
    x, st = jax_rf_sample(
        jax_params, _jax_cfg(8.0),
        JaxDice.dice(compress=JaxCompress("int8_residual")),
        num_steps=STEPS, classes=jnp.asarray(classes),
        key=jax.random.PRNGKey(7), guidance=1.5, patch_parallel_ndev=2,
        patch_compose=True)
    return np.asarray(x), st


@pytest.mark.parametrize("shape", sorted(PATCH_MESHES))
def test_patch_meshes_match_the_composed_simulation(shape, tree, inputs,
                                                    patch_ref):
    noise, classes = inputs
    m = PATCH_MESHES[shape]
    cfg = _cfg(8.0)
    port, counts = mesh_lib.spawn(
        jobs.sample_runs, m["n"], dp=m["dp"], patch=m["patch"],
        backend="gloo", device="cpu", timeout_s=RANK_TIMEOUT_S,
        args=(tree, [("dice_int8", cfg, _dcfg("dice_int8"))], noise,
              classes, 1.5))
    x, st, keys = port["dice_int8"]
    want, ref_st = patch_ref
    np.testing.assert_allclose(x.numpy(), want, **TOL_F32)
    splan = plan_lib.compile_step_plans(_dcfg("dice_int8"), 2, STEPS,
                                        experts_per_token=2)
    assert keys == [splan.num_variants] * m["n"]
    # per-rank wire bytes from this rank's B_loc x T_loc tokens
    lanes = m["n"] // m["patch"]
    local = (8 // lanes) * (cfg.patch_tokens // m["patch"])
    assert st["dispatch_bytes"] == [
        float(sum(a.dispatch_bytes(local, cfg) for a in plan.actions))
        for plan in splan.steps]
    # the staleness buffers split over the ranks; every rank of a patch
    # group holds the full-sequence K/V (DistriFusion's memory cost)
    kv = cfg.num_layers * 2 * 8 * cfg.patch_tokens * cfg.num_kv_heads \
        * cfg.head_dim * 4
    single = ref_st["buffer_bytes"][-1]
    assert st["buffer_bytes"][-1] == single - kv + m["patch"] * kv


def test_dp_invariance_is_bit_for_bit():
    """dp=2 over replica-identical shards reduces to exactly dp=1's
    load-balance loss and served-counts mean: the mean runs over each
    replica group first, then over dp, and (x + x) / 2 == x."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :2]
    counts = rng.integers(0, 9, (2, 8)).astype(np.float32) / 7.0
    args = (probs, idx, counts)
    one, _ = mesh_lib.spawn(jobs.dp_invariance, 2, backend="gloo",
                            device="cpu", timeout_s=RANK_TIMEOUT_S,
                            args=args)
    two, _ = mesh_lib.spawn(jobs.dp_invariance, 4, dp=2, backend="gloo",
                            device="cpu", timeout_s=RANK_TIMEOUT_S,
                            args=args)
    assert len(set(one)) == 1 and set(two) == set(one)


@pytest.mark.parametrize("shape,n,dp,patch", [
    ("ep2xdp2", 4, 2, 1), ("ep2xpatch2", 4, 1, 2),
    ("ep2xdp2xpatch2", 8, 2, 2)])
def test_make_mesh_layout_and_collectives(shape, n, dp, patch):
    x = np.arange(8 * 16 * 2, dtype=np.float32).reshape(8, 16, 2)
    every, _ = mesh_lib.spawn(jobs.mesh_layout, n, dp=dp, patch=patch,
                              backend="gloo", device="cpu",
                              timeout_s=RANK_TIMEOUT_S, args=(x,))
    ep = n // (dp * patch)
    want_axes = tuple(a for a, s in (("dp", dp), ("ep", ep),
                                     ("patch", patch)) if s > 1)
    for r, (rank, axes, sizes, coords, lane, ok) in enumerate(every):
        assert rank == r and axes == want_axes
        assert sizes == {a: {"dp": dp, "ep": ep, "patch": patch}[a]
                         for a in want_axes}
        # dp-major, then ep, then patch
        assert r == (coords["dp"] * ep + coords["ep"]) * patch \
            + coords["patch"]
        assert lane == coords["dp"] * ep + coords["ep"]
        assert all(ok.values()), (r, ok)


def test_make_mesh_validates_without_ranks():
    with pytest.raises(ValueError, match="integers"):
        mesh_lib.make_mesh(dp=0, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="integers"):
        mesh_lib.make_mesh(patch=2.0, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(ep=2, dp=2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="one card per rank"):
        mesh_lib.make_mesh(ep=2, patch=2, backend="nccl")
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.spawn(print, 6, dp=4, backend="gloo", device="cpu")
    with pytest.raises(TypeError, match="HierMesh"):
        serve.DiceServer(_cfg(8.0), DiceConfig.dice(), mesh=object(),
                         params={})


def test_hier_sharding_helpers():
    m = mesh_lib.HierMesh(rank=6, dp=2, ep=2, patch=2, backend="gloo",
                          device=torch.device("cpu"))
    assert shard_lib.batch_shard_axes(m) == ("dp", "ep")
    assert shard_lib.data_shard_axes(m) == ("dp", "ep", "patch")
    assert (m.rank_in("dp"), m.rank_in("ep"), m.rank_in("patch")) == (1, 1, 0)
    assert shard_lib.local_rows(8, m) == slice(6, 8)
    assert shard_lib.local_tokens(16, m) == slice(0, 8)
    assert shard_lib.expert_slice(8, m) == slice(4, 8)
    x = torch.arange(8 * 16).reshape(8, 16, 1)
    assert torch.equal(shard_lib.hier_place_tokens(x, m), x[6:8, 0:8])
    with pytest.raises(ValueError, match="must divide"):
        shard_lib.local_tokens(15, m)
    with pytest.raises(ValueError, match="batch 6 must divide"):
        shard_lib.hier_place_batch(x[:6], m)
    ep_only = mesh_lib.HierMesh(rank=1, dp=2, ep=1, patch=2, backend="gloo",
                                device=torch.device("cpu"))
    assert ep_only.ep_mesh is None and ep_only.axis_names == ("dp", "patch")
    assert shard_lib.expert_slice(8, ep_only) == slice(0, 8)


@pytest.fixture(scope="module")
def continuous(tree):
    """serve_continuous over ep2 x dp2 (one slot a rank) and in one
    process, on the same requests and noise."""
    cfg = _cfg(8.0)
    noise = {r: np.random.default_rng(r).standard_normal(
        (cfg.patch_tokens, cfg.in_channels)).astype(np.float32)
        for r in range(6)}
    reqs = [(1, 0), (2, 1), (3, 2), (4, 3), (5, 4), (6, 5)]
    arrivals = [0.0, 0.0, 0.0, 0.0, 1.0, 1.0]
    runs = [("dice", DiceConfig.dice(), STEPS, [])]
    port, _ = mesh_lib.spawn(jobs.continuous_runs, 4, dp=2, backend="gloo",
                             device="cpu", timeout_s=RANK_TIMEOUT_S,
                             args=(tree, cfg, runs, reqs, arrivals, 0, noise,
                                   4))
    params = bridge.from_jax_params(tree, device="cpu")
    server = serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                              device="cpu")
    single = serve.serve_continuous(
        server, [serve.Request(c, r) for c, r in reqs], max_batch=4,
        num_steps=STEPS, seed=0, arrival_steps=arrivals, noise=noise)
    return port["dice"], single


def test_serve_continuous_over_ep2_dp2(continuous):
    (got, stats, _, keys), (want, want_stats) = continuous
    assert sorted(got) == sorted(want) == list(range(6))
    for rid in want:
        np.testing.assert_allclose(got[rid].numpy(), want[rid].numpy(),
                                   **TOL_F32)
    for k in ("ticks", "admissions", "recycled_admissions", "step_keys"):
        assert stats[k] == want_stats[k], k
    assert (stats["dp"], stats["ep"]) == (2, 2)
    assert keys == [stats["num_plan_variants"]] * 4


def test_serve_continuous_refuses_a_patch_axis(tree):
    msg, _ = mesh_lib.spawn(jobs.patch_continuous_refused, 4, patch=2,
                            backend="gloo", device="cpu",
                            timeout_s=RANK_TIMEOUT_S, args=(tree, _cfg(8.0)))
    assert msg is not None and "'patch' mesh axis" in msg


def test_serve_cli_over_ep2_dp2():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ep", "2",
         "--dp", "2", "--backend", "gloo", "--device", "cpu",
         "--requests", "4", "--steps", "4"],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "expert-parallel over 4 ranks (gloo, blocking), mesh 2-way dp " \
        "x 2-way ep" in text
    assert "samples: (4, 64, 4), finite=True" in text
    lines = dict(line.split(None, 1) for line in text.splitlines()
                 if line.startswith("  ") and not line.startswith("  rank"))
    assert (lines["dp"], lines["ep"], lines["backend"]) == ("2", "2", "gloo")
    assert text.count("kernel launches") == 4           # one line a rank


def test_serve_cli_checks_the_mesh_flags():
    import io
    from contextlib import redirect_stderr
    for argv in (["--dp", "2", "--device", "cpu"],            # no backend
                 ["--ep", "2", "--dp", "2", "--backend", "gloo",
                  "--requests", "6"],                          # 6 % 4
                 ["--patch", "2", "--backend", "gloo", "--continuous"]):
        with redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
            serve.main(argv)


def test_ring_in_topology_order_equals_blocking(tree, inputs):
    noise, classes = inputs
    out, _ = mesh_lib.spawn(jobs.topology_ring, 4, backend="gloo",
                            device="cpu", timeout_s=RANK_TIMEOUT_S,
                            args=(tree, _cfg(1.25), noise, classes, 2))
    sched, ring, hops = out["ring"]
    _, blocking, none = out["blocking"]
    assert sched == (1, 3, 2) and out["blocking"][0] is None
    assert hops == 6 and none == 0
    assert float((ring - blocking).abs().max()) <= TOL_RING


@pytest.mark.parametrize("name", ["dice", "dice_int8", "sync"])
@pytest.mark.parametrize("overlap", ["blocking", "ring"])
def test_two_tier_latency_model_matches_the_reference(name, overlap):
    jax_dcfg = {"dice": lambda: JaxDice.dice(overlap=overlap),
                "sync": lambda: JaxDice.sync_ep(overlap=overlap),
                "dice_int8": lambda: JaxDice.dice(
                    compress=JaxCompress("int8_residual"),
                    overlap=overlap)}[name]()
    kw = dict(local_batch=4, n_dev=8, devices_per_host=4,
              inter_host_bw=0.2e9)
    want = jax_serve.modeled_step_latency(jax_configs.config(), jax_dcfg,
                                          **kw)
    got = serve.modeled_step_latency(configs.config(),
                                     _dcfg(name, overlap), **kw)
    server = serve.DiceServer(configs.config(), _dcfg(name, overlap),
                              params={}, device="cpu", n_dev=8,
                              devices_per_host=4, inter_host_bw=0.2e9)
    for lat in (got, server.latency(4)):
        assert lat.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert lat[k] == pytest.approx(v, rel=1e-12), k
            else:
                assert lat[k] == v, k
    assert got["hop_schedule"] == (1, 7, 2, 6, 3, 5, 4)
