"""The port's expert-parallel sampler against the JAX package's ep mesh, on
the CPU.

The reference runs ``rf_sample(mesh=make_ep_mesh(4))`` in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_ep_dice.py`` does, on the 2-layer config of that test (batch
8, 2 requests a device, 6 steps, ``guidance=1.0``) at ``capacity_factor``
1.25, so that per-device capacity drops happen; its samples and per-step
bytes go to an ``.npz``.  The port runs the same schedules in 4 spawned
gloo ranks (``repro_torch.launch.mesh.spawn``) on the reference's params
(``bridge.from_jax_params``) and noise.  Each side runs once per module.

Tolerances: samples within TOL_F32 (rtol = atol = 1e-4: f32 end to end,
products summed in another order); the ring against the blocking path
within 1e-4, the bound of ``tests/test_overlap.py``; byte counts exactly.

Time limits: the reference subprocess gets 400 s (about 40 s here; the
port's ranks run beside it), each spawn of ranks 120 s for its
collectives and its reports (about 10 s here), so a hung exchange fails
its tests instead of the run.
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
from repro.configs import dit_moe_xl as jax_configs
from repro.core import moe as jax_moe
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import plan as plan_lib
from repro_torch.core.schedules import DiceConfig, Schedule
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP = 4
STEPS = jobs.STEPS
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_RING = 1e-4
REF_TIMEOUT_S = 400
RANK_TIMEOUT_S = 120
SCHEDULES = ("sync", "displaced", "interweaved", "selective", "dice",
             "dice_int8")
RING = SCHEDULES + ("staggered_batch",)
KEYS = ("samples", "dispatch_bytes", "raw_bytes", "buffer_bytes", "hops",
        "hop_bytes", "num_plan_variants", "jit_cache_size")

REF_PROG = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.compress.codecs import CompressConfig
    from repro.configs.dit_moe_xl import tiny
    from repro.core.schedules import DiceConfig, Schedule
    from repro.launch.mesh import make_ep_mesh
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
    mesh = make_ep_mesh(4)
    int8 = CompressConfig("int8_residual")
    runs = {
        "sync": DiceConfig.sync_ep(),
        "displaced": DiceConfig.displaced(),
        "interweaved": DiceConfig.interweaved(),
        "selective": DiceConfig(schedule=Schedule.DICE, sync_policy="deep",
                                cond_comm=False),
        "dice": DiceConfig.dice(sync_policy="deep"),
        "dice_int8": DiceConfig.dice(sync_policy="deep", compress=int8),
        "ring_dice_int8": DiceConfig.dice(sync_policy="deep", compress=int8,
                                          overlap="ring"),
    }
    out = {}
    for name, dcfg in runs.items():
        x, st = rf_sample(params, cfg, dcfg, num_steps=6, classes=classes,
                          key=key, guidance=1.0, mesh=mesh)
        out[name + "/samples"] = np.asarray(x)
        for s in ("dispatch_bytes", "raw_bytes", "buffer_bytes", "hops",
                  "hop_bytes"):
            out[name + "/" + s] = np.asarray(st[s])
        out[name + "/num_plan_variants"] = np.asarray(st["num_plan_variants"])
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
    int8 = CompressConfig("int8_residual")
    return {
        "sync": lambda: DiceConfig.sync_ep(overlap=overlap),
        "displaced": lambda: DiceConfig.displaced(overlap=overlap),
        "interweaved": lambda: DiceConfig.interweaved(overlap=overlap),
        "selective": lambda: DiceConfig(schedule=Schedule.DICE,
                                        sync_policy="deep", cond_comm=False,
                                        overlap=overlap),
        "dice": lambda: DiceConfig.dice(sync_policy="deep", overlap=overlap),
        "dice_int8": lambda: DiceConfig.dice(sync_policy="deep",
                                             compress=int8, overlap=overlap),
        "staggered_batch": lambda: DiceConfig.staggered_batch(
            overlap=overlap),
    }[name]()


@pytest.fixture(scope="module")
def jax_tree():
    """The reference program's params, built the same way here."""
    params = jax_init_dit(jax.random.PRNGKey(0), _jax_cfg(1.25))
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return jax.device_get(params)


@pytest.fixture(scope="module")
def inputs():
    """The reference rf_sample's classes and noise (drawn from its key)."""
    cfg = _jax_cfg(1.25)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (8, cfg.patch_tokens, cfg.in_channels)))
    return noise, np.arange(8) % cfg.num_classes


@pytest.fixture(scope="module")
def both(tmp_path_factory, jax_tree, inputs):
    """The reference's runs (a subprocess) and all of the port's ep=4 runs
    (one spawn of 4 gloo ranks), side by side."""
    path = tmp_path_factory.mktemp("ep_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, str(path)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        noise, classes = inputs
        runs = [(name, _cfg(1.25), _dcfg(name)) for name in SCHEDULES]
        runs += [("ring_" + name, _cfg(1.25), _dcfg(name, "ring"))
                 for name in RING]
        runs += [("blocking_staggered_batch", _cfg(1.25),
                  _dcfg("staggered_batch"))]
        runs += [("cf8_" + name, _cfg(8.0), _dcfg(name))
                 for name in SCHEDULES]
        port, counts = mesh_lib.spawn(jobs.sample_runs, EP, backend="gloo",
                                      device="cpu", timeout_s=RANK_TIMEOUT_S,
                                      args=(jax_tree, runs, noise, classes))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert counts == [{k: 0 for k in counts[0]}] * EP   # plain versions
    with np.load(path) as f:
        return {k: f[k] for k in f.files}, port


@pytest.fixture(scope="module")
def ref(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


def _ref_stats(ref, name):
    return {k: ref[f"{name}/{k}"] for k in KEYS}


@pytest.mark.parametrize("name", SCHEDULES)
def test_ep4_matches_the_reference_mesh(name, ref, port):
    r = _ref_stats(ref, name)
    x, st, keys = port[name]
    np.testing.assert_allclose(x.numpy(), r["samples"], **TOL_F32)
    # the per-device all-to-all payload, step by step, as transmitted
    assert st["dispatch_bytes"] == [float(b) for b in r["dispatch_bytes"]]
    assert st["raw_bytes"] == [float(b) for b in r["raw_bytes"]]
    assert st["buffer_bytes"] == [float(b) for b in r["buffer_bytes"]]
    assert st["hops"] == [0] * STEPS == list(r["hops"])
    splan = plan_lib.compile_step_plans(_dcfg(name), 2, STEPS,
                                        experts_per_token=2)
    assert st["num_plan_variants"] == splan.num_variants == \
        int(r["num_plan_variants"]) == int(r["jit_cache_size"])
    assert keys == [splan.num_variants] * EP          # on every rank
    if name.startswith("dice"):
        w = _dcfg(name).warmup_steps
        refresh, light = st["dispatch_bytes"][w], st["dispatch_bytes"][w + 1]
        assert light < refresh


def test_ep4_runs_drop_pairs_at_capacity_factor_1_25(port):
    """Per-device capacity is sized from the 32 local tokens: some light
    steps overflow it, so the parity above covers capacity drops."""
    drops = [f for name in SCHEDULES for f in port[name][1]["dropped_frac"]]
    assert max(drops) > 0
    assert all(f == 0 for name in SCHEDULES
               for f in port["cf8_" + name][1]["dropped_frac"])


def test_int8_codec_shrinks_light_steps_over_the_mesh(port):
    w = DiceConfig.dice().warmup_steps
    plain, coded = port["dice"][1], port["dice_int8"][1]
    assert coded["dispatch_bytes"][w + 1] < plain["dispatch_bytes"][w + 1]
    assert coded["raw_bytes"][w + 1] == plain["dispatch_bytes"][w + 1]
    assert coded["dispatch_bytes"][w] == coded["raw_bytes"][w]


@pytest.mark.parametrize("name", SCHEDULES)
def test_ep4_equals_the_single_process_run_at_capacity_factor_8(
        name, port, jax_tree, inputs):
    """No capacity drop can happen, so expert parallelism changes nothing
    but the order of sums: the reference's ep == single-device property."""
    noise, classes = inputs
    params = bridge.from_jax_params(jax_tree, device="cpu")
    x, st = rf_sample(params, _cfg(8.0), _dcfg(name), num_steps=STEPS,
                      classes=torch.as_tensor(classes),
                      noise=torch.as_tensor(noise), guidance=1.0)
    x_ep, st_ep, _ = port["cf8_" + name]
    np.testing.assert_allclose(x_ep.numpy(), x.numpy(), **TOL_F32)
    # the per-device payload is a quarter of the whole batch's
    assert st_ep["dispatch_bytes"] == [b / EP for b in st["dispatch_bytes"]]
    assert st_ep["buffer_bytes"] == st["buffer_bytes"]


@pytest.mark.parametrize("name", RING)
def test_ring_matches_blocking(name, port):
    blocking = port["blocking_staggered_batch" if name == "staggered_batch"
                    else name]
    x, st, keys = port["ring_" + name]
    err = float((x - blocking[0]).abs().max())
    assert err <= TOL_RING, err
    # a staggered layer runs two half-batch rings, a warm-up (sync) one
    splan = plan_lib.compile_step_plans(_dcfg(name), 2, STEPS,
                                        experts_per_token=2)
    calls = [max(2 if a.mode == "staggered" else 1 for a in plan.actions)
             for plan in splan.steps]
    assert st["hops"] == [2 * (EP - 1) * c for c in calls]
    # same payload as the all-to-alls, split into hops of one chunk each
    assert st["dispatch_bytes"] == blocking[1]["dispatch_bytes"]
    assert st["hop_bytes"] == [b / EP / c for b, c in
                               zip(st["dispatch_bytes"], calls)]
    assert keys == [st["num_plan_variants"]] * EP


def test_ring_hops_and_bytes_match_the_reference(ref, port):
    r = _ref_stats(ref, "ring_dice_int8")
    x, st, _ = port["ring_dice_int8"]
    assert st["hops"] == [2 * (EP - 1)] * STEPS == list(r["hops"])
    assert st["hop_bytes"] == [float(b) for b in r["hop_bytes"]]
    np.testing.assert_allclose(x.numpy(), r["samples"], **TOL_F32)


@pytest.fixture(scope="module")
def exchange():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4 * 24, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :2]
    scheds = (None, (3, 1, 2), (2, 3, 1))
    (errs, lbs), _ = mesh_lib.spawn(jobs.exchange_and_lb, EP, backend="gloo",
                                    device="cpu", timeout_s=RANK_TIMEOUT_S,
                                    args=(scheds, (probs, idx)))
    return errs, lbs, probs, idx


def test_ring_expert_exchange_equals_all_to_all(exchange):
    """On random chunks and a row-independent FFN, the ring's output is
    the blocking path's on every rank, up to the order of the FFN's f32
    sums (its chunk is C rows, the blocking call's n * C: 1e-6 for sums of
    8 terms); and every hop order gives the same output bit for bit."""
    errs, _, _, _ = exchange
    assert len(errs) == EP
    for per_rank in errs:
        assert len(per_rank) == 3
        assert all(e <= 1e-6 and same for e, same in per_rank.values()), \
            per_rank


def test_mesh_transports_on_the_cpu():
    """The mesh's collectives and a ring hop through ``EPMesh.exchange``
    give their expected values on every one of 4 gloo ranks."""
    every_rank, _ = mesh_lib.spawn(jobs.mesh_transports, EP, backend="gloo",
                                   device="cpu", timeout_s=RANK_TIMEOUT_S)
    assert len(every_rank) == EP
    for r, ok in enumerate(every_rank):
        assert all(ok.values()), (r, ok)


def test_load_balance_loss_over_the_mesh_matches_reference(exchange):
    """Each rank's loss over its shard, reduced over the mesh before the
    product, equals the reference's loss over the whole batch."""
    _, lbs, probs, idx = exchange
    want = float(jax_moe.load_balance_loss(jnp.asarray(probs),
                                           jnp.asarray(idx), 8))
    assert lbs == pytest.approx([want] * EP, rel=1e-6)
    # the mean of per-shard losses is a different (wrong) number
    rows = probs.shape[0] // EP
    shard = [float(jax_moe.load_balance_loss(
        jnp.asarray(probs[i * rows:(i + 1) * rows]),
        jnp.asarray(idx[i * rows:(i + 1) * rows]), 8)) for i in range(EP)]
    assert np.mean(shard) != pytest.approx(want, rel=1e-6)
