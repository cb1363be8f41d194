"""The port's affinity-aware expert placement against the JAX package's, on
the CPU.

* ``repro_torch.core.placement`` (the port's numpy-only copy) against
  ``repro.core.placement`` on the same histograms: greedy placements,
  ties, replication, drift, ``cap_scale``, the ``placed_params`` round
  trip, and the errors.
* ``moe_forward`` on placed params with
  ``Placement(perm=(3, 1, 0, 2, 5, 4, 7, 6), replicated=(2,))`` equals the
  unplaced forward to 1e-6 with equal ``counts`` and ``served_counts``, as
  ``tests/test_placement.py:238`` holds for the reference.
* ep=4 (4 gloo ranks) with that placement on every layer, and with an
  identity perm at ``cap_scale`` 0.5, against the reference's ep=4 mesh
  run of the same configs (``tests/test_ep_dice.py:126-180``), which a
  subprocess makes with 4 forced XLA host devices, at ``capacity_factor``
  1.25 (drops included); per-rank bytes exactly.
* online greedy placement in ``serve_continuous`` at ep=2 under a skewed
  router bias re-shards, counts it, and (drop-free) serves the samples of
  the identity layout.

Tolerances: TOL_F32 (rtol = atol = 1e-4) for sampled latents; 1e-6 for one
MoE layer.  Time limits: the reference subprocess 400 s, each spawn of
ranks 120 s.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.configs import dit_moe_xl as jax_configs
from repro.core import placement as jax_pl
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import moe, placement as pl_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.placement import Placement
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP = 4
STEPS = jobs.STEPS
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
REF_TIMEOUT_S = 400
RANK_TIMEOUT_S = 120
PERM = (3, 1, 0, 2, 5, 4, 7, 6)


def _shares(seed, L=3, E=8, skew=2.0):
    rng = np.random.default_rng(seed)
    s = rng.gamma(skew, size=(L, E))
    return s / s.sum(-1, keepdims=True)


def _same(a, b):
    """A port Placement equals a reference one, field by field."""
    return (a.perm, a.replicated, a.cap_scale) == \
        (b.perm, b.replicated, b.cap_scale)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_dev,top", [(2, 0), (4, 1), (8, 2), (4, 3)])
def test_greedy_placements_match_the_reference(seed, n_dev, top):
    s = _shares(seed)
    mine = pl_lib.greedy_placements(s, n_dev, replicate_top=top)
    theirs = jax_pl.greedy_placements(s, n_dev, replicate_top=top)
    assert len(mine) == len(theirs) == 3
    assert all(_same(a, b) for a, b in zip(mine, theirs))
    for a, row in zip(mine, s):
        assert pl_lib.expected_cross_device_traffic(row, a, n_dev) == \
            jax_pl.expected_cross_device_traffic(
                row, jax_pl.Placement(a.perm, a.replicated, a.cap_scale),
                n_dev)
        assert 0 < a.cap_scale <= 1
        assert a.replicated or a.cap_scale == 1.0


@pytest.mark.parametrize("shares", [
    np.full(8, 1 / 8),                               # uniform: identity
    np.array([4, 4, 1, 1, 1, 1, 1, 1]) / 14,         # tied hot pair
    np.array([1, 1, 1, 1, 1, 1, 4, 4]) / 14,         # ties at the end
    np.array([0, 0, 0, 0, 0, 0, 0, 1.0])])           # one expert takes all
@pytest.mark.parametrize("top", [0, 1, 2])
def test_ties_and_degenerate_histograms_match(shares, top):
    """Where the replicas take every pair, the planned scale is 0 and both
    packages raise (ROADMAP C.8, a fault of the reference the port
    keeps)."""
    for n_dev in (2, 4):
        if top and shares[-1] == 1.0:
            for mod in (pl_lib, jax_pl):
                with pytest.raises(ValueError, match="cap_scale"):
                    mod.greedy_placement(shares, n_dev, replicate_top=top)
            continue
        a = pl_lib.greedy_placement(shares, n_dev, replicate_top=top)
        b = jax_pl.greedy_placement(shares, n_dev, replicate_top=top)
        assert _same(a, b)
    assert pl_lib.greedy_placement(np.full(8, 1 / 8), 4).is_identity


def test_histogram_drift_and_capacity_match():
    mine = pl_lib.RoutingHistogram(3, 8, decay=0.8)
    theirs = jax_pl.RoutingHistogram(3, 8, decay=0.8)
    for seed in range(5):
        c = np.random.default_rng(seed).integers(0, 50, (3, 8))
        c[1] = 0 if seed == 2 else c[1]             # an empty layer
        mine.update(c)
        theirs.update(c)
        assert np.array_equal(mine.shares, theirs.shares)
    assert mine.updates == theirs.updates == 5
    a, b = _shares(0), _shares(1)
    assert pl_lib.drift(a, b) == jax_pl.drift(a, b)
    for scale in (1.0, 0.5, 0.3125, 0.0625):
        for cap in (8, 16, 40, 96, 1000):
            p = Placement(perm=tuple(range(8)), replicated=(0,),
                          cap_scale=scale)
            q = jax_pl.Placement(perm=tuple(range(8)), replicated=(0,),
                                 cap_scale=scale)
            assert p.scaled_capacity(cap) == q.scaled_capacity(cap)


def test_placed_params_round_trip_on_torch_and_numpy_trees():
    rng = np.random.default_rng(0)
    layer = {k: rng.standard_normal((8, 4, 3)).astype(np.float32)
             for k in ("experts_gate", "experts_up", "experts_down")}
    layer["router"] = rng.standard_normal((4, 8)).astype(np.float32)
    tree = {"blocks": [{"moe": dict(layer)}, {"moe": dict(layer)}]}
    pls = (Placement(perm=PERM, replicated=(2,)), None)
    jpls = (jax_pl.Placement(perm=PERM, replicated=(2,)), None)
    want = jax_pl.placed_params(tree, jpls)
    torch_tree = {"blocks": [{"moe": {k: torch.from_numpy(v)
                                      for k, v in layer.items()}}
                             for _ in range(2)]}
    for got in (pl_lib.placed_params(tree, pls),
                pl_lib.placed_params(torch_tree, pls)):
        g0, w0 = got["blocks"][0]["moe"], want["blocks"][0]["moe"]
        assert sorted(g0) == sorted(w0)
        for k in w0:
            assert np.array_equal(np.asarray(g0[k]), np.asarray(w0[k])), k
        # the wire order undone by the inverse permutation
        inv = list(pls[0].inv_perm())
        assert np.array_equal(np.asarray(g0["experts_gate"])[inv],
                              layer["experts_gate"])
        assert got["blocks"][1]["moe"] is not None
    assert pl_lib.placed_params(tree, (None, None))["blocks"][0]["moe"][
        "experts_gate"] is layer["experts_gate"]


def test_placement_errors_match_the_reference():
    bad = [dict(perm=(0, 0, 1, 2)), dict(perm=(0, 1, 2, 3), replicated=(2, 1)),
           dict(perm=(0, 1, 2, 3), replicated=(4,)),
           dict(perm=(0, 1, 2, 3), cap_scale=0.0),
           dict(perm=(0, 1, 2, 3), cap_scale=1.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            Placement(**kw)
        with pytest.raises(ValueError):
            jax_pl.Placement(**kw)
    for mod in (pl_lib, jax_pl):
        with pytest.raises(ValueError):
            mod.greedy_placement(np.ones(6) / 6, 4)        # 6 % 4
        with pytest.raises(ValueError):
            mod.greedy_placement(np.ones(4) / 4, 2, replicate_top=4)
        with pytest.raises(ValueError):
            mod.PlacementConfig(mode="random")
        with pytest.raises(ValueError):
            mod.RoutingHistogram(2, 4).update(np.ones((3, 4)))
    tree = {"blocks": [{"moe": {k: np.zeros((8, 2, 2)) for k in
                                ("experts_gate", "experts_up",
                                 "experts_down")}}]}
    with pytest.raises(ValueError):
        pl_lib.placed_params(tree, (None, None))      # 2 for 1 layer
    placed = pl_lib.place_moe_params(tree["blocks"][0]["moe"],
                                     Placement(perm=PERM, replicated=(1,)))
    with pytest.raises(ValueError):
        pl_lib.place_moe_params(placed, Placement(perm=PERM))


def test_plan_carries_placements_and_scales_capacity():
    pl = Placement(perm=PERM, replicated=(2,), cap_scale=0.5)
    dcfg = dataclasses.replace(DiceConfig.dice(), placements=(pl, None))
    plan = plan_lib.plan_for_step(dcfg, 2, 3, experts_per_token=2)
    assert plan.actions[0].placement == pl and plan.actions[1].placement \
        is None
    cfg = configs.tiny()
    a0 = plan.actions[0]
    assert a0.dispatch_capacity(256, cfg) == pl.scaled_capacity(
        dataclasses.replace(a0, placement=None).dispatch_capacity(256, cfg))
    assert plan_lib.placement_wire_scale(dcfg) == 0.75
    assert plan_lib.normalize_placement(dcfg, 1).placements is None
    assert plan_lib.normalize_placement(dcfg, 2) is dcfg
    ident = dataclasses.replace(DiceConfig.dice(),
                                placements=(Placement.identity(8),) * 2)
    assert plan_lib.plan_for_step(ident, 2, 3, experts_per_token=2) == \
        plan_lib.plan_for_step(DiceConfig.dice(), 2, 3, experts_per_token=2)
    with pytest.raises(ValueError, match="entries"):
        plan_lib.plan_for_step(dataclasses.replace(
            DiceConfig.dice(), placements=(pl,)), 2, 3, experts_per_token=2)
    with pytest.raises(TypeError):
        DiceConfig(placements=(object(),))


def _moe_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    fs = f * cfg.num_shared_experts

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 / np.sqrt(shape[-2])).astype(np.float32))
    return {"router": w(d, E), "experts_gate": w(E, d, f),
            "experts_up": w(E, d, f), "experts_down": w(E, f, d),
            "shared_gate": w(d, fs), "shared_up": w(d, fs),
            "shared_down": w(fs, d)}


@pytest.mark.parametrize("cached", [False, True])
def test_moe_forward_placement_parity_on_one_device(cached):
    cfg = configs.tiny().replace(d_model=64, moe_d_ff=96)
    p = _moe_params(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 64)).astype(np.float32))
    kw = {}
    if cached:
        gen = torch.Generator().manual_seed(0)
        kw = dict(fresh_mask=torch.rand((32, 2), generator=gen) < 0.6,
                  h_cache=torch.randn((32, 2, 64), generator=gen))
    pl = Placement(perm=PERM, replicated=(2,))
    y_ref, aux_ref = moe.moe_forward(p, x, cfg, capacity=32, **kw)
    y_pl, aux_pl = moe.moe_forward(pl_lib.place_moe_params(p, pl), x, cfg,
                                   capacity=32, placement=pl, **kw)
    assert float((y_pl - y_ref).abs().max()) < 1e-6
    assert torch.equal(aux_pl.counts, aux_ref.counts)
    assert torch.equal(aux_pl.served_counts, aux_ref.served_counts)
    assert aux_pl.dispatch_bytes == aux_ref.dispatch_bytes
    # a scaled capacity shrinks the wire buffer; the replica serves expert 2
    pl_s = Placement(perm=PERM, replicated=(2,), cap_scale=0.5)
    _, aux_s = moe.moe_forward(pl_lib.place_moe_params(p, pl_s), x, cfg,
                               placement=pl_s, **kw)
    assert aux_s.dispatch_bytes < moe.moe_forward(p, x, cfg,
                                                  **kw)[1].dispatch_bytes


REF_PROG = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.dit_moe_xl import tiny
    from repro.core.placement import Placement
    from repro.core.schedules import DiceConfig
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
    pl = Placement(perm=(3, 1, 0, 2, 5, 4, 7, 6), replicated=(2,))
    pl_s = Placement(perm=tuple(range(8)), replicated=(0,), cap_scale=0.5)
    runs = {
        "placed_sync": dataclasses.replace(DiceConfig.sync_ep(),
                                           placements=(pl, pl)),
        "placed_dice": dataclasses.replace(DiceConfig.dice(),
                                           placements=(pl, pl)),
        "placed_dice_ring": dataclasses.replace(
            DiceConfig.dice(overlap="ring"), placements=(pl, pl)),
        "capscale_sync": dataclasses.replace(DiceConfig.sync_ep(),
                                             placements=(pl_s, pl_s)),
        "sync": DiceConfig.sync_ep(),
    }
    out = {}
    for name, dcfg in runs.items():
        x, st = rf_sample(params, cfg, dcfg, num_steps=6, classes=classes,
                          key=key, guidance=1.0, mesh=mesh)
        out[name + "/samples"] = np.asarray(x)
        for s in ("dispatch_bytes", "raw_bytes", "hop_bytes"):
            out[name + "/" + s] = np.asarray(st[s])
    np.savez(sys.argv[1], **out)
""")

MESH_RUNS = ("placed_sync", "placed_dice", "placed_dice_ring",
             "capscale_sync", "sync")


def _jax_cfg(cf):
    return jax_configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=cf)


def _cfg(cf):
    return configs.tiny().replace(
        num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=cf)


def _mesh_dcfg(name):
    pl = Placement(perm=PERM, replicated=(2,))
    pl_s = Placement(perm=tuple(range(8)), replicated=(0,), cap_scale=0.5)
    return {
        "placed_sync": lambda: dataclasses.replace(DiceConfig.sync_ep(),
                                                   placements=(pl, pl)),
        "placed_dice": lambda: dataclasses.replace(DiceConfig.dice(),
                                                   placements=(pl, pl)),
        "placed_dice_ring": lambda: dataclasses.replace(
            DiceConfig.dice(overlap="ring"), placements=(pl, pl)),
        "capscale_sync": lambda: dataclasses.replace(
            DiceConfig.sync_ep(), placements=(pl_s, pl_s)),
        "sync": DiceConfig.sync_ep,
    }[name]()


@pytest.fixture(scope="module")
def tree():
    params = jax_init_dit(jax.random.PRNGKey(0), _jax_cfg(1.25))
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return jax.device_get(params)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, tree):
    path = tmp_path_factory.mktemp("placement_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, str(path)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        cfg = _jax_cfg(1.25)
        noise = np.asarray(jax.random.normal(
            jax.random.PRNGKey(7), (8, cfg.patch_tokens, cfg.in_channels)))
        classes = np.arange(8) % cfg.num_classes
        runs = [(name, _cfg(1.25), _mesh_dcfg(name)) for name in MESH_RUNS]
        port, counts = mesh_lib.spawn(jobs.sample_runs, EP, backend="gloo",
                                      device="cpu", timeout_s=RANK_TIMEOUT_S,
                                      args=(tree, runs, noise, classes))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}, port


@pytest.mark.parametrize("name", MESH_RUNS)
def test_placed_ep4_matches_the_reference_mesh(name, mesh_runs):
    ref, port = mesh_runs
    x, st, keys = port[name]
    np.testing.assert_allclose(x.numpy(), ref[f"{name}/samples"], **TOL_F32)
    for k in ("dispatch_bytes", "raw_bytes", "hop_bytes"):
        assert st[k] == [float(b) for b in ref[f"{name}/{k}"]], k
    splan = plan_lib.compile_step_plans(_mesh_dcfg(name), 2, STEPS,
                                        experts_per_token=2)
    assert keys == [splan.num_variants] * EP


def test_cap_scale_shrinks_the_per_rank_wire(mesh_runs):
    _, port = mesh_runs
    scaled, plain = port["capscale_sync"][1], port["sync"][1]
    cap = plan_lib.LayerAction().dispatch_capacity(32, _cfg(1.25))
    want = Placement(perm=tuple(range(8)), replicated=(0,),
                     cap_scale=0.5).scaled_capacity(cap) / cap
    assert scaled["dispatch_bytes"] == [b * want
                                        for b in plain["dispatch_bytes"]]


def test_online_greedy_placement_reshards_under_a_skewed_router(tree):
    cfg = _cfg(8.0)
    bias = np.zeros(8, np.float32)
    bias[5] = 2.5
    noise = {r: np.random.default_rng(r).standard_normal(
        (cfg.patch_tokens, cfg.in_channels)).astype(np.float32)
        for r in range(8)}
    (got, st), (want, st_id), keys = mesh_lib.spawn(
        jobs.online_placement, 2, backend="gloo", device="cpu",
        timeout_s=RANK_TIMEOUT_S, args=(tree, cfg, bias, noise, 4))[0]
    assert st["placement_reshards"] >= 1 and st_id["placement_reshards"] == 0
    assert st["placement_wire_scale"] < 1.0
    assert st_id["placement_wire_scale"] == 1.0
    shares = np.asarray(st["routing_shares"])
    assert shares.shape == (2, 8) and (shares.argmax(-1) == 5).all()
    assert st["hist_updates"] == st["ticks"]
    # the peak over placement epochs: one key a variant
    assert keys == [st["step_keys"]] * 2
    assert st["step_keys"] <= st["num_plan_variants"]
    assert sorted(got) == sorted(want) == list(range(8))
    for rid in want:                         # drop-free: same samples
        np.testing.assert_allclose(got[rid].numpy(), want[rid].numpy(),
                                   **TOL_F32)
    # the re-shard shrank the wire: fewer bytes over the same ticks
    assert st["dispatch_bytes_total"] < st_id["dispatch_bytes_total"]
