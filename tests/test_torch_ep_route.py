"""Repairs and refusals of the expert-parallel slice, on the CPU.

``route`` breaks top-k ties as ``jax.lax.top_k`` does (lowest expert id
first), so equal or saturated router probabilities give the reference's
experts, slots, counts and drops; ``router_jitter > 0`` is refused where
the port builds a step; the mesh refuses what it does not port (``dp``,
``patch``, ``nccl`` on a shared card, experts or batches that do not
divide over it); and the mesh's pure-Python helpers (hop schedules, the
ring watchdog, the param specs, sharding) agree with the reference's.
None of these tests starts a process group.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import sharding as jax_sharding
from repro.configs import dit_moe_xl as jax_configs
from repro.core import moe as jax_moe
from repro.core import overlap as jax_overlap
from repro.core import plan as jax_plan
from repro.core import staleness as jax_stale
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro_torch import bridge
from repro_torch.common import sharding
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import moe, overlap
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.schedules import DiceConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models.dit_moe import init_dit
from repro_torch.sampling.rectified_flow import make_rf_step, rf_sample

torch.set_num_threads(1)

E, K, T, D = 8, 2, 24, 16


def _fake_mesh(rank, size):
    """An EPMesh with no process group: enough for what runs before the
    first collective (checks, slicing)."""
    return mesh_lib.EPMesh(group=None, rank=rank, size=size, backend="gloo",
                           device=torch.device("cpu"))


def _router(case):
    """(x, router, bias) whose probabilities tie for every token: all 8
    equal, a softmax saturated by a bias of 200 on expert 0 (the other 7
    underflow to 0), or pairs of equal logits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    bias = None
    if case == "equal":
        router[:] = 0.0
    elif case == "saturated":
        bias = np.zeros(E, np.float32)
        bias[0] = 200.0
    elif case == "pairs":                       # experts 2i and 2i+1 tie
        router[:] = 0.0
        bias = np.repeat(np.arange(E // 2, dtype=np.float32), 2)
    return x, router, bias


def _cfg(**kw):
    return configs.tiny().replace(num_experts=E, experts_per_token=K, **kw)


@pytest.mark.parametrize("case", ["equal", "saturated", "pairs"])
def test_route_breaks_ties_like_jax_top_k(case):
    x, router, bias = _router(case)
    p = {"router": torch.from_numpy(router)}
    jp = {"router": jnp.asarray(router)}
    if bias is not None:
        p["router_bias"], jp["router_bias"] = torch.from_numpy(bias), \
            jnp.asarray(bias)
    cfg = _cfg()
    probs, scores, idx = moe.route(p, torch.from_numpy(x), cfg)
    jprobs, jscores, jidx = jax_moe.route(jp, jnp.asarray(x),
                                         jax_configs.tiny().replace(
                                             num_experts=E,
                                             experts_per_token=K))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    # every token ties, and the lowest ids win
    want = [6, 7] if case == "pairs" else [0, 1]
    assert (idx.numpy() == want).all()
    # the same experts give the same slots, counts and capacity drops
    for cap in (4, 8):
        plan = moe.make_plan(idx, E, cap)
        jplan = jax_moe.make_plan(jidx, E, cap)
        for f in ("slot", "t_sorted", "inv_order", "keep", "counts"):
            np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                          np.asarray(getattr(jplan, f)), f)


def test_router_jitter_is_refused_where_a_step_is_built():
    cfg = configs.tiny().replace(router_jitter=0.01)
    params = init_dit(configs.tiny(), generator=torch.Generator())
    with pytest.raises(ValueError, match="JAX PRNG keys"):
        make_rf_step(params, cfg, dt=0.25)
    with pytest.raises(ValueError, match="JAX PRNG keys"):
        rf_sample(params, cfg, DiceConfig.dice(), num_steps=2,
                  classes=torch.zeros(2, dtype=torch.int64),
                  noise=torch.zeros(2, cfg.patch_tokens, cfg.in_channels))
    with pytest.raises(ValueError, match="JAX PRNG keys"):
        serve.DiceServer(cfg, DiceConfig.dice(), params=params, device="cpu")
    # no jitter builds as before
    make_rf_step(params, configs.tiny(), dt=0.25)


def test_make_ep_mesh_refuses_nccl_on_a_shared_card():
    """NCCL refuses two ranks on one device; the mesh says so itself and
    never falls back to gloo."""
    with pytest.raises(ValueError, match="one card per rank"):
        mesh_lib.make_ep_mesh(2, backend="nccl")
    with pytest.raises(ValueError, match="one card per rank"):
        mesh_lib.make_ep_mesh(2, backend="nccl", device="cuda")
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="Duplicate GPU"):
            mesh_lib.rank_device("nccl", 1, 2, dev)
        with pytest.raises(ValueError, match="one card per rank"):
            mesh_lib.spawn(print, 2, backend="nccl", device=dev)
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.make_ep_mesh(2, backend="mpi", device="cpu")


@pytest.mark.parametrize("axes", [dict(dp=2), dict(patch=2),
                                  dict(ep=2, dp=2, patch=2)])
def test_make_mesh_refuses_dp_and_patch(axes):
    """The dp and patch axes are built now (tests/test_torch_hier_mesh.py);
    what is still refused is a mesh without its ranks: no process group,
    or NCCL ranks that would share a card."""
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(backend="gloo", device="cpu", **axes)
    with pytest.raises(ValueError, match="one card per rank"):
        mesh_lib.make_mesh(backend="nccl", device="cuda", **axes)


def test_make_mesh_validates_sizes_and_needs_a_process_group():
    with pytest.raises(ValueError, match="integers"):
        mesh_lib.make_mesh(ep=0, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(ep=2, backend="gloo", device="cpu")
    assert mesh_lib.rank_device("gloo", 1, 2, "cpu") == torch.device("cpu")
    mesh = _fake_mesh(1, 4)
    assert mesh_lib.axis_size(mesh, "ep") == 4
    assert mesh_lib.axis_size(mesh, "dp") == mesh_lib.axis_size(None, "ep") \
        == 1
    assert mesh.shape == {"ep": 4} and mesh.axis_names == ("ep",)
    assert not mesh.stages_p2p


def test_experts_and_batches_must_divide_over_the_mesh():
    cfg = _cfg(num_layers=1)
    params = init_dit(cfg, generator=torch.Generator())
    with pytest.raises(ValueError, match="num_experts=8 must divide"):
        make_rf_step(params, cfg, dt=0.5, mesh=_fake_mesh(0, 3))
    with pytest.raises(ValueError, match="num_experts=8 must divide"):
        moe.moe_forward(params["blocks"][0]["moe"], torch.zeros(T, cfg.d_model),
                        cfg, mesh=_fake_mesh(0, 3))
    with pytest.raises(ValueError, match="batch 6 must divide"):
        rf_sample(params, cfg, DiceConfig.dice(), num_steps=2,
                  classes=torch.zeros(6, dtype=torch.int64),
                  noise=torch.zeros(6, cfg.patch_tokens, cfg.in_channels),
                  mesh=_fake_mesh(0, 4))
    server = serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                              mesh=_fake_mesh(0, 4))
    assert server.n_dev == 4 and server.device == torch.device("cpu")
    with pytest.raises(ValueError, match="max_batch=6 must divide"):
        serve.serve_continuous(server, [serve.Request(1, 0)], max_batch=6)
    with pytest.raises(TypeError, match="EPMesh"):
        serve.DiceServer(cfg, DiceConfig.dice(), params=params, mesh=object())
    with pytest.raises(ValueError, match="device"):
        serve.DiceServer(cfg, DiceConfig.dice(), params=params,
                         mesh=_fake_mesh(0, 4), device="cuda")


@pytest.mark.parametrize("sched,n", [(None, 4), ((1, 2, 3), 4),
                                     ((3, 1, 2), 4), ((2, 1), 3), ((1,), 2),
                                     ((2, 2, 1), 4), ((1, 2), 4), ((3, 1), 1)])
def test_normalize_hop_schedule_matches_reference(sched, n):
    def outcome(fn):
        try:
            return ("ok", fn(sched, n))
        except ValueError:
            return ("raised", "ValueError")
    assert outcome(plan_lib.normalize_hop_schedule) == \
        outcome(jax_plan.normalize_hop_schedule)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("engine", ["blocking", "ring"])
def test_normalize_overlap_keeps_the_ring_on_a_mesh(n, engine):
    mine = plan_lib.normalize_overlap(DiceConfig.dice(overlap=engine), n)
    ref = jax_plan.normalize_overlap(JaxDice.dice(overlap=engine), n)
    assert mine.overlap == ref.overlap == \
        ("ring" if engine == "ring" and n > 1 else "blocking")
    steps = plan_lib.compile_step_plans(mine, 4, 6, experts_per_token=2)
    jsteps = jax_plan.compile_step_plans(ref, 4, 6, experts_per_token=2)
    assert [[a.overlap for a in p.actions] for p in steps.steps] == \
        [[a.overlap for a in p.actions] for p in jsteps.steps]


@pytest.mark.parametrize("wall,base,factor,floor", [
    (1.0, 0.0, 2.0, 0.0), (3.0, 1.0, 2.0, 0.0), (1.5, 1.0, 2.0, 0.0),
    (2.5, 1.0, 2.0, 3.0), (3.5, 1.0, 2.0, 3.0), (2.0, 1.0, 2.0, 0.0)])
def test_hop_anomaly_matches_reference(wall, base, factor, floor):
    assert overlap.hop_anomaly(wall, base, factor, floor_s=floor) == \
        jax_overlap.hop_anomaly(wall, base, factor, floor_s=floor)


def _tiny_tree():
    cfg = jax_configs.tiny().replace(num_layers=2)
    return jax.device_get(jax_init_dit(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("ep_axis", ["ep", None])
def test_ep_param_specs_match_reference(ep_axis):
    tree = _tiny_tree()
    tree["blocks"][0]["moe"]["experts_gate_rep"] = \
        tree["blocks"][0]["moe"]["experts_gate"][:1]
    ref = jax_sharding.ep_param_specs(tree, ep_axis=ep_axis)
    mine = sharding.ep_param_specs(tree, ep_axis=ep_axis)
    ref_leaves = bridge.leaves(jax.tree.map(
        lambda s: s[0] if len(s) else None, ref,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    assert bridge.leaves(mine) == ref_leaves
    assert ("ep" in bridge.leaves(mine).values()) == (ep_axis is not None)


@pytest.mark.parametrize("rank", [0, 3])
def test_ep_shard_params_keeps_the_rank_rows(rank):
    tree = _tiny_tree()
    full = bridge.from_jax_params(tree, device="cpu")
    mesh = _fake_mesh(rank, 4)
    mine = sharding.ep_shard_params(full, mesh)
    e = full["blocks"][0]["moe"]["router"].shape[-1]
    rows = slice(rank * e // 4, (rank + 1) * e // 4)
    for path, leaf in bridge.leaves(full).items():
        got = bridge.leaves(mine)[path]
        want = leaf[rows] if ".experts_" in path else leaf
        assert torch.equal(got, want), path
    # sharding a sharded tree changes nothing
    again = sharding.ep_shard_params(mine, mesh)
    assert all(torch.equal(a, b) for a, b in
               zip(bridge.leaves(again).values(), bridge.leaves(mine).values()))
    assert sharding.expert_slice(e, mesh) == rows


def test_init_dit_keeps_the_rank_rows_of_the_full_init():
    cfg = configs.tiny().replace(num_layers=2)
    full = init_dit(cfg, generator=torch.Generator().manual_seed(3))
    rows = slice(2, 4)
    part = init_dit(cfg, generator=torch.Generator().manual_seed(3),
                    experts=rows)
    for path, leaf in bridge.leaves(full).items():
        want = leaf[rows] if ".experts_" in path else leaf
        assert torch.equal(bridge.leaves(part)[path], want), path


def test_ep_place_batch_takes_the_rank_rows():
    a = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(sharding.ep_place_batch(a, _fake_mesh(2, 4)), a[4:6])
    assert sharding.local_rows(8, _fake_mesh(3, 4)) == slice(6, 8)
    assert sharding.local_rows(8, None) == slice(0, 8)
    with pytest.raises(ValueError, match="batch 6"):
        sharding.ep_place_batch(a[:6], _fake_mesh(0, 4))


@pytest.mark.parametrize("step", [0, 2, 3])
def test_moe_step_matches_reference(step):
    """The step-indexed shim over apply_layer_action, one device."""
    tree = _tiny_tree()
    cfg, jcfg = configs.tiny(), jax_configs.tiny()
    p = bridge.from_jax_params(tree, device="cpu")["blocks"][1]["moe"]
    x = np.random.default_rng(4).standard_normal(
        (32, cfg.d_model)).astype(np.float32)
    dcfg, jdcfg = DiceConfig.dice(), JaxDice.dice()
    splan = plan_lib.compile_step_plans(dcfg, cfg.num_layers, 6,
                                        experts_per_token=2)
    st = stale_lib.init_planned_states(splan, num_tokens=32,
                                       d_model=cfg.d_model, k=2)[1]
    jst = jax_stale.MoELayerState(**{
        f.name: None if getattr(st, f.name) is None
        else jnp.asarray(getattr(st, f.name).numpy())
        for f in dataclasses.fields(st)})
    y, _, aux = stale_lib.moe_step(p, torch.from_numpy(x), cfg, dcfg, st,
                                   moe_layer_idx=1,
                                   num_moe_layers=cfg.num_layers,
                                   step_idx=step)
    jy, _, jaux = jax_stale.moe_step(tree["blocks"][1]["moe"], jnp.asarray(x),
                                     jcfg, jdcfg, jst, moe_layer_idx=1,
                                     num_moe_layers=jcfg.num_layers,
                                     step_idx=step)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    assert aux.dispatch_bytes == int(jaux.dispatch_bytes)
