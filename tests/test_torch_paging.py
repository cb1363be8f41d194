"""The port's expert paging against the JAX package's, on the CPU.

In process, case for case with tests/test_paging.py: the pool's geometry
(phantom padding to ``E_pad``), budget arithmetic, the residency ledger,
``PagingSpec`` validation, the params <-> pool split, the streamed
``load_pooled_checkpoint`` of a file the reference wrote, plan stamping,
``normalize_paging``, paging x placement, budget validation and the
fetch ladder (error releases its reservation, retry, stale fallback,
deadline): each port pool runs the same sequence as a reference pool and
must give its counts, windows and peaks.

Over a mesh: the reference runs ``rf_sample(mesh=make_ep_mesh(4))`` paged
at the auto budget in a subprocess with 4 forced XLA host devices, on the
4-layer config of tests/test_paging.py (capacity factor 8, 6 steps,
``guidance=1.0``); the port runs the same in 4 spawned gloo ranks, on the
reference's params and noise, once per module.  Tolerances: samples
within TOL_F32 of the reference's (rtol = atol = 1e-4: f32 end to end,
sums in another order); paged against the port's own resident run bit
for bit; counts exactly.

Time limits: the reference subprocess 400 s (about 45 s here; the port's
ranks run beside it), each spawn 120 s.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import dit_moe_xl as jax_configs
from repro.core import paging as jax_paging
from repro.core import plan as jax_plan
from repro.core.schedules import DiceConfig as JaxDice
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.resilience import faults as jax_faults
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import paging
from repro_torch.core import plan as plan_lib
from repro_torch.core.paging import EXPERT_LEAF_NAMES, ExpertPool, PagingSpec
from repro_torch.core.placement import Placement
from repro_torch.core.schedules import DiceConfig, Schedule
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.dit_moe import init_dit
from repro_torch.resilience import faults
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP = 4
STEPS = jobs.STEPS
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
REF_TIMEOUT_S = 400
RANK_TIMEOUT_S = 120
SCHEDULES = ("sync", "displaced", "interweaved", "selective", "dice")
FAULTS = "seed=3,paging_err=0.3"
STATS = ("paged_transfers", "paged_bytes_in", "peak_resident_expert_bytes",
         "expert_hbm_budget", "num_plan_variants")


def _layers(num_layers=3, e=8, d=4, f=6):
    rng = np.random.default_rng(0)
    return {i: {"experts_gate": rng.normal(size=(e, d, f)).astype(np.float32),
                "experts_up": rng.normal(size=(e, d, f)).astype(np.float32),
                "experts_down": rng.normal(size=(e, f, d)).astype(np.float32)}
            for i in range(num_layers)}


def _pools(n_dev, **kw):
    layers = _layers(**kw)
    return ExpertPool(layers, n_dev=n_dev), \
        jax_paging.ExpertPool(layers, n_dev=n_dev)


def _ledger(pool):
    return (pool.transfers, pool.bytes_transferred, pool.peak_resident_bytes,
            pool.fetch_errors, pool.fetch_retries, pool.stale_fallbacks,
            {j: list(w) for j, w in pool._resident.items()})


def _port_res(**kw):
    fault_kw = {k: kw.pop(k) for k in list(kw)
                if k in ("seed", "paging_error_rate")}
    return faults.ResilienceConfig(
        faults=faults.FaultConfig(**fault_kw) if fault_kw else None, **kw)


def _ref_res(**kw):
    from repro.resilience import FaultConfig, ResilienceConfig
    fault_kw = {k: kw.pop(k) for k in list(kw)
                if k in ("seed", "paging_error_rate")}
    return ResilienceConfig(faults=FaultConfig(**fault_kw) if fault_kw
                            else None, **kw)


def _both_fetch(mine, ref, layer, j):
    """The same fetch on both pools: the port's data (its device slot) and
    the reference's, or both errors' messages."""
    try:
        want = ref._fetch_host(layer, np.int32(j))
    except jax_paging.PagingFetchError as e:
        with pytest.raises(paging.PagingFetchError) as got:
            mine.fetch(layer, j)
        assert str(got.value) == str(e)
        return None
    slot = mine.fetch(layer, j)
    for k, w in zip(EXPERT_LEAF_NAMES, want):
        np.testing.assert_array_equal(slot.acquire()[k].numpy(), w)
    return slot


# ---------------------------------------------------------------------------
# pool geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,n_dev", [(12, 8), (8, 8), (6, 4), (3, 4)])
def test_pool_pads_to_multiple_of_n_dev(e, n_dev):
    mine, ref = _pools(n_dev, e=e)
    assert (mine.num_experts, mine.num_wire_experts, mine.e_loc) == \
        (ref.num_experts, ref.num_wire_experts, ref.e_loc)
    for j in range(n_dev):
        # every shard equals the reference's, phantom rows (zeros) included
        for k, w in zip(EXPERT_LEAF_NAMES, ref._slice_shards(0, j)):
            np.testing.assert_array_equal(mine.shard(0, j)[k].numpy(), w)
        # a rank's own pool holds just that shard
        own = ExpertPool(_layers(e=e), n_dev=n_dev, rank=j)
        assert own.total_host_bytes() == mine.total_host_bytes() // n_dev
        for k in EXPERT_LEAF_NAMES:
            assert torch.equal(own.shard(0)[k], mine.shard(0, j)[k])
    assert mine.shard_shape_dtypes(0)[0][0] == ref.shard_shape_dtypes(0)[0][0]


def test_pool_budget_arithmetic():
    mine, ref = _pools(4, num_layers=4, e=8)
    assert mine.layer_shard_bytes(0) == ref.layer_shard_bytes(0)
    assert mine.window_bytes([0, 1]) == ref.window_bytes([0, 1])
    for depth in (1, 2, 3):
        assert mine.min_budget_bytes(depth) == ref.min_budget_bytes(depth)
    assert mine.total_host_bytes() == ref.total_host_bytes()


def test_pool_fetch_ledger_tracks_peak():
    mine, ref = _pools(4, num_layers=4, e=8)
    mine._resident_window = ref._resident_window = 2
    for layer in (0, 1, 2, 3, 3, 1):           # a re-fetch refreshes
        _both_fetch(mine, ref, layer, 0)
        assert _ledger(mine) == _ledger(ref)
    assert mine.peak_resident_bytes == 2 * mine.layer_shard_bytes(0)
    mine.reset_stats()
    ref.reset_stats()
    assert _ledger(mine) == _ledger(ref) == (0, 0, 0, 0, 0, 0, {})


def test_pool_rejects_nonuniform_expert_counts():
    layers = _layers(num_layers=2, e=8)
    layers[1] = {k: v[:6] for k, v in layers[1].items()}
    with pytest.raises(ValueError, match="uniform expert count"):
        jax_paging.ExpertPool(layers, n_dev=4)
    with pytest.raises(ValueError, match="uniform expert count"):
        ExpertPool(layers, n_dev=4)


@pytest.mark.parametrize("kw,match", [(dict(depth=0), "depth"),
                                      (dict(budget_bytes=-1), "budget")])
def test_paging_spec_validation(kw, match):
    for cls in (PagingSpec, jax_paging.PagingSpec):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


# ---------------------------------------------------------------------------
# params <-> pool split + streamed pooled restore
# ---------------------------------------------------------------------------
def _tiny():
    cfg = jax_configs.tiny().replace(num_layers=2, d_model=32, moe_d_ff=32,
                                     d_ff=64, num_heads=2, num_kv_heads=2,
                                     head_dim=16, patch_tokens=8)
    return cfg, jax.device_get(jax_init_dit(jax.random.PRNGKey(0), cfg))


def _port_cfg(jcfg):
    return configs.tiny().replace(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _assert_split(stripped, pool, tree, ref_pool, rank=None):
    assert not paging.has_expert_leaves(stripped)
    assert pool.num_layers == ref_pool.num_layers
    for i, blk in enumerate(tree["blocks"]):
        for j in range(ref_pool.n_dev) if rank is None else (rank,):
            for k, w in zip(EXPERT_LEAF_NAMES, ref_pool._slice_shards(i, j)):
                np.testing.assert_array_equal(
                    pool.shard(i, j)[k].numpy(), w)
        np.testing.assert_array_equal(
            stripped["blocks"][i]["moe"]["router"].numpy(),
            np.asarray(blk["moe"]["router"]))


@pytest.mark.parametrize("rank", [None, 0, 3])
def test_strip_and_pool_partition_params(rank):
    cfg, tree = _tiny()
    params = bridge.from_jax_params(tree, device="cpu")
    assert paging.has_expert_leaves(params)
    pool = paging.pool_from_params(params, n_dev=4, rank=rank)
    ref_pool = jax_paging.pool_from_params(tree, n_dev=4)
    _assert_split(paging.strip_expert_params(params), pool, tree, ref_pool,
                  rank)
    assert paging.has_expert_leaves(params)          # not mutated


@pytest.mark.parametrize("rank", [None, 1])
def test_load_pooled_checkpoint_streams_the_split(rank):
    cfg, tree = _tiny()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.msgpack")
        jax_save_checkpoint(path, tree)              # the reference's file
        like = init_dit(_port_cfg(cfg), generator=None)
        stripped, pool = paging.load_pooled_checkpoint(
            path, like, n_dev=4, rank=rank, device="cpu")
        ref_stripped, ref_pool = jax_paging.load_pooled_checkpoint(
            path, tree, n_dev=4)
    _assert_split(stripped, pool, tree, ref_pool, rank)
    assert pool.rank == rank and pool.e_loc == ref_pool.e_loc


# ---------------------------------------------------------------------------
# plan stamping + normalization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2])
def test_plan_stamps_prefetch_and_resident(depth):
    mine = dataclasses.replace(DiceConfig.sync_ep(),
                               paging=PagingSpec(budget_bytes=None,
                                                 depth=depth))
    ref = dataclasses.replace(JaxDice.sync_ep(),
                              paging=jax_paging.PagingSpec(budget_bytes=None,
                                                           depth=depth))
    pm = plan_lib.plan_for_step(mine, 4, 5, experts_per_token=2)
    pr = jax_plan.plan_for_step(ref, 4, 5, experts_per_token=2)
    for a, b in zip(pm.actions, pr.actions):
        assert (a.prefetch, a.resident, a.paging.depth) == \
            (b.prefetch, b.resident, b.paging.depth)
    assert pm.actions[0].resident == tuple(range(depth + 1))
    assert pm.actions[3].prefetch is None


def test_normalize_paging_strips_meshless_plans_bit_identical():
    base = DiceConfig.dice()
    paged = dataclasses.replace(base, paging=PagingSpec(budget_bytes=None))
    norm = paging.normalize_paging(paged, 1)
    for step in range(4):
        assert plan_lib.plan_for_step(norm, 4, step, experts_per_token=2) == \
            plan_lib.plan_for_step(base, 4, step, experts_per_token=2)
    assert paging.paging_of(paging.normalize_paging(paged, 8))
    # one process: the sampler drops the spec, the samples are the resident
    cfg, tree = _tiny()
    cfg = _port_cfg(cfg)
    params = bridge.from_jax_params(tree, device="cpu")
    kw = dict(num_steps=3, classes=torch.arange(4) % cfg.num_classes,
              noise=torch.randn((4, cfg.patch_tokens, cfg.in_channels),
                                generator=torch.Generator().manual_seed(0)))
    x, st = rf_sample(params, cfg, base, **kw)
    xp, stp = rf_sample(params, cfg, paged, **kw)
    assert torch.equal(x, xp) and "paged_transfers" not in stp


def test_paging_excludes_placement():
    pl = Placement(perm=tuple(range(8)), replicated=(0,), cap_scale=0.5)
    for dcfg, mod in ((DiceConfig.sync_ep(), plan_lib),
                      (JaxDice.sync_ep(), jax_plan)):
        spec = (PagingSpec if mod is plan_lib else jax_paging.PagingSpec)()
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.plan_for_step(dataclasses.replace(
                dcfg, paging=spec, placements=(pl,) * 2), 2, 0,
                experts_per_token=2)


def test_validate_plan_rejects_infeasible_budget():
    mine, ref = _pools(4, num_layers=4, e=8)
    splans = [mod.compile_step_plans(dataclasses.replace(
        dc, paging=spec(budget_bytes=1)), 4, 4, experts_per_token=2)
        for mod, dc, spec in ((plan_lib, DiceConfig.sync_ep(), PagingSpec),
                              (jax_plan, JaxDice.sync_ep(),
                               jax_paging.PagingSpec))]
    with pytest.raises(ValueError, match="budget") as got:
        mine.validate_plan(splans[0])
    with pytest.raises(ValueError, match="budget") as want:
        ref.validate_plan(splans[1])
    assert str(got.value) == str(want.value)
    ok = dataclasses.replace(DiceConfig.sync_ep(), paging=PagingSpec(
        budget_bytes=mine.min_budget_bytes(1)))
    mine.validate_plan(plan_lib.compile_step_plans(ok, 4, 4,
                                                   experts_per_token=2))


@pytest.mark.parametrize("budget", [0, None, 12345])
def test_resolve_budget_auto_sentinel(budget):
    mine, ref = _pools(4, num_layers=4, e=8)
    got = paging.paging_of(paging.resolve_budget(dataclasses.replace(
        DiceConfig.sync_ep(), paging=PagingSpec(budget_bytes=budget)), mine))
    want = jax_paging.paging_of(jax_paging.resolve_budget(dataclasses.replace(
        JaxDice.sync_ep(), paging=jax_paging.PagingSpec(budget_bytes=budget)),
        ref))
    assert got.budget_bytes == want.budget_bytes
    assert budget != 0 or got.budget_bytes == mine.min_budget_bytes(1)


# ---------------------------------------------------------------------------
# the fetch ladder: reservation release, retry, stale fallback, deadline
# ---------------------------------------------------------------------------
def test_fetch_error_releases_reservation_no_budget_leak():
    mine, ref = _pools(4, num_layers=4, e=8)
    mine._resident_window = ref._resident_window = 2
    kw = dict(seed=0, paging_error_rate=1.0, paging_retries=2,
              paging_backoff_s=0.0, stale_fallback=False)
    mine.set_resilience(_port_res(**kw))
    ref.set_resilience(_ref_res(**kw))
    for layer in range(4):
        assert _both_fetch(mine, ref, layer, 0) is None
    assert _ledger(mine) == _ledger(ref)
    assert (mine.transfers, mine.peak_resident_bytes) == (0, 0)
    assert mine.fetch_errors == 12 and mine.fetch_retries == 8
    mine.set_resilience(_port_res(stale_fallback=True))
    ref.set_resilience(_ref_res(stale_fallback=True))
    _both_fetch(mine, ref, 0, 0)
    assert _ledger(mine) == _ledger(ref)
    assert mine.transfers == 1 and mine._resident[0] == [0]


def test_fetch_retry_then_success():
    rate = 0.5
    seed = next(s for s in range(1000)
                if faults.FaultPlan(faults.FaultConfig(
                    s, paging_error_rate=rate)).paging_error(0, 0, 1, 0)
                and not faults.FaultPlan(faults.FaultConfig(
                    s, paging_error_rate=rate)).paging_error(0, 0, 1, 1))
    mine, ref = _pools(4, num_layers=2, e=8)
    kw = dict(seed=seed, paging_error_rate=rate, paging_retries=2,
              paging_backoff_s=0.0)
    mine.set_resilience(_port_res(**kw))
    ref.set_resilience(_ref_res(**kw))
    assert _both_fetch(mine, ref, 0, 0) is not None
    assert _ledger(mine) == _ledger(ref)
    assert (mine.fetch_errors, mine.fetch_retries, mine.transfers) == (1, 1, 1)


def test_stale_fallback_serves_resident_shard():
    mine, ref = _pools(4, num_layers=2, e=8)
    mine.set_resilience(_port_res())
    ref.set_resilience(_ref_res())
    _both_fetch(mine, ref, 0, 0)
    kw = dict(seed=0, paging_error_rate=1.0, paging_retries=0,
              stale_fallback=True)
    mine.set_resilience(_port_res(**kw))
    ref.set_resilience(_ref_res(**kw))
    assert _both_fetch(mine, ref, 0, 0) is not None   # the same data
    assert _ledger(mine) == _ledger(ref)
    assert (mine.stale_fallbacks, mine.transfers) == (1, 1)
    assert mine._resident[0] == [0]


def test_fetch_deadline_cuts_retries_short():
    mine, ref = _pools(4, num_layers=2, e=8)
    kw = dict(seed=0, paging_error_rate=1.0, paging_retries=5,
              paging_backoff_s=10.0, paging_deadline_s=1e-3,
              stale_fallback=True)
    mine.set_resilience(_port_res(**kw))
    ref.set_resilience(_ref_res(**kw))
    _both_fetch(mine, ref, 0, 0)
    assert _ledger(mine) == _ledger(ref)
    assert (mine.fetch_errors, mine.fetch_retries, mine.stale_fallbacks) == \
        (1, 0, 1)


def test_fetches_emit_spans_into_the_step_tracer():
    """As the reference's pool does: a delivered fetch is a ``paged_fetch``
    span (layer, device, bytes, attempt), a fallback a
    ``paged_fetch_fallback`` one."""
    from repro_torch.obs import StepTracer
    mine, _ = _pools(4, num_layers=2, e=8)
    mine.tracer = StepTracer()
    mine.fetch(1, 2)
    mine.set_resilience(_port_res(seed=0, paging_error_rate=1.0,
                                  paging_retries=0, stale_fallback=True))
    mine.fetch(0, 3)
    spans = [(e["name"], e["args"]) for e in mine.tracer.events]
    assert spans == [
        ("paged_fetch", {"layer": 1, "dev": 2,
                         "bytes": mine.layer_shard_bytes(1), "attempt": 0}),
        ("paged_fetch_fallback", {"layer": 0, "dev": 3})]


# ---------------------------------------------------------------------------
# 4 gloo ranks against the reference's 4-device mesh
# ---------------------------------------------------------------------------
REF_PROG = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.compress.codecs import CompressConfig
    from repro.configs.dit_moe_xl import tiny
    from repro.core.paging import PagingSpec
    from repro.core.placement import PlacementConfig
    from repro.core.schedules import DiceConfig, Schedule
    from repro.launch.mesh import make_ep_mesh
    from repro.launch.serve import DiceServer, Request, serve_continuous
    from repro.models.dit_moe import init_dit
    from repro.resilience.faults import parse_resilience
    from repro.sampling.rectified_flow import rf_sample

    FAULTS = sys.argv[2]
    cfg = tiny().replace(num_layers=4, d_model=64, moe_d_ff=64, d_ff=256,
                         num_heads=4, num_kv_heads=4, head_dim=16,
                         patch_tokens=16, capacity_factor=8.0)
    params = init_dit(jax.random.PRNGKey(0), cfg)
    cfg6 = cfg.replace(num_experts=6)
    params6 = init_dit(jax.random.PRNGKey(0), cfg6)
    classes = jnp.arange(8) % cfg.num_classes
    key = jax.random.PRNGKey(7)
    mesh = make_ep_mesh(4)
    int8 = CompressConfig("int8_residual")
    auto = PagingSpec(budget_bytes=0)
    runs = {
        "sync": DiceConfig.sync_ep(), "displaced": DiceConfig.displaced(),
        "interweaved": DiceConfig.interweaved(),
        "selective": DiceConfig(schedule=Schedule.DICE, sync_policy="deep",
                                cond_comm=False),
        "dice": DiceConfig.dice(sync_policy="deep"),
        "ring_dice_int8": DiceConfig.dice(sync_policy="deep", compress=int8,
                                          overlap="ring"),
        "e6": DiceConfig.dice(sync_policy="deep"),
    }
    out = {}
    for name, dcfg in runs.items():
        c, p = (cfg6, params6) if name == "e6" else (cfg, params)
        x, st = rf_sample(p, c, dataclasses.replace(dcfg, paging=auto),
                          num_steps=6, classes=classes, key=key,
                          guidance=1.0, mesh=mesh)
        out[name + "/samples"] = np.asarray(x)
        for s in ("paged_transfers", "paged_bytes_in",
                  "peak_resident_expert_bytes", "expert_hbm_budget",
                  "num_plan_variants", "jit_cache_size", "dispatch_bytes",
                  "hop_bytes"):
            out[name + "/" + s] = np.asarray(st[s])
    reqs = [Request(class_id=int(c), rid=i) for i, c in enumerate(classes)]
    srv = DiceServer(cfg, DiceConfig.dice(), params=params, mesh=mesh,
                     paging=auto, resilience=parse_resilience(FAULTS))
    x, _ = srv.generate(reqs, num_steps=6, guidance=1.0, key=key)
    pool = srv.expert_pool
    out["faults/samples"] = np.asarray(x)
    out["faults/counts"] = np.asarray(
        [pool.transfers, pool.bytes_transferred, pool.fetch_errors,
         pool.fetch_retries, pool.stale_fallbacks, pool.peak_resident_bytes])
    _, st = serve_continuous(srv, reqs[:3], max_batch=4, num_steps=6,
                             guidance=1.0, key=key,
                             arrival_steps=[0.0, 0.0, 2.0])
    for s in ("ticks", "paged_transfers", "paged_bytes_in",
              "peak_resident_expert_bytes", "expert_hbm_budget",
              "paging_fetch_errors", "paging_fetch_retries",
              "paging_stale_fallbacks"):
        out["continuous/" + s] = np.asarray(st[s])
    try:
        DiceServer(cfg, DiceConfig.dice(), params=params, mesh=mesh,
                   paging=auto, placement=PlacementConfig(mode="greedy"))
    except ValueError as e:
        out["greedy"] = np.asarray(str(e))
    np.savez(sys.argv[1], **out)
""")


def _jax_cfg(E=8):
    return jax_configs.tiny().replace(
        num_layers=4, d_model=64, moe_d_ff=64, d_ff=256, num_heads=4,
        num_kv_heads=4, head_dim=16, patch_tokens=16, capacity_factor=8.0,
        num_experts=E)


def _cfg(E=8):
    return _port_cfg(_jax_cfg(E))


def _dcfg(name):
    int8 = CompressConfig("int8_residual")
    return {
        "sync": DiceConfig.sync_ep(), "displaced": DiceConfig.displaced(),
        "interweaved": DiceConfig.interweaved(),
        "selective": DiceConfig(schedule=Schedule.DICE, sync_policy="deep",
                                cond_comm=False),
        "dice": DiceConfig.dice(sync_policy="deep"),
        "ring_dice_int8": DiceConfig.dice(sync_policy="deep", compress=int8,
                                          overlap="ring"),
    }[name]


def _paged(dcfg, budget=0):
    return dataclasses.replace(dcfg, paging=PagingSpec(budget_bytes=budget))


@pytest.fixture(scope="module")
def trees():
    return {"e8": jax.device_get(jax_init_dit(jax.random.PRNGKey(0),
                                              _jax_cfg(8))),
            "e6": jax.device_get(jax_init_dit(jax.random.PRNGKey(0),
                                              _jax_cfg(6)))}


@pytest.fixture(scope="module")
def inputs():
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (8, 16, 4)))
    return noise, np.arange(8) % _jax_cfg().num_classes


@pytest.fixture(scope="module")
def both(tmp_path_factory, trees, inputs):
    """The reference's paged runs (a subprocess) and the port's (one spawn
    of 4 gloo ranks), side by side."""
    path = tmp_path_factory.mktemp("paging_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_PROG, str(path),
                             FAULTS], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        noise, classes = inputs
        runs = []
        for name in SCHEDULES + ("ring_dice_int8",):
            runs += [(name, "e8", _cfg(), _dcfg(name)),
                     ("paged_" + name, "e8", _cfg(), _paged(_dcfg(name)))]
        runs += [("paged_e6", "e6", _cfg(6), _paged(_dcfg("dice"))),
                 ("unpaged_e6", "e6", _cfg(6), _dcfg("dice")),
                 ("one_byte", "e8", _cfg(), _paged(_dcfg("dice"), 1))]
        port, counts = mesh_lib.spawn(
            jobs.paging_runs, EP, backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S,
            args=(trees, runs, noise, classes, [FAULTS], _cfg()))
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


@pytest.mark.parametrize("name", SCHEDULES + ("ring_dice_int8",))
def test_paged_ep4_matches_the_reference_and_the_resident_run(name, ref,
                                                              port):
    x, st, keys = port["paged_" + name]
    np.testing.assert_allclose(x.numpy(), ref[f"{name}/samples"], **TOL_F32)
    # E_pad == E: the padded wire is the resident one, bit for bit
    assert torch.equal(x, port[name][0])
    for k in STATS:
        assert st[k] == int(ref[f"{name}/{k}"]), k
    assert keys == [int(ref[f"{name}/jit_cache_size"])] * EP
    assert st["dispatch_bytes"] == port[name][1]["dispatch_bytes"] == \
        [float(b) for b in ref[f"{name}/dispatch_bytes"]]
    assert st["hop_bytes"] == [float(b) for b in ref[f"{name}/hop_bytes"]]
    # the budget holds 2 of 4 uniform layers: below full residency
    peak, budget = st["peak_resident_expert_bytes"], st["expert_hbm_budget"]
    assert 0 < peak <= budget < 2 * peak
    assert st["paged_transfers"] == STEPS * 4 * EP      # layers x ranks


def test_phantom_experts_decouple_e_from_the_mesh(ref, port, trees, inputs):
    """6 experts on 4 ranks (E_pad 8): the reference's paged run, its
    per-rank dispatch bytes (counted over the 8 wire experts); the port's
    single-process run to TOL_F32 (the padded wire changes only the order
    of sums); unpaged, the mesh refuses the expert count and names
    paging."""
    x, st, _ = port["paged_e6"]
    np.testing.assert_allclose(x.numpy(), ref["e6/samples"], **TOL_F32)
    for k in STATS:
        assert st[k] == int(ref[f"e6/{k}"]), k
    noise, classes = inputs
    single, st1 = rf_sample(bridge.from_jax_params(trees["e6"], device="cpu"),
                            _cfg(6), _dcfg("dice"), num_steps=STEPS,
                            classes=torch.as_tensor(classes),
                            noise=torch.as_tensor(noise), guidance=1.0)
    np.testing.assert_allclose(x.numpy(), single.numpy(), **TOL_F32)
    assert st["dispatch_bytes"] == [float(b) for b in ref["e6/dispatch_bytes"]]
    splan = plan_lib.compile_step_plans(_dcfg("dice"), 4, STEPS,
                                        experts_per_token=2)
    assert st["dispatch_bytes"] == [
        float(sum(8 * a.dispatch_capacity(32, _cfg(6)) * 64 * 4
                  for a in p.actions)) for p in splan.steps]
    assert "paging" in port["unpaged_e6"]


def test_infeasible_budget_raises_before_the_first_step(port):
    assert "budget" in port["one_byte"]


def test_fetch_faults_match_the_reference_counts(ref, port):
    """``paging_err=0.3`` with the default retries: the counts summed over
    the ranks equal the reference's single pool's, and the samples the
    clean run's bit for bit (the weights are static)."""
    x, tot = port[FAULTS]
    t, b, errs, retries, stale, peak = ref["faults/counts"].tolist()
    assert (tot["transfers"], tot["bytes_transferred"], tot["fetch_errors"],
            tot["fetch_retries"], tot["stale_fallbacks"],
            tot["peak_resident_bytes"]) == (t, b, errs, retries, stale, peak)
    assert errs > 0 and retries > 0
    assert torch.equal(x, port["paged_dice"][0])
    np.testing.assert_allclose(x.numpy(), ref["faults/samples"], **TOL_F32)


def test_serving_with_paging_and_the_registry(ref, port):
    got, st, series = port["continuous"]
    assert sorted(got) == [0, 1, 2]
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    keys = ("ticks", "paged_transfers", "paged_bytes_in",
            "peak_resident_expert_bytes", "expert_hbm_budget",
            "paging_fetch_errors", "paging_fetch_retries",
            "paging_stale_fallbacks")
    assert {k: st[k] for k in keys} == \
        {k: int(ref[f"continuous/{k}"]) for k in keys}
    assert series == {
        "dice_paged_transfers_total": st["paged_transfers"],
        "dice_paged_bytes_in_total": st["paged_bytes_in"],
        "dice_peak_resident_expert_bytes": st["peak_resident_expert_bytes"],
        "dice_expert_hbm_budget_bytes": st["expert_hbm_budget"],
        "dice_paging_fetch_errors_total": st["paging_fetch_errors"],
        "dice_paging_fetch_retries_total": st["paging_fetch_retries"],
        "dice_paging_stale_fallbacks_total": st["paging_stale_fallbacks"]}
    # the reference's refusal of paging with online greedy placement
    assert str(ref["greedy"]).startswith(port["greedy"])


def _first_unrecovered_fetch(spec, num_layers, steps):
    """Where the reference's pool raises under ``spec`` (stale fallback
    off): the reference's own ``_fetch_host`` over a step's fetch order
    (each pass fetches every layer once on every device)."""
    pool = jax_paging.ExpertPool(_layers(num_layers=num_layers, e=8), n_dev=EP)
    pool.set_resilience(jax_faults.parse_resilience(spec))
    for _ in range(steps):
        for layer in range(num_layers):
            for j in range(EP):
                try:
                    pool._fetch_host(layer, np.int32(j))
                except jax_paging.PagingFetchError as e:
                    return str(e)
    return None


def test_an_unrecovered_fetch_raises_where_the_reference_raises(trees,
                                                               inputs):
    """Stale fallback off: the reference's pool raises PagingFetchError at
    its first fetch whose every attempt fails; the port's rank of that
    device raises the same error, and the run fails instead of hanging."""
    spec = FAULTS + ",stale_fallback=0"
    want = _first_unrecovered_fetch(spec, 4, STEPS)
    assert want is not None
    noise, classes = inputs
    with pytest.raises(RuntimeError) as got:
        mesh_lib.spawn(jobs.paging_runs, EP, backend="gloo", device="cpu",
                       timeout_s=RANK_TIMEOUT_S,
                       args=({"e8": trees["e8"]},
                             [("dice", "e8", _cfg(), _dcfg("dice"))],
                             noise, classes, [spec], _cfg()))
    assert f"PagingFetchError: {want}" in str(got.value)


def test_cli_pages_with_faults_and_a_pooled_checkpoint(tmp_path):
    """``--paging on`` over 2 gloo ranks, restoring a checkpoint the port
    wrote straight into each rank's pool, with fetch faults."""
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.configs.dit_moe_xl import tiny
    path = tmp_path / "tiny.ckpt"
    save_checkpoint(str(path), init_dit(
        tiny(), generator=torch.Generator().manual_seed(5)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--ep", "2",
            "--backend", "gloo", "--device", "cpu", "--requests", "2",
            "--steps", "2", "--ckpt", str(path)]
    paged = subprocess.run(base + ["--paging", "on", "--faults",
                                   "seed=3,paging_err=0.3"],
                           env=env, cwd=REPO, capture_output=True, text=True,
                           timeout=RANK_TIMEOUT_S)
    assert paged.returncode == 0, paged.stderr[-3000:]
    assert "expert paging (depth 1" in paged.stdout
    assert "paged_transfers" in paged.stdout and "finite=True" in \
        paged.stdout
