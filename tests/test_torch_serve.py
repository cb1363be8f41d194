"""The port's serving engines against the JAX package's, on the CPU.

Continuous batching (``serve_continuous``), rigid FIFO batches
(``serve_queue``) and the pure-Python layers under them: the conditional-
communication arithmetic, the continuous-batching planners, the ring hop
helpers, the modeled latency of the paper's deployment, ``reset_slots``,
the admission queue, the metrics registry and the step tracer.

The engines run the 4-layer config of ``tests/test_serve_continuous.py``
(d 64, 16 tokens, capacity_factor 8.0, so no dispatch can overflow) with
its perturbed adaLN and output layer, carried over through
``repro_torch.bridge``; the reference's ``request_noise`` arrays go to the
port as ``noise={rid: array}``.  Samples agree within rtol 1e-4 / atol
1e-5 (f32 end to end, matrix products summed in another order, as in
``tests/test_torch_slice.py``); every count of ticks, admissions and bytes
agrees exactly, and the modeled latency to rel 1e-12.  The port's own
recycled-slot samples must equal its own fresh-batch samples bit for bit.
Each reference run happens once, in module-scoped fixtures.
"""
import dataclasses
import io
from collections import namedtuple
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core import conditional as jax_cond
from repro.core import overlap as jax_overlap
from repro.core import plan as jax_plan
from repro.core import staleness as jax_stale
from repro.core.schedules import DiceConfig as JaxDice
from repro.launch import serve as jax_serve
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import StepTracer as JaxTracer
from repro.resilience.recovery import AdmissionQueue as JaxQueue
from repro.sampling.rectified_flow import make_rf_step as jax_make_rf_step
from repro_torch import bridge
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import conditional, overlap, plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.moe import default_capacity
from repro_torch.core.placement import Placement
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.obs import MetricsRegistry, StepTracer, parse_prometheus
from repro_torch.resilience.faults import FaultConfig, ResilienceConfig
from repro_torch.resilience.recovery import AdmissionQueue
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 4
SCHEDULES = ("sync", "displaced", "interweaved", "dice", "staggered_batch")
CODEC_SCHEDULES = ("displaced", "interweaved", "dice")
ENGINES = ("sync", "interweaved", "dice", "dice_int8")
# (key, [(class_id, rid)], arrival ticks) of the reference's
# test_recycled_slot_bit_identical and test_jit_cache_stays_at_plan_variant_count
SCENARIOS = {
    "recycled": (42, [(1, 0), (2, 1), (3, 2)], [0.0, 0.0, 1.0]),
    "plan_keys": (3, [(i % 8, i) for i in range(5)], [0.0, 0.0, 1.0, 3.0, 5.0]),
}
COUNTS = ("ticks", "makespan_steps", "padded_slot_steps", "slot_occupancy",
          "slotted_ticks", "admissions", "recycled_admissions",
          "steady_period", "buffer_bytes", "dispatch_bytes_total",
          "wire_bytes_total", "raw_bytes_total", "num_plan_variants")
MODELED = ("modeled_step_s", "modeled_total_s")


def _dcfgs(name, codec="none", overlap="blocking"):
    """The same schedule config in both packages."""
    if name == "dice_int8":
        name, codec = "dice", "int8_residual"
    if name == "sync":
        return (DiceConfig.sync_ep(overlap=overlap),
                JaxDice.sync_ep(overlap=overlap))
    if name == "staggered_batch":
        return (DiceConfig.staggered_batch(overlap=overlap),
                JaxDice.staggered_batch(overlap=overlap))
    if codec == "none":
        return (getattr(DiceConfig, name)(overlap=overlap),
                getattr(JaxDice, name)(overlap=overlap))
    return (getattr(DiceConfig, name)(compress=CompressConfig(codec),
                                      overlap=overlap),
            getattr(JaxDice, name)(compress=JaxCompress(codec),
                                   overlap=overlap))


def _action_fields(a):
    out = {}
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        out[f.name] = v.kind if f.name == "codec" and v is not None else v
    return out


def _assert_plan_equal(mine, ref):
    assert (mine.schedule, mine.is_warmup) == (ref.schedule, ref.is_warmup)
    assert [_action_fields(a) for a in mine.actions] == \
        [_action_fields(a) for a in ref.actions]


def _outcome(fn, *args, **kw):
    """A call's value, or the name of what it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:            # compared, never swallowed
        return ("raised", type(e).__name__)


# ---------------------------------------------------------------------------
# pure-Python layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["low", "high", "random"])
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conditional_arithmetic_matches_reference(policy, stride):
    k = 2
    cfg = configs.config()
    cap = lambda kk: default_capacity(8 * cfg.patch_tokens, cfg, k=kk)  # noqa: E731
    assert conditional.comm_volume_fraction(k, stride, policy) == \
        jax_cond.comm_volume_fraction(k, stride, policy)
    assert conditional.comm_volume_fraction(k, stride, policy, light_scale=0.26) \
        == jax_cond.comm_volume_fraction(k, stride, policy, light_scale=0.26)
    assert conditional.expected_dispatch_fraction(k, stride, policy, cap) == \
        jax_cond.expected_dispatch_fraction(k, stride, policy, cap)
    for step in range(6):
        assert conditional.effective_k(step, k, stride=stride, policy=policy) \
            == jax_cond.effective_k(step, k, stride=stride, policy=policy)
        if policy == "random":
            continue
        mine = conditional.fresh_mask(step, 6, k, stride=stride, policy=policy,
                                      device="cpu")
        ref = jax_cond.fresh_mask(step, 6, k, stride=stride, policy=policy)
        assert (mine is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("codec", ["none", "int8_residual"])
@pytest.mark.parametrize("num_layers", [4, 28])
def test_continuous_planners_match_reference(name, codec, num_layers):
    mine_cfg, ref_cfg = _dcfgs(name, codec)
    kw = dict(experts_per_token=2)
    _assert_plan_equal(
        plan_lib.steady_state_plan_for(mine_cfg, num_layers, **kw),
        jax_plan.steady_state_plan_for(ref_cfg, num_layers, **kw))
    _assert_plan_equal(
        plan_lib.slotted_merge_plan(mine_cfg, num_layers, **kw),
        jax_plan.slotted_merge_plan(ref_cfg, num_layers, **kw))
    assert plan_lib.steady_period(mine_cfg, num_layers, **kw) == \
        jax_plan.steady_period(ref_cfg, num_layers, **kw)
    _assert_plan_equal(
        plan_lib.steady_state_plan(name, num_moe_layers=num_layers),
        jax_plan.steady_state_plan(name, num_moe_layers=num_layers))
    assert plan_lib.placement_wire_scale(mine_cfg) == \
        jax_plan.placement_wire_scale(ref_cfg) == 1.0
    # the merge plan is the refresh variant a run already holds
    splan = plan_lib.compile_step_plans(mine_cfg, num_layers, 8, **kw)
    assert plan_lib.slotted_merge_plan(mine_cfg, num_layers, **kw) in splan.variants


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("H", [0, 2, 4])
def test_ring_hop_helpers_match_reference(n, H):
    for shift in range(n + 1):
        assert overlap.hop_crossings(shift, n, H) == \
            jax_overlap.hop_crossings(shift, n, H)
    for dph in (H, None):
        assert _outcome(overlap.ring_hop_schedule, n, devices_per_host=dph) == \
            _outcome(jax_overlap.ring_hop_schedule, n, devices_per_host=dph)


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("codec", ["none", "int8_residual"])
@pytest.mark.parametrize("devices_per_host", [0, 4])
@pytest.mark.parametrize("engine", ["blocking", "ring"])
def test_modeled_step_latency_matches_reference(name, n_dev, codec,
                                                devices_per_host, engine):
    mine_cfg, ref_cfg = _dcfgs(name, codec, overlap=engine)
    kw = dict(local_batch=max(1, 8 // n_dev), n_dev=n_dev,
              devices_per_host=devices_per_host, inter_host_bw=0.2e9)
    mine = serve.modeled_step_latency(configs.config(), mine_cfg,
                                      hw=serve.PAPER_HW, **kw)
    ref = jax_serve.modeled_step_latency(jax_configs.config(), ref_cfg,
                                         hw=jax_serve.PAPER_HW, **kw)
    assert serve.PAPER_HW == jax_serve.PAPER_HW
    assert mine.keys() == ref.keys()
    assert mine["hop_schedule"] == ref["hop_schedule"]
    for key in mine:
        if key != "hop_schedule":
            assert mine[key] == pytest.approx(ref[key], rel=1e-12, abs=0), key
    # the default hardware is the paper's, in both packages
    assert serve.modeled_step_latency(configs.config(), mine_cfg, **kw) == mine


@pytest.mark.parametrize("layout", ["flat", "factored"])
def test_reset_slots_matches_reference(layout):
    rng = np.random.default_rng(0)
    B, T, K, d = 3, 4, 2, 5
    lead = (B * T,) if layout == "flat" else (B, T)
    arrays = {i: {"y_buf": rng.standard_normal(lead + (d,)),
                  "x_prev": rng.standard_normal(lead + (d,)) if i == 0 else None,
                  "h_cache": rng.standard_normal(lead + (K, d)),
                  "c_base": None}
              for i in range(2)}
    mask = np.array([True, False, True])

    def states(cls, conv):
        return {i: cls(**{k: None if v is None else conv(v.astype(np.float32))
                          for k, v in a.items()}) for i, a in arrays.items()}
    mine = stale_lib.reset_slots(states(stale_lib.MoELayerState, torch.from_numpy),
                                 torch.from_numpy(mask), tokens_per_slot=T)
    ref = jax_stale.reset_slots(states(jax_stale.MoELayerState, jnp.asarray),
                                jnp.asarray(mask), tokens_per_slot=T)
    for i in arrays:
        for field in ("y_buf", "x_prev", "h_cache", "c_base"):
            m, r = getattr(mine[i], field), getattr(ref[i], field)
            assert (m is None) == (r is None)
            if r is not None:
                np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    assert float(mine[0].y_buf.abs().sum()) > 0


def test_admission_queue_matches_reference():
    Req = namedtuple("Req", "rid class_id")

    def script(q):
        log = []
        for i, arrival in enumerate([0, 0, 1, 3, 3, 3, 4, 9]):
            q.push(float(arrival), Req(i, i % 3))
        for tick in range(12):
            got = q.pop_ready(tick)
            log.append(("pop", tick, None if got is None else got.rid))
            if tick == 2:
                log.append(("requeue", q.requeue(tick, Req(0, 0), 1),
                            q.requeue(tick, Req(0, 0), 1)))
            log.append(("shed", tick, q.shed_overdue(tick, retry_after=2.0)))
            log.append(("state", len(q), q.next_arrival(), q.waiting(tick),
                        q.peak_depth))
        return log, q.shed, q.requeues
    for bounds in ((0, 0), (2, 0), (0, 3), (2, 3)):
        assert script(AdmissionQueue(*bounds)) == script(JaxQueue(*bounds))


def _fill_registry(reg):
    lab = {"schedule": "dice", "engine": "continuous"}
    reg.counter("dice_ticks_total", "engine ticks", lab).inc()
    reg.counter("dice_ticks_total", "", lab).inc(2.5)
    reg.gauge("dice_buffer_bytes", "buffer bytes", lab).set(7)
    reg.gauge("dice_plan_variants", "variants", lab).set_max(3)
    reg.gauge("dice_plan_variants", "", lab).set_max(2)
    h = reg.histogram("dice_request_e2e_seconds", "e2e", lab)
    for v in (0.003, 0.2, 1.5, 70.0):
        h.observe(v)
    reg.series("dice_slot_occupancy", "occupancy", lab).extend([0.5, 1.0])
    reg.counter("dice_admissions_total", "admissions",
                {**lab, "engine": "queue"}).inc(4)
    other = type(reg)()
    other.counter("dice_ticks_total", "", lab).inc(1)
    other.histogram("dice_request_e2e_seconds", "", lab).observe(0.01)
    reg.merge(other)
    return reg


def test_metrics_registry_and_tracer_match_reference():
    mine, ref = _fill_registry(MetricsRegistry()), _fill_registry(JaxRegistry())
    assert mine.to_prometheus() == ref.to_prometheus()
    assert mine.snapshot() == ref.snapshot()
    assert parse_prometheus(mine.to_prometheus())["samples"][
        'dice_ticks_total{engine="continuous",schedule="dice"}'] == 4.5

    def trace(tr):
        with tr.span("tick", cat="step", args={"tick": 0}):
            tr.instant("admit", args={"rid": 3})
        tr.counter("queue_depth", 2)
        tr.complete("plan_build", tr.now(), cat="plan")
        return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
                for ev in tr.to_json()["traceEvents"]]
    assert trace(StepTracer()) == trace(JaxTracer())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _jax_cfg():
    return jax_configs.tiny().replace(num_layers=4, d_model=64, moe_d_ff=64,
                                      d_ff=256, patch_tokens=16,
                                      capacity_factor=8.0)


def _cfg():
    return configs.tiny().replace(num_layers=4, d_model=64, moe_d_ff=64,
                                  d_ff=256, patch_tokens=16,
                                  capacity_factor=8.0)


@pytest.fixture(scope="module")
def jax_params():
    """The reference test's params: adaLN-zero init de-degenerated."""
    params = jax_init_dit(jax.random.PRNGKey(0), _jax_cfg())
    k = jax.random.PRNGKey(99)
    for i, blk in enumerate(params["blocks"]):
        blk["adaln"] = 0.05 * jax.random.normal(jax.random.fold_in(k, i),
                                                blk["adaln"].shape)
    params["final_out"] = 0.05 * jax.random.normal(
        jax.random.fold_in(k, 10_000), params["final_out"].shape)
    return params


@pytest.fixture(scope="module")
def port_params(jax_params):
    return bridge.from_jax_params(jax.device_get(jax_params), device="cpu")


class _Runs:
    """Each reference run once per module, on first use.

    The two scenarios of one schedule share the reference's jitted step
    (same params, config and shapes; ``make_rf_step`` patched for the
    duration of the call only), so each of its plan keys compiles once.
    Its cache size then counts the union of both scenarios' keys, which
    the port's per-run count must equal all the same."""

    def __init__(self, jax_params, port_params):
        self.jax_params, self.port_params = jax_params, port_params
        self.cache = {}
        self.steps = {}

    def _shared_step(self, params, cfg, dcfg, **kw):
        key = (dcfg, kw["dt"], kw["guidance"])
        if key not in self.steps:
            self.steps[key] = jax_make_rf_step(params, cfg, dcfg, **kw)
        return self.steps[key]

    def _memo(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def reference(self, name, scenario):
        seed, reqs, arrivals = SCENARIOS[scenario]

        def run():
            key = jax.random.PRNGKey(seed)
            server = jax_serve.DiceServer(_jax_cfg(), _dcfgs(name)[1],
                                          params=self.jax_params)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_serve, "make_rf_step", self._shared_step)
                out, stats = jax_serve.serve_continuous(
                    server, [jax_serve.Request(c, r) for c, r in reqs],
                    max_batch=2, num_steps=STEPS, key=key,
                    arrival_steps=arrivals)
            noise_key, _ = jax.random.split(key)
            noise = {r: np.array(jax_serve.request_noise(noise_key, r, _jax_cfg()))
                     for _, r in reqs}
            return out, stats, noise
        return self._memo(("ref", name, scenario), run)

    def port(self, name, scenario):
        """The port on the reference's noise."""
        seed, reqs, arrivals = SCENARIOS[scenario]
        server = serve.DiceServer(_cfg(), _dcfgs(name)[0],
                                  params=self.port_params, device="cpu")
        return serve.serve_continuous(
            server, [serve.Request(c, r) for c, r in reqs], max_batch=2,
            num_steps=STEPS, seed=seed, arrival_steps=arrivals,
            noise=self.reference(name, scenario)[2])


@pytest.fixture(scope="module")
def runs(jax_params, port_params):
    return _Runs(jax_params, port_params)


def _fresh_batch(params, dcfg, reqs, seed, steps=STEPS):
    """The port's fixed-batch sampler, with the engine's noise."""
    cfg = _cfg()
    noise = torch.stack([serve.request_noise(seed, r.rid, cfg) for r in reqs])
    x, _ = rf_sample(params, cfg, dcfg, num_steps=steps, noise=noise,
                     classes=torch.tensor([r.class_id for r in reqs]))
    return {r.rid: x[i] for i, r in enumerate(reqs)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("name", ENGINES)
def test_serve_continuous_matches_reference(name, scenario, runs):
    ref_out, ref, _ = runs.reference(name, scenario)
    out, stats = runs.port(name, scenario)
    assert sorted(out) == sorted(ref_out)
    for rid in ref_out:
        assert out[rid].device.type == "cpu"
        np.testing.assert_allclose(out[rid].numpy(), ref_out[rid], **TOL)
    for key in COUNTS:
        assert stats[key] == ref[key], key
    for key in MODELED:
        assert stats[key + "_paper8"] == pytest.approx(ref[key + "_tpu8"],
                                                       rel=1e-12), key
    assert stats["a2a_bytes_per_layer"] == pytest.approx(
        ref["a2a_bytes_per_layer"], rel=1e-12)
    assert stats["step_keys"] == ref["jit_cache_size"] == stats["num_plan_variants"]
    assert stats["recycled_admissions"] >= 1
    assert len(stats["tick_variants"]) == stats["ticks"]
    assert sum(s for _, s in stats["tick_variants"]) == stats["slotted_ticks"]
    assert stats["e2e_s"]["count"] == len(out)
    assert stats["kernel_launches"] == {k: 0 for k in ops.LAUNCHES}
    assert not any(k.endswith("tpu8") for k in stats)


@pytest.mark.parametrize("steps", [STEPS, 6])
@pytest.mark.parametrize("name", ENGINES)
def test_recycled_slot_equals_fresh_batch_bit_for_bit(name, steps, port_params):
    """rid 2 is admitted into the slot rid 0 or 1 vacated; its sample and
    the first wave's equal the same requests in a fresh batch (rid 2 beside
    another co-resident than in the engine).  At 6 steps a light step's
    output (int8-coded under dice_int8) reaches the sample; at 4 it does
    not."""
    dcfg = _dcfgs(name)[0]
    seed, reqs, arrivals = SCENARIOS["recycled"]
    reqs = [serve.Request(c, r) for c, r in reqs]
    server = serve.DiceServer(_cfg(), dcfg, params=port_params, device="cpu")
    out, stats = serve.serve_continuous(server, reqs, max_batch=2,
                                        num_steps=steps, seed=seed,
                                        arrival_steps=arrivals)
    assert stats["recycled_admissions"] >= 1
    assert not torch.equal(out[2], serve.request_noise(seed, 2, _cfg()))
    ref = _fresh_batch(port_params, dcfg, [reqs[2], serve.Request(5, 7)],
                       seed=seed, steps=steps)
    assert torch.equal(out[2], ref[2])
    ref01 = _fresh_batch(port_params, dcfg, reqs[:2], seed=seed, steps=steps)
    assert torch.equal(out[0], ref01[0]) and torch.equal(out[1], ref01[1])


@pytest.mark.parametrize("name", SCHEDULES + ("dice_int8",))
def test_step_keys_stay_at_the_plan_variant_count(name, port_params):
    """Slot recycling adds no step key: warmup mixtures ride the per-slot
    selectors of the merge plan's (plan, slotted=True) key."""
    _, reqs, arrivals = SCENARIOS["plan_keys"]
    server = serve.DiceServer(_cfg(), _dcfgs(name)[0], params=port_params,
                              device="cpu")
    out, stats = serve.serve_continuous(
        server, [serve.Request(c, r) for c, r in reqs], max_batch=2,
        num_steps=STEPS, seed=3, arrival_steps=arrivals)
    assert sorted(out) == [r for _, r in reqs]
    assert stats["step_keys"] == stats["num_plan_variants"]
    assert len(set(stats["tick_variants"])) == stats["step_keys"]
    assert stats["recycled_admissions"] >= 1
    assert all(bool(torch.isfinite(s).all()) for s in out.values())


def test_random_policy_draws_each_tick_from_its_seed(port_params):
    """A "random" conditional-communication policy draws its masks from a
    generator seeded from (seed, tick): the same seed gives the same
    samples, another seed other ones, and the masks do change them.  6
    steps: a light step's output is consumed only by the step after it."""
    _, reqs, arrivals = SCENARIOS["plan_keys"]

    def run(policy, seed):
        server = serve.DiceServer(_cfg(), DiceConfig.dice(cond_policy=policy),
                                  params=port_params, device="cpu")
        out, stats = serve.serve_continuous(
            server, [serve.Request(c, r) for c, r in reqs], max_batch=2,
            num_steps=6, seed=seed, arrival_steps=arrivals,
            noise={r: serve.request_noise(0, r, _cfg()) for _, r in reqs})
        assert stats["step_keys"] == stats["num_plan_variants"]
        return out
    a, b, c = run("random", 0), run("random", 0), run("random", 1)
    low = run("low", 0)
    assert all(torch.equal(a[r], b[r]) for r in a)
    assert any(not torch.equal(a[r], c[r]) for r in a)
    assert any(not torch.equal(a[r], low[r]) for r in a)


def test_mid_flight_admission_fills_free_slot(port_params):
    """A request arriving mid-flight joins a free slot at the next aligned
    tick instead of waiting for the batch to drain: 6 ticks, not 2 x 4."""
    dcfg = DiceConfig.dice()
    server = serve.DiceServer(_cfg(), dcfg, params=port_params, device="cpu")
    reqs = [serve.Request(1, 10), serve.Request(2, 11)]
    out, stats = serve.serve_continuous(server, reqs, max_batch=2,
                                        num_steps=STEPS, seed=1,
                                        arrival_steps=[0.0, 1.0])
    assert sorted(out) == [10, 11]
    assert stats["makespan_steps"] == 6 and stats["ticks"] == 6
    assert stats["padded_slot_steps"] == 4          # ticks 0-1 and 4-5
    assert stats["slotted_ticks"] == 4 and stats["recycled_admissions"] == 0
    ref = _fresh_batch(port_params, dcfg, [reqs[1], serve.Request(6, 9)], seed=1)
    assert torch.equal(out[11], ref[11])
    # the engine's registry was folded into the server's
    assert server.metrics.value("dice_admissions_total",
                                {"schedule": "dice", "engine": "continuous"}) == 2


def test_serve_queue_matches_reference(jax_params, port_params):
    """3 requests through batches of 2 (one null-class pad row), the
    reference's per-batch noise fed to the port by rid (-1 = the pad)."""
    reqs = [(1, 0), (2, 1), (3, 2)]
    ref_server = jax_serve.DiceServer(_jax_cfg(), JaxDice.sync_ep(),
                                      params=jax_params)
    key = jax.random.PRNGKey(5)
    ref_out, ref = jax_serve.serve_queue(
        ref_server, [jax_serve.Request(c, r) for c, r in reqs], max_batch=2,
        num_steps=STEPS, key=key)
    noise = {}
    for batch in ([0, 1], [2, -1]):
        key, k = jax.random.split(key)
        x0 = np.array(jax.random.normal(k, (2, 16, _cfg().in_channels)))
        noise.update({rid: x0[i] for i, rid in enumerate(batch)})
    server = serve.DiceServer(_cfg(), DiceConfig.sync_ep(), params=port_params,
                              device="cpu")
    out, view = serve.serve_queue(server, [serve.Request(c, r) for c, r in reqs],
                                  max_batch=2, num_steps=STEPS, noise=noise)
    assert sorted(out) == sorted(ref_out) == [0, 1, 2]
    for rid in ref_out:
        np.testing.assert_allclose(out[rid].numpy(), np.asarray(ref_out[rid]),
                                   **TOL)
    # serve_queue's view keeps no ring keys: ring_hops / hop_bytes_total
    # are in each generate() summary
    renamed = {k.replace("tpu8", "paper8").replace("jit_cache_size", "step_keys")
               for k in ref} - {"ring_hops", "hop_bytes_total"}
    assert set(view) == renamed | {"wall_s", "e2e_s"}
    for k in ("batches", "padded", "buffer_bytes", "dispatch_bytes_total",
              "wire_bytes_total", "raw_bytes_total", "num_plan_variants"):
        assert view[k] == ref[k], k
    for k in ("modeled_step_s", "modeled_total_s"):
        assert view[k + "_paper8"] == pytest.approx(ref[k + "_tpu8"], rel=1e-12)
    assert view["a2a_bytes_per_layer"] == pytest.approx(ref["a2a_bytes_per_layer"],
                                                        rel=1e-12)
    assert view["step_keys"] == ref["jit_cache_size"]
    assert view["e2e_s"]["count"] == 3 and view["wall_s"] > 0
    assert (view["batches"], view["padded"]) == (2, 1)


def test_generate_publishes_its_summary(port_params):
    reg = MetricsRegistry()
    server = serve.DiceServer(_cfg(), DiceConfig.dice(), params=port_params,
                              device="cpu", metrics=reg)
    reqs = [serve.Request(1, 0), serve.Request(2, 1)]
    _, stats = server.generate(reqs, num_steps=STEPS)
    lab = {"schedule": "dice", "engine": "batch"}
    assert reg.value("dice_batches_total", lab) == 1
    assert reg.value("dice_dispatch_bytes_total", lab) == stats["wire_bytes_total"]
    assert reg.value("dice_wall_seconds_total", lab) == stats["wall_s"]
    assert reg.value("dice_step_keys", lab) == stats["step_keys"] == 3
    lat = server.latency(len(reqs) // server.n_dev)
    assert reg.histogram("dice_modeled_step_seconds", labels=lab).mean == \
        lat["t_step_s"]
    assert not any(k.startswith("modeled") for k in stats)


def test_request_noise_is_the_same_on_every_call_and_slot():
    cfg = _cfg()
    a = serve.request_noise(7, 3, cfg)
    assert a.shape == (cfg.patch_tokens, cfg.in_channels)
    assert torch.equal(a, serve.request_noise(7, 3, cfg, device="cpu"))
    assert not torch.equal(a, serve.request_noise(7, 4, cfg))
    assert not torch.equal(a, serve.request_noise(8, 3, cfg))


def test_unported_serving_paths_raise(port_params):
    server = serve.DiceServer(_cfg(), DiceConfig.dice(), params=port_params,
                              device="cpu")
    # a mesh is served now (tests/test_torch_ep_serve.py,
    # tests/test_torch_hier_mesh.py), but only the port's own meshes
    with pytest.raises(TypeError, match="EPMesh"):
        serve.serve_continuous(server, [serve.Request(1, 0)], mesh=object())
    # placements are served now (tests/test_torch_placement.py): without
    # an ep mesh they are dropped and the samples are the unplaced ones;
    # so is paging (tests/test_torch_paging.py): without an ep mesh the
    # experts stay resident, the plans and samples are the unpaged ones
    pl = Placement(perm=(1, 0, 2, 3, 4, 5, 6, 7), replicated=(1,))
    placed = serve.DiceServer(
        _cfg(), dataclasses.replace(DiceConfig.dice(),
                                    placements=(pl,) * _cfg().num_layers),
        params=port_params, device="cpu")
    assert placed.plan(4) == server.plan(4)
    from repro_torch.core.paging import PagingSpec
    paged = serve.DiceServer(
        _cfg(), DiceConfig.dice(), params=port_params, device="cpu",
        paging=PagingSpec(budget_bytes=0), resilience=ResilienceConfig(
            faults=FaultConfig(paging_error_rate=0.1)))
    assert paged.expert_pool is None and paged.plan(4) == server.plan(4)
    reqs = [serve.Request(class_id=c, rid=i) for i, c in enumerate((1, 3))]
    x, st = paged.generate(reqs, num_steps=2)
    assert torch.equal(x, server.generate(reqs, num_steps=2)[0])
    assert "paged_transfers" not in st
    with pytest.raises(ValueError):
        serve.DiceServer(_cfg(), DiceConfig.dice(), params=port_params,
                         device="cpu", n_dev=0)


def test_continuous_cli_on_cpu(tmp_path):
    buf = io.StringIO()
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    with redirect_stdout(buf):
        serve.main(["--device", "cpu", "--continuous", "--max-batch", "2",
                    "--requests", "3", "--steps", "4",
                    "--metrics-out", str(prom), "--trace-out", str(trace)])
    out = buf.getvalue()
    assert "served 3 requests continuously, finite=True" in out
    assert "continuous over 2 slots" in out and "tpu8" not in out
    lines = dict(line.split(None, 1) for line in out.splitlines()
                 if line.startswith("  "))
    assert lines["recycled_admissions"] == "1"
    assert lines["step_keys"] == lines["num_plan_variants"] == "3"
    assert float(lines["modeled_step_s_paper8"]) > 0
    text = prom.read_text()
    assert 'dice_admissions_total{engine="continuous",schedule="dice"} 3' in text
    assert '"name": "admit"' in trace.read_text()
