"""The port's wire codecs under faults and its resilience ladder against the
JAX package's, on the CPU.

* C.6: the plain ``residual_int8`` on rows holding NaN or Inf gives the
  jitted JAX encoder's q, scale and reconstruction, NaN positions
  included (the CUDA kernel is held to this plain version by a ``cuda``
  case in tests/test_torch_cuda.py).
* ``topk_residual``: encode, decode and wire bytes bit for bit, ties
  included; ``apply(guard=True)`` on non-finite rows.
* The host-side pieces (``_roll``, ``FaultPlan``, ``parse_resilience``,
  ``normalize_resilience``, ``bursty_arrivals``, the demotion controller)
  give the reference's values and decisions.
* ``moe_forward`` fed the reference's corruption masks gives the
  reference's outputs (TOL: rtol 1e-4 / atol 1e-5, f32, sums in another
  order; non-finite positions equal) and fault counts, guards on and off.
* Guards on with no faults change no bit; a guarded combine equals the
  conditional-communication step that masks the same pairs, bit for bit.
* ``serve_continuous`` under the reference's chaos scenarios
  (tests/test_faults.py): which requests finish, are requeued or shed,
  and at which tick the codec is demoted.  Over 2 gloo ranks both ranks
  demote at the same tick and quarantine a lane of rank 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ep_jobs as jobs
from repro.common.config import ModelConfig as JaxModelConfig
from repro.compress import codecs as jax_codecs
from repro.compress import ref as jax_ref
from repro.compress.codecs import CompressConfig as JaxCompress
from repro.configs import dit_moe_xl as jax_configs
from repro.core import moe as jax_moe
from repro.core.schedules import DiceConfig as JaxDice
from repro.launch import serve as jax_serve
from repro.models.dit_moe import init_dit as jax_init_dit
from repro.obs import ObsConfig as JaxObs
from repro.resilience import faults as jax_faults
from repro.resilience.degrade import DegradationController as JaxController
from repro.sampling.rectified_flow import rf_sample as jax_rf_sample
from repro_torch import bridge
from repro_torch.common.config import ModelConfig
from repro_torch.compress import codecs
from repro_torch.compress.codecs import CompressConfig
from repro_torch.configs import dit_moe_xl as configs
from repro_torch.core import moe
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.obs import ObsConfig
from repro_torch.resilience import faults
from repro_torch.resilience.degrade import DegradationController
from repro_torch.sampling.rectified_flow import rf_sample

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 4


# ---------------------------------------------------------------------------
# C.6: residual_int8 on non-finite rows
# ---------------------------------------------------------------------------
def _nonfinite_rows(d=24, seed=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((6, d)).astype(np.float32)
    base = (value + 0.1 * rng.standard_normal((6, d))).astype(np.float32)
    value[0, 3] = np.nan                        # one NaN
    value[1, 2] = np.inf                        # +Inf
    value[2, 5] = -np.inf                       # -Inf
    value[3, [1, 7, 9]] = [np.nan, np.inf, -np.inf]   # a mix
    base[4, 0] = np.nan                         # a NaN in the base
    return value, base                          # row 5 stays finite


def test_residual_int8_plain_version_matches_the_jitted_encoder():
    """What each side gives (both do the same): a row with a NaN residual
    has scale NaN, q 0 and a NaN reconstruction in every entry; a row with
    an infinite residual (and no NaN) has scale +Inf, q 0 (Inf / Inf and
    finite / Inf both round to what casts to 0) and a NaN reconstruction
    in every entry (0 * Inf); a finite row is untouched."""
    value, base = _nonfinite_rows()
    enc = jax.jit(jax_ref.int8_encode)
    dec = jax.jit(jax_ref.int8_decode)
    jq, js = enc(jnp.asarray(value - base))
    jrec = jnp.asarray(base) + dec(jq, js)
    q, s, rec = kref.residual_int8_ref(torch.from_numpy(value),
                                       torch.from_numpy(base))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))   # NaN == NaN
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    assert np.isnan(s[[0, 3, 4]].numpy()).all()
    assert np.isposinf(s[[1, 2]].numpy()).all()
    assert (q[:5] == 0).all()
    assert np.isnan(rec[:5].numpy()).all()
    assert np.isfinite(rec[5].numpy()).all() and np.isfinite(s[5].numpy())


# ---------------------------------------------------------------------------
# topk_residual and the guard
# ---------------------------------------------------------------------------
def _rows_with_ties(seed=1, d=96):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((7, d)).astype(np.float32)
    r[0] = 0.0                                  # a guarded row: all ties
    r[1] = np.repeat(rng.standard_normal(d // 8), 8)     # repeated values
    r[2, ::2] = -r[2, 1::2]                     # equal magnitudes, signs differ
    r[3] = np.round(r[3])                       # few distinct magnitudes
    return r


@pytest.mark.parametrize("frac", [0.125, 0.3, 1.0])
@pytest.mark.parametrize("rows", ["random", "ties"])
def test_topk_codec_matches_reference_bit_for_bit(frac, rows):
    r = (np.random.default_rng(5).standard_normal((9, 96)).astype(np.float32)
         if rows == "random" else _rows_with_ties())
    spec = codecs.CodecSpec("topk_residual", topk_frac=frac)
    jspec = jax_codecs.CodecSpec("topk_residual", topk_frac=frac)
    enc = codecs.encode(spec, torch.from_numpy(r))
    jenc = jax.jit(lambda a: jax_codecs.encode(jspec, a).data)(jnp.asarray(r))
    for a, b in zip(enc.data, jenc):
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert codecs.encoded_nbytes(enc) == jax_codecs.encoded_nbytes(
        jax_codecs.encode(jspec, jnp.asarray(r))) == \
        r.shape[0] * spec.wire_bytes_per_row(96)
    np.testing.assert_array_equal(
        codecs.decode(spec, enc).numpy(),
        np.asarray(jax_codecs.decode(jspec, jax_codecs.encode(
            jspec, jnp.asarray(r)))))
    assert spec.wire_bytes_per_row(1152) == jspec.wire_bytes_per_row(1152)


@pytest.mark.parametrize("kind", ["int8_residual", "topk_residual"])
@pytest.mark.parametrize("guard", [True, False])
def test_codec_apply_with_guard_matches_reference(kind, guard):
    value, base = _nonfinite_rows(d=32)
    base[4, 0] = 0.5                            # the guard's base is finite
    spec = codecs.CodecSpec(kind)
    jspec = jax_codecs.CodecSpec(kind)
    got = codecs.apply(spec, torch.from_numpy(value), torch.from_numpy(base),
                       guard=guard).numpy()
    want = np.asarray(jax.jit(lambda v, b: jax_codecs.apply(
        jspec, v, b, guard=guard))(jnp.asarray(value), jnp.asarray(base)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if guard:
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[:4], base[:4])   # zero residual


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------
def test_rolls_and_fault_plans_equal_the_reference():
    coords = [("paging_err", 1, 2, 3, 0), ("hop_delay", 7), ("ckpt_trunc", 0, 5),
              ("x",), ()]
    for seed in (0, 7, 123456789):
        for c in coords:
            assert faults._roll(seed, *c) == jax_faults._roll(seed, *c)
    kw = dict(seed=11, hop_delay_rate=0.4, checkpoint_truncate_rate=0.5,
              poison_tick=3)
    mine = faults.FaultPlan(faults.FaultConfig(**kw))
    ref = jax_faults.FaultPlan(jax_faults.FaultConfig(**kw))
    payload = bytes(range(200))
    for t in range(40):
        assert mine.hop_delay(t) == ref.hop_delay(t)
        assert mine.poison(t) == ref.poison(t)
        assert mine.truncate_chunk(t, t % 3, payload) == \
            ref.truncate_chunk(t, t % 3, payload)


SPECS = [None, "", "off", "seed=7,corrupt=0.05,poison_tick=3,queue=16",
         "corrupt_dispatch=0.02,hop_delay=0.5:0.01,guards=0,requeues=1",
         "codec_err_limit=1e-6,demote_after=1,admit_deadline=4",
         "step_deadline=0.2,step_deadline_factor=2.5,quarantine=0,burst=4",
         "seed=3", "guards=0,quarantine=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_normalize_resilience_equal_the_reference(spec):
    mine, ref = faults.parse_resilience(spec), jax_faults.parse_resilience(spec)
    as_dict = lambda c: None if c is None else dataclasses.asdict(c)  # noqa: E731
    assert as_dict(mine) == as_dict(ref)
    assert as_dict(faults.normalize_resilience(mine)) == \
        as_dict(jax_faults.normalize_resilience(ref))


@pytest.mark.parametrize("spec", ["paging_err=0.3", "paging_delay=0.5:0.01",
                                  "retries=3", "stale_fallback=0"])
def test_paging_rungs_raise_naming_a9(spec):
    """The paging rungs, once refused, parse and normalize like
    ``jax_faults.parse_resilience``, ride on a DiceConfig, and roll the
    reference's paging faults (tests/test_torch_paging.py serves them)."""
    as_dict = lambda c: None if c is None else dataclasses.asdict(c)  # noqa: E731
    mine, ref = faults.parse_resilience(spec), jax_faults.parse_resilience(spec)
    assert as_dict(mine) == as_dict(ref)
    assert as_dict(faults.normalize_resilience(mine)) == \
        as_dict(jax_faults.normalize_resilience(ref))
    assert DiceConfig(resilience=mine).resilience == \
        faults.normalize_resilience(mine)
    if mine.faults is not None:
        plan, ref_plan = faults.FaultPlan(mine.faults), \
            jax_faults.FaultPlan(ref.faults)
        coords = [(l, j, s, a) for l in range(3) for j in range(4)
                  for s in (1, 2) for a in range(3)]
        for kind in ("paging_error", "paging_delay"):
            assert [getattr(plan, kind)(*c) for c in coords] == \
                [getattr(ref_plan, kind)(*c) for c in coords]


@pytest.mark.parametrize("burst", [0, 1, 3, 8])
def test_bursty_arrivals_equal_the_reference(burst):
    assert faults.bursty_arrivals(10, 0.5, burst, start=2.0) == \
        jax_faults.bursty_arrivals(10, 0.5, burst, start=2.0)


def _controller_script(ctrl):
    walls = [0.01, 0.012, 0.011, 0.01, 0.013, 0.02, 0.1, 0.11, 0.01, 0.09,
             0.2, 0.3, 0.01]
    errs = [None, 1e-6, 5e-3, 5e-3, 1e-6, 5e-3, 5e-3, 5e-3, None, 1e-7,
            2e-3, 2e-3, 2e-3]
    log = []
    for i, (w, e) in enumerate(zip(walls, errs)):
        log.append(ctrl.observe_step(w, e))
        for ring, codec in ((True, True), (True, False), (False, True)):
            log.append(ctrl.should_demote(ring, codec))
        kind = ctrl.should_demote(True, True)
        if kind is not None and i % 3 == 0:
            ctrl.record_demotion(kind)
        log.append((ctrl.baseline_s, ctrl.consecutive_breaches,
                    ctrl.consecutive_codec_blowups, ctrl.total_breaches,
                    list(ctrl.demotions)))
    return log


@pytest.mark.parametrize("kw", [dict(demote_after=2, step_deadline_factor=4.0,
                                     codec_error_limit=1e-3),
                                dict(demote_after=1, step_deadline_s=0.05),
                                dict(demote_after=0)])
@pytest.mark.parametrize("window", [2, 5])
def test_degradation_controller_sequences_equal_the_reference(kw, window):
    mine = DegradationController(faults.ResilienceConfig(**kw),
                                 baseline_window=window)
    ref = JaxController(jax_faults.ResilienceConfig(**kw),
                        baseline_window=window)
    assert _controller_script(mine) == _controller_script(ref)


# ---------------------------------------------------------------------------
# moe_forward with the reference's corruption masks
# ---------------------------------------------------------------------------
CFG_KW = dict(name="t", family="moe", num_layers=4, d_model=32, d_ff=64,
              vocab_size=64, num_heads=4, num_kv_heads=4, num_experts=4,
              experts_per_token=2, moe_d_ff=48, capacity_factor=4.0)


def _moe_inputs(T=16, seed=0):
    jcfg = JaxModelConfig(**CFG_KW)
    p = jax.device_get(jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg,
                                        dtype=jnp.float32))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((T, 32)).astype(np.float32)
    h = rng.standard_normal((T, 2, 32)).astype(np.float32)
    base = (x + 0.1 * rng.standard_normal((T, 32))).astype(np.float32)
    mask = rng.random((T, 2)) < 0.6
    mask[:, 0] = True
    return jcfg, ModelConfig(**CFG_KW), p, x, h, base, mask


CASES = {
    "combine": dict(corrupt_combine_rate=0.3),
    "dispatch": dict(corrupt_dispatch_rate=0.3),
    "both": dict(corrupt_combine_rate=0.25, corrupt_dispatch_rate=0.2),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("codec", [None, "int8_residual", "topk_residual"])
@pytest.mark.parametrize("guards", [True, False])
@pytest.mark.parametrize("cached", [True, False])
def test_moe_forward_with_reference_masks(case, codec, guards, cached):
    jcfg, cfg, p, x, h, base, mask = _moe_inputs()
    T, K = mask.shape
    seed, salt = 9, 3
    key = jax.random.PRNGKey(21)
    fkw = dict(seed=seed, **CASES[case])
    jres = jax_faults.ResilienceConfig(faults=jax_faults.FaultConfig(**fkw),
                                       guards=guards)
    res = faults.ResilienceConfig(faults=faults.FaultConfig(**fkw),
                                  guards=guards)
    fk = fkw.get

    def ref_mask(site, rate, shape):
        if not rate:
            return None
        return np.asarray(jax_faults.corruption_mask(key, seed, salt, site,
                                                     rate, shape))
    masks = moe.FaultMasks(
        dispatch=ref_mask(jax_faults.FE_CORRUPT_DISPATCH,
                          fk("corrupt_dispatch_rate"), (T,)),
        combine=ref_mask(jax_faults.FE_CORRUPT_COMBINE,
                         fk("corrupt_combine_rate"), (T, K)))
    masks = moe.FaultMasks(*(None if m is None else torch.from_numpy(m.copy())
                             for m in masks))
    kw = dict(capacity=16, want_pair_vals=True)
    jkw, tkw = dict(kw), dict(kw)
    if cached:
        jkw.update(fresh_mask=jnp.asarray(mask), h_cache=jnp.asarray(h))
        tkw.update(fresh_mask=torch.from_numpy(mask),
                   h_cache=torch.from_numpy(h))
    if codec is not None:
        jkw.update(codec=jax_codecs.CodecSpec(codec),
                   dispatch_base=jnp.asarray(base))
        tkw.update(codec=codecs.CodecSpec(codec),
                   dispatch_base=torch.from_numpy(base))
    jy, jaux = jax_moe.moe_forward(p, jnp.asarray(x), jcfg, key=key,
                                   resilience=jres, fault_salt=salt, **jkw)
    y, aux = moe.moe_forward(bridge._convert(p, torch.device("cpu"), "p"),
                             torch.from_numpy(x), cfg, resilience=res,
                             fault_salt=salt, fault_masks=masks, **tkw)
    jy = np.asarray(jy)
    np.testing.assert_array_equal(np.isfinite(y.numpy()), np.isfinite(jy))
    fin = np.isfinite(jy)
    np.testing.assert_allclose(y.numpy()[fin], jy[fin], **TOL)
    np.testing.assert_array_equal(aux.fault_events.numpy(),
                                  np.asarray(jaux.fault_events))
    np.testing.assert_array_equal(aux.pair_keep.numpy(),
                                  np.asarray(jaux.pair_keep))
    assert float(aux.fault_events.sum()) > 0
    if guards:
        assert np.isfinite(y.numpy()).all()


def test_drawn_masks_are_seeded_and_per_pass():
    """Without given masks the port draws them from (seed, site, layer,
    tick, pass, rank): the same coordinates give the same mask, another
    coordinate another one."""
    draw = lambda key, salt=0, seed=4: faults.corruption_mask(  # noqa: E731
        key, seed, salt, faults.FE_CORRUPT_COMBINE, 0.5, (64, 2))
    k = faults.fault_key(3, 0)
    assert torch.equal(draw(k), draw(k))
    others = [draw(faults.fault_key(3, 1)), draw(faults.fault_key(4, 0)),
              draw(faults.fault_key(3, 0, rank=1)), draw(k, salt=1),
              draw(k, seed=5)]
    assert all(not torch.equal(draw(k), o) for o in others)
    assert 0.3 < float(draw(k).float().mean()) < 0.7


def test_guarded_combine_equals_the_cond_comm_masked_step():
    """The reference's test_guarded_combine_equals_cond_comm_masked_step,
    in the port: pairs corrupted and caught by the guard fall back to
    h_cache, exactly as a conditional-communication mask that leaves
    them out does."""
    _, cfg, p, x, h, _, _ = _moe_inputs()
    pt = bridge._convert(p, torch.device("cpu"), "p")
    T, K = 16, 2
    all_fresh = torch.ones((T, K), dtype=torch.bool)
    for seed, rate in ((0, 0.3), (1, 0.5), (7, 0.9), (3, 1.0)):
        cm = faults.corruption_mask(None, seed, 0, faults.FE_CORRUPT_COMBINE,
                                    rate, (T, K))
        assert bool(cm.any())
        res = faults.ResilienceConfig(faults=faults.FaultConfig(
            seed=seed, corrupt_combine_rate=rate))
        y_a, _ = moe.moe_forward(pt, torch.from_numpy(x), cfg, capacity=T * K,
                                 fresh_mask=all_fresh,
                                 h_cache=torch.from_numpy(h), resilience=res)
        y_b, _ = moe.moe_forward(pt, torch.from_numpy(x), cfg, capacity=T * K,
                                 fresh_mask=all_fresh & ~cm,
                                 h_cache=torch.from_numpy(h))
        assert torch.equal(y_a, y_b)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
KW = dict(num_layers=2, d_model=64, moe_d_ff=64, d_ff=256, patch_tokens=16,
          capacity_factor=8.0)


def _jax_cfg():
    return jax_configs.tiny().replace(**KW)


def _cfg():
    return configs.tiny().replace(**KW)


@pytest.fixture(scope="module")
def jax_params():
    """tests/test_faults.py's served params: adaLN-zero de-degenerated."""
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


def test_dice_topk_run_matches_reference(jax_params, port_params):
    """5 steps: step 3 is light and its top-k coded expert outputs reach
    the sample through step 4."""
    key = jax.random.PRNGKey(4)
    cls = np.array([1, 5])
    want, st = jax_rf_sample(jax_params, _jax_cfg(), JaxDice.dice(
        compress=JaxCompress("topk_residual")), num_steps=5, classes=cls,
        key=key)
    noise = np.array(jax.random.normal(key, (2, 16, _cfg().in_channels)))
    got, mine = rf_sample(port_params, _cfg(), DiceConfig.dice(
        compress=CompressConfig("topk_residual")), num_steps=5,
        classes=torch.from_numpy(cls), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert mine["dispatch_bytes"] == st["dispatch_bytes"]
    assert min(mine["dispatch_bytes"]) < max(mine["dispatch_bytes"])


def _serve_port(params, dcfg, *, resilience=None, obs=False, nreq=3,
                max_batch=2, num_steps=STEPS, arrivals=None, noise=None):
    server = serve.DiceServer(_cfg(), dcfg, params=params, device="cpu",
                              resilience=resilience,
                              obs=ObsConfig(enabled=obs))
    reqs = [serve.Request(i % 8, i) for i in range(nreq)]
    return serve.serve_continuous(
        server, reqs, max_batch=max_batch, num_steps=num_steps, seed=42,
        noise=noise,
        arrival_steps=arrivals if arrivals is not None else [0.0] * nreq)


def _serve_ref(params, dcfg, *, resilience=None, obs=False, nreq=3,
               max_batch=2, num_steps=STEPS, arrivals=None):
    """tests/test_faults.py's _serve, returning the server too and the
    requests' noise."""
    server = jax_serve.DiceServer(_jax_cfg(), dcfg, params=params,
                                  resilience=resilience,
                                  obs=JaxObs(enabled=obs))
    reqs = [jax_serve.Request(class_id=i % 8, rid=i) for i in range(nreq)]
    key = jax.random.PRNGKey(42)
    out, stats = jax_serve.serve_continuous(
        server, reqs, max_batch=max_batch, num_steps=num_steps, key=key,
        arrival_steps=arrivals if arrivals is not None else [0.0] * nreq)
    noise_key, _ = jax.random.split(key)
    noise = {i: np.array(jax_serve.request_noise(noise_key, i, _jax_cfg()))
             for i in range(nreq)}
    return out, stats, server, noise


@pytest.mark.parametrize("name", ["sync", "dice", "dice_int8"])
def test_guards_on_faults_off_bit_identical_end_to_end(name, port_params):
    dcfg = {"sync": DiceConfig.sync_ep(), "dice": DiceConfig.dice(),
            "dice_int8": DiceConfig.dice(
                compress=CompressConfig("int8_residual"))}[name]
    ref, ref_stats = _serve_port(port_params, dcfg)
    out, stats = _serve_port(port_params, dcfg,
                             resilience=faults.ResilienceConfig(guards=True),
                             obs=True)
    assert sorted(out) == sorted(ref)
    for rid in ref:
        assert torch.equal(out[rid], ref[rid])
    assert stats["step_keys"] == stats["num_plan_variants"] == \
        ref_stats["step_keys"]
    assert sum(stats["fault_events"].values()) == 0
    # the fixed-batch sampler too
    noise = torch.stack([serve.request_noise(0, r, _cfg()) for r in (0, 1)])
    a, _ = rf_sample(port_params, _cfg(), dcfg, num_steps=STEPS, noise=noise,
                     classes=torch.tensor([1, 2]))
    b, st = rf_sample(port_params, _cfg(), dataclasses.replace(
        dcfg, resilience=faults.ResilienceConfig(guards=True)),
        num_steps=STEPS, noise=noise, classes=torch.tensor([1, 2]))
    assert torch.equal(a, b) and st["fault_events"].sum() == 0


def test_quarantine_matches_reference_and_replays_bit_identically(
        jax_params, port_params):
    """poison_tick poisons the first live slot; the request is requeued
    and served again, its sample equal to a clean run's bit for bit."""
    jres = jax_faults.ResilienceConfig(
        faults=jax_faults.FaultConfig(seed=11, poison_tick=2))
    res = faults.ResilienceConfig(faults=faults.FaultConfig(seed=11,
                                                            poison_tick=2))
    ref, ref_stats, _, noise = _serve_ref(jax_params, JaxDice.dice(),
                                          resilience=jres)
    out, stats = _serve_port(port_params, DiceConfig.dice(), resilience=res,
                             noise=noise)
    clean, _ = _serve_port(port_params, DiceConfig.dice(), noise=noise)
    for k in ("quarantined", "requeued", "shed", "shed_rids", "ticks",
              "makespan_steps", "admissions", "recycled_admissions"):
        assert stats[k] == ref_stats[k], k
    assert (stats["quarantined"], stats["requeued"]) == (1, 1)
    assert sorted(out) == sorted(ref) == [0, 1, 2]
    for rid in ref:
        np.testing.assert_allclose(out[rid].numpy(), ref[rid], **TOL)
        assert torch.equal(out[rid], clean[rid]), rid


def test_overload_burst_sheds_as_the_reference(jax_params, port_params):
    arrivals = faults.bursty_arrivals(8, rate=1.0, burst_size=8)
    kw = dict(max_queue_depth=2, admission_deadline_steps=2)
    ref, ref_stats, _, noise = _serve_ref(
        jax_params, JaxDice.dice(), resilience=jax_faults.ResilienceConfig(
            **kw), nreq=8, arrivals=arrivals)
    out, stats = _serve_port(port_params, DiceConfig.dice(),
                             resilience=faults.ResilienceConfig(**kw),
                             nreq=8, arrivals=arrivals, noise=noise)
    assert stats["shed"] > 0
    for k in ("shed", "shed_rids", "queue_peak_depth", "ticks", "admissions"):
        assert stats[k] == ref_stats[k], k
    assert sorted(out) == sorted(ref)
    assert sorted(set(out) | set(stats["shed_rids"])) == list(range(8))


def test_codec_blowup_demotes_at_the_reference_tick(jax_params, port_params):
    kw = dict(codec_error_limit=1e-12, demote_after=1)
    ref, ref_stats, jserver, noise = _serve_ref(
        jax_params, JaxDice.dice(compress=JaxCompress("int8_residual")),
        resilience=jax_faults.ResilienceConfig(**kw), obs=True, num_steps=6)
    out, stats = _serve_port(
        port_params, DiceConfig.dice(compress=CompressConfig("int8_residual")),
        resilience=faults.ResilienceConfig(**kw), obs=True, num_steps=6,
        noise=noise)
    ref_ticks = [(e["args"]["tick"], e["args"]["kind"])
                 for e in jserver.tracer.events if e.get("name") == "demote"]
    assert stats["demotions"] == ref_stats["demotions"] == ["codec"]
    assert stats["demotion_ticks"] == ref_ticks
    assert stats["step_keys"] == ref_stats["jit_cache_size"]
    assert sorted(out) == sorted(ref) == [0, 1, 2]
    for rid in ref:
        np.testing.assert_allclose(out[rid].numpy(), ref[rid], **TOL)
    # the ticks after the demotion ran the rebuilt, codec-free plans
    t = ref_ticks[0][0]
    assert all(a.codec is None for p in stats["tick_plans"][t:]
               for a in p.actions)
    assert any(a.codec is not None for p in stats["tick_plans"][:t]
               for a in p.actions)


def test_two_ranks_take_the_same_decisions(jax_params):
    """A breach seen on rank 1 alone demotes the ring on both ranks at the
    same tick; a lane poisoned on rank 1 is quarantined on both."""
    tree = jax.device_get(jax_params)
    rng = np.random.default_rng(0)
    noise = {r: rng.standard_normal((16, 4)).astype(np.float32)
             for r in range(6)}
    (ranks, out_b), _ = mesh_lib.spawn(jobs.fault_ladder, 2, backend="gloo",
                                       device="cpu", timeout_s=120,
                                       args=(tree, _cfg(), noise))
    a0, served_a0, b0, served_b0 = ranks[0]
    assert all(r == ranks[0] for r in ranks)        # every rank agrees
    assert a0["demotions"] == ["overlap"] and a0["demotion_ticks"]
    assert served_a0 == list(range(6))
    assert (b0["quarantined"], b0["requeued"], b0["shed"]) == (1, 1, 0)
    assert served_b0 == [0, 1, 2, 3]
    assert all(bool(torch.isfinite(x).all()) for x in out_b.values())
