"""The port's layers, MoE core, staleness executor and wire codecs against
the JAX package's, on the CPU, from the same numpy inputs.

Everything here is f32; the sums run in another order in the two
frameworks, so values agree to rtol 1e-5 / atol 1e-5 and the integer
bookkeeping (dispatch plans, masks, byte counts) agrees exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import codecs as jax_codecs
from repro.configs.dit_moe_xl import smoke as jax_smoke
from repro.core import moe as jax_moe
from repro.core import plan as jax_plan
from repro.core import staleness as jax_stale
from repro.core.schedules import DiceConfig as JaxDice
from repro.models import layers as jax_layers
from repro_torch.compress import codecs
from repro_torch.configs.dit_moe_xl import smoke
from repro_torch.core import moe, plan as plan_lib, staleness
from repro_torch.core.schedules import DiceConfig
from repro_torch.models import layers

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _moe_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    fs = f * cfg.num_shared_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    return {"router": w(d, E), "experts_gate": w(E, d, f),
            "experts_up": w(E, d, f), "experts_down": w(E, f, d),
            "shared_gate": w(d, fs), "shared_up": w(d, fs),
            "shared_down": w(fs, d)}


def _tokens(T, d, seed=1):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    p = {"scale": 0.1 * rng.standard_normal(128).astype(np.float32)}
    _close(layers.rmsnorm(_t(p), _t(x), eps=1e-6),
           jax_layers.rmsnorm(_j(p), _j(x), eps=1e-6))


@pytest.mark.parametrize("dh", [32, 72])
def test_rope_matches_jax(dh):
    x = np.random.default_rng(1).standard_normal((2, 16, 4, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    _close(layers.rope(_t(x), _t(pos), theta=10000.0),
           jax_layers.rope(_j(x), _j(pos), theta=10000.0))


@pytest.mark.parametrize("causal", [False, True])
def test_attn_apply_matches_jax(causal):
    cfg, jcfg = smoke(), jax_smoke()
    rng = np.random.default_rng(2)
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (d, hd)), ("wk", (d, hd)), ("wv", (d, hd)),
                      ("wo", (hd, d)))}
    x = rng.standard_normal((2, cfg.patch_tokens, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(cfg.patch_tokens), (2, cfg.patch_tokens)).copy()
    out, (k, v) = layers.attn_apply(_t(p), _t(x), _t(pos), cfg, causal=causal)
    jout, (jk, jv) = jax_layers.attn_apply(_j(p), _j(x), _j(pos), jcfg,
                                           causal=causal)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


# ---------------------------------------------------------------------------
# MoE core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("capacity", [8, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_route_plan_dispatch_combine_match_jax(capacity, masked):
    """Small capacities drop pairs; the plans must agree slot for slot."""
    cfg = smoke()
    T, E, K = 32, cfg.num_experts, cfg.experts_per_token
    p, x = _moe_params(cfg), _tokens(T, cfg.d_model)
    probs, scores, idx = moe.route(_t(p), _t(x), cfg)
    jprobs, jscores, jidx = jax_moe.route(_j(p), _j(x), jax_smoke())
    _close(probs, jprobs)
    _close(scores, jscores)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    mask = (np.arange(K)[None, :] == 0).repeat(T, 0) if masked else None
    plan = moe.make_plan(idx, E, capacity,
                         fresh_mask=None if mask is None else _t(mask))
    jplan = jax_moe.make_plan(jidx, E, capacity,
                              fresh_mask=None if mask is None else _j(mask))
    for field in ("slot", "t_sorted", "inv_order", "keep", "counts"):
        np.testing.assert_array_equal(_np(getattr(plan, field)),
                                      _np(getattr(jplan, field)), err_msg=field)
    buf = moe.dispatch(_t(x), plan, E, capacity)
    jbuf = jax_moe.dispatch(_j(x), jplan, E, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    cache = _tokens(T * K, cfg.d_model, seed=3).reshape(T, K, -1)
    kw = dict(h_cache=_t(cache), fresh_mask=_t(mask)) if masked else {}
    jkw = dict(h_cache=_j(cache), fresh_mask=_j(mask)) if masked else {}
    y, pair_vals, pair_keep = moe.combine(buf, plan, scores, T, **kw)
    jy, jpv, jpk = jax_moe.combine(jbuf, jplan, jscores, T, **jkw)
    _close(y, jy)
    _close(pair_vals, jpv)
    np.testing.assert_array_equal(pair_keep.numpy(), np.asarray(jpk))


def test_shared_expert_and_load_balance_match_jax():
    cfg = smoke()
    p, x = _moe_params(cfg), _tokens(32, cfg.d_model)
    _close(moe.shared_expert(_t(p), _t(x)), jax_moe.shared_expert(_j(p), _j(x)))
    probs, _, idx = moe.route(_t(p), _t(x), cfg)
    jprobs, _, jidx = jax_moe.route(_j(p), _j(x), jax_smoke())
    _close(moe.load_balance_loss(probs, idx, cfg.num_experts),
           jax_moe.load_balance_loss(jprobs, jidx, cfg.num_experts))
    for T in (1, 100, 2048):
        assert moe.default_capacity(T, cfg) == jax_moe.default_capacity(T, jax_smoke())


@pytest.mark.parametrize("codec", [None, "int8_residual"])
def test_moe_forward_with_mask_cache_codec_matches_jax(codec):
    cfg, jcfg = smoke(), jax_smoke()
    T, K, d = 32, cfg.experts_per_token, cfg.d_model
    p, x = _moe_params(cfg), _tokens(T, d)
    mask = (np.arange(K)[None, :] == 0).repeat(T, 0)
    cache = _tokens(T * K, d, seed=4).reshape(T, K, d)
    base = x + 0.05 * _tokens(T, d, seed=5)
    spec = codecs.CompressConfig(codec).spec() if codec else None
    jspec = jax_codecs.CompressConfig(codec).spec() if codec else None
    y, aux = moe.moe_forward(_t(p), _t(x), cfg, capacity=16,
                             fresh_mask=_t(mask), h_cache=_t(cache),
                             want_pair_vals=True, codec=spec,
                             dispatch_base=_t(base))
    jy, jaux = jax_moe.moe_forward(_j(p), _j(x), jcfg, capacity=16,
                                   fresh_mask=_j(mask), h_cache=_j(cache),
                                   want_pair_vals=True, codec=jspec,
                                   dispatch_base=_j(base))
    _close(y, jy)
    _close(aux.pair_vals, jaux.pair_vals)
    _close(aux.lb_loss, jaux.lb_loss)
    _close(aux.dropped_frac, jaux.dropped_frac)
    assert aux.dispatch_bytes == int(jaux.dispatch_bytes)
    assert aux.raw_dispatch_bytes == int(jaux.raw_dispatch_bytes)
    np.testing.assert_array_equal(aux.counts.numpy(), np.asarray(jaux.counts))
    _close(aux.served_counts, jaux.served_counts)
    np.testing.assert_array_equal(aux.pair_keep.numpy(), np.asarray(jaux.pair_keep))
    if codec:
        _close(aux.wire_payload, jaux.wire_payload)
        assert aux.dispatch_bytes < aux.raw_dispatch_bytes


# ---------------------------------------------------------------------------
# staleness executor
# ---------------------------------------------------------------------------
INT8 = "int8_residual"
ACTIONS = {
    "sync_store": dict(mode="sync", store_y=True, store_x=True, want_cache=True,
                       store_base=True),
    "displaced": dict(mode="displaced"),
    "displaced_codec": dict(mode="displaced", codec=INT8),
    "interweaved": dict(mode="interweaved"),
    "interweaved_light": dict(mode="interweaved", mask_policy="low",
                              effective_k=1, want_cache=True, codec=INT8),
    "interweaved_refresh": dict(mode="interweaved", effective_k=2,
                                want_cache=True, store_base=True),
    "staggered": dict(mode="staggered"),
}


def _actions(kw):
    kw = dict(kw)
    codec = kw.pop("codec", None)
    mine = plan_lib.LayerAction(
        codec=codecs.CompressConfig(codec).spec() if codec else None, **kw)
    ref = jax_plan.LayerAction(
        codec=jax_codecs.CompressConfig(codec).spec() if codec else None, **kw)
    return mine, ref


@pytest.mark.parametrize("name", list(ACTIONS))
def test_apply_layer_action_matches_jax(name):
    cfg, jcfg = smoke(), jax_smoke()
    T, K, d = 32, cfg.experts_per_token, cfg.d_model
    p, x = _moe_params(cfg), _tokens(T, d)
    arrs = {"y_buf": _tokens(T, d, 6), "x_prev": _tokens(T, d, 7),
            "h_cache": _tokens(T * K, d, 8).reshape(T, K, d),
            "c_base": x + 0.05 * _tokens(T, d, 9)}
    state = staleness.MoELayerState(**_t(arrs))
    jstate = jax_stale.MoELayerState(**_j(arrs))
    action, jaction = _actions(ACTIONS[name])
    y, new, aux = staleness.apply_layer_action(_t(p), _t(x), cfg, action, state)
    jy, jnew, jaux = jax_stale.apply_layer_action(_j(p), _j(x), jcfg, jaction,
                                                  jstate)
    _close(y, jy)
    for field in ("y_buf", "x_prev", "h_cache", "c_base"):
        got, want = getattr(new, field), getattr(jnew, field)
        assert (got is None) == (want is None), field
        if got is not None:
            _close(got, want, err_msg=field, **TOL)
    assert aux.dispatch_bytes == int(jaux.dispatch_bytes)
    assert new.bytes() == jnew.bytes()


def test_init_planned_states_match_jax():
    cfg = smoke()
    splan = plan_lib.compile_step_plans(
        DiceConfig.dice(compress=codecs.CompressConfig(INT8)),
        cfg.num_layers, 6, experts_per_token=cfg.experts_per_token)
    jplan = jax_plan.compile_step_plans(
        JaxDice.dice(compress=jax_codecs.CompressConfig(INT8)), cfg.num_layers,
        6, experts_per_token=cfg.experts_per_token)
    kw = dict(num_tokens=64, d_model=cfg.d_model, k=cfg.experts_per_token)
    states = staleness.init_planned_states(splan, device="cpu", **kw)
    jstates = jax_stale.init_planned_states(jplan, **kw)
    assert staleness.state_bytes(states) == jax_stale.state_bytes(jstates)
    for i in states:
        for field in ("y_buf", "x_prev", "h_cache", "c_base"):
            got, want = getattr(states[i], field), getattr(jstates[i], field)
            assert (got is None) == (want is None)
            if got is not None:
                assert tuple(got.shape) == tuple(want.shape)


# ---------------------------------------------------------------------------
# wire codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["none", "int8_residual"])
def test_codecs_match_jax(kind):
    r = _tokens(16, 96, seed=10)
    spec, jspec = codecs.CodecSpec(kind), jax_codecs.CodecSpec(kind)
    enc, jenc = codecs.encode(spec, _t(r)), jax_codecs.encode(jspec, _j(r))
    assert codecs.encoded_nbytes(enc) == jax_codecs.encoded_nbytes(jenc)
    assert spec.wire_bytes_per_row(96) == jspec.wire_bytes_per_row(96)
    # under jit, as the JAX package serves, XLA turns the int8 codec's
    # division by 127 into a product with the reciprocal; the port does the
    # same, so the wire tensors agree to the bit with the jitted encoder
    jdata = jax.jit(lambda a: jax_codecs.encode(jspec, a).data)(_j(r))
    for a, b in zip(enc.data, jdata):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(codecs.roundtrip(spec, _t(r)), jax_codecs.roundtrip(jspec, _j(r)))
    base = _tokens(16, 96, seed=11)
    got = codecs.apply(spec, _t(r), _t(base))
    want = jax_codecs.apply(jspec, _j(r), _j(base))
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["topk_residual", "bogus"])
def test_codecs_outside_the_slice_raise(kind):
    """An unknown codec is refused, not silently served as something else.
    ``topk_residual`` is ported now (tests/test_torch_faults.py holds it
    against the reference): like the reference it refuses a ``topk_frac``
    outside (0, 1]."""
    if kind == "topk_residual":
        for frac in (0.0, -0.5, 1.5):
            with pytest.raises(ValueError):
                codecs.CodecSpec(kind, topk_frac=frac)
            with pytest.raises(ValueError):
                jax_codecs.CodecSpec(kind, topk_frac=frac)
        assert codecs.CodecSpec(kind).keep_count(1152) == \
            jax_codecs.CodecSpec(kind).keep_count(1152) == 144
        return
    with pytest.raises(ValueError):
        codecs.CodecSpec(kind)
    with pytest.raises(ValueError):
        codecs.CompressConfig(kind)
