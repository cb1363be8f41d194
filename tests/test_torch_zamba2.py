"""The port's Zamba2 (hybrid family) against the JAX package's, on the CPU.

``repro_torch.models.zamba2`` (``forward``, ``loss_fn``, ``prefill``,
``decode_step``, ``_ssd_scan``, the depthwise conv's rounding) is held
against ``repro.models.zamba2`` with the reference's own params
(``init_zamba2``) carried over by ``bridge.from_jax_params``, the SSD's
``A_log``, ``dt_bias`` and ``D`` moved off their init values, tokens drawn
from a seed with numpy.  Two layouts: the ``smoke()`` config (2
superblocks, no trailing blocks) and a ragged one (8 blocks at k = 3: two
trailing mamba blocks, as zamba2-7b's 81 at k = 6 leave three).  The shared
block's attention runs the flash wrapper's plain version, as on the CPU it
does.

Tolerances: f32 params 1e-4; bf16 params 5e-2 (``tests/test_torch_dense.py``'s
MODEL_TOL); ``_ssd_scan`` alone in f32 SSD_TOL, rtol 1e-5 and atol 1e-5 of
the output's largest magnitude (its chunk products sum in another order
than the reference's steps: observed 2.3e-7 relative at dt up to 10).
Under f32 params the reference still rounds the conv tail and the KV cache
to bf16: where the two frameworks' f32 values (1e-7 apart) straddle a bf16
rounding boundary they round one bf16 ulp apart (0.1-0.5% of the
elements).  So those leaves are held to one bf16 ulp on top of the f32
atol (BF16_LEAF_TOL: near zero the f32 values differ by more than an ulp), and
f32 prefill logits, whose attention reads the cache it has just rounded,
to CACHE_TOL (observed 1.0e-3 with 61 of 12,288 k elements an ulp apart),
as is the prefill's state after the first attention block.
Each decode step starts from the reference's state, carried over bit for
bit (as ``chip_smoke.py`` 14a starts the CPU's steps from the card's): from
there the f32 steps match to 8.6e-6; chained from the port's own state the
ulp flips feed back (4e-3 after 8 steps).

The reference's ``_ssd_scan`` raises when T is past one chunk and not a
whole number of chunks (it adds ``D * xh`` with the padded ``xh``: ROADMAP.md
C.10).  There the port is held to the reference run on inputs padded with
dt = 0 steps, the padding the reference's own code intends.
"""
import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.models import zamba2 as jax_zamba2
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import layers
from repro_torch.models import zamba2
from repro_torch.models.api import get_model

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BF16_LEAF_TOL = dict(rtol=2 ** -7, atol=1e-4)       # one bf16 ulp beside f32's 1e-4
CACHE_TOL = {"float32": dict(rtol=1e-4, atol=5e-3), "bfloat16": MODEL_TOL["bfloat16"]}
B, PROMPT, DECODE = 2, 16, 8


def _layouts():
    smoke = get_smoke("zamba2-7b")
    return {"smoke": smoke,
            "ragged": smoke.replace(name="zamba2-smoke-ragged", num_layers=8)}


LAYOUTS = _layouts()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _jax_cfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, dtype, seed=0):
    """The reference's params with the SSD's A_log, dt_bias and D drawn off
    their init values (0, -4, 1: every head alike), and the port's copy."""
    jp = jax_zamba2.init_zamba2(jax.random.PRNGKey(seed), _jax_cfg(cfg),
                                dtype=DTYPES[dtype][0])
    rng = np.random.default_rng(seed + 100)
    m = jp["mamba"]
    m["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, m["A_log"].shape), jnp.float32)
    m["dt_bias"] = jnp.asarray(rng.uniform(-4.0, 1.0, m["dt_bias"].shape), jnp.float32)
    m["D"] = jnp.asarray(rng.normal(1.0, 0.5, m["D"].shape), jnp.float32)
    return jp, bridge.from_jax_params(jax.device_get(jp), device="cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _close_state(got, want, dtype, keys, what, tol=None):
    """Leaf by leaf at ``tol`` (MODEL_TOL[dtype]); the bf16 leaves of an f32
    model (the conv tail, the cache) one bf16 ulp wider (BF16_LEAF_TOL)."""
    for k in keys:
        t = tol or MODEL_TOL[dtype]
        if dtype == "float32" and got[k].dtype == torch.bfloat16:
            t = dict(t, rtol=BF16_LEAF_TOL["rtol"])
        _close(got[k], want[k], t, f"{what} {k}")
    assert got["pos"] == int(want["pos"])


def _to_torch(tree):
    """A JAX state (or sub-tree) as torch CPU tensors, bf16 bit for bit;
    ``pos`` a host int."""
    if isinstance(tree, dict):
        return {k: int(v) if k == "pos" else _to_torch(v) for k, v in tree.items()}
    arr = np.asarray(jax.device_get(tree))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


# ---------------------------------------------------------------------------
# configs, layout, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_field_equal_to_jax(which):
    ours = getattr(importlib.import_module("repro_torch.configs.zamba2_7b"), which)()
    ref = getattr(importlib.import_module("repro.configs.zamba2_7b"), which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert (get_config("zamba2-7b") if which == "config" else get_smoke("zamba2-7b")) == ours


@pytest.mark.parametrize("cfg", [get_config("zamba2-7b"), *LAYOUTS.values()],
                         ids=["zamba2-7b", *LAYOUTS])
def test_layout_matches_jax(cfg):
    jcfg = _jax_cfg(cfg)
    assert zamba2._layout(cfg) == jax_zamba2._layout(jcfg)
    assert zamba2.num_mamba_blocks(cfg) == jax_zamba2.num_mamba_blocks(jcfg)
    assert zamba2.num_attn_blocks(cfg) == jax_zamba2.num_attn_blocks(jcfg)
    order = zamba2._blocks(cfg)
    assert [i for kind, i in order if kind == "mamba"] == \
        list(range(zamba2.num_mamba_blocks(cfg)))
    assert [i for kind, i in order if kind == "attn"] == \
        list(range(zamba2.num_attn_blocks(cfg)))
    if cfg.name == "zamba2-7b":
        assert zamba2._layout(cfg) == (13, 5, 65, 3)
        assert [k for k, _ in order[-4:]] == ["attn", "mamba", "mamba", "mamba"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    cfg = LAYOUTS["ragged"]
    got = zamba2.init_zamba2(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=DTYPES[dtype][1])
    want = jax_zamba2.init_zamba2(jax.random.PRNGKey(0), _jax_cfg(cfg),
                                  dtype=DTYPES[dtype][0])
    shapes = lambda t: {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))  # noqa: E731
                        for k, v in bridge.leaves(t).items()}
    assert shapes(got) == shapes(want)
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_array_equal(got["mamba"][k].numpy(),
                                      np.asarray(want["mamba"][k]))
    st = zamba2.init_state(cfg, 3, attn_cache_len=5, device="cpu")
    jst = jax_zamba2.init_state(_jax_cfg(cfg), 3, attn_cache_len=5)
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items() if k != "pos"} == \
        {k: (tuple(v.shape), getattr(torch, str(v.dtype))) for k, v in jst.items()
         if k != "pos"}


# ---------------------------------------------------------------------------
# the SSD recurrence and the conv alone
# ---------------------------------------------------------------------------
SSD_TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(T, dt_max, seed):
    rng = np.random.default_rng(seed)
    Bs, H, P, N = 2, 3, 8, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = (dt_max * rng.random((Bs, T, H))).astype(np.float32)
    A = np.exp(rng.uniform(-1, 1, H)).astype(np.float32)
    return f(Bs, T, H, P), f(Bs, T, N), f(Bs, T, N), dt, A, f(H), f(Bs, H, N, P)


@pytest.mark.parametrize("dt_max", [0.1, 10.0], ids=["weak", "strong"])
@pytest.mark.parametrize("T", [1, 127, 128, 129, 300])
def test_ssd_scan_matches_reference(T, dt_max):
    """y and S_T against the reference's step-at-a-time scan; at dt 10 a
    step's decay is down to e^-27 (A up to e), chunks underflow."""
    x, b, c, dt, A, D, S0 = _ssd_inputs(T, dt_max, seed=T)
    Tp = -(-T // 128) * 128 if T > 128 else T         # C.10: whole chunks
    pad = lambda a: np.pad(a, ((0, 0), (0, Tp - T)) + ((0, 0),) * (a.ndim - 2))  # noqa: E731
    want_y, want_S = jax.jit(jax_zamba2._ssd_scan)(
        *(jnp.asarray(a) for a in (pad(x), pad(b), pad(c), pad(dt), A, D, S0)))
    want_y = np.asarray(want_y)[:, :T]
    got_y, got_S = zamba2._ssd_scan(*(torch.from_numpy(a) for a in (x, b, c, dt, A, D, S0)))
    assert got_y.dtype == got_S.dtype == torch.float32
    assert tuple(got_y.shape) == x.shape and tuple(got_S.shape) == S0.shape
    for got, want in ((got_y, want_y), (got_S, np.asarray(want_S))):
        tol = dict(SSD_TOL, atol=SSD_TOL["atol"] * max(1.0, float(np.abs(want).max())))
        _close(got, want, tol)


def test_reference_ssd_scan_raises_off_whole_chunks():
    """C.10: the reference pads xh to whole chunks and adds D * xh with the
    padded xh to the sliced y; the port returns T rows."""
    x, b, c, dt, A, D, S0 = _ssd_inputs(129, 1.0, seed=0)
    with pytest.raises(TypeError, match="broadcast"):
        jax_zamba2._ssd_scan(*(jnp.asarray(a) for a in (x, b, c, dt, A, D, S0)))
    y, _ = zamba2._ssd_scan(*(torch.from_numpy(a) for a in (x, b, c, dt, A, D, S0)))
    assert y.shape[1] == 129


def test_segsum_sums_each_segment_itself():
    """At strong decay exp(cs[i] - cs[j]) of two cumulative sums near
    -640 loses digits that the segment sum keeps: the relative error of the
    decays that do not underflow (segments above -80)."""
    la = -10.0 * torch.from_numpy(np.random.default_rng(3).random(128).astype(np.float32))
    seg = zamba2._segsum(la)
    exact = zamba2._segsum(la.double())
    cs = la.cumsum(0)
    diff = (cs[:, None] - cs[None, :]).masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                                                   -float("inf"))
    live = exact > -80
    rel = lambda s: float(((s.double().exp() - exact.exp()) / exact.exp())[live].abs().max())  # noqa: E731
    assert rel(seg) < 2e-5 < rel(diff), (rel(seg), rel(diff))
    assert bool(torch.isneginf(seg[~torch.isfinite(exact)]).all())


def test_depthwise_conv_rounds_like_the_reference():
    """bf16: the conv's products and partial sums rounded in the
    reference's order give its values bit for bit (inside jit and inside
    lax.scan, where XLA could keep f32); one f32 sum rounded once does not."""
    rng = np.random.default_rng(5)
    T, K, inner = 24, 4, 256
    ctx = jnp.asarray(rng.standard_normal((2, K - 1 + T, inner)), jnp.bfloat16)
    w = jnp.asarray(0.3 * rng.standard_normal((K, inner)), jnp.bfloat16)

    def ref_conv(ctx, w):
        return sum(ctx[:, K - 1 - j: K - 1 - j + T] * w[K - 1 - j][None, None]
                   for j in range(K))

    def in_scan(ctx, w):
        return jax.lax.scan(lambda c, _: (c, ref_conv(ctx, w)), 0, None, length=1)[1][0]

    tctx, tw = _to_torch(ctx), _to_torch(w)
    got = zamba2._depthwise_conv(tctx, tw, T).view(torch.int16).numpy()
    for fn in (ref_conv, in_scan):
        want = np.asarray(jax.jit(fn)(ctx, w)).view(np.int16)
        np.testing.assert_array_equal(got, want)
    once = sum(tctx[:, K - 1 - j:K - 1 - j + T].float() * tw[K - 1 - j].float()
               for j in range(K)).bfloat16().view(torch.int16).numpy()
    assert (once != want).mean() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_rounds_like_the_reference(dtype):
    """layers.silu (the mamba block's and the MLP's) against jax.nn.silu
    under jit: bf16 bit for bit, where F.silu's single rounding misses a
    third of the values; f32 to an ulp or two."""
    x = np.random.default_rng(6).standard_normal(100_000).astype(np.float32) * 3
    jx = jnp.asarray(x, DTYPES[dtype][0])
    want = np.asarray(jax.jit(jax.nn.silu)(jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(DTYPES[dtype][1])
    got = layers.silu(tx).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        assert (torch.nn.functional.silu(tx).float().numpy() != want).mean() > 0.3
    else:
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_matches_jax(layout, dtype):
    """forward's logits and state, loss_fn, prefill's logits and state
    (S, conv, k, v) leaf by leaf, then DECODE steps (cache_len PROMPT +
    DECODE), each from the reference's state: logits and the state after
    each step."""
    cfg = LAYOUTS[layout]
    jcfg = _jax_cfg(cfg)
    tol = MODEL_TOL[dtype]
    jp, tp = _params(cfg, dtype)
    toks = _tokens(cfg, 1, (B, PROMPT + DECODE))
    tt = torch.from_numpy(toks)

    want, want_st = jax.jit(jax_zamba2.forward, static_argnums=2)(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, got_st = zamba2.forward(tp, tt, cfg)
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == (B, PROMPT + DECODE, cfg.vocab_size)
    _close(got, want, tol, "forward logits")
    _close_state(got_st, want_st, dtype, ("S", "conv"), "forward state")

    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want_loss, _ = jax.jit(jax_zamba2.loss_fn, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got_loss, got_m = zamba2.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         cfg)
    _close(got_loss, want_loss, tol, "loss")
    assert got_m["ce"] is got_loss

    n = PROMPT + DECODE
    want_lg, jst = jax.jit(partial(jax_zamba2.prefill, cfg=jcfg, cache_len=n))(
        jp, jnp.asarray(toks[:, :PROMPT]))
    with torch.no_grad():
        got_lg, st = zamba2.prefill(tp, tt[:, :PROMPT], cfg, cache_len=n)
    _close(got_lg, want_lg, CACHE_TOL[dtype], "prefill logits")
    _close_state(st, jst, dtype, ("S", "conv", "k", "v"), "prefill state",
                 CACHE_TOL[dtype])
    assert st["k"].dtype == st["conv"].dtype == torch.bfloat16 and st["pos"] == PROMPT

    jdec = jax.jit(partial(jax_zamba2.decode_step, cfg=jcfg))
    for t in range(PROMPT, n):
        st = _to_torch(jst)
        want_lg, jst = jdec(jp, jnp.asarray(toks[:, t]), jst)
        with torch.no_grad():
            got_lg, st = zamba2.decode_step(tp, tt[:, t], st, cfg)
        _close(got_lg, want_lg, tol, f"decode {t} logits")
        _close_state(st, jst, dtype, ("S", "conv", "k", "v"), f"decode {t} state")


def test_forward_continues_from_a_state():
    """forward(state=) continues from a state: S, the bf16 conv tail and
    pos (RoPE positions), here the reference's own after the first call."""
    cfg = LAYOUTS["ragged"]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, "float32", seed=1)
    toks = _tokens(cfg, 2, (B, 20))
    jfwd = jax.jit(jax_zamba2.forward, static_argnums=2)
    _, jst = jfwd(jp, jnp.asarray(toks[:, :12]), jcfg)
    st = _to_torch(jst)
    want, jst = jfwd(jp, jnp.asarray(toks[:, 12:]), jcfg, state=jst)
    with torch.no_grad():
        got, st = zamba2.forward(tp, torch.from_numpy(toks[:, 12:]), cfg, state=st)
    _close(got, want, MODEL_TOL["float32"])
    _close_state(st, jst, "float32", ("S", "conv"), "state")
    assert st["pos"] == 20


def test_ring_decode_with_a_window_matches_jax():
    """A cache of exactly the prompt's slots, decoded past it: the ring
    wraps (the oldest slot overwritten) under attn_window 6, each step's
    logits and the ring against the reference's (each step from its state)."""
    cfg = LAYOUTS["smoke"]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, "float32", seed=2)
    toks = _tokens(cfg, 3, (B, PROMPT + DECODE))
    tt = torch.from_numpy(toks)
    want_lg, jst = jax.jit(partial(jax_zamba2.prefill, cfg=jcfg, attn_window=6))(
        jp, jnp.asarray(toks[:, :PROMPT]))
    with torch.no_grad():
        got_lg, st = zamba2.prefill(tp, tt[:, :PROMPT], cfg, attn_window=6)
    _close(got_lg, want_lg, CACHE_TOL["float32"])
    jdec = jax.jit(partial(jax_zamba2.decode_step, cfg=jcfg, attn_window=6))
    for t in range(PROMPT, PROMPT + DECODE):
        st = _to_torch(jst)
        want_lg, jst = jdec(jp, jnp.asarray(toks[:, t]), jst)
        with torch.no_grad():
            got_lg, st = zamba2.decode_step(tp, tt[:, t], st, cfg, attn_window=6)
        _close(got_lg, want_lg, MODEL_TOL["float32"], f"step {t}")
    _close_state(st, jst, "float32", ("S", "k", "v"), "ring")


# ---------------------------------------------------------------------------
# bridge, get_model
# ---------------------------------------------------------------------------
def test_bridge_carries_a_zamba2_tree_bit_for_bit():
    cfg = LAYOUTS["ragged"]
    tree = jax.device_get(jax_zamba2.init_zamba2(jax.random.PRNGKey(0), _jax_cfg(cfg)))
    params = bridge.from_jax_params(tree, device="cpu")
    ref, got = bridge.leaves(tree), bridge.leaves(params)
    assert list(got) == list(ref)
    for path, leaf in ref.items():
        t = got[path]
        assert tuple(t.shape) == leaf.shape, path
        if leaf.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=path)
    assert params["mamba"]["w_xz"].shape[0] == zamba2.num_mamba_blocks(cfg)
    assert params["shared_attn"]["attn"]["wq"].dim() == 2      # ONE block
    del tree["mamba"]["dt_bias"]
    with pytest.raises(KeyError, match="dt_bias"):
        bridge.from_jax_params(tree, device="cpu")


def test_get_model_round_trip():
    cfg = LAYOUTS["smoke"]
    api = get_model(cfg)
    _, tp = _params(cfg, "float32")
    tt = torch.from_numpy(_tokens(cfg, 8, (B, PROMPT + 1)))
    with torch.no_grad():
        lg, st = api.prefill(tp, {"tokens": tt[:, :PROMPT]}, cfg, cache_len=PROMPT + 1)
        want, want_st = zamba2.prefill(tp, tt[:, :PROMPT], cfg, cache_len=PROMPT + 1)
        assert torch.equal(lg, want) and torch.equal(st["k"], want_st["k"])
        lg, st = api.decode_step(tp, {"token": tt[:, PROMPT]}, st, cfg)
        want, want_st = zamba2.decode_step(tp, tt[:, PROMPT], want_st, cfg)
        assert torch.equal(lg, want) and st["pos"] == PROMPT + 1
        ce, _ = api.loss_fn(tp, {"tokens": tt, "labels": tt}, cfg)
    assert torch.isfinite(ce)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0))
    assert params["embed"].dtype == torch.bfloat16
    st = api.init_cache(cfg, 2, 8, device="cpu")
    assert st["k"].shape == (zamba2.num_attn_blocks(cfg), 2, 8, cfg.num_kv_heads,
                             cfg.head_dim)
    assert api.extra_inputs == ()


def test_attn_apply_reads_a_bf16_cache_in_q_dtype():
    """f32 q over zamba2's bf16 cache: the plain version and the kernel take
    one dtype, so attn_apply reads the cache as q's, as the reference's
    attention upcasts it; the cache it returns stays bf16."""
    cfg = LAYOUTS["smoke"]
    _, tp = _params(cfg, "float32")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    ck = torch.zeros(2, 7, cfg.num_kv_heads, cfg.head_dim, dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    out, (k, v) = layers.attn_apply(tp["shared_attn"]["attn"], x,
                                    torch.arange(5)[None].expand(2, 5), cfg,
                                    kv_cache=(ck, cv), cache_pos=0, kv_valid_len=5)
    assert out.dtype == torch.float32 and k is ck and v is cv and ck[:, :5].any()
