"""The port's RWKV-6 training slice against the JAX package, on the CPU.

The recurrence's backward (``kernels/ref.rwkv6_scan_bwd_ref``, the plain
version of ``csrc/rwkv6_scan_bwd.cu``) is held against ``jax.vjp`` of the
reference's oracle; a plain torch mirror of the kernel's chunked arithmetic
(``_chunked_kernel``: 16-step chunks, decays as running products, the
finish launch's reverse sums for dlogw) against the plain backward and
``jax.vjp``; ``ops.RWKV6ScanFn``; the step-0 gradients of ``loss_fn`` against
``jax.grad`` of the reference's, leaf by leaf; ``lm_train_step`` against the
losses the reference's own ``train_lm`` prints; the train CLI's checkpoint
read by the reference; and serving untouched by the autograd wiring.

Tolerances, with their reasons:
  * the plain backward against ``jax.vjp``: f32 outputs within
    ``1e-5 * max|want|`` (f32 sums in another order, chained over T); bf16
    outputs within ``2e-2`` relative and absolute (as ``KERNEL_TOL``: both
    round the same f32 value once, which can land on the neighbouring
    bf16 value);
  * the chunked mirror against the plain backward: within
    ``1e-5 * max|want|`` (at T = 1024 with decays drawn over [-6, 2], w
    from 6e-4 to 0.9975, observed 7.5e-7 for dlogw, 2.2e-7 for the rest;
    logw of -1e-4 over T = 1024 3.5e-6), except dlogw where a chunk's
    decays underflow (logw over [-30, -20]): dlogw is then ~1e-11 of the
    running sums' terms it is the difference of, so its error is held to
    ``1e-5`` of the largest term (``r dr`` and ``k dk``), not of itself;
  * step-0 gradients: f32 params within ``1e-4 * max|want| + 1e-6`` per
    leaf (observed 2.7e-6 of the max); bf16 params within
    ``5e-2 * max|want|``, ``MODEL_TOL``'s bf16 rtol (observed 2.1e-2, on
    ``cm_mix``; the two frameworks' bf16 products round about 0.02% of
    their outputs to the neighbouring value);
  * the training losses against the reference's printed 4-decimal ones,
    bf16 params as its init gives them, 24 steps (past the warm-up of
    20): rtol 2e-3 (the bf16 forward alone moves step 0's loss by 1.3e-4
    relative; the bf16 updates then round apart at a few elements;
    observed 8.3e-4 at worst).
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import ref as jax_ref
from repro.launch import train as jax_train
from repro.models import rwkv6 as jax_rwkv6
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.configs import get_smoke
from repro_torch.data.synthetic import token_batches
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import lm_train_step
from repro_torch.models import rwkv6
from repro_torch.optim import adamw

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
F32_REL = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (5e-2, 0.0)}
LOSS_RTOL = 2e-3
TRAIN_STEPS = 24


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close_rel(got, want, rel=F32_REL, name=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, name
    bound = rel * np.abs(w).max()
    assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(), bound)


def _scan_inputs(seed, B, H, T, DK, dtype, decay=(-6.0, 2.0)):
    """numpy inputs: r, k, v, dout normal; logw = -exp(decay) with decay
    uniform over ``decay``; u normal; s0, dS_T 0.5 x normal.  r/k/v/u in
    ``dtype`` (rounded once), the rest f32."""
    rng = np.random.default_rng(seed)
    r, k, v, dout = (rng.standard_normal((B, H, T, DK)).astype(np.float32)
                     for _ in range(4))
    logw = -np.exp(rng.uniform(*decay, (B, H, T, DK))).astype(np.float32)
    u = rng.standard_normal((H, DK)).astype(np.float32)
    s0, dS = (0.5 * rng.standard_normal((B, H, DK, DK))).astype(np.float32), \
        (0.5 * rng.standard_normal((B, H, DK, DK))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jax_in = [jnp.asarray(a).astype(jdt) for a in (r, k, v)] \
        + [jnp.asarray(logw), jnp.asarray(u).astype(jdt), jnp.asarray(s0)]
    port_in = [_t(a).to(tdt) for a in (r, k, v)] + [_t(logw), _t(u).to(tdt), _t(s0)]
    return jax_in, port_in, dout, dS


# ---------------------------------------------------------------------------
# (1) the plain backward against jax.vjp of the reference's oracle
# ---------------------------------------------------------------------------
def _jax_scan(r, k, v, logw, u, s0):
    """The reference's oracle with u cast to f32 outside the scan, as the
    model's ``_time_mix_scan`` casts ``bonus_u``: its cotangent is then
    summed in f32 and rounded once (the oracle alone promotes a bf16 u
    inside each step, and its scan sums the cotangent in bf16)."""
    return jax_ref.rwkv6_scan_ref(r, k, v, logw, u.astype(jnp.float32), s0)


@pytest.mark.parametrize("T", [1, 37, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_dS", [True, False])
def test_rwkv6_scan_bwd_ref_matches_jax_vjp(T, dtype, with_dS):
    jax_in, port_in, dout, dS = _scan_inputs(T, 2, 2, T, 16, dtype)
    (out, sT), vjp = jax.vjp(_jax_scan, *jax_in)
    want = vjp((jnp.asarray(dout), jnp.asarray(dS) if with_dS
                else jnp.zeros_like(sT)))
    dS_T = _t(dS) if with_dS else None
    got = ref.rwkv6_scan_bwd_ref(*port_in, _t(dout), dS_T)
    chunked = _chunked_kernel(*port_in, _t(dout), dS_T)
    for name, g, c, w, x in zip(NAMES, got, chunked, want, port_in):
        assert g.dtype == (torch.float32 if name in ("dlogw", "ds0") else x.dtype), name
        c = c.to(g.dtype)                      # the kernel rounds its f32 sums once
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **BF16_TOL)
            np.testing.assert_allclose(_np(c), _np(w), err_msg=name, **BF16_TOL)
        else:
            _close_rel(g, w, name=name)
            _close_rel(c, w, name=name)


# ---------------------------------------------------------------------------
# (2) the kernel's chunked arithmetic, in plain torch, against the plain
# backward
# ---------------------------------------------------------------------------
CHUNK = 16


def _decays(w):
    """alpha_t = prod_{m<t} w_m, beta_t = prod_{m>t} w_m down a chunk's
    16 rows of w (..., 16, DK), and Lambda = the whole chunk's product, as
    running products (the kernel's one thread a column)."""
    al, be = [None] * CHUNK, [None] * CHUNK
    a = torch.ones_like(w[..., 0, :])
    for t in range(CHUNK):
        al[t] = a
        a = a * w[..., t, :]
    b = torch.ones_like(a)
    for t in reversed(range(CHUNK)):
        be[t] = b
        b = b * w[..., t, :]
    return torch.stack(al, -2), torch.stack(be, -2), a


def _chunked_kernel(r, k, v, logw, u, s0, dout, dS_T=None):
    """The arithmetic of ``csrc/rwkv6_scan_bwd.cu``, over all (b, h) at
    once, in f32.  Time in chunks of 16 (rows past T zero, w 1); A = dOut
    V^T of a chunk.  The P side walks forward from s0: dr^st = alpha (.)
    (dOut P_a^T) + the sum over s < t of D_{t,s} k_s A[t][s] (Horner:
    acc = acc w_s + k_s A[t][s]), dr, r (.) dr^st, du's parts, then P_e =
    Lambda P_a + (K beta)^T V and at the end Q_T.  The G side walks
    backward from dS_T; one pass over m > t with the running products d =
    D_{m,t} gives B[m][t] = sum_i k_t d r_m and dk^in_t = the sum over m < L
    of d r_m A[m][t]; dk^st = beta (.) (V G_e^T) + dk^in, dv = (K beta) G_e
    + B^T dOut + dout bs, k (.) dk^st, then G_a = Lambda G_e + (R alpha)^T
    dOut.  The finish: dlogw as the reverse running sum from Q_T, split
    over spans of time as the finish launch splits it; du over b."""
    f = torch.float32
    r, k, v, logw, dout = (a.to(f) for a in (r, k, v, logw, dout))
    u = u.to(f)[None]
    B, H, T, DK = r.shape
    n = (T + CHUNK - 1) // CHUNK

    def tiles(x, fill=0.0):
        x = torch.nn.functional.pad(x, (0, 0, 0, n * CHUNK - T), value=fill)
        return x.reshape(B, H, n, CHUNK, DK)
    rt, kt, vt, dt = (tiles(a) for a in (r, k, v, dout))
    wt = torch.exp(tiles(logw))
    vd = (vt * dt).sum(-1)[..., None]
    bs = (u[:, :, None, None] * rt * kt).sum(-1)[..., None]
    steps = torch.arange(CHUNK)
    uu = u[:, :, None]
    dr, rdr, dk, kdk, dv = (torch.empty_like(rt) for _ in range(5))

    P, du = s0.to(f), torch.zeros((B, H, DK))                   # the P side
    for c in range(n):
        rc, kc, vc, wc, dc = (x[:, :, c] for x in (rt, kt, vt, wt, dt))
        al, be, lam = _decays(wc)
        A = torch.einsum("bhtj,bhsj->bhts", dc, vc)
        acc = torch.zeros_like(rc)
        for s in range(CHUNK - 1):
            live = (steps > s)[:, None]
            acc = torch.where(live, acc * wc[..., s:s + 1, :] + kc[..., s:s + 1, :]
                              * A[..., s:s + 1], acc)
        drst = al * torch.einsum("bhtj,bhij->bhti", dc, P) + acc
        dr[:, :, c] = drst + uu * kc * vd[:, :, c]
        rdr[:, :, c] = rc * drst
        du = du + (rc * kc * vd[:, :, c]).sum(-2)
        P = lam[..., None] * P + torch.einsum("bhti,bhtj->bhij", kc * be, vc)
    Q = torch.zeros((B, H, DK)) if dS_T is None else (dS_T.to(f) * P).sum(-1)

    G = torch.zeros_like(P) if dS_T is None else dS_T.to(f)   # the G side
    for c in reversed(range(n)):
        L = min(CHUNK, T - c * CHUNK)
        rc, kc, vc, wc, dc = (x[:, :, c] for x in (rt, kt, vt, wt, dt))
        al, be, lam = _decays(wc)
        A = torch.einsum("bhtj,bhsj->bhts", dc, vc)
        acc = torch.zeros_like(rc)
        Bm = torch.zeros((B, H, CHUNK, CHUNK))
        for t in range(CHUNK):
            d = torch.ones((B, H, DK))
            for m in range(t + 1, L):
                x = d * rc[..., m, :]
                Bm[..., m, t] = (kc[..., t, :] * x).sum(-1)
                acc[..., t, :] = acc[..., t, :] + x * A[..., m, t, None]
                d = d * wc[..., m, :]
        dkst = be * torch.einsum("bhtj,bhij->bhti", vc, G) + acc
        dk[:, :, c] = dkst + uu * rc * vd[:, :, c]
        kdk[:, :, c] = kc * dkst
        dv[:, :, c] = (torch.einsum("bhti,bhij->bhtj", kc * be, G)
                       + torch.einsum("bhmt,bhmj->bhtj", Bm, dc) + dc * bs[:, :, c])
        G = lam[..., None] * G + torch.einsum("bhti,bhtj->bhij", rc * al, dc)

    def flat(x):
        return x.reshape(B, H, n * CHUNK, DK)[:, :, :T]
    rdr, kdk = flat(rdr), flat(kdk)
    nseg = min(32, (T + 15) // 16)                              # the finish
    span = (T + nseg - 1) // nseg
    spans = [(min(T, j * span), min(T, j * span + span)) for j in range(nseg)]
    tot = []
    for t0, t1 in spans:
        acc = torch.zeros((B, H, DK))
        for t in reversed(range(t0, t1)):
            acc = acc + (rdr[:, :, t] - kdk[:, :, t])
        tot.append(acc)
    dlogw = torch.empty((B, H, T, DK))
    for j, (t0, t1) in enumerate(spans):
        R = Q
        for later in reversed(range(j + 1, nseg)):
            R = R + tot[later]
        for t in reversed(range(t0, t1)):
            R = R - kdk[:, :, t]
            dlogw[:, :, t] = R
            R = R + rdr[:, :, t]
    return (flat(dr), flat(dk), flat(dv), dlogw, du.sum(0), G)


def _close_chunked(got, want, port_in, rel=F32_REL):
    """Each output within ``rel`` of its largest value; dlogw also passes
    within ``rel`` of the running sums' largest term (max |r dr|, |k dk|)
    when its own values are far smaller than the terms it is the
    difference of (underflowing decays)."""
    r, k = (x.to(torch.float32) for x in port_in[:2])
    for name, g, w in zip(NAMES, got, want):
        if name == "dlogw":
            terms = max(float((r * want[0]).abs().max()), float((k * want[1]).abs().max()))
            bound = rel * max(float(w.abs().max()), terms)
            assert float((g - w).abs().max()) <= bound, (name, float((g - w).abs().max()), bound)
        else:
            _close_rel(g, w, rel, name=name)


@pytest.mark.parametrize("with_dS", [True, False])
def test_kernel_passes_match_the_plain_backward_at_T_1024(with_dS):
    """The chunked form and its reverse-sum dlogw need no state of step t
    and divide by no decay: at T = 1024 with w down to 6e-4 they stay
    within 1e-5 of the largest value of the direct form
    ``w_t sum_v dS_t S_{t-1}``."""
    _, port_in, dout, dS = _scan_inputs(11, 1, 2, 1024, 32, "float32")
    dS_T = _t(dS) if with_dS else None
    want = ref.rwkv6_scan_bwd_ref(*port_in, _t(dout), dS_T)
    got = _chunked_kernel(*port_in, _t(dout), dS_T)
    for name, g, w in zip(NAMES, got, want):
        _close_rel(g, w, name=name)


def test_kernel_passes_keep_the_init_regime():
    """Decays drawn in [-6, -5] (the init's -6 and the longest memory)."""
    _, port_in, dout, dS = _scan_inputs(12, 1, 1, 512, 16, "float32", decay=(-6.0, -5.0))
    want = ref.rwkv6_scan_bwd_ref(*port_in, _t(dout), _t(dS))
    for name, g, w in zip(NAMES, _chunked_kernel(*port_in, _t(dout), _t(dS)), want):
        _close_rel(g, w, name=name)


def _logw_inputs(seed, T, logw, DK=16):
    """_scan_inputs at B = 1, H = 2 with logw replaced by ``logw(rng,
    shape)``."""
    _, port_in, dout, dS = _scan_inputs(seed, 1, 2, T, DK, "float32")
    port_in[3] = _t(logw(np.random.default_rng(seed + 100), (1, 2, T, DK)).astype(np.float32))
    return port_in, dout, dS


def _one_minus_inf(rng, shape):
    lw = -np.exp(rng.uniform(-6.0, 2.0, shape))
    lw[0, 1, 20, 3] = -np.inf            # one row of one head's state: w 0 at step 20
    return lw


@pytest.mark.parametrize("case,T,logw", [
    ("logw -inf at one step", 45, _one_minus_inf),
    ("decays underflow in a chunk", 64, lambda rng, s: rng.uniform(-30.0, -20.0, s)),
    ("decays near 1", 1024, lambda rng, s: -1e-4 * rng.uniform(0.5, 1.5, s)),
    ("T 1", 1, lambda rng, s: -np.exp(rng.uniform(-6.0, 2.0, s))),
    ("T 37", 37, lambda rng, s: -np.exp(rng.uniform(-6.0, 2.0, s))),
    ("T 300", 300, lambda rng, s: -np.exp(rng.uniform(-6.0, 2.0, s)))],
    ids=lambda x: x if isinstance(x, str) else None)
@pytest.mark.parametrize("with_dS", [True, False])
def test_chunked_kernel_matches_the_plain_backward_at_extreme_decays(case, T, logw, with_dS):
    """The decays are products, never exp of a difference of cumulative
    log-decays: a logw of -inf (w = 0) gives no NaN, a chunk whose
    product underflows f32 gives the plain version's outputs, decays near
    1 over 1024 steps keep their accuracy; a ragged last chunk (T not a
    multiple of 16) is masked by selection."""
    port_in, dout, dS = _logw_inputs(T, T, logw)
    dS_T = _t(dS) if with_dS else None
    want = ref.rwkv6_scan_bwd_ref(*port_in, _t(dout), dS_T)
    got = _chunked_kernel(*port_in, _t(dout), dS_T)
    for g in got:
        assert bool(torch.isfinite(g).all()), case
    _close_chunked(got, want, port_in)


# ---------------------------------------------------------------------------
# (3) the autograd Function on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_fn_runs_the_plain_backward_on_cpu(dtype):
    """torch.autograd through ops.rwkv6_scan gives the plain backward's
    gradients bit for bit (an unused S_T reaches it as None, not as
    zeros); no launch is counted on the CPU; without grad nothing enters
    the Function."""
    _, port_in, dout, dS = _scan_inputs(3, 2, 2, 9, 16, dtype)
    live = [a.clone().requires_grad_() for a in port_in]
    before = dict(ops.LAUNCHES)
    out, sT = ops.rwkv6_scan(*live)
    assert "RWKV6ScanFn" in type(out.grad_fn).__name__
    plain = [a.detach() for a in live]
    for dS_T in (None, _t(dS)):
        loss = (out * _t(dout)).sum()
        if dS_T is not None:
            loss = loss + (sT * dS_T).sum()
        got = torch.autograd.grad(loss, live, retain_graph=True)
        want = ref.rwkv6_scan_bwd_ref(*plain, _t(dout), dS_T)
        for name, g, w, x in zip(NAMES, got, want, plain):
            assert g.dtype == x.dtype, name
            assert torch.equal(g, w.to(x.dtype)), name
    # only the state used: dout arrives as None and means zeros
    got = torch.autograd.grad((sT * _t(dS)).sum(), live)
    want = ref.rwkv6_scan_bwd_ref(*plain, torch.zeros_like(out), _t(dS))
    for g, w, x in zip(got, want, plain):
        assert torch.equal(g, w.to(x.dtype))
    with torch.no_grad():
        assert ops.rwkv6_scan(*live)[0].grad_fn is None
    assert ops.rwkv6_scan(*plain)[0].grad_fn is None
    assert ops.LAUNCHES == before


def test_rwkv6_scan_bwd_checks_shapes():
    _, (r, k, v, logw, u, s0), dout, dS = _scan_inputs(4, 1, 2, 5, 16, "float32")
    with pytest.raises(ValueError, match="dout"):
        ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, _t(dout)[:, :, :4])
    with pytest.raises(ValueError, match="dS_T"):
        ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, _t(dout), _t(dS)[:, :1])
    with pytest.raises(ValueError, match="differs"):
        ops.rwkv6_scan_bwd(r, k[:, :, :4], v, logw, u, s0, _t(dout))


# ---------------------------------------------------------------------------
# (4) step-0 gradients of loss_fn against jax.grad
# ---------------------------------------------------------------------------
def _smoke():
    return jax_get_smoke("rwkv6-3b"), get_smoke("rwkv6-3b")


def _batch(seq=32, seed=0):
    _, cfg = _smoke()
    return next(token_batches(cfg.vocab_size, 2, seq, seed=seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_step0_gradients_match_jax_grad(dtype):
    jcfg, cfg = _smoke()
    jp = jax_rwkv6.init_rwkv6(jax.random.PRNGKey(0), jcfg, dtype=DTYPES[dtype][0])
    b = _batch()
    jb = {key: jnp.asarray(val.numpy()) for key, val in b.items()}
    jloss, jg = jax.value_and_grad(lambda p: jax_rwkv6.loss_fn(p, jb, jcfg)[0])(jp)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = rwkv6.loss_fn(live, b, cfg)
    grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
    rel, floor = GRAD_TOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 5e-2)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in flatten(params)[0]]
    assert len(jleaves) == len(grads) == len(paths)
    for (_, want), got, path, p in zip(jleaves, grads, paths, adamw.tree_leaves(params)):
        assert got.dtype == p.dtype, path
        want = _np(want)
        bound = rel * np.abs(want).max() + floor
        assert np.abs(_np(got) - want).max() <= bound, path
        assert float(got.abs().max()) > 0, path          # every leaf is live


# ---------------------------------------------------------------------------
# (5) lm_train_step against the losses the reference's train_lm prints
# ---------------------------------------------------------------------------
def test_lm_train_step_losses_match_reference_train_lm():
    jcfg, cfg = _smoke()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jax_train.train_lm(jcfg, steps=TRAIN_STEPS, batch=2, seq=32, log_every=1)
    want = [float(x) for x in re.findall(r"loss (\S+)", printed.getvalue())]
    assert len(want) == TRAIN_STEPS
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    opt = adamw.adamw_init(params)
    it = token_batches(cfg.vocab_size, 2, 32, seed=0)
    losses, lrs = [], []
    for _ in range(TRAIN_STEPS):
        params, opt, m = lm_train_step(params, opt, next(it), cfg, total=TRAIN_STEPS)
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert all(v.grad_fn is None for v in m.values())
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL, atol=0)
    assert lrs[0] == 0.0 and lrs[20] == pytest.approx(3e-4, rel=1e-6)
    assert int(opt.step) == TRAIN_STEPS and params["embed"].grad_fn is None


# ---------------------------------------------------------------------------
# (6) the train CLI's checkpoint in the reference
# ---------------------------------------------------------------------------
def test_train_cli_lm_checkpoint_reads_in_reference_bit_for_bit(tmp_path, capsys):
    path = str(tmp_path / "lm.ckpt")
    params = train_cli.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--ckpt", path])
    out = capsys.readouterr().out
    assert len(re.findall(r"^step +\d+  loss ", out, re.M)) == 3
    assert f"saved {path}" in out
    jcfg, _ = _smoke()
    restored = jax_load_checkpoint(path, jax_rwkv6.init_rwkv6(jax.random.PRNGKey(0), jcfg))
    want = [p for _, p in flatten(params)[0]]
    got = jax.tree.leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        if w.dtype == torch.bfloat16:
            assert g.dtype.name == "bfloat16"
            np.testing.assert_array_equal(g.view(np.int16), w.view(torch.int16).numpy())
        else:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("case", ["cli", "train_lm"])
def test_train_lm_refuses_a_mesh(case):
    """The training meshes are ported (``tests/test_torch_train_mesh.py``);
    what is still refused: ``--mesh prod`` on a world that is not 256 ranks
    (``ValueError``, before any init), and a batch that does not divide over
    the mesh's batch axes.  RWKV-6 trains over a mesh data-parallel only: on
    ``make_local_mesh()`` (one rank) its params come out bit for bit as
    without a mesh.  (The name is kept from when every mesh raised.)"""
    cfg = _smoke()[1]
    if case == "cli":
        with pytest.raises(ValueError, match="world size 1"):
            train_cli.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                            "--steps", "1", "--mesh", "prod"])
        return
    from repro_torch.launch.mesh import TrainMesh, make_local_mesh
    with pytest.raises(ValueError, match="divide"):
        train_cli.train_lm(cfg, steps=1, batch=1, seq=4, device="cpu",
                           mesh=TrainMesh(rank=0, data=2, model=1))
    kw = dict(steps=2, batch=2, seq=8, log_every=100)
    got = train_cli.train_lm(cfg, mesh=make_local_mesh(device="cpu"), **kw)
    want = train_cli.train_lm(cfg, device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(adamw.tree_leaves(got),
                                                 adamw.tree_leaves(want)))


# ---------------------------------------------------------------------------
# (7) serving is untouched by the autograd wiring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_bit_identical_to_grad_disabled_calls(dtype):
    """Prefill and 4 decode steps with grad enabled, as serving calls them,
    equal the grad-disabled calls bit for bit and build no graph; with
    params that require grad the forward goes through ``RWKV6ScanFn`` and
    still gives the same bits."""
    jcfg, cfg = _smoke()
    jp = jax_rwkv6.init_rwkv6(jax.random.PRNGKey(0), jcfg, dtype=DTYPES[dtype][0])
    params = bridge.from_jax_params(jax.device_get(jp), device="cpu")
    tokens = _batch(seq=20, seed=3)["tokens"]

    def run(p):
        lg, st = rwkv6.prefill(p, tokens[:, :16], cfg)
        outs = [lg, st["S"]]
        for t in range(16, 20):
            lg, st = rwkv6.decode_step(p, tokens[:, t], st, cfg)
            outs += [lg, st["S"], st["tm_x"], st["cm_x"]]
        return outs

    with torch.no_grad():
        want = run(params)
    served = run(params)
    assert all(o.grad_fn is None for o in served)
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    traced = run(live)
    assert traced[0].grad_fn is not None
    for a, b, c in zip(served, traced, want):
        assert torch.equal(a, c) and torch.equal(b.detach(), c)
