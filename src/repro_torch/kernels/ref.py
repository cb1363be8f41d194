"""Plain PyTorch versions of the CUDA kernels.

They compute the same functions as the kernels under ``csrc/`` and as the
JAX package's oracles in ``repro.kernels.ref`` / ``repro.compress.ref``.
The kernel wrappers in :mod:`repro_torch.kernels.ops` run them for tensors
on the CPU; on the card they are what each kernel is held against.

The three backward versions (``expert_ffn_bwd_ref``,
``flash_attention_bwd_ref``, ``rwkv6_scan_bwd_ref``) write the gradients'
formulas out; they do not call autograd on the forward.  The JAX package
has no backward kernel (it trains through XLA's autodiff of
``repro.kernels.ref`` and of RWKV-6's jnp scan), so ``jax.vjp`` of its
oracles is what the tests hold them against.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.compress.ref import INT8_EPS, int8_decode, int8_encode

NEG_INF = -1e30


def act_fn(act: str):
    """silu, or gelu with the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if act == "silu":
        return F.silu
    if act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def act_grad(act: str, g: torch.Tensor) -> torch.Tensor:
    """d act(g) / dg for :func:`act_fn`'s activations."""
    if act == "silu":
        s = torch.sigmoid(g)
        return s * (1.0 + g * (1.0 - s))
    if act == "gelu":
        k = math.sqrt(2.0 / math.pi)
        th = torch.tanh(k * (g + 0.044715 * g * g * g))
        return 0.5 * (1.0 + th) \
            + 0.5 * g * (1.0 - th * th) * k * (1.0 + 3 * 0.044715 * g * g)
    raise ValueError(f"unknown activation {act!r}")


def expert_ffn_ref(buf, w_gate, w_up, w_down, *, act: str = "silu"):
    """Grouped gated MLP over per-expert token buffers, f32 accumulate.

    buf: (E, C, d); w_gate/w_up: (E, d, f); w_down: (E, f, d) -> (E, C, d).
    """
    x = buf.to(torch.float32)
    g = act_fn(act)(torch.matmul(x, w_gate.to(torch.float32)))
    u = torch.matmul(x, w_up.to(torch.float32))
    out = torch.matmul(g * u, w_down.to(torch.float32))
    return out.to(buf.dtype)


def expert_ffn_bwd_ref(buf, w_gate, w_up, w_down, dy, *, act: str = "silu"):
    """Gradients of :func:`expert_ffn_ref` for the output gradient ``dy``
    (E, C, d), in f32: with ``G = X Wg``, ``U = X Wu``,
    ``H = act(G) U`` and ``Y = H Wd``::

        dH = dY Wd^T,  dG = dH U act'(G),  dU = dH act(G)
        dWd = H^T dY,  dX = dG Wg^T + dU Wu^T,  dWg = X^T dG,  dWu = X^T dU

    Returns (dX, dWg, dWu, dWd), each in its input's dtype."""
    x = buf.to(torch.float32)
    wg, wu, wd = (w.to(torch.float32) for w in (w_gate, w_up, w_down))
    dy = dy.to(torch.float32)
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wu)
    a = act_fn(act)(g)
    h = a * u
    dh = torch.matmul(dy, wd.transpose(1, 2))
    dg = dh * u * act_grad(act, g)
    du = dh * a
    dwd = torch.matmul(h.transpose(1, 2), dy)
    dx = torch.matmul(torch.cat([dg, du], -1),
                      torch.cat([wg, wu], -1).transpose(1, 2))
    xt = x.transpose(1, 2)
    dwg = torch.matmul(xt, dg)
    dwu = torch.matmul(xt, du)
    return (dx.to(buf.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


def attention_mask(Sq: int, Sk: int, *, causal: bool, window,
                   device, q_offset: int = 0, k_pos=None,
                   one_sided: bool = False) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i.  Query i sits at position
    ``q_offset + i``; key j at ``k_pos[j]`` (an int (Sk,) tensor, negative
    for an empty slot), else at j.  A window keeps ``pq - pk < window``
    and, when the attention is not causal and not ``one_sided``, also
    ``pk - pq < window`` (the Pallas kernel's symmetric window)."""
    pq = q_offset + torch.arange(Sq, device=device)[:, None]
    pk = (torch.arange(Sk, device=device) if k_pos is None
          else k_pos.to(device=device, dtype=torch.int64))[None, :]
    mask = (pk >= 0).expand(Sq, Sk).clone()
    if causal:
        mask &= pq >= pk
    if window is not None:
        mask &= (pq - pk) < window
        if not causal and not one_sided:
            mask &= (pk - pq) < window
    return mask


def _chunk_rows(B: int, H: int, Sq: int, Sk: int, rows) -> int:
    """Query rows a chunk of the plain attention: ``rows``, or as many as
    keep one (B, H, rows, Sk) f32 score tensor within 2^28 elements (1
    GiB), so the plain versions hold the seamless encoder's (8, 4096, 16
    heads) on the card without 4 x 8.6 GB of scores."""
    if rows is not None:
        return max(1, rows)
    return max(1, min(Sq, (1 << 28) // max(1, B * H * Sk)))


def _logits(q, k32, *, causal: bool, window=None, softcap=None,
            q_offset: int = 0, k_pos=None, one_sided: bool = False):
    """((B, KVH, G, Sq, Sk) f32 scaled logits ``q k^T / sqrt(Dh)``,
    softcapped and masked at -1e30 by :func:`attention_mask`; that mask)."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k32.shape[1], k32.shape[2]
    qg = q.to(torch.float32).reshape(B, Sq, KVH, H // KVH, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k32) / math.sqrt(Dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device, q_offset=q_offset, k_pos=k_pos,
                          one_sided=one_sided)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_ref(q, k, v, *, causal: bool = False, window=None,
                        softcap=None, q_offset: int = 0, k_pos=None,
                        one_sided_window: bool = False, stats: bool = False,
                        rows=None):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KVH, Dh) -> (B, Sq, H, Dh).

    GQA maps query head h to kv head ``h // (H // KVH)``.  Masked logits are
    -1e30, not -inf, so a fully masked row gives the mean of V.  The mask
    is :func:`attention_mask`'s.  With ``stats`` it returns (the output
    unrounded in f32, the (B, H, Sq) f32 row log-sum-exp of the masked
    logits): what the flash kernel keeps for the backward.  The queries
    run in chunks of ``rows`` (None: :func:`_chunk_rows`), each at its own
    ``q_offset``."""
    B, Sq, H, Dh = q.shape
    n = _chunk_rows(B, H, Sq, k.shape[1], rows)
    if n < Sq:
        parts = [flash_attention_ref(
            q[:, a:a + n], k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset + a, k_pos=k_pos, one_sided_window=one_sided_window,
            stats=stats, rows=n) for a in range(0, Sq, n)]
        if stats:
            return (torch.cat([o for o, _ in parts], 1),
                    torch.cat([lse for _, lse in parts], 2))
        return torch.cat(parts, 1)
    s, _ = _logits(q, k.to(torch.float32), causal=causal, window=window,
                   softcap=softcap, q_offset=q_offset, k_pos=k_pos,
                   one_sided=one_sided_window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    out = out.reshape(B, Sq, H, Dh)
    if stats:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out.to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = False):
    """(B, H, Sq) f32 row log-sum-exp of :func:`flash_attention_ref`'s
    logits (it does not depend on v)."""
    return flash_attention_ref(q, k, k, causal=causal, stats=True)[1]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = False,
                            window=None, softcap=None, q_offset: int = 0,
                            rows=None, magnitudes: bool = False):
    """Gradients of GQA attention (causal or not, Sq and Sk free, a
    one-sided ``window`` and a logit ``softcap`` or not) in the recompute
    form of the backward kernel: with ``scale = 1/sqrt(Dh)``, the logits
    ``S = c tanh(q k^T scale / c)`` under a softcap c (else ``q k^T
    scale``), ``P = exp(S - lse)`` (0 where :func:`attention_mask` drops a
    key: causal, and the window as ``layers.attention`` applies it, ``pq -
    pk < window``, query row i at ``pq = q_offset + i``) and ``D =
    rowsum(dO * O)``::

        dV = P^T dO,  dS = P (dO V^T - D) (1 - (S / c)^2),
        dQ = dS K scale,  dK = dS^T Q scale

    (the factor ``1 - (S / c)^2`` is the cap's derivative; 1 without one).
    q, o, do (B, Sq, H, Dh); k, v (B, Sk, KVH, Dh), query head h reading
    kv head ``h // (H // KVH)``; lse (B, H, Sq), the capped logits'.  ``o``
    is the forward's unrounded f32 output: the reference's softmax backward
    sums ``P dP``, which is dO . O before O is rounded to the inputs' dtype
    (with a bf16 O, 19% of bf16 dq and dk elements land elsewhere).
    Everything runs in f32 over query chunks (:func:`_chunk_rows`); dK and
    dV are summed over a kv head's G query heads and over the chunks in
    f32.  Returns (dq, dk, dv) in the inputs' dtype, each rounded once.

    With ``magnitudes`` the same sums run over the magnitudes of every
    operand (|Q|, |K|, |V|, |O|, |dO|; dS as ``P (|dO| |V|^T + rowsum(|dO|
    |O|)) (1 - (S / c)^2)``) and come back in f32: what each gradient
    element's f32 roundoff scales with where its terms cancel (a causal
    first query's dq is 0, and dP - D there is dO . V - dO . V)."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    f32 = torch.float32
    scale = 1.0 / math.sqrt(Dh)
    k32, v32 = k.to(f32), v.to(f32)
    kt, vt = (k32.abs(), v32.abs()) if magnitudes else (k32, v32)
    dq = torch.empty((B, Sq, H, Dh), dtype=f32, device=q.device)
    dk = torch.zeros((B, Sk, KVH, Dh), dtype=f32, device=q.device)
    dv = torch.zeros((B, Sk, KVH, Dh), dtype=f32, device=q.device)
    n = _chunk_rows(B, H, Sq, Sk, rows)
    for a in range(0, Sq, n):
        m = min(n, Sq - a)
        s, mask = _logits(q[:, a:a + m], k32, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset + a, one_sided=True)
        ls = lse[:, :, a:a + m].to(f32).reshape(B, KVH, G, m)
        p = torch.where(mask, torch.exp(s - ls[..., None]), 0.0)
        qc, doc, oc = (t[:, a:a + m].to(f32).reshape(B, m, KVH, G, Dh)
                       for t in (q, do, o))
        if magnitudes:
            qc, doc, oc = qc.abs(), doc.abs(), oc.abs()
        dd = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vt)
        ds = p * (dp + dd) if magnitudes else p * (dp - dd)
        if softcap is not None:
            ds = ds * (1.0 - torch.square(torch.where(mask, s, 0.0) / softcap))
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
        dq[:, a:a + m] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kt)
                          * scale).reshape(B, m, H, Dh)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc) * scale
    if magnitudes:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def residual_int8_ref(value, base, *, eps: float = INT8_EPS):
    """Fused wire-codec quantize-pack: (N, d) payload + residual base ->
    (q int8 (N, d), scale f32 (N, 1), recon (N, d) value.dtype) with
    ``recon = base + q * scale``; the quantizer is
    :func:`repro_torch.compress.ref.int8_encode`."""
    b = base.to(torch.float32)
    q, scale = int8_encode(value.to(torch.float32) - b, eps=eps)
    recon = (b + int8_decode(q, scale)).to(value.dtype)
    return q, scale, recon


def rwkv6_scan_ref(r, k, v, logw, u, s0):
    """The RWKV-6 recurrence, a Python loop over T in f32.

    r, k, v, logw: (B, H, T, DK) (any strides); u: (H, DK);
    s0: (B, H, DK, DK).  Per step::

        out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(exp(logw_t)) S_{t-1} + k_t^T v_t

    Returns (out (B, H, T, DK) f32, S_T (B, H, DK, DK) f32)."""
    S = s0.to(torch.float32)
    u32 = u.to(torch.float32)[None, :, :, None]
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt = (a[:, :, t].to(torch.float32) for a in (r, k, v))
        w = torch.exp(logw[:, :, t].to(torch.float32))
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S + u32 * kv))
        S = w[..., :, None] * S + kv
    return torch.stack(outs, dim=2), S


def rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dout, dS_T=None):
    """Gradients of :func:`rwkv6_scan_ref` for the output gradient ``dout``
    (B, H, T, DK) and the final state's ``dS_T`` (B, H, DK, DK; None means
    zeros, as in training, where the loss never reads the state).

    A forward loop keeps every state ``S_{t-1}`` before step t, then a
    reverse loop carries the state's gradient ``dS_t`` (the gradient of
    the state after step t) from ``dS_T``, all in f32::

        dr_t    = S_{t-1} dout_t + u k_t (v_t . dout_t)
        dk_t    = dS_t v_t       + u r_t (v_t . dout_t)
        dv_t    = k_t dS_t       + dout_t sum_i u_i r_t,i k_t,i
        dlogw_t = w_t sum_v dS_t S_{t-1}
        du      = sum_b,t r_t k_t (v_t . dout_t)
        dS_{t-1} = diag(w_t) dS_t + r_t^T dout_t,   ds0 = dS_0

    Returns (dr, dk, dv, dlogw, du, ds0): dr/dk/dv in r's dtype, du in u's,
    dlogw and ds0 in f32, each rounded once from f32 (the cotangents of the
    reference's ``.astype(f32)`` of its inputs)."""
    f32 = torch.float32
    B, H, T, DK = r.shape
    u32 = u.to(f32)[None]                                   # (1, H, DK)
    states, S = [], s0.to(f32)
    for t in range(T):
        states.append(S)
        w = torch.exp(logw[:, :, t].to(f32))
        S = w[..., :, None] * S + k[:, :, t].to(f32)[..., :, None] \
            * v[:, :, t].to(f32)[..., None, :]
    dS = (torch.zeros_like(S) if dS_T is None else dS_T.to(f32))
    dr, dk, dv, dlogw = ([None] * T for _ in range(4))
    du = torch.zeros((B, H, DK), dtype=f32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, dot = (a[:, :, t].to(f32) for a in (r, k, v, dout))
        w = torch.exp(logw[:, :, t].to(f32))
        vd = (vt * dot).sum(-1, keepdim=True)
        dr[t] = torch.einsum("bhkv,bhv->bhk", states[t], dot) + u32 * kt * vd
        dk[t] = torch.einsum("bhkv,bhv->bhk", dS, vt) + u32 * rt * vd
        dv[t] = torch.einsum("bhk,bhkv->bhv", kt, dS) \
            + dot * (u32 * rt * kt).sum(-1, keepdim=True)
        dlogw[t] = w * (dS * states[t]).sum(-1)
        du = du + rt * kt * vd
        dS = w[..., :, None] * dS + rt[..., :, None] * dot[..., None, :]
    return (torch.stack(dr, 2).to(r.dtype), torch.stack(dk, 2).to(k.dtype),
            torch.stack(dv, 2).to(v.dtype), torch.stack(dlogw, 2),
            du.sum(0).to(u.dtype), dS)
