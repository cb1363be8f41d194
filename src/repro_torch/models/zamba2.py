"""Zamba2 (arXiv:2411.15242), port of ``repro.models.zamba2``: a Mamba2
backbone with ONE shared (weight-tied) attention + MLP block applied every
``hybrid_attn_every`` blocks.

Mamba2 SSD per head h (scalar decay a_t, state (d_state, head_dim))::

    S_t = a_t S_{t-1} + dt_t B_t^T x_t        a_t = exp(-dt_t A_h)
    y_t = C_t S_t + D_h x_t

B_t, C_t shared across heads (ngroups = 1).  The reference runs the
recurrence a step at a time inside chunks of 128; :func:`_ssd_scan` runs the
same chunks in Mamba2's matrix form, a few batched products a chunk, in
plain PyTorch on either device.  Decode is the same scan at T = 1.

Layout: (k - 1) mamba blocks then the shared block, ``num_layers // k``
times, then ``num_layers % k`` trailing mamba blocks (zamba2-7b: 13
superblocks of 5 + 1 and 3 trailing).  The blocks run in a Python loop
over views of the stacked ``mamba`` leaves unbound once a call; the shared
block's attention is :func:`repro_torch.models.layers.attention`, the
hand-written flash kernel on the card.

Rounding points, found by holding each block against the reference's on
the CPU (``tests/test_torch_zamba2.py``):
  * the state's conv tail is bf16 whatever the params (the reference's
    ``init_state`` and ``_mamba_block``), so f32 streaming rounds it
    between calls; the attention KV cache is bf16 whatever the params and
    is read in q's dtype (``layers.attn_apply``, :func:`_attn_decode`);
  * the depthwise conv sums its K products in x's dtype, rounding each
    product and each partial sum, in the reference's order (its last tap
    first): in bf16 that matches the reference where a sum in f32 rounded
    once does not (``test_depthwise_conv_rounds_like_the_reference``);
  * a residual add followed by a norm reads the unrounded sum
    (``layers.add_rmsnorm``);
  * ``jax.nn.silu`` of bf16 runs as x * (1 / (1 + exp(-x))) with each op
    rounded to bf16 (XLA's expansion of the logistic): ``layers.silu`` does
    the same and matches it bit for bit, where ``F.silu`` (one rounding)
    gives another value for 39% of inputs and, over the smoke model's four
    mamba blocks, logits 0.13 apart (``test_silu_rounds_like_the_reference``).

``pos`` is a host int.  ``decode_step`` writes S, the conv tail, k and v
into the state's tensors in place; ``forward`` and ``prefill`` return new
ones.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.models import dense
from repro_torch.models import layers as L

SSM_HEAD = 64      # mamba2 head dim


def _dims(cfg) -> Tuple[int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    return inner, inner // SSM_HEAD


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_zamba2(cfg, *, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random params on ``generator.device`` in the layout of
    ``repro.models.zamba2.init_zamba2``: ``mamba`` stacked over the mamba
    blocks, one ``shared_attn`` block.  The draws differ from JAX's for the
    same seed; the reference's weights come over by
    :func:`repro_torch.bridge.from_jax_params`.
    ``generator`` None: the same tree of ``meta`` tensors."""
    g, dev = generator, L.init_device(generator)
    d, n = cfg.d_model, cfg.ssm_state
    inner, heads = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=dev)

    def one_block():
        return {
            "ln": L.rmsnorm_init(d, dev),
            "w_xz": L.dense_init(g, (d, 2 * inner), dtype=dtype),
            "conv": torch.randn((cfg.ssm_conv, inner), generator=g, **f32)
                         .mul_(0.1).to(dtype),
            "w_bcdt": L.dense_init(g, (inner, 2 * n + heads), dtype=dtype),
            "A_log": torch.zeros((heads,), **f32),          # A = exp(A_log)
            "D": torch.ones((heads,), **f32),
            "dt_bias": torch.full((heads,), -4.0, **f32),   # slow dynamics
            "w_out": L.dense_init(g, (inner, d), dtype=dtype),
        }

    return {
        "embed": L.dense_init(g, (cfg.vocab_size, d), scale=0.02, dtype=dtype),
        "mamba": L.stack_layers(one_block, num_mamba_blocks(cfg)),
        "shared_attn": {
            "ln1": L.rmsnorm_init(d, dev),
            "attn": L.attn_init(g, d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, dtype=dtype),
            "ln2": L.rmsnorm_init(d, dev),
            "mlp": L.mlp_init(g, d, cfg.d_ff, dtype=dtype),
        },
        "final_norm": L.rmsnorm_init(d, dev),
        "unembed": L.dense_init(g, (cfg.vocab_size, d),
                                scale=1.0 / math.sqrt(d), dtype=dtype),
    }


def num_mamba_blocks(cfg) -> int:
    """num_layers counts all blocks; every k-th is the shared attn block."""
    k = cfg.hybrid_attn_every
    return cfg.num_layers - (cfg.num_layers // k if k else 0)


def num_attn_blocks(cfg) -> int:
    return cfg.num_layers - num_mamba_blocks(cfg)


def _layout(cfg) -> Tuple[int, int, int, int]:
    """(superblocks, mamba blocks a superblock, mamba blocks in superblocks,
    trailing mamba blocks)."""
    k = cfg.hybrid_attn_every
    n_super = cfg.num_layers // k if k else 0
    per = (k - 1) if k else cfg.num_layers
    n_main = n_super * per
    return n_super, per, n_main, num_mamba_blocks(cfg) - n_main


def _blocks(cfg) -> List[Tuple[str, int]]:
    """The blocks in the order they run: ("mamba", i) for the i-th mamba
    block (its leaves and state), ("attn", s) for the shared block's s-th
    use (its KV cache); the main blocks, then the trailing ones."""
    n_super, per, n_main, rem = _layout(cfg)
    order: List[Tuple[str, int]] = []
    for s in range(n_super):
        order += [("mamba", s * per + j) for j in range(per)] + [("attn", s)]
    return order + [("mamba", n_main + j) for j in range(rem)]


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q): ``out[..., i, j] = sum_{j < k <= i} x_k``
    for j <= i, -inf above the diagonal (Mamba2's segsum).  Each entry sums
    its own terms: the difference of two cumulative sums, ``cs[i] -
    cs[j]``, of two large f32 numbers (-1,280 at dt 10 over 128 steps)
    would lose about 1e-4 in the exponent."""
    Q = x.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=x.device)
    seg = torch.where(ones.tril(-1), x[..., :, None], 0.0).cumsum(-2)
    return seg.masked_fill_(~ones.tril(), -math.inf)


def _ssd_scan(xh, bt, ct, dt, A, D, S0, *, chunk: int = 128):
    """Chunked SSD recurrence in Mamba2's matrix form, in f32.

    xh (B, T, H, P) per-head inputs; bt, ct (B, T, N); dt (B, T, H) post-
    softplus; A, D (H,); S0 (B, H, N, P).  Returns (y (B, T, H, P) f32,
    S_T).  T is padded to whole chunks with dt = 0 steps, which leave S
    unchanged, as the reference pads.  Inside chunk c, with ``L_h[i, j] =
    exp(sum_{j < k <= i} log a_k)`` and u = dt x::

        y = ((C B^T) o L_h) u + exp(cumsum log a) o (C S_c)

    and S_{c+1} = exp(sum log a) S_c + sum_j L_h[Q-1, j] B_j^T u_j, the
    states carried over the chunks by one product with the chunk-level
    segsum's decays."""
    B, T, H, P = xh.shape
    N = bt.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    f32 = torch.float32
    x, b, c, dt = (a.to(f32) for a in (xh, bt, ct, dt))
    if pad:
        x, b, c, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                       for a in (x, b, c, dt))
    loga = -dt * A                                          # (B, T', H) <= 0
    la = loga.reshape(B, nc, Q, H).permute(0, 1, 3, 2)      # (B, nc, H, Q)
    u = (x * dt[..., None]).reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4)
    b = b.reshape(B, nc, Q, N)
    c = c.reshape(B, nc, Q, N)

    decay = _segsum(la).exp_()                              # (B, nc, H, Q, Q)
    decay_out = decay[..., Q - 1, :].clone()                # j -> chunk end
    cb = (c @ b.transpose(-1, -2))[:, :, None]
    # in place for serving; autograd needs exp's output as it was
    grad = torch.is_grad_enabled() and decay.requires_grad
    y = ((decay * cb) if grad else decay.mul_(cb)) @ u
    del decay, cb
    states = b.transpose(-1, -2)[:, :, None] @ (decay_out[..., None] * u)
    cs = la.cumsum(-1)                                      # (B, nc, H, Q)
    # S entering each chunk: the chunk-level segsum's (B, H, nc+1, nc+1)
    # decays over [S0, the chunks' own states]
    chunk_decay = _segsum(F.pad(cs[..., -1].transpose(1, 2), (1, 0))).exp_()
    states = torch.cat([S0.to(f32)[:, None], states], 1)    # (B, nc+1, H, N, P)
    carried = chunk_decay @ states.permute(0, 2, 1, 3, 4).reshape(B, H, nc + 1, N * P)
    carried = carried.reshape(B, H, nc + 1, N, P)
    S_in = carried[:, :, :nc].permute(0, 2, 1, 3, 4)        # (B, nc, H, N, P)
    y += cs.exp()[..., None] * (c[:, :, None] @ S_in)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * Q, H, P)[:, :T]
    return y + D[:, None] * xh.to(f32), carried[:, :, nc].contiguous()


def _depthwise_conv(ctx: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """Causal depthwise conv of width K over ``ctx`` (B, K - 1 + T, inner):
    the reference's ``sum`` over taps, last tap first, in ctx's dtype."""
    K = w.shape[0]
    out = ctx[:, K - 1:K - 1 + T] * w[K - 1]
    for j in range(1, K):
        out = out + ctx[:, K - 1 - j:K - 1 - j + T] * w[K - 1 - j]
    return out


def _mamba_block(p, x: torch.Tensor, cfg, S0: torch.Tensor,
                 conv0: torch.Tensor):
    """x (B, T, d); S0 (B, H, N, P) f32; conv0 (B, ssm_conv - 1, inner) bf16.
    Returns (x + block(x), S_T, the conv tail in bf16)."""
    B, T, _ = x.shape
    inner, heads = _dims(cfg)
    n = cfg.ssm_state
    h = L.rmsnorm(p["ln"], x, eps=cfg.norm_eps)
    xi, z = (h @ p["w_xz"]).chunk(2, dim=-1)               # (B, T, inner)
    ctx = torch.cat([conv0.to(xi.dtype), xi], dim=1)
    xc = L.silu(_depthwise_conv(ctx, p["conv"], T))
    bt, ct, dt_raw = (xc @ p["w_bcdt"]).split([n, n, heads], dim=-1)
    dt32 = dt_raw.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dt32, torch.zeros_like(dt32))     # jax.nn.softplus
    y, S = _ssd_scan(xc.reshape(B, T, heads, SSM_HEAD), bt.to(torch.float32),
                     ct.to(torch.float32), dt, torch.exp(p["A_log"]), p["D"],
                     S0)
    y = y.reshape(B, T, inner).to(x.dtype) * L.silu(z)
    K = p["conv"].shape[0]
    return x + y @ p["w_out"], S, ctx[:, -(K - 1):].to(torch.bfloat16)


def _attn_block(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
                kv_cache=None, cache_pos=None, kv_valid_len=None,
                window: Optional[int] = None):
    """The shared block; with ``kv_cache`` its k and v are written into the
    cache in place (``layers.attn_apply``)."""
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    attn, _ = L.attn_apply(p["attn"], h, positions, cfg, kv_cache=kv_cache,
                           cache_pos=cache_pos, window=window,
                           kv_valid_len=kv_valid_len)
    x, h = L.add_rmsnorm(x, attn, p["ln2"], eps=cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, act=cfg.act)


def _attn_decode(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                 kc: torch.Tensor, vc: torch.Tensor, write_idx: int,
                 k_pos: torch.Tensor, pos: int, window: Optional[int]):
    """The shared block at one decode position: k and v written into the
    ring slot ``write_idx`` of (kc, vc) in place, attention over the ring
    (read in q's dtype) through the flash kernel."""
    B = x.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = p["attn"]
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    q = L.rope((h @ a["wq"]).reshape(B, 1, H, Dh), positions, theta=cfg.rope_theta)
    k = L.rope((h @ a["wk"]).reshape(B, 1, KVH, Dh), positions, theta=cfg.rope_theta)
    v = (h @ a["wv"]).reshape(B, 1, KVH, Dh)
    kc[:, write_idx] = k[:, 0].to(kc.dtype)
    vc[:, write_idx] = v[:, 0].to(vc.dtype)
    out = dense._decode_attention(q, kc.to(q.dtype), vc.to(q.dtype), k_pos=k_pos,
                                  q_pos=pos, window=window, softcap=None)
    x, h = L.add_rmsnorm(x, out.reshape(B, 1, H * Dh) @ a["wo"], p["ln2"],
                         eps=cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, act=cfg.act)


# ---------------------------------------------------------------------------
# states / entry points
# ---------------------------------------------------------------------------
def init_state(cfg, batch: int, *, attn_cache_len: int = 0,
               device=None) -> Dict[str, Any]:
    """Zero serving state: S f32 (mamba blocks, B, H, N, P), the conv tail
    bf16 (mamba blocks, B, ssm_conv - 1, inner), ``pos`` 0, and with
    ``attn_cache_len`` the shared block's bf16 KV cache (uses, B, slots,
    KVH, Dh)."""
    dev = resolve_device(device)
    inner, heads = _dims(cfg)
    nm, na = num_mamba_blocks(cfg), num_attn_blocks(cfg)
    st = {
        "S": torch.zeros((nm, batch, heads, cfg.ssm_state, SSM_HEAD),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((nm, batch, cfg.ssm_conv - 1, inner),
                            dtype=torch.bfloat16, device=dev),
        "pos": 0,
    }
    if attn_cache_len:
        shape = (na, batch, attn_cache_len, cfg.num_kv_heads, cfg.head_dim)
        st["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        st["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    return st


def _final_logits(params, x: torch.Tensor, cfg) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return x @ params["unembed"].T


def _superblock(x: torch.Tensor, blocks, S0s, c0s, shared, *,
                positions: torch.Tensor, cfg, window: Optional[int]):
    """(x, [S_T], [conv tail]) of one superblock: its mamba blocks, each
    from its state, then the shared attention block (none for the
    trailing blocks, ``shared`` None)."""
    Ss, cs = [], []
    for p, S0, c0 in zip(blocks, S0s, c0s):
        x, S, c = _mamba_block(p, x, cfg, S0, c0)
        Ss.append(S)
        cs.append(c)
    if shared is not None:
        x = _attn_block(shared, x, positions, cfg, window=window)
    return x, Ss, cs


def forward(params, tokens: torch.Tensor, cfg, *, state=None,
            attn_window: Optional[int] = None, remat: bool = True, **_):
    """Teacher-forced logits (B, T, V) and the state after them (S, conv,
    pos; no KV cache).  The shared block runs full causal self-attention
    over this call's tokens (windowed with ``attn_window``).  With
    ``remat`` and grad enabled each superblock (its mamba blocks and the
    shared block) is recomputed in the backward, as the reference
    checkpoints it; the trailing mamba blocks are not."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if state is None:
        state = init_state(cfg, B, device=x.device)
    pos0 = int(state["pos"])
    positions = dense._positions(B, T, x.device, pos0)
    mamba = L.unstack_layers(params["mamba"], num_mamba_blocks(cfg))
    n_super, per, n_main, rem = _layout(cfg)
    groups = [(range(s * per, (s + 1) * per), params["shared_attn"], remat)
              for s in range(n_super)] + [(range(n_main, n_main + rem), None, False)]
    S_out, c_out = [], []
    for idx, shared, rm in groups:
        run = partial(_superblock, positions=positions, cfg=cfg,
                      window=attn_window or None)
        x, Ss, cs = L.remat(run, x, [mamba[i] for i in idx],
                            [state["S"][i] for i in idx],
                            [state["conv"][i] for i in idx], shared, enabled=rm)
        S_out += Ss
        c_out += cs
    return _final_logits(params, x, cfg), {"S": torch.stack(S_out),
                                           "conv": torch.stack(c_out),
                                           "pos": pos0 + T}


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg, **kw)
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(params, tokens: torch.Tensor, cfg, *,
            cache_len: Optional[int] = None,
            attn_window: Optional[int] = None, **_):
    """Last-token logits (B, V) and the whole serving state: S and the conv
    tail of every mamba block, and the shared block's KV cache of
    ``cache_len`` slots (default T; the prompt in the first T)."""
    B, T = tokens.shape
    n = cache_len or T
    if n < T:
        raise ValueError(f"prefill: cache_len {n} is shorter than the prompt {T}")
    x = params["embed"][tokens.long()]
    st = init_state(cfg, B, attn_cache_len=n, device=x.device)
    positions = dense._positions(B, T, x.device)
    mamba = L.unstack_layers(params["mamba"], num_mamba_blocks(cfg))
    for kind, i in _blocks(cfg):
        if kind == "mamba":
            x, st["S"][i], st["conv"][i] = _mamba_block(mamba[i], x, cfg,
                                                        st["S"][i], st["conv"][i])
        else:
            x = _attn_block(params["shared_attn"], x, positions, cfg,
                            kv_cache=(st["k"][i], st["v"][i]), cache_pos=0,
                            kv_valid_len=T, window=attn_window or None)
    st["pos"] = T
    return _final_logits(params, x[:, -1:], cfg)[:, 0], st


def decode_step(params, token: torch.Tensor, state, cfg, *,
                attn_window: Optional[int] = None, **_):
    """O(1) decode: the SSD state updated at T = 1, the shared block against
    its ring-buffer KV cache (slot ``pos % slots``, masked by the slots'
    positions, ``dense.ring_k_pos``).  token (B,) -> (logits (B, V),
    state), the state's tensors written in place."""
    B = token.shape[0]
    x = params["embed"][token.long()[:, None]]
    pos = int(state["pos"])
    cache_len = state["k"].shape[2]
    positions = torch.full((B, 1), pos, device=x.device)
    k_pos = dense.ring_k_pos(pos, cache_len, x.device)
    mamba = L.unstack_layers(params["mamba"], num_mamba_blocks(cfg))
    for kind, i in _blocks(cfg):
        if kind == "mamba":
            x, S, c = _mamba_block(mamba[i], x, cfg, state["S"][i], state["conv"][i])
            state["S"][i] = S
            state["conv"][i] = c
        else:
            x = _attn_decode(params["shared_attn"], x, positions, cfg,
                             state["k"][i], state["v"][i], pos % cache_len,
                             k_pos, pos, attn_window or None)
    return _final_logits(params, x, cfg)[:, 0], dict(state, pos=pos + 1)
