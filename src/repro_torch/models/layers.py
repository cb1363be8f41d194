"""Shared layers of the port's models (port of ``repro.models.layers``):
init helpers, RMS norm, RoPE, grouped-query attention with the KV-cache
masks, the attention block, the gated MLP and the f32 cross-entropy; the
attention block and the MLP also under tensor parallelism
(:mod:`repro_torch.models.tp`), and the vocab-parallel cross-entropy.
Params are plain dicts of tensors in the JAX package's layout: a
projection weight is (in, out) and applies as ``x @ w``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import act_fn
from repro_torch.models.tp import _ModelReduce


def init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where an init puts its params: ``gen``'s device, or ``meta`` when
    ``gen`` is None (the abstract init: shapes and dtypes without storage,
    the counterpart of the reference's ``jax.eval_shape(init)``)."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: Optional[torch.Generator], shape, *,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal draw from ``gen`` on its device, times ``scale`` (default
    1/sqrt(fan_in), fan-in the second-to-last dim: leading dims stack
    experts or layers).  Drawn in f32, then cast.  ``gen`` None: an empty
    ``meta`` tensor of that shape and dtype."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def stack_layers(draw_layer, n: int):
    """Params of ``n`` layers stacked over a leading layer axis: each
    layer, drawn by ``draw_layer()``, is copied into the stacked tensors,
    so the peak is the stack plus one layer."""
    stack = None
    for i in range(n):
        layer = draw_layer()
        if stack is None:
            stack = _empty_stack(layer, n)
        _fill(stack, layer, i)
    return stack


def _empty_stack(layer, n: int):
    return {k: _empty_stack(v, n) if isinstance(v, dict)
            else v.new_empty((n, *v.shape)) for k, v in layer.items()}


def _fill(stack, layer, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stack[k], v, i)
        else:
            stack[k][i] = v


def unstack_layers(stack, n: int):
    """The first ``n`` layers of stacked params as one dict each, of views
    into the stacked leaves: one ``unbind`` a leaf, whose backward stacks
    the layers' gradients once.  (Indexing the stack per layer would give
    each layer's gradient a zero-filled copy of the whole stack, summed
    over the layers: at rwkv6-3b that is most of a training step.)"""
    cols = {k: unstack_layers(v, n) if isinstance(v, dict)
            else torch.unbind(v) for k, v in stack.items()}
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def remat(fn, *args, enabled: bool = True, save=None):
    """``fn(*args)``, its activations recomputed in the backward when grad
    is enabled (``torch.utils.checkpoint`` without reentry): the
    counterpart of the reference's ``jax.checkpoint`` around a layer.
    Otherwise, or with ``enabled`` False, a plain call.  ``fn`` must bind
    everything else it reads (``functools.partial``), since it runs again
    in the backward; the layers draw no random numbers, so no RNG state
    is kept.  ``save``: a policy of selective checkpointing
    (:data:`SAVE_DOTS`, :data:`SAVE_EXCHANGE`), whose saved op outputs the
    recompute reads instead of running the op again; None recomputes
    everything (the reference's policy None)."""
    if enabled and torch.is_grad_enabled():
        kw = {}
        if save is not None:
            from torch.utils.checkpoint import create_selective_checkpoint_contexts
            kw["context_fn"] = partial(create_selective_checkpoint_contexts, save)
        return torch.utils.checkpoint.checkpoint(_ranged, fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False, **kw)
    return fn(*args)


def _policy(saved):
    def policy(ctx, func, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        return (CheckpointPolicy.MUST_SAVE if func in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


# the reference's dots_with_no_batch_dims_saveable: the outputs of the 2-D
# weight products (a (..., d) @ (d, f) matmul is an aten mm); batched
# products, norms, attention, the expert kernel and elementwise ops are
# recomputed
SAVE_DOTS = _policy({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
# the MoE exchange's received buffers (EPMesh.all_to_all's functional
# collective): the recompute issues no all-to-all, as the reference's
# "ep_recv" name keeps its dispatch buffer
SAVE_EXCHANGE = _policy({torch.ops._c10d_functional.all_to_all_single.default})


def _ranged(fn, *args):
    # a profiler range around each run of a recomputed layer, the forward's
    # and the backward's: launch/profile_train.py tells the recompute by it
    with torch.profiler.record_function("layers.remat"):
        return fn(*args)


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a zero-initialised scale applied as ``1 + scale``."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, params, *,
                eps: float = 1e-6):
    """(x + y, rmsnorm(x + y)), both in x's dtype: the reference's residual
    add followed by a norm, ``x = x + y; h = rmsnorm(p, x)``, as XLA runs
    it.  XLA fuses the add into the norm's f32 convert and drops the add's
    bf16 rounding there, so the norm reads the unrounded f32 sum (in bf16,
    norming the rounded sum gives another value for about 22% of the
    elements; PR 12 found the same in RWKV-6)."""
    s = x.to(torch.float32) + y.to(torch.float32)
    return s.to(x.dtype), rmsnorm(params, s, eps=eps).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved).
    x: (..., S, H, Dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              kv_valid_len=None,
              k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, Dh), k/v (B, Sk, KVH, Dh): the
    JAX package's ``layers.attention``.

    On CUDA tensors this is the hand-written flash kernel; on the CPU its
    plain version.  Query i sits at position ``q_offset + i``; key j is
    visible to it iff ``pq - pk < window`` (one-sided, whether causal or
    not) and, when ``causal``, ``pq >= pk``.  ``kv_valid_len`` (an int or a
    0-d integer tensor) masks the keys at and past it, a partly filled KV
    cache.  ``k_pos`` (int32 (Sk,); negative for an empty slot) gives the
    keys' positions instead of their indices: the ring-buffer cache of
    decode.  The flash kernel's online softmax over key tiles is the
    counterpart of the reference's ``_blocked_attention`` (the path it
    takes when Sq * Sk > 2^22): neither materialises Sq x Sk scores."""
    if kv_valid_len is not None:
        if k_pos is not None:
            raise ValueError("attention: give kv_valid_len or k_pos, not both")
        idx = torch.arange(k.shape[1], device=k.device, dtype=torch.int32)
        k_pos = torch.where(idx < kv_valid_len, idx, torch.full_like(idx, -1))
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               k_pos=k_pos, one_sided_window=True)


def attn_init(gen: torch.Generator, d_model: int, num_heads: int,
              num_kv_heads: int, head_dim: int, *, qk_norm: bool = False,
              dtype: torch.dtype = torch.bfloat16):
    """Attention params in the reference's tree: wq (d, H Dh), wk and wv
    (d, KVH Dh), wo (H Dh, d), and with ``qk_norm`` the per-head RMS norms
    ``q_norm`` / ``k_norm``.  Drawn from ``gen`` (other numbers than the
    reference's for the same seed)."""
    p = {
        "wq": dense_init(gen, (d_model, num_heads * head_dim), dtype=dtype),
        "wk": dense_init(gen, (d_model, num_kv_heads * head_dim), dtype=dtype),
        "wv": dense_init(gen, (d_model, num_kv_heads * head_dim), dtype=dtype),
        "wo": dense_init(gen, (num_heads * head_dim, d_model), dtype=dtype),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, init_device(gen))
        p["k_norm"] = rmsnorm_init(head_dim, init_device(gen))
    return p


def attn_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
               kv_cache=None, cache_pos: Optional[int] = None,
               window: Optional[int] = None, kv_valid_len=None,
               causal: bool = True, tp=None, cut=None):
    """Self-attention block: projections, qk-norm, RoPE on q and k,
    attention, output projection.  Returns (out, (k, v)): this call's k and
    v (post-RoPE), or with ``kv_cache`` = (ck, cv) (B, Sc, KVH, Dh) the
    cache with them written at ``cache_pos`` (a host int), in place; the
    queries then sit at ``cache_pos`` on and attend over the whole cache,
    ``kv_valid_len`` masking its unwritten tail.

    ``tp`` (a :class:`~repro_torch.models.tp.TP`; ``p`` the rank's leaves,
    ``cut`` their cut dims): the block under tensor parallelism, without a
    cache (:func:`_attn_tp`); returns (out in the residual stream's layout,
    None)."""
    if tp is not None:
        if kv_cache is not None or kv_valid_len is not None:
            raise ValueError("attn_apply: tensor parallelism trains; it takes "
                             "no KV cache")
        return _attn_tp(p, cut, x, positions, cfg, window=window,
                        causal=causal, tp=tp), None
    B, S, _ = x.shape
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, KVH, Dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, Dh)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    q_off, new_kv = 0, (k, v)
    if kv_cache is not None:
        ck, cv = kv_cache
        if not 0 <= cache_pos <= ck.shape[1] - S:
            raise ValueError(f"attn_apply: {S} rows at cache_pos {cache_pos} "
                             f"do not fit a cache of {ck.shape[1]}")
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        # the reference's attention upcasts q, k and v to f32: a cache kept
        # in another dtype than q (zamba2's bf16 cache under f32 params) is
        # read in q's dtype, since the flash kernel takes one dtype
        k, v, q_off, new_kv = ck.to(q.dtype), cv.to(q.dtype), cache_pos, (ck, cv)
    out = attention(q, k, v, causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap, q_offset=q_off,
                    kv_valid_len=kv_valid_len)
    return out.reshape(B, S, H * Dh) @ p["wo"], new_kv


def _kv_for_heads(t: torch.Tensor, heads) -> torch.Tensor:
    """The kv heads (dim 2 of (B, S, KVH, Dh)) that query heads read, one
    per entry of ``heads``, as few as GQA allows: a run of kv heads each
    read by the same number of consecutive query heads is narrowed to that
    run (the flash kernel's GQA), anything else taken one per query head."""
    run = sorted(set(heads))
    g = len(heads) // len(run)
    if run == list(range(run[0], run[0] + len(run))) \
            and heads == [h for h in run for _ in range(g)]:
        return t.narrow(2, run[0], len(run))
    return t.index_select(2, torch.tensor(heads, device=t.device))


def _attn_tp(p, cut, x: torch.Tensor, positions: torch.Tensor, cfg, *,
             window: Optional[int], causal: bool, tp) -> torch.Tensor:
    """The attention block on this rank of a tensor-parallel step, in the
    layout :meth:`TP.attn_layout` picks (the reference's ``attn_shard``):

    * ``"heads"``: the rank's H / model query heads from its columns of
      ``wq`` (its own slice where the spec cuts ``wq`` on its heads, else a
      slice of ``wq`` gathered on use); k and v its KVH / model kv heads
      where those divide, else every kv head computed and the ones its
      query heads read kept (two ranks may share one; their dK and dV sum
      over ``model`` in the backward); ``wo``'s rows of those heads; the
      output is a partial sum, all-reduced (reduce-scattered under
      ``seq_shard``);
    * ``"seq"``: the rank's S / model query rows, at ``q_offset`` = their
      first position, against every key; ``wq``, ``wk``, ``wv`` and ``wo``
      gathered on use; the output is the rank's rows, gathered unless
      ``seq_shard`` keeps them;
    * ``"all"``: every head on every rank, the output's columns cut for
      ``wo``'s rows, a partial sum as ``"heads"``.

    ``x`` is the residual stream's normed rows (B, S or S / model, d);
    ``positions`` (B, S) every row's."""
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    S = x.shape[1] * (tp.n if tp.seq else 1)
    layout = tp.attn_layout(H, S)
    xf = tp.enter(x)
    full = partial(tp.use, local=True)

    def project(w, rows, first, width):
        # rows (B, s, d) times columns [first, first + width) of w (d, .)
        return rows @ tp.part(p[w], cut[w], 1, first, width)

    def normed(name, t):
        if name not in p:
            return t
        return rmsnorm({"scale": full(p[name]["scale"], cut[name]["scale"])}, t)

    if layout == "seq":
        rows = S // tp.n
        off = tp.seq_offset(S)
        xq = x if tp.seq else xf.narrow(1, tp.r * rows, rows)
        q = (xq @ full(p["wq"], cut["wq"])).reshape(B, rows, H, Dh)
        k = (xf @ full(p["wk"], cut["wk"])).reshape(B, S, KVH, Dh)
        v = (xf @ full(p["wv"], cut["wv"])).reshape(B, S, KVH, Dh)
        q, k = normed("q_norm", q), normed("k_norm", k)
        q = rope(q, positions.narrow(1, tp.r * rows, rows), theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
        out = attention(q, k, v, causal=causal, window=window,
                        softcap=cfg.attn_logit_softcap, q_offset=off)
        y = out.reshape(B, rows, H * Dh) @ full(p["wo"], cut["wo"])
        return tp.exit_rows(y)

    if layout == "heads":
        hl = H // tp.n
        first = tp.r * hl
        q = project("wq", xf, first * Dh, hl * Dh).reshape(B, S, hl, Dh)
        if KVH % tp.n == 0:
            kl = KVH // tp.n
            k = project("wk", xf, tp.r * kl * Dh, kl * Dh).reshape(B, S, kl, Dh)
            v = project("wv", xf, tp.r * kl * Dh, kl * Dh).reshape(B, S, kl, Dh)
        else:
            heads = tp.kv_heads_for(first, hl, H // KVH)
            k = _kv_for_heads((xf @ full(p["wk"], cut["wk"])).reshape(B, S, KVH, Dh), heads)
            v = _kv_for_heads((xf @ full(p["wv"], cut["wv"])).reshape(B, S, KVH, Dh), heads)
        cols = (first * Dh, hl * Dh)
    else:
        q = (xf @ full(p["wq"], cut["wq"])).reshape(B, S, H, Dh)
        k = (xf @ full(p["wk"], cut["wk"])).reshape(B, S, KVH, Dh)
        v = (xf @ full(p["wv"], cut["wv"])).reshape(B, S, KVH, Dh)
        if (H * Dh) % tp.n:
            raise ValueError(f"tensor parallelism: {H} x {Dh} attention "
                             f"columns do not divide over {tp.n} 'model' ranks")
        w = H * Dh // tp.n
        cols = (tp.r * w, w)
    q, k = normed("q_norm", q), normed("k_norm", k)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    out = attention(q, k, v, causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, S, -1)
    if layout == "all":
        out = out.narrow(2, *cols)
    return tp.exit_partial(out @ tp.part(p["wo"], cut["wo"], 0, *cols))


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of logits cut over ``model`` by
    vocabulary (B, S, V / model: this rank's ``V / model`` consecutive
    entries), in f32: the max, the sum of exponentials and the gold logit
    are reduced over ``model``, so every rank returns the same mean (a
    softcap is applied to the logits before)."""
    lg = logits.to(torch.float32)
    V = lg.shape[-1]
    m = mesh.model_max(lg.detach().amax(dim=-1))
    se = _ModelReduce.apply(torch.exp(lg - m[..., None]).sum(dim=-1), mesh)
    lse = m + torch.log(se)
    t = labels.long() - mesh.rank_in("model") * V
    mine = (t >= 0) & (t < V)
    gold = torch.gather(lg, -1, t.clamp(0, V - 1)[..., None])[..., 0]
    gold = _ModelReduce.apply(torch.where(mine, gold, torch.zeros_like(gold)), mesh)
    return (lse - gold).mean()


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             dtype: torch.dtype = torch.bfloat16):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype.  In bf16 that is the reference's value bit for
    bit, where ``F.silu`` (one rounding) gives another for about 39% of
    inputs: over the encoder-decoder's and Zamba2's stacked blocks the
    difference reaches the 5e-2 bf16 tolerance."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def mlp_apply(p, x: torch.Tensor, *, act: str = "silu", tp=None,
              cut=None) -> torch.Tensor:
    """Gated MLP ``(act(x Wg) * (x Wu)) Wd``, plain matrix products (the
    JAX package leaves them to XLA); silu rounds as :func:`silu`, gelu is
    the tanh form.

    ``tp`` (``p`` the rank's leaves, ``cut`` their cut dims): each rank
    computes the hidden columns of its ``d_ff / model`` slice (its own
    ``w_gate`` / ``w_up`` columns and ``w_down`` rows where the spec cuts
    them there, else slices of the leaves gathered on use), a partial sum
    that leaves the block all-reduced (reduce-scattered under
    ``seq_shard``)."""
    fn = silu if act == "silu" else act_fn(act)
    if tp is None:
        h = fn(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    f = tp.full_dim(p["w_gate"], cut["w_gate"], 1)
    if f % tp.n:
        raise ValueError(f"tensor parallelism: d_ff {f} does not divide over "
                         f"{tp.n} 'model' ranks")
    cols = (tp.r * (f // tp.n), f // tp.n)
    xf = tp.enter(x)
    h = fn(xf @ tp.part(p["w_gate"], cut["w_gate"], 1, *cols)) \
        * (xf @ tp.part(p["w_up"], cut["w_up"], 1, *cols))
    return tp.exit_partial(h @ tp.part(p["w_down"], cut["w_down"], 0, *cols))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Mean token cross-entropy, computed in f32; ``softcap`` caps the
    logits as ``c * tanh(logits / c)`` first."""
    logits = logits.to(torch.float32)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
