"""Decoder-only transformer LM for the dense and MoE families, port of
``repro.models.dense``.

One implementation, config-driven variants:
  * GQA with RoPE; qk-norm (qwen3); attention-logit softcap, sandwich
    norms, embedding scale and final-logit softcap (gemma2); alternating
    local/global sliding windows (gemma2); gated MLP (silu or gelu).
  * MoE FFN (qwen3-moe, dbrx) through :func:`repro_torch.core.moe.moe_forward`:
    the hand-written ``expert_ffn`` kernel on the card, its load-balance
    loss summed over the layers; on one device, or expert-parallel over the
    ``model`` axis of a training mesh (:func:`_moe_block`).

Attention always goes through :func:`repro_torch.models.layers.attention`,
the hand-written flash kernel on the card (its plain version on the CPU):
causal, windowed, soft-capped GQA in prefill and the teacher-forced
forward, and one query against the ring-buffer KV cache in decode, masked
by the slots' absolute positions (``k_pos``).

Params are a plain dict in the JAX package's layout: ``layers`` holds one
tensor per leaf stacked over a leading layer axis; the layers run in a
Python loop where the JAX package scans, over views unbound once a call
(:func:`~repro_torch.models.layers.unstack_layers`).  In training each
layer is recomputed in the backward (``remat``, the reference's
``jax.checkpoint``; a MoE layer routes its tokens again from the same
inputs, so the recompute rebuilds the same dispatch plan).  Attention's
gradients come from the flash backward kernel (causal, GQA, bf16, gemma2's
one-sided windows on its local layers and its logit softcap, head_dim up
to 256), the experts' from the ``expert_ffn_bwd`` kernel (f32 or bf16),
and the router's through the top-k scores that weight the combine and
through the load-balance loss's probabilities.  The KV cache's
``pos`` is a host int, so no step reads a device scalar back; decode writes
its k and v into the cache tensors in place.

``mesh`` (a :class:`~repro_torch.launch.mesh.TrainMesh` with a ``model``
axis) and ``batch_axes`` reach the MoE block, the only place the
reference's mesh changes a number: each rank holds its batch rows (its
``batch_axes`` shard) and its ``E / model`` experts, and the block runs
expert-parallel over the ``model`` group (:func:`_moe_block`).  A mesh
without a ``model`` axis runs the one-device path, as in the reference.
``seq_shard`` and ``attn_shard`` are layout hints that only the reference's
dry run passes; they need the dense weights placed over ``model`` (ROADMAP.md
A) and raise.  ``remat_policy`` (``"full"``, ``"dots"``, ``"save_ffn"``:
:func:`check_remat_policy`) chooses what the backward recomputes.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import moe as moe_lib
from repro_torch.models import layers as L


def _refuse_mesh(seq_shard: bool = False, attn_shard=None) -> None:
    if seq_shard or attn_shard:
        raise NotImplementedError(
            "models.dense: seq_shard and attn_shard are layout hints of the "
            "reference's dry run (sequence-sharded residuals, head-sharded "
            "attention); they need the dense weights placed over 'model', "
            "not ported yet (ROADMAP.md A, the next bring-up slice)")


# ---------------------------------------------------------------------------
# per-layer window pattern
# ---------------------------------------------------------------------------
def layer_windows(cfg, *, long_context: bool = False) -> List[Optional[int]]:
    """Attention window per layer, None for unlimited (the reference's 0)."""
    w = [0] * cfg.num_layers
    if cfg.local_global_pattern and cfg.sliding_window:
        w[0::2] = [cfg.sliding_window] * len(w[0::2])   # gemma2: even layers local
    if long_context and cfg.long_context_window:
        w = [x or cfg.long_context_window for x in w]   # cap global layers
    return [x or None for x in w]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_lm(cfg, *, generator: Optional[torch.Generator] = None,
            dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random params on ``generator.device`` in the layout of
    ``repro.models.dense.init_lm`` (other numbers than the reference's for
    the same seed; its weights come over by
    :func:`repro_torch.bridge.from_jax_params`).  ``generator`` None: the
    same tree of ``meta`` tensors (:func:`layers.init_device`)."""
    g, dev = generator, L.init_device(generator)

    def one_layer():
        p = {
            "ln1": L.rmsnorm_init(cfg.d_model, dev),
            "ln2": L.rmsnorm_init(cfg.d_model, dev),
            "attn": L.attn_init(g, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, qk_norm=cfg.qk_norm, dtype=dtype),
        }
        if cfg.post_norm:
            p["ln1_post"] = L.rmsnorm_init(cfg.d_model, dev)
            p["ln2_post"] = L.rmsnorm_init(cfg.d_model, dev)
        if cfg.is_moe:
            p["moe"] = moe_lib.moe_init(g, cfg, dtype=dtype)
        else:
            p["mlp"] = L.mlp_init(g, cfg.d_model, cfg.d_ff, dtype=dtype)
        return p

    layers = L.stack_layers(one_layer, cfg.num_layers)
    params = {
        "embed": L.dense_init(g, (cfg.vocab_size, cfg.d_model), scale=0.02,
                              dtype=dtype),
        "layers": layers,
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(g, (cfg.vocab_size, cfg.d_model),
                                         scale=1.0 / math.sqrt(cfg.d_model),
                                         dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# one transformer layer
# ---------------------------------------------------------------------------
class _ModelSlice(torch.autograd.Function):
    """This rank's 1 / model slice of ``x`` along ``dim`` (``x`` the same on
    every ``model`` rank); the backward all-gathers the slices' cotangents
    over ``model``, so what produced ``x`` gets the whole cotangent, the
    same on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        k = x.shape[dim] // mesh.model
        return x.narrow(dim, mesh.rank_in("model") * k, k).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_gather(g, ctx.dim), None, None


class _ModelGather(torch.autograd.Function):
    """The ``model`` group's slices concatenated along ``dim``; the backward
    keeps this rank's slice of the cotangent (the same on every rank: all
    that reads the result is replicated)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(y, dim)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.mesh.model
        return g.narrow(ctx.dim, ctx.mesh.rank_in("model") * k, k), None, None


class _BatchGather(torch.autograd.Function):
    """Every batch shard's rows in lane order: the global batch, the same on
    every rank.  The backward sums the cotangents over the batch group and
    keeps this rank's rows: each rank's loss is its share of the one whose
    gradients the trainer averages over that group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.batch_gather(x)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[0] // ctx.mesh.lanes
        return ctx.mesh.batch_sum(g).narrow(0, ctx.mesh.lane * k, k), None


class _BatchMean(torch.autograd.Function):
    """The mean over the batch group (the ``pod x data`` ranks); its
    backward is the batch group's mean of the cotangent, since the trainer
    averages the gradients over that group."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.batch_mean(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.batch_mean(g), None


class _Share(torch.autograd.Function):
    """The identity, whose backward is 1 / n of the cotangent: a leaf that
    every ``model`` rank applies to the same tokens holds a 1 / n share of
    its gradient, which the trainer's sum over ``model`` adds up."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _moe_block(p_moe, x: torch.Tensor, cfg, mesh=None, *,
               batch_axes=("data",), capacity_floor: int = 8):
    """MoE FFN on (B, S, d); returns (y, load-balance loss).

    Without a mesh with a ``model`` axis: the reference's single-device
    path.  With one (:class:`~repro_torch.launch.mesh.TrainMesh`; ``x`` the
    rank's batch rows, the same on every ``model`` rank; ``p_moe``'s
    expert stacks the rank's ``E / model`` experts), the reference's
    ``shard_map`` over ``model`` in its three branches:

    * ``S % model == 0``: each rank takes its ``S / model`` slice of the
      sequence, runs ``moe_forward`` over the ``model`` group (the two
      all-to-alls) at the capacity of its ``B * S / model`` tokens, and the
      slices are gathered back; the load-balance loss takes the group's
      means of its two terms, then the mean over the batch group
      (``batch_axes``, which must be the mesh's: the reference's
      ``lb_axes``);
    * else the reference's two other branches, which see the global batch:
      each rank gathers every batch shard's rows (:class:`_BatchGather`)
      and keeps its own rows of the result.  Where the global ``B``
      divides over ``model`` (decode), the same as above over a
      ``B / model`` slice of its rows, the loss averaged over ``model``
      only; otherwise every rank runs the one-device path on all the
      tokens, over the experts all-gathered from the ``model`` group.

    With grad, the slice's backward all-gathers the slices' cotangents and
    the gather's keeps the rank's own, so everything outside the block gets
    the whole cotangent on every ``model`` rank; the router and shared
    experts get the rank's share of theirs (the trainer sums them over
    ``model``), the experts theirs from every rank's tokens."""
    B, S, d = x.shape
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        y, aux = moe_lib.moe_forward(p_moe, x.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux.lb_loss
    ep = mesh.shape["model"]
    if tuple(batch_axes) != tuple(a for a in ("pod", "data") if a in mesh.axis_names):
        raise ValueError(f"batch_axes {tuple(batch_axes)}: the port's batch group is "
                         f"the mesh's batch axes, launch.mesh.batch_axes(mesh)")
    if S % ep == 0:
        dim, t_local, over_batch = 1, B * (S // ep), True
    else:
        x = x if mesh.lanes == 1 else _BatchGather.apply(x, mesh)
        if x.shape[0] % ep:
            y, lb = _moe_replicated(p_moe, x, cfg, mesh)
            return _own_rows(y, mesh, B), lb
        dim, t_local, over_batch = 0, (x.shape[0] // ep) * S, False
    capacity = moe_lib.default_capacity(t_local, cfg, floor=capacity_floor)
    group = mesh.ep_mesh
    xl = x if group is None else _ModelSlice.apply(x, mesh, dim)
    b, s, _ = xl.shape
    y, aux = moe_lib.moe_forward(p_moe, xl.reshape(b * s, d), cfg,
                                 capacity=capacity, mesh=group)
    terms = aux.lb_terms if group is None \
        else moe_lib.group_mean(aux.lb_terms, group)
    lb = moe_lib.lb_from_terms(terms, cfg.experts_per_token)
    if over_batch and mesh.lanes > 1:
        lb = _BatchMean.apply(lb, mesh)
    y = y.reshape(b, s, d)
    y = y if group is None else _ModelGather.apply(y, mesh, dim)
    return _own_rows(y, mesh, B), lb


def _own_rows(y: torch.Tensor, mesh, B: int) -> torch.Tensor:
    """This rank's ``B`` rows of ``y``, which holds the global batch where
    the block gathered it."""
    return y if y.shape[0] == B else y.narrow(0, mesh.lane * B, B)


def _moe_replicated(p_moe, x: torch.Tensor, cfg, mesh):
    """The reference's fallback where the tokens split over ``model``
    neither way: the one-device path on every rank, the expert stacks
    all-gathered over ``model`` (their backward keeps this rank's slice)
    and the router and shared experts through :class:`_Share`."""
    B, S, d = x.shape
    n = mesh.shape["model"]
    p = {k: _ModelGather.apply(v, mesh, 0) if k.startswith("experts_")
         else _Share.apply(v, n) for k, v in p_moe.items()}
    y, aux = moe_lib.moe_forward(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux.lb_loss


def _ffn(p, h: torch.Tensor, cfg, mesh=None, batch_axes=("data",),
         capacity_floor: int = 8):
    if cfg.is_moe:
        return _moe_block(p["moe"], h, cfg, mesh, batch_axes=batch_axes,
                          capacity_floor=capacity_floor)
    return (L.mlp_apply(p["mlp"], h, act=cfg.act),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _attn_part(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
               window: Optional[int], kv_cache=None, cache_pos=None,
               kv_valid_len=None):
    """(attention output, (k, v)) of :func:`_layer`'s first half: the
    pre-norm and attention, with gemma2's post-norm when the config has
    it."""
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    attn_out, new_kv = L.attn_apply(
        p["attn"], h, positions, cfg, kv_cache=kv_cache, cache_pos=cache_pos,
        window=window, kv_valid_len=kv_valid_len)
    if cfg.post_norm:
        attn_out = L.rmsnorm(p["ln1_post"], attn_out, eps=cfg.norm_eps)
    return attn_out, new_kv


def _ffn_part(p, x: torch.Tensor, attn_out: torch.Tensor, *, cfg, mesh=None,
              batch_axes=("data",)):
    """(x, lb) of :func:`_layer`'s second half: the residual add and norm,
    the MLP or MoE, gemma2's post-norm, the residual add."""
    x, h = L.add_rmsnorm(x, attn_out, p["ln2"], eps=cfg.norm_eps)
    ffn, lb = _ffn(p, h, cfg, mesh, batch_axes)
    if cfg.post_norm:
        ffn = L.rmsnorm(p["ln2_post"], ffn, eps=cfg.norm_eps)
    return x + ffn, lb


def _layer(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
           window: Optional[int], kv_cache=None, cache_pos=None,
           kv_valid_len=None, mesh=None, batch_axes=("data",)):
    """(x, (k, v), lb) of one pre-norm block: attention, then the MLP or
    MoE, each with gemma2's post-norm when the config has it."""
    attn_out, new_kv = _attn_part(p, x, positions, cfg, window=window,
                                  kv_cache=kv_cache, cache_pos=cache_pos,
                                  kv_valid_len=kv_valid_len)
    x, lb = _ffn_part(p, x, attn_out, cfg=cfg, mesh=mesh, batch_axes=batch_axes)
    return x, new_kv, lb


def _train_layer(p, x: torch.Tensor, *, positions: torch.Tensor, cfg,
                 window: Optional[int], mesh=None, batch_axes=("data",)):
    """(x, lb) of :func:`_layer` without a cache: the unit the teacher-
    forced forward recomputes in the backward (over a mesh the recompute
    runs the MoE block's collectives again, in the same order on every
    rank)."""
    x, _, lb = _layer(p, x, positions, cfg, window=window, mesh=mesh,
                      batch_axes=batch_axes)
    return x, lb


def _saved_attn(p, x: torch.Tensor, *, positions: torch.Tensor, cfg,
                window: Optional[int]) -> torch.Tensor:
    """The first of a ``"save_ffn"`` layer's two recomputed regions: the
    attention output, which the second region's checkpoint keeps as its
    input."""
    return _attn_part(p, x, positions, cfg, window=window)[0]


REMAT_POLICIES = ("full", "dots", "save_ffn")


def check_remat_policy(remat_policy: str) -> None:
    """The reference's policies, which give the same values and differ in
    what the backward recomputes: ``"full"`` recomputes each layer;
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) keeps the outputs of
    the 2-D weight products (``layers.SAVE_DOTS``); ``"save_ffn"``
    (``save_only_these_names("moe_out", "attn_out", "ep_recv")``) keeps the
    attention output, as the input of a layer's second recomputed region
    (:func:`_ffn_part`), and the MoE exchange's received buffers
    (``layers.SAVE_EXCHANGE``), so the recompute issues no all-to-all.
    Anything else raises ``ValueError``."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r} (one of "
                         f"{REMAT_POLICIES})")


def _embed(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        # the reference multiplies by sqrt(d) cast to x's dtype first: in
        # bf16 the rounded scale gives other products than the exact one
        scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        x = x * scale
    return x


def _unembed(params, x: torch.Tensor, cfg) -> torch.Tensor:
    w = params.get("unembed", params["embed"])
    logits = x @ w.T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)     # in the logits' dtype
    return logits


def _positions(B: int, S: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + S, device=device)[None, :].expand(B, S)


# ---------------------------------------------------------------------------
# full teacher-forced forward
# ---------------------------------------------------------------------------
def forward_hidden(params, tokens: torch.Tensor, cfg, *,
                   long_context: bool = False, mesh=None,
                   batch_axes=("data",), seq_shard: bool = False,
                   attn_shard=None, remat: bool = True,
                   remat_policy: str = "full"):
    """tokens (B, S) -> (final-normed hidden states (B, S, d), summed
    load-balance loss): :func:`forward` before the unembedding, so a caller
    can unembed only the positions it reads.  ``remat`` (the reference's
    default): with grad enabled each layer is recomputed in the backward
    (:func:`layers.remat`), the same values with less memory;
    ``remat_policy`` as :func:`check_remat_policy`.  ``mesh`` and
    ``batch_axes`` reach the MoE block (:func:`_moe_block`); ``seq_shard``
    and ``attn_shard`` raise."""
    _refuse_mesh(seq_shard, attn_shard)
    check_remat_policy(remat_policy)
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _positions(B, S, x.device)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = L.unstack_layers(params["layers"], cfg.num_layers)
    for p, win in zip(layers, layer_windows(cfg, long_context=long_context)):
        if remat_policy == "save_ffn":
            a = L.remat(partial(_saved_attn, positions=positions, cfg=cfg,
                                window=win), p, x, enabled=remat)
            x, lb_l = L.remat(partial(_ffn_part, cfg=cfg, mesh=mesh,
                                      batch_axes=batch_axes), p, x, a,
                              enabled=remat, save=L.SAVE_EXCHANGE)
        else:
            x, lb_l = L.remat(partial(_train_layer, positions=positions,
                                      cfg=cfg, window=win, mesh=mesh,
                                      batch_axes=batch_axes), p, x,
                              enabled=remat,
                              save=L.SAVE_DOTS if remat_policy == "dots" else None)
        lb = lb + lb_l
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps), lb


def forward(params, tokens: torch.Tensor, cfg, **kw):
    """tokens (B, S) -> (logits (B, S, V), summed load-balance loss).
    Keywords as :func:`forward_hidden`."""
    x, lb = forward_hidden(params, tokens, cfg, **kw)
    return _unembed(params, x, cfg), lb


def loss_fn(params, batch, cfg, *, lb_weight: float = 0.01, **fwd_kw):
    """(cross-entropy + ``lb_weight`` x the load-balance loss, metrics) of
    the teacher-forced forward; keywords as :func:`forward_hidden`.  Its
    backward runs the flash and expert backward kernels on the card."""
    logits, lb = forward(params, batch["tokens"], cfg, **fwd_kw)
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    return ce + lb_weight * lb, {"ce": ce, "lb": lb}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict[str, Any]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}                             # next write position


def prefill(params, tokens: torch.Tensor, cfg, *, long_context: bool = False,
            cache_len: Optional[int] = None, mesh=None, batch_axes=("data",)):
    """tokens (B, S) -> (last-token logits (B, V), cache).  The cache holds
    the prompt's post-RoPE k and v in its first S slots; ``cache_len`` (at
    least S; default S) sizes it for the decode steps to come, the slots
    past S zero.  ``mesh`` and ``batch_axes`` as :func:`forward_hidden`."""
    B, S = tokens.shape
    n = S if cache_len is None else cache_len
    if n < S:
        raise ValueError(f"prefill: cache_len {n} is shorter than the prompt {S}")
    x = _embed(params, tokens, cfg)
    positions = _positions(B, S, x.device)
    shape = (cfg.num_layers, B, n, cfg.num_kv_heads, cfg.head_dim)
    alloc = torch.empty if n == S else torch.zeros
    ks = alloc(shape, dtype=x.dtype, device=x.device)
    vs = alloc(shape, dtype=x.dtype, device=x.device)
    layers = L.unstack_layers(params["layers"], cfg.num_layers)
    for i, (p, win) in enumerate(zip(layers, layer_windows(
            cfg, long_context=long_context))):
        x, (k, v), _ = _layer(p, x, positions, cfg, window=win, mesh=mesh,
                              batch_axes=batch_axes)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    x = L.rmsnorm(params["final_norm"], x[:, -1:], eps=cfg.norm_eps)
    logits = _unembed(params, x, cfg)[:, 0]
    return logits, {"k": ks, "v": vs, "pos": S}


def decode_step(params, token: torch.Tensor, cache, cfg, *,
                long_context: bool = False, mesh=None, batch_axes=("data",),
                capacity_floor: int = 8):
    """One-token decode.  token (B,); cache from :func:`init_cache` or
    :func:`prefill`, whose k and v this step writes in place at
    ``pos % cache_len`` (post-RoPE, so slot order is irrelevant).

    Ring semantics: when the cache is shorter than the position, writes
    wrap; slot s holds the largest position p <= pos with p % cache_len ==
    s, and that position masks it (``k_pos``, built once a step and shared
    by every layer; -1 for a slot not yet written).  ``mesh`` and
    ``batch_axes`` as :func:`forward_hidden`; a single token splits the
    MoE block's tokens over ``model`` by batch rows where B divides, and
    ``capacity_floor`` rounds that block's capacity."""
    B = token.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    write_idx = pos % cache_len
    x = _embed(params, token[:, None], cfg)
    positions = torch.full((B, 1), pos, device=x.device)
    k_pos = ring_k_pos(pos, cache_len, x.device)
    layers = L.unstack_layers(params["layers"], cfg.num_layers)
    windows = layer_windows(cfg, long_context=long_context)
    for p, win, ck, cv in zip(layers, windows, cache["k"].unbind(0),
                              cache["v"].unbind(0)):
        a = p["attn"]
        h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
        q = (h @ a["wq"]).reshape(B, 1, H, Dh)
        k = (h @ a["wk"]).reshape(B, 1, KVH, Dh)
        v = (h @ a["wv"]).reshape(B, 1, KVH, Dh)
        if "q_norm" in a:
            q = L.rmsnorm(a["q_norm"], q)
            k = L.rmsnorm(a["k_norm"], k)
        q = L.rope(q, positions, theta=cfg.rope_theta)
        k = L.rope(k, positions, theta=cfg.rope_theta)
        ck[:, write_idx] = k[:, 0].to(ck.dtype)
        cv[:, write_idx] = v[:, 0].to(cv.dtype)
        out = _decode_attention(q, ck, cv, k_pos=k_pos, q_pos=pos, window=win,
                                softcap=cfg.attn_logit_softcap)
        attn_out = out.reshape(B, 1, H * Dh) @ a["wo"]
        if cfg.post_norm:
            attn_out = L.rmsnorm(p["ln1_post"], attn_out, eps=cfg.norm_eps)
        x, h2 = L.add_rmsnorm(x, attn_out, p["ln2"], eps=cfg.norm_eps)
        ffn, _ = _ffn(p, h2, cfg, mesh, batch_axes, capacity_floor)
        if cfg.post_norm:
            ffn = L.rmsnorm(p["ln2_post"], ffn, eps=cfg.norm_eps)
        x = x + ffn
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = _unembed(params, x, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def ring_k_pos(pos: int, cache_len: int, device) -> torch.Tensor:
    """int32 (cache_len,) absolute positions of a ring cache's slots after
    the write at ``pos``: slot s holds ``pos - ((pos - s) mod cache_len)``,
    -1 for a slot not yet written."""
    slots = torch.arange(cache_len, device=device)
    slot_pos = pos - torch.remainder(pos - slots, cache_len)
    return torch.where(slot_pos >= 0, slot_pos, -1).to(torch.int32)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, *, k_pos: torch.Tensor, q_pos: int,
                      window: Optional[int], softcap: Optional[float]):
    """q (B, 1, H, Dh) against a ring cache (B, Sc, KVH, Dh) whose slots sit
    at ``k_pos`` (:func:`ring_k_pos`; negative for an empty slot): causal at
    ``q_pos``, one-sided window, through the flash kernel with ``q_offset =
    q_pos``."""
    return L.attention(q, k_cache, v_cache, causal=True, window=window,
                       softcap=softcap, q_offset=q_pos, k_pos=k_pos)
