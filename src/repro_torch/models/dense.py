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
axis) and ``batch_axes`` reach the MoE block: each rank holds its batch rows
(its ``batch_axes`` shard) and its ``E / model`` experts, and the block runs
expert-parallel over the ``model`` group (:func:`_moe_block`).  A mesh
without a ``model`` axis runs the one-device path, as in the reference.
Where the rank's params are cut by the reference dry run's specs
(``common/sharding.shard_lm_params``), or the layout hints ``seq_shard`` /
``attn_shard`` are given over a ``model`` axis, the teacher-forced forward
runs tensor-parallel (:func:`tensor_parallel`, :mod:`repro_torch.models.tp`):
each leaf is used as its spec cuts it, the embedding and the cross-entropy
vocab-parallel where ``embed`` / ``unembed`` are cut by vocabulary, the
residual stream's ``S / model`` rows a rank under ``seq_shard``.  Prefill
and decode keep the experts-only layout.  ``remat_policy`` (``"full"``,
``"dots"``, ``"save_ffn"``: :func:`check_remat_policy`) chooses what the
backward recomputes.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Any, Dict, List, Optional

import torch

from repro_torch.common import sharding as shard_lib
from repro_torch.core import moe as moe_lib
from repro_torch.models import layers as L
from repro_torch.models.tp import (TP, _BatchGather, _BatchMean, _ModelGather,
                                   _ModelSlice, _Share)


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
def _moe_block(p_moe, x: torch.Tensor, cfg, mesh=None, *,
               batch_axes=("data",), capacity_floor: int = 8, tp=None,
               cut=None):
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
    ``model``), the experts theirs from every rank's tokens.

    Under tensor parallelism (``tp``, ``cut``: :mod:`repro_torch.models.tp`)
    only the first branch runs (``S % model`` must be 0): under
    ``seq_shard`` ``x`` already holds the rank's ``S / model`` rows, which
    the block takes as they are and returns as they are; the router and
    shared experts are read through :meth:`TP.use` (gathered on use where
    their spec cuts them), whose backward sums their gradients over
    ``model``."""
    B, S, d = x.shape
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        y, aux = moe_lib.moe_forward(p_moe, x.reshape(B * S, d), cfg)
        return y.reshape(B, S, d), aux.lb_loss
    ep = mesh.shape["model"]
    if tuple(batch_axes) != tuple(a for a in ("pod", "data") if a in mesh.axis_names):
        raise ValueError(f"batch_axes {tuple(batch_axes)}: the port's batch group is "
                         f"the mesh's batch axes, launch.mesh.batch_axes(mesh)")
    split = tp is not None and tp.seq
    if tp is not None:
        if (S * ep if split else S) % ep:
            raise NotImplementedError(
                f"tensor parallelism: the MoE block splits the sequence over "
                f"'model'; S={S} does not divide over {ep} ranks")
        p_moe = {k: v if k.startswith("experts_") else tp.use(v, cut[k], local=True)
                 for k, v in p_moe.items()}
    if split:
        dim, t_local, over_batch = 1, B * S, True
    elif S % ep == 0:
        dim, t_local, over_batch = 1, B * (S // ep), True
    else:
        x = x if mesh.lanes == 1 else _BatchGather.apply(x, mesh)
        if x.shape[0] % ep:
            y, lb = _moe_replicated(p_moe, x, cfg, mesh)
            return _own_rows(y, mesh, B), lb
        dim, t_local, over_batch = 0, (x.shape[0] // ep) * S, False
    capacity = moe_lib.default_capacity(t_local, cfg, floor=capacity_floor)
    group = mesh.ep_mesh
    xl = x if group is None or split else _ModelSlice.apply(x, mesh, dim)
    b, s, _ = xl.shape
    y, aux = moe_lib.moe_forward(p_moe, xl.reshape(b * s, d), cfg,
                                 capacity=capacity, mesh=group)
    terms = aux.lb_terms if group is None \
        else moe_lib.group_mean(aux.lb_terms, group)
    lb = moe_lib.lb_from_terms(terms, cfg.experts_per_token)
    if over_batch and mesh.lanes > 1:
        lb = _BatchMean.apply(lb, mesh)
    y = y.reshape(b, s, d)
    y = y if group is None or split else _ModelGather.apply(y, mesh, dim)
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
         capacity_floor: int = 8, tp=None, cut=None):
    if cfg.is_moe:
        return _moe_block(p["moe"], h, cfg, mesh, batch_axes=batch_axes,
                          capacity_floor=capacity_floor, tp=tp,
                          cut=None if cut is None else cut["moe"])
    return (L.mlp_apply(p["mlp"], h, act=cfg.act, tp=tp,
                        cut=None if cut is None else cut["mlp"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _norm(p, cut, name: str, tp):
    """The norm ``name``'s params for the residual stream (:meth:`TP.norm`
    under tensor parallelism)."""
    return p[name] if tp is None else tp.norm(p[name], cut[name])


def _attn_part(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
               window: Optional[int], kv_cache=None, cache_pos=None,
               kv_valid_len=None, tp=None, cut=None):
    """(attention output, (k, v)) of :func:`_layer`'s first half: the
    pre-norm and attention, with gemma2's post-norm when the config has
    it.  ``tp``, ``cut``: tensor parallelism (:mod:`repro_torch.models.tp`;
    the rank's leaves, their cut dims), which returns no (k, v)."""
    h = L.rmsnorm(_norm(p, cut, "ln1", tp), x, eps=cfg.norm_eps)
    attn_out, new_kv = L.attn_apply(
        p["attn"], h, positions, cfg, kv_cache=kv_cache, cache_pos=cache_pos,
        window=window, kv_valid_len=kv_valid_len, tp=tp,
        cut=None if cut is None else cut["attn"])
    if cfg.post_norm:
        attn_out = L.rmsnorm(_norm(p, cut, "ln1_post", tp), attn_out,
                             eps=cfg.norm_eps)
    return attn_out, new_kv


def _ffn_part(p, x: torch.Tensor, attn_out: torch.Tensor, *, cfg, mesh=None,
              batch_axes=("data",), tp=None, cut=None):
    """(x, lb) of :func:`_layer`'s second half: the residual add and norm,
    the MLP or MoE, gemma2's post-norm, the residual add."""
    x, h = L.add_rmsnorm(x, attn_out, _norm(p, cut, "ln2", tp), eps=cfg.norm_eps)
    ffn, lb = _ffn(p, h, cfg, mesh, batch_axes, tp=tp, cut=cut)
    if cfg.post_norm:
        ffn = L.rmsnorm(_norm(p, cut, "ln2_post", tp), ffn, eps=cfg.norm_eps)
    return x + ffn, lb


def _layer(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
           window: Optional[int], kv_cache=None, cache_pos=None,
           kv_valid_len=None, mesh=None, batch_axes=("data",), tp=None,
           cut=None):
    """(x, (k, v), lb) of one pre-norm block: attention, then the MLP or
    MoE, each with gemma2's post-norm when the config has it."""
    attn_out, new_kv = _attn_part(p, x, positions, cfg, window=window,
                                  kv_cache=kv_cache, cache_pos=cache_pos,
                                  kv_valid_len=kv_valid_len, tp=tp, cut=cut)
    x, lb = _ffn_part(p, x, attn_out, cfg=cfg, mesh=mesh, batch_axes=batch_axes,
                      tp=tp, cut=cut)
    return x, new_kv, lb


def _train_layer(p, x: torch.Tensor, *, positions: torch.Tensor, cfg,
                 window: Optional[int], mesh=None, batch_axes=("data",),
                 tp=None, cut=None):
    """(x, lb) of :func:`_layer` without a cache: the unit the teacher-
    forced forward recomputes in the backward (over a mesh the recompute
    runs the MoE block's and tensor parallelism's collectives again, in
    the same order on every rank)."""
    x, _, lb = _layer(p, x, positions, cfg, window=window, mesh=mesh,
                      batch_axes=batch_axes, tp=tp, cut=cut)
    return x, lb


def _saved_attn(p, x: torch.Tensor, *, positions: torch.Tensor, cfg,
                window: Optional[int], tp=None, cut=None) -> torch.Tensor:
    """The first of a ``"save_ffn"`` layer's two recomputed regions: the
    attention output, which the second region's checkpoint keeps as its
    input."""
    return _attn_part(p, x, positions, cfg, window=window, tp=tp, cut=cut)[0]


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


def _embed(params, tokens: torch.Tensor, cfg, tp=None, cut=None) -> torch.Tensor:
    """The embedded tokens, times gemma2's scale.  ``tp``: in the residual
    stream's layout; an ``embed`` cut over ``model`` by vocabulary gives
    each rank its rows' embeddings (zero for the other ranks' tokens),
    summed over ``model`` (exact: one term is not zero)."""
    e = params["embed"]
    if tp is not None and cut["embed"] == 0:
        V = e.shape[0]
        t = tokens.long() - tp.r * V
        x = e[t.clamp(0, V - 1)]
        x = tp.exit_partial(torch.where(((t >= 0) & (t < V))[..., None], x,
                                        torch.zeros_like(x)))
    elif tp is not None:
        x = tp.to_rows(tp.use(e, cut["embed"], local=False)[tokens.long()])
    else:
        x = e[tokens.long()]
    if cfg.embed_scale:
        # the reference multiplies by sqrt(d) cast to x's dtype first: in
        # bf16 the rounded scale gives other products than the exact one
        scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        x = x * scale
    return x


def _softcap(logits: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)     # in the logits' dtype
    return logits


def _unembed(params, x: torch.Tensor, cfg) -> torch.Tensor:
    w = params.get("unembed", params["embed"])
    return _softcap(x @ w.T, cfg)


def _unembed_tp(params, x: torch.Tensor, cfg, tp, cut):
    """(logits, whether they are the rank's vocabulary slice) of the
    residual stream's ``x`` under tensor parallelism: an unembedding cut
    by vocabulary gives each rank its ``V / model`` columns over every
    row, else the whole unembedding (gathered on use) gives every rank all
    of them."""
    key = "unembed" if "unembed" in params else "embed"
    w, c = params[key], cut[key]
    if c == 0:
        return _softcap(tp.enter(x) @ w.T, cfg), True
    x = _ModelGather.apply(x, tp.mesh, 1) if tp.seq else x
    return _softcap(x @ tp.use(w, c, local=False).T, cfg), False


def _positions(B: int, S: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + S, device=device)[None, :].expand(B, S)


# ---------------------------------------------------------------------------
# tensor parallelism: which leaves the rank holds cut
# ---------------------------------------------------------------------------
class _Shape:
    """A leaf's shape alone (``held_cuts`` and ``param_spec`` read it)."""

    def __init__(self, t):
        self.shape = tuple(t.shape)


@lru_cache(maxsize=32)
def _whole_cuts(cfg, axis_names, shape):
    """(the whole params' shapes, their cut dims) on a mesh of ``shape``:
    shapes only, so the cache holds no tensor (the dry run counts every
    storage a step makes, ``meta`` ones included)."""
    class _Mesh:                           # param_spec reads these two only
        pass
    m = _Mesh()
    m.axis_names, m.shape = axis_names, dict(shape)
    whole = shard_lib.tree_map_leaves(_Shape, init_lm(cfg, generator=None))
    return whole, shard_lib.lm_param_cuts(whole, m)


def param_cuts(params, cfg, mesh):
    """The tree of ``params`` with each leaf replaced by the dim its
    ``param_spec`` cuts over ``model`` where this rank holds it cut
    (:func:`~repro_torch.common.sharding.shard_lm_params`), None where it
    holds the whole leaf (the routed experts are cut as ``train_lm`` cuts
    them)."""
    whole, cuts = _whole_cuts(cfg, tuple(mesh.axis_names),
                              tuple(sorted(mesh.shape.items())))
    return shard_lib.held_cuts(params, whole, cuts)


def tensor_parallel(params, cfg, mesh, *, seq_shard: bool = False,
                    attn_shard=None):
    """(:class:`~repro_torch.models.tp.TP`, cut dims) when the step runs
    tensor-parallel: a mesh whose ``model`` axis has more than one rank,
    and a leaf other than the routed experts held cut (the reference's
    ``tree_param_specs`` layout) or a layout hint given.  (None, None)
    otherwise: the hints change nothing without a ``model`` axis, as the
    reference's constraints do nothing without a mesh."""
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()) \
            or mesh.shape["model"] == 1:
        return None, None
    cuts = param_cuts(params, cfg, mesh)
    dense_cut = any(c is not None for path, c in shard_lib.tree_items(cuts)
                    if not shard_lib.is_lm_expert(path))
    if not (dense_cut or seq_shard or attn_shard):
        return None, None
    return TP(mesh, seq_shard=seq_shard, attn_shard=attn_shard), cuts


def _layer_cuts(cuts):
    """A stacked leaf's cut dim as its per-layer leaf's (one less)."""
    if isinstance(cuts, dict):
        return {k: _layer_cuts(v) for k, v in cuts.items()}
    if cuts == 0:
        raise NotImplementedError("tensor parallelism: a spec on the layer "
                                  "axis of a stacked leaf (no config has one)")
    return None if cuts is None else cuts - 1


# ---------------------------------------------------------------------------
# full teacher-forced forward
# ---------------------------------------------------------------------------
def _hidden(params, tokens: torch.Tensor, cfg, *, long_context: bool = False,
            mesh=None, batch_axes=("data",), seq_shard: bool = False,
            attn_shard=None, remat: bool = True, remat_policy: str = "full"):
    """(final-normed hidden states in the residual stream's layout, summed
    load-balance loss, :class:`TP` or None, the cut dims or None)."""
    check_remat_policy(remat_policy)
    tp, cuts = tensor_parallel(params, cfg, mesh, seq_shard=seq_shard,
                               attn_shard=attn_shard)
    B, S = tokens.shape
    if tp is not None and tp.seq and S % tp.n:
        raise ValueError(f"seq_shard: the sequence {S} does not divide over "
                         f"{tp.n} 'model' ranks")
    x = _embed(params, tokens, cfg, tp, cuts)
    positions = _positions(B, S, x.device)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = L.unstack_layers(params["layers"], cfg.num_layers)
    kw = dict(tp=tp, cut=None if cuts is None else _layer_cuts(cuts["layers"]))
    for p, win in zip(layers, layer_windows(cfg, long_context=long_context)):
        if remat_policy == "save_ffn":
            a = L.remat(partial(_saved_attn, positions=positions, cfg=cfg,
                                window=win, **kw), p, x, enabled=remat)
            x, lb_l = L.remat(partial(_ffn_part, cfg=cfg, mesh=mesh,
                                      batch_axes=batch_axes, **kw), p, x, a,
                              enabled=remat, save=L.SAVE_EXCHANGE)
        else:
            x, lb_l = L.remat(partial(_train_layer, positions=positions,
                                      cfg=cfg, window=win, mesh=mesh,
                                      batch_axes=batch_axes, **kw), p, x,
                              enabled=remat,
                              save=L.SAVE_DOTS if remat_policy == "dots" else None)
        lb = lb + lb_l
    x = L.rmsnorm(_norm(params, cuts, "final_norm", tp), x, eps=cfg.norm_eps)
    return x, lb, tp, cuts


def forward_hidden(params, tokens: torch.Tensor, cfg, **kw):
    """tokens (B, S) -> (final-normed hidden states (B, S, d), summed
    load-balance loss): :func:`forward` before the unembedding, so a caller
    can unembed only the positions it reads.

    Keywords: ``remat`` (the reference's default): with grad enabled each
    layer is recomputed in the backward (:func:`layers.remat`), the same
    values with less memory; ``remat_policy`` as
    :func:`check_remat_policy`.  ``mesh`` and ``batch_axes`` reach the MoE
    block (:func:`_moe_block`).  With ``params`` cut by the reference's
    specs (:func:`~repro_torch.common.sharding.shard_lm_params`) over a
    mesh's ``model`` axis, or with the layout hints, the forward runs
    tensor-parallel (:mod:`repro_torch.models.tp`): ``seq_shard`` keeps the
    residual stream's ``S / model`` rows on each rank between layers (the
    reference's ``constrain``; gathered back here), ``attn_shard``
    (``"heads"`` / ``"seq"``) chooses the attention's layout
    (:func:`layers._attn_tp`)."""
    x, lb, tp, _ = _hidden(params, tokens, cfg, **kw)
    if tp is not None and tp.seq:
        x = _ModelGather.apply(x, tp.mesh, 1)
    return x, lb


def forward(params, tokens: torch.Tensor, cfg, **kw):
    """tokens (B, S) -> (logits (B, S, V), summed load-balance loss).
    Keywords as :func:`forward_hidden`."""
    x, lb, tp, cuts = _hidden(params, tokens, cfg, **kw)
    if tp is None:
        return _unembed(params, x, cfg), lb
    logits, sliced = _unembed_tp(params, x, cfg, tp, cuts)
    return (_ModelGather.apply(logits, tp.mesh, 2) if sliced else logits), lb


def loss_fn(params, batch, cfg, *, lb_weight: float = 0.01, **fwd_kw):
    """(cross-entropy + ``lb_weight`` x the load-balance loss, metrics) of
    the teacher-forced forward; keywords as :func:`forward_hidden`.  Its
    backward runs the flash and expert backward kernels on the card.
    Under tensor parallelism with the unembedding cut by vocabulary the
    cross-entropy is the vocab-parallel one
    (:func:`layers.vocab_parallel_cross_entropy`), the same on every
    ``model`` rank."""
    x, lb, tp, cuts = _hidden(params, batch["tokens"], cfg, **fwd_kw)
    if tp is None:
        ce = L.softmax_cross_entropy(_unembed(params, x, cfg), batch["labels"])
    else:
        logits, sliced = _unembed_tp(params, x, cfg, tp, cuts)
        ce = L.vocab_parallel_cross_entropy(logits, batch["labels"], tp.mesh) \
            if sliced else L.softmax_cross_entropy(logits, batch["labels"])
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
