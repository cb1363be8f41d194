"""Llama-3.2-Vision-style VLM (hf:meta-llama/Llama-3.2-11B-Vision), port of
``repro.models.vlm``.

A language decoder with a gated cross-attention block after every
``cross_attn_every - 1`` self-attention layers (the published 11B: 32 self
+ 8 cross), then any trailing self layers.  The vision tower is a stub, as
in the JAX package: ``image_embeds`` (B, num_image_tokens, d_model) arrive
precomputed (bf16, ``ModelApi.extra_inputs``).  Cross-attention K/V depend
on the image only, so serving computes them once at prefill and caches
them.  The self layers are :mod:`repro_torch.models.dense`'s
(``_layer``, ``_embed``, ``_unembed``, ``layer_windows``,
``_decode_attention``); every attention, self and cross, is the
hand-written flash kernel on the card.

Dtypes: ``image_embeds @ wk`` with f32 params promotes to f32 in JAX; the
port casts the embeds to the weights' dtype first (exact, bf16 to f32).  A
gate's tanh (f32) times a block's output is an f32 product in JAX, rounded
to x's dtype after; torch would keep it in bf16, so the port upcasts.
``prefill`` takes ``cache_len`` as ``dense.prefill`` does (default: the
prompt's S slots, the reference's); ``pos`` is a host int and decode writes
k and v into the cache in place.  ``mesh`` and ``batch_axes`` pass through
to the self layers as in the reference (``dense._layer``); the published
model has no MoE block, so a training mesh changes no number here.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import torch

from repro_torch.models import dense
from repro_torch.models import layers as L


def _n_cross(cfg) -> int:
    return cfg.num_layers // cfg.cross_attn_every


def _n_self(cfg) -> int:
    return cfg.num_layers - _n_cross(cfg)


def _self_cfg(cfg):
    return cfg.replace(num_layers=_n_self(cfg))


def init_vlm(cfg, *, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """``dense.init_lm`` over the self layers plus ``cross`` stacked over
    the cross blocks, in the layout of ``repro.models.vlm.init_vlm``; the
    gates start at 0 (tanh-gated, zero-init).  The draws differ from JAX's
    for the same seed; the reference's weights come over by
    :func:`repro_torch.bridge.from_jax_params`.
    ``generator`` None: the same tree of ``meta`` tensors."""
    g, dev, d = generator, L.init_device(generator), cfg.d_model
    params = dense.init_lm(_self_cfg(cfg), generator=g, dtype=dtype)

    def one_cross():
        return {
            "ln1": L.rmsnorm_init(d, dev),
            "ln2": L.rmsnorm_init(d, dev),
            "attn": L.attn_init(g, d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, dtype=dtype),
            "mlp": L.mlp_init(g, d, cfg.d_ff, dtype=dtype),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=dev),
            "gate_mlp": torch.zeros((), dtype=torch.float32, device=dev),
        }

    params["cross"] = L.stack_layers(one_cross, _n_cross(cfg))
    return params


def _gated(gate: torch.Tensor, y: torch.Tensor, dtype: torch.dtype):
    """The reference's ``(tanh(gate) * y).astype(dtype)``: an f32 product."""
    return (torch.tanh(gate) * y.to(torch.float32)).to(dtype)


def _cross_block(p, x: torch.Tensor, img_kv, cfg) -> torch.Tensor:
    """Gated cross-attention + MLP over precomputed image (k, v), each
    (B, Ti, KVH, Dh)."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    q = (h @ p["attn"]["wq"]).reshape(B, S, H, Dh)
    out = L.attention(q, *img_kv, causal=False)
    x, h = L.add_rmsnorm(x, _gated(p["gate_attn"], out.reshape(B, S, H * Dh)
                                   @ p["attn"]["wo"], x.dtype),
                         p["ln2"], eps=cfg.norm_eps)
    return x + _gated(p["gate_mlp"], L.mlp_apply(p["mlp"], h, act=cfg.act), x.dtype)


def _image_kv(params, image_embeds: torch.Tensor, cfg):
    """Every cross block's image K/V: two (n_cross, B, Ti, KVH, Dh) stacks
    in the params' dtype (written in place, or stacked where autograd
    records them)."""
    B, Ti, _ = image_embeds.shape
    n, KVH, Dh = _n_cross(cfg), cfg.num_kv_heads, cfg.head_dim
    wk = params["cross"]["attn"]["wk"]
    img = image_embeds.to(wk.dtype)
    cross = L.unstack_layers(params["cross"], n)
    if torch.is_grad_enabled() and (img.requires_grad or wk.requires_grad):
        return tuple(torch.stack([(img @ p["attn"][w]).view(B, Ti, KVH, Dh)
                                  for p in cross]) for w in ("wk", "wv"))
    ik = img.new_empty((n, B, Ti, KVH, Dh))
    iv = img.new_empty((n, B, Ti, KVH, Dh))
    for c, p in enumerate(cross):
        torch.matmul(img, p["attn"]["wk"], out=ik[c].view(B, Ti, KVH * Dh))
        torch.matmul(img, p["attn"]["wv"], out=iv[c].view(B, Ti, KVH * Dh))
    return ik, iv


def _grouped(cfg):
    """The self layers in superblocks: [(cross block s, its self-layer
    indices)] for each of the n_cross superblocks, then (None, the trailing
    self-layer indices).  The reference's ``_grouped`` reshapes the stacked
    leaves the same way."""
    every = cfg.cross_attn_every - 1
    n_main = _n_cross(cfg) * every
    groups = [(s, range(s * every, (s + 1) * every)) for s in range(_n_cross(cfg))]
    return groups + [(None, range(n_main, _n_self(cfg)))]


def _run(params, x, positions, img_k, img_v, cfg, *, long_context: bool,
         ks=None, vs=None, remat: bool = False, mesh=None,
         batch_axes=("data",)):
    """The decoder over a prompt (superblocks, then trailing self layers);
    each self layer's (k, v) written into ``ks``/``vs`` when given, else,
    with ``remat``, each self layer recomputed in the backward (the
    reference checkpoints the self layers, not the cross blocks).  ``mesh``
    and ``batch_axes`` reach the self layers.  Returns the final-normed
    hidden states."""
    layers = L.unstack_layers(params["layers"], _n_self(cfg))
    cross = L.unstack_layers(params["cross"], _n_cross(cfg))
    windows = dense.layer_windows(_self_cfg(cfg), long_context=long_context)
    for s, idx in _grouped(cfg):
        for i in idx:
            if ks is None:
                x, _ = L.remat(partial(dense._train_layer, positions=positions, cfg=cfg,
                                       window=windows[i], mesh=mesh,
                                       batch_axes=batch_axes),
                               layers[i], x, enabled=remat)
                continue
            x, (ks[i], vs[i]), _ = dense._layer(layers[i], x, positions, cfg,
                                                window=windows[i], mesh=mesh,
                                                batch_axes=batch_axes)
        if s is not None:
            x = _cross_block(cross[s], x, (img_k[s], img_v[s]), cfg)
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)


def forward_hidden(params, tokens: torch.Tensor, image_embeds: torch.Tensor,
                   cfg, *, mesh=None, batch_axes=("data",),
                   long_context: bool = False, remat: bool = True):
    """tokens (B, S) -> final-normed hidden states (B, S, d): :func:`forward`
    before the unembedding, so a caller can unembed only the positions it
    reads.  ``remat``: with grad enabled each self layer is recomputed in
    the backward."""
    B, S = tokens.shape
    x = dense._embed(params, tokens, cfg)
    img_k, img_v = _image_kv(params, image_embeds, cfg)
    return _run(params, x, dense._positions(B, S, x.device), img_k, img_v, cfg,
                long_context=long_context, remat=remat, mesh=mesh,
                batch_axes=batch_axes)


def forward(params, tokens: torch.Tensor, image_embeds: torch.Tensor, cfg, *,
            mesh=None, batch_axes=("data",), long_context: bool = False,
            remat: bool = True, **_):
    """Teacher-forced logits (B, S, V) with interleaved cross-attention, and
    a zero auxiliary loss (the reference's second output)."""
    x = forward_hidden(params, tokens, image_embeds, cfg, mesh=mesh,
                       batch_axes=batch_axes, long_context=long_context,
                       remat=remat)
    return (dense._unembed(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], batch["image_embeds"], cfg, **kw)
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(params, tokens: torch.Tensor, image_embeds: torch.Tensor, cfg, *,
            mesh=None, batch_axes=("data",), long_context: bool = False,
            cache_len: Optional[int] = None, **_):
    """(last-token logits (B, V), cache): the self layers' k and v (n_self,
    B, cache_len, KVH, Dh; the prompt in the first S slots, the rest zero),
    the image K/V ``img_k``, ``img_v`` (n_cross, B, Ti, KVH, Dh), ``pos``
    S.  ``cache_len`` defaults to S, the reference's cache."""
    B, S = tokens.shape
    n = S if cache_len is None else cache_len
    if n < S:
        raise ValueError(f"prefill: cache_len {n} is shorter than the prompt {S}")
    x = dense._embed(params, tokens, cfg)
    img_k, img_v = _image_kv(params, image_embeds, cfg)
    shape = (_n_self(cfg), B, n, cfg.num_kv_heads, cfg.head_dim)
    alloc = torch.empty if n == S else torch.zeros
    ks = alloc(shape, dtype=x.dtype, device=x.device)
    vs = alloc(shape, dtype=x.dtype, device=x.device)
    x = _run(params, x, dense._positions(B, S, x.device), img_k, img_v, cfg,
             long_context=long_context, ks=ks[:, :, :S], vs=vs[:, :, :S],
             mesh=mesh, batch_axes=batch_axes)
    logits = dense._unembed(params, x[:, -1:], cfg)[:, 0]
    return logits, {"k": ks, "v": vs, "img_k": img_k, "img_v": img_v, "pos": S}


def init_cache(cfg, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zero cache: ``dense.init_cache`` over the self layers plus zero image
    K/V (n_cross, batch, num_image_tokens, KVH, Dh)."""
    c = dense.init_cache(_self_cfg(cfg), batch, max_len, dtype=dtype, device=device)
    shape = (_n_cross(cfg), batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
    c["img_k"] = torch.zeros(shape, dtype=dtype, device=device)
    c["img_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def decode_step(params, token: torch.Tensor, cache, cfg, *, mesh=None,
                batch_axes=("data",), long_context: bool = False, **_):
    """One-token decode (B,): the self layers against their ring-buffer
    cache (slot ``pos % slots``, ``dense.ring_k_pos``), the cross blocks
    against the cached image K/V.  Returns (logits (B, V), cache), k and v
    written in place.  The self layers' MLP is dense, so ``mesh`` and
    ``batch_axes`` change nothing here (the reference's decode takes them
    too)."""
    B = token.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    write_idx = pos % cache_len
    x = dense._embed(params, token[:, None], cfg)
    positions = torch.full((B, 1), pos, device=x.device)
    k_pos = dense.ring_k_pos(pos, cache_len, x.device)
    layers = L.unstack_layers(params["layers"], _n_self(cfg))
    cross = L.unstack_layers(params["cross"], _n_cross(cfg))
    windows = dense.layer_windows(_self_cfg(cfg), long_context=long_context)
    for s, idx in _grouped(cfg):
        for i in idx:
            p, a = layers[i], layers[i]["attn"]
            h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
            q = L.rope((h @ a["wq"]).reshape(B, 1, H, Dh), positions, theta=cfg.rope_theta)
            k = L.rope((h @ a["wk"]).reshape(B, 1, KVH, Dh), positions,
                       theta=cfg.rope_theta)
            v = (h @ a["wv"]).reshape(B, 1, KVH, Dh)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, write_idx] = k[:, 0].to(ck.dtype)
            cv[:, write_idx] = v[:, 0].to(cv.dtype)
            out = dense._decode_attention(q, ck, cv, k_pos=k_pos, q_pos=pos,
                                          window=windows[i], softcap=None)
            x, h = L.add_rmsnorm(x, out.reshape(B, 1, H * Dh) @ a["wo"], p["ln2"],
                                 eps=cfg.norm_eps)
            x = x + L.mlp_apply(p["mlp"], h, act=cfg.act)
        if s is not None:
            x = _cross_block(cross[s], x, (cache["img_k"][s], cache["img_v"][s]), cfg)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return dense._unembed(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)
