"""SeamlessM4T-v2-large-style encoder-decoder (arXiv:2308.11596), port of
``repro.models.encdec``.

The audio frontend (mel spectrogram and conv feature extractor) is a stub,
as in the JAX package: ``audio_frames`` (B, num_audio_frames, d_model)
arrive precomputed and are cast to the params' dtype.  A bidirectional
encoder over the frames, a causal text decoder with cross-attention to the
encoder memory.  Serving: ``prefill`` encodes once, computes every decoder
layer's cross K/V over the memory once (:func:`_memory_kv`) and runs the
prompt; ``decode_step`` attends to its ring-buffer self cache and the
cached memory K/V.  Every attention, self and cross, is
:func:`repro_torch.models.layers.attention`: the hand-written flash kernel
on the card.

The reference's ``prefill`` returns a self-attention cache exactly as long
as the prompt, and so does the port's: a decode step past it wraps the
ring and drops the oldest token.  A caller that wants room for decode pads
the cache's slot axis with zeros (:func:`pad_cache`), as
``tests/test_streaming.py`` does.
The layers run in a Python loop over views unbound once a call; ``pos`` is
a host int and decode writes k and v into the cache in place.  A residual
add followed by a norm reads the unrounded sum (``layers.add_rmsnorm``),
and silu rounds as the reference's (``layers.silu``).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import dense
from repro_torch.models import layers as L


def init_encdec(cfg, *, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random params on ``generator.device`` in the layout of
    ``repro.models.encdec.init_encdec``: ``enc_layers`` and ``dec_layers``
    stacked over their layers.  The draws differ from JAX's for the same
    seed; the reference's weights come over by
    :func:`repro_torch.bridge.from_jax_params`.
    ``generator`` None: the same tree of ``meta`` tensors."""
    g, dev, d = generator, L.init_device(generator), cfg.d_model

    def attn():
        return L.attn_init(g, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           dtype=dtype)

    def enc_layer():
        return {"ln1": L.rmsnorm_init(d, dev), "ln2": L.rmsnorm_init(d, dev),
                "attn": attn(), "mlp": L.mlp_init(g, d, cfg.d_ff, dtype=dtype)}

    def dec_layer():
        return {"ln1": L.rmsnorm_init(d, dev), "ln_x": L.rmsnorm_init(d, dev),
                "ln2": L.rmsnorm_init(d, dev), "attn": attn(), "xattn": attn(),
                "mlp": L.mlp_init(g, d, cfg.d_ff, dtype=dtype)}

    return {
        "enc_layers": L.stack_layers(enc_layer, cfg.encoder_layers),
        "enc_norm": L.rmsnorm_init(d, dev),
        "dec_layers": L.stack_layers(dec_layer, cfg.num_layers),
        "embed": L.dense_init(g, (cfg.vocab_size, d), scale=0.02, dtype=dtype),
        "final_norm": L.rmsnorm_init(d, dev),
        "unembed": L.dense_init(g, (cfg.vocab_size, d),
                                scale=1.0 / math.sqrt(d), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _enc_layer(p, x: torch.Tensor, *, positions: torch.Tensor, cfg) -> torch.Tensor:
    """One bidirectional encoder layer: self-attention, then the MLP."""
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    a, _ = L.attn_apply(p["attn"], h, positions, cfg, causal=False)
    x, h = L.add_rmsnorm(x, a, p["ln2"], eps=cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, act=cfg.act)


def encode(params, audio_frames: torch.Tensor, cfg, *,
           remat: bool = True) -> torch.Tensor:
    """audio_frames (B, Tf, d) -> encoder memory (B, Tf, d), in the params'
    dtype.  With ``remat`` and grad enabled each layer is recomputed in the
    backward, as the reference checkpoints it."""
    B, Tf, _ = audio_frames.shape
    x = audio_frames.to(params["embed"].dtype)
    run = partial(_enc_layer, positions=dense._positions(B, Tf, x.device), cfg=cfg)
    for p in L.unstack_layers(params["enc_layers"], cfg.encoder_layers):
        x = L.remat(run, p, x, enabled=remat)
    return L.rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps)


def _memory_kv(params, memory: torch.Tensor, cfg):
    """Every decoder layer's cross K/V over the encoder memory, computed
    once: two (layers, B, Tf, KVH, Dh) stacks (written in place, or
    stacked where autograd records them)."""
    B, Tf, _ = memory.shape
    n, KVH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    layers = L.unstack_layers(params["dec_layers"], n)
    if torch.is_grad_enabled() and (memory.requires_grad
                                    or params["dec_layers"]["xattn"]["wk"].requires_grad):
        return tuple(torch.stack([(memory @ p["xattn"][w]).view(B, Tf, KVH, Dh)
                                  for p in layers]) for w in ("wk", "wv"))
    mk = memory.new_empty((n, B, Tf, KVH, Dh))
    mv = memory.new_empty((n, B, Tf, KVH, Dh))
    for i, p in enumerate(layers):
        torch.matmul(memory, p["xattn"]["wk"], out=mk[i].view(B, Tf, KVH * Dh))
        torch.matmul(memory, p["xattn"]["wv"], out=mv[i].view(B, Tf, KVH * Dh))
    return mk, mv


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _cross_mlp(p, x: torch.Tensor, a: torch.Tensor, mk: torch.Tensor,
               mv: torch.Tensor, cfg) -> torch.Tensor:
    """A decoder layer after its self-attention output ``a``: the residual,
    cross-attention over the memory's K/V, the MLP."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    x, h = L.add_rmsnorm(x, a, p["ln_x"], eps=cfg.norm_eps)
    q = (h @ p["xattn"]["wq"]).reshape(B, S, H, Dh)
    xa = L.attention(q, mk, mv, causal=False)
    x, h = L.add_rmsnorm(x, xa.reshape(B, S, H * Dh) @ p["xattn"]["wo"], p["ln2"],
                         eps=cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, act=cfg.act)


def _dec_layer(p, x: torch.Tensor, positions: torch.Tensor, mem_kv, cfg, *,
               kv_cache=None, cache_pos=None, kv_valid_len=None,
               window: Optional[int] = None):
    """One decoder layer: causal self-attention, cross-attention over
    ``mem_kv`` = (k, v) (B, Tf, KVH, Dh), MLP.  Returns (x, (k, v))."""
    h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    a, new_kv = L.attn_apply(p["attn"], h, positions, cfg, kv_cache=kv_cache,
                             cache_pos=cache_pos, kv_valid_len=kv_valid_len,
                             window=window)
    return _cross_mlp(p, x, a, *mem_kv, cfg), new_kv


def _train_dec_layer(p, x: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor, *,
                     positions: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`_dec_layer` without a cache: the unit training recomputes."""
    return _dec_layer(p, x, positions, (mk, mv), cfg)[0]


def _decoder(params, tokens: torch.Tensor, mem_k, mem_v, cfg, ks=None, vs=None,
             remat: bool = False):
    """The decoder over a prompt: final-normed hidden states; each layer's
    (k, v) written into ``ks``/``vs`` (layers, B, S, KVH, Dh) when given;
    with ``remat`` (and no ``ks``) each layer is recomputed in the
    backward."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = dense._positions(B, S, x.device)
    run = partial(_train_dec_layer, positions=positions, cfg=cfg)
    for i, p in enumerate(L.unstack_layers(params["dec_layers"], cfg.num_layers)):
        if ks is None:
            x = L.remat(run, p, x, mem_k[i], mem_v[i], enabled=remat)
            continue
        x, (ks[i], vs[i]) = _dec_layer(p, x, positions, (mem_k[i], mem_v[i]), cfg)
    return L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)


def forward(params, tokens: torch.Tensor, audio_frames: torch.Tensor, cfg, *,
            remat: bool = True, **_):
    """Teacher-forced decoder logits (B, S, V) given audio frames, and a
    zero auxiliary loss (the reference's second output).  With ``remat``
    and grad enabled every encoder and decoder layer is recomputed in the
    backward, as the reference checkpoints them."""
    memory = encode(params, audio_frames, cfg, remat=remat)
    mem_k, mem_v = _memory_kv(params, memory, cfg)
    x = _decoder(params, tokens, mem_k, mem_v, cfg, remat=remat)
    return (x @ params["unembed"].T,
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], batch["audio_frames"], cfg, **kw)
    ce = L.softmax_cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(params, tokens: torch.Tensor, audio_frames: torch.Tensor, cfg, **_):
    """Encode the audio and run the decoder prompt: (last-token logits
    (B, V), cache).  The cache: the decoder's self k and v (layers, B, S,
    KVH, Dh), exactly the prompt's S slots; the memory K/V ``mem_k``,
    ``mem_v`` (layers, B, Tf, KVH, Dh); ``pos`` S."""
    B, S = tokens.shape
    memory = encode(params, audio_frames, cfg, remat=False)
    mem_k, mem_v = _memory_kv(params, memory, cfg)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    ks = memory.new_empty(shape)
    vs = memory.new_empty(shape)
    x = _decoder(params, tokens, mem_k, mem_v, cfg, ks, vs)
    logits = (x[:, -1:] @ params["unembed"].T)[:, 0]
    return logits, {"k": ks, "v": vs, "mem_k": mem_k, "mem_v": mem_v, "pos": S}


def pad_cache(cache, n: int):
    """``cache`` with ``n`` zero slots appended to its self k and v (layers,
    B, slots, KVH, Dh): room for ``n`` decode steps before the ring wraps."""
    pad = (0, 0, 0, 0, 0, n)
    return dict(cache, k=F.pad(cache["k"], pad), v=F.pad(cache["v"], pad))


def decode_step(params, token: torch.Tensor, cache, cfg, *,
                window: Optional[int] = None, **_):
    """One decoder token (B,) against the ring-buffer self cache (slot
    ``pos % slots``, masked by the slots' positions, ``dense.ring_k_pos``;
    one-sided ``window``) and the cached memory K/V.  Returns (logits (B,
    V), cache), k and v written in place."""
    B = token.shape[0]
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache_len = cache["k"].shape[2]
    pos = int(cache["pos"])
    write_idx = pos % cache_len
    x = params["embed"][token.long()[:, None]]
    positions = torch.full((B, 1), pos, device=x.device)
    k_pos = dense.ring_k_pos(pos, cache_len, x.device)
    layers = L.unstack_layers(params["dec_layers"], cfg.num_layers)
    for i, p in enumerate(layers):
        a = p["attn"]
        h = L.rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
        q = L.rope((h @ a["wq"]).reshape(B, 1, H, Dh), positions, theta=cfg.rope_theta)
        k = L.rope((h @ a["wk"]).reshape(B, 1, KVH, Dh), positions, theta=cfg.rope_theta)
        v = (h @ a["wv"]).reshape(B, 1, KVH, Dh)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, write_idx] = k[:, 0].to(ck.dtype)
        cv[:, write_idx] = v[:, 0].to(cv.dtype)
        out = dense._decode_attention(q, ck, cv, k_pos=k_pos, q_pos=pos,
                                      window=window or None, softcap=None)
        x = _cross_mlp(p, x, out.reshape(B, 1, H * Dh) @ a["wo"],
                       cache["mem_k"][i], cache["mem_v"][i], cfg)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = (x @ params["unembed"].T)[:, 0]
    return logits, dict(cache, pos=pos + 1)
