"""Family dispatcher (port of ``repro.models.api``): one interface over the
model zoo.

``get_model(cfg)`` returns a :class:`ModelApi` with the JAX package's field
names and, family by family, its lambdas and keywords: ``dense`` and
``moe`` (:mod:`repro_torch.models.dense`), ``ssm`` (RWKV-6), ``hybrid``
(Zamba2), ``vlm`` (Llama-3.2-Vision), ``audio`` (SeamlessM4T's
encoder-decoder) and ``dit_moe`` (its ``init`` and the rectified-flow loss;
serving is :class:`repro_torch.launch.serve.DiceServer`).  The stub
modality inputs of ``extra_inputs`` carry torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class ModelApi:
    init: Callable                         # (cfg, *, generator, dtype) -> params
    loss_fn: Callable                      # (params, batch, cfg, **kw) -> (loss, metrics)
    prefill: Optional[Callable]            # (params, batch, cfg, **kw) -> (logits, cache)
    decode_step: Optional[Callable]        # (params, batch, cache, cfg, **kw) -> (logits, cache)
    init_cache: Optional[Callable]         # (cfg, batch, max_len, device=) -> cache, or None
    extra_inputs: tuple = ()               # stub modality inputs (name, shape_fn, dtype)


def get_model(cfg) -> ModelApi:
    fam = cfg.family
    if fam in ("dense", "moe"):
        from repro_torch.models import dense as m
        return ModelApi(
            init=m.init_lm,
            loss_fn=m.loss_fn,
            prefill=lambda p, b, c, **kw: m.prefill(p, b["tokens"], c, **kw),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c, **kw),
            init_cache=m.init_cache,
        )
    if fam == "ssm":
        from repro_torch.models import rwkv6 as m
        return ModelApi(
            init=m.init_rwkv6,
            loss_fn=lambda p, b, c, **kw: m.loss_fn(p, b, c),
            prefill=lambda p, b, c, **kw: m.prefill(p, b["tokens"], c),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c),
            init_cache=lambda c, batch, max_len, device=None, **kw:
                m.init_state(c, batch, device),
        )
    if fam == "hybrid":
        from repro_torch.models import zamba2 as m
        return ModelApi(
            init=m.init_zamba2,
            loss_fn=m.loss_fn,
            prefill=lambda p, b, c, **kw: m.prefill(
                p, b["tokens"], c, cache_len=kw.get("cache_len")),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c, attn_window=kw.get("attn_window")),
            init_cache=lambda c, batch, max_len, device=None, **kw:
                m.init_state(c, batch, attn_cache_len=max_len, device=device),
        )
    if fam == "vlm":
        from repro_torch.models import vlm as m
        return ModelApi(
            init=m.init_vlm,
            loss_fn=m.loss_fn,
            prefill=lambda p, b, c, **kw: m.prefill(
                p, b["tokens"], b["image_embeds"], c, **kw),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c, **kw),
            init_cache=m.init_cache,
            extra_inputs=(("image_embeds",
                           lambda c, batch: (batch, c.num_image_tokens, c.d_model),
                           torch.bfloat16),),
        )
    if fam == "audio":
        from repro_torch.models import encdec as m
        return ModelApi(
            init=m.init_encdec,
            loss_fn=m.loss_fn,
            prefill=lambda p, b, c, **kw: m.prefill(
                p, b["tokens"], b["audio_frames"], c),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c, window=kw.get("attn_window")),
            init_cache=None,
            extra_inputs=(("audio_frames",
                           lambda c, batch: (batch, c.num_audio_frames, c.d_model),
                           torch.bfloat16),),
        )
    if fam == "dit_moe":
        from repro_torch.models import dit_moe as m
        from repro_torch.sampling.rectified_flow import rf_loss
        # the reference's loss_fn draws t, x0 and drop from a PRNG key
        # (default PRNGKey(0)) that torch cannot replay: rf_loss takes them
        # as keywords (rf_draws, or the reference's draws)
        return ModelApi(init=m.init_dit, loss_fn=rf_loss,
                        prefill=None, decode_step=None, init_cache=None)
    raise ValueError(f"unknown family: {fam}")
