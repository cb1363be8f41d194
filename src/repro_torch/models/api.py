"""Family dispatcher (port of ``repro.models.api``): one interface over the
model families the port has.

``get_model(cfg)`` returns a :class:`ModelApi` with the JAX package's field
names.  The port has the ``dense`` and ``moe`` families
(:mod:`repro_torch.models.dense`) and ``ssm`` (RWKV-6); DiT-MoE serving
goes through :class:`repro_torch.launch.serve.DiceServer`, and the other
families (``hybrid``, ``vlm``, ``audio``) are queued in ROADMAP.md A.12.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class ModelApi:
    init: Callable                         # (cfg, *, generator, dtype) -> params
    loss_fn: Callable                      # (params, batch, cfg) -> (loss, metrics)
    prefill: Callable                      # (params, batch, cfg) -> (logits, cache)
    decode_step: Callable                  # (params, batch, cache, cfg) -> (logits, cache)
    init_cache: Optional[Callable]         # (cfg, batch, max_len, device=) -> cache
    extra_inputs: tuple = ()               # stub modality inputs (name, shape_fn, dtype)


def get_model(cfg) -> ModelApi:
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import dense as m
        return ModelApi(
            init=m.init_lm,
            loss_fn=m.loss_fn,
            prefill=lambda p, b, c, **kw: m.prefill(p, b["tokens"], c, **kw),
            decode_step=lambda p, b, cache, c, **kw: m.decode_step(
                p, b["token"], cache, c, **kw),
            init_cache=m.init_cache,
        )
    if cfg.family == "ssm":
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
    raise NotImplementedError(
        f"family {cfg.family!r} has no model interface in the port yet "
        f"(DiT-MoE serving: repro_torch.launch.serve.DiceServer; other "
        f"families: ROADMAP.md A.12)")
