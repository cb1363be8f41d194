"""In-graph staleness telemetry (port of ``repro.obs.telemetry``).

One fixed-shape ``(NUM_FIELDS,)`` f32 vector per MoE layer and step, built
on the device from quantities the layer already computes; ``dit_forward``
stacks the layers' vectors into an ``(L, NUM_FIELDS)`` block, and the
serving loops copy that block to the host once per step.  With
``ObsConfig(enabled=False)`` (the default) nothing is computed and the
samples are bit-identical to a run without the subsystem.

Field semantics (per layer, per step):

  ``staleness_age``             the action's consumption staleness in steps
                                (sync 0, interweaved/staggered 1, displaced
                                2), stamped by
                                :func:`repro_torch.core.staleness.apply_layer_action`
  ``residual_energy_dispatch``  ``|x - c_base|^2 / |x|^2``, the relative
                                energy of the dispatch residual the codec
                                compresses; 0 on lossless steps
  ``residual_energy_combine``   ``|h_fresh - h_cache|^2 / |h_fresh|^2`` over
                                pairs sent fresh and kept, on steps that
                                lean on the cache (a mask or a codec)
  ``mask_rate``                 share of (token, rank) pairs sent fresh
                                (1.0 without a mask)
  ``dropped_frac``              capacity-drop share of dispatched pairs
  ``codec_error``               relative quantization error the codec put
                                on the wire this step (dispatch + combine);
                                exactly 0 on lossless steps

Ratios are over the rank's token shard; over an ep mesh ``dit_forward``
averages the block over the ranks in the same all-reduce as the aux's
other means, so every rank reports the shard mean.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

TELEMETRY_FIELDS = (
    "staleness_age",
    "residual_energy_dispatch",
    "residual_energy_combine",
    "mask_rate",
    "dropped_frac",
    "codec_error",
)
NUM_FIELDS = len(TELEMETRY_FIELDS)
AGE, RES_DISPATCH, RES_COMBINE, MASK_RATE, DROP_FRAC, CODEC_ERR = range(
    NUM_FIELDS)

_EPS = 1e-12


@dataclass(frozen=True)
class ObsConfig:
    """Observability gate.  ``enabled=False`` (the default) computes
    nothing; ``annotate`` also names each MoE layer's action with a
    ``torch.profiler.record_function`` range, so a profiler trace lines up
    with the plan's per-layer modes."""
    enabled: bool = False
    annotate: bool = True


def layer_telemetry(*, x, x_wire, dispatch_base, codec, pair_vals, recon,
                    pair_keep, fresh_mask, h_cache,
                    dropped_frac) -> torch.Tensor:
    """The (NUM_FIELDS,) f32 telemetry vector of one MoE layer forward, on
    the layer's device.  ``pair_vals`` are the combined pair values before
    the codec's reconstruction (fresh pairs carry the raw wire value) and
    ``recon`` the combine-path reconstruction (None when lossless).  The
    age slot is left 0 for the executor to stamp."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x32 = x.to(torch.float32)
    if codec is not None:
        base = torch.zeros_like(x32) if dispatch_base is None \
            else dispatch_base.to(torch.float32)
        den = torch.clamp_min(x32.square().sum(), _EPS)
        res_d = (x32 - base).square().sum() / den
        err_d = (x_wire.to(torch.float32) - x32).square().sum() / den
    else:
        res_d = err_d = zero
    res_c = err_c = zero
    if h_cache is not None and (fresh_mask is not None or codec is not None):
        fk = pair_keep if fresh_mask is None else (pair_keep & fresh_mask)
        w = fk[..., None].to(torch.float32)
        pv = pair_vals.to(torch.float32) * w
        den_c = torch.clamp_min(pv.square().sum(), _EPS)
        res_c = (pv - h_cache.to(torch.float32) * w).square().sum() / den_c
        if recon is not None:
            err_c = (recon.to(torch.float32) * w - pv).square().sum() / den_c
    mask_rate = (fresh_mask.to(torch.float32).mean()
                 if fresh_mask is not None else zero + 1.0)
    return torch.stack([zero, res_d, res_c, mask_rate,
                        dropped_frac.to(torch.float32), err_d + err_c])


def stamp_age(aux, action, obs: Optional[ObsConfig]):
    """Write the action's staleness age into an aux telemetry vector (a
    no-op when telemetry is off)."""
    if obs is None or not obs.enabled or aux.telemetry is None:
        return aux
    tel = aux.telemetry.clone()
    # fill_ takes the value as a kernel argument; ``tel[AGE] = value``
    # would copy it from the host and synchronise the stream (measured:
    # +13% s/step at DiT-MoE-XL, one synchronisation a layer)
    tel.narrow(0, AGE, 1).fill_(float(action.staleness))
    return aux._replace(telemetry=tel)


def scope(obs: Optional[ObsConfig], name: str):
    """A ``torch.profiler.record_function`` range when annotation is on,
    else a no-op context."""
    if obs is not None and obs.enabled and obs.annotate:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def merge_staggered(t0, t1):
    """Telemetry of a staggered layer's two half-batch calls: the fields
    average (equal halves)."""
    if t0 is None or t1 is None:
        return None
    return (t0 + t1) * 0.5
