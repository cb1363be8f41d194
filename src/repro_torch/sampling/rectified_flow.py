"""Rectified Flow sampling for DiT-MoE (port of the sampling half of
``repro.sampling.rectified_flow``, single device).

x_t = t * x1 + (1 - t) * x0 with x0 ~ N(0, I); the model predicts the
velocity v = x1 - x0, and sampling is Euler integration from t=0 to t=1.
``compile_step_plans`` buckets the run's steps into a few plan variants
(warmup-sync / refresh / light for DICE); the loop calls one per-step
function with the step's plan.  PyTorch runs eagerly, so there is no
compile cache: ``num_plan_variants`` is what a later CUDA-graph capture
per variant would hold.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.models.dit_moe import dit_forward


def _euler_step(params, cfg, x, classes, states, states_u, t, *,
                plan, dt: float, guidance: float,
                generator: Optional[torch.Generator] = None):
    """One CFG-guided Euler step: a conditional and a null-class
    ``dit_forward`` pass, each with its own staleness state.  Returns
    (x_next, new_states, new_states_u, aux of the conditional pass)."""
    v_c, ns, aux = dit_forward(params, x, t, classes, cfg, states,
                               plan=plan, generator=generator)
    if guidance != 1.0:
        null = torch.full_like(classes, cfg.num_classes)
        v_u, nsu, _ = dit_forward(params, x, t, null, cfg, states_u,
                                  plan=plan, generator=generator)
        v = v_u + guidance * (v_c - v_u)
    else:
        v, nsu = v_c, states_u
    return x + dt * v, ns, nsu, aux


def make_rf_step(params, cfg, *, dt: float, guidance: float = 1.5):
    """The per-step function behind :func:`rf_sample`::

        rf_step(x, classes, states, states_u, t, *, plan, generator=None)
            -> (x_next, states, states_u, aux)
    """
    def rf_step(x, classes, states, states_u, t, *, plan, generator=None):
        return _euler_step(params, cfg, x, classes, states, states_u,
                           t, plan=plan, dt=dt, guidance=guidance,
                           generator=generator)
    return rf_step


def rf_sample(params, cfg, dcfg, *, num_steps: int, classes: torch.Tensor,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              guidance: float = 1.5):
    """Generate latents (B, T, C) for ``classes`` under a schedule.

    The initial noise is ``noise`` when given (the tests pass the JAX
    reference's), else drawn from ``generator``; one of the two is
    required.  Everything runs on the device of ``classes``.  Returns
    (samples, stats): per-step dispatch / raw / buffer bytes and
    ``num_plan_variants``.
    """
    device = classes.device
    B = classes.shape[0]
    dcfg = plan_lib.normalize_overlap(dcfg, 1)
    if noise is not None:
        x = noise.to(device=device, dtype=torch.float32)
    elif generator is not None:
        x = torch.randn((B, cfg.patch_tokens, cfg.in_channels),
                        generator=generator, device=generator.device,
                        dtype=torch.float32).to(device)
    else:
        raise ValueError("rf_sample needs noise= or generator=")
    dt = 1.0 / num_steps
    splan = plan_lib.compile_step_plans(
        dcfg, cfg.num_layers, num_steps,
        experts_per_token=cfg.experts_per_token)

    def planned_init():
        return stale_lib.init_planned_states(
            splan, num_tokens=B * cfg.patch_tokens, d_model=cfg.d_model,
            k=cfg.experts_per_token, dtype=x.dtype, device=device)

    states = planned_init()
    states_u = planned_init()
    stats = {"dispatch_bytes": [], "raw_bytes": [], "buffer_bytes": []}
    rf_step = make_rf_step(params, cfg, dt=dt, guidance=guidance)
    for s in range(num_steps):
        t = torch.full((B,), s * dt, dtype=torch.float32, device=device)
        x, states, states_u, aux = rf_step(x, classes, states, states_u, t,
                                           plan=splan.steps[s],
                                           generator=generator)
        stats["dispatch_bytes"].append(float(aux["dispatch_bytes"]))
        stats["raw_bytes"].append(float(aux["raw_dispatch_bytes"]))
        stats["buffer_bytes"].append(float(aux["buffer_bytes"]))
    stats["num_plan_variants"] = splan.num_variants
    return x, stats
