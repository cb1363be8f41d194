"""Rectified Flow sampling for DiT-MoE (port of the sampling half of
``repro.sampling.rectified_flow``).

x_t = t * x1 + (1 - t) * x0 with x0 ~ N(0, I); the model predicts the
velocity v = x1 - x0, and sampling is Euler integration from t=0 to t=1.
``compile_step_plans`` buckets the run's steps into a few plan variants
(warmup-sync / refresh / light for DICE); the loop calls one per-step
function with the step's plan.  PyTorch runs eagerly, so there is no
compile cache: the step function records the ``(plan, slotted)`` keys it
ran, which is what a later CUDA-graph capture per key would hold.

Over an expert-parallel mesh (``mesh=``, an
:class:`~repro_torch.launch.mesh.EPMesh`) every rank runs the same loop on
its slice of the batch and of the experts: the counterpart of the
reference's ``shard_map``-ped step over ``make_ep_mesh(n)``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.common import sharding as shard_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.moe import refuse_router_jitter
from repro_torch.models.dit_moe import dit_forward
from repro_torch.resilience import faults as fault_lib


def _euler_step(params, cfg, x, classes, states, states_u, t, *,
                plan, dt: float, guidance: float,
                generator: Optional[torch.Generator] = None,
                slot_fresh: Optional[torch.Tensor] = None,
                consume_mask: Optional[torch.Tensor] = None,
                mesh=None, obs=None, resilience=None,
                tick: Optional[int] = None):
    """One CFG-guided Euler step: a conditional and a null-class
    ``dit_forward`` pass, each with its own staleness state and both with
    the same per-slot selectors.  ``obs`` instruments the conditional pass
    only (the other's aux is dropped); ``resilience`` runs in both, each
    pass drawing its corruption masks from ``(tick, pass, rank)``.
    Returns (x_next, new_states, new_states_u, aux of the conditional
    pass)."""
    kw = dict(plan=plan, generator=generator, slot_fresh=slot_fresh,
              consume_mask=consume_mask, mesh=mesh, resilience=resilience)

    def key(pass_):
        if resilience is None or resilience.faults is None or tick is None:
            return None
        return fault_lib.fault_key(tick, pass_,
                                   None if mesh is None else mesh.rank)

    v_c, ns, aux = dit_forward(params, x, t, classes, cfg, states, obs=obs,
                               fault_key=key(0), **kw)
    if guidance != 1.0:
        null = torch.full_like(classes, cfg.num_classes)
        v_u, nsu, _ = dit_forward(params, x, t, null, cfg, states_u,
                                  fault_key=key(1), **kw)
        v = v_u + guidance * (v_c - v_u)
    else:
        v, nsu = v_c, states_u
    return x + dt * v, ns, nsu, aux


class RFStep:
    """The per-step function behind :func:`rf_sample` and the continuous
    serving engine::

        rf_step(x, classes, states, states_u, t, *, plan, slotted=False,
                slot_fresh=None, consume_mask=None, generator=None,
                tick=None)
            -> (x_next, states, states_u, aux)

    ``slotted=True`` is the continuous engine's mixed warmup/steady tick:
    ``slot_fresh`` (B*T,) marks tokens of slots replaying warmup and
    ``consume_mask`` (B*T, K) carries each slot's conditional-
    communication mask; both are ignored when ``slotted`` is False.

    ``keys`` holds every distinct ``(plan, slotted)`` pair the function
    has run: the counterpart of the reference's jit cache, and what one
    CUDA graph per key would hold.  Every warmup mixture shares one key,
    so ``len(keys)`` stays at the plan-variant count, on every rank of a
    mesh too.

    With ``mesh`` the step runs on this rank's shard: ``x``, ``classes``,
    the states and the selectors hold its rows, and ``params`` are
    sharded here (:func:`~repro_torch.common.sharding.ep_shard_params`).

    ``obs`` and ``resilience`` are fixed for the function's life, as the
    reference's closure constants: an enabled ``obs`` adds
    ``aux["telemetry"]``, a resilience config ``aux["fault_events"]``, and
    ``tick`` seeds the step's corruption masks.
    """

    def __init__(self, params, cfg, *, dt: float, guidance: float = 1.5,
                 mesh=None, obs=None, resilience=None):
        refuse_router_jitter(cfg)
        if mesh is not None:
            shard_lib.expert_slice(cfg.num_experts, mesh)    # E % n check
            params = shard_lib.ep_shard_params(params, mesh)
        self.params, self.cfg = params, cfg
        self.dt, self.guidance = dt, guidance
        self.mesh = mesh
        self.obs, self.resilience = obs, resilience
        self.keys = set()

    def __call__(self, x, classes, states, states_u, t, *, plan,
                 slotted: bool = False,
                 slot_fresh: Optional[torch.Tensor] = None,
                 consume_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 tick: Optional[int] = None):
        self.keys.add((plan, bool(slotted)))
        return _euler_step(self.params, self.cfg, x, classes, states,
                           states_u, t, plan=plan, dt=self.dt,
                           guidance=self.guidance, generator=generator,
                           slot_fresh=slot_fresh if slotted else None,
                           consume_mask=consume_mask if slotted else None,
                           mesh=self.mesh, obs=self.obs,
                           resilience=self.resilience, tick=tick)


def make_rf_step(params, cfg, *, dt: float, guidance: float = 1.5,
                 mesh=None, obs=None, resilience=None) -> RFStep:
    """The per-step function behind :func:`rf_sample` (see :class:`RFStep`).
    Raises for ``cfg.router_jitter > 0`` (JAX PRNG keys cannot be replayed
    in torch) and, with ``mesh``, for experts that do not divide over it."""
    return RFStep(params, cfg, dt=dt, guidance=guidance, mesh=mesh, obs=obs,
                  resilience=resilience)


def rank_generator(generator: Optional[torch.Generator], mesh
                   ) -> Optional[torch.Generator]:
    """The "random" policy's generator on a rank: over a mesh, one seeded
    from (the caller's seed, rank), so each token shard draws its own mask
    as the reference's ``fold_in(key, axis_index)`` does; else the
    caller's."""
    if generator is None or mesh is None:
        return generator
    return torch.Generator(device=generator.device).manual_seed(
        fold_seed(generator.initial_seed(), mesh.rank))


def fold_seed(seed: int, n: int) -> int:
    """One generator seed for the pair ``(seed, n)``, hashed to 32 bits
    (the CPU generator keeps only the low 32 bits of a seed)."""
    return int(np.random.SeedSequence([seed, n & 0xFFFFFFFF])
               .generate_state(1)[0])


def rf_sample(params, cfg, dcfg, *, num_steps: int, classes: torch.Tensor,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              guidance: float = 1.5, mesh=None, obs=None):
    """Generate latents (B, T, C) for ``classes`` under a schedule.

    The initial noise is ``noise`` when given (the tests pass the JAX
    reference's), else drawn from ``generator``; one of the two is
    required.  Everything runs on the device of ``classes``, or on the
    mesh's.  Returns (samples, stats): per-step dispatch / raw / buffer
    bytes, ring hops and hop bytes, drop fractions, ``num_plan_variants``
    and ``step_keys`` (distinct step keys run).

    With an ep ``mesh`` every rank calls this with the same global
    ``classes`` and noise and keeps its rows of both
    (:func:`~repro_torch.common.sharding.ep_place_batch`); the batch must
    divide over the mesh.  ``dispatch_bytes`` is then the per-rank wire
    payload, ``buffer_bytes`` the whole mesh's, and the samples are
    gathered back to every rank.  A "random" policy draws each rank's
    masks from a generator seeded from (``generator``'s seed, rank).

    An enabled ``obs`` also records, per step, the wall time until its
    (L, NUM_FIELDS) telemetry block reached the host in one copy, and the
    block (``stats["step_wall_s"]``, ``stats["telemetry"]``); the samples
    are bit-identical to an obs-off run.
    ``dcfg.resilience`` adds ``stats["fault_events"]``, the counts summed
    over steps (conditional pass).  Step ``s`` draws its corruption masks
    from ``(s, pass, rank)``.
    """
    device = classes.device if mesh is None else mesh.device
    B = classes.shape[0]
    n_ep = mesh.size if mesh is not None else 1
    if B % n_ep:
        raise ValueError(f"batch {B} must divide over the {n_ep}-way 'ep' "
                         f"mesh axis")
    dcfg = plan_lib.normalize_overlap(dcfg, n_ep)
    if noise is not None:
        x = noise.to(device=device, dtype=torch.float32)
    elif generator is not None:
        x = torch.randn((B, cfg.patch_tokens, cfg.in_channels),
                        generator=generator, device=generator.device,
                        dtype=torch.float32).to(device)
    else:
        raise ValueError("rf_sample needs noise= or generator=")
    obs_on = obs is not None and obs.enabled
    res = fault_lib.resilience_of(dcfg)
    rf_step = make_rf_step(params, cfg, dt=1.0 / num_steps,
                           guidance=guidance, mesh=mesh, obs=obs,
                           resilience=res)
    if mesh is not None:
        x = shard_lib.ep_place_batch(x, mesh)
        classes = shard_lib.ep_place_batch(classes, mesh)
        generator = rank_generator(generator, mesh)
    B_loc = x.shape[0]
    dt = 1.0 / num_steps
    splan = plan_lib.compile_step_plans(
        dcfg, cfg.num_layers, num_steps,
        experts_per_token=cfg.experts_per_token)

    def planned_init():
        return stale_lib.init_planned_states(
            splan, num_tokens=B_loc * cfg.patch_tokens, d_model=cfg.d_model,
            k=cfg.experts_per_token, dtype=x.dtype, device=device)

    states = planned_init()
    states_u = planned_init()
    stats = {"dispatch_bytes": [], "raw_bytes": [], "buffer_bytes": [],
             "hops": [], "hop_bytes": [], "dropped_frac": []}
    if obs_on:
        stats["telemetry"], stats["step_wall_s"] = [], []
    fe_sum = None
    for s in range(num_steps):
        t = torch.full((B_loc,), s * dt, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        x, states, states_u, aux = rf_step(x, classes, states, states_u, t,
                                           plan=splan.steps[s],
                                           generator=generator, tick=s)
        if obs_on:
            tel = aux["telemetry"].to("cpu").numpy()   # waits for the step
            stats["step_wall_s"].append(time.perf_counter() - t0)
            stats["telemetry"].append(tel)
        if res is not None:                  # summed on the device
            fe = aux["fault_events"]
            fe_sum = fe if fe_sum is None else fe_sum + fe
        stats["dispatch_bytes"].append(float(aux["dispatch_bytes"]))
        stats["raw_bytes"].append(float(aux["raw_dispatch_bytes"]))
        stats["buffer_bytes"].append(float(aux["buffer_bytes"]))
        stats["hops"].append(int(aux["hops"]))
        stats["hop_bytes"].append(float(aux["hop_bytes"]))
        stats["dropped_frac"].append(aux["dropped_frac"])
    stats["dropped_frac"] = [float(f) for f in stats["dropped_frac"]]
    if res is not None:
        stats["fault_events"] = (
            np.zeros(fault_lib.NUM_FAULT_EVENTS) if fe_sum is None
            else fe_sum.to("cpu").numpy().astype(np.float64))
    stats["num_plan_variants"] = splan.num_variants
    stats["step_keys"] = len(rf_step.keys)
    if mesh is not None:
        x = mesh.all_gather(x)
    return x, stats
