"""Rectified Flow training and sampling for DiT-MoE (port of
``repro.sampling.rectified_flow``).

x_t = t * x1 + (1 - t) * x0 with x0 ~ N(0, I); the model predicts the
velocity v = x1 - x0, and sampling is Euler integration from t=0 to t=1.

``compile_step_plans`` buckets the run's steps into a few plan variants
(warmup-sync / refresh / light for DICE); the loop calls one per-step
function with the step's plan.  PyTorch runs eagerly, so there is no
compile cache: the step function records the ``(plan, slotted)`` keys it
ran, which is what a later CUDA-graph capture per key would hold.

Over a mesh (``mesh=``, from :func:`repro_torch.launch.mesh.make_mesh`)
every rank runs the same loop on its slice of the batch, of the image
tokens and of the experts: the counterpart of the reference's
``shard_map``-ped step over its ``dp x ep x patch`` mesh.  Without one,
``patch_parallel_ndev`` runs the DistriFusion baseline, the replicated
simulation of displaced patch parallelism.  A paging config over an ep
mesh of more than one rank serves the routed experts from a host pool
(:mod:`repro_torch.core.paging`) that the sampler builds from the params
(or is given) and strips from them.

Training (``rf_loss``, ``rf_train_step``) takes the reference's three
random draws (``t``, ``x0`` and the class-drop mask) as inputs, since JAX
PRNG keys cannot be replayed in torch: the tests hand over the
reference's, the port's own runs draw them with :func:`rf_draws` from a
``torch.Generator``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import unflatten
from repro_torch.common import sharding as shard_lib
from repro_torch.core import paging as paging_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.patch_parallel import PatchParallelState
from repro_torch.launch.mesh import axis_size as mesh_axis
from repro_torch.core.moe import refuse_router_jitter
from repro_torch.models.dit_moe import dit_forward, dit_train_forward
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     cosine_schedule, tree_leaves, tree_map)
from repro_torch.resilience import faults as fault_lib


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
CFG_DROP_PROB = 0.1          # class dropout for classifier-free guidance


def rf_draws(generator: torch.Generator, batch: int, shape,
             device=None) -> dict:
    """The three random inputs of :func:`rf_loss`, drawn from
    ``generator`` as the reference draws them: ``t`` (batch,) ~ U[0, 1),
    ``x0`` of ``shape`` ~ N(0, I) and ``drop`` (batch,) bools that are
    True with probability 0.1; on ``device`` (the generator's unless
    given)."""
    kw = dict(generator=generator, device=generator.device)
    t = torch.rand((batch,), **kw)
    x0 = torch.randn(tuple(shape), **kw)
    drop = torch.rand((batch,), **kw) < CFG_DROP_PROB
    return {k: v.to(device) if device is not None else v
            for k, v in (("t", t), ("x0", x0), ("drop", drop))}


def rf_loss(params, batch, cfg, *, t: torch.Tensor, x0: torch.Tensor,
            drop: torch.Tensor, lb_weight: float = 0.01):
    """Rectified-flow loss on ``batch`` ({latents (B, T, C), classes
    (B,)}): the velocity MSE plus ``lb_weight`` times the load-balance
    loss; a ``drop`` row trains the null class.  Returns (loss,
    {mse, lb})."""
    x1, y = batch["latents"], batch["classes"]
    xt = t[:, None, None] * x1 + (1 - t)[:, None, None] * x0
    y_in = torch.where(drop, torch.full_like(y, cfg.num_classes), y)
    v, aux = dit_train_forward(params, xt, t, y_in, cfg)
    mse = torch.mean(torch.square(v - (x1 - x0)))
    return mse + lb_weight * aux["lb_loss"], {"mse": mse, "lb": aux["lb_loss"]}


def rf_train_step(params, opt_state, batch, cfg, *, draws: dict):
    """One training step, as the reference's: the gradients of
    :func:`rf_loss` (``draws`` from :func:`rf_draws` or the reference),
    clipped to global norm 1.0, and AdamW at ``cosine_schedule(step,
    base_lr=1e-3, warmup=20, total=2000)``.  ``params`` and the moments
    are updated in place; the metrics (``loss``, ``mse``, ``lb``,
    ``grad_norm``, ``lr``) stay 0-d device tensors, so the step never
    waits for the card.  Returns (params, opt_state, metrics)."""
    rng = torch.profiler.record_function   # named ranges for profile_train
    with torch.enable_grad():
        # leaves that require grad, sharing the params' storage; the
        # params themselves stay plain tensors, so serving from them
        # later takes the kernels' no-grad path
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with rng("rf_train_step.forward"):
            loss, metrics = rf_loss(live, batch, cfg, **draws)
        leaves = tree_leaves(live)
        with rng("rf_train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with rng("rf_train_step.optimizer"):
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for g, p in zip(grads, leaves)])
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state.step, base_lr=1e-3, warmup=20,
                             total=2000)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
    return params, opt_state, metrics


def _euler_step(params, cfg, x, classes, states, states_u, t, *,
                plan, dt: float, guidance: float,
                generator: Optional[torch.Generator] = None,
                slot_fresh: Optional[torch.Tensor] = None,
                consume_mask: Optional[torch.Tensor] = None,
                mesh=None, hop_schedule=None, obs=None, resilience=None,
                tick: Optional[int] = None, patch_states=None,
                patch_states_u=None, patch_parallel_ndev: int = 0,
                patch_compose: bool = False, patch_fresh=None,
                expert_pool=None):
    """One CFG-guided Euler step: a conditional and a null-class
    ``dit_forward`` pass, each with its own staleness state and patch
    K/V state, and both with the same per-slot selectors.  ``obs``
    instruments the conditional pass only (the other's aux is dropped);
    ``resilience`` runs in both, each pass drawing its corruption masks
    from ``(tick, pass, rank)``.  Returns (x_next, new_states,
    new_states_u, new_patch_states, new_patch_states_u, aux of the
    conditional pass)."""
    kw = dict(plan=plan, generator=generator, slot_fresh=slot_fresh,
              consume_mask=consume_mask, mesh=mesh,
              hop_schedule=hop_schedule, resilience=resilience,
              patch_parallel_ndev=patch_parallel_ndev,
              patch_compose=patch_compose, patch_fresh=patch_fresh,
              expert_pool=expert_pool)

    def key(pass_):
        if resilience is None or resilience.faults is None or tick is None:
            return None
        return fault_lib.fault_key(tick, pass_,
                                   None if mesh is None else mesh.rank)

    v_c, ns, nps, aux = dit_forward(params, x, t, classes, cfg, states,
                                    obs=obs, fault_key=key(0),
                                    patch_states=patch_states, **kw)
    if guidance != 1.0:
        null = torch.full_like(classes, cfg.num_classes)
        v_u, nsu, npsu, _ = dit_forward(params, x, t, null, cfg, states_u,
                                        fault_key=key(1),
                                        patch_states=patch_states_u, **kw)
        v = v_u + guidance * (v_c - v_u)
    else:
        v, nsu, npsu = v_c, states_u, patch_states_u
    return x + dt * v, ns, nsu, nps, npsu, aux


class RFStep:
    """The per-step function behind :func:`rf_sample` and the continuous
    serving engine::

        rf_step(x, classes, states, states_u, t, *, plan, slotted=False,
                slot_fresh=None, consume_mask=None, generator=None,
                tick=None, patch_states=None, patch_states_u=None,
                patch_fresh=None)
            -> (x_next, states, states_u, patch_states, patch_states_u, aux)

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
    the states and the selectors hold its rows (and its patch's tokens),
    and ``params`` are sharded here
    (:func:`~repro_torch.common.sharding.ep_shard_params`), then, for
    ``placements``, re-laid-out over the rank's ep group
    (:func:`~repro_torch.common.sharding.place_experts`).  The ring runs
    its hops in ``hop_schedule``'s order.  ``patch_parallel_ndev`` /
    ``patch_compose`` select the replicated patch simulation (no mesh);
    on a patch mesh ``patch_fresh`` selects all-fresh K/V rows.

    ``obs`` and ``resilience`` are fixed for the function's life, as the
    reference's closure constants: an enabled ``obs`` adds
    ``aux["telemetry"]``, a resilience config ``aux["fault_events"]``, and
    ``tick`` seeds the step's corruption masks.

    ``expert_pool`` (:class:`~repro_torch.core.paging.ExpertPool`, over an
    ep axis of more than one rank) serves the routed experts of a plan
    that pages: the params lose their expert stacks before they are
    sharded, so the experts need not divide over the mesh.
    """

    def __init__(self, params, cfg, *, dt: float, guidance: float = 1.5,
                 mesh=None, obs=None, resilience=None, placements=None,
                 hop_schedule=None, patch_parallel_ndev: int = 0,
                 patch_compose: bool = False, expert_pool=None):
        refuse_router_jitter(cfg)
        self.expert_pool = expert_pool
        if expert_pool is not None:
            if mesh_axis(mesh, "ep") <= 1:
                raise ValueError("expert paging needs an ep mesh of more "
                                 "than one rank")
            params = paging_lib.strip_expert_params(params)
        if mesh is not None:
            if patch_parallel_ndev:
                raise ValueError("the replicated patch-parallel simulation "
                                 "does not run over a mesh; build the mesh "
                                 "with a 'patch' axis instead")
            if self.expert_pool is None:
                shard_lib.expert_slice(cfg.num_experts, mesh)  # E % n check
            shard_lib.local_tokens(cfg.patch_tokens, mesh)  # T % patch
            params = shard_lib.ep_shard_params(params, mesh)
            if placements is not None:
                params = shard_lib.place_experts(params, placements, mesh)
        self.params, self.cfg = params, cfg
        self.dt, self.guidance = dt, guidance
        self.mesh = mesh
        self.hop_schedule = hop_schedule
        self.patch = dict(patch_parallel_ndev=patch_parallel_ndev,
                          patch_compose=patch_compose)
        self.obs, self.resilience = obs, resilience
        self.keys = set()

    def __call__(self, x, classes, states, states_u, t, *, plan,
                 slotted: bool = False,
                 slot_fresh: Optional[torch.Tensor] = None,
                 consume_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 tick: Optional[int] = None, patch_states=None,
                 patch_states_u=None, patch_fresh=None):
        self.keys.add((plan, bool(slotted)))
        return _euler_step(self.params, self.cfg, x, classes, states,
                           states_u, t, plan=plan, dt=self.dt,
                           guidance=self.guidance, generator=generator,
                           slot_fresh=slot_fresh if slotted else None,
                           consume_mask=consume_mask if slotted else None,
                           mesh=self.mesh, hop_schedule=self.hop_schedule,
                           obs=self.obs, resilience=self.resilience,
                           tick=tick, patch_states=patch_states,
                           patch_states_u=patch_states_u,
                           patch_fresh=patch_fresh,
                           expert_pool=self.expert_pool, **self.patch)


def make_rf_step(params, cfg, *, dt: float, guidance: float = 1.5,
                 mesh=None, obs=None, resilience=None, placements=None,
                 hop_schedule=None, patch_parallel_ndev: int = 0,
                 patch_compose: bool = False,
                 expert_pool=None) -> RFStep:
    """The per-step function behind :func:`rf_sample` (see :class:`RFStep`).
    Raises for ``cfg.router_jitter > 0`` (JAX PRNG keys cannot be replayed
    in torch) and, with ``mesh``, for experts (unless paged) or image
    tokens that do not divide over it."""
    return RFStep(params, cfg, dt=dt, guidance=guidance, mesh=mesh, obs=obs,
                  resilience=resilience, placements=placements,
                  hop_schedule=hop_schedule,
                  patch_parallel_ndev=patch_parallel_ndev,
                  patch_compose=patch_compose, expert_pool=expert_pool)


def make_sample_step(params, cfg, dcfg, classes, *, dt: float,
                     guidance: float = 1.5, patch_parallel_ndev: int = 0,
                     mesh=None, patch_compose: bool = False,
                     hop_schedule=None, expert_pool=None, obs=None):
    """One Euler step with ``classes`` bound: the whole-loop sampler's
    view of :class:`RFStep`::

        one_step(x, states, states_u, patch_states, patch_states_u, t, *,
                 plan, patch_fresh=None, generator=None, tick=None)
            -> (x_next, states, states_u, patch_states, patch_states_u, aux)

    ``one_step._cache_size()`` counts the distinct ``(plan, slotted)`` keys
    it has run, the counterpart of the reference's jit cache size: equal
    plans, however many step indices map to them, share one key.  With a
    ``mesh`` ``classes`` are the global ones and the step keeps its lane's
    rows; ``dcfg``'s placements lay out the experts and its ring schedule
    and resilience apply as in :func:`rf_sample`."""
    classes = torch.as_tensor(classes)
    n_ep = mesh_axis(mesh, "ep")
    if mesh is not None:
        classes = shard_lib.hier_place_batch(classes, mesh)
    rf_step = make_rf_step(
        params, cfg, dt=dt, guidance=guidance, mesh=mesh, obs=obs,
        resilience=fault_lib.resilience_of(dcfg),
        placements=plan_lib.placements_of(plan_lib.normalize_placement(dcfg, n_ep)),
        hop_schedule=plan_lib.normalize_hop_schedule(hop_schedule, n_ep),
        patch_parallel_ndev=patch_parallel_ndev, patch_compose=patch_compose,
        expert_pool=expert_pool)

    def one_step(x, states, states_u, patch_states, patch_states_u, t, *,
                 plan, patch_fresh=None, generator=None, tick=None):
        return rf_step(x, classes, states, states_u, t, plan=plan,
                       patch_states=patch_states, patch_states_u=patch_states_u,
                       patch_fresh=patch_fresh, generator=generator, tick=tick)

    one_step._cache_size = lambda: len(rf_step.keys)
    return one_step


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
              guidance: float = 1.5, mesh=None, obs=None,
              patch_parallel_ndev: int = 0, patch_compose: bool = False,
              hop_schedule=None, params_placed: bool = False,
              expert_pool=None):
    """Generate latents (B, T, C) for ``classes`` under a schedule.

    The initial noise is ``noise`` when given (the tests pass the JAX
    reference's), else drawn from ``generator``; one of the two is
    required.  Everything runs on the device of ``classes``, or on the
    mesh's.  Returns (samples, stats): per-step dispatch / raw / buffer
    bytes, ring hops and hop bytes, drop fractions, ``num_plan_variants``
    and ``step_keys`` (distinct step keys run).

    ``patch_parallel_ndev`` (no mesh) runs DistriFusion's displaced patch
    attention over that many simulated devices: with the MoE run locally
    and fresh (the reference benchmark's ``distrifusion`` baseline under
    ``DiceConfig.sync_ep()``), or with ``patch_compose`` composed with the
    schedule's MoE path.  Conditional and unconditional passes keep their
    own K/V buffers, which ``buffer_bytes`` counts.

    With a ``mesh`` every rank calls this with the same global ``classes``
    and noise and keeps its block of both: its lane's batch rows
    (``dp x ep``) and its patch's tokens
    (:func:`~repro_torch.common.sharding.hier_place_tokens`); the batch
    must divide over the lanes.  ``dispatch_bytes`` is then the per-rank
    wire payload, ``buffer_bytes`` the whole mesh's, and the samples are
    gathered back to every rank.  ``dcfg.placements`` lay out the experts
    over the ep groups (dropped without an ep axis of more than one rank),
    from ``params`` in the original layout unless ``params_placed`` says
    they are laid out already (:meth:`DiceServer.params_for` keeps them);
    ``hop_schedule`` orders the ring's hops.  On a patch axis each step
    tells the attention which rows take all-fresh K/V (step 0 and warm-up
    steps).  A "random" policy draws each rank's masks from a generator
    seeded from (``generator``'s seed, world rank).

    An enabled ``obs`` also records, per step, the wall time until its
    (L, NUM_FIELDS) telemetry block reached the host in one copy, and the
    block (``stats["step_wall_s"]``, ``stats["telemetry"]``); the samples
    are bit-identical to an obs-off run.
    ``dcfg.resilience`` adds ``stats["fault_events"]``, the counts summed
    over steps (conditional pass).  Step ``s`` draws its corruption masks
    from ``(s, pass, rank)``.

    ``dcfg.paging`` over an ep axis of more than one rank (dropped
    elsewhere, so the samples are the resident ones) serves the experts
    from ``expert_pool``, built from ``params`` when not given (this rank's
    rows, pinned on a card); the auto budget resolves against it, every
    planned residency window is checked against the budget before the
    first step, and the pool's counts start from 0.  ``stats`` then holds
    ``paged_transfers``, ``paged_bytes_in`` (summed over the ep ranks),
    ``peak_resident_expert_bytes`` (their max) and ``expert_hbm_budget``:
    the reference's single pool's numbers.
    """
    device = classes.device if mesh is None else mesh.device
    B = classes.shape[0]
    n_ep = mesh_axis(mesh, "ep")
    dcfg = plan_lib.normalize_overlap(dcfg, n_ep)
    dcfg = plan_lib.normalize_placement(dcfg, n_ep)
    dcfg = plan_lib.normalize_paging(dcfg, n_ep)
    if paging_lib.paging_of(dcfg) is None:
        expert_pool = None
    else:
        if expert_pool is None:
            if not paging_lib.has_expert_leaves(params):
                raise ValueError("paging is planned but params carry no "
                                 "expert leaves and no expert_pool was "
                                 "provided")
            expert_pool = paging_lib.pool_from_params(
                params, n_dev=n_ep, rank=mesh.rank_in("ep"), device=device)
        dcfg = paging_lib.resolve_budget(dcfg, expert_pool)
        expert_pool.reset_stats()
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
    sharded_patch = mesh is not None and "patch" in mesh.axis_names
    if mesh is not None:
        classes = shard_lib.hier_place_batch(classes, mesh)  # B % lanes
        x = shard_lib.hier_place_tokens(x, mesh)
        generator = rank_generator(generator, mesh)
    rf_step = make_rf_step(
        params, cfg, dt=1.0 / num_steps, guidance=guidance, mesh=mesh,
        obs=obs, resilience=res,
        placements=None if params_placed else plan_lib.placements_of(dcfg),
        hop_schedule=plan_lib.normalize_hop_schedule(hop_schedule, n_ep),
        patch_parallel_ndev=patch_parallel_ndev, patch_compose=patch_compose,
        expert_pool=expert_pool)
    B_loc, T_loc = x.shape[0], x.shape[1]
    dt = 1.0 / num_steps
    splan = plan_lib.compile_step_plans(
        dcfg, cfg.num_layers, num_steps,
        experts_per_token=cfg.experts_per_token)
    pool = rf_step.expert_pool
    if pool is not None:
        # every planned residency window must fit the budget: fail here,
        # before the first step
        pool.validate_plan(splan)
        pool.begin_run(paging_lib.paging_of(dcfg).depth)

    def planned_init():
        return stale_lib.init_planned_states(
            splan, num_tokens=B_loc * T_loc, d_model=cfg.d_model,
            k=cfg.experts_per_token, dtype=x.dtype, device=device)

    def patch_init():
        # full-sequence K/V per rank (DistriFusion's memory cost), zeros
        # that no row reads before patch_fresh stops selecting fresh K/V
        if not sharded_patch:
            return {}
        shape = (B_loc, cfg.patch_tokens, cfg.num_kv_heads, cfg.head_dim)
        return {i: PatchParallelState(
            k_prev=torch.zeros(shape, dtype=x.dtype, device=device),
            v_prev=torch.zeros(shape, dtype=x.dtype, device=device))
            for i in range(cfg.num_layers)}

    states, states_u = planned_init(), planned_init()
    pstates, pstates_u = patch_init(), patch_init()
    stats = {"dispatch_bytes": [], "raw_bytes": [], "buffer_bytes": [],
             "hops": [], "hop_bytes": [], "dropped_frac": []}
    if obs_on:
        stats["telemetry"], stats["step_wall_s"] = [], []
    fe_sum = None
    for s in range(num_steps):
        t = torch.full((B_loc,), s * dt, dtype=torch.float32, device=device)
        pf = None
        if sharded_patch:
            pf = torch.full((B_loc,), s == 0 or splan.steps[s].is_warmup,
                            dtype=torch.bool, device=device)
        t0 = time.perf_counter()
        x, states, states_u, pstates, pstates_u, aux = rf_step(
            x, classes, states, states_u, t, plan=splan.steps[s],
            generator=generator, tick=s, patch_states=pstates,
            patch_states_u=pstates_u, patch_fresh=pf)
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
    if pool is not None:
        tot = paging_lib.ledger_totals(pool, mesh.ep_mesh)
        stats["paged_transfers"] = tot["transfers"]
        stats["paged_bytes_in"] = tot["bytes_transferred"]
        stats["peak_resident_expert_bytes"] = tot["peak_resident_bytes"]
        stats["expert_hbm_budget"] = paging_lib.paging_of(dcfg).budget_bytes
    if mesh is not None:
        x = mesh.gather_samples(x)
    return x, stats
