"""DICE serving engine (port of ``repro.launch.serve``).

Serves class-conditional DiT-MoE generation requests under a selectable
parallelism schedule, in three ways: one fixed batch
(:meth:`DiceServer.generate`), rigid FIFO batches (:func:`serve_queue`),
and continuous batching (:func:`serve_continuous`), where each batch slot
steps and completes on its own and freed slots are recycled mid-flight
with their staleness rows reset.  Besides the samples it reports the
per-step dispatch payload, the persistent staleness-buffer bytes, the
wall time measured on the device and how often each hand-written kernel
was launched.  It also reports the modeled step latency of the paper's
deployment (8 x RTX 4090 over PCIe, ``PAPER_HW``): a model computed from
roofline terms, not a measurement, and named ``..._paper8``.

  PYTHONPATH=src python -m repro_torch.launch.serve --schedule dice \\
      --requests 8 --steps 10 --no-tiny --codec int8_residual
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --max-batch 8 --requests 24 --steps 10 --no-tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --ep 2 --backend gloo \\
      --overlap ring --requests 8 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.serve --ep 2 --dp 2 --patch 2 \\
      --backend gloo --device cpu --requests 8 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --ep 2 --backend gloo \\
      --continuous --placement greedy --replicate-top 1 --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --obs \\
      --continuous --max-batch 2 --requests 3 --faults seed=7,poison_tick=2
  PYTHONPATH=src python -m repro_torch.launch.serve --ep 4 --backend gloo \\
      --device cpu --paging on --faults paging_err=0.3 --requests 4

With a mesh (``DiceServer(mesh=...)``, or ``--ep N --dp D --patch P``,
which spawn ``D x N x P`` ranks) every engine runs over it: one process per
rank, each holding its slice of the batch (over ``dp x ep``), of the image
tokens (over ``patch``: ``generate`` only) and of the experts (over
``ep``), with the dispatch and combine exchanges as all-to-alls or as the
ring (``overlap``), whose hops follow the host topology
(``devices_per_host``).  ``nccl`` needs a card per rank; ``gloo`` runs on
the CPU or with ranks sharing one card.  A placement config
(``--placement greedy``) makes :func:`serve_continuous` re-lay-out the
experts when the routing histogram drifts.

``obs`` adds the per-layer staleness telemetry and measured step wall
times to the registry; ``resilience`` (``--faults``) the seeded wire
faults, the guards and the ladder of :func:`serve_continuous` (watchdog
demotion, quarantine, bounded admission, and with paging the fetch
retries and the stale fallback); ``--ckpt`` serves weights from a
checkpoint file in the reference's format.  ``--paging on`` over an ep
mesh keeps each rank's routed experts in a pinned host pool and fetches
one layer's shard ahead of use (:mod:`repro_torch.core.paging`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common import sharding as shard_lib
from repro_torch.common.device import resolve_device
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.compress.codecs import CODEC_KINDS, CompressConfig
from repro_torch.configs.dit_moe_xl import config as xl_config, tiny
from repro_torch.core import conditional
from repro_torch.core import overlap as overlap_lib
from repro_torch.core import paging as paging_lib
from repro_torch.core import placement as placement_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.moe import refuse_router_jitter
from repro_torch.core.schedules import DiceConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.dit_moe import init_dit
from repro_torch.obs import MetricsRegistry, ObsConfig, StepTracer
from repro_torch.obs import telemetry as obs_fields
from repro_torch.resilience import degrade as degrade_lib
from repro_torch.resilience import faults as fault_lib
from repro_torch.resilience.recovery import AdmissionQueue
from repro_torch.sampling.rectified_flow import (fold_seed, make_rf_step,
                                                 rf_sample)


@dataclass
class Request:
    class_id: int
    rid: int


SCHEDULES = {
    "sync": DiceConfig.sync_ep,
    "displaced": DiceConfig.displaced,
    "interweaved": DiceConfig.interweaved,
    "dice": DiceConfig.dice,
    "staggered_batch": DiceConfig.staggered_batch,
}


# ---------------------------------------------------------------------------
# modeled step latency of the paper's deployment
# ---------------------------------------------------------------------------
# The paper's setup: 8x RTX 4090 over PCIe.  Effective (not peak) constants,
# calibrated by the reference against the paper's Table 5 (all-to-all is
# 75.6-79.2% of sync-EP step time on DiT-MoE-XL at batch 4-32):
#   flops   = 82.6 TF dense bf16 x ~45% achieved utilisation,
#   link_bw = ~0.9 GB/s effective per-GPU all-to-all bandwidth.
PAPER_HW = {"flops": 37e12, "link_bw": 0.9e9}


def layer_compute_flops(cfg, tokens: int) -> float:
    """Per-MoE-layer forward flops (attention + routed + shared experts):
    QKV + output projections 8*T*d^2, QK^T + AV 4*T^2*d, and three d x d_ff
    matmuls per dispatched token for the gated expert FFNs."""
    d = cfg.d_model
    attn_flops = 8 * tokens * d * d + 4 * tokens ** 2 * d
    moe_flops = 6 * tokens * d * cfg.expert_d_ff * (
        cfg.experts_per_token + cfg.num_shared_experts)
    return attn_flops + moe_flops


def hop_wire_times(t_comm: float, n_dev: int, sched, *,
                   devices_per_host: int, link_bw: float,
                   inter_host_bw: float) -> List[float]:
    """Per-hop wire seconds of a chunked ring all-to-all on a two-tier
    fabric: a shift-h hop pushes ``hop_crossings(h, n, H)`` chunks through
    the single inter-host trunk, so it takes the slower of the trunk's
    serialisation and one intra-host chunk transfer."""
    base = t_comm / max(1, n_dev - 1)
    out = []
    for h in sched:
        c = overlap_lib.hop_crossings(h, n_dev, devices_per_host)
        out.append(max(base, c * base * (link_bw / inter_host_bw)))
    return out


def _ring_pipeline_bound(chunk_comp: float, wire_times) -> float:
    """Flow-shop recurrence of the ring engine over explicit per-hop wire
    times: the local chunk's FFN runs behind hop 1's wire, then each
    arriving chunk computes once its data has landed and the previous
    chunk's FFN is done."""
    done = chunk_comp
    wire = 0.0
    for w in wire_times:
        wire += w
        done = max(done, wire) + chunk_comp
    return done


def modeled_step_latency(cfg, dcfg, *, local_batch: int, n_dev: int = 8,
                         hw: Optional[dict] = None,
                         devices_per_host: int = 0,
                         inter_host_bw: Optional[float] = None) -> dict:
    """Modeled seconds per diffusion step on ``n_dev`` devices of ``hw``
    (default ``PAPER_HW``, the paper's 8 x RTX 4090 point).

    A ``"blocking"`` layer is serial (compute + its all-to-alls); a
    ``"ring"`` layer takes the per-hop pipeline bound.  The result carries
    both bounds and ``overlap_efficiency``, the share of communication
    time the selected engine hides.  ``devices_per_host`` with an
    ``inter_host_bw`` below the link rate models a two-tier fabric whose
    ring follows :func:`~repro_torch.core.overlap.ring_hop_schedule`.
    The number is a model of that hardware, never a measurement.
    """
    hw = hw or PAPER_HW
    hetero = (0 < devices_per_host < n_dev
              and inter_host_bw is not None
              and inter_host_bw < hw["link_bw"]
              and n_dev % max(1, devices_per_host) == 0)
    steady = plan_lib.steady_state_plan_for(dcfg, cfg.num_layers,
                                            experts_per_token=cfg.experts_per_token)
    tokens = local_batch * cfg.patch_tokens
    d = cfg.d_model
    t_comp = layer_compute_flops(cfg, tokens) / hw["flops"]
    # per-layer all-to-all: dispatch + combine of the capacity buffer
    cap_tokens = tokens * cfg.experts_per_token * cfg.capacity_factor
    a2a_full = 2 * cap_tokens * d * 2 * (n_dev - 1) / n_dev
    a2a_full *= plan_lib.placement_wire_scale(dcfg)
    a2a_async = a2a_full
    # wire codec: light-step payloads shrink by the codec's ratio at the
    # 2-byte wire dtype the model counts in
    light_scale = 1.0
    cspec = plan_lib.codec_spec_of(dcfg)
    if cspec is not None and plan_lib.schedule_name(dcfg.schedule) in (
            "displaced", "interweaved", "dice"):
        light_scale = cspec.wire_ratio(d, itemsize=2)
    if dcfg.cond_comm:
        # conditional communication gates the async layers only
        a2a_async = a2a_full * conditional.comm_volume_fraction(
            cfg.experts_per_token, dcfg.cond_stride, dcfg.cond_policy,
            light_scale=light_scale)
    elif light_scale < 1.0 and dcfg.cond_stride > 1:
        a2a_async = a2a_full * (
            1 + (dcfg.cond_stride - 1) * light_scale) / dcfg.cond_stride
    t_comm_full = a2a_full / hw["link_bw"]
    t_comm_async = a2a_async / hw["link_bw"]

    if plan_lib.schedule_name(dcfg.schedule) == "staggered_batch":
        # two half-batches: each expert GEMM runs at lower utilisation
        def eff(b):
            return b / (b + 4)
        t_comp = t_comp * eff(local_batch) / eff(max(1, local_batch // 2))

    sync_frac = steady.num_sync_layers / max(1, steady.num_layers)

    aware_sched = oblivious_sched = tuple(range(1, n_dev))
    if hetero:
        aware_sched = overlap_lib.ring_hop_schedule(
            n_dev, devices_per_host=devices_per_host)

    def _wire(tm, sched):
        return hop_wire_times(tm, n_dev, sched,
                              devices_per_host=devices_per_host,
                              link_bw=hw["link_bw"],
                              inter_host_bw=inter_host_bw)

    def ring_bound(tc: float, tm: float, sched=None) -> float:
        if n_dev <= 1:
            return tc + tm
        t_local = tc / n_dev
        if not hetero:
            return t_local + (n_dev - 1) * max(tm / (n_dev - 1), tc / n_dev)
        return _ring_pipeline_bound(
            t_local, _wire(tm, aware_sched if sched is None else sched))

    def _comm(tm: float) -> float:
        return sum(_wire(tm, oblivious_sched)) if hetero else tm

    def step_of(t_sync: float, t_async: float) -> float:
        return cfg.num_layers * (sync_frac * t_sync
                                 + (1 - sync_frac) * t_async)

    t_blocking = step_of(t_comp + _comm(t_comm_full),
                         t_comp + _comm(t_comm_async))
    t_ring = step_of(ring_bound(t_comp, t_comm_full),
                     ring_bound(t_comp, t_comm_async))
    t_ring_obl = (step_of(ring_bound(t_comp, t_comm_full, oblivious_sched),
                          ring_bound(t_comp, t_comm_async, oblivious_sched))
                  if hetero else t_ring)
    t_step = t_ring if plan_lib.overlap_of(dcfg) else t_blocking
    t_comm_step = cfg.num_layers * (sync_frac * _comm(t_comm_full)
                                    + (1 - sync_frac) * _comm(t_comm_async))
    efficiency = ((t_blocking - t_step) / t_comm_step
                  if t_comm_step > 0 else 0.0)
    return {"t_step_s": t_step,
            "t_step_blocking_s": t_blocking,
            "t_step_ring_s": t_ring,
            "t_step_ring_oblivious_s": t_ring_obl,
            "hop_schedule": aware_sched if hetero else None,
            "overlap_efficiency": max(0.0, min(1.0, efficiency)),
            "t_comp_layer": t_comp,
            "t_comm_layer": t_comm_async, "sync_frac": sync_frac,
            "a2a_bytes_layer": sync_frac * a2a_full
            + (1 - sync_frac) * a2a_async}


def _modeled(lat: dict, steps: int) -> dict:
    """The summary keys of a modeled latency over ``steps`` steps."""
    return {"modeled_step_s_paper8": lat["t_step_s"],
            "modeled_total_s_paper8": lat["t_step_s"] * steps,
            "modeled_step_blocking_s": lat["t_step_blocking_s"],
            "modeled_step_ring_s": lat["t_step_ring_s"],
            "modeled_overlap_efficiency": lat["overlap_efficiency"],
            "a2a_bytes_per_layer": lat["a2a_bytes_layer"]}


# ---------------------------------------------------------------------------
# metrics publication: the registry is the single source of truth; the
# summaries the serving loops return are views of it.  Flows are counters,
# per-batch sizes max-gauges, the modeled step time a histogram mean.
# ---------------------------------------------------------------------------
def _publish_batch(reg: MetricsRegistry, stats: dict, lab: dict) -> None:
    """Publish one ``DiceServer.generate`` summary, with its modeled
    latency (:func:`_modeled`), into a registry."""
    reg.counter("dice_batches_total", "generate() batches executed",
                lab).inc()
    reg.histogram("dice_modeled_step_seconds",
                  "modeled per-step latency of the paper's deployment",
                  lab).observe(stats["modeled_step_s_paper8"])
    reg.counter("dice_modeled_seconds_total",
                "modeled run seconds of the paper's deployment",
                lab).inc(stats["modeled_total_s_paper8"])
    reg.gauge("dice_a2a_bytes_per_layer",
              "modeled per-MoE-layer all-to-all payload",
              lab).set_max(float(stats["a2a_bytes_per_layer"]))
    reg.gauge("dice_buffer_bytes", "persistent staleness-buffer footprint",
              lab).set_max(int(stats["buffer_bytes"]))
    reg.counter("dice_dispatch_bytes_total", "dispatch payload moved",
                lab).inc(float(sum(stats["dispatch_bytes_per_step"])))
    reg.counter("dice_wire_bytes_total",
                "codec-compressed bytes on the wire",
                lab).inc(stats["wire_bytes_total"])
    reg.counter("dice_raw_bytes_total", "lossless-equivalent payload bytes",
                lab).inc(stats["raw_bytes_total"])
    reg.gauge("dice_overlap_efficiency",
              "fraction of comm time the selected engine hides",
              lab).set_max(float(stats["modeled_overlap_efficiency"]))
    reg.gauge("dice_plan_variants", "StepPlan variants", lab).set_max(
        stats["num_plan_variants"])
    reg.gauge("dice_step_keys", "(plan, slotted) keys the step fn ran",
              lab).set_max(stats["step_keys"])
    reg.counter("dice_wall_seconds_total",
                "measured wall seconds on the device", lab).inc(
                    stats["wall_s"])
    _publish_paging(reg, stats, lab)


def _publish_paging(reg: MetricsRegistry, stats: dict, lab: dict) -> None:
    """The expert-paging series of a run's summary, where it paged."""
    if "paged_transfers" in stats:
        reg.counter("dice_paged_transfers_total",
                    "expert-pool host->device fetches",
                    lab).inc(stats["paged_transfers"])
        reg.counter("dice_paged_bytes_in_total",
                    "expert-pool host->device bytes",
                    lab).inc(stats["paged_bytes_in"])
    if stats.get("peak_resident_expert_bytes") is not None:
        reg.gauge("dice_peak_resident_expert_bytes",
                  "realized per-device expert-residency peak",
                  lab).set_max(stats["peak_resident_expert_bytes"])
    if stats.get("expert_hbm_budget") is not None:
        reg.gauge("dice_expert_hbm_budget_bytes",
                  "per-device resident-expert byte budget",
                  lab).set_max(stats["expert_hbm_budget"])
    for key, name, help_ in (
            ("paging_fetch_errors", "dice_paging_fetch_errors_total",
             "failed expert-shard fetch attempts"),
            ("paging_fetch_retries", "dice_paging_fetch_retries_total",
             "expert-shard fetch re-attempts"),
            ("paging_stale_fallbacks", "dice_paging_stale_fallbacks_total",
             "fetches served from the stale resident shard")):
        if key in stats:
            reg.counter(name, help_, lab).inc(stats[key])


def _publish_telemetry_step(reg: MetricsRegistry, tel, lab: dict) -> None:
    """Append one step's (num_layers, NUM_FIELDS) telemetry block, already
    on the host, to the per-layer series (the reference's names)."""
    tel = np.asarray(tel)
    per_layer = {"dice_staleness_age": obs_fields.AGE,
                 "dice_mask_rate": obs_fields.MASK_RATE,
                 "dice_dropped_frac": obs_fields.DROP_FRAC,
                 "dice_codec_error": obs_fields.CODEC_ERR}
    for layer in range(tel.shape[0]):
        ll = {**lab, "layer": f"{layer:02d}"}
        reg.series("dice_residual_energy",
                   "relative staleness-residual energy per layer/step",
                   {**ll, "path": "dispatch"}).append(
                       float(tel[layer, obs_fields.RES_DISPATCH]))
        reg.series("dice_residual_energy", "",
                   {**ll, "path": "combine"}).append(
                       float(tel[layer, obs_fields.RES_COMBINE]))
        for name, idx in per_layer.items():
            reg.series(name, "", ll).append(float(tel[layer, idx]))


FAULT_EVENTS = ("corrupt_combine", "guarded_combine", "corrupt_dispatch",
                "guarded_dispatch")


def _publish_fault_events(reg: MetricsRegistry, fe, lab: dict) -> None:
    for idx, nm in enumerate(FAULT_EVENTS):
        if fe[idx]:
            reg.counter("dice_fault_events_total",
                        "in-graph wire corruption / guard events",
                        {**lab, "event": nm}).inc(float(fe[idx]))


def _count(reg: MetricsRegistry, name: str, labels: dict) -> float:
    return reg.value(name, labels) if reg.get(name, labels) is not None \
        else 0.0


def _registry_view(reg: MetricsRegistry, lab: dict) -> dict:
    """The ``serve_queue`` summary, computed from the registry."""
    e2e = reg.histogram("dice_request_e2e_seconds", labels=lab)
    view = {
        "batches": int(reg.value("dice_batches_total", lab)),
        "padded": int(reg.value("dice_padded_requests_total", lab)),
        "modeled_step_s_paper8": reg.histogram("dice_modeled_step_seconds",
                                               labels=lab).mean,
        "modeled_total_s_paper8": reg.value("dice_modeled_seconds_total",
                                            lab),
        "a2a_bytes_per_layer": reg.value("dice_a2a_bytes_per_layer", lab),
        "buffer_bytes": int(reg.value("dice_buffer_bytes", lab)),
        "dispatch_bytes_total": reg.value("dice_dispatch_bytes_total", lab),
        "wire_bytes_total": reg.value("dice_wire_bytes_total", lab),
        "raw_bytes_total": reg.value("dice_raw_bytes_total", lab),
        "modeled_overlap_efficiency": reg.value("dice_overlap_efficiency",
                                                lab),
        "num_plan_variants": int(reg.value("dice_plan_variants", lab)),
        "step_keys": int(reg.value("dice_step_keys", lab)),
        "wall_s": reg.value("dice_wall_seconds_total", lab),
        "e2e_s": e2e.snap(),
    }
    if reg.get("dice_paged_transfers_total", lab) is not None:
        view["paged_transfers"] = int(
            reg.value("dice_paged_transfers_total", lab))
        view["paged_bytes_in"] = int(
            reg.value("dice_paged_bytes_in_total", lab))
    for key, name in (("peak_resident_expert_bytes",
                       "dice_peak_resident_expert_bytes"),
                      ("expert_hbm_budget", "dice_expert_hbm_budget_bytes")):
        if reg.get(name, lab) is not None:
            view[key] = int(reg.value(name, lab))
    return view


def write_metrics(registry: MetricsRegistry, path: str) -> None:
    """Write a registry to ``path``: JSON snapshot for ``*.json``,
    Prometheus text exposition otherwise."""
    if str(path).endswith(".json"):
        registry.write_snapshot(path)
    else:
        registry.write_prometheus(path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(tracer: Optional[StepTracer], name: str, cat: str, args: dict):
    return (tracer.span(name, cat=cat, args=args) if tracer is not None
            else contextlib.nullcontext())


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class DiceServer:
    """Serves DiT-MoE requests on one device, or as one rank of a
    ``mesh`` (:func:`~repro_torch.launch.mesh.make_mesh`: the flat ep mesh
    or the hierarchical ``dp x ep x patch`` one).

    ``params`` defaults to a random init from ``seed`` drawn on the device
    (over a mesh only the rank's experts are kept, layer by layer, so no
    rank ever holds the whole expert tree); given params are sharded over
    the mesh.  ``compress`` threads a wire codec into the schedule
    config; the exchange engine is ``dcfg.overlap``.
    ``n_dev`` is the device count of the modeled deployment (default: the
    mesh's ep size, else 8) and enters the latency model only.
    ``devices_per_host`` declares a two-tier fabric: the ring then runs
    the topology-aware hop order
    (:func:`~repro_torch.core.overlap.ring_hop_schedule`) and the latency
    model prices host-crossing hops at ``inter_host_bw``.  ``placement``
    (a :class:`~repro_torch.core.placement.PlacementConfig`) in
    ``"greedy"`` mode makes :func:`serve_continuous` re-lay-out the
    experts when the routing histogram drifts; ``dcfg.placements`` set by
    the caller apply in every engine.
    ``metrics`` is the registry the serving loops fold their registries
    into; ``tracer`` (a :class:`~repro_torch.obs.StepTracer`) records host
    phases (made for an enabled ``obs`` when not given).  ``obs`` adds the
    staleness telemetry and measured step times; ``resilience`` (a
    :class:`~repro_torch.resilience.faults.ResilienceConfig`) is stamped on
    the schedule config, normalized (an inert one is dropped, so the
    samples stay those without it).

    ``paging`` (a :class:`~repro_torch.core.paging.PagingSpec`) over an ep
    mesh of more than one rank moves the rank's routed-expert rows into a
    pinned host pool (``expert_pool``, built from the params when not
    given) before the params are sharded, so the full expert set is never
    placed on the card; the budget's auto value resolves here, and the
    pool's retry and fallback policy follows ``resilience``.  Paging and
    online greedy placement exclude each other."""

    def __init__(self, cfg, dcfg: DiceConfig, *, params=None, seed: int = 0,
                 device: Optional[str] = None,
                 compress: Optional[CompressConfig] = None,
                 n_dev: Optional[int] = None,
                 mesh: Optional[mesh_lib.EPMesh] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[StepTracer] = None,
                 obs: Optional[ObsConfig] = None,
                 resilience: Optional[fault_lib.ResilienceConfig] = None,
                 devices_per_host: int = 0,
                 inter_host_bw: Optional[float] = None,
                 placement: Optional[placement_lib.PlacementConfig] = None,
                 paging: Optional[paging_lib.PagingSpec] = None,
                 expert_pool: Optional[paging_lib.ExpertPool] = None):
        refuse_router_jitter(cfg)
        if mesh is not None:
            _check_mesh(mesh)
        if compress is not None:
            dcfg = dataclasses.replace(
                dcfg, compress=None if compress.codec == "none" else compress)
        if paging is not None:
            dcfg = dataclasses.replace(dcfg, paging=paging)
        if resilience is not None:
            dcfg = dataclasses.replace(dcfg, resilience=resilience)
        n_ep = mesh_lib.axis_size(mesh, "ep")
        if n_dev is None:
            n_dev = n_ep if mesh is not None else 8
        if n_dev < 1:
            raise ValueError(f"n_dev must be >= 1, got {n_dev}")
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh rank's "
                                 f"device {mesh.device}")
            self.device = mesh.device
        self.cfg = cfg
        # the requested config: the latency model describes its engine on
        # n_dev devices; the samplers normalize a ring away where no mesh
        # of more than one rank runs the steps
        self.dcfg = dcfg
        self.n_dev = n_dev
        self.mesh = mesh
        self.devices_per_host = devices_per_host
        self.inter_host_bw = inter_host_bw
        self.placement = placement
        # the ring's hop order on a two-tier fabric: cheap intra-host
        # shifts first (a permutation of the shifts: the same numbers)
        self.hop_schedule = None
        if (plan_lib.overlap_of(dcfg) and n_ep > 1
                and 0 < devices_per_host < n_ep
                and n_ep % devices_per_host == 0):
            self.hop_schedule = plan_lib.normalize_hop_schedule(
                overlap_lib.ring_hop_schedule(
                    n_ep, devices_per_host=devices_per_host), n_ep)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.obs = obs if obs is not None else ObsConfig()
        self.tracer = tracer if tracer is not None or not self.obs.enabled \
            else StepTracer()
        paged = paging_lib.paging_of(dcfg) is not None and n_ep > 1
        if paged and placement is not None and placement.mode == "greedy":
            raise ValueError(
                "expert paging and online affinity placement are mutually "
                "exclusive: the pool serves per-layer shards in canonical "
                "expert order")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            rows = None
            if mesh is not None:
                rows = paging_lib.expert_rows(
                    cfg.num_experts, n_ep, mesh.rank_in("ep")) if paged \
                    else shard_lib.expert_slice(cfg.num_experts, mesh)
            params = init_dit(cfg, generator=gen, experts=rows)
        self.expert_pool = expert_pool
        if paged:
            # the rank's expert rows go to the pinned host pool before the
            # params are sharded; the device stacks are freed with the strip
            if expert_pool is None and paging_lib.has_expert_leaves(params):
                self.expert_pool = paging_lib.pool_from_params(
                    params, n_dev=n_ep, rank=mesh.rank_in("ep"),
                    device=self.device)
            if self.expert_pool is None:
                raise ValueError(
                    "paging is configured but params carry no expert "
                    "leaves and no expert_pool was provided")
            if self.expert_pool.n_dev != n_ep:
                raise ValueError(
                    f"expert pool is sharded for {self.expert_pool.n_dev} "
                    f"devices but the serving mesh has a {n_ep}-way ep axis")
            self.dcfg = dcfg = paging_lib.resolve_budget(dcfg,
                                                         self.expert_pool)
            params = paging_lib.strip_expert_params(params)
        if self.expert_pool is not None:
            # the pool's retry/fallback policy and seeded fetch faults
            # follow the server's config; its fetch spans go to the tracer
            self.expert_pool.set_resilience(fault_lib.resilience_of(dcfg))
            self.expert_pool.tracer = self.tracer
        if mesh is not None:
            params = shard_lib.ep_shard_params(params, mesh)
        self.params = params
        self._placed = None

    @property
    def n_ep(self) -> int:
        return mesh_lib.axis_size(self.mesh, "ep")

    def params_for(self, placements):
        """The params laid out under ``placements`` over the mesh's ep
        groups (:func:`~repro_torch.common.sharding.place_experts`, an
        all-gather of each placed layer's experts), kept for the last
        placements asked for, so a run re-lays-out the experts once and not
        per ``generate``; the server's own params where there is nothing to
        lay out."""
        if placements is None or self.n_ep <= 1:
            return self.params
        if self._placed is None or self._placed[0] != placements:
            self._placed = None             # free the old layout first
            self._placed = (placements, shard_lib.place_experts(
                self.params, placements, self.mesh))
        return self._placed[1]

    def plan(self, num_steps: int) -> plan_lib.SchedulePlan:
        """The schedule plan a ``generate`` call will run."""
        dcfg = plan_lib.normalize_overlap(self.dcfg, self.n_ep)
        dcfg = plan_lib.normalize_paging(dcfg, self.n_ep)
        return plan_lib.compile_step_plans(
            plan_lib.normalize_placement(dcfg, self.n_ep),
            self.cfg.num_layers, num_steps,
            experts_per_token=self.cfg.experts_per_token)

    def latency(self, local_batch: int, dcfg=None) -> dict:
        """:func:`modeled_step_latency` of this server's deployment (under
        ``dcfg``, default the server's)."""
        return modeled_step_latency(self.cfg, dcfg or self.dcfg,
                                    n_dev=self.n_dev,
                                    local_batch=max(1, local_batch),
                                    devices_per_host=self.devices_per_host,
                                    inter_host_bw=self.inter_host_bw)

    def generate(self, requests: List[Request], *, num_steps: int = 20,
                 guidance: float = 1.5, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 metric_labels: Optional[dict] = None):
        """Sample one batch.  Noise comes from ``noise`` or ``generator``
        (default: a generator on the server's device seeded with 0).  Over
        a mesh every rank calls this with the same requests; each samples
        its slice and every rank gets the whole batch back.

        Returns (samples, summary): the summary holds what was measured and
        counted (dispatch bytes per rank).  It is published into
        ``metrics`` (default: the server's registry) under
        ``metric_labels``, together with the modeled latency of the paper's
        deployment, which :func:`serve_queue`'s view reads from there."""
        classes = torch.tensor([r.class_id for r in requests],
                               dtype=torch.int64, device=self.device)
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        before = dict(ops.LAUNCHES)
        _sync(self.device)
        t0 = time.perf_counter()
        placements = plan_lib.placements_of(
            plan_lib.normalize_placement(self.dcfg, self.n_ep))
        samples, stats = rf_sample(self.params_for(placements), self.cfg,
                                   self.dcfg, num_steps=num_steps,
                                   classes=classes, noise=noise,
                                   generator=generator, guidance=guidance,
                                   mesh=self.mesh, obs=self.obs,
                                   hop_schedule=self.hop_schedule,
                                   params_placed=True,
                                   expert_pool=self.expert_pool)
        _sync(self.device)
        wall = time.perf_counter() - t0
        lat = self.latency(len(requests) // self.n_dev)
        result = {
            **_where(self.device, self.mesh),
            "wall_s": wall,
            "wall_s_per_step": wall / max(num_steps, 1),
            "ring_hops": max(stats["hops"], default=0),
            "hop_bytes_total": float(sum(stats["hop_bytes"])),
            "buffer_bytes": stats["buffer_bytes"][-1]
            if stats["buffer_bytes"] else 0,
            "dispatch_bytes_per_step": stats["dispatch_bytes"],
            "wire_bytes_total": float(sum(stats["dispatch_bytes"])),
            "raw_bytes_total": float(sum(stats["raw_bytes"])),
            "num_plan_variants": stats["num_plan_variants"],
            "step_keys": stats["step_keys"],
            "kernel_launches": _launches_since(before),
            **{k: stats[k] for k in ("paged_transfers", "paged_bytes_in",
                                     "peak_resident_expert_bytes",
                                     "expert_hbm_budget") if k in stats},
        }
        if "telemetry" in stats:
            result["telemetry"] = stats["telemetry"]
            result["step_wall_s"] = stats["step_wall_s"]
        if "fault_events" in stats:
            result["fault_events"] = dict(zip(
                FAULT_EVENTS, map(float, stats["fault_events"])))
        reg = metrics if metrics is not None else self.metrics
        lab = metric_labels if metric_labels is not None else {
            "schedule": plan_lib.schedule_name(self.dcfg.schedule),
            "engine": "batch"}
        _publish_batch(reg, {**result, **_modeled(lat, num_steps)}, lab)
        for w in stats.get("step_wall_s", ()):
            reg.histogram("dice_step_wall_seconds",
                          "measured wall seconds per diffusion step",
                          lab).observe(w)
        for tel in stats.get("telemetry", ()):
            _publish_telemetry_step(reg, tel, lab)
        if "fault_events" in stats:
            _publish_fault_events(reg, stats["fault_events"], lab)
        return samples, result


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, (mesh_lib.EPMesh, mesh_lib.HierMesh)):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.EPMesh or "
                        f"HierMesh, got {type(mesh).__name__}")


def _where(device: torch.device, mesh) -> dict:
    """The summary keys naming where a run ran: the device, and over a
    mesh its axis sizes and backend."""
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    if mesh is not None:
        out.update(mesh.shape, backend=mesh.backend)
    return out


def request_noise(seed: int, rid: int, cfg,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-request initial latent noise (patch_tokens, in_channels).

    Drawn from a CPU generator seeded from ``(seed, rid)`` and then moved
    to ``device``, so the CPU and the card see the same noise and a
    request's noise does not depend on the slot or batch it lands in: the
    recycled-slot guarantee of :func:`serve_continuous` is stated against
    this derivation."""
    gen = torch.Generator().manual_seed(fold_seed(seed, rid))
    z = torch.randn((cfg.patch_tokens, cfg.in_channels), generator=gen)
    return z if device is None else z.to(device, non_blocking=True)


def _noise_of(noise: Optional[dict], seed: int, rid: int, cfg, device):
    """``noise[rid]`` where the caller gave it, else :func:`request_noise`."""
    if noise is not None and rid in noise:
        return torch.as_tensor(noise[rid], dtype=torch.float32).to(device)
    return request_noise(seed, rid, cfg, device)


# ---------------------------------------------------------------------------
# batched serving loop (FIFO queue -> fixed-size batches)
# ---------------------------------------------------------------------------
def serve_queue(server: DiceServer, requests: List[Request], *,
                max_batch: int = 8, num_steps: int = 10,
                guidance: float = 1.5, seed: int = 0,
                noise: Optional[dict] = None):
    """Drain a request queue through fixed-size batches; short final
    batches are padded with the null class (rid -1) and trimmed.  A
    request's noise is ``noise[rid]`` or :func:`request_noise`.  Returns
    ({rid: sample}, summary), the summary a view of a call-scoped registry
    that is folded into ``server.metrics``."""
    cfg, dev = server.cfg, server.device
    out: dict = {}
    reg = MetricsRegistry()
    lab = {"schedule": plan_lib.schedule_name(server.dcfg.schedule),
           "engine": "queue"}
    queue = list(requests)
    t_start = time.perf_counter()
    while queue:
        batch, queue = queue[:max_batch], queue[max_batch:]
        pad = max_batch - len(batch)
        reg.series("dice_queue_depth", "requests still waiting",
                   lab).append(len(queue))
        padded = batch + [Request(class_id=cfg.num_classes, rid=-1)] * pad
        x0 = torch.stack([_noise_of(noise, seed, r.rid, cfg, dev)
                          for r in padded])
        with _span(server.tracer, "serve_queue_batch", "serve",
                   {"batch": len(batch), "pad": pad}):
            samples, _ = server.generate(padded, num_steps=num_steps,
                                         guidance=guidance, noise=x0,
                                         metrics=reg, metric_labels=lab)
        for i, r in enumerate(batch):
            out[r.rid] = samples[i]
        # every request of a rigid batch completes with the batch
        done = time.perf_counter() - t_start
        e2e = reg.histogram("dice_request_e2e_seconds",
                            "request end-to-end seconds (enqueue->sample)",
                            lab)
        for _ in batch:
            e2e.observe(done)
        reg.counter("dice_requests_total", "requests served", lab).inc(
            len(batch))
        reg.counter("dice_padded_requests_total", "null-class pad slots",
                    lab).inc(pad)
    server.metrics.merge(reg)
    return out, _registry_view(reg, lab)


# ---------------------------------------------------------------------------
# continuous batching (slot-level staleness-state recycling)
# ---------------------------------------------------------------------------
@dataclass
class _Slot:
    """One batch lane of the continuous engine."""
    rid: int = -1
    class_id: int = 0
    local_step: int = 0
    active: bool = False


def _tick_generator(seed: int, tick: int, device,
                    rank: Optional[int] = None) -> torch.Generator:
    """The "random" policy's generator of one tick, seeded from
    ``(seed, tick)``: the counterpart of the reference's
    ``fold_in(step_key, tick)``; with ``rank``, from ``(seed, tick,
    rank)``, as the reference folds the device index in on a mesh."""
    s = fold_seed(seed, tick)
    if rank is not None:
        s = fold_seed(s, rank)
    return torch.Generator(device=device).manual_seed(s)


def serve_continuous(server: DiceServer, requests: List[Request], *,
                     max_batch: int = 8, num_steps: int = 10,
                     guidance: float = 1.5, seed: int = 0,
                     arrival_steps: Optional[List[float]] = None,
                     noise: Optional[dict] = None, mesh=None):
    """Continuous-batching serving loop: slot-level admission + recycling.

    Each of the ``max_batch`` slots carries its own step count and
    completes on its own.  Queued requests are admitted into free slots at
    plan-aligned ticks (``tick % steady_period == 0``), so every
    established slot shares the tick's StepPlan.  A recycled slot's
    staleness rows are zeroed (:func:`~repro_torch.core.staleness.reset_slots`)
    and it replays the warmup prefix through the per-slot selectors of
    the step function, so no activation of the previous occupant reaches
    its successor: for configurations whose sampling draws nothing
    (``cond_policy != "random"``) a recycled slot's sample equals the same
    request's in a fresh batch.

    ``arrival_steps[i]`` is the tick at which ``requests[i]`` arrives
    (default 0).  A request's noise is ``noise[rid]`` or
    :func:`request_noise`; a ``"random"`` policy draws each tick's mask
    from a generator seeded from ``(seed, tick)``.  Slot surgery runs on
    the device without a host sync; a finished slot's sample is copied to
    the CPU when it completes, which is when its end-to-end latency is
    read.  Returns ({rid: sample on the CPU}, stats).

    ``mesh`` (default: the server's) runs every tick over the mesh: each
    rank holds ``max_batch / lanes`` consecutive slots of its ``dp x ep``
    lane (their latents, per-slot tensors and staleness rows), while
    admission and the tick's plan are decided on the host from the same
    queue and counters, identically on every rank.  A ``patch`` axis is
    refused, as in the reference: slot surgery assumes batch-only
    sharding.  A finished slot's sample is gathered from its rank, so
    every rank returns every sample.  Over a mesh a "random" policy draws
    a steady tick's masks from ``(seed, tick, rank)``, one per token
    shard, and a slotted tick's from ``(seed, tick)`` over all slots.

    Online placement (``server.placement`` in ``"greedy"`` mode, over an ep
    axis of more than one rank): each tick's served-pair histogram (the
    mean over the ranks) feeds a
    :class:`~repro_torch.core.placement.RoutingHistogram`; at plan-aligned
    ticks after ``warmup_ticks`` observed ticks, a drift of the EMA past
    ``drift_threshold`` from the shares of the live placement re-plans
    the layout greedily and rebuilds the step function on re-laid-out
    experts (``dice_placement_reshards_total``).  The staleness buffers
    follow tokens, not experts, and carry over.  The histograms reach the
    host in one copy at those ticks only.

    With ``server.obs`` enabled each tick's wall time (after a device
    synchronisation) and telemetry block go to the registry.  With a
    resilience config on the server's schedule config the loop runs the
    ladder: the watchdog (:class:`~repro_torch.resilience.degrade.DegradationController`)
    demotes ring -> blocking or codec -> none at plan-aligned ticks,
    rebuilding the plans and the step function; ``hop_delay`` sleeps while
    the ring is live; ``poison_tick`` NaN-poisons a live slot, and the
    quarantine scans the latents for non-finite lanes (one ``isfinite``
    reduction on the device), resets such a slot and requeues its request
    up to ``max_requeues`` times, then sheds it; the admission queue is
    bounded by ``max_queue_depth`` and ``admission_deadline_steps``.  The
    tick's telemetry, fault counts and lane flags reach the host in one
    copy.  Over a mesh one small all-reduce (max) per tick agrees on the
    wall time and the lane flags, so every rank takes the same decisions.

    A paging server (``DiceServer(paging=...)`` over an ep mesh of more
    than one rank) runs every tick on its pool: the pool's counts start
    from 0, every plan's residency windows are checked against the budget
    before the first tick, and the stats add the pool's transfers, bytes,
    peak and budget (and, with a resilience config, its fetch errors,
    retries and stale fallbacks), summed (the peak: maxed) over the ep
    ranks.
    """
    mesh = mesh if mesh is not None else server.mesh
    if mesh is not None:
        _check_mesh(mesh)
        if server.mesh is not None and mesh is not server.mesh:
            raise ValueError("serve_continuous: mesh differs from the "
                             "server's mesh")
    if mesh is not None and "patch" in mesh.axis_names:
        raise ValueError(
            "continuous batching does not compose with a 'patch' mesh axis "
            "(slot surgery assumes batch-only sharding); use "
            "DiceServer.generate on patch meshes")
    cfg = server.cfg
    dev = server.device if mesh is None else mesh.device
    n_ep = mesh_lib.axis_size(mesh, "ep")
    lanes = mesh.lanes if mesh is not None else 1
    dcfg = plan_lib.normalize_overlap(server.dcfg, n_ep)
    dcfg = plan_lib.normalize_placement(dcfg, n_ep)
    dcfg = plan_lib.normalize_paging(dcfg, n_ep)
    pool = None
    if paging_lib.paging_of(dcfg) is not None:
        pool = server.expert_pool
        if pool is None:
            raise ValueError("paging is planned but the server holds no "
                             "expert pool (construct DiceServer with "
                             "paging= on an ep mesh of more than one rank)")
        pool.reset_stats()
    reg = MetricsRegistry()
    lab = {"schedule": plan_lib.schedule_name(dcfg.schedule),
           "engine": "continuous"}
    tracer = server.tracer
    obs_on = server.obs.enabled
    res = fault_lib.resilience_of(dcfg)
    fplan = (fault_lib.FaultPlan(res.faults)
             if res is not None and res.faults is not None else None)
    ctrl = degrade_lib.DegradationController(res) if res is not None else None
    quarantine = res is not None and res.quarantine
    B, Tp, k_exp = max_batch, cfg.patch_tokens, cfg.experts_per_token
    if B % lanes:
        raise ValueError(f"max_batch={B} must divide over the {lanes} "
                         f"dp x ep lanes of the mesh")
    own = shard_lib.local_rows(B, mesh)       # the slots this rank holds
    B_loc = own.stop - own.start
    dt = 1.0 / num_steps

    def build(dcfg):
        """Plans and step function of one config (a demotion rebuilds)."""
        with _span(tracer, "plan_build", "plan",
                   {"schedule": lab["schedule"], "num_steps": num_steps}):
            splan = plan_lib.compile_step_plans(
                dcfg, cfg.num_layers, num_steps, experts_per_token=k_exp)
            merge_plan = plan_lib.slotted_merge_plan(
                dcfg, cfg.num_layers, experts_per_token=k_exp)
            # the server keeps its mesh's placed params; another mesh's
            # step lays them out itself
            params, placements = server.params, plan_lib.placements_of(dcfg)
            if mesh is server.mesh:
                params, placements = server.params_for(placements), None
            if pool is not None:
                # every planned residency window must fit the budget
                pool.validate_plan(splan)
                pool.begin_run(paging_lib.paging_of(dcfg).depth)
            rf_step = make_rf_step(params, cfg, dt=dt, guidance=guidance,
                                   mesh=mesh, obs=server.obs, resilience=res,
                                   placements=placements,
                                   hop_schedule=server.hop_schedule,
                                   expert_pool=pool)
        period = plan_lib.steady_period(dcfg, cfg.num_layers,
                                        experts_per_token=k_exp)
        return (splan, merge_plan, rf_step, period,
                any(a.want_cache for a in merge_plan.actions),
                {p: v for v, p in enumerate(splan.variants)})

    splan, merge_plan, rf_step, period, merge_wants_cache, variant_of = \
        build(dcfg)
    step_keys = 0
    random_policy = dcfg.cond_comm and dcfg.cond_policy == "random"
    # online placement: the histogram of served pairs (fed at the drift
    # checks from the ticks' device tensors) and the shares the live
    # placement was planned from
    pcfg = server.placement
    place_online = pcfg is not None and pcfg.mode == "greedy" and n_ep > 1
    hist = placement_lib.RoutingHistogram(
        cfg.num_layers, cfg.num_experts,
        decay=pcfg.ema_decay if pcfg is not None else 0.9)
    pending_counts = []
    placed_shares = None

    def planned_init():
        return stale_lib.init_planned_states(
            splan, num_tokens=B_loc * Tp, d_model=cfg.d_model, k=k_exp,
            dtype=torch.float32, device=dev)

    states, states_u = planned_init(), planned_init()
    x = torch.zeros((B_loc, Tp, cfg.in_channels), dtype=torch.float32,
                    device=dev)
    # per-slot state the step reads (this rank's slots), kept on the device
    # and changed by scalar writes (no host->device copy, so no sync per
    # tick)
    classes = torch.full((B_loc,), cfg.num_classes, dtype=torch.int64,
                         device=dev)
    steps = torch.zeros((B_loc,), dtype=torch.int64, device=dev)
    active = torch.zeros((B_loc,), dtype=torch.bool, device=dev)
    # t = s * dt as the fixed-batch sampler forms it, so slots match it
    t_of_step = torch.tensor([s * dt for s in range(num_steps)],
                             dtype=torch.float32, device=dev)
    slots = [_Slot() for _ in range(B)]
    ever_used = [False] * B

    # bounded admission: without a resilience config the queue is
    # unbounded and nothing is ever shed
    queue = AdmissionQueue(
        max_queue_depth=res.max_queue_depth if res is not None else 0,
        admission_deadline_steps=(res.admission_deadline_steps
                                  if res is not None else 0))
    for i, r in enumerate(requests):
        queue.push(0.0 if arrival_steps is None else float(arrival_steps[i]),
                   r)
    out: dict = {}
    admit_time: dict = {}
    tick_variants, tick_plans, demotion_ticks = [], [], []
    tick = 0
    before = dict(ops.LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()

    def _next_aligned(g: float) -> int:
        g = math.ceil(g)
        return g + (-g) % period

    def free_slot(i: int) -> None:
        slots[i] = _Slot()
        if own.start <= i < own.stop:
            classes[i - own.start] = cfg.num_classes
            active[i - own.start] = False

    while len(queue) or any(s.active for s in slots):
        # ---- watchdog demotion at plan-aligned ticks: repeated deadline
        # breaches while the ring is live demote it to blocking, repeated
        # codec-error blowups demote the codec; a rebuild of the plans
        if ctrl is not None and tick % period == 0:
            kind = ctrl.should_demote(
                ring_live=plan_lib.overlap_of(dcfg),
                codec_live=plan_lib.codec_spec_of(dcfg) is not None)
            if kind is not None:
                if tracer is not None:
                    tracer.instant("demote", args={"kind": kind,
                                                   "tick": tick})
                step_keys = max(step_keys, len(rf_step.keys))
                dcfg = dataclasses.replace(
                    dcfg, **({"overlap": "blocking"}
                             if kind == degrade_lib.DEMOTE_OVERLAP
                             else {"compress": None}))
                splan, merge_plan, rf_step, period, merge_wants_cache, \
                    variant_of = build(dcfg)
                ctrl.record_demotion(kind)
                demotion_ticks.append((tick, kind))
                reg.counter("dice_demotions_total",
                            "watchdog variant demotions",
                            {**lab, "kind": kind}).inc()

        # ---- drift-triggered re-shard at plan-aligned ticks: every slot is
        # at a cycle boundary, and the staleness rows follow tokens
        if place_online and tick % period == 0 and pending_counts:
            for c in torch.stack(pending_counts).to("cpu").numpy():
                hist.update(c)
            pending_counts = []
            if hist.updates >= pcfg.warmup_ticks:
                base = (placed_shares if placed_shares is not None
                        else np.full((cfg.num_layers, cfg.num_experts),
                                     1.0 / cfg.num_experts))
                if placement_lib.drift(base, hist.shares) > \
                        pcfg.drift_threshold:
                    new_pl = placement_lib.greedy_placements(
                        hist.shares, n_ep, replicate_top=pcfg.replicate_top)
                    if all(p.is_identity for p in new_pl):
                        new_pl = None
                    if new_pl != plan_lib.placements_of(dcfg):
                        if tracer is not None:
                            tracer.instant("placement_reshard",
                                           args={"tick": tick})
                        step_keys = max(step_keys, len(rf_step.keys))
                        dcfg = dataclasses.replace(dcfg, placements=new_pl)
                        splan, merge_plan, rf_step, period, \
                            merge_wants_cache, variant_of = build(dcfg)
                        reg.counter("dice_placement_reshards_total",
                                    "drift-triggered expert re-layouts",
                                    lab).inc()
                    placed_shares = hist.shares

        # ---- admission at plan-aligned ticks ------------------------------
        if tick % period == 0:
            recycle = torch.zeros((B_loc,), dtype=torch.bool, device=dev)
            any_recycled = False
            for i, slot in enumerate(slots):
                if slot.active:
                    continue
                req = queue.pop_ready(tick)
                if req is None:
                    break
                slots[i] = _Slot(rid=req.rid, class_id=req.class_id,
                                 local_step=0, active=True)
                if own.start <= i < own.stop:
                    j = i - own.start
                    recycle[j] = True
                    any_recycled = True
                    classes[j] = req.class_id
                    steps[j] = 0
                    active[j] = True
                    x[j] = _noise_of(noise, seed, req.rid, cfg, dev)
                reg.counter("dice_admissions_total", "slot admissions",
                            lab).inc()
                if ever_used[i]:
                    reg.counter("dice_recycled_admissions_total",
                                "admissions into a recycled slot",
                                lab).inc()
                if tracer is not None:
                    tracer.instant("admit", args={
                        "rid": req.rid, "slot": i, "tick": tick,
                        "recycled": bool(ever_used[i])})
                admit_time[req.rid] = time.perf_counter()
                ever_used[i] = True
            # load shedding: a no-op unless a bound is configured
            for rid in queue.shed_overdue(tick, retry_after=float(period)):
                reg.counter("dice_shed_requests_total",
                            "requests shed by admission bounds", lab).inc()
                if tracer is not None:
                    tracer.instant("shed", args={"rid": rid, "tick": tick})
            if any_recycled:
                states = stale_lib.reset_slots(states, recycle,
                                               tokens_per_slot=Tp)
                states_u = stale_lib.reset_slots(states_u, recycle,
                                                 tokens_per_slot=Tp)
        if not any(s.active for s in slots):
            nxt = queue.next_arrival()
            if nxt is None:
                break                  # everything remaining was shed
            # fully idle: jump to the next aligned tick with an arrival
            tick = _next_aligned(max(nxt, tick + 1))
            continue

        # ---- one engine tick ----------------------------------------------
        slotted = any(s.active and s.local_step < dcfg.warmup_steps
                      for s in slots)
        gen = tick_gen = None
        if random_policy:
            tick_gen = _tick_generator(seed, tick, dev)
            gen = tick_gen if mesh is None else \
                _tick_generator(seed, tick, dev, mesh.rank)
        if slotted:
            plan = merge_plan
            # free slots replay warmup too: their discarded lanes then
            # consume only fresh values, never the zeroed buffers
            fresh_b = ~active | (steps < dcfg.warmup_steps)
            slot_fresh = fresh_b[:, None].expand(B_loc, Tp).reshape(-1)
            consume = None
            if merge_wants_cache:
                if dcfg.cond_comm and not conditional.is_refresh_step(
                        tick, dcfg.cond_stride):
                    # drawn over all slots, then this rank's rows
                    steady_mask = conditional.policy_mask(
                        dcfg.cond_policy, B * Tp, k_exp, device=dev,
                        generator=tick_gen)[own.start * Tp:own.stop * Tp]
                else:
                    steady_mask = torch.ones((B_loc * Tp, k_exp),
                                             dtype=torch.bool, device=dev)
                consume = slot_fresh[:, None] | steady_mask
        else:
            ref = min(s.local_step for s in slots if s.active)
            plan = splan.steps[min(ref, num_steps - 1)]
            slot_fresh = consume = None
        tick_variants.append((variant_of.get(plan, -1), slotted))
        tick_plans.append(plan)

        t = torch.where(active, t_of_step[steps.clamp(max=num_steps - 1)],
                        0.0)
        t_tick = time.perf_counter()
        with _span(tracer, "tick", "step",
                   {"tick": tick, "slotted": slotted}):
            x, states, states_u, _, _, aux = rf_step(
                x, classes, states, states_u, t, plan=plan,
                slotted=slotted, slot_fresh=slot_fresh,
                consume_mask=consume, generator=gen, tick=tick)
            if place_online:
                pending_counts.append(aux["expert_counts"])
            if (fplan is not None and plan_lib.overlap_of(dcfg)
                    and fplan.hop_delay(tick)):
                # an injected slow ring hop, gated on the live engine:
                # demoting the ring stops it
                reg.counter("dice_injected_hop_delays_total",
                            "injected slow ring hops", lab).inc()
                time.sleep(fplan.cfg.hop_delay_s)
            if obs_on or ctrl is not None:
                _sync(dev)
        wall = time.perf_counter() - t_tick

        # ---- the tick's observations, on the host in one copy -------------
        poisoned = None
        if quarantine and fplan is not None and fplan.poison(tick):
            poisoned = next((i for i, s in enumerate(slots) if s.active),
                            None)
            if poisoned is not None and own.start <= poisoned < own.stop:
                x[poisoned - own.start].fill_(float("nan"))
            if poisoned is not None and tracer is not None:
                tracer.instant("poison", args={"slot": poisoned,
                                               "tick": tick})
        bad = None
        tel = fe = None
        if obs_on or res is not None:
            lanes = None
            if quarantine:
                lanes = (~torch.isfinite(x).reshape(B_loc, -1).all(1)).to(
                    torch.float32)
            tel, fe, wall, bad = _tick_observations(aux, lanes, wall, mesh,
                                                    own, B)
        if obs_on:
            reg.histogram("dice_step_wall_seconds",
                          "measured wall seconds per engine tick",
                          lab).observe(wall)
            if tel is not None:
                _publish_telemetry_step(reg, tel, lab)
        if ctrl is not None:
            codec_err = None
            if tel is not None:
                codec_err = float(tel[:, obs_fields.CODEC_ERR].mean())
            if ctrl.observe_step(wall, codec_err):
                reg.counter("dice_watchdog_breaches_total",
                            "engine-tick step-deadline breaches",
                            lab).inc()

        n_free = sum(not s.active for s in slots)
        reg.counter("dice_ticks_total", "engine ticks executed", lab).inc()
        if slotted:
            reg.counter("dice_slotted_ticks_total",
                        "ticks on the slotted merge plan", lab).inc()
        reg.counter("dice_padded_slot_steps_total",
                    "free-slot step executions", lab).inc(n_free)
        reg.series("dice_slot_occupancy", "active-slot fraction per tick",
                   lab).append(1.0 - n_free / B)
        reg.series("dice_queue_depth", "requests still waiting",
                   lab).append(len(queue))
        if fe is not None:
            _publish_fault_events(reg, fe, lab)
        reg.counter("dice_dispatch_bytes_total", "dispatch payload moved",
                    lab).inc(float(aux["dispatch_bytes"]))
        reg.counter("dice_wire_bytes_total",
                    "codec-compressed bytes on the wire",
                    lab).inc(float(aux["dispatch_bytes"]))
        reg.counter("dice_raw_bytes_total",
                    "lossless-equivalent payload bytes",
                    lab).inc(float(aux["raw_dispatch_bytes"]))
        reg.gauge("dice_buffer_bytes",
                  "persistent staleness-buffer footprint",
                  lab).set(int(aux["buffer_bytes"]))

        steps += active
        # ---- quarantine: a non-finite lane (the poison, or corruption the
        # guards did not catch) is reset before the completion scan, its
        # request requeued for a replay (its noise is rid-keyed) up to
        # max_requeues times, then shed
        if bad is not None:
            hit = [i for i in range(B) if bad[i] and slots[i].active]
            if hit:
                qm = torch.zeros((B_loc,), dtype=torch.bool, device=dev)
                for i in hit:
                    slot = slots[i]
                    reg.counter("dice_quarantined_slots_total",
                                "poisoned slots quarantined", lab).inc()
                    if tracer is not None:
                        tracer.instant("quarantine", args={
                            "rid": slot.rid, "slot": i, "tick": tick})
                    if queue.requeue(tick, Request(class_id=slot.class_id,
                                                   rid=slot.rid),
                                     res.max_requeues):
                        reg.counter("dice_requeued_requests_total",
                                    "quarantined requests requeued",
                                    lab).inc()
                    else:
                        reg.counter("dice_shed_requests_total",
                                    "requests shed by admission bounds",
                                    lab).inc()
                    admit_time.pop(slot.rid, None)
                    if own.start <= i < own.stop:
                        qm[i - own.start] = True
                    free_slot(i)
                x = torch.where(qm[:, None, None], 0.0, x)
                states = stale_lib.reset_slots(states, qm,
                                               tokens_per_slot=Tp)
                states_u = stale_lib.reset_slots(states_u, qm,
                                                 tokens_per_slot=Tp)

        finishing = any(s.active and s.local_step + 1 >= num_steps
                        for s in slots)
        # every slot's latents, gathered from their ranks when one finishes
        x_all = x if mesh is None or not finishing else \
            mesh.gather_samples(x)
        for i, slot in enumerate(slots):
            if not slot.active:
                continue
            slot.local_step += 1
            if slot.local_step >= num_steps:
                # a copy: x's rows are overwritten at the next admission
                out[slot.rid] = x_all[i].to("cpu", copy=True)
                reg.counter("dice_requests_total", "requests served",
                            lab).inc()
                if slot.rid in admit_time:
                    reg.histogram(
                        "dice_request_e2e_seconds",
                        "request end-to-end seconds (admission->sample)",
                        lab).observe(time.perf_counter()
                                     - admit_time.pop(slot.rid))
                free_slot(i)
        tick += 1
    _sync(dev)
    wall = time.perf_counter() - t0
    if pending_counts:
        for c in torch.stack(pending_counts).to("cpu").numpy():
            hist.update(c)

    # the modeled deployment, with the placements the run ended on
    lat = server.latency(B // server.n_dev, dataclasses.replace(
        server.dcfg, placements=plan_lib.placements_of(dcfg)))
    reg.gauge("dice_step_keys", "(plan, slotted) keys the step fn ran",
              lab).set_max(max(step_keys, len(rf_step.keys)))
    reg.gauge("dice_plan_variants", "StepPlan variants",
              lab).set_max(splan.num_variants)
    reg.counter("dice_wall_seconds_total",
                "measured wall seconds on the device", lab).inc(wall)
    ticks = int(reg.value("dice_ticks_total", lab))
    padded_slot_steps = int(reg.value("dice_padded_slot_steps_total", lab))
    stats = {
        **_where(dev, mesh),
        "ticks": ticks,
        "makespan_steps": tick,
        "padded_slot_steps": padded_slot_steps,
        "slot_occupancy": 1.0 - padded_slot_steps / max(1, ticks * B),
        "slotted_ticks": int(reg.value("dice_slotted_ticks_total", lab)),
        "admissions": int(reg.value("dice_admissions_total", lab)),
        "recycled_admissions": int(
            reg.value("dice_recycled_admissions_total", lab)),
        "steady_period": period,
        "wall_s": wall,
        "wall_s_per_tick": wall / max(1, ticks),
        "e2e_s": reg.histogram("dice_request_e2e_seconds",
                               labels=lab).snap(),
        **_modeled(lat, ticks),
        "buffer_bytes": int(reg.value("dice_buffer_bytes", lab)),
        "dispatch_bytes_total": reg.value("dice_dispatch_bytes_total", lab),
        "wire_bytes_total": reg.value("dice_wire_bytes_total", lab),
        "raw_bytes_total": reg.value("dice_raw_bytes_total", lab),
        "num_plan_variants": splan.num_variants,
        "step_keys": int(reg.value("dice_step_keys", lab)),
        "tick_variants": tick_variants,
        "tick_plans": tick_plans,
        "kernel_launches": _launches_since(before),
        "placement_reshards": int(_count(
            reg, "dice_placement_reshards_total", lab)),
        "placement_wire_scale": plan_lib.placement_wire_scale(dcfg),
    }
    if place_online:
        stats["routing_shares"] = hist.shares.tolist()
        stats["hist_updates"] = hist.updates
    if pool is not None:
        tot = paging_lib.ledger_totals(pool, mesh.ep_mesh)
        paged = {"paged_transfers": tot["transfers"],
                 "paged_bytes_in": tot["bytes_transferred"],
                 "peak_resident_expert_bytes": tot["peak_resident_bytes"],
                 "expert_hbm_budget": paging_lib.paging_of(dcfg).budget_bytes}
        if res is not None:
            paged.update(paging_fetch_errors=tot["fetch_errors"],
                         paging_fetch_retries=tot["fetch_retries"],
                         paging_stale_fallbacks=tot["stale_fallbacks"])
        _publish_paging(reg, paged, lab)
        stats.update(paged)
    if res is not None:
        stats.update({
            "quarantined": int(_count(reg, "dice_quarantined_slots_total",
                                      lab)),
            "requeued": int(_count(reg, "dice_requeued_requests_total", lab)),
            "shed": len(queue.shed),
            "shed_rids": sorted(rid for rid, _ in queue.shed),
            "queue_peak_depth": queue.peak_depth,
            "watchdog_breaches": int(_count(
                reg, "dice_watchdog_breaches_total", lab)),
            "injected_hop_delays": int(_count(
                reg, "dice_injected_hop_delays_total", lab)),
            "demotions": list(ctrl.demotions),
            "demotion_ticks": demotion_ticks,
            "fault_events": {
                nm: float(_count(reg, "dice_fault_events_total",
                                 {**lab, "event": nm}))
                for nm in FAULT_EVENTS},
        })
    server.metrics.merge(reg)
    return out, stats


def _tick_observations(aux: dict, lanes: Optional[torch.Tensor], wall: float,
                       mesh, own: slice, B: int):
    """(telemetry block, fault counts, wall time, per-slot bad-lane flags)
    of one engine tick, on the host from one device-to-host copy; None for
    what the tick did not compute.  ``lanes`` (B_loc,) flags this rank's
    non-finite slots.  Over a mesh the vector first goes through one
    all-reduce (max) with the wall time and every slot's flags (each rank
    fills its own, zeros elsewhere), so every rank holds the same values;
    the telemetry and fault counts are equal on every rank already."""
    parts = [aux[k].reshape(-1).to(torch.float32)
             for k in ("telemetry", "fault_events") if k in aux]
    head = sum(p.numel() for p in parts)
    if mesh is not None:
        flags = torch.zeros((B,), dtype=torch.float32, device=mesh.device)
        if lanes is not None:
            flags[own] = lanes
        parts += [flags, torch.tensor([wall], dtype=torch.float32,
                                      device=mesh.device)]
        vec = mesh.all_reduce_max(torch.cat(parts)).to("cpu").numpy()
        wall = float(vec[-1])
    else:
        if lanes is not None:
            parts.append(lanes)
        vec = torch.cat(parts).to("cpu").numpy()
    tel = fe = None
    at = 0
    if "telemetry" in aux:
        n = aux["telemetry"].numel()
        tel = vec[:n].reshape(tuple(aux["telemetry"].shape))
        at = n
    if "fault_events" in aux:
        fe = vec[at:head]
    bad = None if lanes is None else vec[head:head + B] > 0
    return tel, fe, wall, bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--schedule", choices=list(SCHEDULES), default="dice")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tiny", action="store_true", default=True,
                    help="small model (default); --no-tiny for XL shapes")
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--ckpt", default=None,
                    help="serve the weights of this checkpoint (the "
                         "reference's format, either package's writer), "
                         "checked against the config's param tree")
    ap.add_argument("--codec", choices=list(CODEC_KINDS), default="none",
                    help="wire codec for light/stale steps; refresh steps "
                         "stay lossless")
    ap.add_argument("--topk-frac", type=float, default=0.125,
                    help="fraction of residual entries the topk_residual "
                         "codec keeps per token")
    ap.add_argument("--guidance", type=float, default=1.5)
    ap.add_argument("--n-dev", type=int, default=None,
                    help="device count of the modeled deployment (latency "
                         "model only; default the --ep size, else 8)")
    ap.add_argument("--ep", type=int, default=0,
                    help="run expert-parallel over N spawned ranks, one "
                         "process each (needs --backend); 0 = one process "
                         "without a mesh")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replica groups of the dp x ep x "
                         "patch mesh: the batch shards over dp x ep, each "
                         "group holds the experts once (needs --backend)")
    ap.add_argument("--patch", type=int, default=1,
                    help="patch-parallel split of the image tokens: "
                         "displaced patch attention runs sharded, one K/V "
                         "all-gather per layer (fixed batches only; needs "
                         "--backend)")
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="two-tier fabric: devices per host (0 = flat).  "
                         "The ring then orders its hops intra-host first "
                         "and the latency model prices host-crossing hops "
                         "at --inter-host-bw")
    ap.add_argument("--inter-host-bw", type=float, default=0.2e9,
                    help="inter-host trunk bandwidth in B/s for the "
                         "two-tier latency model (default 0.2 GB/s)")
    ap.add_argument("--placement", choices=("identity", "greedy"),
                    default="identity",
                    help="expert placement: 'greedy' makes the continuous "
                         "engine accumulate a routing histogram and re-lay-"
                         "out the experts (affinity bin-pack, hot-expert "
                         "replicas) when it drifts")
    ap.add_argument("--replicate-top", type=int, default=0,
                    help="hottest experts replicated on every rank (served "
                         "locally, off the wire); 0 disables")
    ap.add_argument("--paging", choices=["off", "on"], default="off",
                    help="expert paging: keep each rank's routed experts in "
                         "pinned host memory and fetch one MoE layer's "
                         "shard ahead of use on a copy stream (needs --ep > "
                         "1; also lifts the experts %% ep == 0 restriction "
                         "with zero phantom experts)")
    ap.add_argument("--expert-hbm-budget", type=int, default=0,
                    help="per-device byte budget for resident routed-expert "
                         "shards under --paging on: 0 (default) resolves to "
                         "the tightest feasible window, negative means "
                         "unbounded")
    ap.add_argument("--paging-depth", type=int, default=1,
                    help="prefetch distance in MoE layers: layer i fetches "
                         "layer i + depth, so the copy runs behind the "
                         "layers in between")
    ap.add_argument("--backend", choices=list(mesh_lib.BACKENDS),
                    default=None,
                    help="torch.distributed backend of the ep mesh: nccl "
                         "needs one card per rank; gloo runs on the CPU or "
                         "with ranks sharing one card")
    ap.add_argument("--overlap", choices=("blocking", "ring"),
                    default="blocking",
                    help="dispatch/combine engine over the mesh: two "
                         "all-to-alls, or the ring of 2 (ep - 1) hops")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="drain the requests through the continuous-"
                         "batching engine (--max-batch slots) instead of "
                         "one fixed batch")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--obs", action="store_true",
                    help="per-layer staleness telemetry, measured step "
                         "wall times and host-phase tracing (samples stay "
                         "bit-identical to an obs-off run)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace-event JSON of host phases "
                         "to this path (implies --obs)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry here after the run: "
                         "Prometheus text, or a JSON snapshot when the "
                         "path ends in .json (implies --obs)")
    ap.add_argument("--faults", default=None,
                    help="resilience / chaos spec: comma-separated "
                         "key=value, e.g. 'seed=7,corrupt=0.05,"
                         "corrupt_dispatch=0.02,poison_tick=3,"
                         "hop_delay=0.5:0.01,queue=16'.  Fault keys inject "
                         "seeded failures; policy keys (guards, quarantine, "
                         "demote_after, step_deadline_factor, "
                         "codec_err_limit, queue, admit_deadline, requeues, "
                         "and under --paging on: paging_err, "
                         "paging_delay=rate:seconds, retries, backoff, "
                         "fetch_deadline, stale_fallback) tune the "
                         "degradation ladder.  'off' disables")
    args = ap.parse_args(argv)
    if args.ep < 0 or args.dp < 1 or args.patch < 1:
        ap.error("--ep must be >= 0, --dp and --patch >= 1")
    meshed = bool(args.ep) or args.dp > 1 or args.patch > 1
    if meshed and args.backend is None:
        ap.error("--ep, --dp and --patch need --backend (nccl: one card per "
                 "rank; gloo: the CPU, or ranks sharing one card)")
    lanes = max(1, args.ep) * args.dp
    if args.continuous:
        if args.patch > 1:
            ap.error("--continuous does not compose with --patch (slot "
                     "surgery assumes batch-only sharding)")
        if args.max_batch % lanes:
            ap.error(f"--max-batch {args.max_batch} must divide over the "
                     f"{lanes} dp x ep lanes")
    elif args.requests % lanes:
        ap.error(f"--requests {args.requests} must divide over the {lanes} "
                 f"dp x ep lanes")
    if not meshed:
        _serve_cli(args)
        return
    _, counts = mesh_lib.spawn(_serve_cli_rank,
                               lanes * args.patch, dp=args.dp,
                               patch=args.patch, backend=args.backend,
                               device=args.device, args=(args,))
    for r, c in enumerate(counts):
        print(f"  rank {r} kernel launches {c}")


def _serve_cli_rank(mesh, args) -> None:
    """One rank of ``main --ep N``."""
    _serve_cli(args, mesh)


def _serve_cli(args, mesh=None) -> None:
    """The CLI's run, on one device or as one rank of ``mesh`` (rank 0
    prints and writes the outputs)."""
    cfg = tiny() if args.tiny else xl_config()
    dcfg = dataclasses.replace(SCHEDULES[args.schedule](),
                               overlap=args.overlap)
    obs_on = bool(args.obs or args.trace_out or args.metrics_out)
    resilience = fault_lib.parse_resilience(args.faults)
    paging = None
    if args.paging == "on":
        paging = paging_lib.PagingSpec(
            budget_bytes=(None if args.expert_hbm_budget < 0
                          else args.expert_hbm_budget),
            depth=args.paging_depth)
    params = expert_pool = None
    if args.ckpt:
        # the like tree holds shapes only; each rank keeps its experts
        dev = resolve_device(args.device) if mesh is None else mesh.device
        like = init_dit(cfg, generator=None)
        if paging is not None and args.ep > 1:
            # streamed straight into the paging split: the rank's expert
            # rows into its host pool, the rest onto the device
            params, expert_pool = paging_lib.load_pooled_checkpoint(
                args.ckpt, like, n_dev=args.ep, rank=mesh.rank_in("ep"),
                device=dev)
        else:
            params = load_checkpoint(
                args.ckpt, like, device=dev,
                experts=None if mesh is None
                else shard_lib.expert_slice(cfg.num_experts, mesh))
    server = DiceServer(cfg, dcfg, params=params, seed=args.seed,
                        device=None if mesh is not None else args.device,
                        n_dev=args.n_dev, mesh=mesh,
                        compress=CompressConfig(codec=args.codec,
                                                topk_frac=args.topk_frac),
                        obs=ObsConfig(enabled=obs_on),
                        resilience=resilience,
                        devices_per_host=args.devices_per_host,
                        inter_host_bw=args.inter_host_bw,
                        placement=placement_lib.PlacementConfig(
                            mode=args.placement,
                            replicate_top=args.replicate_top),
                        paging=paging, expert_pool=expert_pool)
    reqs = [Request(class_id=i % cfg.num_classes, rid=i)
            for i in range(args.requests)]
    splan = server.plan(args.steps)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    say(f"serving {len(reqs)} requests, schedule={args.schedule}, "
        f"{args.steps} steps, model={cfg.name}, device={server.device}"
        + (f", wire codec {args.codec}" if args.codec != "none" else "")
        + (f", continuous over {args.max_batch} slots"
           if args.continuous else "")
        + (f", weights from {args.ckpt}" if args.ckpt else "")
        + (", telemetry on" if obs_on else "")
        + (", resilience on"
           + (f" (fault seed {resilience.faults.seed})"
              if resilience.faults is not None else "")
           if server.dcfg.resilience is not None else "")
        + (f", expert-parallel over {mesh.world_size} ranks ({mesh.backend}, "
           f"{plan_lib.normalize_overlap(server.dcfg, server.n_ep).overlap})"
           + (", mesh " + " x ".join(f"{n}-way {a}"
                                     for a, n in mesh.shape.items())
              if isinstance(mesh, mesh_lib.HierMesh) else "")
           if mesh is not None else "")
        + (f", ring hops {server.hop_schedule}"
           if server.hop_schedule is not None else "")
        + (f", placement {args.placement} (replicate top "
           f"{args.replicate_top})" if args.placement != "identity" else "")
        + (f", expert paging (depth {args.paging_depth}, budget "
           f"{paging_lib.paging_of(server.dcfg).budget_bytes} bytes/rank)"
           if server.expert_pool is not None else ""))
    say(f"step plan: {splan.num_variants} variants for "
        f"{splan.num_steps} steps "
        f"({[len(splan.steps_of_variant(v)) for v in range(splan.num_variants)]}"
        f" steps each)")
    if args.continuous:
        arrivals = None
        if (resilience is not None and resilience.faults is not None
                and resilience.faults.burst_size > 0):
            arrivals = fault_lib.bursty_arrivals(
                len(reqs), rate=1.0, burst_size=resilience.faults.burst_size)
        out, stats = serve_continuous(server, reqs, max_batch=args.max_batch,
                                      num_steps=args.steps,
                                      guidance=args.guidance, seed=args.seed,
                                      arrival_steps=arrivals)
        finite = all(bool(torch.isfinite(s).all()) for s in out.values())
        say(f"served {len(out)} requests continuously, finite={finite}")
        stats["tick_variants"] = (f"{len(stats['tick_variants'])} ticks, "
                                  f"{len(set(stats['tick_variants']))} keys")
        del stats["tick_plans"]
        if "routing_shares" in stats:
            shares = np.asarray(stats.pop("routing_shares"))
            stats["max_routing_share"] = float(shares.max())
    else:
        samples, stats = server.generate(reqs, num_steps=args.steps,
                                         guidance=args.guidance)
        say(f"samples: {tuple(samples.shape)}, "
            f"finite={bool(torch.isfinite(samples).all())}")
        if "telemetry" in stats:
            # per-field means over steps and layers
            tel = np.mean(stats.pop("telemetry"), axis=(0, 1))
            stats["telemetry_means"] = " ".join(
                f"{f}={v:.6g}" for f, v in zip(obs_fields.TELEMETRY_FIELDS,
                                               tel))
    for k, v in stats.items():
        if isinstance(v, list) and v and k.endswith(("_s", "_per_step")):
            v = f"[{v[0]:.6g} ... {v[-1]:.6g}] ({len(v)} steps)"
        elif isinstance(v, float):
            v = f"{v:.6g}"
        say(f"  {k:26s} {v}")
    if mesh is not None and mesh.rank != 0:
        return
    if args.trace_out:
        server.tracer.write(args.trace_out)
        print(f"wrote step trace to {args.trace_out} "
              f"({len(server.tracer.events)} events)")
    if args.metrics_out:
        write_metrics(server.metrics, args.metrics_out)
        print(f"wrote metrics to {args.metrics_out}")


if __name__ == "__main__":
    main()
