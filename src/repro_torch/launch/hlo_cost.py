"""The step cost analysis and the ring engine's collective contract (port
of ``repro.launch.hlo_cost``).

The reference reads the compiled HLO of a step: it counts its FLOPs, its
HBM traffic and its collectives (``analyze``), prices the collectives on a
two-tier fabric (``hetero_wire_seconds``) and checks the ring engine's
collective-permutes and all-to-alls (``check_ring_lowering``).  The port
runs eagerly and has no HLO: it runs the step once instead.

:func:`analyze_step` runs ``fn(*args)`` under three counters:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` for the aten ops
  it has formulas for (the matrix products), plus the hand-written
  kernels' work from their cost ledger (:mod:`repro_torch.kernels.cost`);
* bytes: a dispatch mode that adds each materialising aten op's operand
  and result bytes (views and allocations excluded): the reference's HBM
  proxy, op by op, since eager PyTorch fuses nothing; plus the kernels'
  bytes from the ledger;
* collectives: the same dispatch mode sees each ``torch.distributed``
  operation as the dispatcher op it runs on every backend
  (``c10d::send``, ``c10d::recv_``, ``c10d::allreduce_``, ...: the names
  in :data:`C10D_OPS`; the MoE exchange's
  ``_c10d_functional::all_to_all_single``), with its tensors.  These ops
  are PyTorch's own, never spans the port adds around its own calls, so
  the counts do not hold the port against itself.  A selective
  checkpoint's recompute answers a saved collective from its cache,
  before the mode, which then counts nothing: nothing went out.

It also tracks the live bytes of every storage the step creates, from
the arguments' own: the step's peak.  On ``meta`` tensors (the dry run)
all of this runs without storage or kernels: a kernel wrapper allocates
what the card would and records its work.  On CPU tensors a wrapper runs
its plain version, whose aten ops the mode counts as any other.

A ring hop is one ``batch_isend_irecv`` of one send and one receive: a
ring step over an ``n``-rank ep group issues ``2 (n - 1)`` of them per MoE
layer call and no all-to-all (:func:`check_ring_lowering`).

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        rf_step(...)
    check_ring_lowering(prof, n_dev=4, moe_layer_calls=cfg.num_layers)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef

# the c10d dispatcher's op names for each collective kind
C10D_OPS = {
    "send": ("c10d::send",),
    "recv": ("c10d::recv_",),
    "all_to_all": ("c10d::alltoall_base_", "c10d::alltoall_"),
    "all_reduce": ("c10d::allreduce_",),
    "all_gather": ("c10d::allgather_", "c10d::_allgather_base_",
                   "c10d::allgather_into_tensor_coalesced_"),
    "reduce_scatter": ("c10d::_reduce_scatter_base_", "c10d::reduce_scatter_",
                       "c10d::reduce_scatter_tensor_coalesced_"),
}
# the ops a dispatch mode sees: EPMesh.all_to_all's functional collective
# runs c10d::alltoall_base_ below the mode (none on meta tensors), which a
# profiler records
_FUNCTIONAL = "_c10d_functional::all_to_all_single"
_KIND_OF = {op: kind for kind, ops in C10D_OPS.items() for op in ops}
_KIND_OF[_FUNCTIONAL] = "all_to_all"


def _event_names(trace) -> List[str]:
    """The names of the profiled ops that :data:`C10D_OPS` counts, each op
    once: a dispatch mode that runs an op again below itself (a selective
    checkpoint's, the ``"dots"`` and ``"save_ffn"`` remat policies) records
    a second event of the same name inside the first's interval (under a
    ``PythonDispatchMode`` event), which is not counted.  A finished
    ``torch.profiler.profile`` is read through its raw kineto events,
    which spares building the (slow) event tree of every op."""
    if not hasattr(trace, "profiler"):
        return list(trace)
    wanted = {op for ops in C10D_OPS.values() for op in ops}
    spans = sorted((e.start_thread_id(), e.name(), e.start_ns(), e.end_ns())
                   for e in trace.profiler.kineto_results.events()
                   if e.name() in wanted)
    names, open_until = [], {}
    for tid, name, start, end in spans:
        if open_until.get((tid, name), -1) >= end:
            continue                          # inside an event of its own name
        open_until[(tid, name)] = end
        names.append(name)
    return names


def collective_counts(trace: Union[Iterable[str], object]) -> Dict[str, int]:
    """How many collectives of each kind a profiled step issued.

    ``trace``: a finished ``torch.profiler.profile`` (its ``events()``) or
    an iterable of event names."""
    names = _event_names(trace)
    return {kind: sum(names.count(op) for op in ops)
            for kind, ops in C10D_OPS.items()}


def check_ring_lowering(trace, *, n_dev: int,
                        moe_layer_calls: int) -> Dict[str, int]:
    """Verify the ring engine's contract on a profiled step.

    A ring step over an ``n_dev``-rank ep group must issue exactly
    ``2 (n_dev - 1)`` point-to-point hops (a send plus a receive each)
    for each of its ``moe_layer_calls`` MoE layer executions (the
    dispatch ring and its combine mirror), and no all-to-all, the
    collective the engine exists to decompose.  ``moe_layer_calls``
    counts layer executions in the step: the MoE layers per model
    forward, times two under classifier-free guidance, times two again
    for staggered mode's half-batch calls.

    Raises ``ValueError`` with the counts on a violation; returns the
    counts (:func:`collective_counts`) on success."""
    counts = collective_counts(trace)
    want = 2 * (n_dev - 1) * moe_layer_calls
    if counts["all_to_all"]:
        raise ValueError(
            f"ring step still issues {counts['all_to_all']} all-to-all(s); "
            f"expected none (counts: {counts})")
    if counts["send"] != want or counts["recv"] != want:
        raise ValueError(
            f"ring step issues {counts['send']} sends and {counts['recv']} "
            f"receives; expected 2*(n-1)*layer_calls = 2*{n_dev - 1}*"
            f"{moe_layer_calls} = {want} hops of one each (counts: {counts})")
    return counts


# ---------------------------------------------------------------------------
# the step cost analysis
# ---------------------------------------------------------------------------
@dataclass
class CostTotals:
    """What one run of a step did, per rank.  ``flops`` and ``bytes`` are
    the aten ops' (``aten_flops``, ``aten_bytes``) plus the kernels'
    (``kernels``: one :class:`~repro_torch.kernels.cost.KernelCost` a
    call); ``collective_bytes`` and ``collective_counts`` are by kind
    (:data:`C10D_OPS`; an all-to-all's bytes are its output's, an
    all-gather's its output's, an all-reduce's its tensors', a hop's its
    message's).  ``peak_bytes`` is the most that the step's storages held
    at once, the arguments' included (``argument_bytes``); ``output_bytes``
    the storages of the result that no argument holds."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    kernels: list = field(default_factory=list)
    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    def kernel_totals(self) -> Dict[str, Dict[str, float]]:
        """Calls, FLOPs and bytes by kernel."""
        out: Dict[str, Dict[str, float]] = {}
        for k in self.kernels:
            row = out.setdefault(k.name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            row["calls"] += 1
            row["flops"] += k.flops
            row["bytes"] += k.bytes
        return out


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


class _StorageTracker:
    """The live bytes of every storage registered with it, and their peak.
    A storage counts from its registration until it is freed (its weak
    reference expires).  Frees are found by a sweep, made only when a
    registration could set a new peak: between sweeps the running sum is
    an upper bound of the live bytes, so the peak stays exact."""

    def __init__(self):
        self.live: Dict[Any, int] = {}
        self.upper = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        n = st.nbytes()
        key = StorageWeakRef(st)
        if n == 0 or key in self.live:
            return
        self.live[key] = n
        self.upper += n
        if self.upper > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.upper)

    def sweep(self) -> None:
        for key in [k for k in self.live if k.expired()]:
            del self.live[key]
        self.upper = sum(self.live.values())


# the views and allocations that move no bytes
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "wait_tensor"}


def _step_mode(tracker: _StorageTracker, totals: CostTotals, coll: list):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _StepMode(TorchDispatchMode):
        """Bytes of the materialising aten ops, collectives' bytes, and the
        storages the step creates."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func._schema.name
            ins = _tensors(args) + _tensors(kwargs)
            outs = _tensors(out)
            if name in _KIND_OF:
                moved = outs or ins
                if name.startswith("c10d::alltoall") or "allgather" in name:
                    moved = ins[:1]            # the output buffer comes first
                elif name == "c10d::_reduce_scatter_base_":
                    moved = ins[1:2]           # the input, after the output
                coll.append((_KIND_OF[name], sum(map(_nbytes, moved))))
            elif not func.is_view and name.split("::")[-1] not in _NO_TRAFFIC:
                held = {_storage_key(t) for t in ins}
                totals.aten_bytes += sum(map(_nbytes, ins)) + sum(
                    _nbytes(t) for t in outs if _storage_key(t) not in held)
            for t in outs:
                tracker.add(t)
            return out

    return _StepMode()


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Any, CostTotals]:
    """Run ``fn(*args, **kwargs)`` once and count what it did (the module
    docstring): returns (its result, :class:`CostTotals`).  The storages
    of ``args`` and ``kwargs`` count as live from the start."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import cost

    tracker = _StorageTracker()
    totals = CostTotals()
    arg_keys = set()
    for t in _tensors(args) + _tensors(kwargs):
        key = _storage_key(t)
        if key not in arg_keys:
            arg_keys.add(key)
            totals.argument_bytes += t.untyped_storage().nbytes()
        tracker.add(t)
    coll: list = []
    first = len(cost.LEDGER)
    with FlopCounterMode(display=False) as flops:
        with _step_mode(tracker, totals, coll):
            out = fn(*args, **kwargs)
    totals.kernels = list(cost.LEDGER[first:])
    del cost.LEDGER[first:]
    for kind, nbytes in coll:
        totals.collective_counts[kind] = totals.collective_counts.get(kind, 0.0) + 1
        totals.collective_bytes[kind] = totals.collective_bytes.get(kind, 0.0) + nbytes
    totals.aten_flops = float(flops.get_total_flops())
    totals.flops = totals.aten_flops + sum(k.flops for k in totals.kernels)
    totals.bytes = totals.aten_bytes + sum(k.bytes for k in totals.kernels)
    tracker.sweep()
    totals.peak_bytes = tracker.peak
    out_keys = {_storage_key(t) for t in _tensors(out)}
    totals.output_bytes = sum(tracker.live.get(k, 0) for k in out_keys
                              if k not in arg_keys)
    return out, totals


def hetero_wire_seconds(totals: CostTotals, *, n_dev: int, link_bw: float,
                        devices_per_host: int = 0,
                        inter_host_bw: Optional[float] = None,
                        hop_schedule: Optional[Tuple[int, ...]] = None
                        ) -> Dict[str, float]:
    """Price the step's collectives on a (possibly two-tier) fabric: the
    reference's ``hetero_wire_seconds`` over :class:`CostTotals`.

    Homogeneous (``devices_per_host`` 0, or no ``inter_host_bw``): every
    kind costs its bytes over ``link_bw``.  Two-tier: ring hops (the
    reference's collective-permutes; here ``send``, whose bytes are the
    hop's message: ``recv`` moves the same bytes and is not priced again)
    walk ``hop_schedule`` (natural order when None) in rings of
    ``n_dev - 1`` launches, and each hop pays the slower of one chunk on
    the intra-host links and its ``hop_crossings`` chunks through the
    inter-host trunk.  Any other collective pays ``max(intra share /
    link_bw, cross share / inter_host_bw)``, the cross share ``(n - H) /
    (n - 1)`` of the payload: the fraction of a uniform exchange that
    leaves the host."""
    from repro_torch.core.overlap import hop_crossings

    H = devices_per_host
    hetero = (inter_host_bw is not None and 0 < H < n_dev
              and n_dev % H == 0 and inter_host_bw < link_bw)
    out: Dict[str, float] = {}
    for kind, byts in totals.collective_bytes.items():
        if kind == "recv":
            continue
        if not hetero:
            out[kind] = byts / link_bw
            continue
        launches = totals.collective_counts.get(kind, 0.0)
        if kind in ("send", "collective-permute") and launches and n_dev > 1:
            sched = (tuple(hop_schedule) if hop_schedule
                     else tuple(range(1, n_dev)))
            b_hop = byts / launches
            per_ring = sum(
                max(b_hop / link_bw,
                    hop_crossings(h, n_dev, H) * b_hop / inter_host_bw)
                for h in sched)
            out[kind] = per_ring * launches / len(sched)
        else:
            cross = (n_dev - H) / max(1, n_dev - 1)
            out[kind] = max((1.0 - cross) * byts / link_bw,
                            cross * byts / inter_host_bw)
    return out
