"""Expert paging: a pinned host-RAM expert pool and planned prefetch (port
of ``repro.core.paging``).

Without paging every rank of an ep mesh keeps its routed-expert shard of
every layer on the device, and the experts must divide over the mesh.
With paging the rank's shards live in host memory, in an
:class:`ExpertPool`, and the device holds a bounded working set: layer
``i`` issues the fetch of layer ``i + depth`` (the plan's ``prefetch``)
before its own attention, so the host-to-device copy runs on the pool's
copy stream behind the attention, the wire and the expert FFN already
enqueued.

The pool pads the expert dimension to the next multiple of the ep size
(``E_pad``) with zero-weight *phantom experts* that the router never
selects (its logits cover the real ``E`` only), so any expert count
serves on any mesh.  With ``E_pad == E`` the padded wire is the resident
one, and paged samples equal resident samples bit for bit.

One process runs each rank, so a rank's pool holds rows ``[j * e_loc,
(j + 1) * e_loc)`` of the padded stacks only (``rank=None`` keeps every
rank's rows, for a single process).  On a card the rows sit in pinned
memory, and each rank owns ``depth + 1`` device slot buffers, made once
per run (:meth:`ExpertPool.begin_run`), each holding the three leaves of
one layer's shard.  :meth:`ExpertPool.fetch` runs the reference's
sequence: reserve a residency slot, then the fallible attempt (seeded
fault rolls, retry with backoff under a deadline, the stale fallback),
then the copy on the pool's copy stream, then an event.  The consumer
waits on that event before the layer's expert compute, and the copy into
a slot waits on the event recorded after the last kernel that read it.
On the CPU the copies are synchronous; the ledger is the same.

The card serves the host-to-device copies queued on one stream before it
turns to another stream's, and the step itself waits for small ones (a
gloo exchange's received payloads), which a layer's copy queued whole
would hold behind all of it (``chip_smoke.py`` phase 11b).  So on a card
a copy thread issues each fetch's copies through the native
``dice_paced_copy`` (``csrc/paced_copy.cu``): ``PACE_BYTES`` at a time,
each piece finished before the next is queued.


The ledger is the reference's: each device owns a window of ``depth +
1`` layers, every fetch appends and evicts the oldest beyond it, and the
realized ``peak_resident_bytes`` is the quantity the
``--expert-hbm-budget`` contract bounds.  Over a mesh each rank keeps the
ledger of its own ``j``; :func:`ledger_totals` sums the counts and takes
the peak's maximum over the ep group, which equals the reference's one
pool.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# the pooled (paged) leaves of one MoE layer's param dict, in fetch order
EXPERT_LEAF_NAMES = ("experts_gate", "experts_up", "experts_down")
# bytes a card-side copy queues at a time (about 0.6 ms over PCIe 5)
PACE_BYTES = 32 << 20


class PagingFetchError(RuntimeError):
    """A paging fetch failed (injected or real) past every retry, with the
    stale-shard fallback disabled."""


@dataclass(frozen=True)
class PagingSpec:
    """Planned paging shape of a run, stamped onto every
    :class:`repro_torch.core.plan.LayerAction` (hashable, like ``codec``).

    budget_bytes
        per-device budget for resident routed-expert shards; every planned
        residency window is validated against it and the realized peak
        stays <= it.  ``None`` is unbounded (paging for the ``E % n_dev``
        decoupling alone); ``0`` is the "auto" sentinel the entry points
        resolve to the tightest feasible budget.
    depth
        prefetch distance in MoE layers: layer ``i`` issues the fetch of
        layer ``i + depth`` before its own compute, and each device keeps
        ``depth + 1`` layer-shard slots.
    """
    budget_bytes: Optional[int] = None
    depth: int = 1

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"paging depth must be >= 1, got {self.depth}")
        if self.budget_bytes is not None and self.budget_bytes < 0:
            raise ValueError(
                f"expert HBM budget must be >= 0, got {self.budget_bytes}")


def padded_experts(num_experts: int, n_dev: int) -> int:
    """``E_pad``: the expert count rounded up to a multiple of ``n_dev``."""
    return -(-num_experts // n_dev) * n_dev


def expert_rows(num_experts: int, n_dev: int, rank: int) -> slice:
    """The real expert rows in rank ``rank``'s shard of the padded stack
    (the rest of its ``e_loc`` rows are phantoms)."""
    e_loc = padded_experts(num_experts, n_dev) // n_dev
    lo = rank * e_loc
    return slice(min(lo, num_experts), min(lo + e_loc, num_experts))


def _host_rows(t: torch.Tensor, rows: int, full: bool, lo: int, hi: int,
               num_experts: int, pin: bool) -> torch.Tensor:
    """``rows`` rows of the padded stack, from a full (``full``) or an
    already-sliced stack ``t``, zero past the real experts, in host memory
    (pinned with ``pin``)."""
    real = t[lo:min(hi, num_experts)] if full else t
    out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                      pin_memory=pin)
    out[:real.shape[0]].copy_(real)
    return out


class _Slot:
    """One device buffer of a layer's three shards, with the event its
    copy records (``ready``) and the one recorded after the last kernel
    that read it (``free``).  On a card the copy thread sets ``issued``
    once it has recorded ``ready`` (or failed, leaving ``error``)."""

    def __init__(self, shapes, device: torch.device):
        self.leaves = {k: torch.empty(shape, dtype=dt, device=device)
                       for k, (shape, dt) in zip(EXPERT_LEAF_NAMES, shapes)}
        cuda = device.type == "cuda"
        self.ready = torch.cuda.Event() if cuda else None
        self.free = torch.cuda.Event() if cuda else None
        self.issued = threading.Event()
        self.issued.set()
        self.error = None

    def acquire(self) -> Dict[str, torch.Tensor]:
        """The leaves, once the current stream has waited for their copy
        (on a card the host first waits until the copy thread has queued
        the last piece of it)."""
        if self.ready is not None:
            self.issued.wait()
            if self.error is not None:
                raise self.error
            torch.cuda.current_stream().wait_event(self.ready)
        return self.leaves

    def release(self) -> None:
        """Mark the point after the last kernel that reads the leaves: the
        next copy into this slot waits for it."""
        if self.free is not None:
            self.free.record(torch.cuda.current_stream())


def _copy_loop(jobs: queue.Queue, stream, device: torch.device) -> None:
    """The pool's copy thread: for each ``(slot, sources)`` job in order,
    wait on the slot's last reader, copy each leaf in ``PACE_BYTES``
    pieces, record ``ready``.  A ``None`` job ends the thread.  A failure,
    also in the thread's set-up, goes to each job's consumer."""
    setup_error = None
    try:
        from repro_torch.kernels.build import library
        torch.cuda.set_device(device)
        copy = library().dice_paced_copy
    except BaseException as e:  # noqa: BLE001 -- raised by acquire
        setup_error = e
    while True:
        job = jobs.get()
        if job is None:
            return
        slot, src = job
        try:
            if setup_error is not None:
                raise setup_error
            stream.wait_event(slot.free)
            for k in EXPERT_LEAF_NAMES:
                dst = slot.leaves[k]
                err = copy(dst.data_ptr(), src[k].data_ptr(),
                           dst.numel() * dst.element_size(), PACE_BYTES,
                           device.index or 0, stream.cuda_stream)
                if err != 0:
                    raise RuntimeError(f"paged copy: CUDA error {err}")
            slot.ready.record(stream)
        except BaseException as e:  # noqa: BLE001 -- raised by acquire
            slot.error = e
        slot.issued.set()


class ExpertPool:
    """Host-RAM owner of the routed-expert stacks of a rank (or of every
    rank, ``rank=None``), serving per-layer shards to the device.

    ``layers`` maps MoE layer index -> ``{"experts_gate": (E, d, f),
    "experts_up": (E, d, f), "experts_down": (E, f, d)}`` tensors or
    arrays: the full expert set, or, with ``num_experts`` and ``rank``
    given, the rank's real rows (:func:`expert_rows`) only.  Each stack is
    padded to ``E_pad`` with zero phantom rows, so device ``j`` owns the
    contiguous shard ``[j * e_loc, (j + 1) * e_loc)``.  ``device`` is
    where shards are fetched to; on a card the host rows are pinned.
    """

    def __init__(self, layers, *, n_dev: int, rank: Optional[int] = None,
                 num_experts: Optional[int] = None, device=None):
        if n_dev < 1:
            raise ValueError(f"n_dev must be >= 1, got {n_dev}")
        if not layers:
            raise ValueError("ExpertPool needs at least one MoE layer")
        if rank is not None and not 0 <= rank < n_dev:
            raise ValueError(f"rank {rank} is not in [0, {n_dev})")
        self.n_dev = n_dev
        self.rank = rank
        first = min(layers)
        if num_experts is None:
            num_experts = int(layers[first]["experts_gate"].shape[0])
        self.num_experts = int(num_experts)
        self.e_pad = padded_experts(self.num_experts, n_dev)
        self.e_loc = self.e_pad // n_dev
        self.device = torch.device("cpu" if device is None else device)
        pin = self.device.type == "cuda"
        if pin and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        lo = 0 if rank is None else rank * self.e_loc
        hi = self.e_pad if rank is None else lo + self.e_loc
        share = len(range(self.num_experts)[expert_rows(
            self.num_experts, n_dev, rank)]) if rank is not None else None
        self._layers: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, leaves in layers.items():
            got = {k: torch.as_tensor(v) for k, v in leaves.items()}
            missing = [k for k in EXPERT_LEAF_NAMES if k not in got]
            if missing:
                raise ValueError(f"MoE layer {i} is missing expert leaves "
                                 f"{missing}")
            rows = got["experts_gate"].shape[0]
            if rows != self.num_experts and rows != share:
                raise ValueError(
                    f"MoE layer {i} has {rows} experts, layer {first} has "
                    f"{self.num_experts}; the pool requires a uniform "
                    f"expert count")
            full = rows == self.num_experts
            self._layers[i] = {
                k: _host_rows(got[k], hi - lo, full, lo, hi,
                              self.num_experts, pin)
                for k in EXPERT_LEAF_NAMES}
        # -- transfer + residency ledger (the reference's) -----------------
        self._lock = threading.Lock()
        self.transfers = 0
        self.bytes_transferred = 0
        self._resident: Dict[int, list] = {}      # dev -> [layer, ...] window
        self._resident_window = 2                  # depth + 1, set per run
        self._peak_resident = 0
        # optional repro_torch.obs.trace.StepTracer: each fetch emits a
        # span (host time: the copy it enqueues runs later on the card)
        self.tracer = None
        # -- resilience: retry/backoff/deadline policy + seeded faults ------
        self.resilience = None
        self.fault_plan = None
        self.fetch_errors = 0             # failed attempts (retried ones too)
        self.fetch_retries = 0            # re-attempts issued
        self.stale_fallbacks = 0          # fetches served by the fallback
        self._fetch_seq: Dict[Tuple[int, int], int] = {}  # (dev, layer) -> n
        # -- device slots, made by begin_run ------------------------------
        self._slots: Dict[int, list] = {}
        self._copy_stream = None
        self._jobs = None               # the copy thread's queue, on a card

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self._layers)

    @property
    def layer_indices(self) -> Tuple[int, ...]:
        return tuple(sorted(self._layers))

    @property
    def num_wire_experts(self) -> int:
        """Padded expert count: the wire/dispatch-buffer expert space."""
        return self.e_pad

    @property
    def devices(self) -> Tuple[int, ...]:
        """The ep indices whose shards this process holds."""
        return tuple(range(self.n_dev)) if self.rank is None \
            else (self.rank,)

    def shard_shape_dtypes(self, layer: int):
        """(shape, dtype) of the three per-device shards of ``layer``, in
        :data:`EXPERT_LEAF_NAMES` order."""
        lv = self._layers[layer]
        return tuple(((self.e_loc,) + tuple(lv[k].shape[1:]), lv[k].dtype)
                     for k in EXPERT_LEAF_NAMES)

    def layer_shard_bytes(self, layer: int) -> int:
        """Per-device bytes one resident layer-shard occupies."""
        return sum(torch.Size(shape).numel() * dt.itemsize
                   for shape, dt in self.shard_shape_dtypes(layer))

    def window_bytes(self, layers) -> int:
        """Per-device bytes of a residency window (a set of layer indices
        simultaneously resident)."""
        return sum(self.layer_shard_bytes(i) for i in layers)

    def min_budget_bytes(self, depth: int = 1) -> int:
        """The tightest feasible per-device budget for ``depth``-ahead
        prefetch: the largest (depth+1)-layer sliding window."""
        idx = self.layer_indices
        win = depth + 1
        return max(self.window_bytes(idx[i:i + win])
                   for i in range(len(idx)))

    def total_host_bytes(self) -> int:
        """Host bytes this process holds (every rank's with ``rank=None``)."""
        return sum(v.numel() * v.element_size()
                   for lv in self._layers.values() for v in lv.values())

    # ------------------------------------------------------------------
    # plan validation
    # ------------------------------------------------------------------
    def validate_actions(self, actions) -> None:
        """Check every planned residency window fits the budget (raises
        before the first step rather than overflowing device memory), and
        size the ledger's eviction window from the plan's depth."""
        for a in actions:
            spec = getattr(a, "paging", None)
            if spec is None:
                continue
            self._resident_window = max(self._resident_window,
                                        spec.depth + 1)
            resident = getattr(a, "resident", None)
            if spec.budget_bytes and resident:
                need = self.window_bytes(resident)
                if need > spec.budget_bytes:
                    raise ValueError(
                        f"expert HBM budget {spec.budget_bytes} cannot hold "
                        f"the planned residency window {tuple(resident)} "
                        f"({need} bytes/device); the tightest feasible "
                        f"budget at depth {spec.depth} is "
                        f"{self.min_budget_bytes(spec.depth)} bytes")

    def validate_plan(self, splan) -> None:
        for variant in splan.variants:
            self.validate_actions(variant.actions)

    # ------------------------------------------------------------------
    # resilience policy
    # ------------------------------------------------------------------
    def set_resilience(self, res) -> None:
        """Install (or clear, with None) the run's ResilienceConfig; a
        FaultPlan is derived from its seeded FaultConfig when present."""
        from repro_torch.resilience.faults import FaultPlan
        with self._lock:
            self.resilience = res
            self.fault_plan = (FaultPlan(res.faults) if res is not None
                               and res.faults is not None else None)

    # ------------------------------------------------------------------
    # device slots and copies
    # ------------------------------------------------------------------
    def begin_run(self, depth: int = 1) -> None:
        """Make ``depth + 1`` device slots for each held device (kept when
        a run of the same depth already made them) and, on a card, the
        copy stream and its thread (ended when the pool is freed).  Slots
        are never reallocated inside a run: a fresh tensor per fetch on a
        side stream could be handed to the compute stream by the caching
        allocator while its copy is in flight."""
        n = depth + 1
        first = self.layer_indices[0]
        shapes = self.shard_shape_dtypes(first)
        for j in self.devices:
            if len(self._slots.get(j, ())) != n:
                if self._copy_stream is not None:
                    # the old slots may still be written: free them after
                    torch.cuda.current_stream().wait_stream(self._copy_stream)
                self._slots[j] = []             # free the old ones first
                self._slots[j] = [_Slot(shapes, self.device)
                                  for _ in range(n)]
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
            self._jobs = queue.Queue()
            threading.Thread(target=_copy_loop, name="expert-pool-copies",
                             args=(self._jobs, self._copy_stream,
                                   self.device), daemon=True).start()
            weakref.finalize(self, self._jobs.put, None)

    def _slot_of(self, layer: int, j: int) -> _Slot:
        if j not in self._slots:
            self.begin_run(self._resident_window - 1)
        slots = self._slots[j]
        return slots[self.layer_indices.index(layer) % len(slots)]

    def _load(self, layer: int, j: int) -> _Slot:
        """The copy: device ``j``'s shard of ``layer`` into its slot, on the
        copy stream behind the slot's last reader (synchronous on the
        CPU).  No ledger side effects."""
        slot = self._slot_of(layer, j)
        src = self.shard(layer, j)
        if self._copy_stream is None:
            for k in EXPERT_LEAF_NAMES:
                slot.leaves[k].copy_(src[k])
            return slot
        slot.issued.clear()
        slot.error = None
        self._jobs.put((slot, src))
        return slot

    def shard(self, layer: int, j: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
        """Device ``j``'s shard of ``layer`` as host tensors (no copy, no
        ledger): what a fetch delivers."""
        j = self._dev(j)
        lo = (j if self.rank is None else 0) * self.e_loc
        return {k: self._layers[layer][k][lo:lo + self.e_loc]
                for k in EXPERT_LEAF_NAMES}

    def _dev(self, j: Optional[int]) -> int:
        if j is None:
            if self.rank is None:
                raise ValueError("a pool of every rank needs the device j")
            return self.rank
        if j not in self.devices:
            raise ValueError(f"this pool holds the shards of {self.devices}, "
                             f"not of device {j}")
        return int(j)

    # ------------------------------------------------------------------
    # the ledger
    # ------------------------------------------------------------------
    def _reserve(self, j: int, layer: int) -> bool:
        """Claim a residency-window slot for ``layer`` on device ``j``
        BEFORE the fallible copy.  Returns whether the layer was already
        resident, so a failed fetch can release exactly what it claimed."""
        with self._lock:
            window = self._resident.setdefault(j, [])
            was_resident = layer in window
            if was_resident:
                window.remove(layer)        # re-fetch refreshes residency
            window.append(layer)
            while len(window) > self._resident_window:
                window.pop(0)
            return was_resident

    def _release(self, j: int, layer: int, was_resident: bool) -> None:
        """Undo a reservation after a failed fetch: a fetch that never
        delivered bytes never occupied its slot."""
        with self._lock:
            window = self._resident.get(j, [])
            if not was_resident and layer in window:
                window.remove(layer)

    def _commit(self, j: int, nbytes: int) -> None:
        """Record a delivered fetch: transfer counters plus the realized
        residency peak (measured at commit)."""
        with self._lock:
            self.transfers += 1
            self.bytes_transferred += nbytes
            live = self.window_bytes(self._resident.get(j, ()))
            if live > self._peak_resident:
                self._peak_resident = live

    def fetch(self, layer: int, j: Optional[int] = None) -> _Slot:
        """Reserve -> (fallible attempt, with injection/retry/backoff under
        a deadline) -> copy -> commit, for device ``j`` (default: the
        pool's rank).  Returns the slot; its :meth:`_Slot.acquire` gives
        the leaves once the copy is done.  On exhaustion the reservation is
        released and, when the resilience policy allows it, the shard is
        served anyway as the stale fallback: the weights are static, so
        the data is the same; no transfer is counted, only
        ``stale_fallbacks``.  An injected delay sleeps on the calling
        (kernel-issuing) thread."""
        tracer = self.tracer
        t_fetch = tracer.now() if tracer is not None else 0.0
        j = self._dev(j)
        res = self.resilience
        fplan = self.fault_plan
        with self._lock:
            seq = self._fetch_seq[(j, layer)] = \
                self._fetch_seq.get((j, layer), 0) + 1
        was_resident = self._reserve(j, layer)
        retries = res.paging_retries if res is not None else 0
        deadline = res.paging_deadline_s if res is not None else 0.0
        t_start = time.perf_counter()
        err = None
        for attempt in range(retries + 1):
            try:
                if fplan is not None:
                    if fplan.paging_delay(layer, j, seq, attempt):
                        time.sleep(fplan.cfg.paging_delay_s)
                    if fplan.paging_error(layer, j, seq, attempt):
                        raise PagingFetchError(
                            f"injected paging fetch fault (layer {layer}, "
                            f"dev {j}, seq {seq}, attempt {attempt})")
                slot = self._load(layer, j)
                nbytes = self.layer_shard_bytes(layer)
                self._commit(j, nbytes)
                if tracer is not None:
                    tracer.complete("paged_fetch", t_fetch, cat="paging",
                                    args={"layer": layer, "dev": j,
                                          "bytes": nbytes,
                                          "attempt": attempt})
                return slot
            except PagingFetchError as e:
                err = e
                with self._lock:
                    self.fetch_errors += 1
                if attempt < retries:
                    backoff = (res.paging_backoff_s * (2 ** attempt)
                               if res is not None else 0.0)
                    if deadline > 0 and (time.perf_counter() - t_start
                                         + backoff) > deadline:
                        break               # retrying would bust the deadline
                    with self._lock:
                        self.fetch_retries += 1
                    if backoff > 0:
                        time.sleep(backoff)
        self._release(j, layer, was_resident)
        if res is not None and res.stale_fallback:
            with self._lock:
                self.stale_fallbacks += 1
            if tracer is not None:
                tracer.complete("paged_fetch_fallback", t_fetch,
                                cat="paging", args={"layer": layer, "dev": j})
            return self._load(layer, j)
        raise err

    @property
    def peak_resident_bytes(self) -> int:
        """Realized per-device peak of the residency ledger: the max over
        devices of the bytes simultaneously held in layer-shard slots."""
        with self._lock:
            return self._peak_resident

    def reset_stats(self) -> None:
        with self._lock:
            self.transfers = 0
            self.bytes_transferred = 0
            self._resident = {}
            self._peak_resident = 0
            self.fetch_errors = 0
            self.fetch_retries = 0
            self.stale_fallbacks = 0
            self._fetch_seq = {}


def ledger_totals(pool: ExpertPool, ep_mesh=None) -> Dict[str, int]:
    """The pool's counts summed, and its peak maxed, over the ranks of
    ``ep_mesh`` (each holds the ledger of its own device): the reference's
    single pool's numbers.  Waits for the current stream on a card."""
    vals = [pool.transfers, pool.bytes_transferred, pool.fetch_errors,
            pool.fetch_retries, pool.stale_fallbacks]
    peak = pool.peak_resident_bytes
    if ep_mesh is not None and ep_mesh.size > 1:
        import torch.distributed as dist
        t = torch.tensor(vals, dtype=torch.int64, device=ep_mesh.device)
        dist.all_reduce(t, group=ep_mesh.group)
        p = torch.tensor([peak], dtype=torch.int64, device=ep_mesh.device)
        dist.all_reduce(p, op=dist.ReduceOp.MAX, group=ep_mesh.group)
        vals, peak = t.tolist(), int(p.item())
    keys = ("transfers", "bytes_transferred", "fetch_errors",
            "fetch_retries", "stale_fallbacks")
    return dict(zip(keys, map(int, vals)), peak_resident_bytes=peak)


# ---------------------------------------------------------------------------
# params <-> pool plumbing
# ---------------------------------------------------------------------------
def has_expert_leaves(params) -> bool:
    blocks = params.get("blocks", ())
    return any(any(k in blk.get("moe", {}) for k in EXPERT_LEAF_NAMES)
               for blk in blocks)


def pool_from_params(params, *, n_dev: int, rank: Optional[int] = None,
                     device=None) -> ExpertPool:
    """Build the pool from a DiT-MoE param tree whose expert stacks hold
    every expert or, over a mesh, rank ``rank``'s real rows
    (:func:`expert_rows`); the expert count is the router's width.
    ``params`` itself is not mutated."""
    layers = {}
    num_experts = None
    for i, blk in enumerate(params["blocks"]):
        moe = blk["moe"]
        num_experts = int(moe["router"].shape[-1])
        layers[i] = {k: moe[k] for k in EXPERT_LEAF_NAMES if k in moe}
    return ExpertPool(layers, n_dev=n_dev, rank=rank,
                      num_experts=num_experts, device=device)


def strip_expert_params(params):
    """The device-resident remainder: ``params`` minus the pooled routed-
    expert stacks (router, shared experts, attention, embeddings stay).
    Shallow-copies containers; leaf tensors are shared, not copied."""
    out = dict(params)
    out["blocks"] = [
        dict(blk, moe={k: v for k, v in blk["moe"].items()
                       if k not in EXPERT_LEAF_NAMES})
        for blk in params["blocks"]
    ]
    return out


def _layer_of(path: str) -> Optional[int]:
    """The block index of a flattened leaf path like
    ``.blocks[3].moe.experts_gate``, or None outside ``blocks``."""
    head, sep, rest = path.partition(".blocks[")
    if not sep or head:
        return None
    return int(rest.split("]", 1)[0])


def load_pooled_checkpoint(path: str, like, *, n_dev: int,
                           rank: Optional[int] = None, device=None):
    """Streamed checkpoint restore straight into the paging split.

    Reads the file (the reference's formats 1-3) one leaf at a time,
    checked against ``like`` (the port's param tree, meta tensors allowed)
    before the first buffer is read, and routes each leaf as it arrives:
    a routed-expert stack is cut to rank ``rank``'s real rows (every
    rank's with ``rank=None``) into the host pool, everything else goes
    to ``device`` (by default where
    :func:`~repro_torch.checkpoint.io.load_checkpoint` would put it).  Peak host memory is one leaf plus the pool.  Returns
    ``(stripped_params, pool)``, the pool fetching to ``device``."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.common.device import resolve_device
    leaves, _ = ckpt_io.flatten(like)
    if device is None:
        first = next((l for _, l in leaves if isinstance(l, torch.Tensor)
                      and l.device.type != "meta"), None)
        device = first.device if first is not None else resolve_device(None)
    device = torch.device(device)
    pool_layers: Dict[int, Dict[str, torch.Tensor]] = {}
    num_experts = None
    out = []
    for (leaf_path, _), t in zip(leaves,
                                 ckpt_io.load_checkpoint_leaves(path, like)):
        name = leaf_path.rsplit(".", 1)[-1]
        layer = _layer_of(leaf_path)
        if name in EXPERT_LEAF_NAMES and layer is not None:
            num_experts = t.shape[0]
            if rank is not None:
                t = t[expert_rows(num_experts, n_dev, rank)].clone()
            pool_layers.setdefault(layer, {})[name] = t
            out.append(None)               # placeholder, stripped below
        else:
            out.append(t.to(device) if device.type != "cpu" else t)
        del t
    restored = ckpt_io.unflatten(like, out)
    pool = ExpertPool(pool_layers, n_dev=n_dev, rank=rank,
                      num_experts=num_experts, device=device)
    return strip_expert_params(restored), pool


# ---------------------------------------------------------------------------
# config plumbing (beside plan.normalize_overlap / normalize_placement)
# ---------------------------------------------------------------------------
def paging_of(dcfg) -> Optional[PagingSpec]:
    """The planned paging spec of ``dcfg``, or None."""
    return getattr(dcfg, "paging", None)


def resolve_budget(dcfg, pool: ExpertPool):
    """Resolve the ``budget_bytes == 0`` "auto" sentinel to the tightest
    feasible per-device budget for the pool's geometry.  A no-op on
    explicit budgets and unbounded (None) specs.  Runs before plans are
    compiled: the resolved spec is stamped into every LayerAction."""
    spec = paging_of(dcfg)
    if spec is None or spec.budget_bytes != 0:
        return dcfg
    return dataclasses.replace(
        dcfg, paging=dataclasses.replace(
            spec, budget_bytes=pool.min_budget_bytes(spec.depth)))


def normalize_paging(dcfg, n_dev: int):
    """Strip ``dcfg.paging`` when no ep mesh of more than one rank backs
    the run (``n_dev`` its ep size): there every expert is local, the
    params keep their expert stacks, and plans stay equal to a resident
    config's, so the samples are bit-identical."""
    if n_dev > 1 or paging_of(dcfg) is None:
        return dcfg
    return dataclasses.replace(dcfg, paging=None)
