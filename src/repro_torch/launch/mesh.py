"""The serving mesh over ``torch.distributed`` (port of
``repro.launch.mesh``): the flat ``("ep",)`` mesh and the hierarchical
``dp x ep x patch`` one.

The reference runs one controller over ``n`` devices and ``shard_map``\\ s
each step over its mesh.  The port runs one process per rank: every rank
executes the same program on its slice of the batch, of the image tokens
and of the expert stacks, and the exchanges are collectives over process
groups.  :func:`spawn` starts the ranks.  The axes, outermost first:

* ``dp``: data-parallel replica groups; the batch shards over ``dp x ep``
  and every expert shard is held once per group;
* ``ep``: expert parallelism; the dispatch/combine all-to-alls (or the
  ring) run over this axis only, within each ``(dp, patch)`` slice;
* ``patch``: DistriFusion's patch parallelism; the image tokens shard
  over it, and each attention layer all-gathers its fresh K/V on it.

World ranks are laid out ``dp``-major, then ``ep``, then ``patch``.  Axes
of size 1 drop out: :func:`make_mesh` with ``dp = patch = 1`` builds the
flat :class:`EPMesh` it always did, and any other shape a
:class:`HierMesh`.

The backend is the caller's choice, never this module's:

* ``nccl`` when every rank has a card of its own (``cuda:{rank}``).  NCCL
  refuses two ranks on one device ("Duplicate GPU detected"), so
  :func:`make_ep_mesh` raises when ``nccl`` ranks would share a card;
* ``gloo`` on the CPU, and for ranks that share one card.  Gloo's
  collectives take CUDA tensors and copy them through the host; its
  point-to-point send and receive do not (a CUDA tensor fails with "Bad
  address"), so :meth:`EPMesh.exchange` copies each message through a
  pinned host buffer on that pairing.

"""
from __future__ import annotations

import pickle
import queue as queue_lib
import socket
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device

BACKENDS = ("nccl", "gloo")
# hierarchical axis order, outermost first
MESH_AXES = ("dp", "ep", "patch")
# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class EPMesh:
    """One rank's view of a 1-D ``("ep",)`` mesh: the process group, this
    rank, the ep size, the backend and the device the rank computes on."""
    group: Any
    rank: int
    size: int
    backend: str
    device: torch.device

    axis_names = ("ep",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"ep": self.size}

    @property
    def stages_p2p(self) -> bool:
        """Point-to-point messages go through pinned host buffers: gloo's
        send/recv read host memory only."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- the view every mesh gives (see HierMesh) --------------------------
    def rank_in(self, axis: str) -> int:
        return self.rank if axis == "ep" else 0

    @property
    def world_size(self) -> int:
        return self.size

    @property
    def lanes(self) -> int:
        """Batch shards: one per rank."""
        return self.size

    @property
    def lane(self) -> int:
        return self.rank

    @property
    def ep_mesh(self) -> "EPMesh":
        """The mesh the MoE exchanges run over: this one."""
        return self

    def gather_samples(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's batch rows, in rank order."""
        return self.all_gather(x)

    # -- collectives -------------------------------------------------------
    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Piece ``j`` of dim 0 goes to rank ``j``; piece ``j`` of the
        result came from rank ``j`` (``lax.all_to_all`` with
        ``split_axis=concat_axis=0, tiled=True``)."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0, in rank order."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over the ranks (``lax.pmean``)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out / self.size

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the ranks (``lax.pmax``)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def exchange(self, send: torch.Tensor, dst: int, recv: torch.Tensor,
                 src: int, tag: int) -> Callable[[], None]:
        """Start one ring hop: send ``send`` to rank ``dst`` and receive
        into ``recv`` from rank ``src``, as one ``batch_isend_irecv``.
        Returns a function that waits for both and leaves the received
        data in ``recv``.  On a staging mesh a CUDA ``send`` is copied to a
        pinned host buffer first (the copy waits for its producer; pass a
        host tensor from :func:`host_copy` to stage once for many hops) and
        a CUDA ``recv`` is filled from one after the wait.

        Untested with ``nccl`` over more than one rank (the order of the
        paired send/recv on NCCL's stream, and writes into views of
        ``recv``) until the 4-card NCCL cell of ROADMAP runs."""
        peer = dist.get_global_rank(self.group, dst) \
            if self.group is not None else dst
        from_ = dist.get_global_rank(self.group, src) \
            if self.group is not None else src
        s, r = send.contiguous(), recv
        if self.stages_p2p and s.device.type == "cuda":
            s = host_copy(s)
        if self.stages_p2p and r.device.type == "cuda":
            r = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, s, peer, self.group, tag),
            dist.P2POp(dist.irecv, r, from_, self.group, tag)])

        def wait():
            for w in works:
                w.wait()
            if r is not recv:
                recv.copy_(r)
        return wait


@dataclass(frozen=True)
class HierMesh:
    """One rank's view of the hierarchical ``dp x ep x patch`` mesh.

    ``rank`` is the world rank, ``(dp_i * ep + ep_i) * patch + patch_i``.
    ``groups`` holds this rank's process group of each axis of size > 1
    (its ``ep`` group: same dp and patch; its ``patch`` group: same dp
    and ep; its ``dp`` group: same ep and patch) and, with ``dp > 1``,
    ``inner``: the ``ep x patch`` ranks of its replica group.
    ``axis_names``, ``shape`` and :meth:`rank_in` mirror the reference's
    mesh, where axes of size 1 are absent."""
    rank: int
    dp: int
    ep: int
    patch: int
    backend: str
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a in MESH_AXES if getattr(self, a) > 1) or ("ep",)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in self.axis_names}

    def rank_in(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis == "dp":
            return self.rank // (self.ep * self.patch)
        if axis == "ep":
            return (self.rank // self.patch) % self.ep
        if axis == "patch":
            return self.rank % self.patch
        return 0

    @property
    def world_size(self) -> int:
        return self.dp * self.ep * self.patch

    @property
    def lanes(self) -> int:
        """Batch shards: the batch splits over ``dp x ep``."""
        return self.dp * self.ep

    @property
    def lane(self) -> int:
        return self.rank_in("dp") * self.ep + self.rank_in("ep")

    @property
    def patch_size(self) -> int:
        return self.patch

    @property
    def stages_p2p(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def ep_mesh(self) -> Optional[EPMesh]:
        """The rank's ep group as an :class:`EPMesh` (what the MoE
        exchanges run over), None when ``ep == 1``."""
        if self.ep == 1:
            return None
        return EPMesh(group=self.groups["ep"], rank=self.rank_in("ep"),
                      size=self.ep, backend=self.backend, device=self.device)

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over every rank: over the replica group first,
        then over ``dp``, so that dp replicas holding identical values give
        exactly the ``dp = 1`` mean (``(x + x) / 2 == x``)."""
        out = t.contiguous().clone()
        inner = self.world_size // self.dp
        if inner > 1:
            dist.all_reduce(out, group=self.groups.get("inner"))
            out = out / inner
        if self.dp > 1:
            dist.all_reduce(out, group=self.groups["dp"])
            out = out / self.dp
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over every rank."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def patch_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The patch group's ``t`` stacked along dim 0, in patch order."""
        return _all_gather(t, self.patch, self.groups.get("patch"))

    def gather_samples(self, x: torch.Tensor) -> torch.Tensor:
        """(B_loc, T_loc, ...) shards of every rank -> the whole
        (B, T, ...) batch: batch rows in lane order, tokens in patch
        order (one all-gather over the world)."""
        g = _all_gather(x, self.world_size, None)
        g = g.reshape((self.lanes, self.patch) + tuple(x.shape))
        g = g.transpose(1, 2)                   # (lanes, B_loc, patch, T_loc)
        return g.reshape((self.lanes * x.shape[0], self.patch * x.shape[1])
                         + tuple(x.shape[2:]))


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a pinned host buffer (waits for ``t``'s
    producer)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def rank_device(backend: str, rank: int, size: int,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device rank ``rank`` of ``size`` computes on.

    ``nccl``: ``cuda:{rank}``, one card per rank; raises where ranks would
    share a card (fewer cards than ranks, or one explicit ``device`` for
    several ranks).  ``gloo``: ``device`` for every rank, the card
    (``cuda:0`` for an index-less "cuda") unless the caller names the CPU
    (:func:`resolve_device`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is outside an ep mesh of {size}")
    if backend == "gloo":
        dev = resolve_device(device)
        # "cuda" is the default card, which every rank of a host shares
        return torch.device("cuda", 0) if dev == torch.device("cuda") else dev
    own = torch.device("cuda", rank)
    if device is not None:
        dev = torch.device(device)
        # an index-less "cuda" names one card for every rank
        index = dev.index if dev.index is not None else (0 if size == 1
                                                          else -1)
        if dev.type != "cuda" or index != rank:
            raise ValueError(
                f"backend 'nccl' needs one card per rank, cuda:{{rank}}; "
                f"device={str(dev)!r} would be shared by the {size} ranks "
                f"or is not this rank's card.  NCCL refuses two ranks on one "
                f"device ('Duplicate GPU detected'); use backend='gloo' for "
                f"ranks that share a card")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < size:
        raise ValueError(
            f"backend 'nccl' needs one card per rank: {size} ranks, {cards} "
            f"cards.  NCCL refuses two ranks on one device ('Duplicate GPU "
            f"detected'); use backend='gloo' for ranks that share a card")
    return own


def make_mesh(*, ep: int = 1, dp: int = 1, patch: int = 1, backend: str,
              device: Optional[Union[str, torch.device]] = None
              ) -> Union[EPMesh, HierMesh]:
    """This rank's mesh of ``dp x ep x patch`` ranks over the default
    process group, which must hold exactly that many.  ``dp = patch = 1``
    gives the flat :class:`EPMesh` of :func:`make_ep_mesh`; any other shape
    a :class:`HierMesh`, whose process groups every rank creates in the
    same order (``new_group`` is collective over the world)."""
    for name, size in (("dp", dp), ("ep", ep), ("patch", patch)):
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"{name}={size!r}: axis sizes must be integers "
                             f">= 1")
    if dp == 1 and patch == 1:
        return make_ep_mesh(ep, backend=backend, device=device)
    want = dp * ep * patch
    live = dist.is_initialized()
    rank = dist.get_rank() if live else 0
    dev = rank_device(backend, rank, want, device)
    if not live:
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "repro_torch.launch.mesh.spawn)")
    world = dist.get_world_size()
    if want != world:
        raise ValueError(f"mesh dp={dp} x ep={ep} x patch={patch} = {want} "
                         f"ranks must equal the world size {world}: the "
                         f"port's mesh is one process per rank")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def at(d, e, p):
        return (d * ep + e) * patch + p

    layouts = {
        "ep": [[at(d, e, p) for e in range(ep)]
               for d in range(dp) for p in range(patch)],
        "patch": [[at(d, e, p) for p in range(patch)]
                  for d in range(dp) for e in range(ep)],
        "dp": [[at(d, e, p) for d in range(dp)]
               for e in range(ep) for p in range(patch)],
        "inner": [[at(d, e, p) for e in range(ep) for p in range(patch)]
                  for d in range(dp)] if dp > 1 else [],
    }
    groups = {}
    for axis, members in layouts.items():
        for ranks in members:
            if len(ranks) < 2:
                continue
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return HierMesh(rank=rank, dp=dp, ep=ep, patch=patch, backend=backend,
                    device=dev, groups=groups)


def make_ep_mesh(ep: int = 0, *, backend: str,
                 device: Optional[Union[str, torch.device]] = None) -> EPMesh:
    """This rank's 1-D expert-parallel mesh over the default process group,
    which the caller (or :func:`spawn`) has initialised with ``backend``;
    ``ep == 0`` takes the whole world.  Never switches backend or device:
    a mismatch raises."""
    live = dist.is_initialized()
    rank = dist.get_rank() if live else 0
    world = dist.get_world_size() if live else max(ep, 1)
    ep = world if ep <= 0 else ep
    # raises for nccl on a shared card before anything touches the group
    dev = rank_device(backend, rank, ep, device)
    if not live:
        raise RuntimeError("make_ep_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "repro_torch.launch.mesh.spawn)")
    if ep != world:
        raise ValueError(f"ep={ep} must equal the world size {world}: the "
                         f"port's mesh is one process per ep rank")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return EPMesh(group=None, rank=rank, size=ep, backend=backend,
                  device=dev)


def axis_size(mesh, name: str) -> int:
    """Size of a named axis, 1 when absent."""
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


# ---------------------------------------------------------------------------
# launcher: one process per rank
# ---------------------------------------------------------------------------
def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(fn, args, rank: int, size: int, backend: str, device,
               port: int, timeout_s: float, threads: int, results,
               dp: int = 1, patch: int = 1) -> None:
    """Body of one spawned rank: init the process group, build the
    ``dp x ep x patch`` mesh, run ``fn(mesh, *args)`` with the launch
    counts set to 0, and report (rank 0's result, this rank's counts) or
    the traceback."""
    from repro_torch.kernels import ops
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank, timeout=timedelta(seconds=timeout_s))
        mesh = make_mesh(ep=size // (dp * patch), dp=dp, patch=patch,
                         backend=backend, device=device)
        ops.reset_launches()
        out = fn(mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        counts = dict(ops.LAUNCHES)
        payload = pickle.dumps(_to_cpu(out) if rank == 0 else None)
        results.put((rank, True, payload, counts))
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *, backend: str,
          device: Optional[Union[str, torch.device]] = None,
          args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int = 1, dp: int = 1, patch: int = 1
          ) -> Tuple[Any, List[Dict[str, int]]]:
    """Run ``fn(mesh, *args)`` in ``n`` spawned ranks over ``backend``, on
    the mesh ``dp x (n / (dp * patch)) x patch`` (the flat ep mesh by
    default).

    ``fn`` must be importable (a module-level function) and ``args``
    picklable.  Each rank sets ``torch.set_num_threads(threads)`` (0
    leaves it) and inits its process group with ``timeout_s``, which every
    collective inherits, so a hung exchange raises in the rank.  The parent
    waits at most ``timeout_s`` plus a margin for the ranks' reports and
    10 s for each join, terminates what is left, and raises if a rank
    failed, hung or died.  Returns (rank 0's result with its tensors on the
    CPU, every rank's ``kernels.ops.LAUNCHES`` counts over ``fn``)."""
    import torch.multiprocessing as mp
    if n % (dp * patch):
        raise ValueError(f"{n} ranks do not split into dp={dp} x patch="
                         f"{patch} groups")
    for r in range(n):                 # fail here, before any rank starts
        rank_device(backend, r, n, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    dev = None if device is None else str(device)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, n, backend, dev, port,
                               timeout_s, threads, results, dp, patch))
             for r in range(n)]
    for p in procs:
        p.start()
    reports: Dict[int, tuple] = {}
    deadline = time.monotonic() + timeout_s + 60.0
    error = None
    try:
        while len(reports) < n and error is None:
            try:
                rank, ok, payload, counts = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in reports]
                if dead:
                    # a report may still be in the pipe: one last look
                    try:
                        rank, ok, payload, counts = results.get(timeout=5.0)
                    except queue_lib.Empty:
                        error = (f"ep rank(s) {dead} exited without a report "
                                 f"(exit codes "
                                 f"{[procs[r].exitcode for r in dead]})")
                        continue
                elif time.monotonic() > deadline:
                    error = (f"ep ranks timed out after {timeout_s:.0f} s; "
                             f"reported: {sorted(reports)}")
                    continue
                else:
                    continue
            if not ok:
                error = f"ep rank {rank} of {n} ({backend}) failed:\n{payload}"
            reports[rank] = (payload, counts)
        if error is not None:
            # the other ranks' reports, which often name the cause
            while True:
                try:
                    rank, ok, payload, _ = results.get(timeout=2.0)
                except queue_lib.Empty:
                    break
                if not ok:
                    error += f"\nep rank {rank} failed too:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=10.0 if error is None else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    if error is not None:
        raise RuntimeError(error)
    result = pickle.loads(reports[0][0])
    return result, [reports[r][1] for r in range(n)]

