"""The ring engine's collective contract, checked on a profiled step (port
of ``check_ring_lowering`` and ``collective_counts`` of
``repro.launch.hlo_cost``).

The reference reads the compiled HLO of a step and counts its
collective-permutes and all-to-alls.  The port runs eagerly and has no
HLO: it reads a ``torch.profiler`` trace of one step instead and counts
the ``torch.distributed`` operations the step issued, by the names the
c10d dispatcher records for them on every backend (``c10d::send``,
``c10d::recv_``, ``c10d::alltoall_base_``, ...).  Those events come from
PyTorch itself, never from spans the port adds around its own calls, so
the check does not hold the port against itself.  A ring hop is one
``batch_isend_irecv`` of one send and one receive: a ring step over an
``n``-rank ep group issues ``2 (n - 1)`` of them per MoE layer call and
no all-to-all.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        rf_step(...)
    check_ring_lowering(prof, n_dev=4, moe_layer_calls=cfg.num_layers)
"""
from __future__ import annotations

from typing import Dict, Iterable, Union

# the c10d dispatcher's op names for each collective kind
C10D_OPS = {
    "send": ("c10d::send",),
    "recv": ("c10d::recv_",),
    "all_to_all": ("c10d::alltoall_base_", "c10d::alltoall_"),
    "all_reduce": ("c10d::allreduce_",),
    "all_gather": ("c10d::allgather_", "c10d::_allgather_base_",
                   "c10d::allgather_into_tensor_coalesced_"),
}


def collective_counts(trace: Union[Iterable[str], object]) -> Dict[str, int]:
    """How many collectives of each kind a profiled step issued.

    ``trace``: a finished ``torch.profiler.profile`` (its ``events()``) or
    an iterable of event names."""
    names = ([e.name for e in trace.events()] if hasattr(trace, "events")
             else list(trace))
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
