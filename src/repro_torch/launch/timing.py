"""Time a call on the card: wall time by CUDA events, or device time from
a ``torch.profiler`` trace."""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import torch


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    after a warm-up call.  It includes the host cost of each call (checks,
    ``torch.empty``, the launch): a kernel that runs shorter than its
    wrapper's host path is timed as the host path.  Inputs stay where the
    last call left them, so a working set under 50 MB is timed warm in L2."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(evt) -> float:
    """Self device time (us) of a ``key_averages()`` entry, under the
    attribute name of this PyTorch version."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _annotation(evt) -> bool:
    """A range the trace lists on the device beside the kernels (the
    schedule's ``ProfilerStep#`` step, a user's ``record_function``)."""
    return bool(getattr(evt, "is_user_annotation", False)) or evt.key.startswith("ProfilerStep")


def device_ms(fn, iters: int, launches_per_call: Optional[int] = None,
              attempts: int = 3) -> float:
    """Mean device time per call of ``fn``: the durations of the CUDA
    kernels in a ``torch.profiler`` trace of ``iters`` calls (after a
    warm-up call and a warm-up profiler step).  Each traced kernel name
    gives the mean of its traced launches times its launches a call (its
    traced launches over ``iters``, rounded), and their sum is the call's
    time: the trace can miss a few of many short launches, and a kernel's
    own mean is not biased by that, where a mean over every launch of the
    trace would be whenever the missed ones were of another kernel.  Host
    time between launches is not counted, so a kernel shorter than its
    wrapper's host path is timed as itself.  ``fn`` should launch only the
    kernels to be timed (a wrapper's ``torch.empty`` launches none).  A
    trace whose kernels round to no launch a call (late in a whole
    chip_smoke.py run one held none for 50 calls) or, given
    ``launches_per_call``, to another number a call, or that lost more
    than a tenth of the ``iters`` times ``launches_per_call`` launches, is
    never used: a fresh trace is taken, up to ``attempts`` in all, and then
    it raises.  (Whole chip_smoke.py runs have traced 39 of 40 launches
    once, and 38 of 40 in each of three traces.)"""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        # one warm-up step, traced and dropped, then the iters calls: the
        # tracer is already collecting when the timed calls begin
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not _annotation(e) and e.count]
        launches = sum(e.count for e in kernels)
        per_call = [round(e.count / iters) for e in kernels]
        if launches_per_call is None and sum(per_call) >= 1:
            break
        if (launches_per_call is not None and sum(per_call) == launches_per_call
                and 10 * launches >= 9 * iters * launches_per_call):
            break
    else:
        if launches_per_call is None:
            raise RuntimeError(f"device_ms: {launches} kernel launches traced for {iters} "
                               f"calls, {attempts} times; the profiler saw no device time")
        raise RuntimeError(f"device_ms: {launches} kernel launches traced for "
                           f"{iters} calls of {launches_per_call}, {attempts} times")
    return sum(device_us(e) / e.count * n for e, n in zip(kernels, per_call)) / 1e3


def kernel_ms(fn, iters: int, names: Sequence[str], attempts: int = 3) -> Dict[str, float]:
    """Device time per call of each kernel of ``names`` that ``fn``
    launches, from one ``torch.profiler`` trace of ``iters`` calls (after a
    warm-up call and a warm-up profiler step, as ``device_ms`` takes them).
    A traced kernel belongs to the one name its full name contains; its
    mean over its traced launches times its launches a call (its traced
    launches over ``iters``, rounded) is that name's time, so a launch the
    trace misses does not bias it.  Their sum is the call's device time:
    where a call of several launches spends its time, from the one trace.
    A trace in which a name has no launch (the profiler dropped them) is
    never used: a fresh one is taken, up to ``attempts`` in all, and then
    it raises.  A traced kernel that matches no name, or more than one,
    raises at once: it would be counted as some other kernel's time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        out = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or _annotation(e) or not e.count:
                continue
            owners = [n for n in names if n in e.key]
            if len(owners) != 1:
                raise RuntimeError(f"kernel_ms: traced kernel {e.key!r} matches "
                                   f"{len(owners)} of the names {list(names)}")
            per_launch = device_us(e) / 1e3 / e.count
            out[owners[0]] = (out.get(owners[0], 0.0)
                              + per_launch * max(1, round(e.count / iters)))
        missing = [n for n in names if n not in out]
        if not missing:
            return out
    raise RuntimeError(f"kernel_ms: no launch of {missing} traced for {iters} calls, "
                       f"{attempts} times")


def rotating(fn, sets):
    """A call of ``fn`` on the next input set each time, round robin: with
    sets that together outgrow the 50 MB L2, no call finds its inputs
    there."""
    turn = itertools.count()
    return lambda: fn(*sets[next(turn) % len(sets)])
