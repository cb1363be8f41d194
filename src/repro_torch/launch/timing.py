"""Time a call on the card: wall time by CUDA events, or device time from
a ``torch.profiler`` trace."""
from __future__ import annotations

import itertools
from typing import Optional

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
    warm-up call and a warm-up profiler step), averaged over the launches the trace holds, times the
    launches a call makes (the traced launches over ``iters``, rounded: the
    trace can miss a few of many short launches).  Host time between
    launches is not counted, so a kernel shorter than its wrapper's host
    path is timed as itself.  ``fn`` should launch only the kernels to be
    timed (a wrapper's ``torch.empty`` launches none); raises if the trace
    holds no device time.  Given ``launches_per_call``, a trace that holds
    another number of launches than ``iters`` times that is never
    averaged (it dropped kernels, and its mean would be wrong): a fresh
    trace is taken, up to ``attempts`` in all, and then it raises.  (In a
    whole chip_smoke.py run a trace of 40 launches of 0.13-0.15 ms once
    held 39.)"""
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
                   and not _annotation(e)]
        launches = sum(e.count for e in kernels)
        if launches_per_call is None or launches == iters * launches_per_call:
            break
    else:
        raise RuntimeError(f"device_ms: {launches} kernel launches traced for "
                           f"{iters} calls of {launches_per_call}, {attempts} times")
    per_call = round(launches / iters)
    if per_call < 1:
        raise RuntimeError(f"device_ms: {launches} kernel launches traced for "
                           f"{iters} calls; the profiler saw no device time")
    return sum(device_us(e) for e in kernels) / 1e3 / launches * per_call


def rotating(fn, sets):
    """A call of ``fn`` on the next input set each time, round robin: with
    sets that together outgrow the 50 MB L2, no call finds its inputs
    there."""
    turn = itertools.count()
    return lambda: fn(*sets[next(turn) % len(sets)])
