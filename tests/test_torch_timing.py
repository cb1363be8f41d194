"""``launch/timing.device_ms`` on the CPU, with a stand-in for the profiler.

Each kernel of a trace is averaged over its own traced launches, so a trace
that missed a few launches is used; one that lost more than a tenth of them
is never used: a fresh one is taken, and after ``attempts`` short traces the
call raises.
Each trace runs one warm-up step before the timed calls.
The stand-in profiler hands out prepared traces; no card is needed.
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch import timing


def _trace(counts_us):
    """key_averages() of a trace: (launches, total device us) per kernel,
    and the schedule's step as the device lists it (not a kernel)."""
    step = SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, count=1,
                           self_device_time_total=9e9, key="ProfilerStep*")
    return [step] + [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, count=n,
                                     self_device_time_total=us, key=f"kernel{i}")
                     for i, (n, us) in enumerate(counts_us)]


@pytest.fixture
def fake_profiler(monkeypatch):
    traces = []

    class Profile:
        def __init__(self, activities, schedule):
            self.events = traces.pop(0)
            self.steps = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1

        def key_averages(self):
            assert self.steps == 2               # the warm-up step, then the timed one
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return traces


def test_a_short_trace_is_retaken_not_averaged(fake_profiler):
    # 20 calls of 2 kernels: the first trace dropped 5 of the 40 launches
    fake_profiler += [_trace([(15, 1500.0), (20, 3000.0)]),
                      _trace([(20, 2000.0), (20, 3000.0)])]
    calls = []
    ms = timing.device_ms(lambda: calls.append(1), 20, launches_per_call=2)
    assert ms == pytest.approx((2000.0 + 3000.0) / 1e3 / 40 * 2)
    assert len(calls) == 1 + 2 * (1 + 20)    # warm-up, then two traces of 1 + 20
    assert not fake_profiler


def test_only_short_traces_raise(fake_profiler):
    fake_profiler += [_trace([(30, 3000.0)]) for _ in range(3)]
    with pytest.raises(RuntimeError, match="30 kernel launches traced for 20 calls of 2, "
                                           "3 times"):
        timing.device_ms(lambda: None, 20, launches_per_call=2)


def test_a_trace_that_missed_a_few_launches_is_averaged_by_kernel(fake_profiler):
    # 38 of 40 launches, one of each kernel missed; each kernel's mean is its
    # own (0.1 and 0.2 ms), not the trace's mean over all 38 launches
    fake_profiler += [_trace([(19, 1900.0), (19, 3800.0)])]
    calls = []
    ms = timing.device_ms(lambda: calls.append(1), 20, launches_per_call=2)
    assert ms == pytest.approx(0.1 + 0.2)
    assert len(calls) == 1 + 1 + 20          # one trace
    assert not fake_profiler


def test_a_trace_of_another_launch_count_is_retaken(fake_profiler):
    # a third kernel in every call: the call is not the one planned
    fake_profiler += [_trace([(20, 2000.0), (20, 3000.0), (20, 1000.0)]),
                      _trace([(20, 2000.0), (20, 3000.0)])]
    ms = timing.device_ms(lambda: None, 20, launches_per_call=2)
    assert ms == pytest.approx(0.1 + 0.15)
    assert not fake_profiler


def test_without_a_launch_count_the_first_trace_is_used(fake_profiler):
    fake_profiler += [_trace([(30, 3000.0)]), _trace([(40, 1.0)])]
    # 30 launches over 20 calls round to 2 a call
    assert timing.device_ms(lambda: None, 20) == pytest.approx(3000.0 / 1e3 / 30 * 2)
    assert len(fake_profiler) == 1


def test_without_a_launch_count_an_empty_trace_is_retaken(fake_profiler):
    # the profiler saw no device time in the first trace
    fake_profiler += [_trace([]), _trace([(20, 2000.0)])]
    assert timing.device_ms(lambda: None, 20) == pytest.approx(2000.0 / 1e3 / 20)
    assert not fake_profiler


def test_without_a_launch_count_only_empty_traces_raise(fake_profiler):
    fake_profiler += [_trace([(4, 400.0)]) for _ in range(3)]
    with pytest.raises(RuntimeError, match="4 kernel launches traced for 20 calls, 3 times; "
                                           "the profiler saw no device time"):
        timing.device_ms(lambda: None, 20)


def test_kernel_ms_splits_a_call_by_kernel(fake_profiler):
    # 10 calls of 2 kernels, one launch of the second missed by the trace;
    # the schedule's step is not a kernel
    fake_profiler += [_trace([(10, 1000.0), (9, 225.0)])]
    calls = []
    got = timing.kernel_ms(lambda: calls.append(1), 10, ("kernel0", "kernel1"))
    assert got == {"kernel0": pytest.approx(0.1), "kernel1": pytest.approx(0.025)}
    assert len(calls) == 1 + 1 + 10          # warm-up call, warm-up step, timed calls


def test_kernel_ms_retakes_a_trace_that_lost_a_kernel(fake_profiler):
    # the first trace holds no launch of the second kernel: its time would
    # silently drop out of the call's sum
    fake_profiler += [_trace([(10, 1000.0)]), _trace([(10, 1000.0), (10, 250.0)])]
    calls = []
    got = timing.kernel_ms(lambda: calls.append(1), 10, ("kernel0", "kernel1"))
    assert got == {"kernel0": pytest.approx(0.1), "kernel1": pytest.approx(0.025)}
    assert len(calls) == 1 + 2 * (1 + 10)    # warm-up, then two traces of 1 + 10


def test_kernel_ms_raises_on_an_empty_trace(fake_profiler):
    fake_profiler += [_trace([])] * 3
    with pytest.raises(RuntimeError, match=r"no launch of \['kernel0'\] traced for 10 calls, "
                                           r"3 times"):
        timing.kernel_ms(lambda: None, 10, ("kernel0",))
    assert not fake_profiler                 # three traces taken


def test_kernel_ms_refuses_a_kernel_it_was_not_given(fake_profiler):
    # a stray kernel on the stream would be counted as the call's time
    fake_profiler += [_trace([(10, 1000.0), (10, 250.0)])]
    with pytest.raises(RuntimeError, match="'kernel1' matches 0 of the names"):
        timing.kernel_ms(lambda: None, 10, ("kernel0",))
