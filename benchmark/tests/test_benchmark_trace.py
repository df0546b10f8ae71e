"""The reduction of a profiler trace to busy time, launches, device time
by op and idle gaps, on a trace written by hand."""

import pytest

from benchmark.harness.trace import SLICE, Trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


EVENTS = [
    _x(SLICE, "user_annotation", 0, 1000),
    _x("step", "cpu_op", 10, 500),
    _x("_WhitenedMarginals", "cpu_op", 20, 100),
    _x("_WhitenedMarginals", "cpu_op", 30, 50),  # nested (vmap rule)
    _x("cudaLaunchKernel", "cuda_runtime", 40, 5, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=2),
    _x("_WhitenedMarginalsBackward", "cpu_op", 600, 100, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 610, 5, tid=2, correlation=3),
    _x("gp_fwd", "kernel", 50, 100, tid=7, correlation=1),
    _x("gemm", "kernel", 120, 80, tid=7, correlation=2),  # overlaps
    _x("gp_bwd", "kernel", 650, 50, tid=7, correlation=3),
    _x("Memcpy DtoH", "gpu_memcpy", 900, 10, tid=7),
    _x("outside", "kernel", 1500, 10, tid=7, correlation=9),
]


def test_slice_busy_and_launches():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # [50, 200] + [650, 700] + [900, 910]; the kernel past the slice left
    assert t.busy_s() == pytest.approx(210e-6)
    assert t.launches() == 3


def test_device_time_by_op_through_correlation():
    t = Trace(EVENTS)
    fwd, bwd = ("_WhitenedMarginals",), ("_WhitenedMarginalsBackward",)
    assert t.op_calls(fwd) == 1 and t.op_calls(bwd) == 1
    assert t.device_s_under(fwd) == pytest.approx(100e-6)
    assert t.device_s_under(fwd + bwd) == pytest.approx(150e-6)


def test_idle_gaps_by_host_op():
    t = Trace(EVENTS)
    gaps = dict(t.idle_gaps())
    # [0, 50] before "step" began, [700, 900] and [910, 1000] after it
    # ended: outside any op; [200, 650] inside "step" (its GP op ended)
    assert gaps["host, outside any op"] == pytest.approx(340e-6)
    assert gaps["step"] == pytest.approx(450e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s())
    names = [n for n, _ in t.top_kernels()]
    assert names[0] == "gp_fwd" and "outside" not in names
