"""A profiled slice of a run, read from ``torch.profiler``'s trace.

``profiled(fn)`` runs ``fn`` under the profiler (CPU ops and the card's
activity), inside an annotation that marks the slice, and synchronises;
once the window has closed, ``read`` writes the Chrome trace to a
temporary file under TMPDIR and reads it back into a ``Trace``.  Times are the trace's microseconds, turned into seconds by the
readers.  Device activity is every kernel, copy and set on the card; its
busy time is the union of their intervals inside the slice, so overlap on
several streams is counted once.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Iterable

import torch

SLICE = "benchmark.slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profiled(fn):
    """(fn's result, the profiler that recorded it).  The trace is read
    later (``read``): parsed inside the window, its events would stay on
    the Python heap and slow the host for the rest of the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    return out, prof


def read(prof) -> "Trace":
    """The ``Trace`` of a profiler that ``profiled`` returned, through its
    Chrome trace written to a temporary file under TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def _union(intervals: Iterable[tuple]) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        marks = [e for e in xs if e.get("name") == SLICE
                 and e.get("cat") in ("user_annotation", "cpu_op")]
        if not marks:
            raise RuntimeError("the profiled slice's annotation is missing")
        mark = marks[0]
        self.start, self.end = mark["ts"], mark["ts"] + mark["dur"]
        self.tid = mark["tid"]
        inside = [e for e in xs if self.start <= e["ts"] <= self.end]
        self.device = [e for e in inside if e.get("cat") in _DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.launch = {e["args"]["correlation"]: e for e in inside
                       if e.get("cat") in _LAUNCH_CATS
                       and "correlation" in e.get("args", {})}
        self.ops = [e for e in inside if e.get("cat") in ("cpu_op",
                                                          "user_annotation")
                    and e["name"] != SLICE]

    # -- the slice ---------------------------------------------------- #
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        spans = _union((e["ts"], min(e["ts"] + e["dur"], self.end))
                       for e in self.device)
        return sum(b - a for a, b in spans) / 1e6

    def launches(self) -> int:
        return len(self.kernels)

    # -- by op -------------------------------------------------------- #
    def _op_spans(self, names) -> dict:
        """{thread: merged intervals} of the CPU ops named in ``names``
        (a name matches where it ends with one of them)."""
        by_tid = defaultdict(list)
        for e in self.ops:
            if any(e["name"].endswith(n) for n in names):
                by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        return {tid: _union(v) for tid, v in by_tid.items()}

    def op_calls(self, names) -> int:
        """Calls of the ops in ``names``, nested calls counted once."""
        return sum(len(v) for v in self._op_spans(names).values())

    def device_s_under(self, names) -> float:
        """Seconds of the card's kernels launched inside the ops in
        ``names``: the launch call that a kernel's correlation id names (or
        the op its external id names) lies within one of those ops'
        intervals on the same thread."""
        spans = self._op_spans(names)
        by_ext = {e["args"]["External id"]: e for e in self.ops
                  if "External id" in e.get("args", {})}
        total = 0.0
        for k in self.kernels:
            args = k.get("args", {})
            # the launch call, else the innermost op the profiler tied the
            # kernel to
            call = (self.launch.get(args.get("correlation"))
                    or by_ext.get(args.get("External id")))
            if call is None:
                continue
            for a, b in spans.get(call["tid"], ()):
                if a <= call["ts"] <= b:
                    total += k["dur"]
                    break
        return total / 1e6

    # -- the breakdown ------------------------------------------------ #
    def top_kernels(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"]] += e["dur"] / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The card's idle time inside the slice, by the innermost CPU op
        of the slice's thread that was running when each gap began ("host,
        outside any op" where none was): the n largest sums."""
        spans = _union((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        edges = [self.start] + [x for s in spans for x in s] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        ops = sorted((e for e in self.ops if e["tid"] == self.tid),
                     key=lambda e: (e["ts"], -e["dur"]))
        by_label, stack, i = defaultdict(float), [], 0
        for a, b in gaps:  # ops of one thread nest: a stack of open ones
            while i < len(ops) and ops[i]["ts"] <= a:
                stack.append(ops[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < a:
                stack.pop()
            label = next((e["name"] for e in reversed(stack)
                          if e["ts"] + e["dur"] >= a),
                         "host, outside any op")
            by_label[label] += (b - a) / 1e6
        return sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
