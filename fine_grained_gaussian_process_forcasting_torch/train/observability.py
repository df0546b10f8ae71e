"""Tracing, step timing and metrics logging (counterpart of the JAX
package's ``train/observability.py``).

``profile_trace`` runs ``torch.profiler`` where the JAX package runs
``jax.profiler`` and writes a Chrome trace (``trace.json``, viewable in
Perfetto or ``chrome://tracing``) into its directory; ``StepTimer`` and
``MetricsLogger`` are as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the host and, when a card is present, the device while the
    block runs, and write ``log_dir/trace.json``; a no-op without
    ``log_dir``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock timing of (already-synchronised) steps; call ``tick``
    after each blocking step boundary."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._durations: List[float] = []

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self._durations.append(dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self._durations:
            return 0.0
        # drop the first tick (warm-up)
        ds = self._durations[1:] or self._durations
        return len(ds) / sum(ds)


class MetricsLogger:
    """Append-only JSONL metrics."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def log(self, step: int, **metrics) -> None:
        rec: Dict = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
