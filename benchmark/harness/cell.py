"""One run of one cell: set-up, the measured window, the check, the result.

``main`` finds the cell in ``BENCHMARK.json``, its configuration, its
traffic mix (whose ``kind`` names the driver, ``harness/<kind>.py``) and,
with ``--trace 1``, the readers of its per-layer metrics, all by name.
It prints the contract's one JSON line last on standard output, and the
numbers compared, each beside its limit, last on standard error.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness import manifest

#: top-level modules that may not be loaded in the process that reports:
#: JAX, its libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "fine_grained_gaussian_process_forcasting_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def host_reading() -> dict:
    """Counters of the host that explain a slow window: this process's CPU
    seconds, its main thread's seconds waiting for a CPU, and the
    machine's seconds stolen by the hypervisor (read from /proc)."""
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/thread-self/schedstat") as f:
            out["runqueue_s"] = int(f.read().split()[1]) / 1e9
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf(
                "SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return out


def build(manifest_: dict, name: str, seed: int, device, bench=None):
    """(workload entry, the cell's driver object) of cell ``name``."""
    bench = bench or manifest.BENCH
    wl = manifest.workload(manifest_, name)
    cfg = manifest.config(manifest_, wl["config"], bench.parent)
    traffic = manifest.traffic(wl["traffic"], bench)
    driver = importlib.import_module(f"benchmark.harness.{traffic['kind']}")
    return wl, driver.Cell(cfg, traffic, seed, device)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def main(args, t0: float) -> int:
    m = manifest.load()
    wl = manifest.workload(m, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['name']} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    limits = manifest.limits(wl["name"])
    wl, cell = build(m, args.workload, args.seed, "cuda")
    rc, line = run(m, wl, cell, args.seconds, bool(args.trace), limits, t0)
    if rc == 0:
        print(json.dumps(line))
    return rc


def run(m: dict, wl: dict, cell, seconds: float, trace: bool, limits: dict,
        t0: float, fault=None) -> tuple:
    """Set-up, window, check of a built cell: (exit code, result line).
    ``fault`` breaks the timed path underneath (the CPU tests only)."""
    cuda = cell.device.type == "cuda"
    imported = time.perf_counter()
    cell.setup(fault=fault)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    host = host_reading()
    result = cell.window(seconds, trace)
    host = {k: v - host[k] for k, v in host_reading().items() if k in host}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    ok, checks = verdict(cell.check(), limits)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no JAX in the benchmark's process",
              file=sys.stderr)
        return 3, None

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak,
              "power_limit": power_limit() if cuda else "none"}
    metrics = {}
    line = {"correct": ok, "attempted": result["steps"],
            "failed": result["failed"]}
    if trace:
        profile = result["trace"]
        ctx = SimpleNamespace(kind=cell.kind, cfg=cell.cfg,
                              traffic=cell.traffic, trace=profile,
                              result=result,
                              n_seeds=getattr(cell, "n_seeds", 1))
        for entry in manifest.metrics_of(m, "per_layer", wl["name"]):
            value = manifest.reader(entry["name"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        device.update(busy_s=profile.busy_s(), window_s=profile.window_s)
        line["breakdown"] = {"device_ops": profile.top_kernels(),
                             "idle_gaps": profile.idle_gaps()}
    else:
        measured = dict(result["metrics"], setup_s=setup_s)
        for entry in manifest.metrics_of(m, "end_to_end", wl["name"]):
            metrics[entry["name"]] = {"value": measured[entry["name"]],
                                      "unit": entry["unit"]}
    # beside the contract's keys, for the record: set-up by part, the
    # host's counters over the window, and the window's calls or requests
    parts = [("imports", imported - t0)] + [
        (b[0], b[1] - a[1]) for a, b in zip(cell.marks, cell.marks[1:])]
    timing = result.get("calls_s", result.get("latency_s"))
    line.update(metrics=metrics, device=device, setup_parts=parts,
                host=host, window=[round(x, 6) for x in timing],
                checks=checks)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, line
