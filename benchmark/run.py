"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up and checks the first steps (set-up), measures for
``--seconds`` seconds, checks what the timed path produced against the plain
reference under ``benchmark/reference/``, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from a profiled slice of the window (``--trace 1``).
Runs on an NVIDIA card only; exits non-zero without one.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    sys.path[0] = ROOT  # the checkout, not this folder, is the import root
    from benchmark.harness.cell import main

    sys.exit(main(args, T0))
