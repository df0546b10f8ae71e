"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--controls 3] [--faults half_batch frozen] [--out FILE]
    python3 benchmark/calibrate.py --workload <cell> --summarize FILE...

For each seed: the cell's set-up and (serving) a short window at the
cell's own load, then the numbers its check compares: the program's
readings.  For the first ``--controls`` seeds the same numbers of the
control, the reference one precision below the configuration's in the
program's place (the int8 session for serving), and of each fault planted
in the program.  One JSON line a reading, on standard output and appended
to ``--out``.  The benchmark's own runs do not run this.

``--summarize`` reads such files back (and lines of the same form from
the cell's own runs) and gives each number's readings: the lower (the
largest of the program's), the upper (the smallest of the control's where
it reads three times the lower or more, and of each fault's that reads ten
times the lower or more; a state left unchanged, ``frozen``, three times)
and the limit set between them, lower^(1/4) upper^(3/4): more room above
the lower than below the upper.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summarize(paths: list, workload: str) -> dict:
    """{number: {"lower", "floor", "upper", "upper_from", "limit",
    "seeds"}}.  Where every program reading is 0 the limit is set from
    ``floor``, the control's largest reading (what rounding one precision
    lower reads), in place of the lower; 0 there too makes it exact."""
    recs = [r for path in paths for r in map(json.loads, open(path))
            if r["workload"] == workload]
    program = [r["numbers"] for r in recs if r["side"] == "program"]
    out = {}
    for k in program[-1]:  # readings of an earlier check may lack a number
        lower = max(n[k] for n in program if k in n)
        sides = {}
        for r in recs:
            if r["side"] != "program" and k in r["numbers"]:
                sides.setdefault(r["side"], []).append(r["numbers"][k])
        floor = lower or max(sides.get("control", [0.0]))
        ups = {s: min(vs) for s, vs in sides.items()
               if min(vs) >= (3.0 if s in ("control", "frozen") else 10.0)
               * floor}
        upper_from = min(ups, key=ups.get) if ups else None
        upper = ups.get(upper_from)
        out[k] = {"lower": lower, "floor": floor, "upper": upper,
                  "upper_from": upper_from,
                  "limit": (None if upper is None
                            else floor ** 0.25 * upper ** 0.75),
                  "seeds": len({r["seed"] for r in recs
                                if r["side"] == "program"})}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--summarize", nargs="+", default=None)
    p.add_argument("--seeds", type=int, nargs="+", default=[])
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--serve_seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize, args.workload), indent=1))
        return
    sys.path[0] = ROOT
    import torch

    from benchmark.harness import cell, manifest

    m = manifest.load()

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for n, seed in enumerate(args.seeds):
        for side in ["program"] + (["control"] + args.faults
                                   if n < args.controls else []):
            t = time.perf_counter()
            wl, c = cell.build(m, args.workload, seed, "cuda")
            driver = sys.modules[type(c).__module__]
            fault = driver.FAULTS.get(side)
            c.setup(fault=fault)
            if c.kind == "serve":
                c.window(args.serve_seconds, False)
            set_s = time.perf_counter() - t
            c.release()
            t = time.perf_counter()
            if side == "control":
                if c.kind == "serve":
                    numbers = c.check(c.control())
                else:
                    numbers = c.check(c.control_readings())
            else:
                numbers = c.check()
            emit(workload=args.workload, seed=seed, side=side,
                 numbers=numbers, setup_s=set_s,
                 check_s=time.perf_counter() - t,
                 worst_leaves=getattr(c, "detail", None),
                 card=torch.cuda.get_device_name(0),
                 power=cell.power_limit())
            del c
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
