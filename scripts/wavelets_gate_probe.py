#!/usr/bin/env python3
"""The Wavelets FEDformer's card-vs-CPU gradient gate from several
starting points, on an NVIDIA GPU with torch's default algorithms.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/wavelets_gate_probe.py [--seeds 0 1 2] [--repeats 2]
                                          [--out DIR]

``chip_smoke.py``'s ``fedformer_model_wavelets`` holds one MSE step on
MODEL_CHECK windows against the port's CPU run: every gradient within
TOL_TRAIN, or, for those that miss, the card's distances from a float64
CPU run, summed over them, at most twice the fp32 CPU's.  For each seed
(the model's initial weights and the batch) this script applies that gate
at the initial weights, the card's step taken twice, and after the
smoke's 9 Adam steps (``_time_model``'s count), those steps taken
``--repeats`` times from the initial weights, since the atomics of the
default backward kernels make each run's weights differ; the card's step
at each such point taken twice.  It reports, for every point, the leaves
over the tolerance, their summed distances from float64 on the card and
on the CPU, the ratio and the verdict, and how far the card's two steps
at one point lie apart.

Writes ``wavelets_gate.json`` into ``--out`` (default ``build/probe``)
and prints the card's name and power limit.
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fine_grained_gaussian_process_forcasting_torch.models.fedformer import (  # noqa: E402,E501
    FEDformer,
    FEDformerConfig,
)

ADAM_STEPS = 2 * cs.MR_WARMUP + cs.MR_RUNS  # 2 warm-up, 5 timed, 2 more


def gate(got, want, ref):
    """``chip_smoke._card_vs_cpu``'s measures for one card step ``got``
    against the fp32 CPU's ``want`` and the float64 CPU's ``ref``."""
    grads = [k for k in want if k != "loss" and not k.startswith("output:")]
    floor = cs.MR_GRAD_FLOOR * max(np.abs(want[k]).max() for k in grads)
    dist = {k: float(np.abs(got[k] - w).max()
                     / max(max(np.abs(w).max(), floor if k in grads else 0),
                           1e-30)) for k, w in want.items()}
    over = sorted(k for k, v in dist.items() if v > cs.TOL_TRAIN)
    out = {"worst": max(dist.values()), "over": over}
    if over:
        card = sum(cs._bl_distance(got[k], ref[k]) for k in over)
        cpu = sum(cs._bl_distance(want[k], ref[k]) for k in over)
        out.update(cuda=card, cpu=cpu, ratio=card / cpu,
                   passes=card <= 2.0 * cpu)
    else:
        out["passes"] = True
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default="build/probe")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cfg = FEDformerConfig(**cs.FED_CFG, version="Wavelets")
    dec_len = cfg.label_len + cfg.pred_len
    points = []
    for seed in args.seeds:
        model = FEDformer(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
        start = copy.deepcopy(model.state_dict())
        rng = np.random.RandomState(seed)
        *inputs, y = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda() for s in (
            (cs.FED_BATCH, cfg.seq_len, cfg.enc_in),
            (cs.FED_BATCH, cfg.seq_len, cs.FED_MARKS),
            (cs.FED_BATCH, dec_len, cfg.dec_in),
            (cs.FED_BATCH, dec_len, cs.FED_MARKS),
            (cs.FED_BATCH, cfg.pred_len, cfg.c_out)))
        sub = [t[:cs.MODEL_CHECK] for t in inputs + [y]]

        def check(m, ts):
            def run():
                out = m(*ts[:4])
                return {"forecast": out}, torch.mean((out - ts[4]) ** 2)

            return cs._loss_and_grads(m, run)

        for point in ["initial"] + [f"after {ADAM_STEPS} Adam steps, run "
                                    f"{r}" for r in range(args.repeats)]:
            model.load_state_dict(start)
            if point != "initial":
                opt = torch.optim.Adam(model.parameters(), lr=cs.FED_LR)
                for _ in range(ADAM_STEPS):
                    opt.zero_grad(set_to_none=True)
                    torch.mean((model(*inputs) - y) ** 2).backward()
                    opt.step()
            cards = [check(model, sub) for _ in range(2)]
            cpu = copy.deepcopy(model).cpu()
            want = check(cpu, [t.cpu() for t in sub])
            ref = check(cpu.double(), [t.cpu().double() for t in sub])
            row = {"seed": seed, "point": point,
                   "card_steps_apart": max(
                       cs._bl_distance(cards[0][k], cards[1][k])
                       for k in cards[0]),
                   "gates": [gate(c, want, ref) for c in cards]}
            points.append(row)
            cs.log(f"wavelets gate, seed {seed}, {point}: " + "; ".join(
                f"step {j}: worst {g['worst']:.3e}, {len(g['over'])} over"
                + (f", float64 sums cuda {g['cuda']:.4e} cpu {g['cpu']:.4e}"
                   f" (ratio {g['ratio']:.3f})" if g["over"] else "")
                + f", {'passes' if g['passes'] else 'FAILS'}"
                for j, g in enumerate(row["gates"]))
                + f"; the card's two steps apart {row['card_steps_apart']:.3e}")
            del cpu
    with open(os.path.join(args.out, "wavelets_gate.json"), "w") as f:
        json.dump({"card": smi, "adam_steps": ADAM_STEPS, "points": points,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
