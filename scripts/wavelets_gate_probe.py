#!/usr/bin/env python3
"""The Wavelets FEDformer's card-vs-CPU gradient gate from several
starting points, on an NVIDIA GPU.

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
``--repeats`` times from the initial weights (bit-equal runs since the
circular convolutions' backward takes a fixed order); the card's step at
each such point taken twice.  It reports, for every point, the leaves
over the tolerance, their summed distances from float64 on the card and
on the CPU, the ratio and the verdict, and how far the card's two steps
at one point lie apart.

First, on the first seed, the determinism of the step: two backwards of
one full-batch step from the same weights compared leaf by leaf, bit for
bit, with the circular convolutions' fixed-order backward
(``models/embedding.py`` ``_FixedOrderConv1d``) and with cuDNN's default
backward in its place; the ops that ``torch.use_deterministic_algorithms
(True, warn_only=True)`` flags in that step with cuDNN's backward; and the
weights after the 9 Adam steps taken twice.

``--variants`` also takes the card's step at each point through a changed
Wavelets cross block (the probe patches it; the port is not changed):
``leaves_f64``, the weight and bias gradients of the cross blocks' ``Lq``
and ``Lk`` accumulated in float64; ``cross_f64``, the weightless mode-space
cross attention (``FourierCrossAttentionW``: its transforms and complex
products) in float64; ``both``.  Each point records, for every leaf over
the tolerance, the card's and the fp32 CPU's distances from float64.
``--points adam`` skips the initial points, ``--no-determinism`` the
determinism section.

Writes ``wavelets_gate.json`` into ``--out`` (default ``build/probe``)
and prints the card's name and power limit.
"""

import argparse
import contextlib
import copy
import json
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fine_grained_gaussian_process_forcasting_torch.models import (  # noqa: E402,E501
    embedding,
)
from fine_grained_gaussian_process_forcasting_torch.models.fedformer import (  # noqa: E402,E501
    FEDformer,
    FEDformerConfig,
)
from fine_grained_gaussian_process_forcasting_torch.ops import (  # noqa: E402
    wavelet,
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
        leaves = {k: (cs._bl_distance(got[k], ref[k]),
                      cs._bl_distance(want[k], ref[k])) for k in over}
        card = sum(c for c, _ in leaves.values())
        cpu = sum(c for _, c in leaves.values())
        out.update(cuda=card, cpu=cpu, ratio=card / cpu,
                   passes=card <= 2.0 * cpu, leaves=leaves)
    else:
        out["passes"] = True
    return out


class _F64Grad(torch.autograd.Function):
    """``F.linear`` whose weight and bias gradients are accumulated in
    float64."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).double()
        gw = (g2.T @ x.reshape(-1, x.shape[-1]).double()).float()
        return g @ w, gw, g2.sum(0).float()


def _cross_f64(self, q, k, v, mask=None):
    out, _ = _CROSS(self, q.double(), k.double(), v.double(), mask)
    return out.to(q.dtype), None


_CROSS = wavelet.FourierCrossAttentionW.forward


@contextlib.contextmanager
def variant(model, name):
    """The card's step through the variant ``name`` of the cross blocks."""
    layers = []
    if name in ("leaves_f64", "both"):
        for m in model.modules():
            if isinstance(m, wavelet.MultiWaveletCross):
                for lin in (m.Lq, m.Lk):
                    lin.forward = (lambda x, lin=lin: _F64Grad.apply(
                        x, lin.weight, lin.bias))
                    layers.append(lin)
    if name in ("cross_f64", "both"):
        wavelet.FourierCrossAttentionW.forward = _cross_f64
    try:
        yield
    finally:
        wavelet.FourierCrossAttentionW.forward = _CROSS
        for lin in layers:
            del lin.forward


class _CudnnConv:
    """``embedding._FixedOrderConv1d`` as it was: cuDNN's default backward."""

    apply = staticmethod(F.conv1d)


def _grads(model, inputs, y):
    model.zero_grad(set_to_none=True)
    torch.mean((model(*inputs) - y) ** 2).backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _apart(a, b):
    """The leaves of two gradient (or weight) dicts that differ in any
    bit, each with its largest absolute difference."""
    return {k: float((a[k] - b[k]).abs().max()) for k in a
            if not torch.equal(a[k], b[k])}


def determinism(model, start, inputs, y):
    """The step's reruns with the port's backward and with cuDNN's, the
    ops flagged as nondeterministic, and the 9 Adam steps twice."""
    out = {}
    fixed = embedding._FixedOrderConv1d
    for label, conv in (("fixed_order", fixed), ("cudnn_default", _CudnnConv)):
        embedding._FixedOrderConv1d = conv
        try:
            model.load_state_dict(start)
            runs = [_grads(model, inputs, y) for _ in range(3)]
            out[label] = {"leaves": len(runs[0]),
                          "apart_1": _apart(runs[0], runs[1]),
                          "apart_2": _apart(runs[0], runs[2])}
            if label == "cudnn_default":
                torch.use_deterministic_algorithms(True, warn_only=True)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    _grads(model, inputs, y)
                torch.use_deterministic_algorithms(False)
                out["flagged"] = sorted({str(w.message)[:300]
                                         for w in caught})
        finally:
            embedding._FixedOrderConv1d = fixed
        cs.log(f"wavelets determinism, {label}: "
               f"{len(out[label]['apart_1'])} and "
               f"{len(out[label]['apart_2'])} of {out[label]['leaves']} "
               f"leaves differ between reruns: {out[label]['apart_1']}")
    cs.log(f"wavelets determinism: flagged under "
           f"use_deterministic_algorithms: {out['flagged']}")
    weights = []
    for _ in range(2):
        model.load_state_dict(start)
        opt = torch.optim.Adam(model.parameters(), lr=cs.FED_LR)
        for _ in range(ADAM_STEPS):
            opt.zero_grad(set_to_none=True)
            torch.mean((model(*inputs) - y) ** 2).backward()
            opt.step()
        weights.append({k: v.detach().clone()
                        for k, v in model.state_dict().items()})
    out["adam_weights_apart"] = _apart(*weights)
    cs.log(f"wavelets determinism: after {ADAM_STEPS} Adam steps twice, "
           f"{len(out['adam_weights_apart'])} leaves differ: "
           f"{out['adam_weights_apart']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default="build/probe")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=["leaves_f64", "cross_f64", "both"])
    ap.add_argument("--points", choices=["all", "adam"], default="all")
    ap.add_argument("--no-determinism", dest="determinism",
                    action="store_false")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cfg = FEDformerConfig(**cs.FED_CFG, version="Wavelets")
    dec_len = cfg.label_len + cfg.pred_len
    points, report = [], {}
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
        if seed == args.seeds[0] and args.determinism:
            report["determinism"] = determinism(model, start, inputs, y)

        def check(m, ts):
            def run():
                out = m(*ts[:4])
                return {"forecast": out}, torch.mean((out - ts[4]) ** 2)

            return cs._loss_and_grads(m, run)

        initial = ["initial"] if args.points == "all" else []
        for point in initial + [f"after {ADAM_STEPS} Adam steps, run "
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
            for name in args.variants:
                with variant(model, name):
                    row[name] = gate(check(model, sub), want, ref)
                cs.log(f"wavelets gate, seed {seed}, {point}, {name}: "
                       f"{len(row[name]['over'])} over, ratio "
                       f"{row[name].get('ratio', 0.0):.3f}")
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
        json.dump(dict(report, card=smi, adam_steps=ADAM_STEPS,
                       points=points, seconds=time.perf_counter() - t0),
                  f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
