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
The per-op variants run one op upstream of the cross block in float64 on
the card, by casting its inputs (and its weights) in and its outputs out,
patched inside the probe only: ``decomp_f64``, the moving average of
every decomposition (``ops/decomposition.py`` ``moving_avg``: an fp32
cumulative sum and the difference of its ends); ``wavelet_f64``, the
even/odd decomposition and reconstruction products
(``_wavelet_transform``, ``_even_odd``, in every block);
``sparse_ft_f64``, every ``SparseKernelFT`` (rfft, complex einsum,
irfft); ``dec_self_f64``, the decoder's self block
(``MultiWaveletTransform``) whole; ``self_f64``, every self block, the
encoder's too; ``embed_conv_f64``, the circular convolutions
(``CircularConv1d``, forward and backward); ``layernorm_f64``, both
``MyLayerNorm``; ``upstream_f64``, all of these at once.  ``--control``
adds, at each point, the CPU's fp32 step with the check windows in
another order (reversed): the same arithmetic summed in another order,
its summed distance from float64 over the leaves the card's step has over
the tolerance, beside the CPU's own.
``--points adam`` skips the initial points, ``--no-determinism`` the
determinism section.

Writes ``wavelets_gate.json`` into ``--out`` (default ``build/probe``)
and prints the card's name and power limit.
"""

import argparse
import contextlib
import copy
import itertools
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
    decomposition,
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


def _to64(x):
    return (x.double() if torch.is_tensor(x) and x.is_floating_point()
            else x)


def _to32(x):
    if isinstance(x, tuple):
        return tuple(_to32(t) for t in x)
    return x.float() if torch.is_tensor(x) and x.dtype == torch.float64 else x


def _f64_function(fn):
    """``fn`` with its floating inputs cast to float64 and its outputs
    back to float32."""
    def run(*args):
        return _to32(fn(*(_to64(a) for a in args)))

    return run


def _f64_module(m):
    """Makes ``m``'s forward run in float64: its parameters and buffers
    (through ``functional_call``, so that their gradients reach the fp32
    leaves) and its floating inputs cast, its outputs cast back."""
    inner = type(m).forward
    inside = []

    def forward(*args, **kw):
        if inside:
            return inner(m, *args, **kw)
        inside.append(True)
        try:
            tensors = {n: t.double() for n, t in itertools.chain(
                m.named_parameters(), m.named_buffers())}
            out = torch.func.functional_call(
                m, tensors, tuple(_to64(a) for a in args),
                {k: _to64(v) for k, v in kw.items()})
        finally:
            inside.pop()
        return _to32(out)

    m.forward = forward
    return m


_OP_VARIANTS = ("decomp_f64", "wavelet_f64", "sparse_ft_f64",
                "dec_self_f64", "self_f64", "embed_conv_f64",
                "layernorm_f64", "upstream_f64")
_UPSTREAM = ("decomp_f64", "self_f64", "embed_conv_f64", "layernorm_f64")


def _op_modules(model, name):
    """The modules whose forward the op variant ``name`` runs in float64."""
    from fine_grained_gaussian_process_forcasting_torch.models.embedding import (  # noqa: E501
        CircularConv1d,
    )

    if name == "sparse_ft_f64":
        return [m for m in model.modules()
                if isinstance(m, wavelet.SparseKernelFT)]
    if name == "self_f64":
        return [m for m in model.modules()
                if isinstance(m, wavelet.MultiWaveletTransform)]
    if name == "dec_self_f64":
        return [m for n, m in model.named_modules()
                if n.startswith("dec_layer")
                and isinstance(m, wavelet.MultiWaveletTransform)]
    if name == "embed_conv_f64":
        return [m for m in model.modules() if isinstance(m, CircularConv1d)]
    if name == "layernorm_f64":
        return [m for m in model.modules()
                if isinstance(m, decomposition.MyLayerNorm)]
    return []


@contextlib.contextmanager
def variant(model, name):
    """The card's step through the variant ``name`` of the cross blocks,
    or with one op upstream of them in float64."""
    layers = []
    ops = _UPSTREAM if name == "upstream_f64" else (name,)
    functions = {"decomp_f64": (decomposition, ("moving_avg",)),
                 "wavelet_f64": (wavelet, ("_wavelet_transform",
                                           "_even_odd"))}
    saved = []
    for op in ops:
        for m in _op_modules(model, op):
            layers.append(_f64_module(m))
        if op in functions:
            module, names = functions[op]
            for fn in names:
                saved.append((module, fn, getattr(module, fn)))
                setattr(module, fn, _f64_function(getattr(module, fn)))
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
        for module, fn, original in saved:
            setattr(module, fn, original)
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


def reversed_step(cpu, sub):
    """The CPU's fp32 step on the check windows in reverse order (the loss
    is their mean, so the same function, its sums in another order)."""
    rev = [t.cpu()[torch.arange(t.shape[0] - 1, -1, -1)] for t in sub]

    def run():
        out = cpu(*rev[:4])
        return {"forecast": out}, torch.mean((out - rev[4]) ** 2)

    return cs._loss_and_grads(cpu, run)


def control(perm, want, ref, card_gate):
    """Over the leaves the card's step has over the tolerance, the summed
    distances from float64 of the reversed CPU step ``perm`` and of the
    CPU's own step, and the largest distance between the two CPU steps'
    leaves (the gate's measure: each leaf's over the larger of its largest
    magnitude and the floor)."""
    leaves = [k for k in card_gate["over"] if not k.startswith("output:")]
    grads = [k for k in want if k != "loss" and not k.startswith("output:")]
    out = {"cpu_reversed_vs_cpu": gate({k: perm[k] for k in grads},
                                       {k: want[k] for k in grads},
                                       ref)["worst"]}
    if leaves:
        mine = sum(cs._bl_distance(want[k], ref[k]) for k in leaves)
        rev_sum = sum(cs._bl_distance(perm[k], ref[k]) for k in leaves)
        out.update(leaves=len(leaves), cpu=mine, cpu_reversed=rev_sum,
                   ratio=rev_sum / mine,
                   card_ratio_against_reversed=card_gate["cuda"] / rev_sum)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default="build/probe")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=["leaves_f64", "cross_f64", "both",
                             *_OP_VARIANTS])
    ap.add_argument("--control", action="store_true",
                    help="the CPU's fp32 step with the windows reversed")
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
            perm = reversed_step(cpu, sub) if args.control else None
            ref = check(cpu.double(), [t.cpu().double() for t in sub])
            row = {"seed": seed, "point": point,
                   "card_steps_apart": max(
                       cs._bl_distance(cards[0][k], cards[1][k])
                       for k in cards[0]),
                   "gates": [gate(c, want, ref) for c in cards]}
            if args.control:
                row["control"] = control(perm, want, ref, row["gates"][0])
                cs.log(f"wavelets gate, seed {seed}, {point}, cpu control "
                       f"(windows reversed): {row['control']}")
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
