#!/usr/bin/env python3
"""The Wavelets FEDformer's card-vs-CPU gradient gate after Adam steps,
from several seeds and with chosen ops in float64, on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/wavelets_gate_probe.py [--seeds 0 1 2]
        [--variants port self_f64+layernorm_f64] [--out DIR]

``chip_smoke.py``'s ``fedformer_model_wavelets`` holds one MSE step on
MODEL_CHECK windows against the port's CPU run: every gradient within
TOL_TRAIN, or, for those that miss, the card's distances from a float64
CPU run, summed over them, at most twice the fp32 CPU's.  For each seed
(the model's initial weights and the batch) and each variant this script
takes the smoke's 9 Adam steps (``_time_model``'s count) from the seed's
weights through the variant, then the check step twice on the card, and
applies that gate against the CPU at the weights those steps reached.

Variants: ``port``, the port as it is (fp32); or a set of ops joined with
``+``, those ops in float64 on the card, patched inside the probe only by
casting their inputs (and weights) in and their outputs out:
``decomp_f64``, the moving average of every decomposition
(``ops/decomposition.py`` ``moving_avg``); ``self_f64``, every self block
(``MultiWaveletTransform``); ``embed_conv_f64``, the circular convolutions
(``CircularConv1d``); ``layernorm_f64``, both ``MyLayerNorm``.

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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fine_grained_gaussian_process_forcasting_torch.models.embedding import (  # noqa: E402,E501
    CircularConv1d,
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
_OPS = {"self_f64": wavelet.MultiWaveletTransform,
        "embed_conv_f64": CircularConv1d,
        "layernorm_f64": decomposition.MyLayerNorm,
        "decomp_f64": None}


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


def _to64(x):
    return (x.double() if torch.is_tensor(x) and x.is_floating_point()
            else x)


def _to32(x):
    if isinstance(x, tuple):
        return tuple(_to32(t) for t in x)
    return x.float() if torch.is_tensor(x) and x.dtype == torch.float64 else x


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


def _variant_name(name):
    """``port`` or a set of the ops in ``_OPS`` joined with ``+``."""
    if name == "port" or all(op in _OPS for op in name.split("+")):
        return name
    raise argparse.ArgumentTypeError(f"unknown variant {name!r}")


@contextlib.contextmanager
def variant(model, name):
    """The port (``port``), or the port with the ops of ``name`` in
    float64."""
    moving_avg = decomposition.moving_avg
    patched = []
    if name != "port":
        ops = name.split("+")
        if "decomp_f64" in ops:
            decomposition.moving_avg = (
                lambda x, k: moving_avg(x.double(), k).to(x.dtype))
        patched = [_f64_module(m) for m in model.modules()
                   if any(_OPS[op] and isinstance(m, _OPS[op])
                          for op in ops)]
    try:
        yield
    finally:
        decomposition.moving_avg = moving_avg
        for m in patched:
            del m.forward


def through_adam(model, start, inputs, y, sub, name, check) -> dict:
    """From the seed's weights, ADAM_STEPS Adam steps and the check step
    taken twice, all through the variant ``name``; then the CPU's fp32 and
    float64 steps at the weights they reached, and the gate."""
    model.load_state_dict(start)
    with variant(model, name):
        opt = torch.optim.Adam(model.parameters(), lr=cs.FED_LR)
        for _ in range(ADAM_STEPS):
            opt.zero_grad(set_to_none=True)
            torch.mean((model(*inputs) - y) ** 2).backward()
            opt.step()
        cards = [check(model, sub) for _ in range(2)]
    cpu = copy.deepcopy(model).cpu()
    want = check(cpu, [t.cpu() for t in sub])
    ref = check(cpu.double(), [t.cpu().double() for t in sub])
    return {"variant": name, "gate": gate(cards[0], want, ref),
            "card_steps_apart": max(cs._bl_distance(cards[0][k],
                                                    cards[1][k])
                                    for k in cards[0])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--variants", nargs="+", default=["port"],
                    type=_variant_name,
                    help=f"port, or of {', '.join(_OPS)} joined with "
                         "'+'")
    ap.add_argument("--out", default="build/probe")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cfg = FEDformerConfig(**cs.FED_CFG, version="Wavelets")
    dec_len = cfg.label_len + cfg.pred_len
    points = []

    def check(m, ts):
        def run():
            out = m(*ts[:4])
            return {"forecast": out}, torch.mean((out - ts[4]) ** 2)

        return cs._loss_and_grads(m, run)

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
        for name in args.variants:
            row = dict(through_adam(model, start, inputs, y, sub, name,
                                    check), seed=seed)
            points.append(row)
            g = row["gate"]
            cs.log(f"wavelets gate through adam, seed {seed}, {name}: "
                   f"{len(g['over'])} over, ratio "
                   f"{g.get('ratio', 0.0):.3f} (card "
                   f"{g.get('cuda', 0.0):.4e}, cpu "
                   f"{g.get('cpu', 0.0):.4e}), "
                   f"{'passes' if g['passes'] else 'FAILS'}; the card's "
                   f"two steps apart {row['card_steps_apart']:.3e}")
    with open(os.path.join(args.out, "wavelets_gate.json"), "w") as f:
        json.dump(dict(card=smi, adam_steps=ADAM_STEPS,
                       points=points, seconds=time.perf_counter() - t0),
                  f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
