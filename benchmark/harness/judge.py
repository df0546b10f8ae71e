"""What decides ``correct``: the reference's readings and the numbers
compared.

Training: the reference follows the program's first steps from the same
weights on the same batches (Noam-Adam, TF32 off).  Compared: each step's
loss; the first gradient as the optimizer got it, leaf by leaf by norm;
the parameters' change after the steps, leaf by leaf by norm.  A leaf gap
is |norm(program) - norm(reference)| over the larger of the reference's
norm of that leaf and the median leaf's.  Leaves whose first reference
gradient is under a thousandth of the median leaf's (nought to rounding)
are left out of the change.

Serving: every answer of the sampled requests against the reference's
forecast of its window, as the widest gap of a window's forecast over the
RMS of the reference's forecasts.

AutoCorrelation's lags are a top-k that two correct programs may break
differently at a near-tie: on both paths the reference replays the lags
the program recorded and reads ``lag_gap``, how far they lie below its
own top-k (``reference/selection.py``).
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.model import (
    Reference,
    adam_step,
    noam_lr,
    precision,
)
from benchmark.reference.selection import Choices

BETA1 = 0.9  # Adam's first moment: after one step it holds (1 - b1) g


def reference_steps(cfg: dict, mode: str, weights: dict, batches,
                    lags=None) -> dict:
    """The reference's first len(batches) steps from ``weights``: {"loss":
    [float], "grad": {leaf: first gradient}, "change": {leaf: params after
    - before}, "lags": each step's lags, a list a call, "lag_gap",
    "flips": rows whose replayed lags are not its own top-k}.
    ``lags``: another side's, in that form, replayed (the reference's own
    top-k where None)."""
    m, o = cfg["model"], cfg["optimizer"]
    ref = Reference(m, mode)
    params = {k: v.detach().clone().requires_grad_() for k, v in
              weights.items()}
    state, losses, first, chosen = {}, [], None, []
    lag_gap, flips = 0.0, 0
    with precision(mode):
        for t, (enc, dec, y) in enumerate(batches):
            ch = Choices(None if lags is None else dict(enumerate(lags[t])))
            out = ref.forward(params, enc, dec, y, True, ch)
            if lags is not None and len(ch.chosen) != len(lags[t]):
                raise RuntimeError(f"{len(lags[t])} lags recorded for "
                                   f"{len(ch.chosen)} calls")
            chosen.append(ch.chosen)
            lag_gap, flips = max(lag_gap, ch.lag_gap), flips + ch.flips
            grads = dict(zip(params, torch.autograd.grad(
                out.loss, list(params.values()))))
            losses.append(float(out.loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam_step(params, grads, state,
                      noam_lr(t, m["d_model"], o["warmup_steps"],
                              o["lr_mul"]))
    change = {k: (params[k].detach() - weights[k]) for k in params}
    return {"loss": losses, "grad": first, "change": change, "lags": chosen,
            "lag_gap": lag_gap, "flips": flips}


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's |norm(p) - norm(r)| / max(norm(r), the median
    leaf's norm(r)), over the leaves in ``keep`` (all where None)."""
    pn, rn = _norms(program), _norms(reference)
    med = statistics.median(rn.values())
    keys = [k for k in rn if keep is None or k in keep]
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def worst_leaves(program: dict, reference: dict) -> dict:
    """The leaf behind each leaf gap (for the record, not compared)."""
    out = {}
    for key, keep in (("grad", None),
                      ("change", moved_leaves(reference["grad"]))):
        pn, rn = _norms(program[key]), _norms(reference[key])
        med = statistics.median(rn.values())
        out[key] = max((k for k in rn if keep is None or k in keep),
                       key=lambda k: abs(pn[k] - rn[k]) / max(rn[k], med,
                                                              1e-30))
    return out


def moved_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding."""
    rn = _norms(ref_grad)
    med = statistics.median(rn.values())
    return {k for k, v in rn.items() if v >= 1e-3 * med}


def train_numbers(program: dict, reference: dict) -> dict:
    """The numbers of one seed, program and reference as
    ``reference_steps`` returns them, the reference replaying the
    program's lags."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program["loss"], reference["loss"]))
    return {"loss_gap": loss, "lag_gap": reference["lag_gap"],
            "grad_gap": leaf_gap(program["grad"], reference["grad"]),
            "change_gap": leaf_gap(program["change"], reference["change"],
                                   moved_leaves(reference["grad"]))}


def worst(numbers: list) -> dict:
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


# -- serving ---------------------------------------------------------- #
def replayed_forecasts(cfg: dict, mode: str, weights: dict, pool,
                       served: list) -> dict:
    """served: [(window indices (b,), forecasts (b, pred_len), each
    AutoCorrelation call's lags (b, k))] of one side.  The reference
    forecasts each request's windows with those lags: ``lag_gap``, the
    widest shortfall of a chosen lag below the reference's k-th best (over
    the row's largest correlation), and ``forecast_gap``, the widest gap
    of a forecast from the reference's, over the RMS of the reference's
    forecasts."""
    ref = Reference(cfg["model"], mode)
    lag_gap, gap, sq, n = 0.0, 0.0, 0.0, 0
    with torch.no_grad(), precision(mode):
        for idx, pred, lags in served:
            sel = torch.as_tensor(idx, device=pool[0].device)
            ch = Choices(dict(enumerate(lags)))
            want = ref.forward(weights, pool[0][sel], pool[1][sel],
                               choose=ch).predictions[..., 0]
            if len(ch.chosen) != len(lags):
                raise RuntimeError(f"{len(lags)} lags recorded for "
                                   f"{len(ch.chosen)} calls")
            got = torch.as_tensor(pred, device=want.device,
                                  dtype=want.dtype)
            gap = max(gap, float((got - want).abs().max()))
            sq += float(want.double().pow(2).sum())
            n += want.numel()
            lag_gap = max(lag_gap, ch.lag_gap)
    return {"lag_gap": lag_gap, "forecast_gap": gap / (sq / n) ** 0.5}
