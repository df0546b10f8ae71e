"""Post-training int8 quantization for serving (counterpart of the JAX
package's ``train/quantize.py``).

The scheme is JAX's (weight-per-channel / activation-per-token dynamic PTQ):

    w_s = max(max|w[j, :]|, 1e-8) / 127   per OUTPUT channel, once a session
    w_q = round(w / w_s)  : int8
    x_s = max(max|x[token]|, 1e-8) / 127  per token, on each call
    x_q = round(x / x_s)  : int8
    y   = (x_q @ w_q^T) : int32  *  x_s * w_s  (+ bias, fp32)

and the output is cast as Flax casts a Dense's: to the layer's
``compute_dtype`` where it has one, else fp32.  ``round`` is half to even
on both sides.

Which layers: exactly those whose call JAX's interceptor replaces, every
``type(mod) is nn.Dense``.  In the port each is a ``params.Dense`` (the
names map through ``params.from_flax``), so ``quantize_model`` swaps every
module whose type is exactly ``params.Dense`` for an ``Int8Dense``; the
LSTM's gates (``nn.LSTM``), the convolutions and the GP's parameters stay
as they are, as the interceptor leaves Flax's LSTM cell, its convolutions
and raw parameters.  No model file has an int8 branch.

The int32 product is ``torch._int_mm`` on both devices (JAX's
``lax.dot_general(..., preferred_element_type=int32)``, outside any Pallas
kernel).  On the card it takes K and N in multiples of 8 and more than 16
rows; the flagship's embeddings have K 4, ``proj_up`` K 1 and
``final_projection`` N 1, so the weights are zero-padded to whole 8s once,
x_q's columns and, below 17, its rows on each call: zeros add nothing to
an int32 sum, and the padding is sliced off.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.params import Dense

_MIN_ROWS = 17  # the card's int8 product takes more than 16 rows


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127, divided as IEEE division on every device
    (CUDA multiplies by the reciprocal of a Python-number divisor, which
    can land one ulp away)."""
    return torch.clamp(absmax, min=1e-8) / absmax.new_full((), 127.0)


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight (``Linear.weight``, JAX's kernel transposed) ->
    (int8 weight (out, in), per-output-channel fp32 scale (out,))."""
    wf = w.float()
    ws = _scale(wf.abs().amax(dim=1))
    wq = torch.round(wf / ws[:, None]).to(torch.int8)
    return wq, ws


def _pad_weight(wq: torch.Tensor) -> torch.Tensor:
    """(out, in) int8 -> zero-padded to whole 8s, (up8(out), up8(in))."""
    n, k = wq.shape
    return F.pad(wq, (0, _up8(k) - k, 0, _up8(n) - n)).contiguous()


def _int8_apply(x: torch.Tensor, wq_padded: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The activation-quantized int8 product and its dequantization in
    fp32; x (..., in), ``wq_padded`` from ``_pad_weight``."""
    n = ws.shape[0]
    k = x.shape[-1]
    xf = x.float()
    xs = _scale(xf.abs().amax(dim=-1, keepdim=True))
    xq = torch.round(xf / xs).to(torch.int8).reshape(-1, k)
    m = xq.shape[0]
    xq = F.pad(xq, (0, wq_padded.shape[1] - k,
                    0, max(_MIN_ROWS - m, 0)))
    acc = torch._int_mm(xq, wq_padded.t())[:m, :n]
    y = acc.float().reshape(*x.shape[:-1], n) * xs * ws
    if bias is not None:
        y = y + bias.float()
    return y


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A dense layer's forward through the int8 product, the weight (out,
    in) quantized inline (the one-off path; a session quantizes once)."""
    wq, ws = _quantize_weight(weight)
    return _int8_apply(x, _pad_weight(wq), ws, bias)


class Int8Dense(nn.Module):
    """A ``params.Dense`` served through the int8 product: its weight
    quantized once (int8, zero-padded to whole 8s, and the per-channel
    scales), its bias kept in fp32, its output in its ``compute_dtype``
    (fp32 without one).  Holds no fp32 weight."""

    def __init__(self, dense: Dense):
        super().__init__()
        with torch.no_grad():
            wq, ws = _quantize_weight(dense.weight)
            self.register_buffer("qweight", _pad_weight(wq))
            self.register_buffer("scale", ws)
            self.register_buffer(
                "bias", None if dense.bias is None else
                dense.bias.detach().float().clone())
        self.in_features, self.out_features = dense.in_features, dense.out_features
        self.compute_dtype = dense.compute_dtype

    @property
    def int8_weight(self) -> torch.Tensor:
        """The quantized (out, in) weight, without its padding."""
        return self.qweight[: self.out_features, : self.in_features]

    def forward(self, x):
        y = _int8_apply(x, self.qweight, self.scale, self.bias)
        return y.to(self.compute_dtype or torch.float32)


def quantized_layers(model: nn.Module) -> list:
    """The names of the modules ``quantize_model`` swaps: every module whose
    type is exactly ``params.Dense``."""
    return [name for name, mod in model.named_modules() if type(mod) is Dense]


def quantize_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ``params.Dense`` swapped for an
    ``Int8Dense`` (its weights quantized here, once); ``model`` itself is
    left as it is."""
    out = copy.deepcopy(model)
    for name in quantized_layers(out):
        parent, _, leaf = name.rpartition(".")
        owner = out.get_submodule(parent) if parent else out
        setattr(owner, leaf, Int8Dense(getattr(owner, leaf)))
    return out
