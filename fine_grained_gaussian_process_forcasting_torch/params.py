"""Parameters: Flax-compatible initialisation and Flax <-> state-dict maps.

The port's module attributes carry the Flax module names (``forecasting_model
.encoder.layer0.self_attn.wqkv`` and so on), so a Flax parameter tree maps
onto a state dict by flattening its path.  Dense ``kernel`` (in, out) becomes
``Linear.weight`` (out, in), a 1-D Conv ``kernel`` (f, in, out) the conv1d
``weight`` (out, in, f); an LSTM cell ``lstm{i}`` (gates i, f, g, o, each a
Dense ``i*`` on the input and ``h*`` with a bias on the hidden state) becomes
layer i of ``nn.LSTM`` ``lstm``, its gates stacked, with a zero ``b_ih``
(``models/lstm.py``), and DeepAR's cell ``rnn{i}/cell`` (Flax's ``nn.RNN``
of one such cell) the one-layer ``nn.LSTM`` ``rnn{i}.cell``
(``models/deepar.py``); every other leaf keeps its name and shape.  So
no map is needed for Flax's ``LayerNorm`` (``scale``, ``bias``) or
``nn.Embed`` (``embedding``): the port's ``LayerNorm`` and ``Embed`` below
hold leaves of those names.  The input is a nested dict of numpy arrays, so
loading needs no JAX; ``to_flax`` is the inverse, for parameters and for
their gradients.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    matmul16,
    widen,
)

# Flax's lecun_normal: truncated normal at +-2 std, rescaled so the
# truncated distribution keeps variance 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In-place Flax ``lecun_normal`` on a (out, in) ``Linear.weight``.

    Draws on the CPU from ``generator`` and copies, so a seed gives the same
    weights on every device."""
    fan_in = weight.shape[1]
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD_CORRECTION
    cpu = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.trunc_normal_(cpu, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(cpu)


def normal_(param: torch.Tensor, std: float,
            generator: torch.Generator) -> None:
    """In-place N(0, std^2), drawn on the CPU from ``generator``."""
    cpu = torch.empty(param.shape, dtype=param.dtype)
    nn.init.normal_(cpu, 0.0, std, generator=generator)
    with torch.no_grad():
        param.copy_(cpu)


class Dense(nn.Linear):
    """``nn.Linear`` with Flax's ``Dense(dtype=)``: with a ``compute_dtype``
    the input, weight and bias are cast to it (the parameters themselves
    stay fp32), the product is rounded to that dtype and the bias is added
    in it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dtype = self.compute_dtype
        if dtype is None:
            return super().forward(x)
        out = matmul16(x.to(dtype), self.weight.to(dtype).T)
        return out if self.bias is None else out + self.bias.to(dtype)


def dense(in_features: int, out_features: int, *, bias: bool,
          device: torch.device, generator: torch.Generator,
          dtype: Optional[torch.dtype] = None) -> Dense:
    """A linear layer initialised like Flax ``nn.Dense`` (lecun-normal
    kernel, zero bias) that computes in ``dtype`` (None: as it is given)."""
    layer = Dense(in_features, out_features, bias=bias, device=device)
    layer.compute_dtype = dtype
    lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon)`` over the last axis, with its leaves
    ``scale`` and ``bias`` and its arithmetic: the statistics in fp32 (a
    16-bit input widened),
    var = E[x^2] - E[x]^2 clipped at 0, (x - mean) * (rsqrt(var + eps) *
    scale) + bias."""

    def __init__(self, features: int, epsilon: float = 1e-5, *, device):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = widen(x)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Embed(nn.Module):
    """Flax ``nn.Embed(num, features)``: a lookup of the rows of its leaf
    ``embedding`` (num, features), drawn N(0, 1 / features)."""

    def __init__(self, num: int, features: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features,
                                                  device=device))
        normal_(self.embedding, features ** -0.5, generator)

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return self.embedding[index]


_GATES = "ifgo"  # Flax's and nn.LSTM's order of the gates
_LSTM_CELL = re.compile(r"lstm(\d+)$")
_RNN_SCOPE = re.compile(r"(?:^|\.)rnn\d+\.$")  # the prefix of rnn{i}/cell
_LSTM_LEAF = re.compile(r"(?:(.*)\.)?lstm\.(weight_ih|weight_hh|bias_hh|"
                        r"bias_ih)_l(\d+)$")
_RNN_LEAF = re.compile(r"((?:.*\.)?rnn\d+\.cell)\.(weight_ih|weight_hh|"
                       r"bias_hh|bias_ih)_l0$")
_CELL_LEAVES = frozenset(side + g for side in "ih" for g in _GATES)


def _lstm_leaves(cell: Mapping, module: str, layer: str) -> dict:
    """One Flax LSTM cell -> layer ``layer`` of the ``nn.LSTM`` at
    ``module``."""
    def stacked(side, leaf):  # kernels (in, out) -> rows (out, in)
        return np.concatenate([np.array(cell[side + g][leaf], np.float32).T
                               for g in _GATES])

    out = {"weight_ih": stacked("i", "kernel"),
           "weight_hh": stacked("h", "kernel"),
           "bias_hh": stacked("h", "bias")}
    out["bias_ih"] = np.zeros_like(out["bias_hh"])
    return {f"{module}.{name}_l{layer}":
            torch.from_numpy(np.ascontiguousarray(arr))
            for name, arr in out.items()}


def from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax parameter tree (nested dict of arrays) -> CPU state dict.

    Accepts the tree ``ForecastDenoising.init(...)["params"]`` returns, or
    the same tree still wrapped as ``{"params": ...}``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    state: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            is_cell = isinstance(value, Mapping) and set(value) == _CELL_LEAVES
            cell = _LSTM_CELL.match(name)
            if cell and is_cell:
                state.update(_lstm_leaves(value, prefix + "lstm",
                                          cell.group(1)))
                continue
            if name == "cell" and is_cell and _RNN_SCOPE.search(prefix):
                state.update(_lstm_leaves(value, prefix + "cell", "0"))
                continue
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if name == "kernel":
                if arr.ndim not in (2, 3):
                    raise ValueError(f"{prefix}kernel has shape {arr.shape}; "
                                     "only Dense and 1-D Conv kernels are "
                                     "mapped")
                name, arr = "weight", np.ascontiguousarray(arr.T)
            state[prefix + name] = torch.from_numpy(arr)

    walk(params, "")
    return state


def to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict (or a dict of gradients keyed like it) -> Flax-shaped
    nested dict of float32 numpy arrays; the inverse of ``from_flax``.

    Every 2-D ``weight`` of the port is an ``nn.Linear``'s, and becomes the
    Dense ``kernel`` (in, out); every 3-D one a conv1d's, and becomes the
    Conv ``kernel`` (f, in, out).  An ``nn.LSTM``'s layers become Flax's
    cells (``lstm{i}``, or ``rnn{i}/cell`` for DeepAR's one-layer
    ``rnn{i}.cell``), their gates split; its zero ``b_ih`` has no Flax
    leaf."""
    tree: dict = {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy().astype(np.float32)
        lstm, rnn = _LSTM_LEAF.match(key), _RNN_LEAF.match(key)
        if lstm or rnn:
            if rnn:
                module, kind = rnn.groups()
                path = module.split(".")
            else:
                prefix, kind, layer = lstm.groups()
                path = (prefix.split(".") if prefix else []) + [
                    f"lstm{layer}"]
            if kind == "bias_ih":
                continue
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            side = "i" if kind == "weight_ih" else "h"
            leaf = "bias" if kind == "bias_hh" else "kernel"
            for g, block in zip(_GATES, np.split(arr, 4)):
                node.setdefault(side + g, {})[leaf] = np.ascontiguousarray(
                    block.T)
            continue
        *path, name = key.split(".")
        if name == "weight" and arr.ndim in (2, 3):
            name, arr = "kernel", np.ascontiguousarray(arr.T)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr
    return tree
