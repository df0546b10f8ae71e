"""Parameters: Flax-compatible initialisation and Flax <-> state-dict maps.

The port's module attributes carry the Flax module names (``forecasting_model
.encoder.layer0.self_attn.wqkv`` and so on), so a Flax parameter tree maps
onto a state dict by flattening its path.  Dense ``kernel`` (in, out) becomes
``Linear.weight`` (out, in), a 1-D Conv ``kernel`` (f, in, out) the conv1d
``weight`` (out, in, f); every other leaf keeps its name and shape.  The
input is a nested dict of numpy arrays, so loading needs no JAX;
``to_flax`` is the inverse, for parameters and for their gradients.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    matmul16,
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
    Conv ``kernel`` (f, in, out)."""
    tree: dict = {}
    for key, value in state.items():
        *path, name = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if name == "weight" and arr.ndim in (2, 3):
            name, arr = "kernel", np.ascontiguousarray(arr.T)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr
    return tree
