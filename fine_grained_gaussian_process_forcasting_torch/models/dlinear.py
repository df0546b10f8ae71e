"""DLinear: moving-average series decomposition + two linear heads
(counterpart of the JAX package's ``models/dlinear.py``).

The shared-channel variant: decompose with a kernel-25 moving average
(edge-replicated), map the seasonal and trend components seq_len ->
pred_len with linears whose kernels start at 1/seq_len.  The moving average
is JAX's: a float32 cumulative sum of the padded series and the difference
of its ends, not ``avg_pool1d`` (which sums each window in another order).
No hand kernel: JAX computes all of it in XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.params import Dense


def moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Trend extraction with replicated-edge padding.  x: (b, l, c)."""
    pad = (kernel_size - 1) // 2
    front = x[:, :1, :].expand(-1, pad, -1)
    end = x[:, -1:, :].expand(-1, pad, -1)
    zero = torch.zeros_like(x[:, :1, :])
    xp = torch.cat([zero, front, x, end], dim=1)
    # at least float32, as JAX's cumsum(dtype=float32)
    csum = torch.cumsum(xp, dim=1,
                        dtype=torch.promote_types(x.dtype, torch.float32))
    return (csum[:, kernel_size:] - csum[:, :-kernel_size]) / kernel_size


def series_decomp(x: torch.Tensor, kernel_size: int = 25):
    """(residual, moving_mean)."""
    mean = moving_avg(x, kernel_size)
    return x - mean, mean


class DLinear(nn.Module):
    """x: (b, seq_len, c) -> (b, pred_len, c).  Parameters are named as
    Flax names them (``linear_seasonal``, ``linear_trend``), so
    ``params.from_flax`` maps JAX's onto them."""

    def __init__(self, seq_len: int, pred_len: int, kernel_size: int = 25,
                 *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.seq_len, self.pred_len = seq_len, pred_len
        self.kernel_size = kernel_size
        for name in ("linear_seasonal", "linear_trend"):
            layer = Dense(seq_len, pred_len, device=device)
            nn.init.constant_(layer.weight, 1.0 / seq_len)
            nn.init.zeros_(layer.bias)
            setattr(self, name, layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seasonal, trend = series_decomp(x, self.kernel_size)
        out = (self.linear_seasonal(seasonal.transpose(1, 2))
               + self.linear_trend(trend.transpose(1, 2)))
        return out.transpose(1, 2)
