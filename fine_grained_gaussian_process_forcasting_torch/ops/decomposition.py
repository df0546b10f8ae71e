"""Series decomposition (the Autoformer / FEDformer building blocks).

Counterpart of the JAX package's ``ops/decomposition.py``, in plain PyTorch
(the JAX version has no Pallas kernel): an edge-replicated moving average
with the reference's asymmetric padding for even kernels, single and
multi-kernel decomposition (a learned softmax mix of the kernels' trends)
and the seasonal layernorm.  The moving average is JAX's arithmetic: an fp32
cumulative sum of the padded series and the difference of its ends, not
``avg_pool1d`` (which sums each window in another order).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.params import (
    LayerNorm,
    dense,
)


def moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Edge-replicated moving average over axis 1 of x (b, l, c): front
    k - 1 - (k - 1) // 2 copies of the first row, end (k - 1) // 2 of the
    last, so an even kernel pads one more row in front."""
    end = (kernel_size - 1) // 2
    front = kernel_size - 1 - end
    xp = torch.cat([x.new_zeros(x.shape[0], 1, x.shape[2]),
                    x[:, :1].expand(-1, front, -1), x,
                    x[:, -1:].expand(-1, end, -1)], dim=1)
    csum = torch.cumsum(xp, dim=1,
                        dtype=torch.promote_types(x.dtype, torch.float32))
    return ((csum[:, kernel_size:] - csum[:, :-kernel_size])
            / kernel_size).to(x.dtype)


def series_decomp(x: torch.Tensor, kernel_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seasonal residual, trend)."""
    trend = moving_avg(x, kernel_size)
    return x - trend, trend


class SeriesDecompMulti(nn.Module):
    """Multi-kernel decomposition: the kernels' trends mixed by a softmax of
    ``mix``, a Dense(1 -> K) of each value."""

    def __init__(self, kernel_sizes: Sequence[int], *, device, generator):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.mix = dense(1, len(self.kernel_sizes), bias=True, device=device,
                         generator=generator)

    def forward(self, x):
        means = torch.stack([moving_avg(x, k) for k in self.kernel_sizes],
                            dim=-1)  # (b, l, c, K)
        weights = torch.softmax(self.mix(x[..., None]), dim=-1)
        trend = (means * weights).sum(-1)
        return x - trend, trend


class MyLayerNorm(nn.Module):
    """Seasonal layernorm: LayerNorm (Flax's auto-named ``LayerNorm_0``),
    then its mean over time subtracted."""

    def __init__(self, channels: int, *, device):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(channels, device=device)

    def forward(self, x):
        x_hat = self.LayerNorm_0(x)
        return x_hat - x_hat.mean(dim=1, keepdim=True)
