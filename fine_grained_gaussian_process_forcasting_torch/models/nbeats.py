"""N-BEATS: trend/seasonality/generic stacks with backcast subtraction
(counterpart of the JAX package's ``models/nbeats.py``).

Default stacks (trend, seasonality), 3 blocks a stack, thetas_dim (4, 8),
a polynomial trend basis and a harmonic seasonality basis over a [0, 1)
grid; each block a 4-layer ReLU MLP with one theta head shared by backcast
and forecast (trend, seasonality) or separate heads and basis linears
(generic).  A seasonality stack's theta width is ``forecast_length``, as in
JAX.  The bases are float32 numpy constants, held as non-persistent buffers:
they move with the module and are not parameters.  Blocks are named
``stack{s}_block{b}`` with ``fc1`` .. ``fc4`` and ``theta`` (or
``theta_b``, ``theta_f``, ``backcast_fc``, ``forecast_fc``), Flax's names,
so ``params.from_flax`` maps JAX's parameters unchanged.  No hand kernel:
JAX computes the MLPs in XLA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.params import dense

TREND = "trend"
SEASONALITY = "seasonality"
GENERIC = "generic"


def _linspace(backcast_length: int, forecast_length: int, forecast: bool):
    horizon = forecast_length if forecast else backcast_length
    return np.arange(horizon) / horizon


def seasonality_basis(p: int, t: np.ndarray) -> np.ndarray:
    """(p, len(t)) harmonic basis."""
    p1, p2 = (p // 2, p // 2) if p % 2 == 0 else (p // 2, p // 2 + 1)
    s1 = np.array([np.cos(2 * np.pi * i * t) for i in range(p1)])
    s2 = np.array([np.sin(2 * np.pi * i * t) for i in range(p2)])
    return np.concatenate([s1, s2], axis=0).astype(np.float32)


def trend_basis(p: int, t: np.ndarray) -> np.ndarray:
    """(p, len(t)) polynomial basis."""
    return np.array([t**i for i in range(p)]).astype(np.float32)


class _Block(nn.Module):
    def __init__(self, units: int, thetas_dim: int, backcast_length: int,
                 forecast_length: int, block_type: str, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.block_type = block_type

        def layer(n_in, n_out, bias=True):
            return dense(n_in, n_out, bias=bias, device=device,
                         generator=generator)

        for i, n_in in enumerate((backcast_length, units, units, units), 1):
            setattr(self, f"fc{i}", layer(n_in, units))
        if block_type == GENERIC:
            self.theta_b = layer(units, thetas_dim, bias=False)
            self.theta_f = layer(units, thetas_dim, bias=False)
            self.backcast_fc = layer(thetas_dim, backcast_length)
            self.forecast_fc = layer(thetas_dim, forecast_length)
            return
        self.theta = layer(units, thetas_dim, bias=False)
        basis = trend_basis if block_type == TREND else seasonality_basis
        for name, forecast in (("basis_b", False), ("basis_f", True)):
            t = _linspace(backcast_length, forecast_length, forecast)
            self.register_buffer(
                name, torch.from_numpy(basis(thetas_dim, t)).to(device),
                persistent=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for i in range(1, 5):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        if self.block_type == GENERIC:
            return (self.backcast_fc(self.theta_b(h)),
                    self.forecast_fc(self.theta_f(h)))
        theta = self.theta(h)
        return theta @ self.basis_b, theta @ self.basis_f


class NBeats(nn.Module):
    """x: (b, backcast_length[, 1]) -> (residual backcast, forecast)."""

    def __init__(self, backcast_length: int, forecast_length: int,
                 stack_types: Sequence[str] = (TREND, SEASONALITY),
                 nb_blocks_per_stack: int = 3,
                 thetas_dim: Sequence[int] = (4, 8),
                 hidden_layer_units: int = 256, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.forecast_length = forecast_length
        self.blocks = []
        for sid, stype in enumerate(stack_types):
            tdim = (forecast_length if stype == SEASONALITY
                    else thetas_dim[sid])
            for bid in range(nb_blocks_per_stack):
                name = f"stack{sid}_block{bid}"
                setattr(self, name, _Block(
                    hidden_layer_units, tdim, backcast_length,
                    forecast_length, stype, device=device,
                    generator=generator))
                self.blocks.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        backcast = x
        forecast = torch.zeros((x.shape[0], self.forecast_length),
                               dtype=x.dtype, device=x.device)
        for name in self.blocks:
            b, f = getattr(self, name)(backcast)
            backcast = backcast - b
            forecast = forecast + f
        return backcast, forecast
