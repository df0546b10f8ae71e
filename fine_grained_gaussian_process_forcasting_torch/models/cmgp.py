"""CMGP baseline: a convolved-process Gaussian-process forecaster
(counterpart of the JAX package's ``models/cmgp.py``).

Q shared white-noise latent processes convolved with Gaussian smoothing
kernels; on the harness's univariate windows this is one GP whose
covariance is a Q-component mixture of RBFs over time,

    k(t, t') = sum_q  s_q * exp(-(t - t')^2 / (4 * l_q^2)) ,

with s_q > 0 mixture weights (softplus), 4 l_q^2 the variance of two
convolved width-l_q kernels, a constant mean and Gaussian observation
noise.  Hyperparameters train by exact marginal likelihood over the
training windows; the forecast is the exact posterior mean at the horizon
given the window's history.

The time grid is hourly in days (``arange(n) / 24``) and shared by every
window of a batch: one (T, T) Gram matrix, one Cholesky
(``gp/exact.py`` ``psd_safe_cholesky``, the library's factorization, jitter
1e-4 on top of the noise), solved against a (T, b) right-hand side with
``torch.linalg.solve_triangular``.  Distances are broadcast subtractions of
the scalar grid, not products, so no tensor-core rounding reaches the Gram
matrix.  JAX computes all of it in XLA (``jnp.linalg.cholesky``), so this
has no hand kernel.  The smooth mixture kernel is ill-conditioned in fp32
at a few hundred steps: results are judged against float64, not across
devices.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.exact import (
    psd_safe_cholesky,
)
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import softplus


def _inv_softplus(y):
    # stable inverse of softplus for init constants
    return y + np.log(-np.expm1(-y))


class CMGP(nn.Module):
    """Convolved-process GP regression over a fixed hourly time grid.

    ``forward(x)``: x (b, L, 1) history -> (b, pred_len, 1) posterior mean.
    ``nll(x, y)``:  mean per-point negative log marginal likelihood of the
                    joint [history ++ target] window (the training loss).
    """

    def __init__(self, pred_len: int, n_latent: int = 2,
                 jitter: float = 1e-4, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.pred_len, self.n_latent, self.jitter = pred_len, n_latent, jitter
        q = n_latent
        # smoothing-kernel widths staggered across octaves so the mixture
        # spans short- and long-range structure at init (time unit: 1 day)
        width0 = 0.125 * (4.0 ** np.arange(q, dtype=np.float64))

        def param(value):
            return nn.Parameter(torch.tensor(value, dtype=torch.float32,
                                             device=device))

        self.raw_width = param(_inv_softplus(width0).astype(np.float32))
        self.raw_scale = param(np.full((q,), float(_inv_softplus(1.0 / q)),
                                       np.float32))
        self.raw_noise = param(float(_inv_softplus(0.1)))
        self.mean_const = param(0.0)

    def _hyper(self):
        return (softplus(self.raw_width), softplus(self.raw_scale),
                softplus(self.raw_noise), self.mean_const)

    @staticmethod
    def _gram(t_row, t_col, widths, scales):
        """Mixture-of-RBF covariance on scalar time grids (no product)."""
        d2 = (t_row[:, None] - t_col[None, :]) ** 2  # (R, C)
        var = 4.0 * widths**2  # convolution of two width-l kernels
        return torch.sum(scales[:, None, None]
                         * torch.exp(-d2[None] / var[:, None, None]), dim=0)

    def _grid(self, n: int) -> torch.Tensor:
        # hourly data; unit = 1 day so daily structure sits at width ~ 1
        return torch.arange(n, dtype=self.raw_width.dtype,
                            device=self.raw_width.device) / 24.0

    def _eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=self.raw_width.dtype,
                         device=self.raw_width.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        widths, scales, noise, mean = self._hyper()
        L = x.shape[1]
        t = self._grid(L + self.pred_len)
        t_h, t_f = t[:L], t[L:]
        k_hh = (self._gram(t_h, t_h, widths, scales)
                + (noise + self.jitter) * self._eye(L))
        k_fh = self._gram(t_f, t_h, widths, scales)  # (H, L)
        chol = psd_safe_cholesky(k_hh)
        resid = (x[..., 0] - mean).T  # (L, b)
        alpha = torch.linalg.solve_triangular(
            chol.T, torch.linalg.solve_triangular(chol, resid, upper=False),
            upper=True)  # K^-1 (y - m), (L, b)
        return (mean + (k_fh @ alpha).T)[..., None]  # (b, H, 1)

    def nll(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean per-point negative log marginal likelihood, joint window."""
        widths, scales, noise, mean = self._hyper()
        z = torch.cat([x, y], dim=1)[..., 0]  # (b, T)
        T = z.shape[1]
        t = self._grid(T)
        k = (self._gram(t, t, widths, scales)
             + (noise + self.jitter) * self._eye(T))
        chol = psd_safe_cholesky(k)
        resid = (z - mean).T  # (T, b)
        w = torch.linalg.solve_triangular(chol, resid, upper=False)
        quad = torch.mean(torch.sum(w * w, dim=0))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return 0.5 * (quad + logdet + T * math.log(2.0 * math.pi)) / T
