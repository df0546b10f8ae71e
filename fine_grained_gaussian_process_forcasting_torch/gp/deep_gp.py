"""Whitened variational deep GP (counterpart of the JAX ``gp/deep_gp.py``).

Math (whitened strategy, mean-field q(u) = N(m, diag(s^2)) over whitened
inducing values):

    Kzz = k(Z, Z) + jitter*I,  L = chol(Kzz)
    A   = L^{-1} k(Z, x)                      (M x N)
    E[f(x)]   = mu(x) + A^T m
    Var[f(x)] = k(x,x) - sum_M A^2 + sum_M (s * A)^2      (diagonal only)
    KL(q(u) || N(0, I)) = 0.5 * sum_M (s^2 + m^2 - 1 - 2 log s)

Only the marginal (diagonal) posterior is formed.  With ``use_fused`` the
(B, N, M) cross-covariance never reaches device memory: the marginals go
through ``ops/cuda/fused_gp.py`` (the CUDA kernel on the card, its plain
version on the CPU).  The Cholesky, L^-1, u and W are small host-side
library calls, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import (
    rbf_ard,
    softplus,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp
from fine_grained_gaussian_process_forcasting_torch.params import normal_

_JITTER = 1e-4  # gpytorch's float32 cholesky jitter scale
_NOISE_FLOOR = 1e-4  # gpytorch GaussianLikelihood GreaterThan(1e-4)


class GPPosterior(NamedTuple):
    """Marginal posterior q(f) plus the layer's variational bookkeeping.

    ``mean``/``var``: (..., N) marginals; ``kl``: scalar KL(q(u)||p(u));
    ``noise``: the Gaussian likelihood's noise variance.
    """

    mean: torch.Tensor
    var: torch.Tensor
    kl: torch.Tensor
    noise: torch.Tensor


class _VariationalLayer(nn.Module):
    """One whitened mean-field variational GP layer with a scalar output.

    ``ls_init``: initial lengthscale; 0.0 = reference init (raw zeros,
    ~0.693), < 0 = sqrt(2 d), > 0 = that value.
    """

    def __init__(self, input_dims: int, num_inducing: int = 256,
                 use_fused: bool = False, ls_init: float = 0.0, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        d, m = input_dims, num_inducing
        self.input_dims, self.num_inducing = d, m
        self.use_fused = use_fused

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.inducing_points = param(m, d)
        self.variational_mean = param(m)
        self.variational_log_stddev = param(m)
        self.raw_lengthscale = param(d)
        self.raw_outputscale = param()
        self.mean_weight = param(d)
        self.mean_bias = param()
        # the distributions of the Flax initialisers; the draws themselves
        # differ from JAX's, so parity tests load converted weights
        normal_(self.inducing_points, 1.0, generator)
        normal_(self.mean_weight, 1.0 / d, generator)
        if ls_init != 0.0:
            ls0 = math.sqrt(2.0 * d) if ls_init < 0 else float(ls_init)
            with torch.no_grad():
                self.raw_lengthscale.fill_(math.log(math.expm1(ls0)))

    def forward(self, x: torch.Tensor):
        m = self.num_inducing
        lengthscale = softplus(self.raw_lengthscale)
        outputscale = softplus(self.raw_outputscale)
        z = self.inducing_points
        kzz = rbf_ard(z, z, lengthscale, outputscale)
        kzz = kzz + _JITTER * torch.eye(m, dtype=kzz.dtype, device=kzz.device)
        chol = torch.linalg.cholesky(kzz)
        # explicit small inverse: the downstream solves become matmuls
        chol_inv = torch.linalg.solve_triangular(
            chol, torch.eye(m, dtype=kzz.dtype, device=kzz.device),
            upper=False)
        var_mean = self.variational_mean
        log_std = self.variational_log_stddev
        s2 = torch.exp(2.0 * log_std)
        kl = 0.5 * torch.sum(s2 + var_mean * var_mean - 1.0 - 2.0 * log_std)

        if self.use_fused:
            u = chol_inv.T @ var_mean
            w_mat = chol_inv.T @ (chol_inv * (1.0 - s2)[:, None])
            xr = x[None] if x.dim() == 2 else x
            mean, var = fused_gp.whitened_marginals_affine(
                xr.contiguous(), (z / lengthscale).contiguous(),
                u.contiguous(), w_mat.contiguous(), outputscale,
                (1.0 / lengthscale).contiguous(), self.mean_weight,
                self.mean_bias)
            if x.dim() == 2:
                mean, var = mean[0], var[0]
            return mean, torch.clamp(var, min=1e-8), kl

        kzx = rbf_ard(x, z, lengthscale, outputscale)  # (..., N, M)
        a = torch.einsum("mk,...nk->...nm", chol_inv, kzx)
        mean = (torch.einsum("...nd,d->...n", x, self.mean_weight)
                + self.mean_bias + a @ var_mean)
        s = torch.exp(log_std)
        var = (outputscale - torch.sum(a * a, dim=-1)
               + torch.sum((a * s) ** 2, dim=-1))
        return mean, torch.clamp(var, min=1e-8), kl


class DeepGP(nn.Module):
    """Deep GP with linear mean + Gaussian likelihood: the reference's
    shipped single-layer configuration (``hidden_dims=()``)."""

    def __init__(self, input_dims: int, num_inducing: int = 256,
                 use_pallas: bool = False, use_fused: bool = False,
                 hidden_dims: Tuple[int, ...] = (),
                 compute_dtype: Optional[torch.dtype] = None,
                 ls_init: float = 0.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if tuple(hidden_dims):
            raise NotImplementedError(
                "hidden_dims != () (multi-layer deep GP) is not ported yet "
                "(ROADMAP.md modules to port, item 3)")
        if use_pallas:
            raise NotImplementedError(
                "use_pallas (rbf_cross_kernel) is not ported yet "
                "(ROADMAP.md TPU kernels to port, rbf)")
        if compute_dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"compute_dtype={compute_dtype}: the bf16 GP path is not "
                "ported yet (ROADMAP.md modules to port, item 14)")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.raw_noise = nn.Parameter(torch.zeros((), device=device))
        self.output_layer = _VariationalLayer(
            input_dims, num_inducing, use_fused, ls_init, device=device,
            generator=generator)

    def forward(self, x: torch.Tensor) -> GPPosterior:
        """x: (..., N, d) -> marginal q(f) over the N points."""
        mean, var, kl = self.output_layer(x)
        noise = softplus(self.raw_noise) + _NOISE_FLOOR
        return GPPosterior(mean=mean, var=var, kl=kl, noise=noise)


def gaussian_expected_log_prob(y: torch.Tensor,
                               posterior: GPPosterior) -> torch.Tensor:
    """E_{q(f)}[log N(y | f, noise)] per point."""
    return -0.5 * (((y - posterior.mean) ** 2 + posterior.var)
                   / posterior.noise
                   + torch.log(2.0 * math.pi * posterior.noise))


def variational_elbo(y: torch.Tensor, posterior: GPPosterior,
                     num_data: int) -> torch.Tensor:
    """Mean-over-points expected log likelihood minus KL/num_data, then the
    mean over batch dims (gpytorch ``VariationalELBO`` arithmetic)."""
    ell = gaussian_expected_log_prob(y, posterior).mean(dim=-1)
    return (ell - posterior.kl / num_data).mean()
