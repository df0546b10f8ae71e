"""Exact GP regression, the O(n^3) Cholesky path (counterpart of the JAX
package's ``gp/exact.py``).

ConstantMean + ScaleKernel(RBF) + Gaussian likelihood with the closed-form
posterior and marginal log likelihood, as pure functions over an explicit
parameter tuple.  The factorization is the library's
(``ops.cuda.cholesky.batched_cholesky_plain``: NaN where it fails, as
``jnp.linalg.cholesky``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import (
    rbf_ard,
    softplus,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.cholesky import (
    batched_cholesky_plain,
)


class ExactGPParams(NamedTuple):
    raw_lengthscale: torch.Tensor  # (d,)
    raw_outputscale: torch.Tensor  # ()
    raw_noise: torch.Tensor  # ()
    mean_const: torch.Tensor  # ()


def init_exact_gp(d: int, device="cuda") -> ExactGPParams:
    device = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return ExactGPParams(raw_lengthscale=zeros(d), raw_outputscale=zeros(),
                         raw_noise=zeros(), mean_const=zeros())


def psd_safe_cholesky(a: torch.Tensor, max_tries: int = 3,
                      factor=batched_cholesky_plain) -> torch.Tensor:
    """Cholesky with adaptive jitter escalation (gpytorch's
    ``psd_safe_cholesky``): the smallest jitter 1e-4 * s0 * 10^i, i in
    0..max_tries, for which ``factor`` (NaN where it fails) is finite in
    every matrix of the batch, s0 the mean diagonal over the whole batch
    (i = max_tries if none is).  The probes run on a detached copy, one
    device read each; the result is one differentiable factorization at
    the chosen jitter."""
    a0 = a.detach()
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    s0 = torch.diagonal(a0, dim1=-2, dim2=-1).mean()
    ten = torch.tensor(10.0, dtype=a.dtype, device=a.device)

    def jittered(m, i):  # in the arithmetic of the JAX probe
        return m + 1e-4 * s0 * ten ** i * eye

    i = 0
    while (i < max_tries
           and not bool(torch.isfinite(factor(jittered(a0, i))).all())):
        i += 1
    return factor(jittered(a, i))


def _chol_factors(params: ExactGPParams, x: torch.Tensor, y: torch.Tensor):
    ls = softplus(params.raw_lengthscale)
    os_ = softplus(params.raw_outputscale)
    noise = softplus(params.raw_noise)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    chol = psd_safe_cholesky(rbf_ard(x, x, ls, os_) + noise * eye)
    resid = (y - params.mean_const)[:, None]
    alpha = torch.cholesky_solve(resid, chol)[:, 0]
    return ls, os_, chol, alpha


def exact_gp_posterior(params: ExactGPParams, x: torch.Tensor,
                       y: torch.Tensor, x_star: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and marginal variance at x_star given train (x, y)."""
    ls, os_, chol, alpha = _chol_factors(params, x, y)
    k_star = rbf_ard(x_star, x, ls, os_)  # (N*, N)
    mean = params.mean_const + k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
    var = os_ - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=1e-8)


def exact_gp_mll(params: ExactGPParams, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Marginal log likelihood log N(y | mu, Kxx + noise I)."""
    _, _, chol, alpha = _chol_factors(params, x, y)
    n = x.shape[0]
    resid = y - params.mean_const
    return (-0.5 * resid @ alpha
            - torch.sum(torch.log(torch.diagonal(chol)))
            - 0.5 * n * math.log(2.0 * math.pi))
