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
    (i = max_tries if none is).  The candidates 0..max_tries - 1 are
    factored at once on a detached copy and i is picked on the device, so
    nothing is read on the host (JAX's ``lax.while_loop`` probes them one
    by one; the pick is the same).  The result is one differentiable
    factorization at the chosen jitter."""
    a0 = a.detach()
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    s0 = torch.diagonal(a0, dim1=-2, dim2=-1).mean()
    # 10^i, exact in every float type for these i
    powers = torch.tensor([10.0 ** i for i in range(max_tries + 1)],
                          dtype=a.dtype, device=a.device)
    scaled = 1e-4 * s0 * powers  # the JAX probe's arithmetic
    if max_tries > 0:
        lead = (max_tries,) + (1,) * a0.dim()
        probes = factor(a0 + scaled[:max_tries].reshape(lead) * eye)
        ok = torch.isfinite(probes).flatten(1).all(1)
        i = torch.where(ok.any(), ok.int().argmax(),
                        torch.tensor(max_tries, device=a.device))
    else:
        i = torch.zeros((), dtype=torch.long, device=a.device)
    # a gather, not scaled[i]: indexing with a tensor would read it on the
    # host
    return factor(a + scaled.index_select(0, i.reshape(1))[0] * eye)


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
