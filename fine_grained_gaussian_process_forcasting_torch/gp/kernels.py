"""GP covariance kernels (counterpart of the JAX package's ``gp/kernels.py``).

Parametrisation follows gpytorch: positive constraints via softplus with
raw parameters initialised to 0 (lengthscale/outputscale ~= 0.6931).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def sq_dist(x: torch.Tensor, z: torch.Tensor,
            compute_dtype=None) -> torch.Tensor:
    """Pairwise squared Euclidean distance, clamped at 0.

    x: (..., N, d), z: (..., M, d) -> (..., N, M), as |x|^2 + |z|^2 - 2 x.z
    (z's leading dims broadcast against x's, as for the h GPs of a deep GP's
    hidden layer).  The
    cross term runs in full fp32 (the package turns TF32 off), so the three
    terms stay a consistent decomposition and the Gram matrix it feeds
    remains positive definite.  With a ``compute_dtype`` (bfloat16) the
    points are cast to it first: the norms are fp32 sums over the cast
    values and the cross term is exact products of them summed in fp32, so
    the decomposition is that of the cast points and stays consistent.
    """
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        z = z.to(compute_dtype).float()
    x2 = (x * x).sum(-1, keepdim=True)
    z2 = (z * z).sum(-1).unsqueeze(-2)
    xz = torch.matmul(x, z.transpose(-1, -2))
    return torch.clamp(x2 + z2 - 2.0 * xz, min=0.0)


def rbf_ard(x: torch.Tensor, z: torch.Tensor, lengthscale: torch.Tensor,
            outputscale: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Scaled RBF-ARD cross covariance: outputscale * exp(-0.5 * d^2).

    x: (..., N, d), z: (M, d), lengthscale: (d,), outputscale: scalar.
    """
    return outputscale * torch.exp(
        -0.5 * sq_dist(x / lengthscale, z / lengthscale, compute_dtype))


def matern_ard(x: torch.Tensor, z: torch.Tensor, lengthscale: torch.Tensor,
               outputscale: torch.Tensor, nu: float = 2.5) -> torch.Tensor:
    """Matern-nu ARD kernel, nu in {0.5, 1.5, 2.5} (gpytorch
    ``MaternKernel``)."""
    r = torch.sqrt(sq_dist(x / lengthscale, z / lengthscale) + 1e-12)
    if nu == 0.5:
        k = torch.exp(-r)
    elif nu == 1.5:
        a = 3.0 ** 0.5 * r
        k = (1.0 + a) * torch.exp(-a)
    elif nu == 2.5:
        a = 5.0 ** 0.5 * r
        k = (1.0 + a + a * a / 3.0) * torch.exp(-a)
    else:
        raise ValueError(f"unsupported nu={nu}")
    return outputscale * k
