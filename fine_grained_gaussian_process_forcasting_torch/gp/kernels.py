"""GP covariance kernels (counterpart of the JAX package's ``gp/kernels.py``).

Parametrisation follows gpytorch: positive constraints via softplus with
raw parameters initialised to 0 (lengthscale/outputscale ~= 0.6931).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def sq_dist(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distance, clamped at 0.

    x: (..., N, d), z: (M, d) -> (..., N, M), as |x|^2 + |z|^2 - 2 x.z.  The
    cross term runs in full fp32 (the package turns TF32 off), so the three
    terms stay a consistent decomposition and the Gram matrix it feeds
    remains positive definite.
    """
    x2 = (x * x).sum(-1, keepdim=True)
    z2 = (z * z).sum(-1)
    xz = torch.matmul(x, z.transpose(-1, -2))
    return torch.clamp(x2 + z2 - 2.0 * xz, min=0.0)


def rbf_ard(x: torch.Tensor, z: torch.Tensor, lengthscale: torch.Tensor,
            outputscale: torch.Tensor) -> torch.Tensor:
    """Scaled RBF-ARD cross covariance: outputscale * exp(-0.5 * d^2).

    x: (..., N, d), z: (M, d), lengthscale: (d,), outputscale: scalar.
    """
    return outputscale * torch.exp(
        -0.5 * sq_dist(x / lengthscale, z / lengthscale))
