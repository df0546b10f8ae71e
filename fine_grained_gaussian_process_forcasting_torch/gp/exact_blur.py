"""Exact-GP blur at full sequence length (counterpart of the JAX package's
``gp/exact_blur.py``).

Instead of the inducing-point variational approximation, an exact GP over
each sequence's hidden states smooths a learned 1-d projection:

    z = x w + b                       (b, s)
    K = k(x, x)                       (b, s, s)   RBF-ARD over hidden dims
    m = K (K + noise I)^{-1} z        (b, s)      posterior mean

and the training signal is the exact marginal log likelihood of y under the
same kernel, mll = -0.5 (y^T A^-1 y + log|A| + n log 2 pi) / n with
A = K + noise I.

The batched factorization is the library's (cuSOLVER on the card, NaN
where it fails) unless ``use_pallas``, which takes the hand-written kernel
of ``ops/cuda/cholesky.py``.  The psd-safe jitter escalation
(``gp/exact.py`` ``psd_safe_cholesky``) factors its probes at once and
picks the jitter on the device, nothing read on the host (JAX runs it in a
``lax.while_loop``); under ``torch.func.vmap`` each seed's jitter comes
from its own probes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.exact import (
    psd_safe_cholesky,
)
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import softplus
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.cholesky import (
    batched_cholesky,
    batched_cholesky_plain,
)
from fine_grained_gaussian_process_forcasting_torch.params import normal_

_NOISE_FLOOR = 1e-4


def _softplus_inv(value: float, auto: float) -> float:
    """Raw value of a softplus-constrained positive: 0.0 = the reference's
    raw zeros, < 0 = ``auto``, > 0 = that value."""
    if value == 0.0:
        return 0.0
    v0 = float(auto) if value < 0 else float(value)
    return math.log(math.expm1(v0))


class ExactGPBlur(nn.Module):
    """``ls_init``: initial lengthscale (0 = raw zeros, ~0.693; < 0 = auto
    sqrt(2 d); > 0 explicit).  ``noise_init``: initial likelihood noise
    (0 = raw zeros, ~0.693; < 0 = 0.693; > 0 explicit)."""

    def __init__(self, input_dims: int, use_pallas: bool = False,
                 ls_init: float = 0.0, noise_init: float = 0.0, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        d = input_dims
        self.use_pallas = use_pallas

        def param(*shape, fill=0.0):
            return nn.Parameter(torch.full(shape, fill, device=device))

        self.raw_lengthscale = param(
            d, fill=_softplus_inv(ls_init, math.sqrt(2.0 * d)))
        self.raw_outputscale = param()
        self.raw_noise = param(fill=_softplus_inv(noise_init, 0.693))
        self.mean_weight = param(d)
        self.mean_bias = param()
        normal_(self.mean_weight, 1.0 / d, generator)

    def _factor(self, x: torch.Tensor):
        """x: (b, s, d) -> (K, L) with A = K + noise I = L L^T."""
        # 1e-3 floor: softplus alone can underflow to 0 under joint
        # training, and x / ls then overflows (d2 = inf - inf = NaN)
        ls = softplus(self.raw_lengthscale) + 1e-3
        os_ = softplus(self.raw_outputscale)
        noise = softplus(self.raw_noise) + _NOISE_FLOOR
        xs = x / ls
        x2 = torch.sum(xs * xs, dim=-1)
        # a full-fp32 Gram product (TF32 is off): an inconsistent
        # decomposition turns K indefinite once the lengthscales shrink
        d2 = (x2[..., :, None] + x2[..., None, :]
              - 2.0 * torch.matmul(xs, xs.transpose(-1, -2)))
        k = os_ * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
        eye = torch.eye(x.shape[1], dtype=k.dtype, device=k.device)
        a = k + noise * eye
        # the jitter shared across the batch
        chol = psd_safe_cholesky(a, factor=batched_cholesky if self.use_pallas
                                 else batched_cholesky_plain)
        return k, chol

    def smooth(self, x: torch.Tensor) -> torch.Tensor:
        """Posterior-mean smoothing of the hidden projection: (b, s)."""
        k, chol = self._factor(x)
        z = torch.einsum("bsd,d->bs", x, self.mean_weight) + self.mean_bias
        alpha = torch.cholesky_solve(z[..., None], chol)[..., 0]
        return torch.einsum("bst,bt->bs", k, alpha)

    def mll(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-point exact marginal log likelihood, averaged over the batch.
        x: (b, s, d); y: (b, s)."""
        _, chol = self._factor(x)
        resid = (y - (torch.einsum("bsd,d->bs", x, self.mean_weight)
                      + self.mean_bias))[..., None]
        alpha = torch.cholesky_solve(resid, chol)
        n = y.shape[-1]
        quad = torch.sum(resid * alpha, dim=(-1, -2))
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        mll = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
        return torch.mean(mll / n)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        mean = self.smooth(x)
        return mean, (self.mll(x, y) if y is not None else None)
