"""Whitened variational deep GP (counterpart of the JAX ``gp/deep_gp.py``).

Math (whitened strategy, mean-field q(u) = N(m, diag(s^2)) over whitened
inducing values):

    Kzz = k(Z, Z) + jitter*I,  L = chol(Kzz)
    A   = L^{-1} k(Z, x)                      (M x N)
    E[f(x)]   = mu(x) + A^T m
    Var[f(x)] = k(x,x) - sum_M A^2 + sum_M (s * A)^2      (diagonal only)
    KL(q(u) || N(0, I)) = 0.5 * sum_M (s^2 + m^2 - 1 - 2 log s)

Only the marginal (diagonal) posterior is formed.  With ``use_fused`` a
scalar layer's (B, N, M) cross-covariance never reaches device memory: the
marginals go through ``ops/cuda/fused_gp.py`` (the CUDA kernel on the card,
its plain version on the CPU).  Otherwise K is formed, by
``ops/cuda/rbf.py`` with ``use_pallas`` (one launch for all the GPs of a
layer) or by ``rbf_ard``.  The Cholesky, L^-1, u and W are small library
calls, as in the JAX package; under ``torch.func.vmap`` (multi-seed
training) one call a seed (``seedwise.py``).

``hidden_dims`` stacks hidden layers of h independent GPs each (the JAX
layer vmaps one GP over h; here every parameter carries a leading h axis
and every product is batched over it), whose marginals feed the next layer
as a reparameterized draw x = mean + sqrt(var) * eps.  eps comes from the
caller (injected draws), else from ``generator`` (the generator the model
threads for its isotropic noise), else it is 0, as the JAX module without a
``noise`` rng.

``compute_dtype``: a 16-bit dtype runs the two heavy products on inputs
rounded to it, summed in fp32 -- the fused path through the bf16 fused
kernel (K W and, in the backward, K^T (dvar o K)), the unfused path through
the cross-covariance's inner product and the whitened solve.  Parameters,
the Cholesky, L^-1, u, W, the exponential and the KL stay fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch import draws
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import (
    rbf_ard,
    softplus,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    fused_gp,
    rbf,
)
from fine_grained_gaussian_process_forcasting_torch.params import normal_
from fine_grained_gaussian_process_forcasting_torch.seedwise import seedwise

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


def _inverse_factor(kzz: torch.Tensor) -> torch.Tensor:
    """L^-1 of Kzz + jitter = L L^T, explicit (a small inverse: the
    downstream solves become matmuls)."""
    eye = torch.eye(kzz.shape[-1], dtype=kzz.dtype, device=kzz.device)
    chol = torch.linalg.cholesky(kzz + _JITTER * eye)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                         upper=False)


def _whitened_products(chol_inv, var_mean, s2):
    """The whitened q(u)'s u = L^-T m and W = L^-T diag(1 - s^2) L^-1."""
    return (chol_inv.T @ var_mean,
            chol_inv.T @ (chol_inv * (1.0 - s2)[:, None]))


class _VariationalLayer(nn.Module):
    """One whitened mean-field variational GP layer: a scalar GP
    (``output_dims=None``) or h independent GPs over the same inputs
    (``output_dims=h``), whose marginals come back on a trailing h axis
    with the KLs summed.

    ``ls_init``: initial lengthscale; 0.0 = reference init (raw zeros,
    ~0.693), < 0 = sqrt(2 d), > 0 = that value.
    """

    def __init__(self, input_dims: int, output_dims: Optional[int] = None,
                 num_inducing: int = 256, use_pallas: bool = False,
                 use_fused: bool = False, ls_init: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        d, m = input_dims, num_inducing
        self.input_dims, self.num_inducing = d, m
        self.output_dims = output_dims
        self.use_pallas, self.use_fused = use_pallas, use_fused
        self.compute_dtype = compute_dtype
        batch = (output_dims,) if output_dims else ()

        def param(*shape):
            return nn.Parameter(torch.zeros(batch + shape, device=device))

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
        h = self.output_dims
        lengthscale = softplus(self.raw_lengthscale)  # ([h,] d)
        outputscale = softplus(self.raw_outputscale)  # ([h])
        z = self.inducing_points  # ([h,] m, d)
        if h:  # one GP per leading index: (h, 1, d) and (h, 1, 1)
            kzz = rbf_ard(z, z, lengthscale[:, None],
                          outputscale[:, None, None])
        else:
            kzz = rbf_ard(z, z, lengthscale, outputscale)
        chol_inv = seedwise(_inverse_factor, kzz)  # one a seed under vmap
        var_mean = self.variational_mean
        log_std = self.variational_log_stddev
        s2 = torch.exp(2.0 * log_std)
        kl = 0.5 * torch.sum(s2 + var_mean * var_mean - 1.0 - 2.0 * log_std)

        if self.use_fused and not h:
            u, w_mat = seedwise(_whitened_products, chol_inv, var_mean, s2)
            xr = x[None] if x.dim() == 2 else x
            # the bf16 kernel only for an explicit 16-bit compute dtype
            use_bf16 = (self.compute_dtype is not None
                        and self.compute_dtype.itemsize == 2)
            marginals = (fused_gp.whitened_marginals_affine_bf16 if use_bf16
                         else fused_gp.whitened_marginals_affine)
            mean, var = marginals(
                xr.contiguous(), (z / lengthscale).contiguous(),
                u.contiguous(), w_mat.contiguous(), outputscale,
                (1.0 / lengthscale).contiguous(), self.mean_weight,
                self.mean_bias)
            if x.dim() == 2:
                mean, var = mean[0], var[0]
            return mean, torch.clamp(var, min=1e-8), kl

        dt = self.compute_dtype
        # the GP axis leads every batched product, (h, ..., N, ...), and the
        # per-GP constants are viewed against it
        lead, ones = ("h", (1,) * (x.dim() - 1)) if h else ("", ())
        if self.use_pallas:  # fp32 whatever the compute dtype, as in JAX
            kzx = rbf.rbf_cross_kernel(x.contiguous(), z, lengthscale,
                                       outputscale)
        elif h:
            kzx = rbf_ard(x, z.view(h, *ones[1:], m, -1),
                          lengthscale.view(h, *ones, -1),
                          outputscale.view(h, *ones, 1), dt)
        else:
            kzx = rbf_ard(x, z, lengthscale, outputscale, dt)  # (..., N, M)
        if dt is not None:  # rounded inputs, exact products, fp32 sums
            chol_inv, kzx = chol_inv.to(dt).float(), kzx.to(dt).float()
        a = torch.einsum(f"{lead}mk,{lead}...nk->{lead}...nm", chol_inv, kzx)
        mean_b, s = self.mean_bias, torch.exp(log_std)
        if h:
            mean_b = mean_b.view(h, *ones)
            outputscale = outputscale.view(h, *ones)
            s = s.view(h, *ones, m)
        mean_x = torch.einsum(f"...nd,{lead}d->{lead}...n", x,
                              self.mean_weight) + mean_b
        mean = mean_x + torch.einsum(f"{lead}...nm,{lead}m->{lead}...n", a,
                                     var_mean)
        var = (outputscale - torch.sum(a * a, dim=-1)
               + torch.sum((a * s) ** 2, dim=-1))
        var = torch.clamp(var, min=1e-8)
        if h:  # marginals stacked on a trailing axis: (..., N, h)
            mean, var = mean.movedim(0, -1), var.movedim(0, -1)
        return mean, var, kl


def draw_eps(shape, generator: Optional[torch.Generator],
             like: torch.Tensor) -> torch.Tensor:
    """The N(0, 1) draws of one hidden layer's reparameterized sample, from
    ``generator`` (on ``like``'s device), or zeros without one."""
    if generator is None:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return draws.randn(shape, generator, dtype=like.dtype,
                       device=like.device)


class DeepGP(nn.Module):
    """Deep GP with linear mean + Gaussian likelihood: the reference's
    shipped single layer (``hidden_dims=()``), or hidden layers of
    ``hidden_dims[i]`` GPs each before it, KL terms summed across layers."""

    def __init__(self, input_dims: int, num_inducing: int = 256,
                 use_pallas: bool = False, use_fused: bool = False,
                 hidden_dims: Tuple[int, ...] = (),
                 compute_dtype: Optional[torch.dtype] = None,
                 ls_init: float = 0.0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.raw_noise = nn.Parameter(torch.zeros((), device=device))
        kw = dict(num_inducing=num_inducing, use_pallas=use_pallas,
                  use_fused=use_fused, ls_init=ls_init,
                  compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.hidden_dims = tuple(hidden_dims)
        in_dims = input_dims
        for i, width in enumerate(self.hidden_dims):
            self.add_module(f"hidden_layer{i}",
                            _VariationalLayer(in_dims, width, **kw))
            in_dims = width
        self.output_layer = _VariationalLayer(in_dims, None, **kw)

    def forward(self, x: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> GPPosterior:
        """x: (..., N, d) -> marginal q(f) over the N points.  ``eps``: one
        (..., N, hidden_dims[i]) N(0, 1) draw per hidden layer; else drawn
        from ``generator``; else 0."""
        total_kl = torch.zeros((), device=x.device)
        for i in range(len(self.hidden_dims)):
            mean, var, kl = getattr(self, f"hidden_layer{i}")(x)
            total_kl = total_kl + kl
            e = eps[i] if eps is not None else draw_eps(mean.shape,
                                                        generator, mean)
            x = mean + torch.sqrt(var) * e
        mean, var, kl = self.output_layer(x)
        noise = softplus(self.raw_noise) + _NOISE_FLOOR
        return GPPosterior(mean=mean, var=var, kl=total_kl + kl, noise=noise)


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
