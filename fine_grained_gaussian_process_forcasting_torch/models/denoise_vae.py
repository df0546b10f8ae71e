"""The VAE-style denoiser (kept for parity; no path of the model runs it).

Counterpart of the JAX package's ``models/denoise_vae.py`` (no Pallas
kernel): a convolutional encoder and decoder around a reparameterised
latent, an optional blur of the input by the moments of a GP prior, and a
diagonal-Gaussian KL of the latent against the prior moments of the target.
The GP prior's moments (constant mean, outputscale as variance) are
parameters in closed form, as in JAX.

The two normal draws (the input noise, then the latent's) come from the
``generator`` a forward is given: a ``torch.Generator`` or a
``draws.DrawTape`` that records or replays them (JAX's, in the tests).
Without one they come from a fixed seed-0 generator, where JAX falls back
to ``PRNGKey(0)``: other draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch import draws
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import softplus
from fine_grained_gaussian_process_forcasting_torch.models.losses import (
    normal_kl,
)
from fine_grained_gaussian_process_forcasting_torch.ops.conv_attention import (
    BatchStatsNorm,
    Conv1d,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    LayerNorm,
    dense,
)


def _zero(device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((), device=device))


class _ConvStack(nn.Module):
    """Two SAME k=3 convolutions, ``BatchStatsNorm``, a softmax over time."""

    def __init__(self, d: int, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv1d(d, 3, **kw)
        self.conv2 = Conv1d(d, 3, **kw)
        self.bn = BatchStatsNorm(d, device=device)

    def forward(self, x):
        return torch.softmax(self.bn(self.conv2(self.conv1(x))), dim=1)


class DenoiseVAE(nn.Module):
    """x (b, l, d) -> (output (b, l, d), KL loss).  ``target_prior``: hold
    the target's prior moments (``prior_mean_t``, ``raw_outputscale_t``),
    which a call with a target needs; Flax creates them only when ``init``
    is given a target."""

    def __init__(self, d: int, gp: bool = False, n_noise: bool = False,
                 residual: bool = False, target_prior: bool = True, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d, self.gp, self.n_noise, self.residual = d, gp, n_noise, residual
        kw = dict(device=device, generator=generator)
        if gp:
            self.prior_mean = _zero(device)
            self.raw_outputscale = _zero(device)
            self.gp_proj_mean = dense(1, d, bias=True, **kw)
            self.gp_proj_var = dense(1, d, bias=True, **kw)
        self.encoder = _ConvStack(d, **kw)
        self.musig = dense(d, 2 * d, bias=True, **kw)
        self.decoder = _ConvStack(d, **kw)
        self.norm = LayerNorm(d, device=device)
        if target_prior:
            self.prior_mean_t = _zero(device)
            self.raw_outputscale_t = _zero(device)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None, generator=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.d
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        eps = draws.randn(tuple(x.shape), generator, dtype=x.dtype,
                          device=x.device)
        if self.gp:
            shape = x.shape[:2] + (1,)
            mean = self.prior_mean.expand(shape)
            var = softplus(self.raw_outputscale).expand(shape)
            x_noisy = (x + self.gp_proj_mean(mean)
                       + self.gp_proj_var(var) * eps * 0.1)
        elif self.n_noise:
            x_noisy = x
        elif self.residual and residual is not None:
            x_noisy = residual
        else:
            x_noisy = x + eps * 0.05

        musig = self.musig(self.encoder(x_noisy))
        mu, sigma = musig[..., :d], musig[..., d:]
        z = mu + torch.exp(sigma * 0.5) * draws.randn(
            tuple(sigma.shape), generator, device=x.device)
        output = self.norm(self.decoder(z) + x)

        kl_loss = x.new_zeros(())
        if target is not None:
            s_len = target.shape[1]
            shape = target.shape[:2]
            mean_t = self.prior_mean_t.expand(shape)
            var_t = softplus(self.raw_outputscale_t).expand(shape)
            mu_s = mu[:, -s_len:].mean(-1)
            sig_s = sigma[:, -s_len:].mean(-1)
            kl_loss = normal_kl(mean_t, var_t, mu_s, sig_s).mean()
        return output, kl_loss
