"""Forecast -> GP-blur -> denoise composite (the flagship model).

Counterpart of the JAX package's ``models/forecast_denoising.py`` for the
transformer backbone and the variational GP:

- joint loss = MSE(y, final) + clip(lambda, 0, lam_clip_max) * (-ELBO);
- the denoiser is the forecaster itself (shared weights, called twice);
- one deep GP over the concatenated enc+dec hidden states adds its
  posterior mean, projected 1 -> d_model, to the streams ``gp_inject``
  names; the ELBO uses the decoder-stream marginals;
- isotropic mode adds 0.05 * N(0, 1) noise in train and eval; the draws come
  from an explicit generator or are passed in;
- the residual branch re-runs the forecaster on its own outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp.deep_gp import (
    DeepGP,
    GPPosterior,
    variational_elbo,
)
from fine_grained_gaussian_process_forcasting_torch.models.transformer import (
    Transformer,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense, normal_


class ForecastOutput(NamedTuple):
    predictions: torch.Tensor  # (b, pred_len, 1)
    loss: torch.Tensor  # scalar joint loss (0 if y_true is None)
    mse: torch.Tensor  # scalar MSE


class ForecastDenoising(nn.Module):
    """The composite model; arguments mirror the JAX module's fields."""

    def __init__(self, src_input_size: int, tgt_input_size: int,
                 d_model: int, n_heads: int, d_k: int, stack_size: int,
                 pred_len: int, attn_type: str = "basic",
                 backbone: str = "transformer", gp: bool = True,
                 denoise: bool = True, no_noise: bool = False,
                 residual: bool = False, input_corrupt: bool = False,
                 num_inducing: int = 512, gp_hidden_dims: Tuple[int, ...] = (),
                 gp_kind: str = "variational", use_pallas_gp: bool = False,
                 use_fused_gp: bool = True,
                 use_pallas_attention: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 gp_compute_dtype: Optional[torch.dtype] = None,
                 gp_ls_init: float = 0.0, lam_clip_max: float = 0.005,
                 gp_inject: str = "joint", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gp_inject not in ("joint", "enc", "dec", "none"):
            raise ValueError(f"unknown gp_inject {gp_inject!r}")
        if lam_clip_max < 0.0:
            raise ValueError(
                f"lam_clip_max must be >= 0 (got {lam_clip_max}); a clip "
                "with max < min would flip the ELBO weight's sign")
        if backbone == "lstm":
            raise NotImplementedError(
                "backbone='lstm' is not ported yet (ROADMAP.md modules to "
                "port, item 11)")
        if backbone != "transformer":
            raise ValueError(f"unknown backbone {backbone!r}")
        if gp_kind == "exact":
            raise NotImplementedError(
                "gp_kind='exact' is not ported yet (ROADMAP.md modules to "
                "port, item 10)")
        if gp_kind != "variational":
            raise ValueError(f"unknown gp_kind {gp_kind!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_model, self.pred_len = d_model, pred_len
        self.gp, self.denoise, self.no_noise = gp, denoise, no_noise
        self.residual, self.input_corrupt = residual, input_corrupt
        self.lam_clip_max, self.gp_inject = lam_clip_max, gp_inject

        kw = dict(device=device, generator=generator)
        self.forecasting_model = Transformer(
            d_model=d_model, d_ff=4 * d_model, d_k=d_k, d_v=d_k,
            n_heads=n_heads, n_layers=stack_size, attn_type=attn_type,
            compute_dtype=compute_dtype,
            use_pallas_attention=use_pallas_attention, **kw)
        self.enc_embedding = dense(src_input_size, d_model, bias=True, **kw)
        self.dec_embedding = dense(tgt_input_size, d_model, bias=True, **kw)
        self.final_projection = dense(d_model, 1, bias=True, **kw)
        if gp and (denoise or input_corrupt):
            # only then does the Flax module call (and so create) them
            self.deep_gp = DeepGP(
                input_dims=d_model, num_inducing=num_inducing,
                use_pallas=use_pallas_gp, use_fused=use_fused_gp,
                hidden_dims=tuple(gp_hidden_dims),
                compute_dtype=gp_compute_dtype, ls_init=gp_ls_init, **kw)
            self.proj_up = dense(1, d_model, bias=True, **kw)
        self.lam = nn.Parameter(torch.zeros(1, device=device))
        normal_(self.lam, 1.0, generator)

    def _denoise(self, enc_hidden, dec_hidden, training: bool, noise,
                 generator) -> Tuple[torch.Tensor, Optional[GPPosterior]]:
        posterior = None
        if self.gp:
            # one GP evaluation over the concatenated enc+dec points
            s_enc = enc_hidden.shape[1]
            joint = torch.cat([enc_hidden, dec_hidden], dim=1)
            post = self.deep_gp(joint)  # marginals over (b, s)
            eps = self.proj_up(post.mean[..., None])  # (b, s, d)
            enc_noisy = (enc_hidden + eps[:, :s_enc]
                         if self.gp_inject in ("joint", "enc") else enc_hidden)
            dec_noisy = (dec_hidden + eps[:, s_enc:]
                         if self.gp_inject in ("joint", "dec") else dec_hidden)
            posterior = GPPosterior(mean=post.mean[..., s_enc:],
                                    var=post.var[..., s_enc:], kl=post.kl,
                                    noise=post.noise)
        elif self.no_noise:
            enc_noisy, dec_noisy = enc_hidden, dec_hidden
        else:  # isotropic corruption, active in train and eval
            if noise is None:
                if generator is None:
                    raise ValueError(
                        "isotropic mode needs a generator or noise draws")
                noise = tuple(
                    torch.randn(t.shape, generator=generator,
                                device=t.device, dtype=t.dtype)
                    for t in (enc_hidden, dec_hidden))
            enc_noisy = enc_hidden + 0.05 * noise[0]
            dec_noisy = dec_hidden + 0.05 * noise[1]
        # the denoising network IS the forecaster (shared parameters)
        _, dec_rec = self.forecasting_model(enc_noisy, dec_noisy,
                                            training=training)
        return dec_hidden + dec_rec, posterior

    def forward(self, enc_inputs: torch.Tensor, dec_inputs: torch.Tensor,
                y_true: Optional[torch.Tensor] = None, training: bool = False,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> ForecastOutput:
        """``noise``: the isotropic mode's N(0, 1) draws for the encoder and
        decoder hidden states; else they are drawn from ``generator`` (a
        generator on the inputs' device)."""
        dev = enc_inputs.device
        mll_error = torch.zeros((), device=dev)
        enc = self.enc_embedding(enc_inputs)
        dec = self.dec_embedding(dec_inputs)
        enc_out, dec_out = self.forecasting_model(enc, dec, training=training)
        forecast = self.final_projection(dec_out[:, -self.pred_len:, :])

        if self.denoise or (self.input_corrupt and training):
            de_out, posterior = self._denoise(enc_out, dec_out, training,
                                              noise, generator)
            final = self.final_projection(de_out[:, -self.pred_len:, :])
            if (self.gp and training and y_true is not None
                    and self.lam_clip_max > 0.0 and posterior is not None):
                target = y_true[..., 0]  # (b, pred_len)
                n = target.shape[-1]
                sliced = GPPosterior(mean=posterior.mean[..., -n:],
                                     var=posterior.var[..., -n:],
                                     kl=posterior.kl, noise=posterior.noise)
                mll_error = -variational_elbo(target, sliced,
                                              num_data=self.d_model)
            if self.residual:
                _, dec_res = self.forecasting_model(enc_out, dec_out,
                                                    training=training)
                res = self.final_projection(dec_res[:, -self.pred_len:, :])
                final = forecast + res
        else:
            final = forecast

        loss = torch.zeros((), device=dev)
        mse = torch.zeros((), device=dev)
        if y_true is not None:
            mse = torch.mean((y_true - final) ** 2)
            lam = torch.clamp(self.lam[0], 0.0, self.lam_clip_max)
            loss = mse + lam * mll_error
        return ForecastOutput(predictions=final, loss=loss, mse=mse)
