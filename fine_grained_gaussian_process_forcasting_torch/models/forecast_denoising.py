"""Forecast -> GP-blur -> denoise composite (the flagship model).

Counterpart of the JAX package's ``models/forecast_denoising.py``, both
backbones (the transformer, and the LSTM of ``backbone="lstm"``, which
``compute_dtype`` does not reach, as in JAX):

- joint loss = MSE(y, final) + clip(lambda, 0, lam_clip_max) * (-ELBO);
- the denoiser is the forecaster itself (shared weights, called twice);
- one deep GP over the concatenated enc+dec hidden states adds its
  posterior mean, projected 1 -> d_model, to the streams ``gp_inject``
  names; the ELBO uses the decoder-stream marginals.  Its hidden layers
  (``gp_hidden_dims``) draw their eps from the model's generator, or take
  injected draws (``gp_eps``), or use 0 without either;
- every draw of a forward (those eps, the isotropic noise, informer's key
  samples) is taken through ``noise_draws`` first, in one order, so that a
  caller may draw them ahead and pass them in;
- ``gp_kind="exact"``: an exact GP smooths each stream in place and its
  exact marginal log likelihood on the decoder states replaces the ELBO;
- isotropic mode adds 0.05 * N(0, 1) noise in train and eval; the draws come
  from an explicit generator or are passed in;
- the residual branch re-runs the forecaster on its own outputs;
- ``compute_dtype`` (e.g. bfloat16) is the forecaster's and
  ``gp_compute_dtype`` the GP's two heavy products'; the embeddings, the
  projections, the GP's input (the forecaster hands back fp32), the ELBO and
  the loss stay fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch import draws
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp
from fine_grained_gaussian_process_forcasting_torch.gp.deep_gp import (
    DeepGP,
    GPPosterior,
    variational_elbo,
)
from fine_grained_gaussian_process_forcasting_torch.gp.exact_blur import (
    ExactGPBlur,
)
from fine_grained_gaussian_process_forcasting_torch.models.lstm import (
    LSTMBackbone,
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
                 gp_ls_init: float = 0.0, exact_noise_init: float = 0.0,
                 lam_clip_max: float = 0.005, gp_inject: str = "joint", *,
                 device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gp_inject not in ("joint", "enc", "dec", "none"):
            raise ValueError(f"unknown gp_inject {gp_inject!r}")
        if lam_clip_max < 0.0:
            raise ValueError(
                f"lam_clip_max must be >= 0 (got {lam_clip_max}); a clip "
                "with max < min would flip the ELBO weight's sign")
        if backbone not in ("transformer", "lstm"):
            raise ValueError(f"unknown backbone {backbone!r}")
        if gp_kind not in ("variational", "exact"):
            raise ValueError(f"unknown gp_kind {gp_kind!r}")
        if gp_inject != "joint" and gp_kind == "exact":
            raise ValueError(
                "gp_inject applies to the variational path only; the exact "
                "blur smooths each stream in place")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.d_model, self.pred_len = d_model, pred_len
        self.gp, self.denoise, self.no_noise = gp, denoise, no_noise
        self.residual, self.input_corrupt = residual, input_corrupt
        self.lam_clip_max, self.gp_inject = lam_clip_max, gp_inject
        self.gp_kind = gp_kind

        kw = dict(device=device, generator=generator)
        if backbone == "lstm":  # compute_dtype does not reach it, as in JAX
            self.forecasting_model = LSTMBackbone(d_model, stack_size, **kw)
        else:
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
            if gp_kind == "exact":  # the library's factorization, as in JAX
                self.deep_gp = ExactGPBlur(d_model, ls_init=gp_ls_init,
                                           noise_init=exact_noise_init, **kw)
            else:
                self.deep_gp = DeepGP(
                    input_dims=d_model, num_inducing=num_inducing,
                    use_pallas=use_pallas_gp, use_fused=use_fused_gp,
                    hidden_dims=tuple(gp_hidden_dims),
                    compute_dtype=gp_compute_dtype, ls_init=gp_ls_init, **kw)
            self.proj_up = dense(1, d_model, bias=True, **kw)
        self.lam = nn.Parameter(torch.zeros(1, device=device))
        normal_(self.lam, 1.0, generator)

    def noise_draws(self, batch: int, enc_len: int, dec_len: int,
                    training: bool, generator: Optional[torch.Generator],
                    device, skip: Sequence[str] = ()) -> dict:
        """The draws one forward takes from ``generator``, in the order and
        at the shapes it takes them, keyed as the forward's arguments:
        ``index_samples`` (informer's key samples, one per ProbSparse call:
        the forecaster's, then the denoiser's and the residual branch's),
        ``noise`` (the isotropic mode's N(0, 1) encoder and decoder draws)
        or ``gp_eps`` (one N(0, 1) draw per hidden GP layer; zeros without
        a generator); {} where the forward draws nothing.  Drawn in forward
        order: the forecaster's key samples, the noise or eps, the other
        passes' key samples.  The keys in ``skip`` (draws the caller holds)
        are not drawn.  The forward draws through it, so a caller that
        draws ahead (a seed's own generator, ``train/multiseed.py``) and
        passes the draws in gets the same function."""
        key_samples = getattr(self.forecasting_model, "key_samples", None)

        def samples():
            if key_samples is None or "index_samples" in skip:
                return []
            return key_samples(enc_len, dec_len, generator, device)

        out, drawn = {}, samples()
        if self.denoise or (self.input_corrupt and training):
            out = self._denoise_draws(batch, enc_len, dec_len, generator,
                                      device, skip)
            drawn += samples()
            if self.residual:
                drawn += samples()
        if drawn:
            out["index_samples"] = drawn
        return out

    def _denoise_draws(self, batch, enc_len, dec_len, generator, device,
                       skip) -> dict:
        """The denoising step's ``noise`` or ``gp_eps``, as ``noise_draws``
        keys them."""
        like = torch.empty((), device=device)
        if self.gp:
            hidden = (() if self.gp_kind == "exact"
                      else self.deep_gp.hidden_dims)
            if not hidden or "gp_eps" in skip:
                return {}
            # through the module, where a caller may wrap it
            return {"gp_eps": [deep_gp.draw_eps((batch, enc_len + dec_len, h),
                                                generator, like)
                               for h in hidden]}
        if self.no_noise or "noise" in skip:
            return {}
        if generator is None:
            raise ValueError(
                "isotropic mode needs a generator or noise draws")
        return {"noise": tuple(
            draws.randn((batch, length, self.d_model), generator,
                        device=device)
            for length in (enc_len, dec_len))}

    def _denoise(self, enc_hidden, dec_hidden, training: bool, noise,
                 keys, gp_eps
                 ) -> Tuple[torch.Tensor, Optional[GPPosterior]]:
        posterior = None
        if self.gp and self.gp_kind == "exact":  # each stream in place
            enc_noisy, dec_noisy = (
                t + self.proj_up(self.deep_gp.smooth(t)[..., None])
                for t in (enc_hidden, dec_hidden))
        elif self.gp:
            # one GP evaluation over the concatenated enc+dec points
            s_enc = enc_hidden.shape[1]
            joint = torch.cat([enc_hidden, dec_hidden], dim=1)
            post = self.deep_gp(joint, gp_eps)  # over (b, s)
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
            enc_noisy = enc_hidden + 0.05 * noise[0]
            dec_noisy = dec_hidden + 0.05 * noise[1]
        # the denoising network IS the forecaster (shared parameters)
        _, dec_rec = self.forecasting_model(enc_noisy, dec_noisy,
                                            training=training,
                                            generator=keys)
        return dec_hidden + dec_rec, posterior

    def forward(self, enc_inputs: torch.Tensor, dec_inputs: torch.Tensor,
                y_true: Optional[torch.Tensor] = None, training: bool = False,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                gp_eps: Optional[Sequence[torch.Tensor]] = None,
                index_samples: Optional[Sequence[torch.Tensor]] = None
                ) -> ForecastOutput:
        """``noise``: the isotropic mode's N(0, 1) draws for the encoder and
        decoder hidden states; ``gp_eps``: the deep GP's N(0, 1) draws, one
        (b, enc_len + dec_len, gp_hidden_dims[i]) per hidden layer;
        ``index_samples``: informer's key samples, one per ProbSparse call
        in forward order; else each is drawn from ``generator`` (a generator
        on the inputs' device, or a ``draws.DrawTape`` that records or
        replays the draws; informer's from a fixed seed-0 generator without
        one), through ``noise_draws``."""
        dev = enc_inputs.device
        given = [k for k, v in (("noise", noise), ("gp_eps", gp_eps),
                                ("index_samples", index_samples))
                 if v is not None]
        drawn = self.noise_draws(enc_inputs.shape[0], enc_inputs.shape[1],
                                 dec_inputs.shape[1], training, generator,
                                 dev, skip=given)
        noise = drawn.get("noise", noise)
        gp_eps = drawn.get("gp_eps", gp_eps)
        index_samples = drawn.get("index_samples", index_samples)
        # the forecaster's passes take the key samples in order
        keys = (draws.DrawTape(draws=index_samples) if index_samples
                else generator)
        mll_error = torch.zeros((), device=dev)
        enc = self.enc_embedding(enc_inputs)
        dec = self.dec_embedding(dec_inputs)
        enc_out, dec_out = self.forecasting_model(enc, dec, training=training,
                                                  generator=keys)
        forecast = self.final_projection(dec_out[:, -self.pred_len:, :])

        if self.denoise or (self.input_corrupt and training):
            de_out, posterior = self._denoise(enc_out, dec_out, training,
                                              noise, keys, gp_eps)
            final = self.final_projection(de_out[:, -self.pred_len:, :])
            # lam_clip_max == 0 drops the term: skipped, so that a
            # non-finite likelihood cannot reach the loss as 0 * inf
            if (self.gp and training and y_true is not None
                    and self.lam_clip_max > 0.0):
                target = y_true[..., 0]  # (b, pred_len)
                n = target.shape[-1]
                if self.gp_kind == "exact":
                    mll_error = -self.deep_gp.mll(dec_out[:, -n:], target)
                elif posterior is not None:
                    sliced = GPPosterior(
                        mean=posterior.mean[..., -n:],
                        var=posterior.var[..., -n:], kl=posterior.kl,
                        noise=posterior.noise)
                    mll_error = -variational_elbo(target, sliced,
                                                  num_data=self.d_model)
            if self.residual:
                _, dec_res = self.forecasting_model(enc_out, dec_out,
                                                    training=training,
                                                    generator=keys)
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
