"""The system under test: the port's model, trainers and session, built from
a configuration's ``model`` and ``optimizer`` groups.  Nothing else of the
port is imported by the benchmark."""

from __future__ import annotations

import math

import torch

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def model(cfg: dict, device):
    """The port's ``ForecastDenoising`` of the configuration (its own
    initial weights, which the benchmark's replace)."""
    from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
        ForecastDenoising,
    )

    m = cfg["model"]
    if m["d_ff"] != 4 * m["d_model"]:
        raise ValueError("the port's feed-forward width is 4 d_model")
    return ForecastDenoising(
        src_input_size=m["src_input_size"],
        tgt_input_size=m["tgt_input_size"], d_model=m["d_model"],
        n_heads=m["n_heads"], d_k=m["d_k"], stack_size=m["stack_size"],
        pred_len=m["pred_len"], attn_type=m["attn_type"], gp=True,
        denoise=True, num_inducing=m["num_inducing"],
        compute_dtype=_DTYPES[m["compute_dtype"]],
        gp_compute_dtype=_DTYPES[m["gp_compute_dtype"]],
        gp_ls_init=m["gp_ls_init"], lam_clip_max=m["lam_clip_max"],
        device=device, generator=torch.Generator().manual_seed(0))


def trainer(cfg: dict, net, n_seeds: int, device):
    """``Trainer`` for one seed, ``MultiSeedTrainer`` for more."""
    from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
        MultiSeedTrainer,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
        Trainer,
    )

    o = cfg["optimizer"]
    kw = dict(warmup_steps=o["warmup_steps"], lr_mul=o["lr_mul"],
              clip_grad_norm=o["clip_grad_norm"],
              nonfinite_guard=o["nonfinite_guard"], device=device)
    d = cfg["model"]["d_model"]
    if n_seeds == 1:
        return Trainer(net, d, **kw)
    return MultiSeedTrainer(net, d, n_seeds, **kw)


def session(net, weights: dict, batch: int, device, quantize=None):
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    return InferenceSession(net, weights, batch_size=batch, device=device,
                            quantize=quantize)


class DelayRecorder:
    """Wraps ``auto_correlation`` in the port's transformer module and keeps
    the lags each call chose, as the call itself takes them: (1, k), the
    top-k of the batch's mean correlation, in training; (b, k) in
    evaluation.  Under ``MultiSeedTrainer``'s ``torch.func.vmap`` a call's
    lags carry the seed axis first: (S, 1, k)."""

    def __enter__(self):
        from fine_grained_gaussian_process_forcasting_torch.models import (
            transformer,
        )

        self.module, self.original = transformer, transformer.auto_correlation
        self.delays = []

        def recording(q, k, v, factor=1, training=True, **kw):
            ctx, mean_value = self.original(q, k, v, factor=factor,
                                            training=training, **kw)
            top_k = int(factor * math.log(q.shape[2]))
            scores = mean_value.mean(0, keepdim=True) if training \
                else mean_value
            self.delays.append(_unbatched(
                torch.topk(scores, top_k, dim=-1).indices).cpu())
            return ctx, mean_value

        transformer.auto_correlation = recording
        return self

    def __exit__(self, *exc):
        self.module.auto_correlation = self.original


def _unbatched(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor: inside ``torch.func.vmap``, the values of
    every vmapped row, that axis first (functorch's own unwrapping; a
    tensor kept from inside vmap is unusable after it)."""
    from torch._C import _functorch as ft

    while ft.is_batchedtensor(t):
        axis = ft.maybe_get_bdim(t)
        t = ft.get_unwrapped(t).movedim(axis, 0)
    return t
