"""AutoCorrelation (Autoformer): FFT period discovery + time-delay aggregation.

Counterpart of the JAX package's ``ops/autocorrelation.py``, in plain
PyTorch (the JAX version has no Pallas kernel).  The JAX package computes
its transforms as DFT-by-GEMM, a choice made for the TPU's matrix unit; here
they are ``torch.fft.rfft``/``irfft``, which give the same circular
correlation.  Layout: (batch, heads, length, d) in and out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _delay_aggregate(values: torch.Tensor, delays: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of left-rolls: out[..., t] = sum_i w_i v[..., (t+d_i)%L].

    values: (b, h, d, L); delays: (k,) shared or (b, k) per-sample;
    weights: (b, k).
    """
    b, h, d, L = values.shape
    if delays.dim() == 1:
        delays = delays.expand(b, -1)
    t = torch.arange(L, device=values.device)
    index = (t[None, None, :] + delays[:, :, None]) % L  # (b, k, L)
    out = torch.zeros_like(values)
    for i in range(delays.shape[1]):
        idx = index[:, i][:, None, None, :].expand(b, h, d, L)
        out = out + weights[:, i, None, None, None] * torch.gather(
            values, -1, idx)
    return out


def auto_correlation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     factor: int = 1, training: bool = True,
                     delays: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AutoCorrelation attention over (b, h, l, d) operands.

    training=True  -> delays shared across the batch (top-k of the
                      batch-mean correlation)
    training=False -> per-sample delays

    ``delays`` ((top_k,) in training, (b, top_k) in eval) replaces the
    top-k choice, the weights still coming from this call's correlation:
    it replays another run's delays, so that two devices that break a
    near-tie differently still compute the same function.

    Returns (context (b, h, L, d), mean correlation over heads/channels
    (b, L)).
    """
    b, h, L, d = q.shape
    S = k.shape[2]
    if L > S:
        pad = torch.zeros((b, h, L - S, d), dtype=q.dtype, device=q.device)
        k = torch.cat([k, pad], dim=2)
        v = torch.cat([v, pad], dim=2)
    else:
        k = k[:, :, :L]
        v = v[:, :, :L]

    # (b, h, d, L): time last for the transforms
    qt = q.transpose(2, 3)
    kt = k.transpose(2, 3)
    vt = v.transpose(2, 3)
    # only the (head, channel) mean of the correlation is consumed, and the
    # mean commutes with the inverse transform: average the spectra first
    qf = torch.fft.rfft(qt, dim=-1)
    kf = torch.fft.rfft(kt, dim=-1)
    spec = (qf * torch.conj(kf)).mean(dim=(1, 2))  # (b, F)
    mean_value = torch.fft.irfft(spec, n=L, dim=-1)  # (b, L)

    top_k = int(factor * math.log(L))
    if training:
        index = (torch.topk(mean_value.mean(dim=0), top_k).indices  # (k,)
                 if delays is None else delays)
        weights = mean_value[:, index]
        agg = _delay_aggregate(vt, index, torch.softmax(weights, dim=-1))
    else:
        if delays is None:
            weights, delay = torch.topk(mean_value, top_k, dim=-1)  # (b, k)
        else:
            delay = delays
            weights = torch.gather(mean_value, -1, delay)
        agg = _delay_aggregate(vt, delay, torch.softmax(weights, dim=-1))
    return agg.transpose(2, 3), mean_value
