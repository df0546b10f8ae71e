"""FEDformer: the frequency-enhanced decomposed transformer.

Counterpart of the JAX package's ``models/fedformer.py`` (no Pallas kernel):
a seasonal / trend decomposition of the encoder window starts the decoder,
every layer decomposes again after its attention and its feed-forward, and
the trends add up through the decoder.  The inner correlation is the
version's: Fourier blocks (``ops/fourier.py``), multiwavelet blocks
(``ops/wavelet.py``) or AutoCorrelation (``ops/autocorrelation.py``).  The
products are cuBLAS's and the transforms cuFFT's on the card.

Kept from JAX as they stand: the decoder's blocks are sized for
``seq_len // 2 + pred_len`` rows, not ``label_len + pred_len`` (where the two
differ, a Fourier mode past the decoder's spectrum is read clamped and
written nowhere, as JAX does); AutoCorrelation runs in its training form,
the delays shared across the batch, at inference too; the trend goes out
through a circular k=3 convolution without bias.  ``delays=`` (an
``ops.autocorrelation.DelayTape``) records the AutoCorrelation delays of a
forward or replays another run's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.embedding import (
    CircularConv1d,
    DataEmbeddingWoPos,
)
from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (
    DelayTape,
    auto_correlation,
)
from fine_grained_gaussian_process_forcasting_torch.ops.decomposition import (
    MyLayerNorm,
    SeriesDecompMulti,
    series_decomp,
)
from fine_grained_gaussian_process_forcasting_torch.ops.fourier import (
    FourierBlock,
    FourierCrossAttention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.full_attention import (
    full_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.wavelet import (
    MultiWaveletCross,
    MultiWaveletTransform,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense


@dataclasses.dataclass(frozen=True)
class FEDformerConfig:
    """The reference's ``configs`` object, field for field with JAX's."""

    enc_in: int = 7
    dec_in: int = 7
    c_out: int = 7
    seq_len: int = 96
    label_len: int = 48
    pred_len: int = 96
    d_model: int = 16
    n_heads: int = 8
    d_ff: int = 16
    e_layers: int = 2
    d_layers: int = 1
    moving_avg: Union[int, Sequence[int]] = (24,)
    version: str = "Fourier"  # 'Fourier' | 'Wavelets' | 'Autoformer'
    mode_select: str = "random"
    modes: int = 64
    L: int = 3
    base: str = "legendre"
    cross_activation: str = "tanh"
    embed: str = "timeF"
    freq: str = "h"
    activation: str = "gelu"
    output_attention: bool = False
    wavelet_k: int = 8


def _inners(version: str):
    """(self, cross) inner correlation of a version."""
    if version == "Wavelets":
        return "wavelet_self", "wavelet_cross"
    if version == "Fourier":
        return "fourier_self", "fourier_cross"
    return "autocorrelation", "autocorrelation"


class _Decomp(nn.Module):
    """One kernel: ``series_decomp``; several: ``SeriesDecompMulti``
    (Flax's auto-named ``SeriesDecompMulti_0``)."""

    def __init__(self, kernel, *, device, generator):
        super().__init__()
        if not isinstance(kernel, int) and len(kernel) == 1:
            kernel = kernel[0]
        self.kernel = kernel
        if not isinstance(kernel, int):
            self.SeriesDecompMulti_0 = SeriesDecompMulti(
                tuple(kernel), device=device, generator=generator)

    def forward(self, x):
        if isinstance(self.kernel, int):
            return series_decomp(x, self.kernel)
        return self.SeriesDecompMulti_0(x)


class CorrelationLayer(nn.Module):
    """Q / K / V / out projections around an inner correlation op:
    'fourier_self' | 'fourier_cross' | 'wavelet_self' | 'wavelet_cross' |
    'autocorrelation' | 'full'."""

    def __init__(self, inner: str, d_model: int, n_heads: int,
                 config: FEDformerConfig, seq_len_q: int = 0,
                 seq_len_kv: int = 0, *, device, generator):
        super().__init__()
        self.inner, self.n_heads = inner, n_heads
        cfg = config
        kw = dict(device=device, generator=generator)
        for name in ("query_projection", "key_projection",
                     "value_projection"):
            setattr(self, name, dense(d_model, d_model, bias=True, **kw))
        if inner == "fourier_self":
            self.block = FourierBlock(
                d_model, d_model, seq_len_q, cfg.modes, cfg.mode_select,
                n_heads, **kw)
        elif inner == "fourier_cross":
            self.block = FourierCrossAttention(
                d_model, d_model, seq_len_q, seq_len_kv, cfg.modes,
                cfg.mode_select, cfg.cross_activation, n_heads, **kw)
        elif inner == "wavelet_self":
            self.block = MultiWaveletTransform(
                d_model, k=cfg.wavelet_k, L=cfg.L, base=cfg.base, **kw)
        elif inner == "wavelet_cross":
            self.block = MultiWaveletCross(
                d_model, d_model, cfg.modes, ich=d_model, k=cfg.wavelet_k,
                L=cfg.L, base=cfg.base, activation=cfg.cross_activation,
                **kw)
        elif inner not in ("autocorrelation", "full"):
            raise ValueError(f"unknown inner correlation {inner!r}")
        self.out_projection = dense(d_model, d_model, bias=True, **kw)

    def forward(self, queries, keys, values, mask=None,
                delays: Optional[DelayTape] = None):
        B, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        if self.inner == "autocorrelation":
            correlate = auto_correlation if delays is None else delays
            ctx, attn = correlate(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), training=True)
            out = ctx.transpose(1, 2)
        elif self.inner == "full":
            out, attn = full_attention(q, k, v, mask_flag=bool(mask))
        else:
            out, attn = self.block(q, k, v, mask)
        return self.out_projection(out.reshape(B, L, -1)), attn


def _feed_forward(layer, x):
    """conv1 -> gelu (Flax's tanh form) or relu -> conv2."""
    y = layer.conv1(x)
    y = (F.gelu(y, approximate="tanh") if layer.activation == "gelu"
         else F.relu(y))
    return layer.conv2(y)


class FEDEncoderLayer(nn.Module):
    """Progressive-decomposition encoder layer."""

    def __init__(self, config: FEDformerConfig, inner: str, *, device,
                 generator):
        super().__init__()
        cfg = config
        kw = dict(device=device, generator=generator)
        self.activation = cfg.activation
        self.attention = CorrelationLayer(
            inner, cfg.d_model, cfg.n_heads, cfg, cfg.seq_len, cfg.seq_len,
            **kw)
        self.decomp1 = _Decomp(cfg.moving_avg, **kw)
        self.conv1 = dense(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.conv2 = dense(cfg.d_ff, cfg.d_model, bias=False, **kw)
        self.decomp2 = _Decomp(cfg.moving_avg, **kw)

    def forward(self, x, mask=None, delays=None):
        new_x, attn = self.attention(x, x, x, mask, delays)
        x, _ = self.decomp1(x + new_x)
        res, _ = self.decomp2(x + _feed_forward(self, x))
        return res, attn


class FEDDecoderLayer(nn.Module):
    """Progressive-decomposition decoder layer; returns (x, its trend
    through the circular ``projection``)."""

    def __init__(self, config: FEDformerConfig, *, device, generator):
        super().__init__()
        cfg = config
        kw = dict(device=device, generator=generator)
        self.activation = cfg.activation
        dec_q_len = cfg.seq_len // 2 + cfg.pred_len
        self_inner, cross_inner = _inners(cfg.version)
        self.self_attention = CorrelationLayer(
            self_inner, cfg.d_model, cfg.n_heads, cfg, dec_q_len, dec_q_len,
            **kw)
        self.decomp1 = _Decomp(cfg.moving_avg, **kw)
        self.cross_attention = CorrelationLayer(
            cross_inner, cfg.d_model, cfg.n_heads, cfg, dec_q_len,
            cfg.seq_len, **kw)
        self.decomp2 = _Decomp(cfg.moving_avg, **kw)
        self.conv1 = dense(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.conv2 = dense(cfg.d_ff, cfg.d_model, bias=False, **kw)
        self.decomp3 = _Decomp(cfg.moving_avg, **kw)
        self.projection = CircularConv1d(cfg.d_model, cfg.c_out, 1,
                                         bias=False, **kw)

    def forward(self, x, cross, mask=None, delays=None):
        x = x + self.self_attention(x, x, x, mask, delays)[0]
        x, trend1 = self.decomp1(x)
        x = x + self.cross_attention(x, cross, cross, mask, delays)[0]
        x, trend2 = self.decomp2(x)
        x, trend3 = self.decomp3(x + _feed_forward(self, x))
        return x, self.projection(trend1 + trend2 + trend3)


class FEDformer(nn.Module):
    """The whole model: (x_enc, x_mark_enc, x_dec, x_mark_dec) ->
    (b, pred_len, c_out).  ``x_dec`` is not read: the decoder starts from
    the encoder window's decomposition, as in JAX."""

    def __init__(self, config: FEDformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = self.config = config
        kw = dict(device=device, generator=generator)
        self_inner, _ = _inners(cfg.version)
        self.decomp = _Decomp(cfg.moving_avg, **kw)
        self.enc_embedding = DataEmbeddingWoPos(cfg.enc_in, cfg.d_model,
                                                cfg.embed, cfg.freq, **kw)
        for i in range(cfg.e_layers):
            setattr(self, f"enc_layer{i}",
                    FEDEncoderLayer(cfg, self_inner, **kw))
        self.enc_norm = MyLayerNorm(cfg.d_model, device=device)
        self.dec_embedding = DataEmbeddingWoPos(cfg.dec_in, cfg.d_model,
                                                cfg.embed, cfg.freq, **kw)
        for i in range(cfg.d_layers):
            setattr(self, f"dec_layer{i}", FEDDecoderLayer(cfg, **kw))
        self.dec_norm = MyLayerNorm(cfg.d_model, device=device)
        self.projection = dense(cfg.d_model, cfg.c_out, bias=True, **kw)

    def forward(self, x_enc, x_mark_enc, x_dec, x_mark_dec,
                delays: Optional[DelayTape] = None) -> torch.Tensor:
        cfg = self.config
        mean = x_enc.mean(dim=1, keepdim=True).expand(-1, cfg.pred_len, -1)
        seasonal_init, trend_init = self.decomp(x_enc)
        trend = torch.cat([trend_init[:, -cfg.label_len:], mean], dim=1)
        seasonal_init = F.pad(seasonal_init[:, -cfg.label_len:],
                              (0, 0, 0, cfg.pred_len))

        enc_out = self.enc_embedding(x_enc, x_mark_enc)
        for i in range(cfg.e_layers):
            enc_out, _ = getattr(self, f"enc_layer{i}")(enc_out,
                                                       delays=delays)
        enc_out = self.enc_norm(enc_out)

        dec_out = self.dec_embedding(seasonal_init, x_mark_dec)
        for i in range(cfg.d_layers):
            dec_out, residual_trend = getattr(self, f"dec_layer{i}")(
                dec_out, enc_out, delays=delays)
            trend = trend + residual_trend
        dec_out = self.dec_norm(dec_out)
        out = trend + self.projection(dec_out)
        return out[:, -cfg.pred_len:]
