"""Input embeddings for the FEDformer family.

Counterpart of the JAX package's ``models/embedding.py`` (no Pallas kernel):
a circular k=3 convolution of the values, the sinusoidal positional table,
fixed (sinusoid) or learned calendar embeddings, a linear embedding of
real-valued time features, and the two composed ``DataEmbedding`` variants.
Module attributes carry the Flax names (``value_embedding.token_conv``,
``temporal_embedding.embed``, ``month_embed.embedding``), so
``params.from_flax`` maps JAX's parameters onto them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.params import (
    Embed,
    dense,
    lecun_normal_,
)

# Flax's kaiming_normal: lecun_normal's truncated normal at twice the
# variance
_KAIMING_GAIN = 2.0 ** 0.5


def sinusoid_table(n: int, d_model: int) -> np.ndarray:
    """(n, d_model) log-space sinusoid table."""
    pe = np.zeros((n, d_model), dtype=np.float32)
    position = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: d_model // 2])
    return pe


class CircularConv1d(nn.Module):
    """Flax ``Conv(out, (f,), padding="VALID")`` over (b, l, c) after the
    time axis is padded circularly by ``pad`` rows each side: ``weight``
    (out, in, f), as ``params.from_flax`` lays out Flax's (f, in, out)
    kernel; lecun-normal over fan-in in * f (times ``gain``)."""

    def __init__(self, c_in: int, c_out: int, pad: int, bias: bool,
                 filter_length: int = 3, gain: float = 1.0, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.pad = pad
        self.weight = nn.Parameter(torch.empty(c_out, c_in, filter_length,
                                               device=device))
        lecun_normal_(self.weight.data.view(c_out, c_in * filter_length),
                      generator)
        if gain != 1.0:
            self.weight.data.mul_(gain)
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device))
                     if bias else None)

    def forward(self, x):
        p = self.pad
        xp = torch.cat([x[:, -p:], x, x[:, :p]], dim=1).transpose(1, 2)
        conv = _FixedOrderConv1d.apply if xp.is_cuda else F.conv1d
        return conv(xp, self.weight, self.bias).transpose(1, 2)


class _FixedOrderConv1d(torch.autograd.Function):
    """``F.conv1d(x, weight, bias)`` (no padding, stride 1) whose backward
    is two GEMMs and a fixed-order sum over the taps, so that two backwards
    of one step are bit-equal.  cuDNN's default backward algorithms add
    with atomics and differ run to run; only this call site is changed, no
    process-wide switch is set."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return F.conv1d(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors  # x (b, in, l), g (b, out, l - f + 1)
        f, l_out = weight.shape[-1], g.shape[-1]
        gx = gw = gb = None
        if ctx.needs_input_grad[1]:
            gw = torch.einsum("bol,bilt->oit", g, x.unfold(2, f, 1))
        if ctx.needs_input_grad[0]:
            taps = torch.einsum("bol,oit->tbil", g, weight)
            gx = x.new_zeros(x.shape)
            for t in range(f):
                gx[..., t:t + l_out] += taps[t]
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2))
        return gx, gw, gb


class TokenEmbedding(nn.Module):
    """Circular k=3 convolution of the values, no bias (``token_conv``)."""

    def __init__(self, c_in: int, d_model: int, *, device, generator):
        super().__init__()
        self.token_conv = CircularConv1d(c_in, d_model, 1, bias=False,
                                         gain=_KAIMING_GAIN, device=device,
                                         generator=generator)

    def forward(self, x):
        return self.token_conv(x)


class PositionalEmbedding(nn.Module):
    """The first l rows of the sinusoid table, (1, l, d_model)."""

    def __init__(self, d_model: int, max_len: int = 5000, *, device):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(
            sinusoid_table(max_len, d_model)).to(device), persistent=False)

    def forward(self, x):
        return self.table[None, : x.shape[1]]


class FixedEmbedding(nn.Module):
    """A sinusoid lookup table, not trained."""

    def __init__(self, c_in: int, d_model: int, *, device):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(
            sinusoid_table(c_in, d_model)).to(device), persistent=False)

    def forward(self, x):
        return self.table[x.long()]


_CALENDAR = (("month_embed", 13), ("day_embed", 32), ("weekday_embed", 7),
             ("hour_embed", 24), ("minute_embed", 4))


class TemporalEmbedding(nn.Module):
    """Calendar-feature embedding; x_mark columns [month, day, weekday,
    hour(, minute)], each through a fixed table or a learned ``Embed``."""

    def __init__(self, d_model: int, embed_type: str = "fixed",
                 freq: str = "h", *, device, generator):
        super().__init__()
        self.names = [name for name, _ in _CALENDAR[: 5 if freq == "t"
                                                     else 4]]
        for name, c_in in _CALENDAR[: len(self.names)]:
            setattr(self, name, FixedEmbedding(c_in, d_model, device=device)
                    if embed_type == "fixed" else
                    Embed(c_in, d_model, device=device, generator=generator))

    def forward(self, x):
        xi = x.long()
        out = getattr(self, self.names[0])(xi[:, :, 0])
        for col, name in enumerate(self.names[1:], 1):
            out = out + getattr(self, name)(xi[:, :, col])
        return out


# the time features ``freq`` gives (the reference's ``freq_map``): the input
# width of the timeF embedding, which Flax infers from x_mark
FREQ_FEATURES = {"h": 4, "t": 5, "s": 6, "m": 1, "a": 1, "w": 2, "d": 3,
                 "b": 3}


class TimeFeatureEmbedding(nn.Module):
    """Linear embedding of real-valued time features, no bias (``embed``)."""

    def __init__(self, d_model: int, freq: str = "h", *, device, generator):
        super().__init__()
        self.embed = dense(FREQ_FEATURES[freq], d_model, bias=False,
                           device=device, generator=generator)

    def forward(self, x):
        return self.embed(x)


class DataEmbedding(nn.Module):
    """token + temporal (+ positional) embedding of ``c_in`` value
    channels."""

    use_pos = True

    def __init__(self, c_in: int, d_model: int, embed_type: str = "fixed",
                 freq: str = "h", *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.value_embedding = TokenEmbedding(c_in, d_model, **kw)
        self.temporal_embedding = (
            TimeFeatureEmbedding(d_model, freq, **kw)
            if embed_type == "timeF" else
            TemporalEmbedding(d_model, embed_type, freq, **kw))
        if self.use_pos:
            self.position_embedding = PositionalEmbedding(d_model,
                                                          device=device)

    def forward(self, x, x_mark):
        out = self.value_embedding(x) + self.temporal_embedding(x_mark)
        if self.use_pos:
            out = out + self.position_embedding(x)
        return out


class DataEmbeddingWoPos(DataEmbedding):
    """token + temporal only."""

    use_pos = False
