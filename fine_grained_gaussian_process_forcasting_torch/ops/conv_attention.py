"""Convolutional attention ops: ATA, ACAT, ConvAttn.

Counterpart of the JAX package's ``ops/conv_attention.py``, with its two
deliberate departures from the original reference kept: the convolutions
and norms are trained parameters of the layer, and the scales are stacked on
their own axis before the top-1 over scales.

``BatchStatsNorm`` normalises with the current batch's statistics in
training and in eval alike (biased variance over (batch, length), eps 1e-5),
so the ops hold no running state.  A Flax ``Conv(padding="SAME")`` with an
odd filter f pads f // 2 on each side and cross-correlates, as
``torch.nn.functional.conv1d`` does; its (f, in, out) kernel is stored here
as conv1d's (out, in, f) weight (``params.from_flax`` transposes it).  The
convolutions are cuDNN's (plain XLA in JAX, no Pallas), with TF32 off (the
package pins it at import).

The final softmax attention of ATA and ConvAttn takes a kernel of the port
when the layer's flag is set (``conv_attention_route``): the head-folded
kernel at d_k <= 63 and the flash kernel above, on the card; each wrapper's
plain version on the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    matmul16,
    scaled_dot_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.flash_attention import (
    fused_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.head_folded_attention import (
    MAX_HEAD_DIM,
    head_folded_attention,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    lecun_normal_,
)


class BatchStatsNorm(nn.Module):
    """BatchNorm over (batch, length, channels) input that always takes the
    current batch's statistics, with learned ``scale`` and ``bias``."""

    def __init__(self, channels: int, epsilon: float = 1e-5, *, device):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = x.var(dim=(0, 1), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias


class Conv1d(nn.Module):
    """Flax ``Conv(c, (f,), padding="SAME")`` over (batch, length, channels):
    ``weight`` (out, in, f), initialised lecun-normal over fan-in in * f,
    ``bias`` zero (or none)."""

    def __init__(self, channels: int, filter_length: int, bias: bool = True,
                 *, device, generator):
        super().__init__()
        if filter_length % 2 != 1:
            raise ValueError("only odd filter lengths pad symmetrically")
        self.weight = nn.Parameter(torch.empty(
            channels, channels, filter_length, device=device))
        flat = self.weight.data.view(channels, channels * filter_length)
        lecun_normal_(flat, generator)
        self.bias = (nn.Parameter(torch.zeros(channels, device=device))
                     if bias else None)

    def forward(self, x):
        """A 16-bit input is widened to the weight's dtype, as Flax's Conv
        promotes it against its fp32 kernel."""
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     padding=self.weight.shape[-1] // 2)
        return y.transpose(1, 2)


def conv_attention_route(d_k: int, use_kernel: bool) -> str:
    """Which implementation the conv family's final softmax attention takes:
    "head_folded", "flash" or "plain".

    Only the flag takes a kernel, as in JAX, whose ``_dot_attention`` runs
    its head-folded kernel at every d_k: here the head-folded kernel at
    d_k <= 63 and the flash kernel above, which compute the same softmax
    attention.  Without the flag the plain op.  The same on every device: on
    the CPU the named wrapper runs its plain version.
    """
    if not use_kernel:
        return "plain"
    return "head_folded" if d_k <= MAX_HEAD_DIM else "flash"


def _dot_attention(q, k, v, use_kernel: bool):
    """The conv family's final softmax attention, by
    ``conv_attention_route``.  In a 16-bit model q and k come from the fp32
    convolutions and v from the 16-bit projection: the plain op casts the
    probabilities to v's dtype and returns that dtype, and a kernel takes v
    widened to fp32 and returns fp32, as JAX's plain op and its head-folded
    kernel do."""
    route = conv_attention_route(q.shape[-1], use_kernel)
    if route == "plain":
        return scaled_dot_attention(q, k, v)[0]
    v = v.to(q.dtype)
    if route == "flash":
        return fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    # the head-folded kernel reads (b, h, L, d) views in place; only a head
    # dim that is not unit-stride (ConvAttn's convolution outputs) is copied
    return head_folded_attention(*(
        t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v)))


def _merge_heads(x):
    """(b, h, l, d) -> (b, l, h*d) for the channel-mixing convolutions."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _split_heads(x, h: int):
    """(b, l, h*d) -> (b, h, l, d)."""
    b, l, hd = x.shape
    return x.reshape(b, l, h, hd // h).transpose(1, 2)


def relu_scale_max(pre):
    """max over scales of relu(pre), pre (b, l, c, S): ATA's top-1.  A tie
    shares the gradient evenly, as JAX's max does."""
    return F.relu(pre).amax(dim=-1)


class ATAAttention(nn.Module):
    """Multi-scale conv (f in 1, 3, 7, 9) + BatchStatsNorm + ReLU over Q and
    K, the top-1 across scales, then softmax attention."""

    def __init__(self, d_k: int, n_heads: int,
                 filter_lengths: Sequence[int] = (1, 3, 7, 9),
                 use_kernel: bool = False, *, device, generator):
        super().__init__()
        self.n_heads, self.use_kernel = n_heads, use_kernel
        self.filter_lengths = tuple(filter_lengths)
        c = d_k * n_heads
        for name in ("q", "k"):
            for f in self.filter_lengths:
                self.add_module(f"{name}_conv{f}", Conv1d(
                    c, f, device=device, generator=generator))
                self.add_module(f"{name}_bn{f}",
                                BatchStatsNorm(c, device=device))

    def _pyramid(self, x, name):
        pre = [getattr(self, f"{name}_bn{f}")(
            getattr(self, f"{name}_conv{f}")(x)) for f in self.filter_lengths]
        return relu_scale_max(torch.stack(pre, dim=-1))

    def forward(self, q, k, v):
        h = self.n_heads
        q_top = self._pyramid(_merge_heads(q), "q")
        k_top = self._pyramid(_merge_heads(k), "k")
        return _dot_attention(_split_heads(q_top, h), _split_heads(k_top, h),
                              v, self.use_kernel)


class ACATAttention(nn.Module):
    """Conv pyramids (f in 3, 9; no bias) + one shared BatchStatsNorm + ELU;
    per-scale scores on keys subsampled with stride max(f), max over scales,
    scattered into a strided attention map, re-softmaxed over the full key
    length (untouched positions carry e^0 mass)."""

    def __init__(self, d_k: int, n_heads: int,
                 filter_lengths: Sequence[int] = (3, 9), *, device,
                 generator):
        super().__init__()
        self.d_k, self.n_heads = d_k, n_heads
        self.filter_lengths = tuple(filter_lengths)
        c = d_k * n_heads
        self.shared_bn = BatchStatsNorm(c, device=device)
        for name in ("q", "k"):
            for f in self.filter_lengths:
                self.add_module(f"{name}_conv{f}", Conv1d(
                    c, f, bias=False, device=device, generator=generator))

    def _pyramid(self, x, name):
        outs = [F.elu(self.shared_bn(getattr(self, f"{name}_conv{f}")(x)))
                for f in self.filter_lengths]
        return torch.stack(outs, dim=1)  # (b, S, l, c)

    def forward(self, q, k, v):
        h, d_k = self.n_heads, self.d_k
        b, _, l, _ = q.shape
        l_k = k.shape[2]
        n_scales = len(self.filter_lengths)
        q_p = self._pyramid(_merge_heads(q), "q")
        k_p = self._pyramid(_merge_heads(k), "k")
        q_p = q_p.reshape(b, n_scales, l, h, d_k).permute(0, 3, 1, 2, 4)
        k_p = k_p.reshape(b, n_scales, l_k, h, d_k).permute(0, 3, 1, 2, 4)
        m_f = max(self.filter_lengths)
        k_sub = k_p[:, :, :, 0::m_f, :]
        scores = torch.matmul(q_p, k_sub.transpose(-1, -2)) / math.sqrt(d_k)
        attn = torch.softmax(scores, dim=-1).amax(dim=2)  # max over scales
        attn_full = attn.new_zeros((b, h, l, l_k))
        attn_full[..., 0::m_f] = attn
        attn_full = torch.softmax(attn_full, dim=-1)
        return matmul16(attn_full.to(v.dtype), v)


class ConvAttnAttention(nn.Module):
    """One f = 9 convolution (no bias) over Q and over K, then softmax
    attention."""

    def __init__(self, d_k: int, n_heads: int, kernel: int = 9,
                 use_kernel: bool = False, *, device, generator):
        super().__init__()
        self.n_heads, self.use_kernel = n_heads, use_kernel
        c = d_k * n_heads
        self.conv_q = Conv1d(c, kernel, bias=False, device=device,
                             generator=generator)
        self.conv_k = Conv1d(c, kernel, bias=False, device=device,
                             generator=generator)

    def forward(self, q, k, v):
        h = self.n_heads
        qs = self.conv_q(_merge_heads(q))
        ks = self.conv_k(_merge_heads(k))
        return _dot_attention(_split_heads(qs, h), _split_heads(ks, h), v,
                              self.use_kernel)
