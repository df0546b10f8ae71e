"""The Informer-style encoder / decoder stack with distilling convolutions.

Counterpart of the JAX package's ``models/informer_stack.py`` (no Pallas
kernel): post-norm residual blocks with dense feed-forwards, full or
ProbSparse attention (``ops/full_attention.py``, ``ops/probsparse.py`` at
factor 5), and between encoder blocks a circular k=3 convolution, batch-
statistics norm, ELU and a stride-2 max-pool.  The products are cuBLAS's
and the convolution cuDNN's on the card.

ProbSparse draws its key sample from the ``generator`` a forward is given:
a ``torch.Generator``, or a ``draws.DrawTape`` that records the samples of
each layer in call order or replays another run's (JAX's, in the tests).
Without one each layer draws from a fixed seed-0 generator, where JAX falls
back to ``PRNGKey(0)``: another draw.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.embedding import (
    CircularConv1d,
)
from fine_grained_gaussian_process_forcasting_torch.ops.conv_attention import (
    BatchStatsNorm,
)
from fine_grained_gaussian_process_forcasting_torch.ops.full_attention import (
    full_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.probsparse import (
    prob_sparse_attention,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    LayerNorm,
    dense,
)

PROB_FACTOR = 5  # the stack's ProbSparse sampling factor, as in JAX


class AttentionLayer(nn.Module):
    """Q / K / V / out projections around full or ProbSparse attention."""

    def __init__(self, d_model: int, n_heads: int, inner: str = "full",
                 mask_flag: bool = False, *, device, generator):
        super().__init__()
        if inner not in ("full", "prob"):
            raise ValueError(f"unknown inner attention {inner!r}")
        self.n_heads, self.inner, self.mask_flag = n_heads, inner, mask_flag
        kw = dict(bias=True, device=device, generator=generator)
        self.query_projection = dense(d_model, d_model, **kw)
        self.key_projection = dense(d_model, d_model, **kw)
        self.value_projection = dense(d_model, d_model, **kw)
        self.out_projection = dense(d_model, d_model, **kw)

    def forward(self, queries, keys, values, mask=None, generator=None):
        B, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        if self.inner == "prob":
            if generator is None:
                generator = torch.Generator(device=q.device).manual_seed(0)
            ctx, attn = prob_sparse_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                generator, factor=PROB_FACTOR, mask_flag=self.mask_flag)
            out = ctx.transpose(1, 2)
        else:
            out, attn = full_attention(q, k, v, mask_flag=self.mask_flag)
        return self.out_projection(out.reshape(B, L, -1)), attn


class ConvLayer(nn.Module):
    """Distilling layer: circular pad 2, a k=3 convolution with bias,
    ``BatchStatsNorm``, ELU, max-pool k 3 / stride 2 / pad 1 (-inf), so
    l rows become ceil((l + 2) / 2)."""

    def __init__(self, c_in: int, *, device, generator):
        super().__init__()
        self.down_conv = CircularConv1d(c_in, c_in, 2, bias=True,
                                        device=device, generator=generator)
        self.norm = BatchStatsNorm(c_in, device=device)

    def forward(self, x):
        y = F.elu(self.norm(self.down_conv(x)))
        return F.max_pool1d(y.transpose(1, 2), 3, 2, 1).transpose(1, 2)


class InformerEncoderLayer(nn.Module):
    """Residual attention, LayerNorm, dense feed-forward, LayerNorm."""

    def __init__(self, d_model: int, d_ff: Optional[int] = None,
                 activation: str = "relu", n_heads: int = 8,
                 inner: str = "full", *, device, generator):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.activation = activation
        kw = dict(device=device, generator=generator)
        self.attention = AttentionLayer(d_model, n_heads, inner, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.conv1 = dense(d_model, d_ff, bias=True, **kw)
        self.conv2 = dense(d_ff, d_model, bias=True, **kw)
        self.norm2 = LayerNorm(d_model, device=device)

    def forward(self, x, mask=None, generator=None):
        new_x, attn = self.attention(x, x, x, mask, generator)
        y = x = self.norm1(x + new_x)
        y = self.conv1(y)
        y = (F.relu(y) if self.activation == "relu"
             else F.gelu(y, approximate="tanh"))
        return self.norm2(x + self.conv2(y)), attn


class InformerEncoder(nn.Module):
    """Encoder layers with a distilling ``ConvLayer`` between them, then
    LayerNorm."""

    def __init__(self, d_model: int, n_layers: int = 2, n_heads: int = 8,
                 inner: str = "prob", distil: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.n_layers, self.distil = n_layers, distil
        for i in range(n_layers):
            setattr(self, f"layer{i}", InformerEncoderLayer(
                d_model, n_heads=n_heads, inner=inner, **kw))
            if distil and i < n_layers - 1:
                setattr(self, f"distil{i}", ConvLayer(d_model, **kw))
        self.norm = LayerNorm(d_model, device=device)

    def forward(self, x, mask=None, generator=None):
        for i in range(self.n_layers):
            x, _ = getattr(self, f"layer{i}")(x, mask, generator)
            if self.distil and i < self.n_layers - 1:
                x = getattr(self, f"distil{i}")(x)
        return self.norm(x)


class InformerDecoderLayer(nn.Module):
    """Causal ProbSparse self-attention, full cross attention, a dense
    feed-forward of width 4 d_model, each residual and LayerNorm'd."""

    def __init__(self, d_model: int, n_heads: int = 8, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.self_attention = AttentionLayer(d_model, n_heads, "prob",
                                             mask_flag=True, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.cross_attention = AttentionLayer(d_model, n_heads, "full", **kw)
        self.norm2 = LayerNorm(d_model, device=device)
        self.conv1 = dense(d_model, 4 * d_model, bias=True, **kw)
        self.conv2 = dense(4 * d_model, d_model, bias=True, **kw)
        self.norm3 = LayerNorm(d_model, device=device)

    def forward(self, x, cross, x_mask=None, cross_mask=None,
                generator=None):
        x = x + self.self_attention(x, x, x, x_mask, generator)[0]
        x = self.norm1(x)
        x = x + self.cross_attention(x, cross, cross, cross_mask)[0]
        y = x = self.norm2(x)
        y = self.conv2(F.relu(self.conv1(y)))
        return self.norm3(x + y)
