"""Encoder-decoder transformer (counterpart of the JAX ``models/transformer.py``).

Sinusoidal positional encoding, post-LN residual blocks with LayerNorm
without affine parameters (eps 1e-5), ReLU feed-forward d -> 4d -> d, and
multi-head attention over the ``basic`` and ``autoformer`` ops.  Module
attribute names follow the Flax module names, so ``params.from_flax`` maps a
Flax tree onto ``state_dict`` keys directly.

``compute_dtype`` (e.g. ``torch.bfloat16``) mirrors Flax's ``dtype=`` by
explicit casts, not ``torch.autocast`` (which picks a precision op by op and
would be another function): parameters stay fp32; every dense layer
(``params.Dense``) casts its input, weight and bias to the compute dtype;
the streams and the
positional encoding are cast on entry; LayerNorm takes its statistics in
fp32 and returns the compute dtype; both outputs are cast back to the input
dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    scaled_dot_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (
    auto_correlation,
)
from fine_grained_gaussian_process_forcasting_torch.ops.conv_attention import (
    ACATAttention,
    ATAAttention,
    ConvAttnAttention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.flash_attention import (
    fused_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.head_folded_attention import (
    MAX_HEAD_DIM,
    head_folded_attention,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense

ATTENTION_TYPES = ("basic", "ATA", "ACAT", "conv_attn", "autoformer",
                   "informer", "fedformer")
PORTED_ATTENTION_TYPES = ("basic", "autoformer", "ATA", "ACAT", "conv_attn")
CONV_ATTENTION_TYPES = ("ATA", "ACAT", "conv_attn")


def positional_encoding(length: int, d_model: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal table (1, length, d_model), computed in fp32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.pow(10000.0, torch.arange(0, d_model, 2, dtype=torch.float32,
                                          device=device) / d_model)
    x = pos / div
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(x)
    pe[:, 1::2] = torch.cos(x[:, : d_model // 2])
    return pe[None].to(dtype)


def basic_attention_route(device: torch.device, d_k: int, is_self: bool,
                          use_pallas_attention: Optional[bool] = None) -> str:
    """Which implementation a ``basic`` attention call takes: "plain",
    "head_folded" or "flash".

    Resolved on the tensor's device.  The CPU always takes the plain path.
    On CUDA, auto (None) takes the head-folded kernel at d_k < 64, self- and
    cross-attention, and the flash kernel for self-attention at
    64 <= d_k < 128; cross-attention at d_k >= 64 and everything at
    d_k >= 128 are plain.  An explicit True or False forces a kernel (the one
    of that d_k) or the plain path.
    """
    if torch.device(device).type == "cpu":
        return "plain"
    if use_pallas_attention is None:
        use_kernel = d_k < 128 and (is_self or d_k < 64)
    else:
        use_kernel = use_pallas_attention
    if not use_kernel:
        return "plain"
    return "flash" if d_k >= 64 else "head_folded"


class FeedForward(nn.Module):
    """ReLU MLP d_model -> d_ff -> d_model."""

    def __init__(self, d_model: int, d_ff: int, dtype=None, *, device,
                 generator):
        super().__init__()
        kw = dict(bias=True, device=device, generator=generator, dtype=dtype)
        self.w1 = dense(d_model, d_ff, **kw)
        self.w2 = dense(d_ff, d_model, **kw)

    def forward(self, x):
        return self.w2(F.relu(self.w1(x)))


class MultiHeadAttention(nn.Module):
    """Q/K/V projection + dispatch over the ported attention ops.

    Self-attention (``q_in is k_in is v_in``) uses one fused ``wqkv``
    projection; cross-attention uses separate ``wq``/``wk``/``wv``.  As the
    Flax module creates only the set its calls use, ``is_self`` says which
    set this layer holds.

    The conv family keeps the JAX package's boolean opt-in: only an explicit
    ``use_pallas_attention=True`` takes the head-folded kernel (ATA and
    conv_attn, on CUDA tensors), and auto (None) is the plain op, as
    ``bool(None)`` is there.  The port's kernel takes d_k <= 63, so the flag
    at a larger d_k raises rather than run the plain op in its place.
    """

    def __init__(self, d_model: int, d_k: int, d_v: int, n_heads: int,
                 attn_type: str = "basic",
                 use_pallas_attention: Optional[bool] = None, dtype=None, *,
                 is_self: bool, device, generator):
        super().__init__()
        if attn_type not in ATTENTION_TYPES:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        if attn_type not in PORTED_ATTENTION_TYPES:
            raise NotImplementedError(
                f"attn_type={attn_type!r} is not ported yet (ROADMAP.md "
                "modules to port, item 9: the rest of the attention zoo)")
        if attn_type in CONV_ATTENTION_TYPES and dtype is not None \
                and dtype.itemsize == 2:
            raise NotImplementedError(
                f"attn_type={attn_type!r} with compute_dtype={dtype} is not "
                "ported yet: the JAX conv layers promote a 16-bit input to "
                "fp32 against their fp32 kernels (ROADMAP.md modules to port, "
                "item 14)")
        use_kernel = bool(use_pallas_attention)
        if (attn_type in ("ATA", "conv_attn") and use_kernel
                and d_k > MAX_HEAD_DIM):
            raise ValueError(
                f"attn_type={attn_type!r} with use_pallas_attention=True at "
                f"d_k={d_k}: the port's head-folded kernel takes d_k <= "
                f"{MAX_HEAD_DIM}, and the flag asks for that kernel; pass "
                "use_pallas_attention=None (the plain op)")
        self.d_k, self.d_v, self.n_heads = d_k, d_v, n_heads
        self.attn_type = attn_type
        self.use_pallas_attention = use_pallas_attention
        h = n_heads
        conv_kw = dict(device=device, generator=generator)
        if attn_type == "ATA":
            self.ata = ATAAttention(d_k, h, use_kernel=use_kernel, **conv_kw)
        elif attn_type == "ACAT":
            self.acat = ACATAttention(d_k, h, **conv_kw)
        elif attn_type == "conv_attn":
            self.conv_attn = ConvAttnAttention(d_k, h, use_kernel=use_kernel,
                                               **conv_kw)
        kw = dict(bias=False, device=device, generator=generator,
                  dtype=dtype)
        if is_self:
            self.wqkv = dense(d_model, 2 * d_k * h + d_v * h, **kw)
        else:
            self.wq = dense(d_model, d_k * h, **kw)
            self.wk = dense(d_model, d_k * h, **kw)
            self.wv = dense(d_model, d_v * h, **kw)
        self.fc = dense(h * d_v, d_model, **kw)

    def forward(self, q_in, k_in, v_in, training: bool = False):
        b = q_in.shape[0]
        h, d_k, d_v = self.n_heads, self.d_k, self.d_v
        is_self = q_in is k_in and k_in is v_in
        if is_self:
            qkv = self.wqkv(q_in)
            q = qkv[..., : d_k * h]
            k = qkv[..., d_k * h: 2 * d_k * h]
            v = qkv[..., 2 * d_k * h:]
        else:
            q, k, v = self.wq(q_in), self.wk(k_in), self.wv(v_in)

        def split(x, d):
            return x.reshape(b, -1, h, d).transpose(1, 2)

        q, k, v = split(q, d_k), split(k, d_k), split(v, d_v)
        if self.attn_type == "ATA":
            context = self.ata(q, k, v)
        elif self.attn_type == "ACAT":
            context = self.acat(q, k, v)
        elif self.attn_type == "conv_attn":
            context = self.conv_attn(q, k, v)
        elif self.attn_type == "autoformer":
            # batch-shared delays in training, per-sample in eval
            context, _ = auto_correlation(q, k, v, training=training)
        else:
            route = basic_attention_route(q.device, d_k, is_self,
                                          self.use_pallas_attention)
            if route == "flash":
                context = fused_attention(
                    q.contiguous(), k.contiguous(), v.contiguous())
            elif route == "head_folded":
                context = head_folded_attention(
                    q.contiguous(), k.contiguous(), v.contiguous())
            else:
                context, _ = scaled_dot_attention(q, k, v)
        context = context.transpose(1, 2).reshape(b, -1, h * d_v)
        return self.fc(context)


def _layer_norm(x):
    """LayerNorm without affine parameters; the statistics in fp32, the
    result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(x.dtype)


class EncoderLayer(nn.Module):
    """Self-attn -> LN -> FFN -> LN, post-norm without affine."""

    def __init__(self, d_model, d_ff, d_k, d_v, n_heads, attn_type,
                 use_pallas_attention=None, dtype=None, *, device, generator):
        super().__init__()
        self.self_attn = MultiHeadAttention(
            d_model, d_k, d_v, n_heads, attn_type, use_pallas_attention,
            dtype, is_self=True, device=device, generator=generator)
        self.ffn = FeedForward(d_model, d_ff, dtype, device=device,
                               generator=generator)

    def forward(self, x, training: bool = False):
        out = _layer_norm(self.self_attn(x, x, x, training=training) + x)
        return _layer_norm(self.ffn(out) + out)


class DecoderLayer(nn.Module):
    """Self-attn, cross-attn, FFN, each followed by a post-LN."""

    def __init__(self, d_model, d_ff, d_k, d_v, n_heads, attn_type,
                 use_pallas_attention=None, dtype=None, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, d_k, d_v, n_heads, attn_type, use_pallas_attention,
            dtype, is_self=True, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, d_k, d_v, n_heads, attn_type, use_pallas_attention,
            dtype, is_self=False, **kw)
        self.ffn = FeedForward(d_model, d_ff, dtype, **kw)

    def forward(self, x, enc_out, training: bool = False):
        out = _layer_norm(x + self.self_attn(x, x, x, training=training))
        out2 = _layer_norm(out + self.cross_attn(out, enc_out, enc_out,
                                                 training=training))
        return _layer_norm(out2 + self.ffn(out2))


class Encoder(nn.Module):
    def __init__(self, d_model, d_ff, d_k, d_v, n_heads, n_layers, attn_type,
                 use_pallas_attention=None, dtype=None, *, device, generator):
        super().__init__()
        self.d_model = d_model
        self.n_layers = n_layers
        self.dtype = dtype
        for i in range(n_layers):
            self.add_module(f"layer{i}", EncoderLayer(
                d_model, d_ff, d_k, d_v, n_heads, attn_type,
                use_pallas_attention, dtype, device=device,
                generator=generator))

    def forward(self, x, training: bool = False):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + positional_encoding(x.shape[1], self.d_model, x.device,
                                    x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, training=training)
        return x


class Decoder(nn.Module):
    def __init__(self, d_model, d_ff, d_k, d_v, n_heads, n_layers, attn_type,
                 use_pallas_attention=None, dtype=None, *, device, generator):
        super().__init__()
        self.d_model = d_model
        self.n_layers = n_layers
        self.dtype = dtype
        for i in range(n_layers):
            self.add_module(f"layer{i}", DecoderLayer(
                d_model, d_ff, d_k, d_v, n_heads, attn_type,
                use_pallas_attention, dtype, device=device,
                generator=generator))

    def forward(self, x, enc_out, training: bool = False):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + positional_encoding(x.shape[1], self.d_model, x.device,
                                    x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, enc_out, training=training)
        return x


class Transformer(nn.Module):
    """Seq2seq transformer over already-embedded (b, l, d_model) inputs.
    Returns (enc_out, dec_out)."""

    def __init__(self, d_model: int, d_ff: int, d_k: int, d_v: int,
                 n_heads: int, n_layers: int, attn_type: str = "basic",
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas_attention: Optional[bool] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if (attn_type == "autoformer" and compute_dtype is not None
                and compute_dtype.itemsize == 2):
            raise NotImplementedError(
                f"attn_type='autoformer' with compute_dtype={compute_dtype} "
                "is not ported yet: the reference rounds its DFT matrices "
                "and spectra to that dtype (ROADMAP.md modules to port, "
                "item 14)")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        args = (d_model, d_ff, d_k, d_v, n_heads, n_layers, attn_type,
                use_pallas_attention, compute_dtype)
        self.encoder = Encoder(*args, device=device, generator=generator)
        self.decoder = Decoder(*args, device=device, generator=generator)

    def forward(self, enc_inputs, dec_inputs, training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        in_dtype = enc_inputs.dtype
        enc_out = self.encoder(enc_inputs, training=training)
        dec_out = self.decoder(dec_inputs, enc_out, training=training)
        return enc_out.to(in_dtype), dec_out.to(in_dtype)
