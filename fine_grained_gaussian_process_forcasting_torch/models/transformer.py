"""Encoder-decoder transformer (counterpart of the JAX ``models/transformer.py``).

Sinusoidal positional encoding, post-LN residual blocks with LayerNorm
without affine parameters (eps 1e-5), ReLU feed-forward d -> 4d -> d, and
multi-head attention over the whole zoo: ``basic``, ``autoformer``, the
conv family (``ATA``, ``ACAT``, ``conv_attn``), ``informer`` and
``fedformer``.  Module attribute names follow the Flax module names, so
``params.from_flax`` maps a Flax tree onto ``state_dict`` keys directly.

``compute_dtype`` (e.g. ``torch.bfloat16``) mirrors Flax's ``dtype=`` by
explicit casts, not ``torch.autocast`` (which picks a precision op by op and
would be another function): parameters stay fp32; every dense layer
(``params.Dense``) casts its input, weight and bias to the compute dtype;
the streams and the
positional encoding are cast on entry; LayerNorm takes its statistics in
fp32 and returns the compute dtype; both outputs are cast back to the input
dtype.  fedformer's layers take no ``dtype=`` in the JAX package, so they
compute in fp32 in a 16-bit model too, as the conv family's convolutions do.

Tensor parallelism (``model_axis``, set by ``parallel.sharding``; None on
one device) is Megatron's split, the placement of JAX's
``parallel/sharding.py``: a rank holds h / tp heads of each attention layer
and d_ff / tp hidden units of each feed-forward block.  The column-parallel
projections take their replicated input through ``copy_to`` and the
row-parallel outputs are summed by ``reduce_from``.  ``basic``, informer and
autoformer run on the rank's heads (autoformer sums its head-partial
correlation over the axis); the conv family's convolutions mix every
channel, so ATA, ACAT and conv_attn gather the heads, run replicated and
keep the rank's heads of the context; fedformer's own projections and
Fourier block are replicated leaves and run replicated, its ``fc``
row-parallel on the rank's slice of their output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    matmul16,
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
    head_folded_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.fourier import (
    FourierBlock,
)
from fine_grained_gaussian_process_forcasting_torch.ops.probsparse import (
    prob_sparse_attention,
    sample_keys,
    sample_sizes,
)
from fine_grained_gaussian_process_forcasting_torch.parallel.mesh import (
    copy_to,
    gather,
    reduce_from,
    split,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense

ATTENTION_TYPES = ("basic", "ATA", "ACAT", "conv_attn", "autoformer",
                   "informer", "fedformer")
# fedformer's Fourier block: the sequence length its modes are chosen for
# and their number, fixed in the JAX package's MultiHeadAttention
FEDFORMER_SEQ_LEN, FEDFORMER_MODES = 96, 8


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
    of that d_k: flash at every d_k >= 64, as JAX's flag takes its
    ``fused_attention`` there) or the plain path.
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

    model_axis = None  # parallel.mesh.Axis: the rank's hidden units

    def forward(self, x):
        ax = self.model_axis
        if ax is None:
            return self.w2(F.relu(self.w1(x)))
        hidden = F.relu(self.w1(copy_to(x, ax)))
        w2, dtype = self.w2, self.w2.compute_dtype
        out = (F.linear(hidden, w2.weight) if dtype is None
               else matmul16(hidden.to(dtype), w2.weight.to(dtype).T))
        return reduce_from(out, ax) + w2.bias.to(out.dtype)


class MultiHeadAttention(nn.Module):
    """Q/K/V projection + dispatch over the ported attention ops.

    Self-attention (``q_in is k_in is v_in``) uses one fused ``wqkv``
    projection; cross-attention uses separate ``wq``/``wk``/``wv``.  As the
    Flax module creates only the set its calls use, ``is_self`` says which
    set this layer holds.

    The conv family keeps the JAX package's boolean opt-in: only an explicit
    ``use_pallas_attention=True`` takes a kernel (ATA and conv_attn, on CUDA
    tensors; ``conv_attention.conv_attention_route``), and auto (None) is the
    plain op, as ``bool(None)`` is there.

    ``informer`` draws its key sample from the ``generator`` its call is
    given (the model's), or from a fixed seed-0 generator without one.
    ``fedformer`` holds its own projections instead: ``fed_q`` (with bias)
    on the queries' stream only, so that cross-attention ignores k and v,
    the Fourier block, ``fed_out`` (with bias) and ``fc``, all fp32.
    """

    def __init__(self, d_model: int, d_k: int, d_v: int, n_heads: int,
                 attn_type: str = "basic",
                 use_pallas_attention: Optional[bool] = None, dtype=None, *,
                 is_self: bool, device, generator):
        super().__init__()
        if attn_type not in ATTENTION_TYPES:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        use_kernel = bool(use_pallas_attention)
        self.d_k, self.d_v, self.n_heads = d_k, d_v, n_heads
        self.attn_type = attn_type
        self.use_pallas_attention = use_pallas_attention
        h = n_heads
        init_kw = dict(device=device, generator=generator)
        if attn_type == "fedformer":
            self.fed_q = dense(d_model, d_k * h, bias=True, **init_kw)
            self.fourier_block = FourierBlock(
                d_model, d_model, FEDFORMER_SEQ_LEN, FEDFORMER_MODES,
                n_heads=h, **init_kw)
            self.fed_out = dense(d_model, d_model, bias=True, **init_kw)
            self.fc = dense(d_model, d_model, bias=False, **init_kw)
            return
        if attn_type == "ATA":
            self.ata = ATAAttention(d_k, h, use_kernel=use_kernel, **init_kw)
        elif attn_type == "ACAT":
            self.acat = ACATAttention(d_k, h, **init_kw)
        elif attn_type == "conv_attn":
            self.conv_attn = ConvAttnAttention(d_k, h, use_kernel=use_kernel,
                                               **init_kw)
        kw = dict(bias=False, device=device, generator=generator,
                  dtype=dtype)
        if is_self:
            self.wqkv = dense(d_model, 2 * d_k * h + d_v * h, **kw)
        else:
            self.wq = dense(d_model, d_k * h, **kw)
            self.wk = dense(d_model, d_k * h, **kw)
            self.wv = dense(d_model, d_v * h, **kw)
        self.fc = dense(h * d_v, d_model, **kw)

    # parallel.mesh.Axis (set by parallel.sharding): the rank's heads, and
    # the batch that autoformer's training delays average over
    model_axis = None
    data_axis = None

    def forward(self, q_in, k_in, v_in, training: bool = False,
                generator: Optional[torch.Generator] = None):
        b = q_in.shape[0]
        ax = self.model_axis
        h = self.n_heads // (1 if ax is None else ax.size)  # this rank's
        d_k, d_v = self.d_k, self.d_v
        if self.attn_type == "fedformer":  # fp32, as Flax promotes
            length = q_in.shape[1]
            qs = self.fed_q(q_in.to(self.fed_q.weight.dtype)).reshape(
                b, length, self.n_heads, -1)
            out, _ = self.fourier_block(qs)
            out = split(self.fed_out(out.reshape(b, length, -1)), ax, -1)
            return reduce_from(self.fc(out), ax)
        is_self = q_in is k_in and k_in is v_in
        if is_self:
            qkv = self.wqkv(copy_to(q_in, ax))
            q = qkv[..., : d_k * h]
            k = qkv[..., d_k * h: 2 * d_k * h]
            v = qkv[..., 2 * d_k * h:]
        else:
            q, k, v = (self.wq(copy_to(q_in, ax)), self.wk(copy_to(k_in, ax)),
                       self.wv(copy_to(v_in, ax)))

        def heads(x, d):
            return x.reshape(b, -1, h, d).transpose(1, 2)

        q, k, v = heads(q, d_k), heads(k, d_k), heads(v, d_v)
        if self.attn_type in ("ATA", "ACAT", "conv_attn"):
            # the convolutions mix every head: replicated on all of them
            op = getattr(self, self.attn_type.lower())
            context = split(op(*(gather(t, ax, 1) for t in (q, k, v))), ax,
                            1)
        elif self.attn_type == "autoformer":
            # batch-shared delays in training, per-sample in eval; the
            # axes only on a mesh
            axes = ({} if ax is None and self.data_axis is None else
                    dict(model_axis=ax, data_axis=self.data_axis))
            context, _ = auto_correlation(q, k, v, training=training, **axes)
        elif self.attn_type == "informer":
            context, _ = prob_sparse_attention(q, k, v, generator=generator)
        else:
            route = basic_attention_route(q.device, d_k, is_self,
                                          self.use_pallas_attention)
            if route == "flash":
                context = fused_attention(
                    q.contiguous(), k.contiguous(), v.contiguous())
            elif route == "head_folded":
                # the kernel reads the projections' (b, L, h, d) buffers
                # in place and writes the context as a view of (b, L, h, d)
                # memory, so neither way makes a copy
                context = head_folded_attention(q, k, v)
            else:
                context, _ = scaled_dot_attention(q, k, v)
        context = context.transpose(1, 2).reshape(b, -1, h * d_v)
        return reduce_from(self.fc(context), ax)


def _layer_norm(x, dtype=None):
    """LayerNorm without affine parameters; the statistics in fp32, the
    result in ``dtype`` (None: x's), as Flax's ``LayerNorm(dtype=)``."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(
        dtype or x.dtype)


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
        self.dtype = dtype

    def forward(self, x, training: bool = False, generator=None):
        out = _layer_norm(self.self_attn(x, x, x, training=training,
                                         generator=generator) + x,
                          self.dtype)
        return _layer_norm(self.ffn(out) + out, self.dtype)


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
        self.dtype = dtype

    def forward(self, x, enc_out, training: bool = False, generator=None):
        kw = dict(training=training, generator=generator)
        out = _layer_norm(x + self.self_attn(x, x, x, **kw), self.dtype)
        out2 = _layer_norm(out + self.cross_attn(out, enc_out, enc_out, **kw),
                           self.dtype)
        return _layer_norm(out2 + self.ffn(out2), self.dtype)


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

    def forward(self, x, training: bool = False, generator=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + positional_encoding(x.shape[1], self.d_model, x.device,
                                    x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, training=training,
                                           generator=generator)
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

    def forward(self, x, enc_out, training: bool = False, generator=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x + positional_encoding(x.shape[1], self.d_model, x.device,
                                    x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, enc_out, training=training,
                                           generator=generator)
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
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        args = (d_model, d_ff, d_k, d_v, n_heads, n_layers, attn_type,
                use_pallas_attention, compute_dtype)
        self.encoder = Encoder(*args, device=device, generator=generator)
        self.decoder = Decoder(*args, device=device, generator=generator)
        self.attn_type, self.n_layers = attn_type, n_layers

    def key_samples(self, enc_len: int, dec_len: int, generator,
                    device) -> list:
        """informer's key samples of one forward, drawn from ``generator``
        in the order its ProbSparse calls take them (each encoder layer's
        self-attention, then each decoder layer's self- and cross-
        attention), each (l_q, u_part) int64; [] for the other attention
        types, which draw nothing."""
        if self.attn_type != "informer":
            return []
        calls = ([(enc_len, enc_len)] * self.n_layers
                 + [(dec_len, dec_len), (dec_len, enc_len)] * self.n_layers)
        return [sample_keys(l_q, l_k, sample_sizes(l_q, l_k)[0], generator,
                            device) for l_q, l_k in calls]

    def forward(self, enc_inputs, dec_inputs, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator``: where informer draws its key samples (a
        generator, or a ``draws.DrawTape`` that replays ``key_samples``)."""
        in_dtype = enc_inputs.dtype
        enc_out = self.encoder(enc_inputs, training=training,
                               generator=generator)
        dec_out = self.decoder(dec_inputs, enc_out, training=training,
                               generator=generator)
        return enc_out.to(in_dtype), dec_out.to(in_dtype)
