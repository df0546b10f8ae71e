"""Fused softmax attention at any head dim (bf16 and fp32): CUDA kernels +
plain.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``
``fused_attention`` and ``fused_attention_bf16sm``: softmax(q k^T / sqrt(d)) v
over (b, h, L, d) operands with Lq and Lk free, and its VJP.  The operands'
dtype sets the arithmetic, as in the Pallas kernel: bf16 operands run the two
forward and five backward products on bf16 inputs summed in fp32, with P and
dS rounded to bf16 before their products; fp32 operands run everything in
fp32.  The softmax and dS are fp32 either way, and the outputs come back in
the operands' dtype.
``fused_attention_bf16sm`` subtracts the row's max in fp32 and then runs the
exponential, the sum and the division on bf16 values (the sum itself in
fp32); nothing routes to it.

Every head dim d >= 1 runs, as the Pallas kernel's zero-padding to the lane
width takes any d: the kernels zero-fill their shared-memory tiles past d
and mask their stores, nothing is padded in device memory.  bf16 operands
at d <= 256 take the ``wgmma`` kernels (padded width ``wgmma_width``: 64,
128 or 256); fp32 operands and bf16 at d > 256 take the FFMA kernels, 64
output columns a block.

``fused_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors and
runs the plain version for CPU tensors; it never falls back from one to the
other.  It is a ``torch.autograd.Function`` on both: the VJP is the Pallas
kernel's own rule (which rounds P and dS), not the derivative of the rounded
forward.  On the card the forward kernel also writes each row's log-sum-exp
(``sm_bf16``: its max and rounded sum) when a gradient is wanted, and the
backward kernels recompute the probabilities from it.

Under ``torch.func.vmap`` (the seeds of a multi-seed model) the vmapped
axis folds into b: the Function's ``vmap`` rule makes one call on
(S b, h, L, d) and unfolds the context, as head-folded attention does.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.head_folded_attention import (
    fold_vmapped,
)

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward launches (one per backward call, two kernels) since last set to 0
bwd_launches = 0
#: the same two counts for the sm_bf16 variant
sm16_launches = 0
sm16_bwd_launches = 0
#: the fp32 operands' share of ``launches`` and ``bwd_launches``
f32_launches = 0
f32_bwd_launches = 0

DTYPES = (torch.bfloat16, torch.float32)


def wgmma_width(d: int, dtype) -> int:
    """The padded head dim of the ``wgmma`` kernels that a call takes (64,
    128 or 256), or 0 where the FFMA kernels take it; as ``wgmma_width``
    in the CUDA source decides."""
    if dtype != torch.bfloat16 or d > 256:
        return 0
    return 64 if d <= 64 else (128 if d <= 128 else 256)


def _dot(a, b):
    """Product of the operands as the kernels take it: exact products of
    the (bf16 or fp32) values, summed in fp32."""
    return torch.matmul(a.float(), b.float())


def _softmax(s, sm_bf16):
    """Row softmax of fp32 scores.  ``sm_bf16``: the max subtracted in fp32,
    then exp, sum and divide on bf16 values, the sum itself in fp32; bf16
    probabilities."""
    if not sm_bf16:
        return torch.softmax(s, dim=-1)
    e = torch.exp((s - s.max(-1, keepdim=True).values).bfloat16())
    return e / e.float().sum(-1, keepdim=True).bfloat16()


def fused_attention_plain(q, k, v, sm_bf16=False):
    """The same function in plain PyTorch: fp32 scores, the softmax, the
    probabilities rounded to the operands' dtype before P v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _softmax(_dot(q, k.transpose(-1, -2)) * scale, sm_bf16)
    return _dot(p.to(q.dtype), v).to(q.dtype)


def fused_attention_bwd_plain(q, k, v, do, sm_bf16=False):
    """(dq, dk, dv) of ``fused_attention`` for the cotangent ``do``, term
    for term as the Pallas ``_bwd_kernel`` writes them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    p = _softmax(_dot(q, k.transpose(-1, -2)) * scale, sm_bf16)
    dv = _dot(p.to(q.dtype).transpose(-1, -2), do)
    dp = _dot(do, v.transpose(-1, -2))
    p = p.float()
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(q.dtype)
    dq = _dot(ds, k) * scale
    dk = _dot(ds.transpose(-1, -2), q) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class Stats(NamedTuple):
    """What the forward keeps for the backward: each row's log-sum-exp, (b,
    h, lq) (``sm_bf16``: its max and rounded sum, (2, b, h, lq)), and, for
    bf16 operands, ``o_lo``, the output's rounding residual against the
    product with unrounded probabilities, so that the backward's
    D = rowsum(dO o (o + o_lo)) is the reference's rowsum(dP o P)."""
    lse: torch.Tensor
    o_lo: Optional[torch.Tensor]


def launcher():
    """The C forward launcher: (q, k, v, out, o_lo-or-null, stats-or-null
    pointers, b*h, Lq, Lk, d, bf16, sm_bf16, stream) -> cudaError_t."""
    return _build.function(
        "flash_attention", "flash_attention_fwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher: (q, k, v, o, o_lo-or-null, stats, dout, dq,
    dk, dv, delta pointers, b*h, Lq, Lk, d, bf16, sm_bf16, stream) ->
    cudaError_t."""
    return _build.function(
        "flash_attention", "flash_attention_bwd",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, h, L, d)")
    b, h, _, d = q.shape
    lk = k.shape[2]
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if d == 0:
        raise ValueError("head dim 0")
    if lk == 0:
        raise ValueError("no keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v, with_stats: bool, sm_bf16=False):
    """Launch the forward kernel: (out, stats or None).  stats, for the
    backward: each row's log-sum-exp, (b, h, lq); with ``sm_bf16`` each row's
    max and rounded sum, (2, b, h, lq).  The inputs are checked by the
    caller."""
    global launches, sm16_launches, f32_launches
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    stats = None
    if with_stats:
        shape = (2, b, h, lq) if sm_bf16 else (b, h, lq)
        stats = Stats(torch.empty(shape, device=q.device, dtype=torch.float32),
                      torch.empty_like(q) if q.dtype == torch.bfloat16
                      else None)
    if out.numel() == 0:
        return out, stats
    err = launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _ptr(stats.o_lo) if with_stats else None,
                     stats.lse.data_ptr() if with_stats else None, b * h, lq,
                     k.shape[2], d, int(q.dtype == torch.bfloat16),
                     int(sm_bf16), _stream(q))
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: cudaError {err}")
    if sm_bf16:
        sm16_launches += 1
    else:
        launches += 1
        f32_launches += q.dtype == torch.float32
    return out, stats


def _ptr(t):
    return None if t is None else t.data_ptr()


def backward_kernel(q, k, v, out, stats, do, sm_bf16=False):
    """Launch the backward kernels: (dq, dk, dv); ``stats`` the forward's
    ``Stats``; ``do`` contiguous, in the operands' dtype."""
    global bwd_launches, sm16_bwd_launches, f32_bwd_launches
    b, h, lq, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    err = bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _ptr(stats.o_lo), stats.lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b * h, lq, k.shape[2], d,
        int(q.dtype == torch.bfloat16), int(sm_bf16), _stream(q))
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: cudaError {err}")
    if sm_bf16:
        sm16_bwd_launches += 1
    else:
        bwd_launches += 1
        f32_bwd_launches += q.dtype == torch.float32
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The kernels on the card; the plain forward and the plain VJP on the
    CPU.  Returns the context and, on the card, the backward's ``Stats``."""

    @staticmethod
    def forward(sm_bf16, q, k, v):
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v, sm_bf16), None, None
        out, stats = forward_kernel(q, k, v, True, sm_bf16)
        return out, *stats

    @staticmethod
    def setup_context(ctx, inputs, output):
        sm_bf16, q, k, v = inputs
        out, lse, o_lo = output
        ctx.sm_bf16 = sm_bf16
        ctx.save_for_backward(q, k, v, out, lse, o_lo)
        ctx.mark_non_differentiable(*(t for t in (lse, o_lo)
                                      if t is not None))

    @staticmethod
    def vmap(info, in_dims, sm_bf16, q, k, v):
        out = _attention(*(t.contiguous() for t in fold_vmapped(
            info, in_dims[1:], q, k, v)), sm_bf16)
        return ((out.unflatten(0, (info.batch_size, -1)), None, None),
                (0, None, None))

    @staticmethod
    @once_differentiable
    def backward(ctx, do, *_):
        q, k, v, out, lse, o_lo = ctx.saved_tensors
        if q.device.type == "cpu":
            return (None, *fused_attention_bwd_plain(q, k, v, do,
                                                     ctx.sm_bf16))
        return (None, *backward_kernel(q, k, v, out, Stats(lse, o_lo),
                                       do.to(q.dtype).contiguous(),
                                       ctx.sm_bf16))


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel: the kernel on CUDA tensors, the plain version on CPU
# tensors, the context's shape from ``register_fake``.  The served
# (no-gradient) path calls it.
@torch.library.custom_op(
    "fgp_torch::flash_attention_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, bool sm_bf16) -> Tensor")
def flash_attention_fwd(q, k, v, sm_bf16):
    _check(q, k, v)
    return forward_kernel(q, k, v, False, sm_bf16)[0]


@flash_attention_fwd.register_kernel("cpu")
def _(q, k, v, sm_bf16):
    return fused_attention_plain(q, k, v, sm_bf16)


@flash_attention_fwd.register_fake
def _(q, k, v, sm_bf16):
    return torch.empty_like(q) if q.device.type == "cuda" else q.new_empty(
        q.shape)


def _attention(q, k, v, sm_bf16):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch._C._are_functorch_transforms_active():
        return _FusedAttention.apply(sm_bf16, q, k, v)[0]  # its vmap rule
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cuda":
            _check(q, k, v)
        return _FusedAttention.apply(sm_bf16, q, k, v)[0]
    return flash_attention_fwd(q, k, v, sm_bf16)


def fused_attention(q, k, v):
    """Context (b, h, Lq, d) of softmax attention, in the operands' dtype;
    q (b, h, Lq, d), k and v (b, h, Lk, d), all bfloat16 or all float32."""
    return _attention(q, k, v, False)


def fused_attention_bf16sm(q, k, v):
    """The same with the softmax's exponential, sum and division on bf16
    values after an fp32 max-subtract."""
    return _attention(q, k, v, True)
