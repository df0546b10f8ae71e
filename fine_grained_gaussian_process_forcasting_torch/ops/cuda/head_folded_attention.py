"""Fused softmax attention for small head dims (fp32): CUDA kernels + plain.

Counterpart of the JAX package's ``ops/pallas/head_folded_attention.py``
``head_folded_attention``: softmax(q k^T / sqrt(d)) v over (b, h, L, d)
operands, d < 64, with Lq and Lk free (self- and cross-attention), and its
VJP.

``head_folded_attention`` launches ``csrc/head_folded_attention.cu`` for
CUDA tensors and runs the plain version for CPU tensors; it never falls back
from one to the other.  On the card it is a ``torch.autograd.Function``:
the forward kernel also writes each row's log-sum-exp when a gradient is
wanted, and the backward kernel recomputes the probabilities from it.  On
the CPU, torch's autograd differentiates the plain forward.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward kernel launches (one per backward call) since last set to 0
bwd_launches = 0

MAX_HEAD_DIM = 63


def head_folded_attention_plain(q, k, v):
    """The same function in plain PyTorch (fp32 scores and softmax)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def head_folded_attention_bwd_plain(q, k, v, do):
    """(dq, dk, dv) of ``head_folded_attention`` for the cotangent ``do``,
    term for term as the Pallas ``_bwd_kernel`` writes them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def launcher():
    """The C forward launcher: (q, k, v, out, lse-or-null pointers, b*h, Lq,
    Lk, d, stream) -> cudaError_t."""
    return _build.function(
        "head_folded_attention", "head_folded_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher: (q, k, v, o, lse, dout, dq, dk, dv, delta
    pointers, b*h, Lq, Lk, d, stream) -> cudaError_t."""
    return _build.function(
        "head_folded_attention", "head_folded_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, h, L, d)")
    b, h, _, d = q.shape
    lk = k.shape[2]
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside the kernel's 1..63")
    if lk == 0:
        raise ValueError("no keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v, with_lse: bool):
    """Launch the forward kernel: (out, lse or None).  The inputs are
    checked by the caller."""
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    err = launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None, b * h, lq,
                     k.shape[2], d, _stream(q))
    if err != 0:
        raise RuntimeError(
            f"head_folded_attention_fwd launch failed: cudaError {err}")
    global launches
    launches += 1
    return out, lse


def backward_kernel(q, k, v, out, lse, do):
    """Launch the backward kernel: (dq, dk, dv)."""
    b, h, lq, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    err = bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b * h, lq, k.shape[2], d,
        _stream(q))
    if err != 0:
        raise RuntimeError(
            f"head_folded_attention_bwd launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class _HeadFoldedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = forward_kernel(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return backward_kernel(q, k, v, out, lse, do.contiguous())


def head_folded_attention(q, k, v):
    """Context (b, h, Lq, d) of softmax attention; q (b, h, Lq, d),
    k and v (b, h, Lk, d)."""
    if q.device.type == "cpu":
        return head_folded_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _HeadFoldedAttention.apply(q, k, v)
    return forward_kernel(q, k, v, with_lse=False)[0]
