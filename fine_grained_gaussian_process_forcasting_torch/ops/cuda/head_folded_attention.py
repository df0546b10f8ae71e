"""Fused softmax attention for small head dims (fp32 forward): CUDA + plain.

Counterpart of the JAX package's ``ops/pallas/head_folded_attention.py``
``head_folded_attention``: softmax(q k^T / sqrt(d)) v over (b, h, L, d)
operands, d < 64, with Lq and Lk free (self- and cross-attention).

``head_folded_attention`` launches ``csrc/head_folded_attention.cu`` for
CUDA tensors and runs the plain version for CPU tensors; it never falls back
from one to the other.  Forward only: the backward kernel is not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: kernel launches since the counter was last set to 0
launches = 0

MAX_HEAD_DIM = 63


def head_folded_attention_plain(q, k, v):
    """The same function in plain PyTorch (fp32 scores and softmax)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def launcher():
    """The C launcher: (q, k, v, out pointers, b*h, Lq, Lk, d, stream) ->
    cudaError_t."""
    return _build.function(
        "head_folded_attention", "head_folded_attention_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: the head-folded attention backward "
                "kernel is not ported yet (ROADMAP.md, next slice)")


def head_folded_attention(q, k, v):
    """Context (b, h, Lq, d) of softmax attention; q (b, h, Lq, d),
    k and v (b, h, Lk, d)."""
    if q.device.type == "cpu":
        return head_folded_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, lq, k.shape[2], d, stream)
    if err != 0:
        raise RuntimeError(
            f"head_folded_attention_fwd launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
