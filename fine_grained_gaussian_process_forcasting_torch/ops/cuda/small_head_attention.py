"""Softmax attention for head dims d <= 8 (fp32): CUDA kernels + plain.

Counterpart of the JAX package's ``ops/pallas/small_head_attention.py``
``small_head_attention``: softmax(q k^T / sqrt(d)) v over (b, h, L, d)
operands with d <= 8, Lq and Lk free, and its VJP.  The operands are taken
in fp32 and the context (and gradients) come back in the input dtype, as the
JAX op casts.

``small_head_attention`` launches ``csrc/small_head_attention.cu`` for CUDA
tensors and runs the plain version for CPU tensors; it never falls back from
one to the other.  On the card it is a ``torch.autograd.Function``: the
forward kernel also writes each row's log-sum-exp, and the backward
recomputes the probabilities from it, in one launch where a head's rows
fit on chip and in two past that (``bwd_launches_a_call``).  On the CPU,
the plain backward (term for term the Pallas ``_bwd_kernel``) is its VJP.

No model route reaches this op, in this package or in the JAX one: like the
Pallas kernel it replaces, only a caller of the op itself does.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build
from fine_grained_gaussian_process_forcasting_torch.ops.cuda.head_folded_attention import (
    fold_vmapped,
)

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward calls (one kernel launch each, or two past the fused route's
#: rows) since last set to 0
bwd_launches = 0

MAX_SMALL_D = 8


def small_head_attention_plain(q, k, v):
    """The forward in plain PyTorch, fp32, as the Pallas ``_fwd_kernel``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def small_head_attention_bwd_plain(q, k, v, do):
    """(dq, dk, dv) for the cotangent ``do``, term for term as the Pallas
    ``_bwd_kernel`` writes them: P recomputed, dv = P^T do, dP = do v^T,
    dS = P (dP - rowsum(dP P)), dq = dS k / sqrt(d), dk = dS^T q / sqrt(d)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(do, v.transpose(-1, -2))
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def launcher():
    """The C forward launcher: (q, k, v, out, lse pointers, b*h, Lq, Lk, d,
    stream) -> cudaError_t."""
    return _build.function(
        "small_head_attention", "small_head_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher: (q, k, v, o, lse, dout, dq, dk, dv, delta
    pointers, b*h, Lq, Lk, d, stream) -> cudaError_t."""
    return _build.function(
        "small_head_attention", "small_head_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bwd_launches_a_call(lq, d):
    """The backward's kernel launches for heads of ``lq`` rows at head dim
    ``d``, as the C entry chooses them: 1 (each exponential once) where the
    head's rows fit in shared memory, else 2."""
    return _build.function("small_head_attention",
                           "small_head_attention_bwd_launches",
                           [ctypes.c_int] * 2)(lq, d)


def kernels_launched():
    """The kernels the C entries have launched since the library was loaded,
    counted at each launch statement (the backward's route included)."""
    return _build.function("small_head_attention",
                           "small_head_attention_kernels_launched", [],
                           ctypes.c_ulonglong)()


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, h, L, d)")
    b, h, _, d = q.shape
    lk = k.shape[2]
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_SMALL_D:
        raise ValueError(f"head dim {d} is outside small_head_attention's "
                         f"1..{MAX_SMALL_D}; use flash or head-folded "
                         "attention for larger head dims")


def _check_kernel_operands(q, k, v):
    if k.shape[2] == 0:
        raise ValueError("no keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes, as the
    kernels' vector loads take them."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v):
    """Launch the forward kernel on checked fp32 operands: (out, lse)."""
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    err = launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b * h, lq, k.shape[2], d, _stream(q))
    if err != 0:
        raise RuntimeError(
            f"small_head_attention_fwd launch failed: cudaError {err}")
    global launches
    launches += 1
    return out, lse


def backward_kernel(q, k, v, out, lse, do):
    """Launch the backward on checked fp32 operands: (dq, dk, dv).  The
    delta scratch is the streamed route's (``bwd_launches_a_call`` 2)."""
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
            f"small_head_attention_bwd launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _fold_rule(info, in_dims, q, k, v):
    """The vmap rule of both Functions: the vmapped axis (the seeds) folded
    into b, one call of ``small_head_attention`` on (S b, h, L, d), as
    head-folded attention's rule folds."""
    out = small_head_attention(*fold_vmapped(info, in_dims, q, k, v))
    return out.unflatten(0, (info.batch_size, -1))


class _SmallHeadAttention(torch.autograd.Function):
    """The kernels; returns the context and the forward's lse."""

    @staticmethod
    def forward(q, k, v):
        return forward_kernel(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        out, lse = output
        ctx.save_for_backward(*inputs, out, lse)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        return (_fold_rule(info, in_dims, q, k, v), None), (0, None)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _):
        q, k, v, out, lse = ctx.saved_tensors
        return backward_kernel(q, k, v, out, lse, _aligned(do.contiguous()))


class _SmallHeadAttentionPlain(torch.autograd.Function):
    """The CPU's op: the plain forward, with the plain backward as its VJP."""

    @staticmethod
    def forward(q, k, v):
        return small_head_attention_plain(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        return _fold_rule(info, in_dims, q, k, v), 0

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        return small_head_attention_bwd_plain(*ctx.saved_tensors, do)


def _kernel_operands(q, k, v):
    """fp32 operands as the kernels take them: contiguous, on 16 bytes,
    checked."""
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    _check_kernel_operands(q, k, v)
    return q, k, v


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel: the kernel on CUDA tensors, the plain version on CPU
# tensors (fp32 operands either way), the context's shape from
# ``register_fake``.  The served (no-gradient) path calls it.
@torch.library.custom_op("fgp_torch::small_head_attention_fwd",
                         mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v) -> Tensor")
def small_head_attention_fwd(q, k, v):
    return forward_kernel(*_kernel_operands(q, k, v))[0]


@small_head_attention_fwd.register_kernel("cpu")
def _(q, k, v):
    return small_head_attention_plain(q, k, v)


@small_head_attention_fwd.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)


def small_head_attention(q, k, v):
    """Context (b, h, Lq, d) of softmax attention for d <= 8; q (b, h, Lq, d),
    k and v (b, h, Lk, d).  Computed in fp32, returned in q's dtype.  Under
    ``torch.func.vmap`` the Functions' rule folds the seeds into b: one
    launch each way on the card, one plain call on the CPU."""
    _check_shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    dtype = q.dtype
    q, k, v = (t.float() for t in (q, k, v))
    if torch._C._are_functorch_transforms_active():
        out = (_SmallHeadAttentionPlain.apply(q, k, v)
               if q.device.type == "cpu"
               else _SmallHeadAttention.apply(q, k, v)[0])
    elif not (torch.is_grad_enabled()
              and any(t.requires_grad for t in (q, k, v))):
        out = small_head_attention_fwd(q, k, v)
    elif q.device.type == "cpu":
        out = _SmallHeadAttentionPlain.apply(q, k, v)
    else:
        out = _SmallHeadAttention.apply(*_kernel_operands(q, k, v))[0]
    return out.to(dtype)
