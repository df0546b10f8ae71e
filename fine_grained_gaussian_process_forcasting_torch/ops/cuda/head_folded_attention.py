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

Like the TPU kernel, which took its operands as (b, L, h d), the kernels
read the projections' own layout: q, k and v may be any (b, h, L, d) views
whose head dim has unit stride (the transposed (b, L, h, d) buffers of the
transformer), and the outputs (the context; dq, dk and dv) are fresh
(b, h, L, d) tensors laid out as (b, L, h, d) memory (``folded_empty``), so
that the way back into (b, L, h d) rows is a view as well.

Under ``torch.func.vmap`` (the seeds of a multi-seed model) the vmapped
axis folds into b: the Function's ``vmap`` rule calls the kernel once on
(S b, h, L, d), a view of the same buffers wherever the seed's stride is b
times the batch's (the projections' own layout), and unfolds the context.
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

# The backward's fused route (one launch, each exponential once) holds a
# head's query rows (q, dO, lse, D and the warps' dQ partials) and its
# keys' dK and dV in shared memory: at padded head dims up to 16 and up to
# 256 rows; longer heads and wider head dims take the streamed route (two
# launches), and so do heads that need more than the card's 227 KB.  A
# warp owns 32 x keys-a-lane keys of a head, at most MAX_WARPS_A_HEAD warps
# a head (they loop over the rest), at most _MAX_WARPS warps a block;
# heads are grouped into a block while their shared memory stays within
# _SMEM_TARGET (two blocks an SM).
FUSED_MAX_ROWS = 256
FUSED_MAX_DP = 16
MAX_WARPS_A_HEAD = 4
_KEYS_A_LANE = {4: 3, 8: 2, 16: 1}
_MAX_WARPS = {4: 16, 8: 8, 16: 8}
_SMEM_TARGET = 80 * 1024
_SMEM_MAX = 227 * 1024


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


def padded_head_dim(d: int) -> int:
    """The kernels' compile-time head dim for d: 4, 8, 16, 32 or 64."""
    return next(dp for dp in (4, 8, 16, 32, 64) if d <= dp)


def fused_smem_bytes(hb: int, wph: int, lq: int, lk: int, d: int) -> int:
    """Shared memory of the fused backward's block: q, dO, (lse, D) and the
    warps' dQ partials of every row, dK and dV of every key."""
    dp = padded_head_dim(d)
    rq = 32 // dp
    rows = -(-lq // rq) * rq
    return 4 * hb * (rows * (2 * dp + 2 + wph * dp) + 2 * lk * dp)


def bwd_plan(h: int, lq: int, lk: int, d: int) -> tuple[int, int]:
    """(heads a block, warps a head) of the backward's fused route, or
    (0, 0) for the streamed route."""
    dp = padded_head_dim(d)
    if dp > FUSED_MAX_DP or lq > FUSED_MAX_ROWS:
        return 0, 0
    wph = min(-(-lk // (32 * _KEYS_A_LANE[dp])), MAX_WARPS_A_HEAD)
    if fused_smem_bytes(1, wph, lq, lk, d) > _SMEM_MAX:
        return 0, 0
    for hb in (8, 4, 2):
        if (hb <= h and hb * wph <= _MAX_WARPS[dp]
                and fused_smem_bytes(hb, wph, lq, lk, d) <= _SMEM_TARGET):
            return hb, wph
    return 1, wph


def folded_empty(b: int, h: int, length: int, d: int, device):
    """An uninitialised fp32 (b, h, L, d) tensor laid out as (b, L, h, d)
    memory (the transpose of a contiguous (b, L, h, d) tensor)."""
    return torch.empty_strided((b, h, length, d),
                               (length * h * d, d, h * d, 1), device=device,
                               dtype=torch.float32)


def launch_strides(*tensors):
    """The (b, h, L) element strides of each (b, h, L, d) tensor, as the C
    entry points take them."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def launcher():
    """The C forward launcher: (q, k, v, out, lse-or-null pointers, the
    (b, h, L) strides of q, k, v and out, b, h, Lq, Lk, d, stream) ->
    cudaError_t."""
    return _build.function(
        "head_folded_attention", "head_folded_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher: (q, k, v, o, lse, dout, dq, dk, dv,
    delta-or-null pointers, the (b, h, L) strides of q, k, v, o, dout, dq,
    dk and dv, b, h, Lq, Lk, d, heads a block, warps a head (``bwd_plan``),
    stream) -> cudaError_t."""
    return _build.function(
        "head_folded_attention", "head_folded_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _unit_head_stride(t) -> bool:
    return t.shape[-1] == 1 or t.stride(-1) == 1


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
        if not _unit_head_stride(t):
            raise ValueError(f"{name} must have unit stride in its head "
                             f"dim, got strides {t.stride()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v, with_lse: bool):
    """Launch the forward kernel: (out, lse or None), out a (b, h, Lq, d)
    view of (b, Lq, h, d) memory.  The inputs are checked by the caller."""
    b, h, lq, d = q.shape
    out = folded_empty(b, h, lq, d, q.device)
    lse = (torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    err = launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     launch_strides(q, k, v, out), b, h, lq, k.shape[2], d,
                     _stream(q))
    if err != 0:
        raise RuntimeError(
            f"head_folded_attention_fwd launch failed: cudaError {err}")
    global launches
    launches += 1
    return out, lse


def backward_kernel(q, k, v, out, lse, do):
    """Launch the backward kernel: (dq, dk, dv), (b, h, L, d) views of
    (b, L, h, d) memory.  ``do`` must have unit stride in its head dim."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq = folded_empty(b, h, lq, d, q.device)
    dk = folded_empty(b, h, lk, d, q.device)
    dv = folded_empty(b, h, lk, d, q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    hb, wph = bwd_plan(h, lq, lk, d)
    delta = (torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
             if hb == 0 else None)
    err = bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if delta is None else delta.data_ptr(),
        launch_strides(q, k, v, out, do, dq, dk, dv), b, h, lq, lk, d, hb, wph,
        _stream(q))
    if err != 0:
        raise RuntimeError(
            f"head_folded_attention_bwd launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def fold_vmapped(info, in_dims, *ts):
    """The vmapped axis of each (b, h, L, d) operand folded into b: (S b, h,
    L, d), a view where the strides allow it (an operand the vmap does not
    batch is repeated S times)."""
    folded = []
    for t, dim in zip(ts, in_dims):
        t = (t.movedim(dim, 0) if dim is not None
             else t.expand(info.batch_size, *t.shape))
        folded.append(t.flatten(0, 1))
    return folded


class _HeadFoldedAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v):
        return forward_kernel(q, k, v, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        out, lse = output
        ctx.save_for_backward(*inputs, out, lse)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        out = head_folded_attention(*fold_vmapped(info, in_dims, q, k, v))
        return (out.unflatten(0, (info.batch_size, -1)), None), (0, None)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _):
        q, k, v, out, lse = ctx.saved_tensors
        if not _unit_head_stride(do):
            do = do.contiguous()
        return backward_kernel(q, k, v, out, lse, do)


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel: the kernel on CUDA tensors, the plain version on CPU
# tensors, the context's shape and strides from ``register_fake``.  The
# served (no-gradient) path calls it.
@torch.library.custom_op("fgp_torch::head_folded_attention_fwd",
                         mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v) -> Tensor")
def head_folded_attention_fwd(q, k, v):
    _check(q, k, v)
    return forward_kernel(q, k, v, with_lse=False)[0]


@head_folded_attention_fwd.register_kernel("cpu")
def _(q, k, v):
    return head_folded_attention_plain(q, k, v)


@head_folded_attention_fwd.register_fake
def _(q, k, v):
    b, h, lq, d = q.shape
    if q.device.type == "cuda":
        return folded_empty(b, h, lq, d, q.device)
    return q.new_empty((b, h, lq, d))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def head_folded_attention(q, k, v):
    """Context (b, h, Lq, d) of softmax attention; q (b, h, Lq, d), k and v
    (b, h, Lk, d).  On the card the inputs may be any views with a unit
    stride on d, and the context is laid out as (b, Lq, h, d) memory."""
    if q.device.type == "cpu":
        if (torch._C._are_functorch_transforms_active()
                or _needs_grad(q, k, v)):
            return head_folded_attention_plain(q, k, v)
        return head_folded_attention_fwd(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch._C._are_functorch_transforms_active():
        return _HeadFoldedAttention.apply(q, k, v)[0]  # its vmap rule folds
    if _needs_grad(q, k, v):
        _check(q, k, v)
        return _HeadFoldedAttention.apply(q, k, v)[0]
    return head_folded_attention_fwd(q, k, v)
