"""Batched lower Cholesky factorization (fp32): CUDA kernel + plain.

Counterpart of the JAX package's ``ops/pallas/cholesky.py``
``batched_cholesky``: the lower factor L of each SPD matrix of a (..., n, n)
batch, zeros above the diagonal.  A matrix that is not positive definite
gives NaN, never an exception (the Pallas recurrence takes the square root
of a negative pivot; ``jnp.linalg.cholesky`` NaN-fills), which the exact
blur's psd-safe jitter probe relies on.

The JAX op's pullback is plain XLA (``cholesky.py:177-191``); here it is the
same formula in plain PyTorch, P = phi(L^T dL) (lower triangle, halved
diagonal), dA = 1/2 L^-T (P + P^T) L^-1, by two triangular solves.  So the
op is a ``torch.autograd.Function`` on both devices: its forward launches
``csrc/cholesky.cu`` for CUDA tensors and runs the plain forward for CPU
tensors, never falling back from one to the other.  Only the symmetric part
of dA is defined (A is read in its lower triangle).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: kernel launches since the counter was last set to 0
launches = 0

_MAX_N = 46340  # the kernel indexes n^2 in 32 bits


def batched_cholesky_plain(a):
    """The library's factorization (LAPACK on the CPU, cuSOLVER on the
    card), ``torch.linalg.cholesky_ex``, NaN-filled where it failed, as
    ``jnp.linalg.cholesky`` returns; differentiable by torch's autograd."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol, float("nan"))


def batched_cholesky_bwd_plain(chol, dchol):
    """dA of ``batched_cholesky`` for the cotangent dL, as
    ``cholesky.py:177-191`` computes it."""
    p = torch.matmul(chol.transpose(-1, -2), dchol)
    p = torch.tril(p) - 0.5 * torch.diag_embed(
        torch.diagonal(p, dim1=-2, dim2=-1))
    s = p + p.transpose(-1, -2)
    tmp = torch.linalg.solve_triangular(chol.transpose(-1, -2), s,
                                        upper=True)  # L^-T S
    return 0.5 * torch.linalg.solve_triangular(chol, tmp, upper=False,
                                               left=False)  # (L^-T S) L^-1


def launcher():
    """The C launcher: (a, out pointers, batch, n, stream) -> cudaError_t."""
    return _build.function("cholesky", "batched_cholesky_fwd",
                           [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])


def _check(a):
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"a must be (..., n, n), got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if not 1 <= a.shape[-1] <= _MAX_N:
        raise ValueError(f"n = {a.shape[-1]} is outside the kernel's "
                         f"1..{_MAX_N}")


def forward_kernel(a):
    """Launch the kernel on a checked input: L."""
    global launches
    n = a.shape[-1]
    out = torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch == 0:
        return out
    err = launcher()(a.data_ptr(), out.data_ptr(), batch, n,
                     torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"batched_cholesky_fwd launch failed: cudaError {err}")
    launches += 1
    return out


class _BatchedCholesky(torch.autograd.Function):
    """The kernel (card) or the plain forward (CPU); the plain pullback.
    Under ``torch.func.vmap`` its rule folds the vmapped axis into the
    batch and makes one call."""

    @staticmethod
    def forward(a):
        if a.device.type == "cpu":
            return batched_cholesky_plain(a)
        return forward_kernel(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def vmap(info, in_dims, a):
        """The vmapped axis (the seeds) folded into the leading batch dims:
        (S, ..., n, n) factored as one batch, one call.  Each matrix is
        factored alone, so each seed's factor (NaN where its matrix is not
        positive definite) is the one a call of that seed gives."""
        (dim,) = in_dims
        a = a.movedim(dim, 0) if dim is not None else a.expand(
            info.batch_size, *a.shape)
        return batched_cholesky(a.contiguous()), 0

    @staticmethod
    @once_differentiable
    def backward(ctx, dchol):
        (chol,) = ctx.saved_tensors
        return batched_cholesky_bwd_plain(chol, dchol)


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel: the kernel on CUDA tensors, the library's factorization on
# CPU tensors, L's shape from ``register_fake``.  The served (no-gradient)
# path calls it.
@torch.library.custom_op("fgp_torch::batched_cholesky_fwd", mutates_args=(),
                         device_types="cuda", schema="(Tensor a) -> Tensor")
def batched_cholesky_fwd(a):
    _check(a)
    return forward_kernel(a)


@batched_cholesky_fwd.register_kernel("cpu")
def _(a):
    # LAPACK's factor is column-major; the op's output is row-major, as the
    # kernel's
    return batched_cholesky_plain(a).contiguous()


@batched_cholesky_fwd.register_fake
def _(a):
    return a.new_empty(a.shape)


def batched_cholesky(a):
    """Lower Cholesky factors of (..., n, n) SPD matrices; NaN where a
    matrix is not positive definite.  Under ``torch.func.vmap`` on the card
    the Function's rule folds the seeds into the batch (one launch); CPU
    tensors take the plain version, which vmap batches itself."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if torch._C._are_functorch_transforms_active():
        if a.device.type == "cpu":
            return batched_cholesky_plain(a)
        return _BatchedCholesky.apply(a)  # its vmap rule folds
    if not (torch.is_grad_enabled() and a.requires_grad):
        return batched_cholesky_fwd(a)
    if a.device.type == "cuda":
        _check(a)
    return _BatchedCholesky.apply(a)
