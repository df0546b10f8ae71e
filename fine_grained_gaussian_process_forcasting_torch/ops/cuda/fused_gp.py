"""Fused whitened-GP marginals (affine, fp32 forward): CUDA kernel + plain.

Counterpart of the JAX package's ``ops/pallas/fused_gp.py``
``whitened_marginals_affine``.  With W = L^-T diag(1 - s^2) L^-1 and
u = L^-T m, the whitened variational marginals at RAW inputs x are

    K[r, m] = os * exp(-0.5 * |x[r] * inv_ls - zs[m]|^2)
    mean[r] = x[r] . mean_w + mean_b + K[r] . u
    var[r]  = os - K[r] . (K W)[r]

``whitened_marginals_affine`` launches ``csrc/fused_gp.cu`` for CUDA tensors
and runs the plain version for CPU tensors; it never falls back from one to
the other.  Forward only: the backward kernel is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: kernel launches since the counter was last set to 0
launches = 0

_MAX_SMEM = 232_448  # bytes of shared memory one H100 block can use


def whitened_marginals_affine_plain(x, zs, u, w, outputscale, inv_ls,
                                    mean_w, mean_b):
    """The same function in plain PyTorch, with the Pallas kernel's
    |xs|^2 + |zs|^2 - 2 xs.zs distance (no clamp)."""
    xs = x * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * torch.matmul(xs, zs.T))
    k = outputscale * torch.exp(-0.5 * d2)
    mean = torch.matmul(x, mean_w) + mean_b + torch.matmul(k, u)
    var = outputscale - (torch.matmul(k, w) * k).sum(-1)
    return mean, var


def launcher():
    """The C launcher: (x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var
    pointers, R, d, M, stream) -> cudaError_t."""
    return _build.function(
        "fused_gp", "fused_gp_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _smem_bytes(d: int, m: int) -> int:
    return _build.function("fused_gp", "fused_gp_fwd_smem_bytes",
                           [ctypes.c_int, ctypes.c_int],
                           ctypes.c_longlong)(d, m)


def _check(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, d), got {tuple(x.shape)}")
    d = x.shape[-1]
    m = zs.shape[0]
    want = {"x": (x, tuple(x.shape)), "zs": (zs, (m, d)), "u": (u, (m,)),
            "w": (w, (m, m)), "outputscale": (outputscale, ()),
            "inv_ls": (inv_ls, (d,)), "mean_w": (mean_w, (d,)),
            "mean_b": (mean_b, ())}
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: the fused-GP backward kernel is not "
                "ported yet (ROADMAP.md, next slice)")
    if x.numel() == 0:
        raise ValueError("x has no rows")


def whitened_marginals_affine(x, zs, u, w, outputscale, inv_ls, mean_w,
                              mean_b):
    """(mean, var), each (B, N), of the whitened variational GP at RAW x.

    x: (B, N, d); zs: (M, d) = Z / lengthscale; u: (M,) = L^-T m;
    w: (M, M) = L^-T diag(1 - s^2) L^-1; outputscale: 0-d;
    inv_ls: (d,) = 1 / lengthscale; mean_w: (d,); mean_b: 0-d.
    """
    if x.device.type == "cpu":
        return whitened_marginals_affine_plain(x, zs, u, w, outputscale,
                                               inv_ls, mean_w, mean_b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b)
    b, n, d = x.shape
    m = zs.shape[0]
    smem = _smem_bytes(d, m)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_gp kernel needs {smem} bytes of shared memory at d={d}, "
            f"M={m}; a block has {_MAX_SMEM}")
    mean = torch.empty((b, n), device=x.device, dtype=torch.float32)
    var = torch.empty((b, n), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launcher()(x.data_ptr(), zs.data_ptr(), u.data_ptr(), w.data_ptr(),
                outputscale.data_ptr(), inv_ls.data_ptr(), mean_w.data_ptr(),
                mean_b.data_ptr(), mean.data_ptr(), var.data_ptr(),
                b * n, d, m, stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_fwd launch failed: cudaError {err}")
    global launches
    launches += 1
    return mean, var
