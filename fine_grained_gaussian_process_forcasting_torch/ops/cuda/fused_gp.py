"""Fused whitened-GP marginals (affine, fp32): CUDA kernels + plain.

Counterpart of the JAX package's ``ops/pallas/fused_gp.py``
``whitened_marginals_affine``.  With W = L^-T diag(1 - s^2) L^-1 and
u = L^-T m, the whitened variational marginals at RAW inputs x are

    K[r, m] = os * exp(-0.5 * |x[r] * inv_ls - zs[m]|^2)
    mean[r] = x[r] . mean_w + mean_b + K[r] . u
    var[r]  = os - K[r] . (K W)[r]

``whitened_marginals_affine`` launches ``csrc/fused_gp.cu`` for CUDA tensors
and runs the plain version for CPU tensors; it never falls back from one to
the other.  On the card it is a ``torch.autograd.Function`` whose backward
launches the backward kernels of the same source and returns a gradient for
each of the eight inputs; on the CPU, torch's autograd differentiates the
plain forward.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward launches (one per backward call, four kernels) since last set to 0
bwd_launches = 0

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


def whitened_marginals_affine_bwd_plain(x, zs, u, w, outputscale, inv_ls,
                                        mean_w, mean_b, dmean, dvar):
    """The VJP in plain PyTorch, term for term as the Pallas ``_bwd_kernel``
    (affine) writes it, W taken as symmetric.  Returns the gradients of
    (x, zs, u, w, outputscale, inv_ls, mean_w, mean_b)."""
    b, n, d = x.shape
    xr = x.reshape(b * n, d)
    xs = xr * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * torch.matmul(xs, zs.T))
    k = outputscale * torch.exp(-0.5 * d2)
    g = torch.matmul(k, w)
    dm = dmean.reshape(-1, 1)
    dv = dvar.reshape(-1, 1)
    e = (dm * u - 2.0 * dv * g) * k
    dxsc = torch.matmul(e, zs) - e.sum(-1, keepdim=True) * xs
    dx = dxsc * inv_ls + dm * mean_w
    dzs = torch.matmul(e.T, xs) - e.sum(0)[:, None] * zs
    du = (k * dm).sum(0)
    dw = -torch.matmul(k.T, dv * k)
    dos = e.sum() / outputscale + dv.sum()
    dinv_ls = (dxsc * xr).sum(0)
    dmean_w = (dm * xr).sum(0)
    dmean_b = dm.sum()
    return (dx.reshape(b, n, d), dzs, du, dw, dos, dinv_ls, dmean_w,
            dmean_b)


def launcher():
    """The C launcher: (x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var
    pointers, R, d, M, stream) -> cudaError_t."""
    return _build.function(
        "fused_gp", "fused_gp_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher: (x, zs, u, w, os, inv_ls, mean_w, dmean,
    dvar, dx, dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b, scratch
    pointers, R, d, M, stream) -> cudaError_t."""
    return _build.function(
        "fused_gp", "fused_gp_bwd",
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _smem_bytes(d: int, m: int, symbol="fused_gp_fwd_smem_bytes") -> int:
    return _build.function("fused_gp", symbol, [ctypes.c_int, ctypes.c_int],
                           ctypes.c_longlong)(d, m)


def bwd_scratch_floats(r: int, d: int, m: int) -> int:
    """Floats of device scratch one backward call needs at R rows."""
    return _build.function("fused_gp", "fused_gp_bwd_scratch_floats",
                           [ctypes.c_int] * 3, ctypes.c_longlong)(r, d, m)


def _check_smem(d: int, m: int, symbol: str):
    smem = _smem_bytes(d, m, symbol)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{symbol[:-11]} kernel needs {smem} bytes of shared memory at "
            f"d={d}, M={m}; a block has {_MAX_SMEM}")


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
    args = (x, zs, u, w, outputscale, inv_ls, mean_w, mean_b)
    _check(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WhitenedMarginalsAffine.apply(*args)
    return forward_kernel(*args)


def forward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b):
    """Launch the forward kernel on checked inputs: (mean, var)."""
    b, n, d = x.shape
    m = zs.shape[0]
    _check_smem(d, m, "fused_gp_fwd_smem_bytes")
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


def backward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean,
                    dvar):
    """Launch the backward kernels on checked inputs and contiguous (B, N)
    cotangents: the gradients of the eight inputs."""
    b, n, d = x.shape
    m = zs.shape[0]
    _check_smem(d, m, "fused_gp_bwd_smem_bytes")

    def new(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    grads = (new(b, n, d), new(m, d), new(m), new(m, m), new(), new(d),
             new(d), new())
    scratch = new(bwd_scratch_floats(b * n, d, m))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = bwd_launcher()(
        *(t.data_ptr() for t in (x, zs, u, w, outputscale, inv_ls, mean_w,
                                 dmean, dvar)),
        *(t.data_ptr() for t in grads), scratch.data_ptr(), b * n, d, m,
        stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_bwd launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return grads


class _WhitenedMarginalsAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return forward_kernel(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, dmean, dvar):
        # autograd materialises an unused output's cotangent as zeros
        return backward_kernel(*ctx.saved_tensors, dmean.contiguous(),
                               dvar.contiguous())
