"""Fused whitened-GP marginals (affine; fp32 and bf16): CUDA kernels + plain.

Counterpart of the JAX package's ``ops/pallas/fused_gp.py``
``whitened_marginals_affine`` and ``whitened_marginals_affine_bf16``.  With W = L^-T diag(1 - s^2) L^-1 and
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

The non-affine ``whitened_marginals`` and ``whitened_marginals_bf16`` take
pre-scaled xs = x / lengthscale and return (K u, var): the affine function
at inv_ls = 1, mean_w = 0, mean_b = 0, so they run on the same kernels with
those inputs, add to the same launch counters, and return the gradients of
their five inputs.

``whitened_marginals_affine_bf16`` takes and returns the same fp32 tensors;
only the two products K W and K^T (dvar o K) round their inputs to bf16 and
sum in fp32, everything else stays fp32.  Its VJP is the Pallas kernel's own
rule (``E`` from the bf16 ``K W``, ``dW`` from rounded ``K`` and
``dvar o K``), not the derivative of the rounded forward, so on the CPU too
it is a ``torch.autograd.Function``, over the plain forward and the plain
backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward launches (one per backward call, four kernels) since last set to 0
bwd_launches = 0
#: the same two counts for the bf16 variant
bf16_launches = 0
bf16_bwd_launches = 0

_MAX_SMEM = 232_448  # bytes of shared memory one H100 block can use
# the kernels' shared-memory arithmetic (csrc/fused_gp.cu: TR, KT_STRIDE,
# WBUF, BK)
_TR, _KT_STRIDE, _WBUF, _BK = 64, 68, 2 * 16 * 256, 16
#: inducing points a block holds K^T for when all of M does not fit (a
#: multiple of the kernels' 256-column panel)
CHUNK = 512


class Layout(NamedTuple):
    """How the kernels split M: ``chunk`` inducing points of K^T in a
    block's shared memory (M padded to 16 when all of it fits, the single
    pass; else ``CHUNK``), and the bytes the forward and the backward's row
    launch need for it."""
    chunk: int
    fwd_smem: int
    bwd_smem: int


def layout(m: int) -> Layout:
    """The kernels' split of M inducing points, which the launchers take:
    one pass over all of M up to M 720, chunks of ``CHUNK`` beyond (the
    counterpart of the Pallas kernel's ``_row_layout``, which shrinks its
    row tile instead)."""
    def fwd(rows):
        return (rows * _KT_STRIDE + _WBUF) * 4

    def bwd(rows):
        return fwd(rows) + 3 * _TR * 4

    m_pad = -(-m // _BK) * _BK
    chunk = m_pad if bwd(m_pad) <= _MAX_SMEM else CHUNK
    return Layout(chunk, fwd(chunk), bwd(chunk))


def _round_bf16(t):
    """``t`` rounded to bf16, kept as fp32, so that a product of two such
    tensors is exact products summed in fp32, as the tensor cores do; the
    gradient passes through as if nothing was rounded."""
    return t + (t.bfloat16().float() - t).detach()


def _dot16(a, b, bf16):
    if bf16:
        a, b = _round_bf16(a), _round_bf16(b)
    return torch.matmul(a, b)


def whitened_marginals_affine_plain(x, zs, u, w, outputscale, inv_ls,
                                    mean_w, mean_b, bf16=False):
    """The same function in plain PyTorch, with the Pallas kernel's
    |xs|^2 + |zs|^2 - 2 xs.zs distance (no clamp).  ``bf16``: K and W are
    rounded to bf16 where they enter the K W product."""
    xs = x * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * torch.matmul(xs, zs.T))
    k = outputscale * torch.exp(-0.5 * d2)
    mean = torch.matmul(x, mean_w) + mean_b + torch.matmul(k, u)
    var = outputscale - (_dot16(k, w, bf16) * k).sum(-1)
    return mean, var


def whitened_marginals_affine_bf16_plain(*args):
    """The bf16 variant in plain PyTorch."""
    return whitened_marginals_affine_plain(*args, bf16=True)


def whitened_marginals_affine_bwd_plain(x, zs, u, w, outputscale, inv_ls,
                                        mean_w, mean_b, dmean, dvar,
                                        bf16=False):
    """The VJP in plain PyTorch, term for term as the Pallas ``_bwd_kernel``
    (affine) writes it, W taken as symmetric.  Returns the gradients of
    (x, zs, u, w, outputscale, inv_ls, mean_w, mean_b).  ``bf16``: the K W
    and K^T (dvar o K) products round their inputs to bf16."""
    b, n, d = x.shape
    xr = x.reshape(b * n, d)
    xs = xr * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * torch.matmul(xs, zs.T))
    k = outputscale * torch.exp(-0.5 * d2)
    g = _dot16(k, w, bf16)
    dm = dmean.reshape(-1, 1)
    dv = dvar.reshape(-1, 1)
    e = (dm * u - 2.0 * dv * g) * k
    dxsc = torch.matmul(e, zs) - e.sum(-1, keepdim=True) * xs
    dx = dxsc * inv_ls + dm * mean_w
    dzs = torch.matmul(e.T, xs) - e.sum(0)[:, None] * zs
    du = (k * dm).sum(0)
    dw = -_dot16(k.T, dv * k, bf16)
    dos = e.sum() / outputscale + dv.sum()
    dinv_ls = (dxsc * xr).sum(0)
    dmean_w = (dm * xr).sum(0)
    dmean_b = dm.sum()
    return (dx.reshape(b, n, d), dzs, du, dw, dos, dinv_ls, dmean_w,
            dmean_b)


def whitened_marginals_affine_bf16_bwd_plain(*args):
    """The bf16 variant's VJP in plain PyTorch."""
    return whitened_marginals_affine_bwd_plain(*args, bf16=True)


def _affine_args(xs, zs, u, w, outputscale):
    """The non-affine variants' inputs as the affine kernel's: inv_ls 1,
    mean_w 0, mean_b 0."""
    d = xs.shape[-1]
    return (xs, zs, u, w, outputscale,
            torch.ones(d, device=xs.device, dtype=xs.dtype),
            torch.zeros(d, device=xs.device, dtype=xs.dtype),
            torch.zeros((), device=xs.device, dtype=xs.dtype))


def whitened_marginals_plain(xs, zs, u, w, outputscale, bf16=False):
    """The non-affine function in plain PyTorch: (K u, var) at pre-scaled
    xs."""
    return whitened_marginals_affine_plain(
        *_affine_args(xs, zs, u, w, outputscale), bf16=bf16)


def whitened_marginals_bf16_plain(*args):
    """The non-affine bf16 variant in plain PyTorch."""
    return whitened_marginals_plain(*args, bf16=True)


def whitened_marginals_bwd_plain(xs, zs, u, w, outputscale, dmean, dvar,
                                 bf16=False):
    """The non-affine VJP in plain PyTorch: the gradients of (xs, zs, u, w,
    outputscale)."""
    return whitened_marginals_affine_bwd_plain(
        *_affine_args(xs, zs, u, w, outputscale), dmean, dvar,
        bf16=bf16)[:5]


def whitened_marginals_bf16_bwd_plain(*args):
    """The non-affine bf16 variant's VJP in plain PyTorch."""
    return whitened_marginals_bwd_plain(*args, bf16=True)


def launcher(bf16=False):
    """The C launcher: (x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var
    pointers, R, d, M, layout(M).chunk, stream) -> cudaError_t.  ``bf16``:
    the bf16 variant's, which takes ``bf16_wt(w)`` in the place of w."""
    return _build.function(
        "fused_gp", "fused_gp_bf16_fwd" if bf16 else "fused_gp_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bwd_launcher(bf16=False):
    """The C backward launcher: (x, zs, u, w, os, inv_ls, mean_w, dmean,
    dvar, dx, dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b, scratch
    pointers, R, d, M, layout(M).chunk, stream) -> cudaError_t.  ``bf16`` as
    ``launcher``."""
    return _build.function(
        "fused_gp", "fused_gp_bf16_bwd" if bf16 else "fused_gp_bwd",
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bf16_wt(w):
    """W^T in bf16, zero-padded to the shape the bf16 kernels read: the
    cast that the bf16 variant makes once per call."""
    m = w.shape[0]
    rows, cols = (_build.function("fused_gp", name, [ctypes.c_int])(m)
                  for name in ("fused_gp_bf16_wt_rows",
                               "fused_gp_bf16_wt_cols"))
    wt = torch.zeros((rows, cols), device=w.device, dtype=torch.bfloat16)
    wt[:m, :m] = w.T
    return wt


def bwd_scratch_floats(r: int, d: int, m: int, bf16=False) -> int:
    """Floats of device scratch one backward call needs at R rows."""
    symbol = ("fused_gp_bf16_bwd_scratch_floats" if bf16
              else "fused_gp_bwd_scratch_floats")
    return _build.function("fused_gp", symbol, [ctypes.c_int] * 3,
                           ctypes.c_longlong)(r, d, m)


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
    return _marginals((x, zs, u, w, outputscale, inv_ls, mean_w, mean_b),
                      bf16=False)


def whitened_marginals_affine_bf16(x, zs, u, w, outputscale, inv_ls, mean_w,
                                   mean_b):
    """The same with the K W product (and, in the VJP, K^T (dvar o K)) on
    bf16-rounded inputs summed in fp32; fp32 tensors in and out."""
    return _marginals((x, zs, u, w, outputscale, inv_ls, mean_w, mean_b),
                      bf16=True)


def whitened_marginals(xs, zs, u, w, outputscale):
    """(K u, var), each (B, N), at pre-scaled xs (B, N, d) = x / lengthscale;
    zs, u, w and outputscale as for ``whitened_marginals_affine``."""
    return _marginals((xs, zs, u, w, outputscale), bf16=False)


def whitened_marginals_bf16(xs, zs, u, w, outputscale):
    """The non-affine function with the bf16 variant's two products."""
    return _marginals((xs, zs, u, w, outputscale), bf16=True)


def _full(args):
    """The affine kernel's eight inputs, from eight or from the non-affine
    variants' five."""
    return args if len(args) == 8 else _affine_args(*args)


def _marginals(args, bf16):
    x = args[0]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x.device.type == "cpu":
        if bf16 and grad:  # the bf16 VJP is the kernel's own rule
            return _WhitenedMarginals.apply(bf16, *args)
        return whitened_marginals_affine_plain(*_full(args), bf16=bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(*_full(args))
    if grad:
        return _WhitenedMarginals.apply(bf16, *args)
    return forward_kernel(*_full(args), bf16=bf16)


def forward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b,
                   bf16=False):
    """Launch the forward kernel on checked inputs: (mean, var)."""
    global launches, bf16_launches
    b, n, d = x.shape
    m = zs.shape[0]
    mean = torch.empty((b, n), device=x.device, dtype=torch.float32)
    var = torch.empty((b, n), device=x.device, dtype=torch.float32)
    w_in = bf16_wt(w) if bf16 else w
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launcher(bf16)(
        x.data_ptr(), zs.data_ptr(), u.data_ptr(), w_in.data_ptr(),
        outputscale.data_ptr(), inv_ls.data_ptr(), mean_w.data_ptr(),
        mean_b.data_ptr(), mean.data_ptr(), var.data_ptr(), b * n, d, m,
        layout(m).chunk, stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_fwd launch failed: cudaError {err}")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return mean, var


def backward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean,
                    dvar, bf16=False):
    """Launch the backward kernels on checked inputs and contiguous (B, N)
    cotangents: the gradients of the eight inputs."""
    global bwd_launches, bf16_bwd_launches
    b, n, d = x.shape
    m = zs.shape[0]

    def new(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    grads = (new(b, n, d), new(m, d), new(m), new(m, m), new(), new(d),
             new(d), new())
    scratch = new(bwd_scratch_floats(b * n, d, m, bf16))
    w_in = bf16_wt(w) if bf16 else w
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = bwd_launcher(bf16)(
        *(t.data_ptr() for t in (x, zs, u, w_in, outputscale, inv_ls, mean_w,
                                 dmean, dvar)),
        *(t.data_ptr() for t in grads), scratch.data_ptr(), b * n, d, m,
        layout(m).chunk, stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_bwd launch failed: cudaError {err}")
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return grads


class _WhitenedMarginals(torch.autograd.Function):
    """The kernels on the card; on the CPU (the bf16 variants only) the plain
    forward and the plain VJP.  Five inputs: the non-affine variant, run as
    the affine function at inv_ls 1, mean_w 0, mean_b 0."""

    @staticmethod
    def forward(ctx, bf16, *args):
        ctx.bf16 = bf16
        ctx.save_for_backward(*args)
        if args[0].device.type == "cpu":
            return whitened_marginals_affine_plain(*_full(args), bf16=bf16)
        return forward_kernel(*_full(args), bf16=bf16)

    @staticmethod
    @once_differentiable
    def backward(ctx, dmean, dvar):
        args = ctx.saved_tensors
        # autograd materialises an unused output's cotangent as zeros
        full = (*_full(args), dmean.contiguous(), dvar.contiguous())
        if dmean.device.type == "cpu":
            grads = whitened_marginals_affine_bwd_plain(*full, bf16=ctx.bf16)
        else:
            grads = backward_kernel(*full, bf16=ctx.bf16)
        return (None, *grads[:len(args)])
