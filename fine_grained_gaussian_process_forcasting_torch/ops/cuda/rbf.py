"""RBF cross-covariance (fp32): CUDA kernel + plain.

Counterpart of the JAX package's ``ops/pallas/rbf.py`` ``rbf_cross_kernel``:

    K = outputscale * exp(-0.5 * max(0, |x~|^2 + |z~|^2 - 2 x~.z~)),
    x~ = x / lengthscale,  z~ = z / lengthscale,

for raw points x (..., N, d) and inducing points z (M, d) with lengthscale
(d,) and outputscale () -> (..., N, M); or, in one call, for the h GPs of a
deep GP's hidden layer over the same x: z (h, M, d), lengthscale (h, d),
outputscale (h,) -> (h, ..., N, M), which the JAX layer gets by vmapping
the op.

On the card one launch of ``csrc/rbf.cu`` computes the h GPs' K: a kernel
bound by its stores (K is written once, as whole 128-byte lines), whose
fp32 cross products on the CUDA cores and exponentials run while the stores
drain; each block stages and scales its rows of x once and walks all of M.

The JAX op's VJP is plain XLA over the saved K (``rbf.py:92-113``); here it
is the same closed form in plain PyTorch.  So the op is a
``torch.autograd.Function`` on both devices: its forward launches
``csrc/rbf.cu`` for CUDA tensors and runs the plain forward for CPU
tensors, never falling back from one to the other, and its backward is
``rbf_cross_kernel_bwd_plain``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: kernel launches since the counter was last set to 0
launches = 0


def _gps(z, lengthscale, outputscale):
    """The parameters with a leading GP axis: (h, M, d), (h, d), (h,)."""
    if z.dim() == 3:
        return z, lengthscale, outputscale
    return z[None], lengthscale[None], outputscale.reshape(1)


def _out_shape(x, z):
    lead = (z.shape[0],) if z.dim() == 3 else ()
    return lead + tuple(x.shape[:-1]) + (z.shape[-2],)


def rbf_cross_kernel_plain(x, z, lengthscale, outputscale):
    """The same function in plain PyTorch, as the Pallas body computes it."""
    zg, lsg, osg = _gps(z, lengthscale, outputscale)
    xs = x.reshape(-1, x.shape[-1])[None] / lsg[:, None, :]  # (h, R, d)
    zs = zg / lsg[:, None, :]
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)[:, None, :]
          - 2.0 * torch.matmul(xs, zs.transpose(-1, -2)))
    k = osg[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    return k.reshape(_out_shape(x, z))


def rbf_cross_kernel_bwd_plain(x, z, lengthscale, outputscale, k, g):
    """Gradients of (x, z, lengthscale, outputscale) from the saved K and
    its cotangent g, the closed form of ``rbf.py:92-113`` (with gK = g K,
    x~ = x / l):  dx~ = gK z~ - rowsum(gK) x~,  dz~ = gK^T x~ - colsum(gK)
    z~,  dos = sum(gK) / os,  dl = -(dx~ . x + dz~ . z) / l^2.  For h GPs
    the gradient of the shared x is summed over them, as under JAX's vmap."""
    zg, lsg, osg = _gps(z, lengthscale, outputscale)
    h, m, d = zg.shape
    xr = x.reshape(-1, d)
    xs = xr[None] / lsg[:, None, :]
    zs = zg / lsg[:, None, :]
    gk = (g * k).reshape(h, -1, m)
    gxs = torch.matmul(gk, zs) - gk.sum(-1, keepdim=True) * xs
    gzs = (torch.matmul(gk.transpose(-1, -2), xs)
           - gk.sum(-2)[..., None] * zs)
    gos = gk.sum((-1, -2)) / osg
    gx = (gxs / lsg[:, None, :]).sum(0).reshape(x.shape)
    gz = gzs / lsg[:, None, :]
    gl = -((gxs * xr).sum(-2) + (gzs * zg).sum(-2)) / lsg ** 2
    if z.dim() == 2:
        gz, gl, gos = gz[0], gl[0], gos.reshape(())
    return gx, gz, gl, gos


def launcher():
    """The C launcher: (x, z, ls, os, out pointers, R, M, d, G, stream) ->
    cudaError_t."""
    return _build.function(
        "rbf", "rbf_cross_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(x, z, lengthscale, outputscale):
    if x.dim() < 2:
        raise ValueError(f"x must be (..., N, d), got {tuple(x.shape)}")
    d = x.shape[-1]
    if z.dim() == 2:
        want = {"z": (z, (z.shape[0], d)), "lengthscale": (lengthscale, (d,)),
                "outputscale": (outputscale, ())}
    elif z.dim() == 3:
        h = z.shape[0]
        want = {"z": (z, (h, z.shape[1], d)),
                "lengthscale": (lengthscale, (h, d)),
                "outputscale": (outputscale, (h,))}
    else:
        raise ValueError(f"z must be (M, d) or (h, M, d), got "
                         f"{tuple(z.shape)}")
    want["x"] = (x, tuple(x.shape))
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() == 0 or z.numel() == 0:
        raise ValueError("x and z must not be empty")


def forward_kernel(x, z, lengthscale, outputscale):
    """Launch the kernel on checked inputs: K, in the op's output shape."""
    global launches
    zg = _gps(z, lengthscale, outputscale)[0]
    h, m, d = zg.shape
    r = x.numel() // d
    out = torch.empty((h, r, m), device=x.device, dtype=torch.float32)
    err = launcher()(
        x.data_ptr(), z.data_ptr(), lengthscale.data_ptr(),
        outputscale.data_ptr(), out.data_ptr(), r, m, d, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rbf_cross_fwd launch failed: cudaError {err}")
    launches += 1
    return out.reshape(_out_shape(x, z))


class _RbfCrossKernel(torch.autograd.Function):
    """The kernel (card) or the plain forward (CPU); the plain VJP."""

    @staticmethod
    def forward(ctx, x, z, lengthscale, outputscale):
        if x.device.type == "cpu":
            k = rbf_cross_kernel_plain(x, z, lengthscale, outputscale)
        else:
            k = forward_kernel(x, z, lengthscale, outputscale)
        ctx.save_for_backward(x, z, lengthscale, outputscale, k)
        return k

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return rbf_cross_kernel_bwd_plain(*ctx.saved_tensors, g)


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel: the kernel on CUDA tensors, the plain version on CPU
# tensors, K's shape from ``register_fake``.  The served (no-gradient) path
# calls it.
@torch.library.custom_op(
    "fgp_torch::rbf_cross_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor z, Tensor lengthscale, Tensor outputscale) "
           "-> Tensor")
def rbf_cross_fwd(x, z, lengthscale, outputscale):
    _check(x, z, lengthscale, outputscale)
    return forward_kernel(x, z, lengthscale, outputscale)


@rbf_cross_fwd.register_kernel("cpu")
def _(x, z, lengthscale, outputscale):
    return rbf_cross_kernel_plain(x, z, lengthscale, outputscale)


@rbf_cross_fwd.register_fake
def _(x, z, lengthscale, outputscale):
    return x.new_empty(_out_shape(x, z))


def rbf_cross_kernel(x, z, lengthscale, outputscale):
    """K of one GP, (..., N, M), or of h GPs, (h, ..., N, M), at raw x.  Not
    under ``torch.func.vmap``: the h GPs' weights over a shared x would need
    a seed axis in the kernel (ROADMAP.md item 18)."""
    if torch._C._are_functorch_transforms_active():
        raise NotImplementedError(
            "rbf_cross_kernel has no seed axis yet (ROADMAP.md modules to "
            "port, item 18: the kernels' seed axes)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    args = (x, z, lengthscale, outputscale)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return rbf_cross_fwd(*args)
    if x.device.type == "cuda":
        _check(*args)
    return _RbfCrossKernel.apply(*args)
