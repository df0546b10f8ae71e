"""RBF cross-covariance (fp32): CUDA kernel + plain.

Counterpart of the JAX package's ``ops/pallas/rbf.py`` ``rbf_cross_kernel``:

    K = outputscale * exp(-0.5 * max(0, |x~|^2 + |z~|^2 - 2 x~.z~)),
    x~ = x / lengthscale,  z~ = z / lengthscale,

for raw points x (..., N, d) and inducing points z (M, d) with lengthscale
(d,) and outputscale () -> (..., N, M); or, in one call, for the h GPs of a
deep GP's hidden layer over the same x: z (h, M, d), lengthscale (h, d),
outputscale (h,) -> (h, ..., N, M), which the JAX layer gets by vmapping
the op.  Multi-seed training vmaps that layer once more, over S seeds with
their own x and GPs: x (S, ..., N, d), z (S, h, M, d), lengthscale (S, h,
d), outputscale (S, h) -> (S, h, ..., N, M), the Function's ``vmap`` rule
stacking the seeds on that axis.

On the card one launch of ``csrc/rbf.cu`` computes the h GPs' K (every
seed's, with the seed axis): a kernel
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
#: of them, launches with the seed axis (every seed's K in one launch)
seeds_launches = 0


def _seeded(x, z, lengthscale, outputscale):
    """The inputs with a leading seed axis and a GP axis: x (S, R, d), z
    (S, h, M, d), lengthscale (S, h, d), outputscale (S, h); S = 1 without
    the seed axis, h = 1 for one GP."""
    d = x.shape[-1]
    if z.dim() == 4:
        return (x.reshape(z.shape[0], -1, d), z, lengthscale, outputscale)
    if z.dim() == 2:
        z, lengthscale = z[None], lengthscale[None]
        outputscale = outputscale.reshape(1)
    return (x.reshape(1, -1, d), z[None], lengthscale[None],
            outputscale[None])


def _out_shape(x, z):
    if z.dim() == 4:
        return tuple(z.shape[:2]) + tuple(x.shape[1:-1]) + (z.shape[-2],)
    lead = (z.shape[0],) if z.dim() == 3 else ()
    return lead + tuple(x.shape[:-1]) + (z.shape[-2],)


def rbf_cross_kernel_plain(x, z, lengthscale, outputscale):
    """The same function in plain PyTorch, as the Pallas body computes it;
    with the seed axis too (x (S, ..., N, d), z (S, h, M, d), lengthscale
    (S, h, d), outputscale (S, h) -> (S, h, ..., N, M))."""
    xg, zg, lsg, osg = _seeded(x, z, lengthscale, outputscale)
    xs = xg[:, None] / lsg[:, :, None, :]  # (S, h, R, d)
    zs = zg / lsg[:, :, None, :]
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)[:, :, None, :]
          - 2.0 * torch.matmul(xs, zs.transpose(-1, -2)))
    k = osg[..., None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    return k.reshape(_out_shape(x, z))


def rbf_cross_kernel_bwd_plain(x, z, lengthscale, outputscale, k, g):
    """Gradients of (x, z, lengthscale, outputscale) from the saved K and
    its cotangent g, the closed form of ``rbf.py:92-113`` (with gK = g K,
    x~ = x / l):  dx~ = gK z~ - rowsum(gK) x~,  dz~ = gK^T x~ - colsum(gK)
    z~,  dos = sum(gK) / os,  dl = -(dx~ . x + dz~ . z) / l^2.  For h GPs
    the gradient of the shared x is summed over them, as under JAX's vmap;
    with the seed axis each seed's x takes its own GPs' sum, never another
    seed's."""
    xg, zg, lsg, osg = _seeded(x, z, lengthscale, outputscale)
    s, h, m, d = zg.shape
    xs = xg[:, None] / lsg[:, :, None, :]
    zs = zg / lsg[:, :, None, :]
    gk = (g * k).reshape(s, h, -1, m)
    gxs = torch.matmul(gk, zs) - gk.sum(-1, keepdim=True) * xs
    gzs = (torch.matmul(gk.transpose(-1, -2), xs)
           - gk.sum(-2)[..., None] * zs)
    gos = gk.sum((-1, -2)) / osg
    gx = (gxs / lsg[:, :, None, :]).sum(1).reshape(x.shape)
    gz = gzs / lsg[:, :, None, :]
    gl = -((gxs * xg[:, None]).sum(-2) + (gzs * zg).sum(-2)) / lsg ** 2
    if z.dim() == 4:
        return gx, gz, gl, gos
    if z.dim() == 3:
        return gx, gz[0], gl[0], gos[0]
    return gx, gz[0, 0], gl[0, 0], gos.reshape(())


def launcher():
    """The C launcher: (x, z, ls, os, out pointers, R, M, d, G, S, stream)
    -> cudaError_t; S = 1 without the seed axis."""
    return _build.function(
        "rbf", "rbf_cross_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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
    elif z.dim() == 4:
        if x.dim() < 3 or x.shape[0] != z.shape[0]:
            raise ValueError(f"x must be (S, ..., N, d) for z "
                             f"{tuple(z.shape)}, got {tuple(x.shape)}")
        sh = tuple(z.shape[:2])
        want = {"z": (z, sh + (z.shape[2], d)),
                "lengthscale": (lengthscale, sh + (d,)),
                "outputscale": (outputscale, sh)}
    else:
        raise ValueError(f"z must be (M, d), (h, M, d) or (S, h, M, d), got "
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
    """Launch the kernel on checked inputs, with or without the seed axis:
    K, in the op's output shape."""
    global launches, seeds_launches
    sd, h, m, d = _seeded(x, z, lengthscale, outputscale)[1].shape
    r = x.numel() // (sd * d)
    out = torch.empty((sd, h, r, m), device=x.device, dtype=torch.float32)
    err = launcher()(
        x.data_ptr(), z.data_ptr(), lengthscale.data_ptr(),
        outputscale.data_ptr(), out.data_ptr(), r, m, d, h, sd,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rbf_cross_fwd launch failed: cudaError {err}")
    launches += 1
    seeds_launches += z.dim() == 4
    return out.reshape(_out_shape(x, z))


class _RbfCrossKernel(torch.autograd.Function):
    """The kernel (card) or the plain forward (CPU); the plain VJP; with or
    without the seed axis."""

    @staticmethod
    def forward(x, z, lengthscale, outputscale):
        if x.device.type == "cpu":
            return rbf_cross_kernel_plain(x, z, lengthscale, outputscale)
        return forward_kernel(x, z, lengthscale, outputscale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def vmap(info, in_dims, x, z, lengthscale, outputscale):
        """The vmapped axis as the seed axis: every input stacked on it (an
        input it does not batch is repeated), one seeded call; one GP takes
        a GP axis of 1 for the call."""
        if z.dim() - (in_dims[1] is not None) == 4:
            raise NotImplementedError(
                "rbf_cross_kernel takes one seed axis; a vmap over seeded "
                "inputs would need two")
        x, z, ls, os_ = (
            (a.movedim(dim, 0) if dim is not None
             else a.expand(info.batch_size, *a.shape)).contiguous()
            for a, dim in zip((x, z, lengthscale, outputscale), in_dims))
        if z.dim() == 3:  # one GP
            return rbf_cross_kernel(x, z[:, None], ls[:, None],
                                    os_[:, None])[:, 0], 0
        return rbf_cross_kernel(x, z, ls, os_), 0

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
    """K of one GP, (..., N, M), or of h GPs, (h, ..., N, M), at raw x.
    Under ``torch.func.vmap`` (multi-seed training) the Function's rule
    stacks the seeds: one launch computes every seed's K."""
    args = (x, z, lengthscale, outputscale)
    if torch._C._are_functorch_transforms_active():
        return _RbfCrossKernel.apply(*args)  # its vmap rule: the seed axis
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return rbf_cross_fwd(*args)
    if x.device.type == "cuda":
        _check(*args)
    return _RbfCrossKernel.apply(*args)
