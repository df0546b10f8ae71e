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

On the card every entry runs its products on the tensor cores as products
of three bf16 parts of each fp32 operand (``csrc/fused_gp.cu``, the `wgb::`
engine), all but the fp32 forward's K W, an FFMA chain in the plain
version's order: five launches forward, nine backward, at any M, each on
a device scratch buffer that the wrapper allocates (``fwd_scratch_floats``,
``bwd_scratch_floats``).

Every entry also takes a leading seed axis, S independent functions in
one call: x (S, B, N, d), each parameter with a leading S (zs (S, M, d), u
(S, M), w (S, M, M), outputscale (S,), inv_ls and mean_w (S, d), mean_b
(S,)), mean and var (S, B, N) and each gradient with its leading S.  On the
card the same five launches forward and nine backward run all S seeds
(``csrc/fused_gp.cu``, the seed along each grid's z), each seed's scratch
after the last's; seed i's outputs equal a call on its inputs alone, bit
for bit.  Under ``torch.func.vmap`` the Function's ``vmap`` rule stacks the
vmapped inputs on that axis and makes the one seeded call, so a vmapped
model launches each kernel once for all its seeds.  The plain versions take
the axis too.

``whitened_marginals_affine_bf16`` takes and returns the same fp32 tensors;
only the two products K W and K^T (dvar o K) round their inputs to bf16 and
sum in fp32, everything else stays fp32.  Its forward is the fp32 forward's
sequence with K W on the tensor cores from bf16(K), rounded as it is
loaded, and bf16(W).  Its VJP is the Pallas kernel's own
rule (``E`` from the bf16 ``K W``, ``dW`` from rounded ``K`` and
``dvar o K``), not the derivative of the rounded forward, so on the CPU too
it is a ``torch.autograd.Function``, over the plain forward and the plain
backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

#: forward kernel launches since the counter was last set to 0
launches = 0
#: backward launches (one per backward call, nine kernels) since last set
#: to 0
bwd_launches = 0
#: the same two counts for the bf16 variant
bf16_launches = 0
bf16_bwd_launches = 0
#: of those, the calls with the seed axis (each one call for all its
#: seeds), by variant and way
seeds_launches = 0
seeds_bwd_launches = 0
bf16_seeds_launches = 0
bf16_seeds_bwd_launches = 0

_GT, _GKC = 128, 64  # the engine's output tile and summed-index stage


class FwdPlan(NamedTuple):
    """The forward's device scratch, as ``csrc/fused_gp.cu`` ``wgb::fwd_plan``
    lays it out: rows and inducing points padded to whole 128 x 128 tiles
    (``rp``, ``mp``), d to whole 64-column stages (``dk``), and the bytes of
    each array, every one of them 256-byte aligned."""
    rp: int
    mp: int
    dk: int
    arrays: dict

    @property
    def total(self) -> int:
        return sum(self.arrays.values())


def fwd_plan(r: int, d: int, m: int, bf16=False) -> FwdPlan:
    """The forward's scratch at R rows: x's three bf16 parts, |xs|^2 and
    x . mean_w, zs's parts and |zs|^2, K (fp32), the partial sums of K u and
    of (K W o K) per 128 inducing points; bf16, W^T in bf16 besides.  The
    library's ``fused_gp_(bf16_)fwd_scratch_floats`` gives the same total."""
    def up(v, to):
        return -(-v // to) * to

    rp, mp, dk = up(r, _GT), up(m, _GT), up(d, _GKC)
    sizes = {"x_parts": 3 * rp * dk * 2, "x2": rp * 4, "x_mean_w": rp * 4,
             "zs_parts": 3 * mp * dk * 2, "z2": mp * 4,
             "w_bf16": mp * mp * 2 if bf16 else 0, "k": mp * rp * 4,
             "part_mean": mp // _GT * rp * 4, "part_var": mp // _GT * rp * 4}
    return FwdPlan(rp, mp, dk, {k: up(v, 256) for k, v in sizes.items()})


def bwd_design(m: int, bf16=False) -> str:
    """Which backward kernels the launcher runs at M inducing points: both
    variants on `wgmma` at every M; the fp32 one with every product on three
    bf16 parts of each fp32 operand, K and E split into their parts on their
    way into shared memory."""
    return "wgmma" if bf16 else "wgmma-split"


def _round_bf16(t):
    """``t`` rounded to bf16, kept as fp32, so that a product of two such
    tensors is exact products summed in fp32, as the tensor cores do; the
    gradient passes through as if nothing was rounded."""
    return t + (t.bfloat16().float() - t).detach()


def _dot16(a, b, bf16):
    if bf16:
        a, b = _round_bf16(a), _round_bf16(b)
    return torch.matmul(a, b)


def _seeded(x) -> bool:
    """Whether ``x`` carries the seed axis: (S, B, N, d) rather than
    (B, N, d)."""
    return x.dim() == 4


def whitened_marginals_affine_plain(x, zs, u, w, outputscale, inv_ls,
                                    mean_w, mean_b, bf16=False):
    """The same function in plain PyTorch, with the Pallas kernel's
    |xs|^2 + |zs|^2 - 2 xs.zs distance (no clamp).  ``bf16``: K and W are
    rounded to bf16 where they enter the K W product.  With the seed axis,
    the function of each seed (``torch.func.vmap`` over it)."""
    if _seeded(x):
        return torch.func.vmap(functools.partial(
            whitened_marginals_affine_plain, bf16=bf16))(
                x, zs, u, w, outputscale, inv_ls, mean_w, mean_b)
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
    and K^T (dvar o K) products round their inputs to bf16.  With the seed
    axis, each seed's VJP."""
    if _seeded(x):
        return torch.func.vmap(functools.partial(
            whitened_marginals_affine_bwd_plain, bf16=bf16))(
                x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean, dvar)
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
    mean_w 0, mean_b 0 (each seed's, with the seed axis)."""
    lead = xs.shape[:-3]
    d = xs.shape[-1]
    kw = dict(device=xs.device, dtype=xs.dtype)
    return (xs, zs, u, w, outputscale, torch.ones(*lead, d, **kw),
            torch.zeros(*lead, d, **kw), torch.zeros(lead, **kw))


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


def launcher():
    """The C forward launcher of S seeds, either variant: (x, zs, u, w, os,
    inv_ls, mean_w, mean_b, mean, var, scratch pointers, R, d, M, S, bf16,
    stream) -> cudaError_t, each array with the seed axis leading (S = 1:
    one function) and S times a seed's ``fwd_scratch_floats``."""
    return _build.function(
        "fused_gp", "fused_gp_fwd",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def bwd_launcher():
    """The C backward launcher, either variant: (x, zs, u, w, os, inv_ls,
    mean_w, dmean, dvar, dx, dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b,
    scratch pointers, R, d, M, S, bf16, stream) -> cudaError_t, laid out as
    the forward's (both variants take the fp32 w)."""
    return _build.function(
        "fused_gp", "fused_gp_bwd",
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fwd_scratch_floats(r: int, d: int, m: int, bf16=False) -> int:
    """Floats of device scratch one forward call needs at R rows (a seed's
    share of a seeded call)."""
    symbol = ("fused_gp_bf16_fwd_scratch_floats" if bf16
              else "fused_gp_fwd_scratch_floats")
    return _build.function("fused_gp", symbol, [ctypes.c_int] * 3,
                           ctypes.c_longlong)(r, d, m)


def bwd_scratch_floats(r: int, d: int, m: int, bf16=False) -> int:
    """Floats of device scratch one backward call needs at R rows (a seed's
    share of a seeded call)."""
    symbol = ("fused_gp_bf16_bwd_scratch_floats" if bf16
              else "fused_gp_bwd_scratch_floats")
    return _build.function("fused_gp", symbol, [ctypes.c_int] * 3,
                           ctypes.c_longlong)(r, d, m)


def _check(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b):
    if x.dim() not in (3, 4):
        raise ValueError(f"x must be (B, N, d) or (S, B, N, d), got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-3])  # the seed axis, or none
    d = x.shape[-1]
    m = zs.shape[-2]
    want = {"x": (x, tuple(x.shape)), "zs": (zs, lead + (m, d)),
            "u": (u, lead + (m,)), "w": (w, lead + (m, m)),
            "outputscale": (outputscale, lead), "inv_ls": (inv_ls, lead + (d,)),
            "mean_w": (mean_w, lead + (d,)), "mean_b": (mean_b, lead)}
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
    inv_ls: (d,) = 1 / lengthscale; mean_w: (d,); mean_b: 0-d.  Or every
    one of them with a leading seed axis S, and (S, B, N) out.
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
    if torch._C._are_functorch_transforms_active():
        # under vmap: the Function's rule makes one seeded call
        return _WhitenedMarginals.apply(bf16, *args)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x.device.type == "cpu":
        if bf16 and grad:  # the bf16 VJP is the kernel's own rule
            return _WhitenedMarginals.apply(bf16, *args)
        if grad:
            return whitened_marginals_affine_plain(*_full(args), bf16=bf16)
        return fused_gp_fwd(*_full(args), bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if grad:
        _check(*_full(args))
        return _WhitenedMarginals.apply(bf16, *args)
    return fused_gp_fwd(*_full(args), bf16)


def _seeds_and_shape(x):
    """(S, B, N, d) of x, S = 1 without the seed axis."""
    return (1, *x.shape) if x.dim() == 3 else tuple(x.shape)


def forward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b,
                   bf16=False):
    """Launch the forward kernels on checked inputs, with or without the
    seed axis: (mean, var)."""
    global launches, bf16_launches, seeds_launches, bf16_seeds_launches
    s, b, n, d = _seeds_and_shape(x)
    m = zs.shape[-2]
    lead = tuple(x.shape[:-3])
    mean = torch.empty(lead + (b, n), device=x.device, dtype=torch.float32)
    var = torch.empty(lead + (b, n), device=x.device, dtype=torch.float32)
    scratch = torch.empty(s * fwd_scratch_floats(b * n, d, m, bf16),
                          device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launcher()(
        *(t.data_ptr() for t in (x, zs, u, w, outputscale, inv_ls, mean_w,
                                 mean_b, mean, var, scratch)),
        b * n, d, m, s, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_fwd launch failed: cudaError {err}")
    if bf16:
        bf16_launches += 1
        bf16_seeds_launches += bool(lead)
    else:
        launches += 1
        seeds_launches += bool(lead)
    return mean, var


# The forward as a registered op, so that ``torch.export`` records a call
# of the kernel (FakeTensors have no data to hand to ctypes): the kernels on
# CUDA tensors, the plain version on CPU tensors, the outputs' shapes from
# ``register_fake``.  The served (no-gradient) path calls it.
@torch.library.custom_op(
    "fgp_torch::fused_gp_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor zs, Tensor u, Tensor w, Tensor outputscale, "
           "Tensor inv_ls, Tensor mean_w, Tensor mean_b, bool bf16) -> "
           "(Tensor, Tensor)")
def fused_gp_fwd(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, bf16):
    args = (x, zs, u, w, outputscale, inv_ls, mean_w, mean_b)
    _check(*args)
    return forward_kernel(*args, bf16=bf16)


@fused_gp_fwd.register_kernel("cpu")
def _(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, bf16):
    return whitened_marginals_affine_plain(x, zs, u, w, outputscale, inv_ls,
                                           mean_w, mean_b, bf16=bf16)


@fused_gp_fwd.register_fake
def _(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, bf16):
    return x.new_empty(x.shape[:-1]), x.new_empty(x.shape[:-1])


def backward_kernel(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean,
                    dvar, bf16=False):
    """Launch the backward kernels on checked inputs and contiguous (B, N)
    cotangents, or (S, B, N) with the seed axis: the gradients of the eight
    inputs."""
    global bwd_launches, bf16_bwd_launches, seeds_bwd_launches
    global bf16_seeds_bwd_launches
    s, b, n, d = _seeds_and_shape(x)
    m = zs.shape[-2]
    lead = tuple(x.shape[:-3])

    def new(*shape):
        return torch.empty(lead + shape, device=x.device, dtype=torch.float32)

    grads = (new(b, n, d), new(m, d), new(m), new(m, m), new(), new(d),
             new(d), new())
    scratch = torch.empty(s * bwd_scratch_floats(b * n, d, m, bf16),
                          device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = bwd_launcher()(
        *(t.data_ptr() for t in (x, zs, u, w, outputscale, inv_ls, mean_w,
                                 dmean, dvar)),
        *(t.data_ptr() for t in grads), scratch.data_ptr(), b * n, d, m, s,
        int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"fused_gp_bwd launch failed: cudaError {err}")
    if bf16:
        bf16_bwd_launches += 1
        bf16_seeds_bwd_launches += bool(lead)
    else:
        bwd_launches += 1
        seeds_bwd_launches += bool(lead)
    return grads


class _WhitenedMarginals(torch.autograd.Function):
    """The kernels on the card; on the CPU (the bf16 variants only) the plain
    forward and the plain VJP.  Five inputs: the non-affine variant, run as
    the affine function at inv_ls 1, mean_w 0, mean_b 0.  With or without
    the seed axis."""

    @staticmethod
    def forward(bf16, *args):
        if args[0].device.type == "cpu":
            return whitened_marginals_affine_plain(*_full(args), bf16=bf16)
        return forward_kernel(*_full(args), bf16=bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bf16 = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def vmap(info, in_dims, bf16, *args):
        """The vmapped axis as the seed axis: every input stacked on it
        (an input it does not batch is repeated), one seeded call."""
        if args[0].dim() - (in_dims[1] is not None) == 4:
            raise NotImplementedError(
                "the fused GP takes one seed axis; a vmap over seeded "
                "inputs would need two")
        stacked = tuple(
            (a.movedim(dim, 0) if dim is not None
             else a.expand(info.batch_size, *a.shape)).contiguous()
            for a, dim in zip(args, in_dims[1:]))
        return _marginals(stacked, bf16), (0, 0)

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
