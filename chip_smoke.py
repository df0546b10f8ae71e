#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: the card's name, count and power limit; builds the CUDA kernels
   from ``fine_grained_gaussian_process_forcasting_torch/csrc``.
2. Kernels: each kernel, forward and backward, against its plain-PyTorch
   version at the shapes its path gives it (max-abs error against a stated
   tolerance), timed with CUDA events beside its plain version, its bound
   and, where one exists, the one PyTorch call that computes the same
   function: the fp32 fused GP and head-folded attention at the flagship
   shapes (the fused GP also at the production width, d 512), the bf16 fused
   GP and the flash attention (bf16, which the production-width paths take;
   fp32 and the sm_bf16 variant of both, which no path of this script
   takes) at the production-width shapes; the fused GP's non-affine
   variants (the same kernels, on no path) at the flagship shape; the rbf
   cross-covariance at the multi-layer flagship's hidden layer (8 GPs, one
   launch); the batched Cholesky at the exact blur's (256, 192, 192) and
   (256, 96, 96), at (16, 384, 384), at the sizes around its 32-column
   panels (n 1, 31, 32, 33, 97, 191, 192, 241) and past 1056 (n 1100, the
   panel staged from device memory), and on batches with a matrix that
   fails at the first pivot or inside a later panel (NaN there, no
   exception); the small-head attention
   (d <= 8, on no path) at the flagship's three calls at d 4, timed beside
   SDPA and the head-folded kernel, and at d 2 and d 8, with two backward
   runs bit-equal; the flash kernels at the head dims they pad in their
   tiles (60, 72, 128, 256), both dtypes; the fused GP at M 1024 and 2048,
   both dtypes (these on no path).  The bf16 backward (the `wgmma` design)
   is also held to float64: each gradient no farther from it than twice the
   plain version, and two runs bit-equal; so is the bf16 forward (its cross
   term on bf16 parts, K W on bf16(K) and bf16(W)): mean and var, summed
   over 16 draws, no farther than twice the plain bf16 version from the
   fp32 and from the bf16 function in float64, at prod_basic's shape, at
   d 32 non-affine and at M 1024 and 2048, and two runs bit-equal.  So
   are the fp32 forward and backward (every product on bf16 parts but the
   forward's K W): each output's distance from the float64 fp32 function,
   summed over 16 draws from a generator of their own, at most twice the
   plain fp32 version's (cuBLAS, TF32 off), at the flagship, at d 512,
   non-affine and at M 1024 and 2048.  The fused-GP
   backward's device time by kernel is read under ``torch.profiler`` at the
   flagship and d 512 (fp32) and production (bf16) shapes, with the scratch
   it allocates and the bytes it writes between its launches, each beside
   its forward's device time by kernel and scratch (the bf16 forward at the
   flagship's d 32 too).  The rbf kernel is also held to K in float64 beside
   the plain version, rerun bit-equal, and timed at the served ragged batch
   with the store bandwidth it reached.  The library's backward is timed on
   the device alone, from its kernels under ``torch.profiler``.
3. Serving, flagship: the AutoDG model (autoformer + GP + denoise, d_model
   32, 8 heads, 1 layer, 512 inducing points, enc 192, dec/pred 96) and its
   ``basic``-attention twin, weights from a fixed seed, serve 600 request
   windows through ``InferenceSession.predict`` (two batches of 256 and a
   ragged 88).  Checks shapes, finiteness, the kernels' launch counts, and the
   first 16 windows against the port's own CPU run.
4. Training, flagship: both configurations train from the weights of seed 0
   through ``Trainer.train_epoch`` (Noam-Adam, warmup 4000) on batches of
   256 windows drawn from the seed: 3 warm-up steps, then 3 epochs of 20
   steps, each timed, whose launches are counted, then one profiled step.
   Checks finite losses, the launches per step (fused GP forward and backward
   once; head-folded attention forward and backward six times in ``basic``),
   and one step's loss and gradients on 16 windows against the port's CPU
   run.
5. Serving and training, production width: the ``basic`` + GP + denoise
   model at d_model 512, 8 heads (d_k 64), 2 layers, 512 inducing points,
   batch 64, enc 512, dec/pred 128, 8 features, ``compute_dtype`` and
   ``gp_compute_dtype`` bfloat16, through the same two entry points: 216
   windows served (three batches and a ragged 24), 3 warm-up steps and 3
   epochs of 20 steps trained.  Per batch 8 flash-attention launches and one
   bf16 fused GP; per step as many again backward; no head-folded launch.
   The first 4 windows, and one step on 4 windows, against the port's CPU
   run at a bf16 tolerance.
6. Serving and training, the rest of the GP layer and the conv family at
   the production width: ``multilayer``, the
   flagship with a hidden layer of 8 GPs on the ``use_pallas_gp`` route
   (per batch one rbf launch for the 8 GPs and one fused GP for the output
   layer at d 8; per step the same and one fused-GP backward), and
   ``exact``, the flagship with the exact-GP blur (the library's
   factorization, as in JAX: no hand kernel).  Then ``exact_blur_pallas``:
   ``ExactGPBlur(32, use_pallas=True)`` with the trained exact model's blur
   weights on its encoder and decoder states, ``smooth`` twice and ``mll``
   once, forward and backward, through the Cholesky kernel (two launches
   per factorization: the jitter probe and the differentiable one), held
   against cuSOLVER on the card and against the CPU.  ``conv_attn_wide``:
   ``conv_attn`` at d_model 512, 8 heads (d_k 64), fp32, with
   ``use_pallas_attention=True``: one served batch of 64 and 3 + 4 training
   steps, the fp32 flash kernels six times each way a step.
7. The training CLI, ``cli_ata``: ``train.cli.main`` as ``run.sh`` runs it
   (``--exp_name solar --attn_type ATA --denoising True --gp True``) on
   synthetic solar data at the flagship width, cut to 2560 training and 512
   validation and test windows, 3 epochs, 1 trial, 1 seed, into a temporary
   directory; twice: ``--use_pallas_attention auto`` (the conv family's
   plain attention) and ``True`` (the head-folded kernel, six launches each
   way per step).  Checks finite losses, the launches per step and per
   evaluated batch, the checkpoint, the predictions ``.npz`` (2, 256, 96),
   the ``reported_errors_solar.csv`` row, and one step of the checkpointed
   ATA model on 16 windows against the port's CPU run.

The CPU runs take the AutoCorrelation delays that the card chose, the deep
GP's eps draws the card made and, in training, the card's side of every
ReLU, so that a near-tie broken the other way on one device cannot make the
two compute different functions; likewise ATA's top-1 scale of every
(position, channel) and its side of zero; how many differed is printed.

Prints the ``kernels`` JSON line (each kernel's launches summed over the
serving and training runs, and by run), then the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero on any
failure, without a result line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# flagship AutoDG configuration (bench.py)
B, ENC_LEN, DEC_LEN, PRED, F = 256, 192, 96, 96, 4
D_MODEL, HEADS, LAYERS, INDUCING = 32, 8, 1, 512
N_WINDOWS = 600  # two full batches + a ragged tail of 88
N_CHECK = 16  # windows compared with the CPU run
SEED = 0
# training: Noam-Adam as the flagship trains (bench.py), warm-up steps,
# then timed epochs of N_TRAIN_STEPS steps each
WARMUP_STEPS, LR_MUL = 4000, 2.0
N_WARMUP, N_TRAIN_STEPS, N_EPOCHS = 3, 20, 3

# production-width configuration (bench.py bench_prod_step with
# attn_type="basic"): d_model 512, 8 heads (d_k 64), 2 layers, bf16
P_B, P_ENC_LEN, P_DEC_LEN, P_PRED, P_F = 64, 512, 128, 128, 8
P_D_MODEL, P_LAYERS = 512, 2
P_N_WINDOWS = 216  # three full batches + a ragged tail of 24
P_N_CHECK = 4  # windows compared with the CPU run (slow at this width)
C_B = 64  # conv_attn_wide's batch

# the multi-layer flagship: one hidden layer of 8 GPs before the output GP
ML_HIDDEN = 8

# published H100 SXM peaks (dense): fp32 outside the tensor cores, bf16 on
# them, HBM3; exponentials on the special-function units: 16 per SM per
# clock x 132 SMs x 1.98 GHz boost clock
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9

TOL_FUSED_GP = 1e-4
# the rbf and Cholesky kernels against their plain versions: the JAX
# package's own tolerances for those kernels, (rtol, atol), held as
# max|kernel - plain| / (atol + rtol |plain|) <= 1
TOL_RBF = (1e-4, 1e-5)
TOL_CHOL = (2e-3, 2e-3)
TOL_ATTENTION = 1e-5
TOL_SERVING = 1e-3
# backward kernels against their plain backward.  Fused GP: every output
# within 1e-3 of max(1, its largest magnitude): the row sums run over
# 73,728 rows in another order, and W at these inputs reaches ~100 in
# magnitude (an ill-conditioned 512-point Gram matrix), which the plain
# fp32 version itself feels (both are printed against float64).
# Attention: the JAX package's kernel-gradient atol (1e-5).
TOL_FUSED_GP_BWD = 1e-3
# the bf16 fused-GP backward runs the reference's fp32 products as products
# of bf16 parts: each gradient's distance from a float64 evaluation of the
# function (the fp32 function, and the bf16 function rounded to bf16 at the
# same places) may be at most twice the plain bf16 version's
F64_BUDGET_BF16_BWD = 2.0
# The distance from the bf16 function comes mostly from the elements where
# an fp32 K and the float64 K round to different bf16 values, and the
# kernel's K and plain's differ in their last bits, so each has its own set
# of such elements: in one draw of the inputs the two distances are nearly
# independent errors of one size, whose ratio exceeds 2 in about 30 % of
# draws.  That comparison is made on the distances summed over F64_DRAWS
# draws (a ratio above 2 in about 0.6 % of runs for two equal errors).
F64_DRAWS = 16
# the fp32 fused GP runs every product on bf16 parts too (three parts of
# each fp32 operand): each output's distance from the float64 fp32 function,
# summed over F64_DRAWS draws, may be at most twice the plain fp32 version's
# (cuBLAS, TF32 off)
F64_BUDGET_FP32 = 2.0
# the bf16 forward runs the distance's cross term on bf16 parts too: its
# mean and var each no farther than twice the plain bf16 version from the
# fp32 function in float64 and from the bf16 function in float64 (K and W
# rounded to bf16 where they enter K W, the products exact), the distances
# summed over F64_DRAWS draws
F64_BUDGET_BF16_FWD = 2.0
# those fp32 and bf16-forward draws, and the fp32 backward's profile at d
# 512, come from a generator of their own, so that the other checks' inputs do not depend on
# them
F64_SEED = 1
TOL_ATTENTION_BWD = 1e-5
# one training step on the card against the CPU: the loss, and each
# parameter's gradient relative to its largest magnitude
TOL_TRAIN = 1e-3
# a gradient that is 0 in exact arithmetic (ATA's convolution biases: the
# batch norm right after each subtracts their contribution with the mean)
# is a sum of terms that cancel, whose rounding residue has no reference
# value to be held to: on each device it must stay below 1e-5 of the step's
# largest gradient
ZERO_GRAD = 1e-5
# bf16 kernels against their plain versions, which round the same operands
# to bf16 at the same places: they differ by the order of the fp32 sums and
# (flash) by rounding the unnormalised instead of the normalised
# probabilities, so a value may land one bf16 step apart: 2^-7 of
# max(1, the output's largest magnitude); the fused GP's mean stays fp32
TOL_BF16 = 2.0 ** -7
# the sm_bf16 softmax's probabilities are bf16 values that went through
# three roundings; the card's expf and division put a few of them on the
# neighbouring bf16 value: 2^-6
TOL_SM16 = 2.0 ** -6
# the fp32 flash kernels against their plain versions: (rtol, atol), the JAX
# package's own tolerances for that kernel, forward and gradients
TOL_FLASH_F32 = (1e-4, 1e-5)
TOL_FLASH_F32_BWD = (2e-3, 1e-4)
# the bf16 model on the card against the port's CPU run.  Both round at the
# same places, but the card sums in another order and its flash kernel
# rounds other values of P, and four transformer passes with their
# LayerNorms carry a one-step difference on: the worst prediction within
# 2^-5 of the largest magnitude (the mean difference is printed beside it),
# the loss 2^-6 relative, each gradient within 2^-3 of its largest magnitude
# (sums over all rows that nearly cancel carry the rounding of every term)
TOL_SERVING_BF16 = 2.0 ** -5
TOL_LOSS_BF16 = 2.0 ** -6
TOL_TRAIN_BF16 = 2.0 ** -3

# the flagship's three attention calls per forecaster pass: (Lq, Lk)
ATTENTION_CALLS = {"enc_self": (ENC_LEN, ENC_LEN),
                   "dec_self": (DEC_LEN, DEC_LEN),
                   "dec_cross": (DEC_LEN, ENC_LEN)}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_bwd_ms(q, k, v, do, iters: int) -> float:
    """Device time of ``scaled_dot_product_attention``'s backward alone: the
    graph is built once and kept, ``torch.autograd.grad`` runs ``iters``
    times under ``torch.profiler``, and the device time of the kernels it
    launched is summed, so that autograd's host time is left out."""
    from torch.autograd import DeviceType
    from torch.nn.functional import scaled_dot_product_attention
    from torch.profiler import ProfilerActivity, profile

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = scaled_dot_product_attention(*leaves)

    def run():
        torch.autograd.grad(out, leaves, do, retain_graph=True)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    if not busy_us > 0:
        raise AssertionError("the profiler saw no device time in "
                             "scaled_dot_product_attention's backward")
    return busy_us / 1e3 / iters


def bound(flops: float, exps: float, nbytes: float, bf16_flops: float = 0.0):
    """(ms, what bounds it): the larger of the operations at the peak of
    their type (fp32 on the CUDA cores, bf16 on the tensor cores,
    exponentials on the special-function units: three units that can work at
    once) and the bytes (each input read once, each output written once) at
    peak."""
    ops_ms = max(flops / PEAK_FP32, bf16_flops / PEAK_BF16,
                 exps / PEAK_EXP) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; nvidia-smi: {smi}")
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for path in paths.values():
        log_path = path.with_suffix(".log")
        if log_path.exists():
            log(log_path.read_text().strip())
    return name, count, smi


GP_SHAPES = {"flagship": (B, ENC_LEN + DEC_LEN, D_MODEL, INDUCING),
             "production": (P_B, P_ENC_LEN + P_DEC_LEN, P_D_MODEL, INDUCING)}
_FUSED_GP_SOURCE = ("fine_grained_gaussian_process_forcasting_torch/csrc/"
                    "fused_gp.cu")
_FUSED_GP_PALLAS = ("fine_grained_gaussian_process_forcasting_tpu/ops/pallas/"
                    "fused_gp.py")


def _gp_inputs(gen, shape):
    """Inputs of the fused GP at (b, n, d, m)."""
    dev = "cuda"
    b, n, d, m = shape
    # inputs built by the GP layer's own host math, at lengthscale sqrt(2 d)
    # so that K is far from 0 (at the default init it underflows)
    x = torch.randn(b, n, d, device=dev, generator=gen)
    z = torch.randn(m, d, device=dev, generator=gen)
    ls = torch.full((d,), math.sqrt(2.0 * d), device=dev)
    os_ = torch.tensor(math.log(2.0), device=dev)
    zs = (z / ls).contiguous()
    kzz = os_ * torch.exp(-0.5 * torch.cdist(zs, zs) ** 2)
    chol = torch.linalg.cholesky(kzz + 1e-4 * torch.eye(m, device=dev))
    li = torch.linalg.solve_triangular(chol, torch.eye(m, device=dev),
                                       upper=False)
    var_mean = 0.3 * torch.randn(m, device=dev, generator=gen)
    s2 = torch.rand(m, device=dev, generator=gen)
    u = (li.T @ var_mean).contiguous()
    w = (li.T @ (li * (1.0 - s2)[:, None])).contiguous()
    return (x, zs, u, w, os_, (1.0 / ls).contiguous(),
            torch.randn(d, device=dev, generator=gen) / d,
            torch.tensor(0.1, device=dev))


# M past 720, where an earlier bf16 forward took M in chunks and every
# kernel now tiles M as it tiles rows: the flagship's windows and width at 1024
# and 2048 inducing points, on a quarter of its batch
LARGE_M_SHAPES = [(64, ENC_LEN + DEC_LEN, D_MODEL, m) for m in (1024, 2048)]


def _gp_inputs_large_m(gen, shape):
    """Inputs of the fused GP at a large M: W = A^T diag(1 - s^2) A with A
    of entries ~ N(0, 1 / M), the form of L^-T diag(1 - s^2) L^-1 with the
    magnitudes of a well-spread set of inducing points (2048 random points
    in d 32 give a Gram matrix that the fp32 Cholesky cannot factor well)."""
    x, zs, u, _, os_, inv_ls, mean_w, mean_b = _gp_inputs(
        gen, shape[:3] + (16,))
    b, n, d, m = shape
    z = torch.randn(m, d, device="cuda", generator=gen)
    zs = (z * inv_ls).contiguous()
    a = torch.randn(m, m, device="cuda", generator=gen) / math.sqrt(m)
    s2 = torch.rand(m, device="cuda", generator=gen)
    w = a.T @ (a * (1.0 - s2)[:, None])
    w = (0.5 * (w + w.T)).contiguous()
    u = (0.3 * torch.randn(m, device="cuda", generator=gen)).contiguous()
    return (x, zs, u, w, os_, inv_ls, mean_w, mean_b)


def _fwd_runner(fused_gp, args, bf16):
    """A closure that launches the forward kernels alone on ``args`` (the
    affine function's eight inputs), as the wrapper would, on their scratch;
    ``forward_kernel``'s allocations are made once here and not timed."""
    b, n, d = args[0].shape
    m = args[1].shape[0]
    outs = [torch.empty(b, n, device="cuda") for _ in range(2)]
    scratch = torch.empty(fused_gp.fwd_scratch_floats(b * n, d, m, bf16),
                          device="cuda")
    ptrs = [a.data_ptr() for a in (*args, *outs, scratch)]
    launch = fused_gp.launcher(bf16)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if launch(*ptrs, b * n, d, m, stream):
            raise RuntimeError("fused_gp launch failed")
    return run


# the fp32 float64 gates' generator (F64_SEED), and the bf16 forward's (the
# same seed, a generator of its own so that the fp32 gates' draws stay
# those they were), made in main()
_F64_GEN = [None]
_F64_BF16_GEN = [None]


def _gate_f64(tag, summed, budget, ref="fp32 function"):
    """Logs each output's summed distance from float64 (``ref``, the
    function evaluated there) beside plain's; raises if one is more than
    ``budget`` times plain's.  The largest ratio."""
    worst = 0.0
    for name, (ks, ps) in summed.items():
        ratio = _f64_ratio(ks, ps)
        worst = max(worst, ratio)
        log(f"{tag} {name}: vs float64 {ref}, summed over "
            f"{F64_DRAWS} draws: kernel {ks:.3e}, plain {ps:.3e} (kernel / "
            f"plain {ratio:.3f}; budget {budget})")
        if not ratio <= budget:
            raise AssertionError(f"{tag} {name} is {ratio:.3f} times farther "
                                 f"from float64 than the plain version")
    return worst


def _gate_bf16_fwd_f64(tag, draw, kernel, plain, names, first):
    """The bf16 forward's float64 gate: each output's distance from the fp32
    function and from the bf16 function, both evaluated in float64
    (``plain(args, bf16)`` on float64 args), summed over ``F64_DRAWS`` draws
    (``first``, then ``draw()``), at most ``F64_BUDGET_BF16_FWD`` times the
    plain bf16 version's.  The largest ratio."""
    sums = {bf16: {name: [0.0, 0.0] for name in names} for bf16 in (0, 1)}
    for i in range(F64_DRAWS):
        args = first if i == 0 else draw()
        with torch.inference_mode():
            got, want = kernel(args), plain(args, True)
            wide = [a.double() for a in args]
            for bf16 in (0, 1):
                for name, g, w_, e in zip(names, got, want, plain(wide, bf16)):
                    sums[bf16][name][0] += (g.double() - e).abs().max().item()
                    sums[bf16][name][1] += (w_.double() - e).abs().max().item()
        del got, want
    return max(_gate_f64(tag, sums[bf16], F64_BUDGET_BF16_FWD,
                         ("bf16" if bf16 else "fp32") + " function")
               for bf16 in (0, 1))


def check_fused_gp(gen, shape, bf16=False, large_m=False):
    """The forward kernel against its plain version at (b, n, d, m), and
    its time beside the plain version's and its bound; each variant held to
    float64 too, and two runs bit-equal.  ``large_m``: the inputs of
    ``_gp_inputs_large_m``; an entry on no path."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = shape
    tag = f"fused_gp{'_bf16' if bf16 else ''} (rows {b * n}, d {d}, M {m})"
    args = (_gp_inputs_large_m if large_m else _gp_inputs)(gen, shape)
    w = args[3]
    with torch.inference_mode():
        wrapper = (fused_gp.whitened_marginals_affine_bf16 if bf16
                   else fused_gp.whitened_marginals_affine)
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = fused_gp.whitened_marginals_affine_plain(*args, bf16=bf16)
        exact = fused_gp.whitened_marginals_affine_plain(
            *(a.double() for a in args))
    errs = [(g - w_).abs().max().item() for g, w_ in zip(got, want)]
    # the mean is fp32 in both variants; the bf16 variance within one bf16
    # step of max(1, its largest magnitude)
    tols = [TOL_FUSED_GP, TOL_BF16 * max(1.0, want[1].abs().max().item())
            if bf16 else TOL_FUSED_GP]
    err64 = [max((t.double() - e).abs().max().item()
                 for t, e in zip(ts, exact)) for ts in (got, want)]
    log(f"{tag}: max|kernel - plain| mean {errs[0]:.3e} (tol {tols[0]:.3e}),"
        f" var {errs[1]:.3e} (tol {tols[1]:.3e}); vs float64 fp32 function: "
        f"kernel {err64[0]:.3e}, plain {err64[1]:.3e}; "
        f"max|W| {w.abs().max().item():.3e}")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError(f"{tag} disagrees with its plain version: "
                             f"{errs} > {tols}")
    # the products on bf16 parts (all of the fp32 forward's but K W)
    inputs = _gp_inputs_large_m if large_m else _gp_inputs
    if bf16:
        f64_ratio = _gate_bf16_fwd_f64(
            tag, lambda: inputs(_F64_BF16_GEN[0], shape), lambda a: wrapper(*a),
            lambda a, bf: fused_gp.whitened_marginals_affine_plain(*a,
                                                                   bf16=bf),
            ("mean", "var"), args)
    else:
        f64_ratio = _gate_f64(tag, _f64_distances(
            lambda: (inputs(_F64_GEN[0], shape), ()),
            lambda a, c: fused_gp.whitened_marginals_affine(*a),
            lambda a, c: fused_gp.whitened_marginals_affine_plain(*a),
            ("mean", "var"), first=(args, ())), F64_BUDGET_FP32)
    with torch.inference_mode():
        again = wrapper(*args)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{tag} differs between two runs")
    log(f"{tag}: two runs bit-equal in mean and var")

    run_kernel = _fwd_runner(fused_gp, args, bf16)
    with torch.inference_mode():
        ms = time_ms(run_kernel, 20)
        plain_ms = time_ms(
            lambda: fused_gp.whitened_marginals_affine_plain(*args,
                                                             bf16=bf16), 10)
    r = b * n
    kw_flops = r * 2.0 * m * m  # the K W product
    # the rest: the distance as |x|^2 + |z|^2 - 2 x.z (one product, 2 M d a
    # row, and 3 M for the norms and the add), K u and K.(K W) (4 M), the
    # mean (2 d)
    rest = r * (2.0 * m * d + 7.0 * m + 2.0 * d)
    nbytes = 4.0 * (r * d + m * d + m + m * m + 2 * d + 2 + 2 * r)
    bound_ms, bound_by = (bound(rest, r * m, nbytes, kw_flops) if bf16
                          else bound(kw_flops + rest, r * m, nbytes))
    # the design's own bound: the distance's cross term as six bf16 part
    # products and K W (fp32: six again; bf16: one bf16 product) at the
    # tensor cores' peak
    tc_ms = bound(r * (7.0 * m + 2.0 * d), r * m, nbytes,
                  6.0 * r * 2.0 * m * d + (1.0 if bf16 else 6.0) * kw_flops)[0]
    log(f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); K W {kw_flops / 1e9:.1f} GFLOP, "
        f"the fp32 rest {rest / 1e9:.1f} GFLOP; the design's tensor-core "
        f"bound {tc_ms:.4f} ms")
    return {"name": "fused_gp.whitened_marginals_affine"
                    + ("_bf16 (fwd" if bf16 else " (fwd, fp32")
                    + (f", M {m})" if large_m else ")"),
            "route": "cuda", "source": _FUSED_GP_SOURCE,
            "replaces": _FUSED_GP_PALLAS + ":222", "on_path": not large_m,
            "shape": {"rows": r, "d": d, "M": m},
            "max_abs_err": max(errs), "tolerance": max(tols), "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "tc_bound_ms": tc_ms,
            "f64_dist_over_plain": f64_ratio}


def _measure(got, want, rtol_atol):
    """(max|got - want|, max|got - want| / (atol + rtol |want|))."""
    rtol, atol = rtol_atol
    diff = (got - want).abs()
    return (diff.max().item(),
            (diff / (atol + rtol * want.abs())).max().item())


def _f64_ratio(kernel, plain):
    """The kernel's distance from float64 over the plain version's."""
    if plain > 0:
        return kernel / plain
    return 0.0 if kernel == 0 else math.inf


def _f64_distances(draw, kernel, plain, names, first=None):
    """Each output's max distance from the plain version's function in
    float64 (the bf16 one rounded to bf16 where the plain bf16 version
    rounds), for the kernel and for the plain version, summed over
    ``F64_DRAWS`` draws of the inputs: ``first`` (args, cot) and then
    ``draw()``.  ``kernel(args, cot)`` and ``plain(args, cot)`` give the
    outputs."""
    sums = {name: [0.0, 0.0] for name in names}
    for i in range(F64_DRAWS):
        args, cot = first if i == 0 and first is not None else draw()
        with torch.inference_mode():
            got = kernel(args, cot)
            want = plain(args, cot)
            exact = plain([a.double() for a in args],
                          [c.double() for c in cot])
        for name, g, w_, e in zip(names, got, want, exact):
            sums[name][0] += (g.double() - e).abs().max().item()
            sums[name][1] += (w_.double() - e).abs().max().item()
        del got, want, exact
    return sums


def check_fused_gp_nonaffine(gen, shape, bf16=False):
    """``whitened_marginals``(``_bf16``), forward and backward, which run
    the affine kernels at inv_ls 1, mean_w 0, mean_b 0: the wrappers
    against their plain versions on the same pre-scaled inputs, timed.  On
    no path of this script: two kernel entries, ``on_path`` false."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = shape
    v = "_bf16" if bf16 else ""
    tag = f"fused_gp.whitened_marginals{v} (rows {b * n}, d {d}, M {m})"
    x, zs, u, w, os_, inv_ls = _gp_inputs(gen, shape)[:6]
    args = ((x * inv_ls).contiguous(), zs, u, w, os_)
    full = fused_gp._affine_args(*args)
    cot = (torch.randn(b, n, device=dev, generator=gen),
           torch.randn(b, n, device=dev, generator=gen))
    counter = "bf16_launches" if bf16 else "launches"
    counts = getattr(fused_gp, counter)
    with torch.inference_mode():
        got = (fused_gp.whitened_marginals_bf16 if bf16
               else fused_gp.whitened_marginals)(*args)
        torch.cuda.synchronize()
        want = fused_gp.whitened_marginals_plain(*args, bf16=bf16)
        grads = fused_gp.backward_kernel(*full, *cot, bf16=bf16)[:5]
        torch.cuda.synchronize()
        want_grads = fused_gp.whitened_marginals_bwd_plain(*args, *cot,
                                                           bf16=bf16)
        # the same function in float64, rounded to bf16 at the same places
        exact_grads = fused_gp.whitened_marginals_bwd_plain(
            *(a.double() for a in args + cot), bf16=bf16)
    if getattr(fused_gp, counter) != counts + 1:
        raise AssertionError(f"{tag}: the wrapper launched no kernel")
    # the forward as the affine entries hold it; each gradient relative to
    # max(1, its largest magnitude), as the affine backward's.  dos alone,
    # a sum of 37.7 M terms that nearly cancel (both fp32 versions lie
    # ~2e-2 from float64 there), may instead be no farther from the float64
    # function than twice the plain version is, and within 10x the tolerance.
    # bf16: besides, every gradient within F64_BUDGET_BF16_BWD times plain's
    # distance from that float64 function (summed over F64_DRAWS draws) and
    # from the fp32 function in float64.  fp32: every output, forward and
    # backward, within F64_BUDGET_FP32 times plain's distance from the
    # float64 function, summed over F64_DRAWS draws
    tols = [TOL_FUSED_GP, TOL_BF16 * max(1.0, want[1].abs().max().item())
            if bf16 else TOL_FUSED_GP]
    errs = [(g - w_).abs().max().item() for g, w_ in zip(got, want)]
    rel_tol = TOL_BF16 if bf16 else TOL_FUSED_GP_BWD
    names = ("dxs", "dzs", "du", "dW", "dos")
    if bf16:
        with torch.inference_mode():
            fp32_fn = fused_gp.whitened_marginals_bwd_plain(
                *(a.double() for a in args + cot))

    draw_gen = gen if bf16 else _F64_GEN[0]

    def draw():
        x, zs_, u_, w_, os__, inv = _gp_inputs(draw_gen, shape)[:6]
        return (((x * inv).contiguous(), zs_, u_, w_, os__),
                (torch.randn(b, n, device=dev, generator=draw_gen),
                 torch.randn(b, n, device=dev, generator=draw_gen)))

    summed = _f64_distances(
        draw, lambda a, c: fused_gp.backward_kernel(
            *fused_gp._affine_args(*a), *c, bf16=bf16)[:5],
        lambda a, c: fused_gp.whitened_marginals_bwd_plain(*a, *c,
                                                           bf16=bf16),
        names, first=(args, cot))
    if bf16:
        def draw_f64():
            x, zs_, u_, w_, os__, inv = _gp_inputs(_F64_BF16_GEN[0], shape)[:6]
            return ((x * inv).contiguous(), zs_, u_, w_, os__)

        fwd_f64 = _gate_bf16_fwd_f64(
            tag, draw_f64, lambda a: fused_gp.whitened_marginals_bf16(*a),
            lambda a, bf: fused_gp.whitened_marginals_plain(*a, bf16=bf),
            ("K u", "var"), args)
    else:
        fwd_f64 = _gate_f64(tag, _f64_distances(
            lambda: (draw()[0], ()),
            lambda a, c: fused_gp.whitened_marginals(*a),
            lambda a, c: fused_gp.whitened_marginals_plain(*a),
            ("K u", "var"), first=(args, ())), F64_BUDGET_FP32)
    bwd_errs, bwd_ok, f64 = [], True, {}
    for i, (name, g, w_, e) in enumerate(zip(names, grads, want_grads,
                                             exact_grads)):
        rel = (g - w_).abs().max().item() / max(1.0, w_.abs().max().item())
        err64 = [(t.double() - e).abs().max().item() for t in (g, w_)]
        bwd_errs.append(rel)
        f64[name] = {"kernel": err64[0], "plain": err64[1]}
        bwd_ok &= rel <= rel_tol or (name == "dos" and rel <= 10 * rel_tol
                                     and err64[0] <= 2.0 * err64[1])
        line = (f"{tag} bwd {name}: max|kernel - plain| / max(1, max|plain|) "
                f"{rel:.3e} (tol {rel_tol:.3e}); vs float64: kernel "
                f"{err64[0]:.3e}, plain {err64[1]:.3e}")
        if bf16:
            k32, p32 = ((t.double() - fp32_fn[i]).abs().max().item()
                        for t in (g, w_))
            ks, ps = summed[name]
            ratios = (_f64_ratio(ks, ps), _f64_ratio(k32, p32))
            f64[name].update(kernel_summed=ks, plain_summed=ps,
                             kernel_fp32_function=k32,
                             plain_fp32_function=p32)
            bwd_ok &= max(ratios) <= F64_BUDGET_BF16_BWD
            line += (f"; summed over {F64_DRAWS} draws: kernel {ks:.3e}, "
                     f"plain {ps:.3e} (kernel / plain {ratios[0]:.3f}); vs "
                     f"float64 fp32 function: kernel {k32:.3e}, plain "
                     f"{p32:.3e} (kernel / plain {ratios[1]:.3f}); budget "
                     f"{F64_BUDGET_BF16_BWD} for both")
        else:
            ks, ps = summed[name]
            ratio = _f64_ratio(ks, ps)
            f64[name].update(kernel_summed=ks, plain_summed=ps)
            bwd_ok &= ratio <= F64_BUDGET_FP32
            line += (f"; summed over {F64_DRAWS} draws: kernel {ks:.3e}, "
                     f"plain {ps:.3e} (kernel / plain {ratio:.3f}; budget "
                     f"{F64_BUDGET_FP32})")
        log(line)
    log(f"{tag}: max|kernel - plain| mean {errs[0]:.3e} (tol {tols[0]:.3e}),"
        f" var {errs[1]:.3e} (tol {tols[1]:.3e})")
    if not (all(e <= t for e, t in zip(errs, tols)) and bwd_ok):
        raise AssertionError(f"{tag} disagrees with its plain version")

    stream = torch.cuda.current_stream().cuda_stream
    run_fwd = _fwd_runner(fused_gp, full, bf16)
    outs = [torch.empty_like(t) for t in full]  # the gradients' shapes
    scratch = torch.empty(fused_gp.bwd_scratch_floats(b * n, d, m, bf16),
                          device=dev)
    bwd_ptrs = ([a.data_ptr() for a in full[:7]]
                + [c.data_ptr() for c in cot]
                + [o.data_ptr() for o in outs] + [scratch.data_ptr()])
    bwd_launch = fused_gp.bwd_launcher(bf16)

    def run_bwd():
        if bwd_launch(*bwd_ptrs, b * n, d, m, stream):
            raise RuntimeError("fused_gp_bwd launch failed")

    with torch.inference_mode():
        ms, bwd_ms = time_ms(run_fwd, 20), time_ms(run_bwd, 10)
        plain_ms = time_ms(
            lambda: fused_gp.whitened_marginals_plain(*args, bf16=bf16), 10)
        plain_bwd_ms = time_ms(
            lambda: fused_gp.whitened_marginals_bwd_plain(*args, *cot,
                                                          bf16=bf16), 5)
    # the function's work as for the affine entries, without the mean's
    # x . mean_w (2 d a row) and the read of inv_ls, mean_w, mean_b
    r = b * n
    kw_flops = r * 2.0 * m * m
    rest = r * (2.0 * m * d + 7.0 * m)
    nbytes = 4.0 * (r * d + m * d + m + m * m + 1 + 2 * r)
    products = r * (2.0 * m * m + (2.0 * m * m if bf16 else m * (m + 1.0)))
    bwd_rest = r * (4.0 * m * d + (2.0 * d + 10.0) * m)
    bwd_bytes = 4.0 * (2 * r * d + 2 * r + 2 * m * d + 2 * m + 2 * m * m + 2)
    if bf16:
        fwd_bound = bound(rest, r * m, nbytes, kw_flops)
        bwd_bound = bound(bwd_rest, r * m, bwd_bytes, products)
    else:
        fwd_bound = bound(kw_flops + rest, r * m, nbytes)
        bwd_bound = bound(products + bwd_rest, r * m, bwd_bytes)
    log(f"{tag}: fwd kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); bwd kernel {bwd_ms:.4f} ms "
        f"({fused_gp.bwd_design(m, bf16)} design), plain {plain_bwd_ms:.4f} ms, bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}); library: none")
    common = {"route": "cuda", "source": _FUSED_GP_SOURCE,
              "shape": {"rows": r, "d": d, "M": m}, "library_ms": None,
              "on_path": False}
    return ({"name": f"fused_gp.whitened_marginals{v} (fwd"
                     + ("" if bf16 else ", fp32") + ")",
             "replaces": _FUSED_GP_PALLAS + (":367" if bf16 else ":363"),
             "max_abs_err": max(errs), "tolerance": max(tols), "ms": ms,
             "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": fwd_bound[0],
             "bound_by": fwd_bound[1], "f64_dist_over_plain": fwd_f64,
             **common},
            {"name": f"fused_gp.whitened_marginals{v} (bwd"
                     + ("" if bf16 else ", fp32") + ")",
             "replaces": _FUSED_GP_PALLAS + ":290",
             "max_abs_err": max((g - w_).abs().max().item()
                                for g, w_ in zip(grads, want_grads)),
             "max_rel_err": max(bwd_errs), "tolerance": rel_tol,
             "tolerance_is": "relative to max(1, max|plain|) per output; "
                            "dos: or within 10x and no farther from "
                            "float64 than twice plain"
                            + ("; bf16: every output no farther from the "
                               "float64 function than twice plain" if bf16
                               else "; every output no farther from the "
                               "float64 function than twice plain, summed "
                               "over F64_DRAWS draws"),
             "max_abs_err_vs_float64": f64,
             "ms": bwd_ms, "kernel_ms": bwd_ms, "plain_ms": plain_bwd_ms,
             "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], **common})


def _rbf_inputs(gen, h, rows, m, d):
    """The multi-layer flagship's hidden-layer inputs: hidden states x
    (rows, d), h GPs' inducing points, lengthscales about sqrt(2 d) (the
    CLI's ``--gp_ls_init auto``), outputscales about softplus(0)."""
    dev = "cuda"
    x = torch.randn(rows, d, device=dev, generator=gen)
    z = torch.randn(h, m, d, device=dev, generator=gen)
    ls = math.sqrt(2.0 * d) * (0.75 + 0.5 * torch.rand(
        h, d, device=dev, generator=gen))
    os_ = math.log(2.0) * (0.75 + 0.5 * torch.rand(h, device=dev,
                                                   generator=gen))
    return x, z, ls, os_


RBF_DESIGN = ("FFMA, a block of 256 threads a 128-row tile of one GP over "
              "all of M in 128-column tiles, two blocks an SM; x staged and "
              "scaled once, z copied by cp.async during the epilogue; the "
              "norms and clamp folded into ex2; float4 streaming stores, "
              "whole 128-byte lines, draining while the next tile's products "
              "run")


def check_rbf(gen):
    """The rbf cross-covariance at the multi-layer flagship's hidden layer
    (8 GPs over the 256 x 288 joint positions, 512 inducing points, d 32)
    against its plain version; one launch for all the GPs.  Also: the
    kernel's and plain's distance from K in float64, two runs bit-equal,
    the store bandwidth it reaches, and its time at the served ragged batch
    (the first 88 x 288 rows)."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import rbf

    h, rows, m, d = ML_HIDDEN, B * (ENC_LEN + DEC_LEN), INDUCING, D_MODEL
    x, z, ls, os_ = _rbf_inputs(gen, h, rows, m, d)
    tag = f"rbf (h {h}, rows {rows}, M {m}, d {d})"
    with torch.inference_mode():
        before = rbf.launches
        got = rbf.rbf_cross_kernel(x, z, ls, os_)
        torch.cuda.synchronize()
        if rbf.launches != before + 1:
            raise AssertionError(f"{tag}: expected one launch")
        want = rbf.rbf_cross_kernel_plain(x, z, ls, os_)
        err, measure = _measure(got, want, TOL_RBF)
        exact = rbf.rbf_cross_kernel_plain(*(t.double() for t in
                                             (x, z, ls, os_)))
        err64 = [(t.double() - exact).abs().max().item() for t in (got, want)]
        del want, exact
        again = rbf.rbf_cross_kernel(x, z, ls, os_)
        if not torch.equal(got, again):
            raise AssertionError(f"{tag} differs between two runs")
        del again
        stream = torch.cuda.current_stream().cuda_stream
        launch = rbf.launcher()

        def runner(r):
            ptrs = [t.data_ptr() for t in (x, z, ls, os_, got)]

            def run():
                if launch(*ptrs, r, m, d, h, stream):
                    raise RuntimeError("rbf launch failed")
            return run

        ms = time_ms(runner(rows), 20)
        served_rows = 88 * (ENC_LEN + DEC_LEN)
        served_ms = time_ms(runner(served_rows), 20)
        plain_ms = time_ms(lambda: rbf.rbf_cross_kernel_plain(x, z, ls, os_),
                           5)
    pairs = float(h * rows * m)
    # a pair: the cross product (2 d), the distance and clamp (4), the
    # exponent and outputscale (2); the norms (2 d a point) are per point
    flops = pairs * (2.0 * d + 6.0) + 2.0 * d * h * (rows + m)
    nbytes = 4.0 * (pairs + rows * d + h * (m * d + d + 1))
    bound_ms, bound_by = bound(flops, pairs, nbytes)
    store_tb_s = 4.0 * pairs / ms / 1e9
    log(f"{tag}: design: {RBF_DESIGN}; max|kernel - plain| {err:.3e}, / "
        f"(atol + rtol |plain|) {measure:.3e} (limit 1; rtol {TOL_RBF[0]}, "
        f"atol {TOL_RBF[1]}); vs K in float64: kernel {err64[0]:.3e}, plain "
        f"{err64[1]:.3e}; two runs bit-equal; kernel {ms:.4f} ms (K written "
        f"at {store_tb_s:.3f} TB/s), at the served ragged batch ({served_rows}"
        f" rows) {served_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB); library: none (no one PyTorch call computes"
        f" it)")
    if not measure <= 1.0:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return {"name": "rbf.rbf_cross_kernel (fwd, fp32, h GPs)",
            "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "rbf.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/rbf.py:52",
            "design": RBF_DESIGN,
            "shape": {"h": h, "rows": rows, "M": m, "d": d},
            "max_abs_err": err, "measure": measure,
            "tolerance": {"rtol": TOL_RBF[0], "atol": TOL_RBF[1]},
            "tolerance_is": "measure = max|kernel - plain| / (atol + rtol "
                            "|plain|) <= 1",
            "max_abs_err_vs_float64": {"kernel": err64[0],
                                       "plain": err64[1]},
            "ms": ms, "kernel_ms": ms, "store_tb_per_s": store_tb_s,
            "served_ragged_rows": served_rows, "served_ragged_ms": served_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _blur_gram(gen, b, n, d=D_MODEL):
    """A = K + noise I + the first jitter, as the exact blur forms it from
    hidden states, at lengthscale sqrt(2 d), outputscale softplus(0), noise
    0.1 (the exact config's init)."""
    xs = torch.randn(b, n, d, device="cuda", generator=gen) / math.sqrt(
        2.0 * d)
    x2 = (xs * xs).sum(-1)
    d2 = x2[..., :, None] + x2[..., None, :] - 2.0 * xs @ xs.transpose(-1, -2)
    a = math.log(2.0) * torch.exp(-0.5 * d2.clamp(min=0.0))
    a = a + (0.1 + 1e-4) * torch.eye(n, device="cuda")
    s0 = torch.diagonal(a, dim1=-2, dim2=-1).mean()
    return (a + 1e-4 * s0 * torch.eye(n, device="cuda")).contiguous()


def check_cholesky(gen):
    """The batched Cholesky at the exact blur's encoder (256, 192, 192) and
    decoder (256, 96, 96) shapes against its plain version (cuSOLVER,
    NaN-filled), timed beside it and ``torch.linalg.cholesky``; at n 384
    (the true sequence length, the matrix in device memory) for
    correctness; and a batch with an indefinite matrix, which must come
    back NaN and only there."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        cholesky,
    )

    stream = torch.cuda.current_stream().cuda_stream
    launch = cholesky.launcher()
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "flops": 0.0, "exps": 0.0, "bytes": 0.0}
    err_all = measure_all = 0.0
    for call, (b, n) in (("enc", (B, ENC_LEN)), ("dec", (B, DEC_LEN)),
                         ("n384", (16, 384))):
        a = _blur_gram(gen, b, n)
        with torch.inference_mode():
            before = cholesky.launches
            got = cholesky.batched_cholesky(a)
            torch.cuda.synchronize()
            if cholesky.launches != before + 1:
                raise AssertionError("batched_cholesky launched no kernel")
            want = cholesky.batched_cholesky_plain(a)
            err, measure = _measure(got, want, TOL_CHOL)
            out = torch.empty_like(a)

            def run_kernel():
                if launch(a.data_ptr(), out.data_ptr(), b, n, stream):
                    raise RuntimeError("batched_cholesky launch failed")

            iters = 20 if n < 384 else 3
            ms = time_ms(run_kernel, iters)
            plain_ms = time_ms(lambda: cholesky.batched_cholesky_plain(a),
                               iters)
            library_ms = time_ms(lambda: torch.linalg.cholesky(a), iters)
        # the lower triangle read (the function reads nothing above it),
        # the factor written whole
        flops, nbytes = b * n ** 3 / 3.0, 4.0 * b * (n * (n + 1) / 2 + n * n)
        bound_ms, bound_by = bound(flops, 0.0, nbytes)
        log(f"batched_cholesky {call} (b {b}, n {n}, "
            f"{'shared memory' if n <= 240 else 'device memory'}): "
            f"max|kernel - plain| {err:.3e}, / (atol + rtol |plain|) "
            f"{measure:.3e} (limit 1); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.linalg.cholesky {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not measure <= 1.0:
            raise AssertionError(f"batched_cholesky {call} disagrees with "
                                 f"its plain version")
        err_all, measure_all = max(err_all, err), max(measure_all, measure)
        rows.append({"call": call, "b": b, "n": n, "max_abs_err": err,
                     "measure": measure, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        if call != "n384":  # the exact blur's pair of sizes
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("flops", flops),
                             ("bytes", nbytes)):
                total[key] += val
    # correctness at the 32-column panel boundaries, a single matrix, and
    # past 1056, where the panel no longer fits shared memory whole
    edges = []
    for b, n in ((1, 1), (3, 31), (3, 32), (3, 33), (2, 97), (5, 191),
                 (1, ENC_LEN), (2, 241), (1, 1100)):
        a = _blur_gram(gen, b, n)
        with torch.inference_mode():
            got = cholesky.batched_cholesky(a)
            err, measure = _measure(got, cholesky.batched_cholesky_plain(a),
                                    TOL_CHOL)
        upper_zero = bool((torch.triu(got, 1) == 0).all())
        log(f"batched_cholesky b {b}, n {n}: max|kernel - plain| {err:.3e}, "
            f"/ (atol + rtol |plain|) {measure:.3e} (limit 1); upper "
            f"triangle zero: {upper_zero}")
        if not (measure <= 1.0 and upper_zero):
            raise AssertionError(f"batched_cholesky b {b}, n {n} disagrees "
                                 f"with its plain version")
        err_all, measure_all = max(err_all, err), max(measure_all, measure)
        edges.append({"b": b, "n": n, "max_abs_err": err,
                      "measure": measure})
    # a matrix that fails at the first pivot, and ones that fail inside a
    # later panel: NaN there, and only there
    for n, fail_at in ((DEC_LEN, 0), (191, 150), (384, 300)):
        a = _blur_gram(gen, 4, n)
        if fail_at == 0:
            a[2] -= 2.0 * torch.eye(n, device="cuda")
        else:
            a[2, fail_at, fail_at] = -1.0
        got = cholesky.batched_cholesky(a)
        nan = torch.isnan(got).flatten(1)
        if not (nan[2].all() and not nan[[0, 1, 3]].any()):
            raise AssertionError("batched_cholesky: an indefinite matrix must "
                                 "give NaN, and only it")
        log(f"batched_cholesky: a matrix of a batch of 4 (n {n}) that fails "
            f"at pivot {fail_at} came back all NaN, the others finite")
    bound_ms, bound_by = bound(total["flops"], 0.0, total["bytes"])
    # one encoder and one decoder factorization, summed
    return {"name": "cholesky.batched_cholesky (fwd, fp32)", "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "cholesky.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/cholesky.py:146",
            "max_abs_err": err_all, "measure": measure_all,
            "tolerance": {"rtol": TOL_CHOL[0], "atol": TOL_CHOL[1]},
            "tolerance_is": "measure = max|kernel - plain| / (atol + rtol "
                            "|plain|) <= 1",
            "ms": total["ms"], "kernel_ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "library": "torch.linalg.cholesky (cuSOLVER)", "calls": rows,
            "edge_cases": edges}


def check_head_folded(gen):
    from torch.nn.functional import scaled_dot_product_attention

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        head_folded_attention as hfa,
    )

    dev = "cuda"
    d = D_MODEL // HEADS
    launch = hfa.launcher()
    stream = torch.cuda.current_stream().cuda_stream
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "flops": 0.0, "exps": 0.0, "bytes": 0.0}
    err_all = 0.0
    for call, (lq, lk) in ATTENTION_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        with torch.inference_mode():
            got = hfa.head_folded_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got - hfa.head_folded_attention_plain(q, k, v)
                   ).abs().max().item()
            out = torch.empty_like(q)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None)

            def run_kernel():
                if launch(*ptrs, B * HEADS, lq, lk, d, stream):
                    raise RuntimeError("head_folded_attention launch failed")

            ms = time_ms(run_kernel, 50)
            plain_ms = time_ms(
                lambda: hfa.head_folded_attention_plain(q, k, v), 20)
            library_ms = time_ms(
                lambda: scaled_dot_product_attention(q, k, v), 20)
        pairs = B * HEADS * lq * lk
        flops, exps = 4.0 * pairs * d + 3.0 * pairs, float(pairs)
        nbytes = 4.0 * B * HEADS * d * (2 * lq + 2 * lk)
        bound_ms, bound_by = bound(flops, exps, nbytes)
        log(f"head_folded_attention {call} (b {B}, h {HEADS}, Lq {lq}, "
            f"Lk {lk}, d {d}): max|kernel - plain| {err:.3e} "
            f"(tol {TOL_ATTENTION}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if not err <= TOL_ATTENTION:
            raise AssertionError(
                f"head_folded_attention {call} disagrees with its plain "
                f"version: {err} > {TOL_ATTENTION}")
        err_all = max(err_all, err)
        rows.append({"call": call, "lq": lq, "lk": lk, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("flops", flops),
                         ("exps", exps), ("bytes", nbytes)):
            total[key] += val
    bound_ms, bound_by = bound(total["flops"], total["exps"], total["bytes"])
    # the three calls of one forecaster pass, summed
    return {"name": "head_folded_attention (fwd, fp32)", "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "head_folded_attention.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/head_folded_attention.py:108",
            "max_abs_err": err_all, "tolerance": TOL_ATTENTION,
            "ms": total["ms"], "kernel_ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "calls": rows}


def check_fused_gp_bwd(gen, shape, bf16=False, large_m=False):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = shape
    tag = f"fused_gp{'_bf16' if bf16 else ''} bwd (rows {b * n}, d {d}, M {m})"
    rel_tol = TOL_BF16 if bf16 else TOL_FUSED_GP_BWD
    args = (_gp_inputs_large_m if large_m else _gp_inputs)(gen, shape)
    cot = (torch.randn(b, n, device=dev, generator=gen),
           torch.randn(b, n, device=dev, generator=gen))
    with torch.inference_mode():
        got = fused_gp.backward_kernel(*args, *cot, bf16=bf16)
        torch.cuda.synchronize()
        want = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot,
                                                            bf16=bf16)
        exact = fused_gp.whitened_marginals_affine_bwd_plain(
            *(a.double() for a in args + cot))
    names = ("dx", "dzs", "du", "dW", "dos", "dinv_ls", "dmean_w",
             "dmean_b")
    # the variant's own function in float64 (bf16: rounded to bf16 where
    # plain rounds), over F64_DRAWS draws
    draw_gen = gen if bf16 else _F64_GEN[0]

    def draw():
        return ((_gp_inputs_large_m if large_m else _gp_inputs)(
            draw_gen, shape),
            (torch.randn(b, n, device=dev, generator=draw_gen),
             torch.randn(b, n, device=dev, generator=draw_gen)))

    summed = _f64_distances(
        draw, lambda a, c: fused_gp.backward_kernel(*a, *c, bf16=bf16),
        lambda a, c: fused_gp.whitened_marginals_affine_bwd_plain(
            *a, *c, bf16=bf16), names, first=(args, cot))
    budget = F64_BUDGET_BF16_BWD if bf16 else F64_BUDGET_FP32
    worst = worst_abs = worst_f64 = 0.0
    for name, g, w_, e in zip(names, got, want, exact):
        scale = w_.abs().max().item()
        err = (g - w_).abs().max().item()
        tol = rel_tol * max(scale, 1.0)
        k64 = (g.double() - e).abs().max().item()
        p64 = (w_.double() - e).abs().max().item()
        f64_ratio = _f64_ratio(k64, p64)
        line = (f"{tag} {name}: max|kernel - plain| {err:.3e} (tol "
                f"{tol:.3e} = {rel_tol:.3e} x max(1, max|plain| "
                f"{scale:.3e})); vs float64 fp32 function: kernel "
                f"{k64:.3e}, plain {p64:.3e} (kernel / plain {f64_ratio:.3f}")
        ks, ps = summed[name]
        if bf16:  # the one draw from the fp32 function, and the summed
            f64_ratio = max(f64_ratio, _f64_ratio(ks, ps))
            line += (f"); vs float64 bf16 function, summed over {F64_DRAWS} "
                     f"draws: kernel {ks:.3e}, plain {ps:.3e} (kernel / "
                     f"plain {_f64_ratio(ks, ps):.3f}; budget "
                     f"{budget} for both")
        else:  # summed over the draws
            f64_ratio = _f64_ratio(ks, ps)
            line += (f"); summed over {F64_DRAWS} draws: kernel {ks:.3e}, "
                     f"plain {ps:.3e} (kernel / plain {f64_ratio:.3f}; "
                     f"budget {budget}")
        log(line + ")")
        if not err <= tol:
            raise AssertionError(f"{tag} {name} disagrees with its "
                                 f"plain version: {err} > {tol}")
        if not f64_ratio <= budget:
            raise AssertionError(f"{tag} {name} is {f64_ratio:.3f} times "
                                 f"farther from float64 than the plain "
                                 f"version")
        worst = max(worst, err / max(scale, 1.0))
        worst_abs = max(worst_abs, err)
        worst_f64 = max(worst_f64, f64_ratio)
    again = fused_gp.backward_kernel(*args, *cot, bf16=bf16)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{tag} differs between two runs")
    log(f"{tag}: two runs bit-equal in all eight gradients")

    launch = fused_gp.bwd_launcher(bf16)
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(t) for t in got]
    scratch = torch.empty(fused_gp.bwd_scratch_floats(b * n, d, m, bf16),
                          device=dev)
    ptrs = ([a.data_ptr() for a in args[:7]] + [c.data_ptr() for c in cot]
            + [o.data_ptr() for o in outs] + [scratch.data_ptr()])
    def run_kernel():
        if launch(*ptrs, b * n, d, m, stream):
            raise RuntimeError("fused_gp_bwd launch failed")

    with torch.inference_mode():
        ms = time_ms(run_kernel, 10)
        plain_ms = time_ms(
            lambda: fused_gp.whitened_marginals_affine_bwd_plain(
                *args, *cot, bf16=bf16), 5)
    r = b * n
    # the VJP's own work: K W (2 M^2 per row) and dW = -K^T diag(dvar) K
    # (fp32: symmetric, M (M + 1) per row; bf16: the rounded product is not,
    # 2 M^2); then K again (its distance as one product, 2d per element,
    # and 2 more), E zs and E^T xs (2 M d each), E and the row and column
    # sums (~8 per element), all fp32
    products = r * (2.0 * m * m + (2.0 * m * m if bf16 else m * (m + 1.0)))
    rest = r * (4.0 * m * d + (2.0 * d + 10.0) * m)
    nbytes = 4.0 * (2 * r * d + 2 * r + 2 * m * d + 2 * m + 2 * m * m
                    + 3 * d + 4)
    bound_ms, bound_by = (bound(rest, r * m, nbytes, products) if bf16
                          else bound(products + rest, r * m, nbytes))
    # the fp32 design's own bound: its five products (the cross term, K W,
    # E zs, E^T xs, dW) as six bf16 part products each at the tensor cores'
    # peak, the rest (8 an (R, M) element, 2 d a row) at the fp32 peak
    tc_ms = None if bf16 else bound(
        r * (10.0 * m + 2.0 * d), r * m, nbytes,
        6.0 * (products + r * 6.0 * m * d))[0]
    log(f"{tag}: kernel {ms:.4f} ms ({fused_gp.bwd_design(m, bf16)} design), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; K W and dW "
        f"{products / 1e9:.1f} GFLOP, the fp32 rest {rest / 1e9:.1f} GFLOP"
        + ("" if bf16 else f"; the design's tensor-core bound {tc_ms:.4f} "
           f"ms") + "); library: none")
    return {"name": "fused_gp.whitened_marginals_affine"
                    + ("_bf16 (bwd" if bf16 else " (bwd, fp32")
                    + (f", M {m})" if large_m else ")"),
            "route": "cuda", "source": _FUSED_GP_SOURCE,
            "replaces": _FUSED_GP_PALLAS + ":290", "on_path": not large_m,
            "shape": {"rows": r, "d": d, "M": m},
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "tolerance": rel_tol,
            "tolerance_is": "relative to max(1, max|plain|) per output",
            "design": fused_gp.bwd_design(m, bf16),
            "f64_dist_over_plain": worst_f64,
            **({} if bf16 else {"tc_bound_ms": tc_ms}),
            "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _by_kernel(fn, iters):
    """Device ms per call of ``fn`` by kernel name, from ``torch.profiler``
    over ``iters`` calls after two warm-up calls, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
    return {e.key: e.self_device_time_total / 1e3 / iters for e in kernels}


def fused_gp_bwd_launches(gen, shape, bf16=False, iters=5):
    """The fused-GP backward's device time by kernel (``torch.profiler``
    over ``iters`` calls, per call) at (b, n, d, m), the design that ran
    (``fused_gp.bwd_design``), the device scratch it allocates and the bytes
    it writes between its launches for later ones to read; and the same
    variant's forward by kernel (``fused_gp_fwd_by_kernel``)."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    b, n, d, m = shape
    tag = f"fused_gp{'_bf16' if bf16 else ''} bwd (rows {b * n}, d {d}, M {m})"
    args = _gp_inputs(gen, shape)
    cot = (torch.randn(b, n, device="cuda", generator=gen),
           torch.randn(b, n, device="cuda", generator=gen))
    by_kernel = _by_kernel(
        lambda: fused_gp.backward_kernel(*args, *cot, bf16=bf16), iters)
    if not by_kernel:
        raise AssertionError(f"{tag}: the profiler saw no device time")
    scratch = 4 * fused_gp.bwd_scratch_floats(b * n, d, m, bf16)
    design = fused_gp.bwd_design(m, bf16)
    # written by one launch for later ones (the scratch's (M, R) planes and
    # x's three bf16 parts, padded to whole 128 x 128 tiles as the kernels
    # write them): fp32 K and E (4 bytes an element each); bf16 K, bf16(K),
    # bf16(dvar o K) and E's three parts (14)
    rp, mp, dp = (-(-v // 128) * 128 for v in (b * n, m, d))
    between = (8 if not bf16 else 14) * mp * rp + 6 * rp * dp
    log(f"{tag}: design {design}; device scratch {scratch / 2 ** 20:.1f} "
        f"MiB; written between launches {between / 1e6:.1f} MB; device "
        f"time per call by kernel (sum {sum(by_kernel.values()):.4f} ms):")
    for key, ms in by_kernel.items():
        log(f"  {ms:9.4f} ms  {key[:150]}")
    out = {"design": design, "scratch_bytes": scratch,
           "between_launches_bytes": between,
           "device_ms_by_kernel": by_kernel}
    out.update(fused_gp_fwd_by_kernel(args, bf16, iters))
    return out


def fused_gp_fwd_by_kernel(args, bf16=False, iters=5):
    """The forward's device time by kernel on ``args`` (``torch.profiler``
    over ``iters`` calls, per call) and the scratch it allocates, which must
    be what ``fused_gp.fwd_plan`` lays out."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    b, n, d = args[0].shape
    m = args[1].shape[0]
    scratch = 4 * fused_gp.fwd_scratch_floats(b * n, d, m, bf16)
    plan = fused_gp.fwd_plan(b * n, d, m, bf16)
    if scratch != plan.total:
        raise AssertionError(f"the forward's scratch is {scratch} bytes, "
                             f"fwd_plan lays out {plan.total}")
    fwd = _by_kernel(lambda: fused_gp.forward_kernel(*args, bf16=bf16), iters)
    log(f"fused_gp{'_bf16' if bf16 else ''} fwd (rows {b * n}, d {d}, M {m}):"
        f" scratch {scratch / 2 ** 20:.1f} MiB; device time per call by "
        f"kernel (sum {sum(fwd.values()):.4f} ms):")
    for key, ms in fwd.items():
        log(f"  {ms:9.4f} ms  {key[:150]}")
    return {"fwd_scratch_bytes": scratch, "fwd_device_ms_by_kernel": fwd}


FLASH_CALLS = {"enc_self": P_ENC_LEN, "dec_self": P_DEC_LEN}
_FLASH_SOURCE = ("fine_grained_gaussian_process_forcasting_torch/csrc/"
                 "flash_attention.cu")
_FLASH_PALLAS = ("fine_grained_gaussian_process_forcasting_tpu/ops/pallas/"
                 "flash_attention.py")


def _flash_bound(row, bf16):
    """The bound of a flash call: its products at the bf16 peak for bf16
    operands, at the fp32 peak for fp32 ones."""
    if bf16:
        return bound(0.0, row["exps"], row["bytes"], row["flops"])
    return bound(row["flops"], row["exps"], row["bytes"])


def _sum_calls(rows, bf16):
    """One forecaster pass's calls summed into one kernel entry."""
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "flops", "exps",
                       "bytes")}
    return (total, *_flash_bound(total, bf16))


def check_flash(gen, dtype=torch.bfloat16, sm_bf16=False):
    """The flash-attention kernels of one operand dtype, forward and
    backward, at the production-width self-attention shapes (b 64, h 8,
    d 64; L 512 and 128) against their plain versions; two kernel entries.
    The production-width paths take the bf16 kernels; an fp32 model at d_k 64
    takes the fp32 ones, which no path of this script runs.  ``sm_bf16``: the
    variant whose softmax runs on bf16 values, which nothing routes to."""
    from torch.nn.functional import scaled_dot_product_attention

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        flash_attention as fa,
    )

    dev = "cuda"
    h, d = HEADS, P_D_MODEL // HEADS
    bf16 = dtype == torch.bfloat16
    dname = "bf16" if bf16 else "fp32"
    stream = torch.cuda.current_stream().cuda_stream
    tag = "flash_attention" + ("_bf16sm" if sm_bf16 else "") + f" {dname}"
    # bf16 operands, and the sm_bf16 softmax with either: relative to
    # max(1, max|plain|); fp32 with the fp32 softmax: |kernel - plain| over
    # (atol + rtol |plain|), which must stay within 1
    tol = TOL_SM16 if sm_bf16 else TOL_BF16
    mixed = not bf16 and not sm_bf16
    iters = 20 if bf16 else 5

    def errs(g, w_, rtol_atol):  # (absolute, the measure held to the limit)
        diff = (g.float() - w_.float()).abs()
        if mixed:
            rtol, atol = rtol_atol
            return diff.max().item(), (
                diff / (atol + rtol * w_.float().abs())).max().item()
        return diff.max().item(), diff.max().item() / max(
            1.0, w_.float().abs().max().item())

    fwd_rows, bwd_rows = [], []
    for call, length in FLASH_CALLS.items():
        q, k, v, do = (torch.randn(P_B, h, length, d, device=dev,
                                   generator=gen).to(dtype)
                       for _ in range(4))
        pairs = float(P_B * h * length * length)
        nbytes = float(q.element_size()) * P_B * h * length * d
        with torch.inference_mode():
            wrapper = (fa.fused_attention_bf16sm if sm_bf16
                       else fa.fused_attention)
            got = wrapper(q, k, v)
            out, stats = fa.forward_kernel(q, k, v, True, sm_bf16)
            grads = fa.backward_kernel(q, k, v, out, stats, do, sm_bf16)
            torch.cuda.synchronize()
            again = fa.backward_kernel(q, k, v, out, stats, do, sm_bf16)
            want = fa.fused_attention_plain(q, k, v, sm_bf16)
            want_grads = fa.fused_attention_bwd_plain(q, k, v, do, sm_bf16)
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                raise AssertionError(f"{tag} bwd {call} differs between "
                                     f"two runs")
            if not torch.equal(got, out):
                raise AssertionError(f"{tag} {call}: the forward with and "
                                     f"without its row statistics differ")
            abs_err, err = errs(got, want, TOL_FLASH_F32)
            bwd_abs_err, bwd_err = (max(e) for e in zip(
                *(errs(g, w_, TOL_FLASH_F32_BWD)
                  for g, w_ in zip(grads, want_grads))))
            bufs = [torch.empty_like(t) for t in (q, k, v)] + [
                torch.empty(P_B, h, length, device=dev)]
            o_lo = None if stats.o_lo is None else stats.o_lo.data_ptr()
            # inference (no statistics) and training (lse, and o_lo for
            # bf16): the forward with the statistics is what a training
            # step launches
            fwd_ptrs = [t.data_ptr() for t in (q, k, v, out)] + [None, None]
            train_ptrs = [t.data_ptr() for t in (q, k, v, out)] + [
                o_lo, stats.lse.data_ptr()]
            bwd_ptrs = [t.data_ptr() for t in (q, k, v, out)] + [
                o_lo, stats.lse.data_ptr(), do.data_ptr()] + [
                t.data_ptr() for t in bufs]
            fwd_launch, bwd_launch = fa.launcher(), fa.bwd_launcher()

            def run_fwd(ptrs=fwd_ptrs):
                if fwd_launch(*ptrs, P_B * h, length, length, d,
                              int(bf16), int(sm_bf16), stream):
                    raise RuntimeError("flash_attention_fwd launch failed")

            def run_bwd():
                if bwd_launch(*bwd_ptrs, P_B * h, length, length, d,
                              int(bf16), int(sm_bf16), stream):
                    raise RuntimeError("flash_attention_bwd launch failed")

            ms = time_ms(run_fwd, iters)
            train_ms = time_ms(lambda: run_fwd(train_ptrs), iters)
            bwd_ms = time_ms(run_bwd, max(iters // 2, 3))
            plain_ms = time_ms(
                lambda: fa.fused_attention_plain(q, k, v, sm_bf16), 5)
            plain_bwd_ms = time_ms(
                lambda: fa.fused_attention_bwd_plain(q, k, v, do, sm_bf16), 5)
            sdpa_fwd = time_ms(
                lambda: scaled_dot_product_attention(q, k, v), iters)
        sdpa_bwd = sdpa_bwd_ms(q, k, v, do, 10)
        fwd = {"call": call, "L": length, "max_abs_err": abs_err,
               "measure": err, "ms": ms, "ms_with_statistics": train_ms,
               "plain_ms": plain_ms, "library_ms": sdpa_fwd,
               "flops": 4.0 * pairs * d, "exps": pairs, "bytes": 4 * nbytes}
        bwd = {"call": call, "L": length, "max_abs_err": bwd_abs_err,
               "measure": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms,
               "library_ms": sdpa_bwd,
               "flops": 10.0 * pairs * d, "exps": pairs, "bytes": 7 * nbytes}
        for name, row, rtol_atol in (
                ("fwd", fwd, TOL_FLASH_F32),
                ("bwd (2 launches)", bwd, TOL_FLASH_F32_BWD)):
            row["bound_ms"], row["bound_by"] = _flash_bound(row, bf16)
            limit = 1.0 if mixed else tol
            what = (f"max|kernel - plain| / ({rtol_atol[1]} + {rtol_atol[0]} "
                    f"|plain|)" if mixed
                    else "max|kernel - plain| / max(1, max|plain|)")
            log(f"{tag} {name} {call} (b {P_B}, h {h}, L {length},"
                f" d {d}): {what} {row['measure']:.3e} (limit {limit:.3e}; "
                f"max|kernel - plain| {row['max_abs_err']:.3e}); kernel "
                f"{row['ms']:.4f} ms"
                + (f" (with the training statistics "
                   f"{row['ms_with_statistics']:.4f} ms)"
                   if "ms_with_statistics" in row else "")
                + f", plain {row['plain_ms']:.4f} ms, sdpa "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            if not row["measure"] <= limit:
                raise AssertionError(
                    f"{tag} {name} {call} disagrees with its plain "
                    f"version: {row['measure']} > {limit}")
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)

    entries = []
    for rows, what, line, library, rtol_atol in (
            (fwd_rows, "fwd", 126, "scaled_dot_product_attention",
             TOL_FLASH_F32),
            (bwd_rows, "bwd", 151,
             "scaled_dot_product_attention's backward kernels, device time "
             "under torch.profiler", TOL_FLASH_F32_BWD)):
        total, bound_ms, bound_by = _sum_calls(rows, bf16)
        # the two self-attention calls of one forecaster pass, summed
        entries.append({
            "name": "flash_attention.fused_attention"
                    + ("_bf16sm" if sm_bf16 else "") + f" ({what}, {dname})",
            "route": "cuda", "source": _FLASH_SOURCE,
            "replaces": f"{_FLASH_PALLAS}:{line}",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "measure": max(r["measure"] for r in rows),
            "tolerance": ({"rtol": rtol_atol[0], "atol": rtol_atol[1]}
                          if mixed else tol),
            "tolerance_is": ("measure = max|kernel - plain| / (atol + rtol "
                             "|plain|) <= 1" if mixed else
                             "measure = max|kernel - plain| / max(1, "
                             "max|plain|) per output <= tolerance"),
            "ms": total["ms"], "kernel_ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "library": library, "on_path": not sm_bf16,
            "calls": rows})
    return entries


# head dims the flash kernels pad in their tiles (the port refused them
# before): held against plain at a short self-attention, both dtypes
PADDED_D = (60, 72, 128, 256)
PADDED_B, PADDED_L = 8, 256


def check_flash_padded(gen, dtype):
    """The flash kernels at the padded head dims ``PADDED_D`` (b 8, h 8,
    L 256): forward and backward against their plain versions, two backward
    runs bit-equal, timed beside the plain version and SDPA; two kernel
    entries (forward, backward) whose calls are the head dims, on no path
    of this script."""
    from torch.nn.functional import scaled_dot_product_attention

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        flash_attention as fa,
    )

    bf16 = dtype == torch.bfloat16
    dname = "bf16" if bf16 else "fp32"
    h, length = HEADS, PADDED_L
    fwd_rows, bwd_rows = [], []
    for d in PADDED_D:
        q, k, v, do = (torch.randn(PADDED_B, h, length, d, device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(4))
        with torch.inference_mode():
            out, stats = fa.forward_kernel(q, k, v, True)
            grads = fa.backward_kernel(q, k, v, out, stats, do)
            again = fa.backward_kernel(q, k, v, out, stats, do)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                raise AssertionError(f"flash {dname} d {d}: two backward "
                                     f"runs differ")
            want = fa.fused_attention_plain(q, k, v)
            want_grads = fa.fused_attention_bwd_plain(q, k, v, do)
            ms = time_ms(lambda: fa.forward_kernel(q, k, v, False), 10)
            bwd_ms = time_ms(lambda: fa.backward_kernel(q, k, v, out, stats,
                                                        do), 5)
            plain_ms = time_ms(lambda: fa.fused_attention_plain(q, k, v), 3)
            plain_bwd_ms = time_ms(
                lambda: fa.fused_attention_bwd_plain(q, k, v, do), 3)
            sdpa_ms = time_ms(lambda: scaled_dot_product_attention(q, k, v),
                              10)
        sdpa_bwd = sdpa_bwd_ms(q, k, v, do, 5)
        pairs = float(PADDED_B * h * length * length)
        nbytes = float(q.element_size()) * PADDED_B * h * length * d
        for rows, g, w_, t, pt, lt, flops, nb, tol in (
                (fwd_rows, [out], [want], ms, plain_ms, sdpa_ms, 4.0, 4,
                 TOL_FLASH_F32),
                (bwd_rows, grads, want_grads, bwd_ms, plain_bwd_ms, sdpa_bwd,
                 10.0, 7, TOL_FLASH_F32_BWD)):
            diffs = [(a.float() - b_.float()).abs() for a, b_ in zip(g, w_)]
            abs_err = max(x.max().item() for x in diffs)
            if bf16:
                measure = max(x.max().item() / max(1.0, b_.float().abs().max(
                    ).item()) for x, b_ in zip(diffs, w_))
                limit = TOL_BF16
            else:
                measure = max((x / (tol[1] + tol[0] * b_.abs())).max().item()
                              for x, b_ in zip(diffs, w_))
                limit = 1.0
            row = {"d": d, "wgmma_width": fa.wgmma_width(d, dtype),
                   "max_abs_err": abs_err, "measure": measure, "ms": t,
                   "plain_ms": pt, "library_ms": lt,
                   "flops": flops * pairs * d, "exps": pairs,
                   "bytes": nb * nbytes}
            row["bound_ms"], row["bound_by"] = _flash_bound(row, bf16)
            what = "fwd" if rows is fwd_rows else "bwd"
            log(f"flash_attention {dname} {what} padded d {d} (b {PADDED_B}, "
                f"h {h}, L {length}; wgmma width {row['wgmma_width']}): "
                f"measure {measure:.3e} (limit {limit:.3e}; max|kernel - "
                f"plain| {abs_err:.3e}); kernel {t:.4f} ms, plain "
                f"{pt:.4f} ms, sdpa {lt:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            if not measure <= limit:
                raise AssertionError(f"flash {dname} {what} d {d} disagrees "
                                     f"with its plain version: {measure} > "
                                     f"{limit}")
            rows.append(row)
    entries = []
    for rows, what, line, tol in ((fwd_rows, "fwd", 126, TOL_FLASH_F32),
                                  (bwd_rows, "bwd", 151, TOL_FLASH_F32_BWD)):
        total, bound_ms, bound_by = _sum_calls(rows, bf16)
        entries.append({
            "name": f"flash_attention.fused_attention ({what}, {dname}, "
                    f"padded d {'/'.join(map(str, PADDED_D))})",
            "route": "cuda", "source": _FLASH_SOURCE,
            "replaces": f"{_FLASH_PALLAS}:{line}",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "measure": max(r["measure"] for r in rows),
            "tolerance": (TOL_BF16 if bf16 else
                          {"rtol": tol[0], "atol": tol[1]}),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": total["library_ms"],
            "library": "scaled_dot_product_attention", "on_path": False,
            "calls": rows})
    return entries


def check_head_folded_bwd(gen):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        head_folded_attention as hfa,
    )

    dev = "cuda"
    d = D_MODEL // HEADS
    launch = hfa.bwd_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "flops": 0.0, "exps": 0.0, "bytes": 0.0}
    err_all = 0.0
    for call, (lq, lk) in ATTENTION_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        do = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        with torch.inference_mode():
            out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
            got = hfa.backward_kernel(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
            err = max((g - w_).abs().max().item()
                      for g, w_ in zip(got, want))
            bufs = [torch.empty_like(t) for t in got] + [torch.empty_like(lse)]
            ptrs = [t.data_ptr() for t in (q, k, v, out, lse, do)] + [
                t.data_ptr() for t in bufs]

            def run_kernel():
                if launch(*ptrs, B * HEADS, lq, lk, d, stream):
                    raise RuntimeError("head_folded_attention_bwd failed")

            ms = time_ms(run_kernel, 50)
            plain_ms = time_ms(
                lambda: hfa.head_folded_attention_bwd_plain(q, k, v, do), 20)
        library_ms = sdpa_bwd_ms(q, k, v, do, 20)
        pairs = B * HEADS * lq * lk
        # the VJP's work per (query, key) pair: scores and P (2d + 1 exp),
        # dV, dP, dQ, dK (2d each), dS (3)
        flops, exps = (10.0 * d + 3.0) * pairs, float(pairs)
        nbytes = 4.0 * B * HEADS * d * (3 * lq + 4 * lk)
        bound_ms, bound_by = bound(flops, exps, nbytes)
        log(f"head_folded_attention bwd {call} (b {B}, h {HEADS}, Lq {lq}, "
            f"Lk {lk}, d {d}): max|kernel - plain| {err:.3e} (tol "
            f"{TOL_ATTENTION_BWD}); kernel {ms:.4f} ms (2 launches), plain "
            f"{plain_ms:.4f} ms, sdpa bwd (its kernels' device time) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not err <= TOL_ATTENTION_BWD:
            raise AssertionError(
                f"head_folded_attention bwd {call} disagrees with its plain "
                f"version: {err} > {TOL_ATTENTION_BWD}")
        err_all = max(err_all, err)
        rows.append({"call": call, "lq": lq, "lk": lk, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("flops", flops),
                         ("exps", exps), ("bytes", nbytes)):
            total[key] += val
    bound_ms, bound_by = bound(total["flops"], total["exps"], total["bytes"])
    # the three calls of one forecaster pass, summed
    return {"name": "head_folded_attention (bwd, fp32)", "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "head_folded_attention.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/head_folded_attention.py:139",
            "max_abs_err": err_all, "tolerance": TOL_ATTENTION_BWD,
            "ms": total["ms"], "kernel_ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "library": "scaled_dot_product_attention's backward kernels, "
                       "device time under torch.profiler",
            "calls": rows}


# small-head attention (d <= 8), on no path: the flagship's three calls at
# d 4, timed, and d 2 (the HPO grid's d_model 16) and d 8 at enc-self, held
# for correctness; (Lq, Lk, d)
SMALL_HEAD_CALLS = {"enc_self": (ENC_LEN, ENC_LEN, 4),
                    "dec_self": (DEC_LEN, DEC_LEN, 4),
                    "dec_cross": (DEC_LEN, ENC_LEN, 4),
                    "enc_self_d2": (ENC_LEN, ENC_LEN, 2),
                    "enc_self_d8": (ENC_LEN, ENC_LEN, 8)}
SMALL_HEAD_TIMED = ("enc_self", "dec_self", "dec_cross")
# the JAX package's tolerances for that kernel (tests/test_pallas_kernels.py):
# (rtol, atol), held as max|kernel - plain| / (atol + rtol |plain|) <= 1
TOL_SMALL_HEAD = (1e-4, 1e-5)
TOL_SMALL_HEAD_BWD = (2e-3, 1e-4)
_SMALL_HEAD_SOURCE = ("fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "small_head_attention.cu")
_SMALL_HEAD_PALLAS = ("fine_grained_gaussian_process_forcasting_tpu/ops/"
                      "pallas/small_head_attention.py")


def check_small_head(gen):
    """The small-head kernels, forward and backward, against their plain
    versions; the flagship's calls timed beside the plain version, SDPA and
    the port's head-folded kernel at the same shapes.  Bounds from the JAX
    kernel's cost estimate: forward 4 n Lq Lk d flops, n Lq Lk
    exponentials, 4 n (2 Lq + 2 Lk) d bytes; backward 12 n Lq Lk d flops,
    n Lq Lk exponentials, 4 n (3 Lq + 4 Lk) d bytes.  Both forwards are
    timed writing each row's log-sum-exp, as their autograd Functions run
    them.  No path reaches it: two entries, ``on_path`` false."""
    from torch.nn.functional import scaled_dot_product_attention

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        head_folded_attention as hfa,
        small_head_attention as sha,
    )

    dev = "cuda"
    n = B * HEADS
    fwd_launch, bwd_launch = sha.launcher(), sha.bwd_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    keys = ("ms", "plain_ms", "library_ms", "head_folded_ms", "flops", "exps",
            "bytes")
    totals = {"fwd": dict.fromkeys(keys, 0.0), "bwd": dict.fromkeys(keys, 0.0)}
    rows = {"fwd": [], "bwd": []}
    worst = {"fwd": (0.0, 0.0), "bwd": (0.0, 0.0)}
    for call, (lq, lk, d) in SMALL_HEAD_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        do = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        with torch.inference_mode():
            got = sha.small_head_attention(q, k, v)
            out, lse = sha.forward_kernel(q, k, v)
            grads = sha.backward_kernel(q, k, v, out, lse, do)
            again = sha.backward_kernel(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            err_f = _measure(got, sha.small_head_attention_plain(q, k, v),
                             TOL_SMALL_HEAD)
            want = sha.small_head_attention_bwd_plain(q, k, v, do)
            errs = [_measure(g, w_, TOL_SMALL_HEAD_BWD)
                    for g, w_ in zip(grads, want)]
            err_b = (max(e[0] for e in errs), max(e[1] for e in errs))
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
        log(f"small_head_attention {call} (b {B}, h {HEADS}, Lq {lq}, Lk "
            f"{lk}, d {d}): fwd max|kernel - plain| {err_f[0]:.3e} "
            f"({err_f[1]:.3f} of the tolerance {TOL_SMALL_HEAD}); bwd "
            f"{err_b[0]:.3e} ({err_b[1]:.3f} of {TOL_SMALL_HEAD_BWD}); two "
            f"backward runs bit-equal: {same}")
        if not (err_f[1] <= 1.0 and err_b[1] <= 1.0 and same):
            raise AssertionError(
                f"small_head_attention {call}: fwd {err_f}, bwd {err_b}, "
                f"bit-equal {same}")
        for way, err in (("fwd", err_f), ("bwd", err_b)):
            worst[way] = max(worst[way], err, key=lambda e: e[1])
        if call not in SMALL_HEAD_TIMED:
            continue
        with torch.inference_mode():
            fwd_out, fwd_lse = torch.empty_like(q), torch.empty_like(lse)
            bufs = [torch.empty_like(t) for t in (q, k, v, lse)]
            fwd_ptrs = [t.data_ptr() for t in (q, k, v, fwd_out, fwd_lse)]
            bwd_ptrs = [t.data_ptr() for t in (q, k, v, out, lse, do)] + [
                t.data_ptr() for t in bufs]

            def run_fwd():
                if fwd_launch(*fwd_ptrs, n, lq, lk, d, stream):
                    raise RuntimeError("small_head_attention_fwd failed")

            def run_bwd():
                if bwd_launch(*bwd_ptrs, n, lq, lk, d, stream):
                    raise RuntimeError("small_head_attention_bwd failed")

            hf_out, hf_lse = hfa.forward_kernel(q, k, v, with_lse=True)
            timed = {
                "fwd": {"ms": time_ms(run_fwd, 50),
                        "plain_ms": time_ms(lambda: sha.small_head_attention_plain(
                            q, k, v), 20),
                        "library_ms": time_ms(
                            lambda: scaled_dot_product_attention(q, k, v), 20),
                        "head_folded_ms": time_ms(
                            lambda: hfa.forward_kernel(q, k, v, True), 50)},
                "bwd": {"ms": time_ms(run_bwd, 50),
                        "plain_ms": time_ms(
                            lambda: sha.small_head_attention_bwd_plain(
                                q, k, v, do), 20),
                        "head_folded_ms": time_ms(
                            lambda: hfa.backward_kernel(q, k, v, hf_out,
                                                        hf_lse, do), 50)}}
        timed["bwd"]["library_ms"] = sdpa_bwd_ms(q, k, v, do, 20)
        pairs = float(n * lq * lk)
        work = {"fwd": (4.0 * pairs * d, pairs, 4.0 * n * (2 * lq + 2 * lk) * d),
                "bwd": (12.0 * pairs * d, pairs,
                        4.0 * n * (3 * lq + 4 * lk) * d)}
        for way in ("fwd", "bwd"):
            flops, exps, nbytes = work[way]
            bound_ms, bound_by = bound(flops, exps, nbytes)
            t = timed[way]
            log(f"small_head_attention {way} {call}: kernel {t['ms']:.4f} ms"
                f"{' (2 launches)' if way == 'bwd' else ''}, plain "
                f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, "
                f"head-folded kernel {t['head_folded_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            rows[way].append({"call": call, "lq": lq, "lk": lk, "d": d,
                              "bound_ms": bound_ms, "bound_by": bound_by, **t})
            for key, val in (*t.items(), ("flops", flops), ("exps", exps),
                             ("bytes", nbytes)):
                totals[way][key] += val
    entries = []
    for way, line, tol in (("fwd", 126, TOL_SMALL_HEAD),
                           ("bwd", 148, TOL_SMALL_HEAD_BWD)):
        t = totals[way]
        bound_ms, bound_by = bound(t["flops"], t["exps"], t["bytes"])
        # the three flagship-shaped calls, summed
        entries.append({
            "name": f"small_head_attention ({way}, fp32)", "route": "cuda",
            "source": _SMALL_HEAD_SOURCE,
            "replaces": f"{_SMALL_HEAD_PALLAS}:{line}",
            "max_abs_err": worst[way][0], "err_over_tolerance": worst[way][1],
            "tolerance": tol, "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"],
            "library": ("scaled_dot_product_attention" if way == "fwd" else
                        "scaled_dot_product_attention's backward kernels, "
                        "device time under torch.profiler"),
            "head_folded_ms": t["head_folded_ms"], "on_path": False,
            "calls": rows[way]})
    return entries


@dataclasses.dataclass(frozen=True)
class Config:
    """One model configuration and how deep this script drives it."""

    name: str
    attn_type: str
    batch: int
    enc_len: int
    dec_len: int
    pred: int
    features: int
    d_model: int
    layers: int
    bf16: bool
    n_windows: int  # served: full batches and a ragged tail
    n_check: int  # windows compared with the CPU run
    per_batch: dict  # kernel launches of one served batch
    per_step: dict  # kernel launches of one training step
    gp: dict = dataclasses.field(default_factory=dict)  # GP options
    # gradients that the training check may also judge against float64
    f64_leaves: tuple = ()
    # gradients that are 0 in exact arithmetic (fnmatch patterns): residue
    # on both devices, held below ZERO_GRAD of the step's largest gradient
    zero_leaves: tuple = ()
    epochs: int = N_EPOCHS  # timed epochs of training
    steps: int = N_TRAIN_STEPS  # steps per timed epoch

    def model(self, device: str):
        from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
            ForecastDenoising,
        )

        # the production-width GP starts at lengthscale sqrt(2 d): at the
        # default 0.69 every K[r, m] underflows to 0 in d 512 and the card's
        # GP marginals could not be told from the CPU's
        extra = dict(compute_dtype=torch.bfloat16,
                     gp_compute_dtype=torch.bfloat16,
                     gp_ls_init=-1.0) if self.bf16 else {}
        extra.update(self.gp)
        return ForecastDenoising(
            src_input_size=self.features, tgt_input_size=self.features,
            d_model=self.d_model, n_heads=HEADS, d_k=self.d_model // HEADS,
            stack_size=self.layers, pred_len=self.pred,
            attn_type=self.attn_type, gp=True, denoise=True,
            num_inducing=INDUCING, device=device,
            generator=torch.Generator().manual_seed(SEED), **extra)

    def windows(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(n, self.enc_len, self.features)).astype(
                    np.float32),
                rng.normal(size=(n, self.dec_len, self.features)).astype(
                    np.float32))

    def training_data(self, n: int, seed: int):
        """n batches drawn on the host from the seed, as windows would be,
        on the card."""
        rng = np.random.default_rng(seed)
        shape = (n, self.batch)
        enc = rng.normal(size=shape + (self.enc_len, self.features))
        dec = rng.normal(size=shape + (self.dec_len, self.features))
        y = (0.5 * dec[..., -self.pred:, :1]
             + 0.1 * rng.normal(size=shape + (self.pred, 1)))
        return tuple(torch.from_numpy(a.astype(np.float32)).to("cuda")
                     for a in (enc, dec, y))


_NONE = dict.fromkeys(
    ("fused_gp", "fused_gp_bwd", "head_folded_attention",
     "head_folded_attention_bwd", "fused_gp_bf16", "fused_gp_bf16_bwd",
     "flash_attention", "flash_attention_bwd", "flash_attention_bf16sm",
     "flash_attention_bf16sm_bwd", "flash_attention_fp32",
     "flash_attention_fp32_bwd", "rbf", "cholesky", "small_head_attention",
     "small_head_attention_bwd"), 0)
_FLAGSHIP = dict(batch=B, enc_len=ENC_LEN, dec_len=DEC_LEN, pred=PRED,
                 features=F, d_model=D_MODEL, layers=LAYERS, bf16=False,
                 n_windows=N_WINDOWS, n_check=N_CHECK)
CONFIGS = (
    Config("autoformer", "autoformer", **_FLAGSHIP,
           per_batch=dict(_NONE, fused_gp=1),
           per_step=dict(_NONE, fused_gp=1, fused_gp_bwd=1)),
    # head-folded attention: enc-self, dec-self, dec-cross, in both passes
    Config("basic", "basic", **_FLAGSHIP,
           per_batch=dict(_NONE, fused_gp=1, head_folded_attention=6),
           per_step=dict(_NONE, fused_gp=1, fused_gp_bwd=1,
                         head_folded_attention=6,
                         head_folded_attention_bwd=6)),
    # flash attention: enc-self and dec-self of two layers, in both passes;
    # cross-attention at d_k 64 is plain
    Config("prod_basic", "basic", batch=P_B, enc_len=P_ENC_LEN,
           dec_len=P_DEC_LEN, pred=P_PRED, features=P_F, d_model=P_D_MODEL,
           layers=P_LAYERS, bf16=True, n_windows=P_N_WINDOWS,
           n_check=P_N_CHECK,
           per_batch=dict(_NONE, fused_gp_bf16=1, flash_attention=8),
           per_step=dict(_NONE, fused_gp_bf16=1, fused_gp_bf16_bwd=1,
                         flash_attention=8, flash_attention_bwd=8)),
    # the flagship with a hidden layer of 8 GPs on the Pallas route
    # (--gp_hidden_dims 8 --use_pallas_gp True --gp_ls_init auto): the
    # hidden layer's K through the rbf kernel, one launch for the 8 GPs; the
    # scalar output layer (d 8) through the fused GP
    Config("multilayer", "autoformer", **_FLAGSHIP,
           per_batch=dict(_NONE, rbf=1, fused_gp=1),
           per_step=dict(_NONE, rbf=1, fused_gp=1, fused_gp_bwd=1),
           gp=dict(gp_hidden_dims=(ML_HIDDEN,), use_pallas_gp=True,
                   gp_ls_init=-1.0),
           # the output layer's W = L^-T diag(1 - s^2) L^-1 of a 512-point
           # Gram matrix in d 8 reaches ~1e4 once q(u) leaves the prior: the
           # gradients that pass through it carry ~1e-3 of fp32 error on
           # either device
           f64_leaves=tuple(f"deep_gp.output_layer.{n}" for n in (
               "inducing_points", "raw_lengthscale", "raw_outputscale",
               "variational_log_stddev"))),
    # the flagship with the exact-GP blur (--gp_kind exact, noise init 0.1,
    # lengthscale auto: RESULTS.md's n01_lsauto arm); its factorizations are
    # the library's, as in JAX, so it launches no hand kernel
    Config("exact", "autoformer", **_FLAGSHIP, per_batch=_NONE,
           per_step=_NONE,
           gp=dict(gp_kind="exact", exact_noise_init=0.1, gp_ls_init=-1.0)),
    # conv_attn at the production width in fp32 with the flag (d_model 512,
    # 8 heads, d_k 64; --d_model_choices 512 --use_pallas_attention True):
    # the conv family's softmax attention on the fp32 flash kernels, enc-self,
    # dec-self and dec-cross in both passes; one served batch and a few steps
    Config("conv_attn_wide", "conv_attn", batch=C_B, enc_len=ENC_LEN,
           dec_len=DEC_LEN, pred=PRED, features=F, d_model=P_D_MODEL,
           layers=LAYERS, bf16=False, n_windows=C_B, n_check=P_N_CHECK,
           per_batch=dict(_NONE, fused_gp=1, flash_attention_fp32=6),
           per_step=dict(_NONE, fused_gp=1, fused_gp_bwd=1,
                         flash_attention_fp32=6, flash_attention_fp32_bwd=6),
           gp=dict(use_pallas_attention=True), epochs=1, steps=4),
)


class _DelayRecorder:
    """Wraps ``auto_correlation`` in the transformer module and keeps the
    top-k delays each call chose: the batch's shared set, (top_k,), in
    training; per sample, (b, top_k), in eval.  Given ``replay`` (another
    run's ``delays``), each call uses those instead, and ``delays`` still
    records what this run would have chosen."""

    def __init__(self, replay=None):
        from fine_grained_gaussian_process_forcasting_torch.models import (
            transformer,
        )

        self.module = transformer
        self.original = transformer.auto_correlation
        self.replay = replay
        self.delays = []

    def __enter__(self):
        def recording(q, k, v, factor=1, training=True):
            forced = None
            if self.replay is not None:
                forced = self.replay[len(self.delays)].to(q.device)
                forced = forced if training else forced[: q.shape[0]]
            ctx, mean_value = self.original(q, k, v, factor=factor,
                                            training=training, delays=forced)
            top_k = int(factor * math.log(q.shape[2]))
            if training:
                idx = torch.topk(mean_value.mean(0), top_k).indices
            else:
                idx = torch.topk(mean_value, top_k, dim=-1).indices
            self.delays.append(idx.cpu())
            return ctx, mean_value

        self.module.auto_correlation = recording
        return self

    def __exit__(self, *exc):
        self.module.auto_correlation = self.original


class _ReluRecorder:
    """Keeps, per call, where each feed-forward layer's pre-activation is
    positive.  Given ``replay`` (another run's ``masks``), a pre-activation
    on the other side of zero (a value within rounding of it) is moved to
    the replayed side, keeping its gradient, so that both runs differentiate
    the same linear piece: one unit flipping for one token moves that unit's
    weight gradients by the token's whole share.  ``flips`` counts them."""

    def __init__(self, model, replay=None):
        from fine_grained_gaussian_process_forcasting_torch.models.transformer import (
            FeedForward,
        )

        self.layers = [m.w1 for m in model.modules()
                       if isinstance(m, FeedForward)]
        self.replay = replay
        self.masks, self.flips, self.hooks = [], 0, []

    def __enter__(self):
        def hook(module, args, out):
            mask = out > 0
            if self.replay is not None:
                want = self.replay[len(self.masks)].to(out.device)
                self.flips += int((want != mask).sum())
                side = torch.where(want, out.clamp_min(1e-30),
                                   out.clamp_max(0.0))
                out = side.detach() + (out - out.detach())  # side, exactly
            self.masks.append(mask.cpu())
            return out

        self.hooks = [layer.register_forward_hook(hook)
                      for layer in self.layers]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


class _EpsRecorder:
    """Wraps the deep GP's ``draw_eps`` and keeps each hidden layer's draws.
    Given ``replay`` (another run's ``draws``), each call returns those
    instead, cut to this call's batch (a served batch is padded on the card,
    not on the CPU), on this run's device.  For serving, whose session takes
    no draws; a training step is handed them as ``gp_eps``."""

    def __init__(self, replay=None):
        from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp

        self.module = deep_gp
        self.original = deep_gp.draw_eps
        self.replay = replay
        self.draws = []

    def __enter__(self):
        def recording(shape, generator, like):
            if self.replay is not None:
                eps = self.replay[len(self.draws)][: shape[0]].to(like.device)
            else:
                eps = self.original(shape, generator, like)
            self.draws.append(eps.cpu())
            return eps

        self.module.draw_eps = recording
        return self

    def __exit__(self, *exc):
        self.module.draw_eps = self.original


class _ScaleMaxRecorder:
    """Wraps ATA's top-1 over scales (``conv_attention.relu_scale_max``) and
    keeps, per call, which scale won each (position, channel) and whether
    the winner was positive.  Given ``replay`` (another run's ``choices``),
    each call takes the replayed scale, on the replayed side of zero (a value
    within rounding of it is moved there, keeping its gradient), so that both
    runs differentiate the same piece: a near-tie between two scales, or a
    winner within rounding of 0, can fall the other way on another device.
    ``flips`` counts where this run's own choice differed."""

    def __init__(self, replay=None):
        from fine_grained_gaussian_process_forcasting_torch.ops import (
            conv_attention,
        )

        self.module = conv_attention
        self.original = conv_attention.relu_scale_max
        self.replay = replay
        self.choices, self.flips = [], 0

    def __enter__(self):
        def recording(pre):
            top, idx = pre.max(dim=-1)
            positive = top > 0
            self.choices.append((idx.cpu(), positive.cpu()))
            if self.replay is None:
                return self.original(pre)
            want_idx, want_pos = (t.to(pre.device)
                                  for t in self.replay[len(self.choices) - 1])
            self.flips += int(((want_idx != idx) & want_pos
                               | (want_pos != positive)).sum())
            sel = pre.gather(-1, want_idx[..., None])[..., 0]
            grad = torch.where(want_pos, sel - sel.detach(),
                               torch.zeros_like(sel))
            return torch.where(want_pos, sel.detach().clamp_min(1e-30),
                               torch.zeros_like(sel)) + grad

        self.module.relu_scale_max = recording
        return self

    def __exit__(self, *exc):
        self.module.relu_scale_max = self.original


def _differing(chosen, replayed):
    """Per call: where this run's own top-k set differs from the one it
    replayed (per window in eval, one flag in training)."""
    return [(a.sort(-1).values != b[: a.shape[0]].sort(-1).values).any(-1)
            for a, b in zip(chosen, replayed)]


def profile_device(fn, label: str, wall_ms: float):
    """Device time of ``fn()`` by kernel (``torch.profiler``), and the
    device's idle share of ``wall_ms``, the median wall time of the same
    work without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side kernels only: the CPU op that launched a kernel reports
    # the same device time again, and so does a user annotation (such as
    # the optimizer's step) that spans kernels on the device
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = [e for e in events if not e.is_user_annotation]
    spans = [e.key for e in events if e.is_user_annotation]
    if spans:
        log(f"profile {label}: annotations not counted as kernels: {spans}")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"profile {label}: device busy {busy_ms:.4f} ms in {launches} "
        f"kernel launches; idle share of the {wall_ms:.3f} ms median "
        f"{1.0 - busy_ms / wall_ms:.3f}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")
    return {"busy_ms": busy_ms, "launches": launches,
            "idle_share": 1.0 - busy_ms / wall_ms}


def _counters():
    """The launch counters, by kernel: (wrapper module, counter name)."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        cholesky,
        flash_attention,
        fused_gp,
        head_folded_attention,
        rbf,
        small_head_attention,
    )

    return {"fused_gp": (fused_gp, "launches"),
            "fused_gp_bwd": (fused_gp, "bwd_launches"),
            "head_folded_attention": (head_folded_attention, "launches"),
            "head_folded_attention_bwd": (head_folded_attention,
                                          "bwd_launches"),
            "fused_gp_bf16": (fused_gp, "bf16_launches"),
            "fused_gp_bf16_bwd": (fused_gp, "bf16_bwd_launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "flash_attention_bf16sm": (flash_attention, "sm16_launches"),
            "flash_attention_bf16sm_bwd": (flash_attention,
                                           "sm16_bwd_launches"),
            "flash_attention_fp32": (flash_attention, "f32_launches"),
            "flash_attention_fp32_bwd": (flash_attention,
                                         "f32_bwd_launches"),
            "rbf": (rbf, "launches"),
            "cholesky": (cholesky, "launches"),
            "small_head_attention": (small_head_attention, "launches"),
            "small_head_attention_bwd": (small_head_attention,
                                         "bwd_launches")}


def zero_counts():
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def read_counts():
    """The launch counts; the flash wrapper's own counters take every
    operand dtype, so "flash_attention" here is the bf16 share and
    "flash_attention_fp32" the fp32 one."""
    counts = {name: getattr(module, attr)
              for name, (module, attr) in _counters().items()}
    for key in ("flash_attention", "flash_attention_bwd"):
        counts[key] -= counts[key.replace("attention", "attention_fp32")]
    return counts


def serve(cfg: Config, card: str):
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    b = cfg.batch
    enc, dec = cfg.windows(cfg.n_windows, SEED)
    model = cfg.model("cuda")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=b, device="cuda")
    session.predict(enc[:b], dec[:b])  # warm-up: cuBLAS/cuFFT plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    out = session.predict(enc, dec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_batches = -(-cfg.n_windows // b)
    expect = {k: n_batches * v for k, v in cfg.per_batch.items()}
    if out.shape != (cfg.n_windows, cfg.pred, 1):
        raise AssertionError(f"{cfg.name}: output shape {out.shape}")
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{cfg.name}: non-finite predictions")
    if counts != expect:
        raise AssertionError(f"{cfg.name}: launches {counts}, expected "
                             f"{expect}")

    batch_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        session.predict(enc[:b], dec[:b])
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"serving {cfg.name} on {card}: {cfg.n_windows} windows in "
        f"{wall * 1e3:.2f} ms ({cfg.n_windows / wall:.1f} windows/s); per "
        f"batch of {b}: median {float(np.median(batch_ms)):.3f} ms "
        f"(runs {', '.join(f'{t:.3f}' for t in batch_ms)}); peak memory "
        f"{peak / 2**20:.1f} MiB; launches {counts}")
    profile_device(lambda: session.predict(enc[:b], dec[:b]),
                   f"serving {cfg.name}, one batch of {b}",
                   float(np.median(batch_ms)))

    # the first windows against the port's own CPU run, same weights and
    # the card's delays
    n = cfg.n_check
    cpu = InferenceSession(cfg.model("cpu"), state, batch_size=n,
                           device="cpu")
    with _DelayRecorder() as rec_gpu, _EpsRecorder() as eps_gpu:
        gpu_first = session.predict(enc[:n], dec[:n])
    with _DelayRecorder(replay=rec_gpu.delays) as rec_cpu, \
            _EpsRecorder(replay=eps_gpu.draws):
        cpu_first = cpu.predict(enc[:n], dec[:n])
    flipped = torch.zeros(n, dtype=torch.bool)
    for differs in _differing(rec_cpu.delays, rec_gpu.delays):
        flipped |= differs
    max_diff = float(np.abs(gpu_first - cpu_first).max())
    tol = (TOL_SERVING_BF16 * float(np.abs(cpu_first).max()) if cfg.bf16
           else TOL_SERVING)
    log(f"{cfg.name}: max|cuda - cpu| over {n} windows "
        f"{max_diff:.3e} (tol {tol:.3e}; mean|cuda - cpu| "
        f"{float(np.abs(gpu_first - cpu_first).mean()):.3e}, max|cpu| "
        f"{float(np.abs(cpu_first).max()):.3e}); windows whose own delays "
        f"differ on the cpu (replayed the card's): "
        f"{torch.nonzero(flipped).flatten().tolist()}")
    if not max_diff <= tol:
        raise AssertionError(f"{cfg.name}: cuda and cpu disagree: "
                             f"{max_diff} > {tol}")
    return counts, {"windows_compared": n, "max_abs_diff": max_diff,
                    "tolerance": tol,
                    "delays_replayed_windows": int(flipped.sum())}


def check_step_against_cpu(cfg: Config, params, batch):
    """Loss and every parameter gradient of one training step on the card
    against the same step of the port's CPU run: same weights, the first
    ``cfg.n_check`` windows, the same deep-GP draws (drawn once on the
    card, passed to both as ``gp_eps``)."""
    tol = TOL_TRAIN_BF16 if cfg.bf16 else TOL_TRAIN
    tol_loss = TOL_LOSS_BF16 if cfg.bf16 else TOL_TRAIN
    draw_gen = torch.Generator("cuda").manual_seed(SEED)
    gp_eps = [torch.randn((cfg.n_check, cfg.enc_len + cfg.dec_len, h),
                          generator=draw_gen, device="cuda")
              for h in cfg.gp.get("gp_hidden_dims", ())]

    def step(model, device, replay=None, masks=None, scales=None,
             dtype=torch.float32):
        enc, dec, y = (t[:cfg.n_check].to(device, dtype) for t in batch)
        with _DelayRecorder(replay=replay) as rec, \
                _ReluRecorder(model, replay=masks) as relu, \
                _ScaleMaxRecorder(replay=scales) as top:
            out = model(enc, dec, y, training=True,
                        generator=torch.Generator(device).manual_seed(SEED),
                        gp_eps=[e.to(device, dtype) for e in gp_eps] or None)
        out.loss.backward()
        return out.loss.item(), {n: p.grad.detach().cpu()
                                 for n, p in model.named_parameters()}, \
            rec, relu, top

    model = cfg.model("cuda")
    model.load_state_dict(params)
    loss_g, grads_g, rec_g, relu_g, top_g = step(model, "cuda")
    # the cpu takes the card's delays, its side of every ReLU and its top
    # scale of every ATA pyramid
    replay, masks, scales = rec_g.delays, relu_g.masks, top_g.choices
    model = cfg.model("cpu")
    model.load_state_dict(params)
    loss_c, grads_c, rec, relu, top = step(model, "cpu", replay, masks,
                                           scales)
    flipped = [i for i, differs in
               enumerate(_differing(rec.delays, replay)) if differs]
    if replay:
        log(f"train {cfg.name}: shared top-k delays per call on the card "
            f"{[d.sort().values.tolist() for d in replay]}; calls whose own "
            f"delays differ on the cpu (replayed the card's): {flipped}")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    worst_name, worst = "", 0.0
    # a gradient a million times smaller than the largest one (the inert
    # GP's lengthscale and inducing points at the default init: ~1e-18) is
    # rounding residue on both devices, so its error is held to that floor
    largest = max(g.abs().max().item() for g in grads_c.values())
    floor = 1e-6 * largest
    over, zero_resid = {}, 0.0
    for name, gc in grads_c.items():
        if grads_g[name].dtype != torch.float32:
            raise AssertionError(f"train {cfg.name}: gradient of {name} is "
                                 f"{grads_g[name].dtype}")
        if any(fnmatch.fnmatch(name, pat) for pat in cfg.zero_leaves):
            resid = max(gc.abs().max().item(),
                        grads_g[name].abs().max().item()) / largest
            zero_resid = max(zero_resid, resid)
            if not resid <= ZERO_GRAD:
                over[name] = resid
            continue
        scale = max(gc.abs().max().item(), floor)
        err = (grads_g[name] - gc).abs().max().item()
        rel = err / scale if scale > 0 else err
        if rel > tol:
            over[name] = rel
        if rel > worst:
            worst_name, worst = name, rel
    if loss_err > tol_loss:
        over["loss"] = loss_err
    # a gradient named in cfg.f64_leaves that misses the tolerance passes
    # if it is within 10x of it and the card lies no farther from a float64
    # CPU run than the fp32 CPU run does, twice over
    f64 = {}
    if set(over) & set(cfg.f64_leaves):
        model = cfg.model("cpu").double()
        model.load_state_dict(params)
        _, grads64, _, _, _ = step(model, "cpu", replay, masks, scales,
                                   torch.float64)
        for name in set(over) & set(cfg.f64_leaves):
            err64 = [(t[name].double() - grads64[name]).abs().max().item()
                     for t in (grads_g, grads_c)]
            f64[name] = {"cuda": err64[0], "cpu_fp32": err64[1]}
            log(f"train {cfg.name}: {name} {over[name]:.3e} over; against "
                f"float64 on the cpu: cuda {err64[0]:.3e}, cpu fp32 "
                f"{err64[1]:.3e}")
            if over[name] <= 10 * tol and err64[0] <= 2.0 * err64[1]:
                del over[name]
    log(f"train {cfg.name}: one step on {cfg.n_check} windows, cuda vs cpu: "
        f"loss {loss_g:.7f} vs {loss_c:.7f} (rel diff {loss_err:.3e}, tol "
        f"{tol_loss:.3e}); worst gradient {worst_name}: max|cuda - cpu| / "
        f"max(max|cpu|, floor {floor:.1e}) {worst:.3e} over "
        f"{len(grads_c)} parameters (tol {tol:.3e})"
        + (f"; gradients 0 in exact arithmetic ({cfg.zero_leaves}): largest "
           f"on either device {zero_resid:.3e} of the largest gradient "
           f"(bound {ZERO_GRAD:.0e})" if cfg.zero_leaves else "")
        + "; feed-forward "
        f"pre-activations moved to the card's side of zero on the cpu: "
        f"{relu.flips} of {sum(m.numel() for m in masks)}"
        + (f"; ATA top-1 scales (or their side of zero) replayed from the "
           f"card on the cpu: {top.flips} of "
           f"{sum(c[0].numel() for c in scales)}" if scales else ""))
    if over:
        raise AssertionError(f"train {cfg.name}: cuda and cpu disagree: "
                             f"{over}")
    return {"windows_compared": cfg.n_check,
            "max_rel_diff": max(loss_err, worst), "tolerance": tol,
            "judged_against_float64": f64,
            "delays_replayed_calls": len(flipped),
            "relu_sides_replayed": relu.flips,
            "ata_scales_replayed": top.flips,
            "zero_gradient_residue": zero_resid}


def train(cfg: Config, card: str):
    from fine_grained_gaussian_process_forcasting_torch.train import Trainer

    data = cfg.training_data(N_WARMUP + cfg.epochs * cfg.steps + 2,
                             SEED + 1)
    model = cfg.model("cuda")
    trainer = Trainer(model, cfg.d_model, warmup_steps=WARMUP_STEPS,
                      lr_mul=LR_MUL, device="cuda")
    state = trainer.init_state()  # the weights of seed 0

    def batches(i, n):
        return tuple(t[i: i + n] for t in data)

    state, _, _ = trainer.train_epoch(state, batches(0, N_WARMUP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    epoch_ms, loss_sums = [], []
    for e in range(cfg.epochs):
        t0 = time.perf_counter()
        state, loss_sum, _ = trainer.train_epoch(
            state, batches(N_WARMUP + e * cfg.steps, cfg.steps))
        epoch_ms.append((time.perf_counter() - t0) * 1e3)  # float() synced
        loss_sums.append(loss_sum)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k: cfg.epochs * cfg.steps * v
              for k, v in cfg.per_step.items()}
    if counts != expect:
        raise AssertionError(f"train {cfg.name}: launches {counts}, "
                             f"expected {expect}")
    # a non-finite loss in a step makes its epoch's sum non-finite
    if not all(math.isfinite(v) for v in loss_sums):
        raise AssertionError(f"train {cfg.name}: non-finite loss sums "
                             f"{loss_sums}")
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError(f"train {cfg.name}: a parameter left fp32")
    step_ms = [t / cfg.steps for t in epoch_ms]
    median = float(np.median(step_ms))
    log(f"train {cfg.name} on {card}: {cfg.epochs} epochs of {cfg.steps} "
        f"steps of {cfg.batch} windows: "
        f"{', '.join(f'{t:.2f}' for t in epoch_ms)} "
        f"ms; per step: median {median:.3f} ms ({1e3 / median:.2f} "
        f"steps/s); mean loss per epoch "
        f"{', '.join(f'{v / cfg.steps:.6f}' for v in loss_sums)}; "
        f"launches {counts}; peak memory {peak / 2**20:.1f} MiB")
    first = N_WARMUP + cfg.epochs * cfg.steps
    after = {}

    def one_step():
        after["state"], _, _ = trainer.train_epoch(state, batches(first, 1))

    profile_device(one_step, f"train {cfg.name}, one step of {cfg.batch} "
                   f"windows", median)
    cpu_check = check_step_against_cpu(cfg, after["state"].params,
                                       tuple(t[first + 1] for t in data))
    return counts, cpu_check, trainer.model


def exact_blur_pallas(model, card: str):
    """The exact blur through its ``use_pallas`` entry point, the hand
    Cholesky kernel's path: ``ExactGPBlur(32, use_pallas=True)`` with the
    trained exact model's blur weights, on that model's encoder (256, 192,
    32) and decoder (256, 96, 32) hidden states: ``smooth`` of both and
    ``mll`` of the decoder's, forward and backward.  Held against the same
    module with ``use_pallas=False`` (cuSOLVER) on the card and against the
    CPU."""
    from fine_grained_gaussian_process_forcasting_torch.gp.exact_blur import (
        ExactGPBlur,
    )

    cfg = next(c for c in CONFIGS if c.name == "exact")
    enc, dec, y = (t[0] for t in cfg.training_data(1, SEED + 2))
    with torch.no_grad():
        enc_h, dec_h = model.forecasting_model(model.enc_embedding(enc),
                                               model.dec_embedding(dec))
    weights = {k: v.detach().clone() for k, v in
               model.deep_gp.state_dict().items()}

    def run(use_pallas, device):
        blur = ExactGPBlur(D_MODEL, use_pallas=use_pallas, device=device)
        blur.load_state_dict(weights)
        xs = [t.to(device, copy=True).requires_grad_(True)
              for t in (enc_h, dec_h)]
        smooth_enc, smooth_dec = blur.smooth(xs[0]), blur.smooth(xs[1])
        mll = blur.mll(xs[1][:, -PRED:], y[..., 0].to(device))
        (smooth_enc.sum() + smooth_dec.sum() - mll).backward()
        grads = {n: p.grad for n, p in blur.named_parameters()}
        grads.update(enc_states=xs[0].grad, dec_states=xs[1].grad)
        return {"smooth_enc": smooth_enc.detach(),
                "smooth_dec": smooth_dec.detach(), "mll": mll.detach(),
                **grads}

    run(True, "cuda")  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    got = run(True, "cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["cholesky"] < 6 or any(v for k, v in counts.items()
                                     if k != "cholesky"):
        raise AssertionError(f"exact_blur_pallas: launches {counts}, "
                             f"expected >= 2 Cholesky launches per _factor")
    library = run(False, "cuda")
    cpu = run(True, "cpu")
    worst = {}
    for name, g in got.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"exact_blur_pallas: {name} not finite")
        for other, ref in (("cusolver", library[name]),
                           ("cpu", cpu[name].to("cuda"))):
            err = (g - ref).abs().max().item() / max(
                ref.abs().max().item(), 1e-30)
            worst[other] = max(worst.get(other, 0.0), err)
            if not err <= TOL_TRAIN:
                raise AssertionError(
                    f"exact_blur_pallas: {name} differs from the {other} "
                    f"run by {err:.3e} of its largest magnitude")
    wall = {}
    for use_pallas in (True, False):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            run(use_pallas, "cuda")
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        wall[use_pallas] = float(np.median(runs))
    log(f"exact_blur_pallas on {card}: smooth(enc) + smooth(dec) + mll(dec),"
        f" fwd and bwd: launches {counts['cholesky']} Cholesky; worst "
        f"difference / largest magnitude: vs cuSOLVER {worst['cusolver']:.3e},"
        f" vs cpu {worst['cpu']:.3e} (tol {TOL_TRAIN:.1e}); median wall "
        f"{wall[True]:.3f} ms (use_pallas=False: {wall[False]:.3f} ms)")
    profile_device(lambda: run(True, "cuda"), "exact_blur_pallas, one pass",
                   wall[True])
    return counts, {"max_rel_diff_cusolver": worst["cusolver"],
                    "max_rel_diff_cpu": worst["cpu"],
                    "tolerance": TOL_TRAIN}


# the training CLI on synthetic solar data, as run.sh runs it, at the
# flagship width (d_model 32, 8 heads, 1 layer, 512 inducing points, batch
# 256, enc 192, dec/pred 96); cut: 2560 of 32,000 training windows and 512
# of 3,840 validation and test windows per epoch, 3 of 50 epochs, 1 of 4
# trials, 1 of 3 seeds
CLI_EPOCHS, CLI_TRAIN, CLI_VALID = 3, 2560, 512
CLI_ARGV = ["--exp_name", "solar", "--attn_type", "ATA", "--model_name",
            "ATA", "--denoising", "True", "--gp", "True", "--synthetic",
            "--d_model_choices", str(D_MODEL), "--stack_choices", str(LAYERS),
            "--n_trials", "1", "--n_seeds", "1", "--num_epochs",
            str(CLI_EPOCHS), "--max_train_samples", str(CLI_TRAIN),
            "--max_valid_samples", str(CLI_VALID)]
CLI_FEATURES = 5  # solar: day_of_week, hour, Power(MW), categorical_id, capacity


class _EpochWatch:
    """Wraps ``Trainer.train_epoch`` for one CLI run: times each epoch (its
    losses are read back, so the call ends synchronised), keeps the last
    epoch's first batch for the CPU check, and profiles the epoch
    ``profile_epoch`` against the wall time of the one before it."""

    def __init__(self, label: str, profile_epoch: int):
        from fine_grained_gaussian_process_forcasting_torch.train import (
            trainer,
        )

        self.cls, self.original = trainer.Trainer, trainer.Trainer.train_epoch
        self.label, self.profile_epoch = label, profile_epoch
        self.epoch_ms, self.steps, self.batch, self.profile = [], [], None, None

    def __enter__(self):
        def train_epoch(trainer_self, state, data):
            self.batch = tuple(t[0] for t in data)
            self.steps.append(int(data[0].shape[0]))
            result = {}

            def run():
                result["out"] = self.original(trainer_self, state, data)

            t0 = time.perf_counter()
            if len(self.epoch_ms) == self.profile_epoch:
                self.profile = profile_device(
                    run, f"{self.label}, epoch {self.profile_epoch} "
                    f"({self.steps[-1]} steps)", self.epoch_ms[-1])
            else:
                run()
            self.epoch_ms.append((time.perf_counter() - t0) * 1e3)
            return result["out"]

        self.cls.train_epoch = train_epoch
        return self

    def __exit__(self, *exc):
        self.cls.train_epoch = self.original


def cli_ata(card: str, use_pallas: bool):
    """``train.cli.main`` end to end on the card: synthetic solar windows,
    one trial of 3 epochs, the best checkpoint, the evaluation on the test
    windows, ``reported_errors_solar.csv``; the conv-family attention plain
    (``--use_pallas_attention auto``) or through the head-folded kernel
    (``True``)."""
    import shutil
    import tempfile

    from fine_grained_gaussian_process_forcasting_torch.train import cli

    flag = "True" if use_pallas else "auto"
    label = f"cli_ata ({flag})"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        argv = CLI_ARGV + ["--use_pallas_attention", flag, "--out_dir",
                           out_dir]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with _EpochWatch(label, profile_epoch=CLI_EPOCHS - 1) as watch:
            results = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()

        steps = sum(watch.steps)
        n_valid = CLI_VALID // B
        evals = CLI_EPOCHS * n_valid + n_valid  # validation, then the test
        per_call = 6  # enc-self, dec-self, dec-cross, in both passes
        expect = dict(_NONE, fused_gp=steps + evals, fused_gp_bwd=steps)
        if use_pallas:
            expect.update(head_folded_attention=per_call * (steps + evals),
                          head_folded_attention_bwd=per_call * steps)
        if watch.steps != [CLI_TRAIN // B] * CLI_EPOCHS or counts != expect:
            raise AssertionError(f"{label}: steps {watch.steps}, launches "
                                 f"{counts}, expected {expect}")
        name = "ATA_solar_96_8220_denoise_gp"
        with open(f"{out_dir}/losses_lists/{name}_metrics.jsonl") as f:
            metrics = [json.loads(line) for line in f]
        losses = [m[k] for m in metrics for k in ("train_loss", "valid_loss")]
        if len(metrics) != CLI_EPOCHS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{label}: epoch metrics {metrics}")
        with open(f"{out_dir}/reported_errors_solar.csv") as f:
            rows = f.read().splitlines()
        if rows[0] != ",MSE,MAE" or len(rows) != 2 \
                or not rows[1].startswith(name + ","):
            raise AssertionError(f"{label}: reported errors {rows}")
        preds = np.load(f"{out_dir}/solar/{name}.npz")["predictions"]
        if preds.shape != (n_valid, B, PRED) or not np.isfinite(preds).all():
            raise AssertionError(f"{label}: predictions {preds.shape}")
        params = torch.load(f"{out_dir}/models_solar_{PRED}/{name}",
                            weights_only=True)["params"]
        if not results or not math.isfinite(results[0]["mse"]):
            raise AssertionError(f"{label}: evaluation {results}")

        epoch_ms = watch.epoch_ms
        step_ms = epoch_ms[1] / watch.steps[1]  # the first steady epoch
        busy = watch.profile
        mean_loss = ", ".join(f"{m['train_loss'] / watch.steps[0]:.6f}"
                              for m in metrics)
        log(f"{label} on {card}: cli.main in {wall:.2f} s; train epochs of "
            f"{watch.steps[0]} steps of {B} windows: "
            f"{', '.join(f'{t:.2f}' for t in epoch_ms)} ms (epoch 0 warms "
            f"up, epoch {CLI_EPOCHS - 1} under the profiler); per step "
            f"{step_ms:.3f} ms ({1e3 / step_ms:.2f} steps/s); device busy "
            f"{busy['busy_ms'] / watch.steps[-1]:.4f} ms per step, idle "
            f"share {busy['idle_share']:.3f}; peak memory "
            f"{peak / 2**20:.1f} MiB; test {results[0]['errors']}; mean "
            f"train loss per epoch {mean_loss}; launches {counts}")
        cfg = Config(f"cli_ata_{flag}", "ATA", batch=B, enc_len=ENC_LEN,
                     dec_len=DEC_LEN, pred=PRED, features=CLI_FEATURES,
                     d_model=D_MODEL, layers=LAYERS, bf16=False, n_windows=0,
                     n_check=N_CHECK, per_batch=_NONE, per_step=_NONE,
                     gp=dict(use_pallas_attention=True if use_pallas
                             else None),
                     zero_leaves=("*.ata.*_conv*.bias",))
        cpu_check = check_step_against_cpu(cfg, params, watch.batch)
        cpu_check.update(epoch_ms=epoch_ms, steps_per_s=1e3 / step_ms,
                         idle_share=busy["idle_share"],
                         peak_mib=peak / 2**20, test_errors=results[0]["errors"])
        return counts, cpu_check
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # plain fp32 products in full fp32 on cuBLAS: the yardstick of every
    # fp32 kernel's distance from float64
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _F64_GEN[0] = torch.Generator(device="cuda").manual_seed(F64_SEED)
    _F64_BF16_GEN[0] = torch.Generator(device="cuda").manual_seed(F64_SEED)
    flagship, production = GP_SHAPES["flagship"], GP_SHAPES["production"]
    kernels = {"fused_gp": check_fused_gp(gen, flagship),
               "fused_gp_bwd": check_fused_gp_bwd(gen, flagship),
               "head_folded_attention": check_head_folded(gen),
               "head_folded_attention_bwd": check_head_folded_bwd(gen),
               "fused_gp_bf16": check_fused_gp(gen, production, bf16=True),
               "fused_gp_bf16_bwd": check_fused_gp_bwd(gen, production,
                                                       bf16=True)}
    kernels["flash_attention"], kernels["flash_attention_bwd"] = check_flash(
        gen)
    # held and timed: the sm_bf16 variant, to which nothing routes, and the
    # fp32 kernels, which conv_attn_wide takes
    (kernels["flash_attention_bf16sm"],
     kernels["flash_attention_bf16sm_bwd"]) = check_flash(gen, sm_bf16=True)
    for sm_bf16, key in ((False, "flash_attention_fp32"),
                         (True, "flash_attention_fp32sm")):
        kernels[key], kernels[key + "_bwd"] = check_flash(
            gen, torch.float32, sm_bf16)
    # the head dims the kernels pad, on no path of this script
    for dtype, key in ((torch.bfloat16, "flash_attention_padded_bf16"),
                       (torch.float32, "flash_attention_padded_fp32")):
        kernels[key], kernels[key + "_bwd"] = check_flash_padded(gen, dtype)
    # the fp32 fused GP at the production width too (no path of this script
    # runs it there; it is the width the kernel could not take before)
    kernels["fused_gp"]["at_production_width"] = check_fused_gp(gen,
                                                                production)
    kernels["fused_gp_bwd"]["at_production_width"] = check_fused_gp_bwd(
        gen, production)
    # the non-affine variants, on no path: the affine kernels at inv_ls 1,
    # mean_w 0, mean_b 0
    for bf16, key in ((False, "fused_gp_nonaffine"),
                      (True, "fused_gp_nonaffine_bf16")):
        kernels[key], kernels[key + "_bwd"] = check_fused_gp_nonaffine(
            gen, flagship, bf16)
    # M past 720: the chunked kernels, on no path of this script
    for shape in LARGE_M_SHAPES:
        for bf16 in (False, True):
            key = f"fused_gp{'_bf16' if bf16 else ''}_m{shape[3]}"
            kernels[key] = check_fused_gp(gen, shape, bf16, large_m=True)
            kernels[key + "_bwd"] = check_fused_gp_bwd(gen, shape, bf16,
                                                       large_m=True)
    # the backward's device time by kernel, at both widths it runs on a path
    kernels["fused_gp_bwd"]["by_kernel"] = fused_gp_bwd_launches(gen,
                                                                 flagship)
    kernels["fused_gp_bwd"]["at_production_width"]["by_kernel"] = (
        fused_gp_bwd_launches(_F64_GEN[0], production))
    kernels["fused_gp_bf16_bwd"]["by_kernel"] = fused_gp_bwd_launches(
        gen, production, bf16=True)
    # the bf16 forward by kernel at the flagship's d 32 too
    kernels["fused_gp_bf16"]["by_kernel_d32"] = fused_gp_fwd_by_kernel(
        _gp_inputs(_F64_BF16_GEN[0], flagship), bf16=True)
    kernels["rbf"] = check_rbf(gen)
    kernels["cholesky"] = check_cholesky(gen)
    (kernels["small_head_attention"],
     kernels["small_head_attention_bwd"]) = check_small_head(gen)
    log(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    # the fp32 flash entries and the non-affine fused-GP entries share other
    # entries' counters and their entry points ran on no path: their
    # launches stay 0
    by_path, cpu_checks = {k: {} for k in kernels}, {}

    def record(path, counts):
        for k in kernels:
            by_path[k][path] = counts.get(k, 0)
        log(f"{path} done at {time.perf_counter() - t_start:.1f} s")

    for cfg in CONFIGS:
        counts, cpu_checks[f"serve_{cfg.name}"] = serve(cfg, smi)
        record(f"serve_{cfg.name}", counts)
    for cfg in CONFIGS:
        counts, cpu_checks[f"train_{cfg.name}"], model = train(cfg, smi)
        record(f"train_{cfg.name}", counts)
        if cfg.name == "exact":
            counts, cpu_checks["exact_blur_pallas"] = exact_blur_pallas(
                model, smi)
            record("exact_blur_pallas", counts)
        del model
    for use_pallas in (False, True):
        path = f"cli_ata_{'pallas' if use_pallas else 'auto'}"
        counts, cpu_checks[path] = cli_ata(smi, use_pallas)
        record(path, counts)

    for k, entry in kernels.items():
        entry["launches"] = sum(by_path[k].values())
        entry["launches_by_path"] = by_path[k]
        entry["cpu_checks"] = cpu_checks  # each path's run against the cpu
    if not all(k["launches"] > 0 for k in kernels.values()
               if k.get("on_path", True)):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{by_path}")

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
