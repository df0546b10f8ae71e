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
   shapes (the fused GP also at the production width, d 512; head-folded
   attention in both layouts it takes, the (b, h, L, d) views of the
   projections' (b, L, h, d) buffers and contiguous (b, h, L, d) tensors,
   with two runs bit-equal), the bf16 fused
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
   (d <= 8, on no path; the forward R query rows a lane with a lazy
   softmax offset, the backward one launch a warp a head with dQ passed
   from lane to lane) at the flagship's three calls at d 4, timed beside
   SDPA and the head-folded kernel on one count of the function's work
   (``attention_work``), and at d 2 and d 8, with two runs bit-equal and
   the kernels each call launched counted by the library; the
   flash kernels at the head dims they pad in their tiles (60, 72, 128,
   256), both dtypes; the fused GP at M 1024 and 2048,
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
   the device alone, from its kernels under ``torch.profiler``.  The seed
   axis (multi-seed training): the fused GP for 3 seeds in one call each
   way, fp32 at the flagship shape and bf16 at the production width, every
   seed bit-equal to its own call of one seed, within the plain gates and
   the float64 gate, timed beside 3 single calls; the head-folded, flash
   and small-head kernels' vmap rules (the seeds folded into the batch),
   bit-equal to per-seed calls forward and backward; the Cholesky's fold
   at (256, 192, 192) x 3 seeds, one launch, each factor bit-equal to its
   own call; the rbf kernel's seed axis at the multi-layer flagship's
   hidden layer (3 seeds x 8 GPs, one launch, bit-equal to 3 launches of
   one seed and timed beside them, with its store bandwidth and bound).
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
   run.  ``train_multiseed_autoformer``: the flagship at 3 seeds (weights
   of seeds 0, 1, 2) through ``MultiSeedTrainer``, the same steps: the
   fused GP once each way a step for all seeds, one step's per-seed losses
   and gradients against 3 single-seed steps on the card, seed 0's step
   against the CPU; seed-steps/s, busy, launches and peak memory beside
   ``train_autoformer``'s.  After every single-seed path, the options that
   train at 3 seeds through the kernels' seed rules, each at the flagship's
   width with 3 warm-up steps and 1 epoch of 4, the same gates, beside its
   single-seed path: ``train_multiseed_multilayer`` (every seed's hidden-
   layer K in one rbf launch, the fused GP's seed axis),
   ``train_multiseed_exact`` (no hand kernel), ``..._exact_blur_pallas``
   (the exact model with its blur on the Cholesky kernel, the seeds folded:
   6 launches a step), ``..._lstm`` (one cuDNN call a seed) and
   ``..._informer`` (each seed's key samples from its own generator; the
   card's samples and chosen queries replayed on the CPU).
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
   The model's last options, each served and trained the same way:
   ``prod_autoformer``, ``bench.py`` ``bench_prod_step`` as it stands
   (autoformer at the production width above, bf16, the GP's default
   lengthscale; 216 windows, 3 + 60 steps); ``autoformer_bf16``, its
   ``bench_jax(bf16=True)`` (the flagship in bf16; 600 windows, 3 + 60
   steps); and at the flagship's width, 600 windows and 3 + 4 steps each,
   ``informer`` (ProbSparse attention), ``fedformer`` (Fourier attention)
   and ``lstm`` (the LSTM backbone, cuDNN) in fp32, and ``conv_attn_bf16``
   (the conv family at 16 bits, flag off).  Per batch one fused GP (the
   bf16 one at 16 bits), per step one each way; the CPU runs also replay
   ProbSparse's key samples and chosen queries from the card.
   Serving and runtime, after the serving phases: ``serve_int8`` serves
   the flagship pair (autoformer, basic) through ``InferenceSession(...,
   quantize="int8")``, 600 windows, the launches a batch as fp32's, within
   JAX's 0.15 of the fp32 session on fp32's AutoCorrelation delays, the
   first 16 windows within 2^-5 of the CPU's int8 session, latency a batch
   beside fp32's; ``export_*`` exports ``basic`` and ``autoformer`` (fp32
   and int8), ``autoformer_bf16``, ``prod_basic``, ``multilayer`` and
   ``exact_blur_pallas`` at full batch (``export_serving``, ``torch.export``
   with each kernel a registered op), loads each from its file, serves it,
   counts the kernels it launches from inside and holds it to
   ``session.predict`` (rtol 1e-6 / atol 1e-7, int8 1e-5 / 1e-6), the
   flagship int8 artifact also served by a fresh process that imports no
   model code; ``predict_dataframe`` serves a synthetic electricity frame
   on the card and on the CPU: the same identifiers, the forecasts within
   1e-3 of each entity's std.
7. The training CLI, ``cli_ata``: ``train.cli.main`` as ``run.sh`` runs it
   (``--exp_name solar --attn_type ATA --denoising True --gp True``) on
   synthetic solar data at the flagship width, cut to 2560 training and 512
   validation and test windows, 3 epochs, 1 trial, 1 seed, into a temporary
   directory; twice: ``--use_pallas_attention auto`` (the conv family's
   plain attention) and ``True`` (the head-folded kernel, six launches each
   way per step).  Checks finite losses, the launches per step and per
   evaluated batch, the checkpoint, the predictions ``.npz`` (2, 256, 96),
   the ``reported_errors_solar.csv`` row, and one step of the checkpointed
   ATA model on 16 windows against the port's CPU run.  Then
   ``cli_multiseed``: the same with ``--multiseed True --n_seeds 3
   --use_pallas_attention True`` (the seeds train as one group, head-folded
   once a call site for all of them), three checkpoints, curves, ``.npz``
   files and CSV rows, finite per-seed test errors, and
   ``evaluate_checkpoints`` over the three checkpoints.
8. The baselines, ``baselines``: ``BaselinesHarness`` trains DLinear,
   NBeats, DeepAR and CMGP on a synthetic electricity frame at the
   harness's widths (history 192, horizon 96, the loader's batches of 256
   cut to 8 train and 2 valid and test), one trial of 2 epochs each, and
   ``evaluate`` writes the error CSV's four rows; each is held to the CPU's
   ``evaluate`` on the card's best parameters, then timed at the study's
   widest configuration (steps/s, busy, idle share, peak memory) with one
   step's loss and gradients against the CPU's (CMGP, a Cholesky of a
   smooth kernel, against float64 on the CPU instead).  No hand kernel
   runs there.
9. The rest of ``models/``, after ``baselines`` (no hand kernel: cuBLAS,
   cuFFT, cuDNN): ``fedformer_model_{fourier,wavelets,autoformer}``,
   ``FEDformer`` at the FEDformer repository's run.py defaults (enc/dec/c_out
   7, seq 96, label 48, pred 96, d_model 512, 8 heads, d_ff 2048, 2 + 1
   layers, moving_avg 24, 64 random modes, L 3, legendre, tanh, timeF at
   freq h, batch 32; MSE + Adam); ``informer_stack``,
   ``InformerEncoder(512, 2 layers, 8 heads, ProbSparse, distil)`` on (32,
   96, 512) and ``InformerDecoderLayer(512, 8)`` on (32, 72, 512);
   ``arima_batch``, ``fit_forecast_batch`` on 1024 windows of 192 steps,
   96 ahead, 200 Adam steps (seconds and windows/s); ``denoise_vae``,
   ``DenoiseVAE(32, gp=True)`` on (256, 288, 32) with a 96-step target.
   Each: ms a forward and a training step (medians of 5), device busy,
   launches and idle share of a step under the profiler, peak memory;
   finite outputs and losses; one step's outputs, loss and gradients on
   the first windows against the CPU on the card's weights (the fp32
   training gate, gradients over a floor of 1e-2 of the largest; where
   some miss it, held to float64 on the CPU instead: Wavelets' cross
   block), the card's AutoCorrelation delays, ProbSparse key samples and
   chosen queries and the VAE's draws replayed there; ARIMA's 200-step fit,
   chaotic on a few windows, held to float64 on the CPU by its median
   window and its count of diverged windows.  Wavelets' step on the check
   windows is taken twice and must be bit-equal.
10. Parallelism, last, ``parallel``: the flagship and ``basic`` at the
   flagship's widths, each with and without FSDP, on a 2 x 2 (data, model)
   mesh of four ranks that share the card over gloo (spawned after every
   kernel is built; gloo's collectives staged through host memory): step
   1's loss and every gradient, gathered, within TOL_TRAIN of a
   one-process card step from the same weights, autoformer's delays equal
   to it, every rank's weights bit-equal after each of PAR_STEPS steps,
   the fused GP (and in ``basic`` the head-folded kernels) launched in
   every rank; ms a step, device busy and idle share, the staging copies'
   share of the busy time, the gloo calls' share of the host step and
   peak memory, by rank.  Then ``cli.main`` with ``--dp 1``, a mesh of one
   rank over NCCL.  Four ranks on one card show that the collectives are
   right, not how a step scales across cards.

The CPU runs take the AutoCorrelation delays that the card chose, the deep
GP's eps draws the card made and, in training, the card's side of every
ReLU, so that a near-tie broken the other way on one device cannot make the
two compute different functions; likewise ATA's top-1 scale of every
(position, channel) and its side of zero, and ProbSparse's key samples
(drawn on the card) and the queries chosen; how many differed is printed.

Every profile also prints the count and device time of its ``direct_copy``
kernels (the copies that layout changes cost).  Prints the ``kernels`` JSON
line (each kernel's launches summed over the serving and training runs, and
by run), then the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  Exits non-zero on any
failure, without a result line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

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


def attention_work(n, lq, lk, d, way):
    """(flops, exponentials, bytes) of fp32 softmax attention over n
    (batch, head) pairs of Lq x Lk (query, key) pairs at head dim d, the
    one count that the head-folded and small-head kernels are held to.
    Forward ("fwd"): 4d + 3 flops a pair (the score and the output, 2d
    each; the max, the subtraction, the sum), q read and the output written,
    k and v read.  Backward ("bwd"): 10d + 3 (the score and P, dV, dP, dQ,
    dK, 2d each; dS 3), q, dO read and dq written, k, v read and dk, dv
    written.  One exponential a pair both ways."""
    pairs = float(n) * lq * lk
    if way == "fwd":
        return (4.0 * d + 3.0) * pairs, pairs, 4.0 * n * d * (2 * lq + 2 * lk)
    return (10.0 * d + 3.0) * pairs, pairs, 4.0 * n * d * (3 * lq + 4 * lk)


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
    launch = fused_gp.launcher()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if launch(*ptrs, b * n, d, m, 1, int(bf16), stream):
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


def _gp_grad_within(name, rel, rel_tol, kernel_summed, plain_summed):
    """A fused-GP gradient's gate against its plain version, affine and
    not: ``rel`` = max|kernel - plain| / max(1, max|plain|) within
    ``rel_tol``.  dos alone, a sum over every row and inducing point (37.7 M
    terms at the flagship) that nearly cancels, may instead be no farther
    from the float64 function than twice the plain version is, the two
    versions' distances summed over ``F64_DRAWS`` draws (``kernel_summed``,
    ``plain_summed``), as every float64 gate of this script sums them:
    where |dos| is small, both fp32 versions lie 2-7e-2 from float64, more
    than 1e-3 of it, and on one draw either may be the closer."""
    return rel <= rel_tol or (name == "dos"
                              and kernel_summed <= 2.0 * plain_summed)


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
    # the forward as the affine entries hold it; each gradient as the affine
    # backward's (``_gp_grad_within``).  bf16: besides, every gradient
    # within F64_BUDGET_BF16_BWD times plain's distance from that float64
    # function (summed over F64_DRAWS draws) and from the fp32 function in
    # float64.  fp32: every output, forward and
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
        bwd_ok &= _gp_grad_within(name, rel, rel_tol, *summed[name])
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
    bwd_launch = fused_gp.bwd_launcher()

    def run_bwd():
        if bwd_launch(*bwd_ptrs, b * n, d, m, 1, int(bf16), stream):
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
                            "dos: or no farther from float64 than twice "
                            "plain, summed over F64_DRAWS draws"
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
                if launch(*ptrs, r, m, d, h, 1, stream):
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


def check_rbf_seeds(gen):
    """The rbf kernel's seed axis at the multi-layer flagship's hidden
    layer (8 GPs, 256 x 288 rows, M 512, d 32) for N_SEEDS seeds, each
    with its own x and GPs: one launch for every seed's K, bit-equal to
    N_SEEDS launches of one seed, each seed within TOL_RBF of the plain
    version; timed beside the N_SEEDS single launches, with the store
    bandwidth it reaches and its bound (N_SEEDS times one seed's)."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import rbf

    h, rows, m, d = ML_HIDDEN, B * (ENC_LEN + DEC_LEN), INDUCING, D_MODEL
    s = N_SEEDS
    per = [_rbf_inputs(gen, h, rows, m, d) for _ in range(s)]
    args = _stack_seeds(per)
    tag = f"rbf seeds (S {s}, h {h}, rows {rows}, M {m}, d {d})"
    with torch.inference_mode():
        before = (rbf.launches, rbf.seeds_launches)
        got = rbf.rbf_cross_kernel(*args)
        torch.cuda.synchronize()
        if (rbf.launches, rbf.seeds_launches) != (before[0] + 1,
                                                  before[1] + 1):
            raise AssertionError(f"{tag}: expected one seeded launch")
        if tuple(got.shape) != (s, h, rows, m):
            raise AssertionError(f"{tag}: K has shape {tuple(got.shape)}")
        for i in range(s):
            if not torch.equal(got[i], rbf.rbf_cross_kernel(*per[i])):
                raise AssertionError(f"{tag}: seed {i} differs from its "
                                     "launch of one seed")
        err = measure = 0.0
        for i in range(s):
            e, m_ = _measure(got[i], rbf.rbf_cross_kernel_plain(*per[i]),
                             TOL_RBF)
            err, measure = max(err, e), max(measure, m_)
        ms = time_ms(lambda: rbf.forward_kernel(*args), 10)
        single_ms = time_ms(
            lambda: [rbf.forward_kernel(*a) for a in per], 10)
        plain_ms = time_ms(lambda: rbf.rbf_cross_kernel_plain(*args), 3)
    pairs = float(s * h * rows * m)
    flops = pairs * (2.0 * d + 6.0) + s * 2.0 * d * h * (rows + m)
    nbytes = 4.0 * (pairs + s * (rows * d + h * (m * d + d + 1)))
    bound_ms, bound_by = bound(flops, pairs, nbytes)
    store_tb_s = 4.0 * pairs / ms / 1e9
    log(f"{tag}: every seed's K in one launch, bit-equal to {s} launches of "
        f"one seed; max|kernel - plain| {err:.3e}, / (atol + rtol |plain|) "
        f"{measure:.3e} (limit 1); one launch {ms:.4f} ms (K written at "
        f"{store_tb_s:.3f} TB/s), {s} launches of one seed {single_ms:.4f} "
        f"ms (ratio {ms / single_ms:.3f}); plain over the seed axis "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
        f"{nbytes / 1e9:.3f} GB); library: none")
    if not measure <= 1.0:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return {"name": "rbf.rbf_cross_kernel (seed axis, fwd, fp32, h GPs)",
            "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "rbf.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/rbf.py:52 (under jax.vmap)",
            "shape": {"seeds": s, "h": h, "rows": rows, "M": m, "d": d},
            "max_abs_err": err, "measure": measure,
            "tolerance": {"rtol": TOL_RBF[0], "atol": TOL_RBF[1]},
            "bit_equal_to_single_seed_calls": True, "ms": ms,
            "kernel_ms": ms, "single_seed_calls_ms": single_ms,
            "store_tb_per_s": store_tb_s, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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


# the head-folded kernels' two layouts: the (b, h, L, d) views of (b, L, h,
# d) buffers that the transformer hands them (the main path's), and
# contiguous (b, h, L, d) tensors
HF_LAYOUTS = ("folded", "contiguous")


def _folded_like(t):
    """t's values as a (b, h, L, d) view of (b, L, h, d) memory."""
    b, h, n, d = t.shape
    out = torch.empty(b, n, h, d, device=t.device, dtype=t.dtype)
    out.copy_(t.transpose(1, 2))
    return out.transpose(1, 2)


def _hf_layout(layout, *ts):
    return ts if layout == "contiguous" else tuple(map(_folded_like, ts))


def check_head_folded(gen):
    """The head-folded forward against its plain version at the flagship's
    three calls, in both layouts (1e-5 each), two runs bit-equal; timed in
    both layouts, serving (no lse) and training (with lse), beside plain
    and SDPA.  ``ms`` sums the three calls in the main path's layout."""
    from torch.nn.functional import scaled_dot_product_attention

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        head_folded_attention as hfa,
    )

    dev = "cuda"
    d = D_MODEL // HEADS
    launch = hfa.launcher()
    stream = torch.cuda.current_stream().cuda_stream
    keys = ("ms", "contiguous_ms", "lse_ms", "plain_ms", "library_ms",
            "flops", "exps", "bytes")
    rows, total = [], dict.fromkeys(keys, 0.0)
    err_all = 0.0
    for call, (lq, lk) in ATTENTION_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        row = {"call": call, "lq": lq, "lk": lk}
        with torch.inference_mode():
            want = hfa.head_folded_attention_plain(q, k, v)
            for layout in HF_LAYOUTS:
                qq, kk, vv = _hf_layout(layout, q, k, v)
                got = hfa.head_folded_attention(qq, kk, vv)
                again = hfa.head_folded_attention(qq, kk, vv)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"head_folded_attention {call} ({layout}): two runs "
                        f"differ")
                if not err <= TOL_ATTENTION:
                    raise AssertionError(
                        f"head_folded_attention {call} ({layout}) disagrees "
                        f"with its plain version: {err} > {TOL_ATTENTION}")
                err_all = max(err_all, err)
                out = hfa.folded_empty(B, HEADS, lq, d, dev)
                lse = torch.empty(B, HEADS, lq, device=dev)
                strides = hfa.launch_strides(qq, kk, vv, out)
                ptrs = [t.data_ptr() for t in (qq, kk, vv, out)]

                def run_kernel(with_lse):
                    if launch(*ptrs, lse.data_ptr() if with_lse else None,
                              strides, B, HEADS, lq, lk, d, stream):
                        raise RuntimeError(
                            "head_folded_attention launch failed")

                ms = time_ms(lambda: run_kernel(False), 50)
                row[f"{layout}_err"] = err
                row[f"{layout}_ms"] = ms
                if layout == "folded":
                    row["lse_ms"] = time_ms(lambda: run_kernel(True), 50)
            plain_ms = time_ms(
                lambda: hfa.head_folded_attention_plain(q, k, v), 20)
            library_ms = time_ms(
                lambda: scaled_dot_product_attention(q, k, v), 20)
        flops, exps, nbytes = attention_work(B * HEADS, lq, lk, d, "fwd")
        bound_ms, bound_by = bound(flops, exps, nbytes)
        log(f"head_folded_attention {call} (b {B}, h {HEADS}, Lq {lq}, "
            f"Lk {lk}, d {d}): max|kernel - plain| {row['folded_err']:.3e} "
            f"folded, {row['contiguous_err']:.3e} contiguous (tol "
            f"{TOL_ATTENTION}), two runs bit-equal; kernel "
            f"{row['folded_ms']:.4f} ms folded ({row['lse_ms']:.4f} with the "
            f"lse), {row['contiguous_ms']:.4f} contiguous; plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        row.update(max_abs_err=max(row["folded_err"], row["contiguous_err"]),
                   ms=row["folded_ms"], plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        rows.append(row)
        for key, val in (("ms", row["folded_ms"]),
                         ("contiguous_ms", row["contiguous_ms"]),
                         ("lse_ms", row["lse_ms"]), ("plain_ms", plain_ms),
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
            "contiguous_ms": total["contiguous_ms"],
            "with_lse_ms": total["lse_ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "reruns_bit_equal": True, "calls": rows}


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
        if not _gp_grad_within(name, err / max(scale, 1.0), rel_tol, ks,
                               ps):
            raise AssertionError(f"{tag} {name} disagrees with its "
                                 f"plain version: {err} > {tol} (float64, "
                                 f"summed over {F64_DRAWS} draws: kernel "
                                 f"{ks}, plain {ps})")
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

    launch = fused_gp.bwd_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(t) for t in got]
    scratch = torch.empty(fused_gp.bwd_scratch_floats(b * n, d, m, bf16),
                          device=dev)
    ptrs = ([a.data_ptr() for a in args[:7]] + [c.data_ptr() for c in cot]
            + [o.data_ptr() for o in outs] + [scratch.data_ptr()])
    def run_kernel():
        if launch(*ptrs, b * n, d, m, 1, int(bf16), stream):
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
            "tolerance_is": "relative to max(1, max|plain|) per output; "
                            "dos: or no farther from float64 than twice "
                            "plain, summed over F64_DRAWS draws",
            "design": fused_gp.bwd_design(m, bf16),
            "f64_dist_over_plain": worst_f64,
            **({} if bf16 else {"tc_bound_ms": tc_ms}),
            "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


N_SEEDS = 3  # the protocol's seeds (scripts/run.sh), trained as one group


def _stack_seeds(per):
    """Per-seed tuples of tensors, stacked on a leading seed axis."""
    return tuple(torch.stack(ts) for ts in zip(*per))


def check_fused_gp_seeds(gen, shape, bf16=False):
    """The seed axis of the fused GP: N_SEEDS seeds' inputs at (b, n, d, m)
    in one call each way, held (1) bit-equal to N_SEEDS calls of one seed
    each (the same arithmetic, offsets only), (2) each seed against the
    plain version at ``check_fused_gp``'s and ``check_fused_gp_bwd``'s
    gates, (3) each seed's outputs, summed over F64_DRAWS draws, no farther
    from float64 than F64_BUDGET_FP32 (bf16: F64_BUDGET_BF16_* from the bf16
    function, and the forward from the fp32 function too) times the plain
    version's.  Times the seeded calls beside N_SEEDS single calls.
    Returns the (forward, backward) entries of the kernels line."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = shape
    s = N_SEEDS
    tag = (f"fused_gp{'_bf16' if bf16 else ''} seeds (S {s}, rows {b * n}, "
           f"d {d}, M {m})")
    plain = fused_gp.whitened_marginals_affine_plain
    plain_bwd = fused_gp.whitened_marginals_affine_bwd_plain

    def draw(g):
        per = [_gp_inputs(g, shape) for _ in range(s)]
        cot = [(torch.randn(b, n, device=dev, generator=g),
                torch.randn(b, n, device=dev, generator=g)) for _ in range(s)]
        return per, cot

    per, cot = draw(gen)
    args, cots = _stack_seeds(per), _stack_seeds(cot)
    with torch.inference_mode():
        fwd = fused_gp.forward_kernel(*args, bf16=bf16)
        bwd = fused_gp.backward_kernel(*args, *cots, bf16=bf16)
        fwd1 = [fused_gp.forward_kernel(*a, bf16=bf16) for a in per]
        bwd1 = [fused_gp.backward_kernel(*a, *c, bf16=bf16)
                for a, c in zip(per, cot)]
    torch.cuda.synchronize()
    for i in range(s):
        if not (all(torch.equal(x[i], y) for x, y in zip(fwd, fwd1[i]))
                and all(torch.equal(x[i], y) for x, y in zip(bwd, bwd1[i]))):
            raise AssertionError(f"{tag}: seed {i} differs from its call of "
                                 "one seed")
    log(f"{tag}: every seed's mean, var and eight gradients bit-equal to "
        f"its own call of one seed")
    fwd_names, bwd_names = ("mean", "var"), ("dx", "dzs", "du", "dW", "dos",
                                             "dinv_ls", "dmean_w", "dmean_b")
    # float64 distances, per seed, summed over F64_DRAWS draws of all seeds:
    # from the fp32 function (fp32) or the bf16 function (bf16; the forward
    # from the fp32 function too)
    refs = (1, 0) if bf16 else (0,)
    sums = {(way, r, name, i): [0.0, 0.0] for i in range(s) for r in refs
            for way, names in (("fwd", fwd_names), ("bwd", bwd_names))
            for name in names if way == "fwd" or r == refs[0]}
    errs = {}
    f64_gen = _F64_BF16_GEN[0] if bf16 else _F64_GEN[0]
    for k in range(F64_DRAWS):
        if k:
            per, cot = draw(f64_gen)
            args, cots = _stack_seeds(per), _stack_seeds(cot)
            with torch.inference_mode():
                fwd = fused_gp.forward_kernel(*args, bf16=bf16)
                bwd = fused_gp.backward_kernel(*args, *cots, bf16=bf16)
        with torch.inference_mode():
            for i in range(s):
                want_f = plain(*per[i], bf16=bf16)
                want_b = plain_bwd(*per[i], *cot[i], bf16=bf16)
                wide = [a.double() for a in per[i]]
                wide_c = [c.double() for c in cot[i]]
                for way, got, want, names in (("fwd", fwd, want_f, fwd_names),
                                              ("bwd", bwd, want_b,
                                               bwd_names)):
                    if k == 0:  # the plain gates, on the first draw
                        for name, g, w_ in zip(names, got, want):
                            scale = w_.abs().max().item()
                            errs[(way, name, i)] = (
                                (g[i] - w_).abs().max().item(), scale)
                    for r in refs:
                        if way == "bwd" and r != refs[0]:
                            continue
                        exact = (plain(*wide, bf16=r) if way == "fwd"
                                 else plain_bwd(*wide, *wide_c, bf16=r))
                        for name, g, w_, e in zip(names, got, want, exact):
                            acc = sums[(way, r, name, i)]
                            acc[0] += (g[i].double() - e).abs().max().item()
                            acc[1] += (w_.double() - e).abs().max().item()
    worst_f64, worst = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
    worst_abs = {"fwd": 0.0, "bwd": 0.0}
    for (way, r, name, i), (ks, ps) in sums.items():
        budget = ((F64_BUDGET_BF16_FWD if way == "fwd"
                   else F64_BUDGET_BF16_BWD) if bf16 else F64_BUDGET_FP32)
        ratio = _f64_ratio(ks, ps)
        worst_f64[way] = max(worst_f64[way], ratio)
        if not ratio <= budget:
            raise AssertionError(
                f"{tag} seed {i} {name}: {ratio:.3f} times farther from the "
                f"{'bf16' if r else 'fp32'} function in float64 than plain")
    for (way, name, i), (err, scale) in errs.items():
        if way == "fwd":
            tol = (TOL_BF16 * max(1.0, scale) if bf16 and name == "var"
                   else TOL_FUSED_GP)
            ok, rel = err <= tol, err / tol * TOL_FUSED_GP
        else:
            rel_tol = TOL_BF16 if bf16 else TOL_FUSED_GP_BWD
            ks, ps = sums[(way, refs[0], name, i)]
            rel = err / max(scale, 1.0)
            ok = _gp_grad_within(name, rel, rel_tol, ks, ps)
        worst[way] = max(worst[way], rel)
        worst_abs[way] = max(worst_abs[way], err)
        if not ok:
            raise AssertionError(f"{tag} seed {i} {way} {name} disagrees "
                                 f"with its plain version: {err:.3e}")
    log(f"{tag}: each seed within the plain gates (largest max|kernel - "
        f"plain| fwd {worst_abs['fwd']:.3e}, bwd {worst_abs['bwd']:.3e}); "
        f"largest summed float64 distance over plain's: fwd "
        f"{worst_f64['fwd']:.3f}, bwd {worst_f64['bwd']:.3f}")

    with torch.inference_mode():
        ms = {"fwd": time_ms(lambda: fused_gp.forward_kernel(*args, bf16=bf16),
                             10),
              "bwd": time_ms(lambda: fused_gp.backward_kernel(
                  *args, *cots, bf16=bf16), 5)}
        singles = {"fwd": time_ms(lambda: [fused_gp.forward_kernel(
                       *a, bf16=bf16) for a in per], 10),
                   "bwd": time_ms(lambda: [fused_gp.backward_kernel(
                       *a, *c, bf16=bf16) for a, c in zip(per, cot)], 5)}
        plain_ms = {"fwd": time_ms(lambda: plain(*args, bf16=bf16), 5),
                    "bwd": time_ms(lambda: plain_bwd(*args, *cots,
                                                     bf16=bf16), 3)}
    r = s * b * n  # every seed's rows
    kw = r * 2.0 * m * m
    fwd_rest = r * (2.0 * m * d + 7.0 * m + 2.0 * d)
    fwd_bytes = 4.0 * s * (b * n * d + m * d + m + m * m + 2 * d + 2
                           + 2 * b * n)
    bwd_products = r * (2.0 * m * m + (2.0 * m * m if bf16
                                       else m * (m + 1.0)))
    bwd_rest = r * (4.0 * m * d + (2.0 * d + 10.0) * m)
    bwd_bytes = 4.0 * s * (2 * b * n * d + 2 * b * n + 2 * m * d + 2 * m
                           + 2 * m * m + 3 * d + 4)
    bounds = {"fwd": (bound(fwd_rest, r * m, fwd_bytes, kw) if bf16
                      else bound(kw + fwd_rest, r * m, fwd_bytes)),
              "bwd": (bound(bwd_rest, r * m, bwd_bytes, bwd_products) if bf16
                      else bound(bwd_products + bwd_rest, r * m, bwd_bytes))}
    entries = []
    for way, site in (("fwd", ":222"), ("bwd", ":290")):
        log(f"{tag} {way}: one call for {s} seeds {ms[way]:.4f} ms, {s} "
            f"calls of one seed {singles[way]:.4f} ms (ratio "
            f"{ms[way] / singles[way]:.3f}); plain over the seed axis "
            f"{plain_ms[way]:.4f} ms; bound {bounds[way][0]:.4f} ms "
            f"({bounds[way][1]}); library: none")
        entries.append({
            "name": "fused_gp.whitened_marginals_affine"
                    + ("_bf16" if bf16 else "") + f" (seed axis, {way}"
                    + ("" if bf16 else ", fp32") + ")",
            "route": "cuda", "source": _FUSED_GP_SOURCE,
            "replaces": _FUSED_GP_PALLAS + site + " (under jax.vmap)",
            "on_path": not bf16,
            "shape": {"seeds": s, "rows": b * n, "d": d, "M": m},
            "max_abs_err": worst_abs[way], "max_rel_err": worst[way],
            "bit_equal_to_single_seed_calls": True,
            "f64_dist_over_plain": worst_f64[way], "ms": ms[way],
            "single_seed_calls_ms": singles[way], "plain_ms": plain_ms[way],
            "bound_ms": bounds[way][0], "bound_by": bounds[way][1],
            "library_ms": None})
    return entries


def check_attention_folds(gen):
    """The vmap rules that fold the seeds into a kernel's batch: N_SEEDS
    seeds folded into the batch, one call each way, bit-equal to one call
    per seed, forward and the gradients of q, k and v; head-folded on the
    projections' views and small-head at the flagship's enc-self shape,
    flash (bf16) at the production width's.  Times the folded calls beside
    N_SEEDS single calls.  Then the Cholesky's fold (``check_cholesky_fold``).
    Returns {kernel key: result} to record beside each kernel's entry."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        flash_attention,
        head_folded_attention,
        small_head_attention,
    )

    s = N_SEEDS
    out = {}
    for key, fn, shape, dtype in (
            ("head_folded_attention", head_folded_attention.head_folded_attention,
             (B, HEADS, ENC_LEN, D_MODEL // HEADS), torch.float32),
            ("small_head_attention", small_head_attention.small_head_attention,
             (B, HEADS, ENC_LEN, D_MODEL // HEADS), torch.float32),
            ("flash_attention", flash_attention.fused_attention,
             (P_B, HEADS, P_ENC_LEN, P_D_MODEL // HEADS), torch.bfloat16)):
        b, h, length, d = shape
        tag = f"{key} seed fold (S {s}, {shape}, {str(dtype)[6:]})"
        # (S, b, L, h, d) buffers viewed as (S, b, h, L, d), as the
        # projections give them under vmap
        qkv = [torch.randn(s, b, length, h, d, device="cuda", generator=gen
                           ).to(dtype).transpose(2, 3) for _ in range(3)]
        if key == "flash_attention":  # its wrapper takes contiguous operands
            qkv = [t.contiguous() for t in qkv]
        do = torch.randn(s, b, h, length, d, device="cuda", generator=gen
                         ).to(dtype)
        leaves = [t.detach().requires_grad_() for t in qkv]
        got = torch.func.vmap(fn)(*leaves)
        got.backward(do)
        singles = []
        for i in range(s):
            one = [t[i].detach().requires_grad_() for t in qkv]
            o = fn(*one)
            o.backward(do[i])
            singles.append((o.detach(), *(t.grad for t in one)))
        same = all(torch.equal(got[i].detach(), singles[i][0])
                   and all(torch.equal(t.grad[i], g) for t, g in
                           zip(leaves, singles[i][1:])) for i in range(s))
        if not same:
            raise AssertionError(f"{tag}: the folded call differs from the "
                                 "calls of one seed")
        def folded():
            return torch.func.vmap(fn)(*qkv)

        def single():
            return [fn(*(t[i] for t in qkv)) for i in range(s)]

        with torch.inference_mode():
            ms, single_ms = time_ms(folded, 10), time_ms(single, 10)
        # the device's share: the kernels' time under the profiler (the
        # events above also hold vmap's host time where it exceeds it)
        busy = {name: sum(_by_kernel(f, 10).values())
                for name, f in (("folded", folded), ("single", single))}
        log(f"{tag}: forward and dq, dk, dv bit-equal to {s} calls of one "
            f"seed; forward folded {ms:.4f} ms, {s} single calls "
            f"{single_ms:.4f} ms (CUDA events); device time by the profiler "
            f"folded {busy['folded']:.4f} ms, single calls "
            f"{busy['single']:.4f} ms")
        out[key] = {"seeds": s, "shape": list(shape),
                    "bit_equal_to_single_seed_calls": True, "ms": ms,
                    "single_seed_calls_ms": single_ms,
                    "device_ms": busy["folded"],
                    "single_seed_calls_device_ms": busy["single"]}
    out["small_head_attention_bwd"] = out["small_head_attention"]
    out["cholesky"] = check_cholesky_fold(gen)
    return out


def check_cholesky_fold(gen):
    """The Cholesky's vmap rule at the exact blur's encoder shape (256,
    192, 192) for N_SEEDS seeds: one launch for all seeds, each seed's
    factor bit-equal to its own call's; its gradient (the plain pullback,
    no kernel) within TOL_CHOL of the calls of one seed.  Timed beside
    N_SEEDS single calls."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        cholesky,
    )

    s, shape = N_SEEDS, (B, ENC_LEN)
    tag = f"cholesky seed fold (S {s}, b {shape[0]}, n {shape[1]})"
    a = torch.stack([_blur_gram(gen, *shape) for _ in range(s)])
    cot = torch.randn(a.shape, device="cuda", generator=gen) * 1e-2
    leaf = a.detach().requires_grad_()
    before = cholesky.launches
    got = torch.func.vmap(cholesky.batched_cholesky)(leaf)
    torch.cuda.synchronize()
    if cholesky.launches != before + 1:
        raise AssertionError(f"{tag}: expected one launch for all seeds")
    got.backward(cot)
    grad_err = 0.0
    for i in range(s):
        one = a[i].detach().requires_grad_()
        single = cholesky.batched_cholesky(one)
        if not torch.equal(got[i].detach(), single.detach()):
            raise AssertionError(f"{tag}: seed {i} differs from its call")
        single.backward(cot[i])
        err, measure = _measure(leaf.grad[i], one.grad, TOL_CHOL)
        if not measure <= 1.0:
            raise AssertionError(f"{tag}: seed {i}'s gradient differs from "
                                 f"its call's: {err:.3e}")
        grad_err = max(grad_err, err)

    def folded():
        return torch.func.vmap(cholesky.batched_cholesky)(a)

    def single():
        return [cholesky.batched_cholesky(a[i]) for i in range(s)]

    with torch.inference_mode():
        ms, single_ms = time_ms(folded, 10), time_ms(single, 10)
    busy = {name: sum(_by_kernel(f, 10).values())
            for name, f in (("folded", folded), ("single", single))}
    log(f"{tag}: one launch, every seed's factor bit-equal to its call of "
        f"one seed, gradients (plain pullback) within {grad_err:.3e}; "
        f"folded {ms:.4f} ms, {s} single calls {single_ms:.4f} ms (CUDA "
        f"events); device time by the profiler folded {busy['folded']:.4f} "
        f"ms, single calls {busy['single']:.4f} ms")
    return {"seeds": s, "shape": [shape[0], shape[1], shape[1]],
            "bit_equal_to_single_seed_calls": True,
            "grad_max_abs_err": grad_err, "ms": ms,
            "single_seed_calls_ms": single_ms, "device_ms": busy["folded"],
            "single_seed_calls_device_ms": busy["single"]}


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
    """The head-folded backward against its plain version at the flagship's
    three calls, in both layouts (1e-5 each), two runs bit-equal; timed in
    both layouts beside plain and SDPA's backward.  ``ms`` sums the three
    calls in the main path's layout."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        head_folded_attention as hfa,
    )

    dev = "cuda"
    d = D_MODEL // HEADS
    launch = hfa.bwd_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    keys = ("ms", "contiguous_ms", "plain_ms", "library_ms", "flops", "exps",
            "bytes")
    rows, total = [], dict.fromkeys(keys, 0.0)
    err_all = 0.0
    for call, (lq, lk) in ATTENTION_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        do = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        hb, wph = hfa.bwd_plan(HEADS, lq, lk, d)
        row = {"call": call, "lq": lq, "lk": lk,
               "launches_a_call": 1 if hb else 2,
               "heads_a_block": hb, "warps_a_head": wph}
        with torch.inference_mode():
            want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
            for layout in HF_LAYOUTS:
                qq, kk, vv, dd = _hf_layout(layout, q, k, v, do)
                out, lse = hfa.forward_kernel(qq, kk, vv, with_lse=True)
                got = hfa.backward_kernel(qq, kk, vv, out, lse, dd)
                again = hfa.backward_kernel(qq, kk, vv, out, lse, dd)
                torch.cuda.synchronize()
                err = max((g - w_).abs().max().item()
                          for g, w_ in zip(got, want))
                if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                    raise AssertionError(
                        f"head_folded_attention bwd {call} ({layout}): two "
                        f"runs differ")
                if not err <= TOL_ATTENTION_BWD:
                    raise AssertionError(
                        f"head_folded_attention bwd {call} ({layout}) "
                        f"disagrees with its plain version: {err} > "
                        f"{TOL_ATTENTION_BWD}")
                err_all = max(err_all, err)
                bufs = [hfa.folded_empty(B, HEADS, n, d, dev)
                        for n in (lq, lk, lk)]
                delta = None if hb else torch.empty_like(lse)
                strides = hfa.launch_strides(qq, kk, vv, out, dd, *bufs)
                ptrs = [t.data_ptr() for t in (qq, kk, vv, out, lse, dd,
                                               *bufs)]
                ptrs.append(None if delta is None else delta.data_ptr())

                def run_kernel():
                    if launch(*ptrs, strides, B, HEADS, lq, lk, d, hb, wph,
                              stream):
                        raise RuntimeError("head_folded_attention_bwd failed")

                row[f"{layout}_err"] = err
                row[f"{layout}_ms"] = time_ms(run_kernel, 50)
            plain_ms = time_ms(
                lambda: hfa.head_folded_attention_bwd_plain(q, k, v, do), 20)
        library_ms = sdpa_bwd_ms(q, k, v, do, 20)
        flops, exps, nbytes = attention_work(B * HEADS, lq, lk, d, "bwd")
        bound_ms, bound_by = bound(flops, exps, nbytes)
        log(f"head_folded_attention bwd {call} (b {B}, h {HEADS}, Lq {lq}, "
            f"Lk {lk}, d {d}; {row['launches_a_call']} launch(es), "
            f"{hb} heads a block, {wph} warps a head): max|kernel - plain| "
            f"{row['folded_err']:.3e} folded, {row['contiguous_err']:.3e} "
            f"contiguous (tol {TOL_ATTENTION_BWD}), two runs bit-equal; "
            f"kernel {row['folded_ms']:.4f} ms folded, "
            f"{row['contiguous_ms']:.4f} contiguous; plain {plain_ms:.4f} "
            f"ms, sdpa bwd (its kernels' device time) {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        row.update(max_abs_err=max(row["folded_err"], row["contiguous_err"]),
                   ms=row["folded_ms"], plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        rows.append(row)
        for key, val in (("ms", row["folded_ms"]),
                         ("contiguous_ms", row["contiguous_ms"]),
                         ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("flops", flops), ("exps", exps), ("bytes", nbytes)):
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
            "contiguous_ms": total["contiguous_ms"],
            "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "library": "scaled_dot_product_attention's backward kernels, "
                       "device time under torch.profiler",
            "reruns_bit_equal": True, "calls": rows}


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
# the redesign, and the probe's reason for it (scripts/head_folded_routes.py,
# section small_head; its readings are in PERF.md section 6)
SMALL_HEAD_DESIGN = (
    "the first design's kernels were bound by their products and the "
    "shared-memory loads that fed them, not by exp2 or memory, so the "
    "redesign cuts instructions a pair: forward R query rows a lane (6 at "
    "d <= 4 past 96 rows, else 3) against keys broadcast from shared "
    "memory, a lazy offset tested once a group of 4 keys after its "
    "products; backward one launch where a head's rows fit, a warp a "
    "head, RK keys a lane (6 at d <= 4 past 96 keys, else 3), each "
    "exponential once, dQ passed lane to lane in rotation")


def check_small_head(gen):
    """The small-head kernels, forward and backward, against their plain
    versions; the flagship's calls timed beside the plain version, SDPA and
    the port's head-folded kernel at the same operands.  Bounds from
    ``attention_work``, the count head-folded attention is held to.  Both
    forwards are timed writing each row's log-sum-exp, as their autograd
    Functions run them.  No path reaches it: two entries, ``on_path``
    false."""
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
    log(f"small_head_attention design: {SMALL_HEAD_DESIGN}")
    for call, (lq, lk, d) in SMALL_HEAD_CALLS.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        do = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        with torch.inference_mode():
            got = sha.small_head_attention(q, k, v)
            out, lse = sha.forward_kernel(q, k, v)
            grads = sha.backward_kernel(q, k, v, out, lse, do)
            again = (out,) + sha.backward_kernel(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            err_f = _measure(got, sha.small_head_attention_plain(q, k, v),
                             TOL_SMALL_HEAD)
            want = sha.small_head_attention_bwd_plain(q, k, v, do)
            errs = [_measure(g, w_, TOL_SMALL_HEAD_BWD)
                    for g, w_ in zip(grads, want)]
            err_b = (max(e[0] for e in errs), max(e[1] for e in errs))
            same = all(torch.equal(a, b)
                       for a, b in zip((got,) + grads, again))
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

            # the kernels one call of each C entry launched in this run,
            # counted by the library at its launch statements, beside the
            # route the backward's entry says it takes
            launched = {}
            for way, run in (("fwd", run_fwd), ("bwd", run_bwd)):
                before = sha.kernels_launched()
                run()
                launched[way] = sha.kernels_launched() - before
        planned = {"fwd": 1, "bwd": sha.bwd_launches_a_call(lq, d)}
        log(f"small_head_attention {call} (b {B}, h {HEADS}, Lq {lq}, Lk "
            f"{lk}, d {d}): fwd max|kernel - plain| {err_f[0]:.3e} "
            f"({err_f[1]:.3f} of the tolerance {TOL_SMALL_HEAD}); bwd "
            f"{err_b[0]:.3e} ({err_b[1]:.3f} of {TOL_SMALL_HEAD_BWD}); two "
            f"runs bit-equal, forward and backward: {same}; kernels launched "
            f"a call {launched} (planned {planned})")
        if not (err_f[1] <= 1.0 and err_b[1] <= 1.0 and same
                and launched == planned):
            raise AssertionError(
                f"small_head_attention {call}: fwd {err_f}, bwd {err_b}, "
                f"bit-equal {same}, launched {launched}, planned {planned}")
        for way, err in (("fwd", err_f), ("bwd", err_b)):
            worst[way] = max(worst[way], err, key=lambda e: e[1])
        if call not in SMALL_HEAD_TIMED:
            continue
        with torch.inference_mode():
            # head-folded at the same operands, through its C entries too
            hf_out, hf_lse = hfa.forward_kernel(q, k, v, with_lse=True)
            hf_fwd = [t.data_ptr() for t in (q, k, v, fwd_out, fwd_lse)]
            hf_strides = hfa.launch_strides(q, k, v, fwd_out)
            hb, wph = hfa.bwd_plan(HEADS, lq, lk, d)
            hf_bwd = [t.data_ptr() for t in (q, k, v, hf_out, hf_lse, do,
                                             *bufs[:3])]
            hf_bwd.append(None if hb else bufs[3].data_ptr())
            hf_bwd_strides = hfa.launch_strides(q, k, v, hf_out, do,
                                                *bufs[:3])

            def run_hf_fwd():
                if hfa.launcher()(*hf_fwd, hf_strides, B, HEADS, lq, lk, d,
                                  stream):
                    raise RuntimeError("head_folded_attention_fwd failed")

            def run_hf_bwd():
                if hfa.bwd_launcher()(*hf_bwd, hf_bwd_strides, B, HEADS, lq,
                                      lk, d, hb, wph, stream):
                    raise RuntimeError("head_folded_attention_bwd failed")

            timed = {
                "fwd": {"ms": time_ms(run_fwd, 50),
                        "plain_ms": time_ms(lambda: sha.small_head_attention_plain(
                            q, k, v), 20),
                        "library_ms": time_ms(
                            lambda: scaled_dot_product_attention(q, k, v), 20),
                        "head_folded_ms": time_ms(run_hf_fwd, 50)},
                "bwd": {"ms": time_ms(run_bwd, 50),
                        "plain_ms": time_ms(
                            lambda: sha.small_head_attention_bwd_plain(
                                q, k, v, do), 20),
                        "head_folded_ms": time_ms(run_hf_bwd, 50)}}
        timed["bwd"]["library_ms"] = sdpa_bwd_ms(q, k, v, do, 20)
        for way in ("fwd", "bwd"):
            flops, exps, nbytes = attention_work(n, lq, lk, d, way)
            bound_ms, bound_by = bound(flops, exps, nbytes)
            t = timed[way]
            launches = launched[way]
            log(f"small_head_attention {way} {call}: kernel {t['ms']:.4f} ms "
                f"({launches} launch{'es' if launches > 1 else ''}), plain "
                f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, "
                f"head-folded kernel {t['head_folded_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            rows[way].append({"call": call, "lq": lq, "lk": lk, "d": d,
                              "kernels_launched_a_call": launches,
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
            "design": SMALL_HEAD_DESIGN, "reruns_bit_equal": True,
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
    # more model options: the GP's, the flag, the backbone
    gp: dict = dataclasses.field(default_factory=dict)
    # gradients that the training check may also judge against float64
    f64_leaves: tuple = ()
    # gradients that are 0 in exact arithmetic (fnmatch patterns): residue
    # on both devices, held below ZERO_GRAD of the step's largest gradient
    zero_leaves: tuple = ()
    epochs: int = N_EPOCHS  # timed epochs of training
    steps: int = N_TRAIN_STEPS  # steps per timed epoch
    # the exact blur on its Cholesky kernel (``ExactGPBlur.use_pallas``,
    # which no model option reaches, in either package)
    blur_pallas: bool = False

    def model(self, device: str, seed: int = SEED):
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
        model = ForecastDenoising(
            src_input_size=self.features, tgt_input_size=self.features,
            d_model=self.d_model, n_heads=HEADS, d_k=self.d_model // HEADS,
            stack_size=self.layers, pred_len=self.pred,
            attn_type=self.attn_type, gp=True, denoise=True,
            num_inducing=INDUCING, device=device,
            generator=torch.Generator().manual_seed(seed), **extra)
        if self.blur_pallas:
            model.deep_gp.use_pallas = True
        return model

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
    ("fused_gp", "fused_gp_bwd", "fused_gp_seeds", "fused_gp_seeds_bwd",
     "fused_gp_bf16_seeds", "fused_gp_bf16_seeds_bwd",
     "head_folded_attention",
     "head_folded_attention_bwd", "fused_gp_bf16", "fused_gp_bf16_bwd",
     "flash_attention", "flash_attention_bwd", "flash_attention_bf16sm",
     "flash_attention_bf16sm_bwd", "flash_attention_fp32",
     "flash_attention_fp32_bwd", "rbf", "rbf_seeds", "cholesky",
     "small_head_attention", "small_head_attention_bwd"), 0)
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
    # bench.py bench_prod_step as it stands (bench.py:136-161): autoformer
    # at d_model 512, 8 heads (d_k 64), 2 layers, bf16 model and GP, the
    # GP's default lengthscale; AutoCorrelation is torch ops (cuFFT), so the
    # bf16 fused GP is its only hand kernel, once each way a step
    Config("prod_autoformer", "autoformer", batch=P_B, enc_len=P_ENC_LEN,
           dec_len=P_DEC_LEN, pred=P_PRED, features=P_F, d_model=P_D_MODEL,
           layers=P_LAYERS, bf16=True, n_windows=P_N_WINDOWS,
           n_check=P_N_CHECK, per_batch=dict(_NONE, fused_gp_bf16=1),
           per_step=dict(_NONE, fused_gp_bf16=1, fused_gp_bf16_bwd=1),
           gp=dict(gp_ls_init=0.0)),
    # the flagship in bf16, as bench.py bench_jax(bf16=True) builds it
    # (bench.py:49-56): the same launches at d 32
    Config("autoformer_bf16", "autoformer", **dict(_FLAGSHIP, bf16=True),
           per_batch=dict(_NONE, fused_gp_bf16=1),
           per_step=dict(_NONE, fused_gp_bf16=1, fused_gp_bf16_bwd=1),
           gp=dict(gp_ls_init=0.0)),
    # the paper's comparison rows (RESULTS.md:84-89) at the flagship's
    # width, fp32: ProbSparse and Fourier attention and the LSTM backbone
    # are torch ops (cuFFT, cuDNN), the fused GP their hand kernel; a few
    # steps each
    *(Config(name, attn_type, **_FLAGSHIP,
             per_batch=dict(_NONE, fused_gp=1),
             per_step=dict(_NONE, fused_gp=1, fused_gp_bwd=1), gp=gp,
             epochs=1, steps=4)
      for name, attn_type, gp in (("informer", "informer", {}),
                                  ("fedformer", "fedformer", {}),
                                  ("lstm", "basic", dict(backbone="lstm")))),
    # the conv family at 16 bits, flag off: fp32 convolutions on the bf16
    # projections, plain attention; the bf16 fused GP
    Config("conv_attn_bf16", "conv_attn", **dict(_FLAGSHIP, bf16=True),
           per_batch=dict(_NONE, fused_gp_bf16=1),
           per_step=dict(_NONE, fused_gp_bf16=1, fused_gp_bf16_bwd=1),
           epochs=1, steps=4),
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


class _SampleRecorder:
    """Wraps ProbSparse attention in the transformer module (or
    ``module``: the Informer stack's) and keeps each call's key sample and
    the queries it chose (per sample).  Given ``replay`` (another run's
    ``draws``), each call takes those instead, the queries cut to this
    call's batch (a served batch is padded on the card, not on the CPU);
    ``flips`` counts the (sample, head) pairs whose own choice here, from
    the replayed sample, differed."""

    def __init__(self, replay=None, module=None):
        from fine_grained_gaussian_process_forcasting_torch.models import (
            transformer,
        )
        from fine_grained_gaussian_process_forcasting_torch.ops import (
            probsparse,
        )

        self.module, self.ops = module or transformer, probsparse
        self.original = self.module.prob_sparse_attention
        self.replay = replay
        self.draws, self.flips = [], 0

    def __enter__(self):
        def recording(q, k, v, generator=None, **kw):
            ops = self.ops
            u_part, u = ops.sample_sizes(q.shape[2], k.shape[2],
                                         kw.get("factor", 1))
            if self.replay is not None:
                sample, m_top = (t.to(q.device) for t in
                                 self.replay[len(self.draws)])
                m_top = m_top[: q.shape[0]]
                own = ops.top_queries(q, k, sample, u)
                self.flips += int((own.sort(-1).values
                                   != m_top.sort(-1).values).any(-1).sum())
            else:
                sample = ops.sample_keys(q.shape[2], k.shape[2], u_part,
                                         generator, q.device)
                m_top = ops.top_queries(q, k, sample, u)
            self.draws.append((sample.cpu(), m_top.cpu()))
            return self.original(q, k, v, index_sample=sample, m_top=m_top,
                                 **kw)

        self.module.prob_sparse_attention = recording
        return self

    def __exit__(self, *exc):
        self.module.prob_sparse_attention = self.original


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
    # the copy kernels (``.contiguous()``, transposes back), on record
    # beside the kernels around which layouts are changed
    copies = [e for e in kernels if "direct_copy" in e.key]
    copy_ms = sum(e.self_device_time_total for e in copies) / 1e3
    copy_launches = sum(e.count for e in copies)
    log(f"profile {label}: direct_copy kernels {copy_launches} launches, "
        f"{copy_ms:.4f} ms")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")
    return {"busy_ms": busy_ms, "launches": launches,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "direct_copy_launches": copy_launches,
            "direct_copy_ms": copy_ms}


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
            # the calls with the seed axis, counted in fused_gp's too
            "fused_gp_seeds": (fused_gp, "seeds_launches"),
            "fused_gp_seeds_bwd": (fused_gp, "seeds_bwd_launches"),
            "fused_gp_bf16_seeds": (fused_gp, "bf16_seeds_launches"),
            "fused_gp_bf16_seeds_bwd": (fused_gp, "bf16_seeds_bwd_launches"),
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
            # the launches with the seed axis, counted in rbf's too
            "rbf_seeds": (rbf, "seeds_launches"),
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
    with _DelayRecorder() as rec_gpu, _EpsRecorder() as eps_gpu, \
            _SampleRecorder() as psp_gpu:
        gpu_first = session.predict(enc[:n], dec[:n])
    with _DelayRecorder(replay=rec_gpu.delays) as rec_cpu, \
            _EpsRecorder(replay=eps_gpu.draws), \
            _SampleRecorder(replay=psp_gpu.draws) as psp_cpu:
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
        f"{torch.nonzero(flipped).flatten().tolist()}"
        + (f"; ProbSparse key samples and queries replayed from the card "
           f"in {len(psp_gpu.draws)} calls, (window, head) choices that "
           f"differ on the cpu: {psp_cpu.flips}" if psp_gpu.draws else ""))
    if not max_diff <= tol:
        raise AssertionError(f"{cfg.name}: cuda and cpu disagree: "
                             f"{max_diff} > {tol}")
    return counts, {"windows_compared": n, "max_abs_diff": max_diff,
                    "tolerance": tol,
                    "delays_replayed_windows": int(flipped.sum()),
                    "probsparse_choices_replayed": psp_cpu.flips}


# int8 serving (train/quantize.py): JAX's own bound for the int8 session
# against fp32, 0.15 of the largest fp32 prediction (tests/test_quantize.py)
TOL_INT8_VS_FP32 = 0.15
# the card's int8 session against the CPU's: the int8 products are exact
# int32 sums on both devices, but the activations entering each int8 layer
# differ by the devices' fp32 rounding, and every activation whose x / x_s
# falls that close to a half takes the neighbouring int8 code on the other
# device, one step of 1/127 of its token's largest activation: 8-bit values
# rounded the other way at places, as in the bf16 model, whose card-vs-CPU
# gate this takes (TOL_SERVING_BF16, 2^-5 of the largest prediction)
TOL_SERVING_INT8 = 2.0 ** -5
# the exported program against ``session.predict``: the JAX package's
# tolerances for its own artifact (tests/test_predict.py), (rtol, atol)
TOL_EXPORT = (1e-6, 1e-7)
TOL_EXPORT_INT8 = (1e-5, 1e-6)
# predict_dataframe: the electricity windows served (one batch of 256)
DF_WINDOWS = 256


def _median_ms(fn, runs: int = 5) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def serve_int8(cfg: Config, card: str):
    """The int8 session (``quantize="int8"``) at full width: every window
    of ``serve``'s, the launches a batch as fp32's, within JAX's bound of
    the fp32 session on the card, the first windows against the int8
    session on the CPU (the card's delays replayed), and latency a batch
    and windows/s beside fp32's."""
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    b = cfg.batch
    enc, dec = cfg.windows(cfg.n_windows, SEED)
    model = cfg.model("cuda")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    fp32 = InferenceSession(model, state, batch_size=b, device="cuda")
    int8 = InferenceSession(model, state, batch_size=b, device="cuda",
                            quantize="int8")
    for session in (fp32, int8):
        session.predict(enc[:b], dec[:b])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out8 = int8.predict(enc, dec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-cfg.n_windows // b)
    expect = {k: n_batches * v for k, v in cfg.per_batch.items()}
    if out8.shape != (cfg.n_windows, cfg.pred, 1):
        raise AssertionError(f"{cfg.name} int8: output shape {out8.shape}")
    if not np.all(np.isfinite(out8)):
        raise AssertionError(f"{cfg.name} int8: non-finite predictions")
    if counts != expect:
        raise AssertionError(f"{cfg.name} int8: launches {counts}, "
                             f"expected {expect}")
    # against fp32 on the same delays: a near-tie that quantization noise
    # breaks the other way picks other delays, another function (why JAX
    # holds only basic to the bound); both figures are printed
    with _DelayRecorder() as rec32:
        out32 = fp32.predict(enc, dec)
    with _DelayRecorder(replay=rec32.delays) as rec8:
        same_delays = int8.predict(enc, dec)
    # each call's delays are one padded batch's, a batch's calls in turn
    flipped = np.zeros(n_batches * b, dtype=bool)
    calls = len(rec32.delays) // n_batches
    for i, differs in enumerate(_differing(rec8.delays, rec32.delays)):
        start = i // calls * b
        flipped[start: start + b] |= differs.numpy()
    flipped = flipped[: cfg.n_windows]

    def rel(a):
        return float(np.abs(a - out32).max() / (np.abs(out32).max() + 1e-3))

    vs_fp32, own_delays = rel(same_delays), rel(out8)
    if not 0.0 < vs_fp32 < TOL_INT8_VS_FP32:
        raise AssertionError(f"{cfg.name} int8: max|int8 - fp32| / max|fp32|"
                             f" {vs_fp32:.3e} on fp32's delays, expected in "
                             f"(0, {TOL_INT8_VS_FP32})")
    ms = {name: _median_ms(lambda s=s: s.predict(enc[:b], dec[:b]))
          for name, s in (("int8", int8), ("fp32", fp32))}

    n = cfg.n_check
    cpu = InferenceSession(cfg.model("cpu"), state, batch_size=n,
                           device="cpu", quantize="int8")
    with _DelayRecorder() as rec_gpu:
        gpu_first = int8.predict(enc[:n], dec[:n])
    with _DelayRecorder(replay=rec_gpu.delays):
        cpu_first = cpu.predict(enc[:n], dec[:n])
    max_diff = float(np.abs(gpu_first - cpu_first).max())
    mean_diff = float(np.abs(gpu_first - cpu_first).mean())
    tol = TOL_SERVING_INT8 * float(np.abs(cpu_first).max())
    log(f"serve_int8 {cfg.name} on {card}: {cfg.n_windows} windows in "
        f"{wall * 1e3:.2f} ms ({cfg.n_windows / wall:.1f} windows/s); per "
        f"batch of {b}: int8 {ms['int8']:.3f} ms ({b / ms['int8'] * 1e3:.1f}"
        f" windows/s), fp32 {ms['fp32']:.3f} ms ({b / ms['fp32'] * 1e3:.1f}"
        f" windows/s); peak memory {peak / 2**20:.1f} MiB; launches "
        f"{counts}; max|int8 - fp32| / max|fp32| {vs_fp32:.3e} on fp32's "
        f"delays (bound {TOL_INT8_VS_FP32}), {own_delays:.3e} on its own, "
        f"whose delays differ in {int(flipped.sum())} of {cfg.n_windows} "
        f"windows; int8 max|cuda - cpu| over {n} windows "
        f"{max_diff:.3e} (tol {tol:.3e}; mean {mean_diff:.3e}, max|cpu| "
        f"{float(np.abs(cpu_first).max()):.3e})")
    if not max_diff <= tol:
        raise AssertionError(f"{cfg.name} int8: cuda and cpu disagree: "
                             f"{max_diff} > {tol}")
    return counts, {"int8_vs_fp32": vs_fp32,
                    "int8_vs_fp32_bound": TOL_INT8_VS_FP32,
                    "int8_vs_fp32_own_delays": own_delays,
                    "windows_own_delays_differ": int(flipped.sum()),
                    "windows_compared": n, "max_abs_diff": max_diff,
                    "mean_abs_diff": mean_diff, "tolerance": tol,
                    "int8_batch_ms": ms["int8"],
                    "fp32_batch_ms": ms["fp32"]}


def _within(got, want, rtol_atol):
    """max(|got - want| / (atol + rtol |want|)): at most 1 passes."""
    rtol, atol = rtol_atol
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


_FRESH_LOADER = """
import json, sys
import numpy as np
import torch
from fine_grained_gaussian_process_forcasting_torch import serving
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    fused_gp, head_folded_attention)
serve = serving.load_exported(sys.argv[1])
enc, dec = np.load(sys.argv[2]), np.load(sys.argv[3])
serve(enc, dec)
torch.cuda.synchronize()
fused_gp.launches = head_folded_attention.launches = 0
out = serve(enc, dec)
torch.cuda.synchronize()
np.save(sys.argv[4], out)
print(json.dumps({"fused_gp": fused_gp.launches,
                  "head_folded_attention": head_folded_attention.launches,
                  "modules": sorted(m for m in sys.modules if m.startswith(
                      "fine_grained_gaussian_process_forcasting_torch"))}))
"""


def _fresh_process_load(path, enc, dec, want, tmpdir, expect):
    """The artifact loaded and served in a new process that imports
    ``serving`` (torch and the kernels' ops) and nothing of the model."""
    files = [os.path.join(tmpdir, f"{n}.npy") for n in ("enc", "dec", "out")]
    np.save(files[0], enc)
    np.save(files[1], dec)
    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-c", _FRESH_LOADER, path, *files],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    if run.returncode != 0:
        raise AssertionError(f"fresh-process load failed:\n{run.stderr}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    model_code = [m for m in report["modules"] if m.split(".")[1:2] in (
        ["models"], ["params"], ["train"], ["gp"])]
    if model_code:
        raise AssertionError(f"the fresh process imported {model_code}")
    counts = {k: report[k] for k in ("fused_gp", "head_folded_attention")}
    if counts != {k: expect[k] for k in counts}:
        raise AssertionError(f"fresh-process launches {counts}, expected "
                             f"{expect}")
    err = _within(np.load(files[2]), want, TOL_EXPORT_INT8)
    if not err <= 1.0:
        raise AssertionError(f"fresh-process output off session.predict "
                             f"by {err:.3e} of the tolerance")
    return {"launches": counts, "within_tolerance": err,
            "modules": report["modules"]}


def export_served(cfg: Config, card: str, quantize, tmpdir: str,
                  fresh_process: bool = False):
    """``export_serving`` at the configuration's full batch and shapes ->
    ``load_exported`` from the file -> served: the launches of one batch
    from inside the loaded program (the kernels' ops), its output against
    ``session.predict`` at the JAX package's tolerances, export seconds,
    artifact bytes, and latency a batch beside the eager session's.
    ``exact`` takes the exact blur's Cholesky kernel (``use_pallas``, the
    route of ``exact_blur_pallas``)."""
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    label = f"{cfg.name}{'_int8' if quantize else ''}"
    b = cfg.batch
    enc, dec = cfg.windows(b, SEED + 3)
    model = cfg.model("cuda")
    expect = dict(cfg.per_batch)
    if cfg.name == "exact":
        label = f"exact_blur_pallas{'_int8' if quantize else ''}"
        model.deep_gp.use_pallas = True
        # smooth() of both streams, each a batched probe and the factor
        expect["cholesky"] = 4
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=b, device="cuda",
                               quantize=quantize)
    want = session.predict(enc, dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = session.export_serving(os.path.join(tmpdir, f"{label}.pt2"),
                                  cfg.enc_len, cfg.dec_len, cfg.features)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    served = InferenceSession.load_exported(path)
    load_s = time.perf_counter() - t0
    served(enc, dec)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    got = served(enc, dec)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expect:
        raise AssertionError(f"export {label}: launches from the loaded "
                             f"program {counts}, expected {expect}")
    tol = TOL_EXPORT_INT8 if quantize else TOL_EXPORT
    err = _within(got, want, tol)
    max_diff = float(np.abs(got - want).max())
    ms = {"exported": _median_ms(lambda: served(enc, dec)),
          "eager": _median_ms(lambda: session.predict(enc, dec))}
    log(f"export {label} on {card}: export {export_s:.2f} s, load "
        f"{load_s:.2f} s, artifact {size} bytes; launches from the loaded "
        f"program {counts}; max|exported - predict| {max_diff:.3e} "
        f"({err:.3e} of rtol {tol[0]:.0e} / atol {tol[1]:.0e}); per batch "
        f"of {b}: exported {ms['exported']:.3f} ms, eager "
        f"{ms['eager']:.3f} ms")
    if not err <= 1.0:
        raise AssertionError(f"export {label}: the loaded program is off "
                             f"session.predict by {err:.3e} of the "
                             f"tolerance (max diff {max_diff:.3e})")
    result = {"export_s": export_s, "load_s": load_s, "artifact_bytes": size,
              "max_abs_diff": max_diff, "within_tolerance": err,
              "tolerance": tol, "exported_batch_ms": ms["exported"],
              "eager_batch_ms": ms["eager"]}
    if fresh_process:
        result["fresh_process"] = _fresh_process_load(path, enc, dec, want,
                                                      tmpdir, expect)
        log(f"export {label}: a fresh process served the artifact: "
            f"{result['fresh_process']}")
    return counts, result


def predict_dataframe_phase(card: str):
    """``InferenceSession.predict_dataframe`` of the flagship (random
    weights) on the port's synthetic electricity frame, on the card and on
    the CPU (the card's delays replayed): the same identifiers in the same
    order, and the forecasts, each in its entity's standardized units,
    within the fp32 serving gate."""
    from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
        ExperimentConfig,
    )
    from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
        make_synthetic_frame,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    cfg = next(c for c in CONFIGS if c.name == "autoformer")
    raw = make_synthetic_frame("electricity", num_entities=4,
                               steps_per_entity=500, seed=SEED)
    with tempfile.TemporaryDirectory() as root:
        fmt = ExperimentConfig(PRED, "electricity",
                               root_folder=root).make_data_formatter()
    model = cfg.model("cuda")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=B, device="cuda")
    session.predict_dataframe(raw, fmt, PRED, max_windows=DF_WINDOWS)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with _DelayRecorder() as rec:
        frame = session.predict_dataframe(raw, fmt, PRED,
                                          max_windows=DF_WINDOWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect = {k: -(-DF_WINDOWS // B) * v for k, v in cfg.per_batch.items()}
    if counts != expect:
        raise AssertionError(f"predict_dataframe: launches {counts}, "
                             f"expected {expect}")
    cpu = InferenceSession(cfg.model("cpu"), state, batch_size=B,
                           device="cpu")
    with _DelayRecorder(replay=rec.delays):
        cpu_frame = cpu.predict_dataframe(raw, fmt, PRED,
                                          max_windows=DF_WINDOWS)
    cols = [f"t+{i + 1}" for i in range(PRED)]
    if list(frame) != cols + ["identifier"] or list(cpu_frame) != list(frame):
        raise AssertionError(f"predict_dataframe: columns {list(frame)}")
    ids = frame["identifier"]
    if len(ids) != DF_WINDOWS or not np.array_equal(
            ids, cpu_frame["identifier"]):
        raise AssertionError("predict_dataframe: the card's identifiers "
                             "differ from the cpu's")
    values = np.stack([frame[c] for c in cols], 1)
    ref = np.stack([cpu_frame[c] for c in cols], 1)
    # each entity's standardized units, where TOL_SERVING applies
    scale = np.array([fmt._target_scaler[i].scale_[0] for i in ids])
    max_diff = float((np.abs(values - ref) / scale[:, None]).max())
    if not np.all(np.isfinite(values)) or not max_diff <= TOL_SERVING:
        raise AssertionError(f"predict_dataframe: cuda and cpu disagree by "
                             f"{max_diff:.3e} standard deviations")
    log(f"predict_dataframe on {card}: {DF_WINDOWS} electricity windows of "
        f"{len(set(ids.tolist()))} entities in {wall * 1e3:.2f} ms, "
        f"launches {counts}; identifiers equal to the cpu's; max|cuda - "
        f"cpu| {max_diff:.3e} of each entity's std (tol {TOL_SERVING:.0e})")
    return counts, {"windows": DF_WINDOWS, "max_abs_diff_std": max_diff,
                    "tolerance": TOL_SERVING, "wall_ms": wall * 1e3}


# the export phase: (configuration, quantize, load in a fresh process too)
EXPORTS = (("basic", None, False), ("basic", "int8", False),
           ("autoformer", None, False), ("autoformer", "int8", True),
           ("autoformer_bf16", None, False), ("prod_basic", None, False),
           ("multilayer", None, False), ("exact", None, False))


def _step(cfg: Config, params, windows, device, kw, replay=None,
          dtype=torch.float32):
    """One training step of ``cfg``'s model at ``params`` in ``dtype`` on
    ``device``, on ``windows`` = (enc, dec, y), its forward given ``kw``:
    (loss, {name: gradient, on the cpu}, the recorders of its
    AutoCorrelation delays, ReLU sides, ATA top-1 scales and ProbSparse
    samples and queries).  Given ``replay`` (an earlier step's recorders),
    it takes their choices."""
    model = cfg.model(device)
    if dtype != torch.float32:
        model = model.to(dtype)
    model.load_state_dict(params)
    r = replay
    with _DelayRecorder(replay=r and r[0].delays) as rec, \
            _ReluRecorder(model, replay=r and r[1].masks) as relu, \
            _ScaleMaxRecorder(replay=r and r[2].choices) as top, \
            _SampleRecorder(replay=r and r[3].draws) as psp:
        out = model(*(t.to(device, dtype) for t in windows), training=True,
                    **kw)
    out.loss.backward()
    return out.loss.item(), {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}, \
        (rec, relu, top, psp)


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

    def kw(device, dtype=torch.float32):
        return dict(generator=torch.Generator(device).manual_seed(SEED),
                    gp_eps=[e.to(device, dtype) for e in gp_eps] or None)

    windows = tuple(t[:cfg.n_check] for t in batch)
    loss_g, grads_g, recs = _step(cfg, params, windows, "cuda", kw("cuda"))
    # the cpu takes the card's delays, its side of every ReLU, its top
    # scale of every ATA pyramid and its ProbSparse samples and queries
    loss_c, grads_c, (rec, relu, top, psp) = _step(
        cfg, params, windows, "cpu", kw("cpu"), recs)
    replay, masks, scales = recs[0].delays, recs[1].masks, recs[2].choices
    samples = recs[3].draws
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
    f64, names = {}, sorted(set(over) & set(cfg.f64_leaves))
    if names:
        _, exact, _ = _step(cfg, params, windows, "cpu",
                            kw("cpu", torch.float64), recs, torch.float64)
        for name in names:
            card, cpu = ((t[name].double() - exact[name]).abs().max().item()
                         for t in (grads_g, grads_c))
            f64[name] = {"cuda": card, "cpu_fp32": cpu}
            log(f"train {cfg.name}: {name} {over[name]:.3e} over; against "
                f"float64 on the cpu: cuda {card:.3e}, cpu fp32 {cpu:.3e}")
            if over[name] <= 10 * tol and card <= 2.0 * cpu:
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
           f"{sum(c[0].numel() for c in scales)}" if scales else "")
        + (f"; ProbSparse samples and queries replayed from the card in "
           f"{len(samples)} calls, (window, head) choices that differ on "
           f"the cpu: {psp.flips}" if samples else ""))
    if over:
        raise AssertionError(f"train {cfg.name}: cuda and cpu disagree: "
                             f"{over}")
    return {"windows_compared": cfg.n_check,
            "max_rel_diff": max(loss_err, worst), "tolerance": tol,
            "judged_against_float64": f64,
            "delays_replayed_calls": len(flipped),
            "relu_sides_replayed": relu.flips,
            "ata_scales_replayed": top.flips,
            "probsparse_choices_replayed": psp.flips,
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

    busy = profile_device(one_step, f"train {cfg.name}, one step of "
                          f"{cfg.batch} windows", median)
    cpu_check = check_step_against_cpu(cfg, after["state"].params,
                                       tuple(t[first + 1] for t in data))
    cpu_check.update(step_ms=median, steps_per_s=1e3 / median,
                     busy_ms=busy["busy_ms"], launches_a_step=busy["launches"],
                     idle_share=busy["idle_share"], peak_mib=peak / 2**20)
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
    """Wraps ``train_epoch`` of ``cls`` (``Trainer`` by default) for one CLI
    run: times each epoch (its losses are read back, so the call ends
    synchronised), keeps the last epoch's first batch for the CPU check,
    and profiles the epoch ``profile_epoch`` (None: none) against the wall
    time of the one before it."""

    def __init__(self, label: str, profile_epoch: int, cls=None):
        from fine_grained_gaussian_process_forcasting_torch.train import (
            trainer,
        )

        cls = cls or trainer.Trainer
        self.cls, self.original = cls, cls.train_epoch
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


class _no_vmap_loops(warnings.catch_warnings):
    """Fails the path if ``torch.func.vmap`` fell back to a per-seed loop
    for any op inside (its "performance drop" warning)."""

    def __init__(self, label):
        super().__init__(record=True)
        self.label = label

    def __enter__(self):
        self.caught = super().__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        slow = {str(w.message)[:200] for w in self.caught
                if "performance drop" in str(w.message)}
        if slow and exc[0] is None:
            raise AssertionError(f"{self.label}: vmap ran ops as a per-seed "
                                 f"loop: {sorted(slow)}")
        if exc[0] is None:
            log(f"{self.label}: no op fell back to a per-seed loop under "
                "vmap")


def train_multiseed(cfg: Config, card: str, single: dict,
                    per_step: dict = None, single_path: str = None):
    """``train_multiseed_{cfg.name}``: the configuration trained at N_SEEDS
    seeds as one group (``MultiSeedTrainer``), seed i from the weights of
    seed SEED + i, through the same warm-up, epochs and profiled step as
    ``train(cfg)``, whose numbers (``single``, the path ``single_path``) it
    prints beside its own.  Checks finite per-seed losses, the launches a
    step (``per_step``; the fused GP once each way a step for all seeds
    without it), no op run as vmap's per-seed loop, one step's per-seed
    losses and gradients against N_SEEDS single-seed steps on the card
    (TOL_TRAIN), and seed 0's step against the port's CPU run as ``train``
    does."""
    from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
        MultiSeedTrainer,
    )

    name = f"train_multiseed_{cfg.name}"
    seeds = [SEED + i for i in range(N_SEEDS)]
    data = cfg.training_data(N_WARMUP + cfg.epochs * cfg.steps + 2,
                             SEED + 1)
    trainer = MultiSeedTrainer(cfg.model("cuda"), cfg.d_model, N_SEEDS,
                               warmup_steps=WARMUP_STEPS, lr_mul=LR_MUL,
                               device="cuda")
    state = trainer.init_state(
        seeds, lambda s: cfg.model("cuda", seed=s).state_dict())

    def batches(i, n):
        return tuple(t[i: i + n] for t in data)

    with _no_vmap_loops(name):  # and none in evaluation
        state, _, _ = trainer.train_epoch(state, batches(0, N_WARMUP))
        trainer.eval_epoch(state, batches(0, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    epoch_ms, loss_sums = [], []
    for e in range(cfg.epochs):
        t0 = time.perf_counter()
        state, loss_sum, _ = trainer.train_epoch(
            state, batches(N_WARMUP + e * cfg.steps, cfg.steps))
        epoch_ms.append((time.perf_counter() - t0) * 1e3)  # read back: synced
        loss_sums.append(loss_sum)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if per_step is None:
        per_step = dict(_NONE, **_SEEDED_GP)
    single_path = single_path or f"train_{cfg.name}"
    expect = {k: cfg.epochs * cfg.steps * v for k, v in per_step.items()}
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    if not all(np.isfinite(v).all() for v in loss_sums):
        raise AssertionError(f"{name}: non-finite loss sums {loss_sums}")
    median = float(np.median([t / cfg.steps for t in epoch_ms]))
    first = N_WARMUP + cfg.epochs * cfg.steps
    after = {}

    def one_step():
        after["state"], _, _ = trainer.train_epoch(state, batches(first, 1))

    busy = profile_device(one_step, f"{name}, one step of {N_SEEDS} seeds x "
                          f"{cfg.batch} windows", median)
    log(f"{name} on {card}: {cfg.epochs} epochs of {cfg.steps} steps of "
        f"{N_SEEDS} seeds x {cfg.batch} windows: "
        f"{', '.join(f'{t:.2f}' for t in epoch_ms)} ms; per step median "
        f"{median:.3f} ms ({N_SEEDS * 1e3 / median:.2f} seed-steps/s; "
        f"{single_path}: {single['step_ms']:.3f} ms, "
        f"{single['steps_per_s']:.2f} steps/s); device busy a step "
        f"{busy['busy_ms']:.4f} ms in {busy['launches']} launches, idle share "
        f"{busy['idle_share']:.3f} ({single_path}: {single['busy_ms']:.4f} "
        f"ms in {single['launches_a_step']} launches, idle share "
        f"{single['idle_share']:.3f}); peak memory {peak / 2**20:.1f} MiB "
        f"({single_path}: {single['peak_mib']:.1f} MiB); mean loss per "
        f"epoch by seed {[list(np.round(v / cfg.steps, 6)) for v in loss_sums]}"
        f"; launches {counts}")

    # one step at the state after the profiled step, against N_SEEDS
    # single-seed steps on the card from each seed's parameters and draws
    batch = tuple(t[first + 1] for t in data)
    state = after["state"]
    losses, grads = trainer.gradients(state, batch)
    worst_name, worst, loss_err, over = "", 0.0, 0.0, {}
    for i in range(N_SEEDS):
        gen = torch.Generator("cuda")
        gen.set_state(state.rngs[i])
        drawn = trainer.model.noise_draws(cfg.batch, cfg.enc_len,
                                          cfg.dec_len, True, gen, "cuda")
        params = trainer.seed_params(state, i)
        loss, one, _ = _step(cfg, params, batch, "cuda", drawn)
        loss_err = max(loss_err, abs(losses[i].item() - loss) / abs(loss))
        largest = max(g.abs().max().item() for g in one.values())
        for pname, g in one.items():
            scale = max(g.abs().max().item(), 1e-6 * largest)
            rel = (grads[pname][i].cpu() - g).abs().max().item() / scale
            if rel > TOL_TRAIN:
                over[(i, pname)] = rel
            if rel > worst:
                worst_name, worst = f"seed {i} {pname}", rel
    log(f"{name}: one step's per-seed losses and gradients against "
        f"{N_SEEDS} single-seed steps on the card: loss rel diff "
        f"{loss_err:.3e}, worst gradient {worst_name} {worst:.3e} of its "
        f"largest magnitude (tol {TOL_TRAIN})")
    if not (loss_err <= TOL_TRAIN and not over):
        raise AssertionError(f"{name}: the seeds' step differs from single-"
                             f"seed steps: loss {loss_err}, {over}")
    cpu_check = check_step_against_cpu(cfg, trainer.seed_params(state, 0),
                                       batch)
    cpu_check.update(step_ms=median, seed_steps_per_s=N_SEEDS * 1e3 / median,
                     busy_ms=busy["busy_ms"], launches_a_step=busy["launches"],
                     idle_share=busy["idle_share"], peak_mib=peak / 2**20,
                     vs_single_seed_steps={"loss_rel": loss_err,
                                           "worst_grad_rel": worst},
                     single_seed_path=single_path,
                     single_seed={k: single[k] for k in (
                         "step_ms", "steps_per_s", "busy_ms",
                         "launches_a_step", "idle_share", "peak_mib")})
    return counts, cpu_check


# the fused GP at the seed axis, once each way a step for all seeds
_SEEDED_GP = dict(fused_gp=1, fused_gp_bwd=1, fused_gp_seeds=1,
                  fused_gp_seeds_bwd=1)
# the options that train at N_SEEDS seeds through the kernels' seed rules,
# 3 warm-up steps and 1 epoch of 4 each: (path's name, the configuration
# it trains, its launches a step)
MULTISEED_OPTIONS = (
    # the hidden layer's K, every seed's in one rbf launch
    ("multilayer", "multilayer", dict(_NONE, **_SEEDED_GP, rbf=1,
                                      rbf_seeds=1)),
    ("exact", "exact", _NONE),  # the library's factorizations
    # the blur's three factorizations a step (smooth of both streams, mll),
    # each a jitter probe and the differentiable factor: one launch each
    # for all seeds
    ("exact_blur_pallas", "exact", dict(_NONE, cholesky=6)),
    ("lstm", "lstm", dict(_NONE, **_SEEDED_GP)),  # one cuDNN call a seed
    ("informer", "informer", dict(_NONE, **_SEEDED_GP)),
)


def multiseed_options(card: str, record, cpu_checks):
    """``train_multiseed_{multilayer, exact, exact_blur_pallas, lstm,
    informer}``: each configuration at the flagship's width at N_SEEDS
    seeds, beside its single-seed path's numbers."""
    by_name = {cfg.name: cfg for cfg in CONFIGS}
    for name, base, per_step in MULTISEED_OPTIONS:
        cfg = dataclasses.replace(by_name[base], name=name, epochs=1,
                                  steps=4,
                                  blur_pallas=name == "exact_blur_pallas")
        path = f"train_multiseed_{name}"
        counts, cpu_checks[path] = train_multiseed(
            cfg, card, cpu_checks[f"train_{base}"], per_step,
            f"train_{base}")
        record(path, counts)


def cli_multiseed(card: str):
    """``train.cli.main`` with ``--multiseed True --n_seeds 3
    --use_pallas_attention True`` at ``cli_ata``'s cuts: the three seeds
    train as one group (head-folded attention once a call site for all
    seeds), each is evaluated on the test windows, then
    ``evaluate_checkpoints`` scores the three checkpoints.  Checks the
    launches, three checkpoints, loss curves, ``.npz`` files and CSV rows,
    and finite per-seed test errors, which it prints."""
    import random
    import shutil
    import tempfile

    from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
        make_synthetic_frame,
    )
    from fine_grained_gaussian_process_forcasting_torch.train import cli
    from fine_grained_gaussian_process_forcasting_torch.train.evaluate_checkpoints import (
        EvalArgs,
        evaluate_checkpoints,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
        MultiSeedTrainer,
    )

    label = "cli_multiseed"
    rng = random.Random(1234)  # the CLI's seeds
    seeds = [rng.randint(1000, 9999) for _ in range(N_SEEDS)]
    names = [f"ATA_solar_{PRED}_{s}_denoise_gp" for s in seeds]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_ms_")
    try:
        argv = [a if a != "1" or CLI_ARGV[i - 1] != "--n_seeds"
                else str(N_SEEDS) for i, a in enumerate(CLI_ARGV)]
        argv += ["--multiseed", "True", "--use_pallas_attention", "True",
                 "--out_dir", out_dir]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        # no epoch under the profiler: at ~3,800 launches a step under
        # vmap it would take ~30 s (train_multiseed_autoformer profiles)
        with _EpochWatch(label, profile_epoch=None,
                         cls=MultiSeedTrainer) as watch, \
                _no_vmap_loops(label):
            results = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = sum(watch.steps)
        n_valid = CLI_VALID // B
        seeded = steps + CLI_EPOCHS * n_valid  # trained, then validated
        single = N_SEEDS * n_valid  # each seed's test windows
        per_call = 6  # enc-self, dec-self, dec-cross, in both passes
        expect = dict(_NONE, fused_gp=seeded + single, fused_gp_bwd=steps,
                      fused_gp_seeds=seeded, fused_gp_seeds_bwd=steps,
                      head_folded_attention=per_call * (seeded + single),
                      head_folded_attention_bwd=per_call * steps)
        if watch.steps != [CLI_TRAIN // B] * CLI_EPOCHS or counts != expect:
            raise AssertionError(f"{label}: steps {watch.steps}, launches "
                                 f"{counts}, expected {expect}")
        if len(results) != N_SEEDS or not all(
                math.isfinite(r["mse"]) and math.isfinite(r["mae"])
                for r in results):
            raise AssertionError(f"{label}: evaluation {results}")
        with open(f"{out_dir}/reported_errors_solar.csv") as f:
            rows = f.read().splitlines()
        if rows[0] != ",MSE,MAE" or [r.split(",")[0] for r in rows[1:]] \
                != names:
            raise AssertionError(f"{label}: reported errors {rows}")
        for name in names:
            preds = np.load(f"{out_dir}/solar/{name}.npz")["predictions"]
            curve = np.load(f"{out_dir}/losses_lists/"
                            f"{name}_mse_losses_valid.npy")
            if preds.shape != (n_valid, B, PRED) or curve.shape != (
                    CLI_EPOCHS,) or not np.isfinite(preds).all():
                raise AssertionError(f"{label}: {name}: predictions "
                                     f"{preds.shape}, curve {curve.shape}")
            torch.load(f"{out_dir}/models_solar_{PRED}/{name}",
                       weights_only=True)  # the checkpoint loads

        raw = make_synthetic_frame("solar", num_entities=8,
                                   steps_per_entity=1600, seed=0)
        scored = evaluate_checkpoints(raw, EvalArgs(
            exp_name="solar", pred_len=PRED, seeds=tuple(seeds),
            attn_types=("ATA",), d_models=(D_MODEL,), stack_sizes=(LAYERS,),
            out_dir=out_dir, num_inducing=INDUCING, max_samples=CLI_VALID,
            batch_size=B), device="cuda")
        counts_all = read_counts()
        evaluated = counts_all["fused_gp"] - counts["fused_gp"]
        if len(scored) != N_SEEDS or evaluated != N_SEEDS * n_valid or not \
                all(np.isfinite(r["per_step_mse"]).all()
                    and r["per_step_mse"].shape == (PRED,)
                    for r in scored.values()):
            raise AssertionError(f"{label}: evaluate_checkpoints scored "
                                 f"{list(scored)}, fused-GP launches "
                                 f"{evaluated}")
        epoch_ms = watch.epoch_ms
        step_ms = float(np.median([t / n for t, n in zip(epoch_ms[1:],
                                                         watch.steps[1:])]))
        test = {s: r["errors"] for s, r in zip(seeds, results)}
        mses = [r["mse"] for r in results]
        log(f"{label} on {card}: cli.main in {wall:.2f} s; train epochs of "
            f"{watch.steps[0]} steps of {N_SEEDS} seeds x {B} windows: "
            f"{', '.join(f'{t:.2f}' for t in epoch_ms)} ms; per step "
            f"{step_ms:.3f} ms ({N_SEEDS * 1e3 / step_ms:.2f} seed-steps/s, "
            f"the median of epochs 1-{CLI_EPOCHS - 1}); peak memory "
            f"{peak / 2**20:.1f} MiB; launches {counts}")
        log(f"{label}: test errors by seed {test}; test MSE mean "
            f"{np.mean(mses):.4f}, std {np.std(mses):.4f} (throughput cuts: "
            f"{CLI_TRAIN} training windows, {CLI_EPOCHS} epochs)")
        log(f"{label}: evaluate_checkpoints on its own {CLI_VALID} test "
            f"windows: " + "; ".join(
                f"{k} MSE {r['mse']:.4f} MAE {r['mae']:.4f}"
                for k, r in scored.items()))
        return counts_all, {
            "epoch_ms": epoch_ms, "seed_steps_per_s": N_SEEDS * 1e3 / step_ms,
            "peak_mib": peak / 2**20,
            "test_errors": test, "test_mse_mean": float(np.mean(mses)),
            "test_mse_std": float(np.std(mses)),
            "evaluate_checkpoints_mse": {k: r["mse"]
                                         for k, r in scored.items()}}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# the baselines phase: BaselinesHarness at the harness's published widths
BL_MODELS = ("DLinear", "NBeats", "DeepAR", "CMGP")
BL_HISTORY = 192  # max_encoder_length, the harness's default
BL_BATCH = 256  # the loader's batch, which the harness keeps
BL_TRAIN_BATCHES, BL_TEST_BATCHES = 8, 2
BL_WIDEST = (64, 2)  # the study's widest (d_model, stack); CMGP d_model 32
BL_STEPS, BL_RUNS = 20, 3  # timed steps a run at the widest configuration
BL_F64_DRAWS = 8  # CMGP's gates against float64: batches summed


def _bl_distance(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bl_step(harness, model, x, y):
    """One step's loss and every gradient, as float64 numpy, by name."""
    model.zero_grad(set_to_none=True)
    loss = harness.loss(model, x, y)
    loss.backward()
    out = {"loss": loss.detach().double().cpu().numpy()}
    out.update({n: p.grad.detach().double().cpu().numpy()
                for n, p in model.named_parameters()})
    return out


def _bl_cut(loader):
    """The loader's batches (of 256, the loader's size) cut to
    ``BL_TRAIN_BATCHES`` train and ``BL_TEST_BATCHES`` valid and test."""
    for split, n in (("train_loader", BL_TRAIN_BATCHES),
                     ("valid_loader", BL_TEST_BATCHES),
                     ("test_loader", BL_TEST_BATCHES)):
        batches = getattr(loader, split)
        if batches.n_batches < n or batches.x_enc.shape[1] != BL_BATCH:
            raise AssertionError(f"baselines: {split} has "
                                 f"{batches.x_enc.shape[:2]} batches")
        setattr(loader, split, dataclasses.replace(
            batches, x_enc=batches.x_enc[:n], x_dec=batches.x_dec[:n],
            y=batches.y[:n]))


def _bl_cpu_model(harness, config, state, dtype=torch.float32):
    model = harness._make_model(*config).to(dtype)
    model.load_state_dict({k: v.detach().cpu().to(dtype)
                           for k, v in state.items()})
    return model


def baselines_phase(card: str):
    """``BaselinesHarness`` on the card: DLinear, NBeats, DeepAR and CMGP on
    the port's synthetic electricity frame (8 entities x 1200 hours), at
    the harness's widths (history 192, horizon 96, batches of 256), one
    trial of 2 epochs each, the loader cut to 8 train and 2 valid and test
    batches; ``evaluate`` beside the CPU's on the card's best parameters
    (DeepAR's draws are the same CPU generator's on both), the error CSV's
    four rows.  Then each model at the study's widest configuration:
    steps/s, device busy a step, idle share and peak memory, and one step's
    loss and gradients against the CPU's.  Every gate is the fp32 training
    gate but CMGP's: its Cholesky of a smooth kernel is held to float64 on
    the CPU (the card's distance at most twice the fp32 CPU's, summed).
    The baselines launch no hand kernel."""
    from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
        make_synthetic_frame,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.baselines_harness import (  # noqa: E501
        BaselineArgs,
        BaselinesHarness,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
        noam_adam,
    )

    raw = make_synthetic_frame("electricity", num_entities=8,
                               steps_per_entity=1200, seed=SEED)
    zero_counts()
    report = {}
    with tempfile.TemporaryDirectory() as root:
        for name in BL_MODELS:
            args = BaselineArgs(
                exp_name="electricity", model_name=name, pred_len=PRED,
                n_trials=1, num_epochs=2, out_dir=os.path.join(root, "cuda"),
                max_encoder_length=BL_HISTORY)
            t0 = time.perf_counter()
            h = BaselinesHarness(raw, args, device="cuda")
            _bl_cut(h.loader)
            h.run_study()
            result = h.evaluate()
            study_s = time.perf_counter() - t0
            losses = [v for _, _, t, vl in h.epoch_losses for v in (t, vl)]
            if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"baselines {name}: epoch losses "
                                     f"{h.epoch_losses}")
            # evaluate on the CPU with the card's best parameters
            cpu = BaselinesHarness(raw, dataclasses.replace(
                args, out_dir=os.path.join(root, "cpu")), device="cpu")
            _bl_cut(cpu.loader)
            config = h.best_config

            def cpu_predictions(dtype):
                cpu.best_model = _bl_cpu_model(cpu, config, h.best_params,
                                               dtype)
                cpu.best_params = cpu.best_model.state_dict()
                return cpu.evaluate()["predictions"]

            preds, ref = result["predictions"], cpu_predictions(torch.float32)
            if not np.all(np.isfinite(preds)):
                raise AssertionError(f"baselines {name}: non-finite "
                                     f"predictions")
            if name == "CMGP":
                ref64 = cpu_predictions(torch.float64)
                d_card, d_cpu = (_bl_distance(p, ref64) for p in (preds, ref))
                eval_gate = {"vs_float64_cuda": d_card,
                             "vs_float64_cpu": d_cpu}
                ok = d_card <= 2.0 * d_cpu
            else:
                d_card = _bl_distance(preds, ref)
                eval_gate = {"vs_cpu": d_card, "tolerance": TOL_TRAIN}
                ok = d_card <= TOL_TRAIN
            if not ok:
                raise AssertionError(f"baselines {name}: evaluate's "
                                     f"predictions, cuda vs cpu {eval_gate}")

            # the widest configuration: timed steps, a profiled one, and one
            # step's loss and gradients against the CPU
            config = (32 if name == "CMGP" else BL_WIDEST[0], BL_WIDEST[1])
            model = h._make_model(*config)
            opt = noam_adam(model.parameters(), config[0], WARMUP_STEPS)
            tl = h.loader.train_loader
            xs = torch.from_numpy(np.concatenate([tl.x_enc, tl.x_dec],
                                                 2)).cuda()
            ys = torch.from_numpy(tl.y).cuda()
            for i in range(N_WARMUP):
                h.train_step(model, opt, xs[i], ys[i])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for _ in range(BL_RUNS):
                t1 = time.perf_counter()
                step_losses = [h.train_step(model, opt, xs[i % len(xs)],
                                            ys[i % len(xs)])
                               for i in range(BL_STEPS)]
                total = float(torch.stack(step_losses).sum())  # synced
                step_ms.append((time.perf_counter() - t1) * 1e3 / BL_STEPS)
                if not math.isfinite(total):
                    raise AssertionError(f"baselines {name}: non-finite "
                                         f"training loss at {config}")
            peak = torch.cuda.max_memory_allocated()
            median = float(np.median(step_ms))
            busy = profile_device(
                lambda: h.train_step(model, opt, xs[0], ys[0]),
                f"baselines {name} at {config}, one step of {BL_BATCH} "
                f"windows", median)
            state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            cpu_model = _bl_cpu_model(cpu, config, state)
            draws = BL_F64_DRAWS if name == "CMGP" else 1
            worst, summed = {}, {"cuda": 0.0, "cpu": 0.0}
            for j in range(draws):
                got = _bl_step(h, model, xs[j], ys[j])
                want = _bl_step(cpu, cpu_model, xs[j].cpu(), ys[j].cpu())
                if name == "CMGP":
                    m64 = _bl_cpu_model(cpu, config, state, torch.float64)
                    ref64 = _bl_step(cpu, m64, xs[j].cpu().double(),
                                     ys[j].cpu().double())
                    for k in ref64:
                        summed["cuda"] += _bl_distance(got[k], ref64[k])
                        summed["cpu"] += _bl_distance(want[k], ref64[k])
                else:
                    worst = {k: _bl_distance(got[k], want[k]) for k in want}
            if name == "CMGP":
                step_gate = {"vs_float64_summed_cuda": summed["cuda"],
                             "vs_float64_summed_cpu": summed["cpu"],
                             "draws": draws}
                ok = summed["cuda"] <= 2.0 * summed["cpu"]
            else:
                step_gate = {"worst": max(worst.values()),
                             "worst_leaf": max(worst, key=worst.get),
                             "tolerance": TOL_TRAIN}
                ok = step_gate["worst"] <= TOL_TRAIN
            if not ok:
                raise AssertionError(f"baselines {name}: one step at "
                                     f"{config}, cuda vs cpu {step_gate}")
            log(f"baselines {name} on {card}: study (1 trial, 2 epochs of "
                f"{BL_TRAIN_BATCHES} batches of {BL_BATCH}, config "
                f"{h.best_config}) and evaluate in {study_s:.2f} s, epoch "
                f"losses {h.epoch_losses}; test MSE {result['mse']:.6f} MAE "
                f"{result['mae']:.6f}; evaluate vs cpu {eval_gate}; widest "
                f"{config}: median {median:.3f} ms a step "
                f"({1e3 / median:.2f} steps/s) over {BL_RUNS} runs of "
                f"{BL_STEPS}, device busy {busy['busy_ms']:.4f} ms in "
                f"{busy['launches']} launches, idle share "
                f"{busy['idle_share']:.3f}, peak memory "
                f"{peak / 2**20:.1f} MiB; one step vs cpu {step_gate}")
            report[name] = {
                "study_s": study_s, "best_config": list(h.best_config),
                "test_mse": result["mse"], "test_mae": result["mae"],
                "evaluate_vs_cpu": eval_gate, "widest": list(config),
                "step_ms": median, "steps_per_s": 1e3 / median,
                "busy_ms": busy["busy_ms"], "launches_a_step":
                busy["launches"], "idle_share": busy["idle_share"],
                "peak_mib": peak / 2**20, "step_vs_cpu": step_gate}
        csv_path = os.path.join(
            root, "cuda", "Previous_set_up_Final_errors_electricity.csv")
        with open(csv_path) as f:
            rows = f.read().splitlines()
        if len(rows) != 1 + len(BL_MODELS) or rows[0] != ",MSE,MAE":
            raise AssertionError(f"baselines: error CSV {rows}")
        log(f"baselines: {csv_path.rsplit(os.sep, 1)[1]}: {rows}")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"baselines: a hand kernel launched: {counts}")
    return counts, report


# the rest of models/: the FEDformer stack at the FEDformer repository's
# run.py defaults (Zhou et al., ICML 2022), the Informer stack at the
# Informer paper's width (Zhou et al., AAAI 2021), the batched ARIMA and the
# denoising VAE
FED_CFG = dict(enc_in=7, dec_in=7, c_out=7, seq_len=96, label_len=48,
               pred_len=96, d_model=512, n_heads=8, d_ff=2048, e_layers=2,
               d_layers=1, moving_avg=(24,), mode_select="random", modes=64,
               L=3, base="legendre", cross_activation="tanh", embed="timeF",
               freq="h")
FED_VERSIONS = ("Fourier", "Wavelets", "Autoformer")
FED_BATCH, FED_MARKS, FED_LR = 32, 4, 1e-4  # run.py's batch and lr
INF_D, INF_HEADS, INF_B, INF_ENC, INF_DEC = 512, 8, 32, 96, 72  # 48 + 24
VAE_D, VAE_B, VAE_L, VAE_TARGET = 32, 256, ENC_LEN + DEC_LEN, PRED
AR_WINDOWS, AR_LEN, AR_STEPS, AR_ITERS, AR_LR = 1024, ENC_LEN, PRED, 200, 5e-2
MODEL_CHECK = 4  # windows of a batch compared with the CPU run
VAE_CHECK = 16
AR_CHECK = 256  # windows of the ARIMA batch fitted on the CPU too
MR_WARMUP, MR_RUNS = 2, 5  # untimed, then timed forwards and steps
# a gradient whose exact value is 0 (a bias that a norm right after
# cancels: MyLayerNorm's, the distilling conv's and the VAE's conv2 under
# their batch norms; a projection bias on modes no block keeps) is
# rounding residue on both devices: each leaf's error is taken over the
# larger of its own largest magnitude and MR_GRAD_FLOOR of the step's
# largest gradient, so such a leaf passes where the two residues agree
# within ZERO_GRAD of the largest
MR_GRAD_FLOOR = ZERO_GRAD / TOL_TRAIN
# the 200-step Adam fit of ARIMA(1,1,1) is chaotic on a few windows (on the
# CPU 5 of 256 lie past 1e-3 of a float64 run, one 0.23 away; the rest
# ~1.4e-6): the card is held to float64 on the CPU by the median window,
# at most twice the fp32 CPU's distance, and by the windows past
# AR_DIVERGED, at most AR_EXTRA more than the fp32 CPU's
AR_DIVERGED, AR_EXTRA = 1e-3, 0.02


def _time_model(label, forward, step):
    """ms a forward (no gradient) and ms a training step, each the median
    of MR_RUNS after MR_WARMUP; peak memory over the timed steps; device
    busy, launches and idle share of one profiled step."""
    def fwd():
        with torch.no_grad():
            return forward()

    for _ in range(MR_WARMUP):
        fwd()
        step()
    torch.cuda.synchronize()
    fwd_ms = _median_ms(fwd, MR_RUNS)
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_ms(step, MR_RUNS)
    peak = torch.cuda.max_memory_allocated()
    busy = profile_device(step, f"{label}, one training step", step_ms)
    loss = float(step().detach())
    out = fwd()
    outs = out if isinstance(out, tuple) else (out,)
    if not math.isfinite(loss) or not all(bool(torch.isfinite(o).all())
                                          for o in outs):
        raise AssertionError(f"{label}: non-finite loss {loss} or output")
    return {"fwd_ms": fwd_ms, "step_ms": step_ms, "busy_ms": busy["busy_ms"],
            "launches_a_step": busy["launches"],
            "idle_share": busy["idle_share"], "peak_mib": peak / 2**20,
            "loss": loss}


def _loss_and_grads(model, run):
    """``run()`` -> (outputs dict, loss); every output, the loss and each
    parameter's gradient (zeros where the loss does not reach it), as
    float64 numpy."""
    model.zero_grad(set_to_none=True)
    outs, loss = run()
    loss.backward()
    res = {f"output:{k}": v for k, v in outs.items()}
    res["loss"] = loss
    res.update({n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in model.named_parameters()})
    return {k: v.detach().double().cpu().numpy() for k, v in res.items()}


def _card_vs_cpu(label, got, want, f64=None):
    """Outputs and loss within TOL_TRAIN of their largest magnitude; each
    gradient within TOL_TRAIN of the larger of its own largest magnitude
    and MR_GRAD_FLOOR of the largest gradient.  Where some miss it and
    ``f64`` is given (the same run in float64 on the CPU), those pass if
    the card's distances from float64, summed over them, are at most twice
    the fp32 CPU's (the port's float64 rule)."""
    grads = [k for k in want if k != "loss" and not k.startswith("output:")]
    floor = MR_GRAD_FLOOR * max(np.abs(want[k]).max() for k in grads)
    dist = {}
    for k, w in want.items():
        scale = np.abs(w).max()
        if k in grads:
            scale = max(scale, floor)
        dist[k] = float(np.abs(got[k] - w).max() / max(scale, 1e-30))
    outs = {k: v for k, v in dist.items() if k not in grads}
    worst = max(grads, key=dist.get)
    gate = {"outputs": outs, "worst_gradient": dist[worst],
            "worst_leaf": worst, "gradients": len(grads),
            "tolerance": TOL_TRAIN}
    over = sorted(k for k, v in dist.items() if v > TOL_TRAIN)
    if over and f64 is not None:
        ref = f64()
        summed = {"cuda": sum(_bl_distance(got[k], ref[k]) for k in over),
                  "cpu": sum(_bl_distance(want[k], ref[k]) for k in over)}
        gate["float64"] = dict(leaves_over_tolerance=over,
                               summed_from_float64=summed)
        if summed["cuda"] <= 2.0 * summed["cpu"]:
            over = []
    if over:
        raise AssertionError(f"{label}: cuda vs cpu {gate}")
    return gate


def _phase_log(label, card, timing, extra=""):
    log(f"{label} on {card}: forward {timing['fwd_ms']:.3f} ms, training "
        f"step {timing['step_ms']:.3f} ms (medians of {MR_RUNS}), device "
        f"busy {timing['busy_ms']:.4f} ms a step in "
        f"{timing['launches_a_step']} launches, idle share "
        f"{timing['idle_share']:.3f}, peak memory {timing['peak_mib']:.1f} "
        f"MiB{extra}")


def _no_kernel(label):
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: a hand kernel launched: {counts}")
    return counts


def fedformer_phase(version: str, card: str):
    """``FEDformer`` (``version``) at run.py's defaults, batch 32: one MSE +
    Adam step a timed step, the same forward under ``no_grad``; then one
    step's outputs, loss and gradients on the first MODEL_CHECK windows
    against the CPU (AutoCorrelation's delays recorded on the card and
    replayed), both from the seed's weights, a copy taken before the timed
    steps: after them the Wavelets model's fp32 gradients lie more than
    twice as far from float64 as the CPU's on some seeds (ROADMAP.md
    section 3).  Wavelets' step is taken twice there and must be bit-equal
    (its circular convolutions' fixed-order backward,
    ``models/embedding.py``).  No hand kernel runs."""
    import copy

    from fine_grained_gaussian_process_forcasting_torch.models.fedformer import (  # noqa: E501
        FEDformer,
        FEDformerConfig,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (  # noqa: E501
        DelayTape,
    )

    label = f"fedformer_model_{version.lower()}"
    cfg = FEDformerConfig(**FED_CFG, version=version)
    zero_counts()
    model = FEDformer(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    dec_len = cfg.label_len + cfg.pred_len
    *inputs, y = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in (
        (FED_BATCH, cfg.seq_len, cfg.enc_in),
        (FED_BATCH, cfg.seq_len, FED_MARKS),
        (FED_BATCH, dec_len, cfg.dec_in), (FED_BATCH, dec_len, FED_MARKS),
        (FED_BATCH, cfg.pred_len, cfg.c_out)))
    opt = torch.optim.Adam(model.parameters(), lr=FED_LR)
    cpu_model = copy.deepcopy(model).cpu()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(*inputs) - y) ** 2)
        loss.backward()
        opt.step()
        return loss

    timing = _time_model(label, lambda: model(*inputs), step)
    model.load_state_dict(cpu_model.state_dict())
    sub = [t[:MODEL_CHECK] for t in inputs + [y]]
    tape = DelayTape() if version == "Autoformer" else None

    def run(m, ts, delays):
        out = m(*ts[:4], delays=delays)
        return {"forecast": out}, torch.mean((out - ts[4]) ** 2)

    got = _loss_and_grads(model, lambda: run(model, sub, tape))
    if version == "Wavelets":
        again = _loss_and_grads(model, lambda: run(model, sub, tape))
        apart = [k for k in got if not np.array_equal(got[k], again[k])]
        if apart:
            raise AssertionError(f"{label}: two steps from the same weights "
                                 f"differ at {apart}")

    def on_cpu(m, dtype):
        replay = (DelayTape([d.cpu() for d in tape.delays]) if tape
                  else None)
        return _loss_and_grads(m, lambda: run(
            m, [t.cpu().to(dtype) for t in sub], replay))

    want = on_cpu(cpu_model, torch.float32)
    gate = _card_vs_cpu(label, got, want, lambda: on_cpu(
        copy.deepcopy(cpu_model).double(), torch.float64))
    extra = (f"; delays a call on the card "
             f"{[d.sort().values.tolist() for d in tape.delays]}"
             if tape else "")
    _phase_log(label, card, timing, f", weights {weights / 2**20:.1f} MiB; "
               f"one step on {MODEL_CHECK} windows vs cpu {gate}{extra}")
    return _no_kernel(label), dict(timing, weights_mib=weights / 2**20,
                                   step_vs_cpu=gate)


def informer_stack_phase(card: str):
    """``InformerEncoder(512, 2 layers, 8 heads, ProbSparse, distil)`` on
    (32, 96, 512), then ``InformerDecoderLayer(512, 8)`` on (32, 72, 512)
    against its output: the timed forward and MSE + Adam step; one step on
    MODEL_CHECK windows against the CPU, the card's key samples and chosen
    queries replayed there.  No hand kernel runs."""
    import copy

    from fine_grained_gaussian_process_forcasting_torch.models import (
        informer_stack,
    )

    label = "informer_stack"
    gen = torch.Generator().manual_seed(SEED)
    zero_counts()
    enc = informer_stack.InformerEncoder(INF_D, 2, INF_HEADS, "prob", True,
                                         device="cuda", generator=gen)
    dec = informer_stack.InformerDecoderLayer(INF_D, INF_HEADS,
                                              device="cuda", generator=gen)
    model = torch.nn.ModuleDict({"encoder": enc, "decoder": dec})
    rng = np.random.RandomState(SEED)
    x, dec_in, y = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((INF_B, INF_ENC, INF_D),
                                      (INF_B, INF_DEC, INF_D),
                                      (INF_B, INF_DEC, INF_D)))
    card_gen = torch.Generator(device="cuda").manual_seed(SEED)
    opt = torch.optim.Adam(model.parameters(), lr=FED_LR)

    def forward(m, x_, d_, g):
        enc_out = m["encoder"](x_, generator=g)
        return enc_out, m["decoder"](d_, enc_out, generator=g)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((forward(model, x, dec_in, card_gen)[1] - y) ** 2)
        loss.backward()
        opt.step()
        return loss

    timing = _time_model(label, lambda: forward(model, x, dec_in, card_gen),
                         step)
    cpu_model = copy.deepcopy(model).cpu()

    def run(m, x_, d_, y_):
        enc_out, out = forward(m, x_, d_, None)
        return ({"encoder": enc_out, "decoder": out},
                torch.mean((out - y_) ** 2))

    n = MODEL_CHECK
    with _SampleRecorder(module=informer_stack) as rec:
        got = _loss_and_grads(model, lambda: run(model, x[:n], dec_in[:n],
                                                 y[:n]))

    def on_cpu(m, dtype):
        with _SampleRecorder(replay=rec.draws, module=informer_stack) as r:
            out = _loss_and_grads(m, lambda: run(
                m, *(t[:n].cpu().to(dtype) for t in (x, dec_in, y))))
        return out, r.flips

    want, flips = on_cpu(cpu_model, torch.float32)
    gate = _card_vs_cpu(label, got, want, lambda: on_cpu(
        copy.deepcopy(cpu_model).double(), torch.float64)[0])
    gate["query_choices_flipped_on_cpu"] = flips
    _phase_log(label, card, timing, f"; encoder out "
               f"{tuple(forward(model, x, dec_in, card_gen)[0].shape)}; one "
               f"step on {n} windows vs cpu (the card's {len(rec.draws)} "
               f"key samples and chosen queries replayed) {gate}")
    return _no_kernel(label), dict(timing, step_vs_cpu=gate)


def denoise_vae_phase(card: str):
    """``DenoiseVAE(32, gp=True)`` on (256, 288, 32) with a 96-step target:
    the timed forward and MSE + KL + Adam step, its two normal draws from a
    card generator; one step on VAE_CHECK windows against the CPU, the
    card's draws replayed there (``draws.DrawTape``).  No hand kernel
    runs."""
    import copy

    from fine_grained_gaussian_process_forcasting_torch import draws
    from fine_grained_gaussian_process_forcasting_torch.models.denoise_vae import (  # noqa: E501
        DenoiseVAE,
    )

    label = "denoise_vae"
    zero_counts()
    model = DenoiseVAE(VAE_D, gp=True, device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    x, y, target = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((VAE_B, VAE_L, VAE_D),
                                      (VAE_B, VAE_L, VAE_D),
                                      (VAE_B, VAE_TARGET, 1)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def loss_of(m, x_, t_, y_, g):
        out, kl = m(x_, t_, generator=g)
        return out, kl, torch.mean((out - y_) ** 2) + kl

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, x, target, y, gen)[2]
        loss.backward()
        opt.step()
        return loss

    timing = _time_model(label, lambda: model(x, target, generator=gen),
                         step)
    cpu_model = copy.deepcopy(model).cpu()
    n = VAE_CHECK
    tape = draws.DrawTape(gen)

    def run(m, ts, g):
        out, kl, loss = loss_of(m, *ts, g)
        return {"output": out, "kl": kl}, loss

    got = _loss_and_grads(model, lambda: run(
        model, (x[:n], target[:n], y[:n]), tape))

    def on_cpu(m, dtype):
        # the input noise in the inputs' dtype, the latent's fp32, as the
        # model draws them
        eps, z = (d.cpu() for d in tape.draws)
        replay = draws.DrawTape(draws=[eps.to(dtype), z])
        return _loss_and_grads(m, lambda: run(
            m, tuple(t[:n].cpu().to(dtype) for t in (x, target, y)),
            replay))

    want = on_cpu(cpu_model, torch.float32)
    gate = _card_vs_cpu(label, got, want, lambda: on_cpu(
        copy.deepcopy(cpu_model).double(), torch.float64))
    _phase_log(label, card, timing, f"; one step on {n} windows vs cpu "
               f"(the card's {len(tape.draws)} draws replayed) {gate}")
    return _no_kernel(label), dict(timing, step_vs_cpu=gate)


def arima_batch_phase(card: str):
    """``fit_forecast_batch`` on 1024 windows of 192 steps (integrated
    ARMA(1,1) series from the seed), 96 ahead, 200 Adam steps: its seconds
    and windows/s; ms a step and a forward (the CSS residuals) as medians;
    the device busy a step under the profiler.  The first AR_CHECK windows
    are fitted on the CPU too, in fp32 and float64, and the card held to
    float64 (AR_DIVERGED, AR_EXTRA).  No hand kernel runs."""
    from fine_grained_gaussian_process_forcasting_torch.models import arima

    label = "arima_batch"
    rng = np.random.RandomState(SEED)
    n, T = AR_WINDOWS, AR_LEN
    phi, theta = (rng.uniform(-0.8, 0.8, (n,)) for _ in range(2))
    e = rng.standard_normal((n, T))
    w = np.zeros((n, T))
    for t in range(1, T):
        w[:, t] = 0.05 + phi * w[:, t - 1] + theta * e[:, t - 1] + e[:, t]
    x = (10.0 + np.cumsum(w, 1)).astype(np.float32)
    zero_counts()
    arima.fit_forecast_batch(x, AR_STEPS, iters=2, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = arima.fit_forecast_batch(x, AR_STEPS, AR_ITERS, AR_LR,
                                   device="cuda")
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (n, AR_STEPS) or not np.isfinite(out).all():
        raise AssertionError(f"{label}: forecasts {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    wd = torch.diff(torch.from_numpy(x).cuda(), dim=1)
    params = arima.fit_batch(wd, AR_ITERS, AR_LR)
    steps10 = 10
    step_ms = _median_ms(lambda: arima.fit_batch(wd, steps10, AR_LR),
                         MR_RUNS) / steps10
    fwd_ms = _median_ms(lambda: arima.css_residuals_batch(params, wd),
                        MR_RUNS)
    busy = profile_device(lambda: arima.fit_batch(wd, steps10, AR_LR),
                          f"{label}, {steps10} Adam steps",
                          step_ms * steps10)
    busy_step, launches_step = busy["busy_ms"] / steps10, (
        busy["launches"] / steps10)

    k = AR_CHECK
    cpu32 = arima.fit_forecast_batch(x[:k], AR_STEPS, AR_ITERS, AR_LR,
                                     device="cpu")
    xt = torch.from_numpy(x[:k].astype(np.float64))
    w64 = torch.diff(xt, dim=1)
    cpu64 = arima.forecast_batch(arima.fit_batch(w64, AR_ITERS, AR_LR), w64,
                                 xt[:, -1], AR_STEPS).numpy()

    def per_window(a, ref):
        return np.abs(a - ref).max(1) / np.abs(ref).max(1)

    card64, cpu32_64 = per_window(out[:k], cpu64), per_window(cpu32, cpu64)
    card32 = per_window(out[:k], cpu32)
    gate = {"median_vs_float64_cuda": float(np.median(card64)),
            "median_vs_float64_cpu": float(np.median(cpu32_64)),
            "past_diverged_cuda": int((card64 > AR_DIVERGED).sum()),
            "past_diverged_cpu": int((cpu32_64 > AR_DIVERGED).sum()),
            "windows": k, "median_vs_cpu_fp32": float(np.median(card32)),
            "worst_vs_cpu_fp32": float(card32.max()),
            "within_1e-3_of_cpu_fp32": int((card32 <= TOL_TRAIN).sum())}
    ok = (gate["median_vs_float64_cuda"]
          <= 2.0 * gate["median_vs_float64_cpu"]
          and gate["past_diverged_cuda"]
          <= gate["past_diverged_cpu"] + AR_EXTRA * k)
    if not ok:
        raise AssertionError(f"{label}: cuda vs float64 {gate}")
    log(f"{label} on {card}: {n} windows x {T} steps, {AR_ITERS} Adam "
        f"steps, {AR_STEPS} ahead in {fit_s:.3f} s ({n / fit_s:.1f} "
        f"windows/s); a step {step_ms:.3f} ms, the residuals (forward) "
        f"{fwd_ms:.3f} ms (medians of {MR_RUNS}); device busy "
        f"{busy_step:.4f} ms a step in {launches_step:.0f} launches, idle "
        f"share {busy['idle_share']:.3f}; peak memory {peak / 2**20:.1f} "
        f"MiB; the first {k} windows vs the cpu {gate}")
    return _no_kernel(label), {
        "fit_s": fit_s, "windows_per_s": n / fit_s, "step_ms": step_ms,
        "fwd_ms": fwd_ms, "busy_ms": busy_step,
        "launches_a_step": launches_step, "idle_share": busy["idle_share"],
        "peak_mib": peak / 2**20, "vs_cpu": gate}


MODEL_PHASES = tuple(f"fedformer_model_{v.lower()}" for v in FED_VERSIONS) + (
    "informer_stack", "arima_batch", "denoise_vae")


def models_rest_phases(card: str, record, cpu_checks):
    """The phases of the rest of ``models/``, after ``baselines``."""
    for version in FED_VERSIONS:
        path = f"fedformer_model_{version.lower()}"
        counts, cpu_checks[path] = fedformer_phase(version, card)
        record(path, counts)
    for path, phase in (("informer_stack", informer_stack_phase),
                        ("arima_batch", arima_batch_phase),
                        ("denoise_vae", denoise_vae_phase)):
        counts, cpu_checks[path] = phase(card)
        record(path, counts)


# data, tensor and FSDP parallelism (parallel/): four ranks on the one card,
# a 2 x 2 (data, model) mesh over gloo, each rank's tensors on cuda:0
PAR_MESH, PAR_STEPS = (2, 2), 3
PAR_CONFIGS = ("autoformer", "basic")
PAR_TIMEOUT_S = 240
PAR_CLI_ARGV = ["--exp_name", "solar", "--attn_type", "basic", "--model_name",
                "mesh_nccl", "--synthetic", "--d_model_choices", str(D_MODEL),
                "--stack_choices", str(LAYERS), "--n_trials", "1",
                "--n_seeds", "1", "--num_epochs", "1", "--max_train_samples",
                str(2 * B), "--max_valid_samples", str(B), "--dp", "1"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))


def _digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _CollectiveClock:
    """Host seconds inside torch.distributed's collectives (gloo: the
    staged CPU buffers), while the context is open."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter_tensor",
             "broadcast_object_list")

    def __enter__(self):
        import torch.distributed as dist

        self.seconds, self._plain = 0.0, {}
        for name in self.NAMES:
            fn = getattr(dist, name)
            self._plain[name] = fn

            def timed(*a, _fn=fn, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds += time.perf_counter() - t0

            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._plain.items():
            setattr(dist, name, fn)


def _rank_profile(fn):
    """Device busy ms of ``fn()`` in this process, and the ms of its
    host <-> device copies (the staged collectives' device share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.self_device_time_total for e in events
                 if "Memcpy" in e.key) / 1e3
    return busy, copies


def _parallel_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the parallel phase: every configuration with and
    without FSDP; step 1's loss and gathered gradients and autoformer's
    delays against the one-process card step, PAR_STEPS steps with every
    rank's weights compared after each, the launches of this rank, a
    profiled step; results to ``workdir/rank{r}.pt``.  Any failure raises,
    and the parent sees this rank's nonzero exit."""
    _rank_env(rank, world, port)
    import torch.distributed as dist

    from fine_grained_gaussian_process_forcasting_torch.data.window import (
        BatchedSplit,
    )
    from fine_grained_gaussian_process_forcasting_torch.models import (
        transformer,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (  # noqa: E501
        DelayTape,
    )
    from fine_grained_gaussian_process_forcasting_torch.parallel import (
        make_mesh,
    )
    from fine_grained_gaussian_process_forcasting_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*PAR_MESH, device="cuda")
    if dist.get_backend() != "gloo" or torch.cuda.current_device() != 0:
        raise AssertionError(f"rank {rank}: backend {dist.get_backend()}, "
                             f"device {torch.cuda.current_device()}")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    by_name = {cfg.name: cfg for cfg in CONFIGS}
    out = {}
    for cfg_name in PAR_CONFIGS:
        cfg, ref = by_name[cfg_name], inputs[cfg_name]
        for fsdp in (False, True):
            label = f"parallel {cfg_name}{' fsdp' if fsdp else ''}"
            trainer = Trainer(cfg.model("cuda"), cfg.d_model,
                              warmup_steps=WARMUP_STEPS, lr_mul=LR_MUL,
                              device="cuda", mesh=mesh, fsdp=fsdp)
            state = trainer.init_state()  # the weights of seed 0
            data = trainer.device_put_split(BatchedSplit(*ref["data"]))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            tape, plain = DelayTape(), transformer.auto_correlation
            transformer.auto_correlation = tape
            try:
                loss, grads = trainer.gradients(state, tuple(
                    t[0] for t in data))
            finally:
                transformer.auto_correlation = plain
            dist_ = {k: _bl_distance(g.double().cpu().numpy(),
                                     ref["grads"][k]) for k, g in
                     grads.items()}
            worst = max(dist_, key=dist_.get)
            loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
            delays = [d.tolist() for d in tape.delays]
            if (dist_[worst] > TOL_TRAIN or loss_rel > TOL_TRAIN
                    or delays != ref["delays"]):
                raise AssertionError(
                    f"{label}, rank {rank}: step 1 vs one process: loss "
                    f"{float(loss)} vs {ref['loss']}, worst gradient "
                    f"{worst} {dist_[worst]:.3e}; delays {delays} vs "
                    f"{ref['delays']}")
            step_ms, digests, collective_s = [], [], 0.0
            for i in range(PAR_STEPS):
                with _CollectiveClock() as clock:
                    t0 = time.perf_counter()
                    state, loss_sum, _ = trainer.train_epoch(
                        state, tuple(t[i: i + 1] for t in data))
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                collective_s += clock.seconds
                digests.append(_digest(trainer.full_params(state)))
            every = [None] * world
            dist.all_gather_object(every, digests)
            if any(d != every[0] for d in every):
                raise AssertionError(f"{label}: the ranks' weights differ "
                                     f"after a step: {every}")
            counts = read_counts()
            need = ["fused_gp", "fused_gp_bwd"] + (
                ["head_folded_attention", "head_folded_attention_bwd"]
                if cfg_name == "basic" else [])
            if not all(counts[k] > 0 for k in need) or not math.isfinite(
                    loss_sum):
                raise AssertionError(f"{label}, rank {rank}: launches "
                                     f"{counts}, loss {loss_sum}")
            busy, copies = _rank_profile(lambda: trainer.train_epoch(
                state, tuple(t[PAR_STEPS: PAR_STEPS + 1] for t in data)))
            median = float(np.median(step_ms))
            out[label] = dict(
                loss=float(loss), worst_gradient=dist_[worst],
                worst_leaf=worst, delays=delays, step_ms=median,
                busy_ms=busy, idle_share=1.0 - busy / median,
                copies_share_of_busy=copies / busy,
                collectives_host_share=collective_s * 1e3 / sum(step_ms),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                launches=counts, stored=sum(
                    t.numel() for t in trainer._opt_params()))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _nccl_cli_rank(workdir: str, port: int) -> None:
    """``cli.main`` with ``--dp 1``: a mesh of one rank over NCCL."""
    _rank_env(0, 1, port)
    import torch.distributed as dist

    from fine_grained_gaussian_process_forcasting_torch.train import cli

    results = cli.main(PAR_CLI_ARGV + ["--out_dir", workdir])
    backend = dist.get_backend()
    counts = read_counts()
    dist.destroy_process_group()
    if backend != "nccl" or not results or not math.isfinite(
            results[0]["mse"]) or not counts["fused_gp"]:
        raise AssertionError(f"cli --dp 1: backend {backend}, results "
                             f"{results}, launches {counts}")
    torch.save({"mse": results[0]["mse"], "launches": counts},
               os.path.join(workdir, "nccl.pt"))


def _spawn(target, args_of, n: int) -> None:
    """``n`` processes of ``target(*args_of(rank))``; raises unless all
    exit 0 in PAR_TIMEOUT_S, and stops every one it started."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        deadline = time.perf_counter() + PAR_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise AssertionError(f"{target.__name__}: exit codes {codes}")


def parallel_phase(card: str, record, cpu_checks) -> None:
    """``parallel``: the flagship and ``basic`` at the flagship's widths
    trained on a 2 x 2 (data, model) mesh of four ranks sharing the card
    over gloo (NCCL refuses two ranks on one device; gloo's collectives
    staged through host memory), with and without FSDP, each for
    PAR_STEPS steps: step 1's loss and every gradient, gathered, within
    TOL_TRAIN of a one-process card step from the same weights (autoformer
    with the same delays), every rank's weights equal after each step, the
    fused GP (and in ``basic`` the head-folded kernels) launched in every
    rank.  Then ``cli.main`` with ``--dp 1`` over NCCL.  The kernels are
    built before any rank starts.  Four ranks on one card show that the
    collectives are right, not how a step scales across cards."""
    import shutil

    from fine_grained_gaussian_process_forcasting_torch.models import (
        transformer,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (  # noqa: E501
        DelayTape,
    )
    from fine_grained_gaussian_process_forcasting_torch.train import Trainer

    t0 = time.perf_counter()
    world = PAR_MESH[0] * PAR_MESH[1]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        by_name = {cfg.name: cfg for cfg in CONFIGS}
        inputs = {}
        for cfg_name in PAR_CONFIGS:  # the one-process card step
            cfg = by_name[cfg_name]
            data = cfg.training_data(PAR_STEPS + 1, SEED + 3)
            trainer = Trainer(cfg.model("cuda"), cfg.d_model,
                              warmup_steps=WARMUP_STEPS, lr_mul=LR_MUL,
                              device="cuda")
            state = trainer.init_state()
            tape, plain = DelayTape(), transformer.auto_correlation
            transformer.auto_correlation = tape
            try:
                loss, grads = trainer.gradients(state, tuple(
                    t[0] for t in data))
            finally:
                transformer.auto_correlation = plain
            inputs[cfg_name] = {
                "data": tuple(t.cpu().numpy() for t in data),
                "loss": float(loss),
                "grads": {k: g.double().cpu().numpy()
                          for k, g in grads.items()},
                "delays": [d.tolist() for d in tape.delays]}
            del trainer, state, grads
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        port = _free_port()
        _spawn(_parallel_rank, lambda r: (r, world, port, workdir), world)
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        for label in ranks[0]:
            runs = [r[label] for r in ranks]
            counts = {k: sum(r["launches"][k] for r in runs)
                      for k in runs[0]["launches"]}
            path = label.replace(" ", "_")
            record(path, counts)
            summary = dict(
                ranks=world, mesh=list(PAR_MESH), card=card,
                worst_gradient=max(r["worst_gradient"] for r in runs),
                delays=runs[0]["delays"],
                step_ms=[r["step_ms"] for r in runs],
                busy_ms=[r["busy_ms"] for r in runs],
                idle_share=[r["idle_share"] for r in runs],
                copies_share_of_busy=[r["copies_share_of_busy"]
                                      for r in runs],
                collectives_host_share=[r["collectives_host_share"]
                                        for r in runs],
                peak_mib=[r["peak_mib"] for r in runs],
                stored_elements=[r["stored"] for r in runs],
                launches_by_rank=[r["launches"] for r in runs])
            cpu_checks[path] = summary
            log(f"{label} on {card}: 2 x 2 mesh, 4 ranks on cuda:0 over "
                f"gloo; step 1 vs one process: worst gradient "
                f"{summary['worst_gradient']:.3e} (tolerance {TOL_TRAIN}), "
                f"delays {summary['delays']}; ms a step by rank "
                f"{['%.3f' % v for v in summary['step_ms']]}, device busy "
                f"{['%.4f' % v for v in summary['busy_ms']]} ms, idle share "
                f"{['%.3f' % v for v in summary['idle_share']]}, staging "
                f"copies' share of busy "
                f"{['%.3f' % v for v in summary['copies_share_of_busy']]}, "
                f"collectives' share of the host step "
                f"{['%.3f' % v for v in summary['collectives_host_share']]}"
                f", peak memory {['%.1f' % v for v in summary['peak_mib']]} "
                f"MiB; parameters and shards stored "
                f"{summary['stored_elements']}; launches by rank "
                f"{[{k: v for k, v in c.items() if v} for c in summary['launches_by_rank']]}")
        cli_dir = os.path.join(workdir, "cli")
        _spawn(_nccl_cli_rank, lambda r: (cli_dir, _free_port()), 1)
        nccl = torch.load(os.path.join(cli_dir, "nccl.pt"),
                          weights_only=False)
        record("parallel_cli_nccl", nccl["launches"])
        cpu_checks["parallel_cli_nccl"] = {"mse": nccl["mse"]}
        log(f"parallel cli --dp 1 on {card}: NCCL, world size 1, test MSE "
            f"{nccl['mse']:.6f}; phase {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


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
    # the seed axis (multi-seed training): the fused GP's at both widths,
    # the attention kernels' folds
    (kernels["fused_gp_seeds"],
     kernels["fused_gp_seeds_bwd"]) = check_fused_gp_seeds(gen, flagship)
    (kernels["fused_gp_bf16_seeds"],
     kernels["fused_gp_bf16_seeds_bwd"]) = check_fused_gp_seeds(
        gen, production, bf16=True)
    kernels["rbf"] = check_rbf(gen)
    kernels["rbf_seeds"] = check_rbf_seeds(gen)
    kernels["cholesky"] = check_cholesky(gen)
    (kernels["small_head_attention"],
     kernels["small_head_attention_bwd"]) = check_small_head(gen)
    for key, fold in check_attention_folds(gen).items():
        kernels[key]["seed_fold"] = fold
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
    by_name = {cfg.name: cfg for cfg in CONFIGS}
    for cfg_name in ("autoformer", "basic"):
        path = f"serve_int8_{cfg_name}"
        counts, cpu_checks[path] = serve_int8(by_name[cfg_name], smi)
        record(path, counts)
    with tempfile.TemporaryDirectory() as tmpdir:
        for cfg_name, quantize, fresh in EXPORTS:
            cfg = by_name[cfg_name]
            label = "exact_blur_pallas" if cfg_name == "exact" else cfg_name
            path = f"export_{label}{'_int8' if quantize else ''}"
            counts, cpu_checks[path] = export_served(cfg, smi, quantize,
                                                     tmpdir, fresh)
            record(path, counts)
    counts, cpu_checks["predict_dataframe"] = predict_dataframe_phase(smi)
    record("predict_dataframe", counts)
    for cfg in CONFIGS:
        counts, cpu_checks[f"train_{cfg.name}"], model = train(cfg, smi)
        record(f"train_{cfg.name}", counts)
        if cfg.name == "exact":
            counts, cpu_checks["exact_blur_pallas"] = exact_blur_pallas(
                model, smi)
            record("exact_blur_pallas", counts)
        del model
        if cfg.name == "autoformer":  # the same flagship at N_SEEDS seeds
            path = f"train_multiseed_{cfg.name}"
            counts, cpu_checks[path] = train_multiseed(
                cfg, smi, cpu_checks[f"train_{cfg.name}"])
            record(path, counts)
    multiseed_options(smi, record, cpu_checks)
    for use_pallas in (False, True):
        path = f"cli_ata_{'pallas' if use_pallas else 'auto'}"
        counts, cpu_checks[path] = cli_ata(smi, use_pallas)
        record(path, counts)
    counts, cpu_checks["cli_multiseed"] = cli_multiseed(smi)
    record("cli_multiseed", counts)
    counts, cpu_checks["baselines"] = baselines_phase(smi)
    record("baselines", counts)
    models_rest_phases(smi, record, cpu_checks)
    parallel_phase(smi, record, cpu_checks)

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
