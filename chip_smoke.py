#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: the card's name, count and power limit; builds the CUDA kernels
   from ``fine_grained_gaussian_process_forcasting_torch/csrc``.
2. Kernels: each kernel, forward and backward, against its plain-PyTorch
   version at the flagship AutoDG shapes (max-abs error against a stated
   tolerance), timed with CUDA events beside its plain version, its bound
   and, where one exists, the one PyTorch call that computes the same
   function.
3. Serving: the flagship AutoDG model (autoformer + GP + denoise, d_model 32,
   8 heads, 1 layer, 512 inducing points, enc 192, dec/pred 96) and its
   ``basic``-attention twin, weights from a fixed seed, serve 600 request
   windows through ``InferenceSession.predict`` (two batches of 256 and a
   ragged 88).  Checks shapes, finiteness, the kernels' launch counts, and the
   first 16 windows against the port's own CPU run.
4. Training: both configurations train from the weights of seed 0 through
   ``Trainer.train_epoch`` (Noam-Adam, warmup 4000) on batches of 256
   windows drawn from the seed: 3 warm-up steps, then 3 epochs of 20 steps,
   each timed, whose launches are counted, then one profiled step.  Checks
   finite losses, the launches per step (fused GP forward and backward once;
   head-folded attention forward and backward six times in ``basic``), and
   one step's loss and gradients on 16 windows against the port's CPU run.

The CPU runs of parts 3 and 4 take the AutoCorrelation delays that the card
chose, so that a near-tie broken the other way on one device cannot make
the two compute different functions; how many differed is printed.

Prints the ``kernels`` JSON line (each kernel's launches summed over the
serving and training runs, and by run), then the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero on any
failure, without a result line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

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

# published H100 SXM peaks (dense): fp32 outside the tensor cores, HBM3;
# exponentials on the special-function units: 16 per SM per clock x 132 SMs
# x 1.98 GHz boost clock
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9

TOL_FUSED_GP = 1e-4
TOL_ATTENTION = 1e-5
TOL_SERVING = 1e-3
# backward kernels against their plain backward.  Fused GP: every output
# within 1e-3 of max(1, its largest magnitude): the row sums run over
# 73,728 rows in another order, and W at these inputs reaches ~100 in
# magnitude (an ill-conditioned 512-point Gram matrix), which the plain
# fp32 version itself feels (both are printed against float64).
# Attention: the JAX package's kernel-gradient atol (1e-5).
TOL_FUSED_GP_BWD = 1e-3
TOL_ATTENTION_BWD = 1e-5
# one training step on the card against the CPU: the loss, and each
# parameter's gradient relative to its largest magnitude
TOL_TRAIN = 1e-3

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


def bound(flops: float, exps: float, nbytes: float):
    """(ms, what bounds it): the larger of the operations at peak and the
    bytes (each input read once, each output written once) at peak."""
    ops_ms = max(flops / PEAK_FP32, exps / PEAK_EXP) * 1e3
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


def _gp_inputs(gen):
    """Inputs of the fused GP at the flagship shapes."""
    dev = "cuda"
    b, n, d, m = B, ENC_LEN + DEC_LEN, D_MODEL, INDUCING
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


def check_fused_gp(gen):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = B, ENC_LEN + DEC_LEN, D_MODEL, INDUCING
    args = _gp_inputs(gen)
    w = args[3]
    with torch.inference_mode():
        got = fused_gp.whitened_marginals_affine(*args)
        torch.cuda.synchronize()
        want = fused_gp.whitened_marginals_affine_plain(*args)
        exact = fused_gp.whitened_marginals_affine_plain(
            *(a.double() for a in args))
    err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
    err64 = [max((t.double() - e).abs().max().item()
                 for t, e in zip(ts, exact)) for ts in (got, want)]
    log(f"fused_gp: max|kernel - plain| {err:.3e} (tol {TOL_FUSED_GP}); "
        f"vs float64: kernel {err64[0]:.3e}, plain {err64[1]:.3e}; "
        f"max|W| {w.abs().max().item():.3e}")
    if not err <= TOL_FUSED_GP:
        raise AssertionError(f"fused_gp disagrees with its plain version: "
                             f"{err} > {TOL_FUSED_GP}")

    mean = torch.empty(b, n, device=dev)
    var = torch.empty(b, n, device=dev)
    launch = fused_gp.launcher()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args] + [mean.data_ptr(), var.data_ptr()]

    def run_kernel():
        if launch(*ptrs, b * n, d, m, stream):
            raise RuntimeError("fused_gp launch failed")

    with torch.inference_mode():
        ms = time_ms(run_kernel, 20)
        plain_ms = time_ms(
            lambda: fused_gp.whitened_marginals_affine_plain(*args), 10)
    r = b * n
    flops = r * (2.0 * m * m + 3.0 * m * d + 4.0 * m + 2.0 * d)
    nbytes = 4.0 * (r * d + m * d + m + m * m + 2 * d + 2 + 2 * r)
    bound_ms, bound_by = bound(flops, r * m, nbytes)
    log(f"fused_gp: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}) at rows {r}, d {d}, M {m}")
    return {"name": "fused_gp.whitened_marginals_affine (fwd, fp32)",
            "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "fused_gp.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/fused_gp.py:222",
            "max_abs_err": err, "tolerance": TOL_FUSED_GP, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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


def check_fused_gp_bwd(gen):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

    dev = "cuda"
    b, n, d, m = B, ENC_LEN + DEC_LEN, D_MODEL, INDUCING
    args = _gp_inputs(gen)
    cot = (torch.randn(b, n, device=dev, generator=gen),
           torch.randn(b, n, device=dev, generator=gen))
    with torch.inference_mode():
        got = fused_gp.backward_kernel(*args, *cot)
        torch.cuda.synchronize()
        want = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot)
        exact = fused_gp.whitened_marginals_affine_bwd_plain(
            *(a.double() for a in args + cot))
    names = ("dx", "dzs", "du", "dW", "dos", "dinv_ls", "dmean_w",
             "dmean_b")
    worst = worst_abs = 0.0
    for name, g, w_, e in zip(names, got, want, exact):
        scale = w_.abs().max().item()
        err = (g - w_).abs().max().item()
        tol = TOL_FUSED_GP_BWD * max(scale, 1.0)
        log(f"fused_gp bwd {name}: max|kernel - plain| {err:.3e} (tol "
            f"{tol:.3e} = {TOL_FUSED_GP_BWD} x max(1, max|plain| "
            f"{scale:.3e})); vs float64: kernel "
            f"{(g.double() - e).abs().max().item():.3e}, plain "
            f"{(w_.double() - e).abs().max().item():.3e}")
        if not err <= tol:
            raise AssertionError(f"fused_gp bwd {name} disagrees with its "
                                 f"plain version: {err} > {tol}")
        worst = max(worst, err / max(scale, 1.0))
        worst_abs = max(worst_abs, err)
    again = fused_gp.backward_kernel(*args, *cot)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("fused_gp bwd differs between two runs")

    launch = fused_gp.bwd_launcher()
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty_like(t) for t in got]
    scratch = torch.empty(fused_gp.bwd_scratch_floats(b * n, d, m),
                          device=dev)
    ptrs = ([a.data_ptr() for a in args[:7]] + [c.data_ptr() for c in cot]
            + [o.data_ptr() for o in outs] + [scratch.data_ptr()])

    def run_kernel():
        if launch(*ptrs, b * n, d, m, stream):
            raise RuntimeError("fused_gp_bwd launch failed")

    with torch.inference_mode():
        ms = time_ms(run_kernel, 10)
        plain_ms = time_ms(
            lambda: fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot),
            5)
    r = b * n
    # the VJP's own work: K again (3d + 2 per element), K W (2 M^2 per
    # row), dW = -K^T diag(dvar) K (symmetric: M (M + 1) per row), E zs and
    # E^T xs (2 M d each), E and the row and column sums (~8 per element)
    flops = r * (2.0 * m * m + m * (m + 1.0) + 4.0 * m * d
                 + (3.0 * d + 10.0) * m)
    nbytes = 4.0 * (2 * r * d + 2 * r + 2 * m * d + 2 * m + 2 * m * m
                    + 3 * d + 4)
    bound_ms, bound_by = bound(flops, r * m, nbytes)
    log(f"fused_gp bwd: kernel {ms:.4f} ms (4 launches), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{flops / 1e9:.1f} GFLOP) at rows {r}, d {d}, M {m}; library: none")
    return {"name": "fused_gp.whitened_marginals_affine (bwd, fp32)",
            "route": "cuda",
            "source": "fine_grained_gaussian_process_forcasting_torch/csrc/"
                      "fused_gp.cu",
            "replaces": "fine_grained_gaussian_process_forcasting_tpu/ops/"
                        "pallas/fused_gp.py:290",
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "tolerance": TOL_FUSED_GP_BWD,
            "tolerance_is": "relative to max(1, max|plain|) per output",
            "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_head_folded_bwd(gen):
    from torch.nn.functional import scaled_dot_product_attention

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
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd_bwd():
            scaled_dot_product_attention(*leaves).backward(do)

        with torch.inference_mode():
            sdpa_fwd = time_ms(
                lambda: scaled_dot_product_attention(q, k, v), 20)
        library_ms = time_ms(sdpa_fwd_bwd, 20) - sdpa_fwd
        pairs = B * HEADS * lq * lk
        # the VJP's work per (query, key) pair: scores and P (2d + 1 exp),
        # dV, dP, dQ, dK (2d each), dS (3)
        flops, exps = (10.0 * d + 3.0) * pairs, float(pairs)
        nbytes = 4.0 * B * HEADS * d * (3 * lq + 4 * lk)
        bound_ms, bound_by = bound(flops, exps, nbytes)
        log(f"head_folded_attention bwd {call} (b {B}, h {HEADS}, Lq {lq}, "
            f"Lk {lk}, d {d}): max|kernel - plain| {err:.3e} (tol "
            f"{TOL_ATTENTION_BWD}); kernel {ms:.4f} ms (2 launches), plain "
            f"{plain_ms:.4f} ms, sdpa bwd (fwd+bwd minus fwd) "
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
            "library": "scaled_dot_product_attention fwd+bwd minus its fwd",
            "calls": rows}


def _flagship(attn_type: str, device: str):
    from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
        ForecastDenoising,
    )

    return ForecastDenoising(
        src_input_size=F, tgt_input_size=F, d_model=D_MODEL, n_heads=HEADS,
        d_k=D_MODEL // HEADS, stack_size=LAYERS, pred_len=PRED,
        attn_type=attn_type, gp=True, denoise=True, num_inducing=INDUCING,
        device=device, generator=torch.Generator().manual_seed(SEED))


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
        fused_gp,
        head_folded_attention,
    )

    return {"fused_gp": (fused_gp, "launches"),
            "fused_gp_bwd": (fused_gp, "bwd_launches"),
            "head_folded_attention": (head_folded_attention, "launches"),
            "head_folded_attention_bwd": (head_folded_attention,
                                          "bwd_launches")}


def zero_counts():
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def read_counts():
    return {name: getattr(module, attr)
            for name, (module, attr) in _counters().items()}


def serve(attn_type: str, enc, dec, expect, card: str):
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    model = _flagship(attn_type, "cuda")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=B, device="cuda")
    session.predict(enc[:B], dec[:B])  # warm-up: cuBLAS/cuFFT plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    out = session.predict(enc, dec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    if out.shape != (N_WINDOWS, PRED, 1):
        raise AssertionError(f"{attn_type}: output shape {out.shape}")
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{attn_type}: non-finite predictions")
    if counts != expect:
        raise AssertionError(f"{attn_type}: launches {counts}, expected "
                             f"{expect}")

    batch_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        session.predict(enc[:B], dec[:B])
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"serving {attn_type} on {card}: {N_WINDOWS} windows in "
        f"{wall * 1e3:.2f} ms ({N_WINDOWS / wall:.1f} windows/s); per batch "
        f"of {B}: median {float(np.median(batch_ms)):.3f} ms "
        f"(runs {', '.join(f'{t:.3f}' for t in batch_ms)}); peak memory "
        f"{peak / 2**20:.1f} MiB; launches {counts}")
    profile_device(lambda: session.predict(enc[:B], dec[:B]),
                   f"serving {attn_type}, one batch of {B}",
                   float(np.median(batch_ms)))

    # the first windows against the port's own CPU run, same weights and
    # the card's delays
    cpu = InferenceSession(_flagship(attn_type, "cpu"), state,
                           batch_size=N_CHECK, device="cpu")
    with _DelayRecorder() as rec_gpu:
        gpu_first = session.predict(enc[:N_CHECK], dec[:N_CHECK])
    with _DelayRecorder(replay=rec_gpu.delays) as rec_cpu:
        cpu_first = cpu.predict(enc[:N_CHECK], dec[:N_CHECK])
    flipped = torch.zeros(N_CHECK, dtype=torch.bool)
    for differs in _differing(rec_cpu.delays, rec_gpu.delays):
        flipped |= differs
    max_diff = float(np.abs(gpu_first - cpu_first).max())
    log(f"{attn_type}: max|cuda - cpu| over {N_CHECK} windows "
        f"{max_diff:.3e} (tol {TOL_SERVING}); windows whose own delays "
        f"differ on the cpu (replayed the card's): "
        f"{torch.nonzero(flipped).flatten().tolist()}")
    if not max_diff <= TOL_SERVING:
        raise AssertionError(f"{attn_type}: cuda and cpu disagree: "
                             f"{max_diff} > {TOL_SERVING}")
    return counts, {"windows_compared": N_CHECK, "max_abs_diff": max_diff,
                    "delays_replayed_windows": int(flipped.sum())}


def check_step_against_cpu(attn_type: str, params, batch):
    """Loss and every parameter gradient of one training step on the card
    against the same step of the port's CPU run: same weights, the first
    ``N_CHECK`` windows."""
    results, replay = [], None
    for device in ("cuda", "cpu"):  # the cpu takes the card's delays
        model = _flagship(attn_type, device)
        model.load_state_dict(params)
        enc, dec, y = (t[:N_CHECK].to(device) for t in batch)
        with _DelayRecorder(replay=replay) as rec:
            out = model(enc, dec, y, training=True)
        out.loss.backward()
        results.append((out.loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
        if replay is None:
            replay = rec.delays
    (loss_g, grads_g), (loss_c, grads_c) = results
    flipped = [i for i, differs in
               enumerate(_differing(rec.delays, replay)) if differs]
    if replay:
        log(f"train {attn_type}: shared top-k delays per call on the card "
            f"{[d.sort().values.tolist() for d in replay]}; calls whose own "
            f"delays differ on the cpu (replayed the card's): {flipped}")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    worst_name, worst = "", 0.0
    for name, gc in grads_c.items():
        scale = gc.abs().max().item()
        err = (grads_g[name] - gc).abs().max().item()
        rel = err / scale if scale > 0 else err
        if rel > worst:
            worst_name, worst = name, rel
    log(f"train {attn_type}: one step on {N_CHECK} windows, cuda vs cpu: "
        f"loss {loss_g:.7f} vs {loss_c:.7f} (rel diff {loss_err:.3e}); "
        f"worst gradient {worst_name}: max|cuda - cpu| / max|cpu| "
        f"{worst:.3e} over {len(grads_c)} parameters (tol {TOL_TRAIN})")
    if not (loss_err <= TOL_TRAIN and worst <= TOL_TRAIN):
        raise AssertionError(f"train {attn_type}: cuda and cpu disagree: "
                             f"loss {loss_err}, {worst_name} {worst}")
    return {"windows_compared": N_CHECK, "max_rel_diff": max(loss_err, worst),
            "delays_replayed_calls": len(flipped)}


def train(attn_type: str, data, per_step, card: str):
    from fine_grained_gaussian_process_forcasting_torch.train import Trainer

    model = _flagship(attn_type, "cuda")
    trainer = Trainer(model, D_MODEL, warmup_steps=WARMUP_STEPS,
                      lr_mul=LR_MUL, device="cuda")
    state = trainer.init_state()  # the weights of seed 0

    def batches(i, n):
        return tuple(t[i: i + n] for t in data)

    state, _, _ = trainer.train_epoch(state, batches(0, N_WARMUP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    epoch_ms, loss_sums = [], []
    for e in range(N_EPOCHS):
        t0 = time.perf_counter()
        state, loss_sum, _ = trainer.train_epoch(
            state, batches(N_WARMUP + e * N_TRAIN_STEPS, N_TRAIN_STEPS))
        epoch_ms.append((time.perf_counter() - t0) * 1e3)  # float() synced
        loss_sums.append(loss_sum)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = {k: N_EPOCHS * N_TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != expect:
        raise AssertionError(f"train {attn_type}: launches {counts}, "
                             f"expected {expect}")
    # a non-finite loss in a step makes its epoch's sum non-finite
    if not all(math.isfinite(v) for v in loss_sums):
        raise AssertionError(f"train {attn_type}: non-finite loss sums "
                             f"{loss_sums}")
    step_ms = [t / N_TRAIN_STEPS for t in epoch_ms]
    median = float(np.median(step_ms))
    log(f"train {attn_type} on {card}: {N_EPOCHS} epochs of {N_TRAIN_STEPS} "
        f"steps of {B} windows: {', '.join(f'{t:.2f}' for t in epoch_ms)} "
        f"ms; per step: median {median:.3f} ms ({1e3 / median:.2f} "
        f"steps/s); mean loss per epoch "
        f"{', '.join(f'{v / N_TRAIN_STEPS:.6f}' for v in loss_sums)}; "
        f"launches {counts}; peak memory {peak / 2**20:.1f} MiB")
    first = N_WARMUP + N_EPOCHS * N_TRAIN_STEPS
    after = {}

    def one_step():
        after["state"], _, _ = trainer.train_epoch(state, batches(first, 1))

    prof = profile_device(one_step, f"train {attn_type}, one step of {B} "
                          f"windows", median)
    cpu_check = check_step_against_cpu(attn_type, after["state"].params,
                                       tuple(t[first + 1] for t in data))
    return counts, cpu_check


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = {"fused_gp": check_fused_gp(gen),
               "fused_gp_bwd": check_fused_gp_bwd(gen),
               "head_folded_attention": check_head_folded(gen),
               "head_folded_attention_bwd": check_head_folded_bwd(gen)}

    rng = np.random.default_rng(SEED)
    enc = rng.normal(size=(N_WINDOWS, ENC_LEN, F)).astype(np.float32)
    dec = rng.normal(size=(N_WINDOWS, DEC_LEN, F)).astype(np.float32)
    n_batches = -(-N_WINDOWS // B)
    by_path, cpu_checks = {k: {} for k in kernels}, {}
    gp_only = {"fused_gp": 1, "fused_gp_bwd": 0, "head_folded_attention": 0,
               "head_folded_attention_bwd": 0}
    with_attention = dict(gp_only, head_folded_attention=6)
    for attn_type, per_batch in (("autoformer", gp_only),
                                 ("basic", with_attention)):
        expect = {k: n_batches * v for k, v in per_batch.items()}
        counts, cpu_checks[f"serve_{attn_type}"] = serve(
            attn_type, enc, dec, expect, smi)
        for k, v in counts.items():
            by_path[k][f"serve_{attn_type}"] = v

    # training batches, drawn on the host from the seed as windows would be
    n = N_WARMUP + N_EPOCHS * N_TRAIN_STEPS + 2
    rng = np.random.default_rng(SEED + 1)
    t_enc = rng.normal(size=(n, B, ENC_LEN, F)).astype(np.float32)
    t_dec = rng.normal(size=(n, B, DEC_LEN, F)).astype(np.float32)
    t_y = (0.5 * t_dec[..., -PRED:, :1]
           + 0.1 * rng.normal(size=(n, B, PRED, 1))).astype(np.float32)
    data = tuple(torch.from_numpy(a).to("cuda") for a in (t_enc, t_dec, t_y))
    for attn_type, per_step in (
            ("autoformer", dict(gp_only, fused_gp_bwd=1)),
            ("basic", dict(with_attention, fused_gp_bwd=1,
                           head_folded_attention_bwd=6))):
        counts, cpu_checks[f"train_{attn_type}"] = train(
            attn_type, data, per_step, smi)
        for k, v in counts.items():
            by_path[k][f"train_{attn_type}"] = v

    for k, entry in kernels.items():
        entry["launches"] = sum(by_path[k].values())
        entry["launches_by_path"] = by_path[k]
        entry["cpu_checks"] = cpu_checks  # each path's run against the cpu
    if not all(k["launches"] > 0 for k in kernels.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{by_path}")

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
