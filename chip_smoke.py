#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: the card's name, count and power limit; builds the CUDA kernels
   from ``fine_grained_gaussian_process_forcasting_torch/csrc``.
2. Kernels: each kernel against its plain-PyTorch version at the flagship
   AutoDG shapes (max-abs error against a stated tolerance), timed with CUDA
   events beside its plain version, its bound and, where one exists, the one
   PyTorch call that computes the same function.
3. Serving: the flagship AutoDG model (autoformer + GP + denoise, d_model 32,
   8 heads, 1 layer, 512 inducing points, enc 192, dec/pred 96) and its
   ``basic``-attention twin, weights from a fixed seed, serve 600 request
   windows through ``InferenceSession.predict`` (two batches of 256 and a
   ragged 88).  Checks shapes, finiteness, the kernels' launch counts, and the
   first 16 windows against the port's own CPU run.

Prints the ``kernels`` JSON line, then the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
without a result line.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# flagship AutoDG serving configuration
B, ENC_LEN, DEC_LEN, PRED, F = 256, 192, 96, 96, 4
D_MODEL, HEADS, LAYERS, INDUCING = 32, 8, 1, 512
N_WINDOWS = 600  # two full batches + a ragged tail of 88
N_CHECK = 16  # windows compared with the CPU run
SEED = 0

# published H100 SXM peaks (dense): fp32 outside the tensor cores, HBM3;
# exponentials on the special-function units: 16 per SM per clock x 132 SMs
# x 1.98 GHz boost clock
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9

TOL_FUSED_GP = 1e-4
TOL_ATTENTION = 1e-5
TOL_SERVING = 1e-3


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


def check_fused_gp(gen):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

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
    args = (x, zs, u, w, os_, (1.0 / ls).contiguous(),
            torch.randn(d, device=dev, generator=gen) / d,
            torch.tensor(0.1, device=dev))
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
    calls = {"enc_self": (ENC_LEN, ENC_LEN), "dec_self": (DEC_LEN, DEC_LEN),
             "dec_cross": (DEC_LEN, ENC_LEN)}
    launch = hfa.launcher()
    stream = torch.cuda.current_stream().cuda_stream
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "flops": 0.0, "exps": 0.0, "bytes": 0.0}
    err_all = 0.0
    for call, (lq, lk) in calls.items():
        q = torch.randn(B, HEADS, lq, d, device=dev, generator=gen)
        k = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        v = torch.randn(B, HEADS, lk, d, device=dev, generator=gen)
        with torch.inference_mode():
            got = hfa.head_folded_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got - hfa.head_folded_attention_plain(q, k, v)
                   ).abs().max().item()
            out = torch.empty_like(q)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())

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
    per-sample top-k delays of the first ``N_CHECK`` windows of each call."""

    def __init__(self):
        from fine_grained_gaussian_process_forcasting_torch.models import (
            transformer,
        )

        self.module = transformer
        self.original = transformer.auto_correlation
        self.delays = []

    def __enter__(self):
        def recording(q, k, v, factor=1, training=True):
            ctx, mean_value = self.original(q, k, v, factor=factor,
                                            training=training)
            top_k = int(factor * math.log(q.shape[2]))
            idx = torch.topk(mean_value, top_k, dim=-1).indices
            self.delays.append(idx[:N_CHECK].sort(-1).values.cpu().numpy())
            return ctx, mean_value

        self.module.auto_correlation = recording
        return self

    def __exit__(self, *exc):
        self.module.auto_correlation = self.original


def profile_batch(session, enc, dec, attn_type: str, batch_ms: float):
    """Device time of one served batch by kernel (``torch.profiler``), and
    the device's idle share of the batch's median wall time without the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.predict(enc, dec)
        torch.cuda.synchronize()
    # device-side events only: the CPU op that launched a kernel reports
    # the same device time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"profile {attn_type}: one batch of {len(enc)}: device busy "
        f"{busy_ms:.4f} ms in {launches} kernel launches; idle share of "
        f"the {batch_ms:.3f} ms median batch {1.0 - busy_ms / batch_ms:.3f}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")


def serve(attn_type: str, enc, dec, expect, card: str):
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        fused_gp,
        head_folded_attention,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.predict import (
        InferenceSession,
    )

    model = _flagship(attn_type, "cuda")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=B, device="cuda")
    session.predict(enc[:B], dec[:B])  # warm-up: cuBLAS/cuFFT plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_gp.launches = 0
    head_folded_attention.launches = 0
    t0 = time.perf_counter()
    out = session.predict(enc, dec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fused_gp": fused_gp.launches,
              "head_folded_attention": head_folded_attention.launches}
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
    profile_batch(session, enc[:B], dec[:B], attn_type,
                  float(np.median(batch_ms)))

    # the first windows against the port's own CPU run, same weights
    cpu = InferenceSession(_flagship(attn_type, "cpu"), state,
                           batch_size=N_CHECK, device="cpu")
    with _DelayRecorder() as rec_gpu:
        gpu_first = session.predict(enc[:N_CHECK], dec[:N_CHECK])
    with _DelayRecorder() as rec_cpu:
        cpu_first = cpu.predict(enc[:N_CHECK], dec[:N_CHECK])
    diff = np.abs(gpu_first - cpu_first).max(axis=(1, 2))
    flipped = np.zeros(N_CHECK, dtype=bool)
    for dg, dc in zip(rec_gpu.delays, rec_cpu.delays):
        flipped |= np.any(dg != dc, axis=-1)
    if rec_gpu.delays:
        log(f"{attn_type}: top-k delays of window 0, per call, cuda "
            f"{[d[0].tolist() for d in rec_gpu.delays]} cpu "
            f"{[d[0].tolist() for d in rec_cpu.delays]}")
        log(f"{attn_type}: windows whose delays differ between cuda and "
            f"cpu: {np.flatnonzero(flipped).tolist()} (max diff there "
            f"{diff[flipped].max() if flipped.any() else 0.0:.3e})")
    same = ~flipped
    if not same.any():
        raise AssertionError(f"{attn_type}: every window's delays flipped")
    max_diff = float(diff[same].max())
    log(f"{attn_type}: max|cuda - cpu| over {int(same.sum())} windows "
        f"{max_diff:.3e} (tol {TOL_SERVING})")
    if not max_diff <= TOL_SERVING:
        raise AssertionError(f"{attn_type}: cuda and cpu disagree: "
                             f"{max_diff} > {TOL_SERVING}")
    return counts, {"windows_per_s": N_WINDOWS / wall,
                    "batch_ms_median": float(np.median(batch_ms)),
                    "peak_bytes": peak, "cpu_max_abs_diff": max_diff}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_fused_gp(gen), check_head_folded(gen)]

    rng = np.random.default_rng(SEED)
    enc = rng.normal(size=(N_WINDOWS, ENC_LEN, F)).astype(np.float32)
    dec = rng.normal(size=(N_WINDOWS, DEC_LEN, F)).astype(np.float32)
    n_batches = -(-N_WINDOWS // B)
    launches = {"fused_gp": 0, "head_folded_attention": 0}
    for attn_type, per_batch in (("autoformer", {"fused_gp": 1,
                                                 "head_folded_attention": 0}),
                                 ("basic", {"fused_gp": 1,
                                            "head_folded_attention": 6})):
        expect = {k: n_batches * v for k, v in per_batch.items()}
        counts, _ = serve(attn_type, enc, dec, expect, smi)
        for k, v in counts.items():
            launches[k] += v
    kernels[0]["launches"] = launches["fused_gp"]
    kernels[1]["launches"] = launches["head_folded_attention"]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel never ran on the serving path: "
                             f"{launches}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
