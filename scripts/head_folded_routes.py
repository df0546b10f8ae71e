#!/usr/bin/env python3
"""Probes of the head-folded attention kernels on an NVIDIA GPU, timed at
the flagship's three calls (b 256, h 8, d 4: enc-self 192 x 192, dec-self
96 x 96, dec-cross 96 x 192).

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/head_folded_routes.py [--out DIR] [--sections ...]

Sections (all by default; ``scripts/head_folded_routes.cu`` holds the
probes' kernels):

``legacy``: the forward and the two backward launches that the port ran
before its redesign (kept in the probe), whole, with their exponentials
removed and with their products removed, on contiguous (b, h, L, d)
operands.

``copies``: the copies that the ``basic`` route made around those kernels
in one attention call: q, k and v made contiguous out of the projection's
(b, L, h d) output (one fused qkv buffer for self-attention, three
buffers for cross-attention), the context's transpose back, the backward's
cotangent made contiguous and dq, dk, dv transposed back; each group timed
as one ``torch`` op sequence.

``engines``: the two candidate engines for the forward's products at d 4,
S = Q K^T and O = S V with no softmax between them: FFMA (three query rows
a thread, K and V broadcast from shared memory) and ``mma.sync`` on TF32
parts (one pass, or three: big big + big small + small big); each one's
max|O - O in float64| beside the plain fp32 version's (``torch.matmul``).

``variants``: the port's first redesigned forward at d 4 (three rows a
thread, each row offset by a bound on its scores, K and V by ``cp.async``)
with its parts switched off one at a time: its exponentials, its score
bound, its asynchronous staging; with its registers capped at 64 (four
blocks an SM) and its key loop unrolled by 4; each whole variant's
max|O - plain|.

``port_variants``: the port's own kernel bodies at d 4 with parts switched
off (the forward's exp2, its running max; the backward's exp2, its
reduce-scatter of dQ), on the projections' layout; the whole kernels'
max|. - plain|.

``clocks``: the SM clock and power draw (``nvidia-smi``) while the port's
forward and backward run back to back at enc-self.

``port``: the port's kernels (``ops/cuda/head_folded_attention.py``), forward
with and without the log-sum-exp and backward, on contiguous operands and on
the (b, h, L, d) views of (b, L, h, d) buffers that the transformer hands
them.

``small_head``: the small-head kernels (``ops/cuda/small_head_attention.py``)
on contiguous (b, h, L, d) operands: the ones the port ran before their
redesign, kept in the probe (``small_legacy``), whole, without their
exponentials and without their products; the port's bodies with their rows
(forward) or keys (backward) a lane set to 3 and to 6, whole, without
exp2, without the forward's test of its group sums, without the backward's
rotation of dQ; the port's C entries; the head-folded kernels' C entries at
the same operands; and the instructions of the kernels'
innermost loops, read from their SASS (``cuobjdump``), per (query, key)
pair.

Prints one line a probe and shape and writes everything, with the probe's
build log, to ``DIR`` (by default ``build/probe``):
``head_folded_routes.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the flagship's shapes and the timer)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (  # noqa: E402,E501
    _build,
    head_folded_attention as hfa,
)

B, H = chip_smoke.B, chip_smoke.HEADS
D = chip_smoke.D_MODEL // chip_smoke.HEADS
CALLS = chip_smoke.ATTENTION_CALLS
ITERS = 50
MODES = {"whole": 0, "no_exp": 1, "no_products": 2}


def build(log_dir: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "probe" / "head_folded_routes.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-o", str(out),
           str(ROOT / "scripts" / "head_folded_routes.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (log_dir / "head_folded_routes_build.log").write_text(proc.stdout
                                                          + proc.stderr)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_legacy_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.probe_legacy_bwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.probe_engine_ffma.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.probe_engine_mma.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.probe_variant_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.probe_fwd_variant.argtypes = [p] * 5 + [strides] + [i] * 5 + [p]
    lib.probe_bwd_variant.argtypes = [p] * 9 + [strides] + [i] * 7 + [p]
    lib.probe_small_legacy_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.probe_small_legacy_bwd.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.probe_small_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.probe_small_bwd.argtypes = [p] * 9 + [i] * 5 + [p]
    return lib


def _ok(err, what):
    if err:
        raise RuntimeError(f"{what}: cudaError {err}")


def _inputs(gen, lq, lk):
    def draw(n):
        return torch.randn(B, H, n, D, device="cuda", generator=gen)
    return draw(lq), draw(lk), draw(lk), draw(lq)


def legacy(lib, gen, report):
    stream = torch.cuda.current_stream().cuda_stream
    rows = report.setdefault("legacy", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, do = _inputs(gen, lq, lk)
        o = torch.empty_like(q)
        lse = torch.empty(B, H, lq, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        ptr = [t.data_ptr() for t in (q, k, v, o, lse)]
        bptr = [t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                       delta)]
        _ok(lib.probe_legacy_fwd(*ptr, B * H, lq, lk, D, 0, stream), "fwd")
        _ok(lib.probe_legacy_bwd(*bptr, B * H, lq, lk, D, 0, 3, stream),
            "bwd")
        torch.cuda.synchronize()
        want = hfa.head_folded_attention_plain(q, k, v)
        err = (o - want).abs().max().item()
        row = {"max_abs_err_vs_plain": err}
        for name, mode in MODES.items():
            row[f"fwd_{name}_ms"] = chip_smoke.time_ms(
                lambda: _ok(lib.probe_legacy_fwd(*ptr, B * H, lq, lk, D, mode,
                                                 stream), "fwd"), ITERS)
            for which, part in ((1, "dq"), (2, "dkv"), (3, "bwd")):
                row[f"{part}_{name}_ms"] = chip_smoke.time_ms(
                    lambda: _ok(lib.probe_legacy_bwd(
                        *bptr, B * H, lq, lk, D, mode, which, stream), "bwd"),
                    ITERS)
        # the forward's result is overwritten by the ablations: restore it
        _ok(lib.probe_legacy_fwd(*ptr, B * H, lq, lk, D, 0, stream), "fwd")
        rows[call] = row
        print(f"legacy {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else f"{key} {val:.3e}"
            for key, val in row.items()), flush=True)


def copies(lib, gen, report):
    """The copies the ``basic`` route made around one call, by group."""
    rows = report.setdefault("copies", {})
    hd = H * D
    for call, (lq, lk) in CALLS.items():
        is_self = call != "dec_cross"
        if is_self:
            qkv = torch.randn(B, lq, 3 * hd, device="cuda", generator=gen)
            q_in, k_in, v_in = (qkv[..., i * hd:(i + 1) * hd]
                                for i in range(3))
        else:
            q_in = torch.randn(B, lq, hd, device="cuda", generator=gen)
            k_in = torch.randn(B, lk, hd, device="cuda", generator=gen)
            v_in = torch.randn(B, lk, hd, device="cuda", generator=gen)

        def split(x):
            return x.reshape(B, -1, H, D).transpose(1, 2)

        q, k, v = split(q_in), split(k_in), split(v_in)
        ctx = torch.randn(B, H, lq, D, device="cuda", generator=gen)
        grad = torch.randn(B, lq, hd, device="cuda", generator=gen)
        dq, dk, dv = (torch.randn(B, H, n, D, device="cuda", generator=gen)
                      for n in (lq, lk, lk))
        row = {
            "qkv_contiguous_ms": chip_smoke.time_ms(
                lambda: (q.contiguous(), k.contiguous(), v.contiguous()),
                ITERS),
            "context_back_ms": chip_smoke.time_ms(
                lambda: ctx.transpose(1, 2).reshape(B, lq, hd), ITERS),
            "do_contiguous_ms": chip_smoke.time_ms(
                lambda: split(grad).contiguous(), ITERS),
            "grads_back_ms": chip_smoke.time_ms(
                lambda: [t.transpose(1, 2).reshape(B, -1, hd)
                         for t in (dq, dk, dv)], ITERS),
            "copies": 8,
        }
        row["total_ms"] = sum(val for key, val in row.items()
                              if key.endswith("_ms"))
        rows[call] = row
        print(f"copies {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else f"{key} {val}"
            for key, val in row.items()), flush=True)


def engines(lib, gen, report):
    stream = torch.cuda.current_stream().cuda_stream
    rows = report.setdefault("engines", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, _ = _inputs(gen, lq, lk)
        want = torch.matmul(torch.matmul(q.double(), k.double().transpose(
            -1, -2)), v.double())
        plain = torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v)
        row = {"plain_err": (plain.double() - want).abs().max().item(),
               "plain_ms": chip_smoke.time_ms(
                   lambda: torch.matmul(torch.matmul(q, k.transpose(-1, -2)),
                                        v), 20)}
        o = torch.empty_like(q)
        ptr = [t.data_ptr() for t in (q, k, v, o)]
        runs = {
            "ffma": lambda: _ok(lib.probe_engine_ffma(*ptr, B * H, lq, lk,
                                                      stream), "ffma"),
            "mma_tf32x1": lambda: _ok(lib.probe_engine_mma(
                *ptr, B * H, lq, lk, 1, stream), "mma"),
            "mma_tf32x3": lambda: _ok(lib.probe_engine_mma(
                *ptr, B * H, lq, lk, 3, stream), "mma"),
        }
        for name, run in runs.items():
            o.zero_()
            run()
            torch.cuda.synchronize()
            row[f"{name}_err"] = (o.double() - want).abs().max().item()
            row[f"{name}_ms"] = chip_smoke.time_ms(run, ITERS)
        pairs = B * H * lq * lk
        # 4 d flops a pair at the fp32 peak
        row["bound_ms"] = 4.0 * D * pairs / chip_smoke.PEAK_FP32 * 1e3
        rows[call] = row
        print(f"engines {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else f"{key} {val:.3e}"
            for key, val in row.items()), flush=True)


def port(lib, gen, report):
    rows = report.setdefault("port", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, do = _inputs(gen, lq, lk)

        def folded(t):
            out = torch.empty(B, t.shape[2], H, D, device="cuda")
            out.copy_(t.transpose(1, 2))
            return out.transpose(1, 2)

        row = {}
        for layout, (qq, kk, vv, dd) in (
                ("contiguous", (q, k, v, do)),
                ("folded", tuple(folded(t) for t in (q, k, v, do)))):
            with torch.inference_mode():
                row[f"{layout}_fwd_ms"] = chip_smoke.time_ms(
                    lambda: hfa.forward_kernel(qq, kk, vv, with_lse=False),
                    ITERS)
                row[f"{layout}_fwd_lse_ms"] = chip_smoke.time_ms(
                    lambda: hfa.forward_kernel(qq, kk, vv, with_lse=True),
                    ITERS)
                out, lse = hfa.forward_kernel(qq, kk, vv, with_lse=True)
                row[f"{layout}_bwd_ms"] = chip_smoke.time_ms(
                    lambda: hfa.backward_kernel(qq, kk, vv, out, lse, dd),
                    ITERS)
        rows[call] = row
        print(f"port {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" for key, val in row.items()), flush=True)


VARIANTS = ("whole", "regs_64", "no_exp", "no_bound", "no_async",
            "unroll_4", "products_and_sum")


def variants(lib, gen, report):
    """The port's forward at d 4 with its parts switched off one at a time
    (``scripts/head_folded_routes.cu``, ``variant``)."""
    stream = torch.cuda.current_stream().cuda_stream
    rows = report.setdefault("variants", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, _ = _inputs(gen, lq, lk)
        want = hfa.head_folded_attention_plain(q, k, v)
        o = torch.empty_like(q)
        ptr = [t.data_ptr() for t in (q, k, v, o)]
        row = {}
        for which, name in enumerate(VARIANTS):
            def run():
                _ok(lib.probe_variant_fwd(*ptr, B, lq, lk, which, stream),
                    name)
            run()
            torch.cuda.synchronize()
            if name in ("whole", "regs_64", "no_bound", "no_async",
                        "unroll_4"):
                row[f"{name}_err"] = (o - want).abs().max().item()
            row[f"{name}_ms"] = chip_smoke.time_ms(run, ITERS)
        rows[call] = row
        print(f"variants {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else f"{key} {val:.3e}"
            for key, val in row.items()), flush=True)


FWD_PORT_VARIANTS = ("port", "no_exp", "no_max", "no_exp_no_max")
BWD_PORT_VARIANTS = ("port", "no_exp", "no_reduce", "no_exp_no_reduce")


def port_variants(lib, gen, report):
    """The port's own kernel bodies at d 4 with parts switched off
    (``scripts/head_folded_routes.cu``, ``portvar``), on the projections'
    layout; the whole variants' max|. - plain|."""
    stream = torch.cuda.current_stream().cuda_stream
    rows = report.setdefault("port_variants", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in _inputs(gen, lq, lk))
        out = hfa.folded_empty(B, H, lq, D, "cuda")
        lse = torch.empty(B, H, lq, device="cuda")
        fstrides = hfa.launch_strides(q, k, v, out)
        fptr = [t.data_ptr() for t in (q, k, v, out, lse)]
        row = {}
        for which, name in enumerate(FWD_PORT_VARIANTS):
            def run():
                _ok(lib.probe_fwd_variant(*fptr, fstrides, B, H, lq, lk,
                                          which, stream), name)
            run()
            torch.cuda.synchronize()
            if which == 0:
                row[f"fwd_{name}_err"] = (
                    out - hfa.head_folded_attention_plain(q, k, v)
                ).abs().max().item()
            row[f"fwd_{name}_ms"] = chip_smoke.time_ms(run, ITERS)
        out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
        hb, wph = hfa.bwd_plan(H, lq, lk, D)
        grads = [hfa.folded_empty(B, H, n, D, "cuda") for n in (lq, lk, lk)]
        bstrides = hfa.launch_strides(q, k, v, out, do, *grads)
        bptr = [t.data_ptr() for t in (q, k, v, out, lse, do, *grads)]
        want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
        for which, name in enumerate(BWD_PORT_VARIANTS):
            def run():
                _ok(lib.probe_bwd_variant(*bptr, bstrides, B, H, lq, lk, hb,
                                          wph, which, stream), name)
            run()
            torch.cuda.synchronize()
            if which == 0:
                row[f"bwd_{name}_err"] = max(
                    (g - w).abs().max().item() for g, w in zip(grads, want))
            row[f"bwd_{name}_ms"] = chip_smoke.time_ms(run, ITERS)
        rows[call] = row
        print(f"port_variants {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else f"{key} {val:.3e}"
            for key, val in row.items()), flush=True)


def clocks(lib, gen, report):
    """The SM clock while the port's forward and backward run back to back
    for about a second each (``nvidia-smi``, sampled from a thread)."""
    import threading

    lq = lk = chip_smoke.ENC_LEN
    q, k, v, do = _inputs(gen, lq, lk)
    out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
    rows = report.setdefault("clocks", {})
    for name, fn in (("fwd", lambda: hfa.forward_kernel(q, k, v, False)),
                     ("bwd", lambda: hfa.backward_kernel(q, k, v, out, lse,
                                                         do))):
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                samples.append(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True).stdout.strip())

        thread = threading.Thread(target=sample)
        thread.start()
        with torch.inference_mode():
            for _ in range(4):
                for _ in range(2000):
                    fn()
                torch.cuda.synchronize()
        stop.set()
        thread.join()
        rows[name] = samples
        print(f"clocks {name} (MHz, W) while it runs: {samples}", flush=True)


# the small-head bodies' PROBE bits (csrc/small_head_attention.cu: NO_EXP
# 1, NO_CHECK 2, NO_ROTATE 4)
SMALL_FWD_PROBES = {"whole": 0, "no_exp": 1, "no_check": 2,
                    "no_exp_no_check": 3}
SMALL_BWD_PROBES = {"whole": 0, "no_exp": 1, "no_rotate": 4,
                    "no_exp_no_rotate": 5}


def small_head(lib, gen, report):
    """The small-head kernels at the flagship's three calls, d 4, on
    contiguous (b, h, L, d) operands: the first design kept in the probe, the
    port's bodies with parts switched off and with 3 or 6 rows (keys) a
    lane, the port's wrappers, and the head-folded kernels beside."""
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        small_head_attention as sha,
    )

    stream = torch.cuda.current_stream().cuda_stream
    rows = report.setdefault("small_head", {})
    for call, (lq, lk) in CALLS.items():
        q, k, v, do = _inputs(gen, lq, lk)
        n = B * H
        want = sha.small_head_attention_plain(q, k, v)
        want_grads = sha.small_head_attention_bwd_plain(q, k, v, do)
        o = torch.empty_like(q)
        lse = torch.empty(B, H, lq, device="cuda")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        fptr = [t.data_ptr() for t in (q, k, v, o, lse)]
        row = {}
        # the first design's kernels
        for name, mode in MODES.items():
            def run_fwd():
                _ok(lib.probe_small_legacy_fwd(*fptr, n, lq, lk, mode,
                                               stream), "legacy fwd")
            run_fwd()
            torch.cuda.synchronize()
            if mode == 0:
                row["legacy_fwd_err"] = (o - want).abs().max().item()
            row[f"legacy_fwd_{name}_ms"] = chip_smoke.time_ms(run_fwd, ITERS)
        _ok(lib.probe_small_legacy_fwd(*fptr, n, lq, lk, 0, stream), "fwd")
        bptr = [t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                       delta)]
        for name, mode in MODES.items():
            for which, part in ((1, "dq"), (2, "dkv"), (3, "bwd")):
                def run_bwd():
                    _ok(lib.probe_small_legacy_bwd(*bptr, n, lq, lk, mode,
                                                   which, stream), "legacy")
                if mode == 0 and which == 3:
                    run_bwd()
                    torch.cuda.synchronize()
                    row["legacy_bwd_err"] = max(
                        (g - w).abs().max().item()
                        for g, w in zip((dq, dk, dv), want_grads))
                row[f"legacy_{part}_{name}_ms"] = chip_smoke.time_ms(
                    run_bwd, ITERS)
        # the port's bodies, parts switched off, 3 or 6 rows (keys) a lane
        for r in (3, 6):
            for name, probe in SMALL_FWD_PROBES.items():
                def run_fwd():
                    _ok(lib.probe_small_fwd(*fptr, n, lq, lk, r, probe,
                                            stream), "small fwd")
                run_fwd()
                torch.cuda.synchronize()
                if probe == 0:
                    row[f"fwd_r{r}_err"] = (o - want).abs().max().item()
                row[f"fwd_r{r}_{name}_ms"] = chip_smoke.time_ms(run_fwd,
                                                                ITERS)
        out, lse = sha.forward_kernel(q, k, v)
        bptr = [t.data_ptr() for t in (q, k, v, out, lse, do, dq, dk, dv)]
        for rk in (3, 6):
            for name, probe in SMALL_BWD_PROBES.items():
                def run_bwd():
                    _ok(lib.probe_small_bwd(*bptr, n, lq, lk, rk, probe,
                                            stream), "small bwd")
                run_bwd()
                torch.cuda.synchronize()
                if probe == 0:
                    row[f"bwd_rk{rk}_err"] = max(
                        (g - w).abs().max().item()
                        for g, w in zip((dq, dk, dv), want_grads))
                row[f"bwd_rk{rk}_{name}_ms"] = chip_smoke.time_ms(run_bwd,
                                                                  ITERS)
        # the port's C entries, and head-folded at the same operands
        fwd_ptr = [t.data_ptr() for t in (q, k, v, o, delta)]
        bwd_ptr = [t.data_ptr() for t in (q, k, v, out, lse, do, dq, dk, dv,
                                          delta)]
        fwd_entry, bwd_entry = sha.launcher(), sha.bwd_launcher()
        with torch.inference_mode():
            row["port_fwd_ms"] = chip_smoke.time_ms(
                lambda: _ok(fwd_entry(*fwd_ptr, n, lq, lk, D, stream),
                            "port fwd"), ITERS)
            row["port_bwd_ms"] = chip_smoke.time_ms(
                lambda: _ok(bwd_entry(*bwd_ptr, n, lq, lk, D, stream),
                            "port bwd"), ITERS)
            row["port_bwd_launches"] = sha.bwd_launches_a_call(lq, D)
            hf_out, hf_lse = hfa.forward_kernel(q, k, v, with_lse=True)
            strides = hfa.launch_strides(q, k, v, o)
            hf_fwd = [t.data_ptr() for t in (q, k, v, o, delta)]
            row["head_folded_fwd_ms"] = chip_smoke.time_ms(
                lambda: _ok(hfa.launcher()(*hf_fwd, strides, B, H, lq, lk, D,
                                           stream), "head-folded fwd"),
                ITERS)
            hb, wph = hfa.bwd_plan(H, lq, lk, D)
            bstrides = hfa.launch_strides(q, k, v, hf_out, do, dq, dk, dv)
            hf_bwd = [t.data_ptr() for t in (q, k, v, hf_out, hf_lse, do, dq,
                                             dk, dv)]
            hf_bwd.append(None if hb else delta.data_ptr())
            row["head_folded_bwd_ms"] = chip_smoke.time_ms(
                lambda: _ok(hfa.bwd_launcher()(*hf_bwd, bstrides, B, H, lq,
                                               lk, D, hb, wph, stream),
                            "head-folded bwd"), ITERS)
        rows[call] = row
        print(f"small_head {call} (Lq {lq}, Lk {lk}): " + ", ".join(
            f"{key} {val:.4f}" if key.endswith("ms") else
            f"{key} {val:.3e}" if key.endswith("err") else f"{key} {val}"
            for key, val in row.items()), flush=True)
    sass = report["small_head_sass"] = small_head_sass()
    # the share of the issue rate (4 warp instructions a clock an SM, 132
    # SMs, at the 1980 MHz the `clocks` section read under load) that
    # the loops reach at enc-self: their instructions a pair (the SASS loop
    # with the exponentials) times the pairs, over the time
    lq, lk = CALLS["enc_self"]
    pairs = B * H * lq * lk
    shares = report["small_head_issue_share"] = {}
    for ms_key, frag in (("fwd_r6_no_check_ms", "small_var3fwdILi6ELi2E"),
                         ("bwd_rk6_whole_ms",
                          "bwd_fused_kernelILi4ELi6ELb1E")):
        loops = sass.get(frag) if isinstance(sass, dict) else None
        if not loops:
            continue
        loop = max(loops, key=lambda x: x["mix"].get("MUFU", 0))
        ms = rows["enc_self"][ms_key]
        shares[ms_key] = (pairs * loop["per_pair"] / 32
                          / (ms * 1e-3 * 132 * 4 * 1.98e9))
        print(f"issue share enc_self {ms_key}: {loop['per_pair']:.2f} "
              f"instructions a pair, {ms:.4f} ms: "
              f"{shares[ms_key]:.3f} of the issue rate", flush=True)


# the small-head kernels at d 4 whose innermost loops the SASS section
# counts, by a fragment of their mangled names, with the (query, key) pairs
# a lane one trip of that loop computes (the forward a group of 4 keys for
# R rows, the backward two rotation steps of RK keys): the port's, and the
# probe's copies without the forward's test of its group sums (R 6, 3) and
# without the backward's rotation (RK 6)
SASS_KERNELS = {"fwd_kernelILi4ELi6E": 4 * 6, "fwd_kernelILi4ELi3E": 4 * 3,
                "bwd_fused_kernelILi4ELi6ELb1E": 2 * 6,
                "bwd_fused_kernelILi4ELi3ELb1E": 2 * 3,
                "small_var3fwdILi6ELi2E": 4 * 6,
                "small_var3fwdILi3ELi2E": 4 * 3,
                "small_var3bwdILi6ELb1ELi2E": 2 * 6}


def _sass_loops(text):
    """{function: [(instructions, {opcode: count}), ...]} of each
    function's innermost loops (a backward branch whose span holds no other
    backward branch), from ``cuobjdump -sass`` text."""
    import re

    funcs, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if name and ins:
            funcs[name].append((int(ins.group(1), 16), ins.group(2).strip()))
    loops = {}
    for name, code in funcs.items():
        spans = []
        for at, ins in code:
            to = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if to and int(to.group(1), 16) <= at:
                spans.append((int(to.group(1), 16), at))
        inner = [s for s in spans if not any(
            o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
        found = []
        for lo, hi in inner:
            mix = {}
            body = [ins for at, ins in code if lo <= at <= hi]
            for ins in body:
                op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
                mix[op] = mix.get(op, 0) + 1
            found.append((len(body), mix))
        loops[name] = found
    return loops


def small_head_sass():
    """Each timed kernel's innermost loops: their instructions, their mix,
    and the instructions per (query, key) pair."""
    import shutil

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        _build,
    )

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = [_build.build(("small_head_attention",))["small_head_attention"],
            ROOT / "build" / "probe" / "head_folded_routes.so"]
    text = ""
    for lib in libs:
        proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True)
        if proc.returncode:
            print(f"cuobjdump failed: {proc.stderr.strip()}", flush=True)
            return {"error": proc.stderr.strip()}
        text += proc.stdout
    out = {}
    for name, loops in _sass_loops(text).items():
        for frag, pairs in SASS_KERNELS.items():
            if frag not in name:
                continue
            # every innermost span: the key loop, and any rare path placed
            # after it that branches back into it
            out[frag] = [{"instructions": count, "pairs": pairs,
                          "per_pair": count / pairs, "mix": mix}
                         for count, mix in loops]
            for count, mix in loops:
                print(f"sass {frag}: an innermost loop of {count} "
                      f"instructions, {pairs} pairs a lane a trip, "
                      f"{count / pairs:.2f} a pair; {mix}", flush=True)
    return out


SECTIONS = {"legacy": legacy, "copies": copies, "engines": engines,
            "variants": variants, "port_variants": port_variants,
            "clocks": clocks, "port": port, "small_head": small_head}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "probe",
                        help="directory for the JSON report and build log")
    parser.add_argument("--sections", nargs="+", choices=list(SECTIONS),
                        default=list(SECTIONS), help="which probes to run")
    opts = parser.parse_args()
    out_dir = opts.out
    out_dir.mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    lib = build(out_dir)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    report = {"device": smi, "shapes": {"b": B, "h": H, "d": D,
                                        "calls": CALLS}}
    for name in opts.sections:
        SECTIONS[name](lib, gen, report)
    out = out_dir / "head_folded_routes.json"
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
