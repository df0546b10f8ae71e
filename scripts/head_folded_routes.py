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


SECTIONS = {"legacy": legacy, "copies": copies, "engines": engines,
            "variants": variants, "port_variants": port_variants,
            "clocks": clocks, "port": port}


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
