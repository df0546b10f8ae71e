#!/usr/bin/env python3
"""Probes of the fused GP's and the rbf kernel's products on an NVIDIA GPU,
timed and held against float64.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/fused_gp_routes.py [--out DIR] [--sections ...]

Sections (all by default; ``scripts/fused_gp_routes.cu`` holds the probes'
kernels):

``kw_dw``: three routes for the fp32 fused-GP backward's two large
products, G = K W (2 M^2 flops a row) and dW = -K^T diag(dvar) K
(symmetric: M (M + 1) a row), at the flagship's 73,728 rows (d 32) and the
production width's 40,960 rows (d 512), M 512, on the inputs
``chip_smoke.py`` gives the fused GP:

  (a) three bf16 parts of each operand on the port's ``wgb::gemm_kernel``,
      K split on load, with the tensor cores' sums added in fp32 every
      ``sum`` k16 steps (K W: 32 or 4; dW: 0 = never, 4 or 1);
  (b) 3xTF32 on ``wgmma .tf32`` (per: stages of 32 a sum spans, 0 = never);
  (c) FFMA at two blocks an SM.

Each route's G and dW replace the plain fp32 version's in the VJP (every
other term as the plain version computes it), so that each gradient's
distance from the float64 function, summed over ``DRAWS`` draws, can be
set beside the plain fp32 version's.

``bf16_fwd``: the bf16 fused-GP forward at prod_basic's shape (40,960
rows, d 512, M 512): the direct-difference kernel that the port's forward
replaced (kept in the probe) whole and its
first phase alone (the distance by direct difference, K and the mean), and
the port's forward as the wrapper launches it, each beside its distance
from the plain bf16 version.

``rbf``: the rbf cross-covariance at the multi-layer flagship's hidden
layer (8 GPs, 73,728 rows, M 512, d 32) and its served ragged batch (88
windows, 25,344 rows): (a) the cross term of each GP on the
``wgb::`` engine in three bf16 parts, x scaled and split on load, K written
from the accumulators, one launch a GP; (b) the port's kernel
(``csrc/rbf.cu``); each route's distance from K in float64, summed over
``DRAWS`` draws, beside the plain version's; and a kernel that only writes
the output (os exp(-1/2)), the store bandwidth a kernel bound by its stores
can reach.

Prints one line a route and shape and writes everything, with the probe's
build log, to ``DIR`` (by default ``build/probe``): ``fused_gp_routes.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its fused-GP and rbf inputs and timer)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (  # noqa: E402
    _build,
    fused_gp,
    rbf,
)

DRAWS = 4
SHAPES = {"flagship": chip_smoke.GP_SHAPES["flagship"],
          "d512": chip_smoke.GP_SHAPES["production"]}
OUTPUTS = ("var", "dx", "dzs", "du", "dW", "dos", "dinv_ls", "dmean_w",
           "dmean_b")
GT = 128


def build(log_dir: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "probe" / "fused_gp_routes.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-o", str(out), str(ROOT / "scripts" / "fused_gp_routes.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (log_dir / "fused_gp_routes_build.log").write_text(proc.stdout
                                                        + proc.stderr)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_kw_a.argtypes = [p, p, p, i, i, i, p]
    lib.probe_dw_a.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.probe_tf32.argtypes = [p, p, p, p, i, p, i, ctypes.c_longlong, i, i,
                               i, i, i, i, i, p]
    lib.probe_ffma.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.probe_legacy_bf16_fwd.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.probe_rbf_a.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.probe_store_only.argtypes = [p, p, i, ctypes.c_longlong, p]
    return lib


def round_up(v, to):
    return -(-v // to) * to


def tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest), as fp32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_parts(t):
    big = tf32(t)
    return big.contiguous(), tf32(t - big).contiguous()


def bf16_parts(t):
    out, rest = [], t
    for _ in range(3):
        p = rest.bfloat16()
        out.append(p)
        rest = rest - p.float()
    return torch.stack(out).contiguous()


def slabs(rp, tiles):
    """wgb::slabs: slabs of the summed rows for about one wave."""
    s = max(1, min(132 // tiles, rp // 64))
    k_len = round_up(-(-rp // s), 64)
    return -(-rp // k_len), k_len


def kernel_k(args):
    x, zs, u, w, os_, inv_ls = args[:6]
    xs = x.reshape(-1, x.shape[-1]) * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * xs @ zs.T)
    return os_ * torch.exp(-0.5 * d2)


def vjp_with(args, cot, g, dw):
    """The plain fp32 VJP and variance with G = K W and dW given."""
    x, zs, u, w, os_, inv_ls, mean_w, mean_b = args
    dmean, dvar = cot
    r, d = x.shape[0] * x.shape[1], x.shape[-1]
    xr = x.reshape(r, d)
    xs = xr * inv_ls
    k = kernel_k(args)
    dm, dv = dmean.reshape(-1, 1), dvar.reshape(-1, 1)
    e = (dm * u - 2.0 * dv * g) * k
    dxsc = e @ zs - e.sum(-1, keepdim=True) * xs
    return {"var": os_ - (g * k).sum(-1),
            "dx": dxsc * inv_ls + dm * mean_w,
            "dzs": e.T @ xs - e.sum(0)[:, None] * zs,
            "du": (k * dm).sum(0), "dW": dw,
            "dos": e.sum() / os_ + dv.sum(),
            "dinv_ls": (dxsc * xr).sum(0), "dmean_w": (dm * xr).sum(0),
            "dmean_b": dm.sum()}


class Routes:
    """The routes' two products on one draw's K, W and dvar."""

    def __init__(self, lib, args, cot):
        self.lib = lib
        k = kernel_k(args)
        w, dvar = args[3], cot[1].reshape(-1)
        self.R, self.M = k.shape
        self.Rp, self.Mp = round_up(self.R, GT), round_up(self.M, GT)
        Rp, Mp, R, M = self.Rp, self.Mp, self.R, self.M
        dev = k.device
        self.kt = torch.zeros(Mp, Rp, device=dev)
        self.kt[:M, :R] = k.T
        self.kr = torch.zeros(Rp, Mp, device=dev)
        self.kr[:R, :M] = k
        wt = torch.zeros(Mp, Mp, device=dev)
        wt[:M, :M] = w.T
        self.wpad = torch.zeros(Mp, Mp, device=dev)
        self.wpad[:M, :M] = w
        self.wparts = bf16_parts(wt)
        self.dvp = torch.zeros(Rp, device=dev)
        self.dvp[:R] = dvar
        self.wt_t = tf32_parts(wt)
        self.kr_t = tf32_parts(self.kr)
        self.kt_t = tf32_parts(self.kt)
        self.dvkt_t = tf32_parts(self.kt * self.dvp)
        self.gt = torch.empty(Mp, Rp, device=dev)
        self.g = torch.empty(Rp, Mp, device=dev)
        self.s_w, self.k_w = slabs(Rp, (Mp // GT) * (Mp // GT + 1) // 2)
        self.pw = torch.empty(self.s_w, Mp, Mp, device=dev)
        # (c): row ranges so that dW's ten tiles make about two blocks an SM
        nt = Mp // GT
        self.s_c = max(1, min(264 // (nt * (nt + 1) // 2), -(-R // 8)))
        self.rows_c = round_up(-(-Rp // self.s_c), 8)
        self.s_c = -(-Rp // self.rows_c)
        self.pw_c = torch.empty(self.s_c, Mp, Mp, device=dev)
        self.stream = torch.cuda.current_stream().cuda_stream

    def _ok(self, err, what):
        if err:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")

    def kw(self, route, opt):
        p = self.lib
        if route == "a":
            self._ok(p.probe_kw_a(self.wparts.data_ptr(), self.kt.data_ptr(),
                                  self.gt.data_ptr(), self.Mp, self.Rp, opt,
                                  self.stream), "kw a")
        elif route == "b":
            self._ok(p.probe_tf32(
                self.wt_t[0].data_ptr(), self.wt_t[1].data_ptr(),
                self.kr_t[0].data_ptr(), self.kr_t[1].data_ptr(), self.Mp,
                self.gt.data_ptr(), self.Rp, 0, self.Mp // GT, self.Rp // GT,
                1, self.Mp, self.Mp, 0, opt, self.stream), "kw b")
        else:
            self._ok(p.probe_ffma(self.kt.data_ptr(), self.wpad.data_ptr(),
                                  None, self.g.data_ptr(), self.Mp, self.Rp,
                                  self.Mp, self.Mp, 1, 0, self.stream),
                     "kw c")

    def dw(self, route, opt):
        p = self.lib
        if route == "a":
            self._ok(p.probe_dw_a(self.kt.data_ptr(), self.dvp.data_ptr(),
                                  self.pw.data_ptr(), self.Mp, self.Rp,
                                  self.s_w, self.k_w, opt, self.stream),
                     "dw a")
        elif route == "b":
            self._ok(p.probe_tf32(
                self.kt_t[0].data_ptr(), self.kt_t[1].data_ptr(),
                self.dvkt_t[0].data_ptr(), self.dvkt_t[1].data_ptr(),
                self.Rp, self.pw.data_ptr(), self.Mp, self.Mp * self.Mp,
                self.Mp // GT, self.Mp // GT, self.s_w, self.k_w, self.Rp, 1,
                opt, self.stream), "dw b")
        else:
            self._ok(p.probe_ffma(self.kr.data_ptr(), self.kr.data_ptr(),
                                  self.dvp.data_ptr(), self.pw_c.data_ptr(),
                                  self.Rp, self.Mp, self.Mp, self.rows_c,
                                  self.s_c, 1, self.stream), "dw c")

    def results(self, route):
        """(G (R, M), dW (M, M)) from the last kw and dw of `route`."""
        R, M = self.R, self.M
        g = self.g[:R, :M] if route == "c" else self.gt[:M, :R].T
        pw = self.pw_c if route == "c" else self.pw
        s = pw.double().sum(0)
        t = torch.arange(self.Mp, device=s.device) // GT
        full = torch.where(t[:, None] <= t[None, :], s, s.T)
        return g, (-full[:M, :M]).float()


ROUTES = [("a", 32, 4), ("a", 32, 0), ("a", 32, 1), ("a", 4, 4),
          ("b", 0, 2), ("b", 0, 0), ("c", 0, 0)]


def label(route, kw_opt, dw_opt):
    if route == "a":
        return f"(a) bf16x3, K W sum {kw_opt}, dW sum {dw_opt}"
    if route == "b":
        return f"(b) 3xTF32, dW sum {'64 rows' if dw_opt else 'unbroken'}"
    return "(c) FFMA, 2 blocks/SM"


def kw_dw(lib, gen, report):
    """The three routes for K W and dW (section ``kw_dw``)."""
    report["kw_dw"] = {"draws": DRAWS, "shapes": {}}
    for tag, shape in SHAPES.items():
        b, n, d, m = shape
        rows = {}
        dist = {lbl: dict.fromkeys(OUTPUTS, 0.0)
                for lbl in ["plain"] + [label(*r) for r in ROUTES]}
        times = {}
        for i in range(DRAWS):
            args = chip_smoke._gp_inputs(gen, shape)
            cot = (torch.randn(b, n, device="cuda", generator=gen),
                   torch.randn(b, n, device="cuda", generator=gen))
            with torch.inference_mode():
                k = kernel_k(args)
                exact = vjp_with([a.double() for a in args],
                                 [c.double() for c in cot],
                                 kernel_k([a.double() for a in args])
                                 @ args[3].double(), None)
                wide_k = kernel_k([a.double() for a in args])
                exact["dW"] = -(wide_k.T @ (cot[1].reshape(-1, 1).double()
                                             * wide_k))
                plain = vjp_with(args, cot, k @ args[3],
                                 -(k.T @ (cot[1].reshape(-1, 1) * k)))
                for name in OUTPUTS:
                    dist["plain"][name] += (plain[name].double()
                                            - exact[name]).abs().max().item()
                routes = Routes(lib, args, cot)
                for route, kw_opt, dw_opt in ROUTES:
                    lbl = label(route, kw_opt, dw_opt)
                    routes.kw(route, kw_opt)
                    routes.dw(route, dw_opt)
                    torch.cuda.synchronize()
                    g, dw = routes.results(route)
                    got = vjp_with(args, cot, g, dw)
                    for name in OUTPUTS:
                        dist[lbl][name] += (got[name].double()
                                            - exact[name]).abs().max().item()
                    if i == 0:
                        times[lbl] = (
                            chip_smoke.time_ms(
                                lambda: routes.kw(route, kw_opt), 10),
                            chip_smoke.time_ms(
                                lambda: routes.dw(route, dw_opt), 10))
                del routes
        r = b * n
        kw_gflop, dw_gflop = r * 2.0 * m * m / 1e9, r * m * (m + 1.0) / 1e9
        for lbl, (kw_ms, dw_ms) in times.items():
            ratios = {name: dist[lbl][name] / dist["plain"][name]
                      if dist["plain"][name] > 0 else math.inf
                      for name in OUTPUTS}
            worst = max(ratios, key=ratios.get)
            rows[lbl] = {"kw_ms": kw_ms, "dw_ms": dw_ms,
                         "kw_tflops": kw_gflop / kw_ms,
                         "dw_tflops": dw_gflop / dw_ms,
                         "dist_over_plain": ratios,
                         "dist_summed": dist[lbl]}
            print(f"{tag} (rows {r}, d {d}, M {m}) {lbl}: K W {kw_ms:.4f} ms "
                  f"({kw_gflop / kw_ms:.1f} TFLOP/s fp32-equivalent), dW "
                  f"{dw_ms:.4f} ms ({dw_gflop / dw_ms:.1f}); distance from "
                  f"float64 over plain's, summed over {DRAWS} draws: "
                  + ", ".join(f"{k_} {v:.3f}" for k_, v in ratios.items())
                  + f"; worst {worst} {ratios[worst]:.3f}", flush=True)
        report["kw_dw"]["shapes"][tag] = {"rows": r, "d": d, "M": m,
                                 "plain_dist_summed": dist["plain"],
                                 "routes": rows}


def bf16_fwd(lib, gen, report):
    """The direct-difference bf16 forward whole and its first phase alone,
    and the port's bf16 forward, at prod_basic's shape (section
    ``bf16_fwd``)."""
    shape = chip_smoke.GP_SHAPES["production"]
    b, n, d, m = shape
    args = chip_smoke._gp_inputs(gen, shape)
    x, zs, u, w, os_, inv_ls, mean_w, mean_b = args
    r = b * n
    wt = torch.zeros(round_up(m, 256), round_up(m, 16), device="cuda",
                     dtype=torch.bfloat16)
    wt[:m, :m] = w.T
    mean, var = torch.empty(r, device="cuda"), torch.empty(r, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, zs, u, wt, os_, inv_ls, mean_w,
                                   mean_b, mean, var)]

    def legacy(phases):
        def run():
            err = lib.probe_legacy_bf16_fwd(*ptrs, r, d, m, phases, stream)
            if err:
                raise RuntimeError(f"legacy bf16 forward: cudaError {err}")
        return run

    with torch.inference_mode():
        want = fused_gp.whitened_marginals_affine_bf16_plain(*args)
        legacy(2)()
        torch.cuda.synchronize()
        dist = {"legacy": [(mean - want[0].reshape(-1)).abs().max().item(),
                           (var - want[1].reshape(-1)).abs().max().item()]}
        got = fused_gp.forward_kernel(*args, bf16=True)
        dist["port"] = [(g - w_).abs().max().item()
                        for g, w_ in zip(got, want)]
        whole = chip_smoke.time_ms(legacy(2), 20)
        first = chip_smoke.time_ms(legacy(1), 20)
        port = chip_smoke.time_ms(chip_smoke._fwd_runner(fused_gp, args,
                                                         True), 20)
    line = {"rows": r, "d": d, "M": m, "legacy_ms": whole,
            "legacy_phase1_ms": first, "legacy_phase2_ms": whole - first,
            "port_ms": port, "max_abs_vs_plain_mean_var": dist}
    report["bf16_fwd"] = line
    print(f"bf16 forward (rows {r}, d {d}, M {m}): the direct-difference "
          f"kernel {whole:.4f} ms = the distance, K and the mean "
          f"{first:.4f} + K W and the variance {whole - first:.4f}; the "
          f"port's forward {port:.4f} ms; max|. - plain| (mean, var): "
          f"direct difference {dist['legacy'][0]:.3e}, "
          f"{dist['legacy'][1]:.3e}; the port's {dist['port'][0]:.3e}, "
          f"{dist['port'][1]:.3e}", flush=True)


RBF_SHAPES = {"multilayer": (chip_smoke.ML_HIDDEN,
                             chip_smoke.B * (chip_smoke.ENC_LEN
                                             + chip_smoke.DEC_LEN),
                             chip_smoke.INDUCING, chip_smoke.D_MODEL),
              "served_ragged": (chip_smoke.ML_HIDDEN,
                                88 * (chip_smoke.ENC_LEN + chip_smoke.DEC_LEN),
                                chip_smoke.INDUCING, chip_smoke.D_MODEL)}


class RbfRouteA:
    """Route (a) of one draw: each GP's cross term on ``wgb::gemm_kernel``,
    x padded to whole tiles and 64 columns (split and scaled on load), zs's
    parts and both squared norms made here, outside the timed launches."""

    def __init__(self, lib, x, z, ls, os_):
        self.lib = lib
        h, m, d = z.shape
        r = x.shape[0]
        if d > 64:
            raise ValueError("route (a) probes d <= 64, one stage")
        self.r, self.m = r, m
        self.rp, self.mp = round_up(r, GT), round_up(m, GT)
        self.x = torch.zeros(self.rp, 64, device="cuda")
        self.x[:r, :d] = x
        self.inv = torch.zeros(h, 64, device="cuda")
        self.inv[:, :d] = 1.0 / ls
        xs = x[None] * self.inv[:, None, :d]
        self.x2 = torch.zeros(h, self.rp, device="cuda")
        self.x2[:, :r] = (xs * xs).sum(-1)
        zs = z * self.inv[:, None, :d]
        self.z2 = torch.zeros(h, self.mp, device="cuda")
        self.z2[:, :m] = (zs * zs).sum(-1)
        zpad = torch.zeros(h, self.mp, 64, device="cuda")
        zpad[:, :m, :d] = zs
        self.zp = [bf16_parts(zpad[g]) for g in range(h)]
        self.os = os_
        self.out = torch.empty(h, r, m, device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self):
        for g in range(self.out.shape[0]):
            err = self.lib.probe_rbf_a(
                self.x.data_ptr(), self.inv[g].data_ptr(),
                self.zp[g].data_ptr(), self.x2[g].data_ptr(),
                self.z2[g].data_ptr(), self.os[g:].data_ptr(),
                self.out[g].data_ptr(), self.r, self.m, self.rp, self.mp,
                self.stream)
            if err:
                raise RuntimeError(f"rbf route (a): cudaError {err}")
        return self.out


def rbf_routes(lib, gen, report):
    """Routes (a) and (b) for the rbf cross-covariance and the store-only
    ceiling (section ``rbf``)."""
    report["rbf"] = {"draws": DRAWS, "shapes": {}}
    for tag, (h, r, m, d) in RBF_SHAPES.items():
        dist = {"plain": 0.0, "a": 0.0, "b": 0.0}
        for i in range(DRAWS):
            x, z, ls, os_ = chip_smoke._rbf_inputs(gen, h, r, m, d)
            with torch.inference_mode():
                exact = rbf.rbf_cross_kernel_plain(
                    *(t.double() for t in (x, z, ls, os_)))
                route_a = RbfRouteA(lib, x, z, ls, os_)
                got = {"plain": rbf.rbf_cross_kernel_plain(x, z, ls, os_),
                       "a": route_a().clone(),
                       "b": rbf.forward_kernel(x, z, ls, os_)}
                for key, k in got.items():
                    dist[key] += (k.double() - exact).abs().max().item()
                del got, exact
                if i == 0:
                    launch_b = rbf.launcher()
                    out_b = torch.empty(h, r, m, device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream
                    ptrs = [t.data_ptr() for t in (x, z, ls, os_, out_b)]

                    def run_b():
                        if launch_b(*ptrs, r, m, d, h, stream):
                            raise RuntimeError("rbf launch failed")

                    def run_store():
                        if lib.probe_store_only(out_b.data_ptr(),
                                                os_.data_ptr(), h, r * m,
                                                stream):
                            raise RuntimeError("store-only launch failed")

                    ms = {"a": chip_smoke.time_ms(route_a, 20),
                          "b": chip_smoke.time_ms(run_b, 20),
                          "store_only": chip_smoke.time_ms(run_store, 20)}
                    del out_b
                del route_a
        gbytes = 4.0 * h * r * m / 1e9
        ratios = {key: dist[key] / dist["plain"] if dist["plain"] > 0
                  else math.inf for key in ("a", "b")}
        report["rbf"]["shapes"][tag] = {
            "h": h, "rows": r, "M": m, "d": d, "ms": ms,
            "store_tb_per_s": {key: gbytes / v for key, v in ms.items()},
            "dist_summed": dist, "dist_over_plain": ratios}
        print(f"rbf {tag} (h {h}, rows {r}, M {m}, d {d}; K {gbytes:.3f} "
              f"GB): (a) wgb bf16x3 {ms['a']:.4f} ms "
              f"({gbytes / ms['a']:.3f} TB/s), (b) the port's kernel "
              f"{ms['b']:.4f} ms ({gbytes / ms['b']:.3f} TB/s), stores alone "
              f"{ms['store_only']:.4f} ms ({gbytes / ms['store_only']:.3f} "
              f"TB/s); max|K - float64| summed over {DRAWS} draws: plain "
              f"{dist['plain']:.3e}, (a) {dist['a']:.3e} ({ratios['a']:.3f}x"
              f" plain's), (b) {dist['b']:.3e} ({ratios['b']:.3f}x)",
              flush=True)


SECTIONS = {"kw_dw": kw_dw, "bf16_fwd": bf16_fwd, "rbf": rbf_routes}


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
    report = {"device": smi}
    for name in opts.sections:
        SECTIONS[name](lib, gen, report)
    out = out_dir / "fused_gp_routes.json"
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
