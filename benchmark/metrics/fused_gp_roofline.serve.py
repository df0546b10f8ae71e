"""The fused GP marginals' share of their roofline in serving (layer:
kernels): the least time of each forward call (``harness/flops.py``
``fused_gp_work``) over the device time of the kernels launched inside the
registered op, in percent."""

from benchmark.harness import flops

FWD = ("fgp_torch::fused_gp_fwd", "_WhitenedMarginals")


def read(ctx):
    if ctx.kind != "serve":
        return None
    m, sh = ctx.cfg["model"], ctx.cfg["shapes"]
    t = ctx.trace
    calls = t.op_calls(FWD)
    device = t.device_s_under(FWD)
    if calls == 0 or device <= 0:
        return None
    rows = sh["batch"] * (sh["enc_len"] + sh["dec_len"])
    work = flops.fused_gp_work(m, rows, m["gp_compute_dtype"] == "bfloat16")
    return 100.0 * calls * flops.least_seconds(work["fwd"]) / device
