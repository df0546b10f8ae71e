"""The fused GP marginals' share of their roofline in training (layer:
kernels): the least time of each forward and backward call
(``harness/flops.py`` ``fused_gp_work``, every seed of the call), over the
device time of the kernels launched inside those ops (the forward's
registered op or autograd Function, its backward node), in percent."""

from benchmark.harness import flops

FWD = ("fgp_torch::fused_gp_fwd", "_WhitenedMarginals")
BWD = ("_WhitenedMarginalsBackward",)


def read(ctx):
    if ctx.kind != "train":
        return None
    m, sh = ctx.cfg["model"], ctx.cfg["shapes"]
    t = ctx.trace
    n_fwd, n_bwd = t.op_calls(FWD), t.op_calls(BWD)
    device = t.device_s_under(FWD + BWD)
    if n_fwd == 0 or n_bwd == 0 or device <= 0:
        return None
    rows = sh["batch"] * (sh["enc_len"] + sh["dec_len"])
    work = flops.fused_gp_work(m, rows, m["gp_compute_dtype"] == "bfloat16")
    least = ctx.n_seeds * (n_fwd * flops.least_seconds(work["fwd"])
                           + n_bwd * flops.least_seconds(work["bwd"]))
    return 100.0 * least / device
