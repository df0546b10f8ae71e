"""The whole served forward's share of the chip's peak (layer: model
step): the model's counted forward operations a request times the requests
outside the profiled slice, over their seconds, against the peak of the
configuration's compute dtype, in percent."""

from benchmark.harness import flops
from benchmark.harness.peaks import peak_flops


def read(ctx):
    r = ctx.result
    if ctx.kind != "serve" or r["unprofiled_s"] <= 0:
        return None
    m, sh = ctx.cfg["model"], ctx.cfg["shapes"]
    per = flops.step(m, sh["batch"], sh["enc_len"], sh["dec_len"],
                     train=False)
    rate = per * r["unprofiled_requests"] / r["unprofiled_s"]
    return 100.0 * rate / peak_flops(m["compute_dtype"])
