"""The whole training step's share of the chip's peak (layer: model step):
the model's counted operations a step (``harness/flops.py``, the forward
and backward of every seed) times the steps outside the profiled slice,
over their seconds, against the peak of the configuration's compute
dtype, in percent."""

from benchmark.harness import flops
from benchmark.harness.peaks import peak_flops


def read(ctx):
    r = ctx.result
    if ctx.kind != "train" or r["unprofiled_s"] <= 0:
        return None
    m, sh = ctx.cfg["model"], ctx.cfg["shapes"]
    per_step = ctx.n_seeds * flops.step(m, sh["batch"], sh["enc_len"],
                                        sh["dec_len"], train=True)
    rate = per_step * r["unprofiled_steps"] / r["unprofiled_s"]
    return 100.0 * rate / peak_flops(m["compute_dtype"])
