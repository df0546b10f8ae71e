"""The card's idle share in a training run (layer: device): one less
the card's busy time a step (the union of the intervals in which a
kernel, copy or set ran, in the profiled slice, over its steps) over the
wall time a step outside the slice, in percent.  The wall time is
taken outside the slice because the profiler slows the host, not the
card."""


def read(ctx):
    r = ctx.result
    if ctx.kind != "train" or r["unprofiled_steps"] <= 0:
        return None
    busy = ctx.trace.busy_s() / r["slice_steps"]
    wall = r["unprofiled_s"] / r["unprofiled_steps"]
    return 100.0 * (1.0 - busy / wall)
