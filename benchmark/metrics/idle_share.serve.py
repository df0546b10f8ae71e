"""The card's idle share in a serving run (layer: device): one less
the card's busy time a request (the union of the intervals in which a
kernel, copy or set ran, in the profiled slice, over its requests) over the
wall time a request outside the slice, in percent.  The wall time is
taken outside the slice because the profiler slows the host, not the
card."""


def read(ctx):
    r = ctx.result
    if ctx.kind != "serve" or r["unprofiled_requests"] <= 0:
        return None
    busy = ctx.trace.busy_s() / r["slice_requests"]
    wall = r["unprofiled_s"] / r["unprofiled_requests"]
    return 100.0 * (1.0 - busy / wall)
