"""Kernel launches a training step: every kernel on the card in the
profiled slice over its steps (layer: trainer)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.trace.launches() / ctx.result["slice_steps"]
