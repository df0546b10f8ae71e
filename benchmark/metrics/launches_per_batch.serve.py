"""Kernel launches a served request: every kernel on the card in the
profiled slice over its requests (layer: session)."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    return ctx.trace.launches() / ctx.result["slice_requests"]
