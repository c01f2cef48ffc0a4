"""beam_launches: kernel launches a batch, counted in the trace over the
traced batches."""


def read(ctx):
    if ctx.trace is None or ctx.trace.launches <= 0:
        return None
    return ctx.trace.launches / ctx.traced_batches
