"""beam_device_ms: device busy milliseconds a batch (the union of the
kernels', copies' and memsets' intervals) over the traced batches."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.traced_batches
