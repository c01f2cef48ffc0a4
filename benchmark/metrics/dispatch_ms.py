"""dispatch_ms: host milliseconds to issue one batch, the benchmark's
span around each ``search(out="device")`` call (from the client taking
the batch to the call's return), mean over the batches of the window."""


def read(ctx):
    b = ctx.window.in_window()
    if not b:
        return None
    return 1e3 * sum(x.t_dispatched - x.t_take for x in b) / len(b)
