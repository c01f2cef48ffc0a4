"""batch_p95_ms: the 95th percentile, over every batch completed within
the window, of the milliseconds from the client taking the batch to its
results in host memory. In these closed loops, which keep the card
saturated, a batch's latency is its share of the in-flight queue: the
tail swings with the host, so it is read here and not bounded."""

import numpy as np


def read(ctx):
    lat = [(b.t_done - b.t_take) * 1e3 for b in ctx.window.in_window()]
    return float(np.percentile(lat, 95)) if lat else None
