"""search_roofline: the least time of the whole search work of the
batches completed in the window (``counts.ivf_search_work`` or
``counts.exact_work``) over the window's wall time, in percent."""

from benchlib import counts


def read(ctx):
    works = ctx.window_work("search")
    if not works:
        return None
    w = counts.add_work(works)
    wall = ctx.window.t_end - ctx.window.t_start
    return 100.0 * counts.least_seconds(w["bytes"], w["flops"])[0] / wall
