"""device_idle_pct: the share of the traced stretch in which the card
runs no kernel, copy or memset, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
