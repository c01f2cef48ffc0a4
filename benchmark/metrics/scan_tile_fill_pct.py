"""scan_tile_fill_pct: the share of the grouped scan's launched query
slots that hold a live (query, probe) tuple, in percent: the program's
counters ``ivf.tuples`` (B x nprobe) over ``ivf.tile_slots`` (tiles x
queries a tile) in ``_ivf_search_grouped``, over the traced stretch."""

from benchlib import spans


def read(ctx):
    r = spans.ratio("ivf.tuples", "ivf.tile_slots")
    return None if r is None else 100.0 * r
