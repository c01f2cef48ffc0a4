"""beam_fresh_pct: the share of the candidate rows the beam gathers that
it evaluates for the first time, in percent: the program's counters
``hnsw.fresh`` (summed on the card) over ``hnsw.gathered`` (steps x
rows x expanded x degree), over the traced stretch."""

from benchlib import spans


def read(ctx):
    r = spans.ratio("hnsw.fresh", "hnsw.gathered")
    return None if r is None else 100.0 * r
