"""beam_kernel_pct: the share of the rows entering a level-0 beam search
that the hand-written beam kernel served, in percent: the program's
counters ``hnsw.kernel_rows`` over ``hnsw.rows``, over the traced
stretch. A program without them reads None."""

from benchlib import spans


def read(ctx):
    r = spans.ratio("hnsw.kernel_rows", "hnsw.rows")
    return None if r is None else 100.0 * r
