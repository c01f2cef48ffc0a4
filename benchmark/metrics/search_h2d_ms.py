"""search_h2d_ms: host milliseconds a search in the query upload, the
program's span ``ndb.as_batch`` (``index/base.py`` ``as_batch``: a
pageable host-to-device copy, which waits behind the card's queued
work; one a search, no child spans), mean over the traced stretch's
calls less the slowest where there are two or more: the profiler's
one-time start-up can land in the first upload (642 ms in two of five
traced HNSW runs on an NVIDIA H100, against 1-2 ms)."""

from benchlib import spans


def read(ctx):
    got = spans.read()
    if got is None:
        return None
    s = got[0].get("ndb.as_batch")
    if not s:
        return None
    if s["count"] == 1:
        return 1e3 * s["total_s"]
    return 1e3 * (s["total_s"] - s["max_s"]) / (s["count"] - 1)
