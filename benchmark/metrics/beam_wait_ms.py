"""beam_wait_ms: host milliseconds a HNSW search spends blocked on the
card and after it: the program's spans ``ndb.hnsw.check`` (the beam's
``expanded.all()`` every few steps) and ``ndb.hnsw.collect`` (the copy of
the answers to host memory and the id map), over the traced stretch's
searches."""

from benchlib import spans


def read(ctx):
    return spans.per_search_ms(["ndb.hnsw.check", "ndb.hnsw.collect"],
                               "total_s", "ndb.hnsw.search")
