"""beam_issue_ms: host milliseconds a HNSW search spends issuing the
router and the beam loop, the self time of the program's span
``ndb.hnsw.beam`` (its convergence checks left out), over the traced
stretch's searches."""

from benchlib import spans


def read(ctx):
    return spans.per_search_ms(["ndb.hnsw.beam"], "self_s",
                               "ndb.hnsw.search")
