"""ivf_issue_ms: host milliseconds an IVFFlat search spends issuing its
route, the self time of the program's span ``ndb.ivf.search``
(``IVFFlatIndex.search`` less the query upload), over the traced
stretch's searches."""

from benchlib import spans


def read(ctx):
    return spans.per_search_ms(["ndb.ivf.search"], "self_s",
                               "ndb.ivf.search")
