"""beam_roofline: the least time of the rows a beam search evaluates for
the first time, over the device's busy time a batch in the traced
stretch, in percent. The work (``counts.least_seconds``): each fresh row
(the program's counter ``hnsw.fresh``, a search: over the count of
``ndb.hnsw.search``) read once from the store with its f32 norm, and
2 x dim operations at the configuration's rate. It counts the rows the
walk needed, so a change to the walk changes the yardstick; each batch
is one search call."""

import torch

from benchlib import counts, spans


def read(ctx):
    got = spans.read()
    if got is None or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    n = got[0].get("ndb.hnsw.search", {}).get("count", 0)
    fresh = got[1].get("hnsw.fresh")
    if not n or not fresh:
        return None
    cfg = ctx.config
    dim = int(cfg["corpus"]["dim"])
    sb = torch.empty((), dtype=getattr(torch, cfg["store_dtype"])) \
        .element_size()
    rows = fresh / n
    least = counts.least_seconds(rows * (dim * sb + 4),
                                 {cfg["precision"]["scan_products"]:
                                  rows * 2.0 * dim})[0]
    return 100.0 * least / (ctx.trace.busy_s / ctx.traced_batches)
