"""beam_steps: loop steps a level-0 beam search runs, the program's
counter ``hnsw.steps`` over the count of its span ``ndb.hnsw.beam`` (one
a sub-batch), over the traced stretch."""

from benchlib import spans


def read(ctx):
    got = spans.read()
    if got is None:
        return None
    beams = got[0].get("ndb.hnsw.beam", {}).get("count", 0)
    steps = got[1].get("hnsw.steps")
    return None if not beams or steps is None else steps / beams
