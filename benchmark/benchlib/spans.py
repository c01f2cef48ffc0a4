"""The program's own spans and counters
(``neurondb_tpu_torch.utils.tracing``), read after the window.

The program records them only while a profiler records, and whole for a
search that began then, so after a traced run the registry holds the
traced stretch's searches; after an untraced run it is empty. A program
without them leaves it empty too. Each reader then returns None.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def read() -> Optional[Tuple[Dict[str, Dict[str, float]], Dict[str, int]]]:
    """(spans, counters) of the program's registry, or None when it holds
    neither."""
    from neurondb_tpu_torch.utils import tracing
    spans = tracing.spans()
    counters = tracing.counters() if hasattr(tracing, "counters") else {}
    if not spans and not counters:
        return None
    return spans, counters


def per_search_ms(names, key: str, root: str) -> Optional[float]:
    """Milliseconds a search (a ``root`` span: ``ndb.ivf.search`` or
    ``ndb.hnsw.search``) of the spans ``names``' ``key`` (``"total_s"``
    or ``"self_s"``), summed over those recorded; None where none of
    them or no search was recorded."""
    got = read()
    if got is None:
        return None
    spans = got[0]
    n = spans.get(root, {}).get("count", 0)
    held = [spans[s].get(key) for s in names if s in spans]
    if n <= 0 or not held or None in held:
        return None
    return 1e3 * sum(held) / n


def ratio(num: str, den: str) -> Optional[float]:
    """Counter ``num`` over counter ``den``; None where either is missing
    or the denominator is 0."""
    got = read()
    if got is None:
        return None
    c = got[1]
    if c.get(num) is None or not c.get(den):
        return None
    return c[num] / c[den]
