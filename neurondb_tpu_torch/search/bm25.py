"""BM25's text normalisation: ``tokenize``, ``STOPWORDS`` and the light
stemmer of ``neurondb_tpu/search/bm25.py``.

Only these for now: ``HashTokenizer`` (``ml/transformer.py``) tokenizes
with them. ``BM25Index`` and its scorers wait for the BM25/hybrid slice.
"""

from __future__ import annotations

import re
from typing import List

_TOKEN = re.compile(r"[a-z0-9]+")

# Minimal English stopword set (parity with to_tsvector's simple config).
STOPWORDS = frozenset("""a an and are as at be by for from has he in is it its
of on that the to was were will with this these those i you your we they them
or not no but if then so do does did been being have had""".split())


def tokenize(text: str, *, stem: bool = True,
             stopwords: bool = True) -> List[str]:
    toks = _TOKEN.findall(text.lower())
    if stopwords:
        toks = [t for t in toks if t not in STOPWORDS]
    if stem:
        toks = [_light_stem(t) for t in toks]
    return toks


def _light_stem(t: str) -> str:
    """Cheap suffix stripper (stand-in for the snowball stemmer PG uses)."""
    for suf in ("ingly", "edly", "ing", "ies", "ied", "ers", "est",
                "ed", "es", "ly", "s"):
        if t.endswith(suf) and len(t) - len(suf) >= 3:
            if suf == "ies" or suf == "ied":
                return t[: -3] + "y"
            return t[: -len(suf)]
    return t
