"""Per-query planner: ANN-vs-FTS routing with query-fingerprint
self-tuning.

Counterpart of ``neurondb_tpu/search/planner.py``, the same policy:
- vector-only query -> ANN; text-only query -> FTS;
- both: rare, selective terms (high idf mass) pull toward FTS-heavy
  fusion, generic text toward ANN-heavy fusion.
Per fingerprint, observed latency above the SLO shrinks the precision
knobs (ef / nprobe) by 20% and a result shortfall grows them by 20%.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from neurondb_tpu_torch.search.bm25 import tokenize


@dataclass
class QueryPlan:
    mode: str                  # "ann" | "fts" | "hybrid"
    weight: float              # fusion weight toward the vector side
    ef: int                    # HNSW precision knob
    nprobe: int                # IVF precision knob
    fingerprint: str = ""
    reason: str = ""


@dataclass
class _FingerprintStats:
    calls: int = 0
    ef: int = 64
    nprobe: int = 10
    lat_ewma: float = 0.0
    misses: int = 0


class QueryPlanner:
    def __init__(self, *, latency_slo_ms: float = 50.0,
                 ef_bounds=(16, 512), nprobe_bounds=(1, 256)):
        self.latency_slo_ms = latency_slo_ms
        self.ef_bounds = ef_bounds
        self.nprobe_bounds = nprobe_bounds
        self._stats: Dict[str, _FingerprintStats] = {}
        self._lock = threading.Lock()

    # ---- fingerprinting ----
    @staticmethod
    def fingerprint(text: Optional[str], has_vector: bool,
                    k: int) -> str:
        """Shape-of-query hash: term-count bucket + k bucket + modality.
        Two queries with the same fingerprint share tuned parameters."""
        nterms = len(text.split()) if text else 0
        tb = 0 if nterms == 0 else 1 if nterms <= 2 else 2 if nterms <= 6 \
            else 3
        kb = 0 if k <= 10 else 1 if k <= 100 else 2
        raw = f"{int(has_vector)}|{tb}|{kb}"
        return hashlib.sha1(raw.encode()).hexdigest()[:12]

    # ---- routing ----
    def plan(self, *, text: Optional[str] = None, has_vector: bool = False,
             k: int = 10, bm25=None) -> QueryPlan:
        fp = self.fingerprint(text, has_vector, k)
        with self._lock:
            st = self._stats.setdefault(fp, _FingerprintStats())
        if has_vector and not text:
            return QueryPlan("ann", 1.0, st.ef, st.nprobe, fp,
                             "vector-only")
        if text and not has_vector:
            return QueryPlan("fts", 0.0, st.ef, st.nprobe, fp,
                             "text-only")
        # both sides present: selectivity from the corpus statistics
        sel = self._text_selectivity(text, bm25)
        if sel >= 0.75:
            return QueryPlan("hybrid", 0.3, st.ef, st.nprobe, fp,
                             f"selective terms (idf mass {sel:.2f}) -> "
                             "FTS-heavy fusion")
        if sel <= 0.25:
            return QueryPlan("hybrid", 0.8, st.ef, st.nprobe, fp,
                             f"generic terms (idf mass {sel:.2f}) -> "
                             "ANN-heavy fusion")
        return QueryPlan("hybrid", 0.5, st.ef, st.nprobe, fp,
                         "balanced fusion")

    @staticmethod
    def _text_selectivity(text: str, bm25) -> float:
        """Mean normalized IDF of the query terms: 1.0 = every term is
        rare (selective), 0.0 = every term is ubiquitous."""
        if bm25 is None or not len(getattr(bm25, "idf", ())):
            return 0.5
        idf_max = float(bm25.idf.max()) or 1.0
        vals = []
        for t in tokenize(text):
            ti = bm25._term_index(t)
            if ti is not None:
                vals.append(float(bm25.idf[ti]) / idf_max)
        return float(np.mean(vals)) if vals else 0.5

    # ---- feedback / self-tuning ----
    def observe(self, plan: QueryPlan, *, latency_ms: float,
                shortfall: bool = False) -> None:
        """Record an execution: latency over the SLO shrinks precision
        20%, a result shortfall (fewer than k hits / user-flagged low
        quality) grows it 20% (worker_tuner.c envelope)."""
        with self._lock:
            st = self._stats.setdefault(plan.fingerprint,
                                        _FingerprintStats())
            st.calls += 1
            st.lat_ewma = latency_ms if st.calls == 1 else \
                0.8 * st.lat_ewma + 0.2 * latency_ms
            lo_e, hi_e = self.ef_bounds
            lo_p, hi_p = self.nprobe_bounds
            if shortfall:
                st.misses += 1
                st.ef = min(hi_e, int(st.ef * 1.2) + 1)
                st.nprobe = min(hi_p, int(st.nprobe * 1.2) + 1)
            elif st.lat_ewma > self.latency_slo_ms:
                st.ef = max(lo_e, int(st.ef * 0.8))
                st.nprobe = max(lo_p, int(st.nprobe * 0.8))

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {fp: {"calls": s.calls, "ef": s.ef,
                         "nprobe": s.nprobe,
                         "lat_ewma_ms": round(s.lat_ewma, 3),
                         "misses": s.misses}
                    for fp, s in self._stats.items()}


def planned_search(collection, planner: QueryPlanner, *,
                   vector=None, text: Optional[str] = None,
                   k: int = 10) -> Dict[str, Any]:
    """Execute a query through the planner against a client Collection:
    routes to ANN / FTS / hybrid, applies the tuned precision knobs, and
    feeds latency back. Returns {"plan", "results"}."""
    plan = planner.plan(text=text, has_vector=vector is not None, k=k,
                        bm25=getattr(collection, "_bm25", None))
    t0 = time.time()
    if plan.mode == "ann":
        res = collection.search(vector, k=k)
    elif plan.mode == "fts":
        collection._ensure_index()
        if getattr(collection, "_bm25", None) is None:
            # vectors-only collection: no postings to rank — fall back
            # to ANN when a vector exists, else empty result
            res = (collection.search(vector, k=k)
                   if vector is not None else [])
        else:
            s, ids = collection._bm25.search(text, k=k)
            res = [{"id": int(i), "score": float(v)}
                   for v, i in zip(s, ids)]
    else:
        res = collection.hybrid_search(vector, text, k=k,
                                       weight=plan.weight)
    latency_ms = (time.time() - t0) * 1e3
    planner.observe(plan, latency_ms=latency_ms,
                    shortfall=len(res) < k)
    return {"plan": plan, "results": res}
