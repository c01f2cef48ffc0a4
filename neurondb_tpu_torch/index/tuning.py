"""Index auto-tuning — parameter optimization + cost-based selection.

A copy of ``neurondb_tpu/index/tuning.py`` (numpy only), kept here so
the port imports nothing from the JAX package: the same heuristics, the
same answers.

Reference: NeuronDB/src/index/index_tuning.c (m/ef_construction tuning for
HNSW, nlists for IVF, cost-based HNSW-vs-IVF choice, query-pattern
analysis) and the planner hook's auto-routing (src/planner/planner.c).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def recommend_hnsw_params(n: int, dim: int, *,
                          target_recall: float = 0.95) -> Dict[str, int]:
    """Heuristic parameter choice following the standard quality envelope
    (the reference's tuner sweeps the same knobs)."""
    if target_recall >= 0.99:
        m, efc = 32, 400
    elif target_recall >= 0.95:
        m, efc = 16, 200
    else:
        m, efc = 8, 100
    ef_search = max(32, int(2.0 * math.log2(max(n, 2)) ** 1.5))
    return {"m": m, "ef_construction": efc, "ef_search": ef_search}


def recommend_ivf_params(n: int, *, target_recall: float = 0.95
                         ) -> Dict[str, int]:
    """nlists ~= sqrt(N) (the classic rule the reference's tuner applies);
    nprobe scaled for the recall target."""
    nlists = max(16, min(65536, int(math.sqrt(max(n, 1)) * 4)))
    frac = 0.02 if target_recall >= 0.99 else \
        (0.01 if target_recall >= 0.95 else 0.005)
    nprobe = max(1, int(nlists * frac))
    return {"nlists": nlists, "nprobe": nprobe}


def select_index_kind(n: int, dim: int, *, write_heavy: bool = False,
                      memory_budget_bytes: Optional[int] = None,
                      batch_queries: bool = True) -> str:
    """Cost-based index selection (index_tuning.c role).

    - tiny corpora: exact flat scan beats any ANN overhead;
    - batched query workloads favor IVF (list-grouped scan kernel);
    - write-heavy workloads favor IVF (spill + rebuild) over HNSW;
    - tight memory favors PQ.
    """
    raw = n * dim * 4
    if memory_budget_bytes is not None and raw > memory_budget_bytes:
        return "pq"
    if n <= 20000:
        return "flat"
    if write_heavy or batch_queries:
        return "ivfflat"
    return "hnsw"


@dataclass
class QueryPatternAnalyzer:
    """Rolling query-workload statistics driving re-tuning decisions
    (the reference's query-fingerprint self-tuner, planner.c:3-11)."""

    window: int = 1000
    _ks: List[int] = field(default_factory=list)
    _batch: List[int] = field(default_factory=list)
    _lat: List[float] = field(default_factory=list)

    def observe(self, k: int, batch_size: int, latency_s: float) -> None:
        for buf, v in ((self._ks, k), (self._batch, batch_size),
                       (self._lat, latency_s)):
            buf.append(v)
            if len(buf) > self.window:
                buf.pop(0)

    def summary(self) -> Dict[str, Any]:
        if not self._ks:
            return {"observations": 0}
        return {
            "observations": len(self._ks),
            "k_p50": float(np.median(self._ks)),
            "k_max": int(np.max(self._ks)),
            "batch_p50": float(np.median(self._batch)),
            "latency_p50_ms": float(np.median(self._lat)) * 1000,
            "latency_p99_ms": float(np.percentile(self._lat, 99)) * 1000,
        }

    def suggest(self, n: int, dim: int) -> Dict[str, Any]:
        s = self.summary()
        if not s.get("observations"):
            return {"index": select_index_kind(n, dim)}
        batched = s["batch_p50"] >= 8
        kind = select_index_kind(n, dim, batch_queries=batched)
        out: Dict[str, Any] = {"index": kind}
        if kind == "hnsw":
            out.update(recommend_hnsw_params(n, dim))
        elif kind == "ivfflat":
            out.update(recommend_ivf_params(n))
        return out
