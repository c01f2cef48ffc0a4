"""Retrieval quality metrics — recall@k / precision@k / F1 / MRR / nDCG.

A copy of ``neurondb_tpu/ml/metrics.py`` (numpy only), kept here so the
port needs nothing from the JAX package. Reference:
NeuronDB/src/ml/ml_recall_metrics.c (recall_at_k:64, precision_at_k:130,
f1_at_k:190, mean_reciprocal_rank:271).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def recall_at_k(retrieved: np.ndarray, relevant: np.ndarray,
                k: int | None = None) -> float:
    """Fraction of ground-truth neighbors found in the top-k.
    retrieved/relevant: [B, >=k] id arrays (row-aligned queries)."""
    retrieved = np.asarray(retrieved)
    relevant = np.asarray(relevant)
    if k is not None:
        retrieved = retrieved[:, :k]
        relevant = relevant[:, :k]
    hits = 0
    for got, want in zip(retrieved, relevant):
        hits += len(set(got.tolist()) & set(want.tolist()))
    return hits / relevant.size


def precision_at_k(retrieved: np.ndarray, relevant_sets: Sequence[set],
                   k: int) -> float:
    """Fraction of retrieved@k that are relevant (set-valued ground truth)."""
    retrieved = np.asarray(retrieved)[:, :k]
    num = sum(len(set(got.tolist()) & rel)
              for got, rel in zip(retrieved, relevant_sets))
    return num / (len(relevant_sets) * k)


def f1_at_k(retrieved: np.ndarray, relevant_sets: Sequence[set],
            k: int) -> float:
    p = precision_at_k(retrieved, relevant_sets, k)
    r = np.mean([
        len(set(got[:k].tolist()) & rel) / max(len(rel), 1)
        for got, rel in zip(np.asarray(retrieved), relevant_sets)])
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def mean_reciprocal_rank(retrieved: np.ndarray,
                         first_relevant: np.ndarray) -> float:
    """MRR with a single relevant id per query."""
    rr = []
    for got, want in zip(np.asarray(retrieved), np.asarray(first_relevant)):
        pos = np.nonzero(got == want)[0]
        rr.append(1.0 / (pos[0] + 1) if len(pos) else 0.0)
    return float(np.mean(rr))


def ndcg_at_k(retrieved: np.ndarray, gains: Sequence[dict], k: int) -> float:
    """nDCG@k with graded relevance: gains[i] maps id -> gain for query i."""
    scores = []
    for got, g in zip(np.asarray(retrieved), gains):
        dcg = sum(g.get(int(d), 0.0) / np.log2(j + 2)
                  for j, d in enumerate(got[:k]))
        ideal = sorted(g.values(), reverse=True)[:k]
        idcg = sum(v / np.log2(j + 2) for j, v in enumerate(ideal))
        scores.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(scores))
