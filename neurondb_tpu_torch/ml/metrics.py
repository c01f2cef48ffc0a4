"""Retrieval quality: recall@k, copied from ``neurondb_tpu/ml/metrics.py``
so the port needs nothing from the JAX package."""

from __future__ import annotations

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
