"""Reranking: cross-encoder, flash (long context), ColBERT, LTR, ensemble
and LLM-as-judge.

Counterpart of ``neurondb_tpu/search/rerank.py``. The cross-encoder path
scores (query, doc) pairs with a scorer from ``ml/transformer.py``
(``CrossEncoder``, ``PretrainedCrossEncoder``), whose attention runs the
hand-written flash-attention kernel on a card; any callable
``scorer(query: str, docs: list[str]) -> np.ndarray`` works. The other
rerankers are host numpy, as in the JAX package; ``train_ltr`` fits its
ridge weights with the port's ``ml/linear.py`` on ``config.device``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def _order(scores: np.ndarray, k: Optional[int]
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(scores descending, positions), stable, cut to k."""
    order = np.argsort(-scores, kind="stable")
    if k is not None:
        order = order[:k]
    return scores[order], order


def rerank_cross_encoder(query: str, docs: Sequence[str],
                         scorer: Callable[[str, Sequence[str]], np.ndarray],
                         k: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Score each (query, doc) pair with a cross-encoder; return
    (scores desc, doc positions)."""
    return _order(np.asarray(scorer(query, docs), np.float32), k)


def rerank_flash(query: str, docs: Sequence[str], scorer,
                 k: Optional[int] = None):
    """Long-context cross-encoder rerank: the same API; the O(S)-memory
    tiled attention lives in the scorer's kernel."""
    return rerank_cross_encoder(query, docs, scorer, k)


def rerank_colbert(query_tokens: np.ndarray, doc_tokens: Sequence[np.ndarray],
                   k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """ColBERT late interaction: score(d) = sum_i max_j cos(q_i, d_j) over
    query token embeddings [Tq, D] and per-doc token embeddings [Td, D]."""
    q = np.asarray(query_tokens, np.float32)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    scores = np.zeros(len(doc_tokens), np.float32)
    for i, dt in enumerate(doc_tokens):
        d = np.asarray(dt, np.float32)
        dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
        scores[i] = (qn @ dn.T).max(axis=1).sum()
    return _order(scores, k)


def rerank_ltr(features: np.ndarray, weights: np.ndarray,
               k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pointwise learning-to-rank: a linear score over per-candidate
    feature vectors [N, F]."""
    f = np.asarray(features, np.float32)
    w = np.asarray(weights, np.float32)
    return _order(f @ w, k)


def train_ltr(features: np.ndarray, relevance: np.ndarray,
              l2: float = 1e-3, *, device=None) -> np.ndarray:
    """Fit pointwise LTR weights by ridge regression on graded relevance
    (ml_ltr.c:239 train path), on ``device`` (default
    ``config.device``)."""
    from neurondb_tpu_torch.ml.api import as_input
    from neurondb_tpu_torch.ml.linear import linear_regression_fit
    from neurondb_tpu_torch.config import resolve_device
    dev = resolve_device(device)
    model = linear_regression_fit(as_input(features, dev),
                                  as_input(relevance, dev), l2=l2,
                                  fit_intercept=False)
    return model["coef"].cpu().numpy()


def rerank_ensemble(rankings: Sequence[Tuple[np.ndarray, np.ndarray]],
                    weights: Optional[Sequence[float]] = None,
                    k: Optional[int] = None, *, method: str = "weighted"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Ensemble rerank over (scores, ids) rankings. ``method``:
    "weighted" (min-max normalise each ranking, weighted sum) or "borda"
    (positional Borda count)."""
    weights = list(weights) if weights is not None else [1.0] * len(rankings)
    agg: Dict[int, float] = {}
    for (scores, ids), w in zip(rankings, weights):
        scores = np.asarray(scores, np.float32)
        ids = np.asarray(ids)
        if method == "borda":
            n = len(ids)
            for pos, i in enumerate(ids):
                agg[int(i)] = agg.get(int(i), 0.0) + w * (n - pos)
        else:
            lo, hi = scores.min(), scores.max()
            norm = (scores - lo) / (hi - lo) if hi > lo else np.ones_like(scores)
            for s, i in zip(norm, ids):
                agg[int(i)] = agg.get(int(i), 0.0) + w * float(s)
    items = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
    if k is not None:
        items = items[:k]
    return (np.asarray([s for _, s in items], np.float32),
            np.asarray([i for i, _ in items], np.int64))


def rerank_llm(query: str, docs: Sequence[str], llm_client,
               k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """LLM-as-judge rerank: ``llm_client.rerank(query, docs)`` scores each
    document's relevance."""
    return _order(np.asarray(llm_client.rerank(query, list(docs)),
                             np.float32), k)
