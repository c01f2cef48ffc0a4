"""Sparse retrieval: an inverted index over learned sparse vectors, and
its fusion with dense kNN.

Counterpart of ``neurondb_tpu/search/sparse_search.py``: term-at-a-time
accumulation over CSR postings on the host, fused against a dense
index's results by a weighted sum or RRF.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from neurondb_tpu_torch.types.sparse import SparseVectors


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


class SparseInvertedIndex:
    """CSR inverted index over a corpus of sparse vectors (dim-indexed)."""

    def __init__(self, sp: SparseVectors, ids: Optional[Sequence[int]] = None):
        self.dim = sp.dim
        idx = _host(sp.indices)
        val = _host(sp.values)
        n = idx.shape[0]
        self.n_docs = n
        self.ids = np.asarray(ids if ids is not None else range(n), np.int64)
        mask = idx >= 0
        flat_dim = idx[mask]
        flat_doc = np.repeat(np.arange(n, dtype=np.int32), mask.sum(1))
        flat_val = val[mask].astype(np.float32)
        order = np.argsort(flat_dim, kind="stable")
        self._dims = flat_dim[order]
        self._docs = flat_doc[order]
        self._vals = flat_val[order]
        counts = np.bincount(self._dims, minlength=self.dim)
        self._offsets = np.zeros(self.dim + 1, np.int64)
        np.cumsum(counts, out=self._offsets[1:])

    def scores(self, q_indices, q_values) -> np.ndarray:
        """Dense [n_docs] dot-product scores for one sparse query."""
        out = np.zeros(self.n_docs, np.float32)
        for d, v in zip(_host(q_indices).ravel(), _host(q_values).ravel()):
            if d < 0 or d >= self.dim or v == 0:
                continue
            s, e = self._offsets[d], self._offsets[d + 1]
            out[self._docs[s:e]] += v * self._vals[s:e]
        return out

    def search(self, query: SparseVectors, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        s = self.scores(_host(query.indices)[0], _host(query.values)[0])
        k = min(k, self.n_docs)
        rows = np.argpartition(-s, k - 1)[:k] if k < self.n_docs else \
            np.arange(self.n_docs)
        rows = rows[np.argsort(-s[rows], kind="stable")]
        return s[rows], self.ids[rows]


def dense_sparse_fusion(dense_index, sparse_index: SparseInvertedIndex,
                        query_vec, query_sparse: SparseVectors, *,
                        k: int = 10, weight: float = 0.5,
                        candidates: int = 100,
                        method: str = "weighted"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse dense kNN with sparse retrieval. ``method="weighted"``: the
    normalized score sum; ``"rrf"``: rank fusion."""
    dd, dids = dense_index.search(np.asarray(query_vec, np.float32),
                                  k=candidates)
    if dd.ndim > 1:
        dd, dids = dd[0], dids[0]
    ok = dids >= 0
    dd, dids = dd[ok], dids[ok]
    ss, sids = sparse_index.search(query_sparse, k=candidates)
    if method == "rrf":
        from neurondb_tpu_torch.search.hybrid import reciprocal_rank_fusion
        return reciprocal_rank_fusion([dids, sids], k=k)
    dnorm = 1.0 - (dd - dd.min()) / max(dd.max() - dd.min(), 1e-9)
    snorm = (ss - ss.min()) / max(ss.max() - ss.min(), 1e-9) \
        if len(ss) else ss
    pool: Dict[int, float] = {}
    for v, i in zip(dnorm, dids):
        pool[int(i)] = pool.get(int(i), 0.0) + weight * float(v)
    for v, i in zip(snorm, sids):
        pool[int(i)] = pool.get(int(i), 0.0) + (1 - weight) * float(v)
    items = sorted(pool.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return (np.asarray([s for _, s in items], np.float32),
            np.asarray([i for i, _ in items], np.int64))
