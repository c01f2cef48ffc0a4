"""Specialty index variants: RRI (rerank-ready) and CQ (consistent query).

Counterpart of ``neurondb_tpu/index/specialty.py``.

- RRI — NeuronDB/src/index/index_rerank.c:3-8 ("stores top-k candidate
  lists for hot queries, enabling zero round trips to heap for
  reranking"): candidate lists are batched exact GEMM top-k on the
  index's device, cached in a host dict keyed by the query bytes' hash.
  The index keeps a host copy of its vectors, so a cache hit returns ids,
  distances and the candidate vectors with no device round trip and no
  CUDA launch at all.

- CQ — NeuronDB/src/index/index_consistent.c:3-14,104-172 (snapshot
  pinning, identical results across replicas): ``pin()`` keeps references
  to the current device tensors, and ``search`` against a pinned version
  is unaffected by later adds and deletes. In torch a reference is a
  snapshot only while nothing writes into the tensor, so ``add`` builds
  new tensors (``torch.cat``) and ``delete`` selects the kept rows into
  new ones (``index_select``); nothing here writes in place into a tensor
  a pin may hold. Ties are broken on the host by ascending external id
  from a ``k + 8`` margin (distances compared as f32), so two replicas
  holding the same snapshot return byte-identical results.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.index.base import as_batch
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK


def _query_hash(q: np.ndarray) -> str:
    """Stable hash of the exact query bytes (index_rerank.c hashes the
    query literal; f32 bytes are the equivalent identity here)."""
    return hashlib.sha1(np.ascontiguousarray(q, np.float32).tobytes()
                        ).hexdigest()


class RerankReadyIndex:
    """Precomputed-candidate index (RRI).

    ``get_candidates`` returns (distances, ids, candidate_vectors) for a
    query: from the cache when the exact query was seen (or warmed), and
    from one exact device top-k otherwise. ``warm`` bulk-populates the
    cache for a batch of hot queries in a single GEMM dispatch.
    """

    kind = "rerank_ready"

    def __init__(self, vectors, *, metric: str = "l2", ids=None,
                 k: int = 32, max_cached: int = 10000, device=None):
        self.device = resolve_device(device)
        self._vecs_np = np.ascontiguousarray(
            vectors.detach().cpu().numpy() if isinstance(vectors, torch.Tensor)
            else vectors, dtype=np.float32)
        x = torch.from_numpy(self._vecs_np).to(self.device)
        self.metric = D.canonical_metric(metric)
        self.dim = int(x.shape[1])
        self.n = int(x.shape[0])
        self.k = int(k)
        self.max_cached = int(max_cached)
        self._vecs = x
        self._sqnorms = (x * x).sum(1)
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(self.n, dtype=np.int64))
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- internal: batched exact candidate lists --
    def _compute(self, q: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        cfg = get_config()
        k = min(self.k, self.n)
        d, rows = TK.chunked_knn(
            q.to(self.device), self._vecs, k, metric=self.metric,
            chunk=min(cfg.scan_chunk, max(self.n, 1)),
            base_sqnorms=self._sqnorms)
        return d.cpu().numpy(), rows.cpu().numpy()

    def warm(self, queries) -> int:
        """Precompute candidate lists for hot queries (rerank_index_warm
        parity). Returns the number of lists inserted."""
        q, _ = as_batch(queries, device=self.device)
        qn = q.cpu().numpy()
        d, rows = self._compute(q)
        added = 0
        with self._lock:
            for i in range(qn.shape[0]):
                h = _query_hash(qn[i])
                if h not in self._cache and len(self._cache) < self.max_cached:
                    self._cache[h] = (d[i], rows[i])
                    added += 1
        return added

    def get_candidates(self, query, k: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(distances, external ids, candidate vectors) for one query.
        Cache hits are pure host memory — zero device round trips
        (index_rerank.c:211-218 returns candidate_vec from the cache
        table for the same reason)."""
        qn = (query.detach().cpu().numpy() if isinstance(query, torch.Tensor)
              else np.asarray(query)).astype(np.float32).reshape(-1)
        h = _query_hash(qn)
        with self._lock:
            hit = self._cache.get(h)
        if hit is None:
            self.misses += 1
            d, rows = self._compute(torch.from_numpy(qn[None]))
            d, rows = d[0], rows[0]
            with self._lock:
                if len(self._cache) < self.max_cached:
                    self._cache[h] = (d, rows)
        else:
            self.hits += 1
            d, rows = hit
        kk = min(k or self.k, len(rows))
        rows_k = rows[:kk]
        safe = np.maximum(rows_k, 0)
        vecs = np.where((rows_k >= 0)[:, None], self._vecs_np[safe], 0.0)
        ids = np.where(rows_k >= 0, self._ids[safe], -1)
        return d[:kk], ids, vecs

    def search(self, queries, k: int = 10, **kw):
        q, single = as_batch(queries, device=self.device)
        qn = q.cpu().numpy()
        outs_d, outs_i = [], []
        for i in range(qn.shape[0]):
            d, ids, _ = self.get_candidates(qn[i], k=k)
            outs_d.append(d)
            outs_i.append(ids)
        dd, ii = np.stack(outs_d), np.stack(outs_i)
        return (dd[0], ii[0]) if single else (dd, ii)

    def stats(self) -> Dict[str, int]:
        return {"cached": len(self._cache), "hits": self.hits,
                "misses": self.misses, "k": self.k}


class ConsistentIndex:
    """Snapshot-pinned deterministic kNN (CQ semantics).

    ``pin()`` freezes the current state under a version id; ``search``
    with ``snapshot=`` that id sees exactly that state regardless of
    later mutations. Results order ties by ascending external id
    (index_consistent.c:166 ORDER BY dist ASC, ... id ASC), so replicas
    sharing a snapshot return identical (id, dist) sequences.
    """

    kind = "consistent"

    def __init__(self, vectors=None, *, dim: Optional[int] = None,
                 metric: str = "l2", ids=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.metric = D.canonical_metric(metric)
        self.seed = int(seed)            # distributed determinism seed
        if vectors is None and dim is None:
            raise ValueError("need vectors or dim")
        if vectors is not None:
            x = self._upload(vectors)
            dim = int(x.shape[1])
        else:
            x = torch.zeros((0, dim), dtype=torch.float32, device=self.device)
        self.dim = int(dim)
        self._vecs = x
        self._sqnorms = (x * x).sum(1)
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(x.shape[0], dtype=np.int64))
        self._snapshots: Dict[int, Tuple] = {}
        self._next_vid = 1

    def _upload(self, vectors) -> torch.Tensor:
        if isinstance(vectors, torch.Tensor):
            return vectors.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(vectors, np.float32),
                               device=self.device)

    @property
    def n(self) -> int:
        return int(self._vecs.shape[0])

    def add(self, vectors, ids=None) -> None:
        x = self._upload(vectors)
        start = self.n
        new_ids = (np.asarray(ids, np.int64) if ids is not None
                   else np.arange(start, start + x.shape[0], dtype=np.int64))
        # new tensors: pinned snapshots keep referencing the old ones
        self._vecs = torch.cat([self._vecs, x])
        self._sqnorms = torch.cat([self._sqnorms, (x * x).sum(1)])
        self._ids = np.concatenate([self._ids, new_ids])

    def delete(self, ids) -> int:
        mask = ~np.isin(self._ids, np.asarray(ids, np.int64))
        removed = int((~mask).sum())
        if removed:
            keep = torch.from_numpy(np.nonzero(mask)[0]).to(self.device)
            self._vecs = self._vecs.index_select(0, keep)
            self._sqnorms = self._sqnorms.index_select(0, keep)
            self._ids = self._ids[mask]
        return removed

    def pin(self) -> int:
        """Freeze the current state; returns the snapshot version id."""
        vid = self._next_vid
        self._next_vid += 1
        self._snapshots[vid] = (self._vecs, self._sqnorms, self._ids)
        return vid

    def release(self, vid: int) -> None:
        self._snapshots.pop(vid, None)

    def search(self, queries, k: int = 10, *, snapshot: Optional[int] = None,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        if snapshot is not None:
            if snapshot not in self._snapshots:
                raise KeyError(f"unknown snapshot {snapshot}")
            vecs, sqnorms, ids = self._snapshots[snapshot]
        else:
            vecs, sqnorms, ids = self._vecs, self._sqnorms, self._ids
        cfg = get_config()
        q, single = as_batch(queries, device=self.device)
        n = int(vecs.shape[0])
        kk = min(k, max(n, 1))
        # fetch a margin so host-side deterministic tie-breaking can
        # reorder equal-distance candidates by external id
        km = min(n, kk + 8) if n else 1
        d, rows = TK.chunked_knn(
            q, vecs, km, metric=self.metric,
            chunk=min(cfg.scan_chunk, max(n, 1)), base_sqnorms=sqnorms)
        d, rows = d.cpu().numpy(), rows.cpu().numpy()
        ext = np.where(rows >= 0, ids[np.maximum(rows, 0)], np.int64(2**62))
        # deterministic ordering: (dist ASC, id ASC); distances rounded
        # to f32 so replicas with different accumulation orders agree
        d32 = d.astype(np.float32)
        order = np.lexsort((ext, d32), axis=-1)[:, :kk]
        dd = np.take_along_axis(d32, order, axis=1)
        ii = np.take_along_axis(np.where(rows >= 0, ext, -1), order, axis=1)
        return (dd[0], ii[0]) if single else (dd, ii)

    def stats(self) -> Dict[str, int]:
        return {"n": self.n, "pinned": len(self._snapshots),
                "seed": self.seed}
