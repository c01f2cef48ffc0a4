"""Python SDK: ``Collection`` and ``Client``.

Counterpart of ``neurondb_tpu/client.py``. A ``Collection`` holds
vectors, documents and metadata on the host, and builds its index and
BM25 postings lazily on its ``device`` (default ``config.device``) over
the port's five index kinds (flat, ivfflat, hnsw, pq, ivfpq); it serves
ANN, hybrid search and stats. ``Client`` manages collections and serves
the LLM router (``llm``: ``service.llm.router_from_config``), the
embedding service (``embeddings``) and RAG pipelines (``rag()``), their
models on the client's ``device``. Its ML runtime (``train``,
``predict``, ``evaluate``) is not ported yet and raises
``NotImplementedError`` naming ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.index.flat import FlatIndex
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.index.ivfpq import IVFPQIndex
from neurondb_tpu_torch.index.pq import PQIndex
from neurondb_tpu_torch.search.bm25 import BM25Index
from neurondb_tpu_torch.search.hybrid import hybrid_search

INDEX_KINDS = {"flat": FlatIndex, "ivfflat": IVFFlatIndex,
               "hnsw": HNSWIndex, "pq": PQIndex, "ivfpq": IVFPQIndex}


class Collection:
    def __init__(self, name: str, dim: int, *, metric: str = "l2",
                 index: str = "flat", index_params: Optional[Dict] = None,
                 embedder: Optional[Callable] = None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.index_kind = index
        self.index_params = index_params or {}
        self.embedder = embedder
        self._vectors: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._docs: Dict[int, str] = {}
        self._meta: Dict[int, Dict] = {}
        self._index = None
        self._bm25 = None
        self._dirty = True
        self._lock = threading.Lock()

    # ---- data ----
    def add(self, vectors=None, *, documents: Optional[Sequence[str]] = None,
            ids=None, metadata: Optional[Sequence[Dict]] = None) -> np.ndarray:
        if vectors is None:
            if documents is None or self.embedder is None:
                raise ValueError("need vectors, or documents + an embedder")
            vectors = self.embedder(list(documents))
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        if v.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {v.shape[1]}")
        with self._lock:
            start = 0 if self._ids is None else int(self._ids.max()) + 1
            new_ids = np.asarray(ids, np.int64) if ids is not None else \
                np.arange(start, start + len(v), dtype=np.int64)
            self._vectors = v if self._vectors is None else \
                np.vstack([self._vectors, v])
            self._ids = new_ids if self._ids is None else \
                np.concatenate([self._ids, new_ids])
            if documents is not None:
                for i, doc in zip(new_ids, documents):
                    self._docs[int(i)] = doc
            if metadata is not None:
                for i, md in zip(new_ids, metadata):
                    self._meta[int(i)] = md
            self._dirty = True
        return new_ids

    def delete(self, ids) -> None:
        """Index-level delete when the live index supports it (IVF
        in-place list compaction / HNSW tombstones — hnsw_am.c bulkdelete
        parity); a full rebuild happens only for index kinds without a
        delete path."""
        with self._lock:
            drop = sorted(set(int(i) for i in np.atleast_1d(ids)))
            keep = ~np.isin(self._ids, list(drop))
            self._vectors = self._vectors[keep]
            self._ids = self._ids[keep]
            for i in drop:
                self._docs.pop(i, None)
                self._meta.pop(i, None)
            if self._index is not None and not self._dirty and \
                    hasattr(self._index, "delete"):
                self._index.delete(np.asarray(drop, np.int64))
                # always rebuild: deleting the LAST docs must clear the
                # stale postings too (_rebuild_bm25 handles empty)
                self._rebuild_bm25()
            else:
                self._dirty = True
            if not self._docs:
                # nothing can lazily rebuild an emptied collection
                # (_ensure_index raises) — drop stale postings NOW
                self._bm25 = None

    def _rebuild_bm25(self) -> None:
        ids_sorted = sorted(self._docs)
        self._bm25 = BM25Index([self._docs[i] for i in ids_sorted],
                               ids=ids_sorted, device=self.device) \
            if ids_sorted else None

    def __len__(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    # ---- index ----
    def _ensure_index(self):
        with self._lock:
            if not self._dirty and self._index is not None:
                return
            if self._vectors is None or not len(self._vectors):
                raise ValueError(f"collection {self.name!r} is empty")
            if self.index_kind not in INDEX_KINDS:
                raise ValueError(f"unknown index kind {self.index_kind!r}")
            self._index = INDEX_KINDS[self.index_kind](
                self._vectors, metric=self.metric, ids=self._ids,
                device=self.device, **self.index_params)
            # unconditional: an emptied doc set must CLEAR stale
            # postings (_rebuild_bm25 sets None when no docs remain)
            self._rebuild_bm25()
            self._dirty = False

    # ---- search surface ----
    def search(self, query=None, *, text: Optional[str] = None,
               k: int = 10, **kw) -> List[Dict]:
        self._ensure_index()
        if query is None:
            if text is None or self.embedder is None:
                raise ValueError("need a query vector, or text + embedder")
            query = np.asarray(self.embedder([text]), np.float32)[0]
        d, ids = self._index.search(np.asarray(query, np.float32), k=k, **kw)
        if d.ndim > 1:
            d, ids = d[0], ids[0]
        return [{"id": int(i), "distance": float(dd),
                 "document": self._docs.get(int(i)),
                 "metadata": self._meta.get(int(i), {})}
                for dd, i in zip(d, ids) if i >= 0]

    def hybrid_search(self, query_vec, query_text: str, *, k: int = 10,
                      weight: float = 0.5, **kw) -> List[Dict]:
        self._ensure_index()
        if self._bm25 is None:
            raise ValueError("hybrid search needs documents")
        scores, ids = hybrid_search(self._index, self._bm25,
                                    np.asarray(query_vec, np.float32),
                                    query_text, k=k, weight=weight, **kw)
        return [{"id": int(i), "score": float(s),
                 "document": self._docs.get(int(i))}
                for s, i in zip(scores, ids)]

    def stats(self) -> Dict:
        self._ensure_index()
        base = {"name": self.name, "n": len(self), "dim": self.dim,
                "metric": self.metric, "index": self.index_kind}
        if hasattr(self._index, "stats"):
            base.update(self._index.stats())
        return base


class Client:
    """Top-level handle: collections, the LLM router, the embedding
    service and RAG pipelines on ``device``; the ML runtime waits for a
    later slice of the port."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._collections: Dict[str, Collection] = {}
        self._router = None
        self._embeddings = None

    def create_collection(self, name: str, dim: int, **kw) -> Collection:
        if name in self._collections:
            raise ValueError(f"collection {name!r} exists")
        kw.setdefault("device", self.device)
        col = Collection(name, dim, **kw)
        self._collections[name] = col
        return col

    def collection(self, name: str) -> Collection:
        return self._collections[name]

    def drop_collection(self, name: str) -> None:
        self._collections.pop(name, None)

    def list_collections(self) -> List[str]:
        return sorted(self._collections)

    # ---- ML: not ported yet ----
    def train(self, project: str, algorithm: str, X, y=None,
              hyperparams: Optional[Dict] = None) -> int:
        raise NotImplementedError(_NOT_PORTED)

    def predict(self, model_id: int, X) -> np.ndarray:
        raise NotImplementedError(_NOT_PORTED)

    def evaluate(self, model_id: int, X, y=None) -> Dict:
        raise NotImplementedError(_NOT_PORTED)

    # ---- services ----
    @property
    def llm(self):
        if self._router is None:
            from neurondb_tpu_torch.service.llm import router_from_config
            self._router = router_from_config(device=self.device)
        return self._router

    @property
    def embeddings(self):
        if self._embeddings is None:
            from neurondb_tpu_torch.service.embeddings import EmbeddingService
            self._embeddings = EmbeddingService(self.llm)
        return self._embeddings

    def rag(self, *, metric: str = "cosine", chunk_size: int = 512):
        from neurondb_tpu_torch.search.rag import RAGPipeline
        return RAGPipeline(embed=lambda texts: self.embeddings.embed_batch(
            texts), metric=metric, chunk_size=chunk_size, device=self.device)


_NOT_PORTED = "the ML runtime is not ported yet (ROADMAP queue 1 item 15)"
