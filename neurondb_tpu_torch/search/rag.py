"""RAG pipeline: chunk -> embed -> index -> retrieve.

Counterpart of ``neurondb_tpu/search/rag.py``. ``chunk_text`` slides a
character window (or packs whole sentences); ``RAGPipeline`` embeds the
chunks with any callable ``embed(texts) -> [N, D]`` (``Client.rag``
passes the embedding service's), indexes them in the port's
``FlatIndex`` and ``BM25Index`` on ``device`` (default
``config.device``), and retrieves through ``hybrid_search`` or the dense
index alone.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from neurondb_tpu_torch.index.flat import FlatIndex
from neurondb_tpu_torch.search.bm25 import BM25Index
from neurondb_tpu_torch.search.hybrid import hybrid_search

_SENT = re.compile(r"(?<=[.!?])\s+")


def chunk_text(text: str, *, chunk_size: int = 512, overlap: int = 64,
               by: str = "chars") -> List[str]:
    """Split text into overlapping chunks (neurondb_chunk_text parity).
    by="chars" slides a window; by="sentences" packs whole sentences."""
    if by == "sentences":
        sents = [s.strip() for s in _SENT.split(text) if s.strip()]
        chunks, cur = [], ""
        for s in sents:
            if cur and len(cur) + 1 + len(s) > chunk_size:
                chunks.append(cur)
                cur = (cur[-overlap:] + " " if overlap else "") + s
            else:
                cur = (cur + " " + s).strip()
        if cur:
            chunks.append(cur)
        return chunks
    step = max(chunk_size - overlap, 1)
    out = [text[i:i + chunk_size] for i in range(0, max(len(text), 1), step)]
    return [c for c in out if c.strip()] or [""]


@dataclass
class RAGPipeline:
    """End-to-end retrieval pipeline over a document set."""

    embed: Callable[[Sequence[str]], np.ndarray]
    metric: str = "cosine"
    chunk_size: int = 512
    overlap: int = 64
    device: Optional[str] = None
    docs: List[str] = field(default_factory=list)
    build_seconds: Dict[str, float] = field(default_factory=dict)
    chunks: List[str] = field(default_factory=list)
    chunk_doc: List[int] = field(default_factory=list)
    _index = None
    _bm25 = None

    def add_documents(self, docs: Sequence[str]) -> None:
        """Chunk, embed and index; ``build_seconds`` holds each stage's
        wall seconds (chunk, embed, index, bm25)."""
        t0 = time.perf_counter()
        base = len(self.docs)
        self.docs.extend(docs)
        for di, doc in enumerate(docs, start=base):
            cs = chunk_text(doc, chunk_size=self.chunk_size,
                            overlap=self.overlap)
            self.chunks.extend(cs)
            self.chunk_doc.extend([di] * len(cs))
        self.build_seconds = {"chunk": time.perf_counter() - t0}
        self._rebuild()

    def _rebuild(self) -> None:
        t0 = time.perf_counter()
        embs = np.asarray(self.embed(self.chunks), np.float32)
        t1 = time.perf_counter()
        self._index = FlatIndex(embs, metric=self.metric, device=self.device)
        t2 = time.perf_counter()
        self._bm25 = BM25Index(self.chunks, device=self.device)
        self.build_seconds.update(embed=t1 - t0, index=t2 - t1,
                                  bm25=time.perf_counter() - t2)

    def retrieve(self, query: str, k: int = 5, *, hybrid: bool = True,
                 weight: float = 0.5) -> List[Dict]:
        """Top-k chunks (neurondb_rank_documents parity). Returns dicts with
        chunk text, source doc id and score."""
        qv = np.asarray(self.embed([query]), np.float32)[0]
        if hybrid and self._bm25 is not None:
            scores, ids = hybrid_search(self._index, self._bm25, qv, query,
                                        k=k, weight=weight)
        else:
            d, ids = self._index.search(qv, k=k)
            scores = 1.0 - d
        return [{"chunk": self.chunks[int(i)], "doc_id": self.chunk_doc[int(i)],
                 "chunk_id": int(i), "score": float(s)}
                for s, i in zip(scores, ids) if i >= 0]

    def context(self, query: str, k: int = 5, sep: str = "\n\n") -> str:
        """Concatenated context string for prompt assembly."""
        return sep.join(r["chunk"] for r in self.retrieve(query, k))
