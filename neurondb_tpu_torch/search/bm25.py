"""BM25 full-text scoring: the FTS half of hybrid search.

Counterpart of ``neurondb_tpu/search/bm25.py``: the same tokenizer,
stopwords and light stemmer, the same CSR postings (term-major, docs
ascending within a term), the same Robertson idf and Okapi weights.
Small corpora build through the Python tokenizer; from
``NATIVE_THRESHOLD`` documents on, through ``tokenize_corpus``: FNV-1a
hashes of the runs of ASCII alphanumerics of each document's UTF-8
bytes, lower-cased and cut at 48 bytes (the byte semantics of the JAX
package's native tokenizer, vectorised with numpy).

``scores`` (one query, host numpy) is the oracle. ``scores_batch`` scores
a batch on the index's device: one gather-add per term slot, each
query's terms in the oracle's order, over per-posting weights computed
in numpy with the oracle's own expression. Within a slot every (query,
document) pair is distinct, so each add is the oracle's ``out[rows] +=
w`` and the batch scores equal the oracle's bit for bit.

Deliberate divergences from the JAX package's device scorers:
- one exact f32 scorer at every size: no bf16 heavy tier (the JAX
  package's rows are bf16 from 500k documents), no scatter mode and no
  ``seg_cap`` truncation; ``config.bm25_scorer`` must be ``"tiled"``
  (its default), served by this scorer;
- no batch-wide ``union_cap``: nothing is dropped beyond ``term_cap``;
- the hashed build runs at >= ``NATIVE_THRESHOLD`` documents always (the
  JAX package takes its Python build when its native library is absent);
- the ``[B, n_docs]`` score matrix is split into sub-batches by
  ``score_budget_bytes`` of f32 on the card.
"""

from __future__ import annotations

import re
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.ops.topk import topk_largest

_TOKEN = re.compile(r"[a-z0-9]+")

# Minimal English stopword set (parity with to_tsvector's simple config).
STOPWORDS = frozenset("""a an and are as at be by for from has he in is it its
of on that the to was were will with this these those i you your we they them
or not no but if then so do does did been being have had""".split())

FNV_OFFSET = 1469598103934665603
FNV_PRIME = 1099511628211
MAX_TOKEN_BYTES = 48
_ALNUM = np.zeros(256, bool)
for _lo, _hi in ((48, 58), (65, 91), (97, 123)):
    _ALNUM[_lo:_hi] = True
_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[65:91] += 32


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


def fnv1a(s: bytes) -> int:
    h = FNV_OFFSET
    for b in s:
        h = ((h ^ b) * FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def tokenize_corpus(docs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Documents -> (doc_ids int32 [T], token hashes uint64 [T]), tokens
    in document order: each run of ASCII alphanumeric bytes of the
    document's UTF-8 encoding (undecodable characters dropped), ASCII
    lower-cased, its first 48 bytes hashed with 64-bit FNV-1a."""
    blobs = [d.encode("utf-8", "ignore") for d in docs]
    text = np.frombuffer(b"".join(blobs), np.uint8)
    offs = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offs[1:])
    alnum = _ALNUM[text]
    # a run starts where the previous byte is no alphanumeric of its doc
    prev = np.concatenate([[False], alnum[:-1]])
    nxt = np.concatenate([alnum[1:], [False]])
    nonempty = offs[:-1] < offs[1:]
    prev[offs[:-1][nonempty]] = False
    nxt[offs[1:][nonempty] - 1] = False
    starts = np.flatnonzero(alnum & ~prev)
    ends = np.flatnonzero(alnum & ~nxt) + 1
    take = np.minimum(ends - starts, MAX_TOKEN_BYTES)
    doc_ids = (np.searchsorted(offs, starts, side="right") - 1).astype(np.int32)
    low = _LOWER[text].astype(np.uint64)
    h = np.full(len(starts), FNV_OFFSET, np.uint64)
    prime = np.uint64(FNV_PRIME)
    for j in range(int(take.max()) if len(take) else 0):
        m = np.flatnonzero(take > j)
        h[m] = (h[m] ^ low[starts[m] + j]) * prime      # wraps mod 2**64
    return doc_ids, h


class BM25Index:
    """Okapi BM25 inverted index over a document corpus, its postings
    scored on ``device`` (default ``config.device``)."""

    NATIVE_THRESHOLD = 5000  # docs
    #: f32 bytes of one [b, n_docs] score sub-batch on the device
    score_budget_bytes = 2 << 30

    def __init__(self, docs: Sequence[str], *, k1: float = 1.2,
                 b: float = 0.75, ids: Optional[Sequence[int]] = None,
                 use_native: Optional[bool] = None,
                 prune_idf_below: float = 0.01, device=None):
        """``use_native`` picks the hashed build (the JAX package's
        native route); by default it is taken at >= NATIVE_THRESHOLD
        documents. Terms with idf < ``prune_idf_below`` are skipped by
        every scorer alike."""
        self.device = resolve_device(device)
        self.k1 = k1
        self.b = b
        self.prune_idf_below = prune_idf_below
        self.term_cap = 64        # batch-scoring terms per query
        self.n_docs = len(docs)
        self.ids = np.asarray(ids if ids is not None else range(len(docs)),
                              np.int64)
        self._vocab: Dict[str, int] = {}
        self._hash_vocab: Optional[Dict[int, int]] = None
        self._dev = None
        self.build_seconds: Dict[str, float] = {}   # hashed build's phases
        if use_native is None:
            use_native = len(docs) >= self.NATIVE_THRESHOLD
        if use_native:
            self._build_hashed(docs)
        else:
            self._build_python(docs)

    def _build_python(self, docs: Sequence[str]) -> None:
        doc_terms: List[Counter] = []
        lengths = np.zeros(len(docs), np.float32)
        for i, doc in enumerate(docs):
            toks = tokenize(doc)
            lengths[i] = len(toks)
            c = Counter(toks)
            doc_terms.append(c)
            for t in c:
                if t not in self._vocab:
                    self._vocab[t] = len(self._vocab)
        self.doc_len = lengths
        self.avg_len = float(lengths.mean()) if len(docs) else 0.0
        nv = len(self._vocab)
        counts = np.zeros(nv, np.int64)
        for c in doc_terms:
            for t in c:
                counts[self._vocab[t]] += 1
        self.df = counts.astype(np.float32)
        offsets = np.zeros(nv + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        self._post_doc = np.zeros(offsets[-1], np.int32)
        self._post_tf = np.zeros(offsets[-1], np.float32)
        cursor = offsets[:-1].copy()
        for i, c in enumerate(doc_terms):
            for t, tf in c.items():
                ti = self._vocab[t]
                self._post_doc[cursor[ti]] = i
                self._post_tf[cursor[ti]] = tf
                cursor[ti] += 1
        self._offsets = offsets
        self._finish_idf()

    def _build_hashed(self, docs: Sequence[str]) -> None:
        """Vectorised postings from the (doc_id, hash) token stream."""
        t0 = time.perf_counter()
        doc_ids, hashes = tokenize_corpus(docs)
        t1 = time.perf_counter()
        self.doc_len = np.bincount(doc_ids, minlength=self.n_docs
                                   ).astype(np.float32)
        self.avg_len = float(self.doc_len.mean()) if self.n_docs else 0.0
        uniq_h, term_of = np.unique(hashes, return_inverse=True)
        self._hash_vocab = {int(h): i for i, h in enumerate(uniq_h)}
        key = term_of.astype(np.int64) * self.n_docs + doc_ids
        uk, tf = np.unique(key, return_counts=True)
        post_term = (uk // self.n_docs).astype(np.int64)
        self._post_doc = (uk % self.n_docs).astype(np.int32)
        self._post_tf = tf.astype(np.float32)
        nv = len(uniq_h)
        counts = np.bincount(post_term, minlength=nv)
        self.df = counts.astype(np.float32)
        offsets = np.zeros(nv + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        self._offsets = offsets   # post arrays already term-sorted by key
        self._finish_idf()
        self.build_seconds = {"tokenize": t1 - t0,
                              "postings": time.perf_counter() - t1}

    def _finish_idf(self) -> None:
        self.idf = np.maximum(
            np.log((self.n_docs - self.df + 0.5) / (self.df + 0.5) + 1.0),
            0.0)

    def _term_index(self, token: str) -> Optional[int]:
        if self._hash_vocab is not None:
            toks = _TOKEN.findall(token.lower())
            if not toks:
                return None
            return self._hash_vocab.get(
                fnv1a(toks[0].encode()[:MAX_TOKEN_BYTES]))
        return self._vocab.get(token)

    def _query_terms(self, query: str) -> List[int]:
        """The query's scoreable term indices in query order (repeats
        kept): the terms the oracle accumulates, in its order."""
        q_terms = (_TOKEN.findall(query.lower())
                   if self._hash_vocab is not None else tokenize(query))
        out = []
        for t in q_terms:
            ti = self._term_index(t)
            if ti is not None and self.idf[ti] >= self.prune_idf_below:
                out.append(int(ti))
        return out

    def _norm(self) -> np.ndarray:
        return 1.0 - self.b + self.b * self.doc_len / max(self.avg_len, 1e-9)

    def scores(self, query: str) -> np.ndarray:
        """Dense [n_docs] BM25 scores (term-at-a-time accumulation)."""
        out = np.zeros(self.n_docs, np.float32)
        norm = self._norm()
        for ti in self._query_terms(query):
            s, e = self._offsets[ti], self._offsets[ti + 1]
            rows = self._post_doc[s:e]
            tf = self._post_tf[s:e]
            out[rows] += self.idf[ti] * tf * (self.k1 + 1.0) / (
                tf + self.k1 * norm[rows])
        return out

    def capped_terms(self, query: str) -> List[int]:
        """``_query_terms`` cut to the ``term_cap`` highest-idf slots
        (the first of equal idf kept), in query order: what
        ``scores_batch`` accumulates."""
        tis = self._query_terms(query)
        if len(tis) > self.term_cap:
            keep = sorted(range(len(tis)),
                          key=lambda i: -float(self.idf[tis[i]]))
            tis = [tis[i] for i in sorted(keep[: self.term_cap])]
        return tis

    def _ensure_device(self):
        """Postings and their weights on the device. Each weight is the
        oracle's expression evaluated in numpy f32."""
        if self._dev is None:
            norm = self._norm()
            term_of = np.repeat(np.arange(len(self.df)),
                                np.diff(self._offsets))
            tf = self._post_tf
            w = (self.idf[term_of] * tf * (self.k1 + 1.0) / (
                tf + self.k1 * norm[self._post_doc])).astype(np.float32)
            self._dev = {
                "doc": torch.from_numpy(self._post_doc.astype(np.int64)
                                        ).to(self.device),
                "w": torch.from_numpy(w).to(self.device),
            }
        return self._dev

    def scores_batch(self, queries: Sequence[str],
                     device: Optional[bool] = None,
                     return_device: bool = False):
        """[B, n_docs] BM25 scores for a batch of queries. ``device``
        picks the batch scorer on the index's device over the host loop
        of ``scores``; by default an index on the card always scores
        there, one on the CPU from 2048 documents and two queries (the
        JAX package's rule). ``return_device=True`` returns the f32
        tensor on the index's device without a host copy; else a numpy
        array."""
        if get_config().bm25_scorer != "tiled":
            raise ValueError(
                f"bm25_scorer {get_config().bm25_scorer!r} is not ported "
                "(ROADMAP queue 1 item 10): the port scores every batch "
                'exactly ("tiled", the default)')
        if device is None:
            device = self.device.type == "cuda" or (
                self.n_docs >= 2048 and len(queries) > 1)
        if not device:
            out = np.stack([self.scores(q) for q in queries]) if len(queries) \
                else np.zeros((0, self.n_docs), np.float32)
            return (torch.from_numpy(out).to(self.device) if return_device
                    else out)
        b_cap = max(1, self.score_budget_bytes // max(4 * self.n_docs, 1))
        parts = [self._scores_device(queries[s:s + b_cap])
                 for s in range(0, len(queries), b_cap)]
        out = torch.cat(parts) if len(parts) != 1 else parts[0]
        return out if return_device else out.cpu().numpy()

    def _scores_device(self, queries: Sequence[str]) -> torch.Tensor:
        dev = self._ensure_device()
        terms = [self.capped_terms(q) for q in queries]
        B = len(queries)
        scores = torch.zeros(B, self.n_docs, dtype=torch.float32,
                             device=self.device)
        n_slots = max((len(t) for t in terms), default=0)
        for j in range(n_slots):
            bs = np.asarray([b for b in range(B) if len(terms[b]) > j],
                            np.int64)
            ts = np.asarray([terms[b][j] for b in bs], np.int64)
            off = self._offsets[ts]
            cnt = self._offsets[ts + 1] - off
            total = int(cnt.sum())
            if total == 0:
                continue
            # posting positions of every (query, term) of this slot
            first = np.cumsum(cnt) - cnt
            meta = torch.from_numpy(np.stack([bs, off - first, cnt])
                                    ).to(self.device)
            rows = torch.repeat_interleave(meta[0], meta[2],
                                           output_size=total)
            pos = torch.repeat_interleave(meta[1], meta[2],
                                          output_size=total)
            pos += torch.arange(total, device=self.device)
            docs = dev["doc"][pos]
            # one add per (query, document) of the slot: no two collide
            scores[rows, docs] = scores[rows, docs] + dev["w"][pos]
        return scores

    def search(self, query: str, k: int = 10, *,
               device: Optional[bool] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (scores desc, external ids). ``device`` (default: when
        the index is on the card) scores with ``scores_batch`` and takes
        the top-k there, the lowest row first among equal scores; else
        the host oracle and numpy, as the JAX package does."""
        k = min(k, self.n_docs)
        if device is None:
            device = self.device.type == "cuda"
        if device:
            s = self.scores_batch([query], device=True, return_device=True)
            v, rows = topk_largest(s, k)
            return v[0].cpu().numpy(), self.ids[rows[0].cpu().numpy()]
        s = self.scores(query)
        rows = np.argpartition(-s, k - 1)[:k] if k < self.n_docs \
            else np.arange(self.n_docs)
        rows = rows[np.argsort(-s[rows], kind="stable")]
        return s[rows], self.ids[rows]
