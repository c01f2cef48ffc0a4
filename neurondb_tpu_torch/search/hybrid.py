"""Hybrid search: vector + BM25 fusion, RRF, MMR, faceted, temporal.

Counterpart of ``neurondb_tpu/search/hybrid.py``. The host path
(``hybrid_search``, ``hybrid_search_batch(device=False)``) fuses in
Python floats as the JAX package does (``_fuse_one``). The device path
(``hybrid_search_batch``, ``HybridSearcher``) is ``fuse_core`` in torch
on the BM25 index's device: min-max normalisation, the text-only union
of the top-C positive rows deduped against the ANN pool, one top-k.
Both of its selections take the lowest position first among equal
scores, as ``lax.top_k`` does (``ops.topk.topk_largest``).

Deliberate divergences:
- ``HybridSearcher``'s ``approx`` (``lax.approx_max_k`` for the text
  top-C on the TPU) is accepted and served exactly;
- ``HybridSearcher`` pads no sub-batch: the JAX package pads the last one
  to the full sub-batch size for one compiled shape;
- the fusion normalises only the text scores it reads (the candidates'
  and the top-C's), with the same f32 expression as the JAX package's
  full-row pass.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops.topk import topk_largest
from neurondb_tpu_torch.search.bm25 import BM25Index

NEG_BAD = -1e30


def _normalize_scores(s: np.ndarray) -> np.ndarray:
    lo, hi = s.min(), s.max()
    return (s - lo) / (hi - lo) if hi > lo else np.zeros_like(s)


def _bm25_row_of(bm25: BM25Index) -> Dict[int, int]:
    """external doc id -> BM25 row: the fusion joins on external ids."""
    return {int(i): r for r, i in enumerate(bm25.ids)}


def _fuse_one(vd, vids, tscores, bm25_ids, row_of, *, weight, candidates,
              filter_fn=None) -> Dict[int, float]:
    t_norm = _normalize_scores(tscores)
    vec_component = 1.0 - _normalize_scores(vd)
    pool: Dict[int, float] = {}
    for d, i in zip(vec_component, vids):
        row = row_of.get(int(i))
        txt = t_norm[row] if row is not None else 0.0
        pool[int(i)] = weight * float(d) + (1.0 - weight) * float(txt)
    # pull in strong text-only hits too (the SQL UNION the reference builds)
    top_text = np.argsort(-tscores, kind="stable")[:candidates]
    for row in top_text:
        if tscores[row] <= 0:
            break
        ext = int(bm25_ids[row])
        if ext not in pool:
            pool[ext] = (1.0 - weight) * float(t_norm[row])
    if filter_fn is not None:
        pool = {i: s for i, s in pool.items() if filter_fn(i)}
    return pool


def hybrid_search(index, bm25: BM25Index, query_vec, query_text: str,
                  k: int = 10, *, weight: float = 0.5,
                  candidates: int = 100,
                  filter_fn: Optional[Callable[[int], bool]] = None,
                  device: Optional[bool] = None,
                  **search_kw) -> Tuple[np.ndarray, np.ndarray]:
    """score = w * (1 - dist_norm) + (1 - w) * bm25_norm. Returns
    (scores desc, external ids). ``device`` (default: when the BM25 index
    is on the card) fuses as ``hybrid_search_batch`` does on the device;
    else in Python floats (``_fuse_one``), as does every search with a
    ``filter_fn`` (a host callable), whose text scores still come from
    ``scores_batch`` on the index's device."""
    if device is None:
        device = bm25.device.type == "cuda"
    if device and filter_fn is None:
        s, ids = hybrid_search_batch(
            index, bm25, np.asarray(query_vec, np.float32)[None, :],
            [query_text], k, weight=weight, candidates=candidates,
            device=True, **search_kw)
        ok = ids[0] >= 0
        return s[0][ok], ids[0][ok]
    vd, vids = index.search(np.asarray(query_vec), k=candidates, **search_kw)
    if vd.ndim > 1:
        vd, vids = vd[0], vids[0]
    ok = vids >= 0
    vd, vids = vd[ok], vids[ok]
    tscores = bm25.scores_batch([query_text], device=device)[0]
    pool = _fuse_one(vd, vids, tscores, bm25.ids,
                     _bm25_row_of(bm25), weight=weight,
                     candidates=candidates, filter_fn=filter_fn)
    items = sorted(pool.items(), key=lambda kv: -kv[1])[:k]
    ids = np.asarray([i for i, _ in items], np.int64)
    scores = np.asarray([s for _, s in items], np.float32)
    return scores, ids


def hybrid_search_batch(index, bm25: BM25Index, query_vecs,
                        query_texts: Sequence[str], k: int = 10, *,
                        weight: float = 0.5, candidates: int = 100,
                        device: Optional[bool] = None, **search_kw):
    """One batched ANN call for all queries, then BM25 fusion. Returns
    (scores [B, k], ids [B, k]). ``device`` joins and fuses on the BM25
    index's device, where the [B, n_docs] score matrix stays (the JAX
    package joins the ids on the host; the results are the same): by
    default always for an index on the card, and for one on the CPU from
    2048 documents and two queries (the JAX package's rule).
    ``device=False`` is the host oracle."""
    q = np.atleast_2d(np.asarray(query_vecs, np.float32))
    vd, vids = index.search(q, k=candidates, **search_kw)
    if device is None:
        device = bm25.device.type == "cuda" or (
            bm25.n_docs >= 2048 and len(q) > 1)
    if not device:
        row_of = _bm25_row_of(bm25)
        tscores = bm25.scores_batch(list(query_texts), device=False)
        out_s = np.zeros((len(q), k), np.float32)
        out_i = np.full((len(q), k), -1, np.int64)
        for b in range(len(q)):
            ok = vids[b] >= 0
            pool = _fuse_one(vd[b][ok], vids[b][ok], tscores[b],
                             bm25.ids, row_of, weight=weight,
                             candidates=candidates)
            items = sorted(pool.items(), key=lambda kv: -kv[1])[:k]
            for j, (i, s) in enumerate(items):
                out_i[b, j] = i
                out_s[b, j] = s
        return out_s, out_i

    C = vids.shape[1]
    ts = bm25.scores_batch(list(query_texts), return_device=True)
    out_s, out_i = _join_fuse(
        torch.from_numpy(np.asarray(vd, np.float32)).to(ts.device),
        torch.from_numpy(vids).to(ts.device), ts, *_id_tables(bm25),
        weight=float(weight), k=min(k, 2 * C), candidates=C)
    return out_s.cpu().numpy(), out_i.cpu().numpy()


def _id_tables(bm25: BM25Index):
    """(external ids sorted, their BM25 rows, the ids by row) on the BM25
    index's device: the join's binary-search table."""
    sorter = np.argsort(bm25.ids)
    return tuple(torch.from_numpy(a).to(bm25.device)
                 for a in (bm25.ids[sorter], sorter, bm25.ids))


def _minmax(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """where(hi > lo, (x - lo) / max(hi - lo, 1e-30), 0)."""
    n = (x - lo) / torch.clamp(hi - lo, min=1e-30)
    return torch.where(hi > lo, n, torch.zeros((), device=x.device))


def fuse_core(vd: torch.Tensor, vrows: torch.Tensor, vvalid: torch.Tensor,
              tscores: torch.Tensor, *, weight: float, k: int,
              candidates: int):
    """Device fusion with ``_fuse_one``'s semantics: per-row min-max
    normalisation of the full text-score row and of the candidate
    distances, fused score w (1 - dist_n) + (1 - w) text_n for ANN
    candidates, the text-only union of the top-``candidates`` positive
    text rows (deduped against the ANN pool), one top-k. Returns
    (scores [B, k], positions [B, k] into the [ANN C | text C] concat,
    text rows [B, C])."""
    tmin, tmax = torch.aminmax(tscores, dim=1, keepdim=True)
    ok = vrows >= 0          # the candidate has a BM25 row
    inf = torch.tensor(float("inf"), device=vd.device)
    vmin = torch.where(vvalid, vd, inf).amin(1, keepdim=True)
    vmax = torch.where(vvalid, vd, -inf).amax(1, keepdim=True)
    vec_comp = 1.0 - _minmax(vd, vmin, vmax)
    rows_safe = vrows.clamp(min=0).long()
    txt_at_cand = torch.where(
        ok, _minmax(torch.gather(tscores, 1, rows_safe), tmin, tmax), 0.0)
    ann_score = torch.where(
        vvalid, weight * vec_comp + (1.0 - weight) * txt_at_cand, NEG_BAD)
    tv, trows = topk_largest(tscores, candidates)            # [B, C]
    dup = ((trows[:, :, None] == rows_safe[:, None, :])
           & ok[:, None, :]).any(2)
    text_score = torch.where((tv > 0) & ~dup,
                             (1.0 - weight) * _minmax(tv, tmin, tmax), NEG_BAD)
    vals, pos = topk_largest(torch.cat([ann_score, text_score], 1), k)
    return vals, pos, trows


def _join_fuse(vd, vids, tscores, ids_sorted, sorter, bm25_ids, *,
               weight: float, k: int, candidates: int):
    """ANN-id join, fusion and id resolution on the device, with no host
    sync: the external-id -> BM25-row join is a binary search over the
    sorted id table (``_id_tables``). Returns (scores [B, k] desc, ids
    [B, k], -1 padded)."""
    C = vids.shape[1]
    vids = vids.long()
    pos = torch.searchsorted(ids_sorted, vids).clamp(0, ids_sorted.shape[0] - 1)
    hit = (ids_sorted[pos] == vids) & (vids >= 0)
    vrows = torch.where(hit, sorter[pos], -1)
    vals, fpos, trows = fuse_core(vd, vrows, vids >= 0, tscores,
                                  weight=weight, k=k, candidates=candidates)
    from_text = fpos >= C
    col = torch.where(from_text, fpos - C, fpos)
    text_ids = bm25_ids[trows]                               # [B, C]
    out_i = torch.where(
        from_text,
        torch.gather(text_ids, 1, col.clamp(max=text_ids.shape[1] - 1)),
        torch.gather(vids, 1, col.clamp(max=C - 1)))
    out_i = torch.where(vals > NEG_BAD * 0.5, out_i, -1)
    out_s = torch.where(out_i >= 0, vals, 0.0)
    return out_s, out_i


class HybridSearcher:
    """Serving-style hybrid search: the ANN scan, BM25 scoring and the
    fusion of every sub-batch run on the device with no host sync until
    all of a request's sub-batches are queued. Semantics match
    ``hybrid_search_batch``; needs an index with ``search(...,
    out="device")`` (``IVFFlatIndex``, ``IVFPQIndex``)."""

    def __init__(self, index, bm25: BM25Index, *, weight: float = 0.5,
                 candidates: int = 100, approx: Optional[bool] = None):
        self.index = index
        self.bm25 = bm25
        self.weight = float(weight)
        self.candidates = int(candidates)
        self.approx = approx          # accepted; served exactly
        self._tables = _id_tables(bm25)

    def default_batch(self) -> int:
        """Queries a sub-batch: 256 to 2,048, so that one [b, n_docs] f32
        score matrix stays near 2 GB (the JAX package's rule)."""
        per = max((1 << 31) // max(4 * self.bm25.n_docs, 1), 1)
        return 1 << max(8, min(11, int(np.log2(per))))

    def search_batch(self, query_vecs, query_texts: Sequence[str],
                     k: int = 10, *, batch: Optional[int] = None,
                     **search_kw) -> Tuple[np.ndarray, np.ndarray]:
        qdt = getattr(query_vecs, "dtype", None)
        keep = (qdt is not None and np.dtype(qdt).itemsize == 2
                and np.dtype(qdt).kind in "fV")
        q = np.atleast_2d(np.asarray(query_vecs)
                          if keep else np.asarray(query_vecs, np.float32))
        batch = self.default_batch() if batch is None else batch
        outs = []
        for s in range(0, len(q), batch):
            vd, vids = self.index.search(
                q[s:s + batch], k=self.candidates, out="device", **search_kw)
            ts = self.bm25.scores_batch(list(query_texts[s:s + batch]),
                                        device=True, return_device=True)
            outs.append(_join_fuse(vd, vids, ts, *self._tables,
                                   weight=self.weight, k=k,
                                   candidates=self.candidates))
        if not outs:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
        scores = torch.cat([a for a, _ in outs]).cpu().numpy()
        ids = torch.cat([b for _, b in outs]).cpu().numpy()
        return scores.astype(np.float32), ids.astype(np.int64)


def reciprocal_rank_fusion(rankings: Sequence[np.ndarray], k: int = 10,
                           rrf_k: float = 60.0) -> Tuple[np.ndarray, np.ndarray]:
    """RRF over ranked id lists: score(d) = sum_r 1 / (rrf_k + rank_r(d))."""
    scores: Dict[int, float] = {}
    for ranking in rankings:
        for rank, doc in enumerate(np.asarray(ranking).ravel()):
            if doc < 0:
                continue
            scores[int(doc)] = scores.get(int(doc), 0.0) + 1.0 / (rrf_k + rank + 1)
    items = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return (np.asarray([s for _, s in items], np.float32),
            np.asarray([i for i, _ in items], np.int64))


def mmr_diverse_search(query_vec, cand_vecs, cand_ids, k: int = 10,
                       *, lambda_: float = 0.5, metric: str = "cosine",
                       device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Maximal Marginal Relevance re-selection: greedily pick the argmax
    of lambda sim(q, d) - (1 - lambda) max_sim(d, selected). The
    similarities are computed on ``device``."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_vec, np.float32)[None, :], device=dev)
    X = torch.as_tensor(np.asarray(cand_vecs, np.float32), device=dev)
    ids = np.asarray(cand_ids)
    n = len(X)
    k = min(k, n)
    sim_q = 1.0 - D.pairwise_distance(q, X, metric).cpu().numpy()[0]
    sim_dd = 1.0 - D.pairwise_distance(X, X, metric).cpu().numpy()
    selected: List[int] = []
    max_sim = np.full(n, -np.inf, np.float32)
    scores = np.zeros(k, np.float32)
    for step in range(k):
        mmr = lambda_ * sim_q - (1 - lambda_) * np.where(
            np.isfinite(max_sim), max_sim, 0.0)
        mmr[selected] = -np.inf
        best = int(np.argmax(mmr))
        scores[step] = mmr[best]
        selected.append(best)
        max_sim = np.maximum(max_sim, sim_dd[:, best])
    return scores, ids[selected]


def temporal_vector_search(index, query_vec, timestamps: np.ndarray,
                           k: int = 10, *, decay: float = 0.01,
                           now: Optional[float] = None,
                           candidates: int = 100,
                           **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Time-decay rescoring: score = (1 - dist_norm) exp(-decay
    age_days). ``timestamps`` maps id -> unix seconds."""
    now = time.time() if now is None else now
    vd, vids = index.search(np.asarray(query_vec), k=candidates, **kw)
    if vd.ndim > 1:
        vd, vids = vd[0], vids[0]
    ok = vids >= 0
    vd, vids = vd[ok], vids[ok]
    rel = 1.0 - _normalize_scores(vd)
    age_days = (now - timestamps[vids]) / 86400.0
    score = rel * np.exp(-decay * np.maximum(age_days, 0.0))
    order = np.argsort(-score, kind="stable")[:k]
    return score[order].astype(np.float32), vids[order]


def faceted_vector_search(index, query_vec, facets: Dict[int, Dict],
                          facet_filter: Dict, k: int = 10, *,
                          candidates: int = 200,
                          **kw) -> Tuple[np.ndarray, np.ndarray]:
    """ANN + metadata facet filter: keep the candidates whose facet dict
    holds every key=value of ``facet_filter``."""
    vd, vids = index.search(np.asarray(query_vec), k=candidates, **kw)
    if vd.ndim > 1:
        vd, vids = vd[0], vids[0]
    keep = [j for j, i in enumerate(vids) if i >= 0 and all(
        facets.get(int(i), {}).get(fk) == fv
        for fk, fv in facet_filter.items())]
    keep = keep[:k]
    return vd[keep], vids[keep]


def multi_vector_search(index, query_vecs, k: int = 10, *,
                        agg: str = "min", candidates: int = 100,
                        **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-query search: the union of each query vector's candidates,
    each doc's distance aggregated by min or mean, top-k."""
    q = np.atleast_2d(np.asarray(query_vecs, np.float32))
    vd, vids = index.search(q, k=candidates, **kw)
    pool: Dict[int, List[float]] = {}
    for b in range(vd.shape[0]):
        for d, i in zip(vd[b], vids[b]):
            if i >= 0:
                pool.setdefault(int(i), []).append(float(d))
    rows = [(min(v) if agg == "min" else sum(v) / len(v), i)
            for i, v in pool.items()]
    rows.sort()
    rows = rows[:k]
    return (np.asarray([d for d, _ in rows], np.float32),
            np.asarray([i for _, i in rows], np.int64))


def semantic_keyword_search(index, bm25: BM25Index, query_vec,
                            query_text: str, k: int = 10,
                            **kw) -> Tuple[np.ndarray, np.ndarray]:
    """RRF-fused semantic + keyword results."""
    _, vids = index.search(np.asarray(query_vec), k=max(k * 10, 50), **kw)
    if vids.ndim > 1:
        vids = vids[0]
    _, tids = bm25.search(query_text, k=max(k * 10, 50))
    return reciprocal_rank_fusion([vids, tids], k=k)
