"""IVFFlat — k-means-partitioned ANN index with a list-grouped scan.

Counterpart of ``neurondb_tpu/index/ivf.py``. The build trains k-means on
a sample, assigns every row and packs an aligned CSR: each list starts on
a ``LIST_ALIGN``-row boundary and the store ends in a ``PAD_SEG``-row tail,
the same layout as the JAX package, so a state carried across
(``from_state``) yields the same lists. A search takes one of three routes
on every device:

- ``_ivf_search_grouped`` (the default, ``config.ivf_kernel="grouped"``):
  centroid GEMM, top-nprobe, ``group_probes``, the grouped scan (the CUDA
  kernel on a CUDA tensor, its plain torch version on a CPU tensor),
  ``merge_partials`` and ``_ivf_post``;
- ``_ivf_search_probe`` (``config.ivf_kernel="probe"``, the JAX package's
  round-1 route): ``_ivf_coarse`` (centroid GEMM, top-nprobe, the probes'
  offsets and counts), the per-(query, probe) scan ``ivf_probe_scan``
  (``csrc/ivf_probe_scan.cu`` on a CUDA tensor) and ``_ivf_post``;
- ``_ivf_search_exact``: the chunked exact scan, taken where the padded
  nprobe reaches nlists, whichever kernel is configured.

Deliberate divergences from the JAX package:
- probe selection (``coarse_rt``) and the exact route's
  ``recall_target`` are served exactly: the card has no approximate
  top-k primitive;
- ``select`` (default ``config.ivf_select``, ``"packed"``) takes
  ``"packed"``, ``"blockmin"`` or ``"exact"`` with the JAX package's
  gate: packed keys of ``pb = max(11, bitlen(max_list - 1))`` bits, exact
  when ``pb > 14``; an unknown name raises instead of meaning exact;
- the store is bf16 on CUDA (``store_dtype="auto"``), f32 elsewhere;
- the TPU limits on the route (the ``8 * t_max`` SMEM guard and the
  ``D % 128`` gate) are dropped; the kernel's own bound is its shared
  memory, which the scan checks for each call;
- ``ivf_kernel`` (the JAX package's env var ``NEURONDB_TPU_IVF_KERNEL``)
  takes ``"grouped"`` or ``"probe"``; an unknown name raises where the
  JAX package silently takes the round-1 route;
- the probe route scans exactly ``nprobe`` probe columns: the JAX
  package's padding to ``max(npad, 16)`` empty columns exists only to
  share one Mosaic compile. ``select`` is validated and has no effect
  there, as in the JAX package (its selection is exact).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import (get_config, resolve_device,
                                       resolve_store_dtype)
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.ml.kmeans import kmeans_fit, kmeans_predict
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.ops.kernels import ivf_scan as P
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

PAD_SEG = 1024    # store tail padding, as in the JAX package's layout
SEGMENT = P.SEG   # the probe route's rows per segment (``max_segs`` unit)
SELECT_MODES = ("packed", "blockmin", "exact")
IVF_KERNELS = ("grouped", "probe")


def _ivf_post(vals: torch.Tensor, rows: torch.Tensor, row_ids: torch.Tensor,
              *, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    ids = torch.where(rows >= 0, row_ids[rows.clamp(min=0).long()], -1)
    if metric == "l2":
        vals = torch.sqrt(torch.clamp(vals, min=0.0))
    elif metric == "cosine":
        vals = vals * 0.5       # unit vectors: 1 - cos = ||q-x||^2 / 2
    vals = torch.where(ids >= 0, vals, TK.NEG_FILL)
    return vals, ids


def _csr_pack(xdev: torch.Tensor, gather_idx: torch.Tensor,
              live: torch.Tensor, *, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row gather into the aligned-CSR layout, zeroed gap rows, f32
    sqnorms from the f32 source, then the store cast."""
    xp = xdev[gather_idx]
    xp.masked_fill_(~live[:, None], 0.0)
    sq = (xp * xp).sum(1)
    return xp.to(dtype), sq


def _ivf_search_exact(q, vecs, sqnorms, row_ids, offsets, counts, *,
                      k: int, metric: str, chunk: int = 131072,
                      recall_target: float = 1.0):
    """Probe-everything point: the exact chunked GEMM scan over the
    cluster-ordered store. Validity comes from (offsets, counts):
    ``delete`` shrinks list counts without rewriting tail slots."""
    npad_rows = vecs.shape[0]
    idx = torch.arange(npad_rows, dtype=torch.int32, device=vecs.device)
    nlists = offsets.shape[0]
    li = (torch.searchsorted(offsets, idx, right=True) - 1).clamp(0, nlists - 1)
    valid = ((idx >= offsets[li]) & (idx < offsets[li] + counts[li])
             & (row_ids >= 0))
    dd = vecs.dtype if vecs.dtype != torch.float32 else None
    return TK.chunked_knn(q, vecs, k, metric=metric, base_sqnorms=sqnorms,
                          ids=row_ids, valid=valid, chunk=chunk,
                          dot_dtype=dd, recall_target=recall_target)


def select_bits(select: str, max_list: int, *, max_bits: int = 14
                ) -> Tuple[int, bool]:
    """(pos_bits, block_min) of a selection mode: packed keys need
    ``2**pb`` >= the longest list, floored at 11 bits; past ``max_bits``
    the key rounding (2**(pb-24) relative) is no longer negligible and
    the scan selects exactly (pos_bits 0)."""
    if select not in SELECT_MODES:
        raise ValueError(f"unknown select {select!r}; known: {SELECT_MODES}")
    pb = max(11, (max(max_list, 2) - 1).bit_length())
    if pb > max_bits or select == "exact":
        pb = 0
    return pb, pb > 0 and select == "blockmin"


def _nearest_lists(q, centroids, n: int, *, metric: str) -> torch.Tensor:
    """Coarse stage: each query's n nearest centroids [B, n] (exact
    top-n; sq-L2 for l2 and cosine, ip for ip)."""
    cd = D.pairwise_distance(q, centroids,
                             "sqeuclidean" if metric != "ip" else "ip")
    return TK.topk_smallest(cd, n)[1]


def _ivf_search_grouped(q, centroids, vecs, row_ids, offsets, counts,
                        nprobe: int, *, k: int, metric: str, nprobe_pad: int,
                        qt: int = 0, pos_bits: int = 0,
                        block_min: bool = False):
    """Coarse centroid stage -> list-grouped scan -> merge + id map. The
    coarse stage takes the top ``nprobe_pad`` centroids and masks columns
    at or past ``nprobe`` to the sentinel list ``nlists``."""
    npad = nprobe_pad
    nlists = counts.shape[0]
    probes = _nearest_lists(q, centroids, npad, metric=metric)
    col = torch.arange(npad, device=q.device)[None, :]
    probes = torch.where(col < nprobe, probes, nlists).to(torch.int32)
    B = q.shape[0]
    qt = qt or G.auto_qt(B, npad, nlists)
    t_max = G.tiles_for(B, npad, nlists, qt)
    kp = max(8, min(k, G.SEG))
    tile_off, tile_cnt, pos = G.group_probes(probes, offsets, counts, qt=qt,
                                             t_max=t_max)
    qpad = G._scatter_tuples(q, pos, npad=npad, qt=qt, t_max=t_max)
    out_d, out_i = G.grouped_probe_scan(
        qpad, vecs, tile_off, tile_cnt, kp=kp, qt=qt,
        metric="ip" if metric == "ip" else "sqeuclidean",
        pos_bits=pos_bits, block_min=block_min)
    vals, rows = G.merge_partials(out_d, out_i, pos.reshape(B, npad), k=k)
    return _ivf_post(vals, rows, row_ids, metric=metric)


def _ivf_coarse(q, centroids, offsets, counts, *, nprobe: int, metric: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse stage of the probe route: the nprobe nearest lists, then
    each probe's list offset and count [B, nprobe]."""
    probes = _nearest_lists(q, centroids, nprobe, metric=metric)
    return offsets[probes], counts[probes]


def _ivf_search_probe(q, centroids, vecs, row_ids, offsets, counts, *,
                      k: int, nprobe: int, metric: str, max_segs: int):
    """Round-1 route: coarse stage -> per-(query, probe) list scan with
    its cross-probe merge -> id map."""
    poff, pcnt = _ivf_coarse(q, centroids, offsets, counts, nprobe=nprobe,
                             metric=metric)
    vals, rows = P.ivf_probe_scan(
        q, None, vecs, poff, pcnt, k=k, max_segs=max_segs,
        metric="ip" if metric == "ip" else "sqeuclidean")
    return _ivf_post(vals, rows, row_ids, metric=metric)


class IVFFlatIndex(BaseIndex):
    kind = "ivfflat"
    LIST_ALIGN = 32   # rows; the JAX layout, kept so states carry across

    def __init__(self, vectors, *, nlists: Optional[int] = None,
                 metric: str = "l2", ids=None, seed: int = 0,
                 kmeans_iters: Optional[int] = None,
                 sample_cap: Optional[int] = None,
                 spherical: Optional[bool] = None, device=None,
                 device_vectors: Optional[torch.Tensor] = None):
        """``device_vectors``: the same corpus already on ``device``, f32
        [n, d] (normalised where the metric works on the unit sphere);
        the build then reads it instead of uploading ``vectors`` again
        (the HNSW bulk build hands over its resident corpus)."""
        cfg = get_config()
        self.device = resolve_device(device)
        x = np.asarray(vectors, np.float32)
        n, d = x.shape
        self.metric = D.canonical_metric(metric)
        self.dim = d
        self.n = n
        self.nlists = max(1, min(int(nlists if nlists is not None
                                     else cfg.ivf_nlists), n))
        self._seed = seed
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(n, dtype=np.int64))
        # cosine: work on the unit sphere so sq-L2 ranks identically
        self._spherical = (self.metric == "cosine") if spherical is None \
            else spherical
        if self._spherical:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        self._x = x

        # ---- train: sampled Lloyd's on the device ----
        cap = int(sample_cap if sample_cap is not None
                  else max(cfg.ivf_sample_cap, self.nlists * 100))
        if device_vectors is None:
            xdev = torch.from_numpy(x).to(self.device)
        elif (tuple(device_vectors.shape) != (n, d)
              or device_vectors.dtype != torch.float32
              or device_vectors.device.type != self.device.type
              or self.device.index not in (None,
                                           device_vectors.device.index)):
            raise ValueError(
                f"device_vectors must be f32 {(n, d)} on {self.device}, got "
                f"{device_vectors.dtype} {tuple(device_vectors.shape)} on "
                f"{device_vectors.device}")
        else:
            xdev = device_vectors
        if n <= cap:
            sample = xdev
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            pick = torch.randperm(n, generator=gen, device=self.device)[:cap]
            sample = xdev[pick]
        state = kmeans_fit(sample, self.nlists,
                           max_iter=int(kmeans_iters or cfg.ivf_kmeans_iters),
                           tol=cfg.ivf_kmeans_tol, seed=seed)
        del sample
        self.centroids = state.centroids
        self.train_inertia = state.inertia
        self._build_lists(x, xdev=xdev)
        self._spill: list = []        # unindexed inserts, exact-scanned

    # ---- list construction ----
    def _build_lists(self, x: np.ndarray,
                     xdev: Optional[torch.Tensor] = None) -> None:
        if xdev is None:
            xdev = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        labels = kmeans_predict(self.centroids, xdev).cpu().numpy()
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=self.nlists).astype(np.int32)
        A = self.LIST_ALIGN
        aligned = ((counts + A - 1) // A) * A
        self._region = aligned           # per-list row capacity (delete)
        offsets = np.zeros(self.nlists, np.int32)
        np.cumsum(aligned[:-1], out=offsets[1:])
        total = int(aligned.sum())
        n = x.shape[0]
        npad = max(1, -(-total // PAD_SEG) * PAD_SEG) + PAD_SEG
        src = np.zeros(self.nlists + 1, np.int64)
        np.cumsum(counts, out=src[1:])
        order_aligned = np.full(npad, -1, np.int64)
        if n:
            tgt = (np.repeat(offsets.astype(np.int64), counts)
                   + (np.arange(n) - np.repeat(src[:-1], counts)))
            order_aligned[tgt] = order
        order = order_aligned
        live = order >= 0
        dev = self.device
        self._vecs, self._sqnorms = _csr_pack(
            xdev, torch.from_numpy(np.where(live, order, 0)).to(dev),
            torch.from_numpy(live).to(dev),
            dtype=resolve_store_dtype(dev))
        del xdev                         # free the f32 staging copy
        self._row_ids = torch.from_numpy(order.astype(np.int32)).to(dev)
        # CSR row -> external id on the device; ids past int32 map on host
        ext = np.full(npad, -1, np.int64)
        ext[live] = self._ids[order[live]]
        if len(self._ids) == 0 or ext.max() <= np.iinfo(np.int32).max:
            self._ext_ids = torch.from_numpy(ext.astype(np.int32)).to(dev)
            self._host_id_map = None
        else:
            self._ext_ids = self._row_ids
            self._host_id_map = True
        self._offsets = torch.from_numpy(offsets).to(dev)
        self._counts = torch.from_numpy(counts).to(dev)
        self._counts_np = counts.copy()
        self.max_list = int(counts.max()) if n else 1
        self._labels = labels
        self._dead = np.zeros(n, bool)   # tombstones over self._x rows

    # ---- mutation ----
    def add(self, vectors, ids=None) -> np.ndarray:
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if self._spherical:
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-30)
        start = self._ids.max() + 1 if len(self._ids) else 0
        new_ids = (np.asarray(ids, np.int64) if ids is not None
                   else np.arange(start, start + len(v), dtype=np.int64))
        self._spill.append((v, new_ids))
        return new_ids

    def delete(self, ids) -> int:
        """In-place delete: compact each affected posting list within its
        aligned region and shrink its count (``index_put_`` on the store,
        the norms and the id maps) — no rebuild. Returns the number of
        vectors removed."""
        drop = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        removed = 0
        new_spill = []
        for v, sid in self._spill:
            keep = ~np.isin(sid, drop)
            removed += int((~keep).sum())
            if keep.any():
                new_spill.append((v[keep], sid[keep]))
        self._spill = new_spill
        mask = np.isin(self._ids, drop) & ~self._dead
        hit = int(mask.sum())
        removed += hit
        if hit:
            self._dead |= mask
            offsets = self._offsets.cpu().numpy()
            pos_upd, row_upd = [], []
            for lid in np.unique(self._labels[mask]):
                members = np.where((self._labels == lid) & ~self._dead)[0]
                self._counts_np[lid] = len(members)
                pos_upd.append(int(offsets[lid])
                               + np.arange(len(members), dtype=np.int64))
                row_upd.append(members)
            self._counts = torch.from_numpy(self._counts_np.copy()).to(self.device)
            pos = np.concatenate(pos_upd)
            rowsrc = np.concatenate(row_upd)
            if len(pos):
                pj = torch.from_numpy(pos).to(self.device)
                xv = torch.from_numpy(self._x[rowsrc]).to(self.device)
                self._vecs.index_put_((pj,), xv.to(self._vecs.dtype))
                self._sqnorms.index_put_((pj,), (xv * xv).sum(1))
                self._row_ids.index_put_(
                    (pj,), torch.from_numpy(rowsrc.astype(np.int32)).to(self.device))
                if self._host_id_map is None:
                    self._ext_ids.index_put_(
                        (pj,), torch.from_numpy(
                            self._ids[rowsrc].astype(np.int32)).to(self.device))
        self.n = int((~self._dead).sum()) + sum(len(i) for _, i in self._spill)
        return removed

    @property
    def dead_ratio(self) -> float:
        total = len(self._x)
        return float(self._dead.sum()) / total if total else 0.0

    def rebuild_lists(self) -> None:
        """Fold the spill buffer into the posting lists and drop
        tombstones."""
        if not self._spill and not self._dead.any():
            return
        keep = ~self._dead
        vs = np.concatenate([self._x[keep]] + [v for v, _ in self._spill])
        ids = np.concatenate([self._ids[keep]] + [i for _, i in self._spill])
        self._x, self._ids = vs, ids
        self.n = len(vs)
        self._spill = []
        self._build_lists(vs)

    # ---- search ----
    def search(self, queries, k: int = 10, *, nprobe: Optional[int] = None,
               out: str = "numpy", recall_target: float = 1.0,
               coarse_rt: Optional[float] = None,
               select: Optional[str] = None,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        """``out="device"`` returns torch tensors on the index's device
        without a host sync; it needs a batch query, no spill buffer and
        int32 external ids. ``recall_target`` and ``coarse_rt`` are
        accepted for parity and served exactly. ``select`` is the grouped
        scan's top-k extraction (``select_bits``): ``"packed"`` rounds
        distances by <= 2**(pos_bits-24) relative and may swap near-ties
        at the k boundary; ``"blockmin"`` keeps at most one candidate per
        (query, 1024-row segment, class pos % 128); ``"exact"``. The route
        below the exact point is ``config.ivf_kernel``'s; on the probe
        route ``select`` is validated and has no effect."""
        cfg = get_config()
        pos_bits, block_min = select_bits(
            select if select is not None else cfg.ivf_select, self.max_list)
        if cfg.ivf_kernel not in IVF_KERNELS:
            raise ValueError(f"unknown ivf_kernel {cfg.ivf_kernel!r}; "
                             f"known: {IVF_KERNELS}")
        nprobe =max(1, min(int(nprobe if nprobe is not None
                                else cfg.ivf_nprobe), self.nlists))
        q, single = as_batch(queries, device=self.device)
        if self._spherical:
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                                min=1e-30)
        # nprobe buckets of the JAX package: the padded probe count decides
        # the exact route (sentinel columns are skipped by the scan)
        npad = 1
        while npad < nprobe:
            npad *= 4
        npad = min(max(npad, 4), self.nlists)
        kk = min(k, max(self.n, 1))
        if npad >= self.nlists:
            chunk = max(4096, min(131072,
                                  1 << (28 - max(q.shape[0], 1).bit_length() + 1)))
            vals, ids = _ivf_search_exact(
                q, self._vecs, self._sqnorms, self._ext_ids, self._offsets,
                self._counts, k=kk, metric=self.metric, chunk=chunk,
                recall_target=recall_target)
        elif cfg.ivf_kernel == "probe":
            vals, ids = _ivf_search_probe(
                q, self.centroids, self._vecs, self._ext_ids, self._offsets,
                self._counts, k=kk, nprobe=nprobe, metric=self.metric,
                max_segs=P.segments_for(self.max_list))
        else:
            vals, ids = _ivf_search_grouped(
                q, self.centroids, self._vecs, self._ext_ids, self._offsets,
                self._counts, nprobe, k=kk, metric=self.metric,
                nprobe_pad=max(npad, nprobe), qt=cfg.ivf_qt,
                pos_bits=pos_bits, block_min=block_min)
        if out == "device":
            if self._spill or self._host_id_map is not None or single:
                raise ValueError("device output requires a batch query, "
                                 "no spill buffer, and int32 ids")
            return vals, ids
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        if self._host_id_map is not None:   # rows -> int64 external ids
            ids = np.where(ids >= 0, self._ids[np.maximum(ids, 0)], -1)
        if self._spill:
            vals, ids = self._merge_spill(q, k, vals, ids)
        return (vals[0], ids[0]) if single else (vals, ids)

    def _merge_spill(self, q: torch.Tensor, k: int, vals, ids):
        sv = np.concatenate([v for v, _ in self._spill])
        sids = np.concatenate([i for _, i in self._spill])
        d = D.pairwise_distance(q, torch.from_numpy(sv).to(q.device),
                                self.metric).cpu().numpy()
        both_v = np.concatenate([vals, d], axis=1)
        both_i = np.concatenate(
            [ids, np.broadcast_to(sids, (len(d), len(sids)))], axis=1)
        ordv = np.argsort(both_v, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(both_v, ordv, axis=1),
                np.take_along_axis(both_i, ordv, axis=1))

    # ---- persistence ----
    def _state(self):
        self.rebuild_lists()
        return ({"x": self._x, "ids": self._ids,
                 "centroids": self.centroids},
                {"nlists": self.nlists, "n": self.n, "seed": self._seed,
                 "spherical": self._spherical})

    def _load_state(self, arrays, meta, device=None):
        self.device = resolve_device(device)
        self.metric = meta["metric"]
        self.dim = meta["dim"]
        self.n = meta["n"]
        self.nlists = meta["nlists"]
        self._seed = meta.get("seed", 0)
        self._spherical = meta.get("spherical", self.metric == "cosine")
        self._x = np.asarray(arrays["x"], np.float32)
        self._ids = np.asarray(arrays["ids"], np.int64)
        self.centroids = torch.tensor(
            np.asarray(arrays["centroids"], np.float32), device=self.device)
        self.train_inertia = float("nan")
        self._build_lists(self._x)
        self._spill = []

    # ---- diagnostics ----
    def stats(self) -> Dict[str, Any]:
        c = self._counts_np
        return {
            "kind": self.kind, "n": self.n, "nlists": self.nlists,
            "metric": self.metric,
            "list_len_min": int(c.min()), "list_len_max": int(c.max()),
            "list_len_mean": float(c.mean()),
            "empty_lists": int((c == 0).sum()),
            "imbalance": float(c.max() / max(c.mean(), 1e-9)),
            "train_inertia": self.train_inertia,
        }
