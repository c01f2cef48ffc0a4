"""Sharded search and training steps over a device mesh.

Counterpart of ``neurondb_tpu/parallel/sharded.py`` (BASELINE.json
config 5): stores row-sharded over the mesh, the queries copied to each
shard's device, each shard's local top-k, then the cross-shard merge in
the mesh's fixed shard order (``mesh.merge_shards``, the stable
shard-major merge of ``merge_distributed_results``, distributed.c:320);
k-means steps whose (sums, counts, inertia) add up over the shards
(``mesh.psum``).

- ``sharded_knn``: per shard the port's ``ops.topk.chunked_knn`` (a GEMM
  and a top-k, as in JAX), padded to k columns where a shard holds fewer
  than k rows;
- ``sharded_kmeans_step``: per shard the GEMM argmin of ``ml.kmeans``
  (ties to the lowest centroid), then the psum; empty clusters keep
  their centroid;
- ``ShardedIVFIndex``: each list interleaved round-robin over the
  shards (``interleaved_layout``); each shard's search is the coarse
  top-nprobe, the round-1 probe scan over its slice of the probed lists
  (``ops.kernels.ivf_scan.probe_scan``: ``csrc/ivf_probe_scan.cu`` on a
  CUDA tensor) and ``merge_probes``, then the cross-shard merge.

A search copies the queries to the lead device once and from there to
each shard's device; no shard's work waits on the host, and one copy of
the merged result to the host ends the search.

Deliberate divergences from the JAX package:
- each shard holds a tensor of its own rows: no padding to a common
  shape, so no pad rows and no validity mask for them;
- ``ShardedFlatIndex`` maps int64 external ids on the host after the
  merge (int32 rows on the devices), where the JAX class casts its ids
  to int32 on the devices;
- ``ShardedIVFIndex`` serves k (after ``k = min(k, n)``) up to the probe
  kernel's per-probe cap, ``ivf_scan.SEG`` = 512: a larger k raises a
  ValueError naming the cap, where the JAX class's ``lax.scan`` keeps the
  exact top-k for any k;
- the coarse top-nprobe runs once per device, not once per shard: the
  centroids are replicated, so every shard of a device would compute the
  same probes;
- no ``axis`` argument: the shards span the whole mesh;
- ``build_seconds`` holds the build's stages (k-means, assignment,
  layout, upload).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.index.hnsw import _PhaseClock
from neurondb_tpu_torch.index.ivf import _nearest_lists
from neurondb_tpu_torch.ml.kmeans import _assign_chunked, kmeans_fit, \
    kmeans_predict
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.ops.kernels import ivf_scan as PS
from neurondb_tpu_torch.parallel.mesh import (Mesh, as_tensor, make_mesh,
                                              merge_shards, per_device, psum,
                                              shard_rows)


def pad_columns(d: torch.Tensor, i: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's partial top-k widened to k columns with (NEG_FILL, -1)."""
    short = k - d.shape[1]
    if short <= 0:
        return d, i
    return (torch.cat([d, d.new_full((d.shape[0], short), TK.NEG_FILL)], 1),
            torch.cat([i, i.new_full((i.shape[0], short), -1)], 1))


def f32_rows(queries, spherical: bool) -> np.ndarray:
    """[B, D] f32 numpy, on the unit sphere where the metric needs it."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    if spherical:
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    return q


def external_ids(rows: np.ndarray, ids_np: np.ndarray) -> np.ndarray:
    """Global rows -> int64 external ids (-1 stays -1)."""
    return np.where(rows >= 0, ids_np[np.maximum(rows, 0)], np.int64(-1))


def host_results(d: torch.Tensor, rows: torch.Tensor, ids_np: np.ndarray,
                 metric: str) -> Tuple[np.ndarray, np.ndarray]:
    """The search's one copy to the host: raw distances -> the metric's
    (sqrt for l2, x0.5 for cosine on the unit sphere), device rows ->
    external ids."""
    d, rows = d.cpu().numpy(), rows.cpu().numpy()
    if metric == "l2":
        d = np.sqrt(np.maximum(d, 0.0))
    elif metric == "cosine":
        d = d * 0.5
    return d, external_ids(rows, ids_np)


def sharded_knn(mesh: Mesh, queries: torch.Tensor,
                base_sharded: Sequence[torch.Tensor],
                ids_sharded: Sequence[torch.Tensor],
                valid_sharded: Optional[Sequence[torch.Tensor]], k: int, *,
                metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a row-sharded base (per-shard lists of tensors on
    the shards' devices; ``valid_sharded`` may be None). Each shard's
    ``chunked_knn``, widened to k columns, its rows mapped through its
    ids, then ``merge_shards``. Returns (dists, ids) [B, k] on the lead
    device."""
    devs = mesh.shard_devices()
    qs = per_device(queries, devs)
    dists, ids = [], []
    for s, (q, xs) in enumerate(zip(qs, base_sharded)):
        ld, lrows = TK.chunked_knn(
            q, xs, k, metric=metric, chunk=max(1, min(xs.shape[0], 65536)),
            valid=None if valid_sharded is None else valid_sharded[s])
        lids = torch.where(lrows >= 0,
                           ids_sharded[s][lrows.clamp(min=0).long()], -1)
        ld, lids = pad_columns(ld, lids, k)
        dists.append(ld)
        ids.append(lids)
    return merge_shards(mesh, dists, ids, k)


def sharded_kmeans_step(mesh: Mesh, x_sharded: Sequence[torch.Tensor],
                        centroids) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over row-sharded data: per shard the GEMM
    argmin of ``ml.kmeans`` (ties to the lowest centroid) and the
    shard's (sums, counts, inertia); their psum; empty clusters keep
    their centroid. Returns (new centroids [k, D], inertia) on the lead
    device."""
    c = as_tensor(centroids).float().to(mesh.lead)
    k = c.shape[0]
    sums, counts, inertia = [], [], []
    for xs, cd in zip(x_sharded, per_device(c, mesh.shard_devices())):
        xs = xs.float()
        labels, best = _assign_chunked(xs[None], cd[None],
                                       (xs * xs).sum(-1)[None])
        lab = labels[0].long()
        sums.append(torch.zeros_like(cd).index_add_(0, lab, xs))
        counts.append(torch.bincount(lab, minlength=k).float())
        inertia.append(best.sum())
    total, cnt = psum(mesh, sums), psum(mesh, counts)
    newc = torch.where(cnt[:, None] > 0,
                       total / torch.clamp(cnt[:, None], min=1.0), c)
    return newc, psum(mesh, inertia)


class ShardedFlatIndex:
    """Exact k-NN with the base row-sharded across the mesh."""

    def __init__(self, vectors, *, mesh: Optional[Mesh] = None,
                 metric: str = "l2", ids=None):
        self.mesh = mesh or make_mesh()
        self.metric = D.canonical_metric(metric)
        x = np.asarray(vectors, np.float32)
        self.n, self.dim = x.shape
        self._ids_np = np.asarray(ids if ids is not None
                                  else np.arange(self.n), np.int64)
        self._base = shard_rows(self.mesh, x)
        self._rows = shard_rows(self.mesh, np.arange(self.n, dtype=np.int32))

    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.from_numpy(f32_rows(queries, False)).to(self.mesh.lead)
        d, rows = sharded_knn(self.mesh, q, self._base, self._rows, None, k,
                              metric=self.metric)
        return d.cpu().numpy(), external_ids(rows.cpu().numpy(),
                                             self._ids_np)


# ---------------------------------------------------------------------------
# IVF over the mesh
# ---------------------------------------------------------------------------

def interleaved_layout(labels: torch.Tensor, nlists: int, nshards: int
                       ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """Posting lists interleaved round-robin over the shards, the JAX
    package's vectorized layout (sharded.py:164-205): the row of
    within-list rank r goes to shard r % S, and each shard holds its
    lists contiguously in list order, each list's rows in source order.
    Returns (cnt [S, nlists] int64 numpy, per shard the source row of
    each of its slots, on ``labels``' device)."""
    lab = labels.long()
    order = torch.sort(lab, stable=True).indices         # rows by list
    ls = lab[order]
    counts = torch.bincount(lab, minlength=nlists)
    rank = (torch.arange(lab.numel(), device=lab.device)
            - (torch.cumsum(counts, 0) - counts)[ls])    # rank in its list
    shard_of = rank % nshards
    src = order[torch.sort(shard_of, stable=True).indices]
    cnt = torch.bincount(shard_of * nlists + ls, minlength=nshards * nlists)
    cnt = cnt.reshape(nshards, nlists).cpu().numpy()
    return cnt, list(torch.split(src, cnt.sum(1).tolist()))


@dataclass
class IVFShard:
    """One shard's slice of every posting list: its rows list-contiguous
    in an f32 store, the global row of each slot, and per-list
    offset / count (int32, on the shard's device)."""

    vecs: torch.Tensor
    rows: torch.Tensor
    off: torch.Tensor
    cnt: torch.Tensor
    max_segs: int

    @classmethod
    def make(cls, vecs, rows, cnt: np.ndarray, device: torch.device,
             off: Optional[np.ndarray] = None) -> "IVFShard":
        """``off`` defaults to the exclusive cumsum of ``cnt`` (the
        shard's lists back to back)."""
        if off is None:
            off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        dev = torch.device(device)
        as_t = lambda a, dt: as_tensor(a).to(dev, dt)
        return cls(as_t(vecs, torch.float32), as_t(rows, torch.int32),
                   as_t(np.asarray(off, np.int32), torch.int32),
                   as_t(np.asarray(cnt, np.int32), torch.int32),
                   PS.segments_for(int(np.max(cnt, initial=1))))


def ivf_shards(mesh: Mesh, xdev: torch.Tensor, cnt: np.ndarray,
               src: Sequence[torch.Tensor]) -> List[IVFShard]:
    """The corpus (f32, on one device) in ``interleaved_layout``'s
    layout: each shard's rows gathered and placed on its device."""
    return [IVFShard.make(xdev[rows], rows, cnt[s], dev)
            for s, (rows, dev) in enumerate(zip(src, mesh.shard_devices()))]


def shards_from_arrays(mesh: Mesh, vecs, rows, off, cnt) -> List[IVFShard]:
    """Shards from a JAX index's stacked arrays ([S, cap, D], [S, cap],
    [S, nlists] twice), each cut to the rows its lists reach."""
    vecs, rows = np.asarray(vecs), np.asarray(rows)
    off, cnt = np.asarray(off), np.asarray(cnt)
    out = []
    for s, dev in enumerate(mesh.shard_devices()):
        end = int(np.max(off[s] + cnt[s], initial=0))
        out.append(IVFShard.make(vecs[s, :end], rows[s, :end], cnt[s], dev,
                                 off=off[s]))
    return out


def probe_k(k: int) -> int:
    if k > PS.SEG:
        raise ValueError(f"the sharded IVF search serves k <= {PS.SEG}, the "
                         f"probe kernel's per-probe cap (ivf_scan.SEG); "
                         f"got k={k}")
    return k


def ivf_search_shards(mesh: Mesh, q: torch.Tensor,
                      centroids: Sequence[torch.Tensor],
                      shards: Sequence[IVFShard], *, k: int, nprobe: int,
                      metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's top-k over its slice of the probed lists, merged:
    the coarse top-nprobe (once per device, from that device's copy of
    the centroids), ``probe_scan`` over the shard's store at
    ``kp_for(k)`` and its ``max_segs``, ``merge_probes``, the slots'
    global rows; then ``merge_shards``. Returns raw (sq-L2 or -ip)
    distances and global rows [B, k] on the lead device."""
    imetric = "ip" if metric == "ip" else "sqeuclidean"
    coarse = {}
    dists, rows = [], []
    for c, sh in zip(centroids, shards):
        dev = sh.vecs.device
        if dev not in coarse:
            qd = q.to(dev)
            coarse[dev] = (qd, _nearest_lists(qd, c, nprobe, metric=metric))
        qd, probes = coarse[dev]
        pd, pi = PS.probe_scan(qd, sh.vecs, sh.off[probes], sh.cnt[probes],
                               kp=PS.kp_for(k), max_segs=sh.max_segs,
                               metric=imetric)
        vals, slots = PS.merge_probes(pd, pi, k=k)
        dists.append(vals)
        rows.append(torch.where(slots >= 0,
                                sh.rows[slots.clamp(min=0).long()], -1))
    return merge_shards(mesh, dists, rows, k)


class IVFOverMesh:
    """What the 1-D and the 2-D sharded IVF share: the shards, the
    centroids replicated per device, the search, and ``from_arrays``."""

    def _place(self, shards: List[IVFShard], centroids) -> None:
        c = as_tensor(centroids).float()
        self._shards = shards
        self.centroids = c.cpu().numpy()
        self.nlists = len(self.centroids)
        self._cents = per_device(c, self.mesh.shard_devices())
        self.max_list = max([int(sh.cnt.max()) for sh in shards
                             if sh.cnt.numel()] + [1])

    @classmethod
    def from_arrays(cls, mesh: Mesh, *, centroids, vecs, rows, off, cnt,
                    ids, metric: str = "l2"):
        """The index over a JAX index's state, as numpy: ``centroids``,
        the stacked ``_vecs`` [S, cap, D] (``[H, C, cap, D]`` on a 2-D
        mesh), ``_ids`` [S, cap] (global rows, -1 in pad slots), ``_off``
        and ``_cnt`` [S, nlists], and ``_ids_np`` (external ids)."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.metric = D.canonical_metric(metric)
        self._ids_np = np.asarray(ids, np.int64)
        self.n = len(self._ids_np)
        self.dim = np.shape(centroids)[1]
        lead = lambda a, tail: np.asarray(a).reshape((mesh.size,) + tail)
        vecs = np.asarray(vecs)
        nl = np.shape(centroids)[0]
        self._place(shards_from_arrays(
            mesh, lead(vecs, vecs.shape[-2:]), lead(rows, (-1,)),
            lead(off, (nl,)), lead(cnt, (nl,))), centroids)
        self.build_seconds = {}
        return self

    def search(self, queries, k: int = 10, *, nprobe: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = f32_rows(queries, self.metric == "cosine")
        d, rows = ivf_search_shards(
            self.mesh, torch.from_numpy(q).to(self.mesh.lead), self._cents,
            self._shards, k=probe_k(min(k, max(self.n, 1))),
            nprobe=min(nprobe, self.nlists), metric=self.metric)
        return host_results(d, rows, self._ids_np, self.metric)


class ShardedIVFIndex(IVFOverMesh):
    """IVF with posting lists sharded round-robin across the mesh.

    Every shard holds a slice of each list (list-interleaved row
    sharding), so per-probe work is balanced; each shard scans its slice
    of the probed lists with the probe kernel and the partial top-k merge
    rides ``merge_shards`` (BASELINE.json config 5). The store is f32,
    as the JAX class keeps on every backend."""

    def __init__(self, vectors, *, nlists: int = 100,
                 mesh: Optional[Mesh] = None, metric: str = "l2",
                 ids=None, seed: int = 0):
        self.mesh = mesh or make_mesh()
        self.metric = D.canonical_metric(metric)
        x = f32_rows(vectors, self.metric == "cosine")
        self.n, self.dim = x.shape
        self._ids_np = np.asarray(ids if ids is not None
                                  else np.arange(self.n), np.int64)
        clock = _PhaseClock(self.mesh.lead)
        xdev = torch.from_numpy(x).to(self.mesh.lead)
        state = kmeans_fit(xdev, min(nlists, self.n), seed=seed)
        clock.mark("kmeans")
        labels = kmeans_predict(state.centroids, xdev)
        clock.mark("assign")
        cnt, src = interleaved_layout(labels, min(nlists, self.n),
                                      self.mesh.size)
        clock.mark("layout")
        shards = ivf_shards(self.mesh, xdev, cnt, src)
        del xdev, src
        clock.mark("upload")
        self._place(shards, state.centroids)
        self.build_seconds = clock.total()
