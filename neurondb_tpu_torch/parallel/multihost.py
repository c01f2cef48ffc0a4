"""Two-level (DCN x ICI) sharding: the DEEP-100M topology.

Counterpart of ``neurondb_tpu/parallel/multihost.py`` (BASELINE.json
config 5): a ``("dcn", "ici")`` mesh of hosts x devices per host, rows
sharded over both axes (each shard holds N / (H * C) rows), and the
hierarchical merge: each shard's top-k, merged within each host row onto
its first device (ICI), then across the hosts onto the lead device (DCN),
so the cross-host step carries [B, k] per host, not per shard
(``mesh.merge_shards`` reduces the last axis first). Ties resolve
shard-major, as in the flat merge.

``MultiHostIVFIndex.from_chunks`` builds without the whole corpus in
hand: the coarse quantizer trains on a bounded sample
(``kmeans_fit_2d``), then each chunk is routed to its shards. Given a
zero-argument callable that returns a fresh iterator, the build streams
in three passes (sample and train; labels and within-list ranks; then
once per shard, filling only that shard's rows and placing them on its
device), so the host holds one shard's rows and two [N] arrays at most.
Each shard searches as ``ShardedIVFIndex``'s do, on the probe kernel.

Deliberate divergences from the JAX package:
- ``kmeans_fit_2d``'s k-means++ seeding draws the same numpy random
  choices as the JAX package's, with the distance updates on the lead
  device (the JAX package runs them in numpy on the host);
- the training sample is not padded with zero rows to a multiple of the
  shard count (the JAX package's padding rows join the k-means as data),
  and ``nlists`` becomes the number of centroids trained in both build
  paths (the JAX package's buffered path keeps the asked ``nlists``);
- ``_assign_host`` and ``add_chunk`` take their argmin on the mesh's lead
  device (ties to the lowest centroid), in row chunks;
- per-shard tensors hold each shard's own rows: no padding to a common
  capacity.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from neurondb_tpu_torch.index.hnsw import _PhaseClock
from neurondb_tpu_torch.ml.kmeans import kmeans_predict
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.parallel.mesh import (Mesh, _devices, as_tensor,
                                              shard_rows)
from neurondb_tpu_torch.parallel.sharded import (IVFOverMesh, IVFShard,
                                                 ShardedFlatIndex, f32_rows,
                                                 interleaved_layout,
                                                 ivf_shards,
                                                 sharded_kmeans_step,
                                                 sharded_knn)

AXES = ("dcn", "ici")


def make_mesh_2d(n_hosts: Optional[int] = None,
                 chips_per_host: Optional[int] = None, *,
                 device=None) -> Mesh:
    """(hosts, devices-per-host) mesh with axes ``("dcn", "ici")``.
    Defaults: one host row of every visible card. ``device`` as
    ``make_mesh``'s; a CPU mesh needs ``chips_per_host``."""
    n_hosts = 1 if n_hosts is None else n_hosts
    if chips_per_host is None:
        chips_per_host = len(_devices(None, device)) // n_hosts
    devs = np.empty(n_hosts * chips_per_host, dtype=object)
    devs[:] = _devices(n_hosts * chips_per_host, device)
    return Mesh(devs.reshape(n_hosts, chips_per_host), AXES)


def knn_2d(mesh: Mesh, queries: torch.Tensor, base, ids, valid, k: int, *,
           metric: str = "l2"):
    """Exact k-NN over a base row-sharded across (dcn, ici):
    ``sharded_knn``, whose merge is ICI then DCN on a 2-D mesh."""
    return sharded_knn(mesh, queries, base, ids, valid, k, metric=metric)


class MultiHostFlatIndex(ShardedFlatIndex):
    """Exact k-NN sharded over a (dcn, ici) mesh; k is cut to n."""

    def __init__(self, vectors, *, mesh: Optional[Mesh] = None,
                 metric: str = "l2", ids=None):
        super().__init__(vectors, mesh=mesh or make_mesh_2d(), metric=metric,
                         ids=ids)

    def search(self, queries, k: int = 10):
        return super().search(queries, k=min(k, self.n))


def _rows_at(parts, idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows ``idx`` (sorted, global: the shards' rows back to back) of a
    row-sharded array, gathered in order onto ``device``."""
    ends = np.cumsum([p.shape[0] for p in parts])
    out = []
    for s, p in enumerate(parts):
        lo = ends[s] - p.shape[0]
        mine = idx[(idx >= lo) & (idx < ends[s])] - lo
        out.append(p[torch.from_numpy(mine).to(p.device)].to(device))
    return torch.cat(out).float()


def _kmeanspp(x_sharded, nlists: int, seed: int, device: torch.device
              ) -> torch.Tensor:
    """The JAX package's k-means++ seeding on a bounded sample: the same
    numpy draws, the squared distances kept on ``device``."""
    n = sum(p.shape[0] for p in x_sharded)
    rng = np.random.default_rng(seed)
    pick = rng.choice(n, size=min(n, max(nlists * 16, 4096)), replace=False)
    smp = _rows_at(x_sharded, np.sort(pick), device)
    kc = min(nlists, len(smp))
    chosen = torch.empty((kc, smp.shape[1]), dtype=torch.float32,
                         device=device)
    chosen[0] = smp[int(rng.integers(len(smp)))]
    d2min = ((smp - chosen[0]) ** 2).sum(1)
    for i in range(1, kc):
        dm = d2min.cpu().numpy()
        p = dm / max(dm.sum(), 1e-30)
        chosen[i] = smp[int(rng.choice(len(smp), p=p))]
        d2min = torch.minimum(d2min, ((smp - chosen[i]) ** 2).sum(1))
    return chosen


def kmeans_fit_2d(mesh: Mesh, x_sharded, nlists: int, *, iters: int = 25,
                  seed: int = 0, init=None) -> torch.Tensor:
    """Lloyd's over row-sharded data (per-shard lists of tensors):
    ``sharded_kmeans_step``, whose psum runs over both axes, until
    ``iters`` steps or the inertia improves by at most 1e-3 of itself.
    ``init`` defaults to k-means++ on a sample of max(16 nlists, 4096)
    rows. Returns the centroids on the lead device."""
    if init is None:
        init = _kmeanspp(x_sharded, nlists, seed, mesh.lead)
    c = as_tensor(init).float().to(mesh.lead)
    prev = np.inf
    for _ in range(iters):
        c, inertia = sharded_kmeans_step(mesh, x_sharded, c)
        cur = float(inertia)
        if prev - cur <= 1e-3 * max(prev, 1e-30):
            break
        prev = cur
    return c


class MultiHostIVFIndex(IVFOverMesh):
    """IVF over a (dcn, ici) mesh with chunked ingest.

    Layout: every shard holds an interleaved slice of each posting list
    (round-robin by within-list rank over all H * C shards), so per-probe
    work is balanced; a search merges ICI then DCN.

    Two build modes (``from_chunks``):
    - a plain iterable: chunks are buffered on the host for the layout
      (host peak about one corpus copy);
    - a zero-argument callable returning a fresh iterator per call: the
      source is read once per shard, and the host holds one shard's rows
      plus two [N] arrays at most."""

    def __init__(self, *, nlists: int, dim: int,
                 mesh: Optional[Mesh] = None, metric: str = "l2"):
        self.mesh = mesh or make_mesh_2d()
        self.metric = D.canonical_metric(metric)
        self.nlists = nlists
        self.dim = dim
        self.n = 0
        self.centroids = None
        self._pending = []            # host-side (vecs, labels)
        self._ids_np = np.zeros((0,), np.int64)
        self.build_seconds = {}

    def _normalized(self, x) -> np.ndarray:
        return f32_rows(x, self.metric == "cosine")

    def _train(self, smp: np.ndarray, seed: int) -> None:
        smp = self._normalized(smp)
        c = kmeans_fit_2d(self.mesh, shard_rows(self.mesh, smp),
                          min(self.nlists, len(smp)), seed=seed)
        self.centroids = c.cpu().numpy()
        self.nlists = len(self.centroids)
        self._cent_lead = c

    @classmethod
    def from_chunks(cls, chunks: Iterable[np.ndarray], *, nlists: int,
                    mesh: Optional[Mesh] = None, metric: str = "l2",
                    sample_cap: int = 200_000, seed: int = 0
                    ) -> "MultiHostIVFIndex":
        """Build from [n_i, D] chunks. Pass a zero-argument callable for
        the bounded-memory streaming build; a plain iterable is buffered
        on the host."""
        if callable(chunks):
            return cls._from_chunk_factory(
                chunks, nlists=nlists, mesh=mesh, metric=metric,
                sample_cap=sample_cap, seed=seed)
        chunks = iter(chunks)
        first = np.asarray(next(chunks), np.float32)
        self = cls(nlists=nlists, dim=first.shape[1], mesh=mesh,
                   metric=metric)
        clock = _PhaseClock(self.mesh.lead)
        rng = np.random.default_rng(seed)
        sample = [first[rng.choice(len(first),
                                   min(len(first), sample_cap // 2),
                                   replace=False)]] if len(first) else []
        buffered = [first]
        for ch in chunks:
            ch = np.asarray(ch, np.float32)
            buffered.append(ch)
            take = min(len(ch), max(1, sample_cap // 8))
            sample.append(ch[rng.choice(len(ch), take, replace=False)])
        self._train(np.concatenate(sample)[:sample_cap], seed)
        clock.mark("kmeans")
        for ch in buffered:
            self.add_chunk(ch)
        clock.mark("assign")
        self.finalize()
        self.build_seconds = dict(self.build_seconds, **clock.total())
        return self

    @classmethod
    def _from_chunk_factory(cls, factory, *, nlists: int, mesh, metric,
                            sample_cap: int, seed: int
                            ) -> "MultiHostIVFIndex":
        """Streaming build: pass 1 samples and trains the coarse
        quantizer; pass 2 assigns every chunk and records [N] labels and
        within-list ranks; pass 3 runs once per shard, filling only that
        shard's rows and placing them on its device before the next."""
        rng = np.random.default_rng(seed)
        # ---- pass 1: sample + train ----
        sample, dim = [], None
        for ch in factory():
            ch = np.asarray(ch, np.float32)
            dim = ch.shape[1]
            take = min(len(ch), max(1, sample_cap // 8))
            sample.append(ch[rng.choice(len(ch), take, replace=False)])
        self = cls(nlists=nlists, dim=dim, mesh=mesh, metric=metric)
        clock = _PhaseClock(self.mesh.lead)
        self._train(np.concatenate(sample)[:sample_cap], seed)
        clock.mark("kmeans")
        # ---- pass 2: labels + within-list ranks (O(N) on the host) ----
        labels_parts, ranks_parts = [], []
        running = np.zeros(self.nlists, np.int64)
        for ch in factory():
            lab = self._assign_host(np.asarray(ch, np.float32))
            order = np.argsort(lab, kind="stable")
            ls = lab[order]
            starts = np.searchsorted(ls, np.arange(self.nlists))
            rank = np.empty(len(lab), np.int64)
            rank[order] = np.arange(len(lab)) - starts[ls] + running[ls]
            running += np.bincount(lab, minlength=self.nlists)
            labels_parts.append(lab.astype(np.int32))
            ranks_parts.append(rank)
        labels = np.concatenate(labels_parts)
        ranks = np.concatenate(ranks_parts)
        self.n = n = len(labels)
        self._ids_np = np.arange(n, dtype=np.int64)
        clock.mark("assign")
        # shard s of list l holds the ranks congruent to s mod nsh
        nsh = self.mesh.size
        cnt = np.stack([np.maximum((running - s + nsh - 1) // nsh, 0)
                        for s in range(nsh)])
        off = np.zeros_like(cnt)
        off[:, 1:] = np.cumsum(cnt[:, :-1], axis=1)
        shard_of = ranks % nsh
        slot = off[shard_of, labels] + ranks // nsh
        del ranks
        clock.mark("layout")
        # ---- pass 3: one shard at a time ----
        shards = []
        for s, dev in enumerate(self.mesh.shard_devices()):
            xs = np.zeros((int(cnt[s].sum()), self.dim), np.float32)
            ii = np.full(len(xs), -1, np.int32)
            row0 = 0
            for ch in factory():
                ch = self._normalized(ch)
                e = row0 + len(ch)
                mine = shard_of[row0:e] == s
                xs[slot[row0:e][mine]] = ch[mine]
                ii[slot[row0:e][mine]] = np.arange(row0, e)[mine]
                row0 = e
            shards.append(IVFShard.make(xs, ii, cnt[s], dev))
            del xs, ii
        clock.mark("upload")
        self._place(shards, self._cent_lead)
        self.max_list = max(int(running.max()) if n else 1, 1)
        self.build_seconds = clock.total()
        return self

    def _assign_host(self, x: np.ndarray) -> np.ndarray:
        """Nearest centroid of each row, on the lead device (ties to the
        lowest centroid)."""
        xd = torch.from_numpy(self._normalized(x)).to(self.mesh.lead)
        return kmeans_predict(self._cent_lead, xd).cpu().numpy()

    def add_chunk(self, x: np.ndarray) -> None:
        x = self._normalized(x)
        labels = self._assign_host(x)
        rows = np.arange(self.n, self.n + len(x), dtype=np.int64)
        self.n += len(x)
        self._pending.append((x, labels))
        self._ids_np = np.concatenate([self._ids_np, rows])

    def finalize(self, ids=None) -> None:
        """Lay out every ingested chunk as per-shard interleaved slices
        and place them on the mesh. Re-callable (e.g. to swap external
        ids): the host copy of the layout inputs is kept."""
        if self._pending:
            self._x_host = np.concatenate([p[0] for p in self._pending])
            self._labels_host = np.concatenate([p[1] for p in self._pending])
        if ids is not None:
            self._ids_np = np.asarray(ids, np.int64)
        self._pending = []
        clock = _PhaseClock(self.mesh.lead)
        xdev = torch.from_numpy(self._x_host).to(self.mesh.lead)
        cnt, src = interleaved_layout(
            torch.from_numpy(self._labels_host).to(self.mesh.lead),
            self.nlists, self.mesh.size)
        clock.mark("layout")
        shards = ivf_shards(self.mesh, xdev, cnt, src)
        del xdev, src
        clock.mark("upload")
        self._place(shards, self._cent_lead)
        self.build_seconds = clock.total()
