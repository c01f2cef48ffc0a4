"""Sharded HNSW: a graph per shard, the routed beam on each, one merge.

Counterpart of ``neurondb_tpu/parallel/sharded_hnsw.py``. The reference's
distributed fan-out takes any ``%s_ann_index`` shard
(NeuronDB/src/util/distributed.c:151-154) and merges shard-major
(distributed.c:320); here:

- rows split round-robin across shards (row i -> shard i % S), so every
  shard's graph sees the whole distribution;
- an independent bulk-built ``HNSWIndex`` per shard (seed + s), on the
  shard's device: where a shard holds more than
  ``hnsw.EXACT_KNN_MAX_ROWS`` rows its k-NN bootstrap is the IVF
  self-query, which runs the grouped scan kernel
  ``csrc/ivf_scan_grouped.cu`` on the card;
- the queries copied to each shard's device, the routed level-0 beam
  (``hnsw._query_search_routed``) on each shard's own graph, then the
  hierarchical merge (``mesh.merge_shards``).

Each global row lives in one shard, so the merged top-k holds no id
twice.

Deliberate divergences from the JAX package:
- each shard keeps its own tensors: the JAX package pads every shard's
  router, store and graph to common shapes (far-away router pads) and the
  query batch to a power of two, for one ``shard_map`` compile; neither
  is needed here;
- the beam checks convergence on the host every 8 steps, as the port's
  ``HNSWIndex`` search does, and searches in sub-batches that bound the
  visited bitmap (``HNSWIndex.search``'s rule);
- the shards always span the whole mesh (the JAX class's ``axes`` subset
  option is not ported); ``stats()["axes"]`` names the mesh's axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_store_dtype
from neurondb_tpu_torch.index.hnsw import HNSWIndex, _query_search_routed
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.parallel.mesh import (Mesh, as_tensor, make_mesh,
                                              merge_shards, per_device)
from neurondb_tpu_torch.parallel.sharded import host_results


@dataclass
class HNSWShard:
    """One shard's graph on its device: router centroids and their
    representative rows, the store, |x|^2, level-0 adjacency and each
    local row's global row (-1 past the shard's rows)."""

    cents: torch.Tensor
    reps: torch.Tensor
    vecs: torch.Tensor
    sqn: torch.Tensor
    nbr0: torch.Tensor
    gids: torch.Tensor


class ShardedHNSWIndex:
    """HNSW graphs sharded over a device mesh (1-D or ``(dcn, ici)``)."""

    def __init__(self, vectors, *, mesh: Optional[Mesh] = None,
                 metric: str = "l2", m: int = 16,
                 ef_construction: Optional[int] = None,
                 ef_search: Optional[int] = None, ids=None, seed: int = 0):
        self.mesh = mesh or make_mesh()
        self.metric = D.canonical_metric(metric)
        x = np.asarray(vectors, np.float32)
        self.n, self.dim = x.shape
        nsh = self.n_shards = self.mesh.size
        if self.n < nsh:
            raise ValueError(f"need >= {nsh} rows for {nsh} shards")
        self._ids_np = np.asarray(ids if ids is not None
                                  else np.arange(self.n), np.int64)
        self._shards: List[HNSWShard] = []
        self.build_seconds = {}
        for s, dev in enumerate(self.mesh.shard_devices()):
            rows = np.arange(s, self.n, nsh)
            sub = HNSWIndex(x[rows], m=m, ef_construction=ef_construction,
                            ef_search=ef_search, metric=metric,
                            seed=seed + s, build_mode="bulk", device=dev)
            if sub._router is None:  # pragma: no cover - bulk always routes
                raise RuntimeError("per-shard bulk build produced no router")
            gids = torch.full((sub._ncap,), -1, dtype=torch.int32, device=dev)
            gids[:sub.n] = torch.from_numpy(rows.astype(np.int32)).to(dev)
            self._shards.append(HNSWShard(
                sub._router["centroids"], sub._router["reps"], sub._vecs,
                sub._sqnorms, sub._nbr0, gids))
            for phase, secs in sub.build_seconds.items():
                self.build_seconds[phase] = \
                    self.build_seconds.get(phase, 0.0) + secs
            self.ef_search = sub.ef_search
            del sub

    @classmethod
    def from_arrays(cls, mesh: Mesh, *, cents, reps, vecs, sqn, nbr0, gids,
                    ids, metric: str = "l2", ef_search: int = 64
                    ) -> "ShardedHNSWIndex":
        """The index over a JAX ``ShardedHNSWIndex``'s state, as numpy:
        the stacked ``_cents``, ``_reps``, ``_vecs``, ``_sqn``, ``_nbr0``,
        ``_gids`` ([S, ...], padded to common shapes, kept as given) and
        ``_ids_np``. The store takes the port's store dtype."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.metric = D.canonical_metric(metric)
        self._ids_np = np.asarray(ids, np.int64)
        self.n = len(self._ids_np)
        self.dim = np.shape(vecs)[-1]
        self.n_shards = mesh.size
        self.ef_search = int(ef_search)
        self.build_seconds = {}
        self._shards = []
        for s, dev in enumerate(mesh.shard_devices()):
            t = lambda a, dt: as_tensor(np.asarray(a)[s]).to(dev, dt)
            self._shards.append(HNSWShard(
                t(cents, torch.float32), t(reps, torch.int32),
                t(vecs, resolve_store_dtype(dev)), t(sqn, torch.float32),
                t(nbr0, torch.int32), t(gids, torch.int32)))
        return self

    @property
    def _imetric(self) -> str:
        return "ip" if self.metric == "ip" else "sqeuclidean"

    def search(self, queries, k: int = 10, *, ef: Optional[int] = None,
               expand: int = 4, router_topr: int = 4,
               max_steps: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        ef = max(int(ef or self.ef_search), k)
        kk = min(k, self.n)
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))
                             ).to(self.mesh.lead)
        if self.metric == "cosine":
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1,
                                                         keepdim=True),
                                min=1e-30)
        expand = max(1, expand)
        steps = int(max_steps or ((2 * ef + 32) // expand + 16))
        dists, rows = [], []
        for qd, sh in zip(per_device(q, self.mesh.shard_devices()),
                          self._shards):
            # the visited bitmap is [B, Ncap / 32] int32 words
            batch = int(max(64, min(4096, (1 << 32) // sh.nbr0.shape[0])))
            bd, bi = [], []
            for s in range(0, qd.shape[0], batch):
                d, i = _query_search_routed(
                    qd[s:s + batch], sh.cents, sh.reps, sh.vecs, sh.sqn,
                    sh.nbr0, metric=self._imetric, ef=ef, max_steps=steps,
                    expand=expand, topr=min(router_topr, ef))
                bd.append(d[:, :kk])
                bi.append(i[:, :kk])
            bi = torch.cat(bi)
            gid = torch.where(bi >= 0, sh.gids[bi.clamp(min=0)], -1)
            dists.append(torch.where(gid >= 0, torch.cat(bd), TK.NEG_FILL))
            rows.append(gid)
        d, r = merge_shards(self.mesh, dists, rows, kk)
        return host_results(d, r, self._ids_np, self.metric)

    def stats(self):
        return {"kind": "sharded_hnsw", "n": self.n, "dim": self.dim,
                "shards": self.n_shards, "axes": list(self.mesh.axis_names),
                "metric": self.metric}
