"""Data management: time travel, cold-tier compression, vacuum, rebalance.

Reference: NeuronDB/src/util/data_management.c:3-8 (time-travel queries,
cold-tier compression, vector-aware VACUUM, rebalance) and
src/storage/vector_wal.c (WAL delta compression — a stub in the
reference; real delta encoding here).

- Time travel: named snapshots of a VectorStore (AS OF semantics).
- Cold tier: demote rarely-queried rows to an int8 archive, restore on
  demand.
- Vacuum: tombstone compaction + capacity trimming.
- Rebalance: re-run k-means and rebuild IVF lists when imbalance drifts.
- Delta compression: XOR + zlib for vector snapshots.

Counterpart of ``neurondb_tpu/service/data_management.py``, over the
port's ``VectorStore``, ``chunked_knn``, ``quantize`` / ``dequantize``
and ``kmeans_fit``. One divergence the port must make: the JAX snapshot
keeps references to the store's arrays, which is safe only because JAX
arrays are immutable. The port's ``VectorStore`` writes in place (``add``
into its padded tensor, ``delete`` into its validity mask), so a
snapshot here copies the vectors, the mask and the host ids; holding
references would make ``search_as_of`` return the present.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Snapshot:
    name: str
    created_at: float
    vectors: Any            # torch tensor, a copy of the store's rows
    ids: Any                # host int64 ids, a copy
    valid: Any              # torch bool mask, a copy
    n: int


class TimeTravelStore:
    """Snapshot manager over a VectorStore (AS OF semantics)."""

    def __init__(self, store):
        self.store = store
        self._snapshots: Dict[str, Snapshot] = {}

    def snapshot(self, name: Optional[str] = None) -> str:
        name = name or f"snap-{len(self._snapshots)}-{int(time.time())}"
        s = self.store
        n = s._n
        self._snapshots[name] = Snapshot(
            name, time.time(), s._vecs[:n].clone(), s._ids[:n].copy(),
            s._valid[:n].clone(), n)
        return name

    def list_snapshots(self) -> List[Dict]:
        return [{"name": s.name, "created_at": s.created_at, "n": s.n}
                for s in self._snapshots.values()]

    def search_as_of(self, name: str, queries, k: int = 10):
        """Search the store as it existed at snapshot time."""
        from neurondb_tpu_torch.ops import topk as TK
        snap = self._snapshots[name]
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=snap.vectors.device)
        d, rows = TK.chunked_knn(
            q, snap.vectors.float(), k, metric=self.store.metric,
            chunk=max(1, min(65536, snap.vectors.shape[0])),
            valid=snap.valid)
        rows = rows.cpu().numpy()
        ids = np.where(rows >= 0, snap.ids[np.maximum(rows, 0)], -1)
        return d.cpu().numpy(), ids

    def drop_snapshot(self, name: str) -> None:
        self._snapshots.pop(name, None)


class ColdTier:
    """Quantized archive for cold rows (cold-tier compression parity)."""

    def __init__(self, fmt: str = "int8"):
        self.fmt = fmt
        # id -> (host code row, scale, offset, dim)
        self._archive: Dict[int, Tuple] = {}

    def demote(self, store, ids) -> int:
        """Move rows out of the hot store into the compressed archive."""
        from neurondb_tpu_torch.types.quantized import quantize
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        vecs = store.get(ids)
        q = quantize(np.asarray(vecs, np.float32), self.fmt,
                     device=store.device)
        codes = q.codes.cpu()          # a tensor: bf16 / fp8 codes too
        scale = q.scale.cpu().numpy()
        offset = q.offset.cpu().numpy()
        for j, i in enumerate(ids):
            self._archive[int(i)] = (codes[j], float(scale[j]),
                                     float(offset[j]), q.dim)
        store.delete(ids)
        return len(ids)

    def restore(self, store, ids) -> int:
        """Bring archived rows back into the hot store (dequantized)."""
        from neurondb_tpu_torch.types.quantized import Quantized, dequantize
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        found = []
        ents = []
        for i in ids:
            ent = self._archive.pop(int(i), None)
            if ent is None:
                continue
            ents.append(ent)
            found.append(int(i))
        if ents:
            dev = store.device
            q = Quantized(
                torch.stack([e[0] for e in ents]).to(dev),
                torch.tensor([e[1] for e in ents], dtype=torch.float32,
                             device=dev),
                torch.tensor([e[2] for e in ents], dtype=torch.float32,
                             device=dev), self.fmt, ents[0][3])
            store.add(dequantize(q), ids=np.asarray(found))
        return len(found)

    @property
    def size(self) -> int:
        return len(self._archive)


def vacuum(store, *, min_tombstone_ratio: float = 0.0) -> Dict:
    """Vector-aware VACUUM: compact tombstones, report reclaimed rows."""
    before = store.size
    live = len(store)
    ratio = (before - live) / before if before else 0.0
    if ratio <= min_tombstone_ratio:
        return {"ran": False, "tombstone_ratio": ratio}
    t0 = time.time()
    store.compact()
    return {"ran": True, "reclaimed_rows": before - live,
            "seconds": time.time() - t0}


def rebalance_ivf(index, *, imbalance_threshold: float = 4.0) -> Dict:
    """Re-train centroids + rebuild lists when the max/mean list-size
    ratio exceeds the threshold (k-means over every row, seeded
    ``index._seed + 1`` as in the JAX module)."""
    st = index.stats()
    if st["imbalance"] < imbalance_threshold and not index._spill:
        return {"ran": False, "imbalance": st["imbalance"]}
    index.rebuild_lists()
    from neurondb_tpu_torch.ml.kmeans import kmeans_fit
    xdev = torch.from_numpy(np.ascontiguousarray(index._x)).to(index.device)
    state = kmeans_fit(xdev, index.nlists, seed=index._seed + 1)
    index.centroids = state.centroids
    index._build_lists(index._x, xdev=xdev)
    return {"ran": True, "imbalance_before": st["imbalance"],
            "imbalance_after": index.stats()["imbalance"]}


def delta_compress(base: np.ndarray, new: np.ndarray) -> bytes:
    """Delta-encode a vector snapshot against a base (XOR of float bits +
    zlib). The reference's vector_wal.c stub only prepends 'COMPRESSED:';
    this is the real thing."""
    b = np.ascontiguousarray(base, np.float32).view(np.uint32)
    n = np.ascontiguousarray(new, np.float32).view(np.uint32)
    if b.shape != n.shape:
        raise ValueError("delta_compress requires equal shapes")
    delta = np.bitwise_xor(b, n)
    return zlib.compress(delta.tobytes(), level=6)


def delta_decompress(base: np.ndarray, blob: bytes) -> np.ndarray:
    b = np.ascontiguousarray(base, np.float32).view(np.uint32)
    delta = np.frombuffer(zlib.decompress(blob), np.uint32).reshape(b.shape)
    return np.bitwise_xor(b, delta).view(np.float32).copy()
