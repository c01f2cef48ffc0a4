"""VectorStore — a device-resident vector table with ids and tombstones.

Counterpart of ``neurondb_tpu/store.py``: one padded ``[capacity, D]``
tensor on the store's device (f32 or bf16), host int64 external ids, a
validity mask and f32 squared norms taken from the f32 source. Deletes
are tombstones (mask flips) that ``compact`` drops (the neurandefrag
role). Capacity grows by doubling from 1,024. ``search`` is the exact
flat scan (``chunked_knn`` over the valid rows).

Divergences:

- writes are in place (``add`` into the padded tensor, ``delete`` into
  the mask), where the JAX package makes new arrays; a caller that keeps
  ``vectors`` / ``valid`` / ``sqnorms`` sees later writes, and a snapshot
  must copy them;
- ``get`` gathers the requested rows on the device and copies only those
  to the host (the JAX package copies the whole store); a bf16 store's
  rows come back as f32 numpy arrays holding the stored bf16 values
  (numpy has no bfloat16);
- ``compact`` gathers the survivors on the device and keeps each one's
  f32-source squared norm; the JAX package re-adds the stored rows, which
  for a bf16 store recomputes the norms from the bf16 values;
- ``search`` casts the store to f32 one scan chunk at a time, where the
  JAX package casts the whole store for every search; the distances are
  the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.types.quantized import Quantized, quantize


def _round_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


class VectorStore:
    """A mutable table of vectors: a host object owning device tensors."""

    def __init__(self, dim: int, *, dtype: str = "float32",
                 metric: str = "l2", capacity: int = 1024, device=None):
        cfg = get_config()
        if dim <= 0 or dim > cfg.max_dim:
            raise ValueError(
                f"dimension {dim} out of range (1..{cfg.max_dim})")  # neurondb.h:113
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown store dtype {dtype!r}; "
                             "known: float32, bfloat16")
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = D.canonical_metric(metric)
        self.dtype = dtype
        self._store_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self._capacity = _round_capacity(capacity)
        self._n = 0
        self._next_id = 0
        self._vecs = torch.zeros((self._capacity, dim), dtype=self._store_dt,
                                 device=self.device)
        # external ids stay host-side int64 (device int32 would truncate)
        self._ids = np.full((self._capacity,), -1, np.int64)
        self._valid = torch.zeros(self._capacity, dtype=torch.bool,
                                  device=self.device)
        self._sqnorms = torch.zeros(self._capacity, dtype=torch.float32,
                                    device=self.device)
        self._deleted = 0

    # ---- properties ----
    def __len__(self) -> int:
        return self._n - self._deleted

    @property
    def size(self) -> int:
        return self._n            # rows including tombstones

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def vectors(self) -> torch.Tensor:
        return self._vecs

    @property
    def ids(self) -> np.ndarray:
        return self._ids

    @property
    def valid(self) -> torch.Tensor:
        return self._valid

    @property
    def sqnorms(self) -> torch.Tensor:
        return self._sqnorms

    # ---- mutation ----
    def _grow_to(self, need: int) -> None:
        if need <= self._capacity:
            return
        new_cap = _round_capacity(need)
        pad = new_cap - self._capacity
        self._vecs = torch.cat([self._vecs, self._vecs.new_zeros(
            (pad, self.dim))])
        self._ids = np.pad(self._ids, (0, pad), constant_values=-1)
        self._valid = torch.cat([self._valid, self._valid.new_zeros(pad)])
        self._sqnorms = torch.cat([self._sqnorms, self._sqnorms.new_zeros(pad)])
        self._capacity = new_cap

    def _append(self, vecs: torch.Tensor, sqnorms: torch.Tensor,
                new_ids: np.ndarray) -> None:
        m = vecs.shape[0]
        self._grow_to(self._n + m)
        sl = slice(self._n, self._n + m)
        self._vecs[sl] = vecs.to(self._store_dt)
        self._ids[sl] = new_ids
        self._valid[sl] = True
        self._sqnorms[sl] = sqnorms
        self._n += m

    def add(self, vecs, ids=None) -> np.ndarray:
        """Append [M, D] vectors; returns assigned int64 ids."""
        if isinstance(vecs, torch.Tensor):
            v = vecs.to(self.device)
        else:
            v = torch.as_tensor(np.asarray(vecs), device=self.device)
        if v.ndim == 1:
            v = v[None, :]
        if v.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {v.shape[1]}")
        m = v.shape[0]
        if ids is None:
            new_ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
            self._next_id += m
        else:
            new_ids = np.asarray(ids, np.int64)
            if len(new_ids):
                self._next_id = max(self._next_id, int(new_ids.max()) + 1)
        vf = v.float()
        self._append(v, (vf * vf).sum(1), new_ids)
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone rows by external id; returns count removed."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        mask = np.isin(self._ids, ids) & self._valid.cpu().numpy()
        removed = int(mask.sum())
        if removed:
            self._valid[torch.from_numpy(np.nonzero(mask)[0]).to(
                self.device)] = False
        self._deleted += removed
        return removed

    def compact(self) -> None:
        """Physically drop tombstones (neurandefrag role)."""
        idx = torch.nonzero(self._valid[: self._n])[:, 0]
        vecs, sq = self._vecs[idx], self._sqnorms[idx]
        ids = self._ids[idx.cpu().numpy()]
        self.__init__(self.dim, dtype=self.dtype, metric=self.metric,
                      capacity=max(len(ids), 1024), device=self.device)
        if len(ids):
            self._next_id = int(ids.max()) + 1
            self._append(vecs, sq, ids)

    def get(self, ids) -> np.ndarray:
        """Stored rows of external ``ids`` (the last row holding an id, as
        the JAX package's dict lookup returns it); KeyError on a missing
        id."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        have = self._ids[: self._n]
        order = np.argsort(have, kind="stable")
        srt = have[order]
        loc = np.searchsorted(srt, ids, side="right") - 1
        bad = (loc < 0) | (srt[np.maximum(loc, 0)] != ids) if len(srt) \
            else np.ones(len(ids), bool)
        if bad.any():
            raise KeyError(int(ids[np.argmax(bad)]))
        rows = torch.from_numpy(order[loc]).to(self.device)
        return self._vecs[rows].float().cpu().numpy()

    # ---- search ----
    def search(self, queries, k: int = 10, *,
               metric: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact flat k-NN: (dists [B,k], ids [B,k]). The batched-query
        replacement for the <->-ordered index scan (SURVEY.md §7 API)."""
        cfg = get_config()
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.as_tensor(np.asarray(queries, np.float32),
                                device=self.device)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        m = D.canonical_metric(metric or self.metric)
        dists, rows = TK.chunked_knn(
            q, self._vecs, k, metric=m,
            chunk=min(cfg.scan_chunk, self._capacity),
            base_sqnorms=(self._sqnorms if m in ("l2", "sqeuclidean", "cosine")
                          else None),
            valid=self._valid, recall_target=cfg.topk_recall_target)
        dists, rows = dists.cpu().numpy(), rows.cpu().numpy()
        out_ids = np.where(rows >= 0, self._ids[np.maximum(rows, 0)], -1)
        return (dists[0], out_ids[0]) if single else (dists, out_ids)

    # ---- quantization ----
    def quantized(self, fmt: str) -> Quantized:
        return quantize(self._vecs[: self._n].float(), fmt)
