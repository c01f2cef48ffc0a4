"""Sparse vector types: ``sparsevec`` parity as a padded COO batch.

Counterpart of ``neurondb_tpu/types/sparse.py``: a batch of sparse
vectors is indices [N, S] int32 (pad = -1) + values [N, S] f32 with a
fixed slot budget S; padded slots add 0 to every reduction, and only
``to_dense`` scatters into a dense [N, dim] buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device


@dataclass
class SparseVectors:
    """Padded batch of sparse vectors. indices: [N, S] int32 (-1 = pad,
    ascending within a row), values: [N, S] f32, dim: logical dimension."""

    indices: torch.Tensor
    values: torch.Tensor
    dim: int

    @classmethod
    def from_dense(cls, x, slots: Optional[int] = None,
                   device=None) -> "SparseVectors":
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                       np.float32)
        if x.ndim == 1:
            x = x[None, :]
        n, d = x.shape
        nnz = (x != 0).sum(axis=1)
        s = int(slots if slots is not None else max(int(nnz.max()), 1))
        idx = np.full((n, s), -1, np.int32)
        val = np.zeros((n, s), np.float32)
        for i in range(n):
            nz = np.nonzero(x[i])[0][:s]
            idx[i, :len(nz)] = nz
            val[i, :len(nz)] = x[i, nz]
        dev = resolve_device(device)
        return cls(torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev), d)

    @classmethod
    def from_coo(cls, indices, values, dim: int, device=None) -> "SparseVectors":
        dev = resolve_device(device)
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.int32, device=dev)
        val = torch.as_tensor(np.asarray(values), dtype=torch.float32,
                              device=dev)
        if idx.ndim == 1:
            idx, val = idx[None, :], val[None, :]
        return cls(idx, torch.where(idx >= 0, val, 0.0), dim)

    @property
    def mask(self) -> torch.Tensor:
        return self.indices >= 0

    @property
    def nnz(self) -> torch.Tensor:
        return self.mask.sum(1)

    def _vals(self) -> torch.Tensor:
        return torch.where(self.mask, self.values, 0.0)

    def to_dense(self) -> torch.Tensor:
        n = self.indices.shape[0]
        dense = torch.zeros(n, self.dim, dtype=torch.float32,
                            device=self.values.device)
        rows = torch.arange(n, device=dense.device)[:, None].expand_as(
            self.indices)
        safe = torch.where(self.mask, self.indices, 0).long()
        return dense.index_put_((rows, safe), self._vals(), accumulate=True)

    def norm(self) -> torch.Tensor:
        v = self._vals()
        return torch.sqrt((v * v).sum(1))

    def normalize(self) -> "SparseVectors":
        n = torch.clamp(self.norm(), min=1e-30)[:, None]
        return SparseVectors(self.indices, self.values / n, self.dim)


def sparse_inner_product(a: SparseVectors, b: SparseVectors) -> torch.Tensor:
    """Rowwise x.y of aligned batches -> [N] (the ``<*>`` operator): a
    join of the padded slots, S_a x S_b a row."""
    ia, ib = a.indices, b.indices
    eq = (ia[:, :, None] == ib[:, None, :]) & (ia[:, :, None] >= 0)
    prod = a._vals()[:, :, None] * b._vals()[:, None, :]
    return (eq * prod).sum((1, 2))


def sparse_l2_distance(a: SparseVectors, b: SparseVectors) -> torch.Tensor:
    aa = (a._vals() ** 2).sum(1)
    bb = (b._vals() ** 2).sum(1)
    ab = sparse_inner_product(a, b)
    return torch.sqrt(torch.clamp(aa + bb - 2.0 * ab, min=0.0))


def sparse_cosine_distance(a: SparseVectors, b: SparseVectors) -> torch.Tensor:
    ab = sparse_inner_product(a, b)
    den = torch.clamp(a.norm() * b.norm(), min=1e-30)
    return 1.0 - torch.where(den > 1e-30, ab / den, 0.0)


def sparse_dense_matmul(sp: SparseVectors, dense: torch.Tensor) -> torch.Tensor:
    """Sparse rows [N, S] x dense [D, M] -> [N, M] by gather."""
    safe = torch.where(sp.mask, sp.indices, 0).long()
    gathered = dense[safe]                              # [N, S, M]
    return (gathered * sp._vals()[:, :, None]).sum(1)
