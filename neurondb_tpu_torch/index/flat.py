"""Flat (exact) index: the ``<->`` / ``<=>`` / ``<#>`` brute-force scan.

Counterpart of ``FlatIndex`` in ``neurondb_tpu/index/flat.py``, over
``chunked_knn``. ``QuantizedFlatIndex`` waits for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK


class FlatIndex(BaseIndex):
    """Exact brute-force k-NN over an [N, D] device tensor."""

    kind = "flat"

    def __init__(self, vectors, *, metric: str = "l2", ids=None,
                 store_dtype: str = "float32", device=None):
        self.device = resolve_device(device)
        x = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        self.metric = D.canonical_metric(metric)
        self.dim = int(x.shape[1])
        self.n = int(x.shape[0])
        self._store_dtype = store_dtype
        dt = torch.bfloat16 if store_dtype == "bfloat16" else torch.float32
        self._vecs = x.to(dt)
        self._sqnorms = (x * x).sum(1)
        # external ids stay host-side int64
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(self.n, dtype=np.int64))

    def search(self, queries, k: int = 10, **kw) -> Tuple[np.ndarray, np.ndarray]:
        cfg = get_config()
        q, single = as_batch(queries, device=self.device)
        dists, rows = TK.chunked_knn(
            q, self._vecs.float(), k, metric=self.metric,
            chunk=min(cfg.scan_chunk, max(self.n, 1)),
            base_sqnorms=self._sqnorms)
        dists, rows = dists.cpu().numpy(), rows.cpu().numpy()
        ids = np.where(rows >= 0, self._ids[np.maximum(rows, 0)], -1)
        return (dists[0], ids[0]) if single else (dists, ids)

    def _state(self):
        return ({"vecs": self._vecs, "ids": self._ids},
                {"store_dtype": self._store_dtype, "n": self.n})

    def _load_state(self, arrays, meta, device=None):
        self.__init__(arrays["vecs"], metric=meta["metric"], ids=arrays["ids"],
                      store_dtype=meta.get("store_dtype", "float32"),
                      device=device)
