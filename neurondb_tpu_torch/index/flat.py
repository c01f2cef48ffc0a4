"""Flat indexes: the exact scan and the quantized scan + exact rerank.

Counterpart of ``neurondb_tpu/index/flat.py``. ``FlatIndex`` runs
``chunked_knn``. ``QuantizedFlatIndex`` is ``BASELINE.json`` config 3:
a coarse top-(R k) from the compressed codes, then exact distances from
the kept originals. Deliberate divergence: the JAX package holds a full
f32 dequantized copy of the codes for its coarse scan; this one
dequantizes each scan chunk (``config.scan_chunk`` rows) as it goes, so
the device holds the codes, their scales, one f32 norm a row and the
originals. The distances are ``dequantize``'s all the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.types.quantized import (CODE_DTYPES, Quantized,
                                                dequantize, quantize)


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


class QuantizedFlatIndex(BaseIndex):
    """Compressed flat scan with an optional exact rerank.

    ``search(k, rerank=R)``: coarse top-(R k) from the quantized codes,
    then exact distances on those candidates from the kept originals.
    R = 0 skips the rerank (the compressed scan alone). Binary codes
    score by Hamming distance whatever the metric; the rerank then
    orders by the metric."""

    kind = "quantized_flat"

    def __init__(self, vectors, *, fmt: str = "int8", metric: str = "l2",
                 ids=None, keep_originals: bool = True, device=None):
        self.device = resolve_device(device)
        x = torch.as_tensor(np.asarray(vectors, np.float32), device=self.device)
        self.metric = D.canonical_metric(metric)
        self.dim = int(x.shape[1])
        self.n = int(x.shape[0])
        self.fmt = fmt
        self.q = quantize(x, fmt)
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(self.n, dtype=np.int64))
        self._set_originals(x if keep_originals else None)

    def _set_originals(self, x) -> None:
        self._orig = x
        self._approx_sq = None
        if self.fmt != "binary":
            # |approx|^2 per row, from one chunk's dequantized rows at a time
            self._approx_sq = torch.cat([
                (a * a).sum(1) for a in self._approx_chunks(self._chunk())])

    def _chunk(self) -> int:
        return min(get_config().scan_chunk, max(self.n, 1))

    def _approx_chunks(self, chunk: int):
        for s in range(0, self.n, chunk):
            e = min(s + chunk, self.n)
            yield dequantize(Quantized(self.q.codes[s:e], self.q.scale[s:e],
                                       self.q.offset[s:e], self.fmt,
                                       self.q.dim))

    @property
    def compression_bytes(self) -> int:
        return self.q.nbytes

    @property
    def device_bytes(self) -> int:
        """Bytes this index holds on its device: codes, scales, offsets,
        the approximation's row norms and the originals."""
        held = [t for t in (self._approx_sq, self._orig) if t is not None]
        return self.q.nbytes + sum(t.numel() * t.element_size() for t in held)

    def _coarse(self, q: torch.Tensor, ck: int):
        """Coarse top-``ck`` (distances, rows) over the codes, chunk by
        chunk: Hamming distance for binary codes, else the metric over
        the dequantized rows. Ties keep the lowest row first, so the
        chunking leaves the result as one scan would give it."""
        chunk = self._chunk()
        B = q.shape[0]
        bvals = torch.full((B, ck), TK.NEG_FILL, dtype=torch.float32,
                           device=q.device)
        brows = torch.full((B, ck), -1, dtype=torch.int32, device=q.device)
        if self.fmt == "binary":
            qbits = quantize(q, "binary").codes
            parts = ((s, D.hamming_packed(qbits, self.q.codes[s:s + chunk])
                      .float()) for s in range(0, self.n, chunk))
        else:
            parts = ((s, D.pairwise_distance(
                q, a, self.metric,
                base_sqnorms=self._approx_sq[s:s + a.shape[0]]))
                for s, a in zip(range(0, self.n, chunk),
                                self._approx_chunks(chunk)))
        for s, d in parts:
            cv, cpos = TK.topk_smallest(d, ck)
            bvals, brows = TK.merge_topk(bvals, brows, cv,
                                         (cpos + s).to(torch.int32), ck)
        return bvals, brows

    def search(self, queries, k: int = 10, *, rerank: int = 4,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        q, single = as_batch(queries, device=self.device)
        coarse_k = max(k, min(self.n, k * max(rerank, 1)))
        cd, rows = self._coarse(q, min(coarse_k, self.n))
        if rerank and self._orig is not None:
            cand = self._orig[rows.clamp(min=0).long()]          # [B, ck, D]
            dd = exact_candidate_dist(q, cand, self.metric)
            dd = torch.where(rows >= 0, dd, TK.NEG_FILL)
            cd, pos = TK.topk_smallest(dd, k)
            rows = torch.gather(rows, 1, pos)
        else:
            cd, rows = cd[:, :k], rows[:, :k]
        cd, rows = cd.cpu().numpy(), rows.cpu().numpy()
        ids = np.where(rows >= 0, self._ids[np.maximum(rows, 0)], -1)
        return (cd[0], ids[0]) if single else (cd, ids)

    def _state(self):
        codes = self.q.codes
        if codes.dtype not in (torch.float16, torch.int8, torch.uint8):
            codes = codes.float()        # bf16 and fp8 leave as f32 values
        arrays = {"codes": codes.cpu().numpy(), "scale": self.q.scale,
                  "offset": self.q.offset, "ids": self._ids}
        if self._orig is not None:
            arrays["orig"] = self._orig
        return arrays, {"fmt": self.fmt, "n": self.n, "qdim": self.q.dim}

    def _load_state(self, arrays, meta, device=None):
        self.device = resolve_device(device)
        self.metric = meta["metric"]
        self.dim = meta["dim"]
        self.n = meta["n"]
        self.fmt = meta["fmt"]
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        self.q = Quantized(t(arrays["codes"], CODE_DTYPES[self.fmt]),
                           t(arrays["scale"]), t(arrays["offset"]),
                           self.fmt, meta["qdim"])
        self._ids = np.asarray(arrays["ids"], np.int64)
        self._set_originals(t(arrays["orig"]) if "orig" in arrays else None)


def exact_candidate_dist(q: torch.Tensor, cand: torch.Tensor,
                         metric: str) -> torch.Tensor:
    """q [B, D] against per-query candidates [B, C, D] -> [B, C]."""
    if metric in ("l2", "sqeuclidean"):
        d = q[:, None, :] - cand
        d2 = (d * d).sum(-1)
        return d2 if metric == "sqeuclidean" else torch.sqrt(
            torch.clamp(d2, min=0.0))
    if metric == "ip":
        return -torch.einsum("bd,bcd->bc", q, cand)
    if metric == "cosine":
        dots = torch.einsum("bd,bcd->bc", q, cand)
        qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        cn = torch.linalg.vector_norm(cand, dim=-1)
        den = torch.clamp(qn * cn, min=1e-30)
        return 1.0 - torch.where(den > 1e-30, dots / den,
                                 torch.zeros((), device=q.device))
    return torch.stack([D.pairwise_distance(qq[None], cc, metric)[0].float()
                        for qq, cc in zip(q, cand)])
