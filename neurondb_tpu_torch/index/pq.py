"""Product quantization + OPQ: compressed ANN with asymmetric distance.

Counterpart of ``neurondb_tpu/index/pq.py``. Per-subspace codebooks train
as one batched k-means over [n_sub, n, ds] (``kmeans_fit_batched``, the
JAX package's ``vmap``); encoding is a per-subspace batched GEMM argmin;
OPQ alternates PQ training with the Procrustes rotation
(``torch.linalg.svd``). The scan of ``PQIndex`` decodes code chunks and
scores them with a GEMM, as the JAX package does. Plain torch throughout:
the JAX module has no Pallas kernel.

``train_opq_rotation`` keeps the JAX package's order: the returned
codebooks were trained on the data rotated by the rotation before the
returned one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.ml.kmeans import kmeans_fit_batched
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK


def _subspaces(x: torch.Tensor, n_sub: int, ds: int) -> torch.Tensor:
    """[N, D] -> [n_sub, N, ds] (trailing dims past n_sub * ds dropped)."""
    return x[:, : n_sub * ds].reshape(x.shape[0], n_sub, ds).transpose(0, 1)


def train_pq_codebook(x: torch.Tensor, *, n_sub: int = 8, ksub: int = 256,
                      iters: int = 25, seed: int = 0) -> torch.Tensor:
    """[n_sub, ksub, ds] codebooks; all subspaces train in one batch."""
    ds = x.shape[1] // n_sub
    xs = _subspaces(x.float(), n_sub, ds).contiguous()
    return kmeans_fit_batched(xs, ksub, max_iter=iters, seed=seed).centroids


def pq_encode(codebooks: torch.Tensor, x: torch.Tensor,
              budget: int = 1 << 26) -> torch.Tensor:
    """[N, n_sub] codes (uint8 for ksub <= 256, else int32) via the
    per-subspace GEMM argmin (first index on ties), in row chunks whose
    [n_sub, chunk, ksub] distance block holds at most ``budget`` floats."""
    n_sub, ksub, ds = codebooks.shape
    n = x.shape[0]
    cb = codebooks.float()
    cb_sq = (cb * cb).sum(-1)[:, None, :]                  # [S, 1, K]
    codes = torch.empty((n, n_sub), device=x.device,
                        dtype=torch.uint8 if ksub <= 256 else torch.int32)
    chunk = max(1, budget // (n_sub * ksub))
    for s in range(0, n, chunk):
        xs = _subspaces(x[s:s + chunk].float(), n_sub, ds)  # [S, c, ds]
        d2 = ((xs * xs).sum(-1)[..., None] + cb_sq
              - 2.0 * (xs @ cb.transpose(1, 2)))
        codes[s:s + chunk] = torch.argmin(d2, dim=-1).T.to(codes.dtype)
    return codes


def pq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[N, n_sub*ds] reconstruction."""
    n_sub, _, ds = codebooks.shape
    sub = torch.arange(n_sub, device=codes.device)
    return codebooks[sub[None, :], codes.long()].reshape(codes.shape[0],
                                                         n_sub * ds)


def pq_asymmetric_distance(codebooks: torch.Tensor, q: torch.Tensor,
                           codes: torch.Tensor) -> torch.Tensor:
    """[B, N] squared ADC distances via per-subspace lookup tables."""
    n_sub, _, ds = codebooks.shape
    qs = _subspaces(q.float(), n_sub, ds)                  # [S, B, ds]
    cb = codebooks.float()
    tables = ((qs * qs).sum(-1)[..., None] + (cb * cb).sum(-1)[:, None, :]
              - 2.0 * (qs @ cb.transpose(1, 2)))           # [S, B, K]
    ci = codes.long()                                      # [N, S]
    per_sub = torch.stack([tables[j][:, ci[:, j]] for j in range(n_sub)])
    return torch.clamp(per_sub.sum(0), min=0.0)


def train_opq_rotation(x: torch.Tensor, *, n_sub: int = 8, ksub: int = 256,
                       pq_iters: int = 15, opq_iters: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R [D, D], codebooks): OPQ-NP alternating minimization. Each round
    trains codebooks on x @ R, encodes and decodes, and sets R to the
    Procrustes solution U V^T of x^T rec."""
    x = x.float()
    R = torch.eye(x.shape[1], device=x.device)
    cb = train_pq_codebook(x, n_sub=n_sub, ksub=ksub, iters=pq_iters)
    for _ in range(opq_iters):
        xr = x @ R
        cb = train_pq_codebook(xr, n_sub=n_sub, ksub=ksub, iters=pq_iters)
        rec = pq_decode(cb, pq_encode(cb, xr))
        u, _, vt = torch.linalg.svd(x.T @ rec, full_matrices=False)
        R = u @ vt
    return R, cb


def _pq_chunked_scan(q: torch.Tensor, codebooks: torch.Tensor,
                     codes: torch.Tensor, *, k: int, metric: str,
                     chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan over code chunks: decode each chunk, fused distance, a
    running top-k merge (query-time memory O(chunk * D))."""
    n = codes.shape[0]
    k = min(k, n)
    B = q.shape[0]
    q_sq = (q * q).sum(1)
    bv = torch.full((B, k), TK.NEG_FILL, dtype=torch.float32, device=q.device)
    bi = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for s in range(0, n, chunk):
        dec = pq_decode(codebooks, codes[s:s + chunk])     # [c, D]
        dots = q @ dec.T
        if metric == "ip":
            d = -dots
        else:
            d = torch.clamp(q_sq[:, None] + (dec * dec).sum(1)[None, :]
                            - 2.0 * dots, min=0.0)
        cv, cpos = TK.topk_smallest(d, min(k, d.shape[1]))
        bv, bi = TK.merge_topk(bv, bi, cv, (cpos + s).to(torch.int32), k)
    return bv, bi


class PQIndex(BaseIndex):
    """PQ (or OPQ) compressed index with asymmetric scan + optional exact
    rerank from kept originals."""

    kind = "pq"

    def __init__(self, vectors, *, n_sub: int = 8, ksub: int = 256,
                 metric: str = "l2", opq: bool = False, ids=None,
                 train_sample: int = 65536, keep_originals: bool = False,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        x = np.asarray(vectors, np.float32)
        m = "l2" if metric == "sqeuclidean" else D.canonical_metric(metric)
        if m not in ("l2", "cosine", "ip"):
            raise ValueError(f"pq supports l2/cosine/ip, got {metric}")
        self.metric = m
        self.dim = x.shape[1]
        self.n = x.shape[0]
        self.n_sub = n_sub
        self.ksub = min(ksub, max(self.n, 2))
        self.opq = opq
        self._spherical = self.metric == "cosine"
        if self._spherical:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        self._ids = np.asarray(ids if ids is not None else np.arange(self.n),
                               np.int64)
        rng = np.random.default_rng(seed)
        sample = x if self.n <= train_sample else \
            x[rng.choice(self.n, train_sample, replace=False)]
        xdev = torch.from_numpy(x).to(self.device)
        sdev = torch.from_numpy(np.ascontiguousarray(sample)).to(self.device)
        if opq:
            self.R, cb = train_opq_rotation(sdev, n_sub=n_sub, ksub=self.ksub)
            xr = xdev @ self.R
        else:
            self.R = None
            cb = train_pq_codebook(sdev, n_sub=n_sub, ksub=self.ksub)
            xr = xdev
        self.codebooks = cb
        self.codes = pq_encode(cb, xr)
        self._orig = xdev if keep_originals else None

    @property
    def code_bytes(self) -> int:
        return int(self.codes.numel() * self.codes.element_size())

    def search(self, queries, k: int = 10, *, rerank: int = 0,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        q, single = as_batch(queries, device=self.device)
        if rerank and self._orig is None:
            raise ValueError(
                "rerank requires keep_originals=True (the compressed codes "
                "alone cannot produce exact distances); build with "
                "PQIndex(..., keep_originals=True) or pass rerank=0")
        if self._spherical:
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                                min=1e-30)
        qr = q @ self.R if self.R is not None else q
        coarse_k = max(k, min(self.n, k * max(rerank, 1)))
        metric = "ip" if self.metric == "ip" else "sqeuclidean"
        d, rows = _pq_chunked_scan(qr, self.codebooks, self.codes,
                                   k=coarse_k, metric=metric)
        if rerank:
            cand = self._orig[rows.clamp(min=0).long()]        # [B, C, D]
            if self.metric == "ip":
                dd = -torch.einsum("bd,bcd->bc", q, cand)
            else:
                dd = ((q[:, None, :] - cand) ** 2).sum(-1)
            dd = torch.where(rows >= 0, dd, TK.NEG_FILL)
            d, pos = TK.topk_smallest(dd, k)
            rows = torch.gather(rows, 1, pos)
        else:
            d, rows = d[:, :k], rows[:, :k]
        if self.metric == "l2":
            d = torch.sqrt(torch.clamp(d, min=0.0))
        elif self.metric == "cosine":
            d = d * 0.5
        rows = rows.cpu().numpy()
        ids = np.where(rows >= 0, self._ids[np.maximum(rows, 0)], -1)
        d = d.cpu().numpy()
        return (d[0], ids[0]) if single else (d, ids)

    def _state(self):
        arrays = {"codebooks": self.codebooks, "codes": self.codes,
                  "ids": self._ids}
        if self.R is not None:
            arrays["R"] = self.R
        if self._orig is not None:
            arrays["orig"] = self._orig
        return arrays, {"n_sub": self.n_sub, "ksub": self.ksub,
                        "n": self.n, "opq": self.opq}

    def _load_state(self, arrays, meta, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.metric = meta["metric"]
        self.dim = meta["dim"]
        self.n = meta["n"]
        self.n_sub = meta["n_sub"]
        self.ksub = meta["ksub"]
        self.opq = meta["opq"]
        self._spherical = self.metric == "cosine"

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.codebooks = f32(arrays["codebooks"])
        codes = np.asarray(arrays["codes"])
        self.codes = torch.as_tensor(
            codes.astype(np.uint8 if self.ksub <= 256 else np.int32),
            device=dev)
        self._ids = np.asarray(arrays["ids"], np.int64)
        self.R = f32(arrays["R"]) if "R" in arrays else None
        self._orig = f32(arrays["orig"]) if "orig" in arrays else None
