"""IVF-PQ: coarse-quantized posting lists of PQ codes, exact rerank.

Counterpart of ``neurondb_tpu/index/ivfpq.py``. Posting lists hold
n_sub-byte PQ codes of the residual x - centroid (optionally OPQ-rotated)
in an aligned CSR: each list starts on a ``LIST_ALIGN`` = 128 column and
the codes end in a ``SEG`` = 1024 column tail, subspace-major
(``codes_t [n_sub, Npad]``) for the grouped scan. A search takes one of
two routes on every device:

- grouped (``_ivfpq_search_grouped``): centroid GEMM, top-nprobe,
  ``group_probes``, the per-tuple inputs of the ADC tables
  (``pq_tuple_inputs``: residual queries, constants, slot map), the
  fused PQ scan ``grouped_pq_scan_fused``, which builds the tables itself
  (the CUDA kernel on a CUDA tensor, its plain torch version on a CPU
  tensor; no table buffer), ``merge_partials``;
- segment (``_ivfpq_search_device``): per probe, 512-row segments decoded
  and scored with a GEMM, masking tombstoned rows. Taken while deletes
  are outstanding, because the grouped scan sees only codes and would
  score dead rows.

Either route's candidates then take the one exact rerank over the kept
originals (``_rerank``).

Deliberate divergences from the JAX package:
- the JAX package takes the segment route on every device but a TPU; the
  port takes the grouped route on every device;
- packed selection is read from ``config.ivf_select`` (packed keys when
  it is ``"packed"``, exact for ``"blockmin"`` and ``"exact"``; an
  unknown name raises), where the JAX package reads the env var
  ``NEURONDB_TPU_IVF_SELECT``; probe selection is exact;
- ``orig_dtype=None`` keeps bf16 originals on CUDA and f32 elsewhere (the
  JAX package's "bf16 on TPU");
- one rerank serves both routes and scores (q - x)^2, as the JAX
  package's segment route does; its grouped route, fused into one jit
  for the TPU, expands it as |q|^2 + |x|^2 - 2 q.x.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import get_config, resolve_device
from neurondb_tpu_torch.index.base import BaseIndex, as_batch
from neurondb_tpu_torch.index.ivf import select_bits
from neurondb_tpu_torch.index.pq import (pq_encode, train_opq_rotation,
                                         train_pq_codebook)
from neurondb_tpu_torch.ml.kmeans import kmeans_fit, kmeans_predict
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

SEGMENT = 512
ORIG_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}


def _ivfpq_search_device(q, centroids, codebooks, R, codes, row_ids,
                         offsets, counts, *, k: int, nprobe: int,
                         metric: str, max_segs: int, segment: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment route: per probe rank, each segment's codes are decoded
    and scored against the residual query; rows whose ``row_ids`` is -1
    (tombstoned) never enter the running top-k. Returns (raw distances,
    original rows) [B, k]."""
    B = q.shape[0]
    ns = codebooks.shape[0]
    cd = D.pairwise_distance(q, centroids,
                             "sqeuclidean" if metric != "ip" else "ip")
    _, probes = TK.topk_smallest(cd, nprobe)
    bvals = torch.full((B, k), TK.NEG_FILL, dtype=torch.float32,
                       device=q.device)
    bids = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    sub = torch.arange(ns, device=q.device)
    span = torch.arange(segment, device=q.device)
    for p in range(probes.shape[1]):
        pc = probes[:, p]
        off = offsets[pc].long()
        end = off + counts[pc].long()
        c = centroids[pc]                                  # [B, D]
        if metric == "ip":
            qc_dot = (q * c).sum(1)
        else:
            qc = (q - c) @ R                               # residual query
            qc_sq = (qc * qc).sum(1)
        for s in range(max_segs):
            rows = off[:, None] + s * segment + span[None, :]      # [B, S]
            in_list = rows < end[:, None]
            rows_safe = rows.clamp(0, codes.shape[0] - 1)
            cseg = codes[rows_safe].long()                 # [B, S, n_sub]
            dec = codebooks[sub, cseg].reshape(B, segment, -1)     # [B, S, D]
            if metric == "ip":
                d = -(qc_dot[:, None] + (dec @ q[:, :, None])[..., 0])
            else:
                dots = (dec @ qc[:, :, None])[..., 0]
                d = torch.clamp(qc_sq[:, None] + (dec * dec).sum(-1)
                                - 2.0 * dots, min=0.0)
            cand = torch.where(in_list, row_ids[rows_safe], -1)
            d = torch.where(in_list & (cand >= 0), d, TK.NEG_FILL)
            cv, cpos = TK.topk_smallest(d, min(k, segment))
            bvals, bids = TK.merge_topk(bvals, bids, cv,
                                        torch.gather(cand, 1, cpos), k)
    return bvals, bids


def _ivfpq_search_grouped(q, centroids, codebooks, R, codes_t, row_ids,
                          offsets, counts, nprobe: int, *, k: int,
                          metric: str, nprobe_pad: int, pos_bits: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped route: coarse centroid stage -> tuple grouping -> per-tuple
    ADC tables -> grouped PQ scan -> cross-probe merge -> original rows.
    Columns at or past ``nprobe`` probe the sentinel list."""
    nlists = counts.shape[0]
    cd = D.pairwise_distance(q, centroids,
                             "sqeuclidean" if metric != "ip" else "ip")
    _, probes = TK.topk_smallest(cd, nprobe_pad)
    col = torch.arange(nprobe_pad, device=q.device)[None, :]
    probes = torch.where(col < nprobe, probes, nlists).to(torch.int32)
    vals, rows = PQS.ivfpq_grouped_search(
        q, probes, centroids, codebooks, codes_t, offsets, counts, k=k,
        metric=metric, R=R, pos_bits=pos_bits)
    ids = torch.where(rows >= 0, row_ids[rows.clamp(min=0).long()], -1)
    return torch.where(ids >= 0, vals, TK.NEG_FILL), ids


def _rerank(q, ids, orig, orig_scale, *, k: int, metric: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of candidates ``ids`` [B, C] (original rows, -1 =
    none): a gather of the originals in f32 (int8 rows times their
    scale), -q.x (ip) or ||q - x||^2 against the f32 query, then the
    top-k."""
    idsafe = ids.clamp(min=0).long()
    cand = orig[idsafe].float()                            # [B, C, D]
    if orig.dtype == torch.int8:
        cand = cand * orig_scale[idsafe][..., None]
    if metric == "ip":
        dd = -(cand @ q[:, :, None])[..., 0]
    else:
        dd = ((q[:, None, :] - cand) ** 2).sum(-1)
    dd = torch.where(ids >= 0, dd, TK.NEG_FILL)
    vals, pos = TK.topk_smallest(dd, k)
    return vals, torch.gather(ids, 1, pos)


class IVFPQIndex(BaseIndex):
    """IVF over PQ-compressed residual codes + optional exact rerank."""

    kind = "ivfpq"

    def __init__(self, vectors, *, nlists: Optional[int] = None,
                 n_sub: int = 16, ksub: int = 256, metric: str = "l2",
                 ids=None, seed: int = 0, sample_cap: int = 131072,
                 keep_originals: bool = False, opq: bool = False,
                 orig_dtype: Optional[str] = None, device=None):
        cfg = get_config()
        self.device = dev = resolve_device(device)
        x = np.asarray(vectors, np.float32)
        n, d = x.shape
        if d % n_sub:
            raise ValueError(f"dim {d} not divisible by n_sub {n_sub}")
        self.metric = D.canonical_metric(metric)
        self.dim = d
        self.n = n
        self.n_sub = n_sub
        self.ksub = min(ksub, max(n, 2))
        self.nlists = max(1, min(int(nlists or cfg.ivf_nlists), n))
        self._seed = seed
        self._ids = (np.asarray(ids, np.int64) if ids is not None
                     else np.arange(n, dtype=np.int64))
        self._ids_identity = ids is None
        self._spherical = self.metric == "cosine"
        if self._spherical:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                               1e-30)
        if opq and self.metric == "ip":
            raise ValueError("opq is defined for l2/cosine (residual "
                             "rotation does not compose with raw ip)")
        rng = np.random.default_rng(seed)

        # coarse quantizer: sampled Lloyd's (the same numpy sample as the
        # JAX package draws)
        sample = x if n <= sample_cap else \
            x[rng.choice(n, sample_cap, replace=False)]
        state = kmeans_fit(torch.from_numpy(np.ascontiguousarray(sample))
                           .to(dev), self.nlists,
                           max_iter=cfg.ivf_kmeans_iters,
                           tol=cfg.ivf_kmeans_tol, seed=seed)
        self.centroids = state.centroids

        if orig_dtype is None:
            orig_dtype = "bf16" if dev.type == "cuda" else "f32"
        if orig_dtype not in ORIG_DTYPES:
            raise ValueError(f"unknown orig_dtype {orig_dtype!r}; known: "
                             f"{sorted(ORIG_DTYPES)}")
        orig_int8 = keep_originals and ORIG_DTYPES[orig_dtype] == torch.int8
        self._orig_scale = None
        chunk = 1 << 20
        if orig_int8:
            # int8 originals with a per-row symmetric scale, quantized on
            # the host and uploaded once; labels and residuals come from
            # the device-resident int8 store
            scale = np.empty(n, np.float32)
            xq = np.empty((n, d), np.int8)
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                scale[s:e] = np.maximum(
                    np.abs(x[s:e]).max(axis=1), 1e-30) / 127.0
                xq[s:e] = np.clip(np.rint(x[s:e] / scale[s:e, None]),
                                  -127, 127).astype(np.int8)
            self._orig = torch.from_numpy(xq).to(dev)
            self._orig_scale = torch.from_numpy(scale).to(dev)
            del xq
            xsrc = None
        else:
            xsrc = torch.from_numpy(x).to(dev)

        def rows_f32(s, e):
            if xsrc is not None:
                return xsrc[s:e]
            return self._orig[s:e].float() * self._orig_scale[s:e, None]

        labels_t = torch.empty(n, dtype=torch.int64, device=dev)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            labels_t[s:e] = kmeans_predict(self.centroids, rows_f32(s, e))
        labels = labels_t.cpu().numpy()

        # PQ (or OPQ) codebooks on residuals of a sample, from the host
        # f32 rows as in the JAX package
        self.opq = opq
        cents_np = self.centroids.cpu().numpy()
        if n <= sample_cap:
            rs = x - cents_np[labels]
        else:
            pick = rng.choice(n, sample_cap, replace=False)
            rs = x[pick] - cents_np[labels[pick]]
        rs = torch.from_numpy(np.ascontiguousarray(rs)).to(dev)
        if opq:
            self.R, self.codebooks = train_opq_rotation(
                rs, n_sub=n_sub, ksub=self.ksub)
        else:
            self.R = None
            self.codebooks = train_pq_codebook(rs, n_sub=n_sub,
                                               ksub=self.ksub)
        del rs
        # full-corpus encode, chunked over rows
        codes = torch.empty((n, n_sub), device=dev,
                            dtype=torch.uint8 if self.ksub <= 256
                            else torch.int32)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            rb = rows_f32(s, e) - self.centroids[labels_t[s:e]]
            if opq:
                rb = rb @ self.R
            codes[s:e] = pq_encode(self.codebooks, rb)
        del labels_t
        self._pack_lists(labels, codes)
        if keep_originals and not orig_int8:
            self._orig = xsrc.to(ORIG_DTYPES[orig_dtype])
        elif not keep_originals:
            self._orig = None
        self.orig_dtype = (None if self._orig is None
                           else _dtype_name(self._orig.dtype))

    def _pack_lists(self, labels: np.ndarray, codes: torch.Tensor) -> None:
        """Aligned CSR: every list offset a multiple of LIST_ALIGN, a SEG
        tail; gap columns hold code 0 and row id -1."""
        n = len(labels)
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=self.nlists).astype(np.int32)
        A = PQS.LIST_ALIGN
        aligned = ((counts + A - 1) // A) * A
        offsets = np.zeros(self.nlists, np.int32)
        np.cumsum(aligned[:-1], out=offsets[1:])
        npad = max(1, -(-int(aligned.sum()) // PQS.SEG) * PQS.SEG) + PQS.SEG
        src = np.zeros(self.nlists + 1, np.int64)
        np.cumsum(counts, out=src[1:])
        tgt = (np.repeat(offsets.astype(np.int64), counts)
               + (np.arange(n) - np.repeat(src[:-1], counts)))
        rid = np.full(npad, -1, np.int32)
        rid[tgt] = order
        dev = self.device
        cp = torch.zeros((npad, self.n_sub), dtype=codes.dtype, device=dev)
        cp[torch.from_numpy(tgt).to(dev)] = codes[torch.from_numpy(order)
                                                  .to(dev)]
        self._codes_t = cp.T.contiguous()       # subspace-major for the scan
        self._row_ids = torch.from_numpy(rid).to(dev)
        self._offsets = torch.from_numpy(offsets).to(dev)
        self._counts = torch.from_numpy(counts).to(dev)
        self.max_list = int(counts.max()) if n else 1
        self._alive = np.ones(n, bool)

    @property
    def code_bytes(self) -> int:
        return int(self.n * self.n_sub)

    def _R_or_eye(self) -> torch.Tensor:
        if self.R is not None:
            return self.R
        return torch.eye(self.dim, device=self.device)

    def delete(self, ids) -> int:
        """Tombstone delete: dead rows' row ids become -1 on the device;
        the segment route masks them."""
        kill = np.isin(self._ids, np.asarray(ids, np.int64)) & self._alive
        removed = int(kill.sum())
        if removed:
            self._alive &= ~kill
            rid = self._row_ids.cpu().numpy()
            dead = np.nonzero(np.isin(np.maximum(rid, 0), np.nonzero(kill)[0])
                              & (rid >= 0))[0]
            self._row_ids[torch.from_numpy(dead).to(self.device)] = -1
        return removed

    def search(self, queries, k: int = 10, *, nprobe: int = 10,
               rerank: int = 0, out: str = "numpy",
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        """``out="device"`` returns torch tensors (raw distances: squared
        for l2, unscaled for cosine; original-row ids) without a host
        sync; it needs a batch query, no outstanding deletes and default
        ids. Packed selection follows ``config.ivf_select``."""
        if rerank and self._orig is None:
            raise ValueError("rerank requires keep_originals=True")
        q, single = as_batch(queries, device=self.device)
        if self._spherical:
            q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                                min=1e-30)
        nprobe = min(nprobe, self.nlists)
        kk = min(k, max(self.n, 1))
        # pow-2 rerank buckets: coarse_k = kk * bucket
        rr = 1
        while rr < max(rerank, 1):
            rr *= 2
        coarse_k = int(min(kk * rr, PQS.KP_MAX, max(self.n, 1)))
        metric = "ip" if self.metric == "ip" else "sqeuclidean"
        grouped = bool(self._alive.all()) and self._codes_t.dtype == torch.uint8
        if out == "device" and (single or not grouped
                                or not self._ids_identity):
            raise ValueError("device output requires a batch query, no "
                             "outstanding deletes, and default ids")
        if grouped:
            npad = 4
            while npad < nprobe:
                npad *= 2                  # pow-2 probe buckets
            npad = min(npad, self.nlists)
            # packed keys of up to 16 bits: ADC distances are approximate
            # already and the top candidates are reranked; blockmin means
            # exact here, as in the JAX package
            pb, block_min = select_bits(get_config().ivf_select,
                                        self.max_list, max_bits=16)
            if block_min:
                pb = 0
            vals, rows = _ivfpq_search_grouped(
                q, self.centroids, self.codebooks, self.R, self._codes_t,
                self._row_ids, self._offsets, self._counts, nprobe,
                k=coarse_k, metric=metric, nprobe_pad=max(npad, nprobe),
                pos_bits=pb)
        else:
            vals, rows = _ivfpq_search_device(
                q, self.centroids, self.codebooks, self._R_or_eye(),
                self._codes_t.T, self._row_ids, self._offsets, self._counts,
                k=coarse_k, nprobe=nprobe, metric=metric,
                max_segs=max(1, -(-self.max_list // SEGMENT)),
                segment=SEGMENT)
        if rerank:
            vals, rows = _rerank(q, rows, self._orig, self._orig_scale, k=kk,
                                 metric=metric)
        else:
            vals, rows = vals[:, :kk], rows[:, :kk]
        if out == "device":
            return vals, rows
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        if self.metric == "l2":
            vals = np.sqrt(np.maximum(vals, 0.0))
        elif self.metric == "cosine":
            vals = vals * 0.5
        ids = np.where(rows >= 0, self._ids[np.maximum(rows, 0)], -1)
        vals = np.where(ids >= 0, vals, np.inf)
        return (vals[0], ids[0]) if single else (vals, ids)

    # ---- persistence ----
    def _state(self):
        arrays = {"centroids": self.centroids, "codebooks": self.codebooks,
                  "codes": self._codes_t.T, "row_ids": self._row_ids,
                  "offsets": self._offsets, "counts": self._counts,
                  "ids": self._ids, "alive": self._alive}
        if self.R is not None:
            arrays["R"] = self.R
        meta = {"n": self.n, "n_sub": self.n_sub, "ksub": self.ksub,
                "nlists": self.nlists, "max_list": self.max_list,
                "seed": self._seed}
        if self._orig is not None:
            arrays["orig"] = self._orig
            if self._orig_scale is not None:
                arrays["orig_scale"] = self._orig_scale
            # int8 originals are meaningless without their row scales:
            # format 2 records the dtype so a reader that does not know
            # the layout fails loudly
            meta["orig_dtype"] = _dtype_name(self._orig.dtype)
            if meta["orig_dtype"] == "int8":
                meta["format_version"] = 2
        return arrays, meta

    def _load_state(self, arrays, meta, device=None):
        self.device = dev = resolve_device(device)
        self.metric = meta["metric"]
        self.dim = meta["dim"]
        self.n = meta["n"]
        self.n_sub = meta["n_sub"]
        self.ksub = meta["ksub"]
        self.nlists = meta["nlists"]
        self.max_list = meta["max_list"]
        self._seed = meta.get("seed", 0)
        self._spherical = self.metric == "cosine"

        def to_dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.centroids = to_dev(arrays["centroids"], np.float32)
        self.codebooks = to_dev(arrays["codebooks"], np.float32)
        self.R = to_dev(arrays["R"], np.float32) if "R" in arrays else None
        self.opq = self.R is not None
        self._codes_t = to_dev(np.asarray(arrays["codes"]).T,
                               np.uint8 if self.ksub <= 256 else np.int32)
        self._row_ids = to_dev(arrays["row_ids"], np.int32)
        self._offsets = to_dev(arrays["offsets"], np.int32)
        self._counts = to_dev(arrays["counts"], np.int32)
        self._ids = np.asarray(arrays["ids"], np.int64)
        self._ids_identity = bool(
            np.array_equal(self._ids, np.arange(self.n, dtype=np.int64)))
        self._alive = np.asarray(arrays["alive"], bool).copy()
        self._orig_scale = (to_dev(arrays["orig_scale"], np.float32)
                            if "orig_scale" in arrays else None)
        if "orig" not in arrays:
            self._orig = None
        elif np.asarray(arrays["orig"]).dtype == np.int8:
            # format 2: int8 codes are meaningless without their per-row
            # scales; refuse instead of loading unscaled rerank rows
            if self._orig_scale is None:
                raise ValueError(
                    "IVF-PQ checkpoint has int8 originals (format v2) "
                    "but no 'orig_scale' array; refusing to load "
                    "unscaled rerank codes")
            self._orig = to_dev(arrays["orig"], np.int8)
        else:
            self._orig = to_dev(arrays["orig"], np.float32).to(
                torch.bfloat16 if dev.type == "cuda" else torch.float32)
        self.orig_dtype = (None if self._orig is None
                           else _dtype_name(self._orig.dtype))

    def stats(self) -> Dict[str, Any]:
        counts = self._counts.cpu().numpy()
        return {"kind": self.kind, "n": self.n, "nlists": self.nlists,
                "n_sub": self.n_sub, "code_bytes": self.code_bytes,
                "raw_bytes": self.n * self.dim * 4,
                "compression": round(self.dim * 4 / self.n_sub, 1),
                "max_list": int(counts.max()) if len(counts) else 0,
                "alive": int(self._alive.sum())}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")
