"""Sharded IVF-PQ: PQ-coded posting lists sharded across a device mesh.

Counterpart of ``neurondb_tpu/parallel/sharded_ivfpq.py``, the IVF-PQ
composition of BASELINE.json config 5. The reference reaches its scale
by templating any ``%s_ann_index`` shard into its distributed fan-out
(NeuronDB/src/util/distributed.c:151-154) and merging shard-major
(distributed.c:320); here the fan-out is a loop over the mesh's shards
and the merge is ``mesh.merge_shards``, as for the flat, IVF and HNSW
sharded indexes.

Layout (``ShardedIVFIndex``'s list-interleaved row sharding):

- the coarse centroids and PQ codebooks train once on a host sample
  (``sample_cap`` rows; ``ml.kmeans`` and ``index.pq``) and are
  replicated: every shard needs them for probe selection and its tables;
- each list is split round-robin across the shards
  (``sharded.interleaved_layout``), so per-probe work is balanced;
- each shard stores its codes in the fused PQ kernel's layout
  (``pq_shard_layout``: subspace-major ``codes_t [n_sub, Npad]``, every
  list on a ``LIST_ALIGN`` column, a ``SEG`` tail), the dense slot of
  each code column, and by dense slot the global row ids and the rerank
  originals: int8 with per-row scales (default) or bf16 (f32 on the CPU,
  where the JAX class keeps f32 off the TPU).

A search copies the queries to each shard's device; each shard takes the
coarse top-nprobe, scores its slice of the probed lists with the fused
PQ kernel (``ivfpq_scan.grouped_pq_scan_fused``: ``csrc/ivfpq_scan.cu``
on a CUDA tensor, the tables built in the kernel from the residual query
``q - c`` for l2, from ``q`` for ip), keeps the top
``coarse_k = rerank_k or max(4k, 32)`` candidates, reranks them exactly
on its own originals (``index.ivfpq._rerank``); then the hierarchical
merge. Every global row lives in one shard, so the merge never returns
an id twice.

Deliberate divergences from the JAX package:
- ADC distances are sums of per-subspace table entries (the kernel's),
  where the JAX body decodes the codes and expands |q - c - x|^2 with a
  GEMM: the same function in another rounding;
- the scan's candidates per (query, probe) are capped at the kernel's
  ``KP_MAX`` = 256: a ``coarse_k`` above it raises a ValueError naming the
  cap (the JAX scan keeps any number);
- the rerank scores (q - x)^2 on the dequantized rows, as the port's
  ``IVFPQIndex`` does; the JAX body expands it as |q|^2 + |x|^2 - 2 q.x;
- ``orig_dtype`` takes ``"int8"`` or ``"bf16"`` (anything else raises);
- the shards always span the whole mesh (no ``axes`` subset), and the
  query batch is not padded to a power of two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_store_dtype
from neurondb_tpu_torch.index.hnsw import _PhaseClock
from neurondb_tpu_torch.index.ivf import _nearest_lists
from neurondb_tpu_torch.index.ivfpq import _rerank
from neurondb_tpu_torch.index.pq import pq_encode, train_pq_codebook
from neurondb_tpu_torch.ml.kmeans import kmeans_fit, kmeans_predict
from neurondb_tpu_torch.ops import distance as D
from neurondb_tpu_torch.ops import topk as TK
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS
from neurondb_tpu_torch.parallel.mesh import (Mesh, as_tensor, make_mesh,
                                              merge_shards, per_device)
from neurondb_tpu_torch.parallel.sharded import (f32_rows, host_results,
                                                 interleaved_layout,
                                                 pad_columns)

ORIG_DTYPES = ("int8", "bf16")


@dataclass
class PQShard:
    """One shard on its device: codes in the kernel's layout with each
    list's aligned offset and count, the dense slot of each code column
    (-1 in the gaps), and by dense slot the global rows, the originals
    and their scales (int8 only)."""

    codes_t: torch.Tensor
    off: torch.Tensor
    cnt: torch.Tensor
    col_slot: torch.Tensor
    gids: torch.Tensor
    orig: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]


def pq_shard_layout(codes: torch.Tensor, off: np.ndarray, cnt: np.ndarray,
                    device) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """A shard's list-contiguous codes [slots, n_sub] (list l at dense
    slots off[l] .. off[l] + cnt[l]) -> the fused kernel's layout:
    (codes_t [n_sub, Npad] uint8, aligned offsets, counts, col_slot
    [Npad] int32): each list starts on a ``LIST_ALIGN`` column, the
    columns end in a ``SEG`` tail, and ``col_slot`` maps a column to its
    dense slot (-1 in the gaps)."""
    cnt = np.asarray(cnt, np.int64)
    aligned = -(-cnt // PQS.LIST_ALIGN) * PQS.LIST_ALIGN
    aoff = np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int64)
    npad = max(1, -(-int(aligned.sum()) // PQS.SEG) * PQS.SEG) + PQS.SEG
    lab = np.repeat(np.arange(len(cnt)), cnt)
    within = np.arange(len(lab)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    slot = np.asarray(off, np.int64)[lab] + within
    col = aoff[lab] + within
    col_slot = np.full(npad, -1, np.int32)
    col_slot[col] = slot
    dev = torch.device(device)
    codes_t = torch.zeros((codes.shape[1], npad), dtype=torch.uint8,
                          device=dev)
    codes_t[:, torch.from_numpy(col).to(dev)] = \
        codes.to(dev)[torch.from_numpy(slot).to(dev)].T.to(torch.uint8)
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return codes_t, as_i32(aoff), as_i32(cnt), as_i32(col_slot)


def _int8_originals(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 codes and scales (the JAX class's, and
    ``IVFPQIndex``'s)."""
    sc = np.maximum(np.abs(x).max(axis=1), 1e-30).astype(np.float32) / 127.0
    return np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8), sc


class ShardedIVFPQIndex:
    """IVF-PQ posting lists sharded round-robin over a device mesh, with a
    per-shard exact rerank on int8 (default) or bf16 originals."""

    def __init__(self, vectors, *, nlists: int = 100, n_sub: int = 16,
                 ksub: int = 256, mesh: Optional[Mesh] = None,
                 metric: str = "l2", ids=None, seed: int = 0,
                 sample_cap: int = 131072, rerank: bool = True,
                 orig_dtype: str = "int8"):
        self.mesh = mesh or make_mesh()
        self.metric = D.canonical_metric(metric)
        x = f32_rows(vectors, self.metric == "cosine")
        self.n, self.dim = x.shape
        if self.dim % n_sub:
            raise ValueError(f"dim {self.dim} not divisible by n_sub "
                             f"{n_sub}")
        if min(ksub, max(self.n, 2)) > PQS.KSUB:
            raise ValueError(f"ksub {ksub} > {PQS.KSUB}: the PQ kernel "
                             f"reads one-byte codes")
        if rerank and orig_dtype not in ORIG_DTYPES:
            raise ValueError(f"unknown orig_dtype {orig_dtype!r}; known: "
                             f"{ORIG_DTYPES}")
        self.n_sub = n_sub
        self.ksub = min(ksub, max(self.n, 2))
        self.nlists = max(1, min(nlists, self.n))
        self.rerank = rerank
        self.orig_dtype = orig_dtype if rerank else None
        self.n_shards = self.mesh.size
        self._ids_np = np.asarray(ids if ids is not None
                                  else np.arange(self.n), np.int64)
        rng = np.random.default_rng(seed)
        lead = self.mesh.lead
        clock = _PhaseClock(lead)

        # ---- replicated training: coarse quantizer + PQ codebooks ----
        sample = x if self.n <= sample_cap else \
            x[rng.choice(self.n, sample_cap, replace=False)]
        smp = torch.from_numpy(np.ascontiguousarray(sample)).to(lead)
        cents = kmeans_fit(smp, self.nlists, seed=seed).centroids
        xdev = torch.from_numpy(x).to(lead)
        labels = kmeans_predict(cents, xdev)
        books = train_pq_codebook(
            smp - cents[kmeans_predict(cents, smp).long()], n_sub=n_sub,
            ksub=self.ksub, seed=seed)
        del smp
        clock.mark("train")
        cnt, src = interleaved_layout(labels, self.nlists, self.n_shards)
        clock.mark("layout")

        # ---- per-shard stores: codes + global rows (+ originals) ----
        shards = []
        for s, dev in enumerate(self.mesh.shard_devices()):
            rows = src[s]
            codes = pq_encode(books, xdev[rows] - cents[labels[rows].long()])
            off = np.concatenate([[0], np.cumsum(cnt[s])[:-1]])
            rows_np = rows.cpu().numpy()
            orig = scale = None
            if rerank and orig_dtype == "int8":
                orig, scale = _int8_originals(x[rows_np])
            elif rerank:
                orig = x[rows_np]
            shards.append(self._shard(codes, off, cnt[s], rows_np, orig,
                                      scale, dev))
        del xdev, src
        clock.mark("encode_upload")
        self._place(shards, cents, books, int(cnt.sum(1).max()))
        self.build_seconds = clock.total()

    @staticmethod
    def _shard(codes, off, cnt, gids, orig, scale, device) -> PQShard:
        codes_t, aoff, acnt, col_slot = pq_shard_layout(
            as_tensor(codes), off, cnt, device)
        dev = torch.device(device)
        t = lambda a, dt: None if a is None else as_tensor(a).to(dev, dt)
        odt = (None if orig is None else torch.int8
               if np.asarray(orig).dtype == np.int8
               else resolve_store_dtype(dev))
        return PQShard(codes_t, aoff, acnt, col_slot, t(gids, torch.int32),
                       t(orig, odt), t(scale, torch.float32))

    def _place(self, shards: List[PQShard], cents, books, cap: int) -> None:
        c = as_tensor(cents).float()
        b = as_tensor(books).float()
        self._shards = shards
        self.centroids, self.codebooks = c.cpu().numpy(), b.cpu().numpy()
        devs = self.mesh.shard_devices()
        self._cents, self._books = per_device(c, devs), per_device(b, devs)
        self._cap = max(cap, 1)
        self.max_list = max([int(sh.cnt.max()) for sh in shards
                             if sh.cnt.numel()] + [1])

    @classmethod
    def from_arrays(cls, mesh: Mesh, *, centroids, codebooks, codes, gids,
                    off, cnt, ids, orig=None, orig_scale=None,
                    metric: str = "l2") -> "ShardedIVFPQIndex":
        """The index over a JAX ``ShardedIVFPQIndex``'s state, as numpy:
        ``centroids``, ``codebooks``, the stacked ``_codes`` [S, cap,
        n_sub], ``_gids`` [S, cap], ``_off`` / ``_cnt`` [S, nlists],
        ``_orig`` [S, cap, D] (int8 or f32; None without rerank),
        ``_orig_scale`` [S, cap] (int8 only) and ``_ids_np``; each
        shard's codes are laid out again for the kernel."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.metric = D.canonical_metric(metric)
        self._ids_np = np.asarray(ids, np.int64)
        self.n = len(self._ids_np)
        self.nlists, self.dim = np.shape(centroids)
        self.n_sub, self.ksub = np.shape(codebooks)[:2]
        self.n_shards = mesh.size
        self.rerank = orig is not None
        self.orig_dtype = (None if orig is None else "int8"
                           if np.asarray(orig).dtype == np.int8 else "bf16")
        codes, cnt = np.asarray(codes), np.asarray(cnt)
        at = lambda a, s: None if a is None else np.asarray(a)[s]
        shards = [cls._shard(codes[s], np.asarray(off)[s], cnt[s],
                             np.asarray(gids)[s], at(orig, s),
                             at(orig_scale, s), dev)
                  for s, dev in enumerate(mesh.shard_devices())]
        self._place(shards, centroids, codebooks, int(cnt.sum(1).max()))
        self.build_seconds = {}
        return self

    def search(self, queries, k: int = 10, *, nprobe: int = 10,
               rerank_k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k; with originals kept, each shard reranks its top
        ``rerank_k`` (default ``max(4k, 32)``) ADC candidates exactly."""
        q = f32_rows(queries, self.metric == "cosine")
        nprobe = min(nprobe, self.nlists)
        use_rr = self.rerank and self._shards[0].orig is not None
        coarse_k = int(rerank_k or max(4 * k, 32)) if use_rr else k
        k = min(k, self.n)
        kl = min(coarse_k if use_rr else k, self._cap)
        if kl > PQS.KP_MAX:
            raise ValueError(f"the sharded IVF-PQ scan keeps at most "
                             f"{PQS.KP_MAX} candidates per probe (the "
                             f"kernel's KP_MAX); got {kl}")
        imetric = "ip" if self.metric == "ip" else "sqeuclidean"
        coarse = {}
        dists, rows = [], []
        devs = self.mesh.shard_devices()
        qs = per_device(torch.from_numpy(q).to(self.mesh.lead), devs)
        for qd, c, cb, sh in zip(qs, self._cents, self._books, self._shards):
            if qd.device not in coarse:
                coarse[qd.device] = _nearest_lists(
                    qd, c, nprobe, metric=self.metric).to(torch.int32)
            vals, cols = PQS.ivfpq_grouped_search(
                qd, coarse[qd.device], c, cb, sh.codes_t, sh.off, sh.cnt,
                k=kl, metric=imetric)
            slots = torch.where(cols >= 0,
                                sh.col_slot[cols.clamp(min=0).long()], -1)
            if use_rr:
                vals, slots = _rerank(qd, slots, sh.orig, sh.scale,
                                      k=min(k, kl), metric=imetric)
            vals, slots = pad_columns(vals[:, :k], slots[:, :k], k)
            g = torch.where(slots >= 0, sh.gids[slots.clamp(min=0).long()],
                            -1)
            dists.append(torch.where(g >= 0, vals, TK.NEG_FILL))
            rows.append(g)
        d, r = merge_shards(self.mesh, dists, rows, k)
        return host_results(d, r, self._ids_np, self.metric)

    def stats(self):
        code_bytes = self.n * self.n_sub
        orig_bytes = (self.n * (self.dim + 4) if self.orig_dtype == "int8"
                      else (self.n * self.dim * 2 if self.rerank else 0))
        return {"kind": "sharded_ivfpq", "n": self.n, "dim": self.dim,
                "shards": self.n_shards, "axes": list(self.mesh.axis_names),
                "nlists": self.nlists, "n_sub": self.n_sub,
                "metric": self.metric, "max_list": self.max_list,
                "bytes_per_shard": (code_bytes + orig_bytes)
                // max(self.n_shards, 1)}
