"""The operations and bytes a search needs, and the card's peaks.

The counts are functions of the cell's shapes and data, not of how the
program computes them: each input byte read once, each output byte
written once, each product and norm the answer needs, at the peak of the
precision the configuration states. A roofline share built from them
keeps reading the same work after a later change fuses, replaces or
removes a kernel. The least time of a piece of work is the larger of its
bytes over the memory bandwidth and its operations over their peak.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bf16": 989e12,          # bf16 x bf16 -> f32 on the tensor cores
    # f32-accurate products: three TF32 tensor-core passes a product
    # (495 TFLOP/s TF32 / 3), faster than f32 outside the tensor cores
    # (67 TFLOP/s), so the least time of f32 work
    "f32": 495e12 / 3,
}


def least_seconds(nbytes: float, flops: Dict[str, float]
                  ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations") of work that reads and
    writes ``nbytes`` and computes ``flops[rate]`` operations at each
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(f / PEAK_FLOPS[rate] for rate, f in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_rows(list_sizes: np.ndarray, probes: np.ndarray
               ) -> Tuple[int, int]:
    """(rows scanned over all (query, probe) pairs, rows of the distinct
    probed lists) for probes [B, nprobe] into lists of ``list_sizes``."""
    sizes = np.asarray(list_sizes, np.int64)
    p = np.asarray(probes, np.int64)
    return int(sizes[p].sum()), int(sizes[np.unique(p)].sum())


def grouped_scan_work(list_sizes, probes, *, dim: int, k: int,
                      store_bytes: int, rate: str) -> Dict:
    """The list scan of one batch: the probed lists' rows read once, the
    queries (f32) read once, the top-k (f32 distance, int32 id) of each
    query written once; a product of 2 * dim operations for every
    (query, scanned row) pair and a norm for every distinct row."""
    b = int(np.asarray(probes).shape[0])
    rows, uniq = probe_rows(list_sizes, probes)
    nbytes = uniq * dim * store_bytes + b * dim * 4 + b * k * 8
    return {"bytes": float(nbytes),
            "flops": {rate: 2.0 * dim * (rows + uniq)}}


def coarse_work(b: int, nlists: int, dim: int, nprobe: int) -> Dict:
    """The coarse stage of one batch: queries and centroids (f32) read
    once, the probes (int32) written once; 2 * dim operations for every
    (query, centroid) pair and a norm for every centroid, in f32."""
    nbytes = b * dim * 4 + nlists * dim * 4 + b * nprobe * 4
    return {"bytes": float(nbytes),
            "flops": {"f32": 2.0 * dim * (b * nlists + nlists)}}


def ivf_search_work(list_sizes, probes, *, nlists: int, dim: int, k: int,
                    store_bytes: int, rate: str) -> Dict:
    """One IVF batch end to end: the coarse stage and the list scan, the
    queries read once and the probes kept on chip (no round trip)."""
    b, nprobe = np.asarray(probes).shape
    scan = grouped_scan_work(list_sizes, probes, dim=dim, k=k,
                             store_bytes=store_bytes, rate=rate)
    coarse = coarse_work(b, nlists, dim, nprobe)
    nbytes = (scan["bytes"] + coarse["bytes"] - b * dim * 4
              - b * nprobe * 4)
    flops = dict(scan["flops"])
    for r, f in coarse["flops"].items():
        flops[r] = flops.get(r, 0.0) + f
    return {"bytes": float(nbytes), "flops": flops}


def exact_work(b: int, n: int, *, dim: int, k: int, store_bytes: int,
               rate: str) -> Dict:
    """An exact batch: the whole store read once, the queries (f32) read
    once, the top-k written once; 2 * dim operations for every (query,
    row) pair and a norm for every row."""
    nbytes = n * dim * store_bytes + b * dim * 4 + b * k * 8
    return {"bytes": float(nbytes),
            "flops": {rate: 2.0 * dim * (b * n + n)}}


def add_work(works) -> Dict:
    """The sum of several batches' work."""
    nbytes = 0.0
    flops: Dict[str, float] = {}
    for w in works:
        nbytes += w["bytes"]
        for r, f in w["flops"].items():
            flops[r] = flops.get(r, 0.0) + f
    return {"bytes": nbytes, "flops": flops}
