"""DBSCAN, agglomerative clustering, anomaly/outlier detection.

Counterpart of ``neurondb_tpu/ml/cluster_extra.py``. Reference:
NeuronDB/src/ml/ml_dbscan.c, ml_hierarchical.c, ml_anomaly_detection.c,
ml_outlier_detection.c.

- DBSCAN: the eps-neighbourhood graph is a distance-matrix threshold;
  clusters grow by min-label propagation over it.
- Agglomerative: centroid linkage over masked active clusters, one merge
  a step (the N <= 10k the reference handles through SQL).
- Anomaly: z-score, IQR, kNN-distance and isolation scores.

Divergences, each computing the same result:

- DBSCAN runs the JAX package's ``max_iter or n`` propagation passes only
  until a pass changes nothing (checked every ``CHECK_EVERY`` passes);
  later passes are the identity.
- Agglomerative keeps the ``[N, N]`` squared-distance matrix and, after a
  merge, recomputes only the merged cluster's row and column (the other
  centroids did not move), where the JAX package recomputes the whole
  matrix every step; the argmin over it, the lowest flat index first, is
  the same rule. The merge loop stays on the device (no host sync).
- ``isolation_scores`` draws its hyperplanes and thresholds from a
  ``torch.Generator``, not ``jax.random``: the scores differ and are
  held to what they detect.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ml.neighbors import _knn_neighbors
from neurondb_tpu_torch.ops.vector_ops import _quantile

CHECK_EVERY = 32


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                       - 2.0 * (a @ b.T), min=0.0)


def dbscan_fit(x, *, eps: float = 0.5, min_samples: int = 5,
               max_iter: int = 0) -> Dict:
    """Labels: -1 noise, else cluster id (smallest core-point row id in the
    cluster — stable, deterministic)."""
    x = x.float()
    n = x.shape[0]
    adj = _sq_dists(x, x) <= eps * eps                       # [N, N] incl self
    core = adj.sum(1) >= min_samples
    # propagate min-label through core connectivity: border points take the
    # label of any core neighbor; core-core edges merge clusters
    labels = torch.where(core, torch.arange(n, dtype=torch.int32,
                                            device=x.device), n)
    src = adj & core[None, :]
    for i in range(max_iter or n):
        best = torch.where(src, labels[None, :], n).amin(1)
        new = torch.where(core, torch.minimum(labels, best), best)
        if (i + 1) % CHECK_EVERY == 0 and torch.equal(new, labels):
            break
        labels = new
    labels = torch.where(labels >= n, -1, labels)
    return {"labels": labels.to(torch.int32), "core": core,
            "eps": torch.tensor(float(eps), device=x.device), "X": x}


def dbscan_predict(model: Dict, x) -> torch.Tensor:
    """Assign new points to the cluster of the nearest core point within
    eps, else -1."""
    q = x.float()
    d2 = torch.where(model["core"][None, :], _sq_dists(q, model["X"]),
                     float("inf"))
    j = torch.argmin(d2, dim=1)
    ok = d2.gather(1, j[:, None])[:, 0] <= model["eps"] ** 2
    return torch.where(ok, model["labels"][j], -1).to(torch.int32)


def agglomerative_fit(x, n_clusters: int = 2) -> Dict:
    """Centroid-linkage agglomerative clustering (ml_hierarchical.c)."""
    x = x.float()
    n = x.shape[0]
    dev = x.device
    centroids = x.clone()
    sizes = torch.ones(n, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    labels = torch.arange(n, device=dev)
    big = torch.finfo(torch.float32).max
    d2 = _sq_dists(centroids, centroids)
    d2.fill_diagonal_(big)
    ar = torch.arange(n, device=dev)
    for _ in range(max(n - n_clusters, 0)):
        # one-element index tensors: no host sync inside the loop
        flat = torch.argmin(d2).reshape(1)
        i, j = flat // n, flat % n
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        # merge hi into lo
        s_lo, s_hi = sizes.index_select(0, lo), sizes.index_select(0, hi)
        tot = s_lo + s_hi
        newc = (centroids.index_select(0, lo) * s_lo
                + centroids.index_select(0, hi) * s_hi) / tot   # [1, D]
        centroids.index_copy_(0, lo, newc)
        sizes.index_copy_(0, lo, tot)
        active.index_fill_(0, hi, False)
        labels = torch.where(labels == labels.index_select(0, hi),
                             labels.index_select(0, lo), labels)
        # the merged cluster's distances; hi leaves the active set
        row = _sq_dists(newc, centroids)[0]
        row = torch.where(active & (ar != lo), row, big)
        d2.index_copy_(0, lo, row[None, :])
        d2.index_copy_(1, lo, row[:, None])
        d2.index_fill_(0, hi, big)
        d2.index_fill_(1, hi, big)
    return {"labels": labels.to(torch.int32), "active": active,
            "centroids": centroids}


def relabel_consecutive(labels) -> torch.Tensor:
    """Map arbitrary label values to 0..k-1 (host helper): int32 on the
    labels' device (``config.device`` for host labels)."""
    if isinstance(labels, torch.Tensor):
        lab, dev = labels.cpu().numpy(), labels.device
    else:
        lab, dev = np.asarray(labels), resolve_device(None)
    uniq = {v: i for i, v in enumerate(sorted(set(lab.tolist())))}
    return torch.tensor([uniq[int(v)] for v in lab], dtype=torch.int32,
                        device=dev)


# ---- anomaly / outlier detection ----

def zscore_outliers(x, threshold: float = 3.0) -> torch.Tensor:
    x = x.float()
    z = (x - x.mean(0)).abs() / torch.clamp(x.std(0, correction=0), min=1e-12)
    return (z > threshold).any(1)


def iqr_outliers(x, factor: float = 1.5) -> torch.Tensor:
    x = x.float()
    q1 = _quantile(x, 0.25, dim=0)
    q3 = _quantile(x, 0.75, dim=0)
    iqr = q3 - q1
    lo, hi = q1 - factor * iqr, q3 + factor * iqr
    return ((x < lo) | (x > hi)).any(1)


def knn_outlier_scores(x, k: int = 5) -> torch.Tensor:
    """Mean distance to k nearest neighbors (excluding self)."""
    x = x.float()
    d, _ = _knn_neighbors({"X": x}, x, k + 1)
    return d[:, 1:].mean(1)


def isolation_scores(x, *, n_trees: int = 50, sample: int = 256,
                     seed: int = 0) -> torch.Tensor:
    """Isolation-forest-style scores via random hyperplane split depths
    (a vectorized stand-in scoring the same phenomenon: short average
    isolation depth = outlier)."""
    x = x.float()
    n, d = x.shape
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    depth_cap = int(math.ceil(math.log2(max(min(sample, n), 2))))
    groups = 2 ** depth_cap
    total = torch.zeros(n, device=x.device)
    for _ in range(n_trees):
        alive = torch.ones(n, dtype=torch.bool, device=x.device)
        depth = torch.zeros(n, device=x.device)
        code = torch.zeros(n, dtype=torch.long, device=x.device)
        for _ in range(depth_cap):
            w = torch.randn(d, generator=gen, device=x.device)
            u = torch.rand((), generator=gen, device=x.device)
            proj = x @ w
            # split at a random quantile between the alive min/max
            lo = torch.where(alive, proj, float("inf")).amin()
            hi = torch.where(alive, proj, -float("inf")).amax()
            t = lo + u * torch.clamp(hi - lo, min=1e-12)
            code = code * 2 + (proj > t).long()
            # a point is "isolated" when its side-group is a singleton
            counts = torch.zeros(groups, device=x.device).index_add_(
                0, code % groups, alive.float())
            newly = alive & (counts[code % groups] <= 1.0)
            depth = torch.where(alive, depth + 1.0, depth)
            alive = alive & ~newly
        total += depth
    return -(total / n_trees)  # higher score = more anomalous
