"""K-means — Lloyd's iterations with k-means++ seeding.

Counterpart of ``neurondb_tpu/ml/kmeans.py`` (``_assign``, ``_update``,
``kmeans_plusplus_init``, ``kmeans_fit``, ``kmeans_predict``). A Python
loop takes the place of ``lax.while_loop`` with the same stopping rule
(at most ``max_iter`` iterations while the mean centroid shift is at
least ``tol``) and the same empty-cluster rule (an empty cluster keeps
its old centroid). The update is a segment sum (``index_add_``) rather
than the one-hot GEMM the MXU wanted: at 102,400 x 1024 the one-hot
matrix alone would be 400 MB.

Random streams come from a ``torch.Generator`` seeded with ``seed``; they
differ from ``jax.random``'s, so tests hold the fit to its inertia.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class KMeansState(NamedTuple):
    centroids: torch.Tensor   # [k, D] f32
    inertia: float            # sum of squared distances
    n_iter: int
    shift: float              # last mean centroid movement


def _assign(x: torch.Tensor, centroids: torch.Tensor,
            x_sq: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid per row: ([N] int32 labels, [N] f32 sq-dists)."""
    if x_sq is None:
        x_sq = (x * x).sum(1)
    c_sq = (centroids * centroids).sum(1)
    d2 = x_sq[:, None] + c_sq[None, :] - 2.0 * (x @ centroids.T)
    best, labels = torch.min(d2, dim=1)
    return labels.to(torch.int32), torch.clamp(best, min=0.0)


def _update(x: torch.Tensor, labels: torch.Tensor, k: int,
            old: torch.Tensor) -> torch.Tensor:
    """Mean of assigned points per cluster; empty clusters keep ``old``."""
    lab = labels.long()
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, lab, x)
    counts = torch.bincount(lab, minlength=k).to(x.dtype)
    means = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, means, old)


def kmeans_plusplus_init(x: torch.Tensor, k: int,
                         generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling). When every remaining squared
    distance is 0 (fewer distinct points than k) the draw is uniform,
    without a host sync."""
    n = x.shape[0]
    x_sq = (x * x).sum(1)
    first = int(torch.randint(0, n, (1,), generator=generator,
                              device=generator.device).item())
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first]
    c = x[first]
    mind2 = torch.clamp(x_sq + (c * c).sum() - 2.0 * (x @ c), min=0.0)
    for i in range(1, k):
        w = torch.where(mind2.sum() > 0, mind2, torch.ones_like(mind2))
        idx = torch.multinomial(w, 1, generator=generator)
        c = x.index_select(0, idx)[0]
        centroids[i] = c
        d2 = torch.clamp(x_sq + (c * c).sum() - 2.0 * (x @ c), min=0.0)
        mind2 = torch.minimum(mind2, d2)
    return centroids


def kmeans_fit(x: torch.Tensor, k: int, *, max_iter: int = 50,
               tol: float = 1e-3, seed: int = 0,
               init: str = "kmeans++") -> KMeansState:
    """Full-batch Lloyd's on ``x``'s device. Stops after ``max_iter``
    iterations or when the mean centroid shift drops below ``tol``."""
    x = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    if init == "kmeans++":
        c = kmeans_plusplus_init(x, k, gen)
    else:
        idx = torch.randperm(x.shape[0], generator=gen,
                             device=x.device)[:k]
        c = x[idx]
    x_sq = (x * x).sum(1)
    n_iter, shift = 0, float("inf")
    while n_iter < max_iter and shift >= tol:
        labels, _ = _assign(x, c, x_sq)
        new_c = _update(x, labels, k, c)
        shift = float(torch.linalg.vector_norm(new_c - c, dim=1).mean())
        c = new_c
        n_iter += 1
    _, d2 = _assign(x, c, x_sq)
    return KMeansState(c, float(d2.sum()), n_iter, shift)


def kmeans_predict(centroids: torch.Tensor, x: torch.Tensor,
                   chunk: int = 131072) -> torch.Tensor:
    """Nearest-centroid labels [N] int32, in row chunks so the [chunk, k]
    distance block stays bounded (131,072 x 1024 f32 = 512 MB)."""
    x = x.float()
    c = centroids.float()
    labels = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        labels[s:s + chunk] = _assign(x[s:s + chunk], c)[0]
    return labels
