"""K-means — Lloyd's iterations with k-means++ seeding.

Counterpart of ``neurondb_tpu/ml/kmeans.py`` (``_assign``, ``_update``,
``kmeans_plusplus_init``, ``kmeans_fit``, ``kmeans_predict``). A Python
loop takes the place of ``lax.while_loop`` with the same stopping rule
(at most ``max_iter`` iterations while the mean centroid shift is at
least ``tol``) and the same empty-cluster rule (an empty cluster keeps
its old centroid). The update is a segment sum (``index_add_``) rather
than the one-hot GEMM the MXU wanted: at 102,400 x 1024 the one-hot
matrix alone would be 400 MB.

``kmeans_fit_batched`` writes out the JAX package's ``vmap`` of the fit
over PQ subspaces as one batch dimension: all subspaces seed and iterate
together, each stopping at its own convergence; ``kmeans_fit`` is its
batch of one.

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
    """Nearest centroid per row: ([..., N] int32 labels, [..., N] f32
    sq-dists). x [..., N, D], centroids [..., k, D] (a leading batch of
    subspaces runs as one batched product)."""
    if x_sq is None:
        x_sq = (x * x).sum(-1)
    c_sq = (centroids * centroids).sum(-1)
    d2 = (x_sq[..., :, None] + c_sq[..., None, :]
          - 2.0 * (x @ centroids.transpose(-1, -2)))
    best, labels = torch.min(d2, dim=-1)
    return labels.to(torch.int32), torch.clamp(best, min=0.0)


def _assign_chunked(x: torch.Tensor, centroids: torch.Tensor,
                    x_sq: torch.Tensor, budget: int = 1 << 26
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_assign`` over [S, N, D] in row chunks whose [S, chunk, k]
    distance block holds at most ``budget`` floats."""
    S, n = x.shape[:2]
    chunk = max(1, budget // (S * centroids.shape[1]))
    labels = torch.empty((S, n), dtype=torch.int32, device=x.device)
    best = torch.empty((S, n), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        labels[:, s:s + chunk], best[:, s:s + chunk] = _assign(
            x[:, s:s + chunk], centroids, x_sq[:, s:s + chunk])
    return labels, best


def _update(x: torch.Tensor, labels: torch.Tensor, k: int,
            old: torch.Tensor) -> torch.Tensor:
    """Mean of assigned points per cluster; empty clusters keep ``old``.
    x [..., N, D], labels [..., N], old [..., k, D]: one segment sum over
    the flattened (subspace, cluster) ids."""
    S = x.shape[0] if x.ndim == 3 else 1
    n, d = x.shape[-2:]
    lab = labels.long().reshape(S, n)
    lab = (lab + k * torch.arange(S, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros((S * k, d), dtype=x.dtype, device=x.device)
    sums.index_add_(0, lab, x.reshape(S * n, d))
    counts = torch.bincount(lab, minlength=S * k).to(x.dtype)[:, None]
    means = sums / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, means, old.reshape(S * k, d)) \
        .reshape(old.shape)


def kmeans_plusplus_init(x: torch.Tensor, k: int,
                         generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling) of x [N, D] or of each matrix of
    x [S, N, D] at once (one draw per step for all S). When every
    remaining squared distance of a matrix is 0 (fewer distinct points
    than k) its draw is uniform, without a host sync."""
    if x.ndim == 2:
        return kmeans_plusplus_init(x[None], k, generator)[0]
    S, n, d = x.shape
    ar = torch.arange(S, device=x.device)
    x_sq = (x * x).sum(-1)                                     # [S, N]

    def d2_to(c):                                              # c [S, D]
        return torch.clamp(x_sq + (c * c).sum(-1)[:, None]
                           - 2.0 * (x @ c[:, :, None])[..., 0], min=0.0)

    first = torch.randint(0, n, (S,), generator=generator,
                          device=generator.device).to(x.device)
    centroids = torch.zeros((S, k, d), dtype=x.dtype, device=x.device)
    c = x[ar, first]
    centroids[:, 0] = c
    mind2 = d2_to(c)
    for i in range(1, k):
        w = torch.where(mind2.sum(-1, keepdim=True) > 0, mind2,
                        torch.ones_like(mind2))
        idx = torch.multinomial(w, 1, generator=generator)[:, 0]
        c = x[ar, idx]
        centroids[:, i] = c
        mind2 = torch.minimum(mind2, d2_to(c))
    return centroids


class BatchedKMeansState(NamedTuple):
    centroids: torch.Tensor   # [S, k, D] f32
    inertia: torch.Tensor     # [S] sums of squared distances
    n_iter: torch.Tensor      # [S] Lloyd iterations each matrix ran
    shift: torch.Tensor       # [S] last mean centroid movement


def kmeans_fit_batched(x: torch.Tensor, k: int, *, max_iter: int = 50,
                       tol: float = 1e-3, seed: int = 0,
                       init: str = "kmeans++") -> BatchedKMeansState:
    """Full-batch Lloyd's on each matrix of x [S, N, D] at once (the JAX
    package vmaps ``kmeans_fit`` over PQ subspaces). Every matrix stops on
    its own: after ``max_iter`` iterations, or after the first iteration
    whose mean centroid shift is below ``tol``; its centroids then stay.
    The host syncs once per iteration, to stop when all have."""
    x = x.float()
    S, n, _ = x.shape
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    if init == "kmeans++":
        c = kmeans_plusplus_init(x, k, gen)
    else:
        idx = torch.rand((S, n), generator=gen, device=x.device) \
            .argsort(dim=-1)[:, :k]
        c = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    x_sq = (x * x).sum(-1)
    active = torch.ones(S, dtype=torch.bool, device=x.device)
    n_iter = torch.zeros(S, dtype=torch.int64, device=x.device)
    shift = torch.full((S,), float("inf"), device=x.device)
    for _ in range(max_iter):
        labels, _ = _assign_chunked(x, c, x_sq)
        new_c = _update(x, labels, k, c)
        moved = torch.linalg.vector_norm(new_c - c, dim=-1).mean(-1)
        c = torch.where(active[:, None, None], new_c, c)
        shift = torch.where(active, moved, shift)
        n_iter += active
        active &= shift >= tol
        if not bool(active.any()):
            break
    _, d2 = _assign_chunked(x, c, x_sq)
    return BatchedKMeansState(c, d2.sum(-1), n_iter, shift)


def kmeans_fit(x: torch.Tensor, k: int, *, max_iter: int = 50,
               tol: float = 1e-3, seed: int = 0,
               init: str = "kmeans++") -> KMeansState:
    """Full-batch Lloyd's on ``x``'s device. Stops after ``max_iter``
    iterations or when the mean centroid shift drops below ``tol``."""
    s = kmeans_fit_batched(x[None], k, max_iter=max_iter, tol=tol,
                           seed=seed, init=init)
    return KMeansState(s.centroids[0], float(s.inertia[0]),
                       int(s.n_iter[0]), float(s.shift[0]))


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
