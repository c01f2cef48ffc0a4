"""K-means — Lloyd's iterations with k-means++ seeding.

Counterpart of ``neurondb_tpu/ml/kmeans.py`` (``_assign``, ``_update``,
``kmeans_plusplus_init``, ``kmeans_fit``, ``kmeans_predict``,
``minibatch_kmeans_fit``, ``silhouette_score``,
``davies_bouldin_index``). A Python
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

Random streams come from a ``torch.Generator`` on the data's device
seeded with ``seed`` (the seeding and the mini-batch draws); they differ
from ``jax.random``'s, so tests hold the fits to their inertia.
``silhouette_score`` and ``davies_bouldin_index`` run over the rows in
chunks (the JAX package materializes ``[N, k]`` and ``[N, D]``: 4 GB at
1M x 1,024); their sums run in another order.
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


def minibatch_kmeans_fit(x: torch.Tensor, k: int, *, batch: int = 1024,
                         iters: int = 100, seed: int = 0) -> KMeansState:
    """Mini-batch k-means (ml_minibatch_kmeans.c parity): per-batch
    assignment + per-cluster learning-rate update (Sculley 2010). The
    batches are drawn with replacement from a generator on x's device."""
    x = x.float()
    n = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    c = kmeans_plusplus_init(x, k, gen)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        idx = torch.randint(0, n, (batch,), generator=gen, device=x.device)
        xb = x[idx]
        labels, _ = _assign(xb, c)
        lab = labels.long()
        bc = torch.bincount(lab, minlength=k).float()
        counts = counts + bc
        lr = bc / torch.clamp(counts, min=1.0)
        sums = torch.zeros_like(c).index_add_(0, lab, xb)
        bmean = sums / torch.clamp(bc[:, None], min=1.0)
        c = torch.where(bc[:, None] > 0,
                        c * (1.0 - lr[:, None]) + bmean * lr[:, None], c)
    _, d2 = _assign_chunked(x[None], c[None], (x * x).sum(1)[None])
    return KMeansState(c, float(d2.sum()), int(iters), 0.0)


SCORE_ROWS = 131072     # rows a chunk in the cluster-quality scores


def silhouette_score(x: torch.Tensor, labels: torch.Tensor, k: int,
                     sample: int = 2048, seed: int = 0) -> torch.Tensor:
    """Approximate silhouette via centroid distances (fast evaluate path,
    matching evaluate_kmeans_by_model_id's cluster-quality metrics).
    ``sample`` and ``seed`` are accepted for parity; every row counts,
    as in the JAX package."""
    x = x.float()
    labels = labels.long()
    c = _update(x, labels, k, torch.zeros((k, x.shape[1]), device=x.device))
    c_sq = (c * c).sum(1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], SCORE_ROWS):
        xc, lc = x[s:s + SCORE_ROWS], labels[s:s + SCORE_ROWS]
        d = torch.sqrt(torch.clamp((xc * xc).sum(1)[:, None] + c_sq[None, :]
                                   - 2.0 * (xc @ c.T), min=0.0))
        own = d.gather(1, lc[:, None])[:, 0]
        other = d.scatter(1, lc[:, None], float("inf")).amin(1)
        sc = (other - own) / torch.clamp(torch.maximum(own, other), min=1e-30)
        total += sc.sum(dtype=torch.float64)
    return (total / x.shape[0]).float()


def davies_bouldin_index(x: torch.Tensor, labels: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Davies-Bouldin cluster-quality index (src/ml/ml_davies_bouldin.c)."""
    x = x.float()
    labels = labels.long()
    c = _update(x, labels, k, torch.zeros((k, x.shape[1]), device=x.device))
    counts = torch.bincount(labels, minlength=k).float()
    # mean intra-cluster distance to centroid
    intra = torch.zeros(k, dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], SCORE_ROWS):
        lc = labels[s:s + SCORE_ROWS]
        intra.index_add_(0, lc, torch.linalg.vector_norm(
            x[s:s + SCORE_ROWS] - c[lc], dim=1))
    intra = intra / torch.clamp(counts, min=1.0)
    cd = torch.linalg.vector_norm(c[:, None, :] - c[None, :, :], dim=-1)
    ratio = (intra[:, None] + intra[None, :]) / torch.clamp(cd, min=1e-30)
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    ratio = torch.where(eye, -float("inf"), ratio)
    valid = counts > 0
    r = torch.where(valid[:, None] & valid[None, :], ratio, -float("inf"))
    per = r.amax(1)
    per = torch.where(valid & torch.isfinite(per), per, 0.0)
    return per.sum() / torch.clamp(valid.sum().float(), min=1.0)
