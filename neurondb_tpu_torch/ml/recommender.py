"""Recommender — matrix-factorization collaborative filtering.

Counterpart of ``neurondb_tpu/ml/recommender.py``. Reference:
NeuronDB/src/ml/ml_recommender.c. ALS on a dense-masked rating matrix:
each half-step solves one f x f ridge system a row (batched Cholesky),
plus item-item cosine neighbours over the learned factors.

Divergences:

- each side's normal matrices are one ``[rows, I] @ [I, f^2]`` product
  of the mask with the fixed factors' outer products (the JAX package
  ``vmap``s ``(F * m[:, None]).T @ F`` a row); the sums run in another
  order, so factors agree to a tolerance, not bits;
- the initial factors come from a ``torch.Generator`` on the data's
  device seeded with ``seed``, not from ``jax.random``; ``als_run``
  iterates from given ``(P0, Q0)``, so tests feed it JAX's;
- ``recommend`` / ``similar_items`` / ``user_similarity`` /
  ``recommend_content_based`` / ``recommend_hybrid`` are host numpy, as
  in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _solve_side(Fixed: torch.Tensor, Rside: torch.Tensor,
                Mside: torch.Tensor, l2: float) -> torch.Tensor:
    """For each row u: (F^T diag(m_u) F + l2 I) x_u = F^T (m_u * r_u)."""
    f = Fixed.shape[1]
    outer = (Fixed[:, :, None] * Fixed[:, None, :]).reshape(-1, f * f)
    A = (Mside @ outer).reshape(-1, f, f) + \
        l2 * torch.eye(f, device=Fixed.device)
    b = (Mside * Rside) @ Fixed
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


def als_run(R: torch.Tensor, M: torch.Tensor, P: torch.Tensor,
            Q: torch.Tensor, *, iters: int = 10, l2: float = 0.1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` alternations from (P, Q): users, then items."""
    Rt, Mt = R.T.contiguous(), M.T.contiguous()
    for _ in range(iters):
        P = _solve_side(Q, R, M, l2)
        Q = _solve_side(P, Rt, Mt, l2)
    return P, Q


def als_fit(ratings, mask, *, factors: int = 16, iters: int = 10,
            l2: float = 0.1, seed: int = 0) -> Dict:
    """ratings [U, I] with mask [U, I] (1 = observed). Classic ALS."""
    R = ratings.float()
    M = mask.float()
    U, I = R.shape
    gen = torch.Generator(device=R.device)
    gen.manual_seed(int(seed))
    P = torch.randn((U, factors), generator=gen, device=R.device) * 0.1
    Q = torch.randn((I, factors), generator=gen, device=R.device) * 0.1
    P, Q = als_run(R, M, P, Q, iters=iters, l2=l2)
    return {"user_factors": P, "item_factors": Q}


def predict_ratings(model: Dict, user_ids=None) -> torch.Tensor:
    P, Q = model["user_factors"], model["item_factors"]
    if user_ids is not None:
        P = P[torch.as_tensor(user_ids, device=P.device).long()]
    return P @ Q.T


def recommend(model: Dict, user_id: int, k: int = 10,
              exclude_mask=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k unseen items for a user: (scores, item_ids)."""
    scores = predict_ratings(model, [user_id])[0].cpu().numpy()
    if exclude_mask is not None:
        scores = np.where(np.asarray(exclude_mask, bool), -np.inf, scores)
    order = np.argsort(-scores)[:k]
    return scores[order], order


def recommend_content_based(item_features, item_id: int, k: int = 10
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Items most similar to ``item_id`` by cosine over raw feature
    vectors, excluding itself: (similarities, item_ids)."""
    F_ = np.asarray(item_features, np.float32)
    if not (0 <= item_id < len(F_)):
        raise ValueError(f"item_id {item_id} out of range [0, {len(F_)})")
    fn = F_ / np.maximum(np.linalg.norm(F_, axis=1, keepdims=True), 1e-12)
    sims = fn @ fn[item_id]
    sims[item_id] = -np.inf
    order = np.argsort(-sims)[:k]
    return sims[order], order


def user_similarity(ratings, mask, user1: int, user2: int) -> float:
    """Pearson correlation over co-rated items (0 below 2 co-rated items
    or at zero variance)."""
    R = np.asarray(ratings, np.float32)
    M = np.asarray(mask, bool)
    both = M[user1] & M[user2]
    if int(both.sum()) < 2:
        return 0.0
    x, y = R[user1][both], R[user2][both]
    vx, vy = x - x.mean(), y - y.mean()
    denom = float(np.sqrt((vx ** 2).sum() * (vy ** 2).sum()))
    if denom < 1e-12:
        return 0.0
    return float((vx * vy).sum() / denom)


def recommend_hybrid(model: Dict, item_features, user_id: int, *,
                     cf_weight: float = 0.7, k: int = 10,
                     exclude_mask=None) -> Tuple[np.ndarray, np.ndarray]:
    """cf_weight * CF + (1 - cf_weight) * content similarity to the
    user's top CF item, both min-max normalised: (scores, item_ids)."""
    if not 0.0 <= cf_weight <= 1.0:
        raise ValueError("cf_weight must be between 0.0 and 1.0")
    cf = predict_ratings(model, [user_id])[0].cpu().numpy()
    F_ = np.asarray(item_features, np.float32)
    if len(F_) != len(cf):
        raise ValueError("item_features rows must match item count")
    anchor = int(np.argmax(cf))
    fn = F_ / np.maximum(np.linalg.norm(F_, axis=1, keepdims=True), 1e-12)
    content = fn @ fn[anchor]

    def _norm(v):
        lo, hi = float(v.min()), float(v.max())
        return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)

    scores = cf_weight * _norm(cf) + (1.0 - cf_weight) * _norm(content)
    if exclude_mask is not None:
        scores = np.where(np.asarray(exclude_mask, bool), -np.inf, scores)
    order = np.argsort(-scores)[:k]
    return scores[order], order


def similar_items(model: Dict, item_id: int, k: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Item-item cosine neighbours in factor space."""
    Q = model["item_factors"].cpu().numpy()
    qn = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-12)
    sims = qn @ qn[item_id]
    sims[item_id] = -np.inf
    order = np.argsort(-sims)[:k]
    return sims[order], order
