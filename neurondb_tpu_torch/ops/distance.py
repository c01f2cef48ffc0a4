"""Distance functions — the ``<->`` / ``<=>`` / ``<#>`` operators.

Counterpart of ``neurondb_tpu/ops/distance.py``. The metric registry and
its aliases are the same; ``pairwise_distance`` serves l2, sqeuclidean,
ip and cosine with the GEMM expansion. The other metrics (l1, hamming,
chebyshev, minkowski, jaccard, dice) are ROADMAP queue 1 item 14 and
raise ``NotImplementedError`` until then.

Numeric contract: every product is an f32 matmul. ``dot_dtype=bf16``
rounds the GEMM inputs to bf16 and upcasts them again, so the products
of bf16 values are exact in f32 — the contract of the JAX package's
bf16 x bf16 -> f32 MXU dots. No matmul here has a bf16 output.
"""

from __future__ import annotations

from typing import Optional

import torch

METRICS = ("l2", "sqeuclidean", "cosine", "ip", "l1", "hamming",
           "chebyshev", "minkowski", "jaccard", "dice")
ALIASES = {
    "<->": "l2", "euclidean": "l2", "l2_distance": "l2",
    "<=>": "cosine", "angular": "cosine",
    "<#>": "ip", "inner_product": "ip", "dot": "ip", "neg_ip": "ip",
    "<+>": "l1", "manhattan": "l1", "taxicab": "l1",
    "<~>": "hamming",
    "squared_l2": "sqeuclidean", "sql2": "sqeuclidean",
    "linf": "chebyshev",
}
GEMM_METRICS = ("l2", "sqeuclidean", "cosine", "ip")


def canonical_metric(name: str) -> str:
    m = ALIASES.get(name, name)
    if m not in METRICS:
        raise ValueError(f"unknown distance metric {name!r}; known: {METRICS}")
    return m


def _dot(a: torch.Tensor, b: torch.Tensor, dot_dtype) -> torch.Tensor:
    """a [B, D] . b [N, D]^T in f32, inputs optionally rounded first."""
    if dot_dtype is not None:
        a, b = a.to(dot_dtype), b.to(dot_dtype)
    return a.float() @ b.float().T


def pairwise_distance(queries: torch.Tensor, base: torch.Tensor,
                      metric: str = "l2", *,
                      base_sqnorms: Optional[torch.Tensor] = None,
                      dot_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] distances.

    l2/sqeuclidean use ||q||^2 + ||x||^2 - 2 q.x (clamped at 0); ip is
    -q.x; cosine is 1 - q.x / (|q||x|) with 0 similarity on zero
    vectors. ``base_sqnorms`` caches ||x||^2; norms are taken from the
    incoming precision, only the GEMM inputs see ``dot_dtype``."""
    metric = canonical_metric(metric)
    if metric not in GEMM_METRICS:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet (ROADMAP queue 1 item 14)")
    q = queries.float()
    if metric in ("l2", "sqeuclidean"):
        qn = (q * q).sum(-1, keepdim=True)                          # [B, 1]
        if base_sqnorms is not None:
            xn = base_sqnorms.float()
        else:
            xf = base.float()
            xn = (xf * xf).sum(-1)
        d2 = torch.clamp(qn + xn[None, :] - 2.0 * _dot(q, base, dot_dtype),
                         min=0.0)
        return d2 if metric == "sqeuclidean" else torch.sqrt(d2)
    if metric == "ip":
        return -_dot(q, base, dot_dtype)
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)          # [B, 1]
    xn = (torch.sqrt(base_sqnorms.float()) if base_sqnorms is not None
          else torch.linalg.vector_norm(base.float(), dim=-1))      # [N]
    dots = _dot(q, base, dot_dtype)
    den = torch.clamp(qn * xn[None, :], min=1e-30)
    sim = torch.where((qn > 0) & (xn[None, :] > 0), dots / den,
                      torch.zeros((), dtype=dots.dtype, device=dots.device))
    return 1.0 - sim
