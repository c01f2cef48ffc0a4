"""Distance functions — the ``<->`` / ``<=>`` / ``<#>`` operators.

Counterpart of ``neurondb_tpu/ops/distance.py``: the same metric
registry and aliases, the same pair forms (``l1_distance(x, y)``, ...,
broadcast over leading dims) and ``pairwise_distance`` for every metric.
l2, sqeuclidean, ip and cosine use the GEMM expansion. jaccard and dice
count their indicator intersections with a GEMM of 0/1 values, and
hamming on packed uint8 codes with a GEMM of +-1 bits (hamming =
(bits - dot) / 2): integer sums, exact in f32, so both equal the JAX
package's broadcast counts. l1, chebyshev, minkowski and hamming on
other dtypes broadcast ``[b, n, D]`` in blocks of at most
``BROADCAST_ELEMS`` elements, where the JAX package broadcasts the whole
``[B, N, D]``.

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
BROADCAST_ELEMS = 1 << 24     # [b, n, D] block of the broadcast metrics


def canonical_metric(name: str) -> str:
    m = ALIASES.get(name, name)
    if m not in METRICS:
        raise ValueError(f"unknown distance metric {name!r}; known: {METRICS}")
    return m


# --------------------------------------------------------------------------
# pair forms (broadcast over leading dims)
# --------------------------------------------------------------------------

def squared_l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = x - y
    return (d * d).sum(-1)


def l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(squared_l2_distance(x, y))


def inner_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def inner_product_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``<#>``: negative inner product, ascending = most similar."""
    return -inner_product(x, y)


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      eps: float = 0.0) -> torch.Tensor:
    num = inner_product(x, y)
    den = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    return torch.where(den > eps, num / torch.clamp(den, min=1e-30),
                       torch.zeros((), dtype=num.dtype, device=num.device))


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 1.0 - cosine_similarity(x, y)


def l1_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().sum(-1)


def chebyshev_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().amax(-1)


def minkowski_distance(x: torch.Tensor, y: torch.Tensor,
                       p: float = 3.0) -> torch.Tensor:
    if p <= 0:
        raise ValueError("minkowski p must be > 0")
    return torch.pow(torch.pow((x - y).abs(), p).sum(-1), 1.0 / p)


def hamming_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bit-level Hamming distance (int32): popcount of xor on packed
    uint8 codes, else the count of mismatched components."""
    if x.dtype == torch.uint8 and y.dtype == torch.uint8:
        return _popcount_u8(torch.bitwise_xor(x, y)).sum(-1, dtype=torch.int32)
    return (x != y).sum(-1, dtype=torch.int32)


def _indicator_counts(x, y):
    xb, yb = x > 0, y > 0
    inter = (xb & yb).sum(-1).float()
    return inter, xb.sum(-1), yb.sum(-1)


def jaccard_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jaccard over binary indicators (> 0)."""
    inter, nx, ny = _indicator_counts(x, y)
    union = (nx + ny).float() - inter
    return _set_ratio(inter, union, 1.0)


def dice_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    inter, nx, ny = _indicator_counts(x, y)
    return _set_ratio(inter, (nx + ny).float(), 2.0)


def _set_ratio(inter, total, scale):
    """where(total > 0, 1 - scale * inter / max(total, 1), 0) in f32."""
    r = 1.0 - scale * inter / torch.clamp(total, min=1.0)
    return torch.where(total > 0, r, torch.zeros((), device=r.device))


def mahalanobis_distance(x: torch.Tensor, y: torch.Tensor,
                         vi: torch.Tensor) -> torch.Tensor:
    """Mahalanobis with inverse covariance ``vi`` [D, D]."""
    d = x - y
    return torch.sqrt(torch.einsum("...i,ij,...j->...", d, vi, d))


def _popcount_u8(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount on uint8 lanes -> int32."""
    v = (v & 0x55) + ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v & 0x0F) + ((v >> 4) & 0x0F)
    return v.to(torch.int32)


# --------------------------------------------------------------------------
# pairwise [B, D] x [N, D] -> [B, N]
# --------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor, dot_dtype) -> torch.Tensor:
    """a [B, D] . b [N, D]^T in f32, inputs optionally rounded first."""
    if dot_dtype is not None:
        a, b = a.to(dot_dtype), b.to(dot_dtype)
    return a.float() @ b.float().T


def unpack_signs(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed uint8 bits [N, nb] -> [N, 8 nb] of +-1 (bit i of byte j is
    component 8j + i, as ``types.quantized``'s packer lays it out)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    return (bits.reshape(*codes.shape[:-1], -1).to(dtype) * 2 - 1)


SIGN_SLAB = 256   # bits per GEMM slab: +-256 is exact in a bf16 output


def hamming_packed(qcodes: torch.Tensor, xcodes: torch.Tensor) -> torch.Tensor:
    """[B, nb] x [N, nb] packed uint8 codes -> [B, N] int32 Hamming
    distances through GEMMs of +-1 bits: each 256-bit slab's dot is an
    integer in [-256, 256], exact in the bf16 output of a bf16 GEMM on
    the card (f32 on the CPU); slabs are summed in int32."""
    dt = torch.bfloat16 if qcodes.device.type == "cuda" else torch.float32
    nb = qcodes.shape[-1]
    out = torch.zeros(qcodes.shape[0], xcodes.shape[0], dtype=torch.int32,
                      device=qcodes.device)
    step = SIGN_SLAB // 8
    for s in range(0, nb, step):
        e = min(s + step, nb)
        dot = unpack_signs(qcodes[:, s:e], dt) @ unpack_signs(xcodes[:, s:e], dt).T
        out += (8 * (e - s) - dot.to(torch.int32)) // 2
    return out


def _broadcast_blocks(q: torch.Tensor, x: torch.Tensor, fn,
                      dtype=torch.float32) -> torch.Tensor:
    """fn(q[:, None, :], x[None, :, :]) -> [B, N], in blocks of at most
    ``BROADCAST_ELEMS`` broadcast elements."""
    B, N = q.shape[0], x.shape[0]
    dim = max(int(q.shape[-1]), 1)
    out = torch.empty(B, N, dtype=dtype, device=q.device)
    nb = max(1, min(N, BROADCAST_ELEMS // dim))
    bb = max(1, BROADCAST_ELEMS // (dim * nb))
    for i in range(0, B, bb):
        for j in range(0, N, nb):
            out[i:i + bb, j:j + nb] = fn(q[i:i + bb, None, :],
                                          x[None, j:j + nb, :])
    return out


def pairwise_distance(queries: torch.Tensor, base: torch.Tensor,
                      metric: str = "l2", *, p: float = 3.0,
                      base_sqnorms: Optional[torch.Tensor] = None,
                      dot_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] distances.

    l2/sqeuclidean use ||q||^2 + ||x||^2 - 2 q.x (clamped at 0); ip is
    -q.x; cosine is 1 - q.x / (|q||x|) with 0 similarity on zero
    vectors. ``base_sqnorms`` caches ||x||^2; norms are taken from the
    incoming precision, only the GEMM inputs see ``dot_dtype``. hamming
    is int32 (packed bits on two uint8 inputs, else mismatches); the
    other metrics are f32."""
    metric = canonical_metric(metric)
    if metric == "hamming":
        if queries.dtype == torch.uint8 and base.dtype == torch.uint8:
            return hamming_packed(queries, base)
        return _broadcast_blocks(queries, base, hamming_distance, torch.int32)
    if metric in ("jaccard", "dice"):
        qb, xb = (queries > 0).float(), (base > 0).float()
        inter = qb @ xb.T
        nq, nx = qb.sum(-1)[:, None], xb.sum(-1)[None, :]
        if metric == "jaccard":
            return _set_ratio(inter, nq + nx - inter, 1.0)
        return _set_ratio(inter, nq + nx, 2.0)
    if metric == "l1":
        return _broadcast_blocks(queries.float(), base.float(), l1_distance)
    if metric == "chebyshev":
        return _broadcast_blocks(queries.float(), base.float(),
                                 chebyshev_distance)
    if metric == "minkowski":
        return _broadcast_blocks(
            queries.float(), base.float(),
            lambda a, b: minkowski_distance(a, b, p))
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


# Names matching the reference SQL functions, for the API layer.
vector_l2_distance = l2_distance
vector_cosine_distance = cosine_distance
vector_inner_product = inner_product
vector_l1_distance = l1_distance
