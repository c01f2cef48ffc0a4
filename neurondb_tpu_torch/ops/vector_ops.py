"""Vector math and utility ops — the reference's SQL vector functions.

Counterpart of ``neurondb_tpu/ops/vector_ops.py``: element access,
elementwise arithmetic, reductions and statistics, normalization,
lexicographic comparison, the content hash and the batch aggregates.
Every function takes ``[..., D]`` tensors and broadcasts over the leading
dims; the batch forms take ``[N, D]``. Work runs on the input's device.

Divergences, each for a torch reason:

- ``vector_hash`` is FNV-1a over the f32 bits, as in the JAX package,
  computed in int64 masked to 32 bits (CUDA has no reliable uint32
  multiply); it returns int64 holding the same unsigned 32-bit values,
  bit for bit, where the JAX package returns uint32.
- ``vector_median`` / ``vector_percentile`` / ``vector_quantile`` sort
  and interpolate as ``jnp.median`` (midpoint) and ``jnp.percentile`` /
  ``jnp.quantile`` (linear) do, with the weights in f32 as JAX computes
  them, and the linear blend ``lo * w_lo + hi * w_hi`` rounded as XLA's
  CPU backend rounds it: one fused multiply-add over the first product
  (computed exactly in f64, then rounded to f32); ``torch.median`` (the
  lower middle) and ``torch.quantile`` (an input size limit) are not
  used.
- ``vector_argmin`` / ``vector_argmax`` return int64 (torch's index
  dtype), the first extremum as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# ---- element access / shape (vector_ops.c get/set/slice/append) ----

def vector_get(x: torch.Tensor, i) -> torch.Tensor:
    return x[..., i]


def vector_set(x: torch.Tensor, i, value) -> torch.Tensor:
    out = x.clone()
    out[..., i] = value
    return out


def vector_slice(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    return x[..., start:stop]


def vector_append(x: torch.Tensor, y) -> torch.Tensor:
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.cat([x, torch.atleast_1d(y)], dim=-1)


def vector_concat(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, y], dim=-1)


def vector_dims(x: torch.Tensor) -> int:
    return x.shape[-1]


# ---- elementwise arithmetic ----

def vector_add(x, y): return x + y
def vector_sub(x, y): return x - y
def vector_mul(x, y): return x * y          # alias of hadamard
def vector_hadamard(x, y): return x * y     # vector_ops.c:~300
def vector_div(x, y): return x / y
def vector_scale(x, s): return x * s        # vector_advanced.c scale
def vector_translate(x, t): return x + t    # vector_advanced.c translate
def vector_abs(x): return torch.abs(x)
def vector_square(x): return x * x
def vector_sqrt(x): return torch.sqrt(x)
def vector_pow(x, p): return torch.pow(x, p)
def vector_exp(x): return torch.exp(x)
def vector_log(x): return torch.log(x)
def vector_negate(x): return -x


def vector_cross_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3-D cross product (vector_advanced.c:30+)."""
    if x.shape[-1] != 3 or y.shape[-1] != 3:
        raise ValueError("cross product requires 3-dimensional vectors")
    return torch.linalg.cross(x, y, dim=-1)


# ---- reductions / stats (vector_ops.c stats block) ----

def vector_sum(x): return x.sum(-1)
def vector_mean(x): return x.mean(-1)
def vector_min(x): return x.amin(-1)
def vector_max(x): return x.amax(-1)
def vector_var(x): return x.var(-1, correction=0)
def vector_stddev(x): return x.std(-1, correction=0)
def vector_norm(x): return torch.linalg.vector_norm(x, dim=-1)
def vector_argmin(x): return torch.argmin(x, dim=-1)
def vector_argmax(x): return torch.argmax(x, dim=-1)


def _sorted_with_nan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sorted along ``dim``; a lane holding a NaN becomes all NaN (JAX's
    quantile returns NaN for it)."""
    x = x.float() if not x.is_floating_point() else x
    nan = torch.isnan(x).any(dim, keepdim=True)
    x = torch.where(nan, torch.full_like(x, float("nan")), x)
    return torch.sort(x, dim=dim).values


def _f32(q, device) -> torch.Tensor:
    if isinstance(q, torch.Tensor):
        return q.to(device, torch.float32)
    return torch.tensor(np.asarray(q, np.float32), device=device)


def _quantile(x: torch.Tensor, q, dim: int = -1,
              method: str = "linear") -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim, method=method)`` for scalar or 1-D
    ``q``: positions ``q * (n - 1)`` and weights in f32, the values
    gathered from the sorted lane; a 1-D ``q`` leads the output."""
    a = _sorted_with_nan(x, dim)
    dim = dim % a.ndim
    n = a.shape[dim]
    qt = _f32(q, a.device)
    pos = qt * float(n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    a = a.movedim(dim, -1)
    lo_v = a.index_select(-1, low.reshape(-1)).movedim(-1, 0)   # [nq, ...]
    hi_v = a.index_select(-1, high.reshape(-1)).movedim(-1, 0)
    shape = (-1,) + (1,) * (a.ndim - 1)
    if method == "midpoint":
        out = (lo_v + hi_v) * 0.5
    else:
        # fma(lo, w_lo, hi * w_hi): the product of two f32 values is exact
        # in f64, so one f64 add and the cast round as the fused op does
        out = (lo_v.double() * lw.reshape(shape).double()
               + (hi_v * hw.reshape(shape)).double()).float()
    out = out.to(a.dtype)
    return out[0] if qt.ndim == 0 else out


def vector_median(x: torch.Tensor) -> torch.Tensor:
    return _quantile(x, 0.5, method="midpoint")


def vector_percentile(x: torch.Tensor, pct) -> torch.Tensor:
    """vector_advanced.c percentile: pct in [0, 100]."""
    return _quantile(x, _f32(pct, x.device) / 100.0)


def vector_quantile(x: torch.Tensor, q) -> torch.Tensor:
    return _quantile(x, q)


# ---- normalization / transforms ----

def vector_normalize(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize; zero vectors pass through unchanged (reference guards
    zero norm rather than emitting NaN)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > 0, x / torch.clamp(n, min=eps), x)


def vector_clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.clamp(x, lo, hi)


def vector_standardize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-mean unit-variance per vector (vector_ops.c standardize)."""
    mu = x.mean(-1, keepdim=True)
    sd = x.std(-1, keepdim=True, correction=0)
    return (x - mu) / torch.clamp(sd, min=eps)


def vector_minmax_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    lo = x.amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=eps)


def vector_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


# ---- comparison / hash (src/core/operators.c:45-144) ----

def vector_eq(x, y): return torch.all(x == y, dim=-1)
def vector_ne(x, y): return torch.any(x != y, dim=-1)


def vector_lt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Lexicographic < (operators.c semantics)."""
    return _lex_cmp(x, y) < 0


def vector_le(x, y): return _lex_cmp(x, y) <= 0
def vector_gt(x, y): return _lex_cmp(x, y) > 0
def vector_ge(x, y): return _lex_cmp(x, y) >= 0


def _lex_cmp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-1/0/+1 (int32) lexicographic comparison along the last axis."""
    x, y = torch.broadcast_tensors(x, y)
    neq = x != y
    any_neq = neq.any(-1)
    first = torch.argmax(neq.to(torch.uint8), dim=-1, keepdim=True)
    xa = torch.gather(x, -1, first)[..., 0]
    ya = torch.gather(y, -1, first)[..., 0]
    sgn = torch.sign(xa - ya).to(torch.int32)
    return torch.where(any_neq, sgn, torch.zeros_like(sgn))


_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


def vector_hash(x: torch.Tensor) -> torch.Tensor:
    """Deterministic 32-bit content hash (FNV-1a over float bits), as
    int64 values in [0, 2^32): the JAX package's uint32 hash, bit for
    bit. The product of a 32-bit state and the 25-bit prime fits int64."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    h = torch.full(x.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                   device=x.device)
    for j in range(bits.shape[-1]):
        w = bits[..., j]
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((w >> shift) & 0xFF)) * _FNV_PRIME) & _U32
    return h


# ---- batch forms ([N, D]) (vector_batch.c) ----

def batch_normalize(xs: torch.Tensor) -> torch.Tensor:
    return vector_normalize(xs)


def batch_sum(xs: torch.Tensor) -> torch.Tensor:
    """Aggregate SUM over a set of vectors -> [D]."""
    return xs.sum(0)


def batch_avg(xs: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate AVG -> [D]; optional validity mask for padded rows."""
    if valid is None:
        return xs.mean(0)
    w = valid.to(xs.dtype)[:, None]
    return (xs * w).sum(0) / torch.clamp(w.sum(), min=1.0)
