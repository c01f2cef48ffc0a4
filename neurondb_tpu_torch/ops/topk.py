"""Top-k selection and the chunked exact k-NN scan.

Counterpart of ``neurondb_tpu/ops/topk.py``. Both selections break ties
as ``lax.top_k`` does: among equal values the lowest index comes first
(``torch.topk`` promises no order among ties). Deliberate divergences:
``recall_target < 1.0`` selected with ``lax.approx_min_k`` on the TPU;
the card has no such primitive, so it is served exactly here. -0.0 and
0.0 are one value here (index order between them); ``lax.top_k`` orders
-0.0 first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from neurondb_tpu_torch.ops import distance as D

NEG_FILL = float(torch.finfo(torch.float32).max)


ROW_SORT_MAX = 4096   # rows this wide or narrower: one stable sort
GROUP = 128           # columns a group in _grouped_positions


def topk_smallest(scores: torch.Tensor, k: int, *,
                  recall_target: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis -> (values, indices), ascending,
    the lowest index first among equal values, as ``lax.top_k(-scores)``
    gives them (-0.0 counts as equal to 0.0 here, where ``lax.top_k``
    puts it first). Rows of up to ``ROW_SORT_MAX`` take one stable sort;
    wider rows ``_wide_positions``. ``recall_target`` is accepted for
    parity and served exactly."""
    if scores.shape[-1] <= ROW_SORT_MAX:
        v, pos = torch.sort(scores, dim=-1, stable=True)
        return v[..., :k], pos[..., :k]
    pos = _wide_positions(scores.float(), k)
    return torch.gather(scores, -1, pos), pos


def topk_largest(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis -> (values, indices), descending,
    the lowest index first among equal values: ``lax.top_k(scores)``."""
    if scores.shape[-1] <= ROW_SORT_MAX:
        v, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
        return v[..., :k], pos[..., :k]
    pos = _wide_positions(0.0 - scores.float(), k)
    return torch.gather(scores, -1, pos), pos


def _wide_positions(s: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest of f32 ``s`` in (value, index) order:
    ``_grouped_positions`` where the k groups it keeps are at most half
    the row, else ``_smallest_positions``."""
    k = min(k, s.shape[-1])
    if 2 * k * GROUP <= s.shape[-1]:
        return _grouped_positions(s, k)
    return _smallest_positions(s + 0.0, k)                # -0.0 -> 0.0


def _grouped_positions(s: torch.Tensor, k: int) -> torch.Tensor:
    """``_wide_positions`` with no selection over the whole row: its
    groups of ``GROUP`` columns are ranked by (minimum, group index), and the k
    smallest (value, index) entries lie in the first k groups (a group
    outside them has k groups before it, each holding an entry before all
    of its own). Those groups' columns, in index order, then take a
    stable selection. A NaN counts as +inf in a group's minimum (it sorts
    after +inf in the selection), so the result is a stable sort's unless
    the row's k smallest reach +inf beside a group holding only NaNs."""
    n = s.shape[-1]
    G = n // GROUP
    inf = float("inf")
    mins = torch.nan_to_num(s[..., :G * GROUP].unflatten(-1, (G, GROUP)),
                            nan=inf, posinf=inf, neginf=-inf).amin(-1)
    if G * GROUP < n:
        tail = torch.nan_to_num(s[..., G * GROUP:], nan=inf, posinf=inf,
                                neginf=-inf).amin(-1, keepdim=True)
        mins = torch.cat([mins, tail], dim=-1)
    _, gsel = topk_smallest(mins, k)
    gsel = torch.sort(gsel, dim=-1).values                # index order
    cpos = (gsel[..., None] * GROUP
            + torch.arange(GROUP, device=s.device)).flatten(-2)
    cand = torch.gather(s, -1, cpos.clamp(max=n - 1))
    # past the row's end: NaN, which sorts after every entry of the row
    _, p = topk_smallest(cand.masked_fill(cpos >= n, float("nan")), k)
    return torch.gather(cpos, -1, p)


def _smallest_positions(s: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest of f32 ``s`` (no -0.0: ``==`` and
    ``<`` must see one zero) in (value, index) order: one ``torch.topk``
    for the k-th value, a second over the indices of the values equal to
    it (the lowest of them fill the slots the smaller values leave), and
    a stable sort of the k picks by value."""
    n = s.shape[-1]
    k = min(k, n)
    v, pos = torch.topk(s, k, dim=-1, largest=False, sorted=True)
    kth = v[..., -1:]
    n_less = (v < kth).sum(-1, keepdim=True)
    idx = torch.arange(n, dtype=torch.int32, device=s.device)
    ties = torch.topk(torch.where(s == kth, idx, n), k, dim=-1,
                      largest=False, sorted=True).values.long()
    # the picks below the k-th value, by index, then stably by value
    pos = torch.gather(pos, -1, torch.argsort(pos, dim=-1))
    pos = torch.gather(pos, -1, torch.sort(torch.gather(s, -1, pos),
                                           dim=-1, stable=True).indices)
    slot = torch.arange(k, device=s.device)
    return torch.where(slot >= n_less,
                       torch.gather(ties, -1, (slot - n_less).clamp(min=0)),
                       pos)


def merge_topk(vals_a: torch.Tensor, idx_a: torch.Tensor,
               vals_b: torch.Tensor, idx_b: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (values, ids) top-k sets -> ascending top-k. On equal
    distance the candidate from ``a`` wins (stable sort over the
    concatenation), as in the JAX package."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    v, pos = torch.sort(vals, dim=-1, stable=True)
    k = min(k, vals.shape[-1])
    return v[..., :k], torch.gather(idx, -1, pos[..., :k])


def chunked_knn(queries: torch.Tensor, base: torch.Tensor, k: int, *,
                metric: str = "l2", chunk: int = 65536,
                base_sqnorms: Optional[torch.Tensor] = None,
                ids: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                recall_target: float = 1.0,
                dot_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN without materializing [B, N]: a loop over N-chunks,
    GEMM distances per chunk, running top-k merge. Returns (dists [B, k],
    ids [B, k]) ascending; masked rows score ``NEG_FILL``. ``ids``
    defaults to the row number (int32); the output ids take its dtype."""
    metric = D.canonical_metric(metric)
    B = queries.shape[0]
    N = base.shape[0]
    k = min(k, N)
    dev = queries.device
    bvals = torch.full((B, k), NEG_FILL, dtype=torch.float32, device=dev)
    id_dtype = ids.dtype if ids is not None else torch.int32
    bids = torch.full((B, k), -1, dtype=id_dtype, device=dev)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        sq = base_sqnorms[s:e] if base_sqnorms is not None else None
        d = D.pairwise_distance(queries, base[s:e], metric,
                                base_sqnorms=sq, dot_dtype=dot_dtype).float()
        if valid is not None:
            d = d.masked_fill(~valid[s:e][None, :], NEG_FILL)
        cv, cpos = topk_smallest(d, k, recall_target=recall_target)
        if ids is not None:
            cids = ids[s:e][cpos]
        else:
            cids = (cpos + s).to(id_dtype)
        bvals, bids = merge_topk(bvals, bids, cv, cids, k)
    return bvals, bids
