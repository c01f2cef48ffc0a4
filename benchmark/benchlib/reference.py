"""The plain reference: exact k nearest neighbours by brute force.

Plain PyTorch in float32 with TF32 off, on whatever device it is given.
It imports nothing of the program and takes nothing the program made: it
reads the corpus and the queries that the benchmark generated and handed
to both sides, and the program's answers only to judge them.

Distances are in the user's form, as the indexes return them: the
Euclidean distance for ``l2``, ``1 - cos`` for ``cosine`` (rows and
queries normalised here, in float32).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

QUERY_BLOCK = 4096      # queries a block of the scan
ROW_CHUNK = 262144      # corpus rows a chunk of the scan


@contextlib.contextmanager
def tf32_off():
    """Float32 products in full float32 on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def prepare(x: torch.Tensor, metric: str) -> torch.Tensor:
    """The rows as the metric sees them: unit rows for ``cosine``."""
    x = x.float()
    if metric == "cosine":
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-30)
    elif metric != "l2":
        raise ValueError(f"reference metric must be l2 or cosine, got "
                         f"{metric!r}")
    return x


def _user_form(sq: torch.Tensor, metric: str) -> torch.Tensor:
    """Squared Euclidean distance -> the distance the user sees (on unit
    rows ``|q - x|^2 / 2 = 1 - cos``)."""
    if metric == "l2":
        return torch.sqrt(sq.clamp_min(0.0))
    return sq * 0.5


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int, metric: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [S, k] f32 ascending, row ids [S, k] int64) of the k
    nearest rows of ``x`` to each query: |q|^2 + |x|^2 - 2 q.x in float32
    over the whole corpus, chunk by chunk. ``x`` and ``q`` must come from
    ``prepare``."""
    n = x.shape[0]
    out_d, out_i = [], []
    with tf32_off():
        xsq = (x * x).sum(1)
        for s in range(0, q.shape[0], QUERY_BLOCK):
            qb = q[s:s + QUERY_BLOCK]
            qsq = (qb * qb).sum(1, keepdim=True)
            best_d = best_i = None
            for c in range(0, n, ROW_CHUNK):
                xc = x[c:c + ROW_CHUNK]
                d = qsq + xsq[None, c:c + ROW_CHUNK] - 2.0 * (qb @ xc.T)
                v, i = torch.topk(d, min(k, d.shape[1]), dim=1,
                                  largest=False)
                i = i + c
                if best_d is not None:
                    v = torch.cat([best_d, v], 1)
                    i = torch.cat([best_i, i], 1)
                    v, p = torch.topk(v, k, dim=1, largest=False)
                    i = torch.gather(i, 1, p)
                best_d, best_i = v, i
            order = torch.argsort(best_d, dim=1, stable=True)
            out_d.append(_user_form(torch.gather(best_d, 1, order), metric))
            out_i.append(torch.gather(best_i, 1, order))
    return torch.cat(out_d), torch.cat(out_i)


def distances_of(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """The true distance [M, k] of each answered row id to its query,
    summed directly over (q - x)^2 in float32; NaN where the id is not a
    row of the corpus. ``q`` [M, D] holds each answer row's query."""
    n = x.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = x[ids.clamp(0, n - 1)]                      # [M, k, D]
    sq = ((q[:, None, :] - rows) ** 2).sum(-1)
    return torch.where(ok, _user_form(sq, metric), float("nan"))


def quantized_rows(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The rows as a store of a lower precision would hold them, back in
    float32: ``int8`` (symmetric, one scale a row, max |x| / 127) or
    ``fp8`` (float8 e4m3, the rows' range within its own)."""
    if precision == "int8":
        scale = x.abs().amax(1, keepdim=True).clamp_min(1e-30) / 127.0
        return torch.round(x / scale).clamp(-127, 127) * scale
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown control precision {precision!r}")
