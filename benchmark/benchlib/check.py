"""The comparison that decides ``correct``.

Every sampled answer of the window (a fixed sample of rows of each pool
batch, drawn from the seed) is held to the reference's exact neighbours
of the same query. These numbers are read, a larger one worse; a cell
compares those its traffic file gives a limit:

- ``unanswered``: answer rows that hold an id outside the corpus or the
  same id twice (exact: limit 0);
- ``recall_miss``: 1 - the mean recall@k of the answers against the
  exact top-k;
- ``dist_gap``: the largest gap between a returned distance and the true
  distance of the returned row, in units of that query's exact k-th
  neighbour distance. It catches a wrong id map, a wrong distance and a
  lower precision.

The control puts the reference in the program's place with the store in
a lower precision (``reference.quantized_rows``) and is judged the same
way.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchlib import reference as R

JUDGE_ROWS = 65536        # answer rows judged a block


def sample_rows(seed: int, pool: int, batch: int, per_batch: int
                ) -> np.ndarray:
    """[pool, per_batch] sorted row indices of each pool batch whose
    answers are compared, drawn from the seed."""
    from benchlib.corpus import stream_seed
    rng = np.random.default_rng(stream_seed(seed, "sample"))
    per_batch = min(per_batch, batch)
    return np.stack([np.sort(rng.choice(batch, per_batch, replace=False))
                     for _ in range(pool)])


def judge(x: torch.Tensor, q: torch.Tensor, ref_d: torch.Tensor,
          ref_i: torch.Tensor, qrow: np.ndarray, ans_d: np.ndarray,
          ans_i: np.ndarray, metric: str) -> Dict[str, float]:
    """The numbers of one set of answers. ``x``, ``q``: prepared corpus
    and sampled queries on the device; ``ref_d``, ``ref_i`` [S, k] the
    reference's exact neighbours of ``q``; ``qrow`` [M] the sampled query
    of each answer row; ``ans_d``, ``ans_i`` [M, k] the answers."""
    dev = x.device
    k = ref_i.shape[1]
    n = x.shape[0]
    bad = 0
    hits = 0
    gap = 0.0
    m = len(qrow)
    for s in range(0, m, JUDGE_ROWS):
        e = min(s + JUDGE_ROWS, m)
        qi = torch.as_tensor(qrow[s:e], device=dev).long()
        ids = torch.as_tensor(np.asarray(ans_i[s:e]), device=dev).long()
        dd = torch.as_tensor(np.asarray(ans_d[s:e], np.float32), device=dev)
        if ids.shape[1] != k:
            raise ValueError(f"answers hold {ids.shape[1]} ids a row, "
                             f"expected {k}")
        valid = (ids >= 0) & (ids < n)
        srt = torch.sort(ids, dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        bad += int((~valid.all(1) | dup).sum())
        ri = ref_i[qi]
        hits += int((ids[:, :, None] == ri[:, None, :]).any(-1).sum())
        true_d = R.distances_of(x, q[qi], ids, metric)
        scale = ref_d[qi, k - 1:k].clamp_min(1e-12)
        g = ((dd - true_d).abs() / scale)[valid]
        if g.numel():
            g = torch.nan_to_num(g, nan=float("inf"))
            gap = max(gap, float(g.max()))
    return {"unanswered": float(bad),
            "recall_miss": 1.0 - hits / max(m * k, 1),
            "dist_gap": gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every compared number within its limit, {name: {value, limit}}).
    The numbers compared are those the traffic file gives a limit: a
    number that the control does not separate from sound runs has none."""
    out = {name: {"value": numbers[name], "limit": float(lim)}
           for name, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out


def control_answers(x: torch.Tensor, q: torch.Tensor, k: int, metric: str,
                    precision: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference in the program's place with its rows in a lower
    precision: exact top-k over the quantized rows, the distances as that
    store computes them. ``x``, ``q`` prepared."""
    d, i = R.exact_knn(R.quantized_rows(x, precision), q, k, metric)
    return d.cpu().numpy(), i.cpu().numpy()
