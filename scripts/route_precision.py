#!/usr/bin/env python
"""How the IVFFlat routes' arithmetic agrees with the committed ground
truth, by exact search on the CPU.

The committed file ``bench_cache/gt_clustered_1000000_1000.npz`` was
computed with bf16-rounded queries and rows and f32 row norms. The
port's grouped route rounds the query to bf16 and takes |x|^2 from the
bf16 row; its probe route keeps the f32 query. This script runs an exact
top-10 over the 1M x 128 clustered corpus of ``bench.py`` under each of
those precisions (and plain f32) and prints each one's recall@10 against
the file and against the others: the part of the routes' recall that is
arithmetic rather than probing.

Usage: python scripts/route_precision.py   # CPU, ~1.5 GB, ~1 minute
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

N, DIM, NQ, K = 1_000_000, 128, 1000, 10
CHUNK = 131072


def _recall(a, b):
    return float(np.mean([len(set(r) & set(s)) / K for r, s in zip(a, b)]))


def _top10(q, x, xsq):
    """Exact top-10 of |q|^2 + xsq - 2 q.x over x, in row chunks."""
    qsq = (q * q).sum(1)
    best_d = torch.full((len(q), K), float("inf"))
    best_i = torch.zeros((len(q), K), dtype=torch.long)
    for s in range(0, len(x), CHUNK):
        d = qsq[:, None] + xsq[None, s:s + CHUNK] - 2.0 * (q @ x[s:s + CHUNK].T)
        cd = torch.cat([best_d, d], 1)
        ci = torch.cat([best_i, torch.arange(s, s + d.shape[1]).expand(len(q), -1)], 1)
        best_d, p = torch.topk(cd, K, largest=False)
        best_i = torch.gather(ci, 1, p)
    return best_i.numpy()


def main():
    from bench import make_corpus        # numpy and the stdlib only
    x = make_corpus(N, DIM, corpus="clustered")
    rng = np.random.default_rng(1)       # bench.py:100-103
    q = (x[rng.choice(N, NQ, replace=False)]
         + 0.05 * rng.standard_normal((NQ, DIM)).astype(np.float32))
    gt = np.load(os.path.join(ROOT, "bench_cache",
                              f"gt_clustered_{N}_{NQ}.npz"))["gt_ids"]
    xf = torch.from_numpy(x)
    xb = xf.to(torch.bfloat16).float()
    qf = torch.from_numpy(q.astype(np.float32))
    qb = qf.to(torch.bfloat16).float()
    ids = {
        "probe route (f32 q, bf16 x, |x|^2 of bf16 x)": _top10(qf, xb, (xb * xb).sum(1)),
        "grouped route (bf16 q, bf16 x, |x|^2 of bf16 x)": _top10(qb, xb, (xb * xb).sum(1)),
        "committed file's (bf16 q, bf16 x, |x|^2 of f32 x)": _top10(qb, xb, (xf * xf).sum(1)),
        "f32": _top10(qf, xf, (xf * xf).sum(1)),
    }
    names = list(ids)
    for n in names:
        print(json.dumps({"arithmetic": n,
                          "recall@10 vs committed ground truth": _recall(ids[n], gt),
                          **{f"vs {m}": _recall(ids[n], ids[m])
                             for m in names if m != n}}))


if __name__ == "__main__":
    main()
