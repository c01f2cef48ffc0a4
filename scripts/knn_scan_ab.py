#!/usr/bin/env python3
"""Times the kNN family's exact scan and the top-k selection under it, for
one tree of the port, on one card.

    python3 scripts/knn_scan_ab.py [--root DIR] [--label NAME]
                                   [--rows N] [--queries Q]

Imports ``neurondb_tpu_torch`` from ``--root`` (default: this checkout),
so two trees run in turns compare on one card (unpack the other one with
``git archive`` into a directory ``.gitignore`` lists). On a clustered
``--rows`` x 128 f32 table made on the card from seed 0 (1,024 centres,
unit spread), with 10 labels from the same generator, it times:

- ``ml.neighbors.knn_predict`` (classify, k 5) of ``--queries`` rows of
  the table against the whole table: the scan behind the kNN trainers'
  train-time evaluation and ``knn_outlier_scores``, wall seconds around
  one call after a warm-up on 4,096 rows;
- ``ops.topk.topk_smallest`` on one [4,096, 65,536] chunk of that scan's
  distances at k 5 and 6, and on a [1,024, 65,536] chunk at k 10 (CUDA
  events, median of 7 turns of 10 calls);
- ``ops.topk.chunked_knn`` of 1,024 of the rows at k 10 (``FlatIndex``'s
  search), the same way.

Prints the card's name and power limit, then one JSON line with the times
and a SHA-256 of the kNN predictions and of the chunked_knn ids, so that
two trees that should agree bit for bit can be checked. Needs one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def turns(fns, reps=10, n_turns=7):
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for t in range(n_turns):
        for name in order if t % 2 == 0 else order[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fns[name]()
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b) / reps)
    return {n: sorted(v)[len(v) // 2] for n, v in times.items()}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("knn_scan_ab: needs a CUDA card")
    from neurondb_tpu_torch.ml import neighbors as NB
    from neurondb_tpu_torch.ops import topk as TK
    assert NB.__file__.startswith(os.path.abspath(args.root))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, dim = args.rows, 128
    centres = torch.randn((1024, dim), generator=gen, device="cuda")
    pick = torch.randint(0, 1024, (n,), generator=gen, device="cuda")
    x = centres[pick] + torch.randn((n, dim), generator=gen, device="cuda")
    y = torch.randint(0, 10, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    model = NB.knn_fit(x, y, k=5, task="classify")
    q = x[:args.queries]

    NB.knn_predict(model, q[:4096])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = NB.knn_predict(model, q)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0

    xs = (x * x).sum(1)
    qb = x[:4096]
    d = torch.clamp((qb * qb).sum(1, keepdim=True) + xs[None, :65536]
                    - 2.0 * (qb @ x[:65536].T), min=0.0).sqrt()
    sel = turns({f"k {k}": (lambda k=k: TK.topk_smallest(d, k))
                 for k in (5, 6)})
    sel["[1024] k 10"] = turns(
        {"k": lambda: TK.topk_smallest(d[:1024], 10)})["k"]
    q1 = x[:1024]
    flat = turns({"chunked_knn": lambda: TK.chunked_knn(
        q1, x, 10, base_sqnorms=xs)}, reps=3, n_turns=5)["chunked_knn"]
    ids = TK.chunked_knn(q1, x, 10, base_sqnorms=xs)[1]

    print(json.dumps({
        "label": args.label, "card": smi, "rows": n,
        "queries": args.queries,
        "knn_predict_s": knn_s,
        "topk_smallest_ms": sel,
        "chunked_knn_1024x_rows_k10_ms": flat,
        "knn_pred_sha256": hashlib.sha256(
            pred.cpu().numpy().tobytes()).hexdigest()[:16],
        "chunked_knn_ids_sha256": hashlib.sha256(
            ids.cpu().numpy().tobytes()).hexdigest()[:16]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
