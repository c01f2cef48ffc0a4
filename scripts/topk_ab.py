#!/usr/bin/env python3
"""The port's tie-ruled top-k against ``torch.topk``, on one card.

    python3 scripts/topk_ab.py

``lax.top_k`` returns the lowest index first among equal values;
``torch.topk`` promises no order among ties. ``ops.topk.topk_smallest``
keeps the rule: one stable sort for rows up to ``ROW_SORT_MAX`` columns,
else one pass over 128-column group minima where the k groups kept are
at most half the row, else a ``torch.topk`` for the k-th value and a
second over the indices equal to it. This script holds it to a stable
sort on integer rows full of ties, then times it in alternating turns
(CUDA events, medians of 7 turns of 20 calls) beside plain
``torch.topk`` and a bare stable ``torch.sort`` at the port's shapes: the IVF coarse top-k [16,384, 1,024]
at n 4 and 16, one quantized-flat scan chunk [1,024, 65,536] at k 80,
and the hybrid fusion's text top-C [512, 200,000] at k 100.

Prints the card's name and power limit first. Needs one card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurondb_tpu_torch.ops import topk as TK  # noqa: E402

SHAPES = (((16384, 1024), 4), ((16384, 1024), 16), ((1024, 65536), 80),
          ((512, 200_000), 100))


WAYS = {"stable sort": lambda s, k: torch.sort(s, dim=-1, stable=True),
        "topk_smallest": TK.topk_smallest}


def turns(fns, reps=20, n_turns=7):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("topk_ab: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, k in SHAPES:
        tied = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        sv, si = torch.sort(tied, dim=-1, stable=True)
        v, i = TK.topk_smallest(tied, k)
        ok = torch.equal(i, si[:, :k]) and torch.equal(v, sv[:, :k])
        print(f"{shape} k {k} topk_smallest: equals a stable sort on tied "
              f"rows: {ok}", flush=True)
        s = torch.randn(shape, generator=gen, device="cuda")
        fns = {"torch.topk": lambda: torch.topk(s, k, dim=-1, largest=False)}
        fns.update({n: (lambda f=f: f(s, k)) for n, f in WAYS.items()})
        ms = turns(fns)
        print(f"{shape} k {k}: " + ", ".join(f"{n} {t:.4f} ms"
                                            for n, t in ms.items()),
              flush=True)


if __name__ == "__main__":
    main()
