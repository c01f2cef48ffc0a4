"""Readings that the cells' fixed parameters and limits are set from.

    python3 benchmark/calibrate.py --workload <cell> --sweep
    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --controls int8,fp8 --control-seeds 1,2,3 --seconds 3

``--sweep`` builds the cell's index at seed 0 and prints recall@10 of the
pool's sampled queries at each value of the traffic's ``sweep`` (the
``nprobe`` or ``ef`` that the mix then fixes). ``--seeds`` runs the cell
as a run does (set-up, a short window at the cell's own load, the
comparison) on each seed and prints the compared numbers: the program's
lower readings. ``--controls`` puts the reference in the program's place
with the store in a lower precision on each control seed and prints the
same numbers: the upper readings. One JSON line each; the benchmark's
own runs never run this. Needs the card, as a run does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _ints(s):
    return [int(v) for v in s.split(",") if v]


def emit(rec, out):
    print(json.dumps(rec), file=out, flush=True)


def sweep(cell, device, out):
    import numpy as np
    import torch
    from benchlib import corpus
    from benchlib import main as M
    mix = cell.traffic
    pool, sample = M.make_queries(cell, 0, device)
    index, build_s = M.build_index(cell, 0, device)
    emit({"kind": "sweep_build", "cell": cell.name, "seed": 0,
          "build_s": build_s}, out)
    x = corpus.corpus(cell.config["corpus"], 0, device)
    for v in mix["sweep"]:
        m = dict(mix, **{mix["param"]: v})
        s = cell.driver.Searcher(index, cell.config, m)
        l0 = s.launches()
        t = time.perf_counter()
        answers = [s.collect(s.dispatch(q)) for q in pool]
        M.sync(device)
        secs = time.perf_counter() - t
        l1 = s.launches()
        d = [a[0][sample[i]] for i, a in enumerate(answers)]
        ids = [a[1][sample[i]] for i, a in enumerate(answers)]
        numbers, _ = M.compare(cell, pool, sample, [], device, x,
                               answers=(np.concatenate(d),
                                        np.concatenate(ids)))
        emit({"kind": "sweep", "cell": cell.name, mix["param"]: v,
              "recall_at_10": 1.0 - numbers["recall_miss"],
              "numbers": numbers, "serial_batch_ms": 1e3 * secs / len(pool),
              "launches": {n: l1[n] - l0[n] for n in l1}}, out)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def seeds(cell, device, seed_list, seconds, out):
    import torch
    from benchlib import corpus, window
    from benchlib import main as M
    mix = cell.traffic
    for seed in seed_list:
        pool, sample = M.make_queries(cell, seed, device)
        index, build_s = M.build_index(cell, seed, device)
        s = cell.driver.Searcher(index, cell.config, mix)
        for q in pool:
            s.collect(s.dispatch(q))
        res = window.run_window(s.dispatch, s.collect, pool, sample,
                                depth=int(mix["in_flight"]), seconds=seconds)
        del s, index
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        x = corpus.corpus(cell.config["corpus"], seed, device)
        numbers, failed = M.compare(cell, pool, sample, res.batches, device,
                                    x)
        del x
        emit({"kind": "program", "cell": cell.name, "seed": seed,
              "numbers": numbers, "failed": failed,
              "batches": len(res.batches), "build_s": build_s}, out)


def controls(cell, device, seed_list, precisions, out):
    import numpy as np
    import torch
    from benchlib import check, corpus
    from benchlib import main as M
    from benchlib import reference as R
    metric, k = cell.config["metric"], int(cell.traffic["k"])
    for seed in seed_list:
        pool, sample = M.make_queries(cell, seed, device)
        x = corpus.corpus(cell.config["corpus"], seed, device)
        qs = np.concatenate([pool[s][sample[s]] for s in range(len(pool))])
        qr = R.prepare(torch.as_tensor(qs, device=device), metric)
        for prec in precisions:
            ans = check.control_answers(R.prepare(x, metric), qr, k, metric,
                                        prec)
            numbers, _ = M.compare(cell, pool, sample, [], device, x,
                                   answers=ans)
            emit({"kind": "control", "cell": cell.name, "seed": seed,
                  "precision": prec, "numbers": numbers}, out)
        del x, qr


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", type=Path, default=ROOT,
                   help="the checkout whose BENCHMARK.json names the cell")
    a = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from benchlib import cells
    cell = cells.Cell(a.root, a.workload)
    cell.driver.configure(cell.config, a.device)
    out = sys.stdout
    if a.sweep:
        sweep(cell, a.device, out)
    if a.seeds:
        seeds(cell, a.device, a.seeds, a.seconds, out)
    if a.controls:
        controls(cell, a.device, a.control_seeds,
                 [c for c in a.controls.split(",") if c], out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
