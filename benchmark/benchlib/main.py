"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``, and the result line.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each compared number beside its
limit); the same numbers close standard error. A run that finds no card
(or fewer than the cell asks for), a route that changed, or JAX in the
process exits with another code than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchlib import cells, check, corpus, trace, window
from benchlib import reference as R

FORBIDDEN = ("jax", "jaxlib", "flax", "neurondb_tpu")
EXIT_NO_CARD = 3
EXIT_ROUTE = 4
EXIT_FORBIDDEN = 5


class RunError(Exception):
    """A run that must end without a result."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Tracer:
    """The profiler over the first ``batches`` batches of the window."""

    def __init__(self, batches: int):
        self.batches = batches
        self.prof = None
        self.span = None

    def begin(self) -> None:
        self.prof = trace.start()
        self.span = torch.profiler.record_function(trace.WINDOW_SPAN)
        self.span.__enter__()

    def end(self) -> None:
        self.span.__exit__(None, None, None)
        trace.stop(self.prof)


class Context:
    """What a per-layer metric's reader may read (``read(ctx)``)."""

    def __init__(self, cell: cells.Cell, result: window.WindowResult,
                 summary: Optional[trace.TraceSummary], traced: int,
                 build_s: float, build_phases: Dict[str, float],
                 work: Callable):
        self.config = cell.config
        self.traffic = cell.traffic
        self.window = result
        self.trace = summary
        self.traced_batches = traced
        self.build_s = build_s
        self.build_phases = build_phases
        self._work = work
        self._slots = None

    def slot_work(self) -> List[Dict]:
        """The driver's count of each pool batch's work (``counts``)."""
        if self._slots is None:
            self._slots = self._work()
        return self._slots

    def traced_work(self, kind: str) -> List[Dict]:
        """The work of each batch of the traced stretch."""
        w = self.slot_work()
        return [w[b.slot][kind] for b in self.window.batches[:self.traced_batches]
                if kind in w[b.slot]]

    def window_work(self, kind: str) -> List[Dict]:
        """The work of each batch completed within the window."""
        w = self.slot_work()
        return [w[b.slot][kind] for b in self.window.in_window()
                if kind in w[b.slot]]


def make_queries(cell: cells.Cell, seed: int, device: str):
    """(the pool of query batches as host f32 arrays, the sampled rows of
    each batch)."""
    spec, mix = cell.config["corpus"], cell.traffic
    B, P = int(mix["batch"]), int(mix["pool"])
    qd = corpus.queries(spec, seed, P * B, device)
    pool = [qd[i * B:(i + 1) * B].cpu().numpy() for i in range(P)]
    del qd
    return pool, check.sample_rows(seed, P, B, int(mix["sample_per_batch"]))


def build_index(cell: cells.Cell, seed: int, device: str):
    """(the index, its build seconds): from the host f32 corpus handed to
    the constructor to a searchable index, ended by a device sync. A
    smaller index of the first ``build_warmup_rows`` rows is built and
    dropped first, so that the timed build finds the program's kernels
    loaded and its libraries initialised, as a running database would."""
    x = corpus.corpus(cell.config["corpus"], seed, device)
    x_host = x.cpu().numpy()
    del x
    warm = int(cell.config.get("build_warmup_rows", 0))
    if warm:
        cell.driver.build(cell.config, x_host[:warm], seed, device)
        gc.collect()
    sync(device)
    t = time.perf_counter()
    index = cell.driver.build(cell.config, x_host, seed, device)
    sync(device)
    return index, time.perf_counter() - t


def compare(cell: cells.Cell, pool, sample, batches, device: str,
            x: torch.Tensor, answers=None):
    """(the compared numbers, batches that failed) of the sampled answers
    of ``batches`` against the reference's exact neighbours. ``x``: the
    corpus on the device. ``answers`` (d [S, k], ids [S, k] over the
    pool's sampled queries, in slot order) replaces the batches' answers:
    the control's way in."""
    metric, k = cell.config["metric"], int(cell.traffic["k"])
    S = sample.shape[1]
    xr = R.prepare(x, metric)
    qs = np.concatenate([pool[s][sample[s]] for s in range(len(pool))])
    qr = R.prepare(torch.as_tensor(qs, device=device), metric)
    ref_d, ref_i = R.exact_knn(xr, qr, k, metric)
    if answers is not None:
        return check.judge(xr, qr, ref_d, ref_i, np.arange(len(qs)),
                           answers[0], answers[1], metric), 0
    answered = [b for b in batches if b.ans_i is not None]
    failed = len(batches) - len(answered)
    if not answered:
        return {"unanswered": float(S), "recall_miss": 1.0,
                "dist_gap": float("inf")}, failed
    qrow = np.concatenate([b.slot * S + np.arange(S) for b in answered])
    return check.judge(xr, qr, ref_d, ref_i, qrow,
                       np.concatenate([b.ans_d for b in answered]),
                       np.concatenate([b.ans_i for b in answered]),
                       metric), failed


def run(root: Path, argv: List[str], *, device: str, t0: float,
        out=sys.stdout, err=sys.stderr) -> Dict:
    """One run of a cell; prints the result line and returns it."""
    args = parse_args(argv)
    cell = cells.Cell(root, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError(EXIT_NO_CARD, "no CUDA device: the benchmark "
                           "measures the card and has no CPU fallback")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(EXIT_NO_CARD, f"{cell.name} needs {cell.chips} "
                           f"cards, found {torch.cuda.device_count()}")
    cfg, mix, drv = cell.config, cell.traffic, cell.driver
    drv.configure(cfg, device)
    spec = cfg["corpus"]
    B, P = int(mix["batch"]), int(mix["pool"])
    # ---- set-up: data from the seed, on the device ----
    pool, sample = make_queries(cell, args.seed, device)
    index, build_s = build_index(cell, args.seed, device)
    searcher = drv.Searcher(index, cfg, mix)
    for slot in range(P):                   # every shape the window uses
        searcher.collect(searcher.dispatch(pool[slot]))
    sync(device)
    launches0 = searcher.launches()

    # ---- the window ----
    tracer = Tracer(int(mix["trace_batches"])) if args.trace else None
    res = window.run_window(searcher.dispatch, searcher.collect, pool, sample,
                            depth=int(mix["in_flight"]),
                            seconds=args.seconds, tracer=tracer)
    setup_s = res.t_start - t0
    sync(device)
    launches1 = searcher.launches()
    n_batches = len(res.batches)
    for name, per_batch in mix.get("route", {}).items():
        if name in launches0:
            got = launches1[name] - launches0[name]
            if got != per_batch * n_batches:
                raise RunError(EXIT_ROUTE, f"route changed: {name} launched "
                               f"{got} times over {n_batches} batches, the "
                               f"traffic expects {per_batch} a batch")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # ---- per-layer metrics (traced run) ----
    summary = None
    if tracer is not None:
        summary = trace.summarize(trace.events(tracer.prof))
        tracer.prof = None
    state = {}

    def corpus_dev():
        if "x" not in state:
            state["x"] = corpus.corpus(spec, args.seed, device)
        return state["x"]

    metrics: Dict[str, Dict] = {}
    ctx = Context(cell, res, summary, int(mix["trace_batches"]), build_s,
                  drv.build_phases(index),
                  lambda: drv.work(index, cfg, mix, pool, corpus_dev()))
    if args.trace:
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    del searcher, index, ctx
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the comparison, after the window, in blocks ----
    numbers, failed = compare(cell, pool, sample, res.batches, device,
                              corpus_dev())
    state.clear()
    ok, checks = check.verdict(numbers, mix["limits"])

    # ---- end-to-end metrics (untraced run) ----
    done = res.in_window()
    if not args.trace:
        e2e = {"qps": len(done) * B / args.seconds,
               "recall_at_10": 1.0 - numbers["recall_miss"],
               "build_s": build_s, "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        raise RunError(EXIT_FORBIDDEN, "the process holds modules of JAX or "
                       f"the JAX package: {', '.join(found)}")
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device,
           "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok and failed == 0), "attempted": len(res.batches),
            "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checks"] = dict(checks, failed_batches={"value": failed,
                                                  "limit": 0})
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    print(json.dumps(line), file=out)
    out.flush()
    return line


def main(root: Path, argv: List[str], t0: float) -> int:
    try:
        run(root, argv, device="cuda", t0=t0)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    return 0
