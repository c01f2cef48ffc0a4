"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with tiny cells of its own, run in-process on the
CPU with the program's plain versions.

Run the tests from the repository's root:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import io
import json
import shutil
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_IVF = "tiny-ivfflat"
TINY_HNSW = "tiny-hnsw"
# small versions of each shipped configuration at the same rows per
# centre (and, for IVFFlat, rows per list), so that neighbour distances
# and their gaps are as at full size; cells over the shipped traffic
# mixes at small batches
TINY_CELLS = {
    "tiny-ivfflat.grouped": (TINY_IVF, "tiny-grouped"),
    "tiny-ivfflat.grouped99": (TINY_IVF, "tiny-grouped99"),
    "tiny-ivfflat.exact": (TINY_IVF, "tiny-exact"),
    "tiny-hnsw.beam": (TINY_HNSW, "tiny-beam"),
}


def _tiny_config(src: str, name: str, rows: int, centres: int,
                 **index) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{src}.json").read_text())
    cfg["name"] = name
    cfg["corpus"] = dict(cfg["corpus"], rows=rows, centres=centres)
    cfg["index"] = dict(cfg["index"], **index)
    return cfg


def _tiny_mix(src: str, **kw) -> dict:
    mix = json.loads((BENCH_DIR / "traffic" / f"{src}.json").read_text())
    mix.update(kw)
    return mix


def make_root(tmp: Path) -> Path:
    """A checkout-like copy: ``BENCHMARK.json`` and the benchmark's
    folder, with the tiny configurations, mixes and cells added (as new
    files and entries)."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    configs = {
        TINY_IVF: _tiny_config("sift1m-ivfflat", TINY_IVF, 62500, 16,
                               nlists=64),
        TINY_HNSW: _tiny_config("glove1m-hnsw", TINY_HNSW, 9246, 2),
    }
    for name, cfg in configs.items():
        path = f"benchmark/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": cfg["source"][:200],
                                 "file": path, "reduced": ["corpus"],
                                 "why": "tiny CPU test"})
    mixes = {
        "tiny-grouped": _tiny_mix("b64k-r95", batch=256, pool=2,
                                  sample_per_batch=64, trace_batches=2),
        "tiny-grouped99": _tiny_mix("b64k-r99", batch=256, pool=2,
                                    sample_per_batch=64, trace_batches=2),
        "tiny-exact": _tiny_mix("exact-b1k", batch=64, nprobe=64, pool=2,
                                sample_per_batch=32, trace_batches=2),
        "tiny-beam": _tiny_mix("b4k-r95", batch=64, pool=2,
                               sample_per_batch=32, trace_batches=1),
    }
    for name, mix in mixes.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for cell, (config, traffic) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "tiny CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_cpu(root: Path, cell: str, *, seed: int = 7, seconds: float = 1.0,
            trace: int = 0):
    """One run of ``cell`` on the CPU; (the result dict, stdout, stderr)."""
    from benchlib import main
    out, err = io.StringIO(), io.StringIO()
    line = main.run(root, ["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                    device="cpu", t0=time.perf_counter(), out=out, err=err)
    return line, out.getvalue(), err.getvalue()
