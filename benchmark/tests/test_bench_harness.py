"""Whole runs of each driver on the CPU at a small size, discovery of the
benchmark's pieces by name, and the refusals of the command line."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_tiny as T

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(T.TINY_CELLS))
def test_cpu_run_prints_a_well_formed_line(root, cell, trace):
    line, out, err = T.run_cpu(root, cell, trace=trace)
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(line))
    for key in REQUIRED:
        assert key in last
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    from benchlib import cells
    c = cells.Cell(root, cell)
    want = [m["name"] for m in (c.per_layer() if trace else c.end_to_end())]
    for name, m in last["metrics"].items():
        assert name in want and isinstance(m["value"], float) and m["unit"]
    if not trace:
        assert sorted(last["metrics"]) == sorted(want)
    else:
        assert set(last["device"]) >= {"busy_s", "window_s"}
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for (name, c), text in zip(last["checks"].items(), tail):
        assert text.startswith(f"check {name} ") and " limit " in text


def _digests(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_config_mix_and_metric_are_found_without_edits(root, tmp_path):
    """A new configuration, traffic mix and per-layer metric are new files
    plus new entries of BENCHMARK.json; no file of the benchmark's folder
    changes."""
    import shutil
    new = tmp_path / "co"
    shutil.copytree(root, new)
    before = _digests(new / "benchmark")
    cfg = json.loads((new / "benchmark/configs/tiny-ivfflat.json")
                     .read_text())
    cfg["name"] = "dummy-ivf"
    cfg["corpus"] = dict(cfg["corpus"], rows=20000, centres=8)
    cfg["index"] = dict(cfg["index"], nlists=16)
    (new / "benchmark/configs/dummy-ivf.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "benchmark/traffic/tiny-grouped.json")
                     .read_text())
    mix.update(batch=128, nprobe=4)
    (new / "benchmark/traffic/dummy-mix.json").write_text(json.dumps(mix))
    (new / "benchmark/metrics/dummy_batches.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.in_window()))\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-ivf", "source": "test",
                             "file": "benchmark/configs/dummy-ivf.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy-ivf.dummy-mix",
                               "config": "dummy-ivf", "traffic": "dummy-mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["dummy-ivf.dummy-mix"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _, _ = T.run_cpu(new, "dummy-ivf.dummy-mix", trace=1)
    assert line["correct"] is True
    assert line["metrics"]["dummy_batches"]["value"] > 0
    after = _digests(new / "benchmark")
    assert {p: d for p, d in after.items() if p in before} == before


def test_command_line_refuses_without_a_card(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tiny-ivfflat.grouped", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(T.ROOT)))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run,
    no result."""
    import shutil
    shutil.copytree(T.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(T.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sift1m-ivfflat.b64k-r95", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
