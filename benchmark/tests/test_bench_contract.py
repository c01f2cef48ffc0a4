"""BENCHMARK.json against the rules a benchmark file keeps: its keys,
names, units, bounds, cells and metrics, and the files it names."""

from __future__ import annotations

import json
import re

import bench_tiny as T

BENCH = json.loads((T.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len((T.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("benchmark/")
        data = json.loads((T.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert (T.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        assert (T.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
