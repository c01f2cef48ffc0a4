"""The readers of the program's spans and counters (``benchlib/spans.py``
and the metrics that use it) on a registry filled by hand, on an empty
one, and in traced tiny runs on the CPU."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

import bench_tiny as T
from benchlib import cells, counts

from neurondb_tpu_torch.utils import tracing

IVF_CELLS = ["sift1m-ivfflat.b64k-r95", "sift1m-ivfflat.exact-b1k",
             "sift1m-ivfflat.b64k-r99"]
HNSW_CELL = "glove1m-hnsw.b4k-r95"
READERS = {
    "search_h2d_ms": IVF_CELLS[:1] + [HNSW_CELL] + IVF_CELLS[1:],
    "ivf_issue_ms": IVF_CELLS,
    "scan_tile_fill_pct": [IVF_CELLS[0], IVF_CELLS[2]],
    "beam_steps": [HNSW_CELL],
    "beam_fresh_pct": [HNSW_CELL],
    "beam_roofline": [HNSW_CELL],
    "beam_issue_ms": [HNSW_CELL],
    "beam_wait_ms": [HNSW_CELL],
}
HNSW_CFG = json.loads((T.BENCH_DIR / "configs" / "glove1m-hnsw.json")
                      .read_text())


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _reader(name):
    return cells.load_module(T.BENCH_DIR / "metrics" / f"{name}.py",
                             f"bench_metric_{name}")


def _ctx(busy_s=0.16, batches=4):
    return SimpleNamespace(config=HNSW_CFG, traffic={},
                           trace=SimpleNamespace(busy_s=busy_s),
                           traced_batches=batches)


def _fill_ivf():
    """Two searches of 65,536 queries at nprobe 4 over 1,024 lists."""
    for _ in range(2):
        tracing._record("ndb.ivf.search", 0.015, 0.002)
        tracing._record("ndb.as_batch", 0.013, 0.013)
        tracing._add("ivf.tuples", 65536 * 4)
        tracing._add("ivf.tile_slots", (65536 * 4 // 64 + 1024 + 2) * 64)


def _fill_hnsw():
    """Four searches, 60 steps each, ten million fresh rows each."""
    for _ in range(4):
        tracing._record("ndb.hnsw.search", 0.080, 0.0)
        tracing._record("ndb.as_batch", 0.001, 0.001)
        tracing._record("ndb.hnsw.beam", 0.070, 0.050)
        for _ in range(7):
            tracing._record("ndb.hnsw.check", 0.002, 0.002)
        tracing._record("ndb.hnsw.collect", 0.006, 0.006)
        tracing._add("hnsw.steps", 60)
        tracing._add("hnsw.gathered", 60 * 4096 * 4 * 32)
        tracing._add("hnsw.fresh", torch.tensor(6_000_000))
        tracing._add("hnsw.fresh", torch.tensor(4_000_000))


def test_each_reader_is_declared_for_its_cells():
    bench = json.loads((T.ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(got) == set(READERS)
    for name, m in got.items():
        assert m["workloads"] == READERS[name] and m["moves"] == "qps"
        assert m["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", sorted(READERS))
def test_an_empty_registry_reads_none(name):
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_counters_reads_none(name, monkeypatch):
    monkeypatch.delattr(tracing, "counters")
    assert _reader(name).read(_ctx()) is None


def test_ivf_readers_on_a_registry_filled_by_hand():
    _fill_ivf()
    assert _reader("search_h2d_ms").read(_ctx()) == pytest.approx(13.0)
    assert _reader("ivf_issue_ms").read(_ctx()) == pytest.approx(2.0)
    fill = _reader("scan_tile_fill_pct").read(_ctx())
    assert fill == pytest.approx(100 * 262144 / 327808)
    assert round(fill, 2) == 79.97
    for name in ("beam_steps", "beam_fresh_pct", "beam_roofline",
                 "beam_issue_ms", "beam_wait_ms"):
        assert _reader(name).read(_ctx()) is None, name


def test_the_slowest_upload_is_left_out():
    for secs in (0.002, 0.004, 0.642, 0.003):
        tracing._record("ndb.as_batch", secs, secs)
    assert _reader("search_h2d_ms").read(_ctx()) == pytest.approx(3.0)
    tracing.reset()
    tracing._record("ndb.as_batch", 0.002, 0.002)
    assert _reader("search_h2d_ms").read(_ctx()) == pytest.approx(2.0)


def test_hnsw_readers_on_a_registry_filled_by_hand():
    _fill_hnsw()
    ctx = _ctx(busy_s=0.16, batches=4)
    assert _reader("search_h2d_ms").read(ctx) == pytest.approx(1.0)
    assert _reader("beam_steps").read(ctx) == pytest.approx(60.0)
    assert _reader("beam_issue_ms").read(ctx) == pytest.approx(50.0)
    assert _reader("beam_wait_ms").read(ctx) == pytest.approx(20.0)
    assert _reader("beam_fresh_pct").read(ctx) == pytest.approx(
        100 * 1e7 / (60 * 4096 * 4 * 32))
    # ten million fresh bf16 rows of 100 dims and their f32 norms a
    # search, bound by bytes, over 40 ms of device time a batch
    least = 1e7 * (100 * 2 + 4) / counts.HBM_BYTES_PER_S
    assert 1e7 * 200 / counts.PEAK_FLOPS["bf16"] < least
    assert _reader("beam_roofline").read(ctx) == pytest.approx(
        100 * least / 0.04)
    assert _reader("beam_roofline").read(_ctx(busy_s=0.0)) is None
    for name in ("ivf_issue_ms", "scan_tile_fill_pct"):
        assert _reader(name).read(ctx) is None, name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("bench_spans"))


@pytest.mark.parametrize("cell,want", [
    ("tiny-ivfflat.grouped", {"search_h2d_ms", "ivf_issue_ms",
                              "scan_tile_fill_pct"}),
    ("tiny-hnsw.beam", {"search_h2d_ms", "beam_steps", "beam_fresh_pct",
                        "beam_issue_ms", "beam_wait_ms"}),
])
def test_traced_tiny_runs_print_the_program_metrics(root, cell, want):
    """A traced run prints them (``beam_roofline`` needs the card's busy
    time, which a CPU run has not); an untraced one records nothing."""
    line, _, _ = T.run_cpu(root, cell, trace=0)
    assert not set(line["metrics"]) & set(READERS)
    assert tracing.spans() == {} and tracing.counters() == {}
    line, _, _ = T.run_cpu(root, cell, trace=1)
    got = {n: m["value"] for n, m in line["metrics"].items()
           if n in READERS}
    assert set(got) == want
    assert all(v > 0 for v in got.values())
    if "scan_tile_fill_pct" in got:
        assert got["scan_tile_fill_pct"] <= 100.0
    if "beam_fresh_pct" in got:
        assert got["beam_fresh_pct"] <= 100.0
