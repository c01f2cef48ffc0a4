"""``beam_kernel_pct``, the share of the rows entering a HNSW beam search
that the program's beam kernel served: its declaration, the reader on a
registry filled by hand and on an empty one, and a traced tiny run on the
CPU, where the plain version serves every row."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import bench_tiny as T
from benchlib import cells

from neurondb_tpu_torch.utils import tracing

HNSW_CELL = "glove1m-hnsw.b4k-r95"


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _read():
    reader = cells.load_module(T.BENCH_DIR / "metrics" / "beam_kernel_pct.py",
                               "bench_metric_beam_kernel_pct")
    return reader.read(SimpleNamespace(trace=None, traced_batches=4))


def test_it_is_declared_for_the_hnsw_cell():
    bench = json.loads((T.ROOT / "BENCHMARK.json").read_text())
    m = [m for m in bench["per_layer"] if m["name"] == "beam_kernel_pct"]
    assert len(m) == 1 and bench["per_layer"][-1] is m[0]
    assert m[0] == {"name": "beam_kernel_pct", "unit": "%",
                    "better": "higher", "source": "program_counter",
                    "layer": "HNSW search", "moves": "qps",
                    "workloads": [HNSW_CELL]}


def test_an_empty_registry_reads_none():
    assert _read() is None


def test_a_program_without_the_counters_reads_none(monkeypatch):
    tracing._add("hnsw.rows", 64)
    assert _read() is None                  # no hnsw.kernel_rows
    monkeypatch.delattr(tracing, "counters")
    assert _read() is None


@pytest.mark.parametrize("served,want", [
    ([(4096, 4096)], 100.0),
    ([(4096, 4096), (1024, 0)], 80.0),
    ([(64, 0)], 0.0),
])
def test_on_a_registry_filled_by_hand(served, want):
    """Each beam search adds its rows and the rows the kernel served (0
    on the plain version)."""
    for rows, kernel_rows in served:
        tracing._add("hnsw.rows", rows)
        tracing._add("hnsw.kernel_rows", kernel_rows)
    assert _read() == pytest.approx(want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("bench_kernel_pct"))


def test_a_traced_tiny_run_reads_the_plain_share(root):
    """On the CPU the plain version serves every row: 0.0, and nothing
    untraced."""
    line, _, _ = T.run_cpu(root, "tiny-hnsw.beam", trace=0)
    assert "beam_kernel_pct" not in line["metrics"]
    line, _, _ = T.run_cpu(root, "tiny-hnsw.beam", trace=1)
    assert line["metrics"]["beam_kernel_pct"]["value"] == 0.0
    assert line["metrics"]["beam_kernel_pct"]["unit"] == "%"
