"""Spans and counters of the port's IVFFlat and HNSW search paths
(``utils/tracing.py``): nothing recorded with no profiler, the same
answers with tracing on and off, the spans' nesting in a Chrome trace,
and the counters' values against the shapes they count."""

import json

import numpy as np
import pytest
import torch

from neurondb_tpu_torch.config import get_config
from neurondb_tpu_torch.index import hnsw as H
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
from neurondb_tpu_torch.utils import tracing

N_ROWS, DIM, NLISTS = 4096, 16, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    q = rng.standard_normal((96, DIM)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def ivf(data):
    return IVFFlatIndex(data[0], nlists=NLISTS, seed=0, device="cpu")


@pytest.fixture(scope="module")
def hnsw(data):
    ix = HNSWIndex(data[0], m=8, seed=0, device="cpu")
    assert ix._router is not None           # the bulk build's router
    return ix


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _searches(ivf, hnsw, q):
    """(IVFFlat grouped, IVFFlat exact, HNSW) answers."""
    return [ivf.search(q, k=10, nprobe=3),
            ivf.search(q, k=10, nprobe=NLISTS),
            hnsw.search(q, k=10, ef=32)]


def test_no_profiler_records_nothing(ivf, hnsw, data):
    assert not tracing.recording()
    assert tracing.trace("ndb.x") is tracing._NULL
    _searches(ivf, hnsw, data[1])
    tracing.count("ndb.y", 3)
    assert tracing.spans() == {} and tracing.counters() == {}


def test_answers_equal_with_tracing_on_and_off(ivf, hnsw, data):
    off = _searches(ivf, hnsw, data[1])
    with _cpu_profiler():
        assert tracing.recording()
        on = _searches(ivf, hnsw, data[1])
    for (d0, i0), (d1, i1) in zip(off, on):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)
    sp = tracing.spans()
    assert sp["ndb.ivf.search"]["count"] == 2
    assert sp["ndb.hnsw.search"]["count"] == 1
    assert sp["ndb.as_batch"]["count"] == 3


def test_as_batch_nests_in_the_search_span(ivf, data, tmp_path):
    with tracing.profile(str(tmp_path)):
        ivf.search(data[1], k=10, nprobe=3, out="device")
    trace = json.loads((tmp_path / tracing.TRACE_FILE).read_text())
    ev = {e["name"]: e for e in trace["traceEvents"]
          if e.get("ph") == "X" and e.get("name") in
          ("ndb.ivf.search", "ndb.as_batch")}
    outer, inner = ev["ndb.ivf.search"], ev["ndb.as_batch"]
    assert outer["tid"] == inner["tid"] and outer["pid"] == inner["pid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    sp = tracing.spans()
    for s in sp.values():
        assert 0.0 <= s["self_s"] <= s["total_s"]
        assert s["max_s"] <= s["total_s"]
    assert sp["ndb.ivf.search"]["self_s"] < sp["ndb.ivf.search"]["total_s"]
    assert sp["ndb.as_batch"]["self_s"] == sp["ndb.as_batch"]["total_s"]


@pytest.mark.parametrize("nprobe", [3, 6])
def test_ivf_counters_are_tuples_and_tile_slots(ivf, data, nprobe):
    q = data[1]
    B = q.shape[0]
    npad = 4 if nprobe <= 4 else 16
    qt = get_config().ivf_qt or G.auto_qt(B, npad, NLISTS)
    with _cpu_profiler():
        ivf.search(q, k=10, nprobe=nprobe)
        ivf.search(q, k=10, nprobe=NLISTS)          # the exact route
    c = tracing.counters()
    assert c["ivf.tuples"] == B * nprobe
    assert c["ivf.tile_slots"] == G.tiles_for(B, npad, NLISTS, qt) * qt


def test_hnsw_gathered_is_steps_times_rows(hnsw, data):
    q = data[1]
    with _cpu_profiler():
        hnsw.search(q, k=10, ef=32, expand=4)
    c = tracing.counters()
    deg = hnsw._nbr0.shape[1]
    assert tracing.spans()["ndb.hnsw.beam"]["count"] == 1
    assert 0 < c["hnsw.steps"] <= (2 * 32 + 32) // 4 + 16
    assert c["hnsw.gathered"] == c["hnsw.steps"] * q.shape[0] * 4 * deg
    assert 0 < c["hnsw.fresh"] <= c["hnsw.gathered"]


def _ring_graph(n: int, deg: int, rng) -> torch.Tensor:
    """A connected graph: each node's ring neighbours, random chords,
    a repeated id and -1 padding."""
    nbr = np.full((n, deg), -1, np.int64)
    for i in range(n):
        nbr[i, 0], nbr[i, 1] = (i + 1) % n, (i - 1) % n
        nbr[i, 2] = rng.integers(n)
        nbr[i, 3] = nbr[i, 2] if i % 3 == 0 else rng.integers(n)
    return torch.as_tensor(nbr)


@pytest.mark.parametrize("expand", [1, 4])
def test_hnsw_fresh_counts_every_node_once(expand):
    """With ef >= N and enough steps the beam visits every node of a
    connected graph once: fresh rows = N less each query's distinct
    valid entries."""
    rng = np.random.default_rng(5)
    n, deg, B = 40, 5, 6
    vecs = torch.as_tensor(rng.standard_normal((n, 8)).astype(np.float32))
    sq = (vecs * vecs).sum(1)
    q = torch.as_tensor(rng.standard_normal((B, 8)).astype(np.float32))
    entry = torch.as_tensor(rng.integers(-1, n, size=(B, 3)))
    entry[0] = torch.tensor([7, 7, 7])                  # duplicates
    entry[1] = torch.tensor([-1, 2, -1])                # invalid entries
    nbr = _ring_graph(n, deg, rng)
    with _cpu_profiler():
        _, rows = H._beam_search(q, entry, vecs, sq, nbr, None, metric="l2",
                                 ef=64, max_steps=400, identity_map=True,
                                 expand=expand)
    want = sum(n - len({int(e) for e in row if e >= 0})
               for row in entry.tolist())
    c = tracing.counters()
    assert c["hnsw.fresh"] == want
    assert (rows[:, :n] >= 0).all() and (rows[:, n:] == -1).all()
    assert c["hnsw.steps"] < 400
    assert tracing.spans()["ndb.hnsw.check"]["count"] == \
        c["hnsw.steps"] // H.CHECK_EVERY


def test_a_span_begun_under_the_profiler_records_whole():
    prof = _cpu_profiler()
    prof.start()
    with tracing.trace("ndb.root"):
        prof.stop()
        assert tracing.recording()
        with tracing.trace("ndb.child"):
            tracing.count("ndb.n", torch.tensor(4))
        tracing.count("ndb.n", 3)
    assert not tracing.recording()
    with tracing.trace("ndb.after"):
        tracing.count("ndb.n", 100)
    assert set(tracing.spans()) == {"ndb.root", "ndb.child"}
    assert tracing.counters() == {"ndb.n": 7}
    tracing.reset()
    assert tracing.spans() == {} and tracing.counters() == {}
