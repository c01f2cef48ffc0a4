"""The HNSW beam kernel's host side on the CPU: the shape test that picks
the kernel or the plain version, the arguments and counters of that
choice, and the wrapper's refusal of tensors off the card. The kernel
itself (``csrc/hnsw_beam.cu``) runs against the plain version in
``tests/test_torch_hnsw_beam_kernel.py`` on a card."""

import numpy as np
import pytest
import torch

from neurondb_tpu_torch.index import hnsw as H
from neurondb_tpu_torch.ops.kernels import hnsw_beam as HB
from neurondb_tpu_torch.utils import tracing

CELL = dict(rows=4096, dim=100, ef=128, expand=4, deg=32, entries=4,
            max_steps=(2 * 128 + 32) // 4 + 16, store_dtype=torch.bfloat16)


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# ---- the shape test ----

def test_the_cell_shape_takes_the_kernel():
    assert HB.kernel_takes("cuda", **CELL)
    assert HB.kernel_takes("cuda", **dict(CELL, store_dtype=torch.float32))
    # the build's beams: ef_construction 200, one entry, level 0 and up
    assert HB.kernel_takes("cuda", **dict(CELL, ef=200, entries=1))
    assert HB.kernel_takes("cuda", **dict(CELL, ef=200, entries=1, deg=16))


@pytest.mark.parametrize("change", [
    {"rows": 0}, {"dim": 0}, {"ef": 0}, {"ef": HB.MAX_EF + 1},
    {"expand": 0}, {"deg": 0}, {"expand": 9},        # 9 x 32 > 256
    {"expand": 1, "deg": HB.MAX_CAND + 1}, {"entries": 0},
    {"ef": 8, "entries": 9}, {"max_steps": 0},
    {"store_dtype": torch.float16}, {"store_dtype": torch.int8},
    {"dim": HB.MAX_DIM + 1},
])
def test_each_limit_sends_the_beam_to_the_plain_version(change):
    assert not HB.kernel_takes("cuda", **dict(CELL, **change))


@pytest.mark.parametrize("edge", [
    {"ef": HB.MAX_EF}, {"expand": 8}, {"expand": 1, "deg": HB.MAX_CAND},
    {"ef": 8, "entries": 8}, {"max_steps": 1}, {"rows": 1}, {"dim": 1},
    {"dim": HB.MAX_DIM},
])
def test_the_limits_are_inclusive(edge):
    assert HB.kernel_takes("cuda", **dict(CELL, **edge))


@pytest.mark.parametrize("device", ["cpu", "meta", "xla"])
def test_no_other_device_takes_the_kernel(device):
    assert not HB.kernel_takes(device, **CELL)


def test_the_wrapper_refuses_a_shape_it_does_not_take():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="hnsw_beam takes no beam on cpu"):
        HB.beam_search(q, torch.zeros(2, dtype=torch.long), torch.zeros(
            (10, 8)), torch.zeros(10), torch.zeros((10, 4), dtype=torch.int32),
            None, metric="l2", ef=8, max_steps=4, expand=1)
    assert HB.LAUNCHES == 0


# ---- the counters of the choice ----

def _graph(rng, n, d, deg, *, positive=False, holes=0.1):
    """Integer rows (every f32 sum exact in any order), their norms and a
    random adjacency with -1 holes and repeated ids within rows."""
    lo = 1 if positive else -4
    x = rng.integers(lo, 5, (n, d)).astype(np.float32)
    sq = (x * x).sum(1).astype(np.float32)
    nbr = rng.integers(0, n, (n, deg)).astype(np.int32)
    nbr[rng.random((n, deg)) < holes] = -1
    nbr[:, -1] = nbr[:, 0]
    return x, sq, nbr


def test_the_plain_path_counts_rows_and_no_kernel_rows():
    rng = np.random.default_rng(3)
    x, sq, nbr = _graph(rng, 200, 8, 6)
    q = torch.as_tensor(rng.integers(-4, 5, (12, 8)).astype(np.float32))
    entry = torch.as_tensor(rng.integers(0, 200, (12, 3)))
    args = (q, entry, torch.as_tensor(x), torch.as_tensor(sq),
            torch.as_tensor(nbr), None)
    kw = dict(metric="l2", ef=16, max_steps=40, identity_map=True, expand=4)
    H._beam_search(*args, **kw)
    assert tracing.counters() == {}                   # not tracing
    with _profiler():
        H._beam_search(*args, **kw)
        H._beam_search(q[:5], entry[:5], *args[2:], **kw)
    c = tracing.counters()
    assert c["hnsw.rows"] == 17 and c["hnsw.kernel_rows"] == 0
    assert HB.LAUNCHES == 0


# ---- what the dispatch hands the kernel ----

def _small(rng, *, B=12, R=3, mapped=False):
    x, sq, nbr = _graph(rng, 200, 8, 6)
    rowmap = None
    if mapped:
        xs, sqs, _ = _graph(rng, 600, 8, 6)
        rowmap = rng.choice(600, 200, replace=False).astype(np.int64)
        xs[rowmap], sqs[rowmap] = x, sq
        x, sq = xs, sqs
    q = torch.as_tensor(rng.integers(-4, 5, (B, 8)).astype(np.float32))
    entry = rng.integers(0, 200, (B, R) if R else B)
    return (q, torch.as_tensor(entry), torch.as_tensor(x),
            torch.as_tensor(sq), torch.as_tensor(nbr),
            None if rowmap is None else torch.as_tensor(rowmap))


@pytest.mark.parametrize("entries", [0, 1, 4])       # 0: a 1-d entry
@pytest.mark.parametrize("expand", [0, 1, 4])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_the_dispatch_asks_with_the_call_shape(entries, expand, store,
                                                monkeypatch):
    """``_beam_search`` asks ``kernel_takes`` once, with the call's device,
    rows, dim, ef, E (at least 1), degree, entries a row, max_steps and
    store; refused, it returns the plain version's answers."""
    args = list(_small(np.random.default_rng(entries + 3 * expand),
                       R=entries))
    args[2] = args[2].to(store)
    kw = dict(metric="l2", ef=16, max_steps=30, identity_map=True,
              expand=expand)
    asked = []

    def takes(device_type, **shape):
        asked.append((device_type, shape))
        return False

    monkeypatch.setattr(HB, "kernel_takes", takes)
    d, i = H._beam_search(*args, **kw)
    pd, pi = H._beam_search_plain(*args, **kw)
    assert asked == [("cpu", dict(rows=12, dim=8, ef=16,
                                  expand=max(1, expand), deg=6,
                                  entries=max(1, entries), max_steps=30,
                                  store_dtype=store))]
    assert torch.equal(i, pi) and torch.equal(d, pd)
    assert HB.LAUNCHES == 0


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("expand", [1, 4])
def test_the_kernel_path_passes_the_map_and_counts(mapped, expand,
                                                    monkeypatch):
    """Where the kernel takes the shape, ``_beam_search`` hands it the row
    map only off the identity, returns its beam as it is, and while
    tracing counts every row as the kernel's, ``hnsw.fresh`` as the sum
    of its rows' fresh rows, ``hnsw.steps`` as the slowest row's steps and
    ``hnsw.gathered`` as those steps x B x E x deg."""
    args = _small(np.random.default_rng(7 + expand), mapped=mapped)
    seen = {}

    def beam(q, entry, vecs, sqnorms, nbr, rowmap, **kw):
        seen.update(rowmap=rowmap, kw=kw)
        B = q.shape[0]
        return (torch.zeros((B, 16)), torch.ones((B, 16), dtype=torch.long),
                torch.arange(B, dtype=torch.int32),
                torch.arange(B, dtype=torch.int32) % 5)

    monkeypatch.setattr(HB, "kernel_takes", lambda *a, **k: True)
    monkeypatch.setattr(HB, "beam_search", beam)
    kw = dict(metric="ip", ef=16, max_steps=30, identity_map=not mapped,
              expand=expand)
    with _profiler():
        d, i = H._beam_search(*args, **kw)
    assert (seen["rowmap"] is args[5]) if mapped else seen["rowmap"] is None
    assert seen["kw"] == dict(metric="ip", ef=16, max_steps=30,
                              expand=expand)
    assert torch.equal(d, torch.zeros((12, 16))) and bool((i == 1).all())
    c = tracing.counters()
    assert c["hnsw.rows"] == c["hnsw.kernel_rows"] == 12
    assert c["hnsw.fresh"] == sum(range(12))
    assert c["hnsw.steps"] == 4
    assert c["hnsw.gathered"] == 4 * 12 * expand * 6
