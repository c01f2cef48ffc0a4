"""The HNSW beam kernel (``csrc/hnsw_beam.cu``) on a card, against the
plain version ``_beam_search_plain``.

Skips without a card. This file imports neither jax nor the JAX package
and uses no conftest fixture, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest tests/test_torch_hnsw_beam_kernel.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from neurondb_tpu_torch.index import hnsw as H
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.ops.kernels import hnsw_beam as HB
from neurondb_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

# random data: f32 sums in another order than the plain version's, held
# to this share of the distance's terms (|q|^2 + |x|^2, or |q| |x| for ip)
TERMS_RTOL = 1e-5
RECALL_BAR = 0.999


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tracing.reset()
    yield torch.device("cuda")
    tracing.reset()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _graph(rng, n, d, deg, *, integer, positive=False, holes=0.1):
    if integer:
        lo = 1 if positive else -4
        x = rng.integers(lo, 5, (n, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    sq = (x * x).sum(1).astype(np.float32)
    nbr = rng.integers(0, n, (n, deg)).astype(np.int32)
    nbr[rng.random((n, deg)) < holes] = -1
    nbr[:, -1] = nbr[:, 0]                # repeated ids in every row
    return x, sq, nbr


def _case(rng, *, metric, entries, mapped, integer, n, d, deg, B):
    positive = integer and metric == "ip"
    x, sq, nbr = _graph(rng, n, d, deg, integer=integer, positive=positive)
    rowmap = None
    if mapped:
        xs, sqs, _ = _graph(rng, 3 * n, d, deg, integer=integer,
                            positive=positive)
        rowmap = rng.choice(3 * n, n, replace=False).astype(np.int32)
        xs[rowmap], sqs[rowmap] = x, sq
        x, sq = xs, sqs
    if integer:
        q = rng.integers(1 if positive else -4, 5, (B, d)).astype(np.float32)
    else:
        q = rng.standard_normal((B, d)).astype(np.float32)
    if entries == 1:
        entry = rng.integers(0, n, B).astype(np.int64)
    else:
        entry = rng.integers(0, n, (B, entries)).astype(np.int64)
        entry[::3, 2] = entry[::3, 0]                 # duplicates
        entry[::4, 3] = -1
    return q, entry, x, sq, nbr, rowmap


def _tensors(case, device, store):
    q, entry, x, sq, nbr, rowmap = case
    t = [torch.as_tensor(a).to(device) for a in (q, entry, x, sq, nbr)]
    t[2] = t[2].to(store)
    t.append(None if rowmap is None else torch.as_tensor(rowmap).to(device))
    return t


def _plain(case, store, kw, monkeypatch):
    """The plain version on the CPU, checking convergence every step, so
    that its ``hnsw.steps`` is the slowest row's; (d, rows, counters)."""
    monkeypatch.setattr(H, "CHECK_EVERY", 1)
    tracing.reset()
    t = _tensors(case, "cpu", store)
    with _profiler():
        d, i = H._beam_search_plain(*t, identity_map=t[5] is None, **kw)
    c = tracing.counters()
    tracing.reset()
    return d, i, c


@pytest.mark.parametrize("store", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("entries", [1, 4])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("cut", [False, True])
def test_kernel_is_the_plain_version_bit_for_bit(dev, store, metric, expand,
                                                 entries, mapped, cut,
                                                 monkeypatch):
    """Integer rows (exact in bf16, every f32 sum exact in any order):
    rows and distances bit for bit, ties included; the kernel path's
    ``hnsw.fresh`` and ``hnsw.steps`` equal the plain version's."""
    rng = np.random.default_rng(100 * expand + 10 * entries + mapped)
    case = _case(rng, metric=metric, entries=entries, mapped=mapped,
                 integer=True, n=600, d=12, deg=16, B=40)
    ef = 24
    steps = 3 if cut else (2 * ef + 32) // expand + 16
    kw = dict(metric=metric, ef=ef, max_steps=steps, expand=expand)
    pd, pi, pc = _plain(case, store, kw, monkeypatch)
    t = _tensors(case, dev, store)
    launches = HB.LAUNCHES
    with _profiler():
        kd, ki = H._beam_search(*t, identity_map=not mapped, **kw)
    torch.cuda.synchronize()
    assert HB.LAUNCHES == launches + 1
    assert torch.equal(ki.cpu(), pi) and torch.equal(kd.cpu(), pd)
    c = tracing.counters()
    assert c["hnsw.rows"] == c["hnsw.kernel_rows"] == 40
    assert c["hnsw.fresh"] == pc["hnsw.fresh"]
    assert c["hnsw.steps"] == pc["hnsw.steps"]
    assert c["hnsw.gathered"] == pc["hnsw.gathered"]
    if cut:
        assert c["hnsw.steps"] == steps


@pytest.mark.parametrize("store", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("d", [100, 13])
def test_kernel_on_random_graphs(dev, store, metric, d):
    """Random f32 rows: recall@10 of the kernel's rows against the plain
    version's at least RECALL_BAR, and each distance of a row both return
    within TERMS_RTOL of its terms. d 13: the element loads."""
    rng = np.random.default_rng(d)
    case = _case(rng, metric=metric, entries=4, mapped=False, integer=False,
                 n=20_000, d=d, deg=32, B=512)
    kw = dict(metric=metric, ef=64, max_steps=(2 * 64 + 32) // 4 + 16,
              expand=4)
    t = _tensors(case, dev, store)
    kd, ki = H._beam_search(*t, identity_map=True, **kw)
    pd, pi = H._beam_search_plain(*t, identity_map=True, **kw)
    torch.cuda.synchronize()
    ki, pi = ki.cpu().numpy(), pi.cpu().numpy()
    hits = sum(len(set(a[:10]) & set(b[:10])) for a, b in zip(ki, pi))
    assert hits / (10 * len(ki)) >= RECALL_BAR
    q, x = t[0].double(), t[2].double()
    kd, pd = kd.cpu().double(), pd.cpu().double()
    for r in range(len(ki)):
        both, kj, pj = np.intersect1d(ki[r], pi[r], return_indices=True)
        live = both >= 0
        both, kj, pj = both[live], kj[live], pj[live]
        rows = torch.as_tensor(both, device=dev)
        if metric == "ip":
            terms = q[r].norm() * x[rows].norm(dim=1)
        else:
            terms = (q[r] * q[r]).sum() + (x[rows] * x[rows]).sum(1)
        err = (kd[r, kj] - pd[r, pj]).abs()
        assert (err <= TERMS_RTOL * terms.cpu()).all(), (r, err.max())


@pytest.mark.parametrize("store", [torch.bfloat16, torch.float32])
def test_the_widest_rows_at_the_widest_beam(dev, store, monkeypatch):
    """dim MAX_DIM at ef MAX_EF and E x deg MAX_CAND: the largest shared
    memory ``kernel_takes`` lets through launches, bit for bit."""
    rng = np.random.default_rng(6)
    case = _case(rng, metric="sqeuclidean", entries=4, mapped=False,
                 integer=True, n=400, d=HB.MAX_DIM, deg=64, B=4)
    kw = dict(metric="sqeuclidean", ef=HB.MAX_EF, max_steps=40, expand=4)
    assert HB.kernel_takes("cuda", rows=4, dim=HB.MAX_DIM, ef=HB.MAX_EF,
                           expand=4, deg=64, entries=4, max_steps=40,
                           store_dtype=store)
    pd, pi, _ = _plain(case, store, kw, monkeypatch)
    t = _tensors(case, dev, store)
    launches = HB.LAUNCHES
    kd, ki = H._beam_search(*t, identity_map=True, **kw)
    assert HB.LAUNCHES == launches + 1
    assert torch.equal(ki.cpu(), pi) and torch.equal(kd.cpu(), pd)


def test_the_widest_beam_and_the_most_candidates(dev, monkeypatch):
    """ef 1024 and E x deg 256 (two slots a thread) at the limits."""
    rng = np.random.default_rng(5)
    case = _case(rng, metric="sqeuclidean", entries=4, mapped=False,
                 integer=True, n=3000, d=8, deg=64, B=9)
    kw = dict(metric="sqeuclidean", ef=1024, max_steps=40, expand=4)
    pd, pi, _ = _plain(case, torch.float32, kw, monkeypatch)
    t = _tensors(case, dev, torch.float32)
    kd, ki = H._beam_search(*t, identity_map=True, **kw)
    assert torch.equal(ki.cpu(), pi) and torch.equal(kd.cpu(), pd)


def test_index_search_and_add_run_the_kernel(dev, monkeypatch):
    """A bulk-built index searches through the kernel (one launch a
    sub-batch), its answers those of the plain version within
    RECALL_BAR; ``add``'s wave beams (level 0 and the upper levels, with
    a row map) run it too, and each added row finds itself."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((30_000, 32)).astype(np.float32)
    q = rng.standard_normal((700, 32)).astype(np.float32)
    ix = HNSWIndex(x, m=8, seed=0, device="cuda")
    launches = HB.LAUNCHES
    _, got = ix.search(q, k=10, ef=64, batch=256)
    assert HB.LAUNCHES == launches + 3
    with monkeypatch.context() as m:
        m.setattr(HB, "kernel_takes", lambda *a, **k: False)
        _, want = ix.search(q, k=10, ef=64, batch=256)
    hits = sum(len(set(a) & set(b)) for a, b in zip(got, want))
    assert hits / want.size >= RECALL_BAR
    launches = HB.LAUNCHES
    new = x[:500] + 0.05 * rng.standard_normal((500, 32)).astype(np.float32)
    ids = ix.add(new)
    assert HB.LAUNCHES > launches
    _, top = ix.search(new, k=1)
    assert (top[:, 0] == ids).mean() >= 0.9
