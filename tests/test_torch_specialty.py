"""The rerank-ready and consistent indexes and ``validate_index``: the
torch port against the JAX package on the same numpy inputs (CPU)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neurondb_tpu.index import specialty as JSP
from neurondb_tpu.index import validate as JVAL
from neurondb_tpu.index.ivf import IVFFlatIndex as JIVF
from neurondb_tpu_torch.config import get_config
from neurondb_tpu_torch.index import specialty as TSP
from neurondb_tpu_torch.index import validate as TVAL
from neurondb_tpu_torch.index.hnsw import HNSWIndex as THNSW
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF

# both packages compute |q|^2 + |x|^2 - 2 q.x in f32 with sums in another
# order: squared distances are held to a share of the terms' size
TERMS_TOL = 1e-6


def _close(td, jd, q, x):
    q = np.atleast_2d(q)
    terms = (q * q).sum(1)[:, None] + (x * x).sum(1).max()
    err = np.abs(np.atleast_2d(td) ** 2 - np.atleast_2d(jd) ** 2)
    assert (err <= TERMS_TOL * terms).all(), err.max()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clustered(rng, n, d, ncl=16):
    c = rng.standard_normal((ncl, d)).astype(np.float32) * 3.0
    return (c[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# RerankReadyIndex
# ---------------------------------------------------------------------------

def test_rerank_ready_matches_jax_and_hits_from_host(rng):
    x = _clustered(rng, 1500, 24)
    ids = np.arange(1500, dtype=np.int64) * 3 + 7
    q = x[:20] + 0.05
    j = JSP.RerankReadyIndex(x, ids=ids, k=12)
    t = TSP.RerankReadyIndex(x, ids=ids, k=12, device="cpu")
    assert t.warm(q) == j.warm(q) == 20
    assert t.warm(q) == j.warm(q) == 0             # already cached
    for i in range(20):
        jd, ji, jv = j.get_candidates(q[i], k=8)
        td, ti, tv = t.get_candidates(q[i], k=8)
        np.testing.assert_array_equal(ti, ji)
        _close(td, jd, q[i], x)
        np.testing.assert_array_equal(tv, np.asarray(jv))
    assert t.stats() == j.stats() == {"cached": 20, "hits": 20, "misses": 0,
                                      "k": 12}
    miss = x[100] - 0.01
    np.testing.assert_array_equal(t.get_candidates(miss)[1],
                                  j.get_candidates(miss)[1])
    assert t.misses == j.misses == 1
    td, ti = t.search(q[:5], k=4)
    jd, ji = j.search(q[:5], k=4)
    np.testing.assert_array_equal(ti, ji)
    _close(td, jd, q[:5] if len(td) == 5 else q, x)


class _Ops(TorchDispatchMode):
    """Records every aten operator dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_rerank_ready_hit_runs_no_tensor_op(rng):
    """A hit is host memory only: no torch operator runs at all (on the
    card, no launch); a miss runs the exact scan (counted)."""
    x = _clustered(rng, 500, 16)
    t = TSP.RerankReadyIndex(x, k=8, device="cpu")
    t.warm(x[:4])
    with _Ops() as hit:
        _, hit_ids, _ = t.get_candidates(x[2])
    assert hit.ops == []
    _, miss_ids, _ = t.get_candidates(x[2] + 1e-3)
    assert (t.hits, t.misses) == (1, 1)
    assert hit_ids[0] == 2 and miss_ids[0] == 2


# ---------------------------------------------------------------------------
# ConsistentIndex
# ---------------------------------------------------------------------------

def test_consistent_matches_jax_and_breaks_ties_by_id(rng):
    x = _clustered(rng, 800, 16)
    x[400:410] = x[0]                           # ten exact duplicates
    ids = rng.permutation(10_000)[:800].astype(np.int64)
    j = JSP.ConsistentIndex(x, ids=ids)
    t = TSP.ConsistentIndex(x, ids=ids, device="cpu")
    q = np.concatenate([x[:1], x[1:30] + 0.05])
    jd, ji = j.search(q, k=9)
    td, ti = t.search(q, k=9)
    np.testing.assert_array_equal(ti, ji)
    _close(td, jd, q[:5] if len(td) == 5 else q, x)
    dup_ids = np.sort(ids[np.r_[0, 400:410]])[:9]
    np.testing.assert_array_equal(ti[0], dup_ids)   # dist ASC, id ASC
    td1, ti1 = t.search(q[3], k=5)
    assert td1.shape == (5,) and np.array_equal(ti1, ji[3, :5])


def test_consistent_snapshot_survives_add_and_delete(rng):
    x = _clustered(rng, 600, 16)
    q = x[:25] + 0.02
    j = JSP.ConsistentIndex(x)
    t = TSP.ConsistentIndex(x, device="cpu")
    pins = (j.pin(), t.pin())
    before = t.search(q, k=6, snapshot=pins[1])
    held = t._snapshots[pins[1]][0]
    held_copy = held.clone()
    new = _clustered(rng, 200, 16)
    for idx in (j, t):
        idx.add(new)
        assert idx.delete(np.arange(0, 600, 9)) == len(range(0, 600, 9))
    assert torch.equal(held, held_copy)              # nothing wrote into it
    after = t.search(q, k=6, snapshot=pins[1])
    for a, b in zip(before, after):
        assert a.tobytes() == b.tobytes()
    # searches at one pin are byte-identical, and the JAX package agrees
    p2 = (j.pin(), t.pin())
    once, twice = t.search(q, k=6, snapshot=p2[1]), t.search(
        q, k=6, snapshot=p2[1])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(once, twice))
    np.testing.assert_array_equal(once[1], j.search(q, k=6,
                                                    snapshot=p2[0])[1])
    assert not np.isin(once[1], np.arange(0, 600, 9)).any()
    assert t.stats() == j.stats() == {"n": 733, "pinned": 2, "seed": 0}
    t.release(pins[1])
    with pytest.raises(KeyError, match="unknown snapshot"):
        t.search(q, snapshot=pins[1])
    with pytest.raises(ValueError, match="need vectors or dim"):
        TSP.ConsistentIndex(device="cpu")
    empty = TSP.ConsistentIndex(dim=16, device="cpu")
    empty.add(x[:3], ids=[5, 6, 7])
    assert empty.search(x[1], k=2)[1][0] == 6


# ---------------------------------------------------------------------------
# validate_index: HNSW
# ---------------------------------------------------------------------------

def _graph(rng, n=400, m=4):
    """A level-0 graph: a ring plus random links, padded with -1."""
    nbr = np.full((n, 2 * m), -1, np.int32)
    nbr[:, 0] = (np.arange(n) + 1) % n
    nbr[:, 1:m] = rng.integers(0, n, (n, m - 1))
    nbr[nbr == np.arange(n)[:, None]] = -1
    return nbr


def _hnsw_pair(nbr, entry=0, m=4):
    j = SimpleNamespace(kind="hnsw", n=len(nbr), entry=entry, m=m,
                        _nbr0=nbr.copy())
    t = SimpleNamespace(kind="hnsw", n=len(nbr), entry=entry, m=m,
                        _nbr0=torch.from_numpy(nbr.copy()))
    return j, t


def _fault(nbr, kind):
    nbr = nbr.copy()
    if kind == "self_loop":
        nbr[17, 3] = 17
    elif kind == "out_of_range":
        nbr[5, 2] = len(nbr) + 3
    elif kind == "cut":                      # half the ring unreachable
        nbr[:, 1:] = -1
        nbr[len(nbr) // 2, 0] = -1
    return nbr


@pytest.mark.parametrize("fault", [None, "self_loop", "out_of_range", "cut",
                                   "entry"])
def test_validate_hnsw_matches_jax(rng, fault):
    nbr = _graph(rng)
    j, t = _hnsw_pair(nbr if fault in (None, "entry") else _fault(nbr, fault),
                      entry=-1 if fault == "entry" else 0)
    jr, tr = JVAL.validate_index(j), TVAL.validate_index(t)
    assert tr == jr
    assert tr["valid"] == (fault is None)


def test_validate_real_hnsw_index(rng):
    x = _clustered(rng, 600, 16)
    idx = THNSW(x, m=8, ef_construction=32, seed=0, device="cpu")
    r = TVAL.validate_index(idx)
    assert r["valid"], r
    frac = [c for c in r["checks"] if c["check"] == "connectivity_from_entry"]
    assert frac[0]["reachable_fraction"] == 1.0
    idx._nbr0[3, 0] = 3                        # a planted self loop
    assert not TVAL.validate_index(idx)["valid"]


def test_validate_other_kinds():
    for cls in (TSP.ConsistentIndex,):
        r = TVAL.validate_index(cls(np.eye(4, dtype=np.float32),
                                    device="cpu"))
        assert r == {"kind": "consistent", "valid": True, "checks": [], "n": 4}


# ---------------------------------------------------------------------------
# validate_index: IVFFlat
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ivf_pair():
    rng = np.random.default_rng(5)
    x = _clustered(rng, 2000, 16)
    j = JIVF(x, nlists=16, metric="l2", seed=0)
    arrays, meta = j._state()
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return j, (arrays, dict(meta, metric="l2", dim=j.dim))


def _carry(state, store_dtype="float32"):
    cfg = get_config()
    prev = cfg.store_dtype
    cfg.set("store_dtype", store_dtype)
    try:
        return TIVF.from_state(*state, device="cpu")
    finally:
        cfg.set("store_dtype", prev)


def _strip(report):
    """The JAX report's keys (the port adds counts to the assignment
    check)."""
    out = dict(report, checks=[])
    for c in report["checks"]:
        c = dict(c)
        if c["check"] == "assignment_consistency":
            c = {"check": c["check"], "ok": c["ok"]}
        out["checks"].append(c)
    return out


def test_validate_ivf_matches_jax(ivf_pair):
    j, state = ivf_pair
    t = _carry(state)
    tr = TVAL.validate_index(t)
    assert _strip(tr) == JVAL.validate_index(j)
    assert tr["valid"]
    assign = tr["checks"][-1]
    assert assign["mismatches"] == assign["within_bound"] == 0


@pytest.mark.parametrize("fault", ["count", "labels"])
def test_validate_ivf_planted_faults_fail_as_in_jax(ivf_pair, fault):
    j, state = ivf_pair
    for store in ("float32", "bfloat16"):
        t = _carry(state, store)
        if fault == "count":
            c = t._counts.clone()
            c[3] -= 1
            t._counts = c
        else:
            # every row labelled with its farthest centroid
            far = torch.cdist(torch.from_numpy(t._x), t.centroids).argmax(1)
            t._labels = far.numpy().astype(t._labels.dtype)
        r = TVAL.validate_index(t)
        assert not r["valid"], (store, r)
    j2 = JIVF.__new__(JIVF)
    j2._load_state(*state)
    if fault == "count":
        j2._counts = j2._counts.at[3].add(-1)
    else:
        j2._labels = (np.asarray(j2._labels) + 1) % 16
    assert not JVAL.validate_index(j2)["valid"]


def test_validate_ivf_bf16_store_counts_rounding(ivf_pair):
    """A bf16 store row may sit nearer another centroid than the label its
    f32 source got; it counts as consistent only within the rounding
    bound. Three sampled rows are moved onto the midpoint of their two
    nearest centroids and labelled with the one the check does not pick:
    a tie, so within the bound. (A label on a far centroid fails: the
    planted-fault test.)"""
    _, state = ivf_pair
    t = _carry(state, "bfloat16")
    assert t._vecs.dtype == torch.bfloat16
    r = TVAL.validate_index(t)
    assert r["valid"], r
    rows = np.random.default_rng(0).choice(t.n, 256, replace=False)
    c = t.centroids
    for row in rows[:3]:
        slot = int(torch.nonzero(t._row_ids == int(row))[0, 0])
        d = torch.cdist(t._vecs[slot][None].float(), c)[0]
        a, b = torch.topk(d, 2, largest=False).indices.tolist()
        mid = ((c[a] + c[b]) / 2).to(torch.bfloat16)
        t._vecs[slot] = mid
        picked = int(TVAL.kmeans_predict(c, mid[None].float())[0])
        t._labels[row] = b if picked == a else a
    r = TVAL.validate_index(t)
    assign = r["checks"][-1]
    assert assign["mismatches"] >= 3 and assign["within_bound"] >= 3, r
    assert r["valid"], r
