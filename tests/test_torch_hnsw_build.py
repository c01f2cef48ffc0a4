"""The port's HNSW on its own, on the CPU: the IVF-bootstrap branch of the
bulk build, mutation (add, delete, compact; the JAX package's
``tests/test_delete.py`` HNSW cases), and ``IVFFlatIndex``'s
``device_vectors`` (``tests/test_index.py``'s cases).
"""

import numpy as np
import pytest
import torch

import neurondb_tpu_torch.index.hnsw as TH
from neurondb_tpu_torch.index.flat import FlatIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

BOOTSTRAP_GAP = 0.01     # IVF-bootstrapped build vs exact build, recall@10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the machine's cores: one intra-op
    thread keeps this module's many small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids, gt)]))


def _clustered(seed, n, d=16, ncl=24, nq=200):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    x = (c[rng.integers(0, ncl, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.choice(n, nq, replace=False)]
         + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def corpus():
    """The JAX mutation tests' corpus: 4000 x 32 standard normal."""
    return np.random.default_rng(0).standard_normal((4000, 32)).astype(
        np.float32)


@pytest.fixture(scope="module")
def incremental(corpus):
    return TH.HNSWIndex(corpus, m=8, ef_construction=64, seed=0,
                        device="cpu")


def test_ivf_bootstrap_branch(monkeypatch):
    """Above EXACT_KNN_MAX_ROWS the bulk build's candidate graph comes
    from self-queries of an IVFFlatIndex (the grouped scan, plain on CPU
    tensors) and its router from the IVF's lists; with the threshold
    moved below 6,000 rows that branch builds a graph whose recall@10 is
    within 0.01 of the exact branch's at ef 16 and 64."""
    x, q = _clustered(31, 6000)
    gt = FlatIndex(x, device="cpu").search(q, k=10)[1]
    exact = TH.HNSWIndex(x, m=16, seed=0, build_mode="bulk", device="cpu")
    calls = []
    scan = G.grouped_probe_scan

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return scan(*a, **kw)

    monkeypatch.setattr(G, "grouped_probe_scan", counting)
    monkeypatch.setattr(TH, "EXACT_KNN_MAX_ROWS", 5000)
    boot = TH.HNSWIndex(x, m=16, seed=0, build_mode="bulk", device="cpu")
    assert len(calls) == 1                  # one 16,384-row self-query batch
    assert boot._router["centroids"].shape[0] > 64    # the IVF's lists
    for ef in (16, 64):
        r_e = _recall(exact.search(q, k=10, ef=ef)[1], gt)
        r_b = _recall(boot.search(q, k=10, ef=ef)[1], gt)
        assert abs(r_b - r_e) <= BOOTSTRAP_GAP, (ef, r_b, r_e)
    assert set(boot.build_seconds) >= {"knn_graph", "prune_own",
                                       "reverse_link", "nn_descent",
                                       "bridge", "upper_levels", "total"}


def test_bulk_connected_and_stats():
    """Component bridging leaves one level-0 component."""
    x, _ = _clustered(32, 4500, ncl=48)
    idx = TH.HNSWIndex(x, m=8, seed=0, device="cpu")   # auto: bulk
    assert idx._router is not None
    lab = TH._component_labels(idx._nbr0[:idx.n].numpy())
    assert len(np.unique(lab)) == 1
    st = idx.stats()
    assert st["n"] == 4500 and st["isolated_nodes"] == 0


def test_delete_tombstones(incremental, corpus):
    idx = TH.HNSWIndex.from_state(*_state_copy(incremental), device="cpu")
    q = corpus[:64]
    drop = np.random.default_rng(1).choice(4000, 400, replace=False)
    assert idx.delete(drop.astype(np.int64)) == 400
    _, ids = idx.search(q, k=10, ef=64)
    assert not np.isin(ids, drop).any(), "deleted ids returned"
    keep = np.setdiff1d(np.arange(4000), drop)
    gt = FlatIndex(corpus[keep], ids=keep, device="cpu").search(q, k=10)[1]
    assert _recall(ids, gt) > 0.9


def test_compact_backlink_repair(incremental, corpus):
    idx = TH.HNSWIndex.from_state(*_state_copy(incremental), device="cpu")
    drop = np.random.default_rng(2).choice(4000, 400, replace=False)
    idx.delete(drop.astype(np.int64))
    assert idx.compact() == 400
    assert idx.n == 3600 and idx.dead_ratio == 0.0
    nbr = idx._nbr0[:idx.n].numpy()
    assert nbr.max() < idx.n
    rows = np.arange(idx.n)[:, None]
    assert not ((nbr == rows) & (nbr >= 0)).any()
    q = corpus[:64]
    _, ids = idx.search(q, k=10, ef=64)
    assert not np.isin(ids, drop).any()
    keep = np.setdiff1d(np.arange(4000), drop)
    gt = FlatIndex(corpus[keep], ids=keep, device="cpu").search(q, k=10)[1]
    assert _recall(ids, gt) > 0.9


def test_delete_entry_promotes(corpus):
    idx = TH.HNSWIndex(corpus[:500], m=8, ef_construction=64, seed=0,
                       device="cpu")
    entry_id = int(idx._ids_np[idx.entry])
    idx.delete(np.asarray([entry_id], np.int64))
    assert idx.entry >= 0 and idx._alive_np[idx.entry]
    _, ids = idx.search(corpus[1:5], k=3, ef=64)
    assert entry_id not in ids
    assert idx.delete(np.asarray([entry_id], np.int64)) == 0


def test_add_after_bulk_then_compact():
    """add() on a bulk-built index links new rows searchably; a compact
    keeps the router (its deleted representatives replaced)."""
    x, _ = _clustered(33, 5000)
    idx = TH.HNSWIndex(x[:4500], m=8, seed=0, build_mode="bulk",
                       device="cpu")
    new = idx.add(x[4500:])
    assert np.array_equal(new, np.arange(4500, 5000))
    _, ids = idx.search(x[4500:], k=1, ef=64)
    assert float((ids[:, 0] == new).mean()) >= 0.9
    reps = idx._ids_np[idx._router["reps"].numpy()]
    idx.delete(reps[:5])
    idx.compact()
    assert idx._router is not None and idx.n == 4995
    assert (idx._router["reps"].numpy() >= 0).all()
    _, ids = idx.search(x[4500:4600], k=1, ef=64)
    assert not np.isin(ids, reps[:5]).any()


def test_cosine_and_ip_search():
    x, q = _clustered(34, 1500, nq=50)
    for metric in ("cosine", "ip"):
        idx = TH.HNSWIndex(x, m=8, ef_construction=64, metric=metric,
                           seed=0, device="cpu")
        d, ids = idx.search(q, k=10, ef=64)
        gt = FlatIndex(x, metric=metric, device="cpu").search(q, k=10)[1]
        assert _recall(ids, gt) > 0.95, metric
        assert d.shape == (50, 10) and np.all(np.diff(d, axis=1) >= -1e-6)


def _state_copy(idx):
    arrays, meta = idx._state()
    arrays = {k: (v.numpy() if torch.is_tensor(v) else np.array(v))
              for k, v in arrays.items()}
    return arrays, dict(meta, metric=idx.metric, dim=idx.dim)


def test_ivf_device_vectors_parity():
    """device_vectors (the corpus already on the index's device) builds
    the same index as the host array: same centroids, same lists, same
    search."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    a = IVFFlatIndex(x, nlists=32, metric="l2", seed=0, device="cpu")
    b = IVFFlatIndex(x, nlists=32, metric="l2", seed=0, device="cpu",
                     device_vectors=torch.from_numpy(x))
    assert torch.equal(a.centroids, b.centroids)
    da, ia = a.search(q, k=10, nprobe=8)
    db, ib = b.search(q, k=10, nprobe=8)
    assert np.array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


def test_ivf_device_vectors_spherical():
    """cosine: device_vectors arrives normalised (as the HNSW build hands
    it over): the same search as the host path."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    xs = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    a = IVFFlatIndex(x, nlists=32, metric="cosine", seed=0, device="cpu")
    b = IVFFlatIndex(x, nlists=32, metric="cosine", seed=0, device="cpu",
                     device_vectors=torch.from_numpy(xs))
    _, ia = a.search(q, k=10, nprobe=32)
    _, ib = b.search(q, k=10, nprobe=32)
    assert float((ia == ib).mean()) > 0.99


def test_ivf_device_vectors_checks_its_input():
    x = np.zeros((100, 8), np.float32)
    with pytest.raises(ValueError, match="device_vectors"):
        IVFFlatIndex(x, nlists=4, device="cpu",
                     device_vectors=torch.zeros((99, 8)))
    with pytest.raises(ValueError, match="device_vectors"):
        IVFFlatIndex(x, nlists=4, device="cpu",
                     device_vectors=torch.zeros((100, 8), device="meta"))
