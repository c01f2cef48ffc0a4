"""The port's two-level (dcn x ici) sharding against the JAX package on
the CPU: the JAX side on its 8 virtual devices as 2 hosts x 4 chips, the
port's on ``make_mesh_2d(2, 4, device="cpu")``. JAX indexes are built
once per module and carried across with ``from_arrays``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from neurondb_tpu import parallel as JP
from neurondb_tpu_torch import parallel as TP
from neurondb_tpu_torch.parallel import mesh as TM
from neurondb_tpu_torch.parallel import multihost as TMH

RTOL_FLAT, RTOL_IVF, ATOL = 1e-5, 1e-4, 2e-3   # see test_torch_parallel.py
KM_TOL = 1e-5
N, DIM, NLISTS = 6000, 24, 32


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the machine's cores: one intra-op
    thread keeps this module's many small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jmesh2():
    return JP.make_mesh_2d(2, 4)


@pytest.fixture(scope="module")
def tmesh2():
    return TP.make_mesh_2d(2, 4, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((32, DIM)).astype(np.float32) * 2.0
    x = (centers[rng.integers(0, 32, N)]
         + rng.standard_normal((N, DIM)).astype(np.float32))
    q = x[rng.choice(N, 64, replace=False)] + \
        0.3 * rng.standard_normal((64, DIM)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1,
                    kind="stable")[:, :10]
    return x, q.astype(np.float32), gt


def _chunks(x):
    return [x[i:i + 1500] for i in range(0, len(x), 1500)]


def _jput(mesh, a):
    return jax.device_put(jnp.asarray(a),
                          NamedSharding(mesh, P(("dcn", "ici"))))


# ---- flat ----

def test_knn_2d_matches_jax(jmesh2, tmesh2, corpus):
    x, q, _ = corpus
    rows = np.arange(N, dtype=np.int32)
    ok = np.ones(N, bool)
    jd, ji = JP.knn_2d(jmesh2, jnp.asarray(q), _jput(jmesh2, x),
                       _jput(jmesh2, rows), _jput(jmesh2, ok), 10)
    td, ti = TP.knn_2d(tmesh2, torch.from_numpy(q), TM.shard_rows(tmesh2, x),
                       TM.shard_rows(tmesh2, rows), TM.shard_rows(tmesh2, ok),
                       10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL_FLAT,
                               atol=ATOL)


@pytest.mark.parametrize("n,big_ids", [(1003, False), (1003, True),
                                       (20, True)])
def test_multihost_flat_matches_jax(jmesh2, tmesh2, n, big_ids):
    """Uneven rows, int64 external ids, and 20 rows (fewer than k = 5 on
    every shard: 3, 3, ..., 2, 0)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = x[:7] + 0.01
    ids = np.arange(n, dtype=np.int64) + (1 << 40) if big_ids else None
    jd, ji = JP.MultiHostFlatIndex(x, mesh=jmesh2, ids=ids).search(q, k=5)
    td, ti = TP.MultiHostFlatIndex(x, mesh=tmesh2, ids=ids).search(q, k=5)
    assert ti.dtype == np.int64
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL_FLAT, atol=ATOL)


def test_cross_shard_tie_order_2d(tmesh2, rng):
    """The pinned order of test_multihost_scale's tie test, on the port:
    exact duplicates across all 8 shards come back in ascending row order
    (ICI then DCN merge, both shard-major), three times over."""
    n, d = 4096, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    dup_rows = [5, 700, 1300, 2100, 2900, 3700]
    probe = np.float32(rng.standard_normal(d))
    x[dup_rows] = probe
    idx = TP.MultiHostFlatIndex(x, mesh=tmesh2)
    d1, i1 = idx.search(probe[None, :], k=len(dup_rows))
    assert list(i1[0]) == dup_rows
    np.testing.assert_allclose(d1[0], 0.0, atol=1e-2)
    for _ in range(3):
        _, i2 = idx.search(probe[None, :], k=len(dup_rows))
        assert (i2 == i1).all()


# ---- k-means ----

def _inertia(x, c):
    return float(((x[:, None] - c[None]) ** 2).sum(-1).min(1).sum())


@pytest.mark.parametrize("given_init", [True, False])
def test_kmeans_fit_2d_matches_jax(jmesh2, tmesh2, corpus, given_init):
    """On the same centroids (``init``), and from the k-means++ seeding,
    whose numpy draws the port repeats: centroids to 1e-5, inertia to
    1e-5 relative."""
    x = corpus[0][:4096]
    init = x[:16] if given_init else None
    jc = np.asarray(JP.kmeans_fit_2d(jmesh2, _jput(jmesh2, x), 16, seed=3,
                                     init=init))
    tc = TP.kmeans_fit_2d(tmesh2, TM.shard_rows(tmesh2, x), 16, seed=3,
                          init=init).numpy()
    np.testing.assert_allclose(tc, jc, rtol=KM_TOL, atol=KM_TOL)
    assert abs(_inertia(x, tc) / _inertia(x, jc) - 1.0) <= KM_TOL


# ---- IVF ----

@pytest.fixture(scope="module")
def jax_mh(jmesh2, corpus):
    return JP.MultiHostIVFIndex.from_chunks(_chunks(corpus[0]),
                                            nlists=NLISTS, mesh=jmesh2,
                                            sample_cap=3000)


@pytest.fixture(scope="module")
def jax_mh_found():
    """JAX searches by nprobe, each made once."""
    return {}


@pytest.mark.parametrize("nprobe", [1, 8, NLISTS])
def test_multihost_ivf_shared_state_matches_jax(jax_mh, jax_mh_found, tmesh2,
                                                corpus, nprobe):
    _, q, _ = corpus
    j = jax_mh
    t = TP.MultiHostIVFIndex.from_arrays(
        tmesh2, centroids=j.centroids, vecs=np.asarray(j._vecs),
        rows=np.asarray(j._ids), off=np.asarray(j._off),
        cnt=np.asarray(j._cnt), ids=j._ids_np)
    jd, ji = jax_mh_found[nprobe] = j.search(q, k=10, nprobe=nprobe)
    td, ti = t.search(q, k=10, nprobe=nprobe)
    assert ti.dtype == np.int64
    assert (ti == np.asarray(ji)).mean() >= 0.999
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL_IVF, atol=ATOL)


def test_multihost_ivf_own_build_recall(jax_mh, jax_mh_found, tmesh2,
                                        corpus):
    """Built by the port from the same chunks, recall@10 against the
    exact neighbours is at least the JAX index's less 0.01."""
    x, q, gt = corpus
    t = TP.MultiHostIVFIndex.from_chunks(_chunks(x), nlists=NLISTS,
                                         mesh=tmesh2, sample_cap=3000)
    assert t.n == N and t.nlists == NLISTS
    if 8 not in jax_mh_found:
        jax_mh_found[8] = jax_mh.search(q, k=10, nprobe=8)
    _, ji = jax_mh_found[8]
    _, ti = t.search(q, k=10, nprobe=8)
    assert _recall(ti, gt) >= _recall(np.asarray(ji), gt) - 0.01


def _layout(index):
    return [(sh.vecs.numpy(), sh.rows.numpy(), sh.off.numpy(), sh.cnt.numpy())
            for sh in index._shards]


def test_streaming_build_equals_buffered_layout(tmesh2, corpus, monkeypatch):
    """On one set of centroids, the factory (three-pass streaming) build,
    the buffered build over a list and add_chunk + finalize lay out the
    same shards, row for row; external int64 ids go in through
    finalize(ids=)."""
    x, q, _ = corpus
    rng = np.random.default_rng(5)
    cents = torch.from_numpy(x[rng.choice(N, NLISTS, replace=False)].copy())
    monkeypatch.setattr(TMH, "kmeans_fit_2d", lambda *a, **kw: cents)
    chunks = _chunks(x)
    stream = TP.MultiHostIVFIndex.from_chunks(lambda: iter(chunks),
                                              nlists=NLISTS, mesh=tmesh2)
    buf = TP.MultiHostIVFIndex.from_chunks(chunks, nlists=NLISTS, mesh=tmesh2)
    inc = TP.MultiHostIVFIndex(nlists=NLISTS, dim=DIM, mesh=tmesh2)
    inc._train(x[:100], 0)
    for ch in chunks:
        inc.add_chunk(ch)
    big = np.arange(N, dtype=np.int64) * 7 + (1 << 40)
    inc.finalize(ids=big)
    assert stream.n == buf.n == inc.n == N
    assert set(stream.build_seconds) >= {"kmeans", "assign", "layout",
                                         "upload"}
    for a, b, c in zip(_layout(stream), _layout(buf), _layout(inc)):
        for u, v, w in zip(a, b, c):
            np.testing.assert_array_equal(u, v)
            np.testing.assert_array_equal(u, w)
    ds, is_ = stream.search(q, k=10, nprobe=8)
    di, ii = inc.search(q, k=10, nprobe=8)
    np.testing.assert_array_equal(ds, di)
    np.testing.assert_array_equal(big[is_], ii)
    _, self_hit = inc.search(x[:4] + 0.001, k=3, nprobe=8)
    assert (self_hit[:, 0] == big[:4]).all()
