"""The port's 1-D sharding (``neurondb_tpu_torch.parallel``) against the
JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's side on ``make_mesh(8, device="cpu")``: 8 logical shards of
the CPU, whose per-shard scans take the kernels' plain versions. Inputs
come from numpy seeds. The JAX indexes are built once per module and
carried across with ``from_arrays`` so both packages search one state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neurondb_tpu import parallel as JP
from neurondb_tpu.parallel.mesh import shard_rows as j_shard_rows
from neurondb_tpu_torch import parallel as TP
from neurondb_tpu_torch.parallel import mesh as TM
from neurondb_tpu_torch.parallel import multihost as TMH

# distances: f32 sums in another order; the absolute part is for the
# sqrt of an f32 cancellation residual at d ~ 0 (|q|^2 + |x|^2 - 2 q.x
# of a near-duplicate: O(eps |q|^2) ~ 1e-6 squared, ~1e-3 after sqrt)
RTOL_FLAT, RTOL_IVF, ATOL = 1e-5, 1e-4, 2e-3
KM_TOL = 1e-5


def _clustered(rng, n, d, ncl=32, nq=64, noise=0.3):
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, ncl, n)] + \
        rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] + \
        noise * rng.standard_normal((nq, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _oracle(x, q, k, metric="l2"):
    if metric == "ip":
        d = -(q @ x.T)
    else:
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def _assert_matches(jd, ji, td, ti, *, share, rtol):
    """Ids equal on at least ``share`` of entries; every entry's distance
    within tolerance, so an entry whose ids differ is a distance tie."""
    assert ti.dtype == np.int64 and ti.shape == ji.shape
    assert (ti == ji).mean() >= share, (ti == ji).mean()
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=ATOL)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the machine's cores: one intra-op
    thread keeps this module's many small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jmesh():
    return JP.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return TP.make_mesh(8, device="cpu")


# ---- the mesh ----

@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_cuda_meshes_raise_without_a_card(no_card):
    """The default device is the card: without one, the mesh functions and
    every sharded constructor raise instead of picking the CPU."""
    x = np.zeros((64, 8), np.float32)
    for make in (TP.make_mesh, lambda: TP.make_mesh(4), TP.make_mesh_2d,
                 lambda: TP.make_mesh(4, device="cuda"),
                 lambda: TP.ShardedFlatIndex(x),
                 lambda: TP.ShardedIVFIndex(x, nlists=4),
                 lambda: TP.ShardedHNSWIndex(x),
                 lambda: TP.ShardedIVFPQIndex(x, nlists=4, n_sub=4),
                 lambda: TP.MultiHostFlatIndex(x),
                 lambda: TP.MultiHostIVFIndex(nlists=4, dim=8)):
        with pytest.raises(RuntimeError, match="needs a card"):
            make()


def test_cpu_mesh_shapes_and_rows(tmesh):
    assert tmesh.shape == {"shard": 8} and tmesh.size == 8
    assert all(d.type == "cpu" for d in tmesh.shard_devices())
    with pytest.raises(ValueError, match="shard count"):
        TP.make_mesh(device="cpu")
    m2 = TP.make_mesh_2d(2, 4, device="cpu")
    assert m2.axis_names == ("dcn", "ici") and m2.shape == {"dcn": 2,
                                                             "ici": 4}
    lm = TP.local_mesh([("data", 4), ("model", 2)], device="cpu")
    assert lm.shape == {"data": 4, "model": 2}
    # shard_rows: the blocks NamedSharding(P("shard")) gives each device
    parts = TM.shard_rows(tmesh, np.arange(997))
    assert [len(p) for p in parts] == [125] * 7 + [122]
    assert torch.equal(torch.cat(parts), torch.arange(997))
    reps = TM.replicate(tmesh, np.ones(3))
    assert len(reps) == 8 and all(r is reps[0] for r in reps)


def test_psum_and_merge_order(tmesh):
    parts = [torch.full((2,), float(s)) for s in range(8)]
    assert torch.equal(TM.psum(tmesh, parts), torch.full((2,), 28.0))
    # equal distances everywhere: the merge keeps shard-major order
    d = [torch.zeros((1, 2)) for _ in range(8)]
    i = [torch.tensor([[10 * s, 10 * s + 1]]) for s in range(8)]
    _, ids = TM.merge_shards(tmesh, d, i, 5)
    assert ids.tolist() == [[0, 1, 10, 11, 20]]


# ---- flat ----

@pytest.mark.parametrize("n,metric,k", [(997, "l2", 5), (20, "l2", 5),
                                        (997, "cosine", 7)])
def test_sharded_flat_matches_jax(jmesh, tmesh, n, metric, k):
    """Ids equal, distances close; 997 rows split unevenly, 20 rows leave
    each shard fewer than k (3 or 2 rows)."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    jd, ji = JP.ShardedFlatIndex(x, mesh=jmesh, metric=metric).search(q, k=k)
    td, ti = TP.ShardedFlatIndex(x, mesh=tmesh, metric=metric).search(q, k=k)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL_FLAT, atol=ATOL)


def test_sharded_knn_matches_jax(jmesh, tmesh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    ids = np.arange(1000, dtype=np.int32) * 3
    valid = rng.random(1000) > 0.2
    jd, ji = JP.sharded_knn(
        jmesh, jnp.asarray(q), j_shard_rows(jmesh, jnp.asarray(x)),
        j_shard_rows(jmesh, jnp.asarray(ids)),
        j_shard_rows(jmesh, jnp.asarray(valid)), 6)
    td, ti = TP.sharded_knn(
        tmesh, torch.from_numpy(q), TM.shard_rows(tmesh, x),
        TM.shard_rows(tmesh, ids), TM.shard_rows(tmesh, valid), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL_FLAT,
                               atol=ATOL)


def test_sharded_flat_int64_ids(jmesh, tmesh):
    """External ids past int32 come back whole (the JAX class casts its
    ids to int32 on the devices; the port maps them on the host)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((500, 8)).astype(np.float32)
    big = np.arange(500, dtype=np.int64) + (1 << 40)
    _, ji = JP.ShardedFlatIndex(x, mesh=jmesh).search(x[:6], k=4)
    _, ti = TP.ShardedFlatIndex(x, mesh=tmesh, ids=big).search(x[:6], k=4)
    assert ti.dtype == np.int64
    np.testing.assert_array_equal(ti, big[np.asarray(ji)])


def test_cross_shard_tie_order_1d(tmesh, rng):
    """Duplicates on all 8 shards come back in ascending row order (the
    shard-major merge), three times over."""
    x = rng.standard_normal((4096, 8)).astype(np.float32)
    dup_rows = [5, 600, 1100, 1600, 2100, 2600, 3100, 3700]
    probe = rng.standard_normal(8).astype(np.float32)
    x[dup_rows] = probe
    idx = TP.ShardedFlatIndex(x, mesh=tmesh)
    for _ in range(3):
        d, ids = idx.search(probe[None], k=len(dup_rows))
        assert list(ids[0]) == dup_rows
        np.testing.assert_allclose(d[0], 0.0, atol=1e-2)


# ---- k-means ----

def test_sharded_kmeans_step_matches_jax(jmesh, tmesh):
    rng = np.random.default_rng(3)
    x, _ = _clustered(rng, 4000, 24, ncl=16)
    c0 = x[:10].copy()
    c0[9] = 1e3                               # an empty cluster keeps c0
    jc, jin = JP.sharded_kmeans_step(
        jmesh, j_shard_rows(jmesh, jnp.asarray(x)), jnp.asarray(c0))
    tc, tin = TP.sharded_kmeans_step(tmesh, TM.shard_rows(tmesh, x), c0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=KM_TOL,
                               atol=KM_TOL)
    assert tc[9].tolist() == c0[9].tolist()
    assert abs(float(tin) / float(jin) - 1.0) <= KM_TOL


# ---- IVF ----

_IVF_N, _IVF_D, _IVF_L = 6000, 16, 32


@pytest.fixture(scope="module")
def ivf_data():
    rng = np.random.default_rng(4)
    return _clustered(rng, _IVF_N, _IVF_D, nq=96)


@pytest.fixture(scope="module")
def jax_ivf(jmesh, ivf_data):
    x, _ = ivf_data
    return {m: JP.ShardedIVFIndex(x, nlists=_IVF_L, mesh=jmesh, metric=m,
                                  seed=0) for m in ("l2", "ip", "cosine")}


def _carry_ivf(j, tmesh):
    return TP.ShardedIVFIndex.from_arrays(
        tmesh, centroids=j.centroids, vecs=np.asarray(j._vecs),
        rows=np.asarray(j._ids), off=np.asarray(j._off),
        cnt=np.asarray(j._cnt), ids=j._ids_np, metric=j.metric)


@pytest.fixture(scope="module")
def jax_ivf_found():
    """JAX searches by (metric, nprobe), each made once (every JAX search
    compiles its shard_map program anew)."""
    return {}


@pytest.mark.parametrize("metric,nprobe", [("l2", 1), ("l2", _IVF_L),
                                           ("ip", 16), ("cosine", 4)])
def test_sharded_ivf_shared_state_matches_jax(jax_ivf, jax_ivf_found, tmesh,
                                              ivf_data, metric, nprobe):
    """nprobe 1 and 4 probe part of the lists, 16 half, 32 all."""
    _, q = ivf_data
    j = jax_ivf[metric]
    t = _carry_ivf(j, tmesh)
    assert t.max_list == j.max_list
    jd, ji = jax_ivf_found[metric, nprobe] = j.search(q, k=10, nprobe=nprobe)
    td, ti = t.search(q, k=10, nprobe=nprobe)
    _assert_matches(np.asarray(jd), np.asarray(ji), td, ti, share=0.999,
                    rtol=RTOL_IVF)


def test_sharded_ivf_own_build_recall(jax_ivf, jax_ivf_found, tmesh,
                                     ivf_data):
    """Built by the port (its own k-means), recall@10 against a numpy
    oracle is at least the JAX index's less 0.01."""
    x, q = ivf_data
    gt = _oracle(x, q, 10)
    t = TP.ShardedIVFIndex(x, nlists=_IVF_L, mesh=tmesh, seed=0)
    assert set(t.build_seconds) >= {"kmeans", "assign", "layout", "upload"}
    # every row sits in exactly one shard's slice of its list
    rows = np.concatenate([sh.rows.numpy() for sh in t._shards])
    assert np.array_equal(np.sort(rows), np.arange(_IVF_N))
    if ("l2", 1) not in jax_ivf_found:
        jax_ivf_found["l2", 1] = jax_ivf["l2"].search(q, k=10, nprobe=1)
    _, ji = jax_ivf_found["l2", 1]
    _, ti = t.search(q, k=10, nprobe=1)
    assert _recall(ti, gt) >= _recall(np.asarray(ji), gt) - 0.01


def test_sharded_ivf_ids_and_k_cap(tmesh, ivf_data):
    x, _ = ivf_data
    big = np.arange(_IVF_N, dtype=np.int64) + (1 << 40)
    t = TP.ShardedIVFIndex(x[:2000], nlists=16, mesh=tmesh, ids=big[:2000])
    d, ids = t.search(x[:8], k=3, nprobe=16)
    assert ids.dtype == np.int64 and (ids[:, 0] == big[:8]).all()
    # k is cut to n before the probe kernel's cap applies
    small = TP.ShardedIVFIndex(x[:300], nlists=4, mesh=tmesh)
    assert small.search(x[:2], k=600, nprobe=4)[1].shape == (2, 300)


def test_sharded_ivf_k_past_the_probe_cap_raises(tmesh, ivf_data):
    x, _ = ivf_data
    t = TP.ShardedIVFIndex(x[:2000], nlists=16, mesh=tmesh)
    with pytest.raises(ValueError, match="512"):
        t.search(x[:2], k=513, nprobe=16)


# ---- the dry run of __graft_entry__.dryrun_multichip, on the port ----

def test_dryrun_multichip_on_the_port(tmesh):
    """20k x 32, 32 lists, nprobe 16, 8 shards: the sharded k-means step,
    then the 1-D IVF, the 2-D IVF (streaming chunks), HNSW and IVF-PQ,
    each with its self-query first and recall >= 0.9 against the exact
    oracle."""
    rng = np.random.default_rng(0)
    n, d, nlist, nq, k = 20_000, 32, 32, 128, 10
    centers = rng.standard_normal((64, d)).astype(np.float32) * 1.5
    x = (centers[rng.integers(0, 64, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    q = x[:nq] + 0.01 * rng.standard_normal((nq, d)).astype(np.float32)
    gt = _oracle(x, q, k)

    c1, inertia = TP.sharded_kmeans_step(tmesh, TM.shard_rows(tmesh, x),
                                         x[:nlist])
    assert c1.shape == (nlist, d) and np.isfinite(float(inertia))

    idx = TP.ShardedIVFIndex(x, nlists=nlist, mesh=tmesh, seed=0)
    _, ids = idx.search(q, k=k, nprobe=16)
    assert ids.shape == (nq, k)
    assert (ids[:, 0] == np.arange(nq)).all(), "self-query must return itself"
    assert _recall(ids, gt) >= 0.9

    mesh2 = TP.make_mesh_2d(2, 4, device="cpu")
    chunks = [x[i: i + n // 4] for i in range(0, n, n // 4)]
    mh = TP.MultiHostIVFIndex.from_chunks(chunks, nlists=nlist, mesh=mesh2,
                                          sample_cap=8192)
    _, i2 = mh.search(q, k=k, nprobe=16)
    assert i2.shape == (nq, k)
    assert (i2[:, 0] == np.arange(nq)).all(), "2-D self-query failed"
    assert _recall(i2, gt) >= 0.9

    hn = TP.ShardedHNSWIndex(x, mesh=tmesh, m=8, seed=0)
    _, i3 = hn.search(q, k=k, ef=64)
    assert i3.shape == (nq, k)
    assert (i3[:, 0] == np.arange(nq)).all(), "HNSW self-query failed"
    assert _recall(i3, gt) >= 0.9

    pq = TP.ShardedIVFPQIndex(x, nlists=nlist, n_sub=8, mesh=tmesh, seed=0,
                              sample_cap=8192)
    _, i4 = pq.search(q, k=k, nprobe=16)
    assert i4.shape == (nq, k)
    assert (i4[:, 0] == np.arange(nq)).all(), "IVF-PQ self-query failed"
    assert _recall(i4, gt) >= 0.9
    assert TMH.AXES == mesh2.axis_names
