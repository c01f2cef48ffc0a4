"""The port's sharded HNSW and IVF-PQ against the JAX package on the CPU.

The JAX indexes are built once per module on the 8 virtual CPU devices
and carried across with ``from_arrays``; the port's side runs on
``make_mesh(8, device="cpu")``, where each shard's fused PQ scan takes
the kernel's plain version. Each side also builds on its own, and the
port's recall@10 against the exact neighbours must reach the JAX
index's less 0.02 (their k-means and NN-descent draws differ).
"""

import numpy as np
import pytest
import torch

from neurondb_tpu import parallel as JP
from neurondb_tpu_torch import parallel as TP

# distances: f32 sums in another order (the ADC: per-subspace table sums
# here, a decoded GEMM expansion in JAX); the absolute part is for the
# sqrt of an f32 cancellation residual near d = 0
RTOL, ATOL = 1e-4, 2e-3
AGREE = 0.99
RECALL_GAP = 0.02


def _clustered(seed, n, d, ncl=32, nq=96):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    x = (c[rng.integers(0, ncl, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.choice(n, nq, replace=False)]
         + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1,
                    kind="stable")[:, :10]
    return x, q, gt


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def _no_duplicates(ids):
    for row in ids:
        vals = [v for v in row if v >= 0]
        assert len(vals) == len(set(vals))


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


# ---- HNSW ----

@pytest.fixture(scope="module")
def hnsw_case():
    """4,096 rows over 4 of the 8 virtual devices: the JAX package builds
    its shards' graphs one after another, ~1 s each on the CPU."""
    x, q, gt = _clustered(31, 4096, 16)
    j = JP.ShardedHNSWIndex(x, mesh=JP.make_mesh(4), m=8, seed=0)
    return x, q, gt, j, j.search(q, k=10, ef=64)


def test_sharded_hnsw_shared_state_matches_jax(hnsw_case):
    x, q, _, j, (jd, ji) = hnsw_case
    t = TP.ShardedHNSWIndex.from_arrays(
        TP.make_mesh(4, device="cpu"), cents=np.asarray(j._cents), reps=np.asarray(j._reps),
        vecs=np.asarray(j._vecs), sqn=np.asarray(j._sqn),
        nbr0=np.asarray(j._nbr0), gids=np.asarray(j._gids), ids=j._ids_np,
        metric=j.metric, ef_search=j.ef_search)
    td, ti = t.search(q, k=10, ef=64)
    same = ti == np.asarray(ji)
    assert same.mean() >= AGREE, same.mean()
    np.testing.assert_allclose(td[same], np.asarray(jd)[same], rtol=RTOL,
                               atol=ATOL)


def test_sharded_hnsw_own_build(hnsw_case, tmesh):
    """The port's per-shard bulk builds: recall within RECALL_GAP of the
    JAX build's at ef 64, no id twice in a row, ascending distances, and
    on a 2-D mesh the self-hits survive the ICI-then-DCN merge."""
    x, q, gt, _, (_, ji) = hnsw_case
    t = TP.ShardedHNSWIndex(x, mesh=tmesh, m=8, seed=0)
    d, ids = t.search(q, k=10, ef=64)
    assert _recall(ids, gt) >= _recall(np.asarray(ji), gt) - RECALL_GAP
    _no_duplicates(ids)
    assert (np.diff(d, axis=1) >= -1e-5).all()
    assert t.stats() == {"kind": "sharded_hnsw", "n": 4096, "dim": 16,
                         "shards": 8, "axes": ["shard"], "metric": "l2"}
    t2 = TP.ShardedHNSWIndex(x[:2048], mesh=TP.make_mesh_2d(
        2, 4, device="cpu"), m=8, seed=0)
    _, ids2 = t2.search(x[:32] + 0.001, k=5, ef=48)
    assert (ids2[:, 0] == np.arange(32)).all()


# ---- IVF-PQ ----

@pytest.fixture(scope="module")
def pq_data():
    return _clustered(41, 12000, 32)


@pytest.fixture(scope="module")
def jax_pq(jmesh, pq_data):
    x = pq_data[0]
    return {dt: JP.ShardedIVFPQIndex(x, nlists=32, n_sub=8, mesh=jmesh,
                                     seed=0, sample_cap=8192, orig_dtype=dt)
            for dt in ("int8", "bf16")}


@pytest.fixture(scope="module")
def jax_pq_found():
    """JAX searches by (orig_dtype, rerank), each made once (every JAX
    search compiles its shard_map program anew)."""
    return {}


def _carry_pq(j, tmesh, rerank=True):
    orig = np.asarray(j._orig) if rerank else None
    scale = (np.asarray(j._orig_scale)
             if rerank and j._orig_scale is not None else None)
    return TP.ShardedIVFPQIndex.from_arrays(
        tmesh, centroids=j.centroids, codebooks=j.codebooks,
        codes=np.asarray(j._codes), gids=np.asarray(j._gids),
        off=np.asarray(j._off), cnt=np.asarray(j._cnt), ids=j._ids_np,
        orig=orig, orig_scale=scale, metric=j.metric)


@pytest.mark.parametrize("orig_dtype,rerank", [("int8", True),
                                               ("int8", False),
                                               ("bf16", True)])
def test_sharded_ivfpq_shared_state_matches_jax(jax_pq, jax_pq_found, tmesh,
                                                pq_data, monkeypatch,
                                                orig_dtype, rerank):
    _, q, _ = pq_data
    j = jax_pq[orig_dtype]
    t = _carry_pq(j, tmesh, rerank)
    assert t.rerank == rerank and t.max_list == j.max_list
    if not rerank:
        monkeypatch.setattr(j, "rerank", False)
    jd, ji = jax_pq_found[orig_dtype, rerank] = j.search(q, k=10, nprobe=8)
    td, ti = t.search(q, k=10, nprobe=8)
    assert ti.dtype == np.int64
    assert (ti == np.asarray(ji)).mean() >= AGREE, (ti == ji).mean()
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)
    if rerank:
        assert t.stats() == dict(j.stats(), axes=["shard"])


def test_sharded_ivfpq_own_build(jax_pq, jax_pq_found, tmesh, pq_data):
    """Built by the port (int8 originals): recall within RECALL_GAP of
    the JAX build's, no id twice, int64 external ids whole; a
    ``rerank_k`` past the kernel's candidate cap raises."""
    x, q, gt = pq_data
    big = np.arange(len(x), dtype=np.int64) + (1 << 40)
    t = TP.ShardedIVFPQIndex(x, nlists=32, n_sub=8, mesh=tmesh, seed=0,
                             sample_cap=8192, ids=big)
    assert t.orig_dtype == "int8"
    if ("int8", True) not in jax_pq_found:
        jax_pq_found["int8", True] = jax_pq["int8"].search(q, k=10, nprobe=8)
    _, ji = jax_pq_found["int8", True]
    _, ti = t.search(q, k=10, nprobe=8)
    assert ti.dtype == np.int64 and (ti >= 0).all()
    assert _recall(ti - (1 << 40), gt) >= \
        _recall(np.asarray(ji), gt) - RECALL_GAP
    _no_duplicates(ti)
    with pytest.raises(ValueError, match="256"):
        t.search(q[:2], k=10, nprobe=8, rerank_k=300)
    t2 = TP.ShardedIVFPQIndex(x[:4096], nlists=16, n_sub=8, mesh=tmesh,
                              seed=0, rerank=False)
    assert t2.orig_dtype is None
    _, i2 = t2.search(x[:16], k=3, nprobe=16)
    assert (i2[:, 0] == np.arange(16)).mean() > 0.8
