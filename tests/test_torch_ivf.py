"""IVFFlat as a whole: the torch port against the JAX package on the CPU.

The JAX index is built once and carried across with ``from_state``, so
both packages hold the same centroids and the same lists; their searches
must then agree. The port's own build is held to the JAX build's recall.
On the CPU the JAX package searches through its gather path and stores
f32; the port takes its grouped route (plain scan) or its exact route,
also over an f32 store.
"""

import numpy as np
import pytest
import torch

from neurondb_tpu.index.ivf import IVFFlatIndex as JIVF
from neurondb_tpu_torch.index.base import quantize_queries_int8
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.ml.metrics import recall_at_k
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

# both sides compute |q|^2 + |x|^2 - 2 q.x in f32 with sums in another
# order; queries sit 0.3 sigma off a corpus row, away from the cancelling
# near-duplicate regime
RTOL = 1e-4
ATOL = 1e-5        # cosine and ip values near 0 cannot be held relatively


def _clustered(rng, n, d, ncl=32, noise=0.3, nq=64):
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, ncl, n)] + \
        rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] + \
        noise * rng.standard_normal((nq, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _carry(j: JIVF, metric: str) -> TIVF:
    arrays, meta = j._state()
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return TIVF.from_state(arrays, dict(meta, metric=metric, dim=j.dim),
                           device="cpu")


def _assert_parity(j, t, q, k=10, **kw):
    # exact selection on both sides: the JAX package's CPU route is exact,
    # and the packed default is held to it in tests/test_torch_ivf_select.py
    kw = dict(kw, select="exact")
    jd, ji = j.search(q, k=k, **kw)
    td, ti = t.search(q, k=k, **kw)
    assert ti.shape == ji.shape
    agree = float((ti == ji).mean())
    assert agree >= 0.99, agree
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    return ti


@pytest.fixture(scope="module")
def data(rng_mod):
    x, q = _clustered(rng_mod, 4096, 128)
    d = ((q.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    return x, q, np.argsort(d, axis=1)[:, :10]


@pytest.fixture(scope="module")
def pair(data):
    x, _, _ = data
    j = JIVF(x, nlists=32, seed=0)
    return j, _carry(j, "l2")


def test_from_state_same_lists(pair):
    j, t = pair
    np.testing.assert_array_equal(t._offsets.numpy(), np.asarray(j._offsets))
    np.testing.assert_array_equal(t._counts.numpy(), np.asarray(j._counts))
    np.testing.assert_array_equal(t._row_ids.numpy(), np.asarray(j._row_ids))
    np.testing.assert_array_equal(t._vecs.numpy(), np.asarray(j._vecs))
    assert t._vecs.dtype == torch.float32          # store_dtype auto on CPU
    assert t.stats()["list_len_max"] == j.stats()["list_len_max"]


@pytest.mark.parametrize("nprobe", [4, 32])
def test_search_parity(pair, data, nprobe):
    """nprobe 4 runs the grouped route, nprobe = nlists the exact route."""
    j, t = pair
    _, q, _ = data
    before = G.LAUNCHES
    _assert_parity(j, t, q, nprobe=nprobe)
    assert G.LAUNCHES == before                    # CPU tensors: plain scan


def test_int8_wire_parity(pair, data):
    j, t = pair
    _, q, _ = data
    _assert_parity(j, t, quantize_queries_int8(q), nprobe=4)


def test_own_build_recall_matches_jax_build(pair, data):
    x, q, gt = data
    j, _ = pair
    t = TIVF(x, nlists=32, seed=0, device="cpu")
    rj = recall_at_k(j.search(q, k=10, nprobe=4)[1], gt)
    rt = recall_at_k(t.search(q, k=10, nprobe=4)[1], gt)
    assert abs(rt - rj) <= 0.02, (rt, rj)
    assert t.stats()["n"] == len(x) and np.isfinite(t.train_inertia)


def test_add_delete_rebuild_parity(data, rng):
    x, q, _ = data
    j = JIVF(x[:2048], nlists=16, seed=0)
    t = _carry(j, "l2")
    extra = x[2048:2148] + 0.01
    np.testing.assert_array_equal(t.add(extra), j.add(extra))
    _assert_parity(j, t, q, nprobe=4)            # spill merge
    drop = np.concatenate([rng.choice(2048, 300, replace=False),
                           [2048 + 3, 2048 + 7]])
    assert t.delete(drop) == j.delete(drop) == 302
    assert t.n == j.n and t.dead_ratio == j.dead_ratio
    np.testing.assert_array_equal(t._counts.numpy(), np.asarray(j._counts))
    _assert_parity(j, t, q, nprobe=4)
    _assert_parity(j, t, q, nprobe=16)           # exact route after delete
    t.rebuild_lists()
    j.rebuild_lists()
    assert t.n == j.n == 2048 + 100 - 302
    np.testing.assert_array_equal(t._counts.numpy(), np.asarray(j._counts))
    _assert_parity(j, t, q, nprobe=4)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
@pytest.mark.parametrize("nprobe", [4, 16])
def test_metric_parity(rng, metric, nprobe):
    x, q = _clustered(rng, 2048, 64, ncl=16)
    j = JIVF(x, nlists=16, metric=metric, seed=0)
    t = _carry(j, metric)
    assert t._spherical == (metric == "cosine")
    _assert_parity(j, t, q, nprobe=nprobe)


def test_k_past_rows_pads_with_minus_one(rng):
    """k > n: both return n columns; one probed list fills few of them.
    (nlists stays above the smallest probe bucket, 4: at nlists <= 4 the
    port, like the JAX package on a TPU, takes the exact route.)"""
    x, q = _clustered(rng, 50, 16, ncl=4, nq=6)
    j = JIVF(x, nlists=16, seed=0)
    t = _carry(j, "l2")
    td, ti = t.search(q, k=100, nprobe=1, select="exact")
    jd, ji = j.search(q, k=100, nprobe=1, select="exact")
    assert ti.shape == ji.shape == (6, 50)
    np.testing.assert_array_equal(ti, ji)
    assert (ti == -1).any()
    assert (td[ti == -1] == G.NEG_FILL).all()


def test_int64_ids_take_the_host_map(data):
    x, q, _ = data
    ids = np.arange(len(x), dtype=np.int64) + (1 << 40)
    j = JIVF(x, nlists=32, seed=0, ids=ids)
    t = _carry(j, "l2")
    assert t._host_id_map
    ti = _assert_parity(j, t, q, nprobe=4)
    assert ti.min() >= 1 << 40
    with pytest.raises(ValueError, match="int32 ids"):
        t.search(q, k=10, nprobe=4, out="device")


def test_device_output(pair, data):
    _, t = pair
    _, q, _ = data
    dv, di = t.search(q, k=10, nprobe=4, out="device")
    assert isinstance(dv, torch.Tensor) and dv.device == t.device
    nv, ni = t.search(q, k=10, nprobe=4)
    np.testing.assert_array_equal(di.numpy(), ni)
    np.testing.assert_array_equal(dv.numpy(), nv)
    with pytest.raises(ValueError, match="batch query"):
        t.search(q[0], k=10, nprobe=4, out="device")


@pytest.mark.parametrize("select", ["packed", "blockmin", "bogus"])
def test_unported_select_raises(pair, data, select):
    """Every selection mode of the JAX package is ported now: only an
    unknown name raises. Packed is the default, and the approximate
    coarse knob is served exactly."""
    _, t = pair
    _, q, _ = data
    if select == "bogus":
        with pytest.raises(ValueError, match="unknown select"):
            t.search(q, k=10, nprobe=4, select=select)
        return
    _, ids = t.search(q, k=10, nprobe=4, select=select)
    _, exact = t.search(q, k=10, nprobe=4, select="exact")
    assert recall_at_k(ids, exact) >= 0.9
    d1, i1 = t.search(q, k=10, nprobe=4, coarse_rt=0.5)
    d2, i2 = t.search(q, k=10, nprobe=4, select="packed")
    np.testing.assert_array_equal(i1, i2)


def test_save_load_roundtrip(pair, data, tmp_path):
    _, t = pair
    _, q, _ = data
    t.save(str(tmp_path))
    u = TIVF.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(u.search(q, k=10, nprobe=4)[1],
                                  t.search(q, k=10, nprobe=4)[1])
    assert u.search(q[0], k=3, nprobe=4)[1].shape == (3,)
