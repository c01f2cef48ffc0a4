"""Product quantization, OPQ and the batched k-means under them: the torch
port against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.index import pq as JPQ
from neurondb_tpu_torch.index import pq as TPQ
from neurondb_tpu_torch.ml import kmeans as TK


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(rng, n=2000, d=32, ncl=24):
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    return (centers[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


def _distortion(encode, decode, x):
    return float(((x - decode(encode(x))) ** 2).sum(1).mean())


@pytest.mark.parametrize("ns", [8, 16, 32])
def test_encode_decode_adc_match_jax(rng, ns):
    """The same codebooks: codes equal (an argmin whose GEMM expansion
    sums in another order may flip only between near-equal codewords:
    at most 1 in 1,000), decode exact, ADC within f32 rounding."""
    cb = rng.standard_normal((ns, 256, 64 // ns)).astype(np.float32)
    x = rng.standard_normal((1500, 64)).astype(np.float32)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    jc = np.asarray(JPQ.pq_encode(jnp.asarray(cb), jnp.asarray(x)))
    tc = TPQ.pq_encode(_t(cb), _t(x)).numpy()
    assert tc.dtype == np.uint8 and tc.shape == (1500, ns)
    assert (tc == jc).mean() >= 0.999
    np.testing.assert_array_equal(
        TPQ.pq_decode(_t(cb), _t(jc)).numpy(),
        np.asarray(JPQ.pq_decode(jnp.asarray(cb), jnp.asarray(jc))))
    want = np.asarray(JPQ.pq_asymmetric_distance(
        jnp.asarray(cb), jnp.asarray(q), jnp.asarray(jc)))
    got = TPQ.pq_asymmetric_distance(_t(cb), _t(q), _t(jc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_encode_chunks_agree(rng):
    cb = _t(rng.standard_normal((8, 256, 4)).astype(np.float32))
    x = _t(rng.standard_normal((1000, 32)).astype(np.float32))
    assert torch.equal(TPQ.pq_encode(cb, x), TPQ.pq_encode(cb, x, budget=8 * 256 * 37))


def test_batched_kmeans_each_matrix_stops_on_its_own(rng):
    """Two matrices in one batch: one of 4 distinct points (k = 4
    converges at once), one of overlapping blobs. Each keeps its own
    iteration count and shift, and each fit is a fit of its own data."""
    easy = np.repeat(rng.standard_normal((4, 8)).astype(np.float32) * 5, 250, 0)
    hard = _clustered(rng, n=1000, d=8, ncl=12)
    s = TK.kmeans_fit_batched(_t(np.stack([easy, hard])), 4, max_iter=30,
                              tol=1e-3, seed=0)
    assert s.centroids.shape == (2, 4, 8)
    n_iter = s.n_iter.tolist()
    assert n_iter[0] <= 2 < n_iter[1]
    assert float(s.inertia[0]) <= 1e-6
    for i, m in enumerate((easy, hard)):
        assert n_iter[i] == 30 or float(s.shift[i]) < 1e-3
        one = TK.kmeans_fit(_t(m), 4, max_iter=30, tol=1e-3, seed=0)
        assert float(s.inertia[i]) <= one.inertia * 1.05 + 1e-6


def test_codebook_distortion_within_5pct_of_jax(rng):
    """The random streams differ, so the codebooks do: hold each
    package's own training to the distortion of its codes on the training
    data. 5% bounds a wrong fit (k-means++ seeds land within ~1% on
    blobby data)."""
    x = _clustered(rng)
    jcb = JPQ.train_pq_codebook(jnp.asarray(x), n_sub=8, ksub=32)
    tcb = TPQ.train_pq_codebook(_t(x), n_sub=8, ksub=32)
    assert tcb.shape == (8, 32, 4)
    jd = _distortion(lambda a: JPQ.pq_encode(jcb, jnp.asarray(a)),
                     lambda c: np.asarray(JPQ.pq_decode(jcb, c)), x)
    td = _distortion(lambda a: TPQ.pq_encode(tcb, _t(a)),
                     lambda c: TPQ.pq_decode(tcb, c).numpy(), x)
    assert abs(td - jd) <= 0.05 * jd, (td, jd)


def test_opq_rotation_orthogonal_and_distortion(rng):
    """R orthogonal to f32 rounding; OPQ's distortion within 5% of the JAX
    package's and no worse than 2% above plain PQ's."""
    x = _clustered(rng, n=1500, d=16, ncl=12)
    jR, jcb = JPQ.train_opq_rotation(jnp.asarray(x), n_sub=4, ksub=16,
                                     opq_iters=3)
    tR, tcb = TPQ.train_opq_rotation(_t(x), n_sub=4, ksub=16, opq_iters=3)
    assert tR.shape == (16, 16)
    np.testing.assert_allclose((tR @ tR.T).numpy(), np.eye(16), atol=1e-5)

    def opq_dist(R, cb, enc, dec):
        xr = x @ np.asarray(R)
        return float(((xr - dec(cb, enc(cb, xr))) ** 2).sum(1).mean())

    jd = opq_dist(jR, jcb, lambda c, a: JPQ.pq_encode(c, jnp.asarray(a)),
                  lambda c, k: np.asarray(JPQ.pq_decode(c, k)))
    td = opq_dist(tR, tcb, lambda c, a: TPQ.pq_encode(c, _t(a)),
                  lambda c, k: TPQ.pq_decode(c, k).numpy())
    pcb = TPQ.train_pq_codebook(_t(x), n_sub=4, ksub=16, iters=15)
    pd = _distortion(lambda a: TPQ.pq_encode(pcb, _t(a)),
                     lambda c: TPQ.pq_decode(pcb, c).numpy(), x)
    assert abs(td - jd) <= 0.05 * jd, (td, jd)
    assert td <= 1.02 * pd, (td, pd)


@pytest.fixture(scope="module")
def pq_pair(rng_mod):
    x = _clustered(rng_mod, n=3000, d=32)
    q = x[:40] + 0.05 * rng_mod.standard_normal((40, 32)).astype(np.float32)
    j = JPQ.PQIndex(x, n_sub=8, ksub=64, keep_originals=True, seed=0)
    arrays, meta = j._state()
    t = TPQ.PQIndex.from_state({k: np.array(v) for k, v in arrays.items()},
                               dict(meta, metric="l2", dim=32), device="cpu")
    return j, t, x, q


@pytest.mark.parametrize("rerank", [0, 4])
def test_pq_index_from_state_matches_jax(pq_pair, rerank):
    """Same codebooks and codes: the ADC scan agrees to f32 rounding (ids
    equal but for near-ties), the rerank on exact originals too."""
    j, t, _, q = pq_pair
    jd, ji = j.search(q, k=10, rerank=rerank)
    td, ti = t.search(q, k=10, rerank=rerank)
    assert (ti == ji).mean() >= 0.98
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-4,
                               atol=1e-4)


def test_pq_index_save_load_both_ways(pq_pair, tmp_path):
    j, t, _, q = pq_pair
    t.save(str(tmp_path / "t"))
    back = JPQ.PQIndex.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(back.search(q, k=5)[1], j.search(q, k=5)[1])
    j.save(str(tmp_path / "j"))
    again = TPQ.PQIndex.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(again.search(q, k=5, rerank=2)[1],
                                  t.search(q, k=5, rerank=2)[1])
    assert again.code_bytes == j.code_bytes == 3000 * 8


@pytest.mark.parametrize("opq", [False, True])
def test_pq_index_own_build_recall(pq_pair, opq):
    """The port's own build (its own k-means stream) reaches the JAX
    build's rerank recall within 0.05."""
    _, _, x, q = pq_pair
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    kw = dict(n_sub=8, ksub=32, keep_originals=True, seed=0, opq=opq)
    jr = recall(JPQ.PQIndex(x, **kw).search(q, k=10, rerank=8)[1])
    t = TPQ.PQIndex(x, device="cpu", **kw)
    tr = recall(t.search(q, k=10, rerank=8)[1])
    assert tr >= jr - 0.05, (tr, jr)
    assert (t.R is not None) == opq
    with pytest.raises(ValueError, match="keep_originals"):
        TPQ.PQIndex(x[:300], n_sub=8, ksub=16, device="cpu").search(q, rerank=2)
