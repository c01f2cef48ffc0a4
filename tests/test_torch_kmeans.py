"""k-means: the torch port against the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ml import kmeans as JK
from neurondb_tpu_torch.ml import kmeans as TK


def _clustered(rng, n=4096, d=32, k=128, spread=2.0):
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)


def test_assign_labels_match_jax(rng):
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    c = rng.standard_normal((64, 32)).astype(np.float32)
    jl, jd = JK._assign(jnp.asarray(x), jnp.asarray(c))
    tl, td = TK._assign(torch.from_numpy(x), torch.from_numpy(c))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # f32 expansion, sums in another order
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


def test_update_keeps_empty_cluster(rng):
    x = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
    labels = torch.zeros(100, dtype=torch.int32)
    labels[50:] = 2                                   # cluster 1 is empty
    old = torch.full((3, 8), 7.0)
    new = TK._update(x, labels, 3, old)
    np.testing.assert_allclose(new[0].numpy(), x[:50].mean(0).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(new[1], old[1])
    want = JK._update(jnp.asarray(x.numpy()), jnp.asarray(labels.numpy()), 3,
                      jnp.asarray(old.numpy()))
    np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_predict_chunked_matches_unchunked(rng):
    x = torch.from_numpy(_clustered(rng, n=3000))
    c = x[torch.randperm(3000, generator=torch.Generator().manual_seed(0))[:24]]
    whole = TK.kmeans_predict(c, x, chunk=1 << 20)
    parts = TK.kmeans_predict(c, x, chunk=700)
    assert torch.equal(whole, parts)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(JK.kmeans_predict(jnp.asarray(c.numpy()),
                                                    jnp.asarray(x.numpy()))))


def test_fit_inertia_within_5pct_of_jax(rng):
    """The random streams differ, so the fits differ. On 128 overlapping
    blobs fitted with k=16 the landscape has no lonely cluster for one
    seed to miss (measured: the two packages within 0.7% over six data
    seeds), so 5% bounds a wrong fit, not bad luck."""
    x = _clustered(rng)
    js = JK.kmeans_fit(jnp.asarray(x), 16, max_iter=50, tol=1e-3, seed=0)
    ts = TK.kmeans_fit(torch.from_numpy(x), 16, max_iter=50, tol=1e-3, seed=0)
    ji = float(js.inertia)
    assert abs(ts.inertia - ji) <= 0.05 * ji, (ts.inertia, ji)
    assert 1 <= ts.n_iter <= 50
    # the stopping rule: a converged fit stopped on the shift test
    assert ts.n_iter == 50 or ts.shift < 1e-3


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_fit_is_seeded(rng, init):
    x = torch.from_numpy(_clustered(rng, n=1000))
    a = TK.kmeans_fit(x, 8, seed=3, init=init)
    b = TK.kmeans_fit(x, 8, seed=3, init=init)
    assert torch.equal(a.centroids, b.centroids)


def test_plusplus_with_duplicate_points():
    """Fewer distinct points than k: the D^2 weights are all zero and the
    draw falls back to uniform instead of failing."""
    x = torch.ones((10, 4))
    c = TK.kmeans_plusplus_init(x, 4, torch.Generator().manual_seed(0))
    assert torch.equal(c, torch.ones((4, 4)))
