"""Distances, top-k and the chunked exact scan: the torch port against
the JAX package on the same numpy inputs (CPU, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops import distance as JD
from neurondb_tpu.ops import topk as JT
from neurondb_tpu_torch.ops import distance as TD
from neurondb_tpu_torch.ops import topk as TT

# f32 on both sides; the sums run in another order, so distances agree to
# a few ulps of the operands: rtol 1e-5 (atol 1e-5 for values near 0,
# e.g. ip and cosine)
RTOL = ATOL = 1e-5


def _data(rng, b=24, n=300, d=32):
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cosine"])
@pytest.mark.parametrize("variant", ["plain", "sqnorms", "bf16"])
def test_pairwise_distance_matches_jax(rng, metric, variant):
    q, x = _data(rng)
    sq = (x * x).sum(1) if variant == "sqnorms" else None
    want = JD.pairwise_distance(
        jnp.asarray(q), jnp.asarray(x), metric,
        base_sqnorms=None if sq is None else jnp.asarray(sq),
        dot_dtype=jnp.bfloat16 if variant == "bf16" else None)
    got = TD.pairwise_distance(
        torch.from_numpy(q), torch.from_numpy(x), metric,
        base_sqnorms=None if sq is None else torch.from_numpy(sq),
        dot_dtype=torch.bfloat16 if variant == "bf16" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_metric_names():
    assert TD.canonical_metric("<->") == JD.canonical_metric("<->") == "l2"
    assert TD.canonical_metric("<#>") == "ip"
    with pytest.raises(ValueError, match="unknown distance metric"):
        TD.canonical_metric("euclidean3000")
    with pytest.raises(NotImplementedError, match="item 14"):
        TD.pairwise_distance(torch.zeros(2, 4), torch.zeros(3, 4), "l1")


def test_topk_smallest_matches_jax(rng):
    s = rng.standard_normal((16, 500)).astype(np.float32)
    jv, ji = JT.topk_smallest(jnp.asarray(s), 17)
    tv, ti = TT.topk_smallest(torch.from_numpy(s), 17)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # k past the width clamps, recall_target < 1 is served exactly
    tv, _ = TT.topk_smallest(torch.from_numpy(s[:, :5]), 9,
                             recall_target=0.9)
    np.testing.assert_array_equal(tv.numpy(), np.sort(s[:, :5], axis=1))


def test_merge_topk_ties_go_to_a():
    va = np.array([[1.0, 2.0, 3.0], [0.5, 0.5, 4.0]], np.float32)
    vb = np.array([[1.0, 2.0, 2.0], [0.5, 1.0, 4.0]], np.float32)
    ia = np.array([[10, 11, 12], [13, 14, 15]], np.int32)
    ib = np.array([[20, 21, 22], [23, 24, 25]], np.int32)
    tv, ti = TT.merge_topk(*(torch.from_numpy(a) for a in (va, ia, vb, ib)),
                           5)
    jv, ji = JT.merge_topk(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 5)
    np.testing.assert_array_equal(ti.numpy(), [[10, 20, 11, 21, 22],
                                               [13, 14, 23, 24, 15]])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("variant", ["plain", "ids_valid", "bf16"])
def test_chunked_knn_matches_jax(rng, metric, variant):
    q, x = _data(rng, b=16, n=1000)
    kw_j, kw_t = {}, {}
    if variant == "ids_valid":
        ids = rng.permutation(5000)[:1000].astype(np.int32)
        valid = rng.random(1000) > 0.3
        sq = (x * x).sum(1)
        kw_j = dict(ids=jnp.asarray(ids), valid=jnp.asarray(valid),
                    base_sqnorms=jnp.asarray(sq))
        kw_t = dict(ids=torch.from_numpy(ids), valid=torch.from_numpy(valid),
                    base_sqnorms=torch.from_numpy(sq))
    elif variant == "bf16":
        kw_j = dict(dot_dtype=jnp.bfloat16)
        kw_t = dict(dot_dtype=torch.bfloat16)
    jv, ji = JT.chunked_knn(jnp.asarray(q), jnp.asarray(x), 10, metric=metric,
                            chunk=256, **kw_j)
    tv, ti = TT.chunked_knn(torch.from_numpy(q), torch.from_numpy(x), 10,
                            metric=metric, chunk=256, **kw_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    if variant == "ids_valid":
        assert np.isin(ti.numpy(), ids[valid]).all()


def test_chunked_knn_k_past_rows_pads():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    v, i = TT.chunked_knn(x[:1], x, 10, metric="sqeuclidean", chunk=2)
    assert v.shape == (1, 3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2]])
