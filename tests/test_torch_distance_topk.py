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
    # l1 (ported in the quantized / hybrid slice) now equals JAX's
    a = np.arange(8, dtype=np.float32).reshape(2, 4)
    b = np.arange(12, dtype=np.float32).reshape(3, 4) / 3
    np.testing.assert_array_equal(
        TD.pairwise_distance(torch.from_numpy(a), torch.from_numpy(b),
                             "<+>").numpy(),
        np.asarray(JD.pairwise_distance(jnp.asarray(a), jnp.asarray(b),
                                        "<+>")))


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


# ---- the metrics past the GEMM four, and the tie rule ----

EXACT_METRICS = ("hamming", "jaccard", "dice")   # integer counts: exact
BROADCAST_RTOL = 1e-6                             # l1 / chebyshev / minkowski


@pytest.mark.parametrize("metric", ["l1", "chebyshev", "minkowski",
                                    "hamming", "jaccard", "dice"])
@pytest.mark.parametrize("data", ["gaussian", "integer"])
def test_other_metrics_match_jax(rng, metric, data):
    q, x = _data(rng, b=20, n=150, d=33)
    if data == "integer":       # ties and exact mismatches
        q, x = np.round(q), np.round(x)
    want = np.asarray(JD.pairwise_distance(jnp.asarray(q), jnp.asarray(x),
                                           metric))
    got = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                               metric).numpy()
    assert got.dtype == want.dtype
    if metric in EXACT_METRICS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=BROADCAST_RTOL)


def test_hamming_on_packed_codes_and_blocks(rng, monkeypatch):
    qc = rng.integers(0, 256, (9, 40)).astype(np.uint8)   # 320 bits: 2 slabs
    xc = rng.integers(0, 256, (70, 40)).astype(np.uint8)
    want = np.asarray(JD.pairwise_distance(jnp.asarray(qc), jnp.asarray(xc),
                                           "hamming"))
    got = TD.pairwise_distance(torch.from_numpy(qc), torch.from_numpy(xc),
                               "hamming")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TD.hamming_distance(torch.from_numpy(qc[:, None]),
                            torch.from_numpy(xc[None])).numpy(), want)
    # the broadcast metrics in blocks far smaller than [B, N, D]
    q, x = _data(rng, b=7, n=50, d=5)
    whole = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "l1")
    monkeypatch.setattr(TD, "BROADCAST_ELEMS", 12)
    part = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "l1")
    np.testing.assert_array_equal(part.numpy(), whole.numpy())


def test_pair_forms_match_jax(rng):
    x = rng.standard_normal((6, 17)).astype(np.float32)
    y = rng.standard_normal((6, 17)).astype(np.float32)
    y[0] = x[0]
    tx, ty, jx, jy = (torch.from_numpy(x), torch.from_numpy(y),
                      jnp.asarray(x), jnp.asarray(y))
    for name in ("l2_distance", "squared_l2_distance", "cosine_distance",
                 "inner_product_distance", "l1_distance", "hamming_distance",
                 "chebyshev_distance", "minkowski_distance",
                 "jaccard_distance", "dice_distance"):
        np.testing.assert_allclose(getattr(TD, name)(tx, ty).numpy(),
                                   np.asarray(getattr(JD, name)(jx, jy)),
                                   rtol=BROADCAST_RTOL, atol=1e-6,
                                   err_msg=name)
    vi = np.eye(17, dtype=np.float32) * 2
    np.testing.assert_allclose(
        TD.mahalanobis_distance(tx, ty, torch.from_numpy(vi)).numpy(),
        np.asarray(JD.mahalanobis_distance(jx, jy, jnp.asarray(vi))),
        rtol=1e-5)
    with pytest.raises(ValueError, match="p must be > 0"):
        TD.minkowski_distance(tx, ty, p=0)


@pytest.mark.parametrize("k", [1, 10, 50, 700])
def test_topk_ties_go_to_the_lowest_index(rng, k):
    """lax.top_k's rule on integer rows, ties at and across the k-th
    value: torch.topk alone returns another order."""
    s = rng.integers(0, 4, (6, 3000 if k != 50 else 6000)).astype(np.float32)
    s[0, :] = 1.0                                  # one value everywhere
    jv, ji = JT.topk_smallest(jnp.asarray(s), k)
    tv, ti = TT.topk_smallest(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = TT.topk_largest(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# the sort, two-pass and grouped ways
@pytest.mark.parametrize("n", [300, 5000, 20000])
def test_signed_zeros_are_one_value(n):
    """A recorded divergence: -0.0 and 0.0 tie (index order), where
    lax.top_k orders -0.0 first."""
    s = np.zeros((2, n), np.float32)
    s[:, ::3] = -0.0
    s[1, 1::4] = -1.0
    v, i = TT.topk_smallest(torch.from_numpy(s), 40)
    want = np.argsort(s + 0.0, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(s, want, 1))


def test_chunked_knn_over_duplicate_rows_matches_jax(rng):
    base = rng.standard_normal((40, 8)).astype(np.float32)
    x = np.concatenate([base] * 25)               # every row 25 times
    q = base[:12] + 0.01
    for metric in ("l2", "ip"):
        jv, ji = JT.chunked_knn(jnp.asarray(q), jnp.asarray(x), 30,
                                metric=metric, chunk=128)
        tv, ti = TT.chunked_knn(torch.from_numpy(q), torch.from_numpy(x), 30,
                                metric=metric, chunk=128)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if metric == "l2":   # d^2 within 1e-5 of the expansion's terms
            terms = (q ** 2).sum(1).max() + (x ** 2).sum(1).max()
            np.testing.assert_allclose(tv.numpy() ** 2, np.asarray(jv) ** 2,
                                       rtol=RTOL, atol=RTOL * terms)
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                                       atol=ATOL)
    xi = np.round(rng.standard_normal((500, 6))).astype(np.float32)
    jv, ji = JT.chunked_knn(jnp.asarray(xi[:9]), jnp.asarray(xi), 12,
                            metric="hamming", chunk=64)
    tv, ti = TT.chunked_knn(torch.from_numpy(xi[:9]), torch.from_numpy(xi),
                            12, metric="hamming", chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
