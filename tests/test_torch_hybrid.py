"""Hybrid search: the torch port against the JAX package on the same
numpy inputs (CPU). The corpus is ``bench.py``'s synthetic hybrid text,
where thousands of documents tie on a ``topic{j}`` term's score, with
sparse external ids; both sides search an f32 ``FlatIndex`` so their ANN
inputs are identical, and fusion ties decide the results."""

import numpy as np
import pytest

from neurondb_tpu.index.flat import FlatIndex as JFlat
from neurondb_tpu.search import bm25 as JB
from neurondb_tpu.search import hybrid as JH
from neurondb_tpu_torch.index.flat import FlatIndex as TFlat
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.search import bm25 as TB
from neurondb_tpu_torch.search import hybrid as TH

N, DIM, NQ = 3000, 16, 24
SCORE_TOL = 1e-5       # f32 fusion on both sides, sums in another order
# l2 distances come from the f32 expansion |q|^2 + |x|^2 - 2 q.x on both
# sides: compare d^2 within 1e-5 of those terms (~2 DIM here)
TERMS_TOL = 1e-5 * 2 * DIM


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    ext = np.arange(N, dtype=np.int64) * 7 + 3
    docs = [f"topic{i % 64} item {i} cluster word{i % 64}" for i in range(N)]
    qis = rng.integers(0, N, NQ)
    q = x[qis] + 0.01 * rng.standard_normal((NQ, DIM)).astype(np.float32)
    texts = [f"topic{qi % 64} item {qi}" for qi in qis]
    return x, ext, docs, q, texts


@pytest.fixture(scope="module")
def both(corpus):
    x, ext, docs, _, _ = corpus
    return (JFlat(x, ids=ext), JB.BM25Index(docs, ids=ext),
            TFlat(x, ids=ext, device="cpu"),
            TB.BM25Index(docs, ids=ext, device="cpu"))


@pytest.mark.parametrize("device", [False, True])
def test_batch_matches_jax_on_the_same_path(corpus, both, device):
    _, _, _, q, texts = corpus
    jidx, jbm, tidx, tbm = both
    js, ji = JH.hybrid_search_batch(jidx, jbm, q, texts, k=10, device=device)
    ts, ti = TH.hybrid_search_batch(tidx, tbm, q, texts, k=10, device=device)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_device_fusion_matches_host_fusion(corpus, both):
    """The rule of the JAX package's own test: the same sets, sorted
    scores within 1e-4."""
    _, _, _, q, texts = corpus
    _, _, tidx, tbm = both
    s_h, i_h = TH.hybrid_search_batch(tidx, tbm, q, texts, k=8, device=False)
    s_d, i_d = TH.hybrid_search_batch(tidx, tbm, q, texts, k=8, device=True)
    for b in range(len(q)):
        assert set(i_d[b]) == set(i_h[b]), (b, i_d[b], i_h[b])
    np.testing.assert_allclose(np.sort(s_d, axis=1), np.sort(s_h, axis=1),
                               rtol=1e-4, atol=1e-4)


def test_single_query_matches_jax(corpus, both):
    _, _, _, q, texts = corpus
    jidx, jbm, tidx, tbm = both
    for b in range(4):
        js, ji = JH.hybrid_search(jidx, jbm, q[b], texts[b], k=10)
        ts, ti = TH.hybrid_search(tidx, tbm, q[b], texts[b], k=10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=SCORE_TOL, atol=SCORE_TOL)
    ts, ti = TH.hybrid_search(tidx, tbm, q[0], texts[0], k=10,
                              filter_fn=lambda i: i % 2 == 1)
    assert (ti % 2 == 1).all()


def test_single_query_device_path_matches_its_host_path(corpus, both):
    """``hybrid_search(device=True)`` (the default for a BM25 index on the
    card) fuses as ``hybrid_search_batch`` does on the device: the host
    path's set and sorted scores within 1e-4; a ``filter_fn`` keeps the
    host fusion over the device's text scores."""
    _, _, _, q, texts = corpus
    _, _, tidx, tbm = both
    for b in range(6):
        s_h, i_h = TH.hybrid_search(tidx, tbm, q[b], texts[b], k=10,
                                    device=False)
        s_d, i_d = TH.hybrid_search(tidx, tbm, q[b], texts[b], k=10,
                                    device=True)
        assert set(i_d) == set(i_h), (b, i_d, i_h)
        np.testing.assert_allclose(np.sort(s_d), np.sort(s_h), rtol=1e-4,
                                   atol=1e-4)
    odd = lambda i: i % 2 == 1      # noqa: E731
    s_f, i_f = TH.hybrid_search(tidx, tbm, q[0], texts[0], k=10,
                                filter_fn=odd, device=True)
    s_g, i_g = TH.hybrid_search(tidx, tbm, q[0], texts[0], k=10,
                                filter_fn=odd, device=False)
    np.testing.assert_array_equal(i_f, i_g)
    np.testing.assert_array_equal(s_f, s_g)


def test_hybrid_searcher_matches_batch_across_sub_batches(corpus):
    x, ext, docs, q, texts = corpus
    idx = TIVF(x, nlists=8, ids=ext, device="cpu")
    bm = TB.BM25Index(docs, ids=ext, device="cpu")
    searcher = TH.HybridSearcher(idx, bm, candidates=64, approx=True)
    s_p, i_p = searcher.search_batch(q, texts, k=8, batch=10, nprobe=8)
    s_b, i_b = TH.hybrid_search_batch(idx, bm, q, texts, k=8, candidates=64,
                                      nprobe=8)
    assert i_p.shape == (NQ, 8)
    for b in range(NQ):
        assert set(i_p[b]) == set(i_b[b]), (b, i_p[b], i_b[b])
    np.testing.assert_allclose(np.sort(s_p, axis=1), np.sort(s_b, axis=1),
                               rtol=1e-4, atol=1e-4)
    assert searcher.default_batch() == 2048


def test_rrf_and_semantic_keyword_match_jax(corpus, both):
    _, _, _, q, texts = corpus
    jidx, jbm, tidx, tbm = both
    rng = np.random.default_rng(5)
    ranks = [rng.permutation(50)[:20], rng.permutation(50)[:30], [-1, 3, 7]]
    for got, want in zip(TH.reciprocal_rank_fusion(ranks, k=12),
                         JH.reciprocal_rank_fusion(ranks, k=12)):
        np.testing.assert_array_equal(got, want)
    for b in range(3):
        got = TH.semantic_keyword_search(tidx, tbm, q[b], texts[b], k=10)
        want = JH.semantic_keyword_search(jidx, jbm, q[b], texts[b], k=10)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_mmr_matches_jax(metric):
    rng = np.random.default_rng(8)
    cand = rng.standard_normal((40, 12)).astype(np.float32)
    qv = rng.standard_normal(12).astype(np.float32)
    ids = np.arange(40) * 5
    ts, ti = TH.mmr_diverse_search(qv, cand, ids, k=9, lambda_=0.6,
                                   metric=metric, device="cpu")
    js, ji = JH.mmr_diverse_search(qv, cand, ids, k=9, lambda_=0.6,
                                   metric=metric)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_temporal_faceted_multi_vector_match_jax(corpus, both):
    x, ext, _, q, _ = corpus
    jidx, _, tidx, _ = both
    stamps = np.zeros(int(ext.max()) + 1)
    stamps[ext] = 1.7e9 - (np.arange(N) % 97) * 86400.0
    got = TH.temporal_vector_search(tidx, q[0], stamps, k=10, now=1.7e9)
    want = JH.temporal_vector_search(jidx, q[0], stamps, k=10, now=1.7e9)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    facets = {int(i): {"color": ("red", "blue")[r % 2], "n": r % 3}
              for r, i in enumerate(ext)}
    got = TH.faceted_vector_search(tidx, q[1], facets, {"color": "red"}, k=5)
    want = JH.faceted_vector_search(jidx, q[1], facets, {"color": "red"},
                                    k=5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0] ** 2, want[0] ** 2, rtol=1e-5,
                               atol=TERMS_TOL)
    for agg in ("min", "mean"):
        got = TH.multi_vector_search(tidx, q[:3], k=10, agg=agg)
        want = JH.multi_vector_search(jidx, q[:3], k=10, agg=agg)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0] ** 2, want[0] ** 2, rtol=1e-5,
                                   atol=TERMS_TOL)
