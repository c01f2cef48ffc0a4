"""The port's rerankers against the JAX package's, and the rerank slice
as a whole: carried cross-encoder parameters, one query, the same order."""

import numpy as np
import pytest

import jax

from neurondb_tpu.ml import transformer as JT
from neurondb_tpu.search import rerank as JR
from neurondb_tpu_torch.ml import transformer as TT
from neurondb_tpu_torch.ml.params import params_from_jax
from neurondb_tpu_torch.search import rerank as TR

DOCS = ["the quick brown fox jumps over the lazy dog",
        "postgres is a relational database system",
        "vector search finds nearest neighbors quickly",
        "the fox is quick and brown",
        "accelerators run matrix multiplications",
        "databases store structured data in tables"]


def _overlap(q, docs):
    return np.array([float(len(set(q.split()) & set(d.split())))
                     for d in docs])


def _same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype


@pytest.mark.parametrize("fn", ["rerank_cross_encoder", "rerank_flash"])
@pytest.mark.parametrize("k", [None, 2, 10])
def test_cross_encoder_api_matches_jax(fn, k):
    _same(getattr(TR, fn)("quick fox", DOCS, _overlap, k=k),
          getattr(JR, fn)("quick fox", DOCS, _overlap, k=k))


@pytest.mark.parametrize("k", [None, 2])
def test_colbert_matches_jax(k):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    docs = [rng.standard_normal((n, 16)).astype(np.float32)
            for n in (3, 9, 1, 7)]
    docs.append(np.zeros((2, 16), np.float32))       # the 1e-30 floor
    _same(TR.rerank_colbert(q, docs, k=k), JR.rerank_colbert(q, docs, k=k))


def test_ltr_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.standard_normal((30, 4)).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    _same(TR.rerank_ltr(f, w, k=7), JR.rerank_ltr(f, w, k=7))
    f[3] = f[4]                                    # a tie keeps its order
    _same(TR.rerank_ltr(f, w), JR.rerank_ltr(f, w))


@pytest.mark.parametrize("method", ["weighted", "borda"])
@pytest.mark.parametrize("weights", [None, [2.0, 0.5, 1.0]])
def test_ensemble_matches_jax(method, weights):
    r1 = (np.array([0.9, 0.5, 0.5]), np.array([10, 20, 40]))
    r2 = (np.array([0.8, 0.7]), np.array([20, 30]))
    r3 = (np.array([1.0, 1.0]), np.array([30, 50]))   # flat scores
    for k in (None, 3):
        _same(TR.rerank_ensemble([r1, r2, r3], weights, k, method=method),
              JR.rerank_ensemble([r1, r2, r3], weights, k, method=method))


def test_llm_matches_jax():
    class Client:
        def rerank(self, query, docs):
            return [len(d) % 7 for d in docs]
    _same(TR.rerank_llm("q", DOCS, Client(), k=4),
          JR.rerank_llm("q", DOCS, Client(), k=4))


def test_rerank_slice_matches_jax():
    """The slice end to end on the CPU: the same cross-encoder parameters
    in both packages rank the same candidates in the same order."""
    jp = JT.init_encoder_params(jax.random.PRNGKey(4), hidden=64, layers=2,
                                heads=4, ff=128)
    j = JT.CrossEncoder(jp, heads=4, max_len=32, batch=4, use_flash=False)
    t = TT.CrossEncoder(params_from_jax(jp), heads=4, max_len=32, batch=4,
                        device="cpu")
    docs = DOCS + [d + " again" for d in DOCS]
    js, jo = JR.rerank_cross_encoder("quick brown fox", docs, j, k=5)
    ts, to = TR.rerank_cross_encoder("quick brown fox", docs, t, k=5)
    np.testing.assert_allclose(ts, js, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(to, jo)
