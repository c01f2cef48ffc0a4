"""BM25: the torch port against the JAX package on the same corpora
(CPU): both builds' vocabularies and postings, the host oracle, and the
batch scorer, which must equal the port's own oracle bit for bit."""

import numpy as np
import pytest
import torch

from neurondb_tpu import native
from neurondb_tpu.search import bm25 as JB
from neurondb_tpu_torch import configure
from neurondb_tpu_torch.search import bm25 as TB

# the port's batch scores vs the JAX package's tiled device scorer: f32
# GEMMs there, one add per term here (the tolerance of the JAX tests)
TILED_RTOL = TILED_ATOL = 1e-5
ODD = ["Ünïcödé", "naïve", "日本語テキスト", "x" * 60, "ABC" * 20,
       "İstanbul", "straße", "a1b2", "Hello,World!foo_bar-baz"]


def _docs(rng, n, vocab, lo=5, hi=30):
    return [" ".join(rng.choice(vocab, rng.integers(lo, hi))) for _ in range(n)]


@pytest.fixture(scope="module")
def python_pair():
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(200)] + ["running", "databases", "the"]
    docs = _docs(rng, 3000, vocab)
    return (JB.BM25Index(docs, use_native=False),
            TB.BM25Index(docs, use_native=False, device="cpu"), vocab)


@pytest.fixture(scope="module")
def hashed_pair():
    rng = np.random.default_rng(4)
    vocab = [f"term{i}" for i in range(500)] + ODD
    docs = _docs(rng, 6000, vocab, 0, 40)   # above NATIVE_THRESHOLD
    docs[3], docs[5], docs[9] = "", "   ", "lone \ud800 surrogate"
    return JB.BM25Index(docs), TB.BM25Index(docs, device="cpu"), vocab


def _same_index(j, t):
    for name in ("df", "idf", "doc_len", "_offsets", "_post_doc", "_post_tf"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert j.avg_len == t.avg_len


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  np.asarray(b).view(np.int32))


def test_python_build_matches_jax(python_pair):
    j, t, _ = python_pair
    assert t._hash_vocab is None and j._vocab == t._vocab
    _same_index(j, t)


def test_hashed_build_matches_jax(hashed_pair):
    assert native.available()      # the JAX side took its native route
    j, t, _ = hashed_pair
    assert t._hash_vocab == j._hash_vocab
    _same_index(j, t)
    assert set(t.build_seconds) == {"tokenize", "postings"}


def test_tokenize_corpus_matches_native(hashed_pair):
    docs = ["", "A", "x" * 47 + "Y" * 3, " ".join(ODD), "\ud800abc", "9 9"]
    d_t, h_t = TB.tokenize_corpus(docs)
    d_n, h_n = native.tokenize_corpus(docs)
    np.testing.assert_array_equal(d_t, d_n)
    np.testing.assert_array_equal(h_t, h_n)
    assert TB.fnv1a(b"9") == native._fnv1a(b"9") == int(h_t[-1])
    d_e, h_e = TB.tokenize_corpus([])
    assert len(d_e) == len(h_e) == 0


@pytest.mark.parametrize("build", ["python", "hashed"])
def test_scores_and_search_match_jax(python_pair, hashed_pair, build):
    j, t, vocab = python_pair if build == "python" else hashed_pair
    rng = np.random.default_rng(9)
    queries = [" ".join(rng.choice(vocab, 4)) for _ in range(12)]
    queries += ["", "nothing matches", f"{vocab[0]} {vocab[0]} {vocab[5]}",
                "NAÏVE Straße İstanbul running"]
    for q in queries:
        _bits_equal(t.scores(q), j.scores(q))
        js, ji = j.search(q, k=7)
        ts, ti = t.search(q, k=7)
        np.testing.assert_array_equal(ti, ji)
        _bits_equal(ts, js)


@pytest.mark.parametrize("build", ["python", "hashed"])
def test_search_on_the_device_path_matches_the_host_search(python_pair,
                                                           hashed_pair,
                                                           build):
    """``search(device=True)`` (the default for an index on the card):
    the host search's scores bit for bit, each id carrying its own
    oracle score, and the lowest row first among equal scores."""
    _, t, vocab = python_pair if build == "python" else hashed_pair
    rng = np.random.default_rng(14)
    queries = [" ".join(rng.choice(vocab, 3)) for _ in range(10)]
    queries += ["", f"{vocab[1]} {vocab[1]}"]
    for q in queries:
        hs, _ = t.search(q, k=9, device=False)
        ds, di = t.search(q, k=9, device=True)
        _bits_equal(ds, hs)
        _bits_equal(ds, t.scores(q)[di])
        for a, b, sa, sb in zip(di, di[1:], ds, ds[1:]):
            assert sa > sb or a < b, (q, di, ds)


@pytest.mark.parametrize("build", ["python", "hashed"])
def test_scores_batch_equals_host_oracle_bitwise(python_pair, hashed_pair,
                                                 build):
    j, t, vocab = python_pair if build == "python" else hashed_pair
    rng = np.random.default_rng(10)
    queries = [" ".join(rng.choice(vocab, 4)) for _ in range(17)]
    rep = f"{vocab[0]} {vocab[0]} {vocab[5]}"          # repeated term
    queries += [rep, "", "   "]
    got = t.scores_batch(queries, device=True)
    assert got.dtype == np.float32 and got.shape == (len(queries), t.n_docs)
    _bits_equal(got, np.stack([t.scores(q) for q in queries]))
    on_dev = t.scores_batch(queries, device=True, return_device=True)
    assert isinstance(on_dev, torch.Tensor) and on_dev.device == t.device
    _bits_equal(on_dev.numpy(), got)
    # within the JAX tiled scorer's tolerance (no term past union_cap)
    want = j.scores_batch(queries, device=True)
    np.testing.assert_allclose(got, want, rtol=TILED_RTOL, atol=TILED_ATOL)


def test_term_cap_keeps_the_highest_idf_terms_in_query_order(python_pair):
    _, t, vocab = python_pair
    rng = np.random.default_rng(12)
    long_q = " ".join(rng.choice(vocab[:200], 90))
    terms = t._query_terms(long_q)
    assert len(terms) > t.term_cap
    kept = t.capped_terms(long_q)
    assert len(kept) == t.term_cap
    cut = sorted((float(t.idf[x]) for x in terms), reverse=True)[t.term_cap - 1]
    assert all(float(t.idf[x]) >= cut for x in kept)
    inv = {i: w for w, i in t._vocab.items()}
    same = " ".join(inv[x] for x in kept)                  # oracle's order
    assert t._query_terms(same) == kept
    got = t.scores_batch([long_q, "w1"], device=True)
    _bits_equal(got[0], t.scores(same))
    _bits_equal(got[1], t.scores("w1"))


def test_sub_batches_keep_the_scores(python_pair):
    _, t, vocab = python_pair
    rng = np.random.default_rng(13)
    queries = [" ".join(rng.choice(vocab, 3)) for _ in range(23)]
    whole = t.scores_batch(queries, device=True)
    old = t.score_budget_bytes
    t.score_budget_bytes = t.n_docs * 4 * 8        # 8 queries a sub-batch
    try:
        _bits_equal(t.scores_batch(queries, device=True), whole)
        t.score_budget_bytes = 1                       # floor: one query
        _bits_equal(t.scores_batch(queries[:5], device=True), whole[:5])
    finally:
        t.score_budget_bytes = old
    host = t.scores_batch(queries[:3], device=False, return_device=True)
    assert isinstance(host, torch.Tensor)
    _bits_equal(host.numpy(), whole[:3])


def test_only_the_exact_scorer_is_served(python_pair):
    _, t, _ = python_pair
    configure(bm25_scorer="scatter")
    try:
        with pytest.raises(ValueError, match="item 10"):
            t.scores_batch(["w1", "w2"], device=True)
    finally:
        configure(bm25_scorer="tiled")
