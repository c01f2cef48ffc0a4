"""Sparse vectors, sparse retrieval, the query planner and the client:
the torch port against the JAX package on the same inputs (CPU)."""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest

from neurondb_tpu.client import Client as JClient
from neurondb_tpu.index.flat import FlatIndex as JFlat
from neurondb_tpu.search import bm25 as JB
from neurondb_tpu.search import planner as JP
from neurondb_tpu.search import sparse_search as JSS
from neurondb_tpu.types import sparse as JS
from neurondb_tpu_torch.client import Client
from neurondb_tpu_torch.index.flat import FlatIndex as TFlat
from neurondb_tpu_torch.search import bm25 as TB
from neurondb_tpu_torch.search import planner as TP
from neurondb_tpu_torch.search import sparse_search as TSS
from neurondb_tpu_torch.types import sparse as TS

RTOL = ATOL = 1e-5     # f32 sums in another order


def _sparse_dense(rng, n, d, density=0.2):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return np.where(rng.random((n, d)) < density, x, 0.0).astype(np.float32)


def test_sparse_vectors_ops_match_jax(rng):
    a = _sparse_dense(rng, 12, 30)
    b = _sparse_dense(rng, 12, 30)
    a[3] = 0.0                                    # an empty row
    ja, jb = JS.SparseVectors.from_dense(a), JS.SparseVectors.from_dense(b)
    ta = TS.SparseVectors.from_dense(a, device="cpu")
    tb = TS.SparseVectors.from_dense(b, device="cpu")
    np.testing.assert_array_equal(ta.indices.numpy(), np.asarray(ja.indices))
    np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ja.values))
    np.testing.assert_array_equal(ta.nnz.numpy(), np.asarray(ja.nnz))
    np.testing.assert_array_equal(ta.to_dense().numpy(), a)
    np.testing.assert_allclose(ta.norm().numpy(), np.asarray(ja.norm()),
                               rtol=RTOL)
    np.testing.assert_allclose(ta.normalize().values.numpy(),
                               np.asarray(ja.normalize().values), rtol=RTOL)
    for name in ("sparse_inner_product", "sparse_l2_distance",
                 "sparse_cosine_distance"):
        np.testing.assert_allclose(getattr(TS, name)(ta, tb).numpy(),
                                   np.asarray(getattr(JS, name)(ja, jb)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    dense = rng.standard_normal((30, 5)).astype(np.float32)
    import torch
    np.testing.assert_allclose(
        TS.sparse_dense_matmul(ta, torch.from_numpy(dense)).numpy(),
        np.asarray(JS.sparse_dense_matmul(ja, jnp.asarray(dense))),
        rtol=RTOL, atol=ATOL)
    idx = [[0, 4, -1], [2, 2, 7]]                  # a pad and a repeat
    val = [[1.0, 2.0, 9.0], [0.5, 0.25, 3.0]]
    tc = TS.SparseVectors.from_coo(idx, val, 8, device="cpu")
    jc = JS.SparseVectors.from_coo(idx, val, 8)
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.to_dense().numpy(),
                                  np.asarray(jc.to_dense()))
    assert tuple(TS.SparseVectors.from_coo([1, 3], [2.0, 1.0], 5,
                                           device="cpu").indices.shape) == (1, 2)


def test_sparse_retrieval_and_fusion_match_jax(rng):
    docs = _sparse_dense(rng, 400, 50, density=0.1)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    ext = np.arange(400) * 2 + 5
    jsi = JSS.SparseInvertedIndex(JS.SparseVectors.from_dense(docs), ids=ext)
    tsi = TSS.SparseInvertedIndex(
        TS.SparseVectors.from_dense(docs, device="cpu"), ids=ext)
    jflat, tflat = JFlat(x, ids=ext), TFlat(x, ids=ext, device="cpu")
    for i in range(3):
        qs = docs[i] + np.where(docs[i + 1] != 0, 0.5, 0.0).astype(np.float32)
        jq = JS.SparseVectors.from_dense(qs)
        tq = TS.SparseVectors.from_dense(qs, device="cpu")
        np.testing.assert_array_equal(
            tsi.scores(tq.indices[0], tq.values[0]),
            jsi.scores(np.asarray(jq.indices)[0], np.asarray(jq.values)[0]))
        for got, want in zip(tsi.search(tq, k=7), jsi.search(jq, k=7)):
            np.testing.assert_array_equal(got, want)
        for method in ("weighted", "rrf"):
            got = TSS.dense_sparse_fusion(tflat, tsi, x[i], tq, k=8,
                                          candidates=30, method=method)
            want = JSS.dense_sparse_fusion(jflat, jsi, x[i], jq, k=8,
                                           candidates=30, method=method)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)


def test_planner_matches_jax_over_one_sequence():
    docs = [f"doc number {i} about topic{i % 7} rare{i}" for i in range(300)]
    jbm, tbm = JB.BM25Index(docs), TB.BM25Index(docs, device="cpu")
    jp = JP.QueryPlanner(latency_slo_ms=20.0)
    tp = TP.QueryPlanner(latency_slo_ms=20.0)
    steps = [("topic3", False, 10, 5.0, False),
             (None, True, 10, 50.0, False),
             ("rare17 rare200", True, 5, 80.0, False),
             ("doc number about", True, 10, 1.0, True),
             ("topic1 rare9 doc", True, 200, 30.0, True),
             ("rare17 rare200", True, 5, 10.0, True),
             ("", True, 50, 90.0, False)]
    for text, vec, k, lat, short in steps * 3:
        want = jp.plan(text=text, has_vector=vec, k=k, bm25=jbm)
        got = tp.plan(text=text, has_vector=vec, k=k, bm25=tbm)
        assert asdict(got) == asdict(want)
        jp.observe(want, latency_ms=lat, shortfall=short)
        tp.observe(got, latency_ms=lat, shortfall=short)
    assert tp.stats() == jp.stats()
    assert TP.QueryPlanner.fingerprint("a b c", True, 7) == \
        JP.QueryPlanner.fingerprint("a b c", True, 7)
    assert tp._text_selectivity("topic3", None) == 0.5


def test_planned_search_end_to_end(rng):
    c = Client(device="cpu")
    col = c.create_collection("pl", 8)
    x = rng.standard_normal((500, 8)).astype(np.float32)
    docs = [f"doc number {i} about topic{i % 7}" for i in range(500)]
    col.add(x, documents=docs)
    p = TP.QueryPlanner()
    out = TP.planned_search(col, p, vector=x[3], k=5)
    assert out["plan"].mode == "ann"
    assert out["results"][0]["id"] == 3
    out = TP.planned_search(col, p, text="topic3", k=5)
    assert out["plan"].mode == "fts"
    assert len(out["results"]) == 5
    out = TP.planned_search(col, p, vector=x[3], text="topic3", k=5)
    assert out["plan"].mode == "hybrid"
    assert p.stats()
    only = c.create_collection("v_only", dim=8)
    only.add(x[:50])
    out = TP.planned_search(only, p, text="some keyword query", k=3)
    assert out["results"] == []


@pytest.mark.parametrize("kind,params", [
    ("flat", {}), ("ivfflat", {"nlists": 4}),
    ("hnsw", {"m": 8}), ("pq", {"n_sub": 4, "ksub": 16}),
    ("ivfpq", {"nlists": 4, "n_sub": 4, "ksub": 16})])
def test_collection_matches_jax(rng, kind, params):
    n = 160
    x = rng.standard_normal((n, 8)).astype(np.float32)
    docs = [f"doc number {i} about topic{i % 7}" for i in range(n)]
    cols = []
    for client in (Client(device="cpu"), JClient()):
        col = client.create_collection("c", 8, index=kind,
                                       index_params=params)
        col.add(x, documents=docs, metadata=[{"i": i} for i in range(n)])
        cols.append(col)
    t, j = cols
    if kind in ("flat", "ivfflat"):
        # same search semantics on both sides; the trained indexes differ
        assert [r["id"] for r in t.search(x[5], k=4)] == \
            [r["id"] for r in j.search(x[5], k=4)]
    res = t.search(x[5], k=4)
    assert res[0]["id"] == 5 and res[0]["metadata"] == {"i": 5}
    hy = t.hybrid_search(x[5], "topic5 number 5", k=3)
    assert hy[0]["id"] == 5 and hy[0]["document"] == docs[5]
    st = t.stats()
    assert (st["n"], st["index"], st["dim"]) == (n, kind, 8)


def test_client_sdk(rng):
    c = Client(device="cpu")
    col = c.create_collection("docs", 8, metric="cosine")
    x = rng.standard_normal((30, 8)).astype(np.float32)
    col.add(x, documents=[f"doc number {i}" for i in range(30)])
    res = col.search(x[3], k=2)
    assert res[0]["id"] == 3
    assert res[0]["document"] == "doc number 3"
    hy = col.hybrid_search(x[3], "number 3", k=3)
    assert any(r["id"] == 3 for r in hy)
    col.delete([3])
    res = col.search(x[3], k=1)
    assert res[0]["id"] != 3
    assert "docs" in c.list_collections()
    with pytest.raises(ValueError, match="exists"):
        c.create_collection("docs", 8)
    with pytest.raises(ValueError, match="expected dim"):
        col.add(np.zeros((2, 5), np.float32))
    c.drop_collection("docs")
    assert c.list_collections() == []


def test_client_delete_last_docs_clears_bm25(rng):
    c = Client(device="cpu")
    col = c.create_collection("docs2", dim=4, index="ivfflat",
                              index_params={"nlists": 2})
    v = rng.standard_normal((3, 4)).astype(np.float32)
    col.add(v, documents=["alpha one", "beta two", "gamma three"])
    col.search(v[0], k=1)                    # builds index + bm25
    col.delete(list(col._ids))
    assert col._bm25 is None


def test_client_services_name_their_roadmap_item():
    """Every ML family serves through the client, the ones ported last
    included (random forest, XGBoost's alias, the MLP), as do the LLM
    router, the embedding service and RAG (on the client's device)."""
    c = Client(device="cpu")
    X = np.random.default_rng(0).standard_normal((20, 2)).astype(np.float32)
    y = X @ np.array([1.0, -2.0], np.float32) + 3.0
    for algo, hp in (("random_forest", {"task": "regress", "n_trees": 3}),
                     ("xgboost", {"task": "regress", "n_trees": 3}),
                     ("mlp", {"task": "regress", "epochs": 3})):
        mid = c.train("p", algo, X, y, hp)
        assert np.isfinite(c.predict(mid, X[:3])).all()
    mid = c.train("p", "linreg", X, y)
    np.testing.assert_allclose(c.predict(mid, X[:3]), y[:3], atol=1e-3)
    assert c.evaluate(mid, X, y)["r2"] > 0.999
    jc = JClient()
    assert type(c.llm).__name__ == type(jc.llm).__name__ == "LLMRouter"
    assert c.llm.complete("one. two.") == jc.llm.complete("one. two.")
    assert c.embeddings.embed_text("text").shape == \
        jc.embeddings.embed_text("text").shape == (256,)
    rag = c.rag(chunk_size=64)
    assert (rag.metric, rag.chunk_size, rag.device) == \
        ("cosine", 64, c.device)
    rag.add_documents(["alpha beta gamma. delta epsilon.", "zeta eta theta."])
    assert rag.retrieve("zeta eta", k=1, weight=0.0)[0]["doc_id"] == 1
    with pytest.raises(ValueError, match="unknown index kind"):
        col = c.create_collection("bad", 4, index="annoy")
        col.add(np.zeros((2, 4), np.float32))
        col.search(np.zeros(4, np.float32))
