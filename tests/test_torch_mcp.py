"""The MCP server: the torch port against the JAX package on the CPU.

Both servers are built side by side. Tool names, descriptions and input
schemas must be equal; each deterministic tool is called through both
servers' handlers on the same seeded inputs and the results held equal
(floats at ``RTOL`` / ``ATOL``: f32 sums in another order). The ML tools
read the registries the JAX package wrote (``tests/data/jax_registry``
and ``jax_registry_ml2``) and must predict their ``expected.npz``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import neurondb_tpu.index as JI
from neurondb_tpu.service import mcp as JM
from neurondb_tpu.service import mcp_middleware as JMW
import neurondb_tpu_torch.config as TC
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.ml import registry as TR
from neurondb_tpu_torch.service import mcp as TM
from neurondb_tpu_torch.service import mcp_middleware as TMW
from neurondb_tpu_torch.service import mcp_tools_extra as TX

DATA = Path(__file__).resolve().parent / "data"
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    prev_cfg, prev_threads = TC._config, torch.get_num_threads()
    TC.set_config(TC.NDBConfig(device="cpu", ivf_select="exact"))
    torch.set_num_threads(1)
    yield
    TC.set_config(prev_cfg)
    torch.set_num_threads(prev_threads)


@pytest.fixture(scope="module")
def pair():
    return JM.MCPServer(), TM.MCPServer()


def _norm(o):
    """Tensors, jax arrays and numpy arrays to numpy, recursively."""
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    if isinstance(o, dict):
        return {k: _norm(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_norm(v) for v in o]
    if hasattr(o, "__array__") and not isinstance(o, (np.ndarray,
                                                      np.generic)):
        return np.asarray(o)
    return o


def _same(p, j, path=""):
    if isinstance(p, dict):
        assert isinstance(j, dict) and set(p) == set(j), path
        for k in p:
            _same(p[k], j[k], f"{path}.{k}")
        return
    if isinstance(p, list) and p and isinstance(p[0], (dict, list, str)):
        assert len(p) == len(j), path
        for a, b in zip(p, j):
            _same(a, b, path + "[]")
        return
    if isinstance(p, str) or isinstance(j, str) or p is None:
        assert p == j, (path, p, j)
        return
    pa, ja = np.asarray(p), np.asarray(j)
    assert pa.shape == ja.shape, (path, pa.shape, ja.shape)
    if pa.dtype.kind in "fc" or ja.dtype.kind in "fc":
        np.testing.assert_allclose(pa.astype(np.float64),
                                   ja.astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    else:
        assert np.array_equal(pa, ja), (path, pa, ja)


def _rpc(srv, method, params=None):
    out = srv.handle(json.dumps({"jsonrpc": "2.0", "id": 1,
                                 "method": method, "params": params or {}}))
    return json.loads(out) if out else None


def _call(srv, name, args):
    out = _rpc(srv, "tools/call", {"name": name, "arguments": args})
    assert "error" not in out, out
    text = out["result"]["content"][0]["text"]
    assert "tensor(" not in text and "Array(" not in text
    return json.loads(text)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def test_tools_and_resources_lists_equal_jax(pair):
    j, t = pair
    for method in ("initialize", "tools/list", "resources/list", "ping"):
        assert _rpc(t, method) == _rpc(j, method)
    tools = _rpc(t, "tools/list")["result"]["tools"]
    assert len(tools) == len(_rpc(j, "tools/list")["result"]["tools"]) == 86
    assert _rpc(t, "notifications/initialized") is None


@pytest.mark.parametrize("raw", [
    "not json",
    json.dumps({"jsonrpc": "1.0", "id": 1, "method": "x"}),
    json.dumps({"jsonrpc": "2.0", "id": 2, "method": "nope"}),
    json.dumps({"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                "params": {"name": "nope"}}),
    json.dumps({"jsonrpc": "2.0", "id": 4, "method": "resources/read",
                "params": {"uri": "neurondb://nope"}}),
    json.dumps({"jsonrpc": "2.0", "id": 5, "method": "resources/read"}),
    json.dumps({"jsonrpc": "2.0", "id": 6, "method": "tools/call",
                "params": {"name": "vector_normalize",
                           "arguments": {"bad": True}}}),
    json.dumps({"jsonrpc": "2.0", "id": 7, "method": "tools/call",
                "params": {"name": "vector_search",
                           "arguments": {"vector": [1.0], "k": True}}}),
    json.dumps({"jsonrpc": "2.0", "id": 8, "method": "tools/call",
                "params": {"name": "vector_search",
                           "arguments": {"vector": [1.0],
                                         "collection": "none"}}}),
])
def test_errors_equal_jax(pair, raw):
    j, t = pair
    assert json.loads(t.handle(raw)) == json.loads(j.handle(raw))


def test_middleware_chain_equal_jax():
    seen = []
    for mw in (JMW, TMW):
        clock = [0.0]
        chain = mw.build_chain(
            [mw.AuthMiddleware(["k1"]),
             mw.RateLimitMiddleware(qps=1.0, burst=2,
                                    clock=lambda: clock[0]),
             mw.LoggingMiddleware(), mw.TimeoutMiddleware(5.0),
             mw.ValidationMiddleware(
                 {"t": {"properties": {"n": {"type": "integer"}},
                        "required": ["n"]}}, strict=True)],
            lambda n, a: a["n"] * 2)
        row = []
        for args in ({"n": 1}, {"n": 1, "_meta": {"api_key": "k1"}},
                     {"n": 2, "_meta": {"api_key": "k1"}},
                     {"n": 3, "_meta": {"api_key": "k1"}},
                     {"m": 1, "_meta": {"api_key": "k1"}}):
            clock[0] += 0.1
            try:
                row.append(chain("t", args))
            except mw.MCPError as e:
                row.append(("mcp", e.code))
            except ValueError as e:
                row.append(("value", str(e)))
        clock[0] += 5.0
        try:
            row.append(chain("t", {"m": 1, "_meta": {"api_key": "k1"}}))
        except ValueError as e:
            row.append(("value", str(e)))
        seen.append(row)
    assert seen[0] == seen[1]
    assert ("mcp", TMW.AUTH_ERROR) in seen[1]
    assert ("mcp", TMW.RATE_LIMITED) in seen[1]


# ---------------------------------------------------------------------------
# the deterministic tools, called through both servers
# ---------------------------------------------------------------------------

_R = np.random.default_rng(20)
X = _R.standard_normal((300, 16)).astype(np.float32)
V = X[3] + 0.3 * _R.standard_normal(16).astype(np.float32)
DOCS = [f"topic{i % 7} word{i % 13} item {i}" for i in range(300)]
EDGES = [[i, (i * 7 + 3) % 30] for i in range(30)] + [[0, 1], [5, 9]]
SPARSE_A = np.where(X[0] > 0.5, X[0], 0)
SPARSE_B = np.where(X[1] > 0.5, X[1], 0)
SERIES = np.cumsum(_R.standard_normal(80)) * 0.1 + _R.standard_normal(80)
TS = (1.7e9 - _R.uniform(0, 1e6, 300)).tolist()
FACETS = {str(i): {"color": ["red", "blue"][i % 2]} for i in range(300)}
QMULTI = X[:3] + 0.3 * _R.standard_normal((3, 16)).astype(np.float32)

CASES = [
    ("vector_distance", {"x": X[:3], "y": X[3:6], "metric": "l2"}),
    ("vector_distance", {"x": X[0], "y": X[1], "metric": "cosine"}),
    ("vector_distance", {"x": X[:2], "y": X[4:7], "metric": "l1"}),
    ("vector_normalize", {"vector": X[0]}),
    ("vector_similarity", {"a": X[0], "b": X[1]}),
    ("vector_similarity", {"a": X[0], "b": X[1], "metric": "ip"}),
    ("vector_similarity_unified", {"a": X[0], "b": X[1]}),
    ("vector_arithmetic", {"a": X[0], "b": X[1], "op": "add"}),
    ("vector_arithmetic", {"a": X[0], "b": X[1], "op": "div"}),
    ("vector_arithmetic", {"a": X[0], "op": "softmax"}),
    ("vector_arithmetic", {"a": X[0], "op": "scale", "scalar": 2.5}),
    ("vector_arithmetic", {"a": X[0, :3], "b": X[1, :3], "op": "cross"}),
    ("vector_arithmetic", {"a": X[0], "op": "standardize"}),
    ("vector_quantization", {"vectors": X[:8], "format": "int8"}),
    ("vector_quantization", {"vectors": X[:8], "format": "binary"}),
    ("vector_quantization", {"vectors": X[:8], "format": "f16"}),
    ("vector_quantization", {"vectors": X[:8], "format": "int4"}),
    ("quantize_analyze", {"vectors": X[:50], "format": "int8"}),
    ("quantize_analyze", {"vectors": X[:50], "format": "int4"}),
    ("quantize_analyze", {"vectors": X[:50], "format": "uint8"}),
    ("vecmap_operations", {"a": SPARSE_A, "b": SPARSE_B,
                           "op": "inner_product"}),
    ("vecmap_operations", {"a": SPARSE_A, "b": SPARSE_B, "op": "l2"}),
    ("vecmap_operations", {"a": SPARSE_A, "b": SPARSE_B, "op": "cosine"}),
    ("vecmap_operations", {"a": SPARSE_A, "op": "nnz"}),
    ("vgraph", {"n": 30, "edges": EDGES, "op": "pagerank"}),
    ("vgraph", {"n": 30, "edges": EDGES, "op": "bfs", "source": 2}),
    ("vgraph", {"n": 30, "edges": EDGES, "op": "components"}),
    ("vgraph", {"n": 30, "edges": EDGES, "op": "community"}),
    ("vector_graph", {"n": 30, "edges": EDGES, "op": "shortest_paths",
                      "source": 1}),
    ("vector_graph", {"n": 30, "edges": EDGES, "op": "communities"}),
    ("reciprocal_rank_fusion", {"rankings": [[1, 2, 3, 4], [3, 1, 5, 6],
                                             [9, 3]], "k": 5}),
    ("recall_at_k", {"retrieved": [[1, 2, 3], [4, 5, 6]],
                     "relevant": [[1, 3, 9], [6, 7, 8]]}),
    ("quality_metrics", {"retrieved": [[1, 2, 3], [4, 5, 6]],
                         "relevant": [[1, 3, 9], [6, 7, 8]]}),
    ("chunk_text", {"text": " ".join(DOCS[:40]), "chunk_size": 100,
                    "overlap": 20}),
    ("chunk_text", {"text": " ".join(DOCS[:40]), "chunk_size": 30,
                    "overlap": 5, "by": "words"}),
    ("chunk_document", {"text": " ".join(DOCS[:40]), "chunk_size": 64}),
    ("index_tune", {"n": 1000000, "dim": 128}),
    ("index_tune", {"n": 5000, "dim": 64, "kind": "hnsw"}),
    ("tune_hnsw_index", {"n": 200000, "dim": 96}),
    ("tune_ivf_index", {"n": 200000}),
    ("rerank_ensemble", {"rankings": [{"scores": [0.9, 0.5, 0.1],
                                       "ids": [1, 2, 3]},
                                      {"scores": [0.8, 0.7], "ids": [3, 2]}],
                         "k": 3}),
    ("rerank_ensemble", {"rankings": [{"scores": [0.9, 0.5, 0.1],
                                       "ids": [1, 2, 3]},
                                      {"scores": [0.8, 0.7], "ids": [3, 2]}],
                         "k": 3, "method": "borda"}),
    ("rerank_ltr", {"features": X[:20, :4], "weights": [0.5, -1.0, 2.0, 0.1],
                    "k": 5}),
    ("diverse_search_mmr", {"vector": V, "candidates": X[:30], "k": 5}),
    ("analyze_data", {"data": X[:50]}),
    ("analyze_features", {"X": X[:50]}),
    ("drift_detect", {"reference": X[:100], "live": X[100:] + 0.3}),
    ("timeseries_forecast", {"series": SERIES, "steps": 6, "order": 3}),
    ("outlier_scores", {"X": X[:60], "k": 4}),
    ("detect_outliers", {"data": X[:60], "k": 4}),
    ("vector_search_l2", {"vectors": X, "vector": V, "k": 5}),
    ("vector_search_cosine", {"vectors": X, "vector": V, "k": 5}),
    ("vector_search_inner_product", {"vectors": X, "vector": V, "k": 5}),
    ("config", {"show": "ivf_nprobe"}),
    ("onnx_run", {"model_path": "missing.onnx"}),
    # over the collection "c" (a FlatIndex with documents, both sides)
    ("vector_search", {"collection": "c", "vector": V, "k": 7}),
    ("hybrid_search", {"collection": "c", "vector": V,
                       "text": "topic3 word5", "k": 7}),
    ("semantic_keyword_search", {"collection": "c", "vector": V,
                                 "text": "topic3 word5", "k": 7}),
    ("semantic_keyword_search", {"collection": "c", "vector": V,
                                 "text": "topic3", "k": 7,
                                 "require_keyword": True}),
    ("multi_vector_search", {"collection": "c", "vectors": QMULTI, "k": 7}),
    ("multi_vector_search", {"collection": "c", "vectors": QMULTI, "k": 7,
                             "mode": "max"}),
    ("faceted_vector_search", {"collection": "c", "vector": V,
                               "facets": FACETS, "filter": {"color": "red"},
                               "k": 5}),
    ("temporal_vector_search", {"collection": "c", "vector": V,
                                "timestamps": TS, "k": 5, "now": 1.7e9}),
    ("index_stats", {"collection": "c"}),
    ("index_status", {"collection": "c"}),
    ("index_validate", {"collection": "c"}),
    ("engine_collections", {}),
    ("engine_memory", {}),
    ("vector_search", {"collection": "ivf", "vector": V, "k": 7}),
]


def _lists(a):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in a.items()}


@pytest.fixture(scope="module")
def collections(pair):
    j, t = pair
    for srv in (j, t):
        srv._handlers["create_index"]({"vectors": X.tolist(), "kind": "flat",
                                       "documents": DOCS, "collection": "c"})
    jivf = JI.IVFFlatIndex(X, nlists=8, seed=0)
    arrays, meta = jivf._state()
    j.add_collection("ivf", jivf)
    t.add_collection("ivf", TIVF.from_state(
        {k: np.asarray(v) for k, v in arrays.items()},
        dict(meta, metric="l2", dim=16), device="cpu"))
    return pair


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_tool_equals_jax(collections, name, args):
    j, t = collections
    a = _lists(args)
    got = _norm(t._handlers[name](dict(a)))
    _same(got, _norm(j._handlers[name](dict(a))))
    _call(t, name, a)                    # the JSON-RPC path: plain lists


def test_delete_then_search_equal_jax(collections):
    j, t = collections
    for srv in (j, t):
        with pytest.raises(ValueError, match="no delete"):
            srv._handlers["delete_vectors"]({"collection": "c", "ids": [3]})
    # the carried index's statistics, apart from the k-means inertia that
    # the JAX build measured and a carried state does not hold
    got, want = (_call(s, "index_stats", {"collection": "ivf"})
                 for s in (t, j))
    assert np.isnan(got.pop("train_inertia"))
    want.pop("train_inertia")
    assert got == want
    a = {"collection": "ivf", "ids": [3, 5, 102]}
    assert _call(t, "delete_vectors", a) == _call(j, "delete_vectors", a)
    a = {"collection": "ivf", "vector": V.tolist(), "k": 7}
    _same(_norm(t._handlers["vector_search"](a)),
          _norm(j._handlers["vector_search"](a)))


def test_dataset_load_fvecs_and_npy(tmp_path, pair):
    j, t = pair
    body = np.concatenate([np.full((40, 1), 16, np.int32).view(np.float32),
                           X[:40]], axis=1)
    body.tofile(tmp_path / "x.fvecs")
    np.save(tmp_path / "x.npy", X[:40])
    for path in ("x.fvecs", "x.npy"):
        a = {"path": str(tmp_path / path), "collection": "ds",
             "limit": 30}
        assert _call(t, "dataset_load", a) == _call(j, "dataset_load", a)
        q = {"collection": "ds", "vector": V.tolist(), "k": 4}
        _same(_norm(t._handlers["vector_search"](q)),
              _norm(j._handlers["vector_search"](q)))
    np.testing.assert_array_equal(
        TX.read_vecs(str(tmp_path / "x.fvecs")), X[:40])


def test_resources_read(collections):
    _, t = collections
    for r in _rpc(t, "resources/list")["result"]["resources"]:
        out = _rpc(t, "resources/read", {"uri": r["uri"]})
        json.loads(out["result"]["contents"][0]["text"])
    rows = json.loads(_rpc(t, "resources/read", {
        "uri": "neurondb://indexes"})["result"]["contents"][0]["text"])
    kinds = {row["collection"]: row["kind"] for row in rows["indexes"]}
    assert kinds["c"] == "flat" and kinds["ivf"] == "ivfflat"


def test_engine_tools_on_the_port(collections):
    """The tools whose answers name the engine itself: the port's
    version, backend and device."""
    _, t = collections
    import neurondb_tpu_torch
    out = _call(t, "engine_version", {})
    assert out["version"] == neurondb_tpu_torch.__version__
    assert out["backend"] == "cpu" and out["device"] == "cpu"
    info = _call(t, "device_info", {})
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert info == {"backend": "cpu", "device_count": n,
                    "devices": [torch.cuda.get_device_name(i)
                                for i in range(n)]}
    settings = _call(t, "engine_settings", {})
    assert settings["device"] == "cpu" and "ivf_kernel" in settings
    assert _call(t, "engine_threads", {})["active_threads"] >= 1


@pytest.mark.parametrize("kind,extra", [
    ("flat", {}), ("ivfflat", {"nlists": 8}), ("hnsw", {}),
    ("pq", {"n_sub": 4}), ("ivfpq", {"n_sub": 4, "nlists": 8})])
def test_create_index_builds_the_port_kinds(pair, kind, extra):
    _, t = pair
    out = _call(t, "create_index", {"vectors": X.tolist(), "kind": kind,
                                    "collection": "k_" + kind, **extra})
    assert out == {"collection": "k_" + kind, "kind": kind, "n": len(X)}
    idx = t.collection("k_" + kind)["index"]
    assert type(idx).__module__.startswith("neurondb_tpu_torch.index")
    assert idx.kind == kind
    res = _call(t, "vector_search", {"collection": "k_" + kind,
                                     "vector": X[3].tolist(), "k": 3})
    assert res["ids"][0] == 3


def test_embedding_rag_and_worker_tools(pair):
    _, t = pair
    emb = _call(t, "embed_text", {"texts": DOCS[:3]})["embeddings"]
    assert np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    out = _call(t, "batch_embed_index", {"texts": DOCS[:20],
                                         "collection": "e"})
    assert out == {"collection": "e", "n": 20, "dim": len(emb[0])}
    res = _call(t, "vector_search", {"collection": "e",
                                     "vector": emb[1], "k": 1})
    assert res["ids"] == [1]
    assert _call(t, "process_document",
                 {"text": " ".join(DOCS[:80])})["chunks_indexed"] >= 1
    assert len(_call(t, "retrieve_context",
                     {"query": "topic3", "k": 2})["contexts"]) == 2
    assert _call(t, "generate_response",
                 {"prompt": "topic3?", "use_rag": True})["contexts_used"] == 4
    assert _call(t, "worker_management", {"op": "enqueue"}) == {"job_id": 1}
    assert _call(t, "worker_management", {"op": "status"}) == \
        {"queue": {"runs": 0}, "tuner": {"runs": 0}, "defrag": {"runs": 0}}


@pytest.fixture()
def jax_registry(monkeypatch):
    def use(name):
        monkeypatch.setenv("NEURONDB_TORCH_MODEL_ROOT", str(DATA / name))
        TR.set_registry(None)
    yield use
    TR.set_registry(None)


def test_ml_tools_read_the_jax_registry(pair, jax_registry):
    """An RBF SVM and a whitened PCA persisted by the JAX registry
    predict the JAX package's ``expected.npz`` through the port's
    tools."""
    _, t = pair
    jax_registry("jax_registry")
    with np.load(DATA / "jax_registry" / "expected.npz") as e:
        Xq, svm, pca = e["X"], e["svm"], e["pca"]
    got = _call(t, "ml_predict", {"model_id": 1, "X": Xq.tolist()})
    np.testing.assert_array_equal(got["predictions"], svm)
    got = _call(t, "ml_predict_batch", {"model_id": 2,
                                        "batches": [Xq[:10].tolist(),
                                                    Xq[10:].tolist()]})
    np.testing.assert_allclose(np.concatenate(got["predictions"]), pca,
                               rtol=1e-4, atol=1e-4)
    info = _call(t, "ml_model_info", {"model_id": 1})
    assert (info["algorithm"], info["project"]) == ("svm", "fixture")
    assert [m["model_id"] for m in _call(t, "ml_list_models", {})["models"]] \
        == [1, 2]


def test_ml_tools_read_the_jax_registry_ml2(pair, jax_registry):
    _, t = pair
    jax_registry("jax_registry_ml2")
    with np.load(DATA / "jax_registry_ml2" / "expected.npz") as e:
        Xq, xgb, hw = e["X"], e["xgboost"], e["holt_winters"]
    got = _call(t, "ml_predict", {"model_id": 1, "X": Xq.tolist()})
    np.testing.assert_array_equal(got["predictions"], xgb)
    got = _call(t, "ml_predict", {"model_id": 2, "X": [24]})
    np.testing.assert_allclose(got["predictions"], hw, rtol=1e-5, atol=1e-5)


def test_ml_train_predict_evaluate_roundtrip(pair, tmp_path):
    _, t = pair
    TR.set_registry(TR.ModelRegistry(str(tmp_path), device="cpu"))
    try:
        y = (X[:120, 0] > 0).astype(int)
        mid = _call(t, "ml_train", {"algorithm": "logistic_regression",
                                    "X": X[:120].tolist(),
                                    "y": y.tolist()})["model_id"]
        pred = _call(t, "ml_predict", {"model_id": mid,
                                       "X": X[:120].tolist()})
        ev = _call(t, "ml_evaluate", {"model_id": mid, "X": X[:120].tolist(),
                                      "y": y.tolist()})
        assert ev["accuracy"] == pytest.approx(
            float(np.mean(np.asarray(pred["predictions"]) == y)))
        assert _call(t, "ml_deploy_model", {"model_id": mid}) == {"ok": True}
        assert _call(t, "ml_delete_model", {"model_id": mid}) == \
            {"deleted": mid}
    finally:
        TR.set_registry(None)
