"""MCP server — JSON-RPC 2.0 over stdio exposing the engine as tools.

Reference: NeuronMCP (Go) — protocol/initialize/tools handlers
(pkg/mcp/{protocol.go:18-60,server.go:23-64,transport.go}), ~70 tools
wrapping the SQL surface (internal/tools/register.go:9-120), middleware
chain (auth/logging/rate-limit/validation).

Tool inventory mirrors the reference's categories: vector search
(l2/cos/ip), embeddings, index create/tune, ML train/predict/evaluate,
hybrid/RRF/faceted/temporal/diverse search, rerankers, quantization,
metrics, graph ops, worker and config introspection.

Counterpart of ``neurondb_tpu/service/mcp.py``: the same JSON-RPC
dispatch, resources, tool names and input schemas, every tool over the
port's engine (``create_index`` builds the port's five index kinds on
``config.device``). Divergences: ``_jsonable`` turns a torch tensor (and
a numpy array) into a list, where the JAX module's turns a jax array into
its ``str``; ``device_info`` reports the CUDA devices by name (backend
``config.device``) where the JAX module reports ``jax.devices()``; the
tools that hand a port function tensors put them on ``config.device``.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

PROTOCOL_VERSION = "2024-11-05"

# JSON-RPC error codes (protocol.go parity)
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
RESOURCE_NOT_FOUND = -32002   # MCP spec: resources/read unknown URI
INTERNAL_ERROR = -32603


class MCPServer:
    def __init__(self, name: str = "neurondb-tpu-mcp",
                 version: str = "0.1.0"):
        self.name = name
        self.version = version
        self._tools: Dict[str, Dict] = {}
        self._handlers: Dict[str, Callable[[Dict], Any]] = {}
        self._collections: Dict[str, Any] = {}
        self._registry_default_done = False
        self._middleware: List[Callable] = []
        self._chain = None
        self._resources: Dict[str, Dict] = {}
        register_engine_tools(self)
        from neurondb_tpu_torch.service.mcp_tools_extra import (
            register_extra_tools)
        register_extra_tools(self)
        register_engine_resources(self)
        # default chain mirrors NeuronMCP/internal/middleware: validation
        # always on; auth/rate-limit/metrics/timeout/logging opt-in via
        # use()
        from neurondb_tpu_torch.service.mcp_middleware import ValidationMiddleware
        self.use(ValidationMiddleware(self._tools_schemas()))

    def _tools_schemas(self) -> Dict[str, Dict]:
        return {n: t["inputSchema"] for n, t in self._tools.items()}

    def use(self, middleware: Callable) -> None:
        """Append a middleware (called outermost-first on tools/call)."""
        self._middleware.append(middleware)
        self._chain = None

    def _call_tool(self, name: str, args: Dict) -> Any:
        if self._chain is None:
            from neurondb_tpu_torch.service.mcp_middleware import build_chain
            self._chain = build_chain(
                self._middleware, lambda n, a: self._handlers[n](a))
        return self._chain(name, args)

    # ---- tool registration ----
    def register_tool(self, name: str, description: str,
                      input_schema: Dict,
                      handler: Callable[[Dict], Any]) -> None:
        self._tools[name] = {"name": name, "description": description,
                             "inputSchema": input_schema}
        self._handlers[name] = handler

    # ---- resource registration (resource_handlers.go parity) ----
    def register_resource(self, uri: str, name: str, description: str,
                          getter: Callable[[], Any],
                          mime_type: str = "application/json") -> None:
        self._resources[uri] = {"uri": uri, "name": name,
                                "description": description,
                                "mimeType": mime_type, "getter": getter}

    def _read_resource(self, uri: str) -> Dict:
        res = self._resources.get(uri)
        if res is None:
            raise ValueError(f"resource not found: {uri!r}")
        text = json.dumps(res["getter"](), indent=2, default=_jsonable)
        return {"contents": [{"uri": uri, "mimeType": res["mimeType"],
                              "text": text}]}

    def add_collection(self, name: str, index, docs: Optional[list] = None):
        self._collections[name] = {"index": index, "docs": docs or []}

    def collection(self, name: str):
        if name not in self._collections:
            raise ValueError(f"unknown collection {name!r}")
        return self._collections[name]

    # ---- JSON-RPC dispatch ----
    def handle(self, raw: str) -> Optional[str]:
        try:
            req = json.loads(raw)
        except json.JSONDecodeError:
            return self._err(None, PARSE_ERROR, "parse error")
        if req.get("jsonrpc") != "2.0":
            return self._err(req.get("id"), INVALID_REQUEST,
                             "jsonrpc must be '2.0'")
        method = req.get("method", "")
        params = req.get("params") or {}
        rid = req.get("id")
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "serverInfo": {"name": self.name,
                                   "version": self.version},
                    "capabilities": {"tools": {}, "resources": {}},
                }
            elif method == "notifications/initialized":
                return None
            elif method == "tools/list":
                result = {"tools": list(self._tools.values())}
            elif method == "tools/call":
                name = params.get("name")
                if name not in self._handlers:
                    return self._err(rid, METHOD_NOT_FOUND,
                                     f"unknown tool {name!r}")
                args = params.get("arguments") or {}
                out = self._call_tool(name, args)
                result = {"content": [{"type": "text",
                                       "text": json.dumps(out,
                                                          default=_jsonable)}]}
            elif method == "resources/list":
                result = {"resources": [
                    {k: v for k, v in r.items() if k != "getter"}
                    for r in self._resources.values()]}
            elif method == "resources/read":
                uri = params.get("uri")
                if not uri:
                    return self._err(rid, INVALID_PARAMS,
                                     "missing required param 'uri'")
                if uri not in self._resources:
                    # MCP designates -32002 for unknown resources;
                    # -32601 would read as "method unsupported" to
                    # spec-conformant clients (r4 advisor finding)
                    return self._err(rid, RESOURCE_NOT_FOUND,
                                     f"resource not found: {uri!r}")
                result = self._read_resource(uri)
            elif method == "ping":
                result = {}
            else:
                return self._err(rid, METHOD_NOT_FOUND,
                                 f"unknown method {method!r}")
        except ValueError as e:
            return self._err(rid, INVALID_PARAMS, str(e))
        except Exception as e:  # noqa: BLE001
            from neurondb_tpu_torch.service.mcp_middleware import MCPError
            if isinstance(e, MCPError):
                return self._err(rid, e.code, str(e))
            return self._err(rid, INTERNAL_ERROR, str(e))
        return json.dumps({"jsonrpc": "2.0", "id": rid, "result": result})

    @staticmethod
    def _err(rid, code: int, message: str) -> str:
        return json.dumps({"jsonrpc": "2.0", "id": rid,
                           "error": {"code": code, "message": message}})

    # ---- stdio loop (transport.go parity) ----
    def serve_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            resp = self.handle(line)
            if resp is not None:
                stdout.write(resp + "\n")
                stdout.flush()


def _jsonable(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, (np.ndarray, np.generic)):
        return np.asarray(o).tolist()
    return str(o)


def _dev(a, dtype=torch.float32) -> torch.Tensor:
    """A tool argument as a tensor on ``config.device``."""
    from neurondb_tpu_torch.config import resolve_device
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(None))


# --------------------------------------------------------------------------
# engine tools (register.go inventory)
# --------------------------------------------------------------------------

def register_engine_tools(srv: MCPServer) -> None:
    def schema(props: Dict, required: Sequence[str] = ()) -> Dict:
        return {"type": "object", "properties": props,
                "required": list(required)}

    vec = {"type": "array", "items": {"type": "number"}}

    # ---- vector search ----
    def t_vector_search(a: Dict):
        col = srv.collection(a.get("collection", "default"))
        d, ids = col["index"].search(
            np.asarray(a["vector"], np.float32), k=int(a.get("k", 10)))
        return {"ids": ids, "distances": d}

    srv.register_tool(
        "vector_search", "k-NN search over a collection (<->/<=>/<#>)",
        schema({"collection": {"type": "string"}, "vector": vec,
                "k": {"type": "integer"}}, ["vector"]),
        t_vector_search)

    def t_create_index(a: Dict):
        import neurondb_tpu_torch as ndb
        kind = a.get("kind", "flat")
        data = np.asarray(a["vectors"], np.float32)
        metric = a.get("metric", "l2")
        if kind == "flat":
            idx = ndb.FlatIndex(data, metric=metric)
        elif kind == "ivfflat":
            idx = ndb.IVFFlatIndex(data, metric=metric,
                                   nlists=int(a.get("nlists", 100)))
        elif kind == "hnsw":
            idx = ndb.HNSWIndex(data, metric=metric,
                                m=int(a.get("m", 16)))
        elif kind == "pq":
            idx = ndb.PQIndex(data, metric=metric,
                              n_sub=int(a.get("n_sub", 8)))
        elif kind == "ivfpq":
            idx = ndb.IVFPQIndex(data, metric=metric,
                                 n_sub=int(a.get("n_sub", 16)),
                                 nlists=int(a.get("nlists", 100)))
        else:
            raise ValueError(f"unknown index kind {kind!r}")
        srv.add_collection(a.get("collection", "default"), idx,
                           docs=a.get("documents"))
        return {"collection": a.get("collection", "default"),
                "kind": kind, "n": len(data)}

    srv.register_tool(
        "create_index", "Build an index (flat/ivfflat/hnsw/pq)",
        schema({"collection": {"type": "string"},
                "kind": {"type": "string"},
                "vectors": {"type": "array"},
                "metric": {"type": "string"}}, ["vectors"]),
        t_create_index)

    def t_index_stats(a: Dict):
        col = srv.collection(a.get("collection", "default"))
        idx = col["index"]
        return idx.stats() if hasattr(idx, "stats") else \
            {"kind": idx.kind, "n": getattr(idx, "n", None)}

    srv.register_tool("index_stats", "Index diagnostics (validate/diag)",
                      schema({"collection": {"type": "string"}}),
                      t_index_stats)

    # ---- embeddings ----
    def t_embed(a: Dict):
        svc = _embedding_service()
        out = svc.embed_batch(a["texts"])
        return {"embeddings": out}

    srv.register_tool(
        "embed_text", "Embed texts with the local encoder",
        schema({"texts": {"type": "array", "items": {"type": "string"}}},
               ["texts"]), t_embed)

    # ---- ML ----
    def t_train(a: Dict):
        from neurondb_tpu_torch.ml import api as ML
        mid = ML.train(a.get("project", "mcp"), a["algorithm"],
                       np.asarray(a["X"], np.float32),
                       np.asarray(a["y"]) if "y" in a else None,
                       a.get("hyperparams"))
        return {"model_id": mid}

    srv.register_tool(
        "ml_train", "Train a model (neurondb_train parity)",
        schema({"project": {"type": "string"},
                "algorithm": {"type": "string"}, "X": {"type": "array"},
                "y": {"type": "array"},
                "hyperparams": {"type": "object"}},
               ["algorithm", "X"]), t_train)

    def t_predict(a: Dict):
        from neurondb_tpu_torch.ml import api as ML
        return {"predictions": ML.predict(int(a["model_id"]),
                                          np.asarray(a["X"], np.float32))}

    srv.register_tool(
        "ml_predict", "Predict with a trained model",
        schema({"model_id": {"type": "integer"}, "X": {"type": "array"}},
               ["model_id", "X"]), t_predict)

    def t_evaluate(a: Dict):
        from neurondb_tpu_torch.ml import api as ML
        return ML.evaluate(int(a["model_id"]),
                           np.asarray(a["X"], np.float32),
                           np.asarray(a["y"]) if "y" in a else None)

    srv.register_tool(
        "ml_evaluate", "Evaluate a trained model",
        schema({"model_id": {"type": "integer"}, "X": {"type": "array"},
                "y": {"type": "array"}}, ["model_id", "X"]), t_evaluate)

    def t_list_models(a: Dict):
        from neurondb_tpu_torch.ml.registry import get_registry
        return {"models": get_registry().list(a.get("project"))}

    srv.register_tool("ml_list_models", "List registered models",
                      schema({"project": {"type": "string"}}), t_list_models)

    def t_list_algorithms(a: Dict):
        from neurondb_tpu_torch.ml import api as ML
        return {"algorithms": ML.list_algorithms()}

    srv.register_tool("ml_list_algorithms", "List available algorithms",
                      schema({}), t_list_algorithms)

    # ---- hybrid / fusion ----
    def t_rrf(a: Dict):
        from neurondb_tpu_torch.search.hybrid import reciprocal_rank_fusion
        s, ids = reciprocal_rank_fusion(
            [np.asarray(r) for r in a["rankings"]], k=int(a.get("k", 10)))
        return {"ids": ids, "scores": s}

    srv.register_tool(
        "reciprocal_rank_fusion", "Fuse ranked id lists with RRF",
        schema({"rankings": {"type": "array"}, "k": {"type": "integer"}},
               ["rankings"]), t_rrf)

    def t_quantize(a: Dict):
        from neurondb_tpu_torch.types.quantized import quantize_analyze
        return quantize_analyze(np.asarray(a["vectors"], np.float32),
                                a.get("format", "int8"))

    srv.register_tool(
        "quantize_analyze", "Quantization error report for a format",
        schema({"vectors": {"type": "array"}, "format": {"type": "string"}},
               ["vectors"]), t_quantize)

    def t_recall(a: Dict):
        from neurondb_tpu_torch.ml.metrics import recall_at_k
        return {"recall": recall_at_k(np.asarray(a["retrieved"]),
                                      np.asarray(a["relevant"]),
                                      a.get("k"))}

    srv.register_tool(
        "recall_at_k", "Recall@k against ground truth",
        schema({"retrieved": {"type": "array"},
                "relevant": {"type": "array"}, "k": {"type": "integer"}},
               ["retrieved", "relevant"]), t_recall)

    def t_config(a: Dict):
        from neurondb_tpu_torch.config import get_config
        cfg = get_config()
        if "set" in a:
            for k, v in a["set"].items():
                cfg.set(k, v)
        if "show" in a:
            return {a["show"]: cfg.show(a["show"])}
        return cfg.as_dict()

    srv.register_tool(
        "config", "SHOW/SET engine configuration (GUC parity)",
        schema({"show": {"type": "string"}, "set": {"type": "object"}}),
        t_config)

    def t_graph(a: Dict):
        from neurondb_tpu_torch.types.graph import (VectorGraph, bfs,
                                              community_labels,
                                              connected_components, pagerank)
        g = VectorGraph.from_edges(int(a["n"]),
                                   [tuple(e) for e in a["edges"]])
        op = a.get("op", "pagerank")
        if op == "pagerank":
            return {"pagerank": pagerank(g)}
        if op == "bfs":
            return {"levels": bfs(g, int(a.get("source", 0)))}
        if op == "components":
            return {"components": connected_components(g)}
        if op == "community":
            return {"labels": community_labels(g)}
        raise ValueError(f"unknown graph op {op!r}")

    srv.register_tool(
        "vgraph", "Graph ops over an edge list (pagerank/bfs/components/"
        "community)",
        schema({"n": {"type": "integer"}, "edges": {"type": "array"},
                "op": {"type": "string"}, "source": {"type": "integer"}},
               ["n", "edges"]), t_graph)

    # ---- distance / vector ops ----
    def t_distance(a: Dict):
        from neurondb_tpu_torch.ops import distance as DD
        x = _dev(a["x"])
        y = _dev(a["y"])
        m = a.get("metric", "l2")
        return {"distance": DD.pairwise_distance(
            x[None] if x.ndim == 1 else x,
            y[None] if y.ndim == 1 else y, m)}

    srv.register_tool(
        "vector_distance", "Distance between vectors for any metric",
        schema({"x": {"type": "array"}, "y": {"type": "array"},
                "metric": {"type": "string"}}, ["x", "y"]), t_distance)

    def t_normalize(a: Dict):
        from neurondb_tpu_torch.ops.vector_ops import vector_normalize
        return {"normalized": vector_normalize(_dev(a["vector"]))}

    srv.register_tool("vector_normalize", "L2-normalize a vector",
                      schema({"vector": vec}, ["vector"]), t_normalize)

    # ---- hybrid / diverse / temporal search over a collection ----
    def _col_docs(a):
        col = srv.collection(a.get("collection", "default"))
        return col

    def t_hybrid(a: Dict):
        from neurondb_tpu_torch.search.bm25 import BM25Index
        from neurondb_tpu_torch.search.hybrid import hybrid_search
        col = _col_docs(a)
        docs = col["docs"]
        if not docs:
            raise ValueError("collection has no documents for hybrid search")
        bm = col.get("bm25")
        if bm is None:       # build once per collection, not per call
            bm = BM25Index(docs)
            col["bm25"] = bm
        s, ids = hybrid_search(col["index"], bm,
                               np.asarray(a["vector"], np.float32),
                               a["text"], k=int(a.get("k", 10)),
                               weight=float(a.get("weight", 0.5)))
        return {"ids": ids, "scores": s}

    srv.register_tool(
        "hybrid_search", "Vector + BM25 fused search over a collection",
        schema({"collection": {"type": "string"}, "vector": vec,
                "text": {"type": "string"}, "k": {"type": "integer"},
                "weight": {"type": "number"}}, ["vector", "text"]), t_hybrid)

    def t_mmr(a: Dict):
        from neurondb_tpu_torch.search.hybrid import mmr_diverse_search
        s, ids = mmr_diverse_search(
            np.asarray(a["vector"], np.float32),
            np.asarray(a["candidates"], np.float32),
            np.asarray(a.get("candidate_ids",
                             range(len(a["candidates"])))),
            k=int(a.get("k", 10)),
            lambda_=float(a.get("lambda", 0.5)))
        return {"ids": ids, "scores": s}

    srv.register_tool(
        "diverse_search_mmr", "MMR diversity re-selection over candidates",
        schema({"vector": vec, "candidates": {"type": "array"},
                "candidate_ids": {"type": "array"}, "k": {"type": "integer"},
                "lambda": {"type": "number"}}, ["vector", "candidates"]),
        t_mmr)

    def t_rerank_ensemble(a: Dict):
        from neurondb_tpu_torch.search.rerank import rerank_ensemble
        rankings = [(np.asarray(r["scores"], np.float32),
                     np.asarray(r["ids"])) for r in a["rankings"]]
        s, ids = rerank_ensemble(rankings, a.get("weights"),
                                 k=int(a.get("k", 10)),
                                 method=a.get("method", "weighted"))
        return {"ids": ids, "scores": s}

    srv.register_tool(
        "rerank_ensemble", "Weighted/Borda ensemble of rankings",
        schema({"rankings": {"type": "array"},
                "weights": {"type": "array"}, "k": {"type": "integer"},
                "method": {"type": "string"}}, ["rankings"]),
        t_rerank_ensemble)

    def t_rerank_cross(a: Dict):
        from neurondb_tpu_torch.search.rerank import rerank_cross_encoder
        from neurondb_tpu_torch.ml.transformer import CrossEncoder
        scores, order = rerank_cross_encoder(
            a["query"], a["documents"], CrossEncoder(dim=128),
            k=a.get("k"))
        return {"order": order, "scores": scores}

    srv.register_tool(
        "rerank_cross_encoder", "Cross-encoder rerank of documents",
        schema({"query": {"type": "string"},
                "documents": {"type": "array"}, "k": {"type": "integer"}},
               ["query", "documents"]), t_rerank_cross)

    # ---- ML extensions ----
    def t_automl(a: Dict):
        from neurondb_tpu_torch.ml.automl import automl
        return automl(a.get("project", "mcp"),
                      np.asarray(a["X"], np.float32), np.asarray(a["y"]),
                      task=a.get("task", "classify"),
                      algorithms=a.get("algorithms"),
                      folds=int(a.get("folds", 3)))

    srv.register_tool(
        "automl", "Algorithm + hyperparameter search with CV leaderboard",
        schema({"project": {"type": "string"}, "X": {"type": "array"},
                "y": {"type": "array"}, "task": {"type": "string"},
                "algorithms": {"type": "array"},
                "folds": {"type": "integer"}}, ["X", "y"]), t_automl)

    def t_drift(a: Dict):
        from neurondb_tpu_torch.ml.drift import feature_drift_report
        return feature_drift_report(np.asarray(a["reference"], np.float32),
                                    np.asarray(a["live"], np.float32))

    srv.register_tool(
        "drift_detect", "Feature drift report (PSI/KS/mean-shift)",
        schema({"reference": {"type": "array"}, "live": {"type": "array"}},
               ["reference", "live"]), t_drift)

    def t_forecast(a: Dict):
        from neurondb_tpu_torch.ml.timeseries import ar_fit, ar_forecast
        y = _dev(a["series"])
        m = ar_fit(y, order=int(a.get("order", 4)))
        return {"forecast": ar_forecast(m, y, steps=int(a.get("steps", 8)))}

    srv.register_tool(
        "timeseries_forecast", "AR forecast of a numeric series",
        schema({"series": {"type": "array"}, "order": {"type": "integer"},
                "steps": {"type": "integer"}}, ["series"]), t_forecast)

    def t_topics(a: Dict):
        if a.get("method", "kmeans") == "lda":
            from neurondb_tpu_torch.ml.extras import lda_topics
            return lda_topics(a["documents"],
                              n_topics=int(a.get("n_topics", 5)))
        from neurondb_tpu_torch.ml.extras import discover_topics
        return discover_topics(a["documents"],
                               n_topics=int(a.get("n_topics", 5)))

    srv.register_tool(
        "topic_discovery", "Cluster documents into topics (tf-idf)",
        schema({"documents": {"type": "array"},
                "n_topics": {"type": "integer"}}, ["documents"]), t_topics)

    def t_describe(a: Dict):
        from neurondb_tpu_torch.ml.extras import describe
        return {"summary": describe(np.asarray(a["X"], np.float32))}

    srv.register_tool("analyze_features", "Summary stats per feature",
                      schema({"X": {"type": "array"}}, ["X"]), t_describe)

    def t_outliers(a: Dict):
        from neurondb_tpu_torch.ml.cluster_extra import knn_outlier_scores
        s = knn_outlier_scores(_dev(a["X"]), k=int(a.get("k", 5)))
        return {"scores": s}

    srv.register_tool("outlier_scores", "kNN-distance outlier scores",
                      schema({"X": {"type": "array"},
                              "k": {"type": "integer"}}, ["X"]), t_outliers)

    def t_chunk(a: Dict):
        from neurondb_tpu_torch.search.rag import chunk_text
        return {"chunks": chunk_text(a["text"],
                                     chunk_size=int(a.get("chunk_size", 512)),
                                     overlap=int(a.get("overlap", 64)),
                                     by=a.get("by", "chars"))}

    srv.register_tool(
        "chunk_text", "Split text into overlapping chunks (RAG)",
        schema({"text": {"type": "string"},
                "chunk_size": {"type": "integer"},
                "overlap": {"type": "integer"}, "by": {"type": "string"}},
               ["text"]), t_chunk)

    def t_tune(a: Dict):
        from neurondb_tpu_torch.index.tuning import (recommend_hnsw_params,
                                               recommend_ivf_params,
                                               select_index_kind)
        n = int(a["n"])
        dim = int(a.get("dim", 128))
        kind = a.get("kind") or select_index_kind(n, dim)
        out = {"index": kind}
        if kind == "hnsw":
            out.update(recommend_hnsw_params(
                n, dim, target_recall=float(a.get("target_recall", 0.95))))
        elif kind == "ivfflat":
            out.update(recommend_ivf_params(
                n, target_recall=float(a.get("target_recall", 0.95))))
        return out

    srv.register_tool(
        "index_tune", "Recommend index kind + parameters for a workload",
        schema({"n": {"type": "integer"}, "dim": {"type": "integer"},
                "kind": {"type": "string"},
                "target_recall": {"type": "number"}}, ["n"]), t_tune)

    def t_validate(a: Dict):
        from neurondb_tpu_torch.index.validate import validate_index
        col = srv.collection(a.get("collection", "default"))
        return validate_index(col["index"])

    srv.register_tool("index_validate",
                      "Structural validation of an index (neurondb_validate)",
                      schema({"collection": {"type": "string"}}), t_validate)

    def t_workers(a: Dict):
        from neurondb_tpu_torch.service.metrics import get_metrics
        return {"stat_view": get_metrics().stat_view()}

    srv.register_tool("engine_stats", "Engine metrics (pg_stat_neurondb)",
                      schema({}), t_workers)

    def t_device(a: Dict):
        from neurondb_tpu_torch.config import resolve_device
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {"backend": resolve_device(None).type,
                "devices": [torch.cuda.get_device_name(i) for i in range(n)],
                "device_count": n}

    srv.register_tool("device_info", "Accelerator info (gpu info parity)",
                      schema({}), t_device)


# --------------------------------------------------------------------------
# engine resources (internal/resources/{resource,config,indexes,models,
# schema,stats,workers}.go parity — same seven URIs)
# --------------------------------------------------------------------------

def register_engine_resources(srv: MCPServer) -> None:
    def _index_row(name: str, col: Dict) -> Dict:
        idx = col["index"]
        row = {"collection": name,
               "kind": getattr(idx, "kind", type(idx).__name__),
               "n": int(getattr(idx, "n", 0) or 0),
               "dim": int(getattr(idx, "dim", 0) or 0),
               "metric": getattr(idx, "metric", None),
               "documents": len(col.get("docs") or [])}
        if hasattr(idx, "stats"):
            try:
                row["stats"] = idx.stats()
            except Exception:  # noqa: BLE001 - diagnostics best-effort
                pass
        return row

    def r_config():
        from neurondb_tpu_torch.config import get_config
        return get_config().as_dict()

    srv.register_resource("neurondb://config", "NeuronDB Configuration",
                          "Current engine configuration settings", r_config)

    def r_indexes():
        return {"indexes": [_index_row(n, c)
                            for n, c in srv._collections.items()]}

    srv.register_resource("neurondb://indexes", "Vector Indexes",
                          "Status and information about vector indexes",
                          r_indexes)

    def r_models():
        from neurondb_tpu_torch.ml.registry import get_registry
        return {"models": get_registry().list()}

    srv.register_resource("neurondb://models", "ML Models",
                          "Catalog of trained ML models", r_models)

    def r_schema():
        # the reference reports DB schema (tables/columns); the engine's
        # analog is its collection layout + registered type/metric surface
        from neurondb_tpu_torch.ops.distance import ALIASES
        return {"collections": [
                    {"name": n,
                     "kind": getattr(c["index"], "kind",
                                     type(c["index"]).__name__),
                     "dim": int(getattr(c["index"], "dim", 0) or 0)}
                    for n, c in srv._collections.items()],
                "metrics": sorted(set(ALIASES.values())),
                "protocol": PROTOCOL_VERSION}

    srv.register_resource("neurondb://schema", "Engine Schema",
                          "Collection layout and registered metric surface",
                          r_schema)

    def r_vector_stats():
        rows = [_index_row(n, c) for n, c in srv._collections.items()]
        return {"collections": len(rows),
                "total_vectors": sum(r["n"] for r in rows),
                "dims": sorted({r["dim"] for r in rows}),
                "by_kind": {k: sum(1 for r in rows if r["kind"] == k)
                            for k in {r["kind"] for r in rows}}}

    srv.register_resource("neurondb://vector_stats", "Vector Statistics",
                          "Aggregate vector statistics", r_vector_stats)

    def r_workers():
        from neurondb_tpu_torch.service.metrics import get_metrics
        return {"stat_view": get_metrics().stat_view()}

    srv.register_resource("neurondb://workers", "Background Workers Status",
                          "Status of background workers", r_workers)

    def r_index_health():
        from neurondb_tpu_torch.index.validate import validate_index
        out = []
        for n, c in srv._collections.items():
            try:
                out.append({"collection": n,
                            "report": validate_index(c["index"])})
            except Exception as e:  # noqa: BLE001 - report, don't fail
                out.append({"collection": n, "error": str(e)})
        return {"health": out}

    srv.register_resource("neurondb://index_health", "Index Health",
                          "Index health dashboard", r_index_health)


_emb_singleton = None
_emb_lock = threading.Lock()


def _embedding_service():
    global _emb_singleton
    with _emb_lock:
        if _emb_singleton is None:
            from neurondb_tpu_torch.service.embeddings import EmbeddingService
            _emb_singleton = EmbeddingService()
        return _emb_singleton


def main():  # pragma: no cover - CLI entry
    MCPServer().serve_stdio()


if __name__ == "__main__":
    main()
