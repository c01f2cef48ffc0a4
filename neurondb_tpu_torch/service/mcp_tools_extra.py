"""MCP tool registry, part 2 — closes the gap to the reference's 74
tools (NeuronMCP/internal/tools/register.go:9-120).

Every tool calls a real engine function; the reference's PostgreSQL
admin tools map to the engine-runtime equivalents (config, metrics,
collections, device, workers) since there is no PG here by design.

Counterpart of ``neurondb_tpu/service/mcp_tools_extra.py``: the same
tools and schemas over the port's engine. Where the JAX module makes jax
arrays, these tools make torch tensors on ``config.device``;
``engine_version`` reports the CUDA devices by name; ``dataset_load``
reads .fvecs / .bvecs / .ivecs with numpy (the port has no
``native/``).
"""

from __future__ import annotations

import base64
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neurondb_tpu_torch.service.mcp import _dev


def register_extra_tools(srv) -> None:
    def schema(props: Dict, required: Sequence[str] = ()) -> Dict:
        return {"type": "object", "properties": props,
                "required": list(required)}

    vec = {"type": "array", "items": {"type": "number"}}
    s = {"type": "string"}
    i = {"type": "integer"}
    f = {"type": "number"}
    arr = {"type": "array"}

    def reg(name, desc, props, required, fn):
        srv.register_tool(name, desc, schema(props, required), fn)

    def col_index(a):
        return srv.collection(a.get("collection", "default"))["index"]

    def col_docs(a):
        return srv.collection(a.get("collection", "default"))["docs"]

    # ================= vector search variants =================
    def mk_metric_search(metric):
        def fn(a):
            import neurondb_tpu_torch as ndb
            data = np.asarray(a["vectors"], np.float32)
            idx = ndb.FlatIndex(data, metric=metric)
            d, ids = idx.search(np.asarray(a["vector"], np.float32),
                                k=int(a.get("k", 10)))
            return {"ids": ids, "distances": d, "metric": metric}
        return fn

    for name, metric, op in (("vector_search_l2", "l2", "<->"),
                             ("vector_search_cosine", "cosine", "<=>"),
                             ("vector_search_inner_product", "ip", "<#>")):
        reg(name, f"Exact k-NN over inline vectors with {op}",
            {"vectors": arr, "vector": vec, "k": i},
            ["vectors", "vector"], mk_metric_search(metric))

    def t_vector_similarity(a):
        from neurondb_tpu_torch.ops import distance as D
        x = _dev(np.asarray(a["a"], np.float32)[None])
        y = _dev(np.asarray(a["b"], np.float32)[None])
        metric = a.get("metric", "cosine")
        d = float(D.pairwise_distance(x, y, metric)[0, 0])
        sim = 1.0 - d if metric == "cosine" else -d if metric == "ip" \
            else 1.0 / (1.0 + d)
        return {"distance": d, "similarity": sim, "metric": metric}

    reg("vector_similarity", "Similarity between two vectors",
        {"a": vec, "b": vec, "metric": s}, ["a", "b"],
        t_vector_similarity)
    reg("vector_similarity_unified",
        "Similarity with every supported metric at once",
        {"a": vec, "b": vec}, ["a", "b"],
        lambda a: {m: t_vector_similarity({**a, "metric": m})
                   for m in ("l2", "cosine", "ip", "l1", "chebyshev")})

    def t_vector_arithmetic(a):
        from neurondb_tpu_torch.ops import vector_ops as V
        x = _dev(a["a"])
        op = a.get("op", "add")
        ops1 = {"abs": V.vector_abs, "square": V.vector_square,
                "sqrt": V.vector_sqrt, "normalize": V.vector_normalize,
                "negate": V.vector_negate, "softmax": V.vector_softmax,
                "standardize": V.vector_standardize}
        if op in ops1:
            return {"result": ops1[op](x)}
        y = _dev(a["b"]) if "b" in a else None
        ops2 = {"add": V.vector_add, "sub": V.vector_sub,
                "mul": V.vector_hadamard, "div": V.vector_div,
                "cross": V.vector_cross_product}
        if op in ops2:
            if y is None:
                raise ValueError(f"op {op!r} needs field 'b'")
            return {"result": ops2[op](x, y)}
        if op == "scale":
            return {"result": V.vector_scale(x, float(a.get("scalar", 1.0)))}
        raise ValueError(f"unknown op {op!r}")

    reg("vector_arithmetic", "Vector ops (add/sub/mul/div/scale/"
        "normalize/abs/square/sqrt/softmax/cross)",
        {"a": vec, "b": vec, "op": s, "scalar": f}, ["a", "op"],
        t_vector_arithmetic)

    def t_vector_quantization(a):
        from neurondb_tpu_torch.types import quantized as Q
        x = _dev(np.atleast_2d(np.asarray(a["vectors"], np.float32)))
        fmt = a.get("format", "int8")
        qv = Q.quantize(x, fmt)
        dq = Q.dequantize(qv)
        err = float(torch.mean((x - dq) ** 2))
        return {"format": fmt, "mse": err,
                "compression": Q.FORMATS[fmt],
                "dequantized_sample": dq[0][:8]}

    reg("vector_quantization",
        "Quantize vectors (fp16/int8/binary/uint8/ternary/int4/fp8)",
        {"vectors": arr, "format": s}, ["vectors"], t_vector_quantization)

    def t_vecmap(a):
        from neurondb_tpu_torch.types.sparse import SparseVectors
        op = a.get("op", "inner_product")
        sa = SparseVectors.from_dense(
            np.atleast_2d(np.asarray(a["a"], np.float32)))
        if op == "nnz":
            return {"nnz": int(sa.nnz[0])}
        sb = SparseVectors.from_dense(
            np.atleast_2d(np.asarray(a["b"], np.float32)))
        from neurondb_tpu_torch.types import sparse as S
        fns = {"inner_product": S.sparse_inner_product,
               "l2": S.sparse_l2_distance,
               "cosine": S.sparse_cosine_distance}
        if op not in fns:
            raise ValueError(f"unknown op {op!r}")
        return {op: float(fns[op](sa, sb)[0])}

    reg("vecmap_operations",
        "Sparse-vector ops (inner_product/l2/cosine/nnz)",
        {"a": vec, "b": vec, "op": s}, ["a"], t_vecmap)

    def t_vgraph_full(a):
        from neurondb_tpu_torch.types import graph as G
        g = G.VectorGraph.from_edges(int(a["n"]),
                                     [tuple(e) for e in a["edges"]])
        op = a.get("op", "pagerank")
        if op == "pagerank":
            return {"pagerank": G.pagerank(g)}
        if op == "bfs":
            return {"levels": G.bfs(g, int(a.get("source", 0)))}
        if op == "components":
            return {"labels": G.connected_components(g)}
        if op == "communities":
            return {"labels": G.community_labels(g)}
        if op == "shortest_paths":
            return {"dist": G.shortest_path_lengths(
                g, int(a.get("source", 0)))}
        raise ValueError(f"unknown op {op!r}")

    reg("vector_graph", "Graph algorithms over a vgraph "
        "(pagerank/bfs/components/communities/shortest_paths)",
        {"n": i, "edges": arr, "op": s, "source": i}, ["n", "edges"],
        t_vgraph_full)

    # ================= embeddings =================
    def _embsvc():
        if not hasattr(srv, "_embedding_service"):
            from neurondb_tpu_torch.service.embeddings import EmbeddingService
            srv._embedding_service = EmbeddingService()
        return srv._embedding_service

    reg("embed_batch", "Embed a batch of texts",
        {"texts": arr, "model": s}, ["texts"],
        lambda a: {"embeddings": _embsvc().embed_batch(
            [str(t) for t in a["texts"]], a.get("model", "default"))})
    reg("embed_cached", "Embed one text through the TTL cache",
        {"text": s, "model": s}, ["text"],
        lambda a: {"embedding": _embsvc().embed_cached(
            a["text"], a.get("model", "default"))})
    reg("embed_image", "Embed image bytes (base64)",
        {"image_b64": s, "model": s}, ["image_b64"],
        lambda a: {"embedding": _embsvc().embed_image(
            base64.b64decode(a["image_b64"]), a.get("model", "default"))})
    reg("embed_multimodal", "Fused text+image embedding",
        {"text": s, "image_b64": s, "model": s}, ["text"],
        lambda a: {"embedding": _embsvc().embed_multimodal(
            a["text"],
            base64.b64decode(a["image_b64"]) if a.get("image_b64")
            else None, a.get("model", "default"))})

    def t_configure_model(a):
        from neurondb_tpu_torch.service.embeddings import EmbeddingModelConfig
        _embsvc().add_model(EmbeddingModelConfig(
            a["name"], a.get("provider", "local"),
            int(a.get("dim", 256)), int(a.get("max_len", 128))))
        return {"ok": True, "name": a["name"]}

    reg("configure_embedding_model", "Create/update an embedding model "
        "config", {"name": s, "provider": s, "dim": i, "max_len": i},
        ["name"], t_configure_model)
    reg("get_embedding_model_config", "Get one embedding model config",
        {"name": s}, ["name"],
        lambda a: vars(_embsvc().get_model(a["name"])))
    reg("list_embedding_model_configs", "List embedding model configs",
        {}, [], lambda a: {"models": _embsvc().list_models()})
    reg("delete_embedding_model_config", "Delete an embedding model "
        "config", {"name": s}, ["name"],
        lambda a: (_embsvc().delete_model(a["name"]), {"ok": True})[1])

    # ================= index management =================
    def mk_create(kind):
        def fn(a):
            import neurondb_tpu_torch as ndb
            data = np.asarray(a["vectors"], np.float32)
            metric = a.get("metric", "l2")
            if kind == "hnsw":
                idx = ndb.HNSWIndex(data, metric=metric,
                                    m=int(a.get("m", 16)),
                                    ef_construction=int(
                                        a.get("ef_construction", 200)))
            else:
                idx = ndb.IVFFlatIndex(data, metric=metric,
                                       nlists=int(a.get("nlists", 100)))
            srv.add_collection(a.get("collection", "default"), idx,
                               docs=a.get("documents"))
            return {"collection": a.get("collection", "default"),
                    "kind": kind, "n": len(data)}
        return fn

    reg("create_hnsw_index", "Build an HNSW index",
        {"collection": s, "vectors": arr, "metric": s, "m": i,
         "ef_construction": i}, ["vectors"], mk_create("hnsw"))
    reg("create_ivf_index", "Build an IVFFlat index",
        {"collection": s, "vectors": arr, "metric": s, "nlists": i},
        ["vectors"], mk_create("ivf"))

    def t_drop_index(a):
        name = a.get("collection", "default")
        srv.collection(name)             # raises if unknown
        del srv._collections[name]
        return {"dropped": name}

    reg("drop_index", "Drop a collection/index", {"collection": s},
        ["collection"], t_drop_index)

    def t_index_status(a):
        idx = col_index(a)
        out = {"kind": idx.kind, "n": getattr(idx, "n", None),
               "metric": idx.metric,
               "dead_ratio": getattr(idx, "dead_ratio", 0.0)}
        if hasattr(idx, "stats"):
            out.update(idx.stats())
        return out

    reg("index_status", "Index status + diagnostics", {"collection": s},
        [], t_index_status)

    def mk_tune(kind):
        def fn(a):
            from neurondb_tpu_torch.index import tuning
            n = int(a.get("n", 10000))
            if "n" not in a and a.get("collection") in srv._collections:
                n = int(getattr(col_index(a), "n", n) or n)
            tr = float(a.get("target_recall", 0.95))
            if kind == "hnsw":
                return tuning.recommend_hnsw_params(
                    n, int(a.get("dim", 128)), target_recall=tr)
            return tuning.recommend_ivf_params(n, target_recall=tr)
        return fn

    reg("tune_hnsw_index", "Recommend HNSW build/search params",
        {"collection": s, "n": i, "dim": i, "target_recall": f}, [],
        mk_tune("hnsw"))
    reg("tune_ivf_index", "Recommend IVF build/search params",
        {"collection": s, "n": i, "dim": i, "target_recall": f}, [],
        mk_tune("ivf"))

    def t_delete_vectors(a):
        idx = col_index(a)
        if not hasattr(idx, "delete"):
            raise ValueError(f"index kind {idx.kind!r} has no delete")
        removed = idx.delete(np.asarray(a["ids"], np.int64))
        return {"removed": int(removed)}

    reg("delete_vectors", "Delete vectors from a collection's index",
        {"collection": s, "ids": arr}, ["ids"], t_delete_vectors)

    # ================= search orchestration =================
    def t_semantic_keyword(a):
        from neurondb_tpu_torch.search.bm25 import BM25Index
        from neurondb_tpu_torch.search.hybrid import semantic_keyword_search
        docs = a.get("documents") or col_docs(a)
        bm = BM25Index([str(d) for d in docs])
        res = semantic_keyword_search(
            col_index(a), bm, np.asarray(a["vector"], np.float32),
            a["text"], k=int(a.get("k", 10)),
            require_keyword=bool(a.get("require_keyword", False)))
        return {"results": res}

    reg("semantic_keyword_search", "Vector search gated/boosted by "
        "keyword match", {"collection": s, "vector": vec, "text": s,
                          "k": i, "documents": arr,
                          "require_keyword": {"type": "boolean"}},
        ["vector", "text"], t_semantic_keyword)

    reg("multi_vector_search", "k-NN with several query vectors fused",
        {"collection": s, "vectors": arr, "k": i, "mode": s},
        ["vectors"],
        lambda a: {"results": __import__(
            "neurondb_tpu_torch.search.hybrid", fromlist=["x"]
        ).multi_vector_search(col_index(a),
                              np.asarray(a["vectors"], np.float32),
                              k=int(a.get("k", 10)),
                              mode=a.get("mode", "mean"))})

    def t_faceted(a):
        from neurondb_tpu_torch.search.hybrid import faceted_vector_search
        facets = {int(k): v for k, v in (a.get("facets") or {}).items()}
        return {"results": faceted_vector_search(
            col_index(a), np.asarray(a["vector"], np.float32), facets,
            a.get("filter") or {}, k=int(a.get("k", 10)))}

    reg("faceted_vector_search", "k-NN with metadata facet filters",
        {"collection": s, "vector": vec, "facets": {"type": "object"},
         "filter": {"type": "object"}, "k": i}, ["vector"], t_faceted)

    def t_temporal(a):
        from neurondb_tpu_torch.search.hybrid import temporal_vector_search
        return {"results": temporal_vector_search(
            col_index(a), np.asarray(a["vector"], np.float32),
            np.asarray(a["timestamps"], np.float64),
            k=int(a.get("k", 10)),
            half_life=float(a.get("half_life", 86400.0)),
            now=float(a.get("now", time.time())))}

    reg("temporal_vector_search", "k-NN with exponential time decay",
        {"collection": s, "vector": vec, "timestamps": arr, "k": i,
         "half_life": f, "now": f}, ["vector", "timestamps"], t_temporal)

    # ================= rerankers =================
    def t_rerank_colbert(a):
        from neurondb_tpu_torch.search.rerank import rerank_colbert
        from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider
        router = LLMRouter([LocalProvider()])
        qt = np.asarray(router.embed(a["query"].split() or [a["query"]]),
                        np.float32)
        dt = [np.asarray(router.embed(str(d).split() or [str(d)]),
                         np.float32) for d in a["docs"]]
        order, scores = rerank_colbert(qt, dt, k=int(a.get("k", 10)))
        return {"order": order, "scores": scores}

    reg("rerank_colbert", "Late-interaction (MaxSim) rerank",
        {"query": s, "docs": arr, "k": i}, ["query", "docs"],
        t_rerank_colbert)

    def t_rerank_ltr(a):
        from neurondb_tpu_torch.search.rerank import rerank_ltr
        order, scores = rerank_ltr(
            np.asarray(a["features"], np.float32),
            np.asarray(a["weights"], np.float32),
            k=int(a.get("k", 10)))
        return {"order": order, "scores": scores}

    reg("rerank_ltr", "Pointwise learning-to-rank rerank",
        {"features": arr, "weights": vec, "k": i},
        ["features", "weights"], t_rerank_ltr)

    def t_rerank_llm(a):
        from neurondb_tpu_torch.search.rerank import rerank_llm
        from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider
        router = LLMRouter([LocalProvider()])
        order, scores = rerank_llm(a["query"],
                                   [str(d) for d in a["docs"]], router,
                                   k=int(a.get("k", 10)))
        return {"order": order, "scores": scores}

    reg("rerank_llm", "LLM-scored rerank through the gateway",
        {"query": s, "docs": arr, "k": i}, ["query", "docs"],
        t_rerank_llm)
    # cohere is an HTTP provider in the reference; same scorer shape via
    # the router's rerank entry (fails over to local cross-encoder)
    reg("rerank_cohere", "Provider rerank via the LLM router "
        "(cohere-compatible; local fallback)",
        {"query": s, "docs": arr, "k": i}, ["query", "docs"],
        t_rerank_llm)

    # ================= RAG / documents =================
    def t_chunk_document(a):
        from neurondb_tpu_torch.search.rag import chunk_text
        return {"chunks": chunk_text(
            a["text"], chunk_size=int(a.get("chunk_size", 512)),
            overlap=int(a.get("overlap", 64)))}

    reg("chunk_document", "Chunk a document for RAG",
        {"text": s, "chunk_size": i, "overlap": i}, ["text"],
        t_chunk_document)

    def _rag():
        if not hasattr(srv, "_rag_pipeline"):
            from neurondb_tpu_torch.search.rag import RAGPipeline
            from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider
            router = LLMRouter([LocalProvider()])
            srv._rag_pipeline = RAGPipeline(embed=router.embed)
        return srv._rag_pipeline

    def t_process_document(a):
        rag = _rag()
        before = len(rag.chunks)
        rag.add_documents([a["text"]])
        return {"chunks_indexed": len(rag.chunks) - before}

    reg("process_document", "Chunk + embed + index a document",
        {"text": s, "doc_id": s}, ["text"], t_process_document)

    def t_retrieve_context(a):
        return {"contexts": _rag().retrieve(a["query"],
                                            k=int(a.get("k", 4)))}

    reg("retrieve_context", "Retrieve RAG context chunks",
        {"query": s, "k": i}, ["query"], t_retrieve_context)

    def t_generate_response(a):
        from neurondb_tpu_torch.service.llm import LLMRouter, LocalProvider
        router = LLMRouter([LocalProvider()])
        ctx = _rag().retrieve(a["prompt"], k=int(a.get("k", 4))) \
            if a.get("use_rag") else []
        prompt = a["prompt"] if not ctx else \
            "\n".join(c["chunk"] for c in ctx) + "\n\n" + a["prompt"]
        return {"response": router.complete(prompt),
                "contexts_used": len(ctx)}

    reg("generate_response", "LLM completion (optionally RAG-grounded)",
        {"prompt": s, "use_rag": {"type": "boolean"}, "k": i},
        ["prompt"], t_generate_response)

    # ================= ML lifecycle =================
    def t_predict_batch(a):
        from neurondb_tpu_torch.ml import api as ml
        return {"predictions": [
            np.asarray(ml.predict(int(a["model_id"]),
                                  np.asarray(x, np.float32)))
            for x in a["batches"]]}

    reg("ml_predict_batch", "Predict over several feature batches",
        {"model_id": i, "batches": arr}, ["model_id", "batches"],
        t_predict_batch)

    def t_model_info(a):
        from neurondb_tpu_torch.ml.registry import get_registry
        rec = get_registry().get(int(a["model_id"]))
        return {"model_id": rec.model_id, "project": rec.project,
                "algorithm": rec.algorithm, "version": rec.version,
                "status": rec.status, "metrics": rec.metrics,
                "hyperparams": rec.hyperparams,
                "created_at": rec.created_at}

    reg("ml_model_info", "Model metadata from the registry",
        {"model_id": i}, ["model_id"], t_model_info)

    def t_delete_model(a):
        from neurondb_tpu_torch.ml.registry import get_registry
        get_registry().delete(int(a["model_id"]))
        return {"deleted": int(a["model_id"])}

    reg("ml_delete_model", "Delete a model from the registry",
        {"model_id": i}, ["model_id"], t_delete_model)

    def t_export_model(a):
        from neurondb_tpu_torch.ml.registry import ModelRegistry, get_registry
        rec = get_registry().get(int(a["model_id"]))
        out = ModelRegistry(a["path"])
        mid = out.register(rec.project, rec.algorithm, rec.model,
                           rec.hyperparams, rec.metrics)
        return {"exported_to": a["path"], "model_id": mid}

    reg("ml_export_model", "Export a model to an npz+manifest dir",
        {"model_id": i, "path": s}, ["model_id", "path"], t_export_model)

    reg("ml_deploy_model", "Mark a model deployed",
        {"model_id": i}, ["model_id"],
        lambda a: (__import__("neurondb_tpu_torch.ml.api", fromlist=["x"])
                   .deploy(int(a["model_id"])), {"ok": True})[1])

    def t_cluster_data(a):
        from neurondb_tpu_torch.ml import api as ml
        mid = ml.train("mcp", a.get("algorithm", "kmeans"),
                       np.asarray(a["data"], np.float32),
                       hyperparams={"k": int(a.get("k", 8))})
        labels = ml.predict(mid, np.asarray(a["data"], np.float32))
        return {"model_id": mid, "labels": np.asarray(labels)}

    reg("cluster_data", "Cluster rows (kmeans/minibatch_kmeans/gmm/...)",
        {"data": arr, "algorithm": s, "k": i}, ["data"], t_cluster_data)

    def t_reduce_dim(a):
        from neurondb_tpu_torch.ml import api as ml
        mid = ml.train("mcp", "pca", np.asarray(a["data"], np.float32),
                       hyperparams={"n_components":
                                    int(a.get("n_components", 2))})
        return {"model_id": mid,
                "transformed": np.asarray(ml.predict(
                    mid, np.asarray(a["data"], np.float32)))}

    reg("reduce_dimensionality", "PCA projection",
        {"data": arr, "n_components": i}, ["data"], t_reduce_dim)

    def t_detect_outliers(a):
        from neurondb_tpu_torch.ml.cluster_extra import knn_outlier_scores
        scores = knn_outlier_scores(
            _dev(a["data"]), k=int(a.get("k", 5))).cpu().numpy().ravel()
        thr = float(np.quantile(scores,
                                float(a.get("quantile", 0.95))))
        return {"scores": scores, "threshold": thr,
                "outliers": np.where(scores > thr)[0]}

    reg("detect_outliers", "kNN-distance outliers with a quantile "
        "threshold", {"data": arr, "k": i, "quantile": f}, ["data"],
        t_detect_outliers)

    def t_analyze_data(a):
        x = np.asarray(a["data"], np.float32)
        return {"n": int(x.shape[0]), "dim": int(x.shape[1]),
                "mean": x.mean(0), "std": x.std(0),
                "min": x.min(0), "max": x.max(0),
                "nan_count": int(np.isnan(x).sum())}

    reg("analyze_data", "Per-feature summary statistics",
        {"data": arr}, ["data"], t_analyze_data)

    def t_quality_metrics(a):
        from neurondb_tpu_torch.ml import metrics as M
        got = np.asarray(a["retrieved"], np.int64)
        want = np.asarray(a["relevant"], np.int64)
        if got.ndim == 1:
            got, want = got[None], want[None]
        k = got.shape[1]
        rel_sets = [set(w.tolist()) for w in want]
        gains = [{int(i): 1.0 for i in w} for w in want]
        return {"recall": M.recall_at_k(got, want),
                "precision": M.precision_at_k(got, rel_sets, k),
                "f1": M.f1_at_k(got, rel_sets, k),
                "mrr": M.mean_reciprocal_rank(got, want[:, 0]),
                "ndcg": M.ndcg_at_k(got, gains, k)}

    reg("quality_metrics", "IR quality metrics (recall/precision/F1/"
        "MRR/nDCG)", {"retrieved": arr, "relevant": arr},
        ["retrieved", "relevant"], t_quality_metrics)

    # ================= datasets / admin =================
    def t_dataset_load(a):
        path = a["path"]
        limit = int(a.get("limit", 0)) or None
        if path.endswith(".npy"):
            data = np.load(path)
            if limit:
                data = data[:limit]
        elif path.endswith(".npz"):
            blob = np.load(path)
            data = blob[blob.files[0]]
            if limit:
                data = data[:limit]
        else:
            kind = "bvecs" if path.endswith(".bvecs") else \
                "ivecs" if path.endswith(".ivecs") else "fvecs"
            data = read_vecs(path, kind, max_n=limit)
        name = a.get("collection", "default")
        import neurondb_tpu_torch as ndb
        srv.add_collection(name, ndb.FlatIndex(
            np.asarray(data, np.float32),
            metric=a.get("metric", "l2")))
        return {"collection": name, "n": int(len(data))}

    reg("dataset_load", "Load .fvecs/.bvecs/.npy vectors into a collection",
        {"path": s, "collection": s, "metric": s, "limit": i},
        ["path"], t_dataset_load)

    def _workers():
        if not hasattr(srv, "_worker_pool"):
            from neurondb_tpu_torch.service.workers import (AutoTuner,
                                                      DefragWorker,
                                                      QueueWorker)
            srv._worker_pool = {"queue": QueueWorker(),
                                "tuner": AutoTuner(),
                                "defrag": DefragWorker()}
        return srv._worker_pool

    def t_worker_management(a):
        pool = _workers()
        op = a.get("op", "status")
        if op == "status":
            out = {}
            for name, w in pool.items():
                out[name] = {"runs": len(getattr(w, "runs", []))}
                if hasattr(w, "pending"):
                    out[name]["pending"] = w.pending()
            return out
        if op == "defrag":
            idx = col_index(a)
            return {"vacuumed": pool["defrag"].maybe_vacuum(idx)}
        if op == "enqueue":
            q = pool["queue"]
            jid = q.enqueue(a.get("kind", "noop"), a.get("payload") or {})
            return {"job_id": jid}
        raise ValueError(f"unknown op {op!r}")

    reg("worker_management", "Background worker control "
        "(status/defrag/enqueue)",
        {"op": s, "collection": s, "kind": s,
         "payload": {"type": "object"}}, [], t_worker_management)

    def t_engine_info(a):
        import neurondb_tpu_torch
        from neurondb_tpu_torch.config import resolve_device
        dev = resolve_device(None)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {"version": neurondb_tpu_torch.__version__,
                "backend": dev.type,
                "device": str(dev),
                "device_kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "num_devices": n}

    # PG admin tool equivalents for this engine's runtime
    reg("engine_version", "Engine + backend version info "
        "(postgresql_version parity)", {}, [], t_engine_info)
    def t_engine_settings(a):
        from neurondb_tpu_torch.config import get_config
        cfg = get_config()
        return {f: getattr(cfg, f)
                for f in type(cfg).__dataclass_fields__}

    reg("engine_settings", "All config values (postgresql_settings "
        "parity)", {}, [], t_engine_settings)
    reg("engine_collections", "List collections (postgresql_database_"
        "list parity)", {}, [],
        lambda a: {"collections": sorted(srv._collections),
                   "sizes": {k: getattr(v["index"], "n", None)
                             for k, v in srv._collections.items()}})

    def t_engine_memory(a):
        out = {}
        for name, col in srv._collections.items():
            idx = col["index"]
            n = getattr(idx, "n", 0) or 0
            dim = getattr(idx, "dim", 0) or 0
            out[name] = {"n": n, "dim": dim,
                         "approx_bytes": int(n * dim * 4)}
        return {"collections": out}

    reg("engine_memory", "Per-collection memory accounting "
        "(postgresql_stats parity)", {}, [], t_engine_memory)

    def t_engine_locks(a):
        import threading as th
        return {"active_threads": th.active_count(),
                "thread_names": sorted(t.name for t in th.enumerate())}

    reg("engine_threads", "Runtime thread/lock info (postgresql_locks/"
        "connections parity)", {}, [], t_engine_locks)

    def t_onnx(a):
        from neurondb_tpu_torch.service import onnx_runtime as ox
        if not ox.HAVE_ORT:
            return {"available": False,
                    "reason": "onnxruntime not installed"}
        outs = ox.onnx_predict(a["model_path"],
                               {k: np.asarray(v, np.float32)
                                for k, v in (a.get("inputs") or
                                             {}).items()})
        return {"available": True,
                "outputs": [np.asarray(o) for o in outs]}

    reg("onnx_run", "Run an ONNX session (when onnxruntime present)",
        {"model_path": s, "inputs": {"type": "object"}},
        ["model_path"], t_onnx)

    def t_batch_embed_index(a):
        import neurondb_tpu_torch as ndb
        texts = [str(t) for t in a["texts"]]
        embs = _embsvc().embed_batch(texts, a.get("model", "default"))
        name = a.get("collection", "default")
        srv.add_collection(name, ndb.FlatIndex(
            np.asarray(embs, np.float32), metric="cosine"), docs=texts)
        return {"collection": name, "n": len(texts),
                "dim": int(embs.shape[1])}

    reg("batch_embed_index", "Embed texts and build a collection over "
        "them", {"texts": arr, "collection": s, "model": s}, ["texts"],
        t_batch_embed_index)


def read_vecs(path: str, kind: str = "fvecs",
              max_n: Optional[int] = None) -> np.ndarray:
    """A TEXMEX .fvecs / .bvecs / .ivecs file -> f32 [n, d]: each row is
    an int32 dimension followed by that many f32 / uint8 / int32 values."""
    raw = np.fromfile(path, np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    d = int(raw[:4].view(np.int32)[0])
    width = {"fvecs": 4, "ivecs": 4, "bvecs": 1}[kind]
    row = 4 + d * width
    n = raw.size // row
    if max_n:
        n = min(n, int(max_n))
    body = np.ascontiguousarray(raw[:n * row].reshape(n, row)[:, 4:])
    dt = {"fvecs": np.float32, "ivecs": np.int32, "bvecs": np.uint8}[kind]
    return body.view(dt).reshape(n, d).astype(np.float32)
