"""neurondb_tpu_torch — the PyTorch/CUDA port of neurondb_tpu.

A second package beside ``neurondb_tpu`` (the JAX reference, which it
never imports). It keeps the JAX package's module names so each part has
a findable counterpart, and holds the flat, quantized flat, IVFFlat,
IVF-PQ and HNSW indexes, BM25 and hybrid search, and the cross-encoder
rerank and text-embedding path:

- ``ops``: every distance metric, top-k (ties go to the lowest index, as
  ``lax.top_k``'s), and ``ops.kernels`` with the hand-written CUDA
  kernels of the list-grouped IVF scan, the round-1 probe scan, the
  IVF-PQ scan and flash attention (``csrc/``), built for ``sm_90a`` at
  first use;
- ``types``: the ten quantization formats and padded sparse vectors;
- ``ml``: k-means (single and batched over subspaces), recall, the
  WordPiece tokenizer, the BERT and pre-LN encoders with their
  embedders and cross-encoders, the ViT image encoder, the byte-level
  BPE tokenizer and GPT-2 decode (KV cache, W8A8, int8 KV, sampling);
- ``index``: ``FlatIndex``, ``QuantizedFlatIndex``, ``IVFFlatIndex``,
  ``PQIndex``, ``IVFPQIndex`` and ``HNSWIndex``;
- ``search``: BM25, hybrid fusion, sparse retrieval, the query planner,
  the rerankers and the RAG pipeline;
- ``service``: the LLM router (local, OpenAI and HF providers, cache,
  rate limit, fail-open, async jobs) and the embedding service;
- ``client``: ``Collection`` and ``Client`` (with its LLM, embedding
  and RAG services);
- ``parallel`` (imported on its own, not by this module): a mesh of
  torch devices, the sharded flat, IVF, HNSW and IVF-PQ indexes, the
  two-level (DCN x ICI) IVF with its streaming build, and sharded
  k-means.

Every index and model constructor takes a ``device`` (default from
``config.device``, ``"cuda"``): entry points run on the card unless the
caller asks for the CPU (``device="cpu"`` or ``configure(device="cpu")``),
and nothing picks the CPU on its own.
"""

from neurondb_tpu_torch.version import __version__
from neurondb_tpu_torch.config import (NDBConfig, configure, get_config,
                                       set_config)
from neurondb_tpu_torch.ops import distance  # noqa: F401
from neurondb_tpu_torch.ops.distance import (chebyshev_distance,
                                             cosine_distance,
                                             hamming_distance,
                                             inner_product_distance,
                                             jaccard_distance, l1_distance,
                                             l2_distance, minkowski_distance,
                                             pairwise_distance,
                                             squared_l2_distance)
from neurondb_tpu_torch.ops.topk import merge_topk, topk_smallest
from neurondb_tpu_torch.index.base import (quantize_queries_int4,
                                           quantize_queries_int8,
                                           quantize_queries_int12)
from neurondb_tpu_torch.index.flat import FlatIndex, QuantizedFlatIndex
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.index.ivfpq import IVFPQIndex
from neurondb_tpu_torch.index.pq import PQIndex

__all__ = [
    "__version__",
    "NDBConfig",
    "get_config",
    "set_config",
    "configure",
    "l2_distance",
    "squared_l2_distance",
    "cosine_distance",
    "inner_product_distance",
    "l1_distance",
    "hamming_distance",
    "chebyshev_distance",
    "minkowski_distance",
    "jaccard_distance",
    "pairwise_distance",
    "topk_smallest",
    "merge_topk",
    "quantize_queries_int4",
    "quantize_queries_int8",
    "quantize_queries_int12",
    "FlatIndex",
    "QuantizedFlatIndex",
    "IVFFlatIndex",
    "PQIndex",
    "IVFPQIndex",
    "HNSWIndex",
]
