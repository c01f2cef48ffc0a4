"""neurondb_tpu_torch — the PyTorch/CUDA port of neurondb_tpu.

A second package beside ``neurondb_tpu`` (the JAX reference, which it
never imports). It keeps the JAX package's module names so each part has
a findable counterpart, and holds the IVFFlat, IVF-PQ and HNSW indexes
and the cross-encoder rerank and text-embedding path:

- ``ops``: distances, top-k, and ``ops.kernels`` with the hand-written
  CUDA kernels of the list-grouped IVF scan, the IVF-PQ scan and flash
  attention (``csrc/``), built for ``sm_90a`` at first use;
- ``ml``: k-means (single and batched over subspaces), recall, the
  WordPiece tokenizer, the BERT and pre-LN encoders with their
  embedders and cross-encoders;
- ``index``: ``FlatIndex``, ``IVFFlatIndex``, ``PQIndex``,
  ``IVFPQIndex`` and ``HNSWIndex``;
- ``search``: the rerankers.

Every index and model constructor takes a ``device`` (default from
``config.device``, ``"cuda"``): entry points run on the card unless the
caller asks for the CPU (``device="cpu"`` or ``configure(device="cpu")``),
and nothing picks the CPU on its own.
"""

from neurondb_tpu_torch.version import __version__
from neurondb_tpu_torch.config import (NDBConfig, configure, get_config,
                                       set_config)
from neurondb_tpu_torch.index.base import (quantize_queries_int4,
                                           quantize_queries_int8,
                                           quantize_queries_int12)
from neurondb_tpu_torch.index.flat import FlatIndex
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
    "quantize_queries_int4",
    "quantize_queries_int8",
    "quantize_queries_int12",
    "FlatIndex",
    "IVFFlatIndex",
    "PQIndex",
    "IVFPQIndex",
    "HNSWIndex",
]
