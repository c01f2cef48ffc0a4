"""The indexes: flat, quantized flat, IVFFlat, PQ, IVF-PQ and HNSW."""

from neurondb_tpu_torch.index.flat import FlatIndex, QuantizedFlatIndex
from neurondb_tpu_torch.index.hnsw import HNSWIndex
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.index.ivfpq import IVFPQIndex
from neurondb_tpu_torch.index.pq import PQIndex

__all__ = ["FlatIndex", "QuantizedFlatIndex", "IVFFlatIndex", "PQIndex", "IVFPQIndex", "HNSWIndex"]
