"""Distribution over a mesh of torch devices: sharded search and k-means.

Counterpart of ``neurondb_tpu/parallel``. The reference's SQL shard
fan-out (NeuronDB/src/util/distributed.c:53-180: per-shard queries and a
host merge of k * nshards candidates) becomes stores and posting lists
sharded over a ``parallel.mesh.Mesh`` of devices in one process, each
shard's local top-k on its device (the IVF shards on the probe kernel,
the IVF-PQ shards on the fused PQ kernel, the HNSW shards' bootstrap on
the grouped kernel), and a merge of the partial results in the mesh's
fixed shard order on the lead device.
"""

from neurondb_tpu_torch.parallel.mesh import local_mesh, make_mesh  # noqa: F401
from neurondb_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedFlatIndex,
    ShardedIVFIndex,
    sharded_kmeans_step,
    sharded_knn,
)
from neurondb_tpu_torch.parallel.sharded_hnsw import (  # noqa: F401
    ShardedHNSWIndex,
)
from neurondb_tpu_torch.parallel.sharded_ivfpq import (  # noqa: F401
    ShardedIVFPQIndex,
)
from neurondb_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostFlatIndex,
    MultiHostIVFIndex,
    kmeans_fit_2d,
    knn_2d,
    make_mesh_2d,
)
