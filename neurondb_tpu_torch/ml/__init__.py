"""ML runtime — train/predict/evaluate over the model registry, and the
encoders and decoders the search and serving layers use.

Counterpart of ``neurondb_tpu/ml``: the unified API (``api``) maps an
algorithm name to its trainer (``algorithms``) and keeps the models in
the ``registry``.
"""

from neurondb_tpu_torch.ml.registry import ModelRegistry, get_registry  # noqa: F401
from neurondb_tpu_torch.ml.api import (deploy, evaluate, load_model,  # noqa: F401
                                       predict, train)
