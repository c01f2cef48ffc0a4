"""Service layer: LLM gateway, embeddings, REST API, MCP server, workers.

The counterpart of ``neurondb_tpu/service``: the LLM router, the
embedding service, the agent runtime, the REST server with its
micro-batcher and WebSocket route, the MCP server with its middleware
and extra tools, metrics, tenancy, the background workers, data
management and the ONNX gateway, all over the port's engine on
``config.device``.
"""

from neurondb_tpu_torch.service.llm import LLMRouter, LLMCache  # noqa: F401
from neurondb_tpu_torch.service.embeddings import EmbeddingService  # noqa: F401
