"""Services: the LLM gateway and the embedding service.

The counterparts of ``neurondb_tpu/service/llm.py`` and ``embeddings.py``;
REST, MCP, the agent, the workers and tenancy wait for ROADMAP queue 1
item 16.
"""

from neurondb_tpu_torch.service.llm import LLMRouter, LLMCache  # noqa: F401
from neurondb_tpu_torch.service.embeddings import EmbeddingService  # noqa: F401
