"""ONNX model runtime — session cache + inference gateway.

Reference: NeuronDB/src/onnx/neurondb_onnx.c (ORT C-API wrapper with env
init, session options/threads, CPU/CUDA/TensorRT/CoreML execution
providers, LRU session cache) and neurondb_hf.c (HF model loading).

onnxruntime is not part of this build environment; the runtime detects it
at import time. When absent, sessions raise a clear error while the rest
of the framework keeps working — the local transformer
(ml/transformer.py) is the bundled inference path. When a model exports
as an .npz state dict, ``load_npz_encoder`` turns it into the native
encoder instead (the zero-egress equivalent of the ONNX export tooling in
src/onnx/hf_onex.py).

Counterpart of ``neurondb_tpu/service/onnx_runtime.py``: gated on
``onnxruntime`` being importable as there, with the same provider
priority; ``load_npz_encoder`` builds the port's ``TextEmbedder`` on
``device`` (default ``config.device``).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

import numpy as np

try:
    import onnxruntime as ort  # type: ignore
    HAVE_ORT = True
except ImportError:           # pragma: no cover - not in this image
    ort = None
    HAVE_ORT = False

# Execution-provider priority (neurondb_onnx.c EP selection order:
# TensorRT > CUDA > CoreML > CPU). The first requested provider that the
# runtime actually offers wins; CPU is always appended as the fallback.
EP_PRIORITY = [
    "TensorrtExecutionProvider",
    "CUDAExecutionProvider",
    "CoreMLExecutionProvider",
    "CPUExecutionProvider",
]


def _runtime():
    """The active runtime module (tests may inject a stub)."""
    return ort


def set_runtime(module) -> None:
    """Install an onnxruntime-compatible module (dependency injection —
    also how the EP/session logic is tested without ort installed)."""
    global ort, HAVE_ORT
    ort = module
    HAVE_ORT = module is not None


def select_providers(requested: Optional[List[str]] = None,
                     available: Optional[List[str]] = None) -> List[str]:
    """Pick providers in priority order from what the runtime offers
    (EP fallback semantics of neurondb_onnx.c:127-136)."""
    if available is None:
        if not HAVE_ORT:
            return ["CPUExecutionProvider"]
        available = list(ort.get_available_providers())
    want = list(requested) if requested else EP_PRIORITY
    chosen = [p for p in want if p in available]
    if ("CPUExecutionProvider" not in chosen
            and "CPUExecutionProvider" in available):
        chosen.append("CPUExecutionProvider")
    return chosen or ["CPUExecutionProvider"]


class ONNXSessionCache:
    """LRU cache of inference sessions (neurondb_onnx.c session cache)."""

    def __init__(self, max_sessions: int = 4,
                 providers: Optional[List[str]] = None,
                 intra_op_threads: int = 0,
                 inter_op_threads: int = 0,
                 optimization_level: str = "all"):
        self.max_sessions = max_sessions
        self.providers = providers
        self.intra_op_threads = intra_op_threads
        self.inter_op_threads = inter_op_threads
        self.optimization_level = optimization_level
        self._cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, model_path: str):
        if not HAVE_ORT:
            raise RuntimeError(
                "onnxruntime is not installed in this environment; use the "
                "bundled transformer runtime (neurondb_tpu_torch.ml.transformer) "
                "or install onnxruntime")
        with self._lock:
            if model_path in self._cache:
                self._cache.move_to_end(model_path)
                self.hits += 1
                return self._cache[model_path]
            self.misses += 1
            opts = ort.SessionOptions()
            if self.intra_op_threads:
                opts.intra_op_num_threads = self.intra_op_threads
            if self.inter_op_threads:
                opts.inter_op_num_threads = self.inter_op_threads
            lvl = getattr(ort, "GraphOptimizationLevel", None)
            if lvl is not None and hasattr(opts,
                                           "graph_optimization_level"):
                opts.graph_optimization_level = {
                    "none": getattr(lvl, "ORT_DISABLE_ALL", None),
                    "basic": getattr(lvl, "ORT_ENABLE_BASIC", None),
                    "all": getattr(lvl, "ORT_ENABLE_ALL", None),
                }.get(self.optimization_level) or \
                    getattr(lvl, "ORT_ENABLE_ALL", None)
            sess = ort.InferenceSession(
                model_path, opts,
                providers=select_providers(self.providers))
            self._cache[model_path] = sess
            while len(self._cache) > self.max_sessions:
                self._cache.popitem(last=False)
            return sess

    def evict(self, model_path: str) -> None:
        with self._lock:
            self._cache.pop(model_path, None)

    def stats(self) -> Dict[str, int]:
        return {"sessions": len(self._cache), "hits": self.hits,
                "misses": self.misses}


_cache = ONNXSessionCache()


def onnx_predict(model_path: str, inputs: Dict[str, np.ndarray],
                 output_names: Optional[List[str]] = None) -> List[np.ndarray]:
    """Run an ONNX model (neurondb_onnx predict surface)."""
    sess = _cache.get(model_path)
    return sess.run(output_names, inputs)


def onnx_embed_text(model_path: str, token_ids: np.ndarray,
                    attention_mask: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """Sentence embeddings from an exported encoder: mean-pool the last
    hidden state under the attention mask."""
    if attention_mask is None:
        attention_mask = (token_ids > 0).astype(np.int64)
    out = onnx_predict(model_path, {
        "input_ids": token_ids.astype(np.int64),
        "attention_mask": attention_mask.astype(np.int64)})
    hidden = out[0]                                  # [B, S, H]
    m = attention_mask[:, :, None].astype(np.float32)
    pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1.0)
    return pooled / np.maximum(
        np.linalg.norm(pooled, axis=1, keepdims=True), 1e-12)


def load_npz_encoder(path: str, device=None):
    """Load an exported .npz encoder into the native transformer runtime
    (the zero-egress counterpart of the ONNX export flow)."""
    from neurondb_tpu_torch.config import resolve_device
    from neurondb_tpu_torch.ml.transformer import TextEmbedder, load_params_npz
    dev = resolve_device(device)
    return TextEmbedder(load_params_npz(path, device=dev), device=dev)
