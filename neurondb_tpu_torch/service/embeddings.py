"""Embedding service: embed_text / batch / cached, images, multimodal,
and model-config CRUD.

Counterpart of ``neurondb_tpu/service/embeddings.py``: text goes through
the LLM router's embed op (by default ``LocalProvider`` on the port's
encoder), cached through ``LLMCache``. ``embed_image`` runs an installed
``ml.vision.VisionEncoder`` (``set_vision_encoder``), else a byte-histogram
projection that keeps multimodal pipelines runnable without weights.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from neurondb_tpu_torch.service.llm import LLMCache, LLMRouter, LocalProvider


@dataclass
class EmbeddingModelConfig:
    name: str
    provider: str = "local"
    dim: int = 256
    max_len: int = 128
    params: Dict = field(default_factory=dict)


class EmbeddingService:
    def __init__(self, router: Optional[LLMRouter] = None):
        self.router = router or LLMRouter([LocalProvider()])
        self.cache = LLMCache()
        self._configs: Dict[str, EmbeddingModelConfig] = {
            "default": EmbeddingModelConfig("default")}
        self._lock = threading.Lock()
        self._vision = None

    def set_vision_encoder(self, encoder) -> None:
        """Install an ``ml.vision.VisionEncoder`` (e.g. real ViT weights
        through ``VisionEncoder.from_npz``): ``embed_image`` then runs the
        vision transformer instead of the histogram projection."""
        self._vision = encoder

    # ---- model-config CRUD (embeddings.c:1233-1687) ----
    def add_model(self, cfg: EmbeddingModelConfig) -> None:
        with self._lock:
            self._configs[cfg.name] = cfg

    def get_model(self, name: str) -> EmbeddingModelConfig:
        return self._configs[name]

    def list_models(self) -> List[str]:
        return sorted(self._configs)

    def delete_model(self, name: str) -> None:
        if name == "default":
            raise ValueError("cannot delete the default model")
        with self._lock:
            self._configs.pop(name, None)

    # ---- embedding ops ----
    def embed_text(self, text: str, model: str = "default") -> np.ndarray:
        return self.embed_batch([text], model)[0]

    def embed_batch(self, texts: Sequence[str],
                    model: str = "default") -> np.ndarray:
        self.get_model(model)  # validate
        return np.asarray(self.router.embed(list(texts)), np.float32)

    def embed_cached(self, text: str, model: str = "default") -> np.ndarray:
        hit = self.cache.get("embed1", [model, text])
        if hit is not None:
            return hit
        out = self.embed_text(text, model)
        self.cache.put("embed1", [model, text], out)
        return out

    def embed_image(self, image_bytes: bytes,
                    model: str = "default") -> np.ndarray:
        """Image embedding, unit norm, cut or zero-padded to the model
        config's ``dim``: the installed ViT's CLS vector, else a
        byte-histogram projection."""
        cfg = self.get_model(model)
        if self._vision is not None:
            v = np.asarray(self._vision.embed_bytes(image_bytes),
                           np.float32)
            if v.shape[0] >= cfg.dim:
                v = v[: cfg.dim]
            else:
                v = np.pad(v, (0, cfg.dim - v.shape[0]))
            return v / max(np.linalg.norm(v), 1e-12)
        hist = np.bincount(np.frombuffer(image_bytes, np.uint8),
                           minlength=256).astype(np.float32)
        hist /= max(hist.sum(), 1.0)
        rng = np.random.default_rng(42)
        proj = rng.standard_normal((256, cfg.dim)).astype(np.float32)
        v = hist @ proj
        return v / max(np.linalg.norm(v), 1e-12)

    def embed_multimodal(self, text: str, image_bytes: Optional[bytes],
                         model: str = "default") -> np.ndarray:
        t = self.embed_text(text, model)
        if image_bytes is None:
            return t
        i = self.embed_image(image_bytes, model)
        v = (t + i) / 2.0
        return v / max(np.linalg.norm(v), 1e-12)
