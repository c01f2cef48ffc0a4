"""Model registry — the ml_models catalog, files instead of bytea rows.

Counterpart of ``neurondb_tpu/ml/registry.py``. Reference: models
serialize to bytea in ``neurondb.ml_models`` with hyperparameters and
metrics as JSONB, versioning and a status lifecycle
(NeuronDB/sql/ml_schema.sql:20-36; model_versions :103), managed by
neurondb_train/deploy/load_model (src/ml/ml_unified_api.c:52-56).

A model is a container tree (dict / list / tuple) over tensor, string and
scalar leaves, plus metadata. The registry keeps models in memory and,
under a root directory, persists each as ``model_NNNNNN/`` holding
``weights.npz`` (one ``leaf_i`` array a leaf), ``structure.json`` (the
tree, no pickle) and ``manifest.json``: the JAX package's format, so a
model either package persisted loads in the other.

Divergences:

- leaves load as tensors on the registry's ``device`` (default
  ``config.device``); a string leaf loads as a Python ``str`` (the JAX
  registry returns a 0-d numpy string array, which compares and prints
  as that string). Tensors are written as numpy arrays (bf16 as f32:
  npz cannot hold bf16);
- ``weights.npz`` is written uncompressed (``np.savez``; the JAX package
  compresses). ``np.load`` reads either, so both registries load both; a
  kNN model carries its whole training table, which zlib would take tens
  of seconds to compress at 1M rows;
- the persistence root comes from ``NEURONDB_TORCH_MODEL_ROOT`` (the JAX
  package reads ``NEURONDB_TPU_MODEL_ROOT``), under the port's prefix.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device


@dataclass
class ModelRecord:
    model_id: int
    project: str
    algorithm: str
    model: Any                      # tree of tensors + python scalars
    hyperparams: Dict[str, Any] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)
    version: int = 1
    status: str = "trained"         # trained | deployed | archived
    created_at: float = field(default_factory=time.time)


def _encode_tree(obj: Any, leaves: List[Any]) -> Any:
    """Encode a container tree (dict/list/tuple over array/scalar leaves)
    as a JSON-safe structure; leaves are appended to ``leaves`` and
    referenced by index."""
    if isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            if not isinstance(k, (str, int, float, bool)):
                raise TypeError(f"unsupported dict key type "
                                f"{type(k).__name__} in model pytree")
            items.append([k, _encode_tree(v, leaves)])
        return {"t": "dict", "items": items}
    if isinstance(obj, (list, tuple)):
        kind = "tuple" if isinstance(obj, tuple) else "list"
        return {"t": kind, "items": [_encode_tree(v, leaves) for v in obj]}
    if obj is None:
        return {"t": "none"}
    leaves.append(obj)
    return {"t": "leaf", "i": len(leaves) - 1}


def _decode_tree(node: Any, leaves: List[Any]) -> Any:
    t = node["t"]
    if t == "dict":
        return {k: _decode_tree(v, leaves) for k, v in node["items"]}
    if t == "list":
        return [_decode_tree(v, leaves) for v in node["items"]]
    if t == "tuple":
        return tuple(_decode_tree(v, leaves) for v in node["items"])
    if t == "none":
        return None
    return leaves[node["i"]]


def _leaf_to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _leaf_from_numpy(a: np.ndarray, device: torch.device) -> Any:
    if a.dtype.kind in "US":
        return str(a[()]) if a.ndim == 0 else a
    return torch.from_numpy(np.array(a)).to(device)   # keeps 0-d shapes


def tree_to(obj: Any, device: torch.device) -> Any:
    """The same tree with every tensor leaf on ``device`` (no copy of a
    leaf already there)."""
    if isinstance(obj, dict):
        return {k: tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_to(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


class ModelRegistry:
    def __init__(self, root: Optional[str] = None, *, device=None):
        self.root = root
        self.device = resolve_device(device)
        self._models: Dict[int, ModelRecord] = {}
        self._next = 1
        self._lock = threading.Lock()

    def register(self, project: str, algorithm: str, model: Any,
                 hyperparams: Optional[Dict] = None,
                 metrics: Optional[Dict] = None) -> int:
        with self._lock:
            mid = self._next
            self._next += 1
            versions = [r for r in self._models.values()
                        if r.project == project and r.algorithm == algorithm]
            rec = ModelRecord(mid, project, algorithm, model,
                              hyperparams or {}, metrics or {},
                              version=len(versions) + 1)
            self._models[mid] = rec
            if self.root:
                self._persist(rec)
            return mid

    def get(self, model_id: int) -> ModelRecord:
        rec = self._models.get(model_id)
        if rec is None and self.root:
            rec = self._load_from_disk(model_id)
        if rec is None:
            raise KeyError(f"model {model_id} not found")
        return rec

    def deploy(self, model_id: int) -> None:
        self.get(model_id).status = "deployed"

    def archive(self, model_id: int) -> None:
        self.get(model_id).status = "archived"

    def delete(self, model_id: int) -> None:
        self._models.pop(model_id, None)

    def list(self, project: Optional[str] = None) -> List[Dict[str, Any]]:
        out = []
        for r in self._models.values():
            if project and r.project != project:
                continue
            out.append({"model_id": r.model_id, "project": r.project,
                        "algorithm": r.algorithm, "version": r.version,
                        "status": r.status, "metrics": r.metrics})
        return out

    # ---- persistence ----
    def _path(self, model_id: int) -> str:
        return os.path.join(self.root, f"model_{model_id:06d}")

    def _persist(self, rec: ModelRecord) -> None:
        path = self._path(rec.model_id)
        os.makedirs(path, exist_ok=True)
        leaves: List[Any] = []
        structure = _encode_tree(rec.model, leaves)
        np.savez(os.path.join(path, "weights.npz"),
                 **{f"leaf_{i}": _leaf_to_numpy(l)
                    for i, l in enumerate(leaves)})
        # the tree as JSON, not a pickled treedef: loading a model dir
        # from an untrusted root must not execute code
        with open(os.path.join(path, "structure.json"), "w") as f:
            json.dump(structure, f)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"model_id": rec.model_id, "project": rec.project,
                       "algorithm": rec.algorithm,
                       "hyperparams": rec.hyperparams, "metrics": rec.metrics,
                       "version": rec.version, "status": rec.status,
                       "created_at": rec.created_at}, f, indent=2, default=str)

    def _load_from_disk(self, model_id: int) -> Optional[ModelRecord]:
        path = self._path(model_id)
        if not os.path.isdir(path):
            return None
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "weights.npz")) as data:
            leaves = [_leaf_from_numpy(data[f"leaf_{i}"], self.device)
                      for i in range(len(data.files))]
        with open(os.path.join(path, "structure.json")) as f:
            structure = json.load(f)
        model = _decode_tree(structure, leaves)
        rec = ModelRecord(meta["model_id"], meta["project"], meta["algorithm"],
                          model, meta["hyperparams"], meta["metrics"],
                          meta["version"], meta["status"], meta["created_at"])
        self._models[model_id] = rec
        self._next = max(self._next, model_id + 1)
        return rec


_registry: Optional[ModelRegistry] = None
_reg_lock = threading.Lock()


def get_registry() -> ModelRegistry:
    global _registry
    with _reg_lock:
        if _registry is None:
            _registry = ModelRegistry(
                os.environ.get("NEURONDB_TORCH_MODEL_ROOT"))
        return _registry


def set_registry(registry: Optional[ModelRegistry]) -> None:
    """Replace the process-wide registry (``None``: a fresh one at the
    next ``get_registry``)."""
    global _registry
    with _reg_lock:
        _registry = registry
