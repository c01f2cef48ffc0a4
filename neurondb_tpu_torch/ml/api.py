"""Unified ML API — neurondb_train/predict/evaluate/deploy/load_model.

Counterpart of ``neurondb_tpu/ml/api.py``. Reference:
NeuronDB/src/ml/ml_unified_api.c:52-93 — one entry point that maps an
algorithm name to a trainer, runs it, packs the model into the catalog,
and mirror functions for predict/evaluate/deploy.

Each algorithm registers a ``Trainer`` (train/predict/evaluate callables
over tensors) through ``register_algorithm`` (``ml/algorithms.py``).
``train`` returns a model id in the process-wide registry
(``get_registry()``; ``set_registry`` replaces it). Every entry point
takes a ``device`` (default ``config.device``) and runs the algorithm
there.

Divergences:

- inputs are cast as ``jnp.asarray`` casts them with x64 off: float64 to
  float32, int64 to int32 (other dtypes kept), then moved to ``device``;
  ``predict`` and ``evaluate`` move the model's tensors to ``device``;
- ``train`` swallows only the evaluator's own errors (``ValueError``,
  ``TypeError``, ``KeyError``, ``ZeroDivisionError``), where the JAX
  package swallows any exception: a ``RuntimeError`` (a CUDA launch
  error, ``torch.OutOfMemoryError``) propagates;
- none in the names: every algorithm the JAX package registers is
  registered here under the same name, ``list_algorithms`` returns the
  same list, and each alias resolves to the same trainer (``xgboost``,
  ``lightgbm`` and ``catboost`` alias ``gradient_boosting``, as in the
  JAX package, so their own trainers are reached only by a record that
  names them); an unknown name raises ``ValueError``;
- ``predict`` and ``evaluate`` take a record's trainer by the exact name
  it was registered under before the aliases (``_record_trainer``): the
  JAX package resolves the record's name through the aliases first, so a
  model its registry holds as ``xgboost`` (``tests/data/
  jax_registry_ml2``) predicts through ``gradient_boosting`` there and
  fails.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ml.registry import get_registry, tree_to


@dataclass
class Trainer:
    name: str
    train: Callable[..., Any]                    # (X, y?, **hp) -> model tree
    predict: Callable[..., Any]                  # (model, X) -> predictions
    evaluate: Optional[Callable[..., Dict]] = None   # (model, X, y?) -> metrics
    task: str = "supervised"                     # supervised | unsupervised


_ALGORITHMS: Dict[str, Trainer] = {}

# Name aliases matching the reference's algorithm-from-string mapping
# (ml_unified_api.c:60-93), and the neural-network ones the JAX package's
# algorithms module adds.
_ALIASES = {
    "linreg": "linear_regression",
    "logreg": "logistic_regression",
    "logistic": "logistic_regression",
    "rf": "random_forest",
    "dt": "decision_tree",
    "gbt": "gradient_boosting",
    "xgboost": "gradient_boosting",
    "lightgbm": "gradient_boosting",
    "catboost": "gradient_boosting",
    "nb": "naive_bayes",
    "gaussian_nb": "naive_bayes",
    "knn": "knn_classifier",
    "pca_whitening": "pca",
    "minibatch-kmeans": "minibatch_kmeans",
    "mlp": "neural_network",
    "deeplearning": "neural_network",
    "deep_learning": "neural_network",
}


def register_algorithm(trainer: Trainer) -> Trainer:
    _ALGORITHMS[trainer.name] = trainer
    return trainer


def _resolve(algorithm: str) -> Trainer:
    _ensure_loaded()
    name = _ALIASES.get(algorithm.lower(), algorithm.lower())
    if name not in _ALGORITHMS:
        known = ", ".join(sorted(_ALGORITHMS))
        raise ValueError(f"unknown algorithm {algorithm!r}; known: {known}")
    return _ALGORITHMS[name]


_loaded = False


def _ensure_loaded() -> None:
    """Import the algorithm module so its registrations run."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from neurondb_tpu_torch.ml import algorithms  # noqa: F401  (registers all)


def list_algorithms() -> List[str]:
    _ensure_loaded()
    return sorted(_ALGORITHMS)


_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32}


def as_input(a, device: torch.device) -> torch.Tensor:
    """``jnp.asarray(a)`` with x64 off, on ``device``: float64 becomes
    float32 and int64 int32."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        # the tensor must not share the caller's memory (jnp.asarray
        # copies); the upload to a card copies a contiguous array anyway
        shared = (device.type != "cpu" and a.ndim and a.flags.c_contiguous
                  and a.flags.writeable)
        a = torch.from_numpy(a if shared else np.array(a))
    return a.to(device=device, dtype=_X64_OFF.get(a.dtype, a.dtype))


def train(project: str, algorithm: str, X, y=None,
          hyperparams: Optional[Dict[str, Any]] = None, *,
          device=None) -> int:
    """Train and register; returns model_id (neurondb_train parity)."""
    t = _resolve(algorithm)
    dev = resolve_device(device)
    hp = dict(hyperparams or {})
    X = as_input(X, dev)
    t0 = time.time()
    if t.task == "unsupervised":
        model = t.train(X, **hp)
    else:
        if y is None:
            raise ValueError(f"{algorithm} requires a target")
        y = as_input(y, dev)
        model = t.train(X, y, **hp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    metrics: Dict[str, Any] = {"train_seconds": wall}
    if t.evaluate is not None:
        try:
            ev = t.evaluate(model, X, y) if t.task != "unsupervised" \
                else t.evaluate(model, X)
            metrics.update({k: float(v) for k, v in ev.items()})
        except (ValueError, TypeError, KeyError, ZeroDivisionError):
            pass
    return get_registry().register(project, t.name, model, hp, metrics)


def _record_trainer(rec) -> Trainer:
    """The trainer a registry record names: its exact name first, then
    the aliases."""
    _ensure_loaded()
    return _ALGORITHMS.get(rec.algorithm) or _resolve(rec.algorithm)


def predict(model_id: int, X, *, device=None) -> np.ndarray:
    rec = get_registry().get(model_id)
    t = _record_trainer(rec)
    dev = resolve_device(device)
    out = t.predict(tree_to(rec.model, dev), as_input(X, dev))
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else \
        np.asarray(out)


def evaluate(model_id: int, X, y=None, *,
             device=None) -> Dict[str, float]:
    rec = get_registry().get(model_id)
    t = _record_trainer(rec)
    if t.evaluate is None:
        raise ValueError(f"{rec.algorithm} has no evaluator")
    dev = resolve_device(device)
    ev = t.evaluate(tree_to(rec.model, dev), as_input(X, dev),
                    None if y is None else as_input(y, dev))
    return {k: float(v) for k, v in ev.items()}


def deploy(model_id: int) -> None:
    get_registry().deploy(model_id)


def load_model(model_id: int):
    return get_registry().get(model_id).model
