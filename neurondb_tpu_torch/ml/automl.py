"""AutoML + hyperparameter tuning — algorithm selection by CV search.

Counterpart of ``neurondb_tpu/ml/automl.py`` (which imports no JAX).
Reference: NeuronDB/src/ml/ml_automl.c, ml_hyperparameter_tuning.c:
train candidate algorithms over a grid with k-fold validation, pick the
best by the task's metric, and register the winner. Candidates come from
the port's dispatch table (``ml/api.py``), the folds from host numpy
with the same seeds, so the folds equal the JAX package's.

Divergences: each fold's training and prediction run through the port's
trainers on ``device`` (default ``config.device``): the inputs move
there once; predictions come back to the host for scoring. ``automl``
skips a candidate that raises, as the JAX package does, but lets a
``RuntimeError`` (a CUDA launch error, out of memory) propagate.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device

DEFAULT_SPACES: Dict[str, Dict[str, Dict[str, List]]] = {
    "classify": {
        "logistic_regression": {"l2": [1e-4, 1e-2], "iters": [30]},
        "random_forest": {"n_trees": [20], "depth": [4, 6]},
        "gradient_boosting": {"n_trees": [30], "depth": [3, 4],
                              "learning_rate": [0.1]},
        "naive_bayes": {},
        "knn_classifier": {"k": [3, 7]},
        "svm": {"C": [1.0], "iters": [200]},
    },
    "regress": {
        "linear_regression": {},
        "ridge": {"alpha": [0.1, 1.0]},
        "lasso": {"alpha": [0.01, 0.1]},
        "gradient_boosting": {"task": ["regress"], "n_trees": [30],
                              "depth": [3, 4]},
        "knn_regressor": {"k": [3, 7]},
    },
}


def _grid(space: Dict[str, List]) -> List[Dict]:
    if not space:
        return [{}]
    keys = sorted(space)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(space[k] for k in keys))]


def _folds(n: int, folds: int, seed: int):
    """(train, validation) row indices of each fold."""
    idx = np.random.default_rng(seed).permutation(n)
    for f in range(folds):
        val = idx[f::folds]
        yield np.setdiff1d(idx, val), val


def _fold_scores(algorithm: str, hp: Dict, X: np.ndarray, y: np.ndarray,
                 task: str, folds: int, seed: int, device) -> List[float]:
    from neurondb_tpu_torch.ml.api import _resolve, as_input
    t = _resolve(algorithm)
    dev = resolve_device(device)
    Xd, yd = as_input(X, dev), as_input(y, dev)
    scores = []
    for trn, val in _folds(len(X), folds, seed):
        tr = torch.from_numpy(trn).to(dev)
        model = t.train(Xd[tr], yd[tr], **hp)
        pred = t.predict(model, Xd[torch.from_numpy(val).to(dev)])
        pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) \
            else np.asarray(pred)
        if task == "classify":
            scores.append(float((pred == y[val]).mean()))
        else:
            scores.append(-float(((pred - y[val]) ** 2).mean()))
    return scores


def hyperparameter_search(algorithm: str, X, y, space: Dict[str, List], *,
                          task: str = "classify", folds: int = 3,
                          seed: int = 0, device=None
                          ) -> Tuple[Dict, float, List[Dict]]:
    """Grid search with k-fold CV -> (best_hp, best_score, trials)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    trials = []
    best_hp: Dict = {}
    best = -np.inf
    for hp in _grid(space):
        s = float(np.mean(_fold_scores(algorithm, hp, X, y, task, folds,
                                       seed, device)))
        trials.append({"hyperparams": hp, "score": s})
        if s > best:
            best, best_hp = s, hp
    return best_hp, best, trials


def cross_validate(algorithm: str, X, y, *, task: str = "classify",
                   folds: int = 5, seed: int = 0,
                   hyperparams: Optional[Dict] = None, device=None) -> Dict:
    """k-fold cross validation: per-fold scores plus mean / std —
    accuracy for classify, negative MSE for regress."""
    if folds < 2:
        raise ValueError("folds must be >= 2")
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    scores = _fold_scores(algorithm, dict(hyperparams or {}), X, y, task,
                          folds, seed, device)
    return {"algorithm": algorithm, "folds": folds,
            "fold_scores": scores, "mean_score": float(np.mean(scores)),
            "std_score": float(np.std(scores)),
            "metric": "accuracy" if task == "classify" else "neg_mse"}


def create_ensemble(project: str, model_ids: Sequence[int], *,
                    method: str = "voting", X=None, y=None,
                    task: str = "classify") -> int:
    """Combine registered models into one ensemble model (voting,
    averaging, or stacking with a ridge meta-learner over the members'
    predictions). Returns the ensemble's model_id."""
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml.registry import get_registry
    if len(model_ids) < 2:
        raise ValueError("ensemble requires at least 2 models")
    if method not in ("voting", "averaging", "stacking"):
        raise ValueError("method must be 'voting', 'averaging', or 'stacking'")
    reg = get_registry()
    members = [reg.get(int(m)) for m in model_ids]  # validates existence
    model = {"member_ids": [int(m) for m in model_ids], "method": method,
             "task": task, "meta_w": None, "meta_b": None,
             "classes": None}
    if method == "stacking":
        if X is None or y is None:
            raise ValueError("stacking requires X, y to fit the meta-learner")
        P = np.stack([np.asarray(ML.predict(m.model_id, X), np.float32)
                      for m in members], axis=1)          # [n, n_models]
        yv = np.asarray(y, np.float32)
        A = P.T @ P + 1e-3 * np.eye(P.shape[1], dtype=np.float32)
        model["meta_w"] = np.linalg.solve(A, P.T @ yv)
        model["meta_b"] = float(yv.mean() - P.mean(0) @ model["meta_w"])
    if task == "classify" and y is not None:
        model["classes"] = np.unique(np.asarray(y))
    return reg.register(project, "ensemble", model,
                        {"method": method, "n_models": len(model_ids)},
                        {"members": list(map(int, model_ids))})


def predict_ensemble(model_id: int, X) -> np.ndarray:
    """Run every member and combine per the ensemble's method."""
    from neurondb_tpu_torch.ml import api as ML
    from neurondb_tpu_torch.ml.registry import get_registry
    m = get_registry().get(model_id).model
    P = np.stack([np.asarray(ML.predict(int(mid), X), np.float32)
                  for mid in m["member_ids"]], axis=1)
    if m["method"] == "stacking" and m["meta_w"] is not None:
        w = m["meta_w"]
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        return P @ w + float(m["meta_b"])
    if m["method"] == "voting":
        votes = P.astype(np.int64)
        out = np.empty(len(P), np.int64)
        for i, row in enumerate(votes):
            vals, cnt = np.unique(row, return_counts=True)
            out[i] = vals[np.argmax(cnt)]
        return out
    return P.mean(axis=1)


def auto_feature_engineering(X, feature_names: Optional[Sequence[str]] = None,
                             *, interactions: bool = True,
                             squares: bool = True, log1p: bool = False,
                             max_new: int = 64) -> Dict:
    """Squares, pairwise interactions and (optionally) log1p columns:
    {"X": augmented matrix, "names": column names, "n_engineered"}."""
    X = np.asarray(X, np.float32)
    n, f = X.shape
    names = list(feature_names) if feature_names else \
        [f"f{i}" for i in range(f)]
    if len(names) != f:
        raise ValueError("feature_names length mismatch")
    cols = [X]
    new_names: List[str] = []
    if squares:
        for i in range(f):
            if len(new_names) >= max_new:
                break
            cols.append((X[:, i] ** 2)[:, None])
            new_names.append(f"{names[i]}_sq")
    if interactions:
        for i in range(f):
            for j in range(i + 1, f):
                if len(new_names) >= max_new:
                    break
                cols.append((X[:, i] * X[:, j])[:, None])
                new_names.append(f"{names[i]}_x_{names[j]}")
    if log1p:
        for i in range(f):
            if len(new_names) >= max_new:
                break
            cols.append(np.log1p(np.abs(X[:, i]))[:, None])
            new_names.append(f"{names[i]}_log1p")
    Xa = np.concatenate(cols, axis=1)
    return {"X": Xa, "names": names + new_names,
            "n_engineered": len(new_names)}


def model_leaderboard(project: Optional[str] = None,
                      metric: str = "accuracy") -> List[Dict]:
    """Rank registered models by a metric; models lacking it sort last,
    ties by recency (higher model_id first)."""
    from neurondb_tpu_torch.ml.registry import get_registry
    rows = get_registry().list(project)
    for r in rows:
        v = r.get("metrics", {}).get(metric)
        r["leaderboard_metric"] = metric
        r["leaderboard_score"] = float(v) if v is not None else None
    rows.sort(key=lambda r: (
        -(r["leaderboard_score"] if r["leaderboard_score"] is not None
          else -np.inf),
        -r["model_id"]))
    for rank, r in enumerate(rows, 1):
        r["rank"] = rank
    return rows


def automl(project: str, X, y, *, task: str = "classify",
           algorithms: Optional[Sequence[str]] = None, folds: int = 3,
           seed: int = 0, register: bool = True, device=None) -> Dict:
    """Search algorithms x hyperparameters; optionally register the
    winner. Returns a leaderboard."""
    from neurondb_tpu_torch.ml import api as ML
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    space = DEFAULT_SPACES[task]
    algos = list(algorithms) if algorithms else list(space)
    board = []
    for algo in algos:
        t0 = time.time()
        try:
            hp, score, _ = hyperparameter_search(
                algo, X, y, space.get(algo, {}), task=task, folds=folds,
                seed=seed, device=device)
            board.append({"algorithm": algo, "score": score,
                          "hyperparams": hp,
                          "seconds": round(time.time() - t0, 2)})
        except (ValueError, TypeError, KeyError, IndexError,
                NotImplementedError) as e:   # skip incompatible algos
            board.append({"algorithm": algo, "score": float("-inf"),
                          "error": str(e)})
    board.sort(key=lambda r: -r["score"])
    winner = board[0]
    result = {"leaderboard": board, "best_algorithm": winner["algorithm"],
              "best_hyperparams": winner.get("hyperparams", {}),
              "best_score": winner["score"]}
    if register and np.isfinite(winner["score"]):
        result["model_id"] = ML.train(project, winner["algorithm"], X, y,
                                      winner.get("hyperparams", {}),
                                      device=device)
    return result
