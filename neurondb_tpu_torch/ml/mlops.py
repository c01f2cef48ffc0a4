"""MLOps catalog — A/B tests, model monitoring, audit log, experiments,
feature flags.

A copy of ``neurondb_tpu/ml/mlops.py``, which imports no JAX (numpy
only): the port keeps its own so it never loads the JAX package.
Reference: the catalog tables in NeuronDB/sql/ml_schema.sql:10-196
managed by src/ml/ml_mlops_advanced.c, as in-process services over the
model registry, persisted as JSON when a root directory is configured.
No divergence: the same code, the same host numpy draws.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# A/B tests (ml_schema.sql ab_tests)
# ---------------------------------------------------------------------------

@dataclass
class ABTest:
    name: str
    model_a: int
    model_b: int
    traffic_split: float = 0.5          # share routed to B
    status: str = "running"             # running | concluded
    created_at: float = field(default_factory=time.time)
    exposures: Dict[str, int] = field(
        default_factory=lambda: {"a": 0, "b": 0})
    successes: Dict[str, int] = field(
        default_factory=lambda: {"a": 0, "b": 0})
    winner: Optional[str] = None


class ABTestManager:
    def __init__(self, seed: int = 0):
        self._tests: Dict[str, ABTest] = {}
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def create(self, name: str, model_a: int, model_b: int,
               traffic_split: float = 0.5) -> ABTest:
        if not 0.0 <= traffic_split <= 1.0:
            raise ValueError("traffic_split must be in [0, 1]")
        t = ABTest(name, model_a, model_b, traffic_split)
        with self._lock:
            self._tests[name] = t
        return t

    def route(self, name: str) -> int:
        """Pick the model for one request and record the exposure."""
        t = self._tests[name]
        if t.status != "running":
            arm = t.winner or "a"
        else:
            arm = "b" if self._rng.random() < t.traffic_split else "a"
            t.exposures[arm] += 1
        return t.model_b if arm == "b" else t.model_a

    def record_outcome(self, name: str, model_id: int,
                       success: bool) -> None:
        t = self._tests[name]
        arm = "b" if model_id == t.model_b else "a"
        if success:
            t.successes[arm] += 1

    def evaluate(self, name: str, *, z_threshold: float = 1.96) -> Dict:
        """Two-proportion z-test over the recorded conversions."""
        t = self._tests[name]
        na, nb = max(t.exposures["a"], 1), max(t.exposures["b"], 1)
        pa, pb = t.successes["a"] / na, t.successes["b"] / nb
        p = (t.successes["a"] + t.successes["b"]) / (na + nb)
        se = math.sqrt(max(p * (1 - p) * (1 / na + 1 / nb), 1e-12))
        z = (pb - pa) / se
        significant = abs(z) >= z_threshold
        return {"name": name, "rate_a": pa, "rate_b": pb, "z": z,
                "significant": significant,
                "preferred": "b" if z > 0 else "a"}

    def conclude(self, name: str) -> Dict:
        t = self._tests[name]
        res = self.evaluate(name)
        t.status = "concluded"
        t.winner = res["preferred"] if res["significant"] else "a"
        return {**res, "winner": t.winner}

    def list(self) -> List[Dict]:
        return [{"name": t.name, "status": t.status,
                 "split": t.traffic_split, "exposures": dict(t.exposures),
                 "winner": t.winner} for t in self._tests.values()]


# ---------------------------------------------------------------------------
# model monitoring + drift (model_monitoring, drift_detection)
# ---------------------------------------------------------------------------

class ModelMonitor:
    """Streaming feature/prediction statistics vs a training baseline,
    with PSI-based drift alarms."""

    def __init__(self, model_id: int, baseline_X: np.ndarray, *,
                 bins: int = 10, psi_alert: float = 0.2):
        X = np.asarray(baseline_X, np.float32)
        self.model_id = model_id
        self.bins = bins
        self.psi_alert = psi_alert
        # per-feature quantile bin edges from the baseline
        qs = np.linspace(0, 1, bins + 1)[1:-1]
        self._edges = np.quantile(X, qs, axis=0)          # [bins-1, D]
        self._base_hist = self._histogram(X)
        self._live_counts = np.zeros_like(self._base_hist)
        self._n_pred = 0
        self._pred_sum = 0.0
        self._pred_sq = 0.0
        self.alerts: List[Dict] = []

    def _histogram(self, X: np.ndarray) -> np.ndarray:
        D = X.shape[1]
        out = np.zeros((self.bins, D), np.float64)
        for j in range(D):
            idx = np.searchsorted(self._edges[:, j], X[:, j])
            np.add.at(out[:, j], idx, 1)
        return out / max(len(X), 1)

    def observe(self, X, predictions=None) -> Optional[Dict]:
        X = np.atleast_2d(np.asarray(X, np.float32))
        for j in range(X.shape[1]):
            idx = np.searchsorted(self._edges[:, j], X[:, j])
            np.add.at(self._live_counts[:, j], idx, 1)
        if predictions is not None:
            p = np.asarray(predictions, np.float64).ravel()
            self._n_pred += len(p)
            self._pred_sum += p.sum()
            self._pred_sq += (p * p).sum()
        psi = self.psi()
        worst = float(psi.max()) if psi.size else 0.0
        if worst > self.psi_alert:
            alert = {"ts": time.time(), "model_id": self.model_id,
                     "psi": worst,
                     "feature": int(np.argmax(psi))}
            self.alerts.append(alert)
            return alert
        return None

    def psi(self) -> np.ndarray:
        """Population Stability Index per feature vs the baseline."""
        total = self._live_counts.sum(axis=0, keepdims=True)
        if (total == 0).all():
            return np.zeros(self._base_hist.shape[1])
        live = self._live_counts / np.maximum(total, 1)
        eps = 1e-6
        ratio = np.log((live + eps) / (self._base_hist + eps))
        return ((live - self._base_hist) * ratio).sum(axis=0)

    def summary(self) -> Dict:
        mean = self._pred_sum / self._n_pred if self._n_pred else 0.0
        var = self._pred_sq / self._n_pred - mean * mean \
            if self._n_pred else 0.0
        psi = self.psi()
        return {"model_id": self.model_id, "n_predictions": self._n_pred,
                "pred_mean": mean, "pred_std": math.sqrt(max(var, 0.0)),
                "psi_max": float(psi.max()) if psi.size else 0.0,
                "alerts": len(self.alerts)}


# ---------------------------------------------------------------------------
# audit log (model_audit_log)
# ---------------------------------------------------------------------------

class AuditLog:
    """Append-only model lifecycle events; JSONL-persisted when a path
    is given."""

    def __init__(self, path: Optional[str] = None, keep: int = 10000):
        self.path = path
        self._events: List[Dict] = []
        self._keep = keep
        self._lock = threading.Lock()

    def record(self, action: str, *, model_id: Optional[int] = None,
               actor: str = "system", detail: Optional[Dict] = None
               ) -> Dict:
        ev = {"id": str(uuid.uuid4()), "ts": time.time(),
              "action": action, "model_id": model_id, "actor": actor,
              "detail": detail or {}}
        with self._lock:
            self._events.append(ev)
            del self._events[:-self._keep]
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(ev) + "\n")
        return ev

    def query(self, *, action: Optional[str] = None,
              model_id: Optional[int] = None,
              since: Optional[float] = None) -> List[Dict]:
        out = self._events
        if action is not None:
            out = [e for e in out if e["action"] == action]
        if model_id is not None:
            out = [e for e in out if e["model_id"] == model_id]
        if since is not None:
            out = [e for e in out if e["ts"] >= since]
        return list(out)


# ---------------------------------------------------------------------------
# experiments (ml_experiments + experiment_metrics)
# ---------------------------------------------------------------------------

class ExperimentTracker:
    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._runs: Dict[str, Dict] = {}
        self._lock = threading.Lock()

    def start_run(self, project: str, *, params: Optional[Dict] = None,
                  name: Optional[str] = None) -> str:
        rid = name or str(uuid.uuid4())[:8]
        with self._lock:
            self._runs[rid] = {"run_id": rid, "project": project,
                               "params": params or {}, "metrics": {},
                               "history": [], "status": "running",
                               "started_at": time.time()}
        return rid

    def log_metric(self, run_id: str, name: str, value: float,
                   step: Optional[int] = None) -> None:
        r = self._runs[run_id]
        r["metrics"][name] = float(value)
        r["history"].append({"metric": name, "value": float(value),
                             "step": step, "ts": time.time()})

    def finish_run(self, run_id: str, status: str = "done") -> Dict:
        r = self._runs[run_id]
        r["status"] = status
        r["finished_at"] = time.time()
        if self.root:
            os.makedirs(self.root, exist_ok=True)
            with open(os.path.join(self.root,
                                   f"run_{run_id}.json"), "w") as f:
                json.dump(r, f, indent=2)
        return r

    def best_run(self, project: str, metric: str,
                 maximize: bool = True) -> Optional[Dict]:
        cands = [r for r in self._runs.values()
                 if r["project"] == project and metric in r["metrics"]]
        if not cands:
            return None
        return (max if maximize else min)(
            cands, key=lambda r: r["metrics"][metric])

    def list_runs(self, project: Optional[str] = None) -> List[Dict]:
        return [{"run_id": r["run_id"], "project": r["project"],
                 "status": r["status"], "metrics": dict(r["metrics"])}
                for r in self._runs.values()
                if project is None or r["project"] == project]


# ---------------------------------------------------------------------------
# feature flags (feature_flags)
# ---------------------------------------------------------------------------

class FeatureFlags:
    def __init__(self):
        self._flags: Dict[str, Dict] = {}

    def set(self, name: str, *, enabled: bool = True,
            rollout: float = 1.0) -> None:
        self._flags[name] = {"enabled": enabled,
                             "rollout": float(rollout)}

    def enabled(self, name: str, *, subject: str = "") -> bool:
        f = self._flags.get(name)
        if not f or not f["enabled"]:
            return False
        if f["rollout"] >= 1.0:
            return True
        # deterministic per-subject bucketing
        import hashlib
        h = int(hashlib.sha256(f"{name}:{subject}".encode())
                .hexdigest()[:8], 16) / 0xFFFFFFFF
        return h < f["rollout"]

    def list(self) -> Dict[str, Dict]:
        return dict(self._flags)
