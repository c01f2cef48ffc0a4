"""Topic discovery, LDA, explainability, feature store, analytics.

Counterpart of ``neurondb_tpu/ml/extras.py``. Reference:
NeuronDB/src/ml/ml_topic_discovery.c, ml_explainable_ai.c,
ml_feature_store.c, ml_histogram.c, ml_analytics.c. ``discover_topics``
clusters tf-idf rows with the port's k-means (``ml/kmeans.py``) over the
port's tokenizer (``search/bm25.tokenize``); ``lda_fit`` is batch
variational EM (Blei et al. 2003 / Hoffman et al. 2010) in dense
``[D, K] x [K, V]`` products on the device.

Divergences:

- ``discover_topics`` runs the port's k-means, whose seeding draws from a
  ``torch.Generator`` (``ml/kmeans.py``), so its topics are the JAX
  package's only where both seedings converge alike;
- ``lda_fit`` draws each restart's start ``Gamma(100, 1) * 0.01 + eta``
  from a ``torch.Generator`` on the device seeded with ``seed + 1000 *
  r`` (the JAX package: ``jax.random.gamma``); ``lda_run`` iterates from
  a given start, so tests feed it JAX's. ``digamma`` is
  ``torch.special.digamma``; the log-likelihood proxy that picks the
  restart is computed on the device in f32;
- ``describe`` and ``correlation_matrix`` run on the device:
  ``describe``'s std divides by N (``correction=0``) and its percentiles
  are ``ops.vector_ops._quantile`` (f32 positions, as ``jnp.quantile``;
  numpy's ``percentile`` interpolates in f64); ``correlation_matrix`` is
  ``np.corrcoef``'s f64 arithmetic in torch;
- ``permutation_importance``, the feature store and ``histogram`` stay
  host numpy, as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device
from neurondb_tpu_torch.ops.vector_ops import _quantile


def _counts(docs: Sequence[str]) -> Tuple[np.ndarray, Dict[str, int]]:
    """[D, V] term counts and the vocabulary, terms numbered as first
    seen."""
    from neurondb_tpu_torch.search.bm25 import tokenize
    vocab: Dict[str, int] = {}
    rows = []
    for doc in docs:
        c: Dict[int, float] = {}
        for t in tokenize(doc):
            if t not in vocab:
                vocab[t] = len(vocab)
            ti = vocab[t]
            c[ti] = c.get(ti, 0.0) + 1.0
        rows.append(c)
    X = np.zeros((len(docs), max(len(vocab), 1)), np.float32)
    for i, c in enumerate(rows):
        for ti, tf in c.items():
            X[i, ti] = tf
    return X, vocab


# --------------------------------------------------------------------------
# topic discovery (tf-idf + k-means)
# --------------------------------------------------------------------------

def discover_topics(docs: Sequence[str], n_topics: int = 5, *,
                    top_words: int = 8, iters: int = 30, seed: int = 0,
                    device=None) -> Dict:
    """Cluster documents into topics over tf-idf; per-topic top words and
    document assignments."""
    from neurondb_tpu_torch.ml.kmeans import kmeans_fit, kmeans_predict
    X, vocab = _counts(docs)
    X = X[:, :len(vocab)]
    df = (X > 0).sum(0)
    idf = np.log((len(docs) + 1) / (df + 1)) + 1.0
    X = X * idf[None, :]
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
        resolve_device(device))
    k = min(n_topics, len(docs))
    state = kmeans_fit(Xt, k, max_iter=iters, seed=seed)
    labels = kmeans_predict(state.centroids, Xt).cpu().numpy()
    inv_vocab = {v: t for t, v in vocab.items()}
    cent = state.centroids.cpu().numpy()
    topics = []
    for t in range(k):
        order = np.argsort(-cent[t])[:top_words]
        topics.append({"topic": t,
                       "words": [inv_vocab[int(w)] for w in order
                                 if cent[t, w] > 0],
                       "size": int((labels == t).sum())})
    return {"topics": topics, "labels": labels.tolist(), "n_topics": k}


# --------------------------------------------------------------------------
# LDA (batch variational EM)
# --------------------------------------------------------------------------

def _digamma_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.special.digamma(a) - torch.special.digamma(
        a.sum(1, keepdim=True))


def lda_run(X: torch.Tensor, lam: torch.Tensor, *, alpha: float = 0.1,
            eta: float = 0.01, iters: int = 60, e_steps: int = 25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` EM steps from the topic-word parameters ``lam [K, V]``:
    returns (lam, gamma [D, K])."""
    Dn = X.shape[0]
    K = lam.shape[0]
    gamma = None
    for _ in range(iters):
        expB = torch.exp(_digamma_norm(lam))                # [K, V]
        gamma = torch.ones((Dn, K), device=X.device) + \
            X.sum(1, keepdim=True) / K
        for _ in range(e_steps):
            expT = torch.exp(_digamma_norm(gamma))          # [D, K]
            norm = expT @ expB + 1e-30                      # [D, V]
            gamma = alpha + expT * ((X / norm) @ expB.T)
        expT = torch.exp(_digamma_norm(gamma))
        norm = expT @ expB + 1e-30
        lam = eta + expB * (expT.T @ (X / norm))
    return lam, gamma


def lda_fit(counts, n_topics: int, *, alpha: float = 0.1,
            eta: float = 0.01, iters: int = 60, e_steps: int = 25,
            seed: int = 0, restarts: int = 2, device=None):
    """Latent Dirichlet Allocation by batch variational EM over
    counts [D, V]. Returns (topic_word [K, V] rows summing to 1,
    doc_topic [D, K]) of the restart with the best training
    log-likelihood proxy sum(X * log(theta @ beta)), as numpy."""
    X = _table(counts, device)
    Dn, V = X.shape
    K = min(n_topics, max(2, Dn))
    best = None
    for r in range(max(1, restarts)):
        gen = torch.Generator(device=X.device)
        gen.manual_seed(int(seed) + 1000 * r)
        lam0 = torch._standard_gamma(
            torch.full((K, V), 100.0, device=X.device), generator=gen) \
            * 0.01 + eta
        lam, gamma = lda_run(X, lam0, alpha=alpha, eta=eta, iters=iters,
                             e_steps=e_steps)
        tw = lam / lam.sum(1, keepdim=True)
        dt = gamma / gamma.sum(1, keepdim=True)
        ll = float((X * torch.log(dt @ tw + 1e-30)).sum())
        if best is None or ll > best[0]:
            best = (ll, tw, dt)
    return best[1].cpu().numpy(), best[2].cpu().numpy()


def lda_topics(docs: Sequence[str], n_topics: int = 5, *,
               top_words: int = 8, iters: int = 30, seed: int = 0,
               device=None) -> Dict:
    """discover_topics-compatible output via LDA training."""
    X, vocab = _counts(docs)
    tw, dt = lda_fit(X, n_topics, iters=iters, seed=seed, device=device)
    inv_vocab = {v: t for t, v in vocab.items()}
    labels = dt.argmax(1)
    topics = []
    for t in range(tw.shape[0]):
        order = np.argsort(-tw[t])[:top_words]
        topics.append({"topic": t,
                       "words": [inv_vocab[int(w)] for w in order
                                 if int(w) in inv_vocab],
                       "size": int((labels == t).sum())})
    return {"topics": topics, "labels": labels.tolist(),
            "doc_topic": dt.tolist(), "n_topics": tw.shape[0]}


# --------------------------------------------------------------------------
# explainable AI
# --------------------------------------------------------------------------

def permutation_importance(predict_fn: Callable, X, y, *,
                           metric: str = "accuracy", n_repeats: int = 3,
                           seed: int = 0) -> np.ndarray:
    """Per-feature importance: the metric's drop when the column is
    shuffled (host numpy shuffles, as in the JAX package)."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    rng = np.random.default_rng(seed)

    def score(Xs):
        pred = predict_fn(Xs)
        pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) \
            else np.asarray(pred)
        if metric == "accuracy":
            return float((pred == y).mean())
        return -float(((pred - y) ** 2).mean())

    base = score(X)
    out = np.zeros(X.shape[1], np.float32)
    for f in range(X.shape[1]):
        drops = []
        for _ in range(n_repeats):
            Xp = X.copy()
            rng.shuffle(Xp[:, f])
            drops.append(base - score(Xp))
        out[f] = np.mean(drops)
    return out


def linear_feature_attribution(model: Dict, x) -> np.ndarray:
    """Additive attribution for linear models: contribution =
    w_i * x_i."""
    coef = model["coef"]
    coef = coef.cpu().numpy() if isinstance(coef, torch.Tensor) else \
        np.asarray(coef)
    x = np.asarray(x, np.float32)
    if coef.ndim == 1:
        return x * coef[None, :] if x.ndim > 1 else x * coef
    return x[..., None] * coef[None, :, :]


def prediction_explanation(model_id: int, X, top_k: int = 5) -> List[Dict]:
    """Explain registry-model predictions (linear family: exact weights;
    others raise and point to permutation_importance)."""
    from neurondb_tpu_torch.ml.registry import get_registry
    rec = get_registry().get(model_id)
    X = np.atleast_2d(np.asarray(X, np.float32))
    out = []
    if "coef" in rec.model and rec.model["coef"].ndim <= 2:
        contrib = linear_feature_attribution(rec.model, X)
        if contrib.ndim == 3:
            contrib = np.abs(contrib).sum(-1)
        for row in contrib:
            order = np.argsort(-np.abs(row))[:top_k]
            out.append({"features": order.tolist(),
                        "contributions": row[order].tolist()})
        return out
    raise ValueError(f"no fast explanation for {rec.algorithm}; use "
                     "permutation_importance")


# --------------------------------------------------------------------------
# feature store (feature_stores / feature_definitions catalog parity)
# --------------------------------------------------------------------------

@dataclass
class FeatureDefinition:
    name: str
    dtype: str = "float32"
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
    description: str = ""
    created_at: float = field(default_factory=time.time)


class FeatureStore:
    """Named feature groups keyed by entity id, with point-in-time reads."""

    def __init__(self):
        self._defs: Dict[str, FeatureDefinition] = {}
        self._data: Dict[str, Dict[int, List]] = {}

    def define(self, fd: FeatureDefinition) -> None:
        self._defs[fd.name] = fd
        self._data.setdefault(fd.name, {})

    def list_features(self) -> List[str]:
        return sorted(self._defs)

    def write(self, feature: str, entity_id: int, value,
              ts: Optional[float] = None) -> None:
        if feature not in self._defs:
            raise KeyError(f"undefined feature {feature!r}")
        fd = self._defs[feature]
        if fd.transform is not None:
            value = fd.transform(np.asarray(value))
        self._data[feature].setdefault(entity_id, []).append(
            (ts if ts is not None else time.time(), value))

    def read(self, feature: str, entity_id: int,
             as_of: Optional[float] = None):
        hist = self._data.get(feature, {}).get(entity_id, [])
        if not hist:
            return None
        if as_of is None:
            return hist[-1][1]
        eligible = [v for t, v in hist if t <= as_of]
        return eligible[-1] if eligible else None

    def matrix(self, features: Sequence[str], entity_ids: Sequence[int],
               as_of: Optional[float] = None) -> np.ndarray:
        """Assemble a training matrix (point-in-time correct)."""
        out = np.zeros((len(entity_ids), len(features)), np.float32)
        for j, f in enumerate(features):
            for i, e in enumerate(entity_ids):
                v = self.read(f, e, as_of)
                out[i, j] = 0.0 if v is None else float(np.asarray(v))
        return out


# --------------------------------------------------------------------------
# analytics (ml_analytics.c / ml_histogram.c)
# --------------------------------------------------------------------------

def _table(X, device) -> torch.Tensor:
    if isinstance(X, torch.Tensor):
        t = X.float()
        return t.to(resolve_device(device)) if device is not None else t
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
        resolve_device(device))


def histogram(x, bins: int = 10) -> Dict:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    x = np.asarray(x, np.float32).ravel()
    counts, edges = np.histogram(x, bins=bins)
    return {"counts": counts.tolist(), "edges": edges.tolist()}


def describe(X, *, device=None) -> List[Dict]:
    """Per-feature summary statistics."""
    X = _table(X, device)
    if X.ndim < 2:
        X = X.reshape(1, -1)
    mean, std = X.mean(0), X.std(0, correction=0)
    lo, hi = X.amin(0), X.amax(0)
    pct = _quantile(X, torch.tensor([0.25, 0.5, 0.75]), dim=0)   # [3, F]
    cols = torch.stack([mean, std, lo, pct[0], pct[1], pct[2], hi]).cpu()
    names = ("mean", "std", "min", "p25", "p50", "p75", "max")
    return [{"feature": f, **{k: float(cols[i, f])
                              for i, k in enumerate(names)}}
            for f in range(X.shape[1])]


def correlation_matrix(X, *, device=None) -> np.ndarray:
    """``np.corrcoef`` of the columns, in f64."""
    X = _table(X, device).double()
    Xc = X - X.mean(0)
    c = (Xc.T @ Xc) / (X.shape[0] - 1)
    d = torch.sqrt(torch.diagonal(c))
    c = c / d[:, None] / d[None, :]
    return torch.clamp(c, -1.0, 1.0).cpu().numpy()
