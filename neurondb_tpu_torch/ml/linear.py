"""Linear model family — linear/ridge/lasso/elastic-net/logistic.

Counterpart of ``neurondb_tpu/ml/linear.py``. Reference parity:
NeuronDB/src/ml/ml_linear_regression.c, ml_ridge_lasso.c,
ml_logistic_regression.c. Closed-form solves are one GEMM and a Cholesky
solve (with the ``1e-8`` ridge); lasso and elastic net run FISTA for a
fixed number of steps after a 32-step power iteration for the Lipschitz
constant; logistic regression is damped Newton-IRLS for two classes and
full-batch softmax gradient descent (``iters * 10`` steps) otherwise.
Every step is deterministic, so the port follows the JAX package's
arithmetic step by step on the input's device: the FISTA momentum
sequence ``t`` is computed in float32, as JAX computes it.

Models are dicts of tensors so the registry can serialize them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _with_bias(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                    device=X.device)], dim=1)


def _solve_pos(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.linalg.solve(G, b, assume_a="pos")``: Cholesky, with no
    host check of the factorization (a matrix that is not positive
    definite gives NaNs, as in JAX, and no sync)."""
    L, _ = torch.linalg.cholesky_ex(G)
    return torch.cholesky_solve(b.reshape(b.shape[0], -1), L).reshape(b.shape)


# ---- linear / ridge (closed form) ----

def linear_regression_fit(X, y, *, l2: float = 0.0,
                          fit_intercept: bool = True) -> Dict:
    X = X.float()
    y = y.float()
    A = _with_bias(X) if fit_intercept else X
    d = A.shape[1]
    eye = torch.eye(d, device=X.device)
    G = A.T @ A
    if l2 > 0:
        reg = eye * l2
        if fit_intercept:
            reg[-1, -1] = 0.0        # don't penalize intercept
        G = G + reg
    b = A.T @ y
    w = _solve_pos(G + 1e-8 * eye, b)
    if fit_intercept:
        return {"coef": w[:-1], "intercept": w[-1]}
    return {"coef": w, "intercept": torch.zeros(
        y.shape[1:] if y.ndim > 1 else (), device=X.device)}


def linear_regression_predict(model, X):
    return X.float() @ model["coef"] + model["intercept"]


def regression_metrics(model, X, y) -> Dict[str, torch.Tensor]:
    pred = linear_regression_predict(model, X)
    y = y.float()
    resid = y - pred
    mse = (resid ** 2).mean()
    var = torch.clamp(y.var(correction=0), min=1e-30)
    return {"mse": mse, "rmse": torch.sqrt(mse), "mae": resid.abs().mean(),
            "r2": 1.0 - mse / var}


# ---- lasso / elastic net (FISTA) ----

def lasso_fit(X, y, *, l1: float = 1.0, l2: float = 0.0,
              iters: int = 500) -> Dict:
    """FISTA proximal gradient; objective (1/2n)||Xw + b - y||^2 +
    l1*|w| + (l2/2)||w||^2."""
    X = X.float()
    y = y.float()
    n, d = X.shape
    # Lipschitz constant of the smooth part via power iteration on X^T X / n
    G = (X.T @ X) / n
    v = torch.ones(d, device=X.device) / float(np.sqrt(np.float32(d)))
    for _ in range(32):
        v = G @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    L = torch.clamp(v @ (G @ v), min=1e-6) + l2

    ymean = y.mean()
    xmean = X.mean(0)
    Xc = X - xmean
    yc = y - ymean

    def soft(u, t):
        return torch.sign(u) * torch.clamp(u.abs() - t, min=0.0)

    w = torch.zeros(d, device=X.device)
    z = w
    t = np.float32(1.0)
    for _ in range(iters):
        grad = (Xc.T @ (Xc @ z - yc)) / n + l2 * z
        w_new = soft(z - grad / L, l1 / L)
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        z = w_new + float((t - np.float32(1.0)) / t_new) * (w_new - w)
        w, t = w_new, t_new
    intercept = ymean - xmean @ w
    return {"coef": w, "intercept": intercept}


def elastic_net_fit(X, y, *, alpha: float = 1.0, l1_ratio: float = 0.5,
                    iters: int = 500) -> Dict:
    return lasso_fit(X, y, l1=alpha * l1_ratio,
                     l2=alpha * (1.0 - l1_ratio), iters=iters)


# ---- logistic regression ----

def logistic_regression_fit(X, y, *, l2: float = 1e-4, iters: int = 50,
                            num_classes: int = 2, lr: float = 1.0) -> Dict:
    """Multinomial logistic regression by damped Newton (binary) /
    full-batch natural-ish GD (multiclass), fixed trip count."""
    X = X.float()
    y = y.long()
    A = _with_bias(X)
    n, d = A.shape
    eye = torch.eye(d, device=X.device)
    if num_classes == 2:
        t = y.float()
        w = torch.zeros(d, device=X.device)
        for _ in range(iters):
            p = torch.sigmoid(A @ w)
            g = A.T @ (p - t) / n + l2 * w
            s = torch.clamp(p * (1.0 - p), min=1e-6)
            H = (A.T * s[None, :]) @ A / n + l2 * eye
            w = w - lr * _solve_pos(H, g)
        return {"coef": w[:-1, None], "intercept": w[-1:], "W": w[:, None]}
    # multiclass: softmax regression by full-batch GD, step sized by the
    # mean squared feature norm (a cheap Lipschitz proxy).
    onehot = torch.nn.functional.one_hot(y, num_classes).float()
    scale = torch.clamp((A * A).sum(1).mean(), min=1.0)
    W = torch.zeros((d, num_classes), device=X.device)
    for _ in range(iters * 10):
        p = torch.softmax(A @ W, dim=1)
        g = A.T @ (p - onehot) / n + l2 * W
        W = W - (2.0 / scale) * g
    return {"coef": W[:-1], "intercept": W[-1], "W": W}


def logistic_predict_proba(model, X):
    z = X.float() @ model["coef"] + model["intercept"]
    if model["W"].shape[1] == 1:
        p1 = torch.sigmoid(z[:, 0] if z.ndim > 1 else z)
        return torch.stack([1.0 - p1, p1], dim=1)
    return torch.softmax(z, dim=1)


def logistic_predict(model, X):
    return torch.argmax(logistic_predict_proba(model, X), dim=1)


def classification_metrics(model, X, y, predict_fn=logistic_predict):
    pred = predict_fn(model, X)
    acc = (pred == y.to(torch.int32)).float().mean()
    return {"accuracy": acc}
