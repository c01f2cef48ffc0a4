"""kNN classifier / regressor + Gaussian Naive Bayes + SVM.

Counterpart of ``neurondb_tpu/ml/neighbors.py``. Reference:
NeuronDB/src/ml/ml_knn.c, ml_naive_bayes.c, ml_svm.c. kNN rides the
exact chunked scan (``chunked_knn``); NB is two moment GEMMs. SVM ships
two solvers: a squared-hinge primal for the linear kernel, and an exact
dual solver (projected gradient on the box QP) with true support-vector
semantics for linear/rbf/poly kernels; random Fourier features remain as
the large-n approximation.

Divergences:

- kNN prediction and the kernel SVM's decision run over the query rows in
  blocks (``BLOCK_FLOATS`` floats of distances or kernel values a block),
  where the JAX package forms ``[B, chunk]`` / ``[B, n_sv]`` for the whole
  batch at once (a 1M-row batch would need hundreds of GB).
- ``rbf_features`` draws its frequencies and phases from a
  ``torch.Generator`` on the input's device, not ``jax.random``: the
  features differ and are held to the kernel they approximate.
- The dual SVM's ``sample_cap`` subsample is the JAX package's numpy
  ``default_rng(seed)`` draw, so both take the very same rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neurondb_tpu_torch.ops import topk as TK

BLOCK_FLOATS = 1 << 28          # a query block's [rows, chunk] floats


def _one_hot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot``: labels outside 0..num_classes-1 give a zero row."""
    y = y.long()
    return (y[:, None] == torch.arange(num_classes, device=y.device)).float()


# ---- kNN ----

def knn_fit(X, y, *, k: int = 5, task: str = "classify") -> Dict:
    return {"X": X.float(), "y": y,
            "k": torch.tensor(int(k), dtype=torch.int32, device=X.device),
            "task_classify": torch.tensor(task == "classify",
                                          device=X.device)}


def _knn_neighbors(model: Dict, X, k: int):
    q = X.float()
    base = model["X"]
    chunk = min(65536, base.shape[0])
    base_sq = (base * base).sum(1)
    block = max(1, BLOCK_FLOATS // chunk)
    found = [TK.chunked_knn(q[s:s + block], base, k, metric="l2",
                            chunk=chunk, base_sqnorms=base_sq)
             for s in range(0, max(q.shape[0], 1), block)]
    return torch.cat([d for d, _ in found]), torch.cat([i for _, i in found])


def knn_predict(model: Dict, X) -> torch.Tensor:
    k = int(model["k"])
    d, idx = _knn_neighbors(model, X, k)
    ny = model["y"][idx.long()]                             # [B, k]
    if bool(model["task_classify"]):
        nclass = int(model["y"].max()) + 1
        votes = torch.zeros((ny.shape[0], nclass), device=ny.device)
        valid = (ny >= 0) & (ny < nclass)
        votes.scatter_add_(1, ny.long().clamp(0, nclass - 1),
                           valid.float())
        return torch.argmax(votes, dim=1).to(torch.int32)
    # inverse-distance-weighted regression (reference semantics)
    w = 1.0 / torch.clamp(d, min=1e-6)
    return (ny.float() * w).sum(1) / w.sum(1)


# ---- Gaussian Naive Bayes ----

def naive_bayes_fit(X, y, *, num_classes: int,
                    var_smoothing: float = 1e-9) -> Dict:
    X = X.float()
    onehot = _one_hot(y, num_classes)                       # [N, C]
    counts = onehot.sum(0)                                  # [C]
    means = (onehot.T @ X) / torch.clamp(counts[:, None], min=1.0)
    ex2 = (onehot.T @ (X * X)) / torch.clamp(counts[:, None], min=1.0)
    var = torch.clamp(ex2 - means ** 2, min=0.0)
    var = var + var_smoothing * X.var(0, correction=0).max()
    priors = counts / X.shape[0]
    return {"means": means, "variances": var,
            "log_priors": torch.log(torch.clamp(priors, min=1e-12))}


def naive_bayes_log_proba(model: Dict, X) -> torch.Tensor:
    X = X.float()
    inv = 1.0 / model["variances"]                          # [C, D]
    x2 = (X * X) @ inv.T
    xm = X @ (model["means"] * inv).T
    m2 = (model["means"] ** 2 * inv).sum(1)
    quad = x2 - 2.0 * xm + m2[None, :]
    logdet = torch.log(model["variances"]).sum(1)
    return -0.5 * (quad + logdet[None, :]) + model["log_priors"][None, :]


def naive_bayes_predict(model: Dict, X) -> torch.Tensor:
    return torch.argmax(naive_bayes_log_proba(model, X),
                        dim=1).to(torch.int32)


# ---- linear SVM (squared hinge), one-vs-rest for multiclass ----

def _bias_col(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones((X.shape[0], 1), device=X.device)], dim=1)


def svm_fit(X, y, *, num_classes: int = 2, C: float = 1.0,
            iters: int = 300) -> Dict:
    X = X.float()
    n, d = X.shape
    A = _bias_col(X)
    targets = torch.where(_one_hot(y, num_classes) > 0, 1.0, -1.0)  # [N, C]
    scale = torch.clamp((A * A).sum(1).mean(), min=1.0)
    step = 0.5 / (1.0 + C * scale)
    W = torch.zeros((d + 1, num_classes), device=X.device)
    zero_row = torch.zeros((1, num_classes), device=X.device)
    for _ in range(iters):
        margins = targets * (A @ W)
        viol = torch.clamp(1.0 - margins, min=0.0)
        g = -2.0 * C * (A.T @ (viol * targets)) / n + torch.cat(
            [W[:-1], zero_row])
        W = W - step * g
    return {"W": W}


def svm_decision(model: Dict, X) -> torch.Tensor:
    return _bias_col(X.float()) @ model["W"]


def svm_predict(model: Dict, X) -> torch.Tensor:
    return torch.argmax(svm_decision(model, X), dim=1).to(torch.int32)


def rbf_features(X, n_features: int = 256, gamma: float = 1.0,
                 seed: int = 0) -> torch.Tensor:
    """Random Fourier features so kernel-SVM requests map to the linear
    solver (Rahimi-Recht), replacing the reference's RBF kernel path."""
    X = X.float()
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(seed))
    w = torch.randn((X.shape[1], n_features), generator=gen,
                    device=X.device) * float(np.sqrt(np.float32(2.0 * gamma)))
    b = torch.rand(n_features, generator=gen, device=X.device) * \
        float(np.float32(2.0 * np.pi))
    return float(np.sqrt(np.float32(2.0 / n_features))) * torch.cos(X @ w + b)


# ---- kernel SVM on the dual (support-vector semantics) ----

def kernel_matrix(A, B, *, kernel: str = "rbf", gamma: float = 1.0,
                  degree: int = 3, coef0: float = 1.0) -> torch.Tensor:
    """K(A, B) for linear / rbf / poly kernels as one GEMM (+elementwise).
    Mirrors ml_svm.c linear_kernel:99 / rbf_kernel:126 semantics."""
    A = A.float()
    B = B.float()
    dots = A @ B.T
    if kernel == "linear":
        return dots
    if kernel == "poly":
        return (gamma * dots + coef0) ** degree
    if kernel == "rbf":
        a2 = (A * A).sum(1)[:, None]
        b2 = (B * B).sum(1)[None, :]
        return torch.exp(-gamma * torch.clamp(a2 + b2 - 2.0 * dots, min=0.0))
    raise ValueError(f"unknown kernel {kernel!r}")


def _svm_dual_solve(X, y, *, num_classes: int, C: float, kernel: str,
                    gamma: float, degree: int, coef0: float, iters: int):
    """Box-constrained dual QP, all one-vs-rest classes at once.

    maximize  sum(a) - 0.5 (a*t)' K (a*t)   s.t. 0 <= a <= C   per class

    solved by projected gradient ascent with the 1/lambda_max(K) step
    (a 12-step power-iteration estimate from ones / sqrt(n)); each step is
    one [N,N] x [N,Cls] product. The bias of each class comes from its
    free support vectors' KKT condition, or the margin midpoint when no
    support vector is strictly inside the box.
    """
    X = X.float()
    n = X.shape[0]
    K = kernel_matrix(X, X, kernel=kernel, gamma=gamma, degree=degree,
                      coef0=coef0)                         # [N, N] PSD
    t = torch.where(_one_hot(y, num_classes) > 0, 1.0, -1.0)  # [N, Cls]

    v = torch.ones(n, device=X.device) / float(np.sqrt(np.float32(n)))
    for _ in range(12):
        w = K @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    lam = torch.clamp(v @ (K @ v), min=1e-6)
    eta = 1.0 / lam

    a = torch.zeros_like(t)
    for _ in range(iters):
        f = K @ (a * t)                                    # [N, Cls]
        g = 1.0 - t * f                                    # dD/da
        a = torch.clamp(a + eta * g, 0.0, C)

    f = K @ (a * t)
    free = (a > 1e-6 * C) & (a < C * (1.0 - 1e-6))
    nfree = free.sum(0)
    b_free = torch.where(free, t - f, 0.0).sum(0) / \
        torch.clamp(nfree.float(), min=1.0)
    on = a > 1e-6 * C
    inf = float("inf")
    b_mid = -0.5 * (torch.where(on & (t > 0), f, inf).amin(0)
                    + torch.where(on & (t < 0), f, -inf).amax(0))
    b = torch.where(nfree > 0, b_free,
                    torch.where(torch.isfinite(b_mid), b_mid, 0.0))
    return a, t, b


def svm_kernel_fit(X, y, *, num_classes: int = 2, C: float = 1.0,
                   kernel: str = "rbf", gamma: float = 1.0,
                   degree: int = 3, coef0: float = 1.0, iters: int = 500,
                   sample_cap: int = 8192, seed: int = 0) -> Dict:
    """Exact kernel SVM (dual), compacted to its support vectors.

    The [N, N] kernel matrix bounds memory, so n > sample_cap subsamples
    (the reference caps harder: sample_limit=5000, ml_svm.c:1506).
    Returns only rows where any class keeps a_i > 0 — true
    support-vector semantics (alphas serialized like ml_svm.c:470).
    """
    X = X.float()
    if X.shape[0] > sample_cap:
        sel = np.random.default_rng(seed).choice(X.shape[0], sample_cap,
                                                 replace=False)
        sel = torch.from_numpy(sel).to(X.device)
        X, y = X[sel], y[sel]
    a, t, b = _svm_dual_solve(
        X, y, num_classes=max(num_classes, 2), C=float(C), kernel=kernel,
        gamma=float(gamma), degree=int(degree), coef0=float(coef0),
        iters=int(iters))
    coef = a * t                                           # [N, Cls]
    keep = (coef.abs() > 1e-6 * float(C)).any(1)
    if not bool(keep.any()):
        keep[:] = True
    dev = X.device
    return {"sv": X[keep], "coef": coef[keep], "b": b, "kernel": kernel,
            "gamma": torch.tensor(float(gamma), device=dev),
            "degree": torch.tensor(int(degree), dtype=torch.int32, device=dev),
            "coef0": torch.tensor(float(coef0), device=dev),
            "n_support": keep.sum().to(torch.int32)}


def svm_kernel_decision(model: Dict, X) -> torch.Tensor:
    X = X.float()
    sv = model["sv"]
    rows = max(1, BLOCK_FLOATS // max(sv.shape[0], 1))
    kw = dict(kernel=str(model["kernel"]), gamma=float(model["gamma"]),
              degree=int(model["degree"]), coef0=float(model["coef0"]))
    out = [kernel_matrix(X[s:s + rows], sv, **kw) @ model["coef"]
           + model["b"][None, :] for s in range(0, X.shape[0], rows)]
    return torch.cat(out) if out else torch.zeros(
        (0, model["coef"].shape[1]), device=X.device)


def svm_kernel_predict(model: Dict, X) -> torch.Tensor:
    return torch.argmax(svm_kernel_decision(model, X),
                        dim=1).to(torch.int32)
