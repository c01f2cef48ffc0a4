"""Gaussian mixture model — EM with diagonal covariances.

Counterpart of ``neurondb_tpu/ml/gmm.py``. Reference:
NeuronDB/src/ml/ml_gmm.c + gpu_gmm_kernels.cu. E-step responsibilities
and M-step moments are batched GEMMs; ``iters`` fixed EM steps with
log-likelihood tracking (the returned log-likelihood is the one computed
in the last step, from the parameters that step started from, as in the
JAX package).

Divergence: the k-means++ seeding draws from a ``torch.Generator`` on the
data's device, not ``jax.random``. ``gmm_init`` makes the starting
parameters and the private ``_gmm_em`` runs EM from any ``(means0, var0,
w0)``, so a test can start the port from the JAX package's own seeding
and hold every parameter to it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from neurondb_tpu_torch.ml.kmeans import kmeans_plusplus_init


class GMMState(NamedTuple):
    means: torch.Tensor        # [k, D]
    variances: torch.Tensor    # [k, D] diagonal
    weights: torch.Tensor      # [k]
    log_likelihood: torch.Tensor


def _log_prob(x, means, variances, weights, x_sq=None):
    """[N, k] log p(x | comp) + log w."""
    # -(x-mu)^2 / (2 var) - 0.5 log(2 pi var), summed over dims; GEMM form
    inv = 1.0 / variances                                   # [k, D]
    x2 = (x * x if x_sq is None else x_sq) @ inv.T          # [N, k]
    xm = x @ (means * inv).T
    m2 = (means * means * inv).sum(1)
    quad = x2 - 2.0 * xm + m2[None, :]
    logdet = torch.log(variances).sum(1)
    # d log(2 pi) as JAX forms it, in f32
    c = float(np.float32(x.shape[1]) * np.log(np.float32(2.0 * np.pi)))
    return (-0.5 * (quad + logdet + c)
            + torch.log(weights)[None, :])


def gmm_init(x, k: int, *, reg: float = 1e-6, seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(means0, var0, w0): k-means++ means, the data's variance + reg in
    every component, equal weights."""
    x = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    means0 = kmeans_plusplus_init(x, k, gen)
    var0 = (x.var(0, correction=0)[None, :] + reg).repeat(k, 1)
    w0 = torch.full((k,), 1.0 / k, device=x.device)
    return means0, var0, w0


def _gmm_em(x, means0, var0, w0, *, iters: int = 100,
           reg: float = 1e-6) -> GMMState:
    """``iters`` EM steps from (means0, var0, w0)."""
    x = x.float()
    n = x.shape[0]
    x_sq = x * x
    means, variances, weights = means0, var0, w0
    ll = torch.tensor(-float("inf"), device=x.device)
    for _ in range(iters):
        logp = _log_prob(x, means, variances, weights, x_sq)  # [N, k]
        ll = torch.logsumexp(logp, dim=1).sum()
        resp = torch.softmax(logp, dim=1)                      # [N, k]
        nk = resp.sum(0) + 1e-10                               # [k]
        new_means = (resp.T @ x) / nk[:, None]
        ex2 = (resp.T @ x_sq) / nk[:, None]
        variances = torch.clamp(ex2 - new_means ** 2, min=reg)
        means = new_means
        weights = nk / n
    return GMMState(means, variances, weights, ll)


def gmm_fit(x, k: int, *, iters: int = 100, reg: float = 1e-6,
            seed: int = 0) -> GMMState:
    means0, var0, w0 = gmm_init(x, k, reg=reg, seed=seed)
    return _gmm_em(x, means0, var0, w0, iters=iters, reg=reg)


def gmm_predict_proba(state: GMMState, x) -> torch.Tensor:
    logp = _log_prob(x.float(), state.means, state.variances, state.weights)
    return torch.softmax(logp, dim=1)


def gmm_predict(state: GMMState, x) -> torch.Tensor:
    return torch.argmax(gmm_predict_proba(state, x), dim=1).to(torch.int32)


def gmm_score_samples(state: GMMState, x) -> torch.Tensor:
    """Per-sample log-likelihood (used by anomaly detection)."""
    logp = _log_prob(x.float(), state.means, state.variances, state.weights)
    return torch.logsumexp(logp, dim=1)
