"""PCA + whitening — covariance eigendecomposition on the device.

Counterpart of ``neurondb_tpu/ml/pca.py``. Reference:
NeuronDB/src/ml/ml_dimensionality_reduction.c and ml_pca_whitening.c. The
D x D covariance is one GEMM; ``torch.linalg.eigh`` runs on the input's
device. Also provides the Gaussian random projection.

Divergences: eigenvector signs are arbitrary in both packages (each
component is held up to its sign); ``random_projection`` draws its matrix
from a ``torch.Generator`` on the input's device, not ``jax.random``, so
the two projections differ and each is held to its Johnson-Lindenstrauss
bound.
"""

from __future__ import annotations

from typing import Dict

import torch


def pca_fit(x, n_components: int = 2, *, whiten: bool = False) -> Dict:
    x = x.float()
    mean = x.mean(0)
    xc = x - mean
    cov = (xc.T @ xc) / (x.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov)                 # ascending
    idx = torch.argsort(-evals, stable=True)
    evals = torch.clamp(evals[idx][:n_components], min=0.0)
    comps = evecs[:, idx][:, :n_components].T             # [C, D]
    var_all = torch.trace(cov)
    return {"mean": mean, "components": comps, "explained_variance": evals,
            "explained_variance_ratio": evals / torch.clamp(var_all,
                                                            min=1e-30),
            "whiten": torch.tensor(bool(whiten), device=x.device)}


def pca_transform(model: Dict, x) -> torch.Tensor:
    z = (x.float() - model["mean"]) @ model["components"].T
    scale = torch.sqrt(torch.clamp(model["explained_variance"], min=1e-12))
    return torch.where(model["whiten"], z / scale[None, :], z)


def pca_inverse_transform(model: Dict, z) -> torch.Tensor:
    z = z.float()
    scale = torch.sqrt(torch.clamp(model["explained_variance"], min=1e-12))
    z = torch.where(model["whiten"], z * scale[None, :], z)
    return z @ model["components"] + model["mean"]


def random_projection(x, n_components: int, seed: int = 0) -> torch.Tensor:
    """Gaussian random projection (Johnson-Lindenstrauss)."""
    x = x.float()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    r = torch.randn((x.shape[1], n_components), generator=gen,
                    device=x.device) / float(n_components) ** 0.5
    return x @ r
