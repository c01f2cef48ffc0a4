"""Drift detection — distribution shift between reference and live data.

Counterpart of ``neurondb_tpu/ml/drift.py``. Reference:
NeuronDB/src/ml/ml_drift_detection.c, ml_drift_time.c. PSI, the
two-sample KS statistic, mean / std shift and embedding drift (centroid
distance, dispersion) with threshold alerts.

The JAX package computes all of it in host numpy. Here the sorts,
quantiles, bin counts and CDFs run on the data's device (an array goes
to ``config.device``): PSI's edges follow ``np.quantile``'s linear
method in f64 on the f32 values and its final sum runs in numpy over the
ten bin counts, and KS's CDFs are f64 counts over the lengths, so both
equal the JAX package's values. Divergences: ``mean_shift`` and
``std_ratio`` are f32 means on the device, whose sums run in another
order than numpy's (``std`` divides by N: ``correction=0``);
``embedding_drift`` computes its means and norms on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device


def _on_device(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float() if device is None else a.float().to(
            resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        resolve_device(device))


def _np_quantile(sorted32: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    """``np.quantile(x, qs)`` (linear) of f32 values already sorted: f64
    positions and weights, the f32 difference of the two neighbours,
    numpy's two-sided lerp."""
    n = sorted32.shape[0]
    pos = qs * (n - 1)
    prev = np.floor(pos)
    t = torch.from_numpy(pos - prev).to(sorted32.device)
    lo = torch.from_numpy(np.clip(prev, 0, n - 1).astype(np.int64))
    hi = torch.from_numpy(np.clip(prev + 1, 0, n - 1).astype(np.int64))
    a = sorted32[lo.to(sorted32.device)]
    b = sorted32[hi.to(sorted32.device)]
    diff = (b - a).double()
    return torch.where(t >= 0.5, b.double() - diff * (1 - t),
                       a.double() + diff * t)


def population_stability_index(ref, live, bins: int = 10, *,
                               device=None) -> float:
    """PSI per standard banding; > 0.2 = significant drift."""
    ref = _on_device(ref, device).reshape(-1)
    live = _on_device(live, ref.device).reshape(-1)
    qs = _np_quantile(torch.sort(ref).values, np.linspace(0, 1, bins + 1))
    qs[0], qs[-1] = -torch.inf, torch.inf

    def counts(v):
        b = torch.searchsorted(qs, v.double(), right=True) - 1
        return torch.bincount(b, minlength=bins)[:bins].cpu().numpy()

    r, l = counts(ref), counts(live)
    rp = np.maximum(r / max(ref.numel(), 1), 1e-6)
    lp = np.maximum(l / max(live.numel(), 1), 1e-6)
    return float(np.sum((lp - rp) * np.log(lp / rp)))


def ks_statistic(ref, live, *, device=None) -> float:
    """Two-sample Kolmogorov-Smirnov statistic."""
    ref = torch.sort(_on_device(ref, device).reshape(-1)).values
    live = torch.sort(_on_device(live, ref.device).reshape(-1)).values
    allv = torch.cat([ref, live])
    cdf_r = torch.searchsorted(ref, allv, right=True).double() / ref.numel()
    cdf_l = torch.searchsorted(live, allv, right=True).double() / live.numel()
    return float((cdf_r - cdf_l).abs().max())


def feature_drift_report(ref, live, *, psi_threshold: float = 0.2,
                         device=None) -> Dict:
    """Per-feature drift metrics over [N, F] matrices."""
    ref = _on_device(ref, device)
    live = _on_device(live, ref.device)
    rm, lm = ref.mean(0), live.mean(0)
    rs, ls = ref.std(0, correction=0), live.std(0, correction=0)
    feats = []
    for f in range(ref.shape[1]):
        psi = population_stability_index(ref[:, f], live[:, f])
        feats.append({
            "feature": f,
            "psi": round(psi, 4),
            "ks": round(ks_statistic(ref[:, f], live[:, f]), 4),
            "mean_shift": float(lm[f] - rm[f]),
            "std_ratio": float(ls[f] / max(float(rs[f]), 1e-9)),
            "drifted": psi > psi_threshold,
        })
    return {"features": feats,
            "any_drift": any(x["drifted"] for x in feats),
            "max_psi": max(x["psi"] for x in feats)}


def embedding_drift(ref_emb, live_emb, *, device=None) -> Dict:
    """Centroid cosine distance + dispersion change for embedding
    spaces."""
    r = _on_device(ref_emb, device)
    l = _on_device(live_emb, r.device)
    cr, cl = r.mean(0), l.mean(0)
    cos = 1.0 - float(cr @ cl / (torch.linalg.norm(cr)
                                 * torch.linalg.norm(cl) + 1e-12))
    disp_r = float(torch.linalg.norm(r - cr, dim=1).mean())
    disp_l = float(torch.linalg.norm(l - cl, dim=1).mean())
    return {"centroid_cosine_distance": cos,
            "dispersion_ratio": disp_l / max(disp_r, 1e-9),
            "drifted": cos > 0.1 or not 0.5 < disp_l / max(disp_r, 1e-9) < 2.0}
