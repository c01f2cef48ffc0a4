"""Index validation / diagnostics — neurondb_validate() / neurondb_diag().

Counterpart of ``neurondb_tpu/index/validate.py`` over the port's
``HNSWIndex`` (``_nbr0``, ``entry``, ``m``) and ``IVFFlatIndex``
(``_offsets``, ``_counts``, ``_row_ids`` and ``_vecs`` on the device,
``_labels`` on the host). Reference: NeuronDB/src/index/index_validator.c
(graph connectivity checks, centroid quality metrics). Returns the same
structured reports.

Divergences:

- ``_validate_ivf`` gathers its 256 sampled rows from the CSR store on
  the device (through the inverse of ``_row_ids``) instead of rebuilding
  the whole corpus on the host.
- The assignment check allows for the store's rounding. On the card the
  store is bf16, while each row's label came from its f32 source, so a
  row near a list boundary may be nearer another centroid once rounded.
  A sampled row whose recomputed label differs still counts as
  consistent when its own centroid is within ``_assign_bound`` of the
  nearest one: with ``x~`` the stored row, ``x`` its f32 source and
  ``u`` the store's unit roundoff (2^-8 for bf16, 0 for f32),
  ``||x~ - x|| <= e = u ||x~|| / (1 - u)``, and the f32 expansion that
  chose the label (``|x|^2 + |c|^2 - 2 x.c`` over D terms) is off by at
  most ``t = gamma_(D+2) (|x| + |c|)^2`` (``gamma_m = m 2^-24 / (1 -
  m 2^-24)``, Higham's bound on a sum of m products). Then
  ``||x~ - c_label|| <= min_j ||x~ - c_j|| + 2 e + sqrt(2 t)``, the
  distances taken in float64. A label planted on a far centroid is past
  that bound, so it still fails the check. The check reports the count
  of recomputed labels that differ (``mismatches``) and of those within
  the bound (``within_bound``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from neurondb_tpu_torch.ml.kmeans import kmeans_predict


def validate_index(index) -> Dict[str, Any]:
    kind = getattr(index, "kind", "unknown")
    if kind == "hnsw":
        return _validate_hnsw(index)
    if kind == "ivfflat":
        return _validate_ivf(index)
    report = {"kind": kind, "valid": True, "checks": []}
    if hasattr(index, "n"):
        report["n"] = index.n
    return report


def _validate_hnsw(idx) -> Dict[str, Any]:
    checks = []
    n = idx.n
    nbr = (idx._nbr0[:n].cpu().numpy() if idx._nbr0 is not None
           else np.zeros((0, 2 * idx.m), np.int32))
    # 1. neighbor ids in range
    in_range = bool(((nbr >= -1) & (nbr < n)).all())
    checks.append({"check": "neighbor_ids_in_range", "ok": in_range})
    # 2. no self loops
    self_loops = int((nbr == np.arange(n)[:, None]).sum())
    checks.append({"check": "no_self_loops", "ok": self_loops == 0,
                   "count": self_loops})
    # 3. entry point valid
    entry_ok = 0 <= idx.entry < n
    checks.append({"check": "entry_point_valid", "ok": bool(entry_ok)})
    # 4. reachability from entry (BFS over the level-0 graph); corrupt
    # out-of-range ids are excluded here — check 1 already flags them
    reach = np.zeros(n, bool)
    frontier = [idx.entry] if entry_ok else []
    reach[frontier] = True
    while frontier:
        nxt = nbr[frontier].ravel()
        nxt = nxt[(nxt >= 0) & (nxt < n)]
        new = nxt[~reach[nxt]]
        reach[new] = True
        frontier = np.unique(new).tolist()
    reachable = float(reach.mean()) if n else 1.0
    checks.append({"check": "connectivity_from_entry",
                   "ok": reachable > 0.99, "reachable_fraction": reachable})
    # 5. degree stats
    deg = (nbr >= 0).sum(1)
    checks.append({"check": "degree_bounds",
                   "ok": bool((deg <= 2 * idx.m).all()),
                   "mean_degree": float(deg.mean()) if n else 0.0})
    return {"kind": "hnsw", "n": n,
            "valid": all(c["ok"] for c in checks), "checks": checks}


def _gamma(m: int) -> float:
    e = m * 2.0 ** -24
    return e / (1.0 - e)


def _assign_bound(x: torch.Tensor, centroids: torch.Tensor,
                  store_dtype: torch.dtype) -> torch.Tensor:
    """Per row: how far its label's centroid may lie beyond the nearest
    one (float64 distances of the stored row) while the label is still
    the nearest for its f32 source (module docstring)."""
    u = 2.0 ** -8 if store_dtype == torch.bfloat16 else 0.0
    xn = torch.linalg.vector_norm(x, dim=1)
    e = u * xn / (1.0 - u)
    cmax = float(torch.linalg.vector_norm(centroids, dim=1).max())
    t = _gamma(x.shape[1] + 2) * (xn + e + cmax) ** 2
    return 2.0 * e + torch.sqrt(2.0 * t)


def _validate_ivf(idx) -> Dict[str, Any]:
    checks = []
    counts = idx._counts.cpu().numpy()
    offsets = idx._offsets.cpu().numpy()
    # 1. offsets monotone and consistent with counts
    ends = offsets + counts
    mono = bool((offsets[1:] >= ends[:-1]).all()) if len(offsets) > 1 else True
    checks.append({"check": "csr_layout_consistent", "ok": mono})
    # 2. total rows match
    total_ok = int(counts.sum()) == idx.n
    checks.append({"check": "row_count_matches", "ok": total_ok,
                   "rows": int(counts.sum()), "expected": idx.n})
    # 3. centroid quality: quantization error + balance
    imb = float(counts.max() / max(counts.mean(), 1e-9)) if len(counts) else 1.0
    checks.append({"check": "list_balance", "ok": imb < 8.0,
                   "imbalance": imb,
                   "empty_lists": int((counts == 0).sum())})
    # 4. assignment sanity on a sample: rows belong to their nearest
    # centroid (rows found in the CSR store through the inverse of
    # _row_ids; a row with no live slot reads as zeros, as in the JAX
    # package's rebuild)
    n_sample = min(256, idx.n)
    if n_sample:
        rng = np.random.default_rng(0)
        rows = rng.choice(idx.n, n_sample, replace=False)
        dev = idx._vecs.device
        rid = idx._row_ids.long()
        live = rid >= 0
        slot_of = torch.full((idx.n,), -1, dtype=torch.long, device=dev)
        slot_of[rid[live]] = torch.nonzero(live)[:, 0]
        slot = slot_of[torch.from_numpy(rows).to(dev)]
        x = torch.where((slot >= 0)[:, None],
                        idx._vecs[slot.clamp(min=0)].float(), 0.0)
        cents = idx.centroids.float()
        lab = kmeans_predict(cents, x).cpu().numpy()
        want = np.asarray(idx._labels)[rows]
        miss = lab != want
        within = 0
        if miss.any():
            sel = torch.from_numpy(np.nonzero(miss)[0]).to(dev)
            xs = x[sel].double()
            dist = torch.cdist(xs, cents.double())
            own = dist.gather(1, torch.from_numpy(want[miss]).to(dev).long()
                              [:, None])[:, 0]
            slack = own - dist.amin(1)
            bound = _assign_bound(x[sel], cents, idx._vecs.dtype).double()
            within = int((slack <= bound).sum())
        consistent = n_sample - int(miss.sum()) + within
        ok = bool(consistent / n_sample > 0.99)
        checks.append({"check": "assignment_consistency", "ok": ok,
                       "mismatches": int(miss.sum()),
                       "within_bound": within})
    return {"kind": "ivfflat", "n": idx.n,
            "valid": all(c["ok"] for c in checks), "checks": checks}
