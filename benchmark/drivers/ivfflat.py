"""IVFFlat cells: ``IVFFlatIndex`` built from the host corpus, searched
with ``search(q, k, nprobe, out="device")``; the fan-out copies each
batch's distances and ids to host memory (as the port's
``MicroBatcher`` drives an index).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchlib import counts

from neurondb_tpu_torch.config import configure as _configure
from neurondb_tpu_torch.index.ivf import IVFFlatIndex
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G


def configure(cfg: Dict, device: str) -> None:
    """The program's knobs as the configuration states them."""
    _configure(device=device, **cfg["knobs"])


def build(cfg: Dict, x_host: np.ndarray, seed: int, device: str):
    ix = cfg["index"]
    return IVFFlatIndex(x_host, nlists=int(ix["nlists"]), metric=cfg["metric"],
                        seed=seed, device=device)


class Searcher:
    def __init__(self, index, cfg: Dict, mix: Dict):
        self.index = index
        self.kw = dict(k=int(mix["k"]), nprobe=int(mix["nprobe"]),
                       out="device")
        want = cfg["store_dtype"]
        got = str(index._vecs.dtype).replace("torch.", "")
        if index.device.type == "cuda" and got != want:
            raise RuntimeError(f"the index stores {got}, the configuration "
                               f"states {want}")

    def dispatch(self, q: np.ndarray):
        return self.index.search(q, **self.kw)

    @staticmethod
    def collect(handle):
        d, i = handle
        return d.cpu().numpy(), i.cpu().numpy()

    def launches(self) -> Dict[str, int]:
        """Kernel launches so far, by the counters the program keeps (on
        the card only: the plain versions count nothing)."""
        if self.index.device.type != "cuda":
            return {}
        return {"grouped_probe_scan": G.LAUNCHES}


def build_phases(index) -> Dict[str, float]:
    return {}


def list_sizes(centroids: torch.Tensor, x: torch.Tensor) -> np.ndarray:
    """Rows of each list: every row's nearest centroid (squared L2, in
    float32, blocks of rows)."""
    c = centroids.float()
    csq = (c * c).sum(1)
    sizes = torch.zeros(c.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], 131072):
        xb = x[s:s + 131072]
        lab = torch.argmin(csq[None, :] - 2.0 * (xb @ c.T), dim=1)
        sizes += torch.bincount(lab, minlength=c.shape[0])
    return sizes.cpu().numpy()


def work(index, cfg: Dict, mix: Dict, pool: List[np.ndarray],
         x: torch.Tensor) -> List[Dict]:
    """Each pool batch's work (``counts``): ``search`` always, ``scan``
    (the list scan alone) below the exact point."""
    ix, dim, k = cfg["index"], x.shape[1], int(mix["k"])
    nlists, nprobe = int(ix["nlists"]), int(mix["nprobe"])
    rate = cfg["precision"]["scan_products"]
    sb = torch.empty((), dtype=getattr(torch, cfg["store_dtype"])) \
        .element_size()
    if cfg["metric"] == "cosine":
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if nprobe >= nlists:
        return [{"search": counts.exact_work(len(q), x.shape[0], dim=dim, k=k,
                                             store_bytes=sb, rate=rate)}
                for q in pool]
    c = index.centroids.float()
    sizes = list_sizes(c, x)
    csq = (c * c).sum(1)
    out = []
    for q in pool:
        qd = torch.as_tensor(q, device=x.device)
        if cfg["metric"] == "cosine":
            qd = qd / torch.linalg.vector_norm(qd, dim=1, keepdim=True)
        probes = torch.topk(csq[None, :] - 2.0 * (qd @ c.T), nprobe, dim=1,
                            largest=False).indices.cpu().numpy()
        kw = dict(dim=dim, k=k, store_bytes=sb, rate=rate)
        out.append({"scan": counts.grouped_scan_work(sizes, probes, **kw),
                    "search": counts.ivf_search_work(sizes, probes,
                                                     nlists=nlists, **kw)})
    return out
