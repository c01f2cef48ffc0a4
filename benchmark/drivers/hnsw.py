"""HNSW cells: ``HNSWIndex`` bulk-built from the host corpus, searched
with ``search(q, k, ef)``, which returns host arrays (one batch in
flight; the fan-out has nothing left to copy). A mix's ``search_batch``
is the search's ``batch``: the rows of one beam search (its visited
bitmap is ``search_batch`` x capacity / 8 bytes); without it the
program picks its own.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from neurondb_tpu_torch.config import configure as _configure
from neurondb_tpu_torch.index.hnsw import HNSWIndex


def configure(cfg: Dict, device: str) -> None:
    """The program's knobs as the configuration states them."""
    _configure(device=device, **cfg["knobs"])


def build(cfg: Dict, x_host: np.ndarray, seed: int, device: str):
    ix = cfg["index"]
    return HNSWIndex(x_host, m=int(ix["m"]),
                     ef_construction=int(ix["ef_construction"]),
                     metric=cfg["metric"], seed=seed,
                     build_mode=ix["build_mode"], device=device)


class Searcher:
    def __init__(self, index, cfg: Dict, mix: Dict):
        self.index = index
        self.kw = dict(k=int(mix["k"]), ef=int(mix["ef"]))
        if "search_batch" in mix:
            self.kw["batch"] = int(mix["search_batch"])
        want = cfg["store_dtype"]
        got = str(index._vecs.dtype).replace("torch.", "")
        if index.device.type == "cuda" and got != want:
            raise RuntimeError(f"the index stores {got}, the configuration "
                               f"states {want}")

    def dispatch(self, q: np.ndarray):
        return self.index.search(q, **self.kw)

    @staticmethod
    def collect(handle):
        return handle

    @staticmethod
    def launches() -> Dict[str, int]:
        return {}


def build_phases(index) -> Dict[str, float]:
    """The bulk build's phases in wall seconds, each ended by a device
    synchronisation (``HNSWIndex.build_seconds``)."""
    return dict(index.build_seconds)


def work(index, cfg: Dict, mix: Dict, pool: List[np.ndarray],
         x: torch.Tensor) -> List[Dict]:
    """No count: the beam's work depends on the walk, which the program
    does not count yet."""
    return [{} for _ in pool]
