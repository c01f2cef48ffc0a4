"""HNSW level-0 reachability: the nodes with no directed level-0 path from
the entry in the JAX package's bulk build and in the port's, on the same
20k x 32 clustered rows (m 16). The port must reach every node wherever
the JAX build does (a node both builds leave out is shared behaviour of
the bulk algorithm, not a fault of the port)."""

import numpy as np
import pytest
import torch

from neurondb_tpu.index.hnsw import HNSWIndex as JHNSW
from neurondb_tpu_torch.index.hnsw import HNSWIndex as THNSW


@pytest.fixture(scope="module", autouse=True)
def _four_torch_threads():
    """The two 20k-row builds are this module's whole cost: four intra-op
    threads for the port's (about 13 s against 32 s on one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _clustered(seed=5, n=20_000, d=32, ncl=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    return (c[rng.integers(0, ncl, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


def _unreached(nbr: np.ndarray, entry: int) -> np.ndarray:
    """Rows with no directed path from ``entry`` over the level-0 lists."""
    n = len(nbr)
    reach = np.zeros(n, bool)
    reach[entry] = True
    frontier = np.array([entry])
    while len(frontier):
        nxt = nbr[frontier].ravel()
        nxt = np.unique(nxt[(nxt >= 0) & (nxt < n)])
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt
    return np.flatnonzero(~reach)


def test_level0_reachability_jax_bulk_vs_port_bulk():
    x = _clustered()
    j = JHNSW(x, m=16, seed=0, build_mode="bulk")
    t = THNSW(x, m=16, seed=0, build_mode="bulk", device="cpu")
    uj = _unreached(np.asarray(j._nbr0)[:j.n], j.entry)
    ut = _unreached(t._nbr0[:t.n].numpy(), t.entry)
    print(f"unreached from the entry: JAX {len(uj)}, port {len(ut)} of "
          f"{len(x)}")
    assert len(ut) == 0 or len(uj) > 0, (uj, ut)
    # a node the port cannot reach from the entry still finds itself
    # through the router's entries
    if len(ut):
        _, ids = t.search(x[ut], k=1)
        assert (ids[:, 0] == ut).mean() >= 0.5
