"""``types/graph.py``: the torch port's VectorGraph algorithms against the
JAX package's on the same graphs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.types import graph as JG
from neurondb_tpu_torch.types import graph as TG

PR_TOL = dict(rtol=1e-5, atol=1e-7)   # pagerank: scatter-add order differs
SOURCES = (77,)        # mid-chain: the path 77 -> 78 -> ... is the long BFS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(nb, wt):
    j = JG.VectorGraph(jnp.asarray(nb), jnp.asarray(wt))
    t = TG.VectorGraph(torch.from_numpy(nb.copy()), torch.from_numpy(wt.copy()))
    return j, t


def _random_graph(rng, n=150, deg=6, weights="int"):
    """Directed padded adjacency: a path 0 -> 1 -> ... (a long BFS) plus
    random links, some rows without neighbours, some pads mid-row."""
    nb = rng.integers(0, n, (n, deg)).astype(np.int32)
    nb[:, 0] = np.minimum(np.arange(n) + 1, n - 1)
    nb[rng.random((n, deg)) < 0.5] = -1
    nb[n // 2: n // 2 + 40, 1:] = -1                # a long chain segment
    nb[-5:] = -1                                     # dangling rows
    if weights == "int":
        wt = rng.integers(1, 4, (n, deg)).astype(np.float32)
    else:
        wt = rng.random((n, deg)).astype(np.float32) + 0.1
    wt[nb < 0] = 0.0
    return nb, wt


@pytest.fixture(scope="module")
def walks():
    """A float-weighted graph and the JAX package's n-pass results on it."""
    nb, wt = _random_graph(np.random.default_rng(7), weights="float")
    j, _ = _pair(nb, wt)
    want = {"bfs": [np.asarray(JG.bfs(j, s)) for s in SOURCES],
            "sssp": [np.asarray(JG.shortest_path_lengths(j, s))
                     for s in SOURCES],
            "bfs5": np.asarray(JG.bfs(j, 0, max_steps=5)),
            "cc": np.asarray(JG.connected_components(j)),
            "cc4": np.asarray(JG.connected_components(j, iters=4))}
    return nb, wt, want


@pytest.mark.parametrize("check_every", [32, 3])
def test_bfs_sssp_components_match_jax(walks, monkeypatch, check_every):
    """The fixed-point stop changes nothing: the same arrays as the JAX
    package's n passes (checked every 3 passes too)."""
    monkeypatch.setattr(TG, "CHECK_EVERY", check_every)
    nb, wt, want = walks
    _, t = _pair(nb, wt)
    for i, src in enumerate(SOURCES):
        np.testing.assert_array_equal(TG.bfs(t, src).numpy(), want["bfs"][i])
        np.testing.assert_allclose(TG.shortest_path_lengths(t, src).numpy(),
                                   want["sssp"][i], rtol=1e-6)
    np.testing.assert_array_equal(TG.bfs(t, 0, max_steps=5).numpy(),
                                  want["bfs5"])
    labels, passes = TG.connected_components_passes(t)
    np.testing.assert_array_equal(labels.numpy(), want["cc"])
    assert passes < t.num_nodes
    np.testing.assert_array_equal(
        TG.connected_components(t, iters=4).numpy(), want["cc4"])


def test_from_edges_and_dfs_match_jax():
    edges = [(0, 1), (1, 2), (2, 0), (3, 4), (5, 5), (2, 6)]
    ws = [1.0, 2.0, 0.5, 1.5, 3.0, 1.0]
    for directed in (False, True):
        j = JG.VectorGraph.from_edges(7, edges, ws, directed=directed)
        t = TG.VectorGraph.from_edges(7, edges, ws, directed=directed,
                                      device="cpu")
        np.testing.assert_array_equal(t.neighbors.numpy(),
                                      np.asarray(j.neighbors))
        np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
        assert t.num_nodes == j.num_nodes == 7
        for src in (0, 3):
            assert TG.dfs_order(t, src) == JG.dfs_order(j, src)
    t = TG.VectorGraph.from_edges(3, [(0, 1)], device="cpu")
    assert t.weights.numpy().tolist() == [[1.0], [1.0], [0.0]]


def test_pagerank_matches_jax(rng):
    nb, wt = _random_graph(rng)
    j, t = _pair(nb, wt)
    for damping, iters in ((0.85, 50), (0.5, 7)):
        got = TG.pagerank(t, damping, iters).numpy()
        np.testing.assert_allclose(got, np.asarray(JG.pagerank(j, damping,
                                                               iters)),
                                   **PR_TOL)
        assert abs(got.sum() - 1.0) < 1e-5


@pytest.mark.parametrize("weights", ["int", "float"])
def test_community_labels_match_jax(rng, monkeypatch, weights):
    """Integer weights: the label sums are exact, so the labels equal the
    one-hot einsum's bit for bit; float weights on random data have no
    near-ties at this size. A small histogram budget forces chunks."""
    monkeypatch.setattr(TG, "HIST_BUDGET", 500)
    nb, wt = _random_graph(rng, n=120, weights=weights)
    # make label collisions likely: neighbours drawn from few nodes
    nb = np.where(nb >= 0, nb % 12, -1).astype(np.int32)
    j, t = _pair(nb, wt)
    for iters in (1, 4, 20):
        np.testing.assert_array_equal(
            TG.community_labels(t, iters=iters).numpy(),
            np.asarray(JG.community_labels(j, iters=iters)))


def test_community_tie_rules_match_jax_argmax():
    """jnp.argmax over all N labels: the lowest label among equal sums;
    labels no neighbour holds weigh 0, so they win over a negative best
    and join a tie at 0; a row of zero weights takes label 0; a row with
    no neighbours keeps its label."""
    nb = np.array([[3, 5, -1, -1],      # tie 1 vs 1: label 3
                   [4, 2, 2, -1],       # 2 wins with 2
                   [0, 1, -1, -1],      # negative weights: absent label wins
                   [1, 2, 3, 0],        # zero weights: label 0
                   [-1, -1, -1, -1],    # no neighbours: keeps its label
                   [0, 1, 2, 3],        # four-way tie at 1: label 0
                   [2, 3, 4, 5],        # mixed signs: 4 wins with 2
                   ], np.int32)
    wt = np.array([[1, 1, 0, 0], [1, 1, 1, 0], [-1, -2, 0, 0],
                   [0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1],
                   [1, -1, 2, -2]], np.float32)
    j, t = _pair(nb, wt)
    got = TG.community_labels(t, iters=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.community_labels(j, 1)))
    assert got.tolist() == [3, 2, 2, 0, 4, 0, 4]


def test_graph_runs_on_the_given_device_only():
    t = TG.VectorGraph.from_edges(4, [(0, 1), (1, 2)], device="cpu")
    assert t.device.type == "cpu"
    for out in (TG.bfs(t, 0), TG.pagerank(t), TG.community_labels(t),
                TG.connected_components(t), TG.shortest_path_lengths(t, 0)):
        assert out.device.type == "cpu"
