"""HNSW primitives: the torch port against the JAX package on the CPU.

The same numpy inputs (a seed each) go through the JAX function (its
CPU path: the bitmap visited set, the top-k beam merge, exact merges)
and its port. Ids and adjacency must be equal; distances agree within
rtol = atol = 1e-5 (f32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neurondb_tpu.index.hnsw as H
import neurondb_tpu_torch.index.hnsw as TH

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_PATH = dict(net=False, ring=False, approx=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the machine's cores: one intra-op
    thread keeps this module's many small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _graph(rng, n, d, deg, metric="sqeuclidean", holes=0.1):
    """Rows, f32 norms and a random adjacency [n, deg] with -1 holes and
    repeated ids within rows."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    sq = (x * x).sum(1).astype(np.float32)
    nbr = rng.integers(0, n, (n, deg)).astype(np.int32)
    nbr[rng.random((n, deg)) < holes] = -1
    nbr[:, -1] = nbr[:, 0]                # repeated ids in every row
    return x, sq, nbr


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_greedy_descent(metric):
    rng = np.random.default_rng(1)
    x, sq, nbr = _graph(rng, 600, 12, 8)
    rowmap = rng.permutation(600).astype(np.int32)
    q = rng.standard_normal((40, 12)).astype(np.float32)
    cur = rng.integers(0, 600, 40).astype(np.int32)
    want = H._greedy_descent(_j(q), _j(cur), _j(x), _j(sq), _j(nbr),
                             _j(rowmap), metric=metric, max_steps=256)
    got = TH._greedy_descent(_t(q), _t(cur), _t(x), _t(sq), _t(nbr),
                             _t(rowmap), metric=metric, max_steps=256)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("entries", ["single", "multi"])
def test_beam_search(metric, expand, entries):
    """Single entry, and multi-entry rows with duplicate and -1 entries
    (the router's seeds); identity map."""
    rng = np.random.default_rng(2 + expand)
    x, sq, nbr = _graph(rng, 1500, 16, 12)
    q = rng.standard_normal((48, 16)).astype(np.float32)
    if entries == "single":
        entry = rng.integers(0, 1500, 48).astype(np.int32)
    else:
        entry = rng.integers(0, 1500, (48, 4)).astype(np.int32)
        entry[::3, 2] = entry[::3, 0]                        # duplicates
        entry[::5, 3] = -1
    ef = 24
    steps = (2 * ef + 32) // expand + 16
    wd, wi = H._beam_search(_j(q), _j(entry), _j(x), _j(sq), _j(nbr),
                            jnp.zeros((1,), jnp.int32), 0, metric=metric,
                            ef=ef, max_steps=steps, identity_map=True,
                            expand=expand, **JAX_PATH)
    gd, gi = TH._beam_search(_t(q), _t(entry), _t(x), _t(sq), _t(nbr), None,
                             metric=metric, ef=ef, max_steps=steps,
                             identity_map=True, expand=expand)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def test_beam_search_rowmap():
    """An upper level: local adjacency with a local -> vector row map."""
    rng = np.random.default_rng(4)
    x, sq, _ = _graph(rng, 2000, 8, 6)
    _, _, nbr = _graph(rng, 300, 8, 6)
    rowmap = rng.choice(2000, 300, replace=False).astype(np.int32)
    q = rng.standard_normal((30, 8)).astype(np.float32)
    entry = rng.integers(0, 300, 30).astype(np.int32)
    wd, wi = H._beam_search(_j(q), _j(entry), _j(x), _j(sq), _j(nbr),
                            _j(rowmap), 0, metric="sqeuclidean", ef=16,
                            max_steps=40, identity_map=False, expand=4,
                            **JAX_PATH)
    gd, gi = TH._beam_search(_t(q), _t(entry), _t(x), _t(sq), _t(nbr),
                             _t(rowmap), metric="sqeuclidean", ef=16,
                             max_steps=40, identity_map=False, expand=4)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def _cand(rng, v, c, n):
    cand = rng.integers(0, n, (v, c)).astype(np.int32)
    cand[rng.random((v, c)) < 0.2] = -1
    return cand


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("cap", [8, 40])
def test_prune_and_heuristic(metric, cap):
    """Closest-cap and the diversity heuristic over candidates with -1
    holes; cap 40 is wider than the 32 candidates (padding)."""
    rng = np.random.default_rng(5)
    x, sq, _ = _graph(rng, 800, 10, 4)
    vv = rng.standard_normal((64, 10)).astype(np.float32)
    cand = _cand(rng, 64, 32, 800)
    for jf, tf in ((H._prune_closest, TH._prune_closest),
                   (H._select_neighbors_heuristic,
                    TH._select_neighbors_heuristic)):
        want = jf(_j(vv), _j(cand), _j(x), _j(sq), metric=metric, cap=cap)
        got = tf(_t(vv), _t(cand), _t(x), _t(sq), metric=metric, cap=cap)
        assert np.array_equal(got.numpy(), np.asarray(want)), jf.__name__


@pytest.mark.parametrize("heuristic", [True, False])
def test_bulk_prune_own(heuristic):
    rng = np.random.default_rng(6)
    x, sq, _ = _graph(rng, 900, 10, 4)
    cand = _cand(rng, 900, 20, 900)
    cand[:, 3] = np.arange(900)                           # self hits
    want = H._bulk_prune_own(_j(cand), _j(x), _j(sq), m=8,
                             heuristic=heuristic, metric="sqeuclidean",
                             slab=256)
    got = TH._bulk_prune_own(_t(cand), _t(x), _t(sq), m=8,
                             heuristic=heuristic, metric="sqeuclidean",
                             slab=300)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [16, 8])
def test_bulk_reverse_link(cap):
    """Level 0 (cap 2m, inside a larger capacity) and an upper level
    (cap m)."""
    rng = np.random.default_rng(7)
    n, ncap, m = 700, 1024 if cap == 16 else 700, 8
    x, sq, _ = _graph(rng, ncap, 10, 4)
    sel = _cand(rng, n, m, n)
    sel[:40, :] = 7                                       # a hub target
    nbr0 = np.full((ncap, cap), -1, np.int32)
    want = H._bulk_reverse_link(_j(nbr0), _j(sel), _j(x), _j(sq), m=m,
                                cap=cap, metric="sqeuclidean",
                                heuristic=True, slab=128)
    got = TH._bulk_reverse_link(_t(nbr0), _t(sel), _t(x), _t(sq), m=m,
                                cap=cap, metric="sqeuclidean",
                                heuristic=True, slab=200)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_link_level0_device():
    """One wave's level-0 links: own lists, reverse edges grouped by
    target (intra-wave edges included), re-pruned to capacity."""
    rng = np.random.default_rng(8)
    ncap, m = 1024, 8
    x, sq, nbr = _graph(rng, ncap, 10, 2 * m)
    rows = np.arange(600, 664, dtype=np.int32)
    sel0 = _cand(rng, 64, m, 664)
    sel0[::4, 1] = rows[0]                                # intra-wave edges
    want = H._link_level0_device(_j(nbr), _j(rows), _j(sel0), jnp.int32(64),
                                 _j(x), _j(sq), m=m, cap=2 * m,
                                 metric="sqeuclidean", heuristic=True,
                                 slab=64)
    got = TH._link_level0_device(_t(nbr), _t(rows), _t(sel0), _t(x), _t(sq),
                                 m=m, cap=2 * m, metric="sqeuclidean",
                                 heuristic=True, slab=100)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rnd", [0, 1])
def test_nn_descent_round(monkeypatch, rnd):
    """With the JAX round's random probes fed to the port (the two
    generators differ), the round's own lists are equal."""
    rng = np.random.default_rng(9)
    n, ncap, m, slab = 1500, 2048, 8, 512
    x, sq, nbr = _graph(rng, ncap, 10, 2 * m)
    nbr[n:] = -1

    def jax_rand(rnd_, rows, n_rand, n_, device):
        draws = [np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(7), rnd_ * 65536 + s),
            (slab, n_rand), 0, max(n_, 1), dtype=jnp.int32))
            for s in range(-(-rows // slab))]
        return torch.from_numpy(np.concatenate(draws)[:rows]).to(device)

    monkeypatch.setattr(TH, "_nn_descent_rand", jax_rand)
    want = H._nn_descent_round(_j(nbr), _j(x), _j(sq), jnp.int32(n),
                               jnp.int32(rnd), m=m, metric="sqeuclidean",
                               heuristic=True, slab=slab)
    got = TH._nn_descent_round(_t(nbr), _t(x), _t(sq), n, rnd, m=m,
                               metric="sqeuclidean", heuristic=True,
                               slab=slab)
    assert got.shape == (ncap, m)
    assert np.array_equal(got.numpy()[:n], np.asarray(want)[:n])
    assert bool((got[n:] == -1).all())


def test_strip_selfhits():
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 300, (300, 9)).astype(np.int32)
    ids[::2, 4] = np.arange(0, 300, 2)
    ids[::3, 0] = np.arange(0, 300, 3)
    ids[::7, 8] = -1
    want = H._strip_selfhits(_j(ids), K=8)
    got = TH._strip_selfhits(_t(ids), K=8)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _components(rng, n, ncomp, deg=6):
    """An adjacency [n, deg] of ``ncomp`` components with -1 holes."""
    nbr = np.full((n, deg), -1, np.int32)
    comp = rng.integers(0, ncomp, n)
    for c in range(ncomp):
        mem = np.where(comp == c)[0]
        for col in range(3):                              # edges inside
            nbr[mem, col] = rng.permutation(mem)
    nbr[rng.random((n, deg)) < 0.3] = -1
    return nbr


def test_component_labels():
    """Each node labelled by its component's smallest row (scipy,
    relabelled), equal to the JAX propagation."""
    nbr = _components(np.random.default_rng(11), 3000, 40)
    want = np.asarray(H._component_labels(_j(nbr)))
    got = TH._component_labels(nbr)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 1


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_connect_components(metric):
    """The bridge phase (its outside-distance scan in torch) adds JAX's
    bridges (the JAX package scans on the host at this size) and leaves
    one component."""
    rng = np.random.default_rng(12)
    nbr = _components(rng, 2000, 30, deg=8)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    want = H.HNSWIndex._connect_components(nbr, x, metric)
    got = TH.HNSWIndex._connect_components(nbr, x, metric, device="cpu")
    assert np.array_equal(got, want)
    assert len(np.unique(TH._component_labels(got))) == 1
