"""HNSW graphs carried between the packages, and the two packages'
builds side by side: the torch port against the JAX package on the CPU.

Each JAX index is built once (module fixtures): a bulk index (routed
search through the centroid router) and an incremental one (greedy
descent through the upper levels). Their states go through
``HNSWIndex.from_state`` into the port, which must return the JAX
search's ids on >= 0.99 of entries with distances within 1e-5; save and
load cross in both directions; and the port's own builds reach the JAX
builds' recall@10 within 0.01 at ef 16 and 64.

Both packages score l2 as |q|^2 + |x|^2 - 2 q.x in f32, with the dot's
sum taken in another order. Where the rows' norms are large beside the
distance (here |x|^2 ~ 270 against a nearest d^2 ~ 0.08), each side's
rounding of that expansion is ~1e-5 of |q|^2 + |x|^2, far more than 1e-5
of d: both sides are ~1e-4 from float64 at d ~ 0.3. So l2 distances are
held to 1e-5 relative to the expansion's terms, d^2 within
1e-5 * (1 + |q|^2 + |x|^2); ip distances within rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

from neurondb_tpu.index.hnsw import HNSWIndex as JHNSW
from neurondb_tpu_torch.index.hnsw import HNSWIndex as THNSW

TOL = dict(rtol=1e-5, atol=1e-5)
AGREE = 0.99          # carried graph: ids equal on this share of entries
RECALL_GAP = 0.01     # port build vs JAX build, recall@10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the machine's cores: one intra-op
    thread keeps this module's many small torch ops from contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clustered(seed, n, d=16, ncl=24, nq=300):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ncl, d)).astype(np.float32) * 3
    x = (c[rng.integers(0, ncl, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.choice(n, nq, replace=False)]
         + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def _exact(x, q, metric, k=10):
    if metric == "ip":
        d = -(q @ x.T)
    else:
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids, gt)]))


def _carry(j, device="cpu"):
    arrays, meta = j._state()
    arrays = {k: np.array(v) for k, v in arrays.items()}
    return THNSW.from_state(arrays, dict(meta, metric=j.metric, dim=j.dim),
                            device=device)


@pytest.fixture(scope="module")
def bulk():
    x, q = _clustered(21, 6000)
    return x, q, JHNSW(x, m=16, seed=0, build_mode="bulk")


@pytest.fixture(scope="module")
def incremental():
    x, q = _clustered(22, 2000)
    return x, q, JHNSW(x, m=8, ef_construction=64, seed=0,
                       build_mode="incremental")


@pytest.fixture(scope="module")
def bulk_ip():
    x, q = _clustered(23, 2500)
    return x, q, JHNSW(x, m=8, metric="ip", seed=0, build_mode="bulk")


def _same_search(j, t, q, ef, x):
    jd, ji = j.search(q, k=10, ef=ef)
    td, ti = t.search(q, k=10, ef=ef)
    agree = float((ji == ti).mean())
    assert agree >= AGREE, agree
    same = ji == ti
    if j.metric == "ip":
        np.testing.assert_allclose(td[same], jd[same], **TOL)
    else:
        terms = 1.0 + (q * q).sum(1)[:, None] + (x * x).sum(1)[ji]
        err = np.abs(td.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2)
        assert bool((err <= TOL["rtol"] * terms)[same].all()), \
            float((err / terms)[same].max())
    return ti


@pytest.mark.parametrize("ef", [16, 64])
@pytest.mark.parametrize("which", ["bulk", "incremental", "bulk_ip"])
def test_carried_graph_search(request, which, ef):
    x, q, j = request.getfixturevalue(which)
    t = _carry(j)
    assert (t._router is not None) == (which != "incremental")
    assert t.entry == j.entry and t.entry_level == j.entry_level
    assert np.array_equal(t._nbr0[:t.n].numpy(), np.asarray(j._nbr0[:j.n]))
    _same_search(j, t, q, ef, x)


def test_carried_graph_tombstones(incremental):
    """Deletes on both sides of one carried graph: the same survivors,
    never a deleted id."""
    x, q, j = incremental
    t = _carry(j)
    arrays, meta = j._state()
    j2 = JHNSW.__new__(JHNSW)
    j2._load_state({k: np.array(v) for k, v in arrays.items()},
                   dict(meta, metric=j.metric, dim=j.dim))
    drop = np.arange(0, 2000, 7, dtype=np.int64)
    assert j2.delete(drop) == t.delete(drop) == len(drop)
    ids = _same_search(j2, t, q, 32, x)
    assert not np.isin(ids, drop).any()


def test_jax_saved_loads_in_port(bulk, tmp_path):
    x, q, j = bulk
    j.save(str(tmp_path))
    t = THNSW.load(str(tmp_path), device="cpu")
    assert t._router is not None and t.n == j.n
    _same_search(j, t, q, 32, x)


def test_port_saved_loads_in_jax(incremental, tmp_path):
    x, q, j = incremental
    t = _carry(j)
    t.save(str(tmp_path))
    back = JHNSW.load(str(tmp_path))
    assert back.entry == j.entry and back.n == j.n
    _, ji = j.search(q, k=10, ef=32)
    _, bi = back.search(q, k=10, ef=32)
    assert float((ji == bi).mean()) >= AGREE


@pytest.mark.parametrize("which", ["bulk", "incremental"])
def test_port_build_recall(request, which):
    """The port's own build of the same corpus (its random draws differ:
    level draws are shared, the router's k-means and the NN-descent
    probes are not) reaches the JAX build's recall@10 within 0.01."""
    x, q, j = request.getfixturevalue(which)
    kw = (dict(m=16, build_mode="bulk") if which == "bulk" else
          dict(m=8, ef_construction=64, build_mode="incremental"))
    t = THNSW(x, seed=0, device="cpu", **kw)
    assert np.array_equal(t._levels_np, np.asarray(j._levels_np))
    if which == "incremental":
        # no random draw differs: the waves link the same graph, up to
        # f32 near-ties in the selection
        same = (t._nbr0[:t.n].numpy() == np.asarray(j._nbr0[:j.n])).all(1)
        assert float(same.mean()) >= AGREE
    gt = _exact(x, q, "l2")
    for ef in (16, 64):
        r_j = _recall(j.search(q, k=10, ef=ef)[1], gt)
        r_t = _recall(t.search(q, k=10, ef=ef)[1], gt)
        assert abs(r_t - r_j) <= RECALL_GAP, (ef, r_t, r_j)
