"""IVFFlat's probe route (``ivf_kernel="probe"``): the torch port against
the JAX package on the CPU.

The JAX index is built once and carried across with ``from_state``. On
the CPU the JAX package searches through its gather route
(``_ivf_search_device``), which computes the function of its round-1
probe kernel: exact distances over each query's nprobe lists. The port
takes its probe route (``_ivf_coarse``, ``ivf_probe_scan`` with the plain
scan on CPU tensors, ``_ivf_post``) over an f32 store.
"""

import numpy as np
import pytest
import torch

from neurondb_tpu.index.ivf import IVFFlatIndex as JIVF
from neurondb_tpu_torch import configure, get_config
from neurondb_tpu_torch.index import ivf as TI
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.ops.kernels import ivf_scan as P
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G

# both sides compute |q|^2 + |x|^2 - 2 q.x in f32 with sums in another
# order (the JAX route takes |x|^2 from the f32 source, the port from the
# stored f32 row); queries sit 0.3 sigma off a corpus row
RTOL = 1e-4
ATOL = 1e-5        # cosine and ip values near 0 cannot be held relatively


def _clustered(rng, n, d, ncl=32, noise=0.3, nq=64):
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, ncl, n)] + \
        rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] + \
        noise * rng.standard_normal((nq, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _carry(j: JIVF, metric: str) -> TIVF:
    arrays, meta = j._state()
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return TIVF.from_state(arrays, dict(meta, metric=metric, dim=j.dim),
                           device="cpu")


@pytest.fixture()
def probe_route(monkeypatch):
    """ivf_kernel = "probe" for one test; counts the route's scans and
    fails on any grouped scan."""
    calls = {"probe": 0}
    scan = P.ivf_probe_scan

    def counting(*a, **kw):
        calls["probe"] += 1
        return scan(*a, **kw)

    def no_grouped(*a, **kw):
        raise AssertionError("the probe route ran the grouped scan")

    monkeypatch.setattr(P, "ivf_probe_scan", counting)
    monkeypatch.setattr(G, "grouped_probe_scan", no_grouped)
    configure(ivf_kernel="probe")
    yield calls
    get_config().reset("ivf_kernel")


def _assert_parity(j, t, q, k=10, **kw):
    jd, ji = j.search(q, k=k, **kw)
    td, ti = t.search(q, k=k, **kw)
    assert ti.shape == ji.shape
    agree = float((ti == ji).mean())
    assert agree >= 0.99, agree
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    return td, ti


@pytest.fixture(scope="module")
def data(rng_mod):
    return _clustered(rng_mod, 4096, 128)


@pytest.fixture(scope="module")
def pair(data):
    x, _ = data
    j = JIVF(x, nlists=32, seed=0)
    return j, _carry(j, "l2")


@pytest.mark.parametrize("nprobe", [1, 4, 8])
def test_probe_route_parity(pair, data, probe_route, nprobe):
    j, t = pair
    _, q = data
    before = P.LAUNCHES
    _assert_parity(j, t, q, nprobe=nprobe)
    assert probe_route["probe"] == 1
    assert P.LAUNCHES == before                   # CPU tensors: plain scan


def test_probe_route_equals_grouped_exact(pair, data):
    """The two routes compute one function over the same lists; on an f32
    store (q rounded to the store type is q) they agree."""
    _, t = pair
    _, q = data
    gd, gi = t.search(q, k=10, nprobe=4, select="exact")
    configure(ivf_kernel="probe")
    try:
        pd, pi = t.search(q, k=10, nprobe=4)
    finally:
        get_config().reset("ivf_kernel")
    assert float((pi == gi).mean()) >= 0.99
    np.testing.assert_allclose(pd, gd, rtol=RTOL, atol=ATOL)


def test_long_lists_take_several_segments(rng, probe_route):
    """nlists 6 over 4096 rows: lists of ~680 rows, two 512-row segments
    (the route's max_segs), still the JAX result."""
    x, q = _clustered(rng, 4096, 32, ncl=6)
    j = JIVF(x, nlists=6, seed=0)
    t = _carry(j, "l2")
    assert t.max_list > TI.SEGMENT
    _assert_parity(j, t, q, nprobe=2)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_metric_parity(rng, probe_route, metric):
    x, q = _clustered(rng, 2048, 64, ncl=16)
    j = JIVF(x, nlists=16, metric=metric, seed=0)
    t = _carry(j, metric)
    _assert_parity(j, t, q, nprobe=4)


def test_delete_spill_rebuild_parity(data, rng, probe_route):
    x, q = data
    j = JIVF(x[:2048], nlists=16, seed=0)
    t = _carry(j, "l2")
    extra = x[2048:2148] + 0.01
    np.testing.assert_array_equal(t.add(extra), j.add(extra))
    _assert_parity(j, t, q, nprobe=4)            # spill merge
    drop = np.concatenate([rng.choice(2048, 300, replace=False),
                           [2048 + 3, 2048 + 7]])
    assert t.delete(drop) == j.delete(drop) == 302
    _, ti = _assert_parity(j, t, q, nprobe=4)    # counts shrink
    assert not np.isin(ti, drop).any()
    t.rebuild_lists()
    j.rebuild_lists()
    _assert_parity(j, t, q, nprobe=4)


def test_int64_ids_take_the_host_map(data, probe_route):
    x, q = data
    ids = np.arange(len(x), dtype=np.int64) + (1 << 40)
    j = JIVF(x, nlists=32, seed=0, ids=ids)
    t = _carry(j, "l2")
    assert t._host_id_map
    _, ti = _assert_parity(j, t, q, nprobe=4)
    assert ti.min() >= 1 << 40
    with pytest.raises(ValueError, match="int32 ids"):
        t.search(q, k=10, nprobe=4, out="device")


def test_device_output(pair, data, probe_route):
    _, t = pair
    _, q = data
    dv, di = t.search(q, k=10, nprobe=4, out="device")
    assert isinstance(dv, torch.Tensor) and dv.device == t.device
    nv, ni = t.search(q, k=10, nprobe=4)
    np.testing.assert_array_equal(di.numpy(), ni)
    np.testing.assert_array_equal(dv.numpy(), nv)
    with pytest.raises(ValueError, match="batch query"):
        t.search(q[0], k=10, nprobe=4, out="device")


def test_k_past_rows_pads_with_minus_one(rng, probe_route):
    x, q = _clustered(rng, 50, 16, ncl=4, nq=6)
    j = JIVF(x, nlists=16, seed=0)
    t = _carry(j, "l2")
    td, ti = t.search(q, k=100, nprobe=1)
    jd, ji = j.search(q, k=100, nprobe=1)
    assert ti.shape == ji.shape == (6, 50)
    np.testing.assert_array_equal(ti, ji)
    assert (ti == -1).any()
    assert (td[ti == -1] == G.NEG_FILL).all()


def test_select_is_validated_and_ignored(pair, data, probe_route):
    _, t = pair
    _, q = data
    _, a = t.search(q, k=10, nprobe=4, select="blockmin")
    _, b = t.search(q, k=10, nprobe=4, select="exact")
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown select"):
        t.search(q, k=10, nprobe=4, select="bogus")


def test_exact_point_ignores_the_kernel(pair, data, probe_route):
    """A padded nprobe at nlists takes the exact route on both kernels."""
    j, t = pair
    _, q = data
    _assert_parity(j, t, q, nprobe=32)
    assert probe_route["probe"] == 0


def test_unknown_ivf_kernel_raises(pair, data):
    _, t = pair
    _, q = data
    configure(ivf_kernel="round1")
    try:
        with pytest.raises(ValueError, match="unknown ivf_kernel"):
            t.search(q, k=10, nprobe=4)
    finally:
        get_config().reset("ivf_kernel")
    assert t.search(q, k=10, nprobe=4)[1].shape == (len(q), 10)
