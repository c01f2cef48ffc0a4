"""Packed and blockmin selection of the grouped IVF scan: the torch port's
plain version against the JAX package's Pallas kernel in interpret mode,
and ``IVFFlatIndex.search(select=...)`` against the exact route. The CUDA
kernel is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.index.ivf import IVFFlatIndex as JIVF
from neurondb_tpu.ops.pallas import ivf_scan_grouped as JG
from neurondb_tpu_torch.index.ivf import IVFFlatIndex as TIVF
from neurondb_tpu_torch.index.ivf import select_bits
from neurondb_tpu_torch.ml.metrics import recall_at_k
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as TG

LENS = [700, 512, 100, 1500, 3, 200, 0, 64, 1030]


def _t(a):
    return torch.from_numpy(np.array(a))


def _layout(rng, values):
    """Ragged lists on 32-row starts with the 1024-row tail; ``values``
    draws the rows."""
    aligned = [(-(-n // 32)) * 32 for n in LENS]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    return (values(rng, (npad, 64)).astype(np.float32), offsets,
            np.asarray(LENS, np.int32))


def _integers(rng, shape):
    return rng.integers(-2, 3, shape)


def _probes(rng, b, npad, nlists):
    probes = np.argsort(rng.random((b, nlists)), axis=1)[:, :npad]
    probes = probes.astype(np.int32)
    probes[1, 2:] = nlists                           # padded probe slots
    return probes


def _both(q, probes, vecs, offsets, counts, **kw):
    jd, jr = JG.ivf_grouped_search(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(vecs),
        jnp.asarray(offsets), jnp.asarray(counts), interpret=True, **kw)
    td, tr = TG.ivf_grouped_search(_t(q), _t(probes), _t(vecs), _t(offsets),
                                   _t(counts), **kw)
    return np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy()


@pytest.mark.parametrize("d", [0.0, -0.0, 1.0, 3.5e-3, -7.25, 1e30, -1e30,
                               3.4028235e38, -3.4028235e38, 1e-42])
@pytest.mark.parametrize("pb", [11, 14, 16])
def test_pack_keys_bit_identical_to_xla(d, pb):
    """The key of one distance, and its decoding, bit for bit as the JAX
    kernels compute them (int32 wrap at the largest floats included)."""
    d = np.full(3, d, np.float32)
    dj = jnp.asarray(d)
    b = jax.lax.bitcast_convert_type(dj, jnp.int32)
    key = b ^ ((b >> 31) & jnp.int32(0x7FFFFFFF))
    pos = jnp.array([0, 5, (1 << pb) - 1], jnp.int32)
    key = ((key + jnp.int32(1 << (pb - 1))) & jnp.int32(-(1 << pb))) | pos
    kb = key & jnp.int32(-(1 << pb))
    want_d = jax.lax.bitcast_convert_type(
        kb ^ ((kb >> 31) & jnp.int32(0x7FFFFFFF)), jnp.float32)
    got = TG.pack_keys(_t(d), _t(pos), torch.ones(3, dtype=bool), pb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(key))
    gd, gr = TG.unpack_keys(got, pb, torch.tensor(100))
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  np.asarray(want_d).view(np.int32))
    np.testing.assert_array_equal(gr.numpy(), 100 + np.asarray(pos))
    assert TG.pack_keys(torch.ones(1), torch.zeros(1, dtype=torch.int64),
                        torch.zeros(1, dtype=bool), pb).item() == TG.INT_FILL


@pytest.mark.parametrize("block_min", [False, True])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("qt,k", [(16, 10), (32, 100), (64, 5)])
def test_integer_rows_select_identically(rng, qt, k, metric, block_min):
    """Rows and queries of small integers: every distance is an integer
    below 2**24, exact in f32 in any summation order, so both packages
    score bit-identical distances and their keys must agree: the same
    outputs, ties included (the key's position breaks them)."""
    vecs, offsets, counts = _layout(rng, _integers)
    q = _integers(rng, (24, 64)).astype(np.float32)
    probes = _probes(rng, 24, 4, len(counts))
    pb = max(11, int(counts.max() - 1).bit_length())
    jd, jr, td, tr = _both(q, probes, vecs, offsets, counts, k=k, qt=qt,
                           metric=metric, pos_bits=pb, block_min=block_min)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(td, jd)


def test_blockmin_keeps_one_row_per_class(rng):
    """Blockmin on one long list: at most one row per (segment, class)
    survives, and it is its class's nearest."""
    vecs, offsets, counts = _layout(rng, _integers)
    lid = 3                                          # 1500 rows, 2 segments
    q = vecs[offsets[lid] + 7][None] + 0.25
    probes = np.array([[lid, 9, 9, 9]], np.int32)
    pb = 11
    _, _, td, tr = _both(q, probes, vecs, offsets, counts, k=256, qt=16,
                         pos_bits=pb, block_min=True)
    pos = tr[0][tr[0] >= 0] - offsets[lid]
    cls = (pos // 1024) * 128 + pos % 128
    assert len(pos) == 256 and len(np.unique(cls)) == 256
    x = vecs[offsets[lid]:offsets[lid] + counts[lid]]
    dist = ((x - q[0]) ** 2).sum(1)
    allc = (np.arange(counts[lid]) // 1024) * 128 + np.arange(counts[lid]) % 128
    for p, c in zip(pos, cls):
        assert dist[p] == dist[allc == c].min()


@pytest.mark.parametrize("block_min", [False, True])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_gaussian_rows_match_pallas_within_key_rounding(rng, metric,
                                                        block_min):
    """Gaussian rows: the sums run in another order, so keys may round
    apart at a boundary. The contract of tests/test_pallas_kernels.py:
    sorted values allclose at rtol 1e-3 + 2 * 2**(pb-24), and any row one
    side holds and the other does not lies within that window of the k-th
    distance."""
    vecs, offsets, counts = _layout(rng, lambda r, s: r.standard_normal(s))
    q = rng.standard_normal((24, 64)).astype(np.float32)
    probes = _probes(rng, 24, 4, len(counts))
    pb = 12
    jd, jr, td, tr = _both(q, probes, vecs, offsets, counts, k=10, qt=16,
                           metric=metric, pos_bits=pb, block_min=block_min)
    step = 2.0 ** (pb - 24)
    live = jd < 1e30
    np.testing.assert_array_equal(td < 1e30, live)
    np.testing.assert_allclose(np.sort(td, 1)[live], np.sort(jd, 1)[live],
                               rtol=1e-3 + 2 * step, atol=1e-3)
    n_swaps = 0
    for b in range(len(q)):
        got, want = set(tr[b].tolist()) - {-1}, set(jr[b].tolist()) - {-1}
        assert len(got) == len(want)
        if not want:
            continue
        kth = float(jd[b][live[b]][-1])
        tol = (2 * step + 1e-3) * max(1.0, abs(kth))
        for r in got ^ want:
            dist = (-float(vecs[r] @ q[b]) if metric == "ip"
                    else float(((vecs[r] - q[b]) ** 2).sum()))
            n_swaps += 1
            assert abs(dist - kth) <= tol, (b, r, dist, kth)
    assert n_swaps <= max(2, len(q) // 8), n_swaps


def test_select_bits_gate():
    """The JAX package's gate (index/ivf.py:536-544)."""
    assert select_bits("packed", 700) == (11, False)
    assert select_bits("blockmin", 700) == (11, True)
    assert select_bits("exact", 700) == (0, False)
    assert select_bits("packed", 1) == (11, False)
    assert select_bits("blockmin", 16384) == (14, True)
    assert select_bits("blockmin", 16385) == (0, False)      # pb 15 > 14
    assert select_bits("packed", 40000, max_bits=16) == (16, False)
    with pytest.raises(ValueError, match="unknown select"):
        select_bits("bogus", 10)
    with pytest.raises(ValueError, match="block_min"):
        TG.grouped_probe_scan(torch.zeros(16, 4), torch.zeros(8, 4),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), kp=8,
                              block_min=True)


@pytest.fixture(scope="module")
def ivf(rng_mod):
    centers = rng_mod.standard_normal((32, 64)).astype(np.float32) * 2.0
    x = (centers[rng_mod.integers(0, 32, 4096)]
         + rng_mod.standard_normal((4096, 64))).astype(np.float32)
    q = x[:64] + 0.3 * rng_mod.standard_normal((64, 64)).astype(np.float32)
    j = JIVF(x, nlists=32, seed=0)
    arrays, meta = j._state()
    t = TIVF.from_state({k: np.asarray(v) for k, v in arrays.items()},
                        dict(meta, metric="l2", dim=64), device="cpu")
    d = ((q.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    return j, t, q, np.argsort(d, axis=1)[:, :10]


@pytest.mark.parametrize("select", ["packed", "blockmin"])
def test_index_select_routes_through_the_mode(ivf, select):
    """search(select=...) is the grouped pipeline with the gate's bits,
    and packed is the default."""
    _, t, q, gt = ivf
    pb, bmin = select_bits(select, t.max_list)
    assert pb == 11 and bmin == (select == "blockmin")
    _, ids = t.search(q, k=10, nprobe=4, select=select)
    dv, rows = TG.ivf_grouped_search(
        *_route_inputs(t, q, 4), k=10, pos_bits=pb, block_min=bmin,
        qt=TG.auto_qt(len(q), 4, t.nlists))
    want = np.where(rows.numpy() >= 0,
                    t._ext_ids.numpy()[np.maximum(rows.numpy(), 0)], -1)
    np.testing.assert_array_equal(ids, want)
    if select == "packed":
        np.testing.assert_array_equal(t.search(q, k=10, nprobe=4)[1], ids)
    assert recall_at_k(ids, gt) >= 0.9


def _route_inputs(t, q, nprobe):
    from neurondb_tpu_torch.ops import distance as D
    qt_ = torch.from_numpy(q)
    cd = D.pairwise_distance(qt_, t.centroids, "sqeuclidean")
    probes = torch.topk(cd, nprobe, largest=False).indices.to(torch.int32)
    return qt_, probes, t._vecs, t._offsets, t._counts


@pytest.mark.parametrize("select", ["packed", "blockmin"])
def test_index_select_against_jax_exact(ivf, select):
    """The JAX package on the CPU searches exactly (its gather path): the
    port's packed and blockmin searches stay within the key rounding of
    it (l2 distances are square roots, so half the relative step)."""
    j, t, q, _ = ivf
    jd, ji = j.search(q, k=10, nprobe=4)
    td, ti = t.search(q, k=10, nprobe=4, select=select)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)])
    assert overlap >= (0.99 if select == "packed" else 0.9), overlap
    if select == "packed":
        np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1),
                                   rtol=1e-4 + 2.0 ** (11 - 24), atol=1e-4)
