"""The grouped IVF-PQ scan: the torch port (its plain version on the CPU)
against the JAX package's Pallas kernel in interpret mode. The CUDA
kernel is held to the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops.pallas import ivf_scan_grouped as JG
from neurondb_tpu.ops.pallas import ivfpq_scan as JPQ
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

LENS = [300, 3, 0, 1100, 128, 127, 40, 513]
DIM = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _layout(rng, ns):
    """Codes [ns, Npad] on 128-column list starts with the 1024-column
    tail, random centroids and codebooks."""
    aligned = [(-(-n // 128)) * 128 for n in LENS]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    codes_t = rng.integers(0, 256, (ns, npad)).astype(np.uint8)
    cents = rng.standard_normal((len(LENS), DIM)).astype(np.float32)
    cb = (0.5 * rng.standard_normal((ns, 256, DIM // ns))).astype(np.float32)
    return codes_t, cents, cb, offsets, np.asarray(LENS, np.int32)


def _probes(rng, b, npad):
    nl = len(LENS)
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :npad].astype(np.int32)
    probes[2, 1:] = nl                               # padded probe slots
    return probes


def _orthogonal(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return q.astype(np.float32)


def _tiles(probes, offsets, counts, qt):
    b, npad = probes.shape
    t_max = JG.tiles_for(b, npad, len(counts), qt)
    return t_max, JG.group_probes(jnp.asarray(probes), jnp.asarray(offsets),
                                  jnp.asarray(counts), qt=qt, t_max=t_max)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_build_luts_matches_jax(rng, metric, rotate):
    """The same tables: products summed in another order, so rtol 1e-5
    on entries of size ~1-10 (atol 1e-5 for entries near 0)."""
    codes_t, cents, cb, offsets, counts = _layout(rng, 8)
    q = rng.standard_normal((20, DIM)).astype(np.float32)
    probes = _probes(rng, 20, 4)
    qt = 16
    t_max, (_, _, pos) = _tiles(probes, offsets, counts, qt)
    R = _orthogonal(rng, DIM) if rotate else None
    want = JPQ.build_luts(jnp.asarray(q), jnp.asarray(probes),
                          jnp.asarray(cents), jnp.asarray(cb), pos,
                          None if R is None else jnp.asarray(R), npad=4,
                          qt=qt, t_max=t_max, metric=metric)
    got = PQS.build_luts(_t(q), _t(probes), _t(cents), _t(cb),
                         _t(np.asarray(pos)), None if R is None else _t(R),
                         npad=4, qt=qt, t_max=t_max, metric=metric)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ns", [8, 32])
def test_integer_tables_select_identically(rng, ns, packed):
    """Tables of small integers: every sum is exact in f32 in any order,
    so the plain scan and the Pallas kernel (its one-hot matmul) score
    bit-identical distances and must return the same outputs, ties
    included: the smaller row in exact mode, the position in the key.
    An unfilled slot holds (NEG_FILL, -1) in the port; the Pallas
    kernel's exact mode leaves the row of an already extracted column
    there (``merge_partials`` masks it), so rows compare on filled
    slots."""
    codes_t, _, _, offsets, counts = _layout(rng, ns)
    probes = _probes(rng, 16, 4)
    qt = 16
    t_max, (toff, tcnt, _) = _tiles(probes, offsets, counts, qt)
    lut = rng.integers(-8, 9, (t_max * qt, ns * 256)).astype(np.float32)
    pb = max(11, int(counts.max() - 1).bit_length()) if packed else 0
    jd, ji = JPQ.grouped_pq_scan(jnp.asarray(lut), jnp.asarray(codes_t), toff,
                                 tcnt, kp=16, qt=qt, interpret=True,
                                 pos_bits=pb)
    td, ti = PQS.grouped_pq_scan(_t(lut), _t(codes_t), _t(np.asarray(toff)),
                                 _t(np.asarray(tcnt)), kp=16, qt=qt,
                                 pos_bits=pb)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    live = jd < PQS.NEG_FILL
    np.testing.assert_array_equal(ti.numpy()[live], ji[live])
    assert (ti.numpy()[~live] == -1).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ns", [8, 32])
def test_grouped_search_matches_jax(rng, ns, packed):
    """The whole pipeline on float tables: the sums run in another order
    (1e-5 relative on distances of ~10); packed keys round by
    2**(pb-24) relative, and any row one side holds and the other does
    not lies within that window of the k-th distance."""
    codes_t, cents, cb, offsets, counts = _layout(rng, ns)
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    probes = _probes(rng, 16, 4)
    pb = max(11, int(counts.max() - 1).bit_length()) if packed else 0
    args = (q, probes, cents, cb, codes_t, offsets, counts)
    jd, jr = JPQ.ivfpq_grouped_search(*(jnp.asarray(a) for a in args), k=10,
                                      interpret=True, pos_bits=pb)
    td, tr = PQS.ivfpq_grouped_search(*(_t(a) for a in args), k=10,
                                      pos_bits=pb)
    jd, jr, td, tr = np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy()
    step = 2.0 ** (pb - 24) if packed else 0.0
    tol = 1e-5 + 2 * step
    live = jd < 1e30
    np.testing.assert_array_equal(td < 1e30, live)
    np.testing.assert_allclose(td[live], jd[live], rtol=tol, atol=1e-4)
    for b in range(len(q)):
        got, want = set(tr[b].tolist()) - {-1}, set(jr[b].tolist()) - {-1}
        assert len(got) == len(want)
        if got != want:
            kth = float(jd[b][live[b]][-1])
            for r in got ^ want:
                side_d, side_r = (td[b], tr[b]) if r in got else (jd[b], jr[b])
                dist = float(side_d[list(side_r).index(r)])
                assert abs(dist - kth) <= tol * max(1.0, abs(kth)) + 1e-4


def test_all_sentinel_tiles(rng):
    codes_t, cents, cb, offsets, counts = _layout(rng, 8)
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    probes = np.full((8, 4), len(LENS), np.int32)
    td, tr = PQS.ivfpq_grouped_search(_t(q), _t(probes), _t(cents), _t(cb),
                                      _t(codes_t), _t(offsets), _t(counts),
                                      k=5)
    assert (tr.numpy() == -1).all() and (td.numpy() == PQS.NEG_FILL).all()


def test_plain_scan_kp_256_long_list(rng):
    """kp at its cap over a list longer than kp: the sorted top-256 of
    the gather-and-sum, against numpy on the same table."""
    codes_t, _, _, offsets, counts = _layout(rng, 8)
    probes = np.array([[3, 0, 8, 8]] * 4, np.int32)       # 1100 + 300 rows
    qt = 16
    t_max, (toff, tcnt, _) = _tiles(probes, offsets, counts, qt)
    lut = rng.standard_normal((t_max * qt, 8 * 256)).astype(np.float32)
    td, ti = PQS.grouped_pq_scan(_t(lut), _t(codes_t), _t(np.asarray(toff)),
                                 _t(np.asarray(tcnt)), kp=256, qt=qt)
    toff, tcnt = np.asarray(toff), np.asarray(tcnt)
    for t in np.nonzero(tcnt)[0]:
        o, c = int(toff[t]), int(tcnt[t])
        codes = codes_t[:, o:o + c].astype(np.int64)           # [8, c]
        table = lut[t * qt].reshape(8, 256)
        d = np.zeros(c, np.float32)
        for j in range(8):                                     # kernel order
            d = d + table[j, codes[j]]
        order = np.argsort(d, kind="stable")[:256]
        np.testing.assert_array_equal(td.numpy()[t, 0, :len(order)], d[order])
        np.testing.assert_array_equal(ti.numpy()[t, 0, :len(order)], o + order)


def test_wrapper_contract():
    lut = torch.zeros((16, 8 * 256))
    codes = torch.zeros((8, 2048), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        PQS.grouped_pq_scan(lut, codes.to("meta"), one, one, kp=8)
    assert PQS.KP_MAX == 256 and PQS.LIST_ALIGN == 128
    before = PQS.LAUNCHES
    d, i = PQS.grouped_pq_scan(lut, codes, one, one, kp=8, qt=16)
    assert PQS.LAUNCHES == before and d.shape == (1, 16, 8)
