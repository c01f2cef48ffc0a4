"""The round-1 IVF probe scan: the torch port (its plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode and its
numpy oracle. The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops.pallas import ivf_scan as JS
from neurondb_tpu_torch.ops.kernels import ivf_scan as TS

# The Pallas kernel in interpret mode and the plain version both sum in
# f32, in another order: distances of ~2 * 128 agree to ~1e-5 relative,
# and ip values near 0 to ~1e-5 absolute. The JAX package's own probe
# tests hold the kernel to its oracle at 1e-3.
RTOL = 1e-4
ATOL = 1e-4


@pytest.fixture(scope="module")
def ivf_layout(rng_mod):
    """The layout of tests/test_pallas_kernels.py: odd list lengths on
    32-row starts, the store padded by one segment."""
    lens = [700, 512, 100, 1024, 3, 200]
    aligned = [(-(-n // 32)) * 32 for n in lens]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // TS.SEG) * TS.SEG + TS.SEG
    vecs = rng_mod.standard_normal((npad, 128)).astype(np.float32)
    return vecs, offsets, np.asarray(lens, np.int32)


def _probes(rng, layout, b, nprobe):
    """Random lists per query; a list probed twice counts 0 rows the
    second time (it would duplicate candidates)."""
    _, offsets, counts = layout
    pr = rng.integers(0, len(counts), (b, nprobe))
    poff, pcnt = offsets[pr], counts[pr].copy()
    for i in range(b):
        seen = set()
        for j in range(nprobe):
            if int(pr[i, j]) in seen:
                pcnt[i, j] = 0
            seen.add(int(pr[i, j]))
    return poff.astype(np.int32), pcnt.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_segs(counts):
    return -(-int(np.max(counts)) // TS.SEG)


def _jax(q, vecs, poff, pcnt, *, k, max_segs, metric="sqeuclidean"):
    d, i = JS.ivf_probe_scan(jnp.asarray(q), None, jnp.asarray(vecs),
                             jnp.asarray(poff), jnp.asarray(pcnt), k=k,
                             max_segs=max_segs, metric=metric, interpret=True)
    return np.asarray(d), np.asarray(i)


def _assert_rows_match(got, want, want_d, rel=1e-5):
    """Rows equal, except that two entries whose distances lie within f32
    rounding of each other (1e-5 relative) may trade places."""
    d = np.asarray(want_d, np.float64)
    close = np.abs(np.diff(d, axis=1)) <= rel * np.maximum(np.abs(d[:, 1:]), 1)
    tie = np.zeros(d.shape, bool)
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    ok = (np.asarray(got) == np.asarray(want)) | tie
    assert ok.all(), np.argwhere(~ok)[:5]


def _assert_same(td, ti, jd, ji):
    live = jd < 1e30
    np.testing.assert_array_equal(td < 1e30, live)
    np.testing.assert_array_equal(ti[~live], -1)
    np.testing.assert_allclose(td[live], jd[live], rtol=RTOL, atol=ATOL)
    _assert_rows_match(ti, ji, jd)


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("b,nprobe,k", [(4, 3, 10), (20, 3, 10), (20, 4, 1),
                                        (20, 2, 100), (20, 2, 600)])
def test_matches_pallas_interpret(ivf_layout, rng, b, nprobe, k, metric):
    """B = 20 is not a multiple of the TPU kernel's 16-query block; k = 600
    takes the per-probe cap (kp = 512)."""
    vecs, _, counts = ivf_layout
    q = rng.standard_normal((b, 128)).astype(np.float32)
    poff, pcnt = _probes(rng, ivf_layout, b, nprobe)
    ms = _max_segs(counts)
    jd, ji = _jax(q, vecs, poff, pcnt, k=k, max_segs=ms, metric=metric)
    td, ti = TS.ivf_probe_scan(_t(q), None, _t(vecs), _t(poff), _t(pcnt),
                               k=k, max_segs=ms, metric=metric)
    assert td.shape == ti.shape == (b, k) and ti.dtype == torch.int32
    _assert_same(td.numpy(), ti.numpy(), jd, ji)


def test_per_probe_cap_and_padding(ivf_layout, rng):
    """k = 600 over the 1024-row list and the 3-row list: a query takes at
    most 512 candidates from one list, so 515 are filled and the rest pad
    with (NEG_FILL, -1), as the Pallas kernel gives; the uncapped oracle
    fills all 600."""
    vecs, offsets, counts = ivf_layout
    b = 5
    q = rng.standard_normal((b, 128)).astype(np.float32)
    poff = np.tile(offsets[[3, 4]], (b, 1)).astype(np.int32)
    pcnt = np.tile(counts[[3, 4]], (b, 1)).astype(np.int32)
    jd, ji = _jax(q, vecs, poff, pcnt, k=600, max_segs=2)
    td, ti = TS.ivf_probe_scan(_t(q), None, _t(vecs), _t(poff), _t(pcnt),
                               k=600, max_segs=2)
    _assert_same(td.numpy(), ti.numpy(), jd, ji)
    assert ((ti >= 0).sum(1) == 515).all()
    assert (td[:, 515:] == TS.NEG_FILL).all()
    od, _ = TS.ivf_probe_scan_reference(q, None, vecs, poff, pcnt, k=600)
    assert (od < 1e30).all()


def test_k_past_every_candidate_pads(ivf_layout, rng):
    """k > nprobe * kp: the tail holds (NEG_FILL, -1)."""
    vecs, offsets, counts = ivf_layout
    q = rng.standard_normal((3, 128)).astype(np.float32)
    poff = np.tile(offsets[[0]], (3, 1)).astype(np.int32)
    pcnt = np.tile(counts[[0]], (3, 1)).astype(np.int32)
    td, ti = TS.ivf_probe_scan(_t(q), None, _t(vecs), _t(poff), _t(pcnt),
                               k=1000, max_segs=2)
    assert td.shape == (3, 1000)
    assert (ti[:, :512] >= 0).all() and (ti[:, 512:] == -1).all()
    assert (td[:, 512:] == TS.NEG_FILL).all()


def test_max_segs_cuts_long_lists(ivf_layout, rng):
    """max_segs = 1 reads the first 512 rows of a list, as the Pallas
    kernel's segment loop does."""
    vecs, offsets, counts = ivf_layout
    q = rng.standard_normal((6, 128)).astype(np.float32)
    poff = np.tile(offsets[[0, 3]], (6, 1)).astype(np.int32)
    pcnt = np.tile(counts[[0, 3]], (6, 1)).astype(np.int32)
    jd, ji = _jax(q, vecs, poff, pcnt, k=50, max_segs=1)
    td, ti = TS.ivf_probe_scan(_t(q), None, _t(vecs), _t(poff), _t(pcnt),
                               k=50, max_segs=1)
    _assert_same(td.numpy(), ti.numpy(), jd, ji)
    off = ti.numpy() - np.where(ti.numpy() >= offsets[3], offsets[3], 0)
    assert off.max() < TS.SEG


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_all_empty_probes(ivf_layout, rng, metric):
    vecs, _, _ = ivf_layout
    q = rng.standard_normal((20, 128)).astype(np.float32)
    poff = np.zeros((20, 3), np.int32)
    pcnt = np.zeros((20, 3), np.int32)
    jd, ji = _jax(q, vecs, poff, pcnt, k=5, max_segs=2, metric=metric)
    td, ti = TS.ivf_probe_scan(_t(q), None, _t(vecs), _t(poff), _t(pcnt),
                               k=5, max_segs=2, metric=metric)
    assert (ji == -1).all() and (ti.numpy() == -1).all()
    assert (td.numpy() == TS.NEG_FILL).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_plain_partials_are_per_probe_top_kp(ivf_layout, rng, metric):
    """probe_scan_plain's partial [p, b] is the oracle's top-kp over that
    one probe's list."""
    vecs, _, counts = ivf_layout
    b, nprobe, kp = 9, 3, 40
    q = rng.standard_normal((b, 128)).astype(np.float32)
    poff, pcnt = _probes(rng, ivf_layout, b, nprobe)
    pd, pi = TS.probe_scan_plain(_t(q), _t(vecs), _t(poff), _t(pcnt), kp=kp,
                                 max_segs=_max_segs(counts), metric=metric)
    assert pd.shape == pi.shape == (nprobe, b, kp)
    for p in range(nprobe):
        od, oi = TS.ivf_probe_scan_reference(q, None, vecs, poff[:, p:p + 1],
                                             pcnt[:, p:p + 1], k=kp,
                                             metric=metric)
        _assert_same(pd[p].numpy(), pi[p].numpy(), od, oi)


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_oracle_copy_matches_jax_oracle(ivf_layout, rng, metric):
    vecs, _, _ = ivf_layout
    q = rng.standard_normal((7, 128)).astype(np.float32)
    poff, pcnt = _probes(rng, ivf_layout, 7, 3)
    want = JS.ivf_probe_scan_reference(q, None, vecs, poff, pcnt, k=30,
                                       metric=metric)
    got = TS.ivf_probe_scan_reference(q, None, vecs, poff, pcnt, k=30,
                                      metric=metric)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_constants_match_the_tpu_kernel():
    assert TS.SEG == JS.SEG
    assert TS.NEG_FILL == JS.NEG_FILL
    assert [TS.kp_for(k) for k in (1, 10, 600)] == [8, 10, 512]
    # the JAX index's max_segs: ceil(max_list / 512), then a power of two
    assert [TS.segments_for(n) for n in (1, 512, 513, 1500, 2048, 2049)] == \
        [1, 1, 2, 4, 4, 8]
