"""The list-grouped IVF scan: the torch port (its plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode, the
numpy oracle. The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops.pallas import ivf_scan_grouped as JG
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as TG

# The Pallas kernel sums with the MXU's order, the plain version with
# torch's: the tolerance of the JAX package's own kernel tests.
TOL = 1e-3


@pytest.fixture(scope="module")
def layout(rng_mod):
    """Ragged lists on 32-row starts with the 1024-row tail, as in
    tests/test_pallas_kernels.py."""
    lens = [700, 512, 100, 1500, 3, 200, 0, 64]
    aligned = [(-(-n // 32)) * 32 for n in lens]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    vecs = rng_mod.standard_normal((npad, 128)).astype(np.float32)
    return vecs, offsets, np.asarray(lens, np.int32)


def _probes(rng, b, npad, nlists):
    probes = rng.integers(0, nlists, (b, npad)).astype(np.int32)
    for row in probes:                 # dedupe; dupes double candidates
        seen = set()
        for j in range(npad):
            if int(row[j]) in seen:
                row[j] = nlists        # sentinel
            seen.add(int(row[j]))
    return probes


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rows_match(got, want, want_d, rel=1e-5):
    """Rows equal, except that two entries whose distances lie within f32
    rounding of each other (1e-5 relative) may trade places: the sums
    run in another order, so such a pair is a tie to either side."""
    d = np.asarray(want_d, np.float64)
    close = np.abs(np.diff(d, axis=1)) <= rel * np.maximum(np.abs(d[:, 1:]), 1)
    tie = np.zeros(d.shape, bool)
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    ok = (np.asarray(got) == np.asarray(want)) | tie
    assert ok.all(), np.argwhere(~ok)[:5]


@pytest.mark.parametrize("qt", [16, 32, 64])
@pytest.mark.parametrize("npad", [3, 16])
def test_group_probes_bit_identical(rng, qt, npad):
    nlists = 40
    b = 64
    probes = _probes(rng, b, npad, nlists)
    probes[3, 1:] = nlists
    probes[7] = nlists                 # a query with no probes at all
    offsets = (np.arange(nlists) * 96).astype(np.int32)
    counts = rng.integers(0, 90, nlists).astype(np.int32)
    t_max = JG.tiles_for(b, npad, nlists, qt)
    want = JG.group_probes(jnp.asarray(probes), jnp.asarray(offsets),
                           jnp.asarray(counts), qt=qt, t_max=t_max)
    got = TG.group_probes(_t(probes), _t(offsets), _t(counts), qt=qt,
                          t_max=t_max)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert TG.tiles_for(b, npad, nlists, qt) == t_max
    assert TG.auto_qt(b, npad, nlists) == JG.auto_qt(b, npad, nlists)


def test_scatter_tuples_matches_jax(rng):
    b, npad, nlists, qt = 20, 4, 6, 16
    probes = _probes(rng, b, npad, nlists)
    offsets = (np.arange(nlists) * 64).astype(np.int32)
    counts = np.full(nlists, 50, np.int32)
    t_max = JG.tiles_for(b, npad, nlists, qt)
    _, _, pos = JG.group_probes(jnp.asarray(probes), jnp.asarray(offsets),
                                jnp.asarray(counts), qt=qt, t_max=t_max)
    q = rng.standard_normal((b, 8)).astype(np.float32)
    want = JG._scatter_tuples(jnp.asarray(q), pos, npad=npad, qt=qt,
                              t_max=t_max)
    got = TG._scatter_tuples(_t(q), _t(np.asarray(pos)), npad=npad, qt=qt,
                             t_max=t_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("k", [5, 10, 100])
@pytest.mark.parametrize("qt", [16, 32, 64])
def test_plain_scan_matches_pallas_interpret(layout, rng, qt, k, metric):
    vecs, offsets, counts = layout
    b, npad = 48, 4
    nlists = len(counts)
    q = rng.standard_normal((b, 128)).astype(np.float32)
    probes = _probes(rng, b, npad, nlists)
    probes[5, 2:] = nlists                   # padded probe slots
    jd, jr = JG.ivf_grouped_search(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(vecs),
        jnp.asarray(offsets), jnp.asarray(counts), k=k, metric=metric, qt=qt,
        interpret=True, pos_bits=0)
    td, tr = TG.ivf_grouped_search(_t(q), _t(probes), _t(vecs), _t(offsets),
                                   _t(counts), k=k, metric=metric, qt=qt)
    jd, jr = np.asarray(jd), np.asarray(jr)
    _assert_rows_match(tr.numpy(), jr, jd)
    live = jd < 1e30
    np.testing.assert_array_equal(td.numpy() < 1e30, live)
    np.testing.assert_allclose(td.numpy()[live], jd[live], rtol=TOL, atol=TOL)
    od, oi = TG.ivf_grouped_search_reference(q, probes, vecs, offsets, counts,
                                             k=k, metric=metric)
    _assert_rows_match(tr.numpy(), oi, od)
    np.testing.assert_allclose(td.numpy()[live], od[live], rtol=TOL, atol=TOL)


def test_all_sentinel_tiles(layout, rng):
    vecs, offsets, counts = layout
    nlists = len(counts)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    probes = np.full((8, 4), nlists, np.int32)
    jd, jr = JG.ivf_grouped_search(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(vecs),
        jnp.asarray(offsets), jnp.asarray(counts), k=5, interpret=True)
    td, tr = TG.ivf_grouped_search(_t(q), _t(probes), _t(vecs), _t(offsets),
                                   _t(counts), k=5)
    assert (tr.numpy() == -1).all() and (np.asarray(jr) == -1).all()
    assert (td.numpy() == TG.NEG_FILL).all()


def _bf16_oracle(q, probes, vecs_bf16, offsets, counts, k, metric):
    """float64 oracle of the bf16-store contract: q rounded to bf16 in the
    product, |q|^2 from the f32 query, |x|^2 from the stored row."""
    qh = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    x = vecs_bf16.double().numpy()
    q64 = q.astype(np.float64)
    out_d = np.full((len(q), k), np.inf)
    out_i = np.full((len(q), k), -1)
    for b in range(len(q)):
        ds, ids = [], []
        for lid in probes[b]:
            if lid >= len(counts):
                continue
            o, c = int(offsets[lid]), int(counts[lid])
            dots = x[o:o + c] @ qh[b]
            if metric == "ip":
                d = -dots
            else:
                d = np.maximum(q64[b] @ q64[b] + (x[o:o + c] ** 2).sum(1)
                               - 2 * dots, 0)
            ds.append(d)
            ids.append(np.arange(o, o + c))
        d, i = np.concatenate(ds), np.concatenate(ids)
        o = np.argsort(d, kind="stable")[:k]
        out_d[b, :len(o)], out_i[b, :len(o)] = d[o], i[o]
    return out_d, out_i


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_plain_scan_bf16_store_matches_oracle(layout, rng, metric):
    vecs, offsets, counts = layout
    vb = _t(vecs).to(torch.bfloat16)
    b, npad, k = 32, 4, 10
    q = rng.standard_normal((b, 128)).astype(np.float32)
    probes = _probes(rng, b, npad, len(counts))
    probes[:, 0] = 3                         # every query sees a full list
    probes[:, 1:] = np.where(probes[:, 1:] == 3, len(counts), probes[:, 1:])
    td, tr = TG.ivf_grouped_search(_t(q), _t(probes), vb, _t(offsets),
                                   _t(counts), k=k, metric=metric, qt=16)
    od, oi = _bf16_oracle(q, probes, vb, offsets, counts, k, metric)
    _assert_rows_match(tr.numpy(), oi, od)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-4, atol=1e-3)


def test_plain_scan_kp_1024_long_list(rng):
    """kp at its cap over lists longer than kp, against the oracle."""
    lens = [2500, 1025, 31]
    offsets = np.array([0, 2528, 3584], np.int32)
    vecs = rng.standard_normal((4 * 1024 + 1024, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    probes = np.array([[0, 1, 2]] * 5, np.int32)
    td, tr = TG.ivf_grouped_search(_t(q), _t(probes), _t(vecs), _t(offsets),
                                   _t(np.asarray(lens, np.int32)), k=1024)
    od, oi = TG.ivf_grouped_search_reference(q, probes, vecs, offsets,
                                             np.asarray(lens), k=1024)
    _assert_rows_match(tr.numpy(), oi, od)
    np.testing.assert_allclose(td.numpy(), od, rtol=TOL, atol=TOL)

