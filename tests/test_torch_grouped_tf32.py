"""The f32 store's grouped-scan arithmetic on the CPU.

The CUDA kernel (``csrc/ivf_scan_grouped.cu``, f32 store) makes each
product q . x from three TF32 tensor-core products: every operand is
split into hi = tf32(x) and lo = tf32(x - hi), rounded as ``cvt.rna``
rounds (``csrc/hopper.cuh`` ``split_tf32``), and each m16n8k8 k-step of
8 dims adds lo.hi, then hi.lo, then hi.hi (flash's order) to the f32
accumulator. Here that arithmetic is emulated in plain
torch: each mma adds its 8 exact products to the accumulator with one
rounding toward zero, which is how the tensor cores round (Fasi et al.,
"Numerical behavior of NVIDIA tensor cores", 2021) and the larger error
of the two roundings. The emulated scan is held to ``grouped_scan_plain``
and to the JAX package's Pallas kernel in interpret mode. The tolerance
it fixes, ``F32_TERMS_TOL`` of |q|^2 + |x|^2 beside rtol 1e-4, is the one
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops.pallas import ivf_scan_grouped as JG
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as TG

RTOL = 1e-4          # the card checks' relative tolerance
TOL = 1e-3           # against the Pallas kernel (its own tests' tolerance)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest, ties
    away from zero (add half a step to the magnitude bits, clear 13)."""
    b = x.contiguous().view(torch.int32).long()
    return ((b + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _toward_zero(v):
    """f64 -> f32, rounded toward zero."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _kernel_dots(q, x):
    """q [tb, m, D], x [tb, n, D] f32 -> q . x [tb, m, n] as the kernel
    sums it: per 8-dim k-step lo.hi, hi.lo, hi.hi, each an mma whose 8
    exact products join the accumulator with one rounding toward zero."""
    pad = -q.shape[-1] % 8
    q = torch.nn.functional.pad(q, (0, pad))
    x = torch.nn.functional.pad(x, (0, pad))
    (qh, ql), (xh, xl) = _split(q), _split(x)

    def steps(a, b):      # [k-steps, tb, m, n], exact in f64
        a = a.double().unflatten(-1, (-1, 8))
        b = b.double().unflatten(-1, (-1, 8))
        return torch.einsum("bmkd,bnkd->kbmn", a, b)
    parts = steps(ql, xh), steps(qh, xl), steps(qh, xh)
    acc = torch.zeros(q.shape[0], q.shape[1], x.shape[1])
    for k in range(parts[0].shape[0]):
        for p in parts:
            acc = _toward_zero(acc.double() + p[k])
    return acc


def _emulated_scan(qpad, vecs, tile_off, tile_cnt, *, kp, qt,
                   metric="sqeuclidean", pos_bits=0, block_min=False):
    """``grouped_scan_plain`` with the kernel's f32-store products."""
    T, D = tile_off.shape[0], qpad.shape[1]
    n_rows = vecs.shape[0]
    cnt = TG._clamped_counts(tile_off, tile_cnt, n_rows)
    L = max(int(cnt.max()), 1)
    cols = torch.arange(L)
    rows = tile_off.long()[:, None] + cols
    valid = cols[None, :] < cnt[:, None]
    x = vecs[rows.clamp(0, n_rows - 1)].float()
    q = qpad.float().reshape(T, qt, D)
    dots = _kernel_dots(q, x)
    if metric == "ip":
        d = -dots
    else:
        qsq, xsq = (q * q).sum(-1), (x * x).sum(-1)
        d = torch.clamp((qsq[:, :, None] + xsq[:, None, :]) - 2.0 * dots,
                        min=0.0)
    return TG.select_top(d, tile_off, valid, kp=kp, pos_bits=pos_bits,
                         block_min=block_min)


def _layout(rng, lens, dim, integer=False):
    aligned = [(-(-n // 32)) * 32 for n in lens]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    vecs = rng.standard_normal((npad, dim)).astype(np.float32)
    if integer:
        vecs = np.round(vecs * 1.5).clip(-4, 4)
    return torch.from_numpy(vecs), offsets, np.asarray(lens, np.int32)


def _tiles(rng, vecs, offsets, counts, b, qt, self_rows=0):
    """b queries, the first ``self_rows`` of them corpus rows, 3 probes
    each (one sentinel column), packed into tiles of qt."""
    nl = len(counts)
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :4].astype(np.int32)
    probes[:, 3] = nl
    q = rng.standard_normal((b, vecs.shape[1])).astype(np.float32)
    q = torch.from_numpy(q)
    live = [(lid, r) for lid in range(nl) for r in range(counts[lid])]
    for i in range(self_rows):     # a corpus row, probing its own list
        lid, r = live[int(rng.integers(len(live)))]
        q[i] = vecs[offsets[lid] + r]
        probes[i, 0] = lid
        probes[i, 1:3] = np.where(probes[i, 1:3] == lid, nl, probes[i, 1:3])
    t_max = TG.tiles_for(b, 4, nl, qt)
    toff, tcnt, pos = TG.group_probes(
        torch.from_numpy(probes), torch.from_numpy(offsets),
        torch.from_numpy(counts), qt=qt, t_max=t_max)
    return TG._scatter_tuples(q, pos, npad=4, qt=qt, t_max=t_max), toff, tcnt


def _terms(qpad, vecs, rows, qt):
    T = rows.shape[0]
    q = qpad.reshape(T, qt, 1, -1)
    xsq = (vecs * vecs).sum(-1)
    return torch.where(rows >= 0, (q * q).sum(-1) + xsq[rows.clamp(min=0)],
                       0.0)


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11          # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0])
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0, 0.0]))
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    # hi + lo keeps 22 bits: within 2^-22 |x| (lo.lo is what the kernel drops)
    err = (hi.double() + lo.double() - y.double()).abs()
    assert (err <= 2.0 ** -22 * y.double().abs()).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("dim", [13, 128, 1024])
def test_emulated_kernel_matches_plain(dim, metric):
    """Seeded gaussian rows, half the queries corpus rows (their self-hit
    sits at d ~ 0, where |q|^2 + |x|^2 - 2 q.x cancels): every distance
    within rtol 1e-4 of the plain version's plus F32_TERMS_TOL of
    |q|^2 + |x|^2, the terms-relative error under the tolerance on its
    own, and rows equal away from near-ties."""
    rng = np.random.default_rng(dim)
    vecs, offsets, counts = _layout(rng, [40, 3, 0, 200, 77], dim)
    qt = 16
    qpad, toff, tcnt = _tiles(rng, vecs, offsets, counts, 16, qt,
                              self_rows=8)
    kw = dict(kp=256, qt=qt, metric=metric)    # every row of every list
    ed, ei = _emulated_scan(qpad, vecs, toff, tcnt, **kw)
    pd, pi = TG.grouped_scan_plain(qpad, vecs, toff, tcnt, **kw)
    live = pi >= 0
    assert torch.equal(ei >= 0, live)
    terms = _terms(qpad, vecs, pi, qt)
    diff = (ed - pd).abs()
    assert (diff <= RTOL * pd.abs() + TG.F32_TERMS_TOL * terms)[live].all()
    assert float((diff / terms.clamp(min=1e-30))[live].max()) \
        < TG.F32_TERMS_TOL
    if metric == "sqeuclidean":                # the self-hits were found
        assert int((pd[..., 0] < 1e-2 * terms[..., 0]).sum()) >= 8
    tol = RTOL * pd.abs() + TG.F32_TERMS_TOL * terms
    gap = pd[..., 1:] - pd[..., :-1]
    near = torch.zeros_like(live)
    near[..., 1:] |= gap <= tol[..., 1:] + tol[..., :-1]
    near[..., :-1] |= gap <= tol[..., 1:] + tol[..., :-1]
    assert torch.equal(ei[~near], pi[~near])


@pytest.mark.parametrize("mode", ["exact", "packed", "blockmin"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("dim", [13, 128])
def test_emulated_kernel_integer_data_bit_equal(dim, metric, mode):
    """Small integers are exact in TF32 (lo = 0) and their sums exact in
    f32: the emulated kernel equals the plain version bit for bit, ties
    included, in every mode (at D 13 over a list past one 1024-row
    blockmin segment)."""
    rng = np.random.default_rng(dim + len(mode))
    vecs, offsets, counts = _layout(rng, [40, 3, 0, 1030 if dim < 64 else 300,
                                          77], dim, integer=True)
    qpad, toff, tcnt = _tiles(rng, vecs, offsets, counts, 16, 16,
                              self_rows=4)
    qpad = (qpad * 1.5).round().clamp(-3, 3)
    kw = dict(kp=10, qt=16, metric=metric,
              pos_bits=0 if mode == "exact" else 11,
              block_min=mode == "blockmin")
    ed, ei = _emulated_scan(qpad, vecs, toff, tcnt, **kw)
    pd, pi = TG.grouped_scan_plain(qpad, vecs, toff, tcnt, **kw)
    assert torch.equal(ed, pd) and torch.equal(ei, pi)


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
def test_emulated_search_matches_pallas_interpret(metric):
    """The whole grouped search with the kernel's f32-store products
    against the JAX package's Pallas kernel (interpret mode) on an f32
    store: distances within its tests' tolerance, rows equal except
    where two distances lie within f32 rounding (1e-5 relative)."""
    rng = np.random.default_rng(7)
    vecs, offsets, counts = _layout(rng, [120, 64, 3, 0, 90], 128)
    b, npad, k, qt = 16, 3, 10, 16
    q = rng.standard_normal((b, 128)).astype(np.float32)
    probes = np.argsort(rng.random((b, len(counts))), axis=1)[:, :npad]
    probes = probes.astype(np.int32)
    probes[2, 1:] = len(counts)
    jd, jr = JG.ivf_grouped_search(
        jnp.asarray(q), jnp.asarray(probes), jnp.asarray(vecs.numpy()),
        jnp.asarray(offsets), jnp.asarray(counts), k=k, metric=metric, qt=qt,
        interpret=True, pos_bits=0)
    t_max = TG.tiles_for(b, npad, len(counts), qt)
    toff, tcnt, pos = TG.group_probes(
        torch.from_numpy(probes), torch.from_numpy(offsets),
        torch.from_numpy(counts), qt=qt, t_max=t_max)
    qpad = TG._scatter_tuples(torch.from_numpy(q), pos, npad=npad, qt=qt,
                              t_max=t_max)
    od, oi = _emulated_scan(qpad, vecs, toff, tcnt, kp=k, qt=qt,
                            metric=metric)
    td, tr = TG.merge_partials(od, oi, pos.reshape(b, npad), k=k)
    jd, jr = np.asarray(jd), np.asarray(jr)
    live = jd < 1e30
    np.testing.assert_array_equal(td.numpy() < 1e30, live)
    np.testing.assert_allclose(td.numpy()[live], jd[live], rtol=TOL, atol=TOL)
    d = jd.astype(np.float64)
    close = np.abs(np.diff(d, axis=1)) <= 1e-5 * np.maximum(np.abs(d[:, 1:]), 1)
    tie = np.zeros(d.shape, bool)
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    assert ((tr.numpy() == jr) | tie).all()
