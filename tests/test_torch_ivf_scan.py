"""The round-1 IVF probe scan: the torch port (its plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode and its
numpy oracle. The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py."""

import bisect

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


# ---- the CUDA kernel's work table, on the CPU --------------------------


def _hot_probes(rng, layout, b, nprobe, lists=(0, 3, 4)):
    """Every query probes among a few lists, so groups outgrow a tile;
    repeats count 0 rows, as in ``_probes``."""
    _, offsets, counts = layout
    pr = np.stack([rng.permutation(len(counts))[:nprobe] for _ in range(b)])
    pr = np.asarray(lists)[pr % len(lists)]
    poff, pcnt = offsets[pr], counts[pr].copy()
    for i in range(b):
        seen = set()
        for j in range(nprobe):
            if int(pr[i, j]) in seen:
                pcnt[i, j] = 0
            seen.add(int(pr[i, j]))
    return poff.astype(np.int32), pcnt.astype(np.int32)


def _check_items(keys, order, tile, n):
    """Items hold one key and at most ``tile`` tuples inside one
    block's positions; every tuple lies in exactly one item; the grid
    from shapes covers them all."""
    start, stop = TS.work_items(keys, tile)
    T = keys.numel()
    grid = -(-T // tile)
    assert int(start[0]) == 0 and int(stop[-1]) == T
    assert torch.equal(start[1:], stop[:-1])
    assert bool(((stop - start) <= tile).all())
    assert bool(((start // tile) == ((stop - 1) // tile)).all())
    assert int(((stop - 1) // tile).max()) < grid
    for s, e in zip(start.tolist(), stop.tolist()):
        assert bool((keys[s:e] == keys[s]).all())
    hits = torch.zeros(T, dtype=torch.int64)
    hits[order] += 1
    assert bool((hits == 1).all())
    live = (keys >= 0) & ((keys & 0xFFFFFFFF) > 0)
    assert torch.equal(keys[live] & 0xFFFFFFFF, n.reshape(-1)[order][live])
    return start, stop


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("tile", [4, 8, 32])
def test_work_table_items(ivf_layout, rng, hot, tile):
    vecs, _, counts = ivf_layout
    b, nprobe = 40, 4
    poff, pcnt = (_hot_probes if hot else _probes)(rng, ivf_layout, b, nprobe)
    ms = _max_segs(counts)
    keys, order = TS.work_table(_t(poff), _t(pcnt), n_rows=vecs.shape[0],
                                max_segs=ms)
    assert keys.dtype == order.dtype == torch.int64
    assert bool((keys[1:] >= keys[:-1]).all())
    n = TS._clamped_counts(_t(poff), _t(pcnt), vecs.shape[0]).clamp(
        max=ms * TS.SEG)
    start, stop = _check_items(keys, order, tile, n)
    # equal keys keep the tuples' order (a stable sort)
    for s, e in zip(start.tolist(), stop.tolist()):
        assert bool((order[s + 1:e] > order[s:e - 1]).all())
    if hot:
        assert int((stop - start).max()) == tile     # groups split


def test_work_table_keeps_shared_offsets_apart():
    """An empty list starts where the next list starts, and a list probed
    twice counts 0 the second time: neither joins the live list's item,
    and max_segs and the store's end cut the counts."""
    lens = [5, 0, 0, 7, 3, 600]
    offsets = np.asarray([0, 32, 32, 32, 64, 96], np.int32)
    poff = offsets[[[1, 3, 2, 3], [3, 0, 1, 5], [2, 3, 3, 4]]].astype(np.int32)
    pcnt = np.asarray(lens)[[[1, 3, 2, 3], [3, 0, 1, 5], [2, 3, 3, 4]]]
    pcnt = pcnt.astype(np.int32)
    pcnt[0, 3] = 0                                   # list 3 probed twice
    pcnt[2, 2] = 0
    keys, order = TS.work_table(_t(poff), _t(pcnt), n_rows=700, max_segs=1)
    want = {(32, 7): [1, 4, 9], (0, 5): [5], (96, 512): [7], (64, 3): [11]}
    for (off, n), tuples in want.items():
        sel = keys == ((off << 32) | n)
        assert sorted(order[sel].tolist()) == tuples
    empty = (keys < 0) | ((keys & 0xFFFFFFFF) == 0)
    assert sorted(order[empty].tolist()) == [0, 2, 3, 6, 8, 10]
    n = TS._clamped_counts(_t(poff), _t(pcnt), 700).clamp(max=TS.SEG)
    for tile in (4, 32):
        _check_items(keys, order, tile, n)
    # a store that ends inside list 5 cuts it; an offset past it empties it
    keys, _ = TS.work_table(_t(poff), _t(pcnt), n_rows=200, max_segs=4)
    assert int((keys == ((96 << 32) | 104)).sum()) == 1
    keys, _ = TS.work_table(_t(poff), _t(pcnt), n_rows=90, max_segs=4)
    assert int((keys >> 32)[(keys & 0xFFFFFFFF) > 0].max()) == 64
    # an offset below 0 reads nothing: its key is below 0
    poff[1, 1] = -5
    keys, order = TS.work_table(_t(poff), _t(pcnt), n_rows=700, max_segs=4)
    assert int(order[0]) == 5 and int(keys[0]) < 0


def test_tile_fills_the_card():
    assert TS.tile_for(16384 * 8, 32, 132) == 32
    assert TS.tile_for(1024 * 4, 32, 132) == 8
    assert TS.tile_for(37 * 3, 32, 132) == 4
    assert TS.tile_for(1000, 8, 1) == 8


def _emulate(q, vecs, poff, pcnt, *, kp, max_segs, metric, tile):
    """The kernel's walk in plain torch: item by item from the work
    table, each item's list scored once for all of its tuples, each
    tuple's top-kp (kp <= 16: through the lanes' register lists) written
    at its own place."""
    B, nprobe = poff.shape
    out_d = torch.full((nprobe, B, kp), TS.NEG_FILL)
    out_i = torch.full((nprobe, B, kp), -1, dtype=torch.int32)
    keys, order = TS.work_table(poff, pcnt, n_rows=vecs.shape[0],
                                max_segs=max_segs)
    for s, e in zip(*(t.tolist() for t in TS.work_items(keys, tile))):
        key = int(keys[s])
        off, n = key >> 32, key & 0xFFFFFFFF
        if key < 0 or n == 0:
            continue
        tup = order[s:e]
        qs = q[tup // nprobe]
        x = vecs[off:off + n].float()
        dots = qs @ x.T
        if metric == "ip":
            d = -dots
        else:
            d = torch.clamp(((qs * qs).sum(1)[:, None] + (x * x).sum(1))
                            - 2.0 * dots, min=0.0)
        if kp <= REG_K:
            sd, si = _lane_lists(d, off, kp)
        else:
            sd, si = (t[0] for t in TS.select_top(
                d[None], torch.tensor([off]),
                torch.ones((1, n), dtype=torch.bool), kp=kp))
        out_d[tup % nprobe, tup // nprobe] = sd
        out_i[tup % nprobe, tup // nprobe] = si
    return out_d, out_i


REG_K = 16      # the kernel's register lists: kp <= 16 selects there


def _lane_lists(d, off, kp):
    """The kernel's selection in registers, lane by lane: a query's
    32 / (W / 4) lanes take rows sub, sub + lanes, ... of each 64-row
    chunk and keep their 16 best, a candidate placed by distance alone
    (a lane's rows only grow) and let in only before tau, the least of
    the lanes' kp-th entries at the chunk's start; then kp times the least
    head over the lanes' lists. d [nq, n]; returns (dists, rows)
    [nq, kp]."""
    nq, n = d.shape
    w = min(t for t in TS.TILES if t >= nq)
    lanes = 32 // (w // 4)
    fill = (TS.NEG_FILL, -1)
    out_d = torch.empty((nq, kp))
    out_i = torch.empty((nq, kp), dtype=torch.int32)
    for j in range(nq):
        lists = [[] for _ in range(lanes)]
        for c0 in range(0, n, 64):
            tau = min((lst + [fill] * REG_K)[kp - 1] for lst in lists)
            for sub, lst in enumerate(lists):
                for r in range(c0 + sub, min(c0 + 64, n), lanes):
                    cand = (float(d[j, r]), off + r)
                    if cand < tau:
                        lst.insert(bisect.bisect_right(
                            [e[0] for e in lst], cand[0]), cand)
                        del lst[REG_K:]
        best = []                       # kp times the least head
        for _ in range(kp):
            heads = [(lst[0] if lst else fill, i)
                     for i, lst in enumerate(lists)]
            head, i = min(heads)
            best.append(head)
            if lists[i]:
                lists[i].pop(0)
        out_d[j] = torch.tensor([e[0] for e in best])
        out_i[j] = torch.tensor([e[1] for e in best], dtype=torch.int32)
    return out_d, out_i


@pytest.mark.parametrize("metric", ["sqeuclidean", "ip"])
@pytest.mark.parametrize("k", [1, 10, 512])
def test_item_walk_reproduces_plain(ivf_layout, rng, metric, k):
    """Small integers make every f32 product and sum exact, so any order
    of the sums gives the same bits, and ties are many: the item walk
    equals probe_scan_plain exactly, hot lists, repeats and empty probes
    included."""
    vecs, _, counts = ivf_layout
    vi = torch.from_numpy(rng.integers(-3, 4, vecs.shape).astype(np.float32))
    b, nprobe = 40, 3
    q = torch.from_numpy(rng.integers(-3, 4, (b, 128)).astype(np.float32))
    poff, pcnt = _hot_probes(rng, ivf_layout, b, nprobe, lists=(0, 1, 3, 4))
    pcnt[::7, 1] = 0
    poff, pcnt = _t(poff), _t(pcnt)
    kp, ms = TS.kp_for(k), _max_segs(counts)
    pd, pi = TS.probe_scan_plain(q, vi, poff, pcnt, kp=kp, max_segs=ms,
                                 metric=metric)
    for tile in (4, 32):
        ed, ei = _emulate(q, vi, poff, pcnt, kp=kp, max_segs=ms,
                          metric=metric, tile=tile)
        assert torch.equal(ed, pd) and torch.equal(ei, pi)
