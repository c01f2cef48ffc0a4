"""The fused IVF-PQ scan (tables built inside the scan, live slots only):
its plain version against the JAX package's ``build_luts`` and Pallas
kernel in interpret mode, against the table-fed plain path bit for bit,
and a lane-by-lane emulation of the CUDA kernel's batched selection
(``csrc/topk_select.cuh`` ``offer_batch``, ``sort_batch``,
``merge_sorted``; the kernel's final rank merge) against ``select_top``.
The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurondb_tpu.ops.pallas import ivf_scan_grouped as JG
from neurondb_tpu.ops.pallas import ivfpq_scan as JPQ
from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as G
from neurondb_tpu_torch.ops.kernels import ivfpq_scan as PQS

LENS = [300, 3, 0, 1100, 128, 127, 40, 513]
DIM = 32
B, NPAD, QT = 20, 4, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, ns, metric, rotate, b=B):
    """A codes layout on 128-column list starts with the 1024-column tail,
    queries, probes with padded columns (query 2 probes one list), the
    tile grouping and the port's tuple inputs."""
    aligned = [(-(-n // 128)) * 128 for n in LENS]
    offsets = np.cumsum([0] + aligned[:-1]).astype(np.int32)
    npad = -(-sum(aligned) // 1024) * 1024 + 1024
    codes_t = rng.integers(0, 256, (ns, npad)).astype(np.uint8)
    cents = rng.standard_normal((len(LENS), DIM)).astype(np.float32)
    cb = (0.5 * rng.standard_normal((ns, 256, DIM // ns))).astype(np.float32)
    counts = np.asarray(LENS, np.int32)
    q = rng.standard_normal((b, DIM)).astype(np.float32)
    nl = len(LENS)
    probes = np.argsort(rng.random((b, nl)), axis=1)[:, :NPAD].astype(np.int32)
    probes[2, 1:] = nl
    R = None
    if rotate:
        R = np.linalg.qr(rng.standard_normal((DIM, DIM)))[0].astype(np.float32)
    t_max = JG.tiles_for(b, NPAD, nl, QT)
    toff, tcnt, pos = G.group_probes(_t(probes), _t(offsets), _t(counts),
                                     qt=QT, t_max=t_max)
    ins = PQS.pq_tuple_inputs(_t(q), _t(probes), _t(cents), _t(cb), pos,
                              None if R is None else _t(R), npad=NPAD, qt=QT,
                              t_max=t_max, metric=metric)
    return dict(codes_t=codes_t, cents=cents, cb=cb, offsets=offsets,
                counts=counts, q=q, probes=probes, R=R, t_max=t_max,
                toff=toff, tcnt=tcnt, pos=pos, ins=ins, metric=metric)


def _fused(c, kp, pb):
    qc, cn, sq, scale, st = c["ins"]
    return PQS.grouped_pq_scan_fused(qc, cn, _t(c["cb"]), sq, scale, st,
                                     _t(c["codes_t"]), c["toff"], c["tcnt"],
                                     kp=kp, qt=QT, pos_bits=pb)


def _pb(packed):
    return max(11, (max(LENS) - 1).bit_length()) if packed else 0


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ns", [8, 32])
@pytest.mark.parametrize("metric,rotate", [("sqeuclidean", False),
                                           ("sqeuclidean", True),
                                           ("ip", False)])
def test_fused_plain_matches_jax(rng, ns, packed, metric, rotate):
    """The fused plain version against JAX's ``build_luts`` followed by
    ``grouped_pq_scan(interpret=True)``, on live slots. The tolerances of
    test_grouped_search_matches_jax: the tables' products are summed in
    another order (1e-5 relative on distances of ~10, atol 1e-4); packed
    keys round by 2**(pb-24) relative, and a row one side holds and the
    other does not lies within that window of the last distance."""
    c = _case(rng, ns, metric, rotate)
    pb = _pb(packed)
    kp = 10
    lut = JPQ.build_luts(jnp.asarray(c["q"]), jnp.asarray(c["probes"]),
                         jnp.asarray(c["cents"]), jnp.asarray(c["cb"]),
                         jnp.asarray(c["pos"].numpy()),
                         None if c["R"] is None else jnp.asarray(c["R"]),
                         npad=NPAD, qt=QT, t_max=c["t_max"], metric=metric)
    jd, ji = JPQ.grouped_pq_scan(lut, jnp.asarray(c["codes_t"]),
                                 jnp.asarray(c["toff"].numpy()),
                                 jnp.asarray(c["tcnt"].numpy()), kp=kp,
                                 qt=QT, interpret=True, pos_bits=pb)
    td, ti = _fused(c, kp, pb)
    slots = c["pos"].long()                         # the tuples' slots
    jd = np.asarray(jd).reshape(-1, kp)[slots]
    ji = np.asarray(ji).reshape(-1, kp)[slots]
    td = td.reshape(-1, kp)[slots].numpy()
    ti = ti.reshape(-1, kp)[slots].numpy()
    tol = 1e-5 + 2 * (2.0 ** (pb - 24) if packed else 0.0)
    live = jd < 1e30
    np.testing.assert_array_equal(td < 1e30, live)
    np.testing.assert_allclose(td[live], jd[live], rtol=tol, atol=1e-4)
    for s in range(len(slots)):
        got = set(ti[s][live[s]].tolist())
        want = set(ji[s][live[s]].tolist())
        if got != want:
            kth = float(jd[s][live[s]][-1])
            for r in got ^ want:
                side_d, side_r = (td[s], ti[s]) if r in got else (jd[s], ji[s])
                dist = float(side_d[list(side_r).index(r)])
                assert abs(dist - kth) <= tol * max(1.0, abs(kth)) + 1e-4


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("metric,rotate", [("sqeuclidean", True),
                                           ("ip", False)])
def test_fused_plain_is_table_fed_plain_on_live_slots(rng, packed, metric,
                                                      rotate):
    """Bit for bit: ``build_luts`` then ``grouped_pq_scan_plain`` on the
    slots that hold a tuple, (NEG_FILL, -1) on the empty ones."""
    c = _case(rng, 8, metric, rotate)
    pb = _pb(packed)
    lut = PQS.build_luts(_t(c["q"]), _t(c["probes"]), _t(c["cents"]),
                         _t(c["cb"]), c["pos"],
                         None if c["R"] is None else _t(c["R"]), npad=NPAD,
                         qt=QT, t_max=c["t_max"], metric=metric)
    pd, pi = PQS.grouped_pq_scan_plain(lut, _t(c["codes_t"]), c["toff"],
                                       c["tcnt"], kp=24, qt=QT, pos_bits=pb)
    fd, fi = _fused(c, 24, pb)
    live = (c["ins"][4] >= 0).reshape(-1, QT)
    assert 0 < int(live.sum()) < live.numel()       # some slots are empty
    assert torch.equal(fd[live], pd[live]) and torch.equal(fi[live], pi[live])
    assert (fd[~live] == PQS.NEG_FILL).all() and (fi[~live] == -1).all()


def test_fused_all_sentinel_tiles(rng):
    c = _case(rng, 8, "sqeuclidean", False, b=8)
    probes = torch.full((8, NPAD), len(LENS), dtype=torch.int32)
    toff, tcnt, pos = G.group_probes(probes, _t(c["offsets"]), _t(c["counts"]),
                                     qt=QT, t_max=c["t_max"])
    qc, cn, sq, scale, st = PQS.pq_tuple_inputs(
        _t(c["q"]), probes, _t(c["cents"]), _t(c["cb"]), pos, None,
        npad=NPAD, qt=QT, t_max=c["t_max"], metric="sqeuclidean")
    for pb in (0, _pb(True)):
        d, i = PQS.grouped_pq_scan_fused(qc, cn, _t(c["cb"]), sq, scale, st,
                                         _t(c["codes_t"]), toff, tcnt, kp=10,
                                         qt=QT, pos_bits=pb)
        assert (d == PQS.NEG_FILL).all() and (i == -1).all()


def test_slot_tuple_inverts_pos(rng):
    c = _case(rng, 8, "sqeuclidean", False)
    st, pos = c["ins"][4], c["pos"].long()
    assert st.dtype == torch.int32 and st.shape == (c["t_max"] * QT,)
    assert torch.equal(st[pos].long(), torch.arange(B * NPAD))
    assert int((st >= 0).sum()) == B * NPAD


def test_search_pipeline_takes_the_fused_entry(rng, monkeypatch):
    """``ivfpq_grouped_search`` scores through the fused entry and equals
    the table-fed pipeline bit for bit."""
    c = _case(rng, 8, "sqeuclidean", True)
    args = [_t(c[k]) for k in ("q", "probes", "cents", "cb", "codes_t",
                               "offsets", "counts")]
    calls = []
    fused = PQS.grouped_pq_scan_fused
    monkeypatch.setattr(PQS, "grouped_pq_scan_fused",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    d, r = PQS.ivfpq_grouped_search(*args, k=10, qt=QT, R=_t(c["R"]))
    assert calls == [1]
    lut = PQS.build_luts(args[0], args[1], args[2], args[3], c["pos"],
                         _t(c["R"]), npad=NPAD, qt=QT, t_max=c["t_max"],
                         metric="sqeuclidean")
    od, oi = PQS.grouped_pq_scan_plain(lut, args[4], c["toff"], c["tcnt"],
                                       kp=10, qt=QT)
    wd, wr = G.merge_partials(od, oi, c["pos"].reshape(B, NPAD), k=10)
    assert torch.equal(d, wd) and torch.equal(r, wr)


def test_fused_wrapper_contract(rng):
    c = _case(rng, 8, "sqeuclidean", False)
    qc, cn, sq, scale, st = c["ins"]
    before = PQS.LAUNCHES
    d, i = _fused(c, 8, 0)
    assert PQS.LAUNCHES == before and d.shape == (c["t_max"], QT, 8)
    with pytest.raises(ValueError, match="several devices"):
        PQS.grouped_pq_scan_fused(qc, cn, _t(c["cb"]), sq, scale, st,
                                  _t(c["codes_t"]).to("meta"), c["toff"],
                                  c["tcnt"], kp=8, qt=QT)


# ---- the CUDA kernel's batched selection, lane by lane ------------------

BATCH = 64            # topk_select.cuh kBatch


def _before(ka, ra, kb, rb, rows):
    return ka < kb or (rows and ka == kb and ra < rb)


def _count_below(sk, sr, n, xk, xr, rows, after_too):
    """``count_below``: binary lifting over the sorted s[0, n)."""
    pos, step = 0, (1 << (n.bit_length() - 1)) if n > 0 else 0
    while step:
        i = pos + step - 1
        if i < n:
            if after_too:
                below = not _before(xk, xr, sk[i], sr[i], rows)
            else:
                below = _before(sk[i], sr[i], xk, xr, rows)
            if below:
                pos += step
        step >>= 1
    return pos


def _merge_sorted(lk, lr, kp, sk, sr, n, rows):
    """``merge_sorted``: the run's places first, then the list's entries
    moved up 32 at a time from the top (each block read, then written),
    then the run's entries, all in place."""
    if n <= 0:
        return
    run = [(sk[i], sr[i], i + _count_below(lk, lr, kp, sk[i], sr[i], rows,
                                           True)) for i in range(n)]
    low = run[0][2]
    for blk in range((kp - 1) >> 5, (low >> 5) - 1, -1):
        moves = []
        for lane in range(32):
            i = (blk << 5) + lane
            if low <= i < kp:
                p = i + _count_below(sk, sr, n, lk[i], lr[i], rows, False)
                moves.append((p, lk[i], lr[i]))
        for p, k, r in moves:                    # after __syncwarp
            if p < kp:
                lk[p], lr[p] = k, r
    for k, r, p in run:
        if p < kp:
            lk[p], lr[p] = k, r


def _bitonic(ent, pad, rows):
    """``sort_batch``'s network over 64 places, entry e = lane + 32 h:
    the stage with partner 32 apart swaps within a lane, the others
    exchange with lane ^ j."""
    v = list(ent) + [pad] * (2 * 32 - len(ent))
    size = 2
    while size <= 64:
        j = size >> 1
        while j:
            new = list(v)
            for e in range(64):
                o = e ^ j
                up, low = (e & size) == 0, (e & j) == 0
                if low == up:
                    take = _before(*v[o], *v[e], rows)
                else:
                    take = _before(*v[e], *v[o], rows)
                if take:
                    new[e] = v[o]
            v = new
            j >>= 1
        size <<= 1
    return v[:len(ent)]


class _Warp:
    """One warp's list, buffer and last entry (``offer_batch``)."""

    def __init__(self, kp, rows, empty):
        self.kp, self.rows, self.empty = kp, rows, empty
        self.lk, self.lr = [empty] * kp, [-1] * kp
        self.bk, self.br = [None] * BATCH, [None] * BATCH
        self.nbuf, self.tk, self.tr = 0, empty, -1

    def flush(self):
        n = self.nbuf
        if n == 0:
            return
        ent = [(self.bk[i], self.br[i] if self.rows else 0) for i in range(n)]
        srt = _bitonic(ent, (self.empty, 0x7FFFFFFF), self.rows)
        assert srt == sorted(ent)                # distinct entries
        for i, (k, r) in enumerate(srt):
            self.bk[i], self.br[i] = k, r
        _merge_sorted(self.lk, self.lr, self.kp, self.bk, self.br, n,
                      self.rows)
        self.nbuf = 0
        self.tk, self.tr = self.lk[-1], self.lr[-1]

    def offer(self, keys, rws, valid):           # 32 lanes
        want = [v and _before(k, r, self.tk, self.tr, self.rows)
                for k, r, v in zip(keys, rws, valid)]
        if not any(want):
            return
        if self.nbuf + sum(want) > BATCH:
            self.flush()
            want = [w and _before(k, r, self.tk, self.tr, self.rows)
                    for w, k, r in zip(want, keys, rws)]
        at = self.nbuf
        for lane in range(32):
            if want[lane]:
                self.bk[at], self.br[at] = keys[lane], rws[lane]
                at += 1
        self.nbuf = at


def _emulate(d, off, kp, pb, nm):
    """The kernel's selection for one slot over distances d [cnt]: nm
    warps, member m taking 128-row chunks m, m + nm, ...; then the rank
    merge of their lists into the output. Returns (dists, rows) as the
    kernel writes them."""
    cnt, rows = len(d), pb == 0
    empty = float(PQS.NEG_FILL) if rows else PQS.INT_FILL
    warps = [_Warp(kp, rows, empty) for _ in range(nm)]
    if pb:
        keys = G.pack_keys(torch.from_numpy(d), torch.arange(cnt),
                           torch.ones(cnt, dtype=torch.bool), pb).tolist()
    for m, w in enumerate(warps):
        for c0 in range(m * 128, cnt, nm * 128):
            for b in range(4):
                ps = [c0 + 4 * lane + b for lane in range(32)]
                valid = [p < cnt for p in ps]
                if rows:
                    ks = [float(d[p]) if p < cnt else 0.0 for p in ps]
                    rs = [off + p for p in ps]
                else:
                    ks = [keys[p] if p < cnt else PQS.INT_FILL for p in ps]
                    rs = [0] * 32
                w.offer(ks, rs, valid)
        w.flush()
    out_k, out_r = [None] * kp, [None] * kp
    for m, w in enumerate(warps):               # an entry of member m goes
        for i in range(kp):                     # to its index plus, per
            p = i                               # other member v, v's count
            for v, o in enumerate(warps):       # before it (v < m: or equal)
                if v != m and p < kp:
                    p += _count_below(o.lk, o.lr, kp, w.lk[i], w.lr[i], rows,
                                      v < m)
            if p < kp:
                assert out_k[p] is None          # the places are distinct
                out_k[p], out_r[p] = w.lk[i], w.lr[i]
    if rows:
        return (torch.tensor(out_k, dtype=torch.float32),
                torch.tensor(out_r, dtype=torch.int32))
    return G.unpack_keys(torch.tensor(out_k, dtype=torch.int32), pb,
                         torch.tensor(off))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cnt,kp,nm", [(977, 80, 4), (977, 80, 1),
                                       (300, 256, 3), (40, 10, 4),
                                       (0, 16, 2), (513, 96, 6)])
def test_batched_selection_matches_select_top(packed, cnt, kp, nm):
    """Distances drawn from 9 values, so ties in d are everywhere: exact
    mode must break them by the smaller row, packed mode by the key's
    position; both equal ``select_top`` bit for bit."""
    rng = np.random.default_rng(cnt + kp + nm + packed)
    d = (rng.integers(0, 9, cnt) * 0.25 + 1.0).astype(np.float32)
    off, pb = 4096, (11 if packed else 0)
    gd, gi = _emulate(d, off, kp, pb, nm)
    wd, wi = G.select_top(torch.from_numpy(d).reshape(1, 1, cnt),
                          torch.tensor([off], dtype=torch.int32),
                          torch.ones((1, cnt), dtype=torch.bool), kp=kp,
                          pos_bits=pb)
    assert torch.equal(gd, wd[0, 0]) and torch.equal(gi, wi[0, 0])
