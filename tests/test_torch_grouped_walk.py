"""The bf16-store grouped-scan kernel's selection, emulated lane by lane.

``csrc/ivf_scan_grouped.cu`` (tensor-core kernel) hands each thread the C
fragments of an ``mma.sync`` m16n8k16 product: queries g and g + 8 of its
warp's 16-query m-tile, rows 2t and 2t + 1 of each of its warp's 8-row
n-tiles (lane 4g + t). Lanes t and t ^ 1 trade halves, so that a thread
keeps one query (g + 8 (t & 1)) and rows 4s .. 4s + 3 of each n-tile
(s = t >> 1). The emulation below walks a tile the same way: which
(query, row) each lane holds, its register list of 16, the bound (the
lesser of the query's two lanes' least kp-th and greatest ceil(kp/2)-th
entries) tested before a candidate is queued, the insertion in row order,
blockmin's class minima folded per lane and offered, half the classes at
a time, when a segment or the list ends, the two lanes' lists merged in
each warp and the warps' lists merged per query; kp > 16 offers every
candidate (blockmin: every class minimum) to a sorted list.
On integer data every product and sum is exact, so it must equal
``grouped_scan_plain`` bit for bit, ties and all. Edit it with the kernel.
"""

import numpy as np
import pytest
import torch

from neurondb_tpu_torch.ops.kernels import ivf_scan_grouped as TG

ROWS, WARPS, REG_K = 64, 8, 16          # the kernel's kRows, kWarps, kRegK
SEG, CLASSES = TG.SEG, TG.CLASSES


def m_tiles(qs):
    """m-tiles of 16 queries a block holds (the kernel's ``m_tiles``)."""
    m = -(-qs // 16)
    return 1 if m <= 1 else (2 if m <= 2 else 4)


def lane_rows(rb, s, nt):
    """Chunk rows of lane half s (t >> 1) in the warp of row block rb, in
    the order the thread meets them: n-tile j, then rows 4s .. 4s + 3."""
    return [rb * nt * 8 + 8 * j + 4 * s + u for j in range(nt)
            for u in range(4)]


def _kth(lst, kp, fill):
    return lst[kp - 1] if len(lst) >= kp else fill


def _merge_heads(lists, kp, fill):
    """kp times the least head over ``lists`` (each sorted), popping it:
    the kernel's group_min merge."""
    lists = [list(lst) for lst in lists]
    out = []
    for _ in range(kp):
        heads = [lst[0] if lst else fill for lst in lists]
        i = min(range(len(heads)), key=lambda w: heads[w])
        out.append(heads[i])
        if lists[i]:
            lists[i].pop(0)
    return out


def walk_query(key, n, kp, qs, mode):
    """One query's output keys over a list of n rows: key(pos) is the
    candidate of in-list position pos ((d, row) exact, an int key
    otherwise)."""
    fill = (TG.NEG_FILL, -1) if mode == "exact" else TG.INT_FILL
    nt = m_tiles(qs)
    wpm = WARPS // nt
    lanes = [(rb, h) for rb in range(wpm) for h in range(2)]
    nch = -(-n // ROWS)
    if kp > REG_K:                      # offer_batch: an exact top-kp
        if mode == "blockmin":
            offered = []
            for s in range(0, n, SEG):
                for cls in range(CLASSES):
                    ks = [key(p) for p in range(s + cls, min(s + SEG, n),
                                                CLASSES)]
                    offered += [min(ks)] if ks else []
        else:
            offered = [key(p) for p in range(n)]
        return (sorted(offered) + [fill] * kp)[:kp]
    lst = {ln: [] for ln in lanes}
    minima = {ln: {} for ln in lanes}   # blockmin: class -> least key

    def bound(rb):
        pair = [lst[(rb, h)] for h in range(2)]
        return min(min(_kth(lst_, kp, fill) for lst_ in pair),
                   max(_kth(lst_, -(-kp // 2), fill) for lst_ in pair))

    def insert(ln, cands):
        # by key alone, entries already in the list first (stable sort)
        merged = sorted(lst[ln] + cands,
                        key=(lambda x: x[0]) if mode == "exact" else None)
        lst[ln] = merged[:REG_K]

    for c in range(nch):
        c0 = c * ROWS
        if mode == "blockmin":
            for (rb, t) in lanes:
                for r in lane_rows(rb, t, nt):
                    if c0 + r < n:
                        cls = (c0 & 64) + r
                        k = key(c0 + r)
                        minima[(rb, t)][cls] = min(
                            minima[(rb, t)].get(cls, fill), k)
            if ((c + 1) * ROWS) % SEG == 0 or (c + 1) * ROWS >= n:
                for half in (0, 64):    # classes [half, half + 64)
                    taus = {rb: bound(rb) for rb in range(wpm)}
                    for ln in lanes:
                        insert(ln, [m for cls, m in minima[ln].items()
                                    if half <= cls < half + 64
                                    and m < taus[ln[0]]])
                minima = {ln: {} for ln in lanes}
            continue
        taus = {rb: bound(rb) for rb in range(wpm)}
        for ln in lanes:
            rows = [c0 + r for r in lane_rows(*ln, nt) if c0 + r < n]
            insert(ln, [key(p) for p in rows if key(p) < taus[ln[0]]])
    warp_lists = [_merge_heads([lst[(rb, h)] for h in range(2)], kp, fill)
                  for rb in range(wpm)]
    return _merge_heads(warp_lists, kp, fill)


def walk(qpad, vecs, tile_off, tile_cnt, *, kp, qt, qs, metric, mode, pb):
    """The kernel's output for every tile, sub-tile by sub-tile of qs
    queries: (dists, rows) [T, qt, kp]."""
    T, D = tile_off.shape[0], qpad.shape[1]
    out_d = torch.full((T, qt, kp), TG.NEG_FILL)
    out_i = torch.full((T, qt, kp), -1, dtype=torch.int32)
    cnt = TG._clamped_counts(tile_off, tile_cnt, vecs.shape[0])
    q = qpad.reshape(T, qt, D)
    for ti in range(T):
        n, off = int(cnt[ti]), int(tile_off[ti])
        if n == 0:
            continue
        x = vecs[off:off + n].float()
        qf = q[ti].float()
        dots = qf.to(vecs.dtype).float() @ x.T
        if metric == "ip":
            d = -dots
        else:
            d = torch.clamp(((qf * qf).sum(1)[:, None] + (x * x).sum(1))
                            - 2.0 * dots, min=0.0)
        if mode == "exact":
            cand = [[(v, off + p) for p, v in enumerate(row)]
                    for row in d.tolist()]
        else:
            cand = TG.pack_keys(d, torch.arange(n), torch.ones(n, dtype=bool),
                                pb).tolist()
        for qi in range(qt):            # sub-tiles of qs queries alike
            got = walk_query(cand[qi].__getitem__, n, kp, qs, mode)
            if mode == "exact":
                out_d[ti, qi] = torch.tensor([g[0] for g in got])
                out_i[ti, qi] = torch.tensor([g[1] for g in got],
                                             dtype=torch.int32)
            else:
                out_d[ti, qi], out_i[ti, qi] = TG.unpack_keys(
                    torch.tensor(got, dtype=torch.int32), pb,
                    torch.tensor(off))
    return out_d, out_i


@pytest.mark.parametrize("qs", [8, 16, 64])
@pytest.mark.parametrize("kp", [10, 16, 40])
@pytest.mark.parametrize("mode", ["exact", "packed", "blockmin"])
def test_kernel_walk_reproduces_plain(mode, kp, qs):
    """Integer rows and queries in [-6, 6]: exact distances, many ties.
    Lists of 0 to 2,100 rows (three blockmin segments, a ragged last
    chunk), tiles of 64 queries split into sub-tiles of qs."""
    rng = np.random.default_rng(kp + qs)
    lens = [0, 3, 64, 100, 2100]
    offsets = np.cumsum([0] + [-(-n // 32) * 32 for n in lens[:-1]])
    vecs = torch.from_numpy(rng.integers(-6, 7, (4096, 12))
                            .astype(np.float32)).to(torch.bfloat16)
    qt = 64
    tile_off = torch.tensor(offsets, dtype=torch.int32)
    tile_cnt = torch.tensor(lens, dtype=torch.int32)
    qpad = torch.from_numpy(rng.integers(-6, 7, (len(lens) * qt, 12))
                            .astype(np.float32))
    pb = 0 if mode == "exact" else 12
    metric = "ip" if kp == 16 else "sqeuclidean"
    kw = dict(kp=kp, qt=qt, metric=metric, pos_bits=pb,
              block_min=mode == "blockmin")
    pd, pi = TG.grouped_scan_plain(qpad, vecs, tile_off, tile_cnt, **kw)
    wd, wi = walk(qpad, vecs, tile_off, tile_cnt, kp=kp, qt=qt, qs=qs,
                  metric=metric, mode=mode, pb=pb)
    assert torch.equal(wd, pd) and torch.equal(wi, pi)


def test_lanes_cover_each_chunk_row_once():
    """For each m-tile count, every row of a chunk lies with one lane half
    of one warp row block, and each lane's rows grow."""
    for qs in (8, 16, 32, 64):
        nt = m_tiles(qs)
        rows = [r for rb in range(WARPS // nt) for h in range(2)
                for r in lane_rows(rb, h, nt)]
        assert sorted(rows) == list(range(ROWS))
        for rb in range(WARPS // nt):
            for h in range(2):
                lr = lane_rows(rb, h, nt)
                assert lr == sorted(lr)


def test_regrouped_fragment_holds_one_query_and_four_rows():
    """The m16n8 C fragment (lane 4g + t: queries g, g + 8 x rows 2t,
    2t + 1) after lanes t and t ^ 1 trade halves: lane 4g + t holds query
    g + 8 (t & 1), rows 4 (t >> 1) .. + 3, in order."""
    frag = {(4 * g + t): [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                          (g + 8, 2 * t + 1)] for g in range(8)
            for t in range(4)}
    def sent(lane):                     # odd lanes send c0, c1; even c2, c3
        return frag[lane][:2] if lane & 1 else frag[lane][2:]

    for lane, own in frag.items():
        t = lane & 3
        got = (sent(lane ^ 1) + own[2:] if t & 1 else
               own[:2] + sent(lane ^ 1))
        g = lane >> 2
        assert got == [(g + 8 * (t & 1), 4 * (t >> 1) + u) for u in range(4)]


@pytest.mark.parametrize("qs", [16, 64])
@pytest.mark.parametrize("kp", [10, 16])
@pytest.mark.parametrize("mode", ["exact", "packed", "blockmin"])
def test_kernel_walk_top_rows_in_one_warp(mode, kp, qs):
    """Every query's nearest rows sit at chunk rows 0-7, the first n-tile
    of the first warp, half in each of its two lanes, and tie: the bound
    must let the later ones in while the lanes hold fewer than kp."""
    rng = np.random.default_rng(kp + qs + 1)
    dim, n = 12, 1500
    v = rng.integers(-6, 7, dim)
    far = rng.choice([-6, -5, -4, 4, 5, 6], (n, dim))
    rows = np.where((np.arange(n) % ROWS < 8)[:, None], v, v + far)
    vecs = torch.from_numpy(np.concatenate([rows, np.zeros((1024, dim))])
                            .astype(np.float32)).to(torch.bfloat16)
    qt = 64
    qpad = torch.from_numpy((v + rng.integers(-1, 2, (qt, dim)))
                            .astype(np.float32))
    tile_off = torch.tensor([0], dtype=torch.int32)
    tile_cnt = torch.tensor([n], dtype=torch.int32)
    pb = 0 if mode == "exact" else 11
    kw = dict(kp=kp, qt=qt, metric="sqeuclidean", pos_bits=pb,
              block_min=mode == "blockmin")
    pd, pi = TG.grouped_scan_plain(qpad, vecs, tile_off, tile_cnt, **kw)
    wd, wi = walk(qpad, vecs, tile_off, tile_cnt, kp=kp, qt=qt, qs=qs,
                  metric="sqeuclidean", mode=mode, pb=pb)
    assert torch.equal(wd, pd) and torch.equal(wi, pi)
