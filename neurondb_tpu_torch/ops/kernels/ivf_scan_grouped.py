"""List-grouped IVF probe scan: one pass over a posting list serves a tile
of queries.

Counterpart of ``neurondb_tpu/ops/pallas/ivf_scan_grouped.py``:

  prep    ``group_probes`` sorts the (query, probe) tuples by list id and
          packs each list's queries into tiles of ``qt`` (a tile never
          spans two lists); ``_scatter_tuples`` writes the queries into
          the padded [T * qt, D] buffer.
  scan    ``grouped_probe_scan`` computes each tile's top-kp over its
          list: on a CUDA tensor by the hand-written kernel
          ``csrc/ivf_scan_grouped.cu`` (tensor-core products: bf16 on the
          bf16 store, 3xTF32 on the f32 store; one C entry serves both),
          on a CPU tensor by ``grouped_scan_plain``, the same function in
          plain torch.
  post    ``merge_partials`` gathers each tuple's partial top-kp by its
          padded slot and merges across probe ranks.

The three selection modes of the TPU kernel are ported: exact
(``pos_bits=0``), packed (``pos_bits=pb``: one int32 key per candidate,
``pack_keys``) and blockmin (``block_min=True``: one key per query,
1024-row segment and class ``pos % 128``). ``pack_keys`` and
``unpack_keys`` are the one encode/decode of the packed key; the IVF-PQ
scan imports them, as the JAX PQ module imports from the flat one.

The kernel dispatch follows the tensor's device, never a failure: a CUDA
tensor goes to the kernel or raises. ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.ops.kernels import _build

SEG = 1024        # kp cap, and the blockmin segment (the TPU kernel's)
QT = 16           # queries per tile, smallest bucket
NEG_FILL = float(torch.finfo(torch.float32).max)
INT_FILL = 0x7FFFFFFF  # packed-key sentinel (int32 max)
CLASSES = 128     # blockmin classes per segment (the TPU's lane width)
# opt-in dynamic shared memory per block on sm_90 (227 KB)
SMEM_MAX = 232448
# queries one kernel block serves at most (8 warps x 8 queries)
QS_MAX = 64

LAUNCHES = 0      # kernel launches by grouped_probe_scan on CUDA tensors

# The f32 store's kernel against ``grouped_scan_plain``: |kernel - plain|
# <= 1e-4 |plain| + F32_TERMS_TOL (|q|^2 + |x|^2) per entry. Its products
# are 3xTF32 (lo.lo dropped) summed by the tensor cores, which round each
# step toward zero; near d = 0 the error of |q|^2 + |x|^2 - 2 q.x is
# relative to the terms, not to d (tests/test_torch_grouped_tf32.py).
F32_TERMS_TOL = 2e-5


def tiles_for(b: int, npad: int, nlists: int, qt: int = QT) -> int:
    """Worst-case tile count: every tuple tiled at qt per tile, plus one
    ragged tile per list, plus the sentinel group."""
    return (b * npad) // qt + nlists + 2


def auto_qt(b: int, npad: int, nlists: int) -> int:
    """Queries per tile by expected density (b*npad/nlists queries share
    each probed list). The kernel serves at most ``QS_MAX`` = 64 queries
    per block, the top bucket."""
    density = (b * npad) / max(nlists, 1)
    for qt in (64, 32):
        if density >= qt:
            return qt
    return QT


def group_probes(probes: torch.Tensor, offsets: torch.Tensor,
                 counts: torch.Tensor, *, qt: int, t_max: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probes [B, npad] int list ids (sentinel = nlists for padding).

    Returns (tile_off [t_max] int32, tile_cnt [t_max] int32, pos [B*npad]
    int32: the padded slot of each tuple, in original tuple order). Exact
    integer work: identical to the JAX package's output for the same
    probes."""
    B, npad = probes.shape
    G = B * npad
    dev = probes.device
    flat = probes.reshape(G)
    sl, order = torch.sort(flat, stable=True)       # list id per sorted tuple
    idx = torch.arange(G, device=dev)
    is_start = torch.ones(G, dtype=torch.bool, device=dev)
    is_start[1:] = sl[1:] != sl[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    slot = (idx - seg_start) % qt
    new_tile = is_start | (slot == 0)
    tile_id = torch.cumsum(new_tile.to(torch.int64), dim=0) - 1
    pos = torch.empty(G, dtype=torch.int64, device=dev)
    pos.index_put_((order,), tile_id * qt + slot)
    nlists = counts.shape[0]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    off_ext = torch.cat([offsets.to(torch.int32), zero])
    cnt_ext = torch.cat([counts.to(torch.int32), zero])
    tile_list = torch.full((t_max,), nlists, dtype=torch.int64, device=dev)
    keep = tile_id < t_max                          # JAX scatter mode="drop"
    tile_list.index_put_((tile_id[keep],), sl[keep].to(torch.int64))
    tile_off = off_ext[tile_list]
    tile_cnt = torch.where(tile_list < nlists, cnt_ext[tile_list], 0)
    return tile_off, tile_cnt.to(torch.int32), pos.to(torch.int32)


def _scatter_tuples(q: torch.Tensor, pos: torch.Tensor, *, npad: int,
                    qt: int, t_max: int) -> torch.Tensor:
    """qpad[pos[i]] = q[i // npad] for every tuple i (original order)."""
    G = pos.shape[0]
    tuple_q = torch.arange(G, device=q.device) // npad
    qpad = torch.zeros((t_max * qt, q.shape[1]), dtype=q.dtype,
                       device=q.device)
    qpad[pos.long()] = q[tuple_q]
    return qpad


def _clamped_counts(tile_off: torch.Tensor, tile_cnt: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Tile counts cut so that no row past the store is read."""
    off = tile_off.long()
    inside = (off >= 0) & (off < n_rows)
    return torch.where(inside, torch.minimum(tile_cnt.long(), n_rows - off), 0)


def pack_keys(d: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor,
              pos_bits: int) -> torch.Tensor:
    """Packed selection keys (int32): the monotone bits of the f32
    distance rounded to a multiple of ``2**pos_bits``, OR the in-list
    position; ``INT_FILL`` where not ``valid``. The rounding add wraps
    as XLA's int32 add does (the JAX kernels' arithmetic)."""
    b = d.float().contiguous().view(torch.int32)
    mono = (b ^ ((b >> 31) & 0x7FFFFFFF)).long() + (1 << (pos_bits - 1))
    mono = (mono + (1 << 31)) % (1 << 32) - (1 << 31)        # int32 wrap
    key = (mono & -(1 << pos_bits)) | pos.long()
    return torch.where(valid, key, INT_FILL).to(torch.int32)


def unpack_keys(keys: torch.Tensor, pos_bits: int, off: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys [..., n] int32 -> (rounded distances f32, rows ``off`` + the
    in-list position int32); ``INT_FILL`` decodes to (NEG_FILL, -1).
    ``off`` broadcasts against ``keys``."""
    kb = keys & -(1 << pos_bits)
    dist = (kb ^ ((kb >> 31) & 0x7FFFFFFF)).contiguous().view(torch.float32)
    empty = keys == INT_FILL
    rows = off.to(torch.int32) + (keys & ((1 << pos_bits) - 1))
    return (torch.where(empty, NEG_FILL, dist),
            torch.where(empty, -1, rows).to(torch.int32))


def class_minima(keys: torch.Tensor) -> torch.Tensor:
    """[..., L] keys by in-list position -> [..., ceil(L/SEG) * CLASSES]:
    per SEG-position segment, the minimum key of each class pos % 128
    (blockmin's tournament)."""
    L = keys.shape[-1]
    nseg = -(-L // SEG)
    pad = torch.full((*keys.shape[:-1], nseg * SEG - L), INT_FILL,
                     dtype=keys.dtype, device=keys.device)
    k = torch.cat([keys, pad], dim=-1)
    k = k.reshape(*keys.shape[:-1], nseg, SEG // CLASSES, CLASSES)
    return k.amin(dim=-2).reshape(*keys.shape[:-1], nseg * CLASSES)


def top_keys(keys: torch.Tensor, kp: int, pos_bits: int, off: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kp smallest keys along the last axis, ascending and decoded;
    columns past the candidates hold (NEG_FILL, -1)."""
    kk = min(kp, keys.shape[-1])
    sel = torch.topk(keys, kk, dim=-1, largest=False, sorted=True).values
    if kk < kp:
        pad = torch.full((*keys.shape[:-1], kp - kk), INT_FILL,
                         dtype=keys.dtype, device=keys.device)
        sel = torch.cat([sel, pad], dim=-1)
    return unpack_keys(sel, pos_bits, off)


def select_top(d: torch.Tensor, off: torch.Tensor, valid: torch.Tensor, *,
               kp: int, pos_bits: int = 0, block_min: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-kp of distances d [tb, qt, L] over the rows ``off`` [tb] +
    in-list position, where ``valid`` [tb, L]: (dists, rows) [tb, qt, kp],
    ascending, padded with (NEG_FILL, -1). Exact (``pos_bits`` 0): ties go
    to the smaller row (a stable sort over rows in ascending order).
    Otherwise the kp smallest packed keys, decoded; ``block_min``: of the
    class minima. The selection rule of both plain scans."""
    tb, qt, L = d.shape
    cols = torch.arange(L, device=d.device)
    if pos_bits:
        keys = pack_keys(d, cols, valid[:, None, :], pos_bits)
        if block_min:
            keys = class_minima(keys)
        return top_keys(keys, kp, pos_bits, off[:, None, None])
    kk = min(kp, L)
    d = d.masked_fill(~valid[:, None, :], NEG_FILL)
    r = torch.where(valid, off.long()[:, None] + cols, -1).to(torch.int32)
    sd, si = torch.sort(d, dim=-1, stable=True)
    out_d = torch.full((tb, qt, kp), NEG_FILL, dtype=torch.float32,
                       device=d.device)
    out_i = torch.full((tb, qt, kp), -1, dtype=torch.int32, device=d.device)
    out_d[..., :kk] = sd[..., :kk]
    out_i[..., :kk] = torch.gather(r[:, None, :].expand(-1, qt, -1), -1,
                                   si[..., :kk])
    return out_d, out_i


def grouped_scan_plain(qpad: torch.Tensor, vecs: torch.Tensor,
                       tile_off: torch.Tensor, tile_cnt: torch.Tensor, *,
                       kp: int, qt: int, metric: str = "sqeuclidean",
                       pos_bits: int = 0, block_min: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch (CPU tensors, tests, and the
    comparison on the card). q is rounded to the store dtype, both sides
    are upcast to f32 before the product, |q|^2 comes from the f32 query
    and |x|^2 from the stored row; the top-kp is ``select_top``'s."""
    T = tile_off.shape[0]
    D = qpad.shape[1]
    dev = qpad.device
    out_d = torch.full((T, qt, kp), NEG_FILL, dtype=torch.float32, device=dev)
    out_i = torch.full((T, qt, kp), -1, dtype=torch.int32, device=dev)
    n_rows = vecs.shape[0]
    cnt = _clamped_counts(tile_off, tile_cnt, n_rows)
    lmax = int(cnt.max()) if T else 0
    if lmax == 0:
        return out_d, out_i
    qf = qpad.float().reshape(T, qt, D)
    qh = qf.to(vecs.dtype).float()
    qsq = (qf * qf).sum(-1)                                   # [T, qt]
    cols = torch.arange(lmax, device=dev)
    # tiles per step: bounds the [tb, L, D] gather and [tb, qt, L] scores
    step = max(1, (1 << 26) // (lmax * (D + 2 * qt)))
    for s in range(0, T, step):
        e = min(s + step, T)
        rows = tile_off[s:e].long()[:, None] + cols[None, :]  # [tb, L]
        valid = cols[None, :] < cnt[s:e, None]
        x = vecs[rows.clamp(0, n_rows - 1)].float()           # [tb, L, D]
        dots = torch.bmm(qh[s:e], x.transpose(1, 2))          # [tb, qt, L]
        if metric == "ip":
            d = -dots
        else:
            xsq = (x * x).sum(-1)                             # [tb, L]
            d = torch.clamp((qsq[s:e, :, None] + xsq[:, None, :]) - 2.0 * dots,
                            min=0.0)
        out_d[s:e], out_i[s:e] = select_top(
            d, tile_off[s:e], valid, kp=kp, pos_bits=pos_bits,
            block_min=block_min)
    return out_d, out_i


def _mode(pos_bits: int, block_min: bool) -> int:
    """Kernel selection mode: 0 exact, 1 packed, 2 blockmin."""
    if block_min and not pos_bits:
        raise ValueError("block_min needs packed keys (pos_bits > 0)")
    if pos_bits and not 1 <= pos_bits <= 30:
        raise ValueError(f"pos_bits must lie in [1, 30], got {pos_bits}")
    return 2 if block_min else int(pos_bits > 0)


# the kernel's sources: one library serves both stores
SOURCES = ("ivf_scan_grouped",)


def _lib() -> ctypes.CDLL:
    lib = _build.load_library(SOURCES[0])
    f = lib.ivf_grouped_scan
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    g = lib.ivf_grouped_scan_smem_bytes
    g.argtypes = [ctypes.c_int] * 5
    g.restype = ctypes.c_longlong
    return lib


def _pick_qs(lib: ctypes.CDLL, qt: int, D: int, kp: int, mode: int,
             bf16: bool) -> int:
    """Queries per kernel block: qt, halved while the block's shared
    memory (queries + staged rows + per-query top-kp lists) exceeds the
    card's 227 KB or qt exceeds the block's 64 query slots."""
    def fits(qs):
        return qs <= QS_MAX and lib.ivf_grouped_scan_smem_bytes(
            qs, D, kp, mode, int(bf16)) <= SMEM_MAX
    qs = qt
    while not fits(qs) and qs % 2 == 0:
        qs //= 2
    if not fits(qs):
        raise ValueError(f"grouped scan: no block size fits qt={qt}, D={D}, "
                         f"kp={kp} in {SMEM_MAX} bytes of shared memory")
    return qs


def _grouped_scan_cuda(qpad, vecs, tile_off, tile_cnt, *, kp, qt, metric,
                       pos_bits=0, block_min=False):
    global LAUNCHES
    T = tile_off.shape[0]
    D = qpad.shape[1]
    mode = _mode(pos_bits, block_min)
    if qpad.dtype != torch.float32 or qpad.ndim != 2 or qpad.shape[0] != T * qt:
        raise ValueError("qpad must be f32 [T * qt, D]")
    if vecs.dtype not in (torch.bfloat16, torch.float32) or vecs.ndim != 2 \
            or vecs.shape[1] != D:
        raise ValueError("vecs must be bf16 or f32 [n_rows, D]")
    for name, t in (("tile_off", tile_off), ("tile_cnt", tile_cnt)):
        if t.dtype != torch.int32 or t.shape != (T,):
            raise ValueError(f"{name} must be int32 [T]")
    if not 1 <= kp <= SEG:
        raise ValueError(f"kp must lie in [1, {SEG}]")
    qpad, vecs, tile_off, tile_cnt = (
        t.contiguous() for t in (qpad, vecs, tile_off, tile_cnt))
    out_d = torch.empty((T, qt, kp), dtype=torch.float32, device=qpad.device)
    out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=qpad.device)
    if T == 0:
        return out_d, out_i
    bf16 = vecs.dtype == torch.bfloat16
    lib = _lib()
    qs = _pick_qs(lib, qt, D, kp, mode, bf16)
    sub_per_tile = qt // qs
    with torch.cuda.device(qpad.device):
        stream = torch.cuda.current_stream(qpad.device).cuda_stream
        err = lib.ivf_grouped_scan(
            qpad.data_ptr(), vecs.data_ptr(), tile_off.data_ptr(),
            tile_cnt.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            T * sub_per_tile, sub_per_tile, qs, D, vecs.shape[0], kp,
            int(metric == "ip"), int(bf16), mode, pos_bits, stream)
    if err != 0:
        raise RuntimeError(f"ivf_grouped_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_d, out_i


def grouped_probe_scan(qpad: torch.Tensor, vecs: torch.Tensor,
                       tile_off: torch.Tensor, tile_cnt: torch.Tensor, *,
                       kp: int, metric: str = "sqeuclidean", qt: int = QT,
                       pos_bits: int = 0, block_min: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qpad [T*qt, D] f32 tile-packed queries; vecs [Npad, D]
    cluster-contiguous (bf16 or f32); tile_off/tile_cnt [T] int32.
    Returns (dists [T, qt, kp] f32, csr_rows [T, qt, kp] int32).

    ``pos_bits > 0`` selects by packed keys: it must satisfy
    ``2**pos_bits >= max list rows`` and rounds distances by
    <= 2**(pos_bits-24) relative. ``block_min`` (with ``pos_bits``) keeps
    one candidate per (query, segment, class) before the top-kp.

    CPU tensors take ``grouped_scan_plain``; CUDA tensors launch the
    kernel or raise."""
    if metric not in ("sqeuclidean", "ip"):
        raise ValueError(f"grouped scan metric must be sqeuclidean or ip, "
                         f"got {metric!r}")
    _mode(pos_bits, block_min)
    devs = {t.device for t in (qpad, vecs, tile_off, tile_cnt)}
    if len(devs) != 1:
        raise ValueError(f"grouped scan inputs on several devices: {devs}")
    dev = qpad.device
    kw = dict(kp=kp, qt=qt, metric=metric, pos_bits=pos_bits,
              block_min=block_min)
    if dev.type == "cpu":
        return grouped_scan_plain(qpad, vecs, tile_off, tile_cnt, **kw)
    if dev.type == "cuda":
        return _grouped_scan_cuda(qpad, vecs, tile_off, tile_cnt, **kw)
    raise ValueError(f"no grouped scan for device {dev}")


def merge_partials(out_d: torch.Tensor, out_i: torch.Tensor,
                   pos: torch.Tensor, *, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each tuple's partial top-kp by padded slot, merge across
    probe ranks. pos [B, npad] (original tuple order). On equal distance
    the earlier column wins, as ``lax.top_k`` orders ties."""
    B, npad = pos.shape
    kp = out_d.shape[-1]
    p = pos.reshape(-1).long()
    pd = out_d.reshape(-1, kp)[p].reshape(B, npad * kp)
    pi = out_i.reshape(-1, kp)[p].reshape(B, npad * kp)
    vals, sel = torch.sort(pd, dim=1, stable=True)
    vals = vals[:, :k]
    rows = torch.gather(pi, 1, sel[:, :k])
    rows = torch.where(vals < NEG_FILL * 0.5, rows, -1)
    return vals, rows


def ivf_grouped_search(q: torch.Tensor, probes: torch.Tensor,
                       vecs: torch.Tensor, offsets: torch.Tensor,
                       counts: torch.Tensor, *, k: int,
                       metric: str = "sqeuclidean", qt: int = QT,
                       pos_bits: int = 0, block_min: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full grouped pipeline: probes [B, npad] list ids (sentinel = nlists
    in padding slots). Returns (dists [B, k], csr_rows [B, k])."""
    B, npad = probes.shape
    nlists = counts.shape[0]
    t_max = tiles_for(B, npad, nlists, qt)
    kp = max(8, min(k, SEG))
    tile_off, tile_cnt, pos = group_probes(probes, offsets, counts, qt=qt,
                                           t_max=t_max)
    qpad = _scatter_tuples(q, pos, npad=npad, qt=qt, t_max=t_max)
    out_d, out_i = grouped_probe_scan(qpad, vecs, tile_off, tile_cnt, kp=kp,
                                      metric=metric, qt=qt, pos_bits=pos_bits,
                                      block_min=block_min)
    return merge_partials(out_d, out_i, pos.reshape(B, npad), k=k)


def ivf_grouped_search_reference(q, probes, vecs, offsets, counts, *,
                                 k: int, metric: str = "sqeuclidean"):
    """Numpy oracle with the same semantics (tests): exact distances over
    each query's probed lists, stable ascending order."""
    B = q.shape[0]
    nlists = len(counts)
    out_d = np.full((B, k), NEG_FILL, np.float32)
    out_i = np.full((B, k), -1, np.int32)
    qn = np.asarray(q, np.float32)
    vn = np.asarray(vecs, np.float32)
    for b in range(B):
        ds, ids = [], []
        for p in range(probes.shape[1]):
            lid = int(probes[b, p])
            if lid >= nlists:
                continue
            o, c = int(offsets[lid]), int(counts[lid])
            block = vn[o:o + c]
            if metric == "ip":
                d = -(block @ qn[b])
            else:
                d = ((block - qn[b]) ** 2).sum(1)
            ds.append(d)
            ids.append(np.arange(o, o + c))
        if ds:
            d = np.concatenate(ds)
            i = np.concatenate(ids)
            ordr = np.argsort(d, kind="stable")[:k]
            out_d[b, :len(ordr)] = d[ordr]
            out_i[b, :len(ordr)] = i[ordr]
    return out_d, out_i
