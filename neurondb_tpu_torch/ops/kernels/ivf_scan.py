"""Round-1 IVF probe scan: one pass over a posting list per (query, probe).

Counterpart of ``neurondb_tpu/ops/pallas/ivf_scan.py``:

  scan    ``probe_scan`` computes every (query, probe rank) tuple's top-kp
          over its list: on a CUDA tensor by the hand-written kernel
          ``csrc/ivf_probe_scan.cu``, on a CPU tensor by
          ``probe_scan_plain``, the same function in plain torch. The
          kernel reads each list once for every item of up to 32 tuples
          that probe it: ``work_table`` sorts the tuples by (offset,
          count) on the card, ``work_items`` states how the kernel's
          blocks cut the sorted table into items.
  merge   ``merge_probes`` takes the top-k across probe ranks, as the JAX
          package does outside its kernel, in XLA.

``ivf_probe_scan`` runs both. Semantics kept from the TPU kernel:

- a query takes at most ``kp = max(8, min(k, SEG))`` candidates from any
  one list, so for ``k > SEG`` the result is the top-k of the per-probe
  top-``SEG``s (``ivf_probe_scan_reference`` applies no such cap);
- a list is read up to ``max_segs * SEG`` rows; rows at or past its count
  are masked;
- distances are f32 products of the f32 query and the stored row widened
  to f32, |q|^2 from the query (``qsq`` is accepted and ignored) and
  |x|^2 from the stored row;
- within a probe, ties go to the lower row; across probes, to the lower
  probe rank (a stable sort reproduces both);
- an output whose distance is >= ``NEG_FILL / 2`` has row -1, and where
  ``k > nprobe * kp`` the tail holds (``NEG_FILL``, -1).

The TPU kernel's Mosaic prewarm, its padding of the batch to 16 queries
and its clamp of the DMA start to ``Npad - SEG`` are not ported: nothing
here compiles per shape, blocks need no fixed query count, and rows past
a list's count are never read. The kernel dispatch follows the tensor's
device, never a failure: a CUDA tensor goes to the kernel or raises.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from neurondb_tpu_torch.ops.kernels import _build
from neurondb_tpu_torch.ops.kernels.ivf_scan_grouped import (
    NEG_FILL,
    SMEM_MAX,
    _clamped_counts,
    select_top,
)

SEG = 512         # rows per segment, and the per-probe kp cap
TILES = (4, 8, 16, 32)  # the kernel's query tiles: tuples one item holds
TUPLES_MAX = 2**31 - 1  # B * nprobe: the work table's int32 positions

LAUNCHES = 0      # kernel launches by probe_scan on CUDA tensors


def kp_for(k: int) -> int:
    """Per-probe candidates kept for a top-k: the TPU kernel's rule."""
    return max(8, min(k, SEG))


def segments_for(max_list: int) -> int:
    """``max_segs`` that reads whole lists: SEG-row segments covering the
    longest list, rounded up to a power of two (the JAX index's bucket)."""
    segs = 1
    while segs * SEG < max_list:
        segs *= 2
    return segs


def probe_scan_plain(q: torch.Tensor, vecs: torch.Tensor,
                     probes_off: torch.Tensor, probes_cnt: torch.Tensor, *,
                     kp: int, max_segs: int, metric: str = "sqeuclidean"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch (CPU tensors, tests, and the
    comparison on the card): per probe rank p and query b, the kp
    smallest (distance, CSR row) pairs over rows [off, off + cnt) of the
    store, cnt cut to ``max_segs * SEG`` and to the store's end.
    Returns (dists, rows) [nprobe, B, kp], ascending, padded with
    (NEG_FILL, -1); the top-kp is ``select_top``'s exact rule."""
    B, D = q.shape
    nprobe = probes_off.shape[1]
    dev = q.device
    out_d = torch.full((nprobe, B, kp), NEG_FILL, dtype=torch.float32,
                       device=dev)
    out_i = torch.full((nprobe, B, kp), -1, dtype=torch.int32, device=dev)
    n_rows = vecs.shape[0]
    cnt = _clamped_counts(probes_off, probes_cnt, n_rows).clamp(
        max=max_segs * SEG)                                  # [B, nprobe]
    lmax = int(cnt.max()) if cnt.numel() else 0
    if lmax == 0:
        return out_d, out_i
    qf = q.float()
    qsq = (qf * qf).sum(-1)                                  # [B]
    cols = torch.arange(lmax, device=dev)
    # queries per step: bounds the [b, L, D] gather
    step = max(1, (1 << 26) // (lmax * (D + 2)))
    for p in range(nprobe):
        for s in range(0, B, step):
            e = min(s + step, B)
            off = probes_off[s:e, p]
            rows = off.long()[:, None] + cols[None, :]       # [b, L]
            valid = cols[None, :] < cnt[s:e, p, None]
            x = vecs[rows.clamp(0, n_rows - 1)].float()      # [b, L, D]
            dots = torch.bmm(x, qf[s:e, :, None])[..., 0]    # [b, L]
            if metric == "ip":
                d = -dots
            else:
                xsq = (x * x).sum(-1)
                d = torch.clamp((qsq[s:e, None] + xsq) - 2.0 * dots, min=0.0)
            sd, si = select_top(d[:, None, :], off, valid, kp=kp)
            out_d[p, s:e], out_i[p, s:e] = sd[:, 0], si[:, 0]
    return out_d, out_i


def work_table(probes_off: torch.Tensor, probes_cnt: torch.Tensor, *,
               n_rows: int, max_segs: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work table, on the tensors' device, with no host
    synchronisation: each tuple t = b * nprobe + p gets the key
    ``off << 32 | n``, n its count cut to ``max_segs * SEG`` and to the
    store's end; returns (keys, order) [B * nprobe] int64, the keys sorted
    stably and each sorted position's tuple. A key below 0 (off < 0) or
    with n == 0 reads nothing. Two lists that share an offset (an empty
    list starts where the next one does) or one list probed with two
    counts keep apart keys. Six torch calls: the route at small batches
    waits on the host."""
    off = probes_off.reshape(-1).long()
    n = torch.minimum(probes_cnt.reshape(-1), n_rows - off).clamp_(
        0, max(0, max_segs) * SEG)
    return torch.sort(torch.add(n, off, alpha=1 << 32), stable=True)


def work_items(keys: torch.Tensor, tile: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's items, as its blocks find them: block i takes the
    sorted positions [i * tile, (i + 1) * tile), and an item is a run of
    equal keys inside one block's positions. Returns the items' (start,
    stop) positions, in order (tests and measurement; the kernel finds
    them itself)."""
    T = keys.numel()
    pos = torch.arange(T, device=keys.device)
    first = pos % tile == 0
    first[1:] |= keys[1:] != keys[:-1]
    start = pos[first]
    stop = torch.cat([start[1:], start.new_tensor([T])])
    return start, stop


def tile_for(n_tuples: int, widest: int, n_sm: int) -> int:
    """The launch's query tile, which is also each block's share of the
    sorted tuples: ``widest`` (``pick_tile``), halved (not below 4) while
    the grid would hold fewer than two blocks per SM."""
    t = widest
    while t > 4 and -(-n_tuples // t) < 2 * n_sm:
        t //= 2
    return t


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ivf_probe_scan")
    f = lib.ivf_probe_scan
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    for name, rt in (("ivf_probe_scan_smem_bytes", ctypes.c_longlong),
                     ("ivf_probe_scan_occupancy", ctypes.c_int)):
        g = getattr(lib, name)
        g.argtypes = [ctypes.c_int] * 4
        g.restype = rt
    return lib


def pick_tile(lib: ctypes.CDLL, D: int, kp: int, bf16: bool) -> int:
    """The widest query tile of ``TILES`` whose shared memory (a ring of
    128-dim slabs, the full-width queries, products; for kp > 16 the
    top-kp lists and buffers) fits 227 KB: a 4-query tile fits every D up
    to 9,940 (bf16 store) or 8,980 (f32) at kp 512, and wider D raises."""
    for tq in sorted(TILES, reverse=True):
        if lib.ivf_probe_scan_smem_bytes(tq, D, kp, int(bf16)) <= SMEM_MAX:
            return tq
    raise ValueError(f"probe scan: D={D}, kp={kp} do not fit a {min(TILES)}"
                     f"-query tile in {SMEM_MAX} bytes of shared memory")


def _probe_scan_cuda(q, vecs, probes_off, probes_cnt, *, kp, max_segs,
                     metric):
    global LAUNCHES
    if q.dtype != torch.float32 or q.ndim != 2:
        raise ValueError("q must be f32 [B, D]")
    B, D = q.shape
    if vecs.dtype not in (torch.bfloat16, torch.float32) or vecs.ndim != 2 \
            or vecs.shape[1] != D:
        raise ValueError("vecs must be bf16 or f32 [n_rows, D]")
    if probes_off.ndim != 2 or probes_off.shape[0] != B:
        raise ValueError("probes_off must be int32 [B, nprobe]")
    nprobe = probes_off.shape[1]
    for name, t in (("probes_off", probes_off), ("probes_cnt", probes_cnt)):
        if t.dtype != torch.int32 or t.shape != (B, nprobe):
            raise ValueError(f"{name} must be int32 [B, nprobe]")
    if not 1 <= kp <= SEG:
        raise ValueError(f"kp must lie in [1, {SEG}]")
    if B * nprobe > TUPLES_MAX:
        raise ValueError(f"B * nprobe must be at most {TUPLES_MAX}")
    q, vecs = q.contiguous(), vecs.contiguous()
    out_d = torch.empty((nprobe, B, kp), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nprobe, B, kp), dtype=torch.int32, device=q.device)
    if B == 0 or nprobe == 0:
        return out_d, out_i
    lib = _lib()
    bf16 = vecs.dtype == torch.bfloat16
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    tile = tile_for(B * nprobe, pick_tile(lib, D, kp, bf16), n_sm)
    keys, order = work_table(probes_off, probes_cnt, n_rows=vecs.shape[0],
                             max_segs=max_segs)
    # 16-byte cp.async copies where every row start is 16-byte aligned
    vec8 = int(D % 8 == 0 and vecs.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ivf_probe_scan(
            q.data_ptr(), vecs.data_ptr(), keys.data_ptr(), order.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), B, nprobe, D, kp,
            int(metric == "ip"), int(bf16), vec8, tile, stream)
    if err != 0:
        raise RuntimeError(f"ivf_probe_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_d, out_i


def probe_scan(q: torch.Tensor, vecs: torch.Tensor, probes_off: torch.Tensor,
               probes_cnt: torch.Tensor, *, kp: int, max_segs: int,
               metric: str = "sqeuclidean"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, D] f32; vecs [Npad, D] cluster-contiguous (bf16 or f32);
    probes_off/probes_cnt [B, nprobe] int32 list offsets and lengths.
    Returns the per-probe partials (dists f32, csr_rows int32)
    [nprobe, B, kp]. CPU tensors take ``probe_scan_plain``; CUDA tensors
    launch the kernel or raise."""
    if metric not in ("sqeuclidean", "ip"):
        raise ValueError(f"probe scan metric must be sqeuclidean or ip, "
                         f"got {metric!r}")
    devs = {t.device for t in (q, vecs, probes_off, probes_cnt)}
    if len(devs) != 1:
        raise ValueError(f"probe scan inputs on several devices: {devs}")
    dev = q.device
    kw = dict(kp=kp, max_segs=max_segs, metric=metric)
    if dev.type == "cpu":
        return probe_scan_plain(q, vecs, probes_off, probes_cnt, **kw)
    if dev.type == "cuda":
        return _probe_scan_cuda(q, vecs, probes_off, probes_cnt, **kw)
    raise ValueError(f"no probe scan for device {dev}")


def merge_probes(out_d: torch.Tensor, out_i: torch.Tensor, *, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partials [nprobe, B, kp] -> (dists, rows) [B, k]: a stable sort
    over [B, nprobe * kp], so on equal distance the lower probe rank wins,
    as ``lax.top_k`` orders ties; columns past nprobe * kp hold
    (NEG_FILL, -1)."""
    nprobe, B, kp = out_d.shape
    cd = out_d.permute(1, 0, 2).reshape(B, nprobe * kp)
    ci = out_i.permute(1, 0, 2).reshape(B, nprobe * kp)
    vals, sel = torch.sort(cd, dim=1, stable=True)
    kk = min(k, nprobe * kp)
    vals = vals[:, :kk]
    rows = torch.gather(ci, 1, sel[:, :kk])
    if kk < k:
        vals = torch.cat([vals, torch.full((B, k - kk), NEG_FILL,
                                           dtype=vals.dtype,
                                           device=vals.device)], dim=1)
        rows = torch.cat([rows, torch.full((B, k - kk), -1, dtype=rows.dtype,
                                           device=rows.device)], dim=1)
    rows = torch.where(vals < NEG_FILL * 0.5, rows, -1)
    return vals, rows


def ivf_probe_scan(q: torch.Tensor, qsq, vecs: torch.Tensor,
                   probes_off: torch.Tensor, probes_cnt: torch.Tensor, *,
                   k: int, max_segs: int, metric: str = "sqeuclidean"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, D]; vecs [Npad, D] cluster-contiguous; probes_off/cnt
    [B, nprobe] row offsets/lengths. Returns (dists [B, k], row_ids
    [B, k]) ascending; pads id -1. ``qsq`` is accepted for API parity and
    ignored (|q|^2 comes from the f32 query)."""
    out_d, out_i = probe_scan(q.float(), vecs, probes_off, probes_cnt,
                              kp=kp_for(k), max_segs=max_segs, metric=metric)
    return merge_probes(out_d, out_i, k=k)


def ivf_probe_scan_reference(q, qsq, vecs, probes_off, probes_cnt, *,
                             k: int, metric: str = "sqeuclidean"):
    """Pure-numpy oracle (tests), a copy of the JAX package's: exact
    distances over each query's probed lists, stable ascending order, no
    per-probe cap."""
    B = q.shape[0]
    out_d = np.full((B, k), NEG_FILL, np.float32)
    out_i = np.full((B, k), -1, np.int32)
    qn = np.asarray(q)
    vn = np.asarray(vecs)
    for b in range(B):
        ds, ids = [], []
        for p in range(probes_off.shape[1]):
            o, c = int(probes_off[b, p]), int(probes_cnt[b, p])
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
