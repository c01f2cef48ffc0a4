"""List-grouped IVF-PQ probe scan: asymmetric distances from per-tuple
lookup tables.

Counterpart of ``neurondb_tpu/ops/pallas/ivfpq_scan.py``:

  prep    ``group_probes`` (the flat scan's) tiles the (query, probe)
          tuples by list; ``pq_tuple_inputs`` gives each tuple its
          residual query qc (``q - c_list``, rotated by ``R``; ``q`` for
          ip), its constant cn (``|q - c|^2`` or ``-q.c``, over n_sub),
          the codeword norms sq and the map ``slot_tuple`` from padded
          tile slots to tuples (-1: empty). A tuple's ADC table is
            L[j*256 + k] = ((scale * dot) + sq[j, k]) + cn,
            dot = sum over d in order of qc[j*ds + d] * cb[j, k, d]
          (``adc_tables``; scale -2 for sq-L2, -1 for ip), so
          d(q, row) = sum_j L[j*256 + code[j, row]].
  scan    ``grouped_pq_scan_fused`` computes each tile's top-kp over its
          list's codes, building the live slots' tables itself: on a
          CUDA tensor by the hand-written kernel ``csrc/ivfpq_scan.cu``,
          with the tables in shared memory; on a CPU tensor by
          ``grouped_pq_scan_fused_plain``. ``grouped_pq_scan`` is the TPU
          kernel's interface: tables from ``build_luts`` (every tuple's
          table scattered into a padded ``[t_max * qt, n_sub * 256]``
          buffer), every slot scored; it runs the same kernel or
          ``grouped_pq_scan_plain``.
  post    ``merge_partials`` (the flat scan's).

Selection is exact (``pos_bits=0``) or by packed keys (``pos_bits`` up to
16, the flat scan's ``pack_keys``). The kernel dispatch follows the
tensor's device, never a failure; ``LAUNCHES`` counts kernel launches of
both entries.

CALLER CONTRACT (the JAX package's): codes_t [n_sub, Npad] uint8,
subspace-major, every list offset a multiple of ``LIST_ALIGN`` = 128 and
>= ``SEG`` columns of tail padding; at most 256 codewords per subspace;
``kp = max(8, min(k, KP_MAX))``. The TPU kernel's inner block width
(``_sub_for``, a VMEM limit) has no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from neurondb_tpu_torch.ops.kernels import _build
from neurondb_tpu_torch.ops.kernels.ivf_scan_grouped import (  # noqa: F401
    INT_FILL,
    NEG_FILL,
    QT,
    SMEM_MAX,
    _clamped_counts,
    auto_qt,
    group_probes,
    merge_partials,
    select_top,
    tiles_for,
)

SEG = 1024        # code columns of tail padding the layout keeps
LIST_ALIGN = 128  # list offsets, in code columns
KSUB = 256        # codewords per subspace, at most
KP_MAX = 256      # per-tile top-kp cap (the TPU kernel's SUB)
QS_MAX = 3        # query slots one kernel block serves (4 warps each)

LAUNCHES = 0      # kernel launches by either scan entry on CUDA tensors


def pq_tuple_inputs(q: torch.Tensor, probes: torch.Tensor,
                    centroids: torch.Tensor, codebooks: torch.Tensor,
                    pos: torch.Tensor, R: Optional[torch.Tensor] = None, *,
                    npad: int, qt: int, t_max: int, metric: str
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               float, torch.Tensor]:
    """What the ADC tables are made of, per tuple (query ``i // npad``,
    probe ``probes.flat[i]``), shared by the kernel and the plain paths:
    (qc [G, D] f32, cn [G] f32, sq [n_sub, ks] f32, scale, slot_tuple
    [t_max * qt] int32).

    sq-L2: qc = (q - c) @ R, cn = |qc|^2 / n_sub, sq = |cb|^2, scale -2;
    ip:    qc = q,           cn = -(q . c) / n_sub, sq = 0,  scale -1.
    ``slot_tuple`` inverts ``pos`` (group_probes' padded slot per tuple):
    the tuple in each slot, -1 in an empty one."""
    B, D = q.shape
    ns, KS, _ = codebooks.shape
    G = B * npad
    tuple_q = torch.arange(G, device=q.device) // npad
    nlists = centroids.shape[0]
    lid = probes.reshape(G).long().clamp(max=nlists - 1)
    c = centroids[lid]                                 # [G, D]
    qg = q[tuple_q]                                    # [G, D]
    cb = codebooks.float()
    if metric == "ip":
        qc = qg
        const = -(qg * c).sum(1)
        sq = torch.zeros((ns, KS), dtype=torch.float32, device=q.device)
        scale = -1.0
    else:
        qc = qg - c
        if R is not None:
            qc = qc @ R          # OPQ rotation (orthogonal: norm kept)
        const = (qc * qc).sum(1)
        sq = (cb * cb).sum(-1)                         # [ns, KS]
        scale = -2.0
    slot_tuple = torch.full((t_max * qt,), -1, dtype=torch.int32,
                            device=q.device)
    slot_tuple[pos.long()] = torch.arange(G, dtype=torch.int32,
                                          device=q.device)
    return (qc.float().contiguous(), (const / ns).float(), sq.contiguous(),
            scale, slot_tuple)


def adc_tables(qc: torch.Tensor, cn: torch.Tensor, codebooks: torch.Tensor,
               sq: torch.Tensor, scale: float) -> torch.Tensor:
    """[G, n_sub * ks] f32 tables, the kernel's expression in its order:
    ((scale * dot) + sq) + cn, dot summed over d = 0..ds-1 in order, each
    product and sum rounded on its own (elementwise ops: no FMA)."""
    G = qc.shape[0]
    ns, KS, ds = codebooks.shape
    qs = qc.reshape(G, ns, 1, ds)
    cb = codebooks.float()
    dot = qs[..., 0] * cb[..., 0]                      # [G, ns, KS]
    for d in range(1, ds):
        dot = dot + qs[..., d] * cb[..., d]
    return ((scale * dot + sq) + cn[:, None, None]).reshape(G, ns * KS)


def build_luts(q: torch.Tensor, probes: torch.Tensor,
               centroids: torch.Tensor, codebooks: torch.Tensor,
               pos: torch.Tensor, R: Optional[torch.Tensor] = None, *,
               npad: int, qt: int, t_max: int, metric: str) -> torch.Tensor:
    """Per-TUPLE ADC tables scattered into padded tile slots:
    [t_max * qt, n_sub * 256] f32, zero in unused slots (the JAX
    package's ``build_luts``; tables from ``adc_tables``).

    L[slot, j*KS+k] = ||cb[j,k]||^2 - 2 (q - c)_j . cb[j,k]   (sq-L2)
                      -(q_j . cb[j,k])                         (ip)
    const[slot]     = ||q - c||^2                              (sq-L2)
                      -(q . c)                                 (ip)
    with const / n_sub added to every entry. ``R`` (OPQ) rotates q - c."""
    qc, cn, sq, scale, _ = pq_tuple_inputs(
        q, probes, centroids, codebooks, pos, R, npad=npad, qt=qt,
        t_max=t_max, metric=metric)
    ns, KS, _ = codebooks.shape
    lutpad = torch.zeros((t_max * qt, ns * KS), dtype=torch.float32,
                         device=q.device)
    lutpad[pos.long()] = adc_tables(qc, cn, codebooks, sq, scale)
    return lutpad


def grouped_pq_scan_plain(lutpad: torch.Tensor, codes_t: torch.Tensor,
                          tile_off: torch.Tensor, tile_cnt: torch.Tensor, *,
                          kp: int, qt: int, pos_bits: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch (CPU tensors, tests, and the
    comparison on the card): a gather of each row's table entries, summed
    in f32 in subspace order from 0 (the kernel's order, so the two agree
    bit for bit), then the flat scan's ``select_top``."""
    T = tile_off.shape[0]
    ns, ncols = codes_t.shape
    dev = lutpad.device
    out_d = torch.full((T, qt, kp), NEG_FILL, dtype=torch.float32, device=dev)
    out_i = torch.full((T, qt, kp), -1, dtype=torch.int32, device=dev)
    cnt = _clamped_counts(tile_off, tile_cnt, ncols)
    lmax = int(cnt.max()) if T else 0
    if lmax == 0:
        return out_d, out_i
    lut = lutpad.reshape(T, qt, ns, -1)
    cols = torch.arange(lmax, device=dev)
    step = max(1, (1 << 24) // (lmax * qt))   # bounds the [tb, qt, L] sums
    for s in range(0, T, step):
        e = min(s + step, T)
        rows = tile_off[s:e].long()[:, None] + cols[None, :]   # [tb, L]
        valid = cols[None, :] < cnt[s:e, None]
        rs = rows.clamp(0, ncols - 1)
        d = torch.zeros((e - s, qt, lmax), dtype=torch.float32, device=dev)
        for j in range(ns):
            code = codes_t[j][rs].long()[:, None, :].expand(-1, qt, -1)
            d = d + torch.gather(lut[s:e, :, j, :], 2, code)
        out_d[s:e], out_i[s:e] = select_top(d, tile_off[s:e], valid, kp=kp,
                                            pos_bits=pos_bits)
    return out_d, out_i


def grouped_pq_scan_fused_plain(qc: torch.Tensor, cn: torch.Tensor,
                                codebooks: torch.Tensor, sq: torch.Tensor,
                                scale: float, slot_tuple: torch.Tensor,
                                codes_t: torch.Tensor, tile_off: torch.Tensor,
                                tile_cnt: torch.Tensor, *, kp: int, qt: int,
                                pos_bits: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's function in plain torch: the live slots' tables
    from ``adc_tables`` scored by ``grouped_pq_scan_plain``; empty slots
    (``slot_tuple`` -1) hold (NEG_FILL, -1)."""
    T = tile_off.shape[0]
    ns, KS, _ = codebooks.shape
    st = slot_tuple.long()
    live = st >= 0
    lutpad = torch.zeros((T * qt, ns * KS), dtype=torch.float32,
                         device=qc.device)
    g = st[live]
    lutpad[live] = adc_tables(qc[g], cn[g], codebooks, sq, scale)
    out_d, out_i = grouped_pq_scan_plain(lutpad, codes_t, tile_off, tile_cnt,
                                         kp=kp, qt=qt, pos_bits=pos_bits)
    dead = ~live.reshape(T, qt)
    out_d[dead] = NEG_FILL
    out_i[dead] = -1
    return out_d, out_i


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ivfpq_scan")
    f = lib.ivfpq_table_fed_scan
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    f = lib.ivfpq_fused_scan
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    g = lib.ivfpq_scan_resident_blocks
    g.argtypes = [ctypes.c_int] * 6
    g.restype = ctypes.c_int
    return lib


_QS: Dict[tuple, Tuple[int, int]] = {}


def _pick_qs(qt: int, ns: int, ks: int, ds: int, kp: int,
             packed: bool) -> Tuple[int, int]:
    """(query slots per kernel block, resident blocks per SM): the most
    slots, up to ``QS_MAX`` and qt, with which two blocks share an SM
    (one block's table build and merges then overlap the other's scan),
    else the most with which one block fits. ``ds`` 0 is the table-fed
    entry. From ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, once
    per shape (qs 3, 2 blocks per SM at n_sub 32, kp 80)."""
    key = (qt, ns, ks, ds, kp, packed)
    if key not in _QS:
        lib = _lib()
        fits = {}
        for qs in range(min(QS_MAX, qt), 0, -1):
            blocks = lib.ivfpq_scan_resident_blocks(qs, ns, ks, ds, kp,
                                                    int(packed))
            if blocks < 0:
                raise RuntimeError(f"occupancy query failed: CUDA error "
                                   f"{-blocks}")
            fits[qs] = blocks
        two = [qs for qs, b in fits.items() if b >= 2]
        one = [qs for qs, b in fits.items() if b >= 1]
        if not one:
            raise ValueError(f"IVF-PQ scan: one table of n_sub={ns} and "
                             f"kp={kp} does not fit {SMEM_MAX} bytes of "
                             f"shared memory")
        qs = max(two) if two else max(one)
        _QS[key] = (qs, fits[qs])
    return _QS[key]


def resident_warps(qt: int, ns: int, ds: int, kp: int, packed: bool,
                   ks: int = KSUB) -> Tuple[int, int]:
    """(slots per block, resident warps per SM) of the kernel at these
    shapes: the fused entry at subvector width ``ds``, the table-fed one
    at ``ds`` 0. Needs the card."""
    qs, blocks = _pick_qs(qt, ns, ks, ds, kp, packed)
    return qs, blocks * qs * 4


def _check_scan_args(codes_t, tile_off, tile_cnt, kp, pos_bits):
    T = tile_off.shape[0]
    if codes_t.dtype != torch.uint8 or codes_t.ndim != 2 \
            or codes_t.shape[1] % 4:
        raise ValueError("codes_t must be uint8 [n_sub, Npad], Npad % 4 == 0")
    for name, t in (("tile_off", tile_off), ("tile_cnt", tile_cnt)):
        if t.dtype != torch.int32 or t.shape != (T,):
            raise ValueError(f"{name} must be int32 [T]")
    if not 1 <= kp <= KP_MAX:
        raise ValueError(f"kp must lie in [1, {KP_MAX}]")
    if not 0 <= pos_bits <= 30:
        raise ValueError(f"pos_bits must lie in [0, 30], got {pos_bits}")


def _launch(entry: str, dev: torch.device, args) -> None:
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES += 1


def _grouped_pq_scan_cuda(lutpad, codes_t, tile_off, tile_cnt, *, kp, qt,
                          pos_bits):
    T = tile_off.shape[0]
    _check_scan_args(codes_t, tile_off, tile_cnt, kp, pos_bits)
    ns, ncols = codes_t.shape
    ks = lutpad.shape[-1] // ns
    if lutpad.dtype != torch.float32 or lutpad.shape != (T * qt, ns * ks) \
            or not 1 <= ks <= KSUB:
        raise ValueError("lutpad must be f32 [T * qt, n_sub * ksub], "
                         "ksub <= 256")
    lutpad, codes_t, tile_off, tile_cnt = (
        t.contiguous() for t in (lutpad, codes_t, tile_off, tile_cnt))
    out_d = torch.empty((T, qt, kp), dtype=torch.float32, device=lutpad.device)
    out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=lutpad.device)
    if T == 0:
        return out_d, out_i
    qs, _ = _pick_qs(qt, ns, ks, 0, kp, pos_bits > 0)
    _launch("ivfpq_table_fed_scan", lutpad.device, (
        lutpad.data_ptr(), codes_t.data_ptr(), tile_off.data_ptr(),
        tile_cnt.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        T, qt, qs, ns, ks, ncols, kp, pos_bits))
    return out_d, out_i


def _grouped_pq_scan_fused_cuda(qc, cn, codebooks, sq, scale, slot_tuple,
                                codes_t, tile_off, tile_cnt, *, kp, qt,
                                pos_bits):
    T = tile_off.shape[0]
    _check_scan_args(codes_t, tile_off, tile_cnt, kp, pos_bits)
    ns, ncols = codes_t.shape
    if codebooks.dtype != torch.float32 or codebooks.ndim != 3 \
            or codebooks.shape[0] != ns or not 1 <= codebooks.shape[1] <= KSUB:
        raise ValueError("codebooks must be f32 [n_sub, ksub, ds], "
                         "ksub <= 256")
    _, ks, ds = codebooks.shape
    G = qc.shape[0]
    if qc.dtype != torch.float32 or qc.shape != (G, ns * ds):
        raise ValueError("qc must be f32 [G, n_sub * ds]")
    if cn.dtype != torch.float32 or cn.shape != (G,):
        raise ValueError("cn must be f32 [G]")
    if sq.dtype != torch.float32 or sq.shape != (ns, ks):
        raise ValueError("sq must be f32 [n_sub, ksub]")
    if slot_tuple.dtype != torch.int32 or slot_tuple.shape != (T * qt,):
        raise ValueError("slot_tuple must be int32 [T * qt]")
    qc, cn, codebooks, sq, slot_tuple, codes_t, tile_off, tile_cnt = (
        t.contiguous() for t in (qc, cn, codebooks, sq, slot_tuple, codes_t,
                                 tile_off, tile_cnt))
    out_d = torch.empty((T, qt, kp), dtype=torch.float32, device=qc.device)
    out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=qc.device)
    if T == 0:
        return out_d, out_i
    qs, _ = _pick_qs(qt, ns, ks, ds, kp, pos_bits > 0)
    _launch("ivfpq_fused_scan", qc.device, (
        qc.data_ptr(), cn.data_ptr(), codebooks.data_ptr(), sq.data_ptr(),
        float(scale), slot_tuple.data_ptr(), codes_t.data_ptr(),
        tile_off.data_ptr(), tile_cnt.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), T, qt, qs, ns, ks, ds, ncols, kp, pos_bits))
    return out_d, out_i


def _one_device(kind: str, tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"IVF-PQ {kind} inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no IVF-PQ {kind} for device {dev}")
    return dev


def grouped_pq_scan(lutpad: torch.Tensor, codes_t: torch.Tensor,
                    tile_off: torch.Tensor, tile_cnt: torch.Tensor, *,
                    kp: int, qt: int = QT, pos_bits: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lutpad [T*qt, n_sub*ksub] f32 (per-slot constant pre-folded);
    codes_t [n_sub, Npad] uint8 subspace-major; tile_off / tile_cnt [T]
    int32. Returns (dists [T, qt, kp] f32, csr_rows [T, qt, kp] int32).
    ``pos_bits > 0`` (with ``2**pos_bits`` >= the longest list) selects by
    packed keys. Every slot is scored.

    CPU tensors take ``grouped_pq_scan_plain``; CUDA tensors launch the
    kernel or raise."""
    dev = _one_device("scan", (lutpad, codes_t, tile_off, tile_cnt))
    fn = grouped_pq_scan_plain if dev.type == "cpu" else _grouped_pq_scan_cuda
    return fn(lutpad, codes_t, tile_off, tile_cnt, kp=kp, qt=qt,
              pos_bits=pos_bits)


def grouped_pq_scan_fused(qc: torch.Tensor, cn: torch.Tensor,
                          codebooks: torch.Tensor, sq: torch.Tensor,
                          scale: float, slot_tuple: torch.Tensor,
                          codes_t: torch.Tensor, tile_off: torch.Tensor,
                          tile_cnt: torch.Tensor, *, kp: int, qt: int = QT,
                          pos_bits: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan with the tables built inside it, from ``pq_tuple_inputs``'
    qc [G, D], cn [G], sq [n_sub, ksub], scale and slot_tuple [T*qt]
    (values in [-1, G)); codebooks [n_sub, ksub, ds] f32; the rest as
    ``grouped_pq_scan``. Only live slots are built and scored; an empty
    slot holds (NEG_FILL, -1).

    CPU tensors take ``grouped_pq_scan_fused_plain``; CUDA tensors launch
    the kernel or raise."""
    dev = _one_device("fused scan", (qc, cn, codebooks, sq, slot_tuple,
                                     codes_t, tile_off, tile_cnt))
    fn = (grouped_pq_scan_fused_plain if dev.type == "cpu"
          else _grouped_pq_scan_fused_cuda)
    return fn(qc, cn, codebooks, sq, scale, slot_tuple, codes_t, tile_off,
              tile_cnt, kp=kp, qt=qt, pos_bits=pos_bits)


def ivfpq_grouped_search(q: torch.Tensor, probes: torch.Tensor,
                         centroids: torch.Tensor, codebooks: torch.Tensor,
                         codes_t: torch.Tensor, offsets: torch.Tensor,
                         counts: torch.Tensor, *, k: int,
                         metric: str = "sqeuclidean", qt: int = 0,
                         R: Optional[torch.Tensor] = None, pos_bits: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full grouped IVF-PQ pipeline through the fused scan (no table
    buffer). probes [B, npad] list ids (sentinel = nlists in padding
    slots). Returns (dists [B, k], csr_rows [B, k])."""
    B, npad = probes.shape
    nlists = counts.shape[0]
    qt = qt or auto_qt(B, npad, nlists)
    t_max = tiles_for(B, npad, nlists, qt)
    kp = max(8, min(k, KP_MAX))
    tile_off, tile_cnt, pos = group_probes(probes, offsets, counts, qt=qt,
                                           t_max=t_max)
    qc, cn, sq, scale, slot_tuple = pq_tuple_inputs(
        q, probes, centroids, codebooks, pos, R, npad=npad, qt=qt,
        t_max=t_max, metric=metric)
    out_d, out_i = grouped_pq_scan_fused(
        qc, cn, codebooks.float(), sq, scale, slot_tuple, codes_t, tile_off,
        tile_cnt, kp=kp, qt=qt, pos_bits=pos_bits)
    return merge_partials(out_d, out_i, pos.reshape(B, npad), k=k)
