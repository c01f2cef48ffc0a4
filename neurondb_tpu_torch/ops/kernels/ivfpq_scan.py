"""List-grouped IVF-PQ probe scan: asymmetric distances from per-tuple
lookup tables.

Counterpart of ``neurondb_tpu/ops/pallas/ivfpq_scan.py``:

  prep    ``group_probes`` (the flat scan's) tiles the (query, probe)
          tuples by list; ``build_luts`` writes every tuple's ADC table
          into its padded tile slot, in torch ops (an einsum and a
          scatter, as XLA ran them outside the TPU kernel):
            L[slot, j*256 + c] = ||cb[j,c]||^2 - 2 (q - c_list)_j . cb[j,c]
          plus the per-slot constant ||q - c_list||^2 folded into every
          entry, so d(q, row) = sum_j L[slot, j*256 + code[j, row]].
  scan    ``grouped_pq_scan`` computes each tile's top-kp over its list's
          codes: on a CUDA tensor by the hand-written kernel
          ``csrc/ivfpq_scan.cu``, on a CPU tensor by
          ``grouped_pq_scan_plain``, the same function in plain torch.
  post    ``merge_partials`` (the flat scan's).

Selection is exact (``pos_bits=0``) or by packed keys (``pos_bits`` up to
16, the flat scan's ``pack_keys``). The kernel dispatch follows the
tensor's device, never a failure; ``LAUNCHES`` counts kernel launches.

CALLER CONTRACT (the JAX package's): codes_t [n_sub, Npad] uint8,
subspace-major, every list offset a multiple of ``LIST_ALIGN`` = 128 and
>= ``SEG`` columns of tail padding; at most 256 codewords per subspace;
``kp = max(8, min(k, KP_MAX))``. The TPU kernel's inner block width
(``_sub_for``, a VMEM limit) has no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
QS_MAX = 8        # query slots one kernel block serves (one warp each)

LAUNCHES = 0      # kernel launches by grouped_pq_scan on CUDA tensors


def build_luts(q: torch.Tensor, probes: torch.Tensor,
               centroids: torch.Tensor, codebooks: torch.Tensor,
               pos: torch.Tensor, R: Optional[torch.Tensor] = None, *,
               npad: int, qt: int, t_max: int, metric: str) -> torch.Tensor:
    """Per-TUPLE ADC tables scattered into padded tile slots:
    [t_max * qt, n_sub * 256] f32, zero in unused slots.

    L[slot, j*KS+k] = ||cb[j,k]||^2 - 2 (q - c)_j . cb[j,k]   (sq-L2)
                      -(q_j . cb[j,k])                         (ip)
    const[slot]     = ||q - c||^2                              (sq-L2)
                      -(q . c)                                 (ip)
    with const / n_sub added to every entry. ``R`` (OPQ) rotates q - c."""
    B, D = q.shape
    ns, KS, ds = codebooks.shape
    G = B * npad
    tuple_q = torch.arange(G, device=q.device) // npad
    nlists = centroids.shape[0]
    lid = probes.reshape(G).long().clamp(max=nlists - 1)
    c = centroids[lid]                                 # [G, D]
    qg = q[tuple_q]                                    # [G, D]
    if metric == "ip":
        qc = qg
        const = -(qg * c).sum(1)
        sq_term = 0.0
        scale = -1.0
    else:
        qc = qg - c
        if R is not None:
            qc = qc @ R          # OPQ rotation (orthogonal: norm kept)
        const = (qc * qc).sum(1)
        sq_term = (codebooks * codebooks).sum(-1)      # [ns, KS]
        scale = -2.0
    lut = scale * torch.einsum("gjd,jkd->gjk", qc.reshape(G, ns, ds),
                               codebooks.float())
    lut = (lut + sq_term + (const / ns)[:, None, None]).reshape(G, ns * KS)
    lutpad = torch.zeros((t_max * qt, ns * KS), dtype=torch.float32,
                         device=q.device)
    lutpad[pos.long()] = lut
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


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ivfpq_scan")
    f = lib.ivfpq_grouped_scan
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    g = lib.ivfpq_scan_smem_bytes
    g.argtypes = [ctypes.c_int] * 5
    g.restype = ctypes.c_longlong
    return lib


def _pick_qs(lib: ctypes.CDLL, qt: int, ns: int, ks: int, kp: int,
             packed: bool) -> int:
    """Query slots per kernel block: the most, up to ``QS_MAX`` and qt,
    whose tables and top-kp lists fit the card's 227 KB of shared memory
    (6 at n_sub 32, 8 at n_sub 16)."""
    for qs in range(min(QS_MAX, qt), 0, -1):
        if lib.ivfpq_scan_smem_bytes(qs, ns, ks, kp, int(packed)) <= SMEM_MAX:
            return qs
    raise ValueError(f"IVF-PQ scan: one table of n_sub={ns} and kp={kp} "
                     f"does not fit {SMEM_MAX} bytes of shared memory")


def _grouped_pq_scan_cuda(lutpad, codes_t, tile_off, tile_cnt, *, kp, qt,
                          pos_bits):
    global LAUNCHES
    T = tile_off.shape[0]
    ns, ncols = codes_t.shape
    if codes_t.dtype != torch.uint8 or codes_t.ndim != 2 or ncols % 4:
        raise ValueError("codes_t must be uint8 [n_sub, Npad], Npad % 4 == 0")
    ks = lutpad.shape[-1] // ns
    if lutpad.dtype != torch.float32 or lutpad.shape != (T * qt, ns * ks) \
            or not 1 <= ks <= KSUB:
        raise ValueError("lutpad must be f32 [T * qt, n_sub * ksub], "
                         "ksub <= 256")
    for name, t in (("tile_off", tile_off), ("tile_cnt", tile_cnt)):
        if t.dtype != torch.int32 or t.shape != (T,):
            raise ValueError(f"{name} must be int32 [T]")
    if not 1 <= kp <= KP_MAX:
        raise ValueError(f"kp must lie in [1, {KP_MAX}]")
    if not 0 <= pos_bits <= 30:
        raise ValueError(f"pos_bits must lie in [0, 30], got {pos_bits}")
    lutpad, codes_t, tile_off, tile_cnt = (
        t.contiguous() for t in (lutpad, codes_t, tile_off, tile_cnt))
    out_d = torch.empty((T, qt, kp), dtype=torch.float32, device=lutpad.device)
    out_i = torch.empty((T, qt, kp), dtype=torch.int32, device=lutpad.device)
    if T == 0:
        return out_d, out_i
    lib = _lib()
    qs = _pick_qs(lib, qt, ns, ks, kp, pos_bits > 0)
    with torch.cuda.device(lutpad.device):
        stream = torch.cuda.current_stream(lutpad.device).cuda_stream
        err = lib.ivfpq_grouped_scan(
            lutpad.data_ptr(), codes_t.data_ptr(), tile_off.data_ptr(),
            tile_cnt.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            T, qt, qs, ns, ks, ncols, kp, pos_bits, stream)
    if err != 0:
        raise RuntimeError(f"ivfpq_grouped_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_d, out_i


def grouped_pq_scan(lutpad: torch.Tensor, codes_t: torch.Tensor,
                    tile_off: torch.Tensor, tile_cnt: torch.Tensor, *,
                    kp: int, qt: int = QT, pos_bits: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lutpad [T*qt, n_sub*ksub] f32 (per-slot constant pre-folded);
    codes_t [n_sub, Npad] uint8 subspace-major; tile_off / tile_cnt [T]
    int32. Returns (dists [T, qt, kp] f32, csr_rows [T, qt, kp] int32).
    ``pos_bits > 0`` (with ``2**pos_bits`` >= the longest list) selects by
    packed keys.

    CPU tensors take ``grouped_pq_scan_plain``; CUDA tensors launch the
    kernel or raise."""
    devs = {t.device for t in (lutpad, codes_t, tile_off, tile_cnt)}
    if len(devs) != 1:
        raise ValueError(f"IVF-PQ scan inputs on several devices: {devs}")
    dev = lutpad.device
    if dev.type == "cpu":
        return grouped_pq_scan_plain(lutpad, codes_t, tile_off, tile_cnt,
                                     kp=kp, qt=qt, pos_bits=pos_bits)
    if dev.type == "cuda":
        return _grouped_pq_scan_cuda(lutpad, codes_t, tile_off, tile_cnt,
                                     kp=kp, qt=qt, pos_bits=pos_bits)
    raise ValueError(f"no IVF-PQ scan for device {dev}")


def ivfpq_grouped_search(q: torch.Tensor, probes: torch.Tensor,
                         centroids: torch.Tensor, codebooks: torch.Tensor,
                         codes_t: torch.Tensor, offsets: torch.Tensor,
                         counts: torch.Tensor, *, k: int,
                         metric: str = "sqeuclidean", qt: int = 0,
                         R: Optional[torch.Tensor] = None, pos_bits: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full grouped IVF-PQ pipeline. probes [B, npad] list ids (sentinel
    = nlists in padding slots). Returns (dists [B, k], csr_rows [B, k])."""
    B, npad = probes.shape
    nlists = counts.shape[0]
    qt = qt or auto_qt(B, npad, nlists)
    t_max = tiles_for(B, npad, nlists, qt)
    kp = max(8, min(k, KP_MAX))
    tile_off, tile_cnt, pos = group_probes(probes, offsets, counts, qt=qt,
                                           t_max=t_max)
    lutpad = build_luts(q, probes, centroids, codebooks, pos, R, npad=npad,
                        qt=qt, t_max=t_max, metric=metric)
    out_d, out_i = grouped_pq_scan(lutpad, codes_t, tile_off, tile_cnt,
                                   kp=kp, qt=qt, pos_bits=pos_bits)
    return merge_partials(out_d, out_i, pos.reshape(B, npad), k=k)
