"""Flash attention (tiled online softmax): the encoders' attention kernel.

Counterpart of ``neurondb_tpu/ops/pallas/flash_attention.py``:

- ``attention_reference``: the full-matrix oracle (softmax over
  ``q k^T / sqrt(Dh)``, masked logits at ``NEG_INF``);
- ``flash_attention``: on a CUDA tensor the hand-written kernel
  ``csrc/flash_attention.cu``, on a CPU tensor ``flash_attention_plain``.
  Both modes run on the tensor cores (``mma.sync``): ``bf16=True`` as
  bf16 x bf16 -> f32 products; ``bf16=False`` as exact-f32 products,
  each made of three TF32 products of the operands' high and low parts
  (3xTF32, ~2^-21 relative per product);
- ``flash_attention_plain``: the kernel's arithmetic in plain torch, KV
  tile by KV tile (exp2-domain online softmax, bf16 rounding of q, k, v
  and of p before the PV product), with the tile as an argument. The
  rounding of p is relative to the running maximum, so results depend on
  the KV tile at the bf16 level: the tests hold it to the Pallas kernel
  in interpret mode at the same tile, and the card check holds the
  kernel to it at the kernel's tile (``KV_TILE``, ``KV_TILE_F32``: 64
  keys, one stage of the kernel's K/V ring, in both modes). In f32 the
  tile only reorders sums.

Semantics the TPU kernel's padding changes: a key index >= S contributes
nothing, so a query row whose every key is masked gets the mean of v over
the S keys, as ``attention_reference`` gives (the TPU kernel averages
over its padded length). Head widths 32, 64 and 128 are served; another
width on a CUDA tensor raises. Dispatch follows the tensor's device,
never a failure; ``LAUNCHES`` counts kernel launches per mode (``bf16``,
``f32``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from neurondb_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KV_TILE = 64         # the kernel's KV tile, bf16 products
KV_TILE_F32 = 64     # the kernel's KV tile, f32 products (3xTF32)
HEAD_DIMS = (32, 64, 128)

# kernel launches by flash_attention on CUDA tensors, per mode
LAUNCHES = {"bf16": 0, "f32": 0}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """[B, H, S, Dh] full attention oracle; mask [B, S] (nonzero = attend)."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
    if mask is not None:
        logits = torch.where(mask.bool()[:, None, None, :], logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype,
                                          device=logits.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          bf16: bool = True, kv_tile: int = KV_TILE,
                          matmul=torch.matmul) -> torch.Tensor:
    """The kernel's function in plain torch: q [B, H, Sq, Dh], k, v [B, H,
    S, Dh], mask [B, S] (``int32(mask) > 0`` = attend). Per KV tile, in
    the exp2 domain: s = (q . k) * log2(e)/sqrt(Dh), -1e30 where masked;
    m' = max(m, max s); p = exp2(s - m'); l' = exp2(m - m') l + sum p;
    acc' = exp2(m - m') acc + round(p) @ v; out = acc / max(l, 1e-30), f32.
    ``bf16`` rounds q, k, v and p to bf16 (products exact in f32). Query
    rows are independent: any slice of q's rows gives that slice of the
    output, so the kernel's query tile changes nothing. ``matmul`` takes
    both products of each tile (a test passes the kernel's 3xTF32
    split)."""
    B, H, Sq, Dh = q.shape
    S = k.shape[2]
    scale = LOG2E / (Dh ** 0.5)
    dt = torch.bfloat16 if bf16 else torch.float32
    qf, kf, vf = (t.to(dt).float() for t in (q, k, v))
    keep = None if mask is None else \
        (mask.to(torch.int32) > 0)[:, None, None, :]
    dev = q.device
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for j0 in range(0, S, kv_tile):
        j1 = min(j0 + kv_tile, S)
        s = matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * scale
        if keep is not None:
            s = torch.where(keep[..., j0:j1], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + matmul(p.to(dt).float(), vf[:, :, j0:j1])
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    f = lib.flash_attention_fwd
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 12
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    lib.flash_attention_kv_tile.argtypes = [ctypes.c_int]
    lib.flash_attention_kv_tile.restype = ctypes.c_int
    lib.flash_attention_occupancy.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_occupancy.restype = ctypes.c_int
    return lib


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """f32 with a unit last stride, the other strides and the start on
    16-byte boundaries (the kernel's float4 loads); a strided view of a
    dense layer's output passes as it is."""
    t = t.float()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or \
            any(s % 4 for s in t.stride()[:-1]):
        t = t.contiguous()
    return t


def _flash_attention_cuda(q, k, v, mask, *, bf16):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one shape [B, H, S, Dh]")
    B, H, S, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel serves head widths "
                         f"{HEAD_DIMS}, got {Dh}")
    if mask is not None and tuple(mask.shape) != (B, S):
        raise ValueError(f"mask must be [B, S] = {(B, S)}, got "
                         f"{tuple(mask.shape)}")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    tile = KV_TILE if bf16 else KV_TILE_F32
    if -(-S // tile) * B * H >= 2 ** 31:
        raise ValueError("flash attention: too many (query tile, head) blocks")
    mask_i = None if mask is None else mask.to(torch.int32).contiguous()
    # the output in [B, S, H, Dh], the layout the encoders read next,
    # returned as its [B, H, S, Dh] view
    out = torch.empty((B, S, H, Dh), dtype=torch.float32,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_i is None else mask_i.data_ptr(), out.data_ptr(),
            B, H, S, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], LOG2E / math.sqrt(Dh), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["bf16" if bf16 else "f32"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    bf16: bool = True) -> torch.Tensor:
    """q, k, v [B, H, S, Dh]; mask [B, S] (>0 = attend) or None. Returns
    f32 [B, H, S, Dh]. ``bf16=True`` (default) computes QK^T and PV as
    bf16 x bf16 -> f32 products; ``bf16=False`` to f32 accuracy (3xTF32
    on the card). The softmax state stays f32.

    CPU tensors take ``flash_attention_plain`` at the kernel's KV tile;
    CUDA tensors launch the kernel or raise."""
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"flash attention inputs on several devices: {devs}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, mask, bf16=bf16,
                                     kv_tile=KV_TILE if bf16 else KV_TILE_F32)
    if dev.type == "cuda":
        return _flash_attention_cuda(q, k, v, mask, bf16=bf16)
    raise ValueError(f"no flash attention for device {dev}")
