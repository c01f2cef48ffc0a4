"""Common index API, the checkpoint format and the query wires.

Counterpart of ``neurondb_tpu/index/base.py``. ``save``/``load`` write and
read the same ``arrays.npz`` + ``manifest.json`` pair, so an index saved
by either package loads in the other. ``as_batch`` decodes the same
query wires (f32, half, int8, int12, int4) on the index's device, after
shipping them in their compact form.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


class BaseIndex:
    """Interface: build/add/search/save/load. Subclasses set ``kind``."""

    kind: str = "base"
    metric: str = "l2"
    dim: int = 0

    def search(self, queries, k: int = 10, **kw) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    # ---- persistence ----
    def _state(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        raise NotImplementedError

    def _load_state(self, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                    device=None) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        arrays, meta = self._state()
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(os.path.join(path, "arrays.npz"),
                            **{k: _to_savable(v) for k, v in arrays.items()})
        meta = dict({"format_version": 1}, **meta, kind=self.kind,
                    metric=self.metric, dim=self.dim)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                   *, device=None) -> "BaseIndex":
        """Build from a saved state, ``_state()``'s arrays (as numpy) and
        meta plus ``metric`` and ``dim``, without training: a JAX index's
        state carries across this way, and both packages then hold the
        same centroids, codebooks and lists."""
        obj = cls.__new__(cls)
        obj._load_state(arrays, meta, device=device)
        return obj

    @classmethod
    def load(cls, path: str, *, device=None) -> "BaseIndex":
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: _from_saved(data[k]) for k in data.files}
        return cls.from_state(arrays, meta, device=device)


def _to_savable(v) -> np.ndarray:
    """npz cannot hold bf16: tensors leave as f32 numpy arrays."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_floating_point() and v.dtype != torch.float64:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _from_saved(a: np.ndarray) -> np.ndarray:
    """Checkpoints written before the f32 upcast hold raw bf16 words."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).float().numpy()
    return a


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _batch(q: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    return (q[None, :], True) if q.ndim == 1 else (q, False)


def _is_np_dtype(a, dt) -> bool:
    return (not isinstance(a, torch.Tensor)
            and getattr(a, "dtype", None) is not None
            and np.dtype(a.dtype) == dt)


def _is_wire(a, np_dt, torch_dt) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch_dt
    return _is_np_dtype(a, np_dt)


def as_batch(queries, device=None) -> Tuple[torch.Tensor, bool]:
    """Batchify to [B, D] f32 on ``device`` -> (queries, was_single).

    - ``(int8 codes [B, D], scales [B] or [B, 1])``: the int8 wire,
      ``codes * scales``;
    - ``(int8 codes, uint8 resid [B, D//2], scales)``: the int12 wire;
    - ``(uint8 packed [B, D//2], scales)``: the int4 wire;
    - a float16 / bfloat16 array: shipped in 2 bytes, upcast on device;
    - anything else: f32.
    Wires travel in their compact dtype and decode on ``device``."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if isinstance(queries, tuple) and len(queries) in (2, 3):
        head = queries[0]
        if len(queries) == 2 and _is_wire(head, np.int8, torch.int8):
            codes, scales = (_as_tensor(p, device) for p in queries)
            return _batch(_dequant_int8(codes, scales))
        if len(queries) == 3 and _is_wire(head, np.int8, torch.int8):
            codes, resid, scales = (_as_tensor(p, device) for p in queries)
            return _batch(_dequant_int12(codes, resid, scales))
        if len(queries) == 2 and _is_wire(head, np.uint8, torch.uint8):
            codes, scales = (_as_tensor(p, device) for p in queries)
            return _batch(_dequant_int4(codes, scales))
    if isinstance(queries, torch.Tensor):
        return _batch(queries.to(device).float())
    a = np.asarray(queries)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":
        # bfloat16 (ml_dtypes) host array: ship the raw 2-byte words
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return _batch(t.to(device).view(torch.bfloat16).float())
    if a.dtype == np.float16:
        return _batch(torch.from_numpy(np.ascontiguousarray(a))
                      .to(device).float())
    return _batch(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device))


def _scale_col(scales: torch.Tensor, ndim: int) -> torch.Tensor:
    s = scales.float()
    return s[..., None] if s.ndim == ndim - 1 else s


def _dequant_int8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.float() * _scale_col(scales, codes.ndim)


def _unpack_nibbles(packed: torch.Tensor, bias: float) -> torch.Tensor:
    """[..., D//2] bytes -> [..., D] f32, the even dim in the low nibble."""
    lo = (packed & 0xF).float() - bias
    hi = (packed >> 4).float() - bias
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


_F32_RECIP_14 = float(np.float32(1.0 / 14.0))


def _dequant_int12(codes: torch.Tensor, resid: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    # XLA folds the division by 14 into a fused multiply-add with the f32
    # reciprocal: codes + r * f32(1/14) rounded once. The product and sum
    # of these small integers are exact in f64, so one f64 multiply-add
    # and one rounding to f32 decode bit-for-bit like the JAX package.
    r = _unpack_nibbles(resid, 7.0).double()
    q = (codes.double() + r * _F32_RECIP_14).float()
    return q * _scale_col(scales, codes.ndim)


def _dequant_int4(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    q = _unpack_nibbles(codes, 8.0)
    return q * _scale_col(scales, q.ndim)


def quantize_queries_int4(q: np.ndarray):
    """Client-side helper for the packed int4 wire: per-query max-abs
    scales over 7 levels, two dims per byte (even dim in the low
    nibble). Returns (packed uint8 [B, D//2], scales f32 [B, 1])."""
    q = np.asarray(q, np.float32)
    if q.shape[-1] % 2:
        raise ValueError("int4 wire requires an even dimension")
    sc = np.abs(q).max(axis=-1, keepdims=True) / 7.0
    sc = np.maximum(sc, 1e-30)
    codes = (np.clip(np.round(q / sc), -7, 7) + 8).astype(np.uint8)
    lo, hi = codes[..., 0::2], codes[..., 1::2]
    packed = lo | (hi << 4)
    return packed, sc.astype(np.float32)


def quantize_queries_int8(q: np.ndarray):
    """Client-side helper for the int8 wire: per-query max-abs scales.
    Returns (codes int8 [B, D], scales f32 [B, 1])."""
    q = np.asarray(q, np.float32)
    sc = np.abs(q).max(axis=-1, keepdims=True) / 127.0
    sc = np.maximum(sc, 1e-30)
    codes = np.clip(np.round(q / sc), -127, 127).astype(np.int8)
    return codes, sc.astype(np.float32)


def quantize_queries_int12(q: np.ndarray):
    """Client-side helper for the int12 wire: int8 codes + a packed int4
    refinement of the rounding residual (15 levels over +-scale/2, even
    dim in the low nibble). Returns (codes int8 [B, D], resid uint8
    [B, D//2], scales f32 [B, 1])."""
    q = np.asarray(q, np.float32)
    if q.shape[-1] % 2:
        raise ValueError("int12 wire requires an even dimension")
    sc = np.abs(q).max(axis=-1, keepdims=True) / 127.0
    sc = np.maximum(sc, 1e-30)
    codes = np.clip(np.round(q / sc), -127, 127)
    r = np.clip(np.round((q / sc - codes) * 14.0), -7, 7) + 7
    r = r.astype(np.uint8)
    packed = r[..., 0::2] | (r[..., 1::2] << 4)
    return codes.astype(np.int8), packed, sc.astype(np.float32)
