"""Quantized vector formats and the quantization runtime.

Counterpart of ``neurondb_tpu/types/quantized.py``: the same ten formats,
the same per-vector scales and zero points, the same packed layouts
(int4: two nibbles a byte, low first; ternary: four 2-bit crumbs a byte;
binary: bit i of byte j is component 8j + i). ``torch.round`` and
``jnp.round`` both round half to even and both divisions are IEEE f32,
so codes, scales and offsets equal the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from neurondb_tpu_torch.config import resolve_device

# format -> compression ratio against f32
FORMATS: Dict[str, float] = {
    "f32": 1.0,
    "f16": 2.0,
    "bf16": 2.0,
    "int8": 4.0,
    "uint8": 4.0,
    "int4": 8.0,      # packed 2 per byte
    "ternary": 16.0,  # 2-bit {-1, 0, +1}, packed 4 per byte
    "binary": 32.0,   # 1-bit sign, packed 8 per byte
    "fp8_e4m3": 4.0,
    "fp8_e5m2": 4.0,
}

CODE_DTYPES = {
    "f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
    "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8, "uint8": torch.uint8, "int4": torch.uint8,
    "ternary": torch.uint8, "binary": torch.uint8,
}


@dataclass
class Quantized:
    """A quantized batch of vectors.

    codes: f16/bf16/fp8 [N, D] in that dtype; int8/uint8 [N, D];
        int4 [N, ceil(D/2)], ternary [N, ceil(D/4)], binary
        [N, ceil(D/8)] uint8
    scale: [N] f32 per-vector scale (1.0 where unused)
    offset: [N] f32 per-vector zero point (0.0 where unused)
    dim: original D (packed formats lose it)
    """

    codes: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    fmt: str
    dim: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scale, self.offset))

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


def _pad_cols(v: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-v.shape[1]) % mult
    return torch.nn.functional.pad(v, (0, pad)) if pad else v


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, D] {0,1} -> [N, ceil(D/8)] uint8, little-endian within byte."""
    b = _pad_cols(bits.to(torch.uint8), 8).reshape(bits.shape[0], -1, 8)
    w = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (b << w).sum(-1, dtype=torch.uint8)


def _unpack_bits(packed: torch.Tensor, dim: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :dim]


def _pack_crumbs(vals: torch.Tensor, dim: int) -> torch.Tensor:
    """[N, D] values in 0..3 -> [N, ceil(D/4)] uint8 (2 bits each)."""
    v = _pad_cols(vals.to(torch.uint8), 4).reshape(vals.shape[0], -1, 4)
    shifts = 2 * torch.arange(4, dtype=torch.uint8, device=vals.device)
    return (v << shifts).sum(-1, dtype=torch.uint8)


def _unpack_crumbs(packed: torch.Tensor, dim: int) -> torch.Tensor:
    shifts = 2 * torch.arange(4, dtype=torch.uint8, device=packed.device)
    v = (packed[:, :, None] >> shifts) & 3
    return v.reshape(packed.shape[0], -1)[:, :dim]


def _pack_nibbles(vals: torch.Tensor, dim: int) -> torch.Tensor:
    """[N, D] values in 0..15 -> [N, ceil(D/2)] uint8 (low nibble first)."""
    v = _pad_cols(vals.to(torch.uint8), 2).reshape(vals.shape[0], -1, 2)
    return v[:, :, 0] | (v[:, :, 1] << 4)


def _unpack_nibbles(packed: torch.Tensor, dim: int) -> torch.Tensor:
    v = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=-1)
    return v.reshape(packed.shape[0], -1)[:, :dim]


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, correctly rounded on every device: CUDA turns a division by
    a Python scalar into a product with its reciprocal."""
    return a / torch.full_like(a, b)


def _absmax_scale(x: torch.Tensor, levels: float) -> torch.Tensor:
    absmax = x.abs().amax(1)
    return torch.where(absmax > 0, _div(absmax, levels),
                       torch.ones_like(absmax))


def _rows_f32(x, device) -> torch.Tensor:
    """[N, D] f32 on ``device``: a tensor stays on its own device unless
    ``device`` is given; a host array goes to ``resolve_device(device)``
    (``config.device`` by default)."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=x.device if device is None else device,
                 dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(x, np.float32),
                            device=resolve_device(device))
    return x[None, :] if x.ndim == 1 else x


def quantize(x, fmt: str = "int8", *, device=None) -> Quantized:
    """Quantize [N, D] f32 vectors (array or tensor) to ``fmt``:
    int8 absmax/127, uint8 min-max affine over 255 levels, int4
    absmax/7, fp8 absmax/finfo.max, ternary at +-absmax/2, binary sign.
    ``device``: where the codes are made (default: a tensor's own
    device, ``config.device`` for a host array)."""
    x = _rows_f32(x, device)
    n, d = x.shape
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    if fmt == "f32":
        return Quantized(x, ones, zeros, fmt, d)
    if fmt in ("f16", "bf16"):
        return Quantized(x.to(CODE_DTYPES[fmt]), ones, zeros, fmt, d)
    if fmt in ("fp8_e4m3", "fp8_e5m2"):
        dt = CODE_DTYPES[fmt]
        scale = _absmax_scale(x, float(torch.finfo(dt).max))
        return Quantized((x / scale[:, None]).to(dt), scale, zeros, fmt, d)
    if fmt == "int8":
        scale = _absmax_scale(x, 127.0)
        codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
        return Quantized(codes.to(torch.int8), scale, zeros, fmt, d)
    if fmt == "uint8":
        lo, hi = x.amin(1), x.amax(1)
        scale = torch.where(hi > lo, _div(hi - lo, 255.0), ones)
        codes = torch.clamp(torch.round((x - lo[:, None]) / scale[:, None]),
                            0, 255)
        return Quantized(codes.to(torch.uint8), scale, lo, fmt, d)
    if fmt == "int4":
        scale = _absmax_scale(x, 7.0)
        q = torch.clamp(torch.round(x / scale[:, None]), -7, 7) + 8.0
        return Quantized(_pack_nibbles(q, d), scale, zeros, fmt, d)
    if fmt == "ternary":
        scale = _absmax_scale(x, 1.0)
        thresh = 0.5 * scale[:, None]
        t = torch.where(x > thresh, 2, torch.where(x < -thresh, 0, 1))
        return Quantized(_pack_crumbs(t, d), scale, zeros, fmt, d)
    if fmt == "binary":
        return Quantized(_pack_bits(x > 0), ones, zeros, fmt, d)
    raise ValueError(f"unknown quantization format {fmt!r}")


def dequantize(q: Quantized) -> torch.Tensor:
    """The f32 [N, D] approximation of ``q``."""
    fmt, d = q.fmt, q.dim
    if fmt == "f32":
        return q.codes
    if fmt in ("f16", "bf16"):
        return q.codes.float()
    if fmt in ("fp8_e4m3", "fp8_e5m2", "uint8"):
        return q.codes.float() * q.scale[:, None] + q.offset[:, None]
    if fmt == "int8":
        return q.codes.float() * q.scale[:, None]
    if fmt == "int4":
        return (_unpack_nibbles(q.codes, d).float() - 8.0) * q.scale[:, None]
    if fmt == "ternary":
        return (_unpack_crumbs(q.codes, d).float() - 1.0) * q.scale[:, None]
    if fmt == "binary":
        return _unpack_bits(q.codes, d).float() * 2.0 - 1.0
    raise ValueError(fmt)


def quantize_analyze(x, fmt: str, *, device=None) -> Dict[str, float]:
    """Per-format quantization error report (the reference's
    ``quantize_analyze_*``), computed on ``device`` as ``quantize``
    places it."""
    x = _rows_f32(x, device)
    rec = dequantize(quantize(x, fmt))
    err = rec - x
    mse = float((err * err).mean())
    out = {"format": fmt, "compression_ratio": FORMATS[fmt]}
    if fmt == "binary":
        # binary reconstruction is sign-only: report sign agreement
        out["sign_agreement"] = float(((rec > 0) == (x > 0)).float().mean())
        out.update(mse=mse, max_error=float(err.abs().max()))
        return out
    denom = max(float((x * x).mean()), 1e-30)
    out.update(mse=mse, max_error=float(err.abs().max()),
               relative_rmse=(mse / denom) ** 0.5)
    return out


# SQL-name aliases (vector_to_int8 etc.), placed as ``quantize`` places
# its input
def vector_to_int8(x, *, device=None):
    return quantize(x, "int8", device=device)


def vector_to_fp16(x, *, device=None):
    return quantize(x, "f16", device=device)


def vector_to_binary(x, *, device=None):
    return quantize(x, "binary", device=device)


def vector_to_uint8(x, *, device=None):
    return quantize(x, "uint8", device=device)


def vector_to_ternary(x, *, device=None):
    return quantize(x, "ternary", device=device)


def vector_to_int4(x, *, device=None):
    return quantize(x, "int4", device=device)


def vector_to_fp8_e4m3(x, *, device=None):
    return quantize(x, "fp8_e4m3", device=device)


def vector_to_fp8_e5m2(x, *, device=None):
    return quantize(x, "fp8_e5m2", device=device)
