"""Exotic value types: rtext, vectorp (packed+checksummed vectors).

A copy of ``neurondb_tpu/types/exotic.py`` (numpy, zlib and struct only),
kept here so the port imports nothing from the JAX package: the same
classes, and ``VectorPacked`` blobs byte-identical in both directions.

Reference: NeuronDB/include/neurondb_types.h — `RetrievableText` (:61,
text + token offsets + section ids), `VectorPacked` (:29, packed payload
with CRC fingerprint and endian guard) implemented in
src/vector/vector_types.c:43-1502 / src/core/types_core.c.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = 0x4E444250  # "NDBP"


@dataclass
class RetrievableText:
    """Text with token offsets and section ids — lets retrieval map chunk
    hits back to exact character spans (`rtext` parity)."""

    text: str
    token_offsets: List[Tuple[int, int]] = field(default_factory=list)
    section_ids: List[int] = field(default_factory=list)

    @classmethod
    def from_text(cls, text: str,
                  section_breaks: Optional[Sequence[int]] = None
                  ) -> "RetrievableText":
        import re
        offsets = [(m.start(), m.end())
                   for m in re.finditer(r"\S+", text)]
        breaks = sorted(section_breaks or [])
        sections = []
        for start, _ in offsets:
            sec = 0
            for b in breaks:
                if start >= b:
                    sec += 1
            sections.append(sec)
        return cls(text, offsets, sections)

    @property
    def num_tokens(self) -> int:
        return len(self.token_offsets)

    def token(self, i: int) -> str:
        s, e = self.token_offsets[i]
        return self.text[s:e]

    def section_text(self, section: int) -> str:
        toks = [self.token_offsets[i] for i, s in enumerate(self.section_ids)
                if s == section]
        if not toks:
            return ""
        return self.text[toks[0][0]: toks[-1][1]]

    def span_for_tokens(self, start_tok: int, end_tok: int) -> str:
        s = self.token_offsets[start_tok][0]
        e = self.token_offsets[end_tok - 1][1]
        return self.text[s:e]


class VectorPacked:
    """Checksummed packed vector blob (`vectorp` parity): header with
    magic (endian guard), dim, dtype code, CRC32 fingerprint of payload."""

    _DTYPES = {0: np.float32, 1: np.float16, 2: np.int8, 3: np.uint8}
    _CODES = {np.dtype(np.float32): 0, np.dtype(np.float16): 1,
              np.dtype(np.int8): 2, np.dtype(np.uint8): 3}

    @classmethod
    def pack(cls, vec: np.ndarray) -> bytes:
        v = np.ascontiguousarray(vec)
        code = cls._CODES.get(v.dtype)
        if code is None:
            v = v.astype(np.float32)
            code = 0
        payload = v.tobytes()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        header = struct.pack("<IIII", _MAGIC, v.shape[-1], code, crc)
        return header + payload

    @classmethod
    def unpack(cls, blob: bytes) -> np.ndarray:
        if len(blob) < 16:
            raise ValueError("vectorp blob too short")
        magic, dim, code, crc = struct.unpack("<IIII", blob[:16])
        if magic != _MAGIC:
            # endian guard: a byte-swapped magic means foreign byte order
            if struct.unpack(">I", blob[:4])[0] == _MAGIC:
                raise ValueError("vectorp blob has foreign endianness")
            raise ValueError("bad vectorp magic")
        payload = blob[16:]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError("vectorp checksum mismatch (corrupt payload)")
        dt = cls._DTYPES[code]
        v = np.frombuffer(payload, dt)
        if v.shape[0] != dim:
            raise ValueError(f"vectorp dim mismatch: header {dim}, "
                             f"payload {v.shape[0]}")
        return v.copy()

    @classmethod
    def fingerprint(cls, blob: bytes) -> int:
        return struct.unpack("<IIII", blob[:16])[3]
