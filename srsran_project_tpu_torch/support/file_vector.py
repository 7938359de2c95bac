"""Binary test-vector IO (a copy of ``srsran_project_tpu/support/file_vector.py``),
byte-compatible with the reference's file_vector
(include/srsran/support/file_vector.h:63-81): raw little-endian arrays of a
fixed element type, no header.

Supported element types mirror the reference's usage: cf_t (complex64),
cbf16_t (two bfloat16 halves packed as uint16 pairs), int8 LLRs, uint8
bits, int16, float32.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "cf32": np.complex64,
    "f32": np.float32,
    "i16": np.int16,
    "i8": np.int8,
    "u8": np.uint8,
    "u16": np.uint16,
    "u32": np.uint32,
}


def read_vector(path: str, kind: str) -> np.ndarray:
    """Read a reference-format binary vector."""
    if kind == "cbf16":
        raw = np.fromfile(path, dtype=np.uint16)
        return _cbf16_to_complex(raw)
    return np.fromfile(path, dtype=_DTYPES[kind])


def write_vector(path: str, data: np.ndarray, kind: str) -> None:
    if kind == "cbf16":
        _complex_to_cbf16(np.asarray(data, np.complex64)).tofile(path)
        return
    np.asarray(data, _DTYPES[kind]).tofile(path)


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16) with round-to-nearest-even."""
    u = x.astype(np.float32).view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    return ((u + rounding) >> 16).astype(np.uint16)


def _cbf16_to_complex(raw: np.ndarray) -> np.ndarray:
    re = (raw[0::2].astype(np.uint32) << 16).view(np.float32)
    im = (raw[1::2].astype(np.uint32) << 16).view(np.float32)
    return (re + 1j * im).astype(np.complex64)


def _complex_to_cbf16(x: np.ndarray) -> np.ndarray:
    out = np.empty(x.size * 2, dtype=np.uint16)
    out[0::2] = _bf16_round(x.real)
    out[1::2] = _bf16_round(x.imag)
    return out
