"""PNG for uint8 RGB images with the standard library (zlib, struct).

`encode_png` writes 8-bit RGB, non-interlaced, each row with filter 0 (no
prediction); `decode_png` reads that layout back to an (H, W, 3) uint8
array and refuses any other.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# width, height, bit depth 8, colour type 2 (RGB), compression, filter
# method and interlace 0
_IHDR = ">IIBBBBB"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(_IHDR, w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes in `encode_png`'s layout -> (H, W, 3) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(_IHDR, body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB non-interlaced PNG: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError("PNG rows use prediction filters; only filter 0 "
                         "is read")
    return rows[:, 1:].reshape(h, w, 3).copy()
