"""An 8-bit RGB PNG writer in numpy and zlib (the card has no image
library): one IHDR chunk (colour type 2, bit depth 8, no interlace), one
IDAT chunk of rows each behind filter byte 0, IEND; every CRC by
zlib.crc32. png_size reads the width and height back from the header.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """rgb: (H, W, 3) uint8 -> the bytes of a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)       # filter byte 0 a row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file; raises ValueError when its signature
    or its IHDR chunk (and that chunk's CRC) is not a PNG's."""
    with open(path, "rb") as f:
        head = f.read(8 + 8 + 13 + 4)
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    crc = struct.unpack(">I", head[29:33])[0]
    if zlib.crc32(head[12:29]) & 0xFFFFFFFF != crc:
        raise ValueError(f"{path}: IHDR CRC mismatch")
    w, h = struct.unpack(">II", head[16:24])
    return h, w
