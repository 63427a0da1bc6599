"""MRC2000 image-stack reader/writer (mirror of targetvae_tpu/data/mrc.py,
numpy only; it writes the same bytes).

Implements the same on-disk format the reference handles (src/mrc.py:10-217)
using a numpy structured dtype over the 1024-byte header rather than a struct
format string; supports memory-mapped reads so multi-GB particle stacks are
not copied into RAM up front (the reference reads whole files with f.read(),
train_particles.py:454-461).

Field names/offsets follow the MRC2000 / IMOD header convention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

HEADER_SIZE = 1024

HEADER_DTYPE = np.dtype({
    "names": [
        "nx", "ny", "nz", "mode",
        "nxstart", "nystart", "nzstart",
        "mx", "my", "mz",
        "xlen", "ylen", "zlen",
        "alpha", "beta", "gamma",
        "mapc", "mapr", "maps",
        "amin", "amax", "amean",
        "ispg", "next", "creatid",
        "nint", "nreal",
        "imodStamp", "imodFlags",
        "idtype", "lens", "nd1", "nd2", "vd1", "vd2",
        "tilt_ox", "tilt_oy", "tilt_oz", "tilt_cx", "tilt_cy", "tilt_cz",
        "xorg", "yorg", "zorg",
        "cmap", "stamp", "rms",
        "nlabl", "labels",
    ],
    "formats": [
        "<i4", "<i4", "<i4", "<i4",
        "<i4", "<i4", "<i4",
        "<i4", "<i4", "<i4",
        "<f4", "<f4", "<f4",
        "<f4", "<f4", "<f4",
        "<i4", "<i4", "<i4",
        "<f4", "<f4", "<f4",
        "<i4", "<i4", "<i2",
        "<i2", "<i2",
        "<i4", "<i4",
        "<i2", "<i2", "<i2", "<i2", "<i2", "<i2",
        "<f4", "<f4", "<f4", "<f4", "<f4", "<f4",
        "<f4", "<f4", "<f4",
        "S4", "S4", "<f4",
        "<i4", "S800",
    ],
    "offsets": [
        0, 4, 8, 12,
        16, 20, 24,
        28, 32, 36,
        40, 44, 48,
        52, 56, 60,
        64, 68, 72,
        76, 80, 84,
        88, 92, 96,
        128, 130,
        152, 156,
        160, 162, 164, 166, 168, 170,
        172, 176, 180, 184, 188, 192,
        196, 200, 204,
        208, 212, 216,
        220, 224,
    ],
    "itemsize": HEADER_SIZE,
})

# MRC mode -> numpy dtype (same mapping as reference src/mrc.py:119-132)
MODE_TO_DTYPE = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    3: np.dtype("2h"),
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    16: np.dtype("3B"),
}
DTYPE_TO_MODE = {v: k for k, v in MODE_TO_DTYPE.items()}


def parse_header(buf: bytes) -> np.void:
    return np.frombuffer(buf[:HEADER_SIZE], dtype=HEADER_DTYPE, count=1)[0]


def parse(content: bytes) -> Tuple[np.ndarray, np.void, bytes]:
    """Parse a full MRC file from bytes -> (array, header, extended_header).

    Squeezes nz==1 stacks to 2-D like the reference (src/mrc.py:136-138).
    """
    header = parse_header(content)
    ext = int(header["next"])
    start = HEADER_SIZE + ext
    extended = content[HEADER_SIZE:start]
    dtype = MODE_TO_DTYPE[int(header["mode"])]
    nz, ny, nx = int(header["nz"]), int(header["ny"]), int(header["nx"])
    array = np.frombuffer(content, dtype=dtype, count=nz * ny * nx, offset=start)
    array = array.reshape(nz, ny, nx)
    if nz == 1:
        array = array[0]
    return array, header, extended


def read_mmap(path: str) -> Tuple[np.ndarray, np.void]:
    """Memory-map an MRC stack: (nz, ny, nx) view without loading into RAM."""
    with open(path, "rb") as f:
        header = parse_header(f.read(HEADER_SIZE))
    dtype = MODE_TO_DTYPE[int(header["mode"])]
    nz, ny, nx = int(header["nz"]), int(header["ny"]), int(header["nx"])
    offset = HEADER_SIZE + int(header["next"])
    arr = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                    shape=(nz, ny, nx))
    return arr, header


def make_header(shape, cella=(1.0, 1.0, 1.0), cellb=(0.0, 0.0, 0.0), mz=1,
                dtype=np.float32, dmin=0.0, dmax=-1.0, dmean=-2.0, rms=-1.0,
                exthd_size=0, ispg=0) -> np.ndarray:
    mode = DTYPE_TO_MODE[np.dtype(dtype)]
    h = np.zeros(1, dtype=HEADER_DTYPE)
    h["nx"], h["ny"], h["nz"] = shape[2], shape[1], shape[0]
    h["mode"] = mode
    h["mx"], h["my"], h["mz"] = 1, 1, mz
    h["xlen"], h["ylen"], h["zlen"] = cella
    h["alpha"], h["beta"], h["gamma"] = cellb
    h["mapc"], h["mapr"], h["maps"] = 1, 2, 3
    h["amin"], h["amax"], h["amean"] = dmin, dmax, dmean
    h["ispg"] = ispg
    h["next"] = exthd_size
    h["rms"] = rms
    return h[0]


def write(f, array: np.ndarray, header: Optional[np.void] = None,
          extended_header: bytes = b"", ax=1.0, ay=1.0, az=1.0,
          alpha=0.0, beta=0.0, gamma=0.0) -> None:
    """Write an MRC file (header + extended header + raw data)."""
    if array.ndim == 2:
        array3 = array[None]
    else:
        array3 = array
    if header is None:
        header = make_header(
            array3.shape, cella=(ax, ay, az), cellb=(alpha, beta, gamma),
            dtype=array.dtype,
            dmin=float(array.min()), dmax=float(array.max()),
            dmean=float(array.mean()), rms=float(array.std()),
            exthd_size=len(extended_header))
    buf = np.zeros(1, dtype=HEADER_DTYPE)
    buf[0] = header
    close = False
    if isinstance(f, str):
        f = open(f, "wb")
        close = True
    try:
        f.write(buf.tobytes())
        f.write(extended_header)
        f.write(np.ascontiguousarray(array).tobytes())
    finally:
        if close:
            f.close()
