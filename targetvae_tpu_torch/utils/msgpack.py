"""flax's msgpack wire format, as far as the checkpoints use it, in the
standard library and numpy (the card's machine has neither flax nor msgpack).

`packb(tree)` gives the bytes of flax.serialization.msgpack_serialize(tree)
and `unpackb(data)` the tree of flax.serialization.msgpack_restore(data)
for trees of:

- dicts, packed as msgpack maps with their keys sorted, as flax's copy of
  the tree through jax.tree_util sorts them;
- lists, packed as msgpack arrays;
- numpy arrays, packed as ext type 1, and numpy scalars as ext type 3, each
  carrying the msgpack array [shape, dtype name, raw C-order bytes];
- Python int, float (a double), str, bool and None, packed natively.

flax splits an array of more than 2**30 bytes into a chunked map; no
checkpoint of this package comes near that size, so both directions raise on
one. Tuples, which flax's strict packer refuses as well, raise TypeError.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30       # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ---- writer ----

def _int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def _sized(n: int, out: bytearray, fix: int, fix_max: int, m8, m16: int,
           m32: int) -> None:
    """A length header: the fix form below fix_max, else 8 (where the type
    has one), 16 or 32 bits."""
    if n < fix_max:
        out += struct.pack("B", fix | n)
    elif m8 is not None and n <= 0xFF:
        out += struct.pack(">BB", m8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", m16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", m32, n)
    else:
        raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


def _bin(b: bytes, out: bytearray) -> None:
    n = len(b)
    if n <= 0xFF:
        out += struct.pack(">BB", 0xC4, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC5, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xC6, n)
    else:
        raise ValueError(f"bytes of length {n} exceed msgpack's 32-bit limit")
    out += b


def _ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack("B", fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, C bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
        raise ValueError(
            f"an array of {arr.size * arr.dtype.itemsize} bytes exceeds "
            f"{MAX_CHUNK_SIZE}: flax writes it in chunks, which this codec "
            "does not implement")
    out = bytearray(b"\x93")
    _sized(arr.ndim, out, 0x90, 16, None, 0xDC, 0xDD)
    for d in arr.shape:
        _int(int(d), out)
    _str(arr.dtype.name, out)
    _bin(arr.tobytes("C"), out)
    return bytes(out)


def _str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _sized(len(b), out, 0xA0, 32, 0xD9, 0xDA, 0xDB)
    out += b


def _pack(x, out: bytearray) -> None:
    t = type(x)
    if x is None:
        out += b"\xc0"
    elif x is True:
        out += b"\xc3"
    elif x is False:
        out += b"\xc2"
    elif t is int:
        _int(x, out)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif t is str:
        _str(x, out)
    elif t is dict:
        _sized(len(x), out, 0x80, 16, None, 0xDE, 0xDF)
        for k in sorted(x):
            _pack(k, out)
            _pack(x[k], out)
    elif t is list:
        _sized(len(x), out, 0x90, 16, None, 0xDC, 0xDD)
        for v in x:
            _pack(v, out)
    elif t is np.ndarray:
        _ext(EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot serialise {t.__name__!r} as flax does")


def packb(tree) -> bytes:
    """flax.serialization.msgpack_serialize(tree), byte for byte."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ---- reader ----

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        m = self.unpack("B")
        if m < 0x80:
            return m
        if m >= 0xE0:
            return m - 0x100
        if 0x80 <= m <= 0x8F:
            return self.map(m & 0x0F)
        if 0x90 <= m <= 0x9F:
            return self.array(m & 0x0F)
        if 0xA0 <= m <= 0xBF:
            return self.str(m & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if m in simple:
            return simple[m]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if m in ints:
            v = self.unpack(ints[m])
            return float(v) if m == 0xCA else v
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                   0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if m in fixext:
            return self.ext(fixext[m])
        if m not in lengths:
            raise ValueError(f"unknown msgpack marker 0x{m:02x}")
        n = self.unpack(lengths[m])
        if m in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if m in (0xD9, 0xDA, 0xDB):
            return self.str(n)
        if m in (0xDC, 0xDD):
            return self.array(n)
        if m in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        d = {}
        for _ in range(n):
            k = self.value()
            d[k] = self.value()
        if _CHUNKED in d:
            raise ValueError("a chunked array (flax writes arrays of more "
                             f"than {MAX_CHUNK_SIZE} bytes so): this codec "
                             "does not implement that form")
        return d

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array")
        shape, name, buf = _Reader(data).value()
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """flax.serialization.msgpack_restore(data): numpy arrays for ext type 1,
    numpy scalars for ext type 3."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    return tree
