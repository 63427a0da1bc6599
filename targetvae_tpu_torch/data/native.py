"""ctypes binding to the native host data runtime, native/tvae_native.cpp
(mirror of targetvae_tpu/data/native.py): memory-mapped MRC reads decoded,
cropped and standardised on several threads, and the training feed's
multithreaded row gather.

The library is built from native/tvae_native.cpp with the host's g++ (the
flags of native/Makefile) into targetvae_tpu_torch/build/ at first use,
never at import and never into native/; the file name carries a hash of the
source and flags, so an edited source rebuilds. A build or load that fails
raises with the compiler's message: nothing falls back to numpy unless the
caller asks for it (native=False). ctypes releases the GIL for the length
of each call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "tvae_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-pthread", "-shared"]
# the MRC modes the native decoder reads; any other goes through numpy
NATIVE_MODES = (0, 1, 2, 6)


class _MrcInfo(ctypes.Structure):
    _fields_ = [("nx", ctypes.c_int32), ("ny", ctypes.c_int32),
                ("nz", ctypes.c_int32), ("mode", ctypes.c_int32),
                ("ext_bytes", ctypes.c_int32)]


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which -march=native builds
    for: a library built on another machine is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return b""


def library_path(source: Optional[Path] = None) -> Path:
    h = hashlib.sha256((source or SOURCE).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libtvae_native_{h.hexdigest()[:16]}.so"


def build(source: Optional[Path] = None) -> Path:
    """Compile `source` (native/tvae_native.cpp) into the shared library
    unless it is already built; returns its path. Raises RuntimeError with
    g++'s output on failure."""
    source = source or SOURCE
    lib = library_path(source)
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native data runtime builds "
                           "with the host's C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    done = subprocess.run([cxx] + CXX_FLAGS + ["-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {source} "
                           f"({done.returncode}):\n{done.stdout}{done.stderr}")
    tmp.replace(lib)        # atomic: ranks and test workers build at once
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tvae_mrc_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MrcInfo)]
    lib.tvae_mrc_info.restype = ctypes.c_int
    lib.tvae_mrc_load_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.tvae_mrc_load_f32.restype = ctypes.c_int
    lib.tvae_gather_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.tvae_gather_f32.restype = ctypes.c_int
    return lib


def mrc_info(path: str) -> _MrcInfo:
    """The stack's header fields nx, ny, nz, mode and ext_bytes."""
    info = _MrcInfo()
    rc = library().tvae_mrc_info(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise OSError(f"tvae_mrc_info({path}) failed ({rc})")
    return info


def _numpy_load(path: str, crop: int, normalize: bool) -> np.ndarray:
    from . import mrc
    from .datasets import preprocess_particles
    arr, _ = mrc.read_mmap(path)
    imgs = np.asarray(arr, dtype=np.float32)
    if imgs.ndim == 2:
        imgs = imgs[None]
    return preprocess_particles(imgs, crop, normalize)


def load_mrc_f32(path: str, crop: int = 0, normalize: bool = False,
                 nthreads: int = 0, native: bool = True) -> np.ndarray:
    """The stack (nz, ny, nx) as float32, centre-cropped to crop x crop
    where crop > 0 and each image standardised by its own mean and std with
    normalize. The native path decodes modes 0, 1, 2 and 6 on `nthreads`
    threads (0: up to 16); another mode, or native=False, reads it with
    numpy (mrc.read_mmap, datasets.preprocess_particles)."""
    if not native:
        return _numpy_load(path, crop, normalize)
    info = mrc_info(path)
    if info.mode not in NATIVE_MODES:
        return _numpy_load(path, crop, normalize)
    n = crop if crop > 0 else info.ny
    m = crop if crop > 0 else info.nx
    out = np.empty((info.nz, n, m), dtype=np.float32)
    rc = library().tvae_mrc_load_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        crop, int(normalize), nthreads or min(os.cpu_count() or 1, 16))
    if rc != 0:
        raise OSError(f"tvae_mrc_load_f32({path}) failed ({rc})")
    return out


def gather_f32(images: np.ndarray, idx: np.ndarray,
               out: Optional[np.ndarray] = None, nthreads: int = 0,
               native: bool = True) -> np.ndarray:
    """out[i] = images[idx[i]] for a C-contiguous float32 `images` (n, ...),
    into `out` (a C-contiguous float32 array of len(idx) rows, such as a
    pinned host buffer's view) or a new array; multithreaded memcpy on
    `nthreads` threads (0: up to 8), or numpy's take with native=False."""
    if images.dtype != np.float32 or not images.flags.c_contiguous:
        raise ValueError("gather_f32 takes a C-contiguous float32 array")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    shape = (len(idx),) + images.shape[1:]
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 {shape}")
    if not native:
        return np.take(images, idx, axis=0, out=out)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(images)):
        raise IndexError("gather_f32: index out of range")
    row = int(np.prod(images.shape[1:], dtype=np.int64))
    library().tvae_gather_f32(images.ctypes.data, idx.ctypes.data, len(idx),
                              1, row, out.ctypes.data,
                              nthreads or min(os.cpu_count() or 1, 8))
    return out
