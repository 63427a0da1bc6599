"""Build and load the hand-written Hopper kernels.

All CUDA sources under targetvae_tpu_torch/csrc/ compile with nvcc into one
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), which is loaded with ctypes. Each source compiles in its own nvcc
process, all started together, and one more nvcc links the objects. The
build happens at the first kernel
launch, never at import, into targetvae_tpu_torch/build/ (listed in
.gitignore); the file name carries a hash of the sources, so an edited source
always rebuilds.

Every C entry point takes device pointers and the CUDA stream as void*, ints
as int, launches on that stream without synchronising, and returns
cudaGetLastError() after its launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: name -> argtypes (all return int, a cudaError_t)
SIGNATURES = {
    # pre1, bc, w2, b2, wh, bh, out, N, R, K, D, G, chunk, act, stream
    "tvae_mix_heads_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # pre1, bc, w2, b2, wh, bh, out, N, KI, K, D, G, chunk, act, stream
    "tvae_mix_heads_r1_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # pre1, bc, w2, b2, wh, g, dpre1, dpre2, part_a, part_b, sums, N, KI, K,
    # D, G, chunk, SPa, runs, per, SPb, act, stream
    "tvae_mix_heads_r1_bwd": [_P] * 11 + [_I] * 11 + [_P],
    # heads, p_r, offs, p_tr, grid, out, B, R, M, zd, sig_r, deterministic,
    # seed, cluster, chunk, stream
    "tvae_posterior_fwd": [_P] * 6 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # pre1, bc, w2, b2, wh, g, dpre1, part, out, N, R, K, D, G, chunk, SP,
    # act, stream
    "tvae_mix_heads_bwd": [_P] * 9 + [_I] * 8 + [_P],
    # the forward's five inputs, g, dheads, B, R, M, zd, sig_r,
    # deterministic, seed, cluster, chunk, sub, stream
    "tvae_posterior_bwd": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    # norms, planes, noise, p, gx, gy, offs, out, B, C, zd, row, plane,
    # nrow, sig_r, cluster, chunk, vec, stream
    "tvae_posterior_shard_fwd": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    # the forward's seven inputs, g, gplanes, dadq, spart, B, C, zd, row,
    # plane, nrow, grow, gplane, sig_r, cluster, chunk, vec, stream
    "tvae_posterior_shard_bwd": [_P] * 11 + [_I] * 8 + [_F] + [_I] * 3
                                + [_P],
    # u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, hs_out (or null),
    # B, n, F, H, L, n_out, act, stream
    "tvae_pose_decoder_fwd": [_P] * 13 + [_I] * 7 + [_P],
    # u, v, p, q, w1, wh, w3, g, hs, gx, gy, dP, part, cols_img, cols, gpart,
    # dpart, df, dw1, dwh, B, n, F, H, L, n_out, S1, C1, S2, C2, act, stream
    "tvae_pose_decoder_bwd": [_P] * 20 + [_I] * 11 + [_P],
    # p, wc, bc, w2, b2, wh, bh, out, h1_out (or null), N, CK, R, K, D, G,
    # chunk, act, stream
    "tvae_lifted_encoder_fwd": [_P] * 9 + [_I] * 8 + [_P],
    # p, h1, w2, b2, wh, g, dpre1, part, out, gpart, dwc,
    # N, CK, R, K, D, G, chunk, SP, S, C, act, stream
    "tvae_lifted_encoder_bwd": [_P] * 11 + [_I] * 11 + [_P],
    # y, wk, out, B, H, W, C, k, pad, N, rows, rs, stages, nbuf, G, chunk,
    # stream
    "tvae_lift_conv_fwd": [_P] * 3 + [_I] * 13 + [_P],
    # x, wf, bf, wmax, hz, w1, b1, wh, bh, w3, b3, y, hs_out (or null),
    # B, npx, F, H, L, n_out, act, stream
    "tvae_decoder_mlp_fwd": [_P] * 13 + [_I] * 7 + [_P],
    # the forward's eleven inputs, g, y, hs, dP, part, cols_img, cols, gpart,
    # dx, dw1, dwh, B, npx, F, H, L, n_out, S1, C1, S2, C2, act, stream
    "tvae_decoder_mlp_bwd": [_P] * 22 + [_I] * 11 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(defines: tuple = ()) -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + list(defines)).encode())
    return BUILD_DIR / f"libtvae_kernels_{h.hexdigest()[:16]}.so"


def build(defines: tuple = ()) -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built.
    Returns its path; nvcc's -Xptxas -v reports are kept beside it (.log).
    `defines` (nvcc -D flags) build a variant beside it, such as the clock64
    probe of tools/probe_encoder_fwd.py (-DTVAE_PROBE)."""
    lib = library_path(defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = work / f"{src.stem}.o"
        cmd = ([nvcc] + ARCH_FLAGS + list(defines)
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                  "-c", "-o", str(obj), str(src)])
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc] + ARCH_FLAGS
                              + ["-shared", "-o", str(tmp)]
                              + [str(obj) for obj, _ in jobs],
                              capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    lib.with_suffix(".log").write_text("".join(log))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp.replace(lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if its launch reported a CUDA error."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_cuda(*tensors, dtypes) -> None:
    """Every tensor on one CUDA device, contiguous, of the matching dtype."""
    dev = tensors[0].device
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"argument {i}: expected a tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"argument {i}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"argument {i}: expected a contiguous tensor")
