#!/usr/bin/env python3
"""Distributed shared memory rates of the card, for sizing cluster kernels.

    python3 tools/bench_dsmem.py [--iters 2000]

Builds a small CUDA source of its own (nvcc, into targetvae_tpu_torch/
build/, which .gitignore lists) and launches, for clusters of 2, 4, 8 and 16
CTAs of one CTA an SM (the non-portable size for 16), as many clusters as
the card holds at once (cudaOccupancyMaxActiveClusters), each CTA running
`iters` rounds of:

- "bulk": one thread sends `bytes` to each other CTA of its cluster with
  cp.async.bulk from its shared memory into the peer's, completing on the
  peer's mbarrier (the copy engine), then waits for its own peers' bytes;
- "stores": its 256 threads write the same bytes into the peers' shared
  memory with 16-byte st.shared::cluster, then the cluster meets;
- "barrier": the cluster only meets (barrier.cluster arrive and wait).

Prints one JSON line a cluster size: the bytes a CTA sends a round, the
microseconds a round and the rate a CTA (GB/s sent) and over the card for
each way, with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t su32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t peer(uint32_t a, uint32_t r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(r));
  return d;
}
__device__ __forceinline__ uint32_t crank() {
  uint32_t r; asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r)); return r;
}
__device__ __forceinline__ void cl_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
}

// mode 0 bulk copies, 1 stores, 2 barrier only; smem: [bar 8 | pad | src
// `bytes` | dst cs * bytes]
__global__ void __launch_bounds__(256, 1) dsmem_kernel(int mode, int bytes,
                                                      int iters, int cs,
                                                      long long* cycles) {
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  unsigned char* src = sm + 1024;
  unsigned char* dst = src + bytes;
  const uint32_t r = crank();
  for (int o = threadIdx.x * 16; o < bytes; o += 256 * 16)
    *reinterpret_cast<uint4*>(src + o) = make_uint4(r, o, 1, 2);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(su32(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cl_sync();
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(su32(bar)), "r"((uint32_t)((cs - 1) * bytes)) : "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int j = 1; j < cs; ++j) {
          const uint32_t q = (r + j) % cs;
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
              " [%0], [%1], %2, [%3];"
              :: "r"(peer(su32(dst + r * bytes), q)), "r"(su32(src)),
                 "r"((uint32_t)bytes), "r"(peer(su32(bar), q)) : "memory");
        }
        uint32_t done = 0;
        while (!done)
          asm volatile("{\n.reg .pred p;\n"
                       "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                       "selp.u32 %0, 1, 0, p;\n}"
                       : "=r"(done) : "r"(su32(bar)), "r"((uint32_t)(it & 1)) : "memory");
      }
      // the peers must not send the next round before this one is taken
      cl_sync();
    } else if (mode == 1) {
      for (int j = 1; j < cs; ++j) {
        const uint32_t q = (r + j) % cs;
        const uint32_t base = peer(su32(dst + r * bytes), q);
        for (int o = threadIdx.x * 16; o < bytes; o += 256 * 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + o);
          asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
                       :: "r"(base + o), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                       : "memory");
        }
      }
      cl_sync();
    } else {
      cl_sync();
    }
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - c0;
}

extern "C" int dsmem_run(int mode, int bytes, int iters, int cs, int clusters,
                         long long* cycles, float* ms) {
  // at least 120 KB, so that an SM holds one CTA
  const size_t need = 1024 + (size_t)(cs + 1) * bytes;
  const size_t smem = need < 120 * 1024 ? 120 * 1024 : need;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(dsmem_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem))) return (int)e;
  if (cs > 8 && (e = cudaFuncSetAttribute(
                     dsmem_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (clusters <= 0) {
    cfg.gridDim = dim3(cs);
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, dsmem_kernel, &cfg))) return (int)e;
    return -n;                 // the clusters the card holds at once
  }
  cfg.gridDim = dim3(clusters * cs);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  if ((e = cudaLaunchKernelEx(&cfg, dsmem_kernel, mode, bytes, iters, cs, cycles)))
    return (int)e;
  cudaEventRecord(b);
  if ((e = cudaEventSynchronize(b))) return (int)e;
  cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    sys.path.insert(0, HERE)
    from targetvae_tpu_torch.kernels import _build
    h = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libdsmem_{h}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / f"dsmem_{h}.cu"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc()] + _build.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.dsmem_run.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                                    ctypes.c_void_p]
    lib.dsmem_run.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--bytes", type=int, default=4096,
                    help="bytes a CTA sends each peer a round")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the benchmark runs only on a GPU",
              flush=True)
        return 1
    lib = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    ms = ctypes.c_float()
    for cs in (2, 4, 8, 16):
        nbytes = min(args.bytes, 200_000 // (cs + 1) // 16 * 16)
        n = -lib.dsmem_run(0, nbytes, 1, cs, 0, None, None)
        if n <= 0:
            print(json.dumps({"cluster": cs, "error": n}), flush=True)
            continue
        cycles = torch.zeros(n * cs, dtype=torch.int64, device="cuda")
        row = {"cluster": cs, "clusters": n, "bytes_to_each_peer": nbytes,
               "bytes_sent_a_round": nbytes * (cs - 1)}
        for mode, way in enumerate(("bulk", "stores", "barrier")):
            lib.dsmem_run(mode, nbytes, 10, cs, n, cycles.data_ptr(),
                          ctypes.byref(ms))        # warm
            err = lib.dsmem_run(mode, nbytes, args.iters, cs, n,
                                cycles.data_ptr(), ctypes.byref(ms))
            if err:
                row[way] = {"error": err}
                continue
            us = ms.value * 1e3 / args.iters
            sent = nbytes * (cs - 1) if mode < 2 else 0
            row[way] = {"us_a_round": us,
                        "GBps_a_cta": sent / us / 1e3,
                        "GBps_card": sent * n * cs / us / 1e3}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
