// K1: fused lift-activation + mixing + heads, forward.
//
// Replaces targetvae_tpu/kernels/mix_heads.py::_fwd_kernel (lift=True), the
// Pallas kernel behind fused_lift_act_mix_heads. Per position p and rotation
// r, with pre1 the raw lift-conv output (N, R*K) bf16, r-major channels:
//   h1 = bf16(act(pre1[p, r*K:(r+1)*K] + bc[r*K:(r+1)*K]))
//   h2 = bf16(act(h1 @ W2 + b2))           W2 (K, K) bf16, f32 accumulation
//   out[p, r*D:(r+1)*D] = h2 @ Wh + bh     Wh (K, D) bf16, f32 accumulation
//
// What bounds it on the H100: at the flagship shape (N = 100*39*39 = 152,100
// positions, R = 8, K = 128, D = 7) it does about 0.04 TFLOP and reads
// 311 MB of pre1, so it sits near the ridge: ~0.09 ms of HBM time at
// 3.35 TB/s against ~0.04 ms of bf16 tensor-core time at peak.
//
// Design: one block per tile of 64 positions, 8 warps. W2 (32 KB at K=128)
// and Wh (zero-padded to 16 columns) stay in shared memory for the block's
// life. For each rotation the block loads its 64 x K slice of pre1 16 bytes a
// thread, applies bias and activation and stages h1 in shared memory as bf16
// (pre1 is read once; h1 and h2 never reach device memory). The mixing and
// the heads both run on the tensor cores with nvcuda::wmma 16x16x16 bf16
// fragments, through an f32 staging tile where bias and activation are
// applied; h2 overwrites h1 in place. N need not divide by 64: rows past N
// are zero in shared memory and never stored. wgmma/TMA pipelining is later
// work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TP = 64;          // positions per block
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int DP = 16;          // heads padded to one fragment width

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS) mix_heads_fwd_kernel(
    const __nv_bfloat16* __restrict__ pre1, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bh,
    float* __restrict__ out, int N, int R, int K, int D, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [W2 K*K bf16 | Wh K*DP bf16 | h1/h2 TP*K bf16 | staging TP*K f32]
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* whs = w2s + K * K;
  __nv_bfloat16* hs = whs + K * DP;
  float* stg = reinterpret_cast<float*>(hs + TP * K);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * TP;
  const int RK = R * K;
  const int K8 = K / 8;

  for (int i = tid; i < K * K; i += THREADS) w2s[i] = w2[i];
  for (int i = tid; i < K * DP; i += THREADS) {
    const int k = i / DP, d = i - k * DP;
    whs[i] = d < D ? wh[k * D + d] : __float2bfloat16(0.f);
  }

  const int kb = K / 16;
  for (int r = 0; r < R; ++r) {
    // h1 = bf16(act(pre1 + bc)), eight channels (16 bytes) a thread
    for (int i = tid; i < TP * K8; i += THREADS) {
      const int p = i / K8, c = (i - p * K8) * 8;
      const int row = p0 + p;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row < N)
        raw = *reinterpret_cast<const uint4*>(pre1 + (size_t)row * RK + r * K + c);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __align__(16) __nv_bfloat16 h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] = __float2bfloat16(
            row < N ? act_fn(__bfloat162float(x[j]) + bc[r * K + c + j], act)
                    : 0.f);
      *reinterpret_cast<uint4*>(hs + p * K + c) = *reinterpret_cast<uint4*>(h);
    }
    __syncthreads();

    // pre2 = h1 @ W2 -> staging
    for (int f = warp; f < (TP / 16) * kb; f += WARPS) {
      const int fr = f / kb, fc = f - fr * kb;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < K; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, hs + fr * 16 * K + kk, K);
        wmma::load_matrix_sync(b, w2s + kk * K + fc * 16, K);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stg + fr * 16 * K + fc * 16, acc, K,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // h2 = bf16(act(pre2 + b2)), over h1
    for (int i = tid; i < TP * K; i += THREADS)
      hs[i] = __float2bfloat16(act_fn(stg[i] + b2[i % K], act));
    __syncthreads();

    // heads = h2 @ Wh -> staging as (TP, DP)
    if (warp < TP / 16) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < K; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, hs + warp * 16 * K + kk, K);
        wmma::load_matrix_sync(b, whs + kk * DP, DP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stg + warp * 16 * DP, acc, DP,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < TP * D; i += THREADS) {
      const int p = i / D, d = i - p * D;
      const int row = p0 + p;
      if (row < N) out[(size_t)row * R * D + r * D + d] = stg[p * DP + d] + bh[d];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tvae_mix_heads_fwd(const void* pre1, const void* bc,
                                  const void* w2, const void* b2,
                                  const void* wh, const void* bh, void* out,
                                  int N, int R, int K, int D, int act,
                                  void* stream) {
  if (K % 16 || D > DP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * K * 2 + (size_t)K * DP * 2 +
                      (size_t)TP * K * 2 + (size_t)TP * K * 4;
  int err = allow_smem(mix_heads_fwd_kernel, smem);
  if (err) return err;
  const int grid = (N + TP - 1) / TP;
  mix_heads_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)pre1, (const float*)bc, (const __nv_bfloat16*)w2,
      (const float*)b2, (const __nv_bfloat16*)wh, (const float*)bh,
      (float*)out, N, R, K, D, act);
  return (int)cudaGetLastError();
}
