// K7: pose-aware fused decoder, forward.
//
// Replaces the forward of targetvae_tpu/kernels/decoder_pose.py
// (_fwd_kernel with save_res=False), the Pallas kernel behind
// fused_pose_decoder. For image b and pixel (i, j) of the n x n grid:
//   f     = bf16(U[b, j] * P[b, i] - V[b, j] * Q[b, i])        (F features)
//   h     = bf16(act(f @ W1 + b1 + hz[b]))                     W1 (F, H) bf16
//   h     = bf16(act(h @ Wh[l] + bh[l]))   for l < L - 1       Wh (L-1, H, H) bf16
//   y     = h @ W3 + b3                                        W3 (H, n_out) bf16
// with f32 accumulation everywhere; U, V, P, Q (B, n, F) f32 are built in
// plain PyTorch outside the kernel (kernels/decoder_pose.py::pose_tables).
//
// What bounds it on the H100: the tensor cores. At the flagship shape
// (B = 100, n = 50, F = 1024, H = 512, L = 2) it does about 0.39 TFLOP per
// batch, while its own device-memory traffic is ~80 MB of tables and 1 MB of
// output; the unfused form would write and read a 1 GB (pixels, F) feature
// matrix.
//
// Design: one block per (pixel tile of 32, image), 8 warps, two blocks per
// SM. The feature tile is rebuilt in shared memory as bf16, 32 features at a
// time, beside the matching 32 rows of W1; the row chunks of W1 (and of each
// Wh) stream through two shared-memory buffers with cp.async, the next chunk
// in flight while the tensor cores work on the current one. nvcuda::wmma
// 16x16x16 bf16 fragments accumulate the 32 x H product in registers (each
// warp owns one 16-row block and H/64 column blocks). Bias, hz and the
// activation are applied through an f32 staging tile that reuses the two
// chunk buffers, the bf16 h tile stays in shared memory for the hidden
// layers, and the n_out heads are warp-reduced dot products. The features
// are products taken without FMA contraction, so they round exactly as the
// plain version's. The (pixels, F) matrix never reaches device memory.
// wgmma/TMA and a larger pixel tile (each block re-reads W1 from L2) are
// later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TPX = 32;         // pixels per block
constexpr int FC = 32;          // rows of W1 / Wh staged per step
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int H>
__global__ void __launch_bounds__(THREADS, 2) pose_decoder_fwd_kernel(
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ P, const float* __restrict__ Q,
    const float* __restrict__ hz, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ wh,
    const float* __restrict__ bh, const __nv_bfloat16* __restrict__ w3,
    const float* __restrict__ b3, float* __restrict__ y, int n, int F, int L,
    int n_out, int act) {
  constexpr int CB = H / 16;              // column blocks
  constexpr int NPW = (2 * CB) / WARPS;   // fragments per warp (= H / 64)
  static_assert(TPX * 4 == 2 * FC * 2, "staging must fit the two chunk buffers");
  extern __shared__ __align__(128) unsigned char smem[];
  // [chunk buffers 2*FC*H bf16, aliased by the staging tile TPX*H f32 |
  //  hs TPX*H bf16 | fs TPX*FC bf16]
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage = reinterpret_cast<float*>(smem);
  __nv_bfloat16* hs = wbuf + 2 * FC * H;
  __nv_bfloat16* fs = hs + TPX * H;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int npx = n * n;
  const int t0 = blockIdx.x * TPX;
  const float* Ub = U + (size_t)b * n * F;
  const float* Vb = V + (size_t)b * n * F;
  const float* Pb = P + (size_t)b * n * F;
  const float* Qb = Q + (size_t)b * n * F;
  const int fr = (warp * NPW) / CB;       // this warp's 16-row block
  const int fc0 = (warp * NPW) % CB;      // and its first column block

  // starts the copy of rows [r0, r0 + FC) of a (rows, H) bf16 matrix into
  // chunk buffer `slot`, 16 bytes a thread
  auto load_rows = [&](const __nv_bfloat16* src, int r0, int slot) {
    const __nv_bfloat16* s = src + (size_t)r0 * H;
    __nv_bfloat16* d = wbuf + slot * FC * H;
    for (int i = tid; i < FC * H / 8; i += THREADS) cp_async16(d + i * 8, s + i * 8);
    cp_async_commit();
  };
  // waits for chunk c of nch (the only other group in flight is chunk c+1)
  auto wait_chunk = [&](int c, int nch) {
    if (c + 1 < nch) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NPW];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;

  // ---- layer 1: features @ W1 ----
#pragma unroll
  for (int k = 0; k < NPW; ++k) wmma::fill_fragment(acc[k], 0.f);
  const int nch1 = F / FC;
  load_rows(w1, 0, 0);
  for (int c = 0; c < nch1; ++c) {
    if (c + 1 < nch1) load_rows(w1, (c + 1) * FC, (c + 1) & 1);
    const int f0 = c * FC;
    for (int i = tid; i < TPX * FC; i += THREADS) {
      const int p = i / FC, f = f0 + (i - p * FC);
      const int pix = t0 + p;
      float v = 0.f;
      if (pix < npx) {
        const int row = pix / n, col = pix - row * n;
        v = __fsub_rn(__fmul_rn(Ub[col * F + f], Pb[row * F + f]),
                      __fmul_rn(Vb[col * F + f], Qb[row * F + f]));
      }
      fs[i] = __float2bfloat16(v);
    }
    wait_chunk(c, nch1);
    const __nv_bfloat16* wc = wbuf + (c & 1) * FC * H;
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      wmma::load_matrix_sync(a, fs + fr * 16 * FC + kk, FC);
#pragma unroll
      for (int k = 0; k < NPW; ++k) {
        wmma::load_matrix_sync(bf, wc + kk * H + (fc0 + k) * 16, H);
        wmma::mma_sync(acc[k], a, bf, acc[k]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < NPW; ++k)
    wmma::store_matrix_sync(stage + fr * 16 * H + (fc0 + k) * 16, acc[k], H,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TPX * H; i += THREADS) {
    const int c = i % H;
    hs[i] = __float2bfloat16(act_fn(stage[i] + b1[c] + hz[(size_t)b * H + c], act));
  }
  __syncthreads();

  // ---- hidden layers ----
  const int nch = H / FC;
  for (int l = 0; l < L - 1; ++l) {
    const __nv_bfloat16* wl = wh + (size_t)l * H * H;
#pragma unroll
    for (int k = 0; k < NPW; ++k) wmma::fill_fragment(acc[k], 0.f);
    load_rows(wl, 0, 0);
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) load_rows(wl, (c + 1) * FC, (c + 1) & 1);
      wait_chunk(c, nch);
      const __nv_bfloat16* wc = wbuf + (c & 1) * FC * H;
#pragma unroll
      for (int kk = 0; kk < FC; kk += 16) {
        wmma::load_matrix_sync(a, hs + fr * 16 * H + c * FC + kk, H);
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
          wmma::load_matrix_sync(bf, wc + kk * H + (fc0 + k) * 16, H);
          wmma::mma_sync(acc[k], a, bf, acc[k]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NPW; ++k)
      wmma::store_matrix_sync(stage + fr * 16 * H + (fc0 + k) * 16, acc[k], H,
                              wmma::mem_row_major);
    __syncthreads();
    const float* bl = bh + (size_t)l * H;
    for (int i = tid; i < TPX * H; i += THREADS)
      hs[i] = __float2bfloat16(act_fn(stage[i] + bl[i % H], act));
    __syncthreads();
  }

  // ---- output heads: one warp per (pixel, channel) ----
  for (int o = warp; o < TPX * n_out; o += WARPS) {
    const int p = o / n_out, c = o - p * n_out;
    const int pix = t0 + p;
    if (pix >= npx) continue;
    float s = 0.f;
    for (int k = lane; k < H; k += 32)
      s = fmaf(__bfloat162float(hs[p * H + k]),
               __bfloat162float(w3[k * n_out + c]), s);
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) y[((size_t)b * npx + pix) * n_out + c] = s + b3[c];
  }
}

template <int H>
int launch(const void* u, const void* v, const void* p, const void* q,
           const void* hz, const void* w1, const void* b1, const void* wh,
           const void* bh, const void* w3, const void* b3, void* y, int B,
           int n, int F, int L, int n_out, int act, cudaStream_t stream) {
  const size_t smem = (size_t)2 * FC * H * 2 + (size_t)TPX * H * 2 +
                      (size_t)TPX * FC * 2;
  int err = allow_smem(pose_decoder_fwd_kernel<H>, smem);
  if (err) return err;
  const dim3 grid((n * n + TPX - 1) / TPX, B);
  pose_decoder_fwd_kernel<H><<<grid, THREADS, smem, stream>>>(
      (const float*)u, (const float*)v, (const float*)p, (const float*)q,
      (const float*)hz, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)wh, (const float*)bh, (const __nv_bfloat16*)w3,
      (const float*)b3, (float*)y, n, F, L, n_out, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tvae_pose_decoder_fwd(const void* u, const void* v,
                                     const void* p, const void* q,
                                     const void* hz, const void* w1,
                                     const void* b1, const void* wh,
                                     const void* bh, const void* w3,
                                     const void* b3, void* y, int B, int n,
                                     int F, int H, int L, int n_out, int act,
                                     void* stream) {
  if (F % FC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 64:
      return launch<64>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, B, n, F, L, n_out, act, s);
    case 128:
      return launch<128>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, B, n, F, L, n_out, act, s);
    case 256:
      return launch<256>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, B, n, F, L, n_out, act, s);
    case 512:
      return launch<512>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, B, n, F, L, n_out, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
