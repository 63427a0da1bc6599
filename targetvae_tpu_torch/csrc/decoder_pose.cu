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
//
// Save-residuals mode (training only; the TPU kernel's save_res=True): with
// a non-null hs_out the kernel also writes each layer's bf16 h tile, L tiles
// of (B, n*n, H), for the backward (K8 below). At the flagship that is
// 2 x 256 MB more writes (~0.15 ms at 3.35 TB/s). Serving passes null and
// writes nothing extra.
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
    const float* __restrict__ b3, float* __restrict__ y,
    __nv_bfloat16* __restrict__ hs_out, int n, int F, int L, int n_out,
    int act) {
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

  // save-residuals mode: copies the bf16 h tile of layer `slot` to
  // hs_out (L, B, n*n, H), 16 bytes a thread; rows past the image are not
  // stored. Called after the barrier that follows the tile's write.
  auto save_h = [&](int slot) {
    __nv_bfloat16* dst = hs_out + ((size_t)slot * gridDim.y + b) * npx * H;
    for (int i = tid; i < TPX * H / 8; i += THREADS) {
      const int p = i / (H / 8), k = (i - p * (H / 8)) * 8;
      if (t0 + p < npx)
        *reinterpret_cast<uint4*>(dst + (size_t)(t0 + p) * H + k) =
            *reinterpret_cast<const uint4*>(hs + p * H + k);
    }
  };

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
  if (hs_out) save_h(0);

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
    if (hs_out) save_h(l + 1);
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
           const void* bh, const void* w3, const void* b3, void* y,
           void* hs_out, int B, int n, int F, int L, int n_out, int act,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * FC * H * 2 + (size_t)TPX * H * 2 +
                      (size_t)TPX * FC * 2;
  int err = allow_smem(pose_decoder_fwd_kernel<H>, smem);
  if (err) return err;
  const dim3 grid((n * n + TPX - 1) / TPX, B);
  pose_decoder_fwd_kernel<H><<<grid, THREADS, smem, stream>>>(
      (const float*)u, (const float*)v, (const float*)p, (const float*)q,
      (const float*)hz, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)wh, (const float*)bh, (const __nv_bfloat16*)w3,
      (const float*)b3, (float*)y, (__nv_bfloat16*)hs_out, n, F, L, n_out,
      act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: the backward of K7.
//
// Replaces targetvae_tpu/kernels/decoder_pose.py::_bwd_kernel, the Pallas
// kernel of _bwd. It consumes the bf16 h tiles K7 saved (the JAX contract,
// _vjp_fwd) and, with g16 = bf16(g), computes
//   db3 = sum g; dW3 = h_{L-1}^T g16; dh = g16 W3^T
//   for l = L-1 .. 1: dpre = dh * act'(h_l); dWh[l-1] = h_{l-1}^T bf16(dpre);
//                     dbh[l-1] = sum dpre;   dh = bf16(dpre) Wh[l-1]^T
//   dpre1 = dh * act'(h_0); db1 = sum dpre1; dhz[b] = its per-image sum
//   dW1 = features^T bf16(dpre1), features = bf16(U P - V Q) rebuilt on chip
//   T = (bf16(dpre1) W1^T) * (V P + U Q), reduced over the pixels against
//   (1, gx, gy) into dfc, dfx, dfy (B, F), negated
// (T is the phase cotangent: d cos(ax + ay) = -sin(ax + ay), and
// sin(ax + ay) = V P + U Q). The caller closes dfx/dfy/dfc into dtheta and
// d(dx) with O(B F) work. The (pixels, F) matrices never reach device
// memory.
//
// What bounds it on the H100: the tensor cores. At the flagship shape
// (B = 100, n = 50, F = 1024, H = 512, L = 2) dW1 and the phase product are
// 2 * 250,000 * 1024 * 512 = 262 GFLOP each and the hidden layer's pair
// another 262: ~0.79 TFLOP, >= 0.8 ms at the bf16 peak, against ~0.6 GB of
// traffic (the saved h tiles, the tables, the bf16 dpre tiles it writes
// and reads back).
//
// Design. The TPU kernel carries every weight gradient across its
// sequential grid; CUDA blocks run in no order, and dW1 alone is 2 MB of
// f32, so the work is cut into passes, all of them deterministic:
//  1. chain (one block per 32-pixel tile and image, as K7): from g down to
//     dpre1, through shared memory, with the hidden layers' W^T products on
//     nvcuda::wmma fragments (the columns of Wh stream through two cp.async
//     buffers). It writes each layer's bf16(dpre) tile to device memory and
//     its own partial column sums, dW3 and db3 to one row of `part`.
//  2. csrc/reduce.cu adds the rows in order: per image (dhz), then over
//     the batch (db1, dbh, dW3, db3).
//  3. wgrad: the split-K products dW1 = features^T bf16(dpre1) (the
//     feature tile rebuilt from U, V, P, Q in shared memory, as in K7) and
//     dWh[l-1] = h_{l-1}^T bf16(dpre_l), 64 x 128 output tiles on wmma
//     fragments, each split writing its own partial, then summed in order.
//  4. pose: one block per (64 features, image), the image's U, V, P, Q
//     columns for them in shared memory, walks the image's pixels 32 at a
//     time: the (32 x H) x (H x 64) phase product on wmma fragments, then T
//     and its three weighted sums, each thread one feature and a quarter of
//     the pixels, the quarters added in order at the end.
// So a rerun gives bitwise the same gradients, and the tolerance against
// the plain version is that of two f32 summation orders over bf16 operands.
constexpr int KP = 32;      // pixels per step of the split-K products
constexpr int BT = 64;      // their output tile: BT rows x BT or 2 BT columns
constexpr int PAD = 8;      // shared-memory row padding against bank conflicts
constexpr int FB = 64;      // features per block of the pose reduction
constexpr int PT = 32;      // pixels per step of the pose reduction
constexpr int PG = THREADS / FB;   // its pixel groups: thread = (group, feature)
constexpr int MAX_OUT = 8;  // n_out the chain pass holds in shared memory

using BwdFragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using BwdFragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                 wmma::col_major>;
using BwdFragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using BwdFragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                 wmma::col_major>;
using BwdFragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// pass 1. part row (image b, tile t) = [column sums of dpre_l, l < L (L*H) |
// dW3 (H*n_out) | db3 (n_out)]; dP: bf16(dpre_l) as (L, B, n*n, H).
template <int H>
__global__ void __launch_bounds__(THREADS, 2) pose_bwd_chain_kernel(
    const float* __restrict__ g, const __nv_bfloat16* __restrict__ hs,
    const __nv_bfloat16* __restrict__ wh, const __nv_bfloat16* __restrict__ w3,
    __nv_bfloat16* __restrict__ dP, float* __restrict__ part, int npx, int L,
    int n_out, int X, int act) {
  constexpr int CB = H / 16;
  constexpr int NPW = (2 * CB) / WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  // [chunk buffers 2*FC*H bf16, aliased by the staging tile TPX*H f32 |
  //  bf16(dpre) TPX*H | g TPX*MAX_OUT f32]
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage = reinterpret_cast<float*>(smem);
  __nv_bfloat16* dps = wbuf + 2 * FC * H;
  float* gsm = reinterpret_cast<float*>(dps + TPX * H);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TPX;
  const size_t plane = (size_t)gridDim.y * npx * H;
  const size_t base = (size_t)b * npx * H;
  float* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * X;
  const int fr = (warp * NPW) / CB;
  const int fc0 = (warp * NPW) % CB;

  for (int i = tid; i < TPX * n_out; i += THREADS) {
    const int p = i / n_out, c = i - p * n_out;
    gsm[i] = t0 + p < npx ? g[((size_t)b * npx + t0 + p) * n_out + c] : 0.f;
  }
  __syncthreads();

  // db3; dW3 = h_{L-1}^T g16, one thread per entry, pixels in order
  const __nv_bfloat16* hl = hs + (size_t)(L - 1) * plane + base;
  for (int c = tid; c < n_out; c += THREADS) {
    float s = 0.f;
    for (int p = 0; p < TPX; ++p) s += gsm[p * n_out + c];
    pb[L * H + H * n_out + c] = s;
  }
  for (int i = tid; i < H * n_out; i += THREADS) {
    const int k = i / n_out, c = i - k * n_out;
    float s = 0.f;
    for (int p = 0; p < TPX && t0 + p < npx; ++p)
      s = fmaf(__bfloat162float(hl[(size_t)(t0 + p) * H + k]),
               bf16_round(gsm[p * n_out + c]), s);
    pb[L * H + i] = s;
  }
  // dh = g16 W3^T -> staging
  for (int i = tid; i < TPX * H; i += THREADS) {
    const int p = i / H, k = i - p * H;
    float s = 0.f;
    for (int c = 0; c < n_out; ++c)
      s = fmaf(bf16_round(gsm[p * n_out + c]),
               __bfloat162float(w3[k * n_out + c]), s);
    stage[i] = s;
  }
  __syncthreads();

  // starts the copy of columns [j0, j0 + FC) of every row of an (H, H)
  // bf16 matrix into chunk buffer `slot` as (H, FC), 16 bytes a thread
  auto load_cols = [&](const __nv_bfloat16* src, int j0, int slot) {
    __nv_bfloat16* d = wbuf + slot * FC * H;
    for (int i = tid; i < H * (FC / 8); i += THREADS) {
      const int k = i / (FC / 8), q = (i - k * (FC / 8)) * 8;
      cp_async16(d + k * FC + q, src + (size_t)k * H + j0 + q);
    }
    cp_async_commit();
  };
  auto wait_chunk = [&](int c, int nch) {
    if (c + 1 < nch) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
  };

  BwdFragC acc[NPW];
  BwdFragA a;
  BwdFragBc bfr;
  const int nch = H / FC;
  for (int l = L - 1; l >= 0; --l) {
    const __nv_bfloat16* hlay = hs + (size_t)l * plane + base + (size_t)t0 * H;
    __nv_bfloat16* dl = dP + (size_t)l * plane + base + (size_t)t0 * H;
    // dpre = dh * act'(h_l): f32 in staging, bf16 in shared and device memory
    for (int i = tid; i < TPX * H; i += THREADS) {
      const bool in = t0 + i / H < npx;
      const float v =
          in ? stage[i] * dact_from_h(__bfloat162float(hlay[i]), act) : 0.f;
      stage[i] = v;
      const __nv_bfloat16 v16 = __float2bfloat16(v);
      dps[i] = v16;
      if (in) dl[i] = v16;
    }
    __syncthreads();
    for (int k = tid; k < H; k += THREADS) {
      float s = 0.f;
      for (int p = 0; p < TPX; ++p) s += stage[p * H + k];
      pb[l * H + k] = s;
    }
    if (l == 0) break;
    __syncthreads();   // the staging tile is about to take the chunk loads

    // dh = bf16(dpre) Wh[l-1]^T, the contraction streamed FC columns at a time
    const __nv_bfloat16* wl = wh + (size_t)(l - 1) * H * H;
#pragma unroll
    for (int k = 0; k < NPW; ++k) wmma::fill_fragment(acc[k], 0.f);
    load_cols(wl, 0, 0);
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) load_cols(wl, (c + 1) * FC, (c + 1) & 1);
      wait_chunk(c, nch);
      const __nv_bfloat16* wc = wbuf + (c & 1) * FC * H;
#pragma unroll
      for (int kk = 0; kk < FC; kk += 16) {
        wmma::load_matrix_sync(a, dps + fr * 16 * H + c * FC + kk, H);
#pragma unroll
        for (int k = 0; k < NPW; ++k) {
          wmma::load_matrix_sync(bfr, wc + (fc0 + k) * 16 * FC + kk, FC);
          wmma::mma_sync(acc[k], a, bfr, acc[k]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NPW; ++k)
      wmma::store_matrix_sync(stage + fr * 16 * H + (fc0 + k) * 16, acc[k], H,
                              wmma::mem_row_major);
    __syncthreads();
  }
}

// pass 3. part[z] (M, N) = sum over pixels p of this split of A(p, m) Bm[p, n]:
// A is the bf16 (P, M) matrix, or with FEAT the features
// bf16(U[b, j] P[b, i] - V[b, j] Q[b, i]) of pixel p = (b, i, j), M = F.
// Output tiles of BT x BN, BN = 128 where N allows (each feature tile is
// rebuilt once for each column tile, so wider tiles rebuild less).
template <bool FEAT, int BN>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(
    const __nv_bfloat16* __restrict__ A, const float* __restrict__ U,
    const float* __restrict__ V, const float* __restrict__ Pt,
    const float* __restrict__ Q, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ part, int P, int M, int N, int chunk, int n) {
  constexpr int LDA = BT + PAD, LDB = BN + PAD;
  constexpr int NI = BN / 16;                      // column fragments
  constexpr int FPW = (BT / 16) * NI / WARPS;      // fragments a warp
  __shared__ __align__(128) __nv_bfloat16 As[KP * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[KP * LDB];
  __shared__ int offj[KP], offi[KP];   // FEAT: each pixel's table rows j, i
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BN;
  const int pbeg = blockIdx.z * chunk;
  const int pend = min(P, pbeg + chunk);
  const int npx = n * n;
  BwdFragC acc[FPW];
#pragma unroll
  for (int j = 0; j < FPW; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int p0 = pbeg; p0 < pend; p0 += KP) {
    if (FEAT) {
      if (tid < KP) {
        const int p = p0 + tid;
        int oj = -1, oi = -1;
        if (p < pend) {
          const int b = p / npx, pix = p - b * npx;
          const int row = pix / n, col = pix - row * n;
          oj = (b * n + col) * M + m0;
          oi = (b * n + row) * M + m0;
        }
        offj[tid] = oj;
        offi[tid] = oi;
      }
      __syncthreads();
      for (int i = tid; i < KP * BT; i += THREADS) {
        const int pp = i / BT, mm = i - pp * BT;
        float v = 0.f;
        if (offj[pp] >= 0) {
          const int jc = offj[pp] + mm, ir = offi[pp] + mm;
          v = __fsub_rn(__fmul_rn(U[jc], Pt[ir]), __fmul_rn(V[jc], Q[ir]));
        }
        As[pp * LDA + mm] = __float2bfloat16(v);
      }
    } else {
      for (int i = tid; i < KP * BT / 8; i += THREADS) {
        const int pp = i / (BT / 8), q = (i - pp * (BT / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + pp < pend)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(p0 + pp) * M + m0 + q);
        *reinterpret_cast<uint4*>(As + pp * LDA + q) = v;
      }
    }
    for (int i = tid; i < KP * BN / 8; i += THREADS) {
      const int pp = i / (BN / 8), q = (i - pp * (BN / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + pp < pend)
        v = *reinterpret_cast<const uint4*>(Bm + (size_t)(p0 + pp) * N + n0 + q);
      *reinterpret_cast<uint4*>(Bs + pp * LDB + q) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KP; kk += 16) {
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        const int f = warp * FPW + j, mi = f / NI, ni = f % NI;
        BwdFragAc a;
        BwdFragB b;
        wmma::load_matrix_sync(a, As + kk * LDA + mi * 16, LDA);
        wmma::load_matrix_sync(b, Bs + kk * LDB + ni * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    const int f = warp * FPW + j, mi = f / NI, ni = f % NI;
    wmma::store_matrix_sync(
        part + ((size_t)blockIdx.z * M + m0 + mi * 16) * N + n0 + ni * 16,
        acc[j], N, wmma::mem_row_major);
  }
}

// splits = S; returns the CUDA error of the launch
template <bool FEAT>
int launch_wgrad(const __nv_bfloat16* A, const float* U, const float* V,
                 const float* Pt, const float* Q, const __nv_bfloat16* Bm,
                 float* part, int P, int M, int N, int S, int n,
                 cudaStream_t stream) {
  const int chunk = ((P + S - 1) / S + KP - 1) / KP * KP;
  if (N % (2 * BT) == 0)
    wgrad_kernel<FEAT, 2 * BT><<<dim3(M / BT, N / (2 * BT), S), THREADS, 0,
                                 stream>>>(A, U, V, Pt, Q, Bm, part, P, M, N,
                                           chunk, n);
  else
    wgrad_kernel<FEAT, BT><<<dim3(M / BT, N / BT, S), THREADS, 0, stream>>>(
        A, U, V, Pt, Q, Bm, part, P, M, N, chunk, n);
  return (int)cudaGetLastError();
}

// pass 4. dfc, dfx, dfy (B, F) for features [f0, f0 + FB) of image b. The
// image's U, V, P, Q columns for these features sit in shared memory; each
// thread owns one feature and one of PG pixel groups, and the groups' sums
// are added in order at the end.
__global__ void __launch_bounds__(THREADS) pose_reduce_kernel(
    const __nv_bfloat16* __restrict__ dP0, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ Pt, const float* __restrict__ Q,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dfc,
    int n, int F, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [W1 rows f0.. FB*LDH bf16 | bf16(dpre1) tile PT*LDH bf16 | product
  //  PT*FB | U, V, P, Q columns 4*n*FB | gx, gy 2*n | group sums 3*PG*FB
  //  (f32)]; rows padded to LDH = H + PAD against bank conflicts
  const int LDH = H + PAD;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = w1s + FB * LDH;
  float* stg = reinterpret_cast<float*>(ds + PT * LDH);
  float* tu = stg + PT * FB;
  float* tv = tu + n * FB;
  float* tp = tv + n * FB;
  float* tq = tp + n * FB;
  float* sgx = tq + n * FB;
  float* sgy = sgx + n;
  float* red = sgy + n;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int f0 = blockIdx.x * FB, b = blockIdx.y;
  const int npx = n * n;
  const int H8 = H / 8;
  for (int i = tid; i < FB * H8; i += THREADS) {
    const int r = i / H8, q = (i - r * H8) * 8;
    *reinterpret_cast<uint4*>(w1s + r * LDH + q) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)(f0 + r) * H + q);
  }
  for (int i = tid; i < n * FB; i += THREADS) {
    const int r = i / FB, ff = i - r * FB;
    const size_t src = ((size_t)b * n + r) * F + f0 + ff;
    tu[i] = U[src];
    tv[i] = V[src];
    tp[i] = Pt[src];
    tq[i] = Q[src];
  }
  for (int i = tid; i < n; i += THREADS) {
    sgx[i] = gx[i];
    sgy[i] = gy[i];
  }
  const int grp = tid / FB, ff = tid - grp * FB;
  const __nv_bfloat16* db = dP0 + (size_t)b * npx * H;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
  for (int t0 = 0; t0 < npx; t0 += PT) {
    for (int i = tid; i < PT * H8; i += THREADS) {
      const int pp = i / H8, q = (i - pp * H8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + pp < npx)
        v = *reinterpret_cast<const uint4*>(db + (size_t)(t0 + pp) * H + q);
      *reinterpret_cast<uint4*>(ds + pp * LDH + q) = v;
    }
    __syncthreads();
    // df3 = bf16(dpre1) W1^T for these pixels and features: (PT/16) x
    // (FB/16) fragments, one a warp
    {
      const int mi = warp / (FB / 16), ni = warp % (FB / 16);
      BwdFragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < H; kk += 16) {
        BwdFragA a;
        BwdFragBc bm;
        wmma::load_matrix_sync(a, ds + mi * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(bm, w1s + ni * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(stg + mi * 16 * FB + ni * 16, acc, FB,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int p = grp; p < PT && t0 + p < npx; p += PG) {
      const int pix = t0 + p, i = pix / n, j = pix - i * n;
      const float s = __fadd_rn(__fmul_rn(tv[j * FB + ff], tp[i * FB + ff]),
                                __fmul_rn(tu[j * FB + ff], tq[i * FB + ff]));
      const float t = __fmul_rn(stg[p * FB + ff], s);
      r0 += t;
      r1 += __fmul_rn(sgx[j], t);
      r2 += __fmul_rn(sgy[i], t);
    }
    __syncthreads();
  }
  red[(grp * 3 + 0) * FB + ff] = r0;
  red[(grp * 3 + 1) * FB + ff] = r1;
  red[(grp * 3 + 2) * FB + ff] = r2;
  __syncthreads();
  if (tid < 3 * FB) {
    const int k = tid / FB, f = tid - k * FB;
    float sum = 0.f;
    for (int g = 0; g < PG; ++g) sum += red[(g * 3 + k) * FB + f];
    float* o = k == 0 ? dfc : (k == 1 ? dfx : dfy);
    o[(size_t)b * F + f0 + f] = -sum;
  }
}

template <int H>
int launch_chain(const void* g, const void* hs, const void* wh,
                 const void* w3, void* dP, void* part, int B, int npx, int L,
                 int n_out, int X, int act, cudaStream_t stream) {
  const size_t smem = (size_t)2 * FC * H * 2 + (size_t)TPX * H * 2 +
                      (size_t)TPX * MAX_OUT * 4;
  int err = allow_smem(pose_bwd_chain_kernel<H>, smem);
  if (err) return err;
  const dim3 grid((npx + TPX - 1) / TPX, B);
  pose_bwd_chain_kernel<H><<<grid, THREADS, smem, stream>>>(
      (const float*)g, (const __nv_bfloat16*)hs, (const __nv_bfloat16*)wh,
      (const __nv_bfloat16*)w3, (__nv_bfloat16*)dP, (float*)part, npx, L,
      n_out, X, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tvae_pose_decoder_fwd(const void* u, const void* v,
                                     const void* p, const void* q,
                                     const void* hz, const void* w1,
                                     const void* b1, const void* wh,
                                     const void* bh, const void* w3,
                                     const void* b3, void* y, void* hs_out,
                                     int B, int n, int F, int H, int L,
                                     int n_out, int act, void* stream) {
  if (F % FC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 64:
      return launch<64>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, n, F, L, n_out, act, s);
    case 128:
      return launch<128>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, n, F, L, n_out, act, s);
    case 256:
      return launch<256>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, n, F, L, n_out, act, s);
    case 512:
      return launch<512>(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, n, F, L, n_out, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of K7 (passes in the comment above K8). Inputs: u, v, p, q
// (B, n, F) f32; w1 (F, H), wh (L-1, H, H), w3 (H, n_out) bf16; g
// (B, n*n, n_out) f32; hs (L, B, n*n, H) bf16 saved by the forward; gx, gy
// (n,) f32. Scratch: dP (L, B, n*n, H) bf16; part (B * tiles, X) f32 with
// X = L*H + H*n_out + n_out and tiles = ceil(n*n / 32); gpart
// (max(S1 F H, S2 H H),) f32. Outputs: cols_img (B, X) per-image sums (dhz in
// its first H columns), cols (X,) the batch sums [db1 | dbh | dW3 | db3],
// dfx, dfy, dfc (B, F), dw1 (F, H), dwh (L-1, H, H), all f32. S1, S2 are
// the pixel splits of the dW1 and dWh products.
extern "C" int tvae_pose_decoder_bwd(
    const void* u, const void* v, const void* p, const void* q,
    const void* w1, const void* wh, const void* w3, const void* g,
    const void* hs, const void* gx, const void* gy, void* dP, void* part,
    void* cols_img, void* cols, void* gpart, void* dfx, void* dfy, void* dfc,
    void* dw1, void* dwh, int B, int n, int F, int H, int L, int n_out,
    int S1, int S2, int act, void* stream) {
  if (F % BT || H % BT || n_out < 1 || n_out > MAX_OUT || L < 2 || S1 < 1 ||
      S2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int npx = n * n, P = B * npx;
  const int ntiles = (npx + TPX - 1) / TPX;
  const int X = L * H + H * n_out + n_out;
  const size_t plane = (size_t)B * npx * H;
  const __nv_bfloat16* hsb = (const __nv_bfloat16*)hs;
  __nv_bfloat16* dPb = (__nv_bfloat16*)dP;
  int err;
  switch (H) {
    case 64:
      err = launch_chain<64>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
      break;
    case 128:
      err = launch_chain<128>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
      break;
    case 256:
      err = launch_chain<256>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
      break;
    case 512:
      err = launch_chain<512>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  if ((err = sum_partials((const float*)part, (float*)cols_img, B, ntiles, X, s)))
    return err;
  if ((err = sum_partials((const float*)cols_img, (float*)cols, 1, B, X, s)))
    return err;

  if ((err = launch_wgrad<true>(nullptr, (const float*)u, (const float*)v,
                                 (const float*)p, (const float*)q, dPb,
                                 (float*)gpart, P, F, H, S1, n, s)))
    return err;
  if ((err = sum_partials((const float*)gpart, (float*)dw1, 1, S1, F * H, s)))
    return err;
  for (int l = 1; l < L; ++l) {
    if ((err = launch_wgrad<false>(hsb + (size_t)(l - 1) * plane, nullptr,
                                   nullptr, nullptr, nullptr,
                                   dPb + (size_t)l * plane, (float*)gpart, P,
                                   H, H, S2, n, s)))
      return err;
    if ((err = sum_partials((const float*)gpart,
                            (float*)dwh + (size_t)(l - 1) * H * H, 1, S2,
                            H * H, s)))
      return err;
  }

  const size_t smem = ((size_t)FB + PT) * (H + PAD) * 2 +
                      ((size_t)PT * FB + 4 * (size_t)n * FB + 2 * n +
                       3 * PG * FB) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;   // n above ~115
  if ((err = allow_smem(pose_reduce_kernel, smem))) return err;
  pose_reduce_kernel<<<dim3(F / FB, B), THREADS, smem, s>>>(
      dPb, (const __nv_bfloat16*)w1, (const float*)u, (const float*)v,
      (const float*)p, (const float*)q, (const float*)gx, (const float*)gy,
      (float*)dfx, (float*)dfy, (float*)dfc, n, F, H);
  return (int)cudaGetLastError();
}
