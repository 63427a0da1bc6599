// The coordinate-MLP decoder's chain at arbitrary coordinates (K9/K10,
// csrc/decoder_mlp.cu), and the split-K weight-gradient product of K10. Its
// wmma weight gradient serves K10 alone: the pose decoder (K7/K8) and K12's
// dWc run the wgmma kernels of csrc/decoder_wgmma.cuh, which are templated
// on the same feature sources; until K9/K10 move there, the two headers'
// weight-gradient kernels coexist.
//
// A pixel's F Fourier features come from FeatArgs, feature<FEAT>:
//   FEAT_COORD: bf16(cos(x0 wf[0, f] + x1 wf[1, f] + bf[f])) at the pixel's
//               own coordinates x (B, npx, 2), accurate cosf: at
//               sigma = 2/49 the phase reaches tens of radians
//   FEAT_NONE:  a stored bf16 matrix (the weight-gradient product only)
// products and sums taken without FMA contraction, so they round as the
// plain versions' do.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int TPX = 32;         // pixels per block of the chain kernels
constexpr int FC = 32;          // rows of W1 / Wh staged per step
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;

constexpr int FEAT_NONE = 0, FEAT_COORD = 2;

// where the features of a pixel come from; unused pointers are null
struct FeatArgs {
  const float *X, *WF, *BF;     // FEAT_COORD: x (B*npx, 2), wf (2, F), bf (F)
};

// FEAT_COORD: the phase x0 wf[0, f] + x1 wf[1, f] + bf[f] and its cosine
__device__ __forceinline__ float coord_phase(const FeatArgs& fa, float x0,
                                             float x1, int f, int F) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, fa.WF[f]), __fmul_rn(x1, fa.WF[F + f])),
                   fa.BF[f]);
}

// feature f of pixel `pix` of image b
template <int FEAT>
__device__ __forceinline__ float feature(const FeatArgs& fa, int b, int npx,
                                         int pix, int f, int F) {
  const float* x = fa.X + ((size_t)b * npx + pix) * 2;
  return cosf(coord_phase(fa, x[0], x[1], f, F));
}

// ---------------------------------------------------------------------------
// Forward (K9). For image b and pixel p:
//   f = features (F); h = bf16(act(f @ W1 + b1 + hz[b]))       W1 (F, H) bf16
//   h = bf16(act(h @ Wh[l] + bh[l]))   for l < L - 1            Wh (L-1, H, H)
//   y = h @ W3 + b3                                             W3 (H, n_out)
// with f32 accumulation everywhere.
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
// layers, and the n_out heads are warp-reduced dot products. The
// (pixels, F) matrix never reaches device memory.
//
// Save-residuals mode (training): with a non-null hs_out the kernel also
// writes each layer's bf16 h tile, L tiles of (B, npx, H), for the backward.
// Serving passes null and writes nothing extra.
template <int H, int FEAT>
__global__ void __launch_bounds__(THREADS, 2) decoder_fwd_kernel(
    FeatArgs fa, const float* __restrict__ hz,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bh,
    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ y, __nv_bfloat16* __restrict__ hs_out, int npx, int F,
    int L, int n_out, int act) {
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
  const int t0 = blockIdx.x * TPX;
  const int fr = (warp * NPW) / CB;       // this warp's 16-row block
  const int fc0 = (warp * NPW) % CB;      // and its first column block

  // save-residuals mode: copies the bf16 h tile of layer `slot` to
  // hs_out (L, B, npx, H), 16 bytes a thread; rows past the image are not
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
      fs[i] = __float2bfloat16(pix < npx ? feature<FEAT>(fa, b, npx, pix, f, F)
                                         : 0.f);
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

template <int H, int FEAT>
int launch_fwd_h(FeatArgs fa, const void* hz, const void* w1, const void* b1,
                 const void* wh, const void* bh, const void* w3,
                 const void* b3, void* y, void* hs_out, int B, int npx, int F,
                 int L, int n_out, int act, cudaStream_t stream) {
  const size_t smem = (size_t)2 * FC * H * 2 + (size_t)TPX * H * 2 +
                      (size_t)TPX * FC * 2;
  int err = allow_smem(decoder_fwd_kernel<H, FEAT>, smem);
  if (err) return err;
  const dim3 grid((npx + TPX - 1) / TPX, B);
  decoder_fwd_kernel<H, FEAT><<<grid, THREADS, smem, stream>>>(
      fa, (const float*)hz, (const __nv_bfloat16*)w1, (const float*)b1,
      (const __nv_bfloat16*)wh, (const float*)bh, (const __nv_bfloat16*)w3,
      (const float*)b3, (float*)y, (__nv_bfloat16*)hs_out, npx, F, L, n_out,
      act);
  return (int)cudaGetLastError();
}

// the forward for hidden width H in (64, 128, 256, 512); F % FC == 0
template <int FEAT>
int launch_fwd(FeatArgs fa, const void* hz, const void* w1, const void* b1,
               const void* wh, const void* bh, const void* w3, const void* b3,
               void* y, void* hs_out, int B, int npx, int F, int H, int L,
               int n_out, int act, cudaStream_t s) {
  if (F % FC) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 64:
      return launch_fwd_h<64, FEAT>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 128:
      return launch_fwd_h<128, FEAT>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 256:
      return launch_fwd_h<256, FEAT>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 512:
      return launch_fwd_h<512, FEAT>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward chain (K10). From the saved bf16 h tiles, with g16 = bf16(g):
//   db3 = sum g; dW3 = h_{L-1}^T g16; dh = g16 W3^T
//   for l = L-1 .. 1: dpre = dh * act'(h_l); dWh[l-1] = h_{l-1}^T bf16(dpre);
//                     dbh[l-1] = sum dpre;   dh = bf16(dpre) Wh[l-1]^T
//   dpre1 = dh * act'(h_0); db1 = sum dpre1; dhz[b] = its per-image sum
// One block per 32-pixel tile and image: from g down to dpre1 through shared
// memory, the hidden layers' W^T products on nvcuda::wmma fragments (the
// columns of Wh stream through two cp.async buffers). It writes each layer's
// bf16(dpre) tile to device memory (the wgrad products read them) and its
// own partial column sums, dW3 and db3 to one row of `part`:
// part row (image b, tile t) = [column sums of dpre_l, l < L (L*H) |
// dW3 (H*n_out) | db3 (n_out)]; dP: bf16(dpre_l) as (L, B, npx, H).
// Rows past the image are zero.
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

template <int H>
__global__ void __launch_bounds__(THREADS, 2) decoder_bwd_chain_kernel(
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

template <int H>
int launch_chain_h(const void* g, const void* hs, const void* wh,
                   const void* w3, void* dP, void* part, int B, int npx,
                   int L, int n_out, int X, int act, cudaStream_t stream) {
  const size_t smem = (size_t)2 * FC * H * 2 + (size_t)TPX * H * 2 +
                      (size_t)TPX * MAX_OUT * 4;
  int err = allow_smem(decoder_bwd_chain_kernel<H>, smem);
  if (err) return err;
  const dim3 grid((npx + TPX - 1) / TPX, B);
  decoder_bwd_chain_kernel<H><<<grid, THREADS, smem, stream>>>(
      (const float*)g, (const __nv_bfloat16*)hs, (const __nv_bfloat16*)wh,
      (const __nv_bfloat16*)w3, (__nv_bfloat16*)dP, (float*)part, npx, L,
      n_out, X, act);
  return (int)cudaGetLastError();
}

// the chain pass for hidden width H in (64, 128, 256, 512); part holds
// B * ceil(npx / TPX) rows of X = L*H + H*n_out + n_out floats
inline int launch_chain(const void* g, const void* hs, const void* wh,
                        const void* w3, void* dP, void* part, int B, int npx,
                        int H, int L, int n_out, int act, cudaStream_t s) {
  if (n_out < 1 || n_out > MAX_OUT || L < 2) return (int)cudaErrorInvalidValue;
  const int X = L * H + H * n_out + n_out;
  switch (H) {
    case 64:
      return launch_chain_h<64>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
    case 128:
      return launch_chain_h<128>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
    case 256:
      return launch_chain_h<256>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
    case 512:
      return launch_chain_h<512>(g, hs, wh, w3, dP, part, B, npx, L, n_out, X, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Split-K weight gradient: part[z] (M, N) = sum over rows p of split z of
// A(p, m) Bm[p, n], m < M, n < N, Bm a bf16 (P, N) matrix. A is the bf16
// (P, lda) matrix (FEAT_NONE; columns m >= lda read as zero, so M may round
// lda up to the tile), or the features of row p = (b, pix) rebuilt on chip
// (FEAT_COORD; lda unused, M = F). Output tiles of BT x BN,
// BN = 128 where N allows (each feature tile is rebuilt once for each column
// tile, so wider tiles rebuild less); shared-memory rows padded by PAD
// against bank conflicts; nvcuda::wmma fragments with f32 accumulation.
// Each split writes its own partial; csrc/reduce.cu adds them in order, so
// the gradient is deterministic.
constexpr int KP = 32;      // rows per step of the split-K products
constexpr int BT = 64;      // their output tile: BT rows x BT or 2 BT columns
constexpr int PAD = 8;      // shared-memory row padding against bank conflicts

template <int FEAT, int BN>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(
    const __nv_bfloat16* __restrict__ A, FeatArgs fa,
    const __nv_bfloat16* __restrict__ Bm, float* __restrict__ part, int P,
    int M, int N, int chunk, int npx, int lda) {
  constexpr int LDA = BT + PAD, LDB = BN + PAD;
  constexpr int NI = BN / 16;                      // column fragments
  constexpr int FPW = (BT / 16) * NI / WARPS;      // fragments a warp
  __shared__ __align__(128) __nv_bfloat16 As[KP * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[KP * LDB];
  // FEAT_COORD: each row's coordinates, read once a step; ok = 0 past the
  // split
  __shared__ int ok[KP];
  __shared__ float cx0[KP], cx1[KP];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BN;
  const int pbeg = blockIdx.z * chunk;
  const int pend = min(P, pbeg + chunk);
  BwdFragC acc[FPW];
#pragma unroll
  for (int j = 0; j < FPW; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int p0 = pbeg; p0 < pend; p0 += KP) {
    if (FEAT != FEAT_NONE) {
      if (tid < KP) {
        const int p = p0 + tid;
        ok[tid] = p < pend;
        if (p < pend) {
          cx0[tid] = fa.X[(size_t)p * 2];
          cx1[tid] = fa.X[(size_t)p * 2 + 1];
        }
      }
      __syncthreads();
      for (int i = tid; i < KP * BT; i += THREADS) {
        const int pp = i / BT, mm = i - pp * BT;
        float v = 0.f;
        if (ok[pp]) v = cosf(coord_phase(fa, cx0[pp], cx1[pp], m0 + mm, M));
        As[pp * LDA + mm] = __float2bfloat16(v);
      }
    } else {
      for (int i = tid; i < KP * BT / 8; i += THREADS) {
        const int pp = i / (BT / 8), q = (i - pp * (BT / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + pp < pend && m0 + q < lda)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(p0 + pp) * lda + m0 + q);
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

// S splits; M % BT == 0 and N % BT == 0; returns the CUDA error of the launch
template <int FEAT>
int launch_wgrad(const __nv_bfloat16* A, FeatArgs fa, const __nv_bfloat16* Bm,
                 float* part, int P, int M, int N, int S, int npx, int lda,
                 cudaStream_t stream) {
  if (M % BT || N % BT || S < 1) return (int)cudaErrorInvalidValue;
  const int chunk = ((P + S - 1) / S + KP - 1) / KP * KP;
  if (N % (2 * BT) == 0)
    wgrad_kernel<FEAT, 2 * BT><<<dim3(M / BT, N / (2 * BT), S), THREADS, 0,
                                 stream>>>(A, fa, Bm, part, P, M, N, chunk,
                                           npx, lda);
  else
    wgrad_kernel<FEAT, BT><<<dim3(M / BT, N / BT, S), THREADS, 0, stream>>>(
        A, fa, Bm, part, P, M, N, chunk, npx, lda);
  return (int)cudaGetLastError();
}

}  // namespace
