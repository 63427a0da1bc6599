// K11: the fused patch encoder (lift GEMM + activation + mixing + heads),
// forward.
//
// Replaces targetvae_tpu/kernels/lifted_encoder.py::_fwd_kernel, the Pallas
// kernel behind fused_lifted_encoder (TARGETVAE_ENCODER_TIER=patch). Per
// position p (a row of the im2col patch matrix P, (N, CK) bf16, built
// outside the kernel) and rotation r:
//   pre1 = P[p] @ Wc[:, r*K:(r+1)*K] + bc_r     Wc (CK, R*K) bf16, f32 sum
//   h1   = bf16(act(pre1))                      (saved when training)
//   h2   = bf16(act(h1 @ W2 + b2))              W2 (K, K) bf16
//   out[p, r*D:(r+1)*D] = h2 @ Wh + bh          Wh (K, D) bf16
//
// What bounds it on the H100: the tensor cores. At the flagship (N =
// 152,100 positions, CK = 784, R = 8, K = 128, D = 7) the lift GEMM is
// 0.244 TFLOP and mixing and heads another 0.04: ~0.29 ms at the bf16 peak,
// against 238 MB of P read, 36 MB of output and, in save-h1 mode, 311 MB of
// h1 written (0.08 / 0.17 ms at 3.35 TB/s).
//
// Design: one block per tile of 64 positions, 8 warps, two blocks per SM.
// W2 and Wh stay in shared memory for the block's life. For each rotation
// the lift GEMM streams the P tile and the matching Wc columns through two
// shared-memory buffers in chunks of 32 columns (cp.async, the next chunk in
// flight while the tensor cores work on the current one), so any CK works
// (the galaxy encoder's C k^2 = 12,675; the caller pads CK to a multiple of
// 8 so that every copy is 16 bytes). nvcuda::wmma 16x16x16 bf16 fragments
// keep the 64 x K product in registers: warp w owns column blocks w, w + 8,
// ... of all four row blocks. The accumulators go through an f32 staging
// tile (which reuses the chunk buffers) where bc and the activation are
// applied; the bf16 h1 tile then feeds K1's mixing and heads body on the
// same fragments. Shared-memory rows are padded by 8 bf16 (4 f32) against
// bank conflicts. The (N, R*K) lift tensor never reaches device memory
// unless h1 is saved. Rows past N are zero and never stored. The P tile is
// read once per rotation (from L2 after the first); keeping it resident,
// wgmma and TMA are later work.
//
// K12: the backward of K11.
//
// Replaces targetvae_tpu/kernels/lifted_encoder.py::_bwd_kernel (pallas_call
// at :215). From the saved h1 and P (images are data: no patch gradient),
// two deterministic passes, both on wgmma with TMA-fed operands:
//  A. the chain (csrc/mix_heads.cu's chain kernel, from_h1 mode): per
//     64-position tile and rotation, on a persistent grid, pre2 = h1 W2 +
//     b2 and h2 recomputed, then dWh, dbh, dW2, db2 with dpre2 = dh2
//     act'(f32 pre2) (the TPU kernel's rounding point; K2 takes act' from
//     the bf16 h2), and dpre1 = (bf16(dpre2) W2^T) act'(h1) written as bf16
//     (N, R*K); dbc is the column sum of the f32 dpre1, as the TPU kernel
//     takes it. The lift is not recomputed.
//  B. split-K dWc = P^T bf16(dpre1) on csrc/decoder_wgmma.cuh's weight
//     gradient (K8's, both operands MN-major by TMA, 128 x 256 output
//     tiles, P's columns past C k^2 read as zero up to the 64-row tile),
//     its splits filling the card in one wave (kernels/decoder_pose.py::
//     wgrad_schedule), each split its own partial, added in order by
//     csrc/reduce.cu.
// What bounds it: the tensor cores, 2 N CK R K for dWc plus the chain's
// three 2 N R K^2 products (~0.37 TFLOP at the flagship, 0.37 ms at the bf16
// peak), against at least P + h1 + g read (~0.58 GB, 0.17 ms). dWc runs
// near the card's GEMM rate (cuBLAS at the same shape is the yardstick);
// the chain takes longer than its bytes need (PERF.md, section 6).
#include <mma.h>

#include "decoder_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;    // 8 warps (the forward)
constexpr int WARPS = THREADS / 32;
constexpr int TP = 64;          // positions per block
constexpr int KC = 32;          // columns of P (rows of Wc) per chunk
constexpr int DP = 16;          // heads padded to one fragment width
constexpr int LDP = KC + 8;     // padded rows of the P chunk

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int K>
struct Layout {
  static constexpr int LDK = K + 8;                 // bf16 rows of W2, h, Wc chunk
  static constexpr int LDS = K + 4;                 // f32 staging rows
  static constexpr int NCB = (K / 16 + WARPS - 1) / WARPS;   // column blocks a warp
  static constexpr size_t STAGE = (size_t)TP * LDS * 4;
  static constexpr size_t CHUNKS = ((size_t)2 * TP * LDP + (size_t)2 * KC * LDK) * 2;
  static constexpr size_t REGION = STAGE > CHUNKS ? STAGE : CHUNKS;
  static constexpr size_t SMEM = ((size_t)K * LDK + (size_t)K * DP +
                                  (size_t)TP * LDK) * 2 + REGION;
};

// The block's TP x K product in registers: acc[i][j] covers row block i and
// column block warp + j * WARPS.
template <int K>
using Acc = FragC[4][Layout<K>::NCB];

template <int K>
__device__ __forceinline__ void fill_acc(Acc<K>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Layout<K>::NCB; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// acc += A (TP x 16 at `at`, row stride lda) @ B (16 x K at `bt`, row
// stride ldb), both bf16 in shared memory
template <int K>
__device__ __forceinline__ void mma_tile(Acc<K>& acc,
                                         const __nv_bfloat16* at, int lda,
                                         const __nv_bfloat16* bt, int ldb,
                                         int warp) {
  FragA a;
  FragB b;
#pragma unroll
  for (int j = 0; j < Layout<K>::NCB; ++j) {
    const int cb = warp + j * WARPS;
    if (cb >= K / 16) break;
    wmma::load_matrix_sync(b, bt + cb * 16, ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::load_matrix_sync(a, at + i * 16 * lda, lda);
      wmma::mma_sync(acc[i][j], a, b, acc[i][j]);
    }
  }
}

// acc -> the f32 staging tile (TP x K, row stride LDS)
template <int K>
__device__ __forceinline__ void store_acc(Acc<K>& acc, float* stg, int warp) {
#pragma unroll
  for (int j = 0; j < Layout<K>::NCB; ++j) {
    const int cb = warp + j * WARPS;
    if (cb >= K / 16) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(stg + i * 16 * Layout<K>::LDS + cb * 16,
                              acc[i][j], Layout<K>::LDS, wmma::mem_row_major);
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2) lifted_encoder_fwd_kernel(
    const __nv_bfloat16* __restrict__ P, const __nv_bfloat16* __restrict__ wc,
    const float* __restrict__ bc, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ out,
    __nv_bfloat16* __restrict__ h1_out, int N, int CK, int R, int D, int act) {
  using Ly = Layout<K>;
  constexpr int LDK = Ly::LDK, LDS = Ly::LDS;
  constexpr int K8 = K / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  // [W2 K*LDK | Wh K*DP | h tile TP*LDK (bf16) | region: staging TP*LDS f32,
  //  aliased by the chunk buffers P 2*TP*LDP, Wc 2*KC*LDK (bf16)]
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* whs = w2s + K * LDK;
  __nv_bfloat16* hs = whs + K * DP;
  unsigned char* region = reinterpret_cast<unsigned char*>(hs + TP * LDK);
  float* stg = reinterpret_cast<float*>(region);
  __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(region);
  __nv_bfloat16* wbuf = pbuf + 2 * TP * LDP;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int p0 = blockIdx.x * TP;
  const int RK = R * K;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < K * K8; i += THREADS) {
    const int k = i / K8, c = (i - k * K8) * 8;
    *reinterpret_cast<uint4*>(w2s + k * LDK + c) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)k * K + c);
  }
  for (int i = tid; i < K * DP; i += THREADS) {
    const int k = i / DP, d = i - k * DP;
    whs[i] = d < D ? wh[k * D + d] : __float2bfloat16(0.f);
  }

  // starts the copy of chunk c (columns [c*KC, c*KC + KC) of the P tile and
  // the matching rows of Wc's rotation-r columns) into buffer `slot`;
  // what lies past N or CK is zero-filled
  auto load_chunk = [&](int r, int c, int slot) {
    const int k0 = c * KC;
    __nv_bfloat16* pd = pbuf + slot * TP * LDP;
    for (int i = tid; i < TP * (KC / 8); i += THREADS) {
      const int p = i / (KC / 8), q = (i - p * (KC / 8)) * 8;
      __nv_bfloat16* d = pd + p * LDP + q;
      if (p0 + p < N && k0 + q < CK)
        cp_async16(d, P + (size_t)(p0 + p) * CK + k0 + q);
      else
        *reinterpret_cast<uint4*>(d) = zero;
    }
    __nv_bfloat16* wd = wbuf + slot * KC * LDK;
    for (int i = tid; i < KC * K8; i += THREADS) {
      const int k = i / K8, q = (i - k * K8) * 8;
      __nv_bfloat16* d = wd + k * LDK + q;
      if (k0 + k < CK)
        cp_async16(d, wc + (size_t)(k0 + k) * RK + r * K + q);
      else
        *reinterpret_cast<uint4*>(d) = zero;
    }
    cp_async_commit();
  };

  Acc<K> acc;
  FragA a;
  FragB bfr;
  const int nch = (CK + KC - 1) / KC;
  for (int r = 0; r < R; ++r) {
    // ---- pre1 = P tile @ Wc_r ----
    fill_acc<K>(acc);
    load_chunk(r, 0, 0);
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) {
        load_chunk(r, c + 1, (c + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* pc = pbuf + (c & 1) * TP * LDP;
      const __nv_bfloat16* wcc = wbuf + (c & 1) * KC * LDK;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16)
        mma_tile<K>(acc, pc + kk, LDP, wcc + kk * LDK, LDK, warp);
      __syncthreads();
    }
    store_acc<K>(acc, stg, warp);
    __syncthreads();

    // ---- h1 = bf16(act(pre1 + bc_r)), eight channels (16 bytes) a thread ----
    for (int i = tid; i < TP * K8; i += THREADS) {
      const int p = i / K8, c = (i - p * K8) * 8;
      const int row = p0 + p;
      __align__(16) __nv_bfloat16 h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] = __float2bfloat16(
            row < N ? act_fn(stg[p * LDS + c + j] + bc[r * K + c + j], act) : 0.f);
      *reinterpret_cast<uint4*>(hs + p * LDK + c) = *reinterpret_cast<uint4*>(h);
      if (h1_out && row < N)
        *reinterpret_cast<uint4*>(h1_out + (size_t)row * RK + r * K + c) =
            *reinterpret_cast<uint4*>(h);
    }
    __syncthreads();

    // ---- pre2 = h1 @ W2 -> staging; h2 = bf16(act(pre2 + b2)) over h1 ----
    fill_acc<K>(acc);
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 16)
      mma_tile<K>(acc, hs + kk, LDK, w2s + kk * LDK, LDK, warp);
    store_acc<K>(acc, stg, warp);
    __syncthreads();
    for (int i = tid; i < TP * K; i += THREADS) {
      const int p = i / K, c = i - p * K;
      hs[p * LDK + c] = __float2bfloat16(act_fn(stg[p * LDS + c] + b2[c], act));
    }
    __syncthreads();

    // ---- heads = h2 @ Wh -> staging as (TP, DP) ----
    if (warp < TP / 16) {
      FragC hacc;
      wmma::fill_fragment(hacc, 0.f);
      for (int kk = 0; kk < K; kk += 16) {
        wmma::load_matrix_sync(a, hs + warp * 16 * LDK + kk, LDK);
        wmma::load_matrix_sync(bfr, whs + kk * DP, DP);
        wmma::mma_sync(hacc, a, bfr, hacc);
      }
      wmma::store_matrix_sync(stg + warp * 16 * DP, hacc, DP, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < TP * D; i += THREADS) {
      const int p = i / D, d = i - p * D;
      const int row = p0 + p;
      if (row < N) out[(size_t)row * R * D + r * D + d] = stg[p * DP + d] + bh[d];
    }
    __syncthreads();   // the staging tile is about to take the next chunks
  }
}

template <int K>
int launch_fwd_k(const void* P, const void* wc, const void* bc,
                 const void* w2, const void* b2, const void* wh,
                 const void* bh, void* out, void* h1_out, int N, int CK,
                 int R, int D, int act, cudaStream_t stream) {
  const size_t smem = Layout<K>::SMEM;
  int err = allow_smem(lifted_encoder_fwd_kernel<K>, smem);
  if (err) return err;
  lifted_encoder_fwd_kernel<K><<<(N + TP - 1) / TP, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)P, (const __nv_bfloat16*)wc, (const float*)bc,
      (const __nv_bfloat16*)w2, (const float*)b2, (const __nv_bfloat16*)wh,
      (const float*)bh, (float*)out, (__nv_bfloat16*)h1_out, N, CK, R, D, act);
  return (int)cudaGetLastError();
}

}  // namespace

// K11. P (N, CK) bf16 with CK % 8 == 0; wc (CK, R*K) bf16; bc (R*K,) f32;
// w2 (K, K), wh (K, D) bf16; b2 (K,), bh (D,) f32; out (N, R*D) f32; h1_out
// (N, R*K) bf16, or null when serving.
extern "C" int tvae_lifted_encoder_fwd(const void* P, const void* wc,
                                       const void* bc, const void* w2,
                                       const void* b2, const void* wh,
                                       const void* bh, void* out,
                                       void* h1_out, int N, int CK, int R,
                                       int K, int D, int act, void* stream) {
  if (CK % 8 || D > DP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 32:
      return launch_fwd_k<32>(P, wc, bc, w2, b2, wh, bh, out, h1_out, N, CK, R, D, act, s);
    case 64:
      return launch_fwd_k<64>(P, wc, bc, w2, b2, wh, bh, out, h1_out, N, CK, R, D, act, s);
    case 128:
      return launch_fwd_k<128>(P, wc, bc, w2, b2, wh, bh, out, h1_out, N, CK, R, D, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K12. P (N, CK) and h1 (N, R*K) bf16 from the forward; w2, wh bf16; b2
// f32; g (N, R*D) f32. Scratch: dpre1 (N, R*K) bf16; part (G, SP) f32 as
// tvae_mix_heads_bwd's (G blocks of `chunk` items); gpart (S, MP, R*K) f32
// with MP = CK rounded up to 64, S splits of C rows
// (kernels/decoder_pose.py::wgrad_schedule). Outputs: out (SP,)
// [dW2 | dWh | db2 | dbh | dbc ...] as tvae_mix_heads_bwd's; dwc
// (MP, R*K) f32, its first CK rows dWc.
extern "C" int tvae_lifted_encoder_bwd(
    const void* P, const void* h1, const void* w2, const void* b2,
    const void* wh, const void* g, void* dpre1, void* part, void* out,
    void* gpart, void* dwc, int N, int CK, int R, int K, int D, int G,
    int chunk, int SP, int S, int C, int act, void* stream) {
  const int MP = (CK + 63) / 64 * 64;
  if (CK % 8 || (R * K) % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if ((err = mix_heads_bwd_run(h1, nullptr, w2, b2, wh, g, dpre1, part, out, N,
                               R, K, D, G, chunk, SP, act, 1, s)))
    return err;
  const wg::FeatSrc none{};
  if ((err = wg::launch_wgrad<wg::FEAT_NONE>(P, 1, 0, none, dpre1, 1, 0,
                                             (float*)gpart, N, MP, R * K, S, C,
                                             0, s, CK)))
    return err;
  return sum_partials((const float*)gpart, (float*)dwc, 1, S, MP * R * K, s);
}
