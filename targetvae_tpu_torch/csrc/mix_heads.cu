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

// K2: the backward of K1.
//
// Replaces targetvae_tpu/kernels/mix_heads.py::_bwd_kernel (lift=True), the
// Pallas kernel of _bwd. Nothing but the inputs is saved by the forward:
// per position and rotation it recomputes h1 = bf16(act(pre1 + bc)) and
// h2 = bf16(act(h1 @ W2 + b2)), then with g16 = bf16(g):
//   dWh += h2^T g16        dbh += sum g
//   dh2  = g16 Wh^T        dpre2 = dh2 * act'(h2)
//   dW2 += h1^T bf16(dpre2)           db2 += sum dpre2
//   dh1  = bf16(dpre2) W2^T           dpre1 = dh1 * act'(h1)  -> bf16 out
//   dbc += sum dpre1 (f32, before the rounding)
// act' is recovered from the bf16 activation values, as the TPU kernel does.
// Per rotation, no block-diagonal grouping (a TPU matrix-unit trick). With
// from_h1 the kernel reads the bf16 h1 a forward saved in place of pre1 (the
// first pass of K12, csrc/lifted_encoder.cu, whose lift is a GEMM in K11).
//
// What bounds it on the H100: at the flagship shape (N = 152,100, R = 8,
// K = 128, D = 7) three 2*N*R*K^2 products (0.12 TFLOP with the heads) and
// ~0.66 GB of traffic (pre1 in, dpre1 out, g), so it sits at the ridge:
// ~0.12 ms of tensor-core time against ~0.2 ms of HBM time.
//
// Design: a fixed grid of G blocks (G = min(tiles, 264), set by the
// caller), block g walking tiles g, g + G, ... of 64 positions. W2 and Wh
// stay in shared memory; per rotation the h1, h2, bf16(g) and bf16(dpre2)
// tiles are staged there and every product runs on nvcuda::wmma 16x16x16
// bf16 fragments with f32 accumulation. dW2 and dWh accumulate in registers
// across the block's tiles, the column sums in shared memory (one thread per
// column, rows in order). Each block writes its partial sums to its own row
// of `part`; csrc/reduce.cu adds the rows in order. So the gradients are
// deterministic, and the tolerance against the plain version is that of
// two f32 summation orders. Rows past N are zero and never stored.
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;

template <int K>
__global__ void __launch_bounds__(THREADS) mix_heads_bwd_kernel(
    const __nv_bfloat16* __restrict__ pre1, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ g,
    __nv_bfloat16* __restrict__ dpre1, float* __restrict__ part, int N, int R,
    int D, int SP, int act, int from_h1) {
  constexpr int KB = K / 16;
  constexpr int NW2 = (KB * KB + WARPS - 1) / WARPS;  // dW2 fragments a warp
  constexpr int NWH = (KB + WARPS - 1) / WARPS;       // dWh fragments a warp
  constexpr int K8 = K / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  // [W2 K*K | Wh K*DP | h1 TP*K | h2 TP*K | bf16(dpre2) TP*K | bf16(g) TP*DP
  //  (all bf16) | g TP*DP | staging TP*K | sums db2 K, dbh DP, dbc R*K (f32)]
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* whs = w2s + K * K;
  __nv_bfloat16* h1s = whs + K * DP;
  __nv_bfloat16* h2s = h1s + TP * K;
  __nv_bfloat16* dps = h2s + TP * K;
  __nv_bfloat16* gs = dps + TP * K;
  float* gf = reinterpret_cast<float*>(gs + TP * DP);
  float* stg = gf + TP * DP;
  float* s_b2 = stg + TP * K;
  float* s_bh = s_b2 + K;
  float* s_bc = s_bh + DP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int RK = R * K;

  for (int i = tid; i < K * K; i += THREADS) w2s[i] = w2[i];
  for (int i = tid; i < K * DP; i += THREADS) {
    const int k = i / DP, d = i - k * DP;
    whs[i] = d < D ? wh[k * D + d] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < K + DP + RK; i += THREADS) s_b2[i] = 0.f;

  FragC acc2[NW2], acch[NWH];
#pragma unroll
  for (int j = 0; j < NW2; ++j) wmma::fill_fragment(acc2[j], 0.f);
#pragma unroll
  for (int j = 0; j < NWH; ++j) wmma::fill_fragment(acch[j], 0.f);
  __syncthreads();

  const int ntiles = (N + TP - 1) / TP;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int p0 = t * TP;
    for (int r = 0; r < R; ++r) {
      // h1 = bf16(act(pre1 + bc)), or h1 as given (from_h1), and the tile
      // of g, f32 and bf16
      for (int i = tid; i < TP * K8; i += THREADS) {
        const int p = i / K8, c = (i - p * K8) * 8;
        const int row = p0 + p;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (row < N)
          raw = *reinterpret_cast<const uint4*>(pre1 + (size_t)row * RK + r * K + c);
        if (from_h1) {
          *reinterpret_cast<uint4*>(h1s + p * K + c) = raw;
          continue;
        }
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = __float2bfloat16(
              row < N ? act_fn(__bfloat162float(x[j]) + bc[r * K + c + j], act)
                      : 0.f);
        *reinterpret_cast<uint4*>(h1s + p * K + c) = *reinterpret_cast<uint4*>(h);
      }
      for (int i = tid; i < TP * DP; i += THREADS) {
        const int p = i / DP, d = i - p * DP;
        const int row = p0 + p;
        const float v = (row < N && d < D) ? g[(size_t)row * R * D + r * D + d] : 0.f;
        gf[i] = v;
        gs[i] = __float2bfloat16(v);
      }
      __syncthreads();

      // pre2 = h1 @ W2 -> staging
      for (int f = warp; f < (TP / 16) * KB; f += WARPS) {
        const int fr = f / KB, fc = f - fr * KB;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < K; kk += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, h1s + fr * 16 * K + kk, K);
          wmma::load_matrix_sync(b, w2s + kk * K + fc * 16, K);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stg + fr * 16 * K + fc * 16, acc, K,
                                wmma::mem_row_major);
      }
      __syncthreads();

      // h2 = bf16(act(pre2 + b2)); dbh += column sums of g
      for (int i = tid; i < TP * K; i += THREADS) {
        const int row = p0 + i / K;
        h2s[i] = __float2bfloat16(row < N ? act_fn(stg[i] + b2[i % K], act) : 0.f);
      }
      if (tid < D) {
        float s = 0.f;
        for (int p = 0; p < TP; ++p) s += gf[p * DP + tid];
        s_bh[tid] += s;
      }
      __syncthreads();

      // dWh += h2^T g16 (registers); dh2 = g16 Wh^T -> staging
#pragma unroll
      for (int j = 0; j < NWH; ++j) {
        const int f = warp + j * WARPS;
        if (f < KB) {
          for (int kk = 0; kk < TP; kk += 16) {
            FragAc a;
            FragB b;
            wmma::load_matrix_sync(a, h2s + kk * K + f * 16, K);
            wmma::load_matrix_sync(b, gs + kk * DP, DP);
            wmma::mma_sync(acch[j], a, b, acch[j]);
          }
        }
      }
      for (int f = warp; f < (TP / 16) * KB; f += WARPS) {
        const int fr = f / KB, fc = f - fr * KB;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        FragA a;
        FragBc b;
        wmma::load_matrix_sync(a, gs + fr * 16 * DP, DP);
        wmma::load_matrix_sync(b, whs + fc * 16 * DP, DP);
        wmma::mma_sync(acc, a, b, acc);
        wmma::store_matrix_sync(stg + fr * 16 * K + fc * 16, acc, K,
                                wmma::mem_row_major);
      }
      __syncthreads();

      // dpre2 = dh2 * act'(h2): f32 in staging, bf16 beside it
      for (int i = tid; i < TP * K; i += THREADS) {
        const float v = stg[i] * dact_from_h(__bfloat162float(h2s[i]), act);
        stg[i] = v;
        dps[i] = __float2bfloat16(v);
      }
      __syncthreads();

      // db2 += column sums of dpre2; dW2 += h1^T bf16(dpre2) (registers)
      if (tid < K) {
        float s = 0.f;
        for (int p = 0; p < TP; ++p) s += stg[p * K + tid];
        s_b2[tid] += s;
      }
#pragma unroll
      for (int j = 0; j < NW2; ++j) {
        const int f = warp + j * WARPS;
        if (f < KB * KB) {
          const int mb = f / KB, nb = f - mb * KB;
          for (int kk = 0; kk < TP; kk += 16) {
            FragAc a;
            FragB b;
            wmma::load_matrix_sync(a, h1s + kk * K + mb * 16, K);
            wmma::load_matrix_sync(b, dps + kk * K + nb * 16, K);
            wmma::mma_sync(acc2[j], a, b, acc2[j]);
          }
        }
      }
      __syncthreads();

      // dh1 = bf16(dpre2) W2^T -> staging
      for (int f = warp; f < (TP / 16) * KB; f += WARPS) {
        const int fr = f / KB, fc = f - fr * KB;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < K; kk += 16) {
          FragA a;
          FragBc b;
          wmma::load_matrix_sync(a, dps + fr * 16 * K + kk, K);
          wmma::load_matrix_sync(b, w2s + fc * 16 * K + kk, K);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stg + fr * 16 * K + fc * 16, acc, K,
                                wmma::mem_row_major);
      }
      __syncthreads();

      // dpre1 = dh1 * act'(h1)
      for (int i = tid; i < TP * K; i += THREADS)
        stg[i] *= dact_from_h(__bfloat162float(h1s[i]), act);
      __syncthreads();

      // dpre1 out as bf16, eight channels (16 bytes) a thread; dbc sums
      for (int i = tid; i < TP * K8; i += THREADS) {
        const int p = i / K8, c = (i - p * K8) * 8;
        const int row = p0 + p;
        if (row < N) {
          __align__(16) __nv_bfloat16 h[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(stg[p * K + c + j]);
          *reinterpret_cast<uint4*>(dpre1 + (size_t)row * RK + r * K + c) =
              *reinterpret_cast<uint4*>(h);
        }
      }
      if (tid < K) {
        float s = 0.f;
        for (int p = 0; p < TP; ++p) s += stg[p * K + tid];
        s_bc[r * K + tid] += s;
      }
      __syncthreads();
    }
  }

  // this block's partials: [dW2 K*K | dWh K*D | db2 K | dbh D | dbc R*K]
  float* pb = part + (size_t)blockIdx.x * SP;
#pragma unroll
  for (int j = 0; j < NW2; ++j) {
    const int f = warp + j * WARPS;
    if (f < KB * KB) {
      const int mb = f / KB, nb = f - mb * KB;
      wmma::store_matrix_sync(pb + mb * 16 * K + nb * 16, acc2[j], K,
                              wmma::mem_row_major);
    }
  }
#pragma unroll
  for (int j = 0; j < NWH; ++j) {
    const int f = warp + j * WARPS;
    if (f < KB)
      wmma::store_matrix_sync(stg + f * 16 * DP, acch[j], DP,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < K * D; i += THREADS) {
    const int k = i / D, d = i - k * D;
    pb[K * K + i] = stg[k * DP + d];
  }
  for (int i = tid; i < K; i += THREADS) pb[K * K + K * D + i] = s_b2[i];
  for (int i = tid; i < D; i += THREADS) pb[K * K + K * D + K + i] = s_bh[i];
  for (int i = tid; i < RK; i += THREADS)
    pb[K * K + K * D + K + D + i] = s_bc[i];
}

template <int K>
int launch_bwd(const void* pre1, const void* bc, const void* w2,
               const void* b2, const void* wh, const void* g, void* dpre1,
               void* part, int N, int R, int D, int G, int SP, int act,
               int from_h1, cudaStream_t stream) {
  const size_t smem = ((size_t)K * K + (size_t)K * DP + 3 * (size_t)TP * K +
                       (size_t)TP * DP) * 2 +
                      ((size_t)TP * DP + (size_t)TP * K + K + DP + (size_t)R * K) * 4;
  int err = allow_smem(mix_heads_bwd_kernel<K>, smem);
  if (err) return err;
  mix_heads_bwd_kernel<K><<<G, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)pre1, (const float*)bc, (const __nv_bfloat16*)w2,
      (const float*)b2, (const __nv_bfloat16*)wh, (const float*)g,
      (__nv_bfloat16*)dpre1, (float*)part, N, R, D, SP, act, from_h1);
  return (int)cudaGetLastError();
}

}  // namespace

int mix_heads_bwd_run(const void* src, const void* bc, const void* w2,
                      const void* b2, const void* wh, const void* g,
                      void* dpre1, void* part, void* out, int N, int R, int K,
                      int D, int G, int SP, int act, int from_h1,
                      cudaStream_t s) {
  if (D > DP || G < 1 || SP % 8 ||
      SP < K * K + K * D + K + D + R * K)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (K) {
    case 16:
      err = launch_bwd<16>(src, bc, w2, b2, wh, g, dpre1, part, N, R, D, G, SP, act, from_h1, s);
      break;
    case 32:
      err = launch_bwd<32>(src, bc, w2, b2, wh, g, dpre1, part, N, R, D, G, SP, act, from_h1, s);
      break;
    case 64:
      err = launch_bwd<64>(src, bc, w2, b2, wh, g, dpre1, part, N, R, D, G, SP, act, from_h1, s);
      break;
    case 128:
      err = launch_bwd<128>(src, bc, w2, b2, wh, g, dpre1, part, N, R, D, G, SP, act, from_h1, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return sum_partials((const float*)part, (float*)out, 1, G, SP, s);
}

// part: (G, SP) f32 scratch; out: (SP,) f32, the first
// K*K + K*D + K + D + R*K entries of which receive
// [dW2 | dWh | db2 | dbh | dbc]; dpre1: (N, R*K) bf16.
extern "C" int tvae_mix_heads_bwd(const void* pre1, const void* bc,
                                  const void* w2, const void* b2,
                                  const void* wh, const void* g, void* dpre1,
                                  void* part, void* out, int N, int R, int K,
                                  int D, int G, int SP, int act,
                                  void* stream) {
  return mix_heads_bwd_run(pre1, bc, w2, b2, wh, g, dpre1, part, out, N, R, K,
                           D, G, SP, act, 0, (cudaStream_t)stream);
}

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
