// K1 and K2 at R = 1 with a rectangular mixing: mode B's encoder chain.
//
// Replaces targetvae_tpu/kernels/mix_heads.py::_fwd_kernel and _bwd_kernel
// (pallas_call at :232 and :269) as the JAX package's mode-B tier runs them
// (models/encoders.py::_mode_b_fast): R = 1 and a mixing W2 of KI x K,
// KI = R_lift K the lifted channels (fc_r folded into conv2; KI = K at
// groupconv 0). Per position p, with pre1 (N, KI) bf16 the raw lift conv:
//   h1 = bf16(act(pre1[p] + bc))            bc (KI,)
//   h2 = bf16(act(h1 @ W2 + b2))            W2 (KI, K) bf16, f32 sums
//   out[p] = h2 @ Wh + bh                   Wh (K, D) bf16, f32 sums
// and the backward (K2's, act' of the second layer from the bf16 h2):
//   dWh = sum h2^T g16, dbh = sum g         g16 = bf16(g)
//   dpre2 = (g16 Wh^T) act'(h2), db2 = sum dpre2
//   dW2 = sum h1^T bf16(dpre2)
//   dpre1 = (bf16(dpre2) W2^T) act'(h1) as bf16 (N, KI), dbc = sum dpre1
//
// What bounds it on the H100: the bytes. At mode B's flagship (B = 100,
// 51 x 51 positions: N = 260,100, K = 128, D = 7) the forward reads pre1,
// 66.6 MB at KI = 128 (groupconv 0) and 533 MB at KI = 1,024 (P8), and the
// backward also writes dpre1 of the same size; the products (2 N KI K) are
// 0.07 TFLOP at KI = 1,024, ~0.07 ms at the bf16 peak.
//
// Design: csrc/lifted_encoder.cu's lift mainloop (K11), with pre1 in P's
// place and the mixing in Wc's: KI streams, so that a W2 of any KI fits
// (1,024 x 128 bf16 is 256 KB, more than a block's shared memory):
//  - forward: a persistent grid over 128-position tiles (kernels/
//    mix_heads.py::fwd_schedule); one TMA thread keeps a ring of 64-channel
//    stages in flight, each the tile's two 64 x 64 slices of pre1 and the
//    matching 64 rows of W2 (both from 2-D maps, 128-byte swizzled, zero
//    past KI, N and K); consumer warpgroup w turns its slice into h1 in
//    place (bias, act, rows past N and channels past KI zero), then
//    accumulates pre2 = h1 W2 on m64n128k16 across the stages;
//    csrc/encoder_chain.cuh's fwd_heads finishes h2 and the heads, which
//    leave as one bulk copy a warpgroup;
//  - backward, two kernels and the in-order sums of their partials: the
//    head pass recomputes pre2 on the forward's mainloop, then h2, dh2 =
//    g16 Wh^T (g16^T a 16 x 64 tile from registers loaded before the
//    mainloop), dWh (registers across the block's tiles), dpre2, db2 and
//    dbh (fixed-order sums in shared memory), and writes bf16(dpre2) (N, K)
//    by TMA; the channel pass gives each block one 64-channel chunk of KI
//    (its 64 rows of W2 resident) and a run of 128-position tiles
//    (kernels/mix_heads.py::r1_channel_schedule), streams pre1's slice and
//    bf16(dpre2)'s rows, and computes dh1 = bf16(dpre2) W2_c^T (m64n64),
//    dpre1 with dbc's sums, and dW2_c += h1^T bf16(dpre2) (m64n128,
//    registers across the run). Each warpgroup writes its own row of
//    partials; csrc/reduce.cu adds the rows in order: no atomics, reruns
//    bitwise equal. pre1 is read twice in the backward (once a pass).
// The mode-C kernels (csrc/mix_heads.cu, R in 4, 8, 16 and a square W2)
// are untouched: these are kernels of their own.
#include "encoder_chain.cuh"

namespace {
namespace chain {

constexpr int Q_STAGES = 4;
constexpr int Q_STAGE = 4 * TILE;        // pre1: two 64 x 64; W2 rows: 64 x 128
constexpr int Q_THREADS = 384;
constexpr int Q_PROD_REGS = 40;          // the TMA thread alone
constexpr int Q_CONS_REGS = (64512 - 128 * Q_PROD_REGS) / 256 / 8 * 8;

// the forward's and the head pass's shared memory, byte offsets from the
// 1,024-aligned base
constexpr int Q_WHT = 0;                 // Wh^T, 16 x 128 (the forward)
constexpr int Q_WHS = Q_WHT + WHT;       // Wh, 128 x 64 (the head pass)
constexpr int Q_RING = Q_WHS + W2T;      // 1,024-aligned
constexpr int Q_H = Q_RING + Q_STAGES * Q_STAGE;   // two h tiles
constexpr int Q_GT = Q_H + 2 * HT;       // two g16^T tiles, 16 x 64
constexpr int Q_GF = Q_GT + 2 * 2048;    // two (64, 16) f32 g tiles
constexpr int Q_RED = Q_GF + 2 * 64 * 16 * 4;      // (8 warps, 128) f32
constexpr int Q_B2 = Q_RED + 8 * 128 * 4;
constexpr int Q_BH = Q_B2 + KP * 4;
constexpr int Q_BARS = Q_BH + 16 * 4;
constexpr int Q_HB = Q_BARS + 2 * Q_STAGES * 8;     // the heads, 128 D f32

// h1 = bf16(act(pre1 + bc)) in place over a 64 x 64 slice of pre1 (channels
// c0.., positions p0..), rows past N and channels past KI zero; a
// warpgroup's 128 threads take 4 16-byte pieces each (KI % 8 == 0: a piece
// is in or out whole)
template <int ACT>
__device__ __forceinline__ void to_h1(unsigned char* tile,
                                      const float* __restrict__ bc, int c0,
                                      int KI, int p0, int N, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int idx = t + 128 * e, p = idx >> 3, cc = idx & 7, ch = c0 + cc * 8;
    uint4* q = reinterpret_cast<uint4*>(tile + swz(p, cc));
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + p < N && ch < KI) {
      const uint4 raw = *q;
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bc + ch));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bc + ch + 4));
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ov[k] = pack2(act_fn(__low2float(x[k]) + b[2 * k], ACT),
                      act_fn(__high2float(x[k]) + b[2 * k + 1], ACT));
    }
    *q = o;
  }
}

// The forward's and the head pass's producer: the TMA thread streams, for
// each 128-position tile of [i0, i1), its nch 64-channel stages: the two
// 64 x 64 slices of pre1 below N and the one or two 64 x 64 boxes of W2's
// rows, completing on full[s].
__device__ __forceinline__ void stream_tiles(const CUtensorMap* map_p,
                                             const CUtensorMap* map_w,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int i0, int i1, int nch, int N,
                                             int nbox) {
  int it = 0;
  for (int i = i0; i < i1; ++i) {
    const int p0 = i * FWD_TM;
    const int nh = min(2, (N - p0 + TM - 1) / TM);   // halves below N
    for (int c = 0; c < nch; ++c, ++it) {
      const int s = it % Q_STAGES;
      unsigned char* st = ring + s * Q_STAGE;
      mbar_wait(&empty[s], ((it / Q_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], (nh + nbox) * TILE);
      for (int h = 0; h < nh; ++h)
        tma_load_2d(st + h * TILE, map_p, &full[s], c * 64, p0 + h * TM);
      for (int a = 0; a < nbox; ++a)
        tma_load_2d(st + (2 + a) * TILE, map_w, &full[s], a * 64, c * 64);
    }
  }
}

// A consumer warpgroup's mainloop over its tile's nch stages: h1 in place
// over its slice, then acc = pre2 = h1 W2 (b2 not added), one stage behind
// the TMA thread; `it` counts the block's stages.
template <int ACT>
__device__ __forceinline__ void pre2_mainloop(float* acc, unsigned char* ring,
                                              uint64_t* full, uint64_t* empty,
                                              const float* __restrict__ bc,
                                              int& it, int nch, int KI,
                                              int p0w, int N, int t, int w,
                                              int bar) {
  const int lane = t & 31;
  for (int c = 0; c < nch; ++c, ++it) {
    const int s = it % Q_STAGES;
    unsigned char* st = ring + s * Q_STAGE;
    mbar_wait(&full[s], (it / Q_STAGES) & 1);
    to_h1<ACT>(st + w * TILE, bc, c * 64, KI, p0w, N, t);
    fence_async_smem();
    bar_sync(bar, 128);
    acc_fence<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<128, 0, 1>(acc, gmma_desc(st + w * TILE + kk * 32, 16, 1024),
                       gmma_desc(st + 2 * TILE + kk * 2048, TILE, 1024),
                       c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<64>(acc);
    if (c > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % Q_STAGES]);
  }
  wgmma_wait<0>();
  acc_fence<64>(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % Q_STAGES]);
}

// The maps of pre1 (KI, N) and W2 (K, KI), boxes of 64 x 64.
inline int make_r1_maps(CUtensorMap* m_p, CUtensorMap* m_w, const void* pre1,
                        const void* w2, int N, int KI, int K) {
  const uint64_t d_p[2] = {(uint64_t)KI, (uint64_t)N}, s_p[1] = {(uint64_t)KI * 2};
  const uint64_t d_w[2] = {(uint64_t)K, (uint64_t)KI}, s_w[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, TM};
  int err;
  if ((err = make_map_strided(m_p, pre1, 2, d_p, s_p, box))) return err;
  return make_map_strided(m_w, w2, 2, d_w, s_w, box);
}

// A (K, 1, N) bf16 map in boxes of 64 x 1 x 64, for TMA stores of rows.
inline int make_rows_map(CUtensorMap* m, void* base, int N, int K) {
  const uint64_t dims[3] = {(uint64_t)K, 1, (uint64_t)N};
  const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)K * 2};
  const uint32_t box[3] = {64, 1, TM};
  return make_map_strided(m, base, 3, dims, strides, box);
}

// The common start of the forward and the head pass: the ring and the tiles
// after it zero, b2 and bh staged, the barriers ready.
__device__ __forceinline__ void r1_setup(unsigned char* base,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ bh, int K,
                                         int D, int tid) {
  for (int o = Q_RING + tid * 16; o < Q_GF; o += Q_THREADS * 16)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
  float* b2s = reinterpret_cast<float*>(base + Q_B2);
  float* bhs = reinterpret_cast<float*>(base + Q_BH);
  for (int c = tid; c < KP; c += Q_THREADS) b2s[c] = c < K ? b2[c] : 0.f;
  if (tid < 16) bhs[tid] = tid < D && bh ? bh[tid] : 0.f;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Q_BARS);
  if (tid == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[Q_STAGES + s], 8);
    }
    mbar_init_fence();
  }
}

// ---- K1 at R = 1 ----
template <int ACT>
__global__ void __launch_bounds__(Q_THREADS, 1) r1_fwd_kernel(
    const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bc,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ out, int N, int KI,
    int K, int D, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base + Q_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Q_BARS);
  uint64_t* empty = full + Q_STAGES;
  const int tid = threadIdx.x;
  const int total = (N + FWD_TM - 1) / FWD_TM;
  const int i0 = blockIdx.x * chunk, i1 = min(total, i0 + chunk);
  const int nbox = K > 64 ? 2 : 1, nch = (KI + 63) / 64;
  r1_setup(base, b2, bh, K, D, tid);
  stage_wht(base + Q_WHT, wh, K, D, tid, Q_THREADS);
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    reg_dealloc<Q_PROD_REGS>();
    if (tid == 256)
      stream_tiles(&map_p, &map_w, ring, full, empty, i0, i1, nch, N, nbox);
    return;
  }

  // ---- consumers: warpgroup w owns the tile's positions [64 w, 64 w + 64) ----
  reg_alloc<Q_CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w, nk = (K + 15) / 16;
  unsigned char* h = base + Q_H + w * HT;
  float* hb = reinterpret_cast<float*>(base + Q_HB) + w * TM * D;
  const float* b2s = reinterpret_cast<const float*>(base + Q_B2);
  const float* bhs = reinterpret_cast<const float*>(base + Q_BH);
  float acc[64], hd[8];
  long long seg[4] = {0, 0, 0, 0};
  int it = 0;
  for (int i = i0; i < i1; ++i) {
    const int p0w = i * FWD_TM + w * TM;
    if (i > i0) reuse_heads(t, bar);
    pre2_mainloop<ACT>(acc, ring, full, empty, bc, it, nch, KI, p0w, N, t, w,
                       bar);
    fwd_heads(acc, hd, h, base + Q_WHT, b2s, nk, t, ACT, false, bar, seg);
    put_heads(hd, hb, out, bhs, p0w, 0, N, 1, D, t);
    flush_heads(hb, out, p0w, 0, 0, N, 1, D, t, bar);
  }
  if (t == 0) tma_store_wait_all();
}

// ---- K2 at R = 1, the head pass ----
template <int ACT>
__global__ void __launch_bounds__(Q_THREADS, 1) r1_head_kernel(
    const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_dp, const float* __restrict__ bc,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ wh,
    const float* __restrict__ g, float* __restrict__ part, int N, int KI,
    int K, int D, int chunk, int SP) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base + Q_RING;
  unsigned char* whs = base + Q_WHS;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Q_BARS);
  uint64_t* empty = full + Q_STAGES;
  const int tid = threadIdx.x;
  const int total = (N + FWD_TM - 1) / FWD_TM;
  const int i0 = blockIdx.x * chunk, i1 = min(total, i0 + chunk);
  const int nbox = K > 64 ? 2 : 1, nch = (KI + 63) / 64;
  r1_setup(base, b2, nullptr, K, D, tid);
  // Wh (K, D) as 128 rows (channels) x 64 columns (heads), zero-padded:
  // the K-major B of dh2 = g16 Wh^T
  for (int idx = tid; idx < KP * 8; idx += Q_THREADS) {
    const int i = idx >> 3, cc = idx & 7;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = cc * 8 + e;
      v[e] = i < K && d < D ? wh[i * D + d] : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(whs + swz(i, cc)) = *reinterpret_cast<uint4*>(v);
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    reg_dealloc<Q_PROD_REGS>();
    if (tid == 256)
      stream_tiles(&map_p, &map_w, ring, full, empty, i0, i1, nch, N, nbox);
    return;
  }

  reg_alloc<Q_CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w, lane = t & 31;
  const int q = t >> 5;
  unsigned char* h = base + Q_H + w * HT;
  unsigned char* gt = base + Q_GT + w * 2048;
  float* gf = reinterpret_cast<float*>(base + Q_GF) + w * 64 * 16;
  float* red = reinterpret_cast<float*>(base + Q_RED) + w * 4 * 128;
  const float* b2s = reinterpret_cast<const float*>(base + Q_B2);
  // g: thread t holds heads 8 (t >> 6) .. + 7 of position t & 63
  const int gp = t & 63, gd0 = (t >> 6) * 8;
  float acc[64], dwh[2][8], gv[8];
  float db2 = 0.f, dbh = 0.f;            // columns t (db2) and t < 16 (dbh)
#pragma unroll
  for (int x = 0; x < 8; ++x) dwh[0][x] = dwh[1][x] = 0.f;
  int it = 0;
  for (int i = i0; i < i1; ++i) {
    const int p0w = i * FWD_TM + w * TM;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      gv[e] = p0w + gp < N && gd0 + e < D
                  ? __ldg(g + (size_t)(p0w + gp) * D + gd0 + e) : 0.f;
    pre2_mainloop<ACT>(acc, ring, full, empty, bc, it, nch, KI, p0w, N, t, w,
                       bar);
    // the last tile's bf16(dpre2) has left h
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
    // h2 = bf16(act(pre2 + b2)) into h; g16^T and g into their tiles
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * (t & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(h + (n >> 6) * TILE + at(acc_row(t, x), n & 63)) =
            pack2(act_fn(acc[x] + b2s[n], ACT), act_fn(acc[x + 1] + b2s[n + 1], ACT));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      *reinterpret_cast<__nv_bfloat16*>(gt + at(gd0 + e, gp)) =
          __float2bfloat16(gv[e]);
      gf[gp * 16 + gd0 + e] = gv[e];
    }
    fence_async_smem();
    bar_sync(bar, 128);
    // dh2 = g16 Wh^T into acc; dWh += h2^T g16
    acc_fence<64>(acc);
    wgmma_fence();
    wgmma<128, 1, 0>(acc, gmma_desc(gt, TILE, 1024), gmma_desc(whs, 16, 1024), 0);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<16, 1, 0>(dwh[a], gmma_desc(h + a * TILE + kk * 2048, TILE, 1024),
                        gmma_desc(gt + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence<64>(acc);
    acc_fence<8>(dwh[0]);
    acc_fence<8>(dwh[1]);
    if (t < 16) {
      float s = 0.f;
      for (int p = 0; p < 64; ++p) s += gf[p * 16 + t];
      dbh += s;
    }
    // dpre2 = dh2 act'(h2) over h2 in place, as bf16; db2's sums
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * (t & 3);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh;
        uint32_t* hp = reinterpret_cast<uint32_t*>(
            h + (n >> 6) * TILE + at(acc_row(t, x), n & 63));
        const uint32_t hv = *hp;
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hv);
        const float e0 = acc[x] * dact_from_h(__low2float(hb), ACT);
        const float e1 = acc[x + 1] * dact_from_h(__high2float(hb), ACT);
        *hp = pack2(e0, e1);
        s0 += e0;
        s1 += e1;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[q * 128 + n] = s0;
        red[q * 128 + n + 1] = s1;
      }
    }
    fence_async_smem();
    bar_sync(bar, 128);
    if (t == 0 && p0w < N) {
      for (int a = 0; a < (K > 64 ? 2 : 1); ++a)
        tma_store_3d(&map_dp, h + a * TILE, a * 64, 0, p0w);
      tma_store_commit();
    }
    db2 += ((red[t] + red[128 + t]) + red[256 + t]) + red[384 + t];
    bar_sync(bar, 128);                  // red and gf are read
  }
  if (t == 0) tma_store_wait_all();

  // this warpgroup's partials: [dWh K*D | db2 K | dbh D]
  float* pb = part + (size_t)(2 * blockIdx.x + w) * SP;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int c = 64 * a + acc_row(t, x), d = acc_col(t, x);
      if (c < K && d < D) pb[c * D + d] = dwh[a][x];
    }
  if (t < K) pb[K * D + t] = db2;
  if (t < D) pb[K * D + K + t] = dbh;
}

// ---- K2 at R = 1, the channel pass ----
constexpr int C_STAGES = 3;
constexpr int C_STAGE = 6 * TILE;        // pre1: two 64 x 64; dpre2: two 64 x 128
constexpr int C_W = 0;                   // W2's 64 rows of the chunk, 64 x 128
constexpr int C_RING = C_W + 2 * TILE;
constexpr int C_OUT = C_RING + C_STAGES * C_STAGE;  // two dpre1 tiles
constexpr int C_RED = C_OUT + 2 * TILE;  // (8 warps, 64) f32
constexpr int C_BARS = C_RED + 8 * 64 * 4;

template <int ACT>
__global__ void __launch_bounds__(Q_THREADS, 1) r1_channel_kernel(
    const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_dp,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, float* __restrict__ part, int N,
    int KI, int K, int per, int SP) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ws = base + C_W;
  unsigned char* ring = base + C_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C_BARS);
  uint64_t* empty = full + C_STAGES;
  const int tid = threadIdx.x;
  const int nch = (KI + 63) / 64, c = blockIdx.x % nch, run = blockIdx.x / nch;
  const int tiles = (N + FWD_TM - 1) / FWD_TM;
  const int i0 = run * per, i1 = min(tiles, i0 + per);
  const int nbox = K > 64 ? 2 : 1, c0 = c * 64;
  for (int o = C_RING + tid * 16; o < C_BARS; o += Q_THREADS * 16)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
  // W2's rows c0 .. c0 + 63 (channels) x K columns, zero past KI and K:
  // the K-major B of dh1 = bf16(dpre2) W2_c^T
  for (int idx = tid; idx < 64 * 16; idx += Q_THREADS) {
    const int i = idx >> 4, cc = idx & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + i < KI && cc * 8 < K)
      v = *reinterpret_cast<const uint4*>(w2 + (size_t)(c0 + i) * K + cc * 8);
    *reinterpret_cast<uint4*>(ws + (cc >> 3) * TILE + swz(i, cc & 7)) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    reg_dealloc<Q_PROD_REGS>();
    if (tid == 256) {
      int it = 0;
      for (int i = i0; i < i1; ++i, ++it) {
        const int s = it % C_STAGES, p0 = i * FWD_TM;
        const int nh = min(2, (N - p0 + TM - 1) / TM);
        unsigned char* st = ring + s * C_STAGE;
        mbar_wait(&empty[s], ((it / C_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], nh * (1 + nbox) * TILE);
        for (int h = 0; h < nh; ++h) {
          tma_load_2d(st + h * TILE, &map_p, &full[s], c0, p0 + h * TM);
          for (int a = 0; a < nbox; ++a)
            tma_load_2d(st + (2 + 2 * h + a) * TILE, &map_dp, &full[s], a * 64,
                        p0 + h * TM);
        }
      }
    }
    return;
  }

  reg_alloc<Q_CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w, lane = t & 31;
  const int q = t >> 5, nk = (K + 15) / 16;
  unsigned char* outw = base + C_OUT + w * TILE;
  float* red = reinterpret_cast<float*>(base + C_RED) + w * 4 * 64;
  float dm[64], dh[32], cs[16];
#pragma unroll
  for (int x = 0; x < 64; ++x) dm[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 16; ++x) cs[x] = 0.f;
  int it = 0;
  for (int i = i0; i < i1; ++i, ++it) {
    const int s = it % C_STAGES, p0w = i * FWD_TM + w * TM;
    unsigned char* st = ring + s * C_STAGE;
    unsigned char* h1 = st + w * TILE;
    const unsigned char* dp = st + (2 + 2 * w) * TILE;
    mbar_wait(&full[s], (it / C_STAGES) & 1);
    to_h1<ACT>(h1, bc, c0, KI, p0w, N, t);
    fence_async_smem();
    bar_sync(bar, 128);
    // dh1 = bf16(dpre2) W2_c^T; then dW2_c += h1^T bf16(dpre2)
    acc_fence<32>(dh);
    acc_fence<64>(dm);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk < nk)
        wgmma<64, 0, 0>(dh, gmma_desc(dp + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                        gmma_desc(ws + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                        kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<128, 1, 1>(dm, gmma_desc(h1 + kk * 2048, TILE, 1024),
                       gmma_desc(dp + kk * 2048, TILE, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<32>(dh);
    // the last tile's dpre1 has left outw
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
    // dpre1 = dh1 act'(h1) (rows past N zero) into the bf16 out tile; dbc
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * (t & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh, row = acc_row(t, x);
        const __nv_bfloat162 hb =
            *reinterpret_cast<const __nv_bfloat162*>(h1 + at(row, n));
        const bool in = p0w + row < N;
        const float e0 = in ? dh[x] * dact_from_h(__low2float(hb), ACT) : 0.f;
        const float e1 = in ? dh[x + 1] * dact_from_h(__high2float(hb), ACT) : 0.f;
        *reinterpret_cast<uint32_t*>(outw + at(row, n)) = pack2(e0, e1);
        cs[2 * j] += e0;
        cs[2 * j + 1] += e1;
      }
    }
    fence_async_smem();
    bar_sync(bar, 128);
    if (t == 0 && p0w < N) {
      tma_store_3d(&map_out, outw, c0, 0, p0w);
      tma_store_commit();
    }
    wgmma_wait<0>();
    acc_fence<64>(dm);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (t == 0) tma_store_wait_all();

  // this warpgroup's partials: rows c0.. of [dW2 KI*K | dbc KI]
  float* pb = part + (size_t)(2 * run + w) * SP;
#pragma unroll
  for (int x = 0; x < 64; x += 2) {
    const int m = acc_row(t, x), n = acc_col(t, x);
    if (c0 + m < KI && n < K)
      *reinterpret_cast<float2*>(pb + (size_t)(c0 + m) * K + n) =
          make_float2(dm[x], dm[x + 1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s0 = cs[2 * j], s1 = cs[2 * j + 1];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane < 4) {
      const int n = 8 * j + 2 * lane;
      red[q * 64 + n] = s0;
      red[q * 64 + n + 1] = s1;
    }
  }
  bar_sync(bar, 128);
  if (t < 64 && c0 + t < KI)
    pb[(size_t)KI * K + c0 + t] =
        ((red[t] + red[64 + t]) + red[128 + t]) + red[192 + t];
}

template <int ACT>
int launch_r1_fwd(const void* pre1, const void* bc, const void* w2,
                  const void* b2, const void* wh, const void* bh, void* out,
                  int N, int KI, int K, int D, int G, int chunk,
                  cudaStream_t stream) {
  CUtensorMap m_p, m_w;
  int err;
  if ((err = make_r1_maps(&m_p, &m_w, pre1, w2, N, KI, K))) return err;
  const size_t smem = 1024 + Q_HB + (size_t)FWD_TM * D * 4;
  if ((err = allow_smem(r1_fwd_kernel<ACT>, smem))) return err;
  r1_fwd_kernel<ACT><<<G, Q_THREADS, smem, stream>>>(
      m_p, m_w, (const float*)bc, (const float*)b2, (const __nv_bfloat16*)wh,
      (const float*)bh, (float*)out, N, KI, K, D, chunk);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_r1_bwd(const void* pre1, const void* bc, const void* w2,
                  const void* b2, const void* wh, const void* g, void* dpre1,
                  void* dpre2, void* part_a, void* part_b, void* sums, int N,
                  int KI, int K, int D, int G, int chunk, int SPa, int runs,
                  int per, int SPb, cudaStream_t stream) {
  CUtensorMap m_p, m_w, m_dp, m_dps, m_out;
  int err;
  if ((err = make_r1_maps(&m_p, &m_w, pre1, w2, N, KI, K))) return err;
  if ((err = make_rows_map(&m_dps, dpre2, N, K))) return err;
  if ((err = make_rows_map(&m_out, dpre1, N, KI))) return err;
  const uint64_t d_dp[2] = {(uint64_t)K, (uint64_t)N}, s_dp[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, TM};
  if ((err = make_map_strided(&m_dp, dpre2, 2, d_dp, s_dp, box))) return err;
  const size_t smem_a = 1024 + Q_HB;
  if ((err = allow_smem(r1_head_kernel<ACT>, smem_a))) return err;
  r1_head_kernel<ACT><<<G, Q_THREADS, smem_a, stream>>>(
      m_p, m_w, m_dps, (const float*)bc, (const float*)b2,
      (const __nv_bfloat16*)wh, (const float*)g, (float*)part_a, N, KI, K, D,
      chunk, SPa);
  if ((err = (int)cudaGetLastError())) return err;
  const size_t smem_b = 1024 + C_BARS + 2 * C_STAGES * 8;
  if ((err = allow_smem(r1_channel_kernel<ACT>, smem_b))) return err;
  const int nch = (KI + 63) / 64;
  r1_channel_kernel<ACT><<<nch * runs, Q_THREADS, smem_b, stream>>>(
      m_p, m_dp, m_out, (const float*)bc, (const __nv_bfloat16*)w2,
      (float*)part_b, N, KI, K, per, SPb);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_partials((const float*)part_a, (float*)sums, 1, 2 * G, SPa,
                          stream)))
    return err;
  return sum_partials((const float*)part_b, (float*)sums + SPa, 1, 2 * runs,
                      SPb, stream);
}

}  // namespace chain
}  // namespace

// K1 at R = 1. pre1 (N, KI) bf16, KI % 8 == 0; bc (KI,), b2 (K,), bh (D,)
// f32; w2 (KI, K), wh (K, D) bf16; out (N, D) f32. G blocks of `chunk`
// 128-position tiles (kernels/mix_heads.py::fwd_schedule at R = 1).
extern "C" int tvae_mix_heads_r1_fwd(const void* pre1, const void* bc,
                                     const void* w2, const void* b2,
                                     const void* wh, const void* bh, void* out,
                                     int N, int KI, int K, int D, int G,
                                     int chunk, int act, void* stream) {
  const long long tiles = (long long)(N + chain::FWD_TM - 1) / chain::FWD_TM;
  if (KI % 8 || KI < 8 || (K != 16 && K != 32 && K != 64 && K != 128) ||
      D < 1 || D > 16 || G < 1 || chunk < 1 || (long long)G * chunk < tiles ||
      (long long)(G - 1) * chunk >= tiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return act ? chain::launch_r1_fwd<1>(pre1, bc, w2, b2, wh, bh, out, N, KI,
                                       K, D, G, chunk, s)
             : chain::launch_r1_fwd<0>(pre1, bc, w2, b2, wh, bh, out, N, KI,
                                       K, D, G, chunk, s);
}

// K2 at R = 1: K1's inputs and g (N, D) f32 -> dpre1 (N, KI) bf16 and, in
// sums, [dWh K*D | db2 K | dbh D] at 0 and [dW2 KI*K | dbc KI] at SPa.
// Scratch: dpre2 (N, K) bf16; part_a (2 G, SPa) and part_b (2 runs, SPb)
// f32, a row a warpgroup. The head pass runs on G blocks of `chunk`
// 128-position tiles (fwd_schedule), the channel pass on ceil(KI / 64) x
// runs blocks of `per` tiles (kernels/mix_heads.py::r1_channel_schedule).
extern "C" int tvae_mix_heads_r1_bwd(const void* pre1, const void* bc,
                                     const void* w2, const void* b2,
                                     const void* wh, const void* g,
                                     void* dpre1, void* dpre2, void* part_a,
                                     void* part_b, void* sums, int N, int KI,
                                     int K, int D, int G, int chunk, int SPa,
                                     int runs, int per, int SPb, int act,
                                     void* stream) {
  const long long tiles = (long long)(N + chain::FWD_TM - 1) / chain::FWD_TM;
  if (KI % 8 || KI < 8 || (K != 16 && K != 32 && K != 64 && K != 128) ||
      D < 1 || D > 16 || G < 1 || chunk < 1 || (long long)G * chunk < tiles ||
      (long long)(G - 1) * chunk >= tiles || runs < 1 || per < 1 ||
      (long long)runs * per < tiles || (long long)(runs - 1) * per >= tiles ||
      SPa < K * D + K + D || SPb < KI * K + KI)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return act ? chain::launch_r1_bwd<1>(pre1, bc, w2, b2, wh, g, dpre1, dpre2,
                                       part_a, part_b, sums, N, KI, K, D, G,
                                       chunk, SPa, runs, per, SPb, s)
             : chain::launch_r1_bwd<0>(pre1, bc, w2, b2, wh, g, dpre1, dpre2,
                                       part_a, part_b, sums, N, KI, K, D, G,
                                       chunk, SPa, runs, per, SPb, s);
}
