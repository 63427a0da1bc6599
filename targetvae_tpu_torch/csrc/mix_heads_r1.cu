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
// place and the mixing in Wc's.
//  - forward, W2 resident (KI <= 256, at most 64 KB; groupconv 0): a
//    persistent grid over 64-position tiles (kernels/mix_heads.py::
//    r1_fwd_schedule); one TMA thread loads each tile's KI channels of pre1
//    as one ring stage, and three consumer warpgroups take the block's
//    tiles in turn, each on its own: h1 in place (both 64-channel slices'
//    loads issued together), pre2 = h1 W2 on m64n128k16 against the
//    resident W2, then r1_heads (b2 held in registers) with h2 over h1 in
//    the stage, which goes back to the producer once the heads' product has
//    read it. One warpgroup's epilogue overlaps the others' loads and
//    mainloops: three tiles in flight a block, where the streaming form,
//    its two warpgroups on one tile, has one (tools/probe_encoder_fwd.py
//    --r1);
//  - forward, W2 streamed (KI > 256: 1,024 x 128 bf16 is 256 KB, more than
//    a block's shared memory): a persistent grid over 128-position tiles;
//    one TMA thread keeps a ring of 64-channel stages in flight, each the
//    tile's two 64 x 64 slices of pre1 and the matching 64 rows of W2 (both
//    from 2-D maps, 128-byte swizzled, zero past KI, N and K); consumer
//    warpgroup w turns its slice into h1 in place (bias, act, rows past N
//    and channels past KI zero; the slice's loads all issued before any
//    store), then accumulates pre2 = h1 W2 on m64n128k16 across the
//    stages; fwd_heads finishes h2 and the heads, which leave as one bulk
//    copy a warpgroup;
//  - backward, two kernels and the in-order sums of their partials: the
//    head pass recomputes pre2 on the forward's mainloop, then h2, dh2 =
//    g16 Wh^T (g16^T a 16 x 64 tile from registers loaded before the
//    mainloop), dWh (registers across the block's tiles), dpre2, db2 and
//    dbh (a thread's running sums, added in a fixed order at the end), and
//    writes bf16(dpre2) (N, K) by TMA; the channel pass gives each block one 64-channel chunk of KI
//    (its 64 rows of W2 resident) and a run of 128-position tiles
//    (kernels/mix_heads.py::r1_channel_schedule), streams pre1's slice and
//    bf16(dpre2)'s rows, and computes dh1 = bf16(dpre2) W2_c^T (m64n64),
//    dpre1 with dbc's sums, and dW2_c += h1^T bf16(dpre2) (m64n128,
//    registers across the run). Each warpgroup writes its own row of
//    partials; csrc/reduce.cu adds the rows in order: no atomics, reruns
//    bitwise equal. pre1 is read twice in the backward (once a pass). A
//    one-pass form (a thread-block cluster a tile, KI split over its CTAs,
//    the partial pre2 exchanged through distributed shared memory) read
//    pre1 once but ran slower at both of mode B's shapes (PERF.md,
//    section 6): each tile's chain of exchanges, heads and epilogues was
//    longer than the two passes' streams.
// The mode-C kernels (csrc/mix_heads.cu, R in 4, 8, 16 and a square W2)
// are untouched: these are kernels of their own.
#include "encoder_chain.cuh"

namespace {
namespace chain {

// The R = 1 kernels' clock64 probe (-DTVAE_PROBE, tools/probe_encoder_fwd.py
// --r1): for kernel k (0 K1, 1 K2's head pass, 2 K2's channel pass),
// r1_probe[6 k ..] sums over the blocks the work items and five segments
// of cycles of thread 0 of consumer warpgroup 0: waiting for ring stages,
// the mainloop (waits left out), the epilogue, the stores (issue and the
// waits for their reads) and, for the channel pass, the wait for dW2's
// product.
#ifdef TVAE_PROBE
__device__ unsigned long long r1_probe[18];
__device__ __forceinline__ void r1_probe_add(int k, bool rec, long long items,
                                             long long a, long long b,
                                             long long c, long long d,
                                             long long e) {
  if (rec) {
    const long long v[6] = {items, a, b, c, d, e};
    for (int j = 0; j < 6; ++j)
      atomicAdd(&r1_probe[6 * k + j], (unsigned long long)v[j]);
  }
}
#endif

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
// is in or out whole), all read before any is written. FULL: the slice
// lies inside N and KI, and no piece is checked (so that no branch holds
// back the loads).
template <int ACT, bool FULL, int NB>
__device__ __forceinline__ void to_h1_pieces(unsigned char* tile,
                                             const float* __restrict__ bc,
                                             int c0, int KI, int p0, int N,
                                             int t) {
  uint4 raw[4 * NB];
  float4 b0[4 * NB], b1[4 * NB];
#pragma unroll
  for (int e = 0; e < 4 * NB; ++e) {
    const int idx = t + 128 * (e & 3), p = idx >> 3, cc = idx & 7;
    const int cb = c0 + (e >> 2) * 64 + cc * 8;
    const int ch = FULL || cb < KI ? cb : 0;
    raw[e] = *reinterpret_cast<const uint4*>(tile + (e >> 2) * TILE + swz(p, cc));
    b0[e] = __ldg(reinterpret_cast<const float4*>(bc + ch));
    b1[e] = __ldg(reinterpret_cast<const float4*>(bc + ch + 4));
  }
#pragma unroll
  for (int e = 0; e < 4 * NB; ++e) {
    const int idx = t + 128 * (e & 3), p = idx >> 3, cc = idx & 7;
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw[e]);
    const float b[8] = {b0[e].x, b0[e].y, b0[e].z, b0[e].w,
                        b1[e].x, b1[e].y, b1[e].z, b1[e].w};
    uint4 o;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ov[k] = pack2(act_fn(__low2float(x[k]) + b[2 * k], ACT),
                    act_fn(__high2float(x[k]) + b[2 * k + 1], ACT));
    if (!FULL && (p0 + p >= N || c0 + (e >> 2) * 64 + cc * 8 >= KI))
      o = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(tile + (e >> 2) * TILE + swz(p, cc)) = o;
  }
}
template <int ACT>
__device__ __forceinline__ void to_h1(unsigned char* tile,
                                      const float* __restrict__ bc, int c0,
                                      int KI, int p0, int N, int t) {
  if (p0 + TM <= N && c0 + 64 <= KI)
    to_h1_pieces<ACT, true, 1>(tile, bc, c0, KI, p0, N, t);
  else
    to_h1_pieces<ACT, false, 1>(tile, bc, c0, KI, p0, N, t);
}
// h1 over two neighbouring 64 x 64 slices (channels c0 .. c0 + 127, the
// second slice a tile further on), their 8 pieces a thread read together
template <int ACT>
__device__ __forceinline__ void to_h1_pair(unsigned char* tile,
                                           const float* __restrict__ bc,
                                           int c0, int KI, int p0, int N,
                                           int t) {
  if (p0 + TM <= N && c0 + 128 <= KI)
    to_h1_pieces<ACT, true, 2>(tile, bc, c0, KI, p0, N, t);
  else
    to_h1_pieces<ACT, false, 2>(tile, bc, c0, KI, p0, N, t);
}

// The streaming forward's and the head pass's producer: the TMA thread
// streams, for each 128-position tile of [i0, i1), its nch 64-channel
// stages: the two 64 x 64 slices of pre1 below N and the one or two 64 x
// 64 boxes of W2's rows, completing on full[s].
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
                                              int bar, long long& pw) {
  for (int c = 0; c < nch; ++c, ++it) {
    const int s = it % Q_STAGES;
    unsigned char* st = ring + s * Q_STAGE;
    PROBE(long long cw = clock64();)
    mbar_wait(&full[s], (it / Q_STAGES) & 1);
    PROBE(pw += clock64() - cw;)
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
    // every consumer thread arrives (no branch on the lane beside a
    // product in flight)
    if (c > 0) mbar_arrive(&empty[(it - 1) % Q_STAGES]);
  }
  wgmma_wait<0>();
  acc_fence<64>(acc);
  mbar_arrive(&empty[(it - 1) % Q_STAGES]);
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
      mbar_init(&full[Q_STAGES + s], 256);
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
  long long pw = 0;
  PROBE(long long pm = 0, pe = 0, ps = 0;)
  for (int i = i0; i < i1; ++i) {
    const int p0w = i * FWD_TM + w * TM;
    PROBE(long long c = clock64();)
    if (i > i0) reuse_heads(t, bar);
    PROBE(ps += clock64() - c; c = clock64();)
    pre2_mainloop<ACT>(acc, ring, full, empty, bc, it, nch, KI, p0w, N, t, w,
                       bar, pw);
    PROBE(pm += clock64() - c; c = clock64();)
    fwd_heads(acc, hd, h, base + Q_WHT, b2s, nk, t, ACT, false, bar, seg);
    put_heads(hd, hb, out, bhs, p0w, 0, N, 1, D, t);
    PROBE(pe += clock64() - c; c = clock64();)
    flush_heads(hb, out, p0w, 0, 0, N, 1, D, t, bar);
    PROBE(ps += clock64() - c;)
  }
  if (t == 0) tma_store_wait_all();
  PROBE(r1_probe_add(0, t == 0 && w == 0, i1 - i0, pw, pm - pw, pe, ps, 0);)
}

// ---- K1 at R = 1 with W2 resident (KI <= 256: at most 64 KB) ----
// Where all of W2 fits beside the ring, a stage is a whole 64-position
// tile of pre1 (KI channels), and each of three consumer warpgroups runs
// its own tiles (the block's tiles k = w, w + 3, ...): h1 in place, pre2 on
// m64n128 against the resident W2, then r1_heads with h2 over h1 in the
// stage, which goes back to the producer as soon as the heads' product
// has read it. The streaming form's epilogue took as long as its
// mainloop at KI = 128, with nothing beside it (tools/probe_encoder_fwd.py
// --r1); here one warpgroup's epilogue overlaps the others' loads and
// mainloops.
constexpr int F_TP = 64;
constexpr int F_MAXKI = 256;
constexpr int F_NST = 4;
constexpr int F_WGS = 3;
constexpr int F_THREADS = 128 * (F_WGS + 1);
constexpr int F_CONS_REGS = (65536 - 128 * Q_PROD_REGS) / (128 * F_WGS) / 8 * 8;

// the resident forward's shared memory past the 1,024-aligned base: W2 as
// [K half][nch 64 rows][64], the ring, Wh^T, b2, bh, the barriers, then
// three warpgroups' heads (64 D f32 each). Four stages: six (room for them
// at KI <= 192) ran slower at KI = 128.
__host__ __device__ __forceinline__ int f_stage(int nch) {
  return (nch > 2 ? nch : 2) * TILE;
}
__host__ __device__ __forceinline__ int f_wht(int nch) {
  return 2 * nch * TILE + F_NST * f_stage(nch);
}
__host__ __device__ __forceinline__ int f_heads(int nch) {
  return f_wht(nch) + WHT + KP * 4 + 16 * 4 + 2 * F_NST * 8;
}

// The resident forward's tail from pre2 = h1 W2 in acc: h2 = bf16(act(pre2
// + b2)) into h (b2 at the thread's 32 columns held in b2r, so that h2's
// stores wait on no shared-memory load), then the heads h2 Wh into hd (bh
// not added), all eight k16 steps of K: h2's columns past K are act(0) = 0
// and Wh^T's zero, and a branch between the products would make ptxas
// serialise them.
template <int ACT>
__device__ __forceinline__ void r1_heads(float* acc, float* hd,
                                         unsigned char* h,
                                         const unsigned char* wht,
                                         const float* b2r, int t, int bar) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * (t & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int x = 4 * j + 2 * hh;
      *reinterpret_cast<uint32_t*>(h + (n >> 6) * TILE + at(acc_row(t, x), n & 63)) =
          pack2(act_fn(acc[x] + b2r[2 * j], ACT),
                act_fn(acc[x + 1] + b2r[2 * j + 1], ACT));
    }
  }
  fence_async_smem();
  bar_sync(bar, 128);                    // the whole h2 tile is written
  float hd2[8];
  acc_fence<8>(hd);
  acc_fence<8>(hd2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma<16, 0, 0>(kk < 4 ? hd : hd2,
                    gmma_desc(h + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                    gmma_desc(wht + (kk >> 2) * 2048 + (kk & 3) * 32, 16, 1024),
                    kk & 3);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<8>(hd);
  acc_fence<8>(hd2);
#pragma unroll
  for (int x = 0; x < 8; ++x) hd[x] += hd2[x];
}

template <int ACT>
__global__ void __launch_bounds__(F_THREADS, 1) r1_fwd_resident_kernel(
    const __grid_constant__ CUtensorMap map_p, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bh,
    float* __restrict__ out, int N, int KI, int K, int D, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int nch = (KI + 63) / 64, sb = f_stage(nch), half = nch * TILE;
  unsigned char* w2s = base;
  unsigned char* ring = base + 2 * half;
  unsigned char* wht = base + f_wht(nch);
  float* b2s = reinterpret_cast<float*>(wht + WHT);
  float* bhs = b2s + KP;
  uint64_t* full = reinterpret_cast<uint64_t*>(bhs + 16);
  uint64_t* empty = full + F_NST;
  float* hbase = reinterpret_cast<float*>(base + f_heads(nch));
  const int tid = threadIdx.x;
  const int tiles = (N + F_TP - 1) / F_TP;
  const int i0 = blockIdx.x * chunk, n = min(tiles, i0 + chunk) - i0;
  for (int idx = tid; idx < nch * 64 * 16; idx += F_THREADS) {
    const int i = idx >> 4, cc = idx & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i < KI && cc * 8 < K)
      v = *reinterpret_cast<const uint4*>(w2 + (size_t)i * K + cc * 8);
    *reinterpret_cast<uint4*>(w2s + (cc >> 3) * half + swz(i, cc & 7)) = v;
  }
  stage_wht(wht, wh, K, D, tid, F_THREADS);
  for (int c = tid; c < KP; c += F_THREADS) b2s[c] = c < K ? b2[c] : 0.f;
  if (tid < 16) bhs[tid] = tid < D ? bh[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < F_NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 128 * F_WGS) {
    reg_dealloc<Q_PROD_REGS>();
    if (tid == 128 * F_WGS)
      for (int k = 0; k < n; ++k) {
        const int s = k % F_NST;
        mbar_wait(&empty[s], ((k / F_NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], nch * TILE);
        for (int cb = 0; cb < nch; ++cb)
          tma_load_2d(ring + s * sb + cb * TILE, &map_p, &full[s], cb * 64,
                      (i0 + k) * F_TP);
      }
    return;
  }

  reg_alloc<F_CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w;
  float* hb = hbase + w * F_TP * D;
  float acc[64], hd[8], b2r[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) b2r[x] = b2s[acc_col(t, 2 * x) + (x & 1)];
  PROBE(long long pw = 0, pm = 0, pe = 0, ps = 0, items = 0;)
  for (int k = w; k < n; k += F_WGS) {
    const int s = k % F_NST, p0 = (i0 + k) * F_TP;
    unsigned char* st = ring + s * sb;
    PROBE(long long c = clock64();)
    if (k > w) reuse_heads(t, bar);
    PROBE(ps += clock64() - c; c = clock64();)
    mbar_wait(&full[s], (k / F_NST) & 1);
    PROBE(pw += clock64() - c; c = clock64();)
    for (int cb = 0; cb + 1 < nch; cb += 2)
      to_h1_pair<ACT>(st + cb * TILE, bc, cb * 64, KI, p0, N, t);
    if (nch & 1) to_h1<ACT>(st + (nch - 1) * TILE, bc, (nch - 1) * 64, KI, p0, N, t);
    fence_async_smem();
    bar_sync(bar, 128);
    acc_fence<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < F_MAXKI / 64; ++cb)
      if (cb < nch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<128, 0, 1>(acc, gmma_desc(st + cb * TILE + kk * 32, 16, 1024),
                           gmma_desc(w2s + cb * TILE + kk * 2048, half, 1024),
                           cb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence<64>(acc);
    PROBE(pm += clock64() - c; c = clock64();)
    // h2 over h1 in the stage's first two tiles; then the stage is free
    r1_heads<ACT>(acc, hd, st, wht, b2r, t, bar);
    if (t == 0) mbar_arrive(&empty[s]);
    put_heads(hd, hb, out, bhs, p0, 0, N, 1, D, t);
    PROBE(pe += clock64() - c; c = clock64();)
    flush_heads(hb, out, p0, 0, 0, N, 1, D, t, bar);
    PROBE(ps += clock64() - c; ++items;)
  }
  if (t == 0) tma_store_wait_all();
  PROBE(r1_probe_add(0, t == 0 && w == 0, items, pw, pm, pe, ps, 0);)
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
  // b2 at the thread's 32 columns of the accumulator; the running sums of
  // dbh (its g) and of db2 (its columns), reduced once at the end
  float acc[64], dwh[2][8], gv[8], b2r[32], gacc[8], cs2[32];
#pragma unroll
  for (int x = 0; x < 8; ++x) dwh[0][x] = dwh[1][x] = gacc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    b2r[x] = b2s[acc_col(t, 2 * x) + (x & 1)];
    cs2[x] = 0.f;
  }
  int it = 0;
  long long pw = 0;
  PROBE(long long pm = 0, pe = 0, ps = 0;)
  for (int i = i0; i < i1; ++i) {
    const int p0w = i * FWD_TM + w * TM;
    PROBE(long long c = clock64();)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      gv[e] = p0w + gp < N && gd0 + e < D
                  ? __ldg(g + (size_t)(p0w + gp) * D + gd0 + e) : 0.f;
    pre2_mainloop<ACT>(acc, ring, full, empty, bc, it, nch, KI, p0w, N, t, w,
                       bar, pw);
    PROBE(pm += clock64() - c; c = clock64();)
    // the last tile's bf16(dpre2) has left h
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
    PROBE(ps += clock64() - c; c = clock64();)
    // h2 = bf16(act(pre2 + b2)) into h; g16^T into its tile
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * (t & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(h + (n >> 6) * TILE + at(acc_row(t, x), n & 63)) =
            pack2(act_fn(acc[x] + b2r[2 * j], ACT),
                  act_fn(acc[x + 1] + b2r[2 * j + 1], ACT));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      *reinterpret_cast<__nv_bfloat16*>(gt + at(gd0 + e, gp)) =
          __float2bfloat16(gv[e]);
      gacc[e] += gv[e];
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
    // dpre2 = dh2 act'(h2) over h2 in place, as bf16 (h2's words all read
    // before any is written); db2's running sums
    uint32_t hv[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int n = acc_col(t, 2 * x);
      hv[x] = lds_u32(h + (n >> 6) * TILE + at(acc_row(t, 2 * x), n & 63));
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hv[x]);
      const float e0 = acc[2 * x] * dact_from_h(__low2float(hb), ACT);
      const float e1 = acc[2 * x + 1] * dact_from_h(__high2float(hb), ACT);
      hv[x] = pack2(e0, e1);
      cs2[(x >> 1) * 2] += e0;
      cs2[(x >> 1) * 2 + 1] += e1;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int n = acc_col(t, 2 * x);
      *reinterpret_cast<uint32_t*>(
          h + (n >> 6) * TILE + at(acc_row(t, 2 * x), n & 63)) = hv[x];
    }
    fence_async_smem();
    bar_sync(bar, 128);
    PROBE(pe += clock64() - c; c = clock64();)
    if (t == 0 && p0w < N) {
      for (int a = 0; a < (K > 64 ? 2 : 1); ++a)
        tma_store_3d(&map_dp, h + a * TILE, a * 64, 0, p0w);
      tma_store_commit();
    }
    PROBE(ps += clock64() - c;)
  }
  if (t == 0) tma_store_wait_all();
  PROBE(r1_probe_add(1, t == 0 && w == 0, i1 - i0, pw, pm - pw, pe, ps, 0);)

  // db2: the thread's column sums over the warp's eight row pairs, then
  // the four warps' in order; dbh: the 64 positions' g sums in order
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int x = 0; x < 32; ++x)
      cs2[x] += __shfl_xor_sync(0xffffffffu, cs2[x], off);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(red + q * 128 + 8 * j + 2 * lane) =
          make_float2(cs2[2 * j], cs2[2 * j + 1]);
#pragma unroll
  for (int e = 0; e < 8; ++e) gf[gp * 16 + gd0 + e] = gacc[e];
  bar_sync(bar, 128);
  const float db2 = ((red[t] + red[128 + t]) + red[256 + t]) + red[384 + t];
  float dbh = 0.f;
  if (t < 16)
    for (int p = 0; p < 64; ++p) dbh += gf[p * 16 + t];

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
  PROBE(long long pw = 0, pm = 0, pe = 0, ps = 0, px = 0;)
  for (int i = i0; i < i1; ++i, ++it) {
    const int s = it % C_STAGES, p0w = i * FWD_TM + w * TM;
    unsigned char* st = ring + s * C_STAGE;
    unsigned char* h1 = st + w * TILE;
    const unsigned char* dp = st + (2 + 2 * w) * TILE;
    PROBE(long long c = clock64();)
    mbar_wait(&full[s], (it / C_STAGES) & 1);
    PROBE(pw += clock64() - c; c = clock64();)
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
    PROBE(pm += clock64() - c; c = clock64();)
    // the last tile's dpre1 has left outw
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
    PROBE(ps += clock64() - c; c = clock64();)
    // dpre1 = dh1 act'(h1) (rows past N zero: a factor, not a branch) into
    // the bf16 out tile, h1's words all read first; dbc
    uint32_t hv[16];
#pragma unroll
    for (int x = 0; x < 16; ++x)
      hv[x] = lds_u32(h1 + at(acc_row(t, 2 * x), acc_col(t, 2 * x)));
    const float in0 = p0w + acc_row(t, 0) < N ? 1.f : 0.f;
    const float in1 = p0w + acc_row(t, 2) < N ? 1.f : 0.f;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float in = x & 1 ? in1 : in0;
      const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hv[x]);
      const float e0 = (dh[2 * x] * in) * dact_from_h(__low2float(hb), ACT);
      const float e1 = (dh[2 * x + 1] * in) * dact_from_h(__high2float(hb), ACT);
      *reinterpret_cast<uint32_t*>(
          outw + at(acc_row(t, 2 * x), acc_col(t, 2 * x))) = pack2(e0, e1);
      cs[(x >> 1) * 2] += e0;
      cs[(x >> 1) * 2 + 1] += e1;
    }
    fence_async_smem();
    bar_sync(bar, 128);
    PROBE(pe += clock64() - c; c = clock64();)
    if (t == 0 && p0w < N) {
      tma_store_3d(&map_out, outw, c0, 0, p0w);
      tma_store_commit();
    }
    PROBE(ps += clock64() - c; c = clock64();)
    wgmma_wait<0>();
    acc_fence<64>(dm);
    PROBE(px += clock64() - c;)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (t == 0) tma_store_wait_all();
  PROBE(r1_probe_add(2, t == 0 && w == 0, i1 - i0, pw, pm, pe, ps, px);)

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
  if (KI <= F_MAXKI) {
    const int nch = (KI + 63) / 64;
    const size_t smem = 1024 + f_heads(nch) + (size_t)F_WGS * F_TP * D * 4;
    if ((err = allow_smem(r1_fwd_resident_kernel<ACT>, smem))) return err;
    r1_fwd_resident_kernel<ACT><<<G, F_THREADS, smem, stream>>>(
        m_p, (const float*)bc, (const __nv_bfloat16*)w2, (const float*)b2,
        (const __nv_bfloat16*)wh, (const float*)bh, (float*)out, N, KI, K, D,
        chunk);
    return (int)cudaGetLastError();
  }
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

#ifdef TVAE_PROBE
// Copies the R = 1 probe's 18 sums out and zeroes them.
extern "C" int tvae_probe_mix_heads_r1(void* host) {
  int e = (int)cudaMemcpyFromSymbol(host, chain::r1_probe,
                                    sizeof(chain::r1_probe));
  const unsigned long long z[18] = {};
  return e ? e : (int)cudaMemcpyToSymbol(chain::r1_probe, z, sizeof(z));
}
#endif

// K1 at R = 1. pre1 (N, KI) bf16, KI % 8 == 0; bc (KI,), b2 (K,), bh (D,)
// f32; w2 (KI, K), wh (K, D) bf16; out (N, D) f32. G blocks of `chunk`
// tiles of 64 positions with W2 resident (KI <= 256), else of 128
// positions with W2 streamed (kernels/mix_heads.py::r1_fwd_schedule).
extern "C" int tvae_mix_heads_r1_fwd(const void* pre1, const void* bc,
                                     const void* w2, const void* b2,
                                     const void* wh, const void* bh, void* out,
                                     int N, int KI, int K, int D, int G,
                                     int chunk, int act, void* stream) {
  const int tile = KI <= chain::F_MAXKI ? chain::F_TP : chain::FWD_TM;
  const long long tiles = (long long)(N + tile - 1) / tile;
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
