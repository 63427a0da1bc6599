// K1: fused lift-activation + mixing + heads, forward.
//
// Replaces targetvae_tpu/kernels/mix_heads.py::_fwd_kernel (lift=True), the
// Pallas kernel behind fused_lift_act_mix_heads (pallas_call at :232). Per
// position p and rotation r, with pre1 the raw lift-conv output (N, R*K)
// bf16, r-major channels:
//   h1 = bf16(act(pre1[p, r*K:(r+1)*K] + bc[r*K:(r+1)*K]))
//   h2 = bf16(act(h1 @ W2 + b2))           W2 (K, K) bf16, f32 accumulation
//   out[p, r*D:(r+1)*D] = h2 @ Wh + bh     Wh (K, D) bf16, f32 accumulation
//
// What bounds it on the H100: the bytes. At the flagship shape (N =
// 100*39*39 = 152,100 positions, R = 8, K = 128, D = 7) it reads 311 MB of
// pre1 and writes 36 MB of heads, 0.103 ms at 3.35 TB/s, against ~0.04 TFLOP
// of products (~0.04 ms at the bf16 peak).
//
// Design: the producer side of K2's chain kernel below, with the forward
// tail of csrc/encoder_chain.cuh as its consumers:
//  - a persistent grid of about one block per SM over the (128-position
//    tile, rotation) items, rotations inner (kernels/mix_heads.py::
//    chain_schedule with tile 128);
//  - the chain's TMA thread keeps a ring of items in flight, each the two
//    64 x K slices of pre1 of the tile's halves from the 3-D map (K, R, N),
//    128-byte swizzled, zero past K and N; its loader warps turn pre1 into
//    h1 = bf16(act(pre1 + bc)) in place, seven of them here (a second
//    producer warpgroup: with K2's three they set K1's pace);
//  - consumer warpgroup w takes the item's positions [64 w, 64 w + 64):
//    pre2 = h1 W2 on wgmma (W2 resident), bias and act from the
//    accumulators into a bf16 h2 over h1, heads = h2 Wh (m64n16, Wh^T
//    resident and zero-padded to 16 heads), + bh;
//  - a tile's heads are one contiguous run of 64 R D f32 of out for each
//    warpgroup: they stay in shared memory across the tile's R rotations
//    and leave as one bulk copy (plain stores for a tile split between two
//    blocks or a ragged last tile whose bytes are no multiple of 16). Where
//    that buffer does not fit beside the ring (128 R D f32), the heads go
//    straight to out.
// The activation is a template constant of the kernel, so that the
// epilogues and the loaders' conversion compile to straight-line code: with
// it read at run time, a clock64 probe (tools/probe_encoder_fwd.py) showed
// the epilogues setting the pace of K11. What sets K1's pace now is the
// consumers' tail (the same probe, PERF.md section 6), not the loads.
#include "encoder_chain.cuh"

namespace {

// K2: the backward of K1, and the first pass of K12 (csrc/lifted_encoder.cu).
//
// Replaces targetvae_tpu/kernels/mix_heads.py::_bwd_kernel (lift=True), the
// Pallas kernel of _bwd (pallas_call at :269), and the chain half of
// targetvae_tpu/kernels/lifted_encoder.py::_bwd_kernel. Per position p and
// rotation r, with W2 (K, K) shared by every rotation and g16 = bf16(g):
//   h1 = bf16(act(pre1 + bc))  (K2)   or the bf16 h1 the forward saved (K12)
//   h2 = bf16(act(pre2)), pre2 = h1 W2 + b2
//   dWh += h2^T g16         dbh += sum g
//   dh2  = g16 Wh^T         dpre2 = dh2 act'(h2) (K2) or dh2 act'(pre2) (K12),
//                           each as its TPU kernel takes it (they differ for tanh)
//   dW2 += h1^T bf16(dpre2) db2 += sum dpre2
//   dpre1 = (bf16(dpre2) W2^T) act'(h1), written as bf16 (N, R*K)
//   dbc  = sum dpre1, taken in f32 before the rounding
//
// What bounds it on the H100: the bytes. At the flagship (N = 152,100, R = 8,
// K = 128, D = 7) it reads 311 MB of pre1 (or h1) and writes 311 MB of
// dpre1, ~0.19 ms at 3.35 TB/s, against 0.12 TFLOP of products, ~0.12 ms
// at the bf16 peak.
//
// Design (the wgmma/TMA principles of csrc/decoder_wgmma.cuh):
//  - a persistent grid of about one block per SM; block b takes the work
//    items [b chunk, (b + 1) chunk) of the (64-position tile, rotation)
//    walk, rotations inner (kernels/mix_heads.py::chain_schedule);
//  - one TMA thread keeps a ring of STAGES items in flight: the 64 x K
//    slice of pre1 or h1 of one rotation, 128-byte swizzled, from a 3-D map
//    (K, R, N) so that what lies past K or N reads as zero. Three loader
//    warps write g16 transposed (16 heads x 64 positions, one 2 KB tile a
//    stage) with dbh's sums on the way, and for K2 turn pre1 into h1 in
//    place (bias, act, rows past N zeroed). g comes by plain loads, not a
//    TMA box: its row stride R D 4 bytes need not be the multiple of 16
//    that a tensor map requires (R = 1, D = 7), and a tile's 64 x R D f32
//    (up to 64 KB at R = 16, D = 16) does not fit beside the ring;
//  - W2 (two 128 x 64 column tiles) and Wh (128 x 16 used) stay resident,
//    zero-padded to 128 channels: K < 128 runs the same kernel, its padding
//    zero in every product and masked out of every sum and store;
//  - two consumer warpgroups split the 128 channels, 64 each: pre2 = h1 W2
//    (W2 as the MN-major B), dh2 = g16 Wh^T (g16^T as the MN-major A, one
//    k16 step), dh1 = bf16(dpre2) W2^T (W2 as the K-major B), dW2 +=
//    h1^T bf16(dpre2) (two m64 halves, h1 as the MN-major A, the 64
//    positions as k) and dWh += h2^T g16 (m64n16), the weight gradients
//    accumulating in registers over all of the block's items;
//  - epilogues from the accumulator registers: bias and act into the bf16
//    h2 tile, dpre2 in place, bf16(dpre2) into a double-buffered tile (the
//    A operand of dh1, which needs both warpgroups' halves: one named
//    barrier an item), dpre1 = dh1 act'(h1) into a tile that a TMA store
//    writes out while dW2 and dWh still run. No f32 staging tile;
//  - column sums by warp shuffles over the 16 rows of a warp and one
//    shared-memory pass (db2 once a block, dbc once an item, both from
//    registers); each block writes its partials to its own row of `part`
//    and csrc/reduce.cu adds the rows in order: no f32 atomics, reruns
//    bitwise equal.
namespace chain {

constexpr int GT = 16 * 128;           // g16^T: 16 heads x 64 positions
constexpr int STAGE = HT + GT;         // one item's h1 (or pre1) and g16^T
constexpr int STAGES = 4;
constexpr int LOADERS = 96;            // producer warps 1-3
// g's loads: loader lt takes head lt % D of the positions lt / D + k G,
// G = LOADERS / D groups, so a warp reads ~32 / D rows' D-float pieces at
// once; at most GPER positions a loader (D = 16)
constexpr int GPER = (TM + LOADERS / 16 - 1) / (LOADERS / 16);
constexpr int THREADS = 384;
// setmaxnreg: the block holds 384 x 168 registers; the producers keep 88
// (the loaders' conversion has eight values in flight), the two consumer
// warpgroups get (64,512 - 128 x 88) / 256 = 208
constexpr int PROD_REGS = 88;
constexpr int CONS_REGS = (64512 - 128 * PROD_REGS) / 256 / 8 * 8;

// byte offsets from the 1,024-aligned base of the dynamic shared memory
constexpr int O_W2 = 0;
constexpr int O_WH = O_W2 + 2 * W2T;
constexpr int O_RING = O_WH + W2T;
constexpr int O_H2 = O_RING + STAGES * STAGE;
constexpr int O_DP = O_H2 + HT;          // two buffers
constexpr int O_OUT = O_DP + 2 * HT;
constexpr int O_B2 = O_OUT + HT;
constexpr int O_RED = O_B2 + KP * 4;     // (8 warps, 64 columns) f32
constexpr int O_GRED = O_RED + 8 * 64 * 4;
constexpr int O_BARS = O_GRED + LOADERS * 4;
constexpr int O_BC = O_BARS + 3 * STAGES * 8;   // dbc's sums, R K f32
inline size_t smem_bytes(int R, int K) {
  return 1024 + O_BC + (size_t)R * K * 4;
}

// act' from the f32 input v and a = act(v)
__device__ __forceinline__ float dact_pre(float v, float a, int act) {
  return act == 1 ? 1.f - a * a : (v >= 0.f ? 1.f : 0.01f);
}

template <int R_>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < R_; ++i) d[i] = 0.f;
}

// The producers of the chain kernels (the threads from 256 on). The TMA
// thread (256)
// keeps a ring of STAGES items (`stage` bytes each) in flight: for each of
// the item's HALVES 64-position slices with positions below N, one or two
// 64-channel boxes of pre1 or h1 from the 3-D map (K, R, N), what lies past
// K or N reading as zero. The NLOAD loader threads (from 288 on: three
// warps in the backward, seven in K1) turn pre1 into h1 = bf16(act(pre1 +
// bc)) in place without FROM_H1, rows past N and channels past K zero; with
// WITH_G (the backward) they also write g16 transposed after the slice (16 heads x 64 positions, one 2 KB
// tile) with dbh's sums on the way, into pbh.
template <bool FROM_H1, bool WITH_G, int HALVES, int NLOAD>
__device__ __forceinline__ void produce(
    const CUtensorMap* map_in, unsigned char* ring, int stage,
    uint64_t* tfull, uint64_t* full, uint64_t* empty,
    const float* __restrict__ bc, const float* __restrict__ g, float* gred,
    float* pbh, int i0, int i1, int N, int R, int K, int D, int act,
    int tid) {
  static_assert(!WITH_G || NLOAD == LOADERS, "g's loads assume 96 loaders");
  const int lane = tid & 31;
  const int nbox = K > 64 ? 2 : 1;       // 64-channel boxes a slice holds
  if (tid == 256) {
    for (int i = i0, it = 0; i < i1; ++i, ++it) {
      const int s = it % STAGES, p0 = (i / R) * TM * HALVES;
      const int nh = HALVES == 1 ? 1 : min(HALVES, (N - p0 + TM - 1) / TM);
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&tfull[s], nh * nbox * TILE);
      for (int h = 0; h < nh; ++h)
        for (int a = 0; a < nbox; ++a)
          tma_load_3d(ring + s * stage + h * HT + a * TILE, map_in, &tfull[s],
                      a * 64, i % R, p0 + h * TM);
    }
  } else if (tid >= 288) {
    const int lt = tid - 288, G = NLOAD / D, grp = lt / D, d = lt - grp * D;
    const int RD = R * D;
    float gs = 0.f;
    for (int i = i0, it = 0; i < i1; ++i, ++it) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
      const int p0 = (i / R) * TM * HALVES, r = i % R;
      unsigned char* st = ring + s * stage;
      mbar_wait(&empty[s], ph ^ 1);
      // g16^T: row d holds head d of the 64 positions (rows past D zero);
      // a thread's loads are all issued before the first is used
      if (WITH_G && grp < G) {
        float v[GPER];
#pragma unroll
        for (int k = 0; k < GPER; ++k) {
          const int p = grp + k * G;
          v[k] = p < TM && p0 + p < N ? g[(size_t)(p0 + p) * RD + r * D + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < GPER; ++k) {
          const int p = grp + k * G;
          if (p < TM) {
            gs += v[k];
            *reinterpret_cast<__nv_bfloat16*>(st + HT + at(d, p)) =
                __float2bfloat16(v[k]);
          }
        }
      }
      if (!FROM_H1) {
        // h1 = bf16(act(pre1 + bc)) in place; rows past N and channels
        // past K zero (K % 8 == 0: a 16-byte chunk is in or out whole)
        mbar_wait(&tfull[s], ph);
        for (int idx = lt; idx < HALVES * nbox * TM * 8; idx += NLOAD) {
          const int q = idx >> 9, p = (idx >> 3) & 63, cc = idx & 7;
          const int hh = HALVES == 1 ? 0 : q >> (nbox - 1), a = q - hh * nbox;
          const int c0 = a * 64 + cc * 8, row = p0 + hh * TM + p;
          uint4* qp = reinterpret_cast<uint4*>(st + hh * HT + a * TILE + swz(p, cc));
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (row < N && c0 < K) {
            const uint4 raw = *qp;
            const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
            const float* bcr = bc + r * K + c0;
            uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ov[e] = pack2(act_fn(__low2float(x[e]) + __ldg(bcr + 2 * e), act),
                            act_fn(__high2float(x[e]) + __ldg(bcr + 2 * e + 1), act));
          }
          *qp = o;
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    if (WITH_G) {
      // dbh: the groups' sums added in order
      gred[lt] = gs;
      bar_sync(4, LOADERS);
      if (lt < D) {
        float v = 0.f;
        for (int k = 0; k < G; ++k) v += gred[k * D + lt];
        pbh[lt] = v;
      }
    }
  }
}

template <bool FROM_H1, bool DACT_PRE2>
__global__ void __launch_bounds__(THREADS, 1) chain_kernel(
    const __grid_constant__ CUtensorMap map_in,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ g,
    float* __restrict__ part, int N, int R, int K, int D, int chunk, int SP,
    int act) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* w2s = base + O_W2;
  unsigned char* whs = base + O_WH;
  unsigned char* ring = base + O_RING;
  unsigned char* h2t = base + O_H2;
  unsigned char* dpt = base + O_DP;
  unsigned char* outt = base + O_OUT;
  float* b2s = reinterpret_cast<float*>(base + O_B2);
  float* red = reinterpret_cast<float*>(base + O_RED);
  float* gred = reinterpret_cast<float*>(base + O_GRED);
  uint64_t* tfull = reinterpret_cast<uint64_t*>(base + O_BARS);
  uint64_t* full = tfull + STAGES;
  uint64_t* empty = full + STAGES;
  float* sbc = reinterpret_cast<float*>(base + O_BC);

  const int tid = threadIdx.x, lane = tid & 31;
  const int total = (N + TM - 1) / TM * R;
  const int i0 = blockIdx.x * chunk, i1 = min(total, i0 + chunk);
  const int nbox = K > 64 ? 2 : 1;       // 64-channel boxes an item holds
  float* pb = part + (size_t)blockIdx.x * SP;
  const int o_wh = K * K, o_b2 = o_wh + K * D, o_bh = o_b2 + K,
            o_bc = o_bh + D;

  // the ring and the bf16 tiles after it zero (padding stays zero), up to
  // b2s, which other threads write before the barrier below; the weights
  // zero-padded to 128 channels
  for (int o = O_RING + tid * 16; o < O_B2; o += THREADS * 16)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
  stage_w2(w2s, w2, K, tid, THREADS);
  for (int idx = tid; idx < KP * 8; idx += THREADS) {
    const int i = idx >> 3, cc = idx & 7;
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = cc * 8 + e;
      h[e] = i < K && d < D ? wh[i * D + d] : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(whs + swz(i, cc)) = *reinterpret_cast<uint4*>(h);
  }
  for (int c = tid; c < KP; c += THREADS) b2s[c] = c < K ? b2[c] : 0.f;
  for (int i = tid; i < R * K; i += THREADS) sbc[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&full[s], LOADERS / 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    // ---- producers: the TMA thread, then three loader warps ----
    reg_dealloc<PROD_REGS>();
    produce<FROM_H1, true, 1, LOADERS>(&map_in, ring, STAGE, tfull, full,
                                       empty, bc, g, gred, pb + o_bh, i0, i1,
                                       N, R, K, D, act, tid);
    return;
  }

  // ---- consumers: warpgroup w owns channels [64 w, 64 w + 64) ----
  reg_alloc<CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, q = t >> 5;
  const int r0 = acc_row(t, 0);          // this thread's rows r0, r0 + 8
  float pa[32], dg[32], dw2[2][32], dwh[8], cs[16];
  zero<32>(dw2[0]);
  zero<32>(dw2[1]);
  zero<8>(dwh);
  zero<16>(cs);
  unsigned char* h2w = h2t + w * TILE;
  unsigned char* outw = outt + w * TILE;
  int it = 0;
  for (int i = i0; i < i1; ++i, ++it) {
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    const int p0 = (i / R) * TM, r = i % R;
    const unsigned char* st = ring + s * STAGE;
    const unsigned char* gt = st + HT;
    unsigned char* dp = dpt + (it & 1) * HT;
    mbar_wait(&tfull[s], ph);
    mbar_wait(&full[s], ph);

    // pre2 = h1 W2[:, own]; dh2 = g16 Wh[own]^T
    acc_fence<32>(pa);
    acc_fence<32>(dg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk < 4 * nbox)
        wgmma<64, 0, 1>(pa, gmma_desc(st + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                        gmma_desc(w2s + w * W2T + kk * 2048, TILE, 1024), kk > 0);
    wgmma<64, 1, 0>(dg, gmma_desc(gt, TILE, 1024),
                    gmma_desc(whs + w * TILE, 16, 1024), 0);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence<32>(pa);
    acc_fence<32>(dg);

    // h2 = bf16(act(pre2 + b2)); dpre2 = dh2 act'; db2's sums; bf16(dpre2)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * (t & 3);
      const float bb0 = b2s[64 * w + n], bb1 = b2s[64 * w + n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h, row = r0 + 8 * h;
        const float v0 = pa[x] + bb0, v1 = pa[x + 1] + bb1;
        const float a0 = act_fn(v0, act), a1 = act_fn(v1, act);
        const uint32_t hh = pack2(a0, a1);
        float d0, d1;
        if (DACT_PRE2) {
          d0 = dact_pre(v0, a0, act);
          d1 = dact_pre(v1, a1, act);
        } else {
          const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hh);
          d0 = dact_from_h(__low2float(hb), act);
          d1 = dact_from_h(__high2float(hb), act);
        }
        dg[x] *= d0;
        dg[x + 1] *= d1;
        cs[2 * j] += dg[x];
        cs[2 * j + 1] += dg[x + 1];
        *reinterpret_cast<uint32_t*>(h2w + at(row, n)) = hh;
        *reinterpret_cast<uint32_t*>(dp + w * TILE + at(row, n)) =
            pack2(dg[x], dg[x + 1]);
      }
    }
    fence_async_smem();
    if (t == 0) tma_store_wait_read();   // the last dpre1 tile has left
    bar_sync(1, 256);                    // both halves of bf16(dpre2)

    // dh1 = bf16(dpre2) W2[own]^T; then dW2 += h1^T bf16(dpre2)[:, own] and
    // dWh[own] += h2[:, own]^T g16, still running through the epilogue
    acc_fence<32>(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk < 4 * nbox)
        wgmma<64, 0, 0>(pa, gmma_desc(dp + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                        gmma_desc(w2s + (kk >> 2) * W2T + w * TILE + (kk & 3) * 32,
                                  16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (mt < nbox)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<64, 1, 1>(dw2[mt], gmma_desc(st + mt * TILE + kk * 2048, TILE, 1024),
                          gmma_desc(dp + w * TILE + kk * 2048, TILE, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<16, 1, 0>(dwh, gmma_desc(h2w + kk * 2048, TILE, 1024),
                      gmma_desc(gt + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<32>(pa);

    // dpre1 = dh1 act'(h1) -> the bf16 out tile; dbc's sums of this item
    const unsigned char* h1w = st + w * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * (t & 3);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 4 * j + 2 * h, row = r0 + 8 * h;
        const __nv_bfloat162 hb =
            *reinterpret_cast<const __nv_bfloat162*>(h1w + at(row, n));
        const float e0 = pa[x] * dact_from_h(__low2float(hb), act);
        const float e1 = pa[x + 1] * dact_from_h(__high2float(hb), act);
        *reinterpret_cast<uint32_t*>(outw + at(row, n)) = pack2(e0, e1);
        s0 += e0;
        s1 += e1;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[(w * 4 + q) * 64 + n] = s0;
        red[(w * 4 + q) * 64 + n + 1] = s1;
      }
    }
    fence_async_smem();
    bar_sync(2 + w, 128);
    if (t == 0 && 64 * w < K) {
      tma_store_3d(&map_out, outw, 64 * w, r, p0);
      tma_store_commit();
    }
    if (t < 64 && 64 * w + t < K) {
      const float* rw = red + w * 4 * 64 + t;
      sbc[r * K + 64 * w + t] += ((rw[0] + rw[64]) + rw[128]) + rw[192];
    }
    wgmma_wait<0>();
    acc_fence<32>(dw2[0]);
    acc_fence<32>(dw2[1]);
    acc_fence<8>(dwh);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (t == 0) tma_store_wait_all();

  // this block's partials: [dW2 K*K | dWh K*D | db2 K | dbh D | dbc R*K]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      const int m = 64 * mt + acc_row(t, x), n = 64 * w + acc_col(t, x);
      if (m < K && n < K)
        *reinterpret_cast<float2*>(pb + m * K + n) =
            make_float2(dw2[mt][x], dw2[mt][x + 1]);
    }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int c = 64 * w + acc_row(t, x), d = acc_col(t, x);
    if (c < K && d < D) pb[o_wh + c * D + d] = dwh[x];
  }
  bar_sync(1, 256);                      // every item's reads of red are done
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
      red[(w * 4 + q) * 64 + n] = s0;
      red[(w * 4 + q) * 64 + n + 1] = s1;
    }
  }
  bar_sync(1, 256);
  if (t < 64 && 64 * w + t < K) {
    const float* rw = red + w * 4 * 64 + t;
    pb[o_b2 + 64 * w + t] = ((rw[0] + rw[64]) + rw[128]) + rw[192];
  }
  for (int x = tid; x < R * K; x += 256) pb[o_bc + x] = sbc[x];
}

template <bool FROM_H1, bool DACT_PRE2>
int launch(const void* src, const void* bc, const void* w2, const void* b2,
           const void* wh, const void* g, void* dpre1, void* part, int N,
           int R, int K, int D, int G, int chunk, int SP, int act,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(R, K);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap m_in, m_out;
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)N};
  const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)R * K * 2};
  const uint32_t box[3] = {64, 1, TM};
  int err;
  if ((err = make_map_strided(&m_in, src, 3, dims, strides, box))) return err;
  if ((err = make_map_strided(&m_out, dpre1, 3, dims, strides, box))) return err;
  if ((err = allow_smem(chain_kernel<FROM_H1, DACT_PRE2>, smem))) return err;
  chain_kernel<FROM_H1, DACT_PRE2><<<G, THREADS, smem, stream>>>(
      m_in, m_out, (const float*)bc, (const __nv_bfloat16*)w2,
      (const float*)b2, (const __nv_bfloat16*)wh, (const float*)g,
      (float*)part, N, R, K, D, chunk, SP, act);
  return (int)cudaGetLastError();
}

// ---- K1: the forward of the chain (csrc/encoder_chain.cuh's tail) ----
constexpr int FSTAGE = 2 * HT;           // an item: two 64-position slices
// With K2's three loader warps K1 took 0.455 ms at the flagship, with seven
// 0.262 (H100 80GB HBM3, 700 W, chip_smoke.py), so its block has a second
// producer warpgroup: 512 threads, the TMA thread's warp and seven loader
// warps beside the two consumer warpgroups, 128 registers each (no
// reallocation)
constexpr int F_THREADS = 512;
constexpr int F_LOADERS = F_THREADS - 288;
constexpr int F_W2 = 0;
constexpr int F_WHT = F_W2 + 2 * W2T;
constexpr int F_RING = F_WHT + WHT;      // 1,024-aligned
constexpr int F_B2 = F_RING + STAGES * FSTAGE;
constexpr int F_BH = F_B2 + KP * 4;
constexpr int F_BARS = F_BH + 16 * 4;
constexpr int F_HB = F_BARS + 3 * STAGES * 8;   // the heads, 128 R D f32

template <int ACT>
__global__ void __launch_bounds__(F_THREADS, 1) fwd_kernel(
    const __grid_constant__ CUtensorMap map_in, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bh,
    float* __restrict__ out, int N, int R, int K, int D, int chunk,
    int buffered) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* w2s = base + F_W2;
  unsigned char* wht = base + F_WHT;
  unsigned char* ring = base + F_RING;
  float* b2s = reinterpret_cast<float*>(base + F_B2);
  float* bhs = reinterpret_cast<float*>(base + F_BH);
  uint64_t* tfull = reinterpret_cast<uint64_t*>(base + F_BARS);
  uint64_t* full = tfull + STAGES;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int total = (N + FWD_TM - 1) / FWD_TM * R;
  const int i0 = blockIdx.x * chunk, i1 = min(total, i0 + chunk);
  // the ring zero (boxes past K are never loaded), the weights zero-padded
  for (int o = F_RING + tid * 16; o < F_B2; o += F_THREADS * 16)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
  stage_w2(w2s, w2, K, tid, F_THREADS);
  stage_wht(wht, wh, K, D, tid, F_THREADS);
  for (int c = tid; c < KP; c += F_THREADS) b2s[c] = c < K ? b2[c] : 0.f;
  if (tid < 16) bhs[tid] = tid < D ? bh[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&full[s], F_LOADERS / 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    produce<false, false, 2, F_LOADERS>(&map_in, ring, FSTAGE, tfull, full,
                                        empty, bc, nullptr, nullptr, nullptr,
                                        i0, i1, N, R, K, D, ACT, tid);
    return;
  }

  // ---- consumers: warpgroup w owns the item's positions [64 w, 64 w + 64) ----
  const int t = tid & 127, w = tid >> 7, bar = 2 + w, nk = (K + 15) / 16;
  float* hb = buffered ? reinterpret_cast<float*>(base + F_HB) + w * TM * R * D
                       : nullptr;
  float acc[64], hd[8];
  int ra = 0;                            // the first rotation of this tile here
  long long seg[4] = {0, 0, 0, 0};     // the probe's tail segments
  PROBE(long long pw = 0, pr = 0;)
  for (int i = i0, it = 0; i < i1; ++i, ++it) {
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    const int r = i % R, p0w = (i / R) * FWD_TM + w * TM;
    PROBE(const long long c0 = clock64();)
    if (i == i0 || r == 0) {
      ra = r;
      if (hb && i > i0) reuse_heads(t, bar);
    }
    mbar_wait(&tfull[s], ph);
    mbar_wait(&full[s], ph);
    PROBE(const long long c1 = clock64(); pw += c1 - c0;)
    fwd_tail(acc, hd, ring + s * FSTAGE + w * HT, w2s, wht, b2s, nk, t, ACT,
             false, bar, seg);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    PROBE(const long long c2 = clock64();)
    put_heads(hd, hb, out, bhs, p0w, r, N, R, D, t);
    if (hb && (i + 1 == i1 || r == R - 1))
      flush_heads(hb, out, p0w, ra, r, N, R, D, t, bar);
    PROBE(pr += clock64() - c1; seg[3] += clock64() - c2;)
  }
  if (t == 0) tma_store_wait_all();
  PROBE(probe_add(t, w, pw, 0, pr, i1 - i0, seg);)
}

template <int ACT>
int launch_fwd(const void* pre1, const void* bc, const void* w2,
               const void* b2, const void* wh, const void* bh, void* out,
               int N, int R, int K, int D, int G, int chunk,
               cudaStream_t stream) {
  CUtensorMap m_in;
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)N};
  const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)R * K * 2};
  const uint32_t box[3] = {64, 1, TM};
  int err;
  if ((err = make_map_strided(&m_in, pre1, 3, dims, strides, box))) return err;
  const size_t fixed = 1024 + F_HB, heads = (size_t)FWD_TM * R * D * 4;
  const int buffered = fixed + heads <= 232448;
  const size_t smem = fixed + (buffered ? heads : 0);
  if ((err = allow_smem(fwd_kernel<ACT>, smem))) return err;
  fwd_kernel<ACT><<<G, F_THREADS, smem, stream>>>(
      m_in, (const float*)bc, (const __nv_bfloat16*)w2, (const float*)b2,
      (const __nv_bfloat16*)wh, (const float*)bh, (float*)out, N, R, K, D,
      chunk, buffered);
  return (int)cudaGetLastError();
}

}  // namespace chain

}  // namespace

int mix_heads_bwd_run(const void* src, const void* bc, const void* w2,
                      const void* b2, const void* wh, const void* g,
                      void* dpre1, void* part, void* out, int N, int R, int K,
                      int D, int G, int chunk, int SP, int act, int from_h1,
                      cudaStream_t s) {
  const long long items = (long long)(N + chain::TM - 1) / chain::TM * R;
  if ((K != 16 && K != 32 && K != 64 && K != 128) || D < 1 || D > 16 ||
      R < 1 || G < 1 || chunk < 1 || (long long)G * chunk < items ||
      (long long)(G - 1) * chunk >= items || SP % 8 ||
      SP < K * K + K * D + K + D + R * K)
    return (int)cudaErrorInvalidValue;
  const int err =
      from_h1 ? chain::launch<true, true>(src, bc, w2, b2, wh, g, dpre1, part,
                                          N, R, K, D, G, chunk, SP, act, s)
              : chain::launch<false, false>(src, bc, w2, b2, wh, g, dpre1,
                                            part, N, R, K, D, G, chunk, SP,
                                            act, s);
  if (err) return err;
  return sum_partials((const float*)part, (float*)out, 1, G, SP, s);
}

// part: (G, SP) f32 scratch; out: (SP,) f32, the first
// K*K + K*D + K + D + R*K entries of which receive
// [dW2 | dWh | db2 | dbh | dbc]; dpre1: (N, R*K) bf16. G blocks of `chunk`
// (tile, rotation) items each (kernels/mix_heads.py::chain_schedule).
extern "C" int tvae_mix_heads_bwd(const void* pre1, const void* bc,
                                  const void* w2, const void* b2,
                                  const void* wh, const void* g, void* dpre1,
                                  void* part, void* out, int N, int R, int K,
                                  int D, int G, int chunk, int SP, int act,
                                  void* stream) {
  return mix_heads_bwd_run(pre1, bc, w2, b2, wh, g, dpre1, part, out, N, R, K,
                           D, G, chunk, SP, act, 0, (cudaStream_t)stream);
}

TVAE_PROBE_READER(tvae_probe_mix_heads_fwd)

// pre1 (N, R*K) bf16; bc (R*K,), b2 (K,), bh (D,) f32; w2 (K, K), wh (K, D)
// bf16; out (N, R*D) f32. G blocks of `chunk` (128-position tile, rotation)
// items each (kernels/mix_heads.py::chain_schedule with tile 128).
extern "C" int tvae_mix_heads_fwd(const void* pre1, const void* bc,
                                  const void* w2, const void* b2,
                                  const void* wh, const void* bh, void* out,
                                  int N, int R, int K, int D, int G, int chunk,
                                  int act, void* stream) {
  const long long items =
      (long long)(N + chain::FWD_TM - 1) / chain::FWD_TM * R;
  if (K % 16 || K < 16 || K > chain::KP || D < 1 || D > 16 || R < 1 ||
      G < 1 || chunk < 1 || (long long)G * chunk < items ||
      (long long)(G - 1) * chunk >= items)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return act ? chain::launch_fwd<1>(pre1, bc, w2, b2, wh, bh, out, N, R, K, D,
                                    G, chunk, s)
             : chain::launch_fwd<0>(pre1, bc, w2, b2, wh, bh, out, N, R, K, D,
                                    G, chunk, s);
}
