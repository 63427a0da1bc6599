// K11: the fused patch encoder (lift GEMM + activation + mixing + heads),
// forward.
//
// Replaces targetvae_tpu/kernels/lifted_encoder.py::_fwd_kernel (pallas_call
// at :179), the Pallas kernel behind fused_lifted_encoder
// (TARGETVAE_ENCODER_TIER=patch). Per position p (a row of the im2col patch
// matrix P, (N, CK) bf16, built outside the kernel) and rotation r:
//   pre1 = P[p] @ Wc[:, r*K:(r+1)*K] + bc_r     Wc (CK, R*K) bf16, f32 sum
//   h1   = bf16(act(pre1))                      (saved when training)
//   h2   = bf16(act(h1 @ W2 + b2))              W2 (K, K) bf16
//   out[p, r*D:(r+1)*D] = h2 @ Wh + bh          Wh (K, D) bf16
//
// What bounds it on the H100: the tensor cores. At the flagship (N =
// 152,100 positions, CK = 784, R = 8, K = 128, D = 7) the lift GEMM is
// 0.244 TFLOP and mixing and heads another 0.04: ~0.29 ms at the bf16 peak,
// against 238 MB of P read, 36 MB of output and, in save-h1 mode, 311 MB of
// h1 written (0.08 / 0.17 ms at 3.35 TB/s). One step removed, the L2 that
// feeds the products: every item streams Wc_r, and P is read once for each
// rotation.
//
// Design: a lift mainloop in front of csrc/encoder_chain.cuh's forward
// tail, which K1 also runs:
//  - a persistent grid of about one block per SM over the (128-position
//    tile, rotation) items, rotations inner (kernels/mix_heads.py::
//    chain_schedule with tile 128), so that a tile's P is read from L2
//    after its first rotation;
//  - one TMA thread keeps a ring of 64-column slices of the lift in
//    flight: the tile's P columns (two 64 x 64 K-major boxes from the 2-D
//    map (CK, N)) and the matching 64 rows of Wc's rotation-r columns (one
//    or two 64 x 64 MN-major boxes from the 3-D map (K, R, CK)), 128-byte
//    swizzled, zero past CK, N and K: no padding, any CK (the galaxy's
//    12,680 streams the same way);
//  - two consumer warpgroups, each owning 64 of the item's positions, run
//    the lift on m64n128k16 sharing each Wc slice (so Wc crosses L2 once
//    for every 128 positions), then bias and act from the accumulators into
//    the warpgroup's bf16 h1 tile; in save-h1 mode a TMA store writes that
//    tile out while pre2 runs, and thread 0 waits for it before h2
//    overwrites it;
//  - the tail: pre2 = h1 W2, h2 over h1, heads = h2 Wh + bh, the heads of
//    a tile kept in shared memory across its rotations and written as one
//    block (csrc/encoder_chain.cuh). The lift accumulators are dead before
//    pre2's are written (64 registers a thread each). The (N, R*K) lift
//    never reaches device memory unless h1 is saved.
// The activation is a template constant: read at run time, it left the
// epilogues to set the pace (a clock64 probe, tools/probe_encoder_fwd.py,
// gave 8,561 cycles an item past the lift mainloop against 5,472 with the
// constant; 0.757 against 0.610 ms at the flagship, H100 80GB HBM3, 700 W).
// The mainloop's waits for the ring (L2) are now about a third of it.
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
#include "decoder_wgmma.cuh"
#include "encoder_chain.cuh"

namespace {
namespace chain {

constexpr int L_STAGES = 4;
constexpr int L_STAGE = 4 * TILE;        // P: two 64 x 64; Wc_r: 64 x 128
constexpr int L_THREADS = 384;
constexpr int L_PROD_REGS = 40;          // the TMA thread alone
constexpr int L_CONS_REGS = (64512 - 128 * L_PROD_REGS) / 256 / 8 * 8;
constexpr int L_W2 = 0;
constexpr int L_WHT = L_W2 + 2 * W2T;
constexpr int L_RING = L_WHT + WHT;      // 1,024-aligned
constexpr int L_H = L_RING + L_STAGES * L_STAGE;   // two h tiles
constexpr int L_B2 = L_H + 2 * HT;
constexpr int L_BH = L_B2 + KP * 4;
constexpr int L_BARS = L_BH + 16 * 4;
constexpr int L_HB = L_BARS + 2 * L_STAGES * 8;    // the heads, 128 R D f32

template <int ACT>
__global__ void __launch_bounds__(L_THREADS, 1) lifted_fwd_kernel(
    const __grid_constant__ CUtensorMap map_p,
    const __grid_constant__ CUtensorMap map_wc,
    const __grid_constant__ CUtensorMap map_h1, const float* __restrict__ bc,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bh,
    float* __restrict__ out, int save, int N, int CK, int R, int K, int D,
    int chunk, int buffered) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* w2s = base + L_W2;
  unsigned char* wht = base + L_WHT;
  unsigned char* ring = base + L_RING;
  float* b2s = reinterpret_cast<float*>(base + L_B2);
  float* bhs = reinterpret_cast<float*>(base + L_BH);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L_BARS);
  uint64_t* empty = full + L_STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int total = (N + FWD_TM - 1) / FWD_TM * R;
  const int i0 = blockIdx.x * chunk, i1 = min(total, i0 + chunk);
  const int nbox = K > 64 ? 2 : 1, nch = (CK + 63) / 64;
  // the ring zero (Wc's boxes past K are never loaded), the weights
  // zero-padded to 128 channels
  for (int o = L_RING + tid * 16; o < L_H; o += L_THREADS * 16)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0u, 0u, 0u, 0u);
  stage_w2(w2s, w2, K, tid, L_THREADS);
  stage_wht(wht, wh, K, D, tid, L_THREADS);
  for (int c = tid; c < KP; c += L_THREADS) b2s[c] = c < K ? b2[c] : 0.f;
  if (tid < 16) bhs[tid] = tid < D ? bh[tid] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < L_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (tid >= 256) {
    // ---- the TMA thread: P's and Wc_r's 64-column slices of each item ----
    reg_dealloc<L_PROD_REGS>();
    if (tid == 256) {
      int it = 0;
      for (int i = i0; i < i1; ++i) {
        const int r = i % R, p0 = (i / R) * FWD_TM;
        const int nh = min(2, (N - p0 + TM - 1) / TM);   // halves below N
        for (int c = 0; c < nch; ++c, ++it) {
          const int s = it % L_STAGES;
          unsigned char* st = ring + s * L_STAGE;
          mbar_wait(&empty[s], ((it / L_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], (nh + nbox) * TILE);
          for (int h = 0; h < nh; ++h)
            tma_load_2d(st + h * TILE, &map_p, &full[s], c * 64, p0 + h * TM);
          for (int a = 0; a < nbox; ++a)
            tma_load_3d(st + (2 + a) * TILE, &map_wc, &full[s], a * 64, r,
                        c * 64);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns the item's positions [64 w, 64 w + 64) ----
  reg_alloc<L_CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w, nk = (K + 15) / 16;
  unsigned char* h = base + L_H + w * HT;
  float* hb = buffered ? reinterpret_cast<float*>(base + L_HB) + w * TM * R * D
                       : nullptr;
  float acc[64], hd[8];
  int ra = 0, it = 0;
  long long seg[4] = {0, 0, 0, 0};     // the probe's tail segments
  PROBE(long long pw = 0, pm = 0, pr = 0;)
  for (int i = i0; i < i1; ++i) {
    const int r = i % R, p0w = (i / R) * FWD_TM + w * TM;
    PROBE(const long long c0 = clock64();)
    if (i == i0 || r == 0) {
      ra = r;
      if (hb && i > i0) reuse_heads(t, bar);
    }
    // pre1 = P[rows] Wc_r over the ring, one slice behind the TMA thread
    for (int c = 0; c < nch; ++c, ++it) {
      const int s = it % L_STAGES;
      const unsigned char* st = ring + s * L_STAGE;
      PROBE(const long long cw = clock64();)
      mbar_wait(&full[s], (it / L_STAGES) & 1);
      PROBE(pw += clock64() - cw;)
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
      if (c > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % L_STAGES]);
    }
    wgmma_wait<0>();
    acc_fence<64>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % L_STAGES]);
    PROBE(const long long c1 = clock64(); pm += c1 - c0;)

    // h1 = bf16(act(pre1 + bc_r)) into this warpgroup's tile (the last
    // reader of the tile, the previous item's heads product, has finished)
    const float* bcr = bc + r * K;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * (t & 3);
      const float2 bb = n < K ? __ldg(reinterpret_cast<const float2*>(bcr + n))
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(h + (n >> 6) * TILE + at(acc_row(t, x), n & 63)) =
            pack2(act_fn(acc[x] + bb.x, ACT), act_fn(acc[x + 1] + bb.y, ACT));
      }
    }
    fence_async_smem();
    bar_sync(bar, 128);
    if (save && t == 0 && p0w < N) {
      for (int a = 0; a < nbox; ++a) tma_store_3d(&map_h1, h + a * TILE, a * 64, r, p0w);
      tma_store_commit();
    }
    fwd_tail(acc, hd, h, w2s, wht, b2s, nk, t, ACT, save != 0, bar, seg);
    PROBE(const long long c2 = clock64();)
    put_heads(hd, hb, out, bhs, p0w, r, N, R, D, t);
    if (hb && (i + 1 == i1 || r == R - 1))
      flush_heads(hb, out, p0w, ra, r, N, R, D, t, bar);
    PROBE(pr += clock64() - c1; seg[3] += clock64() - c2;)
  }
  if (t == 0) tma_store_wait_all();
  PROBE(probe_add(t, w, pw, pm, pr, i1 - i0, seg);)
}

template <int ACT>
int launch_lifted_fwd(const void* P, const void* wc, const void* bc,
                      const void* w2, const void* b2, const void* wh,
                      const void* bh, void* out, void* h1_out, int N, int CK,
                      int R, int K, int D, int G, int chunk,
                      cudaStream_t stream) {
  CUtensorMap m_p, m_wc, m_h1;
  const uint64_t d_p[2] = {(uint64_t)CK, (uint64_t)N}, s_p[1] = {(uint64_t)CK * 2};
  const uint32_t box_p[2] = {64, TM};
  const uint64_t d_wc[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)CK};
  const uint64_t d_h1[3] = {(uint64_t)K, (uint64_t)R, (uint64_t)N};
  const uint64_t s_k[2] = {(uint64_t)K * 2, (uint64_t)R * K * 2};
  const uint32_t box_k[3] = {64, 1, TM};
  int err;
  if ((err = make_map_strided(&m_p, P, 2, d_p, s_p, box_p))) return err;
  if ((err = make_map_strided(&m_wc, wc, 3, d_wc, s_k, box_k))) return err;
  m_h1 = m_wc;
  if (h1_out && (err = make_map_strided(&m_h1, h1_out, 3, d_h1, s_k, box_k)))
    return err;
  const size_t fixed = 1024 + L_HB, heads = (size_t)FWD_TM * R * D * 4;
  const int buffered = fixed + heads <= 232448;
  const size_t smem = fixed + (buffered ? heads : 0);
  if ((err = allow_smem(lifted_fwd_kernel<ACT>, smem))) return err;
  lifted_fwd_kernel<ACT><<<G, L_THREADS, smem, stream>>>(
      m_p, m_wc, m_h1, (const float*)bc, (const __nv_bfloat16*)w2,
      (const float*)b2, (const __nv_bfloat16*)wh, (const float*)bh,
      (float*)out, h1_out != nullptr, N, CK, R, K, D, chunk, buffered);
  return (int)cudaGetLastError();
}

}  // namespace chain
}  // namespace

TVAE_PROBE_READER(tvae_probe_lifted_encoder_fwd)

// K11. P (N, CK) bf16 with CK % 8 == 0; wc (CK, R*K) bf16; bc (R*K,) f32;
// w2 (K, K), wh (K, D) bf16; b2 (K,), bh (D,) f32; out (N, R*D) f32; h1_out
// (N, R*K) bf16, or null when serving. G blocks of `chunk` (128-position
// tile, rotation) items each (kernels/mix_heads.py::chain_schedule with
// tile 128).
extern "C" int tvae_lifted_encoder_fwd(const void* P, const void* wc,
                                       const void* bc, const void* w2,
                                       const void* b2, const void* wh,
                                       const void* bh, void* out,
                                       void* h1_out, int N, int CK, int R,
                                       int K, int D, int G, int chunk,
                                       int act, void* stream) {
  const long long items =
      (long long)(N + chain::FWD_TM - 1) / chain::FWD_TM * R;
  if (CK % 8 || CK < 8 || (K != 16 && K != 32 && K != 64 && K != 128) ||
      D < 1 || D > 16 || R < 1 || G < 1 || chunk < 1 ||
      (long long)G * chunk < items || (long long)(G - 1) * chunk >= items)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return act ? chain::launch_lifted_fwd<1>(P, wc, bc, w2, b2, wh, bh, out,
                                           h1_out, N, CK, R, K, D, G, chunk, s)
             : chain::launch_lifted_fwd<0>(P, wc, bc, w2, b2, wh, bh, out,
                                           h1_out, N, CK, R, K, D, G, chunk, s);
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
