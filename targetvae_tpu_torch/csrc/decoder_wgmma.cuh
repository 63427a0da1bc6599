// The coordinate-MLP decoder's kernels on Hopper's warpgroup products:
// the forward (K7 through csrc/decoder_pose.cu, K9 through
// csrc/decoder_mlp.cu), and the backward's passes: the chain, the split-K
// weight-gradient product and the phase cotangent pass (K8,
// csrc/decoder_pose_bwd.cu; K10, csrc/decoder_mlp.cu; the weight gradient
// also takes K12's dWc, csrc/lifted_encoder.cu). Templated on where a
// pixel's F features come from, the products and sums of each taken
// without FMA contraction so that it rounds as the plain version does:
//  FEAT_POSE:  bf16(U[b, j] P[b, i] - V[b, j] Q[b, i]) for pixel (i, j) of
//              the n x n grid, from per-image (B, n, F) tables;
//  FEAT_COORD: bf16(cos(x0 wf[0, f] + x1 wf[1, f] + bf[f])) at the pixel's
//              own coordinates x, an accurate cosine (trig_fast: at
//              sigma = 2/49 the phase reaches tens of radians, beyond what
//              __cosf holds);
//  FEAT_NONE:  a stored bf16 matrix (the weight-gradient product only).
//
// What bounds these kernels on the H100 is the tensor cores' rate and, one
// step removed, the L2 bandwidth that feeds them: at the flagship (B = 100,
// n = 50, F = 1,024, H = 512, L = 2) the forward does 0.39 TFLOP, 0.40 ms at
// the bf16 peak, and each 64-pixel tile reads all of W1 and Wh (1.5 MB) from
// L2. The design (shared by the three kernels):
//  - a tile of 64 pixel rows, wgmma's M, in each of one or two consumer
//    warpgroups that own one or two halves of the H columns (m64n256k16 at
//    H = 512: 128 f32 accumulators a thread, setmaxnreg moving registers
//    from the producer warpgroup to the consumers);
//  - one producer thread keeps a ring of weight slices in flight with TMA
//    (cp.async.bulk.tensor, mbarriers with transaction counts), straight
//    into the 128-byte-swizzled layout wgmma reads (csrc/hopper.cuh), so
//    no shared-memory bank conflicts and no thread spends an instruction on
//    the copy;
//  - three further producer warps build the feature tile of the next
//    K-slice into its swizzled buffer while the current slice's products
//    run;
//  - epilogues from the accumulator registers: bias, hz and activation
//    straight into the bf16 h tile, which is the next layer's A operand;
//    dpre and its column sums likewise; a TMA store writes a saved tile,
//    clipping the rows past the image. Every operand an epilogue reads
//    (biases, hz, W3, the h tiles) is in shared memory first, and its
//    unrolled body stays short: on the card a straight-line epilogue that
//    waited on device loads, or outgrew the instruction cache, cost ~700
//    cycles an accumulator pair.
// Not done here: thread-block clusters with multicast weight loads and a
// persistent grid. The forward measured bound by its feature builders
// (their speed-ups moved it, the weight traffic did not change), so the
// halved L2 traffic of a cluster is not yet what it waits on. FEAT_COORD's
// builders do ALU work where FEAT_POSE's load tables: ~30 instructions for
// each feature, its phase and cosine (trig_fast), none waiting on device
// memory; the clock64 probe below (-DTVAE_PROBE,
// tools/probe_decoder_mlp.py) counts the cycles a tile's products wait for
// them. Three builder warps with the library's cosf built a tile in ~104k
// cycles, against K7's ~59k and the products' ~16k (H100, 700 W); so in
// the forward and in dW1's shared-A tiles the consumer warpgroups build
// most rows themselves while the step before runs on the tensor cores.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// The clock64 probe of the forward, compiled only with -DTVAE_PROBE: thread
// 0 of consumer warpgroup 0 adds into probe_sums [0] the cycles layer 1
// waited for feature slices, [1] layer 1 in all (its waits included), [2]
// the hidden layers' products, [3] the epilogues, [4] the heads, [5] the
// tiles; builder thread 0 adds [6] its cycles building feature slices and
// [7] waiting for a free slice buffer; with FEAT_COORD consumer thread 0
// adds [8] its cycles building its rows. TVAE_WG_PROBE_READER(name) defines
// the C entry point that copies the sums out and zeroes them.
#ifdef TVAE_PROBE
#define WG_PROBE(...) __VA_ARGS__
#define TVAE_WG_PROBE_READER(name)                                          \
  extern "C" int name(void* host) {                                         \
    int e = (int)cudaMemcpyFromSymbol(host, wg::probe_sums,                 \
                                      sizeof(wg::probe_sums));              \
    const unsigned long long z[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};        \
    return e ? e : (int)cudaMemcpyToSymbol(wg::probe_sums, z, sizeof(z));   \
  }
#else
#define WG_PROBE(...)
#define TVAE_WG_PROBE_READER(name)
#endif

namespace {
namespace wg {

#ifdef TVAE_PROBE
__device__ unsigned long long probe_sums[10];
__device__ __forceinline__ void probe_put(int k, long long cycles) {
  atomicAdd(&probe_sums[k], (unsigned long long)cycles);
}
#endif

// FEAT_COORD keeps the value 2 that the profiler shows in kernel names
constexpr int FEAT_NONE = 0, FEAT_POSE = 1, FEAT_COORD = 2;
constexpr int TM = 64;          // pixel rows of a tile: wgmma's M
constexpr int TILE = TM * 128;  // bytes of a 64 x 64 bf16 swizzled tile
constexpr int MAX_OUT = 8;      // output channels the chain pass takes; the
                                // forward takes any, 16 at a time
// setmaxnreg with one producer warpgroup beside two consumers: the block
// holds 384 x 168 registers (__launch_bounds__(384, 1)), so a split gives
// the consumers (64,512 - 128 P) / 256 when the producers keep P, and asks
// for no more than that (a larger sum would stall setmaxnreg.inc for ever).
// The TMA-only producers keep 40 (the consumers get 232); with the feature
// builders' two chunks of loads in flight they keep 88 (the consumers 208).
// (A second producer warpgroup of builders does not fit: at 512 threads a
// block ptxas holds every thread to 128 registers, and m64n256k16 needs
// ~154; FEAT_COORD's consumers build features themselves instead.)
constexpr int PROD_TMA = 40, PROD_BUILD = 88;
__host__ __device__ constexpr int cons_regs(int prod) {
  return (64512 - 128 * prod) / 256 / 8 * 8;
}
constexpr int BUILDERS = 96;    // builder threads: warps 1-3 of the producers

// where the features of a pixel come from; unused pointers are null
struct FeatSrc {
  const float *U, *V, *P, *Q;   // FEAT_POSE: (B, n, F) tables
  int n;                        // FEAT_POSE: image side, npx = n * n;
                                // FEAT_COORD: the row stride of WF
  const float *X, *WF, *BF;     // FEAT_COORD: x (B npx, 2), wf (2, F), bf (F)
  const float* WMAX;            // FEAT_COORD: max |wf[0]|, |wf[1]|, |bf| (3,)
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// FEAT_COORD's phase x0 w0 + x1 w1 + b, each product and sum rounded in
// the plain version's order
__device__ __forceinline__ float coord_phase(float x0, float x1, float w0,
                                             float w1, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1)), b);
}

// cos(x) (sine = 0) or sin(x) (sine = 1) in f32 without a branch, for
// |x| <= TRIG_FAST_MAX: j = rint(x 2 / pi) by the 1.5 * 2^23 shifter (whose
// low bits then hold j), r = x - j pi / 2 by three FMAs (pi / 2 = C1 + C2 +
// C3 to ~72 bits; x - j C1 is exact), then the minimax polynomials of cos
// and sin on [-pi/4, pi/4], the one j's quadrant needs kept and its sign
// set: an error of an ulp or two, as the library's cosf / sinf, so that
// K9's on-chip features match the plain version's bf16(cos(phase)) but
// for the odd entry one bf16 step off (chip_smoke.py phase 2 bounds their
// share at 1e-4, tools/probe_decoder_mlp.py shows why it pays). The
// library's functions carry a
// large-argument path (a local-memory stack and a branch) that kept the
// compiler from interleaving a builder's eight cosines, and round j with
// conversions at a quarter of the FMA rate; this straight line does
// neither.
constexpr float TRIG_FAST_MAX = 105615.f;
__device__ __forceinline__ float trig_fast(float x, int sine) {
  const float jm = fmaf(x, 0.636619772f, 12582912.f);
  const float j = jm - 12582912.f;
  const int k = __float_as_int(jm) - sine;   // cos(x) = cos(r + k pi / 2)
  float r = fmaf(j, -1.57079637e+00f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.71512451e-15f, r);
  const float r2 = r * r;
  const float ps = fmaf(fmaf(-1.9515295891e-04f, r2, 8.3321608736e-03f), r2,
                        -1.6666654611e-01f);
  const float pc = fmaf(fmaf(fmaf(2.443315711809948e-05f, r2,
                                  -1.388731625493765e-03f), r2,
                             4.166664568298827e-02f), r2, -0.5f);
  const float y = k & 1 ? fmaf(ps * r2, r, r) : fmaf(pc, r2, 1.f);
  return __uint_as_float(__float_as_uint(y) ^ ((unsigned)((k + 1) & 2) << 30));
}
// the library's cosf / sinf, out of line, for the rare |x| > TRIG_FAST_MAX
__device__ __noinline__ float trig_slow(float x, int sine) {
  return sine ? sinf(x) : cosf(x);
}
// cos or sin of N arguments: SLOW = false the straight line for all (the
// caller knows they lie in range), SLOW = true the library's function for
// any past it
template <int N, bool SLOW>
__device__ __forceinline__ void trig_n(const float* x, float* y, int sine) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    y[e] = trig_fast(x[e], sine);
    if constexpr (SLOW)
      if (fabsf(x[e]) > TRIG_FAST_MAX) y[e] = trig_slow(x[e], sine);
  }
}

// FEAT_COORD: whether a pixel at (x0, x1) may have a phase past
// trig_fast's range, from fs.WMAX = (max |wf[0]|, max |wf[1]|, max |bf|)
// with a margin for the phase's roundings. The kernels decide once a tile
// (or a step of rows), so that the common path carries no check at all.
__device__ __forceinline__ bool coord_far(const FeatSrc& fs, float x0,
                                          float x1) {
  const float m = fabsf(x0) * fs.WMAX[0] + fabsf(x1) * fs.WMAX[1] + fs.WMAX[2];
  return !(m * 1.001f <= TRIG_FAST_MAX);     // NaN and inf count as far
}

// A pixel's place in the feature source, computed once a tile so that the
// builders divide nothing. FEAT_POSE: the (B n, F) table rows of its column
// and its row, o1 = (b n + j) F and o2 = (b n + i) F. FEAT_COORD: the bits
// of its coordinates x0, x1. o1 = -1 marks a row past the pixels (as bits,
// a NaN no coordinate that yields finite features has).
template <int FEAT>
__device__ __forceinline__ void pixel_offsets(const FeatSrc& fs, int q,
                                              int npx, int F, int& o1,
                                              int& o2) {
  static_assert(FEAT == FEAT_POSE || FEAT == FEAT_COORD,
                "pixel_offsets takes a rebuilt feature source");
  if constexpr (FEAT == FEAT_POSE) {
    const int b = q / npx, pix = q - b * npx;
    const int row = pix / fs.n, col = pix - row * fs.n;
    o1 = (b * fs.n + col) * F;
    o2 = (b * fs.n + row) * F;
  } else {
    const float2 x = reinterpret_cast<const float2*>(fs.X)[q];
    o1 = __float_as_int(x.x);
    o2 = __float_as_int(x.y);
  }
}

// features f .. f+7 of the pixel at offsets (o1, o2), as 8 bf16 (f % 8 == 0):
// feat8_load issues the loads, feat8_make forms the features from them.
// FEAT_POSE: U, V of the column, P, Q of the row, two float4 each.
// FEAT_COORD: wf[0], wf[1] and bf of the 8 features from a window of them
// staged in shared memory (fs.WF, fs.BF; f counts from the window's first
// feature), and the coordinates from the offsets; its cosines as trig_n
// takes them (SLOW).
template <int FEAT>
__device__ __forceinline__ void feat8_load(const FeatSrc& fs, int o1, int o2,
                                           int f, float4* t) {
  if constexpr (FEAT == FEAT_POSE) {
    const size_t jc = (size_t)o1 + f, ir = (size_t)o2 + f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      t[0 + h] = *reinterpret_cast<const float4*>(fs.U + jc + 4 * h);
      t[2 + h] = *reinterpret_cast<const float4*>(fs.V + jc + 4 * h);
      t[4 + h] = *reinterpret_cast<const float4*>(fs.P + ir + 4 * h);
      t[6 + h] = *reinterpret_cast<const float4*>(fs.Q + ir + 4 * h);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      t[0 + h] = *reinterpret_cast<const float4*>(fs.WF + f + 4 * h);
      t[2 + h] = *reinterpret_cast<const float4*>(fs.WF + fs.n + f + 4 * h);
      t[4 + h] = *reinterpret_cast<const float4*>(fs.BF + f + 4 * h);
    }
    t[6] = make_float4(__int_as_float(o1), __int_as_float(o2), 0.f, 0.f);
  }
}

template <int FEAT, bool SLOW>
__device__ __forceinline__ uint4 feat8_make(const float4* t) {
  float x[8];
  if constexpr (FEAT == FEAT_POSE) {
    auto ft = [](float u, float p, float v, float q) {
      return __fsub_rn(__fmul_rn(u, p), __fmul_rn(v, q));
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 u = t[0 + h], v = t[2 + h], p = t[4 + h], q = t[6 + h];
      x[4 * h + 0] = ft(u.x, p.x, v.x, q.x);
      x[4 * h + 1] = ft(u.y, p.y, v.y, q.y);
      x[4 * h + 2] = ft(u.z, p.z, v.z, q.z);
      x[4 * h + 3] = ft(u.w, p.w, v.w, q.w);
    }
  } else {
    const float* w = reinterpret_cast<const float*>(t);
    float ph[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ph[e] = coord_phase(t[6].x, t[6].y, w[e], w[8 + e], w[16 + e]);
    trig_n<8, SLOW>(ph, x, 0);
  }
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// FEAT_COORD: the constants (wf[0], wf[1], bf) of features [f0, f0 + W) into
// a shared-memory window of 3 W floats, zero past F; thread i of `nt` takes
// entries i, i + nt, ...; returns the window as the builders' source
template <int W>
__device__ __forceinline__ FeatSrc stage_coord(const FeatSrc& fs, float* win,
                                               int f0, int F, int i, int nt) {
  for (; i < 3 * W; i += nt) {
    const int k = i / W, f = f0 + i - k * W;
    win[i] = f >= F ? 0.f : (k < 2 ? fs.WF[(size_t)k * fs.n + f] : fs.BF[f]);
  }
  FeatSrc v = fs;
  v.WF = win;
  v.BF = win + 2 * W;
  v.n = W;
  return v;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Builds the features [f0, f0 + 8 CW) of a tile's first `rows` pixel rows, whose
// offsets (pixel_offsets; o1 = -1 past the pixels) are in o1s, o2s, into
// CW / 8 swizzled tiles at dst, row p holding pixel row p (features at or
// past F, and rows past the pixels, zero): the K-major A operand of the
// forward and the MN-major A operand of the weight gradient alike. Builder
// bt of BUILDERS takes the chunks bt, bt + BUILDERS, ... of 8 features,
// PER at a time,
// so that 8 PER independent table loads are in flight together. PER = 2
// measured faster in the forward and slower in the weight gradient (H100,
// 700 W); loading P and Q once for each image row a builder meets measured
// slower in both: the conditional loads wait on one another. FEAT_COORD's
// fs is the shared-memory window of features [f0, f0 + 8 CW) (stage_coord);
// SLOW where a phase may lie past trig_fast's range.
template <int FEAT, int CW, int PER, bool SLOW = false>
__device__ __forceinline__ void build_features(unsigned char* dst,
                                               const FeatSrc& fs, int bt,
                                               const int* o1s,
                                               const int* o2s, int f0,
                                               int F, int rows = TM) {
  for (int idx0 = bt; idx0 < rows * CW; idx0 += PER * BUILDERS) {
    float4 t[PER][8];
    bool ok[PER];
    int off[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = idx0 + k * BUILDERS;
      const int p = idx / CW, cc = idx - p * CW, f = f0 + cc * 8;
      off[k] = idx < rows * CW ? (cc >> 3) * TILE + swz(p, cc & 7) : -1;
      const int o1 = off[k] >= 0 ? o1s[p] : -1;
      ok[k] = o1 != -1 && f < F;
      if (ok[k])
        feat8_load<FEAT>(fs, o1, o2s[p], FEAT == FEAT_COORD ? cc * 8 : f, t[k]);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (off[k] >= 0)
        *reinterpret_cast<uint4*>(dst + off[k]) =
            ok[k] ? feat8_make<FEAT, SLOW>(t[k]) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// FEAT_COORD, the consumers' share of a tile of features: the features
// [f0, f0 + 64) of the tile's rows [R0, TM) into the swizzled tile at dst,
// row p holding pixel row q0 + p of the flattened (B npx) rows (zero at or
// past qend), 4 features an item (items i, i + nt, ...), the coordinates
// and wf, bf read through L1. SLOW where a phase may lie past trig_fast's
// range: the library's cosf there, inline (ptxas fails on a call in a
// consumer warpgroup).
template <int R0, bool SLOW>
__device__ __forceinline__ void coord_build4(unsigned char* dst,
                                             const FeatSrc& fs, int q0,
                                             int qend, int f0, int F, int i,
                                             int nt) {
#pragma unroll 2
  for (; i < (TM - R0) * 16; i += nt) {
    const int p = R0 + (i >> 4), qd = i & 15, f = f0 + 4 * qd;
    uint2 v = make_uint2(0u, 0u);
    if (q0 + p < qend && f < F) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(fs.X) + q0 + p);
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(fs.WF + f));
      const float4 w1 =
          __ldg(reinterpret_cast<const float4*>(fs.WF + fs.n + f));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(fs.BF + f));
      const float ph[4] = {coord_phase(x.x, x.y, w0.x, w1.x, bb.x),
                           coord_phase(x.x, x.y, w0.y, w1.y, bb.y),
                           coord_phase(x.x, x.y, w0.z, w1.z, bb.z),
                           coord_phase(x.x, x.y, w0.w, w1.w, bb.w)};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = trig_fast(ph[e], 0);
        if constexpr (SLOW)
          if (fabsf(ph[e]) > TRIG_FAST_MAX) y[e] = cosf(ph[e]);
      }
      v = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    }
    *reinterpret_cast<uint2*>(dst + swz(p, qd >> 1) + (qd & 1) * 8) = v;
  }
}

template <int R>
__device__ __forceinline__ void zero_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// Forward. For image b and pixel p:
//   f = features (F); h = bf16(act(f @ W1 + b1 + hz[b]))       W1 (F, H) bf16
//   h = bf16(act(h @ Wh[l] + bh[l]))   for l < L - 1            Wh (L-1, H, H)
//   y = h @ W3 + b3                                             W3 (H, n_out)
// f32 accumulation. One block per (64-pixel tile, image): NC consumer
// warpgroups (columns [c NW, (c + 1) NW) each) and one producer warpgroup
// (warp 0: the TMA thread; warps 1-3: the feature builders, which
// FEAT_COORD's consumers help, below). W1 and then
// each Wh stream through one ring of STAGES slices of WS rows x H columns
// (MN-major B operands); the features through two 64-feature buffers
// (K-major A). With save (training) each layer's bf16 h tile also goes to
// hs_out (L, B, npx, H) by TMA store; serving writes nothing extra and its
// y is bitwise the same. FEAT_COORD stages each slice's wf and bf in one
// of two windows, the next slice's fetched into the builders' registers
// while the current one builds, so that no feature waits on device memory.
template <int H, int FEAT>
struct FwdShape {
  static constexpr int NC = H >= 256 ? 2 : 1;   // consumer warpgroups
  static constexpr int NW = H / NC;             // columns of each
  static constexpr int WS = 32;                 // weight rows a stage
  static constexpr int STAGES = 4;
  static constexpr int STAGE = WS * H * 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int HT = TM * H * 2;         // the bf16 h tile
  static constexpr int FBUF = TILE;             // 64 pixels x 64 features
  static constexpr int THREADS = 128 * (NC + 1);
  // FEAT_COORD: the builders' rows of a feature slice; the consumers build
  // the rest while the slice before runs on the tensor cores (the cosines,
  // ~30 instructions a feature, are more than three warps keep up with;
  // 8, 16 or 24 rows, 4 or 8 consumer features in flight, measured within
  // 6 % of each other, H100 at 700 W)
  static constexpr int RB = FEAT == FEAT_COORD ? 24 : TM;
  static constexpr int BIAS = 3 * H * 4;        // two layers' biases, hz[b]
  static constexpr int OFFS = 2 * TM * 4;        // the tile's pixel offsets
  static constexpr int WIN = FEAT == FEAT_COORD ? 2 * 3 * 64 * 4 : 0;
  static constexpr int SMEM =
      RING + HT + 2 * FBUF + BIAS + OFFS + WIN + 64 * 8 + 1024;
  // FEAT_COORD: each builder stages 2 of a slice's 3 x 64 constants
  static_assert(FEAT != FEAT_COORD || 2 * BUILDERS == 3 * 64, "window");
};

template <int H, int FEAT>
__global__ void __launch_bounds__(FwdShape<H, FEAT>::THREADS, 1) fwd_kernel(
    const FeatSrc fs, const float* __restrict__ hz,
    const float* __restrict__ b1, const float* __restrict__ bh,
    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ y, const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_wh,
    const __grid_constant__ CUtensorMap map_hs, int save, int B, int npx,
    int F, int L, int n_out, int act) {
  using S = FwdShape<H, FEAT>;
  constexpr int NW = S::NW, WS = S::WS, STAGES = S::STAGES;
  constexpr int NCT = S::NC * 128;              // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* ht = ring + S::RING;
  unsigned char* fbuf = ht + S::HT;
  float* bias = reinterpret_cast<float*>(fbuf + 2 * S::FBUF);
  int* o1s = reinterpret_cast<int*>(bias + 3 * H);
  int* o2s = o1s + TM;
  float* win = reinterpret_cast<float*>(o2s + TM);   // FEAT_COORD: 2 x 192
  uint64_t* wfull = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(o2s + TM) + S::WIN);
  uint64_t* wempty = wfull + STAGES;
  uint64_t* ffull = wempty + STAGES;
  uint64_t* fempty = ffull + 2;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int nw1 = F / WS;                       // W1 stages
  const int nf = (F + 63) / 64;                 // feature slices
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], S::NC * 4);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ffull[s], BUILDERS / 32 + (S::RB < TM ? S::NC * 4 : 0));
      mbar_init(&fempty[s], S::NC * 4);
    }
    mbar_init_fence();
  }
  // FEAT_COORD: whether a phase of the tile may lie past trig_fast's range;
  // such a tile is built by the builders alone, on the checked path
  bool far = false;
  if constexpr (FEAT == FEAT_COORD) {
    if (tid < TM && t0 + tid < npx) {
      const float2 x = reinterpret_cast<const float2*>(fs.X)[(size_t)b * npx + t0 + tid];
      far = coord_far(fs, x.x, x.y);
    }
    far = __syncthreads_or(far);
  } else {
    __syncthreads();
  }

  if (tid >= NCT) {
    // ---- producer warpgroups ----
    if constexpr (S::NC == 2) reg_dealloc<PROD_BUILD>();
    const int w = (tid - NCT) >> 5;
    if (w == 0) {
      if (lane == 0) {
        const int total = nw1 + (L - 1) * (H / WS);
        for (int it = 0; it < total; ++it) {
          const int ws = it % STAGES;
          mbar_wait(&wempty[ws], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&wfull[ws], S::STAGE);
          // Wh is read as a ((L-1) H, H) matrix: its stages continue W1's
          const CUtensorMap* m = it < nw1 ? &map_w1 : &map_wh;
          const int row = (it < nw1 ? it : it - nw1) * WS;
#pragma unroll
          for (int a = 0; a < H / 64; ++a)
            tma_load_2d(ring + ws * S::STAGE + a * WS * 128, m, &wfull[ws],
                        a * 64, row);
        }
      }
    } else {
      const int bt = tid - NCT - 32;
      const int rows = far ? TM : S::RB;
      for (int p = bt; p < rows; p += BUILDERS) {
        o1s[p] = -1;
        if (t0 + p < npx)
          pixel_offsets<FEAT>(fs, b * npx + t0 + p, npx, F, o1s[p], o2s[p]);
      }
      FeatSrc src = fs;
      if constexpr (FEAT == FEAT_COORD)
        src = stage_coord<64>(fs, win, 0, F, bt, BUILDERS);
      bar_sync(2, BUILDERS);
      WG_PROBE(long long pb = 0, pe = 0;)
      for (int fi = 0; fi < nf; ++fi) {
        const int buf = fi & 1;
        float next[2];            // FEAT_COORD: this builder's share of
        if constexpr (FEAT == FEAT_COORD) {      // slice fi + 1's window
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int i = bt + k * BUILDERS, c = i >> 6;
            const int f = (fi + 1) * 64 + (i & 63);
            next[k] = f >= F ? 0.f
                             : (c < 2 ? fs.WF[(size_t)c * fs.n + f] : fs.BF[f]);
          }
          src.WF = win + buf * 192;
          src.BF = src.WF + 128;
        }
        WG_PROBE(const long long c0 = clock64();)
        mbar_wait(&fempty[buf], ((fi >> 1) & 1) ^ 1);
        WG_PROBE(const long long c1 = clock64(); pe += c1 - c0;)
        constexpr int PER = FEAT == FEAT_COORD ? 1 : 2;
        if (far)
          build_features<FEAT, 8, PER, true>(fbuf + buf * S::FBUF, src, bt, o1s,
                                             o2s, fi * 64, F, rows);
        else
          build_features<FEAT, 8, PER>(fbuf + buf * S::FBUF, src, bt, o1s, o2s,
                                       fi * 64, F, rows);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&ffull[buf]);
        WG_PROBE(pb += clock64() - c1;)
        if constexpr (FEAT == FEAT_COORD) {
          // every builder has read window buf ^ 1 (slice fi - 1) before
          // the barrier of the step before
          win[(buf ^ 1) * 192 + bt] = next[0];
          win[(buf ^ 1) * 192 + bt + BUILDERS] = next[1];
          bar_sync(2, BUILDERS);
        }
      }
      WG_PROBE(if (bt == 0) { probe_put(6, pb); probe_put(7, pe); })
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (S::NC == 2) reg_alloc<cons_regs(PROD_BUILD)>();
  const int t = tid & 127, c = tid >> 7;
  float acc[NW / 2];
  int it = 0;                                   // ring position, as the producer's
  const unsigned char* bcol = ring + c * (NW / 64) * WS * 128;
  auto release_w = [&](int j) {
    if (lane == 0) mbar_arrive(&wempty[j % STAGES]);
  };
  // one ring stage of products: A at a (K-major, two k16 steps), B the
  // stage's WS rows of this warpgroup's columns (MN-major)
  auto stage_mma = [&](const unsigned char* a) {
    const int ws = it % STAGES;
    mbar_wait(&wfull[ws], (it / STAGES) & 1);
    const unsigned char* bb = bcol + ws * S::STAGE;
    acc_fence<NW / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma<NW, 0, 1>(acc, gmma_desc(a + kk * 32, 16, 1024),
                      gmma_desc(bb + kk * 2048, WS * 128, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<NW / 2>(acc);
  };
  // layer l's bias in bias[(l % 2) H ..]: layer 0's b1 and hz[b] (added in
  // the plain version's order, (acc + b1) + hz), layer l's bh[l-1]; each
  // epilogue refills its half for layer l + 2 once all have read it
  for (int n = tid; n < H; n += NCT) {
    bias[n] = b1[n];
    bias[H + n] = bh[n];
    bias[2 * H + n] = hz[(size_t)b * H + n];
  }
  // the bf16 h tile of layer l from the accumulators, then its TMA store
  auto epilogue = [&](int l) {
    if (save && tid == 0) tma_store_wait_read();
    bar_sync(1, NCT);          // every product has read the previous h tile
    const float* bl = bias + (l & 1) * H;
    const float* hzb = bias + 2 * H;
#pragma unroll
    for (int i = 0; i < NW / 2; i += 2) {
      const int r = acc_row(t, i), n = c * NW + acc_col(t, i);
      float v0 = acc[i] + bl[n], v1 = acc[i + 1] + bl[n + 1];
      if (l == 0) {
        v0 += hzb[n];
        v1 += hzb[n + 1];
      }
      *reinterpret_cast<uint32_t*>(ht + (n >> 6) * TILE + swz(r, (n & 63) >> 3) +
                                   (n & 7) * 2) =
          pack_bf16(act_fn(v0, act), act_fn(v1, act));
    }
    fence_async_smem();
    bar_sync(1, NCT);
    if (l + 2 < L)
      for (int n = tid; n < H; n += NCT)
        bias[(l & 1) * H + n] = bh[(size_t)(l + 1) * H + n];
    if (save && tid == 0) {
#pragma unroll
      for (int a = 0; a < H / 64; ++a)
        tma_store_3d(&map_hs, ht + a * TILE, a * 64, t0, l * B + b);
      tma_store_commit();
    }
  };

  // ---- layer 1: features @ W1 ----
  WG_PROBE(long long pw = 0, pep = 0, phid = 0, pcb = 0;
           const long long c0 = clock64();)
  zero_acc<NW / 2>(acc);
  if constexpr (FEAT == FEAT_COORD) {
    // each feature slice's products (its two ring stages) as one group;
    // while they run, the consumers build their rows of the next slice
    // (rows past RB, 4 features an item, wf and bf through L1; none in a
    // tile with a phase past trig_fast's range)
    auto share = [&](int fi) {
      if (!far)
        coord_build4<S::RB, false>(fbuf + (fi & 1) * S::FBUF, fs,
                                   b * npx + t0, b * npx + npx, fi * 64, F,
                                   tid, NCT);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&ffull[fi & 1]);
    };
    share(0);
    for (int fi = 0; fi < nf; ++fi) {
      WG_PROBE(const long long cw = clock64();)
      mbar_wait(&ffull[fi & 1], (fi >> 1) & 1);
      WG_PROBE(pw += clock64() - cw;)
      acc_fence<NW / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ws = (it + h) % STAGES;
        mbar_wait(&wfull[ws], ((it + h) / STAGES) & 1);
        const unsigned char* a = fbuf + (fi & 1) * S::FBUF + h * 64;
        const unsigned char* bb = bcol + ws * S::STAGE;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma<NW, 0, 1>(acc, gmma_desc(a + kk * 32, 16, 1024),
                          gmma_desc(bb + kk * 2048, WS * 128, 1024));
      }
      wgmma_commit();
      if (fi + 1 < nf) {
        // both warpgroups' products of slice fi - 1 have read its buffer
        mbar_wait(&fempty[(fi + 1) & 1], (((fi + 1) >> 1) & 1) ^ 1);
        WG_PROBE(const long long cb = clock64();)
        share(fi + 1);
        WG_PROBE(pcb += clock64() - cb;)
      }
      wgmma_wait<0>();
      acc_fence<NW / 2>(acc);
      release_w(it);
      release_w(it + 1);
      it += 2;
      if (lane == 0) mbar_arrive(&fempty[fi & 1]);
    }
  } else {
    for (int s = 0; s < nw1; ++s, ++it) {
      const int fi = s >> 1;
      WG_PROBE(const long long cw = clock64();)
      if (!(s & 1)) mbar_wait(&ffull[fi & 1], (fi >> 1) & 1);
      WG_PROBE(pw += clock64() - cw;)
      stage_mma(fbuf + (fi & 1) * S::FBUF + (s & 1) * 64);
      if (s > 0) {
        release_w(it - 1);
        if ((s - 1) & 1 && lane == 0) mbar_arrive(&fempty[((s - 1) >> 1) & 1]);
      }
    }
    wgmma_wait<0>();
    acc_fence<NW / 2>(acc);
    release_w(it - 1);
    if (lane == 0) mbar_arrive(&fempty[((nw1 - 1) >> 1) & 1]);
  }
  WG_PROBE(const long long c1 = clock64();)
  epilogue(0);
  WG_PROBE(pep += clock64() - c1;)

  // ---- hidden layers: h @ Wh[l] ----
  for (int l = 1; l < L; ++l) {
    WG_PROBE(const long long c2 = clock64();)
    zero_acc<NW / 2>(acc);
    for (int s = 0; s < H / WS; ++s, ++it) {
      stage_mma(ht + (s >> 1) * TILE + (s & 1) * 64);
      if (s > 0) release_w(it - 1);
    }
    wgmma_wait<0>();
    acc_fence<NW / 2>(acc);
    release_w(it - 1);
    WG_PROBE(const long long c3 = clock64(); phid += c3 - c2;)
    epilogue(l);
    WG_PROBE(pep += clock64() - c3;)
  }

  // ---- output heads: y = h W3 + b3 on m64n16k16, 16 outputs at a time:
  // W3^T staged as the K-major B (16 rows, zero past n_out) in the feature
  // buffers, free since layer 1; consumer warpgroup 0 runs the H / 16 k16
  // steps as two independent sums. (As scalar FMAs, W3 read in the loop or
  // staged as f32, the heads took 16-18k cycles a tile, H100 at 700 W.) ----
  WG_PROBE(const long long c4 = clock64();)
  static_assert(H / 64 * 2048 <= 2 * S::FBUF, "W3^T staging");
  unsigned char* w3t = fbuf;
  for (int o0 = 0; o0 < n_out; o0 += 16) {
    const int no = min(16, n_out - o0);
    if (o0 > 0) bar_sync(1, NCT);       // warpgroup 0 has read the last
    for (int idx = tid; idx < 16 * (H / 8); idx += NCT) {
      const int d = idx / (H / 8), cc = idx - d * (H / 8);
      __align__(16) __nv_bfloat16 w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e] = d < no ? w3[(size_t)(cc * 8 + e) * n_out + o0 + d]
                      : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(w3t + (cc >> 3) * 2048 + swz(d, cc & 7)) =
          *reinterpret_cast<const uint4*>(w);
    }
    fence_async_smem();
    bar_sync(1, NCT);
    if (c == 0) {
      float hd[8], hd2[8];
      zero_acc<8>(hd);
      zero_acc<8>(hd2);
      acc_fence<8>(hd);
      acc_fence<8>(hd2);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks)
        wgmma<16, 0, 0>(ks & 1 ? hd2 : hd,
                        gmma_desc(ht + (ks >> 2) * TILE + (ks & 3) * 32, 16, 1024),
                        gmma_desc(w3t + (ks >> 2) * 2048 + (ks & 3) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence<8>(hd);
      acc_fence<8>(hd2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = acc_col(t, i), pix = t0 + acc_row(t, i);
        if (o < no && pix < npx)
          y[((size_t)b * npx + pix) * n_out + o0 + o] = (hd[i] + hd2[i]) + b3[o0 + o];
      }
    }
  }
  if (save && tid == 0) tma_store_wait_all();
  WG_PROBE(if (tid == 0) {
    probe_put(0, pw);
    probe_put(1, c1 - c0);
    probe_put(2, phid);
    probe_put(3, pep);
    probe_put(4, clock64() - c4);
    probe_put(5, 1);
    probe_put(8, pcb);
  })
}

// the forward for H in (64, 128, 256, 512), F % 32 == 0, L >= 2, any
// n_out >= 1; hs_out null in serving
template <int H, int FEAT>
int launch_fwd_h(const FeatSrc& fs, const void* hz, const void* w1,
                 const void* b1, const void* wh, const void* bh,
                 const void* w3, const void* b3, void* y, void* hs_out, int B,
                 int npx, int F, int L, int n_out, int act,
                 cudaStream_t stream) {
  using S = FwdShape<H, FEAT>;
  CUtensorMap mw1, mwh, mhs;
  const uint32_t box_w[2] = {64, S::WS}, box_t[2] = {64, TM};
  const uint64_t d_w1[2] = {(uint64_t)H, (uint64_t)F};
  const uint64_t d_wh[2] = {(uint64_t)H, (uint64_t)(L - 1) * H};
  const uint64_t d_hs[3] = {(uint64_t)H, (uint64_t)npx, (uint64_t)L * B};
  int err;
  if ((err = make_map(&mw1, w1, 2, d_w1, box_w))) return err;
  if ((err = make_map(&mwh, wh, 2, d_wh, box_w))) return err;
  mhs = mw1;
  if (hs_out && (err = make_map(&mhs, hs_out, 3, d_hs, box_t))) return err;
  if ((err = allow_smem(fwd_kernel<H, FEAT>, S::SMEM))) return err;
  const dim3 grid((npx + TM - 1) / TM, B);
  fwd_kernel<H, FEAT><<<grid, S::THREADS, S::SMEM, stream>>>(
      fs, (const float*)hz, (const float*)b1, (const float*)bh,
      (const __nv_bfloat16*)w3, (const float*)b3, (float*)y, mw1, mwh, mhs,
      hs_out != nullptr, B, npx, F, L, n_out, act);
  return (int)cudaGetLastError();
}

template <int FEAT>
int launch_fwd(const FeatSrc& fs, const void* hz, const void* w1,
               const void* b1, const void* wh, const void* bh, const void* w3,
               const void* b3, void* y, void* hs_out, int B, int npx, int F,
               int H, int L, int n_out, int act, cudaStream_t s) {
  if (F % 32 || L < 2 || n_out < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 64:
      return launch_fwd_h<64, FEAT>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 128:
      return launch_fwd_h<128, FEAT>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 256:
      return launch_fwd_h<256, FEAT>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    case 512:
      return launch_fwd_h<512, FEAT>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B, npx, F, L, n_out, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward chain (K8's first pass, K10's second). From the bf16 h tiles hs
// (L, B, npx, H), with g16 = bf16(g):
//   db3 = sum g; dW3 = h_{L-1}^T g16; dh = g16 W3^T
//   for l = L-1 .. 1: dpre = dh * act'(h_l); dWh[l-1] = h_{l-1}^T bf16(dpre);
//                     dbh[l-1] = sum dpre;   dh = bf16(dpre) Wh[l-1]^T
//   dpre1 = dh * act'(h_0); db1 = sum dpre1
// One block per (64-pixel tile, image), the forward's warpgroups: dh lives
// in the consumers' accumulators; the tile of h_{L-1} arrives by TMA in the
// dpre tile's buffer first (dW3 and the first act' read it there); dpre is
// formed in the accumulators and goes to the bf16
// dpre tile (the A operand of the next product, K-major) and by TMA store
// to dP (L, B, npx, H); Wh's columns stream through the ring as K-major B
// slices of 64 (rows of Wh). Each block writes its column sums, dW3 and db3
// to its own row of `part`: [column sums of dpre_l, l < L (L*H) |
// dW3 (H*n_out) | db3 (n_out)]; rows past the image are zero everywhere.
template <int H>
struct ChainShape {
  static constexpr int NC = H >= 256 ? 2 : 1;
  static constexpr int NW = H / NC;
  static constexpr int DT = TM * H * 2;         // a 64-pixel bf16 tile
  static constexpr int STAGE = DT;              // or 64 columns of Wh, all rows
  static constexpr int STAGES = H == 512 ? 2 : (H == 256 ? 3 : 4);
  static constexpr int BOX = H < 256 ? H : 256; // TMA box rows
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int SMEM = STAGES * STAGE + DT + TM * MAX_OUT * 4 +
                              H * MAX_OUT * 4 + 4 * H * 4 + 64 * 8 + 1024;
};

template <int H>
__global__ void __launch_bounds__(ChainShape<H>::THREADS, 1) chain_kernel(
    const float* __restrict__ g, const __nv_bfloat16* __restrict__ w3,
    float* __restrict__ part, const __grid_constant__ CUtensorMap map_wh,
    const __grid_constant__ CUtensorMap map_dp,
    const __grid_constant__ CUtensorMap map_hs, int B, int npx, int L,
    int n_out, int X, int act) {
  using S = ChainShape<H>;
  constexpr int NW = S::NW, STAGES = S::STAGES, NCT = S::NC * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* dt = ring + STAGES * S::STAGE;
  float* gsm = reinterpret_cast<float*>(dt + S::DT);   // g tile (TM, n_out)
  float* w3s = gsm + TM * MAX_OUT;                      // W3 (H, n_out) f32
  float* red = w3s + H * MAX_OUT;                       // (4 warps, H) sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * H);
  uint64_t* empty = full + STAGES;
  uint64_t* hbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::NC * 4);
    }
    mbar_init(hbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NCT) {
    // the TMA thread: the tile of h_{L-1} into dt, then for each layer
    // l = L-1 .. 1 the 64-column slices of Wh[l-1] (K-major B: rows of Wh)
    // and the tile of h_{l-1}, all through the ring
    if constexpr (S::NC == 2) reg_dealloc<PROD_TMA>();
    if (tid == NCT) {
      mbar_expect_tx(hbar, S::DT);
#pragma unroll
      for (int a = 0; a < H / 64; ++a)
        tma_load_3d(dt + a * TILE, &map_hs, hbar, a * 64, t0, (L - 1) * B + b);
      int it = 0;
      auto next = [&]() {
        const int ws = it % STAGES;
        mbar_wait(&empty[ws], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[ws], S::STAGE);
        return ws;
      };
      for (int l = L - 1; l >= 1; --l) {
        for (int ks = 0; ks < H / 64; ++ks, ++it) {
          const int ws = next();
#pragma unroll
          for (int r = 0; r < H; r += S::BOX)
            tma_load_2d(ring + ws * S::STAGE + r * 128, &map_wh, &full[ws],
                        ks * 64, (l - 1) * H + r);
        }
        const int ws = next();
        ++it;
#pragma unroll
        for (int a = 0; a < H / 64; ++a)
          tma_load_3d(ring + ws * S::STAGE + a * TILE, &map_hs, &full[ws],
                      a * 64, t0, (l - 1) * B + b);
      }
    }
    return;
  }

  if constexpr (S::NC == 2) reg_alloc<cons_regs(PROD_TMA)>();
  const int t = tid & 127, c = tid >> 7, q = t >> 5;
  float* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * X;
  for (int i = tid; i < TM * n_out; i += NCT) {
    const int p = i / n_out, o = i - p * n_out;
    gsm[i] = t0 + p < npx ? g[((size_t)b * npx + t0 + p) * n_out + o] : 0.f;
  }
  for (int i = tid; i < H * n_out; i += NCT) w3s[i] = __bfloat162float(w3[i]);
  bar_sync(1, NCT);

  // h at row r, columns n, n + 1 of a swizzled tile
  auto h_pair = [](const unsigned char* tile, int r, int n) {
    return *reinterpret_cast<const __nv_bfloat162*>(
        tile + (n >> 6) * TILE + swz(r, (n & 63) >> 3) + (n & 7) * 2);
  };
  // db3; dW3 = h_{L-1}^T g16 from the tile in dt, one thread an entry,
  // pixels in order (rows past the image are zero)
  mbar_wait(hbar, 0);
  for (int o = tid; o < n_out; o += NCT) {
    float s = 0.f;
    for (int p = 0; p < TM; ++p) s += gsm[p * n_out + o];
    pb[L * H + H * n_out + o] = s;
  }
  for (int i = tid; i < H * n_out; i += NCT) {
    const int k = i / n_out, o = i - k * n_out;
    float s = 0.f;
    for (int p = 0; p < TM && t0 + p < npx; ++p)
      s = fmaf(__bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                   dt + (k >> 6) * TILE + swz(p, (k & 63) >> 3) + (k & 7) * 2)),
               bf16_round(gsm[p * n_out + o]), s);
    pb[L * H + i] = s;
  }
  // dh = g16 W3^T, straight into the accumulator layout: the output
  // channels in the outer loop, so that the unrolled body stays short (a
  // long straight-line epilogue runs out of the instruction cache)
  float acc[NW / 2];
  zero_acc<NW / 2>(acc);
  const int r0 = acc_row(t, 0);
  const float* w3c = w3s + (c * NW + 2 * (t & 3)) * n_out;
  for (int o = 0; o < n_out; ++o) {
    const float g0 = bf16_round(gsm[r0 * n_out + o]);
    const float g1 = bf16_round(gsm[(r0 + 8) * n_out + o]);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      acc[i] = fmaf((i & 2) ? g1 : g0,
                    w3c[(8 * (i >> 2) + (i & 1)) * n_out + o], acc[i]);
  }

  int it = 0;
  for (int l = L - 1;; --l) {
    // dpre = dh * act'(h_l), h_l from dt (l = L-1) or its ring stage; rows
    // past the image are zero
    const unsigned char* hsrc = dt;
    if (l < L - 1) {
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      hsrc = ring + (it % STAGES) * S::STAGE;
    }
    const float keep0 = t0 + r0 < npx ? 1.f : 0.f;
    const float keep1 = t0 + r0 + 8 < npx ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < NW / 2; i += 2) {
      const __nv_bfloat162 h2 =
          h_pair(hsrc, acc_row(t, i), c * NW + acc_col(t, i));
      const float keep = (i & 2) ? keep1 : keep0;
      // rows past the image read zero-filled h: keep = 0 zeroes them
      acc[i] *= dact_from_h(__low2float(h2), act) * keep;
      acc[i + 1] *= dact_from_h(__high2float(h2), act) * keep;
    }
    if (l < L - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % STAGES]);
      ++it;
    }
    if (tid == 0) tma_store_wait_read();   // the last dpre tile is stored
    bar_sync(1, NCT);                      // and every product has read it
    // column sums over the warp's 16 rows, then the bf16 dpre tile
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      float s0 = acc[4 * j] + acc[4 * j + 2], s1 = acc[4 * j + 1] + acc[4 * j + 3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      const int n = c * NW + 8 * j + 2 * (t & 3);
      if (lane < 4) {
        red[q * H + n] = s0;
        red[q * H + n + 1] = s1;
      }
      const int r = acc_row(t, 4 * j);
      unsigned char* d = dt + (n >> 6) * TILE + (n & 7) * 2;
      *reinterpret_cast<uint32_t*>(d + swz(r, (n & 63) >> 3)) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(d + swz(r + 8, (n & 63) >> 3)) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_async_smem();
    bar_sync(1, NCT);
    for (int n = tid; n < H; n += NCT)
      pb[l * H + n] = red[n] + red[H + n] + red[2 * H + n] + red[3 * H + n];
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < H / 64; ++a)
        tma_store_3d(&map_dp, dt + a * TILE, a * 64, t0, l * B + b);
      tma_store_commit();
    }
    if (l == 0) break;

    // dh = bf16(dpre) Wh[l-1]^T
    zero_acc<NW / 2>(acc);
    for (int ks = 0; ks < H / 64; ++ks, ++it) {
      const int ws = it % STAGES;
      mbar_wait(&full[ws], (it / STAGES) & 1);
      const unsigned char* bb = ring + ws * S::STAGE + c * NW * 128;
      acc_fence<NW / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<NW, 0, 0>(acc, gmma_desc(dt + ks * TILE + kk * 32, 16, 1024),
                        gmma_desc(bb + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      acc_fence<NW / 2>(acc);
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    acc_fence<NW / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  if (tid == 0) tma_store_wait_all();
}

template <int H>
int launch_chain_h(const void* g, const void* hs, const void* wh,
                   const void* w3, void* dP, void* part, int B, int npx,
                   int L, int n_out, int X, int act, cudaStream_t stream) {
  using S = ChainShape<H>;
  CUtensorMap mwh, mdp, mhs;
  const uint32_t box_w[2] = {64, S::BOX}, box_t[2] = {64, TM};
  const uint64_t d_wh[2] = {(uint64_t)H, (uint64_t)(L - 1) * H};
  const uint64_t d_dp[3] = {(uint64_t)H, (uint64_t)npx, (uint64_t)L * B};
  int err;
  if ((err = make_map(&mwh, wh, 2, d_wh, box_w))) return err;
  if ((err = make_map(&mdp, dP, 3, d_dp, box_t))) return err;
  if ((err = make_map(&mhs, hs, 3, d_dp, box_t))) return err;
  if ((err = allow_smem(chain_kernel<H>, S::SMEM))) return err;
  const dim3 grid((npx + TM - 1) / TM, B);
  chain_kernel<H><<<grid, S::THREADS, S::SMEM, stream>>>(
      (const float*)g, (const __nv_bfloat16*)w3, (float*)part, mwh, mdp, mhs,
      B, npx, L, n_out, X, act);
  return (int)cudaGetLastError();
}

// the chain pass for H in (64, 128, 256, 512), n_out <= MAX_OUT, L >= 2;
// part holds B * ceil(npx / TM) rows of X = L*H + H*n_out + n_out floats
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
// A(p, m) Bm(p, n), for m < M, n < N. Bm is plane `pb` of a bf16
// (planes, P, N) tensor (map_b); A is plane `pa` of a bf16 (planes, P, M)
// tensor (FEAT_NONE, map_a) or the features of row p = (b, pix) rebuilt on
// chip (FEAT_POSE, FEAT_COORD; M = F; FEAT_COORD stages the constants of
// the block's 64 MA features once). Output tiles of 64 MA x NT rows
// past M masked: with MA = 2 each consumer warpgroup owns 64 rows and all NT
// columns; with MA = 1 (rebuilt features, NT = 512) the two share one
// 64-row A tile and own 256 columns each, so that each feature is built
// once for all 512 columns. K-steps of 64 rows:
// both operands MN-major from the swizzled ring (TMA for Bm and a stored A,
// the three builder warps for rebuilt features), so neither needs a
// transpose in memory. Split z covers rows [z chunk, (z + 1) chunk); each
// split writes its own partial, which csrc/reduce.cu adds in order.
template <int FEAT, int NT, int MA>
struct WgradShape {
  static constexpr int A = MA * TILE;           // 64 rows x 64 MA of M
  static constexpr int STAGE = A + NT * 128;    // + 64 rows x NT of N
  static constexpr int NWG = MA == 2 ? NT : NT / 2;   // columns a warpgroup
  // rebuilt features leave room in L1 for the image's U, V columns
  static constexpr int STAGES =
      FEAT == FEAT_NONE ? 4 : (STAGE <= 48 * 1024 ? 3 : 2);
  static constexpr int THREADS = 384;
  // FEAT_COORD with one shared A tile: the builders build its first RB
  // rows, the consumers the rest while the step before runs (as the
  // forward's)
  static constexpr bool CB = FEAT == FEAT_COORD && MA == 1;
  static constexpr int RB = CB ? 24 : TM;
  static constexpr int OFFS = 2 * 2 * TM * 4;    // pixel offsets, two steps
  static constexpr int WIN = FEAT == FEAT_COORD ? 3 * 64 * MA * 4 : 0;
  static constexpr int SMEM = STAGES * STAGE + OFFS + WIN + 64 * 8 + 1024;
};

template <int FEAT, int NT, int MA>
__global__ void __launch_bounds__(384, 1) wgrad_kernel(
    const FeatSrc fs, const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, int pa, int pb,
    float* __restrict__ part, int P, int M, int N, int chunk, int npx) {
  using S = WgradShape<FEAT, NT, MA>;
  constexpr int STAGES = S::STAGES, NWG = S::NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  int* offs = reinterpret_cast<int*>(ring + STAGES * S::STAGE);
  float* win = reinterpret_cast<float*>(offs + 4 * TM);   // FEAT_COORD
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(win) + S::WIN);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * 64 * MA, n0 = blockIdx.y * NT;
  const int pbeg = blockIdx.z * chunk, pend = min(P, pbeg + chunk);
  const int steps = (pend - pbeg + TM - 1) / TM;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s],
                FEAT == FEAT_NONE ? 1 : 1 + BUILDERS / 32 + (S::CB ? 8 : 0));
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    reg_dealloc<FEAT == FEAT_NONE ? PROD_TMA : PROD_BUILD>();
    const int w = (tid - 256) >> 5;
    if (w == 0) {
      if (lane == 0) {
        for (int it = 0; it < steps; ++it) {
          const int ws = it % STAGES, p0 = pbeg + it * TM;
          unsigned char* st = ring + ws * S::STAGE;
          mbar_wait(&empty[ws], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[ws], NT * 128 + (FEAT == FEAT_NONE ? S::A : 0));
#pragma unroll
          for (int a = 0; a < NT / 64; ++a)
            tma_load_3d(st + S::A + a * TILE, &map_b, &full[ws], n0 + a * 64,
                        p0, pb);
          if (FEAT == FEAT_NONE)
#pragma unroll
            for (int a = 0; a < MA; ++a)
              tma_load_3d(st + a * TILE, &map_a, &full[ws], m0 + a * 64, p0, pa);
        }
      }
    } else if constexpr (FEAT != FEAT_NONE) {
      const int bt = tid - 288;
      // FEAT_COORD's window, ordered before its first read by the first
      // step's barrier
      FeatSrc src = fs;
      if constexpr (FEAT == FEAT_COORD)
        src = stage_coord<64 * MA>(fs, win, m0, M, bt, BUILDERS);
      for (int it = 0; it < steps; ++it) {
        const int ws = it % STAGES, p0 = pbeg + it * TM;
        mbar_wait(&empty[ws], ((it / STAGES) & 1) ^ 1);
        // this step's pixel offsets, in the half the step before did not use
        int* o1s = offs + (it & 1) * 2 * TM;
        int* o2s = o1s + TM;
        bool far = false;      // FEAT_COORD: a phase past trig_fast's range
        for (int p = bt; p < S::RB; p += BUILDERS) {
          o1s[p] = -1;
          if (p0 + p < pend) {
            pixel_offsets<FEAT>(fs, p0 + p, npx, M, o1s[p], o2s[p]);
            if constexpr (FEAT == FEAT_COORD)
              far |= coord_far(fs, __int_as_float(o1s[p]), __int_as_float(o2s[p]));
          }
        }
        if constexpr (FEAT == FEAT_COORD)
          far = bar_or(2, BUILDERS, far);
        else
          bar_sync(2, BUILDERS);
        unsigned char* dst = ring + ws * S::STAGE;
        if (far)
          build_features<FEAT, 8 * MA, 1, true>(dst, src, bt, o1s, o2s, m0, M,
                                             S::RB);
        else
          build_features<FEAT, 8 * MA, 1>(dst, src, bt, o1s, o2s, m0, M, S::RB);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[ws]);
      }
    }
    return;
  }

  reg_alloc<cons_regs(FEAT == FEAT_NONE ? PROD_TMA : PROD_BUILD)>();
  const int t = tid & 127, w = tid >> 7;
  // this warpgroup's A tile and first B column
  const int aoff = MA == 2 ? w * TILE : 0, bcol = MA == 2 ? 0 : w * NWG;
  float acc[NWG / 2];
  zero_acc<NWG / 2>(acc);
  // S::CB: this warpgroup's rows of step j's A tile; a warpgroup that may
  // meet a phase past trig_fast's range lets its products finish first
  auto share = [&](int j) {
    const int q0 = pbeg + j * TM;
    unsigned char* dst = ring + (j % STAGES) * S::STAGE;
    bool far = false;
    for (int i = tid; i < (TM - S::RB) * 16; i += 256) {
      const int q = q0 + S::RB + (i >> 4);
      if (q < pend) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(fs.X) + q);
        far |= coord_far(fs, x.x, x.y);
      }
    }
    if (bar_or(3 + w, 128, far)) {
      wgmma_wait<0>();
      acc_fence<NWG / 2>(acc);
      coord_build4<S::RB, true>(dst, fs, q0, pend, m0, M, tid, 256);
    } else {
      coord_build4<S::RB, false>(dst, fs, q0, pend, m0, M, tid, 256);
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[j % STAGES]);
  };
  if constexpr (S::CB) share(0);
  for (int it = 0; it < steps; ++it) {
    const int ws = it % STAGES;
    mbar_wait(&full[ws], (it / STAGES) & 1);
    const unsigned char* st = ring + ws * S::STAGE;
    acc_fence<NWG / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<NWG, 1, 1>(acc, gmma_desc(st + aoff + kk * 2048, TILE, 1024),
                       gmma_desc(st + S::A + (bcol / 64) * TILE + kk * 2048,
                                 TILE, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<NWG / 2>(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    if constexpr (S::CB) {
      if (it + 1 < steps) {
        // both warpgroups' products of the stage's last step are done
        mbar_wait(&empty[(it + 1) % STAGES], (((it + 1) / STAGES) & 1) ^ 1);
        share(it + 1);
      }
    }
  }
  wgmma_wait<0>();
  acc_fence<NWG / 2>(acc);
  float* out = part + (size_t)blockIdx.z * M * N;
  const int mw = m0 + (MA == 2 ? w * 64 : 0);
#pragma unroll
  for (int i = 0; i < NWG / 2; i += 2) {
    const int m = mw + acc_row(t, i), n = n0 + bcol + acc_col(t, i);
    if (m < M)
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// S splits of `chunk` rows (a multiple of TM); N % 64 == 0; M % 64 == 0.
// a / b: the (planes, P, a_cols) and (planes, P, N) bf16 tensors (a null
// with FEAT != FEAT_NONE); a_cols (M when 0, a multiple of 8) may fall
// short of M, the columns past it reading as zero. The grid is
// kernels/decoder_pose.py::wgrad_schedule's: rebuilt features with
// N % 512 == 0 take 64 x 512 tiles (MA = 1), all else 128 x 256, 128 x 128
// or 128 x 64, the widest that divides N.
template <int FEAT>
int launch_wgrad(const void* a, int planes_a, int pa, const FeatSrc& fs,
                 const void* b, int planes_b, int pb, float* part, int P,
                 int M, int N, int S, int chunk, int npx,
                 cudaStream_t stream, int a_cols = 0) {
  if (M % 64 || chunk % TM || S < 1 || (long long)S * chunk < P || N % 64 ||
      a_cols % 8 || a_cols > M)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const uint32_t box[2] = {64, TM};
  const uint64_t d_b[3] = {(uint64_t)N, (uint64_t)P, (uint64_t)planes_b};
  int err;
  if ((err = make_map(&mb, b, 3, d_b, box))) return err;
  ma = mb;
  if (FEAT == FEAT_NONE) {
    const uint64_t d_a[3] = {(uint64_t)(a_cols ? a_cols : M), (uint64_t)P,
                             (uint64_t)planes_a};
    if ((err = make_map(&ma, a, 3, d_a, box))) return err;
  }
#define TVAE_WGRAD(NT, MA)                                                    \
  do {                                                                        \
    using WS_ = WgradShape<FEAT, NT, MA>;                                     \
    const dim3 grid((M + 64 * MA - 1) / (64 * MA), N / NT, S);                \
    if ((err = allow_smem(wgrad_kernel<FEAT, NT, MA>, WS_::SMEM))) return err; \
    wgrad_kernel<FEAT, NT, MA><<<grid, WS_::THREADS, WS_::SMEM, stream>>>(    \
        fs, ma, mb, pa, pb, part, P, M, N, chunk, npx);                       \
  } while (0)
  if (FEAT != FEAT_NONE && N % 512 == 0) TVAE_WGRAD(512, 1);
  else if (N % 256 == 0) TVAE_WGRAD(256, 2);
  else if (N % 128 == 0) TVAE_WGRAD(128, 2);
  else TVAE_WGRAD(64, 2);
#undef TVAE_WGRAD
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The phase cotangent pass of the backward (K8's pose pass, K10's dx
// pass). For tile t0 of image b: T = bf16(dpre1) W1^T (64 x F), the tile's
// bf16 dpre1 resident (one TMA load, the K-major A) and W1 streaming
// through a TMA ring as K-major B slices of 64 rows of H by PF features;
// (64 x H) x (H x PF) products on wgmma, each consumer warpgroup owning PF / 2
// features (m64n128: 64 accumulators a thread leave registers for the
// epilogue's loads and sines). Each PF block of T goes straight from the
// accumulator registers (each thread knows its fragment's pixels and
// features) into the feature source's epilogue, in a fixed order:
//  FEAT_POSE:  T (V[j] P[i] + U[j] Q[i]) summed over the tile's pixels
//              against (gx[j], gy[i], 1) (sin(ax + ay) = V P + U Q); row
//              (b, tile) of `out` (B tiles, 3, F) gets minus the three sums,
//              which csrc/reduce.cu adds per image;
//  FEAT_COORD: -sin(phase) T summed over the features against wf[0] and
//              wf[1]: each thread's sums in order over its features, then
//              over its quad and the two warpgroups, into dx (B npx, 2)
//              = `out`; the PF block's wf and bf in one of two windows in
//              shared memory, fetched while the block's products run.
constexpr int PF = 256;              // features of a block of T
constexpr int PNW = PF / 2;          // of a consumer warpgroup
constexpr int PSTAGE = PF * 128;     // 64 rows of H x PF features
constexpr int PSTAGES = 4;

// FEAT_COORD's epilogue of one PF block: -sin(phase) T against wf[0],
// wf[1] from the accumulators into the thread's sums dxs (row, x0 / x1),
// the block's constants from the window cwin, x of the thread's rows in
// (x0s, x1s); rows past the image have zero T and coordinates. SLOW where
// a phase of the tile may lie past trig_fast's range.
template <bool SLOW>
__device__ __forceinline__ void coord_dx(const float* acc, const float* cwin,
                                         int w, int t, const float* x0s,
                                         const float* x1s, float (&dxs)[2][2]) {
#pragma unroll 4
  for (int j = 0; j < PNW / 8; ++j) {
    const int fl = w * PNW + 8 * j + 2 * (t & 3);
    const float2 w0 = *reinterpret_cast<const float2*>(cwin + fl);
    const float2 w1 = *reinterpret_cast<const float2*>(cwin + PF + fl);
    const float2 bf = *reinterpret_cast<const float2*>(cwin + 2 * PF + fl);
    float ph[4], sn[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ph[2 * h] = coord_phase(x0s[h], x1s[h], w0.x, w1.x, bf.x);
      ph[2 * h + 1] = coord_phase(x0s[h], x1s[h], w0.y, w1.y, bf.y);
    }
    trig_n<4, SLOW>(ph, sn, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d0 = -sn[2 * h] * acc[4 * j + 2 * h];
      const float d1 = -sn[2 * h + 1] * acc[4 * j + 2 * h + 1];
      dxs[h][0] = fmaf(d1, w0.y, fmaf(d0, w0.x, dxs[h][0]));
      dxs[h][1] = fmaf(d1, w1.y, fmaf(d0, w1.x, dxs[h][1]));
    }
  }
}

template <int H, int FEAT>
struct PhaseShape {
  static constexpr int AT = TM * H * 2;
  static constexpr int RED = FEAT == FEAT_POSE
                                 ? 3 * 4 * PF * 4     // (3 sums, 4 warps, PF)
                                 : 2 * 3 * PF * 4 + 2 * TM * 2 * 4;
  static constexpr int SMEM = AT + PSTAGES * PSTAGE + RED + 64 * 8 + 1024;
};

template <int H, int FEAT>
__global__ void __launch_bounds__(384, 1) phase_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_w1, const FeatSrc fs,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ out, int npx, int F) {
  static_assert(FEAT == FEAT_POSE || FEAT == FEAT_COORD, "phase source");
  using S = PhaseShape<H, FEAT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* at = align1024(smem_raw);
  unsigned char* ring = at + S::AT;
  float* red = reinterpret_cast<float*>(ring + PSTAGES * PSTAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(red) + S::RED);
  uint64_t* empty = full + PSTAGES;
  uint64_t* afull = empty + PSTAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int nfb = (F + PF - 1) / PF;
  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(afull, 1);
    mbar_init_fence();
  }
  // FEAT_COORD: whether a phase of the tile may lie past trig_fast's range
  bool far = false;
  if constexpr (FEAT == FEAT_COORD) {
    if (tid < TM && t0 + tid < npx) {
      const float2 x = reinterpret_cast<const float2*>(fs.X)[(size_t)b * npx + t0 + tid];
      far = coord_far(fs, x.x, x.y);
    }
    far = __syncthreads_or(far);
  } else {
    __syncthreads();
  }

  if (tid >= 256) {
    reg_dealloc<PROD_TMA>();
    if (tid == 256) {
      mbar_expect_tx(afull, S::AT);
#pragma unroll
      for (int a = 0; a < H / 64; ++a)
        tma_load_3d(at + a * TILE, &map_a, afull, a * 64, t0, b);
      int it = 0;
      for (int fb = 0; fb < nfb; ++fb)
        for (int ks = 0; ks < H / 64; ++ks, ++it) {
          const int ws = it % PSTAGES;
          mbar_wait(&empty[ws], ((it / PSTAGES) & 1) ^ 1);
          mbar_expect_tx(&full[ws], PSTAGE);
          tma_load_2d(ring + ws * PSTAGE, &map_w1, &full[ws], ks * 64, fb * PF);
        }
    }
    return;
  }

  reg_alloc<cons_regs(PROD_TMA)>();
  const int t = tid & 127, w = tid >> 7, q = t >> 5;
  // this thread's two pixel rows: FEAT_POSE their grid coordinates and
  // table rows, FEAT_COORD their coordinates
  const int r0 = acc_row(t, 0);
  int ii[2], jj[2];
  bool ok[2];
  float gxv[2], gyv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = t0 + r0 + 8 * h;
    ok[h] = pix < npx;
    if constexpr (FEAT == FEAT_POSE) {
      ii[h] = ok[h] ? pix / fs.n : 0;
      jj[h] = ok[h] ? pix - ii[h] * fs.n : 0;
      gxv[h] = gx[jj[h]];
      gyv[h] = gy[ii[h]];
    } else {
      const float2 x = ok[h] ? reinterpret_cast<const float2*>(fs.X)[(size_t)b * npx + pix]
                             : make_float2(0.f, 0.f);
      gxv[h] = x.x;
      gyv[h] = x.y;
    }
  }
  const size_t tb = (size_t)b * fs.n * F;
  float dxs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // FEAT_COORD: (row, x0 / x1)
  mbar_wait(afull, 0);

  float acc[PNW / 2];
  int it = 0;
  for (int fb = 0; fb < nfb; ++fb) {
    // FEAT_COORD: this block's window, three entries a thread, fetched
    // before the products and stored after them
    float cw[3];
    if constexpr (FEAT == FEAT_COORD) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = tid + 256 * k, c = i / PF, f = fb * PF + i - c * PF;
        cw[k] = f >= F ? 0.f : (c < 2 ? fs.WF[(size_t)c * fs.n + f] : fs.BF[f]);
      }
    }
    zero_acc<PNW / 2>(acc);
    for (int ks = 0; ks < H / 64; ++ks, ++it) {
      const int ws = it % PSTAGES;
      mbar_wait(&full[ws], (it / PSTAGES) & 1);
      const unsigned char* bb = ring + ws * PSTAGE + w * PNW * 128;
      acc_fence<PNW / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<PNW, 0, 0>(acc, gmma_desc(at + ks * TILE + kk * 32, 16, 1024),
                         gmma_desc(bb + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      acc_fence<PNW / 2>(acc);
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % PSTAGES]);
    }
    wgmma_wait<0>();
    acc_fence<PNW / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % PSTAGES]);

    if constexpr (FEAT == FEAT_COORD) {
      // window fb % 2 (last read in block fb - 2, before the barrier of
      // block fb - 1)
      float* cwin = red + (fb & 1) * 3 * PF;
#pragma unroll
      for (int k = 0; k < 3; ++k) cwin[tid + 256 * k] = cw[k];
      bar_sync(1, 256);
      if (far)
        coord_dx<true>(acc, cwin, w, t, gxv, gyv, dxs);
      else
        coord_dx<false>(acc, cwin, w, t, gxv, gyv, dxs);
    } else {
      // T and its three sums over the warp's 16 rows, from the registers;
      // the table loads of G chunks are issued together
      constexpr int G = 4;
#pragma unroll
      for (int j0 = 0; j0 < PNW / 8; j0 += G) {
        float2 tab[G][2][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int f = fb * PF + w * PNW + 8 * (j0 + g) + 2 * (t & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!ok[h] || f >= F) continue;
            const size_t oj = tb + (size_t)jj[h] * F + f, oi = tb + (size_t)ii[h] * F + f;
            tab[g][h][0] = *reinterpret_cast<const float2*>(fs.U + oj);
            tab[g][h][1] = *reinterpret_cast<const float2*>(fs.V + oj);
            tab[g][h][2] = *reinterpret_cast<const float2*>(fs.P + oi);
            tab[g][h][3] = *reinterpret_cast<const float2*>(fs.Q + oi);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = j0 + g;
          const int fl = w * PNW + 8 * j + 2 * (t & 3), f = fb * PF + fl;
          float sx[2] = {0.f, 0.f}, sy[2] = {0.f, 0.f}, sc[2] = {0.f, 0.f};
          if (f < F) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!ok[h]) continue;
              const float2 u = tab[g][h][0], v = tab[g][h][1];
              const float2 p = tab[g][h][2], qq = tab[g][h][3];
              const float s0 = __fadd_rn(__fmul_rn(v.x, p.x), __fmul_rn(u.x, qq.x));
              const float s1 = __fadd_rn(__fmul_rn(v.y, p.y), __fmul_rn(u.y, qq.y));
              const float ta = __fmul_rn(acc[4 * j + 2 * h], s0);
              const float tc = __fmul_rn(acc[4 * j + 2 * h + 1], s1);
              sc[0] += ta;
              sc[1] += tc;
              sx[0] += __fmul_rn(gxv[h], ta);
              sx[1] += __fmul_rn(gxv[h], tc);
              sy[0] += __fmul_rn(gyv[h], ta);
              sy[1] += __fmul_rn(gyv[h], tc);
            }
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], off);
              sy[e] += __shfl_xor_sync(0xffffffffu, sy[e], off);
              sc[e] += __shfl_xor_sync(0xffffffffu, sc[e], off);
            }
          if (lane < 4) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[(0 * 4 + q) * PF + fl + e] = sx[e];
              red[(1 * 4 + q) * PF + fl + e] = sy[e];
              red[(2 * 4 + q) * PF + fl + e] = sc[e];
            }
          }
        }
      }
      bar_sync(1, 256);
      float* dpart = out + ((size_t)b * gridDim.x + blockIdx.x) * 3 * F;
      for (int i = tid; i < 3 * PF; i += 256) {
        const int k = i / PF, fl = i - k * PF, f = fb * PF + fl;
        const float* rk = red + k * 4 * PF + fl;
        if (f < F) dpart[(size_t)k * F + f] = -(rk[0] + rk[PF] + rk[2 * PF] + rk[3 * PF]);
      }
      bar_sync(1, 256);
    }
  }
  if constexpr (FEAT == FEAT_COORD) {
    // over the quad (the row's features), then the two warpgroups' halves
    float* rs = red + 2 * 3 * PF;                 // (warpgroup, row, 2)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dxs[h][e];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((t & 3) == 0) rs[(w * TM + r0 + 8 * h) * 2 + e] = v;
      }
    bar_sync(1, 256);
    if (tid < 2 * TM && t0 + tid / 2 < npx)
      out[((size_t)b * npx + t0) * 2 + tid] = rs[tid] + rs[2 * TM + tid];
  }
}

template <int H, int FEAT>
int launch_phase_h(const void* dP, const void* w1, const FeatSrc& fs,
                   const void* gx, const void* gy, void* out, int B, int npx,
                   int F, int L, cudaStream_t stream) {
  using S = PhaseShape<H, FEAT>;
  CUtensorMap ma, mw;
  const uint32_t box_a[2] = {64, TM}, box_w[2] = {64, PF};
  const uint64_t d_a[3] = {(uint64_t)H, (uint64_t)npx, (uint64_t)L * B};
  const uint64_t d_w[2] = {(uint64_t)H, (uint64_t)F};
  int err;
  if ((err = make_map(&ma, dP, 3, d_a, box_a))) return err;
  if ((err = make_map(&mw, w1, 2, d_w, box_w))) return err;
  if ((err = allow_smem(phase_kernel<H, FEAT>, S::SMEM))) return err;
  phase_kernel<H, FEAT><<<dim3((npx + TM - 1) / TM, B), 384, S::SMEM, stream>>>(
      ma, mw, fs, (const float*)gx, (const float*)gy, (float*)out, npx, F);
  return (int)cudaGetLastError();
}

// the phase cotangent pass for H in (64, 128, 256, 512) from plane 0 of dP
// (L, B, npx, H), the bf16 dpre1: FEAT_POSE into B * ceil(npx / TM) rows of
// (3, F) partials (gx, gy (n,)), FEAT_COORD into dx (B, npx, 2)
template <int FEAT>
int launch_phase(int H, const void* dP, const void* w1, const FeatSrc& fs,
                 const void* gx, const void* gy, void* out, int B, int npx,
                 int F, int L, cudaStream_t s) {
  switch (H) {
    case 64:
      return launch_phase_h<64, FEAT>(dP, w1, fs, gx, gy, out, B, npx, F, L, s);
    case 128:
      return launch_phase_h<128, FEAT>(dP, w1, fs, gx, gy, out, B, npx, F, L, s);
    case 256:
      return launch_phase_h<256, FEAT>(dP, w1, fs, gx, gy, out, B, npx, F, L, s);
    case 512:
      return launch_phase_h<512, FEAT>(dP, w1, fs, gx, gy, out, B, npx, F, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace
