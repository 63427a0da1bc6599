// The coordinate-MLP decoder's kernels on Hopper's warpgroup products:
// the forward (K7 through csrc/decoder_pose.cu), and the backward's chain
// pass and split-K weight-gradient product (K8, csrc/decoder_pose_bwd.cu;
// the weight gradient also takes K12's dWc, csrc/lifted_encoder.cu).
// Templated on the feature source, as csrc/decoder_chain.cuh is; the one
// source here is FEAT_POSE, bf16(U[b, j] P[b, i] - V[b, j] Q[b, i]) for
// pixel (i, j) of the n x n grid from per-image (B, n, F) tables, taken
// without FMA contraction so that it rounds as the plain version does.
// K9/K10 (csrc/decoder_mlp.cu) still run decoder_chain.cuh's kernels with
// its FEAT_COORD source; moving them here means adding that source's
// branch to pixel_offsets, feat8_load and feat8_make below.
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
// halved L2 traffic of a cluster is not yet what it waits on.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace wg {

constexpr int FEAT_NONE = 0, FEAT_POSE = 1;
constexpr int TM = 64;          // pixel rows of a tile: wgmma's M
constexpr int TILE = TM * 128;  // bytes of a 64 x 64 bf16 swizzled tile
constexpr int MAX_OUT = 8;      // output channels the kernels take
// setmaxnreg with one producer warpgroup beside two consumers: the block
// holds 384 x 168 registers (__launch_bounds__(384, 1)), so a split gives
// the consumers (64,512 - 128 P) / 256 when the producers keep P, and asks
// for no more than that (a larger sum would stall setmaxnreg.inc for ever).
// The TMA-only producers keep 40 (the consumers get 232); with the feature
// builders' two chunks of loads in flight they keep 88 (the consumers 208).
// (A second producer warpgroup of builders does not fit: at 512 threads a
// block ptxas holds every thread to 128 registers, and m64n256k16 needs
// ~154.)
constexpr int PROD_TMA = 40, PROD_BUILD = 88;
__host__ __device__ constexpr int cons_regs(int prod) {
  return (64512 - 128 * prod) / 256 / 8 * 8;
}
constexpr int BUILDERS = 96;    // builder threads: warps 1-3 of the producers

// where the features of a pixel come from; unused pointers are null
struct FeatSrc {
  const float *U, *V, *P, *Q;   // FEAT_POSE: (B, n, F) tables
  int n;                        // FEAT_POSE: image side, npx = n * n
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A pixel's place in the feature source, computed once a tile so that the
// builders divide nothing: the (B n, F) table rows of its column and its
// row, o1 = (b n + j) F and o2 = (b n + i) F; o1 = -1 marks a row past the
// pixels.
template <int FEAT>
__device__ __forceinline__ void pixel_offsets(const FeatSrc& fs, int q,
                                              int npx, int F, int& o1,
                                              int& o2) {
  static_assert(FEAT == FEAT_POSE, "the pose tables are the one source here");
  const int b = q / npx, pix = q - b * npx;
  const int row = pix / fs.n, col = pix - row * fs.n;
  o1 = (b * fs.n + col) * F;
  o2 = (b * fs.n + row) * F;
}

// features f .. f+7 of the pixel at offsets (o1, o2), as 8 bf16 (f % 8 == 0):
// feat8_load issues the loads (U, V of the column, P, Q of the row, two
// float4 each), feat8_make forms the features from them
template <int FEAT>
__device__ __forceinline__ void feat8_load(const FeatSrc& fs, int o1, int o2,
                                           int f, float4* t) {
  const size_t jc = (size_t)o1 + f, ir = (size_t)o2 + f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t[0 + h] = *reinterpret_cast<const float4*>(fs.U + jc + 4 * h);
    t[2 + h] = *reinterpret_cast<const float4*>(fs.V + jc + 4 * h);
    t[4 + h] = *reinterpret_cast<const float4*>(fs.P + ir + 4 * h);
    t[6 + h] = *reinterpret_cast<const float4*>(fs.Q + ir + 4 * h);
  }
}

template <int FEAT>
__device__ __forceinline__ uint4 feat8_make(const float4* t) {
  auto ft = [](float u, float p, float v, float q) {
    return __fsub_rn(__fmul_rn(u, p), __fmul_rn(v, q));
  };
  float x[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 u = t[0 + h], v = t[2 + h], p = t[4 + h], q = t[6 + h];
    x[4 * h + 0] = ft(u.x, p.x, v.x, q.x);
    x[4 * h + 1] = ft(u.y, p.y, v.y, q.y);
    x[4 * h + 2] = ft(u.z, p.z, v.z, q.z);
    x[4 * h + 3] = ft(u.w, p.w, v.w, q.w);
  }
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// Builds the features [f0, f0 + 8 CW) of a tile's 64 pixel rows, whose
// offsets (pixel_offsets; o1 = -1 past the pixels) are in o1s, o2s, into
// CW / 8 swizzled tiles at dst, row p holding pixel row p (features at or
// past F, and rows past the pixels, zero): the K-major A operand of the
// forward and the MN-major A operand of the weight gradient alike. Builder
// bt of BUILDERS takes the chunks bt, bt + BUILDERS, ... of 8 features,
// PER at a time, so that 8 PER independent table loads are in flight
// together. PER = 2 measured faster in the forward and slower in the
// weight gradient (H100, 700 W); loading P and Q once for each image row a
// builder meets measured slower in both: the conditional loads wait on one
// another.
template <int FEAT, int CW, int PER>
__device__ __forceinline__ void build_features(unsigned char* dst,
                                               const FeatSrc& fs, int bt,
                                               const int* o1s,
                                               const int* o2s, int f0,
                                               int F) {
  for (int idx0 = bt; idx0 < TM * CW; idx0 += PER * BUILDERS) {
    float4 t[PER][8];
    bool ok[PER];
    int off[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = idx0 + k * BUILDERS;
      const int p = idx / CW, cc = idx - p * CW, f = f0 + cc * 8;
      off[k] = idx < TM * CW ? (cc >> 3) * TILE + swz(p, cc & 7) : -1;
      const int o1 = off[k] >= 0 ? o1s[p] : -1;
      ok[k] = o1 >= 0 && f < F;
      if (ok[k]) feat8_load<FEAT>(fs, o1, o2s[p], f, t[k]);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (off[k] >= 0)
        *reinterpret_cast<uint4*>(dst + off[k]) =
            ok[k] ? feat8_make<FEAT>(t[k]) : make_uint4(0u, 0u, 0u, 0u);
    }
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
// (warp 0: the TMA thread; warps 1-3: the feature builders). W1 and then
// each Wh stream through one ring of STAGES slices of WS rows x H columns
// (MN-major B operands); the features through two 64-feature buffers
// (K-major A). With save (training) each layer's bf16 h tile also goes to
// hs_out (L, B, npx, H) by TMA store; serving writes nothing extra and its
// y is bitwise the same.
template <int H>
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
  static constexpr int BIAS = 3 * H * 4;        // two layers' biases, hz[b]
  static constexpr int OFFS = 2 * TM * 4;        // the tile's pixel offsets
  static constexpr int SMEM = RING + HT + 2 * FBUF + BIAS + OFFS + 64 * 8 + 1024;
};

template <int H, int FEAT>
__global__ void __launch_bounds__(FwdShape<H>::THREADS, 1) fwd_kernel(
    const FeatSrc fs, const float* __restrict__ hz,
    const float* __restrict__ b1, const float* __restrict__ bh,
    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ y, const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_wh,
    const __grid_constant__ CUtensorMap map_hs, int save, int B, int npx,
    int F, int L, int n_out, int act) {
  using S = FwdShape<H>;
  constexpr int NW = S::NW, WS = S::WS, STAGES = S::STAGES;
  constexpr int NCT = S::NC * 128;              // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* ht = ring + S::RING;
  unsigned char* fbuf = ht + S::HT;
  float* bias = reinterpret_cast<float*>(fbuf + 2 * S::FBUF);
  int* o1s = reinterpret_cast<int*>(bias + 3 * H);
  int* o2s = o1s + TM;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(o2s + TM);
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
      mbar_init(&ffull[s], BUILDERS / 32);
      mbar_init(&fempty[s], S::NC * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

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
      for (int p = bt; p < TM; p += BUILDERS) {
        o1s[p] = -1;
        if (t0 + p < npx)
          pixel_offsets<FEAT>(fs, b * npx + t0 + p, npx, F, o1s[p], o2s[p]);
      }
      bar_sync(2, BUILDERS);
      for (int fi = 0; fi < nf; ++fi) {
        const int buf = fi & 1;
        mbar_wait(&fempty[buf], ((fi >> 1) & 1) ^ 1);
        build_features<FEAT, 8, 2>(fbuf + buf * S::FBUF, fs, bt, o1s, o2s,
                                fi * 64, F);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&ffull[buf]);
      }
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
  zero_acc<NW / 2>(acc);
  for (int s = 0; s < nw1; ++s, ++it) {
    const int fi = s >> 1;
    if (!(s & 1)) mbar_wait(&ffull[fi & 1], (fi >> 1) & 1);
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
  epilogue(0);

  // ---- hidden layers: h @ Wh[l] ----
  for (int l = 1; l < L; ++l) {
    zero_acc<NW / 2>(acc);
    for (int s = 0; s < H / WS; ++s, ++it) {
      stage_mma(ht + (s >> 1) * TILE + (s & 1) * 64);
      if (s > 0) release_w(it - 1);
    }
    wgmma_wait<0>();
    acc_fence<NW / 2>(acc);
    release_w(it - 1);
    epilogue(l);
  }

  // ---- output heads: NCT / TM threads a pixel, each H / (8 TPP) chunks ----
  constexpr int TPP = NCT / TM, CH = H / 8 / TPP;
  const int p = tid / TPP, part = tid % TPP, pix = t0 + p;
  float sum[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) sum[o] = 0.f;
  for (int q = 0; q < CH; ++q) {
    const int k0 = (part * CH + q) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        ht + (k0 >> 6) * TILE + swz(p, (k0 & 63) >> 3));
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = __bfloat162float(hv[e]);
#pragma unroll
      for (int o = 0; o < MAX_OUT; ++o)
        if (o < n_out)
          sum[o] = fmaf(h, __bfloat162float(w3[(k0 + e) * n_out + o]), sum[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    if (o >= n_out) break;
    float s = sum[o];
#pragma unroll
    for (int off = TPP / 2; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (part == 0 && pix < npx) y[((size_t)b * npx + pix) * n_out + o] = s + b3[o];
  }
  if (save && tid == 0) tma_store_wait_all();
}

// the forward for H in (64, 128, 256, 512), F % 32 == 0, L >= 2,
// n_out <= MAX_OUT; hs_out null in serving
template <int H, int FEAT>
int launch_fwd_h(const FeatSrc& fs, const void* hz, const void* w1,
                 const void* b1, const void* wh, const void* bh,
                 const void* w3, const void* b3, void* y, void* hs_out, int B,
                 int npx, int F, int L, int n_out, int act,
                 cudaStream_t stream) {
  using S = FwdShape<H>;
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
  if (F % 32 || L < 2 || n_out < 1 || n_out > MAX_OUT)
    return (int)cudaErrorInvalidValue;
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
// Backward chain (K8's first pass). From the saved bf16 h tiles hs
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

// ---------------------------------------------------------------------------
// Split-K weight gradient: part[z] (M, N) = sum over rows p of split z of
// A(p, m) Bm(p, n), for m < M, n < N. Bm is plane `pb` of a bf16
// (planes, P, N) tensor (map_b); A is plane `pa` of a bf16 (planes, P, M)
// tensor (FEAT_NONE, map_a) or the features of row p = (b, pix) rebuilt on
// chip (FEAT_POSE; M = F). Output tiles of 64 MA x NT rows
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
  static constexpr int OFFS = 2 * 2 * TM * 4;    // pixel offsets, two steps
  static constexpr int SMEM = STAGES * STAGE + OFFS + 64 * 8 + 1024;
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
  uint64_t* full = reinterpret_cast<uint64_t*>(offs + 4 * TM);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * 64 * MA, n0 = blockIdx.y * NT;
  const int pbeg = blockIdx.z * chunk, pend = min(P, pbeg + chunk);
  const int steps = (pend - pbeg + TM - 1) / TM;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], FEAT == FEAT_NONE ? 1 : 1 + BUILDERS / 32);
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
      for (int it = 0; it < steps; ++it) {
        const int ws = it % STAGES, p0 = pbeg + it * TM;
        mbar_wait(&empty[ws], ((it / STAGES) & 1) ^ 1);
        // this step's pixel offsets, in the half the step before did not use
        int* o1s = offs + (it & 1) * 2 * TM;
        int* o2s = o1s + TM;
        for (int p = bt; p < TM; p += BUILDERS) {
          o1s[p] = -1;
          if (p0 + p < pend) pixel_offsets<FEAT>(fs, p0 + p, npx, M, o1s[p], o2s[p]);
        }
        bar_sync(2, BUILDERS);
        build_features<FEAT, 8 * MA, 1>(ring + ws * S::STAGE, fs, bt, o1s, o2s,
                                     m0, M);
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

}  // namespace wg
}  // namespace
