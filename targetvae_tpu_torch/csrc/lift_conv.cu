// K13: the conv tier's lift, forward: an implicit-GEMM convolution on wgmma.
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (targetvae_tpu/ops/groupconv.py::lifted_conv2d, its bf16 route), and the
// port called cuDNN for it (models/encoders.py::conv_rows). For images y
// (B, H, W, C) float32 channels-last and the weight matrix Wk (N, CKP)
// bf16, the OIHW weight (N, C, k, k) with each filter row padded to an even
// kp (a zero column when k is odd) and the columns to a multiple of 8:
//   rows[b H'W' + i W' + j, o] =
//       bf16( sum_{c, di, dj} bf16(ypad[b, i + di, j + dj, c]) Wk[o, (c k + di) kp + dj] )
// with the sum in float32 and zero padding `pad` on every side.
//
// What bounds it on the H100: the tensor cores. At the flagship (B = 100,
// one channel, k = 28, padding 8, 39 x 39 outputs, N = R K = 1,024) it is
// a GEMM of M = 152,100 positions, K = 784 and N = 1,024: 0.244 TFLOP,
// 0.247 ms at the bf16 peak, against 314 MB of bytes (the bf16 rows
// written; 0.094 ms at 3.35 TB/s). One step removed, the L2 that feeds the
// weights: each item streams its 128 channels' CKP columns once for 256
// positions (256 FLOP a byte of L2 traffic).
//
// Design:
//  - a persistent grid of about one block per SM walks (256-position tile,
//    128-channel slice) items in contiguous chunks, the slices inner, so
//    that a tile's image rows are built once for all its slices;
//  - the image rows a tile reads (every padded row from its first
//    position's to its last's plus k - 1, all channels) are built in shared
//    memory by three builder warps of the producer warpgroup, rounded to
//    bf16 and zero-padded on load, in two copies: copy 0 holds padded
//    column x at x, copy 1 at x - 1, so that the bf16 pair (x, x + 1) of an
//    A fragment is one aligned 32-bit load from the copy of x's parity
//    (filter columns come in even pairs: kp is even). Two buffers where
//    shared memory allows, so that the next tile's rows are built while
//    this tile's products run; one otherwise (the builders then wait);
//  - one TMA thread keeps a ring of the item's weight slices (64 columns x
//    128 channels, 128-byte swizzled, K-major) in flight; columns past CKP
//    and channels past N read as zero;
//  - two consumer warpgroups, each owning 128 of the item's positions as
//    two m64 blocks, build the A fragments in registers from the image
//    rows (a table in shared memory gives each column pair's offset: c,
//    di, dj; im2col never reaches device memory) and run wgmma m64n128k16
//    with A from registers and B from the ring, the next step's fragments
//    loaded while the current products run;
//  - the epilogue rounds the f32 accumulators to bf16 into a swizzled
//    staging tile, and a TMA store writes it while the next item's
//    mainloop runs; rows past M and channels past N are not written.
#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace lift {

constexpr int TM = 256;                 // positions of a work item
constexpr int TN = 128;                 // output channels of a work item
constexpr int STAGE = 64 * TN * 2;      // a ring stage: 128 rows of 128 bytes
constexpr int BOX = 128 * 128;          // a staged box: 128 positions x 64 channels
constexpr int STAGING = 2 * 2 * BOX;    // both warpgroups' 128 x 128 outputs
constexpr int THREADS = 384;
constexpr int BUILDERS = 96;            // warps 1-3 of the producer warpgroup
constexpr int PROD_REGS = 56;           // the TMA thread and the builders
constexpr int CONS_REGS = (64512 - 128 * PROD_REGS) / 256 / 8 * 8;
constexpr int SMEM_MAX = 232448;

struct Shape {
  int B, H, W, C, k, kp, pad, Hp, Ho, Wo, M, N;
  int rows, rs, plane, c1off;   // image rows a tile, row stride, a channel's
                                // plane, copy 1's offset (elements)
  int ckp, ks, nst, nsl;        // columns, k16 steps, ring stages an item,
                                // channel slices
  int stages, nbuf, items, chunk;
  int img, tab, bars, smem;     // byte offsets past the ring and staging
};

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) B (16 x 128, bf16,
// K-major in shared memory). A's four registers hold, for thread l of warp
// q of the warpgroup, rows 16 q + l / 4 (a[0], a[2]) and + 8 (a[1], a[3]),
// columns 2 (l % 4) + {0, 1} (a[0], a[1]) and + 8 (a[2], a[3]), the lower
// column in the lower half.
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* m,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the global padded row (b Hp + i) of a position's first filter row
__device__ __forceinline__ int first_row(const Shape& s, int p) {
  const int hw = s.Ho * s.Wo, b = p / hw;
  return b * s.Hp + (p - b * hw) / s.Wo;
}

// The builders' part: the image rows of tile `tile` into buffer `img`
// (bf16, both copies), threads bt = 0 .. BUILDERS - 1 of warps w of 3.
__device__ __forceinline__ void build_rows(const Shape& s, const float* __restrict__ y,
                           __nv_bfloat16* img, int tile, int bt) {
  const int p0 = tile * TM, p1 = min(s.M, p0 + TM) - 1;
  const int g0 = first_row(s, p0), rows = first_row(s, p1) - g0 + s.k;
  const int warp = bt >> 5, lane = bt & 31;
  __nv_bfloat16* img1 = img + s.c1off;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int row = warp; row < s.C * rows; row += BUILDERS / 32) {
    const int c = row / rows, r = row - c * rows, g = g0 + r;
    const int b = g / s.Hp, iy = g - b * s.Hp - s.pad;
    const bool live = b < s.B && iy >= 0 && iy < s.H;
    const float* src =
        live ? y + ((size_t)(b * s.H + iy) * s.W) * s.C + c : y;
    __nv_bfloat16* d0 = img + c * s.plane + r * s.rs;
    __nv_bfloat16* d1 = img1 + c * s.plane + r * s.rs;
    for (int x = lane; x < s.rs; x += 32) {
      const int ix = x - s.pad;
      const float v = live && ix >= 0 && ix < s.W ? __ldg(src + ix * s.C) : 0.f;
      const __nv_bfloat16 h = __float2bfloat16(v);
      d0[x] = h;
      d1[x > 0 ? x - 1 : s.rs - 1] = x > 0 ? h : zero;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ y,
    const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* staging = base + s.stages * STAGE;
  unsigned char* imgs = staging + STAGING;
  int2* tab = reinterpret_cast<int2*>(base + s.tab);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + s.bars);
  uint64_t* empty = full + s.stages;
  uint64_t* img_full = empty + s.stages;
  uint64_t* img_empty = img_full + 2;
  const int img_bytes = 2 * (s.c1off + s.C * s.plane);

  const int tid = threadIdx.x, lane = tid & 31;
  const int i0 = blockIdx.x * s.chunk, i1 = min(s.items, i0 + s.chunk);

  // each column pair's offset into a copy (bytes): table entry (step, t)
  // holds columns 16 step + 2 t and 16 step + 2 t + 8; pairs past C k kp
  // read offset 0 (finite data; their weights are zero)
  for (int e = tid; e < s.ks * 4; e += THREADS) {
    int off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = 16 * (e >> 2) + 2 * (e & 3) + 8 * h;
      const int kk = s.k * s.kp, c = kc / kk, r = kc - c * kk;
      off[h] = c < s.C ? 2 * (c * s.plane + (r / s.kp) * s.rs + r % s.kp) : 0;
    }
    tab[e] = make_int2(off[0], off[1]);
  }
  if (tid == 0) {
    for (int q = 0; q < s.stages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], 8);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&img_full[q], BUILDERS);
      mbar_init(&img_empty[q], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    reg_dealloc<PROD_REGS>();
    if (tid == 256) {
      // ---- the TMA thread: the weight slices of each item ----
      int it = 0;
      for (int i = i0; i < i1; ++i) {
        const int n0 = (i % s.nsl) * TN;
        for (int c = 0; c < s.nst; ++c, ++it) {
          const int q = it % s.stages;
          mbar_wait(&empty[q], ((it / s.stages) & 1) ^ 1);
          mbar_expect_tx(&full[q], STAGE);
          tma_load_2d(ring + q * STAGE, &map_w, &full[q], c * 64, n0);
        }
      }
    } else if (tid >= 288) {
      // ---- the builders: each tile's image rows, in the block's order ----
      int tc = 0;
      for (int i = i0; i < i1; ++i) {
        if (i != i0 && i % s.nsl) continue;
        const int q = tc % s.nbuf;
        mbar_wait(&img_empty[q], ((tc / s.nbuf) & 1) ^ 1);
        build_rows(s, y, reinterpret_cast<__nv_bfloat16*>(imgs + q * img_bytes),
                   i / s.nsl, tid - 288);
        mbar_arrive(&img_full[q]);
        ++tc;
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns positions [128 w, 128 w + 128) of an
  // item, as two m64 blocks ----
  reg_alloc<CONS_REGS>();
  const int t = tid & 127, w = tid >> 7, bar = 2 + w;
  const int t4 = lane & 3, row0 = 16 * (t >> 5) + (lane >> 2);
  const uint32_t tab_a = smem_u32(tab) + 8 * t4;
  unsigned char* stg = staging + w * 2 * BOX;
  float acc0[64], acc1[64];
  uint32_t a0[8], a1[8];
  uint32_t pb[4];
  int it = 0, tc = -1;

  auto load_a = [&](uint32_t(&a)[8], int step) {
    const uint2 o = lds64(tab_a + 32 * step);
    a[0] = lds32(pb[0] + o.x);
    a[1] = lds32(pb[1] + o.x);
    a[2] = lds32(pb[0] + o.y);
    a[3] = lds32(pb[1] + o.y);
    a[4] = lds32(pb[2] + o.x);
    a[5] = lds32(pb[3] + o.x);
    a[6] = lds32(pb[2] + o.y);
    a[7] = lds32(pb[3] + o.y);
  };
  // step `step` of the item whose first stage is `it`: its products, then
  // the release of the stage before, which the step before finished
  auto mma = [&](const uint32_t(&a)[8], int step) {
    const int st = it + (step >> 2), q = st % s.stages;
    if ((step & 3) == 0) mbar_wait(&full[q], (st / s.stages) & 1);
    const uint64_t db =
        gmma_desc(ring + q * STAGE + (step & 3) * 32, 16, 1024);
    acc_fence<64>(acc0);
    acc_fence<64>(acc1);
    wgmma_fence();
    wgmma_rs128(acc0, a, db, step > 0);
    wgmma_rs128(acc1, a + 4, db, step > 0);
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence<64>(acc0);
    acc_fence<64>(acc1);
    if ((step & 3) == 0 && step > 0 && lane == 0)
      mbar_arrive(&empty[(st - 1) % s.stages]);
  };

  for (int i = i0; i < i1; ++i) {
    const int tile = i / s.nsl, n0 = (i % s.nsl) * TN;
    const int p0 = tile * TM, p0w = p0 + 128 * w;
    if (i == i0 || i % s.nsl == 0) {
      // a new tile: give back the last one's rows, wait for its own
      if (tc >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&img_empty[tc % s.nbuf]);
      }
      ++tc;
      const int q = tc % s.nbuf;
      mbar_wait(&img_full[q], (tc / s.nbuf) & 1);
      const uint32_t img0 = smem_u32(imgs + q * img_bytes);
      const int g0 = first_row(s, p0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int p = p0w + 64 * (r >> 1) + 8 * (r & 1) + row0;
        if (p >= s.M) p = p0;
        const int hw = s.Ho * s.Wo, b = p / hw, e = p - b * hw;
        const int ii = e / s.Wo, j = e - ii * s.Wo;
        pb[r] = img0 + 2 * ((j & 1) * s.c1off
                            + (b * s.Hp + ii - g0) * s.rs + (j & ~1));
      }
    }

    // ---- the mainloop: A from the image rows, B from the ring ----
    load_a(a0, 0);
    for (int step = 0; step < s.ks; step += 2) {
      mma(a0, step);
      if (step + 1 >= s.ks) break;
      load_a(a1, step + 1);
      mma(a1, step + 1);
      if (step + 2 < s.ks) load_a(a0, step + 2);
    }
    wgmma_wait<0>();
    acc_fence<64>(acc0);
    acc_fence<64>(acc1);
    if (lane == 0) mbar_arrive(&empty[(it + s.nst - 1) % s.stages]);
    it += s.nst;

    // ---- the epilogue: bf16 rows through the staging tile ----
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* acc = h ? acc1 : acc0;
#pragma unroll
      for (int x = 0; x < 64; x += 2) {
        const int r = 64 * h + acc_row(t, x), n = acc_col(t, x);
        *reinterpret_cast<uint32_t*>(stg + (n >> 6) * BOX + swz(r, (n & 63) >> 3)
                                     + (n & 7) * 2) = pack2(acc[x], acc[x + 1]);
      }
    }
    fence_async_smem();
    bar_sync(bar, 128);
    if (t == 0 && p0w < s.M) {
      tma_store_2d(&map_out, stg, n0, p0w);
      if (n0 + 64 < s.N) tma_store_2d(&map_out, stg + BOX, n0 + 64, p0w);
      tma_store_commit();
    }
  }
  if (t == 0) tma_store_wait_all();
}

}  // namespace lift
}  // namespace

// K13. y (B, H, W, C) f32 contiguous; wk (N, CKP) bf16 with CKP = C k kp
// rounded up to 8 (kp = k rounded up to even); out (B H' W', N) bf16 with
// H' = H + 2 pad - k + 1 (W' likewise). rows: the image rows a tile needs at
// most (kernels/lift_conv.py::lift_conv_plan, which also gives rs, the
// rows' stride, stages, the ring's depth, and nbuf, the image buffers); G
// blocks of `chunk` items.
extern "C" int tvae_lift_conv_fwd(const void* y, const void* wk, void* out,
                                  int B, int H, int W, int C, int k, int pad,
                                  int N, int rows, int rs, int stages,
                                  int nbuf, int G, int chunk, void* stream) {
  using namespace lift;
  Shape s{};
  s.B = B, s.H = H, s.W = W, s.C = C, s.k = k, s.kp = k + (k & 1);
  s.pad = pad, s.Hp = H + 2 * pad, s.Ho = s.Hp - k + 1;
  s.Wo = W + 2 * pad - k + 1, s.M = B * s.Ho * s.Wo, s.N = N;
  s.rows = rows, s.rs = rs, s.plane = rows * rs;
  s.c1off = (C * s.plane + 63) / 64 * 64 + 32;
  s.ckp = (C * k * s.kp + 7) / 8 * 8, s.ks = (s.ckp + 15) / 16;
  s.nst = (s.ks + 3) / 4, s.nsl = (N + TN - 1) / TN;
  s.stages = stages, s.nbuf = nbuf;
  s.items = (s.M + TM - 1) / TM * s.nsl, s.chunk = chunk;
  const int img_bytes = 2 * (s.c1off + C * s.plane);
  s.img = stages * STAGE + STAGING;
  s.tab = s.img + (nbuf * img_bytes + 15) / 16 * 16;
  s.bars = s.tab + s.ks * 32;
  s.smem = s.bars + (2 * stages + 4) * 8;
  const size_t smem = 1024 + s.smem;
  if (B < 1 || C < 1 || k < 1 || s.Ho < 1 || s.Wo < 1 || N < 8 || N % 8 ||
      rs % 2 || rs < W + 2 * pad + 1 || stages < 2 || nbuf < 1 || nbuf > 2 ||
      G < 1 || chunk < 1 || (long long)G * chunk < s.items ||
      (long long)(G - 1) * chunk >= s.items || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_w, m_out;
  const uint64_t d_w[2] = {(uint64_t)s.ckp, (uint64_t)N};
  const uint64_t st_w[1] = {(uint64_t)s.ckp * 2};
  const uint32_t box_w[2] = {64, TN};
  const uint64_t d_o[2] = {(uint64_t)N, (uint64_t)s.M};
  const uint64_t st_o[1] = {(uint64_t)N * 2};
  const uint32_t box_o[2] = {64, 128};
  int err;
  if ((err = make_map_strided(&m_w, wk, 2, d_w, st_w, box_w))) return err;
  if ((err = make_map_strided(&m_out, out, 2, d_o, st_o, box_o))) return err;
  if ((err = allow_smem(fwd_kernel, smem))) return err;
  fwd_kernel<<<G, THREADS, smem, (cudaStream_t)stream>>>(
      m_w, m_out, (const float*)y, s);
  return (int)cudaGetLastError();
}
