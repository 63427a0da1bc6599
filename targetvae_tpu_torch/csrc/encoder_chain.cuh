// The encoder chain's device code shared by csrc/mix_heads.cu (K1, K2),
// csrc/mix_heads_r1.cu (K1, K2 at R = 1) and csrc/lifted_encoder.cu (K11;
// K12's first pass is K2's chain): the tile constants and swizzled-tile
// helpers, the resident weights, and the forward tail that K1 and K11 run
// from a bf16 h1 tile (fwd_heads, its part after pre2, also ends the R = 1
// forward),
//   pre2 = h1 W2 + b2,  h2 = bf16(act(pre2)),  heads = h2 Wh + bh,
// with the heads of a tile kept in shared memory across its rotations and
// written out as one block.
//
// Forward work items are (128-position tile, rotation), rotations inner
// (kernels/mix_heads.py::chain_schedule with tile 128); consumer warpgroup
// w owns the item's positions [64 w, 64 w + 64) and all 128 channels, so
// each warpgroup runs its chain alone: pre2 on m64n128 (W2 as the MN-major
// B), h2 over h1 in place, the heads on m64n16 (Wh^T as a K-major B of 16
// rows). K < 128 is zero-padded to 128 channels (W2's and Wh's rows past K
// are zero) and the products stop after ceil(K / 16) k16 steps.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// The clock64 probe of the forward chain, compiled only with -DTVAE_PROBE
// (tools/probe_encoder_fwd.py): thread 0 of warpgroup 0 of every block adds
// its cycles into probe_sums: [0] waiting for ring stages, [1] K11's lift
// mainloop (waits included), [2] the rest of its items (h1's epilogue and
// the tail), [3] its items, and of the tail [4] pre2's product, [5] h2's
// epilogue, [6] the heads' product, [7] the heads' stores.
// TVAE_PROBE_READER(name) defines the C entry point that copies the sums
// out and zeroes them.
#ifdef TVAE_PROBE
#define PROBE(...) __VA_ARGS__
#define TVAE_PROBE_READER(name)                                              \
  extern "C" int name(void* host) {                                          \
    int e = (int)cudaMemcpyFromSymbol(host, chain::probe_sums,               \
                                      sizeof(chain::probe_sums));            \
    const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};                \
    return e ? e : (int)cudaMemcpyToSymbol(chain::probe_sums, z, sizeof(z)); \
  }
#else
#define PROBE(...)
#define TVAE_PROBE_READER(name)
#endif

namespace {
namespace chain {

#ifdef TVAE_PROBE
__device__ unsigned long long probe_sums[8];
__device__ __forceinline__ void probe_add(int t, int w, long long wait,
                                          long long main, long long rest,
                                          long long items, const long long* seg) {
  if (t == 0 && w == 0) {
    atomicAdd(&probe_sums[0], (unsigned long long)wait);
    atomicAdd(&probe_sums[1], (unsigned long long)main);
    atomicAdd(&probe_sums[2], (unsigned long long)rest);
    atomicAdd(&probe_sums[3], (unsigned long long)items);
    for (int k = 0; k < 4; ++k)
      atomicAdd(&probe_sums[4 + k], (unsigned long long)seg[k]);
  }
}
#endif

constexpr int TM = 64;                 // positions of a warpgroup's tile: wgmma's M
constexpr int KP = 128;                // channels, zero-padded past K
constexpr int TILE = TM * 128;         // 64 rows x 64 bf16, swizzled: 8 KB
constexpr int W2T = 2 * TILE;          // 128 rows x 64 columns: 16 KB
constexpr int HT = 2 * TILE;           // 64 positions x 128 channels
constexpr int WHT = 2 * 16 * 128;      // Wh^T: 16 heads x 128 channels, two tiles
constexpr int FWD_TM = 2 * TM;         // positions of a forward work item

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
// byte offset of element (r, n) of a swizzled tile of 64 bf16 columns
__device__ __forceinline__ int at(int r, int n) {
  return swz(r, n >> 3) + (n & 7) * 2;
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// W2 (K, K) as two 128 x 64 column tiles (row i = input channel i), zero
// past K: the MN-major B of pre2 = h1 W2 and the K-major B of h1's
// gradient; threads tid, tid + nt, ... of the block write it
__device__ __forceinline__ void stage_w2(unsigned char* w2s,
                                         const __nv_bfloat16* __restrict__ w2,
                                         int K, int tid, int nt) {
  for (int idx = tid; idx < KP * 16; idx += nt) {
    const int i = idx >> 4, cc = idx & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i < K && cc * 8 < K)
      v = *reinterpret_cast<const uint4*>(w2 + (size_t)i * K + cc * 8);
    *reinterpret_cast<uint4*>(w2s + (cc >> 3) * W2T + swz(i, cc & 7)) = v;
  }
}

// Wh^T (16 heads x 128 channels, zero past D and K) as two 16 x 64 tiles
// of 2 KB: the K-major B of heads = h2 Wh
__device__ __forceinline__ void stage_wht(unsigned char* wht,
                                          const __nv_bfloat16* __restrict__ wh,
                                          int K, int D, int tid, int nt) {
  for (int idx = tid; idx < 16 * 16; idx += nt) {
    const int d = idx >> 4, cc = idx & 15;
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = cc * 8 + e;
      h[e] = d < D && c < K ? wh[c * D + d] : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(wht + (cc >> 3) * 2048 + swz(d, cc & 7)) =
        *reinterpret_cast<uint4*>(h);
  }
}

// From pre2 = h1 W2 in acc (the accumulators of this warpgroup's 64
// positions x 128 channels, b2 not added): h2 = bf16(act(pre2 + b2)) into
// h (two swizzled tiles), then the heads h2 Wh into hd (8 registers: row
// acc_row(t, x), head acc_col(t, x); bh not added). nk = ceil(K / 16) k16
// steps. The callers pass act as a constant of their template, so that the
// epilogue's activation compiles to straight-line code. A TMA store still
// reading h (K11's saved h1) is waited for by thread 0 before h2 overwrites
// it when wait_store is set. `bar` is the warpgroup's named barrier; seg
// takes the probe's tail segments.
__device__ __forceinline__ void fwd_heads(float* acc, float* hd,
                                          unsigned char* h,
                                          const unsigned char* wht,
                                          const float* b2s, int nk, int t,
                                          int act, bool wait_store, int bar,
                                          long long* seg) {
  PROBE(long long c = clock64();)
  if (wait_store) {
    if (t == 0) tma_store_wait_read();
    bar_sync(bar, 128);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * (t & 3);
    const float bb0 = b2s[n], bb1 = b2s[n + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int x = 4 * j + 2 * hh;
      *reinterpret_cast<uint32_t*>(h + (n >> 6) * TILE + at(acc_row(t, x), n & 63)) =
          pack2(act_fn(acc[x] + bb0, act), act_fn(acc[x + 1] + bb1, act));
    }
  }
  fence_async_smem();
  bar_sync(bar, 128);                    // the whole h2 tile is written
  PROBE(seg[1] += clock64() - c; c = clock64();)
  // the heads as two independent sums, channels [0, 64) and [64, 128), so
  // that their k16 steps need not wait on one another
  float hd2[8];
  acc_fence<8>(hd);
  acc_fence<8>(hd2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < nk)
      wgmma<16, 0, 0>(kk < 4 ? hd : hd2,
                      gmma_desc(h + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                      gmma_desc(wht + (kk >> 2) * 2048 + (kk & 3) * 32, 16, 1024),
                      kk & 3);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<8>(hd);
  acc_fence<8>(hd2);
  if (nk > 4)
#pragma unroll
    for (int x = 0; x < 8; ++x) hd[x] += hd2[x];
  PROBE(seg[2] += clock64() - c;)
}

// The forward from this warpgroup's bf16 h1 at h (64 positions x 128
// channels, two swizzled tiles): pre2 = h1 W2 into acc, then fwd_heads with
// h2 over h1 in place.
__device__ __forceinline__ void fwd_tail(float* acc, float* hd, unsigned char* h,
                                         const unsigned char* w2s,
                                         const unsigned char* wht,
                                         const float* b2s, int nk, int t,
                                         int act, bool wait_store, int bar,
                                         long long* seg) {
  PROBE(long long c = clock64();)
  acc_fence<64>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < nk)
      wgmma<128, 0, 1>(acc, gmma_desc(h + (kk >> 2) * TILE + (kk & 3) * 32, 16, 1024),
                       gmma_desc(w2s + kk * 2048, W2T, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<64>(acc);
  PROBE(seg[0] += clock64() - c;)
  fwd_heads(acc, hd, h, wht, b2s, nk, t, act, wait_store, bar, seg);
}

// The heads of this warpgroup's 64 positions (the first at p0w) for
// rotation r, + bh: into buf (64 x R D f32 in shared memory, a tile's
// contiguous rows of out) or, with no buffer, straight to out (N, R D)
__device__ __forceinline__ void put_heads(const float* hd, float* buf,
                                          float* __restrict__ out,
                                          const float* bhs, int p0w, int r,
                                          int N, int R, int D, int t) {
  const int RD = R * D;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int row = acc_row(t, x), d = acc_col(t, x);
    if (d < D) {
      const float v = hd[x] + bhs[d];
      if (buf)
        buf[row * RD + r * D + d] = v;
      else if (p0w + row < N)
        out[(size_t)(p0w + row) * RD + r * D + d] = v;
    }
  }
}

// Writes rotations [ra, rb] of this warpgroup's buffered heads to out: one
// bulk copy when the rows hold every rotation and their bytes are a
// multiple of 16, plain stores otherwise (a tile the persistent grid split
// between two blocks, a ragged last tile)
__device__ __forceinline__ void flush_heads(const float* buf,
                                            float* __restrict__ out, int p0w,
                                            int ra, int rb, int N, int R,
                                            int D, int t, int bar) {
  fence_async_smem();
  bar_sync(bar, 128);
  const int rows = min(TM, N - p0w), RD = R * D;
  if (rows <= 0) return;
  if (ra == 0 && rb == R - 1 && (rows * RD) % 4 == 0) {
    if (t == 0) {
      bulk_store(out + (size_t)p0w * RD, buf, (uint32_t)rows * RD * 4);
      tma_store_commit();
    }
  } else {
    const int c0 = ra * D, cw = (rb - ra + 1) * D;
    for (int idx = t; idx < rows * cw; idx += 128) {
      const int row = idx / cw, c = c0 + idx - row * cw;
      out[(size_t)(p0w + row) * RD + c] = buf[row * RD + c];
    }
  }
}

// Before the first heads of the next tile go into buf: the last flush has
// read it
__device__ __forceinline__ void reuse_heads(int t, int bar) {
  if (t == 0) tma_store_wait_read();
  bar_sync(bar, 128);
}

}  // namespace chain
}  // namespace
