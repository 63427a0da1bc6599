// K8: the backward of the pose-aware fused decoder (K7, csrc/decoder_pose.cu).
//
// Replaces targetvae_tpu/kernels/decoder_pose.py::_bwd_kernel, the Pallas
// kernel of _bwd, with _vjp_bwd's reduction of the pose cotangents. It
// consumes the bf16 h tiles K7 saved (the JAX contract, _vjp_fwd) and, with
// g16 = bf16(g), computes
//   db3 = sum g; dW3 = h_{L-1}^T g16; dh = g16 W3^T
//   for l = L-1 .. 1: dpre = dh * act'(h_l); dWh[l-1] = h_{l-1}^T bf16(dpre);
//                     dbh[l-1] = sum dpre;   dh = bf16(dpre) Wh[l-1]^T
//   dpre1 = dh * act'(h_0); db1 = sum dpre1; dhz[b] = its per-image sum
//   dW1 = features^T bf16(dpre1), features = bf16(U P - V Q) rebuilt on chip
//   T = (bf16(dpre1) W1^T) * (V P + U Q), reduced over the pixels against
//   (gx, gy, 1) into dfx, dfy, dfc (B, F), negated
// (T is the phase cotangent: d cos(ax + ay) = -sin(ax + ay), and
// sin(ax + ay) = V P + U Q). The caller closes dfx/dfy/dfc into dtheta and
// d(dx) with O(B F) work. The (pixels, F) matrices never reach device
// memory.
//
// What bounds it on the H100: the tensor cores. At the flagship shape
// (B = 100, n = 50, F = 1024, H = 512, L = 2) dW1 and the phase product are
// 2 * 250,000 * 1024 * 512 = 262 GFLOP each and the hidden layer's pair
// another 262: ~0.79 TFLOP, >= 0.8 ms at the bf16 peak, against ~0.6 GB of
// traffic (the saved h tiles, the tables, the bf16 dpre tiles it writes
// and reads back).
//
// Design: passes, all deterministic (fixed grids, no float atomics, partial
// sums added in a fixed order by csrc/reduce.cu), every product on wgmma
// with TMA-fed, 128-byte-swizzled operands (csrc/decoder_wgmma.cuh):
//  1. chain (wg::chain_kernel): one block per 64-pixel tile and image, from
//     g down to dpre1 in the accumulators; each layer's bf16(dpre) tile is
//     the next W^T product's A operand and goes to device memory by TMA
//     store; per-tile column sums, dW3 and db3 to one row of `part`.
//  2. in-order sums: per image (dhz), then over the batch (db1, dbh, dW3,
//     db3).
//  3. wgrad (wg::wgrad_kernel): dW1 = features^T bf16(dpre1) and
//     dWh[l-1] = h_{l-1}^T bf16(dpre_l) as split-K products, 128 x 256
//     output tiles with both operands MN-major (no transpose in memory), the
//     feature operand rebuilt by builder warps once per 256-column half;
//     the splits fill the card in one wave and are summed in order.
//  4. pose (pose_kernel below): one block per (64-pixel tile, image) keeps
//     the tile's bf16(dpre1) resident and streams W1 through a TMA ring:
//     (64 x H) x (H x 256) products on wgmma, then T and its three weighted
//     sums straight from the accumulator registers (each thread knows its
//     fragment's pixel and feature), reduced over the tile's rows in a
//     fixed order into a per-tile partial; step 5 adds the partials in
//     order, per image.
// Fusing pass 4 into pass 1 would save re-reading dpre1 (256 MB, ~0.08 ms)
// but would double the chain kernel's shared memory and registers; the
// passes stay apart.
#include "decoder_wgmma.cuh"

namespace {

using namespace wg;

// Features a block of the pose pass: 128 for each consumer warpgroup, so
// that 64 accumulators a thread leave registers for the table loads of the
// epilogue to be in flight together
constexpr int PF = 256;
constexpr int PNW = PF / 2;
constexpr int PSTAGE = PF * 128;     // 64 rows of H x PF features
constexpr int PSTAGES = 4;

template <int H>
struct PoseShape {
  static constexpr int AT = TM * H * 2;
  static constexpr int RED = 3 * 4 * PF * 4;   // (3 sums, 4 warps, PF)
  static constexpr int SMEM = AT + PSTAGES * PSTAGE + RED + 64 * 8 + 1024;
};

// pass 4. For tile t0 of image b: T = bf16(dpre1) W1^T (64 x F), times
// s = V[j] P[i] + U[j] Q[i], summed over the tile's pixels against
// (gx[j], gy[i], 1); dpart row (b, tile) = -(the three sums) (3, F).
template <int H>
__global__ void __launch_bounds__(384, 1) pose_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_w1, const float* __restrict__ U,
    const float* __restrict__ V, const float* __restrict__ Pt,
    const float* __restrict__ Q, const float* __restrict__ gx,
    const float* __restrict__ gy, float* __restrict__ dpart, int n, int F) {
  using S = PoseShape<H>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* at = align1024(smem_raw);
  unsigned char* ring = at + S::AT;
  float* red = reinterpret_cast<float*>(ring + PSTAGES * PSTAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 3 * 4 * PF);
  uint64_t* empty = full + PSTAGES;
  uint64_t* afull = empty + PSTAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * TM, npx = n * n;
  const int nfb = (F + PF - 1) / PF;
  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(afull, 1);
    mbar_init_fence();
  }
  __syncthreads();

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
  // this thread's two pixel rows and their grid coordinates
  const int r0 = acc_row(t, 0);
  int ii[2], jj[2];
  bool ok[2];
  float gxv[2], gyv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = t0 + r0 + 8 * h;
    ok[h] = pix < npx;
    ii[h] = ok[h] ? pix / n : 0;
    jj[h] = ok[h] ? pix - ii[h] * n : 0;
    gxv[h] = gx[jj[h]];
    gyv[h] = gy[ii[h]];
  }
  const size_t tb = (size_t)b * n * F;
  float* out = dpart + ((size_t)b * gridDim.x + blockIdx.x) * 3 * F;
  mbar_wait(afull, 0);

  float acc[PNW / 2];
  int it = 0;
  for (int fb = 0; fb < nfb; ++fb) {
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
          tab[g][h][0] = *reinterpret_cast<const float2*>(U + oj);
          tab[g][h][1] = *reinterpret_cast<const float2*>(V + oj);
          tab[g][h][2] = *reinterpret_cast<const float2*>(Pt + oi);
          tab[g][h][3] = *reinterpret_cast<const float2*>(Q + oi);
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
    for (int i = tid; i < 3 * PF; i += 256) {
      const int k = i / PF, fl = i - k * PF, f = fb * PF + fl;
      const float* rk = red + k * 4 * PF + fl;
      if (f < F) out[(size_t)k * F + f] = -(rk[0] + rk[PF] + rk[2 * PF] + rk[3 * PF]);
    }
    bar_sync(1, 256);
  }
}

template <int H>
int launch_pose_h(const void* dP, const void* w1, const void* u,
                  const void* v, const void* p, const void* q,
                  const void* gx, const void* gy, void* dpart, int B, int n,
                  int F, int L, cudaStream_t stream) {
  using S = PoseShape<H>;
  const int npx = n * n;
  CUtensorMap ma, mw;
  const uint32_t box_a[2] = {64, TM}, box_w[2] = {64, PF};
  const uint64_t d_a[3] = {(uint64_t)H, (uint64_t)npx, (uint64_t)L * B};
  const uint64_t d_w[2] = {(uint64_t)H, (uint64_t)F};
  int err;
  if ((err = make_map(&ma, dP, 3, d_a, box_a))) return err;
  if ((err = make_map(&mw, w1, 2, d_w, box_w))) return err;
  if ((err = allow_smem(pose_kernel<H>, S::SMEM))) return err;
  pose_kernel<H><<<dim3((npx + TM - 1) / TM, B), 384, S::SMEM, stream>>>(
      ma, mw, (const float*)u, (const float*)v, (const float*)p,
      (const float*)q, (const float*)gx, (const float*)gy, (float*)dpart, n,
      F);
  return (int)cudaGetLastError();
}

int launch_pose(int H, const void* dP, const void* w1, const void* u,
                const void* v, const void* p, const void* q, const void* gx,
                const void* gy, void* dpart, int B, int n, int F, int L,
                cudaStream_t s) {
  switch (H) {
    case 64:
      return launch_pose_h<64>(dP, w1, u, v, p, q, gx, gy, dpart, B, n, F, L, s);
    case 128:
      return launch_pose_h<128>(dP, w1, u, v, p, q, gx, gy, dpart, B, n, F, L, s);
    case 256:
      return launch_pose_h<256>(dP, w1, u, v, p, q, gx, gy, dpart, B, n, F, L, s);
    case 512:
      return launch_pose_h<512>(dP, w1, u, v, p, q, gx, gy, dpart, B, n, F, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the chain pass for H in (64, 128, 256, 512); part holds
// B * ceil(npx / TM) rows of X = L*H + H*n_out + n_out floats
int launch_chain(const void* g, const void* hs, const void* wh,
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

}  // namespace

// The backward of K7 (passes in the comment above). Inputs: u, v, p, q
// (B, n, F) f32; w1 (F, H), wh (L-1, H, H), w3 (H, n_out) bf16; g
// (B, n*n, n_out) f32; hs (L, B, n*n, H) bf16 saved by the forward; gx, gy
// (n,) f32. Scratch: dP (L, B, n*n, H) bf16; part (B * tiles, X) f32 with
// X = L*H + H*n_out + n_out and tiles = ceil(n*n / 64); gpart
// (max(S1 F H, S2 H H),) f32; dpart (B * tiles, 3, F) f32. Outputs:
// cols_img (B, X) per-image sums (dhz in its first H columns), cols (X,) the
// batch sums [db1 | dbh | dW3 | db3], df (B, 3, F) = [dfx | dfy | dfc],
// dw1 (F, H), dwh (L-1, H, H), all f32. S1 splits of C1 pixels for the dW1
// product, S2 of C2 for dWh (kernels/decoder_pose.py::split_schedule).
extern "C" int tvae_pose_decoder_bwd(
    const void* u, const void* v, const void* p, const void* q,
    const void* w1, const void* wh, const void* w3, const void* g,
    const void* hs, const void* gx, const void* gy, void* dP, void* part,
    void* cols_img, void* cols, void* gpart, void* dpart, void* df, void* dw1,
    void* dwh, int B, int n, int F, int H, int L, int n_out, int S1, int C1,
    int S2, int C2, int act, void* stream) {
  using namespace wg;
  if (F % 64 || n_out < 1 || n_out > MAX_OUT || L < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int npx = n * n, P = B * npx;
  const int ntiles = (npx + TM - 1) / TM;
  const int X = L * H + H * n_out + n_out;
  const FeatSrc fs{(const float*)u, (const float*)v, (const float*)p,
                   (const float*)q, n};
  const FeatSrc none{};
  int err;
  if ((err = launch_chain(g, hs, wh, w3, dP, part, B, npx, H, L, n_out, act, s)))
    return err;
  if ((err = sum_partials((const float*)part, (float*)cols_img, B, ntiles, X, s)))
    return err;
  if ((err = sum_partials((const float*)cols_img, (float*)cols, 1, B, X, s)))
    return err;

  if ((err = launch_wgrad<FEAT_POSE>(nullptr, 1, 0, fs, dP, L, 0,
                                     (float*)gpart, P, F, H, S1, C1, npx, s)))
    return err;
  if ((err = sum_partials((const float*)gpart, (float*)dw1, 1, S1, F * H, s)))
    return err;
  for (int l = 1; l < L; ++l) {
    if ((err = launch_wgrad<FEAT_NONE>(hs, L, l - 1, none, dP, L, l,
                                       (float*)gpart, P, H, H, S2, C2, npx, s)))
      return err;
    if ((err = sum_partials((const float*)gpart,
                            (float*)dwh + (size_t)(l - 1) * H * H, 1, S2,
                            H * H, s)))
      return err;
  }

  if ((err = launch_pose(H, dP, w1, u, v, p, q, gx, gy, dpart, B, n, F, L, s)))
    return err;
  return sum_partials((const float*)dpart, (float*)df, B, ntiles, 3 * F, s);
}
