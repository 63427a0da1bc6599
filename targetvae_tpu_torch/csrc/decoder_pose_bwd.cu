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
//  4. pose (wg::phase_kernel<H, FEAT_POSE>): one block per (64-pixel tile,
//     image) keeps the tile's bf16(dpre1) resident and streams W1 through a
//     TMA ring: (64 x H) x (H x 256) products on wgmma, then T and its
//     three weighted sums straight from the accumulator registers (each
//     thread knows its fragment's pixel and feature), reduced over the
//     tile's rows in a fixed order into a per-tile partial; step 5 adds the
//     partials in order, per image.
// Fusing pass 4 into pass 1 would save re-reading dpre1 (256 MB, ~0.08 ms)
// but would double the chain kernel's shared memory and registers; the
// passes stay apart.
#include "decoder_wgmma.cuh"

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

  if ((err = launch_phase<FEAT_POSE>(H, dP, w1, fs, gx, gy, dpart, B, npx, F,
                                     L, s)))
    return err;
  return sum_partials((const float*)dpart, (float*)df, B, ntiles, 3 * F, s);
}
