// K9: the decoder at arbitrary coordinates, forward.
//
// Replaces targetvae_tpu/kernels/decoder_mlp.py::_fwd_kernel, the Pallas
// kernel behind fused_decoder_mlp (bf16 generator_apply / decode). For image
// b and pixel p with coordinates x (B, npx, 2):
//   f = bf16(cos(x0 wf[0] + x1 wf[1] + bf))        (F features, f32 phase)
//   h = bf16(act(f @ W1 + b1 + hz[b]))              W1 (F, H) bf16
//   h = bf16(act(h @ Wh[l] + bh[l]))  for l < L-1   Wh (L-1, H, H) bf16
//   y = h @ W3 + b3                                 W3 (H, n_out) bf16
// with f32 accumulation; wf is already divided by sigma.
//
// What bounds it on the H100: the tensor cores. At the flagship decoder
// (B = 100, npx = 2,500, F = 1,024, H = 512, L = 2) it does 0.39 TFLOP
// against 2 MB of coordinates and 1 MB of output (0.40 ms at the bf16
// peak); the unfused form would write and read a 1 GB (pixels, F) feature
// matrix. One step removed: its 256 M cosines (~30 instructions each),
// built while the tensor cores run the slice before; a clock64 probe
// (tools/probe_decoder_mlp.py) shows the products waiting for them.
//
// Design: csrc/decoder_wgmma.cuh's forward (K7's) with the FEAT_COORD
// feature source: one block per (64-pixel tile, image), W1 and Wh through a
// TMA ring into wgmma's swizzled layout, two consumer warpgroups on
// m64n256k16 and their epilogues from the accumulator registers. Each
// 64-feature slice's bf16(cos(phase)) is built by the three builder warps
// (the tile's first 24 rows, wf and bf through a window in shared memory)
// and by the consumers themselves (the other 40 rows) while the slice
// before runs on the tensor cores. The phase's products and sums are
// rounded one by one in the plain version's order, the cosine is
// wg::trig_fast (no branch, an ulp or two), and a tile whose phases may
// pass its range (wmax bounds them) is built by the builders alone with
// the library's cosf there. The save-residuals mode is K10's first pass.
//
// K10: the backward of K9.
//
// Replaces targetvae_tpu/kernels/decoder_mlp.py::_bwd_kernel. Like the TPU
// kernel it saves nothing in the forward and recomputes it, and returns
// dx, dhz, dW1, db1, dWh, dbh, dW3, db3 (none for wf and bf). Passes, all
// on the wgmma kernels of csrc/decoder_wgmma.cuh and all deterministic
// (fixed grids, no float atomics, partial sums added in order by
// csrc/reduce.cu):
//  1. recompute: K9 in save-residuals mode writes the bf16 h tiles;
//  2. chain (wg::chain_kernel, K8's): from g down to dpre1, bf16 dpre tiles
//     by TMA store, per-tile column sums, dW3 and db3; rows past an image
//     are zero before any product (the TPU kernel's lesson: garbage rows
//     poison dW through NaN * 0);
//  3. in-order sums: per image (dhz), then over the batch (db1, dbh, dW3,
//     db3);
//  4. split-K wgrad (wg::wgrad_kernel): dW1 = features^T bf16(dpre1) with
//     the features rebuilt on chip (FEAT_COORD, 64 x 512 tiles that build
//     each feature once) and dWh[l-1] = h_{l-1}^T bf16(dpre_l);
//  5. dx (wg::phase_kernel<H, FEAT_COORD>): T = bf16(dpre1) W1^T on
//     m64n128 products with the tile's dpre1 resident and W1 through a TMA
//     ring, then dx = sum_f -sin(phase) T wf[:, f] straight from the
//     accumulator registers, reduced over the features in a fixed order.
// What bounds it: the tensor cores, ~1.18 TFLOP at the flagship (the
// forward's recompute, the hidden layer's two products, dW1 and T), 1.19 ms
// at the bf16 peak.
#include "decoder_wgmma.cuh"

using namespace wg;

TVAE_WG_PROBE_READER(tvae_probe_decoder_mlp_fwd)

// K9. x (B, npx, 2), wf (2, F), bf (F,), wmax (3,) = (max |wf[0]|,
// max |wf[1]|, max |bf|), hz (B, H) f32; w1 (F, H), wh (L-1, H, H),
// w3 (H, n_out) bf16; b1 (H,), bh (L-1, H), b3 (n_out,) f32;
// y (B, npx, n_out) f32; hs_out (L, B, npx, H) bf16 or null.
extern "C" int tvae_decoder_mlp_fwd(const void* x, const void* wf,
                                    const void* bf, const void* wmax,
                                    const void* hz, const void* w1,
                                    const void* b1, const void* wh,
                                    const void* bh, const void* w3,
                                    const void* b3, void* y, void* hs_out,
                                    int B, int npx, int F, int H, int L,
                                    int n_out, int act, void* stream) {
  if (F % 64) return (int)cudaErrorInvalidValue;
  const FeatSrc fs{nullptr, nullptr, nullptr, nullptr, F, (const float*)x,
                   (const float*)wf, (const float*)bf, (const float*)wmax};
  return launch_fwd<FEAT_COORD>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B,
                                npx, F, H, L, n_out, act, (cudaStream_t)stream);
}

// K10. The forward's inputs and g (B, npx, n_out) f32. Scratch: y
// (B, npx, n_out) f32 and hs (L, B, npx, H) bf16 for the recomputed
// forward; dP (L, B, npx, H) bf16; part (B * ceil(npx / 64), X) f32 with
// X = L*H + H*n_out + n_out; gpart (max(S1 F H, S2 H H),) f32. Outputs:
// cols_img (B, X) per-image sums (dhz in its first H columns), cols (X,)
// the batch sums [db1 | dbh | dW3 | db3], dx (B, npx, 2), dw1 (F, H),
// dwh (L-1, H, H), all f32. S1 splits of C1 pixels for the dW1 product, S2
// of C2 for dWh (kernels/decoder_pose.py::wgrad_schedule).
extern "C" int tvae_decoder_mlp_bwd(
    const void* x, const void* wf, const void* bf, const void* wmax,
    const void* hz, const void* w1, const void* b1, const void* wh,
    const void* bh, const void* w3, const void* b3, const void* g, void* y,
    void* hs,
    void* dP, void* part, void* cols_img, void* cols, void* gpart, void* dx,
    void* dw1, void* dwh, int B, int npx, int F, int H, int L, int n_out,
    int S1, int C1, int S2, int C2, int act, void* stream) {
  if (F % 64 || n_out < 1 || n_out > MAX_OUT || L < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int P = B * npx;
  const int ntiles = (npx + TM - 1) / TM;
  const int X = L * H + H * n_out + n_out;
  const FeatSrc fs{nullptr, nullptr, nullptr, nullptr, F, (const float*)x,
                   (const float*)wf, (const float*)bf, (const float*)wmax};
  const FeatSrc none{};
  int err;
  if ((err = launch_fwd<FEAT_COORD>(fs, hz, w1, b1, wh, bh, w3, b3, y, hs, B,
                                    npx, F, H, L, n_out, act, s)))
    return err;
  if ((err = launch_chain(g, hs, wh, w3, dP, part, B, npx, H, L, n_out, act, s)))
    return err;
  if ((err = sum_partials((const float*)part, (float*)cols_img, B, ntiles, X, s)))
    return err;
  if ((err = sum_partials((const float*)cols_img, (float*)cols, 1, B, X, s)))
    return err;
  if ((err = launch_wgrad<FEAT_COORD>(nullptr, 1, 0, fs, dP, L, 0,
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
  return launch_phase<FEAT_COORD>(H, dP, w1, fs, nullptr, nullptr, dx, B, npx,
                                  F, L, s);
}
