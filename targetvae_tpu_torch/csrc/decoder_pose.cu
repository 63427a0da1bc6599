// K7: pose-aware fused decoder, forward.
//
// Replaces the forward of targetvae_tpu/kernels/decoder_pose.py
// (_fwd_kernel), the Pallas kernel behind fused_pose_decoder. For image b
// and pixel (i, j) of the n x n grid:
//   f     = bf16(U[b, j] * P[b, i] - V[b, j] * Q[b, i])        (F features)
//   h     = bf16(act(f @ W1 + b1 + hz[b]))                     W1 (F, H) bf16
//   h     = bf16(act(h @ Wh[l] + bh[l]))   for l < L - 1       Wh (L-1, H, H) bf16
//   y     = h @ W3 + b3                                        W3 (H, n_out) bf16
// with f32 accumulation everywhere; U, V, P, Q (B, n, F) f32 are built in
// plain PyTorch outside the kernel (kernels/decoder_pose.py::pose_tables).
//
// What bounds it on the H100: the tensor cores, fed from L2. At the
// flagship shape (B = 100, n = 50, F = 1024, H = 512, L = 2) it does about
// 0.39 TFLOP per batch (0.40 ms at the bf16 peak), while its own
// device-memory traffic is ~80 MB of tables and 1 MB of output; the
// unfused form would write and read a 1 GB (pixels, F) feature matrix. What
// stands between it and that bound is the L2: every 64-pixel tile streams
// all of W1 and Wh (1.5 MB) and its pixels' table rows through the SMs.
//
// Design: csrc/decoder_wgmma.cuh's forward with the FEAT_POSE feature
// source: one block per (64-pixel tile, image); the weights arrive by TMA
// through a four-stage ring of 32-row slices in wgmma's swizzled layout,
// while three producer warps build the next 64-feature slice of the tile
// into its swizzled buffer; two consumer warpgroups (H = 512: 256 columns
// each) run m64n256k16 products with f32 accumulators in registers and
// write the bf16 h tile, the next layer's A operand, from them. The
// features are products taken without FMA contraction, so they round
// exactly as the plain version's. The (pixels, F) matrix never reaches
// device memory.
//
// Save-residuals mode (training only; the TPU kernel's save_res=True): with
// a non-null hs_out the kernel also writes each layer's bf16 h tile, L tiles
// of (B, n*n, H), by TMA store, for the backward (K8,
// csrc/decoder_pose_bwd.cu). At the flagship that is 2 x 256 MB more writes
// (~0.15 ms at 3.35 TB/s). Serving passes null and writes nothing extra; y
// is bitwise the same in both modes.
#include "decoder_wgmma.cuh"

TVAE_WG_PROBE_READER(tvae_probe_pose_decoder_fwd)

extern "C" int tvae_pose_decoder_fwd(const void* u, const void* v,
                                     const void* p, const void* q,
                                     const void* hz, const void* w1,
                                     const void* b1, const void* wh,
                                     const void* bh, const void* w3,
                                     const void* b3, void* y, void* hs_out,
                                     int B, int n, int F, int H, int L,
                                     int n_out, int act, void* stream) {
  const wg::FeatSrc fs{(const float*)u, (const float*)v, (const float*)p,
                       (const float*)q, n};
  return wg::launch_fwd<wg::FEAT_POSE>(fs, hz, w1, b1, wh, bh, w3, b3, y,
                                       hs_out, B, n * n, F, H, L, n_out, act,
                                       (cudaStream_t)stream);
}
