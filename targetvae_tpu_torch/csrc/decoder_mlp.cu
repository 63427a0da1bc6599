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
// against 2 MB of coordinates and 1 MB of output; the unfused form would
// write and read a 1 GB (pixels, F) feature matrix.
//
// Design: the chain of csrc/decoder_chain.cuh (K7's before it moved to
// csrc/decoder_wgmma.cuh) with the FEAT_COORD feature
// source, which evaluates each feature's phase on chip with products and
// sums taken without FMA contraction and the accurate cosf (at
// sigma = 2/49 the phase reaches tens of radians, beyond what __cosf
// holds). The save-residuals mode is K10's first pass.
//
// K10: the backward of K9.
//
// Replaces targetvae_tpu/kernels/decoder_mlp.py::_bwd_kernel. Like the TPU
// kernel it saves nothing in the forward and recomputes it, and returns
// dx, dhz, dW1, db1, dWh, dbh, dW3, db3 (none for wf and bf). Passes, all
// deterministic (fixed grids, partial sums added in order by
// csrc/reduce.cu):
//  1. K9 in save-residuals mode writes the recomputed bf16 h tiles;
//  2. the chain pass of csrc/decoder_chain.cuh from g down to
//     dpre1: bf16 dpre tiles, per-tile column sums, dW3, db3; rows past an
//     image are zero before any product (the TPU kernel's lesson: garbage
//     rows poison dW through NaN * 0);
//  3. in-order sums: per image (dhz), then over the batch (db1, dbh, dW3,
//     db3);
//  4. split-K wgrad: dW1 = features^T bf16(dpre1) with the features rebuilt
//     on chip (FEAT_COORD), and dWh[l-1] = h_{l-1}^T bf16(dpre_l);
//  5. dx: one block per (64 pixels, image) walks F in chunks of 64:
//     df = bf16(dpre1) W1^T on wmma fragments, then
//     dx += sum_f -sin(phase) df wf[:, f], the phase rebuilt as in the
//     forward (accurate sinf); four threads a pixel, their sums added in
//     order at the end.
// What bounds it: the tensor cores, ~0.79 TFLOP at the flagship (the
// forward's recompute, the hidden layer's two products, dW1 and df), >= 0.8 ms
// at the bf16 peak.
#include "decoder_chain.cuh"

using namespace nvcuda;

namespace {

constexpr int DX_TP = 64;   // pixels per block of the dx pass
constexpr int DX_FB = 64;   // features per step of the dx pass
constexpr int DX_LDS = DX_FB + 4;   // f32 product rows, padded
constexpr int DX_G = THREADS / DX_TP;   // threads a pixel

// pass 5. dx (B, npx, 2) for pixels [t0, t0 + DX_TP) of image b.
__global__ void __launch_bounds__(THREADS) mlp_dx_kernel(
    const __nv_bfloat16* __restrict__ dP0, const __nv_bfloat16* __restrict__ w1,
    FeatArgs fa, float* __restrict__ dx, int npx, int F, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [bf16(dpre1) tile DX_TP*LDH | W1 rows DX_FB*LDH (bf16) | product
  //  DX_TP*DX_LDS | x 2*DX_TP | group sums 2*DX_G*DX_TP (f32)]
  const int LDH = H + PAD;
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1s = ds + DX_TP * LDH;
  float* stg = reinterpret_cast<float*>(w1s + DX_FB * LDH);
  float* sx = stg + DX_TP * DX_LDS;
  float* red = sx + 2 * DX_TP;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * DX_TP;
  const int H8 = H / 8;
  const __nv_bfloat16* db = dP0 + ((size_t)b * npx + t0) * H;
  for (int i = tid; i < DX_TP * H8; i += THREADS) {
    const int pp = i / H8, q = (i - pp * H8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + pp < npx) v = *reinterpret_cast<const uint4*>(db + (size_t)pp * H + q);
    *reinterpret_cast<uint4*>(ds + pp * LDH + q) = v;
  }
  for (int i = tid; i < 2 * DX_TP; i += THREADS)
    sx[i] = t0 + i / 2 < npx ? fa.X[((size_t)b * npx + t0) * 2 + i] : 0.f;

  // thread = (pixel p, group j); group j takes features j, j + DX_G, ...
  const int p = tid / DX_G, j = tid - p * DX_G;
  // this warp's two 16 x 16 fragments of the DX_TP x DX_FB product
  const int mi = warp / 2, ni0 = (warp % 2) * 2;
  float r0 = 0.f, r1 = 0.f;
  for (int f0 = 0; f0 < F; f0 += DX_FB) {
    for (int i = tid; i < DX_FB * H8; i += THREADS) {
      const int r = i / H8, q = (i - r * H8) * 8;
      *reinterpret_cast<uint4*>(w1s + r * LDH + q) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(f0 + r) * H + q);
    }
    __syncthreads();
    BwdFragC acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int kk = 0; kk < H; kk += 16) {
      BwdFragA a;
      wmma::load_matrix_sync(a, ds + mi * 16 * LDH + kk, LDH);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        BwdFragBc bm;
        wmma::load_matrix_sync(bm, w1s + (ni0 + k) * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc[k], a, bm, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wmma::store_matrix_sync(stg + mi * 16 * DX_LDS + (ni0 + k) * 16, acc[k],
                              DX_LDS, wmma::mem_row_major);
    __syncthreads();
    const float x0 = sx[2 * p], x1 = sx[2 * p + 1];
    for (int ff = j; ff < DX_FB; ff += DX_G) {
      const int f = f0 + ff;
      const float darg = -sinf(coord_phase(fa, x0, x1, f, F)) * stg[p * DX_LDS + ff];
      r0 = fmaf(darg, fa.WF[f], r0);
      r1 = fmaf(darg, fa.WF[F + f], r1);
    }
    __syncthreads();
  }
  red[(j * DX_TP + p) * 2] = r0;
  red[(j * DX_TP + p) * 2 + 1] = r1;
  __syncthreads();
  if (tid < 2 * DX_TP && t0 + tid / 2 < npx) {
    float s = 0.f;
    for (int g = 0; g < DX_G; ++g) s += red[g * DX_TP * 2 + tid];
    dx[((size_t)b * npx + t0) * 2 + tid] = s;
  }
}

}  // namespace

// K9. x (B, npx, 2), wf (2, F), bf (F,), hz (B, H) f32; w1 (F, H),
// wh (L-1, H, H), w3 (H, n_out) bf16; b1 (H,), bh (L-1, H), b3 (n_out,) f32;
// y (B, npx, n_out) f32; hs_out (L, B, npx, H) bf16 or null.
extern "C" int tvae_decoder_mlp_fwd(const void* x, const void* wf,
                                    const void* bf, const void* hz,
                                    const void* w1, const void* b1,
                                    const void* wh, const void* bh,
                                    const void* w3, const void* b3, void* y,
                                    void* hs_out, int B, int npx, int F, int H,
                                    int L, int n_out, int act, void* stream) {
  const FeatArgs fa{(const float*)x, (const float*)wf, (const float*)bf};
  return launch_fwd<FEAT_COORD>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B,
                                npx, F, H, L, n_out, act, (cudaStream_t)stream);
}

// K10. The forward's inputs and g (B, npx, n_out) f32. Scratch: y
// (B, npx, n_out) f32 and hs (L, B, npx, H) bf16 for the recomputed
// forward; dP (L, B, npx, H) bf16; part (B * ceil(npx / 32), X) f32 with
// X = L*H + H*n_out + n_out; gpart (max(S1 F H, S2 H H),) f32. Outputs:
// cols_img (B, X) per-image sums (dhz in its first H columns), cols (X,)
// the batch sums [db1 | dbh | dW3 | db3], dx (B, npx, 2), dw1 (F, H),
// dwh (L-1, H, H), all f32. S1, S2: the pixel splits of dW1 and dWh.
extern "C" int tvae_decoder_mlp_bwd(
    const void* x, const void* wf, const void* bf, const void* hz,
    const void* w1, const void* b1, const void* wh, const void* bh,
    const void* w3, const void* b3, const void* g, void* y, void* hs,
    void* dP, void* part, void* cols_img, void* cols, void* gpart, void* dx,
    void* dw1, void* dwh, int B, int npx, int F, int H, int L, int n_out,
    int S1, int S2, int act, void* stream) {
  if (F % BT || H % BT || F % DX_FB || L < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int P = B * npx;
  const int ntiles = (npx + TPX - 1) / TPX;
  const int X = L * H + H * n_out + n_out;
  const size_t plane = (size_t)B * npx * H;
  const __nv_bfloat16* hsb = (const __nv_bfloat16*)hs;
  __nv_bfloat16* dPb = (__nv_bfloat16*)dP;
  const FeatArgs fa{(const float*)x, (const float*)wf, (const float*)bf};
  const FeatArgs none{};
  int err;
  if ((err = launch_fwd<FEAT_COORD>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs, B,
                                    npx, F, H, L, n_out, act, s)))
    return err;
  if ((err = launch_chain(g, hs, wh, w3, dP, part, B, npx, H, L, n_out, act, s)))
    return err;
  if ((err = sum_partials((const float*)part, (float*)cols_img, B, ntiles, X, s)))
    return err;
  if ((err = sum_partials((const float*)cols_img, (float*)cols, 1, B, X, s)))
    return err;
  if ((err = launch_wgrad<FEAT_COORD>(nullptr, fa, dPb, (float*)gpart, P, F, H,
                                      S1, npx, F, s)))
    return err;
  if ((err = sum_partials((const float*)gpart, (float*)dw1, 1, S1, F * H, s)))
    return err;
  for (int l = 1; l < L; ++l) {
    if ((err = launch_wgrad<FEAT_NONE>(hsb + (size_t)(l - 1) * plane, none,
                                       dPb + (size_t)l * plane, (float*)gpart,
                                       P, H, H, S2, npx, H, s)))
      return err;
    if ((err = sum_partials((const float*)gpart,
                            (float*)dwh + (size_t)(l - 1) * H * H, 1, S2,
                            H * H, s)))
      return err;
  }
  const size_t smem = ((size_t)DX_TP + DX_FB) * (H + PAD) * 2 +
                      ((size_t)DX_TP * DX_LDS + 2 * DX_TP + 2 * DX_G * DX_TP) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(mlp_dx_kernel, smem))) return err;
  mlp_dx_kernel<<<dim3((npx + DX_TP - 1) / DX_TP, B), THREADS, smem, s>>>(
      dPb, (const __nv_bfloat16*)w1, fa, (float*)dx, npx, F, H);
  return (int)cudaGetLastError();
}
