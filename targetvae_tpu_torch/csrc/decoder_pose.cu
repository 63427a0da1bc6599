// K7: pose-aware fused decoder, forward.
//
// Replaces the forward of targetvae_tpu/kernels/decoder_pose.py
// (_fwd_kernel with save_res=False), the Pallas kernel behind
// fused_pose_decoder. For image b and pixel (i, j) of the n x n grid:
//   f     = bf16(U[b, j] * P[b, i] - V[b, j] * Q[b, i])        (F features)
//   h     = bf16(act(f @ W1 + b1 + hz[b]))                     W1 (F, H) bf16
//   h     = bf16(act(h @ Wh[l] + bh[l]))   for l < L - 1       Wh (L-1, H, H) bf16
//   y     = h @ W3 + b3                                        W3 (H, n_out) bf16
// with f32 accumulation everywhere; U, V, P, Q (B, n, F) f32 are built in
// plain PyTorch outside the kernel (kernels/decoder_pose.py::pose_tables).
//
// What bounds it on the H100: the tensor cores. At the flagship shape
// (B = 100, n = 50, F = 1024, H = 512, L = 2) it does about 0.39 TFLOP per
// batch, while its own device-memory traffic is ~80 MB of tables and 1 MB of
// output; the unfused form would write and read a 1 GB (pixels, F) feature
// matrix.
//
// Design: csrc/decoder_chain.cuh's forward with the FEAT_POSE feature
// source: one block per (pixel tile of 32, image), the feature tile rebuilt
// in shared memory as bf16 beside the matching rows of W1, nvcuda::wmma
// fragments, the (pixels, F) matrix never in device memory. The features
// are products taken without FMA contraction, so they round exactly as the
// plain version's. wgmma/TMA and a larger pixel tile (each block re-reads
// W1 from L2) are later work.
//
// Save-residuals mode (training only; the TPU kernel's save_res=True): with
// a non-null hs_out the kernel also writes each layer's bf16 h tile, L tiles
// of (B, n*n, H), for the backward (K8 below). At the flagship that is
// 2 x 256 MB more writes (~0.15 ms at 3.35 TB/s). Serving passes null and
// writes nothing extra.
#include "decoder_chain.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// K8: the backward of K7.
//
// Replaces targetvae_tpu/kernels/decoder_pose.py::_bwd_kernel, the Pallas
// kernel of _bwd. It consumes the bf16 h tiles K7 saved (the JAX contract,
// _vjp_fwd) and, with g16 = bf16(g), computes
//   db3 = sum g; dW3 = h_{L-1}^T g16; dh = g16 W3^T
//   for l = L-1 .. 1: dpre = dh * act'(h_l); dWh[l-1] = h_{l-1}^T bf16(dpre);
//                     dbh[l-1] = sum dpre;   dh = bf16(dpre) Wh[l-1]^T
//   dpre1 = dh * act'(h_0); db1 = sum dpre1; dhz[b] = its per-image sum
//   dW1 = features^T bf16(dpre1), features = bf16(U P - V Q) rebuilt on chip
//   T = (bf16(dpre1) W1^T) * (V P + U Q), reduced over the pixels against
//   (1, gx, gy) into dfc, dfx, dfy (B, F), negated
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
// Design. The TPU kernel carries every weight gradient across its
// sequential grid; CUDA blocks run in no order, and dW1 alone is 2 MB of
// f32, so the work is cut into passes, all of them deterministic:
//  1. chain (one block per 32-pixel tile and image, as K7): from g down to
//     dpre1, through shared memory, with the hidden layers' W^T products on
//     nvcuda::wmma fragments (the columns of Wh stream through two cp.async
//     buffers). It writes each layer's bf16(dpre) tile to device memory and
//     its own partial column sums, dW3 and db3 to one row of `part`.
//  2. csrc/reduce.cu adds the rows in order: per image (dhz), then over
//     the batch (db1, dbh, dW3, db3).
//  3. wgrad: the split-K products dW1 = features^T bf16(dpre1) (the
//     feature tile rebuilt from U, V, P, Q in shared memory, as in K7) and
//     dWh[l-1] = h_{l-1}^T bf16(dpre_l), 64 x 128 output tiles on wmma
//     fragments, each split writing its own partial, then summed in order.
//  4. pose: one block per (64 features, image), the image's U, V, P, Q
//     columns for them in shared memory, walks the image's pixels 32 at a
//     time: the (32 x H) x (H x 64) phase product on wmma fragments, then T
//     and its three weighted sums, each thread one feature and a quarter of
//     the pixels, the quarters added in order at the end.
// Passes 1 and 3 are csrc/decoder_chain.cuh's (the chain kernel and the
// split-K wgrad with the FEAT_POSE feature source).
// So a rerun gives bitwise the same gradients, and the tolerance against
// the plain version is that of two f32 summation orders over bf16 operands.
constexpr int FB = 64;      // features per block of the pose reduction
constexpr int PT = 32;      // pixels per step of the pose reduction
constexpr int PG = THREADS / FB;   // its pixel groups: thread = (group, feature)

// pass 4. dfc, dfx, dfy (B, F) for features [f0, f0 + FB) of image b. The
// image's U, V, P, Q columns for these features sit in shared memory; each
// thread owns one feature and one of PG pixel groups, and the groups' sums
// are added in order at the end.
__global__ void __launch_bounds__(THREADS) pose_reduce_kernel(
    const __nv_bfloat16* __restrict__ dP0, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ Pt, const float* __restrict__ Q,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dfc,
    int n, int F, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [W1 rows f0.. FB*LDH bf16 | bf16(dpre1) tile PT*LDH bf16 | product
  //  PT*FB | U, V, P, Q columns 4*n*FB | gx, gy 2*n | group sums 3*PG*FB
  //  (f32)]; rows padded to LDH = H + PAD against bank conflicts
  const int LDH = H + PAD;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = w1s + FB * LDH;
  float* stg = reinterpret_cast<float*>(ds + PT * LDH);
  float* tu = stg + PT * FB;
  float* tv = tu + n * FB;
  float* tp = tv + n * FB;
  float* tq = tp + n * FB;
  float* sgx = tq + n * FB;
  float* sgy = sgx + n;
  float* red = sgy + n;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int f0 = blockIdx.x * FB, b = blockIdx.y;
  const int npx = n * n;
  const int H8 = H / 8;
  for (int i = tid; i < FB * H8; i += THREADS) {
    const int r = i / H8, q = (i - r * H8) * 8;
    *reinterpret_cast<uint4*>(w1s + r * LDH + q) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)(f0 + r) * H + q);
  }
  for (int i = tid; i < n * FB; i += THREADS) {
    const int r = i / FB, ff = i - r * FB;
    const size_t src = ((size_t)b * n + r) * F + f0 + ff;
    tu[i] = U[src];
    tv[i] = V[src];
    tp[i] = Pt[src];
    tq[i] = Q[src];
  }
  for (int i = tid; i < n; i += THREADS) {
    sgx[i] = gx[i];
    sgy[i] = gy[i];
  }
  const int grp = tid / FB, ff = tid - grp * FB;
  const __nv_bfloat16* db = dP0 + (size_t)b * npx * H;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
  for (int t0 = 0; t0 < npx; t0 += PT) {
    for (int i = tid; i < PT * H8; i += THREADS) {
      const int pp = i / H8, q = (i - pp * H8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + pp < npx)
        v = *reinterpret_cast<const uint4*>(db + (size_t)(t0 + pp) * H + q);
      *reinterpret_cast<uint4*>(ds + pp * LDH + q) = v;
    }
    __syncthreads();
    // df3 = bf16(dpre1) W1^T for these pixels and features: (PT/16) x
    // (FB/16) fragments, one a warp
    {
      const int mi = warp / (FB / 16), ni = warp % (FB / 16);
      BwdFragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < H; kk += 16) {
        BwdFragA a;
        BwdFragBc bm;
        wmma::load_matrix_sync(a, ds + mi * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(bm, w1s + ni * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(stg + mi * 16 * FB + ni * 16, acc, FB,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int p = grp; p < PT && t0 + p < npx; p += PG) {
      const int pix = t0 + p, i = pix / n, j = pix - i * n;
      const float s = __fadd_rn(__fmul_rn(tv[j * FB + ff], tp[i * FB + ff]),
                                __fmul_rn(tu[j * FB + ff], tq[i * FB + ff]));
      const float t = __fmul_rn(stg[p * FB + ff], s);
      r0 += t;
      r1 += __fmul_rn(sgx[j], t);
      r2 += __fmul_rn(sgy[i], t);
    }
    __syncthreads();
  }
  red[(grp * 3 + 0) * FB + ff] = r0;
  red[(grp * 3 + 1) * FB + ff] = r1;
  red[(grp * 3 + 2) * FB + ff] = r2;
  __syncthreads();
  if (tid < 3 * FB) {
    const int k = tid / FB, f = tid - k * FB;
    float sum = 0.f;
    for (int g = 0; g < PG; ++g) sum += red[(g * 3 + k) * FB + f];
    float* o = k == 0 ? dfc : (k == 1 ? dfx : dfy);
    o[(size_t)b * F + f0 + f] = -sum;
  }
}

}  // namespace

extern "C" int tvae_pose_decoder_fwd(const void* u, const void* v,
                                     const void* p, const void* q,
                                     const void* hz, const void* w1,
                                     const void* b1, const void* wh,
                                     const void* bh, const void* w3,
                                     const void* b3, void* y, void* hs_out,
                                     int B, int n, int F, int H, int L,
                                     int n_out, int act, void* stream) {
  const FeatArgs fa{(const float*)u, (const float*)v, (const float*)p,
                    (const float*)q, nullptr, nullptr, nullptr, n};
  return launch_fwd<FEAT_POSE>(fa, hz, w1, b1, wh, bh, w3, b3, y, hs_out, B,
                               n * n, F, H, L, n_out, act, (cudaStream_t)stream);
}

// The backward of K7 (passes in the comment above K8). Inputs: u, v, p, q
// (B, n, F) f32; w1 (F, H), wh (L-1, H, H), w3 (H, n_out) bf16; g
// (B, n*n, n_out) f32; hs (L, B, n*n, H) bf16 saved by the forward; gx, gy
// (n,) f32. Scratch: dP (L, B, n*n, H) bf16; part (B * tiles, X) f32 with
// X = L*H + H*n_out + n_out and tiles = ceil(n*n / 32); gpart
// (max(S1 F H, S2 H H),) f32. Outputs: cols_img (B, X) per-image sums (dhz in
// its first H columns), cols (X,) the batch sums [db1 | dbh | dW3 | db3],
// dfx, dfy, dfc (B, F), dw1 (F, H), dwh (L-1, H, H), all f32. S1, S2 are
// the pixel splits of the dW1 and dWh products.
extern "C" int tvae_pose_decoder_bwd(
    const void* u, const void* v, const void* p, const void* q,
    const void* w1, const void* wh, const void* w3, const void* g,
    const void* hs, const void* gx, const void* gy, void* dP, void* part,
    void* cols_img, void* cols, void* gpart, void* dfx, void* dfy, void* dfc,
    void* dw1, void* dwh, int B, int n, int F, int H, int L, int n_out,
    int S1, int S2, int act, void* stream) {
  if (F % BT || H % BT || n_out < 1 || n_out > MAX_OUT || L < 2 || S1 < 1 ||
      S2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int npx = n * n, P = B * npx;
  const int ntiles = (npx + TPX - 1) / TPX;
  const int X = L * H + H * n_out + n_out;
  const size_t plane = (size_t)B * npx * H;
  const __nv_bfloat16* hsb = (const __nv_bfloat16*)hs;
  __nv_bfloat16* dPb = (__nv_bfloat16*)dP;
  const FeatArgs fa{(const float*)u, (const float*)v, (const float*)p,
                    (const float*)q, nullptr, nullptr, nullptr, n};
  const FeatArgs none{};
  int err;
  if ((err = launch_chain(g, hs, wh, w3, dP, part, B, npx, H, L, n_out, act, s)))
    return err;
  if ((err = sum_partials((const float*)part, (float*)cols_img, B, ntiles, X, s)))
    return err;
  if ((err = sum_partials((const float*)cols_img, (float*)cols, 1, B, X, s)))
    return err;

  if ((err = launch_wgrad<FEAT_POSE>(nullptr, fa, dPb, (float*)gpart, P, F, H,
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

  const size_t smem = ((size_t)FB + PT) * (H + PAD) * 2 +
                      ((size_t)PT * FB + 4 * (size_t)n * FB + 2 * n +
                       3 * PG * FB) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;   // n above ~115
  if ((err = allow_smem(pose_reduce_kernel, smem))) return err;
  pose_reduce_kernel<<<dim3(F / FB, B), THREADS, smem, s>>>(
      dPb, (const __nv_bfloat16*)w1, (const float*)u, (const float*)v,
      (const float*)p, (const float*)q, (const float*)gx, (const float*)gy,
      (float*)dfx, (float*)dfy, (float*)dfc, n, F, H);
  return (int)cudaGetLastError();
}
