// K3: fused joint posterior, forward.
//
// Replaces the forward of targetvae_tpu/kernels/posterior.py::_call
// (_fwd_kernel / _posterior_core), the Pallas kernel behind fused_posterior.
// For each image, over its C = R*M cells (float32 throughout):
//   q  = log_softmax(attn);  a = softmax(attn + Gumbel) or e^q (deterministic)
//   dx = E_a[grid];  E_a[z_mu], E_a[z_std], E_a[theta_mu], E_a[theta_std]
//   kl = sum e^q (q - p_tr) + sum e^q (KL_theta + sum_d KL_z)   [e^q == 0 guarded]
// and writes 2*zd + 5 scalars per image:
//   [z_mu_e (zd), z_std_e (zd), theta_mu_e, theta_std_e, dx0, dx1, kl].
//
// What bounds it on the H100: memory and latency. At the flagship shape
// (B = 100, R = 8, M = 39*39, zd = 2) the inputs are ~34 MB, read in three
// passes of which the later ones hit L2, and the arithmetic is a few hundred
// flops per cell; one image's reductions are a chain of block-wide syncs.
//
// Design: one block of 512 threads per image, strided over its cells; block
// reductions (warp shuffles, then shared memory) give the max, the two
// normalisers and the 2*zd + 6 weighted sums, so only per-image scalars
// leave the chip. The Gumbel noise comes from a hand-written Philox4x32-10
// keyed by (seed + image index, 0) with the cell index as counter, and is
// recomputed in each pass instead of stored, so a row depends only on its
// image's inputs and seed: splitting a batch and offsetting the seed gives
// the same rows. The uniform takes the top 23 bits as a [1, 2) mantissa
// minus 1 and is clipped to [1e-20, 1 - 1e-7], as the TPU kernel does.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXZD = 8;
constexpr int NACC = 2 * MAXZD + 6;
constexpr float EPS = 1e-6f;

__device__ __forceinline__ uint32_t philox_x(uint32_t counter, uint32_t seed) {
  uint32_t c0 = counter, c1 = 0u, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ float gumbel(uint32_t cell, uint32_t seed) {
  const uint32_t bits = philox_x(cell, seed);
  float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.f;
  u = fminf(fmaxf(u, 1e-20f), 1.f - 1e-7f);
  return -logf(-logf(u));
}

// max over the block of one value per thread; red holds >= WARPS floats
__device__ float block_max(float v, float* red) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// sums over the block of n values per thread; result in out[0..n)
__device__ __forceinline__ void block_sum(float* v, int n, float* red,
                                          float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    if (j < n) {
      float x = v[j];
      for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) red[warp * NACC + j] = x;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * NACC + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) posterior_fwd_kernel(
    const float* __restrict__ attn, const float* __restrict__ th_mu,
    const float* __restrict__ th_ls, const float* __restrict__ z_mu,
    const float* __restrict__ z_ls, const float* __restrict__ p_tr,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ offs, float* __restrict__ out, int R, int M,
    int zd, float sig_r, int deterministic, uint32_t seed) {
  __shared__ float red[WARPS * NACC];
  __shared__ float tot[NACC];
  const int b = blockIdx.x;
  const int C = R * M;
  const float* at = attn + (size_t)b * C;
  const float* tm = th_mu + (size_t)b * C;
  const float* tl = th_ls + (size_t)b * C;
  const float* zm = z_mu + (size_t)b * zd * C;
  const float* zl = z_ls + (size_t)b * zd * C;
  const uint32_t key = seed + (uint32_t)b;

  // pass 1: maxima of the logits and of the perturbed logits
  float m = -INFINITY, ma = -INFINITY;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    m = fmaxf(m, at[c]);
    if (!deterministic) ma = fmaxf(ma, at[c] + gumbel(c, key));
  }
  m = block_max(m, red);
  if (!deterministic) ma = block_max(ma, red);

  // pass 2: the two normalisers
  float v[NACC];
  v[0] = 0.f;
  v[1] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    v[0] += expf(at[c] - m);
    if (!deterministic) v[1] += expf(at[c] + gumbel(c, key) - ma);
  }
  block_sum(v, 2, red, tot);
  const float s = tot[0], sa = tot[1];
  const float log_s = logf(s);
  const float inv2s2 = 1.f / (2.f * sig_r * sig_r);

  // pass 3: expectations under a, KL under e^q
  // v: [z_mu_e (MAXZD) | z_std_e (MAXZD) | th_mu_e, th_std_e, dx0, dx1, val1, val2]
#pragma unroll
  for (int j = 0; j < NACC; ++j) v[j] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int r = c / M, mm = c - r * M;
    const float sh = at[c] - m;
    const float eq = expf(sh) / s;
    const float q = sh - log_s;
    const float a =
        deterministic ? eq : expf(at[c] + gumbel(c, key) - ma) / sa;
    const bool dead = eq == 0.f;
    const float thm = tm[c];
    const float ths = expf(tl[c]) + EPS;
    v[2 * MAXZD + 0] += a * thm;
    v[2 * MAXZD + 1] += a * ths;
    v[2 * MAXZD + 2] += a * gx[mm];
    v[2 * MAXZD + 3] += a * gy[mm];
    const float tqm = dead ? 0.f : thm;
    const float tqs = dead ? 1.f : ths;
    const float dm = tqm - offs[r];
    const float kl_th = logf(sig_r / tqs) + (tqs * tqs + dm * dm) * inv2s2 - 0.5f;
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const float zmv = zm[(size_t)d * C + c];
        const float zs = expf(zl[(size_t)d * C + c]) + EPS;
        v[d] += a * zmv;
        v[MAXZD + d] += a * zs;
        const float zqm = dead ? 0.f : zmv;
        const float zqs = dead ? 1.f : zs;
        kl_z += -logf(zqs) + 0.5f * (zqs * zqs + zqm * zqm) - 0.5f;
      }
    }
    v[2 * MAXZD + 4] += eq * (q - p_tr[c]);
    v[2 * MAXZD + 5] += eq * (kl_th + kl_z);
  }
  block_sum(v, NACC, red, tot);

  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * (2 * zd + 5);
    for (int d = 0; d < zd; ++d) {
      o[d] = tot[d];
      o[zd + d] = tot[MAXZD + d];
    }
    o[2 * zd + 0] = tot[2 * MAXZD + 0];
    o[2 * zd + 1] = tot[2 * MAXZD + 1];
    o[2 * zd + 2] = tot[2 * MAXZD + 2];
    o[2 * zd + 3] = tot[2 * MAXZD + 3];
    o[2 * zd + 4] = tot[2 * MAXZD + 4] + tot[2 * MAXZD + 5];
  }
}

// K4: the backward of K3.
//
// Replaces the backward of targetvae_tpu/kernels/posterior.py::_call
// (_bwd_kernel / _bwd_one). It recomputes the forward of its image with the
// SAME noise: the Philox bits are regenerated from the seed the forward was
// given (seed + image index, cell index as counter), so nothing but the
// inputs and the seed is kept between the two. With the packed cotangent
// g = [g_zmu (zd), g_zstd (zd), g_thmu, g_thstd, g_dx0, g_dx1, g_kl]:
//   d_a    = g_thmu th_mu + g_thstd th_std + g_dx . grid + sum_d g_z . z
//   d_q    = g_kl e^q (q - p_tr + 1 + KL_theta + sum_d KL_z)
//   dth, dz = g . a + g_kl e^q dKL/d(moment)  [the KL part where e^q > 0],
//            chained through exp for the log-std planes
//   dattn  = a (d_a - sum d_a a) + d_q - e^q sum d_q
//
// What bounds it on the H100: memory and latency, like K3. At the flagship
// shape it reads 7 planes of 4.9 MB and writes 7 (~68 MB: >= 0.02 ms).
//
// Design: one block of 512 threads per image, as K3. Passes 1-2 give the
// maxima and normalisers; pass 3 writes the theta and z gradients and
// a d_a + d_q into the dattn plane while summing d_a a and d_q; pass 4
// finishes dattn -= a sum(d_a a) + e^q sum(d_q), each thread on its own
// cells. No atomics: a rerun gives bitwise the same gradients.
__global__ void __launch_bounds__(THREADS) posterior_bwd_kernel(
    const float* __restrict__ attn, const float* __restrict__ th_mu,
    const float* __restrict__ th_ls, const float* __restrict__ z_mu,
    const float* __restrict__ z_ls, const float* __restrict__ p_tr,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ offs, const float* __restrict__ g,
    float* __restrict__ dattn, float* __restrict__ dth_mu,
    float* __restrict__ dth_ls, float* __restrict__ dz_mu,
    float* __restrict__ dz_ls, int R, int M, int zd, float sig_r,
    int deterministic, uint32_t seed) {
  __shared__ float red[WARPS * NACC];
  __shared__ float tot[NACC];
  const int b = blockIdx.x;
  const int C = R * M;
  const size_t o1 = (size_t)b * C, oz = (size_t)b * zd * C;
  const float* at = attn + o1;
  const float* tm = th_mu + o1;
  const float* tl = th_ls + o1;
  const float* zm = z_mu + oz;
  const float* zl = z_ls + oz;
  float* da = dattn + o1;
  const uint32_t key = seed + (uint32_t)b;

  // passes 1-2: as the forward
  float m = -INFINITY, ma = -INFINITY;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    m = fmaxf(m, at[c]);
    if (!deterministic) ma = fmaxf(ma, at[c] + gumbel(c, key));
  }
  m = block_max(m, red);
  if (!deterministic) ma = block_max(ma, red);
  float v[NACC];
  v[0] = 0.f;
  v[1] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    v[0] += expf(at[c] - m);
    if (!deterministic) v[1] += expf(at[c] + gumbel(c, key) - ma);
  }
  block_sum(v, 2, red, tot);
  const float s = tot[0], sa = tot[1];
  const float log_s = logf(s);
  const float s2 = sig_r * sig_r;
  const float inv2s2 = 1.f / (2.f * s2);

  const float* gb = g + (size_t)b * (2 * zd + 5);
  float g_zmu[MAXZD], g_zstd[MAXZD];
#pragma unroll
  for (int d = 0; d < MAXZD; ++d) {
    g_zmu[d] = d < zd ? gb[d] : 0.f;
    g_zstd[d] = d < zd ? gb[zd + d] : 0.f;
  }
  const float g_thmu = gb[2 * zd], g_thstd = gb[2 * zd + 1];
  const float g_dx0 = gb[2 * zd + 2], g_dx1 = gb[2 * zd + 3];
  const float g_kl = gb[2 * zd + 4];

  // pass 3: theta and z gradients; a d_a + d_q into dattn; sum d_a a, sum d_q
  v[0] = 0.f;
  v[1] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int r = c / M, mm = c - r * M;
    const float sh = at[c] - m;
    const float eq = expf(sh) / s;
    const float q = sh - log_s;
    const float a =
        deterministic ? eq : expf(at[c] + gumbel(c, key) - ma) / sa;
    const bool live = !(eq == 0.f);
    const float scale = g_kl * eq;
    const float thm = tm[c];
    const float ths = expf(tl[c]) + EPS;
    float d_a = g_thmu * thm + g_thstd * ths + (g_dx0 * gx[mm] + g_dx1 * gy[mm]);
    const float tqm = live ? thm : 0.f;
    const float tqs = live ? ths : 1.f;
    const float dm = tqm - offs[r];
    const float kl_th = logf(sig_r / tqs) + (tqs * tqs + dm * dm) * inv2s2 - 0.5f;
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const size_t ic = (size_t)d * C + c;
        const float zmv = zm[ic];
        const float zs = expf(zl[ic]) + EPS;
        d_a += g_zmu[d] * zmv + g_zstd[d] * zs;
        const float zqm = live ? zmv : 0.f;
        const float zqs = live ? zs : 1.f;
        kl_z += -logf(zqs) + 0.5f * (zqs * zqs + zqm * zqm) - 0.5f;
        dz_mu[oz + ic] = g_zmu[d] * a + (live ? scale * zmv : 0.f);
        const float d_zs = g_zstd[d] * a + (live ? scale * (zs - 1.f / zs) : 0.f);
        dz_ls[oz + ic] = d_zs * (zs - EPS);
      }
    }
    const float d_q = g_kl * eq * ((q - p_tr[c]) + 1.f + (kl_th + kl_z));
    dth_mu[o1 + c] = g_thmu * a + (live ? scale * (thm - offs[r]) / s2 : 0.f);
    const float d_ths = g_thstd * a + (live ? scale * (ths / s2 - 1.f / ths) : 0.f);
    dth_ls[o1 + c] = d_ths * (ths - EPS);
    v[0] += d_a * a;
    v[1] += d_q;
    da[c] = a * d_a + d_q;
  }
  block_sum(v, 2, red, tot);
  const float s_da = tot[0], s_dq = tot[1];

  // pass 4: the two softmax VJPs' normalising terms
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float eq = expf(at[c] - m) / s;
    const float a =
        deterministic ? eq : expf(at[c] + gumbel(c, key) - ma) / sa;
    da[c] = da[c] - a * s_da - eq * s_dq;
  }
}

}  // namespace

// Gradients of K3's packed output; dattn, dth_* (B, R, M), dz_* (B, zd, R, M).
extern "C" int tvae_posterior_bwd(const void* attn, const void* th_mu,
                                  const void* th_ls, const void* z_mu,
                                  const void* z_ls, const void* p_tr,
                                  const void* gx, const void* gy,
                                  const void* offs, const void* g,
                                  void* dattn, void* dth_mu, void* dth_ls,
                                  void* dz_mu, void* dz_ls, int B, int R,
                                  int M, int zd, float sig_r,
                                  int deterministic, int seed, void* stream) {
  if (zd > MAXZD) return (int)cudaErrorInvalidValue;
  posterior_bwd_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)attn, (const float*)th_mu, (const float*)th_ls,
      (const float*)z_mu, (const float*)z_ls, (const float*)p_tr,
      (const float*)gx, (const float*)gy, (const float*)offs,
      (const float*)g, (float*)dattn, (float*)dth_mu, (float*)dth_ls,
      (float*)dz_mu, (float*)dz_ls, R, M, zd, sig_r, deterministic,
      (uint32_t)seed);
  return (int)cudaGetLastError();
}

extern "C" int tvae_posterior_fwd(const void* attn, const void* th_mu,
                                  const void* th_ls, const void* z_mu,
                                  const void* z_ls, const void* p_tr,
                                  const void* gx, const void* gy,
                                  const void* offs, void* out, int B, int R,
                                  int M, int zd, float sig_r,
                                  int deterministic, int seed, void* stream) {
  if (zd > MAXZD) return (int)cudaErrorInvalidValue;
  posterior_fwd_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)attn, (const float*)th_mu, (const float*)th_ls,
      (const float*)z_mu, (const float*)z_ls, (const float*)p_tr,
      (const float*)gx, (const float*)gy, (const float*)offs, (float*)out, R,
      M, zd, sig_r, deterministic, (uint32_t)seed);
  return (int)cudaGetLastError();
}
