// The joint posterior's kernels: K3/K4 over each image's whole grid, and
// K5/K6 over one cell shard of the grid-sharded posterior (further below).
// All four share the guarded-KL device functions.
//
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

// The guarded KLs of one cell, shared by K3-K6. At a dead cell (e^q == 0,
// live false) the moments are replaced by (0, 1), so a -1e30 pad, whose
// e^q is exactly 0, contributes 0 * finite = 0.
// KL(N(mu, std) || N(off, sig_r)); inv2s2 = 1 / (2 sig_r^2)
__device__ __forceinline__ float kl_theta(float mu, float std, float off,
                                          float sig_r, float inv2s2,
                                          bool live) {
  const float m = live ? mu : 0.f;
  const float s = live ? std : 1.f;
  const float dm = m - off;
  return logf(sig_r / s) + (s * s + dm * dm) * inv2s2 - 0.5f;
}

// KL(N(mu, std) || N(0, 1))
__device__ __forceinline__ float kl_unit(float mu, float std, bool live) {
  const float m = live ? mu : 0.f;
  const float s = live ? std : 1.f;
  return -logf(s) + 0.5f * (s * s + m * m) - 0.5f;
}

// The cotangents of a theta cell's mean and log-std (K4, K6): g . a plus,
// at a live cell, scale = g_kl e^q times the KL's derivative; s2 = sig_r^2.
__device__ __forceinline__ void theta_grads(float g_mu, float g_std, float a,
                                            float scale, bool live, float mu,
                                            float std, float off, float s2,
                                            float* d_mu, float* d_ls) {
  *d_mu = g_mu * a + (live ? scale * (mu - off) / s2 : 0.f);
  const float d_std = g_std * a + (live ? scale * (std / s2 - 1.f / std) : 0.f);
  *d_ls = d_std * (std - EPS);
}

// The same for a z cell against N(0, 1).
__device__ __forceinline__ void z_grads(float g_mu, float g_std, float a,
                                        float scale, bool live, float mu,
                                        float std, float* d_mu, float* d_ls) {
  *d_mu = g_mu * a + (live ? scale * mu : 0.f);
  const float d_std = g_std * a + (live ? scale * (std - 1.f / std) : 0.f);
  *d_ls = d_std * (std - EPS);
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
    const bool live = !(eq == 0.f);
    const float thm = tm[c];
    const float ths = expf(tl[c]) + EPS;
    v[2 * MAXZD + 0] += a * thm;
    v[2 * MAXZD + 1] += a * ths;
    v[2 * MAXZD + 2] += a * gx[mm];
    v[2 * MAXZD + 3] += a * gy[mm];
    const float kl_th = kl_theta(thm, ths, offs[r], sig_r, inv2s2, live);
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const float zmv = zm[(size_t)d * C + c];
        const float zs = expf(zl[(size_t)d * C + c]) + EPS;
        v[d] += a * zmv;
        v[MAXZD + d] += a * zs;
        kl_z += kl_unit(zmv, zs, live);
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
    const float kl_th = kl_theta(thm, ths, offs[r], sig_r, inv2s2, live);
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const size_t ic = (size_t)d * C + c;
        const float zmv = zm[ic];
        const float zs = expf(zl[ic]) + EPS;
        d_a += g_zmu[d] * zmv + g_zstd[d] * zs;
        kl_z += kl_unit(zmv, zs, live);
        z_grads(g_zmu[d], g_zstd[d], a, scale, live, zmv, zs, dz_mu + oz + ic,
                dz_ls + oz + ic);
      }
    }
    const float d_q = g_kl * eq * ((q - p_tr[c]) + 1.f + (kl_th + kl_z));
    theta_grads(g_thmu, g_thstd, a, scale, live, thm, ths, offs[r], s2,
                dth_mu + o1 + c, dth_ls + o1 + c);
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

// K5: one cell shard's posterior partials under global normalisers.
//
// Replaces targetvae_tpu/kernels/posterior.py::posterior_shard_partials'
// forward (_sp_fwd_kernel, the pallas_call at :466), the per-rank kernel of
// the grid-sharded (sequence-parallel) posterior. For each image, over the C
// cells of this rank's shard, with norms = [gmax_q, g_logsum_q, gmax_a,
// g_logsum_a] computed across ranks by the caller:
//   q = attn - gmax_q - g_logsum_q;  e^q;  a = exp(attn + noise - gmax_a - g_logsum_a)
// and the 2*zd + 5 partial sums [sum a z_mu (zd), sum a z_std (zd),
// sum a th_mu, sum a th_std, sum a gx, sum a gy,
// sum e^q (q - p) + sum e^q (KL_theta + sum_d KL_z)], which the caller
// all-reduces. p, gx, gy and offs are per cell (the r-minor flatten of the
// grid), unlike K3's (R, M) planes.
//
// What bounds it on the H100: memory. At the flagship's two-rank shard
// (B = 100, C = 6,144, zd = 2) it reads 8 planes of 2.5 MB once (~20 MB:
// >= 0.006 ms); the arithmetic is ~100 flops a cell.
//
// Design: one block of 512 threads per image, strided over the shard's
// cells in one pass (the normalisers arrive precomputed, so K3's max and
// normaliser passes and its Philox are gone); the sums are reduced with
// warp shuffles, then across warps in shared memory in a fixed order, so a
// rerun is bitwise equal. No atomics. The TPU kernel's (C / 128, 128) view
// and its C % 1024 rule are TPU tiling: any C is taken.
__global__ void __launch_bounds__(THREADS) posterior_shard_fwd_kernel(
    const float* __restrict__ norms, const float* __restrict__ attn,
    const float* __restrict__ noise, const float* __restrict__ th,
    const float* __restrict__ z, const float* __restrict__ p,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ offs, float* __restrict__ out, int C, int zd,
    float sig_r) {
  __shared__ float red[WARPS * NACC];
  __shared__ float tot[NACC];
  const int b = blockIdx.x;
  const float* at = attn + (size_t)b * C;
  const float* nz = noise + (size_t)b * C;
  const float* tm = th + (size_t)b * 2 * C;
  const float* tl = tm + C;
  const float* zm = z + (size_t)b * 2 * zd * C;
  const float* zl = zm + (size_t)zd * C;
  const float n0 = norms[4 * b], n1 = norms[4 * b + 1];
  const float n2 = norms[4 * b + 2], n3 = norms[4 * b + 3];
  const float inv2s2 = 1.f / (2.f * sig_r * sig_r);

  // v: [z_mu_e (MAXZD) | z_std_e (MAXZD) | th_mu_e, th_std_e, dx0, dx1, val1, val2]
  float v[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) v[j] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float x = at[c];
    const float q = x - n0 - n1;
    const float eq = expf(q);
    const float a = expf(x + nz[c] - n2 - n3);
    const bool live = !(eq == 0.f);
    const float thm = tm[c];
    const float ths = expf(tl[c]) + EPS;
    v[2 * MAXZD + 0] += a * thm;
    v[2 * MAXZD + 1] += a * ths;
    v[2 * MAXZD + 2] += a * gx[c];
    v[2 * MAXZD + 3] += a * gy[c];
    const float kl_th = kl_theta(thm, ths, offs[c], sig_r, inv2s2, live);
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const float zmv = zm[(size_t)d * C + c];
        const float zs = expf(zl[(size_t)d * C + c]) + EPS;
        v[d] += a * zmv;
        v[MAXZD + d] += a * zs;
        kl_z += kl_unit(zmv, zs, live);
      }
    }
    v[2 * MAXZD + 4] += eq * (q - p[c]);
    v[2 * MAXZD + 5] += eq * (kl_th + kl_z);
  }
  block_sum(v, NACC, red, tot);

  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * (2 * zd + 5);
    for (int d = 0; d < zd; ++d) {
      o[d] = tot[d];
      o[zd + d] = tot[MAXZD + d];
    }
    for (int j = 0; j < 4; ++j) o[2 * zd + j] = tot[2 * MAXZD + j];
    o[2 * zd + 4] = tot[2 * MAXZD + 4] + tot[2 * MAXZD + 5];
  }
}

// K6: phase 1 of K5's VJP.
//
// Replaces posterior_shard_partials' backward (_sp_bwd_kernel, the
// pallas_call at :477). With the TOTAL packed cotangent g (the caller
// all-reduces it first) = [g_zmu (zd), g_zstd (zd), g_thmu, g_thstd, g_dx0,
// g_dx1, g_kl], for each cell of the shard:
//   d_a = g_thmu th_mu + g_thstd th_std + g_dx0 gx + g_dx1 gy + sum_d g_z . z
//   d_q = g_kl e^q (q - p + 1 + KL_theta + sum_d KL_z)
//   dth, dz as K4 (theta_grads, z_grads)
// and per image spart = [sum d_a a, sum d_q], the softmax VJPs' local sums;
// the caller all-reduces them and finishes
// d_attn = a (d_a - S1) + d_q - e^q S2 elementwise. A -1e30 pad has a = e^q
// = 0, so its d_q, dth, dz and its d_attn are exactly 0.
//
// What bounds it on the H100: memory. At the flagship's two-rank shard it
// reads 8 planes and writes 8 (~39 MB: >= 0.012 ms).
//
// Design: one block of 512 threads per image, one pass over its cells,
// each thread writing its own cells' gradients; the two sums in K5's fixed
// order. No atomics: a rerun gives bitwise the same gradients.
__global__ void __launch_bounds__(THREADS) posterior_shard_bwd_kernel(
    const float* __restrict__ norms, const float* __restrict__ attn,
    const float* __restrict__ noise, const float* __restrict__ th,
    const float* __restrict__ z, const float* __restrict__ p,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ offs, const float* __restrict__ g,
    float* __restrict__ da, float* __restrict__ dq, float* __restrict__ dth,
    float* __restrict__ dz, float* __restrict__ spart, int C, int zd,
    float sig_r) {
  __shared__ float red[WARPS * NACC];
  __shared__ float tot[NACC];
  const int b = blockIdx.x;
  const size_t o1 = (size_t)b * C, o2 = (size_t)b * 2 * C;
  const size_t oz = (size_t)b * 2 * zd * C, zl_off = (size_t)zd * C;
  const float* at = attn + o1;
  const float* nz = noise + o1;
  const float* tm = th + o2;
  const float* tl = tm + C;
  const float* zm = z + oz;
  const float* zl = zm + zl_off;
  const float n0 = norms[4 * b], n1 = norms[4 * b + 1];
  const float n2 = norms[4 * b + 2], n3 = norms[4 * b + 3];
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

  float v[NACC];
  v[0] = 0.f;
  v[1] = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float x = at[c];
    const float q = x - n0 - n1;
    const float eq = expf(q);
    const float a = expf(x + nz[c] - n2 - n3);
    const bool live = !(eq == 0.f);
    const float scale = g_kl * eq;
    const float thm = tm[c];
    const float ths = expf(tl[c]) + EPS;
    float d_a = g_thmu * thm + g_thstd * ths + g_dx0 * gx[c] + g_dx1 * gy[c];
    const float kl_th = kl_theta(thm, ths, offs[c], sig_r, inv2s2, live);
    float kl_z = 0.f;
#pragma unroll
    for (int d = 0; d < MAXZD; ++d) {
      if (d < zd) {
        const size_t ic = (size_t)d * C + c;
        const float zmv = zm[ic];
        const float zs = expf(zl[ic]) + EPS;
        d_a += g_zmu[d] * zmv + g_zstd[d] * zs;
        kl_z += kl_unit(zmv, zs, live);
        z_grads(g_zmu[d], g_zstd[d], a, scale, live, zmv, zs, dz + oz + ic,
                dz + oz + zl_off + ic);
      }
    }
    const float d_q = g_kl * eq * ((q - p[c]) + 1.f + (kl_th + kl_z));
    theta_grads(g_thmu, g_thstd, a, scale, live, thm, ths, offs[c], s2,
                dth + o2 + c, dth + o2 + C + c);
    da[o1 + c] = d_a;
    dq[o1 + c] = d_q;
    v[0] += d_a * a;
    v[1] += d_q;
  }
  block_sum(v, 2, red, tot);
  if (threadIdx.x == 0) {
    spart[2 * b] = tot[0];
    spart[2 * b + 1] = tot[1];
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

// K5: the shard's (B, 2*zd + 5) partial sums; norms (B, 4), attn and noise
// (B, C), th (B, 2, C), z (B, 2, zd, C), p, gx, gy, offs (C,).
extern "C" int tvae_posterior_shard_fwd(const void* norms, const void* attn,
                                        const void* noise, const void* th,
                                        const void* z, const void* p,
                                        const void* gx, const void* gy,
                                        const void* offs, void* out, int B,
                                        int C, int zd, float sig_r,
                                        void* stream) {
  if (zd > MAXZD) return (int)cudaErrorInvalidValue;
  posterior_shard_fwd_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)norms, (const float*)attn, (const float*)noise,
      (const float*)th, (const float*)z, (const float*)p, (const float*)gx,
      (const float*)gy, (const float*)offs, (float*)out, C, zd, sig_r);
  return (int)cudaGetLastError();
}

// K6: K5's inputs and the total cotangent g (B, 2*zd + 5); da, dq (B, C),
// dth (B, 2, C), dz (B, 2, zd, C), spart (B, 2).
extern "C" int tvae_posterior_shard_bwd(const void* norms, const void* attn,
                                        const void* noise, const void* th,
                                        const void* z, const void* p,
                                        const void* gx, const void* gy,
                                        const void* offs, const void* g,
                                        void* da, void* dq, void* dth,
                                        void* dz, void* spart, int B, int C,
                                        int zd, float sig_r, void* stream) {
  if (zd > MAXZD) return (int)cudaErrorInvalidValue;
  posterior_shard_bwd_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)norms, (const float*)attn, (const float*)noise,
      (const float*)th, (const float*)z, (const float*)p, (const float*)gx,
      (const float*)gy, (const float*)offs, (const float*)g, (float*)da,
      (float*)dq, (float*)dth, (float*)dz, (float*)spart, C, zd, sig_r);
  return (int)cudaGetLastError();
}
