// The joint posterior's kernels: K3/K4 over each image's whole grid, and
// K5/K6 over one cell shard of the grid-sharded posterior (further below).
// All four share the guarded-KL device functions.
//
// K3: fused joint posterior, forward.
//
// Replaces the forward of targetvae_tpu/kernels/posterior.py::_call
// (_fwd_kernel / _posterior_core), the Pallas kernel behind fused_posterior.
// It reads the encoder's raw heads where K1 and K11 leave them: (B, M, R, D)
// float32, D = 3 + 2 zd channels [attn, theta_mu, theta_logstd, z_mu (zd),
// z_logstd (zd)], cell c = m R + r of image b (m-major, r-minor, the JAX
// package's flatten). It adds the rotation prior p_r[r] to the logit and
// the offset offs[r] to theta_mu itself, and takes the joint log-prior p_tr
// (M, R) and the attention grid (M, 2). For each image, over its C = R M
// cells (float32 throughout):
//   q  = log_softmax(attn);  a = softmax(attn + Gumbel) or e^q (deterministic)
//   dx = E_a[grid];  E_a[z_mu], E_a[z_std], E_a[theta_mu], E_a[theta_std]
//   kl = sum e^q (q - p_tr) + sum e^q (KL_theta + sum_d KL_z)   [e^q == 0 guarded]
// and writes 2*zd + 5 scalars per image:
//   [z_mu_e (zd), z_std_e (zd), theta_mu_e, theta_std_e, dx0, dx1, kl].
//
// What bounds it on the H100: memory. At the flagship shape (B = 100,
// R = 8, M = 39*39, zd = 2) the heads are 34 MB (>= 0.010 ms at 3.35
// TB/s); the arithmetic, one Philox draw and ~60 float32 operations a cell,
// takes a few microseconds over the card.
//
// Design: one thread-block cluster an image (Hopper's clusters and
// distributed shared memory). The image's cells are cut into chunks of a
// multiple of 4 cells, one a CTA (4 CTAs of 3,044 cells at the flagship).
// Each CTA streams its chunk, with the chunk's p_tr, through a ring of 4
// stages of 256 cells in shared memory, each stage one pair of 1-D bulk
// copies completing on an mbarrier (the few floats of a ragged edge copied
// by the issuing thread, copy_edges), so every byte is read from device
// memory once. Each
// thread takes one cell a stage, draws its Gumbel noise once, and keeps a
// running sum of it in one pass, flash-attention style: q's and the
// sample's largest logit so far, the two normalisers and the 2 zd + 6
// weighted sums, rescaled whenever a larger logit arrives. A cell counts as
// dead (its moments guarded) when its weight under the thread's running
// maximum underflows; under the image's maximum its weight is then smaller
// still, so such a cell adds nothing either way. The warps' and then the
// CTA's sums merge by xor butterflies of rescaled sums, every CTA writes
// its sums into rank 0's shared memory, and rank 0 merges the ranks' in
// rank order and writes the image's scalars: one cluster barrier an image,
// and no pass waits on another CTA. (Holding whole chunks in shared memory
// instead, as K4 does, takes 34 MB of the card's 30 MB at B = 100: two
// waves of CTAs that each load, compute and meet in turn.) The noise is a
// hand-written Philox4x32-10 keyed by (seed + image index, 0) with counter
// r M + m, so a row depends only on its image's inputs and seed: splitting
// a batch and offsetting the seed gives the same rows. The uniform takes
// the top 23 bits as a [1, 2) mantissa minus 1 and is clipped to
// [1e-20, 1 - 1e-7], as the TPU kernel does. No atomics: a rerun is
// bitwise equal.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PT = 256;          // a K3/K4 CTA
constexpr int MAXZD = 8;
constexpr int MAXR = 16;
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

// sums over the block (NT threads) of n values per thread; result in
// out[0..n); red holds >= NT / 32 * NACC floats
template <int NT>
__device__ __forceinline__ void block_sum(const float* v, int n, float* red,
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
    for (int w = 0; w < NT / 32; ++w) s += red[w * NACC + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- K3 / K4 ----

constexpr int NPIECE = 4;        // bulk copies a chunk arrives in

// The guarded KLs of one cell and their derivatives, shared by K3-K6, in
// float32 on the SFU's approximations (__expf, __logf; reciprocals instead
// of divisions): within a few ulps of the plain versions', far inside
// TOL_K3 and TOL_K5. K3/K4's Gumbel noise keeps logf, so that it matches
// philox_gumbel's torch.log to an ulp. At a dead cell (e^q == 0, live
// false) the moments are replaced by (0, 1), so a -1e30 pad, whose e^q is
// exactly 0, contributes 0 * finite = 0.
// KL(N(mu, std) || N(off, sig_r)); log_sig_r = log sig_r,
// inv2s2 = 1 / (2 sig_r^2)
__device__ __forceinline__ float kl_theta_f(float mu, float std, float off,
                                            float log_sig_r, float inv2s2,
                                            bool live) {
  const float m = live ? mu : 0.f;
  const float s = live ? std : 1.f;
  const float dm = m - off;
  return log_sig_r - __logf(s) + (s * s + dm * dm) * inv2s2 - 0.5f;
}

// KL(N(mu, std) || N(0, 1))
__device__ __forceinline__ float kl_unit_f(float mu, float std, bool live) {
  const float m = live ? mu : 0.f;
  const float s = live ? std : 1.f;
  return -__logf(s) + 0.5f * (s * s + m * m) - 0.5f;
}

// The cotangents of a theta cell's mean and log-std (K4, K6): g . a plus,
// at a live cell, scale = g_kl e^q times the KL's derivative;
// inv_s2 = 1 / sig_r^2.
__device__ __forceinline__ void theta_grads_f(float g_mu, float g_std,
                                              float a, float scale, bool live,
                                              float mu, float std, float off,
                                              float inv_s2, float* d_mu,
                                              float* d_ls) {
  *d_mu = g_mu * a + (live ? scale * (mu - off) * inv_s2 : 0.f);
  const float d_std =
      g_std * a + (live ? scale * (std * inv_s2 - __frcp_rn(std)) : 0.f);
  *d_ls = d_std * (std - EPS);
}

// The same for a z cell against N(0, 1).
__device__ __forceinline__ void z_grads_f(float g_mu, float g_std, float a,
                                          float scale, bool live, float mu,
                                          float std, float* d_mu,
                                          float* d_ls) {
  *d_mu = g_mu * a + (live ? scale * mu : 0.f);
  const float d_std =
      g_std * a + (live ? scale * (std - __frcp_rn(std)) : 0.f);
  *d_ls = d_std * (std - EPS);
}

// One launch of K3 or K4: CTA `rank` of image b's cluster takes the cells
// [rank chunk, min(C, (rank + 1) chunk)), at most `sub` of them in shared
// memory at a time. The heads, p_tr and K4's output are 16-byte aligned
// and every chunk and sub-chunk starts on a multiple of 4 cells
// (post_args). At R >= 4 an image's R M cells are a multiple of 4 too, so
// every piece of cells is a whole number of 16-byte bulk copies. At R = 1
// (mode B, M = 51 x 51 at 50 x 50 images) an image of M D floats may start
// 4, 8 or 12 bytes past a 16-byte boundary and its last chunk may end
// between two. K3 and K4 take that case as instantiations of their own
// (RAGGED, launched at R = 1), so that mode C's code is as it was: a CTA
// keeps its cells in shared memory at the same offset modulo 16 as in
// device memory (Chunk::off), and copy_edges and store_cells move the at
// most 3 floats on either side of a piece's aligned body with plain loads
// and stores.
struct PostArgs {
  const float* heads;   // (B, M, R, D)
  const float* p_r;     // (R,)
  const float* offs;    // (R,)
  const float* p_tr;    // (M, R)
  const float* grid;    // (M, 2)
  const float* g;       // K4: (B, 2 zd + 5)
  float* out;           // K3: (B, 2 zd + 5); K4: (B, M, R, D)
  int R, log2r, M, zd, chunk, sub;
  float sig_r;
  uint32_t seed;
};

// This CTA's share of its image's cells.
struct Chunk {
  int b, rank, c0, n, nsub;
  int off;              // floats from a 16-byte boundary to src
  const float* src;     // the heads of cell c0
  uint32_t key;
};

__device__ __forceinline__ Chunk make_chunk(const PostArgs& p,
                                            const cg::cluster_group& cl) {
  const int C = p.R * p.M, D = 3 + 2 * p.zd;
  Chunk k;
  k.rank = (int)cl.block_rank();
  k.b = blockIdx.x / cl.num_blocks();
  k.c0 = k.rank * p.chunk;
  k.n = max(0, min(C, k.c0 + p.chunk) - k.c0);
  k.nsub = (k.n + p.sub - 1) / p.sub;
  k.src = p.heads + ((size_t)k.b * C + k.c0) * D;
  k.off = (int)(((uintptr_t)k.src & 15u) >> 2);
  k.key = p.seed + (uint32_t)k.b;
  return k;
}

// The rotation prior and offsets into shared memory, the mbarriers ready.
__device__ __forceinline__ void setup(const PostArgs& p, float* prs,
                                      float* ofs, uint64_t* bar) {
  if ((int)threadIdx.x < p.R) {
    prs[threadIdx.x] = p.p_r[threadIdx.x];
    ofs[threadIdx.x] = p.offs[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < NPIECE; ++j) mbar_init(&bar[j], 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// The Gumbel noise of cell c (m-major, r-minor) of the image keyed `key`:
// counter r M + m.
__device__ __forceinline__ float cell_noise(const PostArgs& p, int c,
                                            uint32_t key) {
  return gumbel((uint32_t)((c & (p.R - 1)) * p.M + (c >> p.log2r)), key);
}

// The cells of each of a load's NPIECE pieces: a multiple of PT (and so
// of 4), so that each piece's cells fall evenly on the threads.
__device__ __forceinline__ int piece_cells(int n) {
  return ((n + NPIECE - 1) / NPIECE + PT - 1) / PT * PT;
}

// The floats [src, src + n) of device memory into shared memory at dst,
// dst and src alike modulo 16 bytes, in two parts: the at most 3 floats
// before the first 16-byte boundary and the at most 3 after the last one,
// which this thread copies here with plain loads and stores, and the
// aligned body between, whose floats it returns (a multiple of 4, starting
// at float `head`) for one bulk copy. The caller's arrival on the piece's
// mbarrier, after this, publishes the plain stores to the waiting threads
// (an arrival releases, a completed wait acquires).
struct Span {
  int head, body;
};
__device__ __forceinline__ Span copy_edges(float* dst, const float* src,
                                           int n) {
  const int head =
      min(n, (int)(((16u - ((uint32_t)(uintptr_t)src & 15u)) & 15u) >> 2));
  const int body = (n - head) & ~3;
  for (int i = 0; i < head; ++i) dst[i] = src[i];
  for (int i = head + body; i < n; ++i) dst[i] = src[i];
  return {head, body};
}

// Starts the copy of n cells (D floats each) from src into sm: NPIECE
// pieces, piece j (cells [j q, (j + 1) q), q = piece_cells(n)) one bulk
// copy (RAGGED: sm and src alike modulo 16 bytes, and the piece's edges)
// completing on bar[j] (an empty piece arrives at once).
template <bool RAGGED>
__device__ __forceinline__ void start_load(const float* src, float* sm, int n,
                                           int D, uint64_t* bar) {
  if (threadIdx.x == 0) {
    const int q = piece_cells(n);
    for (int j = 0; j < NPIECE; ++j) {
      const int lo = min(n, j * q), hi = min(n, lo + q);
      float* d = sm + (size_t)lo * D;
      const float* g = src + (size_t)lo * D;
      if constexpr (RAGGED) {
        const Span e = copy_edges(d, g, (hi - lo) * D);
        mbar_expect_tx(&bar[j], (uint32_t)e.body * 4u);
        if (e.body)
          bulk_load(d + e.head, g + e.head, (uint32_t)e.body * 4u, &bar[j]);
      } else {
        const uint32_t bytes = (uint32_t)(hi - lo) * D * 4u;
        if (bytes) {
          mbar_expect_tx(&bar[j], bytes);
          bulk_load(d, g, bytes, &bar[j]);
        } else {
          mbar_arrive(&bar[j]);
        }
      }
    }
  }
}

// start_load, then waits for all of it.
template <bool RAGGED>
__device__ __forceinline__ void load_all(const float* src, float* sm, int n,
                                         int D, uint64_t* bar, uint32_t* ph) {
  start_load<RAGGED>(src, sm, n, D, bar);
  for (int j = 0; j < NPIECE; ++j) mbar_wait(&bar[j], *ph);
  *ph ^= 1u;
}

// nf floats from sm to dst in coalesced 16-byte stores: dst 16-byte
// aligned and nf a multiple of 4, or (RAGGED) dst and sm alike modulo 16
// bytes and the at most 3 floats on either side of the aligned body in
// plain stores.
template <bool RAGGED>
__device__ __forceinline__ void store_cells(float* dst, const float* sm,
                                            int nf) {
  int head = 0, n4 = nf / 4;
  if constexpr (RAGGED) {
    head = min(nf, (int)(((16u - ((uint32_t)(uintptr_t)dst & 15u)) & 15u) >> 2));
    n4 = (nf - head) >> 2;
  }
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(sm + head);
  for (int i = threadIdx.x; i < n4; i += PT) d4[i] = s4[i];
  if constexpr (RAGGED) {
    const int t = threadIdx.x, tail = head + 4 * n4;
    if (t < head) dst[t] = sm[t];
    if (t < nf - tail) dst[tail + t] = sm[tail + t];
  }
}

// An online log-sum-exp: the largest logit m and the sum s of exp(x - m).
struct Lse {
  float m, s;
};

__device__ __forceinline__ void lse_add(Lse& l, float x) {
  if (x > l.m) {
    l.s = l.s * __expf(l.m - x) + 1.f;
    l.m = x;
  } else {
    l.s += __expf(x - l.m);
  }
}

// The warp's pairs merged: the largest m, then every lane's s rescaled to
// it and summed, by xor butterflies, so that every lane holds bitwise the
// same pair and a rerun gives the same bits.
__device__ __forceinline__ Lse warp_lse(Lse l) {
  float m = l.m;
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = l.m == -INFINITY ? 0.f : l.s * expf(l.m - m);
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return Lse{m, s};
}

// The CTA's pairs (q's and the sample's) from every thread's: each warp's,
// then warp 0 merges the warps'; valid in every thread on return. red
// holds >= PT / 8 floats.
__device__ void block_lse(Lse* lq, Lse* la, float* red) {
  const Lse q = warp_lse(*lq), a = warp_lse(*la);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[4 * w] = q.m;
    red[4 * w + 1] = q.s;
    red[4 * w + 2] = a.m;
    red[4 * w + 3] = a.s;
  }
  __syncthreads();
  if (w == 0) {
    const bool in = lane < PT / 32;
    const Lse bq = warp_lse(in ? Lse{red[4 * lane], red[4 * lane + 1]}
                               : Lse{-INFINITY, 0.f});
    const Lse ba = warp_lse(in ? Lse{red[4 * lane + 2], red[4 * lane + 3]}
                               : Lse{-INFINITY, 0.f});
    if (lane == 0) {
      red[0] = bq.m;
      red[1] = bq.s;
      red[2] = ba.m;
      red[3] = ba.s;
    }
  }
  __syncthreads();
  *lq = Lse{red[0], red[1]};
  *la = Lse{red[2], red[3]};
  __syncthreads();
}

// Loads the CTA's cells (each sub-chunk in turn, its pieces as they land),
// draws their noise into nz (only the last sub-chunk's stays), and returns
// the CTA's pairs of q's and the sample's logits.
template <bool DET, bool RAGGED>
__device__ void chunk_stats(const PostArgs& p, const Chunk& k, float* sm,
                            float* nz, const float* prs, uint64_t* bar,
                            uint32_t* ph, float* red, Lse* oq, Lse* oa) {
  const int D = 3 + 2 * p.zd;
  Lse lq{-INFINITY, 0.f}, la{-INFINITY, 0.f};
  for (int j = 0; j < k.nsub; ++j) {
    const int cj = j * p.sub, nj = min(p.sub, k.n - cj);
    if (j) __syncthreads();
    start_load<RAGGED>(k.src + (size_t)cj * D, sm, nj, D, bar);
    const int q = piece_cells(nj);
    for (int pc = 0; pc < NPIECE; ++pc) {
      mbar_wait(&bar[pc], *ph);
      const int hi = min(nj, (pc + 1) * q);
      for (int i = pc * q + threadIdx.x; i < hi; i += PT) {
        const int c = k.c0 + cj + i;
        const float x = sm[i * D] + prs[c & (p.R - 1)];
        lse_add(lq, x);
        if (!DET) {
          const float gn = cell_noise(p, c, k.key);
          nz[i] = gn;
          lse_add(la, x + gn);
        }
      }
    }
    *ph ^= 1u;
  }
  block_lse(&lq, &la, red);
  *oq = lq;
  *oa = la;
}

// The image's normalisers from every CTA's pairs: each CTA publishes its
// pairs, the cluster meets, and warp 0 of every CTA reads all ranks' at
// once and merges them as block_lse does, so that every CTA holds bitwise
// the same nrm = [m_q, s_q, m_a, s_a]. After it every CTA of the cluster has
// started, so that another's shared memory may be written.
__device__ void exchange_norms(const cg::cluster_group& cl, Lse q, Lse a,
                               float* xch, float* nrm) {
  if (threadIdx.x == 0) {
    xch[0] = q.m;
    xch[1] = q.s;
    xch[2] = a.m;
    xch[3] = a.s;
  }
  cl.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Lse rq{-INFINITY, 0.f}, ra{-INFINITY, 0.f};
    if (lane < (int)cl.num_blocks()) {
      const float* x = cl.map_shared_rank(xch, lane);
      rq = Lse{x[0], x[1]};
      ra = Lse{x[2], x[3]};
    }
    rq = warp_lse(rq);
    ra = warp_lse(ra);
    if (lane == 0) {
      nrm[0] = rq.m;
      nrm[1] = rq.s;
      nrm[2] = ra.m;
      nrm[3] = ra.s;
    }
  }
  __syncthreads();
}

// Sends v[0..n) (thread j holding v[j]) of this CTA, rank `rank`, into
// gather[rank n + j] of every CTA of the cluster, and meets the cluster; on
// return every CTA's gather holds every rank's values. Needs every CTA
// started (exchange_norms).
__device__ __forceinline__ void push_partials(const cg::cluster_group& cl,
                                              const float* v, int n, int rank,
                                              float* gather) {
  if ((int)threadIdx.x < n) {
    for (int r = 0; r < (int)cl.num_blocks(); ++r)
      cl.map_shared_rank(gather, r)[rank * n + threadIdx.x] = v[threadIdx.x];
  }
  cl.sync();
}

// tot[j] = the sum in rank order of the cs ranks' gather[r n + j], j < n.
__device__ __forceinline__ void sum_gathered(const float* gather, int cs,
                                             int n, float* tot) {
  if ((int)threadIdx.x < n) {
    float t = 0.f;
    for (int r = 0; r < cs; ++r) t += gather[r * n + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// K3's running sums over some cells (of a thread, a CTA, a cluster): q's
// largest logit mq and sq = sum e^(x - mq), P = sum e^(x - mq) (x - p_tr)
// and K = sum e^(x - mq) (KL_theta + sum_d KL_z); the sample's largest
// logit ma, sa = sum e^(x + g - ma) and f = sum e^(x + g - ma) [z_mu (ZD) |
// z_std (ZD) | theta_mu, theta_std, gx, gy] (deterministic: the sample is
// q, f takes q's weights, ma and sa stay unused).
template <int ZD>
struct Run {
  static constexpr int NF = 2 * ZD + 4;
  static constexpr int N = 6 + NF;   // floats, as run_store writes them
  float mq, sq, P, K, ma, sa, f[NF];
};

template <int ZD>
__device__ __forceinline__ Run<ZD> run_empty() {
  Run<ZD> u;
  u.mq = u.ma = -INFINITY;
  u.sq = u.P = u.K = u.sa = 0.f;
#pragma unroll
  for (int j = 0; j < Run<ZD>::NF; ++j) u.f[j] = 0.f;
  return u;
}

// Scales the sums under the sample's weights (DET: q's) to the largest
// logit m; then run_rescale_q moves q's. e^(old - m), 0 while empty.
template <int ZD, bool DET>
__device__ __forceinline__ void run_rescale_a(Run<ZD>& u, float m) {
  const float old = DET ? u.mq : u.ma;
  const float t = old == -INFINITY ? 0.f : expf(old - m);
  if (!DET) {
    u.sa *= t;
    u.ma = m;
  }
#pragma unroll
  for (int j = 0; j < Run<ZD>::NF; ++j) u.f[j] *= t;
}

template <int ZD>
__device__ __forceinline__ void run_rescale_q(Run<ZD>& u, float m) {
  const float t = u.mq == -INFINITY ? 0.f : expf(u.mq - m);
  u.sq *= t;
  u.P *= t;
  u.K *= t;
  u.mq = m;
}

// Rescales u to the logits mq and ma (both at least u's).
template <int ZD, bool DET>
__device__ __forceinline__ void run_rescale(Run<ZD>& u, float mq, float ma) {
  run_rescale_a<ZD, DET>(u, DET ? mq : ma);
  run_rescale_q(u, mq);
}

// u += v, both rescaled to the larger logits first.
template <int ZD, bool DET>
__device__ __forceinline__ void run_merge(Run<ZD>& u, Run<ZD> v) {
  const float mq = fmaxf(u.mq, v.mq), ma = fmaxf(u.ma, v.ma);
  if (mq == -INFINITY) return;
  run_rescale<ZD, DET>(u, mq, ma);
  run_rescale<ZD, DET>(v, mq, ma);
  u.sq += v.sq;
  u.P += v.P;
  u.K += v.K;
  u.sa += v.sa;
#pragma unroll
  for (int j = 0; j < Run<ZD>::NF; ++j) u.f[j] += v.f[j];
}

// The warp's runs merged: the largest logits by a max butterfly, every
// lane's sums rescaled to them and added by xor butterflies, so that every
// lane holds bitwise the same run.
template <int ZD, bool DET>
__device__ __forceinline__ Run<ZD> warp_run(Run<ZD> u) {
  float mq = u.mq, ma = u.ma;
  for (int o = 16; o; o >>= 1) {
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
  }
  run_rescale<ZD, DET>(u, mq, ma);
  for (int o = 16; o; o >>= 1) {
    u.sq += __shfl_xor_sync(0xffffffffu, u.sq, o);
    u.P += __shfl_xor_sync(0xffffffffu, u.P, o);
    u.K += __shfl_xor_sync(0xffffffffu, u.K, o);
    u.sa += __shfl_xor_sync(0xffffffffu, u.sa, o);
#pragma unroll
    for (int j = 0; j < Run<ZD>::NF; ++j)
      u.f[j] += __shfl_xor_sync(0xffffffffu, u.f[j], o);
  }
  return u;
}

template <int ZD>
__device__ __forceinline__ void run_store(const Run<ZD>& u, float* dst) {
  dst[0] = u.mq;
  dst[1] = u.sq;
  dst[2] = u.P;
  dst[3] = u.K;
  dst[4] = u.ma;
  dst[5] = u.sa;
#pragma unroll
  for (int j = 0; j < Run<ZD>::NF; ++j) dst[6 + j] = u.f[j];
}

template <int ZD>
__device__ __forceinline__ Run<ZD> run_load(const float* src) {
  Run<ZD> u;
  u.mq = src[0];
  u.sq = src[1];
  u.P = src[2];
  u.K = src[3];
  u.ma = src[4];
  u.sa = src[5];
#pragma unroll
  for (int j = 0; j < Run<ZD>::NF; ++j) u.f[j] = src[6 + j];
  return u;
}

constexpr int NST = 4;            // K3's ring: stages of PT cells, one a thread
constexpr int MAXRUN = 6 + 2 * MAXZD + 4;

// K3's ring stage s: PT cells of heads, then from float ptr_at their PT
// p_tr values; RAGGED, the heads from float k.off on (at their device
// offset modulo 16 bytes) and p_tr 4 floats later (16-byte aligned in
// device memory, as each chunk starts on a multiple of 4 cells).
template <bool RAGGED>
__host__ __device__ constexpr int ptr_at(int D) {
  return PT * D + (RAGGED ? 4 : 0);
}
template <bool RAGGED>
__host__ __device__ constexpr int stage_floats(int D) {
  return ptr_at<RAGGED>(D) + PT;
}

// Starts the copy of piece j (cells [j PT, min(n, (j + 1) PT)) of the
// CTA's chunk: heads and p_tr) into its ring stage, completing on
// full[j % NST].
template <bool RAGGED>
__device__ __forceinline__ void k3_fetch(const PostArgs& p, const Chunk& k,
                                         int j, float* ring, uint64_t* full,
                                         int D) {
  if (threadIdx.x != 0) return;
  const int lo = j * PT, nc = min(PT, k.n - lo);
  float* st = ring + (size_t)(j % NST) * stage_floats<RAGGED>(D);
  float* sp = st + ptr_at<RAGGED>(D);
  const float* gh = k.src + (size_t)lo * D;
  const float* gp = p.p_tr + k.c0 + lo;
  uint64_t* bar = &full[j % NST];
  if constexpr (RAGGED) {
    float* sh = st + k.off;
    const Span eh = copy_edges(sh, gh, nc * D), ep = copy_edges(sp, gp, nc);
    mbar_expect_tx(bar, (uint32_t)(eh.body + ep.body) * 4u);
    if (eh.body)
      bulk_load(sh + eh.head, gh + eh.head, (uint32_t)eh.body * 4u, bar);
    if (ep.body)
      bulk_load(sp + ep.head, gp + ep.head, (uint32_t)ep.body * 4u, bar);
  } else {
    const uint32_t hb = (uint32_t)nc * D * 4u, pb = (uint32_t)nc * 4u;
    mbar_expect_tx(bar, hb + pb);
    bulk_load(st, gh, hb, bar);
    bulk_load(sp, gp, pb, bar);
  }
}

// K3 (the design in this file's first comment): each thread keeps a Run
// over its cells, one a ring stage, as the CTA streams its chunk through
// the ring; the CTA's Run goes into rank 0's shared memory, and rank 0
// merges the ranks' in rank order and writes the image's 2 zd + 5 scalars.
template <int ZD, bool DET, bool RAGGED>
__global__ void __launch_bounds__(PT, 4) posterior_fwd_kernel(const PostArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[NST];
  __shared__ float red[PT / 32 * MAXRUN], gather[16 * MAXRUN], prs[MAXR],
      ofs[MAXR];
  constexpr int D = 3 + 2 * ZD, NR = Run<ZD>::N;
  const cg::cluster_group cl = cg::this_cluster();
  cluster_arrive_relaxed();   // this CTA has started
  const Chunk k = make_chunk(p, cl);
  const int npieces = (k.n + PT - 1) / PT;
  if ((int)threadIdx.x < p.R) {
    prs[threadIdx.x] = p.p_r[threadIdx.x];
    ofs[threadIdx.x] = p.offs[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  for (int j = 0; j < min(NST, npieces); ++j)
    k3_fetch<RAGGED>(p, k, j, smem, full, D);
  const float log_sig_r = logf(p.sig_r);
  const float inv2s2 = 1.f / (2.f * p.sig_r * p.sig_r);

  Run<ZD> u = run_empty<ZD>();
  for (int j = 0; j < npieces; ++j) {
    mbar_wait(&full[j % NST], (uint32_t)(j / NST) & 1u);
    const int i = threadIdx.x;
    if (j * PT + i < k.n) {
      const float* st = smem + (size_t)(j % NST) * stage_floats<RAGGED>(D);
      const float* h = st + (RAGGED ? k.off : 0) + i * D;
      const int c = k.c0 + j * PT + i, r = c & (p.R - 1), mm = c >> p.log2r;
      const float x = h[0] + prs[r];
      if (x > u.mq) {
        if (DET) run_rescale_a<ZD, true>(u, x);
        run_rescale_q(u, x);
      }
      const float w = __expf(x - u.mq);
      const bool live = !(w == 0.f);
      const float thm = h[1] + ofs[r];
      const float ths = __expf(h[2]) + EPS;
      float kl = kl_theta_f(thm, ths, ofs[r], log_sig_r, inv2s2, live);
      float zs[ZD];
#pragma unroll
      for (int d = 0; d < ZD; ++d) {
        zs[d] = __expf(h[3 + ZD + d]) + EPS;
        kl += kl_unit_f(h[3 + d], zs[d], live);
      }
      u.sq += w;
      u.P += w * (x - st[ptr_at<RAGGED>(D) + i]);
      u.K += w * kl;
      float wa = w;
      if (!DET) {
        const float xa = x + cell_noise(p, c, k.key);
        if (xa > u.ma) run_rescale_a<ZD, false>(u, xa);
        wa = __expf(xa - u.ma);
        u.sa += wa;
      }
#pragma unroll
      for (int d = 0; d < ZD; ++d) {
        u.f[d] += wa * h[3 + d];
        u.f[ZD + d] += wa * zs[d];
      }
      u.f[2 * ZD + 0] += wa * thm;
      u.f[2 * ZD + 1] += wa * ths;
      u.f[2 * ZD + 2] += wa * __ldg(p.grid + 2 * mm);
      u.f[2 * ZD + 3] += wa * __ldg(p.grid + 2 * mm + 1);
    }
    __syncthreads();   // every thread is done with the stage
    if (j + NST < npieces) k3_fetch<RAGGED>(p, k, j + NST, smem, full, D);
  }

  // the CTA's run: the warps', then warp 0 merges them and, once every CTA
  // of the cluster has started, writes it into rank 0's shared memory
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Run<ZD> t = warp_run<ZD, DET>(u);
  if (lane == 0) run_store(t, red + w * NR);
  __syncthreads();
  if (w == 0) {
    t = warp_run<ZD, DET>(lane < PT / 32 ? run_load<ZD>(red + lane * NR)
                                         : run_empty<ZD>());
    cluster_wait();
    if (lane == 0) run_store(t, cl.map_shared_rank(gather, 0) + k.rank * NR);
  } else {
    cluster_wait();
  }
  cl.sync();
  if (k.rank == 0 && threadIdx.x == 0) {
    Run<ZD> a = run_load<ZD>(gather);
    for (int r = 1; r < (int)cl.num_blocks(); ++r)
      run_merge<ZD, DET>(a, run_load<ZD>(gather + r * NR));
    const float inv_sa = 1.f / (DET ? a.sq : a.sa);
    float* o = p.out + (size_t)k.b * (2 * ZD + 5);
#pragma unroll
    for (int j = 0; j < 2 * ZD + 4; ++j) o[j] = a.f[j] * inv_sa;
    o[2 * ZD + 4] = (a.P / a.sq - (a.mq + logf(a.sq))) + a.K / a.sq;
  }
}

// K4: the backward of K3.
//
// Replaces the backward of targetvae_tpu/kernels/posterior.py::_call
// (_bwd_kernel / _bwd_one). It recomputes the forward of its image with the
// SAME noise: the Philox bits are regenerated from the seed the forward was
// given, so nothing but the inputs and the seed is kept between the two.
// With the packed cotangent
// g = [g_zmu (zd), g_zstd (zd), g_thmu, g_thstd, g_dx0, g_dx1, g_kl]:
//   d_a    = g_thmu th_mu + g_thstd th_std + g_dx . grid + sum_d g_z . z
//   d_q    = g_kl e^q (q - p_tr + 1 + KL_theta + sum_d KL_z)
//   dth, dz = g . a + g_kl e^q dKL/d(moment)  [the KL part where e^q > 0],
//            chained through exp for the log-std channels
//   dattn  = a (d_a - S1) + d_q - e^q S2,  S1 = sum d_a a, S2 = sum d_q
// written as the cotangent of the raw heads, (B, M, R, D) float32 in the
// heads' layout (p_r and the offsets are constants), which is the g K2
// and K12 take.
//
// What bounds it on the H100: memory. At the flagship shape it reads the
// 34 MB of heads and writes 34 MB (>= 0.020 ms).
//
// Design: one thread-block cluster an image, as K3, but each CTA holds its
// whole chunk in shared memory (8 CTAs of 1,524 cells, 42.7 KB, at the
// flagship), since every output needs the image's normalisers and dattn
// also the image's sums S1, S2. The chunk arrives once, in four bulk copies
// completing on mbarriers; the pass over each piece as it lands draws each
// cell's noise once into shared memory and takes the CTA's online maximum
// and sum of q's and the sample's logits. The CTAs exchange these pairs
// through distributed shared memory, each merging all ranks' in one fixed
// order, so all hold bitwise the same normalisers. One pass over shared
// memory computes each cell's a, e^q, d_a, d_q and its theta and z
// cotangents, writes the cotangents over the cell's inputs and a d_a + d_q
// in the logit's place, keeps a and e^q beside, and sums S1, S2; every CTA
// writes its two sums into every CTA's shared memory and each adds them
// in rank order; a last pass finishes dattn in shared memory, and the
// chunk leaves in coalesced 16-byte stores, each output byte written once.
// Two cluster barriers an image. A chunk past the shared memory allowed
// streams in sub-chunks, read twice, and finishes dattn in device memory.
// No atomics: a rerun gives bitwise the same gradients.
template <int ZD, bool DET, bool RAGGED>
__global__ void __launch_bounds__(PT, 4) posterior_bwd_kernel(const PostArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[NPIECE];
  __shared__ float red[PT / 32 * NACC];
  __shared__ float xch[4], nrm[4], xs[2], tot[2], prs[MAXR], ofs[MAXR];
  __shared__ float gs[2 * ZD + 5], gather[16 * 2];
  const cg::cluster_group cl = cg::this_cluster();
  const Chunk k = make_chunk(p, cl);
  constexpr int zd = ZD, D = 3 + 2 * ZD;
  const int C = p.R * p.M;
  constexpr int SLACK = RAGGED ? 4 : 0;        // room for k.off
  float* sm = smem + (RAGGED ? k.off : 0);     // the cells, as K3's stages
  float* aa = smem + (size_t)p.sub * D + SLACK;   // the noise, then a
  float* ee = aa + p.sub;                  // e^q
  if ((int)threadIdx.x < 2 * zd + 5)
    gs[threadIdx.x] = p.g[(size_t)k.b * (2 * zd + 5) + threadIdx.x];
  setup(p, prs, ofs, bar);
  uint32_t ph = 0;
  Lse lq, la;
  chunk_stats<DET, RAGGED>(p, k, sm, aa, prs, bar, &ph, red, &lq, &la);
  exchange_norms(cl, lq, la, xch, nrm);
  const float m = nrm[0], ma = nrm[2];
  const float inv_s = 1.f / nrm[1], inv_sa = 1.f / nrm[3];
  const float log_s = logf(nrm[1]);
  const float log_sig_r = logf(p.sig_r);
  const float inv_s2 = 1.f / (p.sig_r * p.sig_r);
  const float inv2s2 = 0.5f * inv_s2;
  const float g_thmu = gs[2 * zd], g_thstd = gs[2 * zd + 1];
  const float g_dx0 = gs[2 * zd + 2], g_dx1 = gs[2 * zd + 3];
  const float g_kl = gs[2 * zd + 4];
  float* dst = p.out + ((size_t)k.b * C + k.c0) * D;

  // per cell: the theta and z cotangents over the inputs, a d_a + d_q in
  // the logit's place, a and e^q beside; sum d_a a, sum d_q
  float v[NACC] = {};
  for (int j = 0; j < k.nsub; ++j) {
    const int cj = j * p.sub, nj = min(p.sub, k.n - cj);
    if (k.nsub > 1) {
      __syncthreads();
      load_all<RAGGED>(k.src + (size_t)cj * D, sm, nj, D, bar, &ph);
    }
    for (int i = threadIdx.x; i < nj; i += PT) {
      const int c = k.c0 + cj + i, r = c & (p.R - 1), mm = c >> p.log2r;
      float* h = sm + i * D;
      const float x = h[0] + prs[r];
      const float sh = x - m;
      const float eq = __expf(sh) * inv_s;
      const float q = sh - log_s;
      float a = eq;
      if (!DET)
        a = __expf(x + (k.nsub > 1 ? cell_noise(p, c, k.key) : aa[i]) - ma) *
            inv_sa;
      const bool live = !(eq == 0.f);
      const float scale = g_kl * eq;
      const float off = ofs[r];
      const float thm = h[1] + off;
      const float ths = __expf(h[2]) + EPS;
      float d_a = g_thmu * thm + g_thstd * ths +
                  (g_dx0 * __ldg(p.grid + 2 * mm) +
                   g_dx1 * __ldg(p.grid + 2 * mm + 1));
      const float kl_th = kl_theta_f(thm, ths, off, log_sig_r, inv2s2, live);
      float kl_z = 0.f;
#pragma unroll
      for (int d = 0; d < zd; ++d) {
        const float zmv = h[3 + d];
        const float zs = __expf(h[3 + zd + d]) + EPS;
        const float gm = gs[d], gsd = gs[zd + d];
        d_a += gm * zmv + gsd * zs;
        kl_z += kl_unit_f(zmv, zs, live);
        z_grads_f(gm, gsd, a, scale, live, zmv, zs, h + 3 + d, h + 3 + zd + d);
      }
      const float d_q =
          g_kl * eq * ((q - __ldg(p.p_tr + c)) + 1.f + (kl_th + kl_z));
      theta_grads_f(g_thmu, g_thstd, a, scale, live, thm, ths, off, inv_s2,
                    h + 1, h + 2);
      v[0] += d_a * a;
      v[1] += d_q;
      h[0] = a * d_a + d_q;
      aa[i] = a;
      ee[i] = eq;
    }
    if (k.nsub > 1) {
      __syncthreads();
      store_cells<RAGGED>(dst + (size_t)cj * D, sm, nj * D);
    }
  }
  block_sum<PT>(v, 2, red, xs);
  push_partials(cl, xs, 2, k.rank, gather);
  sum_gathered(gather, (int)cl.num_blocks(), 2, tot);
  const float s_da = tot[0], s_dq = tot[1];

  // the two softmax VJPs' normalising terms
  if (k.nsub == 1) {
    for (int i = threadIdx.x; i < k.n; i += PT)
      sm[i * D] = sm[i * D] - aa[i] * s_da - ee[i] * s_dq;
    __syncthreads();
    store_cells<RAGGED>(dst, sm, k.n * D);
  } else {
    for (int i = threadIdx.x; i < k.n; i += PT) {
      const int c = k.c0 + i;
      const float x = __ldg(k.src + (size_t)i * D) + prs[c & (p.R - 1)];
      const float eq = __expf(x - m) * inv_s;
      const float a =
          DET ? eq : __expf(x + cell_noise(p, c, k.key) - ma) * inv_sa;
      dst[(size_t)i * D] = dst[(size_t)i * D] - a * s_da - eq * s_dq;
    }
  }
}

// ---- K5 / K6 ----
//
// K5: one cell shard's posterior partials under global normalisers.
//
// Replaces targetvae_tpu/kernels/posterior.py::posterior_shard_partials'
// forward (_sp_fwd_kernel, the pallas_call at :466), the per-rank kernel of
// the grid-sharded (sequence-parallel) posterior. It reads the planes the
// SP step's batch-to-cell exchange leaves, (B, 3 + 2 zd, C) float32 with
// strides of its own: [attn, theta_mu, theta_logstd, z_mu (zd), z_logstd
// (zd)] over the C cells of this rank's shard, the log-prior already added
// to attn and the offsets to theta_mu; the noise (B, C); the per-cell
// constants p (globally log-softmaxed log-prior), gx, gy (the attention
// grid) and offs (C,); norms = [gmax_q, g_logsum_q, gmax_a, g_logsum_a]
// (B, 4) computed across ranks by the caller. For each image:
//   q = attn - gmax_q - g_logsum_q;  e^q;  a = exp(attn + noise - gmax_a - g_logsum_a)
// and the 2*zd + 5 partial sums [sum a z_mu (zd), sum a z_std (zd),
// sum a th_mu, sum a th_std, sum a gx, sum a gy,
// sum e^q (q - p) + sum e^q (KL_theta + sum_d KL_z)], which the caller
// all-reduces. A -1e30 pad has a = e^q = 0 and adds exactly 0.
//
// What bounds it on the H100: memory. At the flagship's two-rank shard
// (B = 100, C = 6,144, zd = 2) it reads 8 planes of 2.5 MB once (~20 MB:
// >= 0.006 ms); the arithmetic is ~100 flops a cell on the SFU's exp and
// log.
//
// Design: one thread-block cluster an image, sized from the shard's shape
// alone (kernels/posterior.py::shard_schedule: 4 CTAs of 1,536 cells at the
// flagship, 400 CTAs of 128 threads, ~3 a SM), so that a row never depends
// on the batch. Each thread takes 4 neighbouring cells a step with 16-byte
// loads of every plane and constant (12 of them in flight a thread at zd =
// 2), in one pass: the normalisers arrive precomputed, so there are no
// running maxima. The sums merge in a fixed order: xor butterflies in each
// warp, the warps' in order, then every CTA writes its sums into rank 0's
// shared memory and rank 0 adds the ranks' in rank order and writes the
// image's row. No atomics: a rerun is bitwise equal. Templates on z for
// zd <= 8 keep the sums in registers; past that (ZD = 0) the z planes go one
// at a time, each with its CTA sum, the logits re-read from L1/L2. Rows
// whose planes are not 16-byte aligned take scalar loads (VEC false); any C.
//
// K6: phase 1 of K5's VJP.
//
// Replaces posterior_shard_partials' backward (_sp_bwd_kernel, the
// pallas_call at :477). With the TOTAL packed cotangent g (the caller
// all-reduces it first) = [g_zmu (zd), g_zstd (zd), g_thmu, g_thstd, g_dx0,
// g_dx1, g_kl], for each cell of the shard:
//   d_a = g_thmu th_mu + g_thstd th_std + g_dx0 gx + g_dx1 gy + sum_d g_z . z
//   d_q = g_kl e^q (q - p + 1 + KL_theta + sum_d KL_z)
//   dth, dz as K4 (theta_grads_f, z_grads_f)
// and per image spart = [sum d_a a, sum d_q], the softmax VJPs' local sums.
// It writes the theta and z cotangents straight into planes 1 .. 2 + 2 zd
// of the planes' cotangent (B, 3 + 2 zd, C), and d_a, d_q into a (B, 2, C)
// scratch; the caller all-reduces spart and finishes plane 0, d_attn =
// a (d_a - S1) + d_q - e^q S2, elementwise. A -1e30 pad gets exactly zero
// d_q, dth, dz (and so a zero d_attn).
//
// What bounds it on the H100: memory. At the flagship's two-rank shard it
// reads 8 planes and writes 8 (~39 MB: >= 0.012 ms).
//
// Design: K5's grid, loads and fixed-order sums; each thread writes its 4
// cells' cotangents with 16-byte stores. No atomics: a rerun gives
// bitwise the same gradients.

constexpr int SPT = 128;          // a K5/K6 CTA
constexpr int SPW = SPT / 32;
constexpr int SP_ZD = 8;          // the largest templated zd (ZD = 0: any)

struct ShardArgs {
  const float* norms;   // (B, 4)
  const float* planes;  // (B, 3 + 2 zd, C), strides row, plane
  const float* noise;   // (B, C), row stride nrow
  const float* p;       // (C,) each: log-prior, grid x, grid y, offsets
  const float* gx;
  const float* gy;
  const float* offs;
  const float* g;       // K6: (B, 2 zd + 5)
  float* out;           // K5: (B, 2 zd + 5); K6: spart (B, 2)
  float* gplanes;       // K6: the planes' cotangent, strides grow, gplane
  float* dadq;          // K6: (B, 2, C)
  int row, plane, nrow, grow, gplane, C, zd, chunk;
  float sig_r;
};

// Cells i .. i + 3 of a row v: one 16-byte load when VEC (v 16-byte
// aligned, i % 4 == 0 and i + 3 < n), else scalar loads, 0 past n.
template <bool VEC>
__device__ __forceinline__ float4 ld4(const float* v, int i, int n) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(v + i));
  float4 r;
  r.x = i < n ? __ldg(v + i) : 0.f;
  r.y = i + 1 < n ? __ldg(v + i + 1) : 0.f;
  r.z = i + 2 < n ? __ldg(v + i + 2) : 0.f;
  r.w = i + 3 < n ? __ldg(v + i + 3) : 0.f;
  return r;
}

// x[0..4) into cells i .. i + 3 of a row v (ld4's rules).
template <bool VEC>
__device__ __forceinline__ void st4(float* v, int i, int n,
                                    const float (&x)[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(v + i) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (i + l < n) v[i + l] = x[l];
}

__device__ __forceinline__ float at4(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

// v[0..N) of every thread summed over the CTA, into out[j step]: xor
// butterflies in each warp, then the warps' added in order by thread j.
// red holds SPW * N floats; out is valid in every thread on return.
template <int N>
__device__ __forceinline__ void cta_sums(const float (&v)[N], float* red,
                                         float* out, int step) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x = v[j];
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[w * N + j] = x;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += SPT) {
    float t = 0.f;
    for (int k = 0; k < SPW; ++k) t += red[k * N + j];
    out[j * step] = t;
  }
  __syncthreads();
}

// The CTA's n sums tot[0..n) into rank 0's gather[rank n ..], once every
// CTA of the cluster has started (each arrived at its start); then the
// cluster meets, after which rank 0's gather holds every rank's.
__device__ __forceinline__ void push_to_rank0(const cg::cluster_group& cl,
                                              const float* tot, int n,
                                              float* gather) {
  const int rank = (int)cl.block_rank();
  cluster_wait();
  float* dst = cl.map_shared_rank(gather, 0) + rank * n;
  for (int j = threadIdx.x; j < n; j += SPT) dst[j] = tot[j];
  cl.sync();
}

// gather[r n + j] summed over the cs ranks in rank order.
__device__ __forceinline__ float rank_sum(const float* gather, int cs, int n,
                                          int j) {
  float t = 0.f;
  for (int r = 0; r < cs; ++r) t += gather[r * n + j];
  return t;
}

// This CTA's image and cells [c0, c1) of the shard.
struct ShardChunk {
  int b, rank, cs, c0, c1;
};

__device__ __forceinline__ ShardChunk shard_chunk(const ShardArgs& p,
                                                  const cg::cluster_group& cl) {
  ShardChunk k;
  k.cs = (int)cl.num_blocks();
  k.rank = (int)cl.block_rank();
  k.b = blockIdx.x / k.cs;
  k.c0 = k.rank * p.chunk;
  k.c1 = min(p.C, k.c0 + p.chunk);
  return k;
}

// K5 (the design at the head of this section). v: [z_mu (ZD) | z_std (ZD)
// | th_mu, th_std, gx, gy, e^q (q - p), e^q KL]; with ZD = 0 the z sums go
// plane by plane after the first pass.
template <int ZD, bool VEC>
__global__ void __launch_bounds__(SPT) posterior_shard_fwd_kernel(
    const ShardArgs p) {
  extern __shared__ __align__(16) float sdyn[];   // the CTA's sums, then rank 0's gather
  __shared__ float red[SPW * (2 * SP_ZD + 6)];
  constexpr int NV = 2 * ZD + 6;
  const cg::cluster_group cl = cg::this_cluster();
  cluster_arrive_relaxed();   // this CTA has started
  const ShardChunk k = shard_chunk(p, cl);
  const int zd = ZD ? ZD : p.zd, nv = 2 * zd + 6;
  float* tot = sdyn;
  float* gather = sdyn + nv;
  const float* at = p.planes + (size_t)k.b * p.row;
  const float* zp = at + 3 * (size_t)p.plane;
  const float* nz = p.noise + (size_t)k.b * p.nrow;
  const float nq = p.norms[4 * k.b] + p.norms[4 * k.b + 1];
  const float na = p.norms[4 * k.b + 2] + p.norms[4 * k.b + 3];
  const float log_sig_r = logf(p.sig_r);
  const float inv2s2 = 1.f / (2.f * p.sig_r * p.sig_r);
  const int n = k.c1;

  float v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = 0.f;
  for (int i = k.c0 + 4 * (int)threadIdx.x; i < n; i += 4 * SPT) {
    const float4 x4 = ld4<VEC>(at, i, n), n4 = ld4<VEC>(nz, i, n);
    const float4 m4 = ld4<VEC>(at + p.plane, i, n);
    const float4 s4 = ld4<VEC>(at + 2 * (size_t)p.plane, i, n);
    const float4 p4 = ld4<VEC>(p.p, i, n), x4g = ld4<VEC>(p.gx, i, n);
    const float4 y4g = ld4<VEC>(p.gy, i, n), o4 = ld4<VEC>(p.offs, i, n);
    float a[4], eq[4], kl[4];
    bool live[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      a[l] = eq[l] = kl[l] = 0.f;
      live[l] = false;
      if (!VEC && i + l >= n) continue;
      const float x = at4(x4, l), q = x - nq;
      eq[l] = __expf(q);
      a[l] = __expf(x + at4(n4, l) - na);
      live[l] = !(eq[l] == 0.f);
      const float thm = at4(m4, l), ths = __expf(at4(s4, l)) + EPS;
      v[2 * ZD] += a[l] * thm;
      v[2 * ZD + 1] += a[l] * ths;
      v[2 * ZD + 2] += a[l] * at4(x4g, l);
      v[2 * ZD + 3] += a[l] * at4(y4g, l);
      v[2 * ZD + 4] += eq[l] * (q - at4(p4, l));
      kl[l] = kl_theta_f(thm, ths, at4(o4, l), log_sig_r, inv2s2, live[l]);
    }
#pragma unroll
    for (int d = 0; d < ZD; ++d) {
      const float4 zm4 = ld4<VEC>(zp + d * (size_t)p.plane, i, n);
      const float4 zl4 = ld4<VEC>(zp + (ZD + d) * (size_t)p.plane, i, n);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float zm = at4(zm4, l), zs = __expf(at4(zl4, l)) + EPS;
        v[d] += a[l] * zm;
        v[ZD + d] += a[l] * zs;
        kl[l] += kl_unit_f(zm, zs, live[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) v[2 * ZD + 5] += eq[l] * kl[l];
  }
  if (ZD) {
    cta_sums<NV>(v, red, tot, 1);
  } else {
    // each z plane in turn: its two sums over the CTA, e^q KL_z in v[5]
    for (int d = 0; d < zd; ++d) {
      const float* zm_r = zp + d * (size_t)p.plane;
      const float* zl_r = zp + (zd + d) * (size_t)p.plane;
      float w[2] = {0.f, 0.f};
      for (int i = k.c0 + 4 * (int)threadIdx.x; i < n; i += 4 * SPT) {
        const float4 x4 = ld4<VEC>(at, i, n), n4 = ld4<VEC>(nz, i, n);
        const float4 zm4 = ld4<VEC>(zm_r, i, n), zl4 = ld4<VEC>(zl_r, i, n);
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (!VEC && i + l >= n) continue;
          const float x = at4(x4, l), eq = __expf(x - nq);
          const float a = __expf(x + at4(n4, l) - na);
          const float zm = at4(zm4, l), zs = __expf(at4(zl4, l)) + EPS;
          w[0] += a * zm;
          w[1] += a * zs;
          v[5] += eq * kl_unit_f(zm, zs, !(eq == 0.f));
        }
      }
      cta_sums<2>(w, red, tot + d, zd);
    }
    cta_sums<NV>(v, red, tot + 2 * zd, 1);
  }

  push_to_rank0(cl, tot, nv, gather);
  if (k.rank == 0) {
    float* o = p.out + (size_t)k.b * (2 * zd + 5);
    for (int j = threadIdx.x; j < 2 * zd + 5; j += SPT)
      o[j] = j < 2 * zd + 4 ? rank_sum(gather, k.cs, nv, j)
                            : rank_sum(gather, k.cs, nv, j) +
                                  rank_sum(gather, k.cs, nv, j + 1);
  }
}

// K6 (the design at the head of this section).
template <int ZD, bool VEC>
__global__ void __launch_bounds__(SPT) posterior_shard_bwd_kernel(
    const ShardArgs p) {
  extern __shared__ __align__(16) float sdyn[];   // the image's g, then rank 0's gather
  __shared__ float red[SPW * 2], tot[2];
  const cg::cluster_group cl = cg::this_cluster();
  cluster_arrive_relaxed();   // this CTA has started
  const ShardChunk k = shard_chunk(p, cl);
  const int zd = ZD ? ZD : p.zd, ng = 2 * zd + 5;
  float* gs = sdyn;
  float* gather = sdyn + ng;
  for (int j = threadIdx.x; j < ng; j += SPT)
    gs[j] = p.g[(size_t)k.b * ng + j];
  __syncthreads();
  const float* at = p.planes + (size_t)k.b * p.row;
  const float* zp = at + 3 * (size_t)p.plane;
  const float* nz = p.noise + (size_t)k.b * p.nrow;
  float* gp = p.gplanes + (size_t)k.b * p.grow;
  float* da = p.dadq + (size_t)k.b * 2 * p.C;
  float* dq = da + p.C;
  const float nq = p.norms[4 * k.b] + p.norms[4 * k.b + 1];
  const float na = p.norms[4 * k.b + 2] + p.norms[4 * k.b + 3];
  const float log_sig_r = logf(p.sig_r);
  const float inv_s2 = 1.f / (p.sig_r * p.sig_r), inv2s2 = 0.5f * inv_s2;
  const float g_thmu = gs[2 * zd], g_thstd = gs[2 * zd + 1];
  const float g_dx0 = gs[2 * zd + 2], g_dx1 = gs[2 * zd + 3];
  const float g_kl = gs[2 * zd + 4];
  const int n = k.c1;

  float v[2] = {0.f, 0.f};
  for (int i = k.c0 + 4 * (int)threadIdx.x; i < n; i += 4 * SPT) {
    const float4 x4 = ld4<VEC>(at, i, n), n4 = ld4<VEC>(nz, i, n);
    const float4 m4 = ld4<VEC>(at + p.plane, i, n);
    const float4 s4 = ld4<VEC>(at + 2 * (size_t)p.plane, i, n);
    const float4 p4 = ld4<VEC>(p.p, i, n), x4g = ld4<VEC>(p.gx, i, n);
    const float4 y4g = ld4<VEC>(p.gy, i, n), o4 = ld4<VEC>(p.offs, i, n);
    float a[4], eq[4], sc[4], kl[4], qp[4], d_a[4], o1[4], o2[4];
    bool live[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float x = at4(x4, l), q = x - nq;
      eq[l] = __expf(q);
      a[l] = __expf(x + at4(n4, l) - na);
      live[l] = !(eq[l] == 0.f);
      sc[l] = g_kl * eq[l];
      qp[l] = q - at4(p4, l);
      const float thm = at4(m4, l), ths = __expf(at4(s4, l)) + EPS;
      const float off = at4(o4, l);
      d_a[l] = g_thmu * thm + g_thstd * ths +
               (g_dx0 * at4(x4g, l) + g_dx1 * at4(y4g, l));
      kl[l] = kl_theta_f(thm, ths, off, log_sig_r, inv2s2, live[l]);
      theta_grads_f(g_thmu, g_thstd, a[l], sc[l], live[l], thm, ths, off,
                    inv_s2, &o1[l], &o2[l]);
    }
    st4<VEC>(gp + p.gplane, i, n, o1);
    st4<VEC>(gp + 2 * (size_t)p.gplane, i, n, o2);
#pragma unroll(ZD ? ZD : 1)
    for (int d = 0; d < zd; ++d) {
      const float4 zm4 = ld4<VEC>(zp + d * (size_t)p.plane, i, n);
      const float4 zl4 = ld4<VEC>(zp + (zd + d) * (size_t)p.plane, i, n);
      const float gm = gs[d], gsd = gs[zd + d];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float zm = at4(zm4, l), zs = __expf(at4(zl4, l)) + EPS;
        d_a[l] += gm * zm + gsd * zs;
        kl[l] += kl_unit_f(zm, zs, live[l]);
        z_grads_f(gm, gsd, a[l], sc[l], live[l], zm, zs, &o1[l], &o2[l]);
      }
      st4<VEC>(gp + (3 + d) * (size_t)p.gplane, i, n, o1);
      st4<VEC>(gp + (3 + zd + d) * (size_t)p.gplane, i, n, o2);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      o1[l] = g_kl * eq[l] * (qp[l] + 1.f + kl[l]);   // d_q
      if (VEC || i + l < n) {
        v[0] += d_a[l] * a[l];
        v[1] += o1[l];
      }
    }
    st4<VEC>(da, i, n, d_a);
    st4<VEC>(dq, i, n, o1);
  }
  cta_sums<2>(v, red, tot, 1);
  push_to_rank0(cl, tot, 2, gather);
  if (k.rank == 0 && threadIdx.x < 2)
    p.out[2 * k.b + threadIdx.x] = rank_sum(gather, k.cs, 2, threadIdx.x);
}

// Launches a K3-K6 kernel as B clusters of cs CTAs of `threads` threads
// (cs > 8 with the non-portable cluster size) with `smem` bytes of dynamic
// shared memory.
template <typename Kernel, typename Args>
int launch_clusters(Kernel kernel, const Args& p, int B, int cs, int threads,
                    size_t smem, cudaStream_t stream) {
  int err;
  if (cs > 8 && (err = (int)cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return err;
  if ((err = allow_smem(kernel, smem))) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if ((err = (int)cudaLaunchKernelEx(&cfg, kernel, p))) return err;
  return (int)cudaGetLastError();
}

// K3/K4's arguments, checked: R a power of two up to MAXR (1 for mode B),
// 1 <= zd <= MAXZD, 1 <= cs <= 16 CTAs of `chunk` cells covering the
// image's R M cells, chunk and sub multiples of 4, the heads, p_tr and out
// 16-byte aligned (the bulk copies' units). Returns the CUDA error code of
// a refusal, else 0.
int post_args(PostArgs* p, const void* heads, const void* p_r,
              const void* offs, const void* p_tr, const void* grid,
              const void* g, void* out, int R, int M, int zd, float sig_r,
              int seed, int cs, int chunk, int sub) {
  if (R < 1 || R > MAXR || (R & (R - 1)) || zd < 1 || zd > MAXZD || M < 1 ||
      cs < 1 || cs > 16 || chunk < 4 || chunk % 4 || sub < 4 || sub % 4 ||
      (long)cs * chunk < (long)R * M || (uintptr_t)heads % 16 ||
      (uintptr_t)p_tr % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  p->heads = (const float*)heads;
  p->p_r = (const float*)p_r;
  p->offs = (const float*)offs;
  p->p_tr = (const float*)p_tr;
  p->grid = (const float*)grid;
  p->g = (const float*)g;
  p->out = (float*)out;
  p->R = R;
  p->log2r = __builtin_ctz((unsigned)R);
  p->M = M;
  p->zd = zd;
  p->chunk = chunk;
  p->sub = sub;
  p->sig_r = sig_r;
  p->seed = (uint32_t)seed;
  return 0;
}

// K5/K6's arguments, checked: zd >= 1, C >= 0, 1 <= cs <= 16 CTAs of
// `chunk` cells (a multiple of 4) covering the shard's C cells; with vec,
// every row 16-byte aligned (the pointers 16-byte aligned, C and the
// strides multiples of 4). Returns the CUDA error code of a refusal, else 0.
int shard_args(ShardArgs* a, const void* norms, const void* planes,
               const void* noise, const void* p, const void* gx,
               const void* gy, const void* offs, const void* g, void* out,
               void* gplanes, void* dadq, int C, int zd, int row, int plane,
               int nrow, int grow, int gplane, float sig_r, int cs,
               int chunk, int vec) {
  const void* rows[] = {planes, noise, p, gx, gy, offs, gplanes, dadq};
  bool aligned = C % 4 == 0 && row % 4 == 0 && plane % 4 == 0 &&
                 nrow % 4 == 0 && grow % 4 == 0 && gplane % 4 == 0;
  for (const void* r : rows) aligned = aligned && (uintptr_t)r % 16 == 0;
  if (zd < 1 || C < 0 || cs < 1 || cs > 16 || chunk < 4 || chunk % 4 ||
      (long)cs * chunk < (long)C || (vec && !aligned))
    return (int)cudaErrorInvalidValue;
  a->norms = (const float*)norms;
  a->planes = (const float*)planes;
  a->noise = (const float*)noise;
  a->p = (const float*)p;
  a->gx = (const float*)gx;
  a->gy = (const float*)gy;
  a->offs = (const float*)offs;
  a->g = (const float*)g;
  a->out = (float*)out;
  a->gplanes = (float*)gplanes;
  a->dadq = (float*)dadq;
  a->row = row;
  a->plane = plane;
  a->nrow = nrow;
  a->grow = grow;
  a->gplane = gplane;
  a->C = C;
  a->zd = zd;
  a->chunk = chunk;
  a->sig_r = sig_r;
  return 0;
}

}  // namespace

// K3: heads (B, M, R, D) f32, p_r, offs (R,), p_tr (M, R), grid (M, 2) ->
// out (B, 2*zd + 5); B clusters of `cluster` CTAs of `chunk` cells
// (kernels/posterior.py::k3_schedule).
extern "C" int tvae_posterior_fwd(const void* heads, const void* p_r,
                                  const void* offs, const void* p_tr,
                                  const void* grid, void* out, int B, int R,
                                  int M, int zd, float sig_r,
                                  int deterministic, int seed, int cluster,
                                  int chunk, void* stream) {
  PostArgs p;
  int err = post_args(&p, heads, p_r, offs, p_tr, grid, nullptr, out, R, M,
                      zd, sig_r, seed, cluster, chunk, chunk);
  if (err) return err;
  const bool ragged = R == 1;
  const int D = 3 + 2 * zd;
  const size_t smem = (size_t)NST * 4 *
      (ragged ? stage_floats<true>(D) : stage_floats<false>(D));
  const cudaStream_t s = (cudaStream_t)stream;
#define TVAE_K3_AT(ZD, DET)                                                  \
  (ragged ? launch_clusters(posterior_fwd_kernel<ZD, DET, true>, p, B,      \
                            cluster, PT, smem, s)                           \
          : launch_clusters(posterior_fwd_kernel<ZD, DET, false>, p, B,     \
                            cluster, PT, smem, s))
#define TVAE_K3(ZD)                                                          \
  case ZD:                                                                   \
    return deterministic ? TVAE_K3_AT(ZD, true) : TVAE_K3_AT(ZD, false);
  switch (zd) {
    TVAE_K3(1) TVAE_K3(2) TVAE_K3(3) TVAE_K3(4)
    TVAE_K3(5) TVAE_K3(6) TVAE_K3(7) TVAE_K3(8)
  }
#undef TVAE_K3
#undef TVAE_K3_AT
  return (int)cudaErrorInvalidValue;
}

// K4: K3's inputs and the packed cotangent g (B, 2*zd + 5) -> dheads
// (B, M, R, D), the cotangent of the raw heads; B clusters of `cluster` CTAs
// of `chunk` cells, at most `sub` of them in shared memory at a time
// (kernels/posterior.py::k4_schedule).
extern "C" int tvae_posterior_bwd(const void* heads, const void* p_r,
                                  const void* offs, const void* p_tr,
                                  const void* grid, const void* g,
                                  void* dheads, int B, int R, int M, int zd,
                                  float sig_r, int deterministic, int seed,
                                  int cluster, int chunk, int sub,
                                  void* stream) {
  PostArgs p;
  int err = post_args(&p, heads, p_r, offs, p_tr, grid, g, dheads, R, M, zd,
                      sig_r, seed, cluster, chunk, sub);
  if (err) return err;
  const bool ragged = R == 1;
  const size_t smem = ((size_t)sub * (3 + 2 * zd + 2) + (ragged ? 4 : 0)) * 4;
  const cudaStream_t s = (cudaStream_t)stream;
#define TVAE_K4_AT(ZD, DET)                                                  \
  (ragged ? launch_clusters(posterior_bwd_kernel<ZD, DET, true>, p, B,      \
                            cluster, PT, smem, s)                           \
          : launch_clusters(posterior_bwd_kernel<ZD, DET, false>, p, B,     \
                            cluster, PT, smem, s))
#define TVAE_K4(ZD)                                                          \
  case ZD:                                                                   \
    return deterministic ? TVAE_K4_AT(ZD, true) : TVAE_K4_AT(ZD, false);
  switch (zd) {
    TVAE_K4(1) TVAE_K4(2) TVAE_K4(3) TVAE_K4(4)
    TVAE_K4(5) TVAE_K4(6) TVAE_K4(7) TVAE_K4(8)
  }
#undef TVAE_K4
#undef TVAE_K4_AT
  return (int)cudaErrorInvalidValue;
}

// K5: the shard's (B, 2*zd + 5) partial sums from the planes (B, 3 + 2 zd,
// C) (strides row, plane), noise (B, C) (row stride nrow), the per-cell
// p, gx, gy, offs (C,) and norms (B, 4); B clusters of `cluster` CTAs of
// `chunk` cells (kernels/posterior.py::shard_schedule), 16-byte loads with
// vec.
extern "C" int tvae_posterior_shard_fwd(const void* norms, const void* planes,
                                        const void* noise, const void* p,
                                        const void* gx, const void* gy,
                                        const void* offs, void* out, int B,
                                        int C, int zd, int row, int plane,
                                        int nrow, float sig_r, int cluster,
                                        int chunk, int vec, void* stream) {
  ShardArgs a;
  int err = shard_args(&a, norms, planes, noise, p, gx, gy, offs, nullptr,
                       out, nullptr, nullptr, C, zd, row, plane, nrow, 0, 0,
                       sig_r, cluster, chunk, vec);
  if (err) return err;
  const size_t smem = (size_t)(2 * zd + 6) * (1 + cluster) * 4;
  const cudaStream_t s = (cudaStream_t)stream;
#define TVAE_K5(ZD)                                                          \
  case ZD:                                                                   \
    return vec ? launch_clusters(posterior_shard_fwd_kernel<ZD, true>, a, B, \
                                 cluster, SPT, smem, s)                      \
               : launch_clusters(posterior_shard_fwd_kernel<ZD, false>, a,   \
                                 B, cluster, SPT, smem, s);
  switch (zd <= SP_ZD ? zd : 0) {
    TVAE_K5(0) TVAE_K5(1) TVAE_K5(2) TVAE_K5(3) TVAE_K5(4)
    TVAE_K5(5) TVAE_K5(6) TVAE_K5(7) TVAE_K5(8)
  }
#undef TVAE_K5
  return (int)cudaErrorInvalidValue;
}

// K6: K5's inputs and the total cotangent g (B, 2*zd + 5) -> the theta and
// z cotangents into planes 1 .. 2 + 2 zd of gplanes (B, 3 + 2 zd, C)
// (strides grow, gplane; plane 0 is the caller's), d_a and d_q into dadq
// (B, 2, C), spart (B, 2); K5's grid.
extern "C" int tvae_posterior_shard_bwd(const void* norms, const void* planes,
                                        const void* noise, const void* p,
                                        const void* gx, const void* gy,
                                        const void* offs, const void* g,
                                        void* gplanes, void* dadq,
                                        void* spart, int B, int C, int zd,
                                        int row, int plane, int nrow,
                                        int grow, int gplane, float sig_r,
                                        int cluster, int chunk, int vec,
                                        void* stream) {
  ShardArgs a;
  int err = shard_args(&a, norms, planes, noise, p, gx, gy, offs, g, spart,
                       gplanes, dadq, C, zd, row, plane, nrow, grow, gplane,
                       sig_r, cluster, chunk, vec);
  if (err) return err;
  const size_t smem = (size_t)(2 * zd + 5 + 2 * cluster) * 4;
  const cudaStream_t s = (cudaStream_t)stream;
#define TVAE_K6(ZD)                                                          \
  case ZD:                                                                   \
    return vec ? launch_clusters(posterior_shard_bwd_kernel<ZD, true>, a, B, \
                                 cluster, SPT, smem, s)                      \
               : launch_clusters(posterior_shard_bwd_kernel<ZD, false>, a,   \
                                 B, cluster, SPT, smem, s);
  switch (zd <= SP_ZD ? zd : 0) {
    TVAE_K6(0) TVAE_K6(1) TVAE_K6(2) TVAE_K6(3) TVAE_K6(4)
    TVAE_K6(5) TVAE_K6(6) TVAE_K6(7) TVAE_K6(8)
  }
#undef TVAE_K6
  return (int)cudaErrorInvalidValue;
}
