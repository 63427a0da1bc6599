// Deterministic sum of per-block partials, the second pass of the backward
// kernels (K2 mix_heads_bwd, K8 pose_decoder_bwd).
//
// The TPU backward kernels accumulate their weight gradients across a
// sequential grid (pl.when(t == 0) init, then +=). CUDA blocks run in no
// order, so each block writes its own partial sums and this pass adds them
// up, one thread per output element, always in the same order: a rerun on
// the same inputs gives bitwise the same gradients, which f32 atomics would
// not. What bounds it: the bytes of the partials, read once (tens of MB at
// the flagship shape, a few microseconds at 3.35 TB/s).
#include "common.cuh"

namespace {

__global__ void sum_partials_kernel(const float* __restrict__ in,
                                    float* __restrict__ out, int S, int X) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= X) return;
  const int b = blockIdx.y;
  const float* p = in + (size_t)b * S * X + x;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += p[(size_t)i * X];
  out[(size_t)b * X + x] = s;
}

}  // namespace

int sum_partials(const float* in, float* out, int nb, int S, int X,
                 cudaStream_t stream) {
  const dim3 grid((X + 255) / 256, nb);
  sum_partials_kernel<<<grid, 256, 0, stream>>>(in, out, S, X);
  return (int)cudaGetLastError();
}
