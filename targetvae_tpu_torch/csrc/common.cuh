// Shared device helpers for the hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// activation codes: 0 = leaky ReLU (slope 0.01), 1 = tanh
static __device__ __forceinline__ float act_fn(float x, int act) {
  return act == 1 ? tanhf(x) : (x >= 0.f ? x : 0.01f * x);
}

// the activation's derivative recovered from its (bf16-rounded) value h:
// leaky ReLU keeps the sign of its input, tanh' = 1 - h^2
static __device__ __forceinline__ float dact_from_h(float h, int act) {
  return act == 1 ? 1.f - h * h : (h >= 0.f ? 1.f : 0.01f);
}

// round a float to the nearest bf16 value (ties to even), returned as float
static __device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Deterministic second pass of the backward kernels' cross-block sums
// (csrc/reduce.cu): out[b, x] = sum over s in order of in[b, s, x], for an
// (nb, S, X) float32 array. Launches on `stream`; returns the CUDA error.
int sum_partials(const float* in, float* out, int nb, int S, int X,
                 cudaStream_t stream);

// Sets the dynamic shared memory a kernel may use and launches nothing;
// returns the CUDA error code.
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
