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

// asynchronous 16-byte copies from device to shared memory
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Deterministic second pass of the backward kernels' cross-block sums
// (csrc/reduce.cu): out[b, x] = sum over s in order of in[b, s, x], for an
// (nb, S, X) float32 array. Launches on `stream`; returns the CUDA error.
int sum_partials(const float* in, float* out, int nb, int S, int X,
                 cudaStream_t stream);

// K2's chain pass and the in-order sum of its partials (csrc/mix_heads.cu),
// also the first pass of K12 (csrc/lifted_encoder.cu): with from_h1 = 0, src
// is the raw lift pre1, h1 = bf16(act(pre1 + bc)) and act' of the second
// layer comes from the bf16 h2 (K2's TPU kernel); with from_h1 = 1, src is
// h1 itself (bc unused) and act' comes from the f32 pre2 (K12's). G blocks
// of `chunk` (tile, rotation) items; other arguments as tvae_mix_heads_bwd's.
int mix_heads_bwd_run(const void* src, const void* bc, const void* w2,
                      const void* b2, const void* wh, const void* g,
                      void* dpre1, void* part, void* out, int N, int R, int K,
                      int D, int G, int chunk, int SP, int act, int from_h1,
                      cudaStream_t stream);

// Sets the dynamic shared memory a kernel may use and launches nothing;
// returns the CUDA error code.
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
