// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes plain C entry points (no PyTorch headers), so
// the whole csrc/ directory builds with one nvcc call in seconds and is
// bound from Python with ctypes (kmbart_tpu_torch/ops/_cuda.py). Each entry
// launches on the caller's stream, never synchronises, and returns
// cudaGetLastError() so a refused launch surfaces in the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KMB_EXPORT extern "C" __attribute__((visibility("default")))

// element-type codes shared with the Python wrappers (_cuda.DTYPE_CODES)
enum { KMB_F32 = 0, KMB_BF16 = 1 };

constexpr float KMB_NEG_INF = -1e9f;  // the JAX package's additive mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA and torch do
}

// value after a round trip through T (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float round_bf16(float x) { return round_to<__nv_bfloat16>(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it asks
// for it (Hopper allows up to 227 KB per block).
template <typename K>
static inline cudaError_t kmb_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
