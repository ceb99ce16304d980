// Shared helpers of the port's Hopper kernels.  Every entry point has a
// plain C signature (bound from Python with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// so the caller sees a refused launch at once.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CS_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float cs_to_float(float x) { return x; }
__device__ __forceinline__ float cs_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T cs_from_float(float x);
template <> __device__ __forceinline__ float cs_from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cs_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
