// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel stages its tiles in shared memory as float and accumulates in
// float, whatever the storage type (float or bfloat16), so one template
// serves both the bf16 main path and the fp32 checks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace s2s {

// Storage-type codes passed over the C interface (the Python wrappers use
// the same numbers).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace s2s
