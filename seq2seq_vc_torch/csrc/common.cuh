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

// Attention dropout's keep test, shared by the rel-pos flash forward and
// its three backward kernels so that all draw the same mask. A counter-based
// hash (the murmur3 finaliser) of the score element's index
//   idx = (bh * t_pad + i) * t_pad + j   (wrapping 32-bit arithmetic)
// where t_pad = round_up(T, 128) is the JAX package's padded length, not a
// tile size of these kernels: the bits equal those of `_mix_bits` and
// `_keep_from_bits` in seq2seq_vc_tpu/ops/flash_attention.py.
__device__ __forceinline__ unsigned mix_bits(unsigned idx, unsigned seed) {
  unsigned x = idx * 0x9E3779B1u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Whether element (bh, i, j) survives dropout at `rate`: the top 24 bits as
// a float in [0, 1) (exact), compared in float32 as the JAX kernels do.
__device__ __forceinline__ bool dropout_keep(unsigned seed, int bh, int i, int j, int t_pad,
                                             float rate) {
  const unsigned idx = ((unsigned)bh * (unsigned)t_pad + (unsigned)i) * (unsigned)t_pad +
                       (unsigned)j;
  return (float)(mix_bits(idx, seed) >> 8) * (1.0f / 16777216.0f) >= rate;
}

}  // namespace s2s
