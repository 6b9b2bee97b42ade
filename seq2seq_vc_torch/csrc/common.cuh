// Shared helpers for the port's hand-written Hopper kernels: the storage
// types (float or bfloat16; every kernel accumulates in float, so one
// template serves both the bf16 main path and the fp32 checks), their
// conversions, and the attention dropout hash.
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

// Attention dropout's keep test, shared by the flash forward kernels and
// their backward kernels so that all draw the same mask. A counter-based
// hash (the murmur3 finaliser) of the score element's index
//   idx = (bh * tq_pad + i) * tk_pad + j   (wrapping 32-bit arithmetic)
// where tq_pad = round_up(Tq, 128) and tk_pad = round_up(Tk, 128) are the
// JAX package's padded query and key lengths (equal for self-attention over
// one sequence), not tile sizes of these kernels: the bits equal those of
// `_mix_bits` and `_keep_from_bits` in seq2seq_vc_tpu/ops/flash_attention.py.
constexpr unsigned kMixMul = 0x9E3779B1u;
__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ unsigned mix_bits(unsigned idx, unsigned seed) {
  return fmix32(idx * kMixMul + seed);
}

// Whether element (bh, i, j) survives dropout at `rate`: the top 24 bits as
// a float in [0, 1) (exact), compared in float32 as the JAX kernels do.
__device__ __forceinline__ bool dropout_keep(unsigned seed, int bh, int i, int j, int tq_pad,
                                             int tk_pad, float rate) {
  const unsigned idx = ((unsigned)bh * (unsigned)tq_pad + (unsigned)i) * (unsigned)tk_pad +
                       (unsigned)j;
  return (float)(mix_bits(idx, seed) >> 8) * (1.0f / 16777216.0f) >= rate;
}

// The same test in integers, for a kernel that draws many bits: the top 24
// bits u pass where u * 2^-24 >= rate, exactly where u >= ceil(rate * 2^24)
// (both sides exact in float32), that is where the bits are at least
//   dropout_threshold(rate) = ceil(rate * 2^24) << 8   (rate < 1: no overflow)
// and mix_bits(idx, seed) = fmix32(idx * kMixMul + seed), whose argument a
// kernel may build from a per-row and a per-column part (wrapping 32-bit
// arithmetic distributes).
__device__ __forceinline__ unsigned dropout_threshold(float rate) {
  return (unsigned)ceilf(rate * 16777216.0f) << 8;
}

}  // namespace s2s
