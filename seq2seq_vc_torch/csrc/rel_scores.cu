// Fused relative-position attention scores, forward (new-style rel-pos).
//
// Replaces the TPU kernel `_fwd_kernel` of seq2seq_vc_tpu/ops/rel_scores.py
// (launched by `_scores_core.fwd_impl`, entry `fused_rel_scores`).
//
//   scores[bh, i, j] = (q_u[i] . k[j] + q_v[i] . pos[h, T-1-i+j]) * scale
//
// pos is the head-split projected RelPositionalEncoding table, (H, 2T-1, D),
// row p <-> relative distance T-1-p. For one (BM query rows, BN key columns)
// tile the band entries it needs come from a window of BM+BN-1 consecutive
// pos rows starting at r0 = T - BM - i0 + j0; the kernel computes the
// (BM, BM+BN-1) product of q_v with that window, keeps it in shared memory,
// and skews it by index arithmetic: bd[i, j] = raw[i, j - i + BM - 1]. The
// (T, 2T-1) band never reaches device memory, and pos is read as it is: no
// zero-padded 3T table and no padding of D, as the TPU layout needed. Ragged
// T is masked here (rows out of range load as zero, stores are guarded).
//
// Bound: the output (B*H*T*T fp32) dominates the bytes; the operations are
// 2*T*T*D (ac) plus 2*T*T*D (bd) multiply-adds per head. At the main path's
// shapes (D = 192 or 768) the card's tensor-core rate would make it bound by
// the bytes it writes; this first version multiplies on the CUDA cores
// (float FMA, register tiles of 4 x 4 and 4 x 8 per thread), so it is bound
// by its FMA issue rate instead. The tensor-core version is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;             // query rows per block
constexpr int BN = 64;             // key columns per block
constexpr int DK = 32;             // depth of one D-chunk
constexpr int WIN = BM + BN;       // pos window rows staged (BM+BN-1 used)
constexpr int LDS = DK + 1;        // padded row stride: no bank conflicts
constexpr int NT = 256;            // threads: a 16 x 16 grid
constexpr int LDR = WIN + 1;       // row stride of the staged raw band

using s2s::to_f;

template <typename T>
__global__ void __launch_bounds__(NT) rel_scores_fwd_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
    const T* __restrict__ pos, float* __restrict__ out, int H, int L, int D,
    float scale) {
  // one buffer: the four D-chunk tiles during the product, then the raw band
  __shared__ float smem[(BM + BM + BN + WIN) * LDS];
  float* s_qu = smem;
  float* s_qv = s_qu + BM * LDS;
  float* s_k = s_qv + BM * LDS;
  float* s_p = s_k + BN * LDS;

  const int j0 = blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const int bh = blockIdx.z;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_pos = 2 * L - 1;
  const int r0 = L - BM - i0 + j0;  // first pos row of this tile's window

  const size_t base = (size_t)bh * L * D;
  const T* qu_b = qu + base;
  const T* qv_b = qv + base;
  const T* k_b = k + base;
  const T* pos_h = pos + (size_t)h * n_pos * D;

  float ac[4][4];
  float raw[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) ac[a][b] = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) raw[a][w] = 0.f;
  }

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = tid; e < BM * DK; e += NT) {
      const int r = e / DK, c = e % DK;
      const int i = i0 + r, d = d0 + c;
      const bool ok = i < L && d < D;
      s_qu[r * LDS + c] = ok ? to_f(qu_b[(size_t)i * D + d]) : 0.f;
      s_qv[r * LDS + c] = ok ? to_f(qv_b[(size_t)i * D + d]) : 0.f;
    }
    for (int e = tid; e < BN * DK; e += NT) {
      const int r = e / DK, c = e % DK;
      const int j = j0 + r, d = d0 + c;
      s_k[r * LDS + c] = (j < L && d < D) ? to_f(k_b[(size_t)j * D + d]) : 0.f;
    }
    for (int e = tid; e < WIN * DK; e += NT) {
      const int r = e / DK, c = e % DK;
      const int p = r0 + r, d = d0 + c;
      s_p[r * LDS + c] =
          (p >= 0 && p < n_pos && d < D) ? to_f(pos_h[(size_t)p * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < DK; ++c) {
      float a_u[4], a_v[4], b_k[4], b_p[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        a_u[a] = s_qu[(ty + 16 * a) * LDS + c];
        a_v[a] = s_qv[(ty + 16 * a) * LDS + c];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) b_k[b] = s_k[(tx + 16 * b) * LDS + c];
#pragma unroll
      for (int w = 0; w < 8; ++w) b_p[w] = s_p[(tx + 16 * w) * LDS + c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) ac[a][b] = fmaf(a_u[a], b_k[b], ac[a][b]);
#pragma unroll
        for (int w = 0; w < 8; ++w) raw[a][w] = fmaf(a_v[a], b_p[w], raw[a][w]);
      }
    }
    __syncthreads();
  }

  // skew: stage the (BM, WIN) band, then read it along the diagonals
  float* s_raw = smem;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s_raw[(ty + 16 * a) * LDR + tx + 16 * w] = raw[a][w];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int il = ty + 16 * a;
    const int i = i0 + il;
    if (i >= L) continue;
    float* out_row = out + ((size_t)bh * L + i) * L;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jl = tx + 16 * b;
      const int j = j0 + jl;
      if (j < L) out_row[j] = (ac[a][b] + s_raw[il * LDR + jl - il + BM - 1]) * scale;
    }
  }
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* pos,
                   float* out, int BH, int H, int L, int D, float scale,
                   cudaStream_t stream) {
  const dim3 grid((L + BN - 1) / BN, (L + BM - 1) / BM, BH);
  rel_scores_fwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(pos), out, H, L, D, scale);
  return cudaGetLastError();
}

}  // namespace

// q_u, q_v, k: (BH, L, D) contiguous; pos: (H, 2L-1, D); out: (BH, L, L) fp32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_scores_fwd(int dtype, const void* qu, const void* qv,
                              const void* k, const void* pos, void* out, int BH,
                              int H, int L, int D, float scale, void* stream) {
  if (BH <= 0 || H <= 0 || L <= 0 || D <= 0 || BH % H != 0 || BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(qu, qv, k, pos, o, BH, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(qu, qv, k, pos, o, BH, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
