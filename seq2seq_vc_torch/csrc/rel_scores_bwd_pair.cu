// Fused relative-position attention scores, backward: the diagonal-reduction
// pair (bwd="pallas"), dq_v and the table gradient in two launches.
//
// Replaces the TPU kernels of seq2seq_vc_tpu/ops/rel_scores.py launched by
// `_scores_core.core_bwd` with bwd="pallas":
//   - rel_scores_bwd_dqv  <- `_dqv_kernel`  (kernel 4)
//   - rel_scores_bwd_dpos <- `_dtab_kernel` (kernel 5)
// They compute what kernel 3 (csrc/rel_scores_bwd.cu) computes in one
// launch, split into its two outputs. With g the float32 cotangent of the
// (B, H, T, T) scores and scale = 1/sqrt(D):
//
//   dq_v[b,h,i] = scale * sum_j g[b,h,i,j] * pos[h, T-1-i+j]
//   dpos[h,r]   = scale * sum_b sum_i g[b,h,i, i+r-(T-1)] * q_v[b,h,i]
//
// - dq_v: a block owns BM = 64 query rows and one BC = 64 chunk of D, and
//   walks the key tiles of BN = 32 keys. For each tile it stages the g tile
//   (BM, BN) and the BM+BN-1 table rows the tile touches (row T-1-i+j of
//   cell (i, j) is window row BM-1-(i-i0)+(j-j0)), and each cell reads its
//   own window row by index arithmetic: acc(i, :) += g(i, j) pos(window row).
// - dpos: a block owns BM table rows of one head and one BC chunk of D, and
//   walks, for every batch item in order, the query rows whose diagonal
//   reaches them (`band::dpos_block`, the same tiles as kernel 3's dpos
//   half). Each table row's sum is one block's, in a fixed order:
//   deterministic, no atomics.
//
// The TPU kernels' reversed table, `_block_rel_unshift_flipped` and the
// (H, n_tab, B, n_q) grid with a resident accumulator were Mosaic
// workarounds and have no counterpart here.
//
// Bound: g (B*H*T*T float32) dominates the bytes of each launch (both read
// all of it); the work is B*H*T*T*D multiply-adds for each output. At the
// training step's shapes the tensor-core rate would leave both bound by the
// bytes of g; this first version multiplies on the CUDA cores in float FMA
// (4 x 4 register tiles), so it is bound by FMA issue and shared-memory
// reads. Tensor cores are later work.
#include <stdint.h>

#include "common.cuh"
#include "rel_band_tiles.cuh"

namespace {

using namespace s2s::band;
using s2s::from_f;
using s2s::to_f;

constexpr int BN = 32;            // keys per tile of the dq_v kernel
constexpr int WIN = BM + BN - 1;  // table rows a (BM, BN) tile touches
// row stride of the staged table window: neighbouring rows of one warp
// (ty, ty + 1 read window rows w, w - 1) fall 16 banks apart
constexpr int LDP = BC + 16;

template <typename T>
__global__ void __launch_bounds__(NT) rel_scores_bwd_dqv_kernel(const float* __restrict__ g,
                                                                const T* __restrict__ pos,
                                                                T* __restrict__ dqv, int H,
                                                                int L, int D, float scale) {
  __shared__ float s_g[BM][BN + 1];
  __shared__ float s_p[WIN][LDP];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_pos = 2 * L - 1;
  const int d0 = blockIdx.x * BC;
  const int i0 = blockIdx.y * BM;
  const size_t bh = blockIdx.z;
  const float* g_b = g + bh * L * L;
  const T* pos_h = pos + (size_t)(bh % H) * n_pos * D;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }

  for (int j0 = 0; j0 < L; j0 += BN) {
    const int r_lo = L - BM - i0 + j0;  // table row of window row 0
    for (int e = tid; e < BM * BN; e += NT) {
      const int m = e / BN, n = e % BN;
      const int i = i0 + m, j = j0 + n;
      s_g[m][n] = (i < L && j < L) ? g_b[(size_t)i * L + j] : 0.f;
    }
    for (int e = tid; e < WIN * BC; e += NT) {
      const int w = e / BC, c = e % BC;
      const int r = r_lo + w, d = d0 + c;
      s_p[w][c] = (r >= 0 && r < n_pos && d < D) ? to_f(pos_h[(size_t)r * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int il = ty + 16 * m;
        const float gv = s_g[il][n];
        const float* prow = s_p[n - il + BM - 1];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(gv, prow[tx + 16 * c], acc[m][c]);
      }
    }
    __syncthreads();
  }

  T* out = dqv + bh * L * D;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < D) out[(size_t)i * D + d] = from_f<T>(acc[m][c] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) rel_scores_bwd_dpos_kernel(const float* __restrict__ g,
                                                                 const T* __restrict__ qv,
                                                                 T* __restrict__ dpos, int B,
                                                                 int H, int L, int D,
                                                                 float scale) {
  __shared__ float s_a[BK][LDA];
  __shared__ float s_b[BK][BC];
  dpos_block(g, qv, dpos, B, H, L, D, scale, (int)blockIdx.x, s_a, s_b);
}

bool bad_shape(int B, int H, int L, int D) {
  return B <= 0 || H <= 0 || L <= 0 || D <= 0 || (long)B * H > 65535;
}

template <typename T>
cudaError_t launch_dqv(const float* g, const void* pos, void* dqv, int B, int H, int L, int D,
                       float scale, cudaStream_t stream) {
  const dim3 grid((D + BC - 1) / BC, (L + BM - 1) / BM, B * H);
  rel_scores_bwd_dqv_kernel<T><<<grid, NT, 0, stream>>>(
      g, static_cast<const T*>(pos), static_cast<T*>(dqv), H, L, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpos(const float* g, const void* qv, void* dpos, int B, int H, int L, int D,
                        float scale, cudaStream_t stream) {
  const long n = dpos_blocks(H, L, D);
  if (n > 0x7fffffffL) return cudaErrorInvalidValue;
  rel_scores_bwd_dpos_kernel<T><<<(unsigned)n, NT, 0, stream>>>(
      g, static_cast<const T*>(qv), static_cast<T*>(dpos), B, H, L, D, scale);
  return cudaGetLastError();
}

}  // namespace

// g: (B, H, L, L) fp32; q_v, dq_v: (B, H, L, D); pos, dpos: (H, 2L-1, D); all
// contiguous, q_v/pos/dq_v/dpos in the storage type `dtype`; scale =
// 1/sqrt(D). Each writes every element of its output and returns the
// launch's cudaError_t (0 = launched).
extern "C" int rel_scores_bwd_dqv(int dtype, const void* g, const void* qv, const void* pos,
                                  void* dqv, int B, int H, int L, int D, float scale,
                                  void* stream) {
  (void)qv;  // dq_v needs the table only; the argument list is the pair's
  if (bad_shape(B, H, L, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch_dqv<float>(gf, pos, dqv, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch_dqv<__nv_bfloat16>(gf, pos, dqv, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int rel_scores_bwd_dpos(int dtype, const void* g, const void* qv, const void* pos,
                                   void* dpos, int B, int H, int L, int D, float scale,
                                   void* stream) {
  (void)pos;  // the table gradient needs q_v only
  if (bad_shape(B, H, L, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch_dpos<float>(gf, qv, dpos, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch_dpos<__nv_bfloat16>(gf, qv, dpos, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
