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
// - dq_v (CUDA-core FMA): a block owns BM = 64 query rows and one BC = 64
//   chunk of D, and walks the key tiles of BN = 32 keys. For each tile it
//   stages the g tile (BM, BN) and the BM+BN-1 table rows the tile touches
//   (row T-1-i+j of cell (i, j) is window row BM-1-(i-i0)+(j-j0)), and each
//   cell reads its own window row by index arithmetic: acc(i, :) += g(i, j)
//   pos(window row).
// - dpos (tensor cores): kernel 3's table-gradient half, `band::dpos_block`
//   of csrc/rel_band_tiles.cuh: a block owns 64 table rows of one head and a
//   D chunk of up to 192 columns, and walks, for the batch items of its
//   group in order, the query rows whose diagonal reaches them, acc += G^T .
//   q_v in mma.sync m16n8k16 (G as bf16 hi + lo planes); the groups of one
//   tile form a cluster that adds their float32 sums in rank order.
//   Deterministic, no atomics.
//
// The TPU kernels' reversed table, `_block_rel_unshift_flipped` and the
// (H, n_tab, B, n_q) grid with a resident accumulator were Mosaic
// workarounds and have no counterpart here.
//
// Bound: g (B*H*T*T float32) dominates the bytes of each launch (both read
// all of it); the work is B*H*T*T*D multiply-adds for each output. At the
// training step's shapes the tensor-core rate would leave both near the
// bytes of g. dq_v still multiplies on the CUDA cores in float FMA (4 x 4
// register tiles), bound by FMA issue and shared-memory reads; its tensor-
// core form is `band::dqv_block`'s, later work.
#include <stdint.h>

#include "rel_band_tiles.cuh"

namespace {

namespace band = s2s::band;
using s2s::from_f;
using s2s::to_f;

// the dq_v kernel's tiles
constexpr int BM = 64;            // query rows per block
constexpr int BC = 64;            // output columns per block: one chunk of D
constexpr int NT = 256;           // threads: a 16 x 16 grid, 4 x 4 outputs each
constexpr int BN = 32;            // keys per tile
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

template <typename T, int NTW>
__global__ void __launch_bounds__(band::NT, 1)
    rel_scores_bwd_dpos_kernel(band::Args<T> a, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  band::dpos_block<T, NTW>(a, (int)blockIdx.x, n_groups, smem);
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

template <typename T, int NTW>
cudaError_t launch_dpos_ntw(const band::Args<T>& a, cudaStream_t stream) {
  int n_sm = 0;
  const cudaError_t err = band::device_sms(&n_sm);
  if (err != cudaSuccess) return err;
  const long tiles = band::dpos_tiles<NTW>(a.H, a.L, a.D);
  const int n_groups = band::dpos_groups(a.B, tiles, n_sm);
  return band::launch_clusters(rel_scores_bwd_dpos_kernel<T, NTW>, n_groups * tiles, n_groups,
                               band::Tiles<T, NTW>::BYTES, stream, a, n_groups);
}

template <typename T>
cudaError_t launch_dpos(const float* g, const void* qv, void* dpos, int B, int H, int L, int D,
                        float scale, cudaStream_t stream) {
  const band::Args<T> a{g, static_cast<const T*>(qv), nullptr, nullptr, static_cast<T*>(dpos),
                        B, H, L, D, scale, s2s::tc::rows_aligned<T>(D, {qv})};
  return band::with_chunk(
      D, [&](auto ntw) { return launch_dpos_ntw<T, decltype(ntw)::value>(a, stream); });
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
