// Fused relative-position attention scores, backward: dq_v and the table
// gradient (new-style rel-pos).
//
// Replaces the TPU kernel `_banded_bwd_kernel` of
// seq2seq_vc_tpu/ops/rel_scores.py (launched by `_scores_core.core_bwd`
// with bwd="banded"). With g the float32 cotangent of the (B, H, T, T)
// scores and scale = 1/sqrt(D):
//
//   dq_v[b,h,i]  = scale * sum_j g[b,h,i,j] * pos[h, T-1-i+j]
//   dpos[h,r]    = scale * sum_b sum_i G[b,h,i,r] * q_v[b,h,i]
//   G[b,h,i,r]   = g[b,h,i, i+r-(T-1)]   (zero where that key leaves [0,T))
//
// G is the (T, 2T-1) band cotangent. Both results are products with G,
// which never reaches device memory: a kernel tile reads it straight from
// g along its diagonals (csrc/rel_band_tiles.cuh), so both halves are plain
// tiled products:
//
// - dq_v: a block owns BM query rows and one BC-wide chunk of D, and walks
//   the table rows its queries touch (T+BM-1 of them) in steps of BK:
//   acc(BM, BC) += G(BM, BK) . pos(BK, BC);
// - dpos: a block owns BM table rows and one BC chunk of D, and walks every
//   (b, i) whose g row reaches them: acc(BM, BC) += G^T(BM, BK) . q_v(BK, BC).
//   Each table row's sum is taken by one block in a fixed order, so the
//   result is deterministic (no atomics, no partial buffers). This half is
//   `band::dpos_block`, which kernel 5 (csrc/rel_scores_bwd_pair.cu) runs on
//   its own.
//
// One launch runs both: the grid's first blocks are the dpos tiles (each
// walks B*T rows of g), the rest the dq_v tiles (T+BM rows each), so the
// short dq_v tiles fill the SMs while the long dpos tiles run. D is split
// over the grid in chunks of BC = 64, so no accumulator grows with D (the
// decoder's D = 768 is 12 chunks); the g tiles that the chunks of one row
// block share are read again through L2.
//
// The Pallas kernel's reversed table, `_block_rel_unshift_flipped` and the
// VMEM-resident (2*t_pad, qw) table gradient were Mosaic workarounds and
// have no counterpart here.
//
// Bound: g (B*H*T*T fp32) dominates the bytes, and the work is
// 2*B*H*T*T*D multiply-adds (T*(2T-1) band cells per head, half of them
// zero, times D, for each of the two products). At the training step's
// shapes the tensor-core rate would leave it bound by the bytes of g; this
// first version multiplies on the CUDA cores in float FMA (4 x 4 register
// tiles), so it is bound by FMA issue and shared-memory reads. Tensor
// cores are later work.
#include <stdint.h>

#include "common.cuh"
#include "rel_band_tiles.cuh"

namespace {

using namespace s2s::band;
using s2s::from_f;
using s2s::to_f;

template <typename T>
__global__ void __launch_bounds__(NT) rel_scores_bwd_kernel(
    const float* __restrict__ g, const T* __restrict__ qv, const T* __restrict__ pos,
    T* __restrict__ dqv, T* __restrict__ dpos, int B, int H, int L, int D,
    float scale, int n_dpos_blocks) {
  __shared__ float s_a[BK][LDA];
  __shared__ float s_b[BK][BC];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_pos = 2 * L - 1;
  const int n_dc = (D + BC - 1) / BC;

  // block index -> (D chunk, row block, head or batch-head); the chunk
  // varies fastest, so the blocks that share a g tile run side by side
  if ((int)blockIdx.x < n_dpos_blocks) {
    dpos_block(g, qv, dpos, B, H, L, D, scale, (int)blockIdx.x, s_a, s_b);
    return;
  }
  int blk = (int)blockIdx.x - n_dpos_blocks;
  const int d0 = (blk % n_dc) * BC;
  blk /= n_dc;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }

  // ---- dq_v: query rows i0 .. i0+BM-1 of (b, h), over the table rows they touch
  const int n_ib = (L + BM - 1) / BM;
  const int i0 = (blk % n_ib) * BM;
  const size_t bh = blk / n_ib;
  const int h = bh % H;
  const float* g_b = g + bh * L * L;
  const T* pos_h = pos + (size_t)h * n_pos * D;
  const int r_lo = max(0, L - i0 - BM);
  const int r_hi = min(n_pos - 1, 2 * L - 2 - i0);
  for (int k0 = r_lo; k0 <= r_hi; k0 += BK) {
    // A: s_a[kk][m] = G[i, r] with i = i0+m, r = k0+kk; consecutive threads
    // take consecutive r, i.e. consecutive keys of g row i
    for (int e = tid; e < BK * BM; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int i = i0 + m, r = k0 + kk, j = i + r - (L - 1);
      s_a[kk][m] = (i < L && r <= r_hi && j >= 0 && j < L) ? g_b[(size_t)i * L + j] : 0.f;
    }
    for (int e = tid; e < BK * BC; e += NT) {
      const int kk = e / BC, c = e % BC;
      const int r = k0 + kk, d = d0 + c;
      s_b[kk][c] = (r <= r_hi && d < D) ? to_f(pos_h[(size_t)r * D + d]) : 0.f;
    }
    __syncthreads();
    tile_fma(s_a, s_b, acc, tx, ty);
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
cudaError_t launch(const float* g, const void* qv, const void* pos, void* dqv, void* dpos,
                   int B, int H, int L, int D, float scale, cudaStream_t stream) {
  const long n_dc = (D + BC - 1) / BC;
  const long n_dpos = dpos_blocks(H, L, D);
  const long n_dqv = n_dc * ((L + BM - 1) / BM) * (long)B * H;
  if (n_dpos + n_dqv > 0x7fffffffL) return cudaErrorInvalidValue;
  rel_scores_bwd_kernel<T><<<(unsigned)(n_dpos + n_dqv), NT, 0, stream>>>(
      g, static_cast<const T*>(qv), static_cast<const T*>(pos), static_cast<T*>(dqv),
      static_cast<T*>(dpos), B, H, L, D, scale, (int)n_dpos);
  return cudaGetLastError();
}

}  // namespace

// g: (B, H, L, L) fp32; q_v, dq_v: (B, H, L, D); pos, dpos: (H, 2L-1, D);
// all contiguous, q_v/pos/dq_v/dpos in the storage type `dtype`. Writes
// every element of dq_v and dpos. Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_scores_bwd(int dtype, const void* g, const void* qv, const void* pos,
                              void* dqv, void* dpos, int B, int H, int L, int D,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(gf, qv, pos, dqv, dpos, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(gf, qv, pos, dqv, dpos, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
