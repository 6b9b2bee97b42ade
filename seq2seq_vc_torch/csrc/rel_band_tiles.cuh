// Tiled products with the band cotangent of the fused rel-scores backward,
// shared by csrc/rel_scores_bwd.cu (kernel 3) and csrc/rel_scores_bwd_pair.cu
// (kernels 4 and 5).
//
// With g the float32 cotangent of the (B, H, T, T) scores, the band
// cotangent is G[b,h,i,r] = g[b,h,i, i+r-(T-1)] (zero where that key leaves
// [0, T)). It never reaches device memory: row i of G over table rows
// [r0, r0+n) is the CONTIGUOUS run g[i, i+r0-(T-1) .. +n) of row i of g, so
// a tile reads it straight from g along the diagonals.
#pragma once

#include "common.cuh"

namespace s2s {
namespace band {

constexpr int BM = 64;   // output rows per block: query rows (dq_v), table rows (dpos)
constexpr int BC = 64;   // output columns per block: one chunk of D
constexpr int BK = 32;   // depth of one step of the reduction
constexpr int NT = 256;  // threads: a 16 x 16 grid, 4 x 4 outputs each
constexpr int LDA = BM + 1;  // padded row stride: conflict-free transposed stores

// acc += s_a^T s_b over one BK step: s_a is (BK, BM) (A stored by k), s_b is
// (BK, BC); thread (tx, ty) owns rows ty + 16a and columns tx + 16c.
__device__ __forceinline__ void tile_fma(const float (*s_a)[LDA], const float (*s_b)[BC],
                                         float (&acc)[4][4], int tx, int ty) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = s_a[kk][ty + 16 * m];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = s_b[kk][tx + 16 * c];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(a[m], b[c], acc[m][c]);
    }
  }
}

// Blocks of the table gradient: (D chunks) x (row blocks of 2L-1) x H.
inline long dpos_blocks(int H, int L, int D) {
  return (long)((D + BC - 1) / BC) * ((2L * L - 1 + BM - 1) / BM) * H;
}

// One block of the table gradient, blk in [0, dpos_blocks): table rows
// r0 .. r0+BM-1 and columns d0 .. d0+BC-1 of head h,
//   dpos[h,r] = scale * sum_b sum_i G[b,h,i,r] * q_v[b,h,i],
// walking every (b, i) whose g row reaches those table rows, in a fixed
// order: acc(BM, BC) += G^T(BM, BK) . q_v(BK, BC). Each table row's sum is
// one block's, so the result is deterministic (no atomics, no partials).
template <typename T>
__device__ __forceinline__ void dpos_block(const float* __restrict__ g, const T* __restrict__ qv,
                                           T* __restrict__ dpos, int B, int H, int L, int D,
                                           float scale, int blk, float (*s_a)[LDA],
                                           float (*s_b)[BC]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_pos = 2 * L - 1;
  const int n_dc = (D + BC - 1) / BC;
  const int d0 = (blk % n_dc) * BC;  // the chunk varies fastest: blocks that share g run together
  blk /= n_dc;
  const int n_rb = (n_pos + BM - 1) / BM;
  const int r0 = (blk % n_rb) * BM;
  const int h = blk / n_rb;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  }
  // rows i whose g row reaches a table row of this block
  const int i_lo = max(0, L - r0 - BM);
  const int i_hi = min(L - 1, 2 * L - 2 - r0);
  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * H + h;
    const float* g_b = g + bh * L * L;
    const T* qv_b = qv + bh * L * D;
    for (int k0 = i_lo; k0 <= i_hi; k0 += BK) {
      // A^T: s_a[kk][m] = G[i, r] with i = k0+kk, r = r0+m; consecutive
      // threads take consecutive r, i.e. consecutive keys of g row i
      for (int e = tid; e < BK * BM; e += NT) {
        const int kk = e / BM, m = e % BM;
        const int i = k0 + kk, j = i + r0 + m - (L - 1);
        s_a[kk][m] = (i <= i_hi && j >= 0 && j < L) ? g_b[(size_t)i * L + j] : 0.f;
      }
      for (int e = tid; e < BK * BC; e += NT) {
        const int kk = e / BC, c = e % BC;
        const int i = k0 + kk, d = d0 + c;
        s_b[kk][c] = (i <= i_hi && d < D) ? to_f(qv_b[(size_t)i * D + d]) : 0.f;
      }
      __syncthreads();
      tile_fma(s_a, s_b, acc, tx, ty);
      __syncthreads();
    }
  }
  T* out = dpos + (size_t)h * n_pos * D;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + ty + 16 * m;
    if (r >= n_pos) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < D) out[(size_t)r * D + d] = from_f<T>(acc[m][c] * scale);
    }
  }
}

}  // namespace band
}  // namespace s2s
