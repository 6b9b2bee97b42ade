// The tiling shared by the rel-pos flash forward (csrc/rel_flash.cu) and dq
// (csrc/rel_flash_bwd_dq.cu) kernels, whose band slots the dk/dv kernel
// (csrc/rel_flash_bwd_dkv.cu) takes too, and the backward's per-cell
// recompute (`cell_grads`, also csrc/rel_flash_bwd_dpos.cu's). A block owns
// BM query rows and walks the keys in tiles of BN; each tile's band term
// comes from the window of BM+BN-1 table rows it touches, multiplied as a
// (BM, WINR) product and skewed by index arithmetic in shared memory.
//
// The band's windows ("slots"). New style: one, table rows T-1-i+j. Legacy
// (the table (H, T, D), row p <-> absolute position p): cells j <= i read
// q_v row i against table row T-1-i+j ("lo"), cells j >= i+2 read q_v row
// i+1 against table row j-i-2 ("hi"), cell j = i+1 reads nothing. Both
// windows have the same skew (window row w = j - i + BM - 1 from its first
// row), so a tile takes one slot when all its cells lie on one side of the
// diagonal and two when it straddles it; a legacy band cell costs D
// multiply-adds either way.
#pragma once

#include <stdint.h>

#include "mma_tiles.cuh"

namespace s2s {
namespace rel {

constexpr int BM = 16;    // query rows per block: one m16 tile
constexpr int BN = 64;    // keys per tile
constexpr int WINR = 80;  // table window rows staged (BM + BN - 1 used)
constexpr int VK = 16;    // rows of one full-width chunk (a k16 step)
constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernels' _NEG_INF

// depth of one staged D-chunk (128 bytes a row) and its padded row length
template <typename T>
constexpr int kDK = 128 / (int)sizeof(T);
template <typename T>
constexpr int kLDC = kDK<T> + tc::kPad<T>;

// The score products of a tile are split over the warps so that each warp's
// products share their A operand (one ldmatrix of A per k-step): the lower
// four warps (quarter q = warp % 4) take n-tiles 2q and 2q+1 of the 16 x 64
// products against the key tile, the upper four the band's raw n-tiles of
// slot 0 (`raw_n`: quarter q takes 2q, 2q+1 and, for q < 2, 8+q of the
// ten). A straddling legacy tile's slot 1 goes to the lower warps (forward)
// or the upper ones (dq). Adjacent n-tiles share one ldmatrix.x4 of B
// (tc::mma2).
constexpr int kRawN = WINR / 8;  // raw n-tiles of one slot

// the raw n-tile that job j (0-2) of quarter q takes; not one where >= kRawN
__device__ __forceinline__ int raw_n(int q, int j) { return j < 2 ? 2 * q + j : 8 + q; }

struct Slots {
  int n;        // 1 or 2
  int aoff[2];  // q_v row offset of the slot's A operand: 0 (row i) or 1 (row i+1)
  int row0[2];  // table row of window row 0
};

// the slots of a tile of TM queries from i0 against TN keys from j0 (window
// row w = j - i + TM - 1, TM + TN - 1 rows); T = L
template <int TM = BM, int TN = BN>
__device__ __forceinline__ Slots tile_slots(bool legacy, int L, int i0, int j0) {
  Slots s;
  const int lo = L - TM - i0 + j0;  // row T-1-i+j at window row 0
  s.n = 1;
  s.aoff[0] = s.aoff[1] = 0;
  s.row0[0] = s.row0[1] = lo;
  if (!legacy) return s;
  const bool has_lo = j0 <= i0 + TM - 1;       // some cell j <= i
  const bool has_hi = j0 + TN - 1 >= i0 + 2;   // some cell j >= i + 2
  const int hi = j0 - i0 - TM - 1;             // row j-i-2 at window row 0
  if (has_lo && has_hi) {
    s.n = 2;
    s.aoff[1] = 1;
    s.row0[1] = hi;
  } else if (has_hi) {
    s.aoff[0] = 1;
    s.row0[0] = hi;
  }
  return s;
}

// the band term of cell (r, jl) of a tile, from the slots' raw products
// raw[slot * BM * ldr + r * ldr + w]; d = j - i
__device__ __forceinline__ float band(const float* raw, int ldr, bool legacy, const Slots& s,
                                      int r, int jl, int d) {
  const int w = jl - r + BM - 1;
  if (!legacy) return raw[r * ldr + w];
  if (d == 1) return 0.f;
  const int slot = d <= 0 ? 0 : s.n - 1;
  return raw[(slot * BM + r) * ldr + w];
}

// whether cell (r, jl), d = j - i, belongs to slot `slot`'s band
__device__ __forceinline__ bool in_slot(bool legacy, const Slots& s, int slot, int d) {
  return !legacy || (s.aoff[slot] == 0 ? d <= 0 : d >= 2);
}

// The backward's per-cell recompute (`_rel_block_grads`), shared by the dq,
// dk/dv and dpos kernels: from the raw score x = q_u.k + band and dp = dO.v
// of cell (query i, key j), p = exp(x * scale - lse), pd = keep(i, j) ? p /
// (1 - rate) : 0 (pd = p at rate 0) and ds = (pd * dp - p * delta) * scale;
// both 0 where !valid. `a` carries scale, rate, keep_scale, seed and t_pad.
template <typename A>
__device__ __forceinline__ void cell_grads(const A& a, float x, float dp, float lse, float delta,
                                           bool valid, int bh, int i, int j, float& pd,
                                           float& ds) {
  const float p = valid ? expf(x * a.scale - lse) : 0.f;
  if (a.rate > 0.f) {
    pd = (valid && dropout_keep(a.seed, bh, i, j, a.t_pad, a.t_pad, a.rate)) ? p * a.keep_scale
                                                                             : 0.f;
    ds = (pd * dp - p * delta) * a.scale;
  } else {
    pd = p;
    ds = p * (dp - delta) * a.scale;
  }
}

// output n-tiles (8 columns each) a warp owns for head dim D: D <= 64 * NTW
template <int NTW>
constexpr int kCols = 8 * NWARP * NTW;  // columns staged for the full-width products

using tc::rows_aligned;

}  // namespace rel
}  // namespace s2s
