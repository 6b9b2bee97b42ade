// Tensor-core tile helpers (mma.sync m16n8k16 from cp.async-staged shared
// memory) shared by the port's tensor-core kernels: the fused rel-pos scores
// (csrc/rel_scores.cu, kernel 1) and their backward (csrc/rel_scores_bwd.cu
// and csrc/rel_scores_bwd_pair.cu, through csrc/rel_band_tiles.cuh:
// kernels 3-5), the rel-pos flash kernels (the
// forward csrc/rel_flash.cu and the backward's dq, dk/dv and dpos:
// csrc/rel_flash_bwd_dq.cu, rel_flash_bwd_dkv.cu, rel_flash_bwd_dpos.cu;
// kernels 2 and 6-8) and the standard flash kernels (the forward
// csrc/flash.cu and the backward csrc/flash_bwd.cu: kernels 9-11).
//
// One warp multiplies a 16 x 16 tile A by a 16 x 8 tile B into an m16n8
// fragment of float32 accumulators: lane l holds the cells (l/4, 2*(l%4)),
// (l/4, 2*(l%4)+1), (l/4+8, 2*(l%4)) and (l/4+8, 2*(l%4)+1). Both tiles lie
// in shared memory, A row-major (or, through `load_a_t`, stored [k][m] and
// read transposed), B either as [n][k] rows (`KN` false: a key
// tile against which queries are scored) or as [k][n] rows (`KN` true: a
// value or table tile that a weight tile multiplies).
//
// - bfloat16: `ldmatrix` (`.trans` for [k][n]) and `mma.sync.m16n8k16` with
//   float32 accumulators, on the tensor cores;
// - float32: the same fragment, the same tile arguments, sixteen FMA steps
//   on the CUDA cores (no TF32: the float32 instantiation is the card's
//   reference path).
//
// So a kernel writes its tiling, staging, masks and epilogues once, for
// both storage types. A warp's own float32 results (a 16 x 16 tile of
// weights, say) become the A operand of its next product through `acc_to_a`
// and `AFrag2`: in bf16 packed in registers as a hi and a lo part, in
// float32 through a scratch tile of the warp's own. Rows of a staged tile are padded by 16 bytes (8
// bf16, 4 floats), so the eight 16-byte rows one `ldmatrix` phase reads fall
// on distinct banks.
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace s2s {
namespace tc {

// 16 bytes of row padding, in elements
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros if !valid
// (`src` must still be a device address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + nrows) and columns [col0, col0 + NCOLS) of a row-major
// source (`ld` elements a row) into dst (`ldd` elements a row), by the
// block's NT threads: 16-byte cp.async copies where `aligned` (every row
// start a multiple of 16 bytes), element loads otherwise. Rows outside
// [lo, hi) and columns at or past `width` become zeros. NCOLS is a multiple
// of 16 bytes.
template <int NT, int NCOLS, typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* __restrict__ src, int ld,
                                      int row0, int nrows, int lo, int hi, int col0, int width,
                                      bool aligned) {
  constexpr int S = kPad<T>;
  constexpr int nseg = NCOLS / S;
  for (int e = threadIdx.x; e < nrows * nseg; e += NT) {
    const int r = e / nseg, c = (e - r * nseg) * S;
    const int row = row0 + r, col = col0 + c;
    T* d = dst + r * ldd + c;
    const bool ok = row >= lo && row < hi;
    if (aligned) {
      const bool in = ok && col < width;
      cp_async16(d, in ? src + (size_t)row * ld + col : src, in);
    } else {
#pragma unroll
      for (int q = 0; q < S; ++q)
        d[q] = (ok && col + q < width) ? src[(size_t)row * ld + col + q] : from_f<T>(0.f);
    }
  }
}

// the A operand of one m16n8k16 step
template <typename T>
struct AFrag;
template <>
struct AFrag<__nv_bfloat16> {
  uint32_t r[4];
};
template <>
struct AFrag<float> {
  const float* p;
  int ld;
};

// The PTX: ldmatrix of 2 or 4 8x8 b16 matrices (row addresses from lanes
// 8m..8m+7 for matrix m; `.trans` delivers the transpose) and one bf16 mma.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t r[2]) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t r[4]) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A: the 16 x 16 tile at `a`, row-major, `lda` elements a row
__device__ __forceinline__ void load_a(AFrag<__nv_bfloat16>& f, const __nv_bfloat16* a,
                                       int lda) {
  const int lane = threadIdx.x % 32;
  ldsm_x4<false>(a + (lane % 16) * lda + (lane / 16) * 8, f.r);
}
__device__ __forceinline__ void load_a(AFrag<float>& f, const float* a, int lda) {
  f.p = a;
  f.ld = lda;
}
// A read transposed: the 16 x 16 tile whose element (m, k) is a[k * lda + m]
// (a [k][m] tile), by ldmatrix.trans: matrix q of the x4 (lanes 8q..8q+7)
// is rows k 8(q/2).., columns m 8(q%2).., which `.trans` delivers as the A
// fragment's register q (m 8(q%2).., k 8(q/2)..)
__device__ __forceinline__ void load_a_t(AFrag<__nv_bfloat16>& f, const __nv_bfloat16* a,
                                         int lda) {
  const int lane = threadIdx.x % 32;
  ldsm_x4<true>(a + (lane % 8 + 8 * (lane / 16)) * lda + 8 * ((lane / 8) % 2), f.r);
}

// c += A . B, B the 16 x 8 tile at `b`: b[k * ldb + n] if KN, else b[n * ldb + k]
template <bool KN>
__device__ __forceinline__ void mma(float c[4], const AFrag<__nv_bfloat16>& a,
                                    const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
  uint32_t r[2];
  if constexpr (KN)
    ldsm_x2<true>(b + (lane % 16) * ldb, r);
  else
    ldsm_x2<false>(b + (lane % 8) * ldb + ((lane / 8) % 2) * 8, r);
  mma_bf16(c, a.r, r[0], r[1]);
}
template <bool KN>
__device__ __forceinline__ void mma(float c[4], const AFrag<float>& a, const float* b,
                                    int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = 2 * (lane % 4);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a0 = a.p[g * a.ld + k], a1 = a.p[(g + 8) * a.ld + k];
    const float b0 = KN ? b[k * ldb + t] : b[t * ldb + k];
    const float b1 = KN ? b[k * ldb + t + 1] : b[(t + 1) * ldb + k];
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

// c0 += A . B and c1 += A . B', B and B' the adjacent 16 x 8 tiles at `b`
// (columns n, KN) or rows n (not KN) 0-7 and 8-15: in bf16 one ldmatrix.x4
// for both
template <bool KN>
__device__ __forceinline__ void mma2(float c0[4], float c1[4], const AFrag<__nv_bfloat16>& a,
                                     const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x % 32;
  uint32_t r[4];
  if constexpr (KN)
    ldsm_x4<true>(b + (lane % 16) * ldb + (lane / 16) * 8, r);
  else
    ldsm_x4<false>(b + (lane % 8 + 8 * (lane / 16)) * ldb + ((lane / 8) % 2) * 8, r);
  mma_bf16(c0, a.r, r[0], r[1]);
  mma_bf16(c1, a.r, r[2], r[3]);
}
template <bool KN>
__device__ __forceinline__ void mma2(float c0[4], float c1[4], const AFrag<float>& a,
                                     const float* b, int ldb) {
  mma<KN>(c0, a, b, ldb);
  mma<KN>(c1, a, KN ? b + 8 : b + 8 * ldb, ldb);
}

// acc[n] += A . B[:, col0 + 8n : col0 + 8n + 8] for the NTW n-tiles from
// column col0 of a [k][n] tile at `b` (columns at or past D skipped, pairs
// through mma2: a pair may reach past D into staged zeros)
template <int NTW, typename T>
__device__ __forceinline__ void mma_cols(float acc[NTW][4], const AFrag<T>& a, const T* b,
                                         int ldb, int col0, int D) {
#pragma unroll
  for (int n = 0; n + 1 < NTW; n += 2)
    if (col0 + 8 * n < D) mma2<true>(acc[n], acc[n + 1], a, b + col0 + 8 * n, ldb);
  if constexpr (NTW % 2 == 1)
    if (col0 + 8 * (NTW - 1) < D) mma<true>(acc[NTW - 1], a, b + col0 + 8 * (NTW - 1), ldb);
}

// The A operand of a warp's next product from its own float32 results: c0
// and c1 are the m16n8 fragments of columns 0-7 and 8-15 of a 16 x 16 tile
// (of attention weights, say), which becomes the m16k16 A operand.
// bfloat16: lane l's accumulator cells (l/4, 2(l%4) + {0, 1}) and (l/4 + 8,
// ...) are the A fragment's k-pairs of the same lane, so the tile is packed
// into registers and never reaches shared memory; `s` is not used. It goes
// in as two bf16 fragments, hi = bf16(x) and lo = bf16(x - hi), whose two
// products sum to x . B within ~2^-16 of x: one bf16 rounding of a weight
// (2^-9 relative) can, in a sum that cancels, move a result past the bf16
// tolerance of a float32 reference. float32: the tile goes to the warp's own
// scratch `s` (16 rows of kLdScratch floats) and the fragment points at it.
constexpr int kLdScratch = 16 + 4;

template <typename T>
struct AFrag2;
template <>
struct AFrag2<__nv_bfloat16> {
  AFrag<__nv_bfloat16> hi, lo;
};
template <>
struct AFrag2<float> {
  AFrag<float> hi;
};

// bf16(lo_x) | bf16(hi_x) << 16, and what rounding left of each
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1, float& r0, float& r1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  r0 = x0 - __bfloat162float(h.x);
  r1 = x1 - __bfloat162float(h.y);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void acc_to_a(AFrag2<__nv_bfloat16>& f, const float c0[4],
                                         const float c1[4], float*) {
  float r[8], unused[2];
  f.hi.r[0] = pack_bf16(c0[0], c0[1], r[0], r[1]);  // row l/4,     k 2(l%4) + {0, 1}
  f.hi.r[1] = pack_bf16(c0[2], c0[3], r[2], r[3]);  // row l/4 + 8, the same k
  f.hi.r[2] = pack_bf16(c1[0], c1[1], r[4], r[5]);  // row l/4,     k 8 + 2(l%4) + {0, 1}
  f.hi.r[3] = pack_bf16(c1[2], c1[3], r[6], r[7]);  // row l/4 + 8, the same k
#pragma unroll
  for (int e = 0; e < 4; ++e) f.lo.r[e] = pack_bf16(r[2 * e], r[2 * e + 1], unused[0], unused[1]);
}
__device__ __forceinline__ void acc_to_a(AFrag2<float>& f, const float c0[4], const float c1[4],
                                         float* s) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = 2 * (lane % 4);
  __syncwarp();  // the warp's reads of the last tile in `s` are done
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float* row = s + (g + 8 * (e / 2)) * kLdScratch + t + e % 2;
    row[0] = c0[e];
    row[8] = c1[e];
  }
  __syncwarp();
  f.hi.p = s;
  f.hi.ld = kLdScratch;
}

// mma_cols for an AFrag2: bf16 multiplies each B pair (one ldmatrix.x4)
// by hi and by lo into the same accumulators
template <int NTW>
__device__ __forceinline__ void mma_cols(float acc[NTW][4], const AFrag2<__nv_bfloat16>& a,
                                         const __nv_bfloat16* b, int ldb, int col0, int D) {
  static_assert(NTW % 2 == 0, "n-tile pairs");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NTW; n += 2) {
    if (col0 + 8 * n >= D) continue;
    uint32_t r[4];
    ldsm_x4<true>(b + col0 + 8 * n + (lane % 16) * ldb + (lane / 16) * 8, r);
    mma_bf16(acc[n], a.hi.r, r[0], r[1]);
    mma_bf16(acc[n + 1], a.hi.r, r[2], r[3]);
    mma_bf16(acc[n], a.lo.r, r[0], r[1]);
    mma_bf16(acc[n + 1], a.lo.r, r[2], r[3]);
  }
}
template <int NTW>
__device__ __forceinline__ void mma_cols(float acc[NTW][4], const AFrag2<float>& a,
                                         const float* b, int ldb, int col0, int D) {
  mma_cols<NTW>(acc, a.hi, b, ldb, col0, D);
}

// true where every row of the (rows, D) inputs starts on 16 bytes (the
// condition of `stage`'s cp.async path)
template <typename T>
inline bool rows_aligned(int D, std::initializer_list<const void*> ptrs) {
  if ((D * (int)sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// the fragment's cells: (row, column) of c[e] within the 16 x 8 tile
__device__ __forceinline__ int frag_row(int e) { return (threadIdx.x % 32) / 4 + 8 * (e / 2); }
__device__ __forceinline__ int frag_col(int e) { return 2 * (threadIdx.x % 4) + (e % 2); }

}  // namespace tc
}  // namespace s2s
