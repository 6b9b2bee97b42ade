// Fused relative-position attention scores, forward (new-style rel-pos), on
// the tensor cores.
//
// Replaces the TPU kernel `_fwd_kernel` of seq2seq_vc_tpu/ops/rel_scores.py
// (launched by `_scores_core.fwd_impl`, entry `fused_rel_scores`; in the
// port `ops/rel_scores.py:fused_rel_scores`, which the AAS-VC conformer's
// attention calls below the flash gate, serving and training).
//
//   scores[bh, i, j] = (q_u[i] . k[j] + q_v[i] . pos[h, T-1-i+j]) * scale
//
// pos is the head-split projected RelPositionalEncoding table, (H, 2T-1, D),
// row p <-> relative distance T-1-p. The output is fp32 (BH, T, T); rows and
// columns past T are never written.
//
// Design (mma.sync m16n8k16, csrc/mma_tiles.cuh). The TPU kernel pads D to
// 128 lanes and reads a zero-padded 3T table; here pos is read as it is and
// D is not padded. A block of 4 warps owns a 64 x 64 output tile of one (b,
// h), 16 query rows a warp. The band entries of the tile come from a window
// of 127 consecutive table rows starting at r0 = T - 64 - i0 + j0 (cell (i,
// j) reads window row 63 - (i - i0) + (j - j0)).
// - Staging: D in chunks of 64 bytes a row (two k-steps of 16 in bf16, one
//   in float32) through a two-buffer cp.async ring (tc::stage; element
//   loads where rows are not 16-byte aligned). A chunk holds q_u and q_v for
//   the block's 64 rows, its 64 key rows and the window (128 rows staged),
//   rows padded 16 bytes: 51 KB for the ring, so four blocks share an SM
//   (128-byte chunks, 92 KB, allowed two and ran slower on the H100). Rows
//   outside [0, T) and table rows outside [0, 2T-1) load as zeros; no cell
//   that reads them is stored.
// - Products: S = q_u . K^T, 8 n-tiles a warp; and the band, raw = q_v .
//   W^T over the warp's own 80-row sub-window starting at window row 48 -
//   16w, which covers j - i + 63 for all of warp w's cells: 10 n-tiles.
//   That is 18 n-tiles (72 float accumulators a lane), 1.125x the minimal
//   work, against the 2x of multiplying the whole window. Adjacent n-tiles
//   share one ldmatrix.x4 (tc::mma2).
// - Epilogue: each warp writes its raw fragments to shared memory and reads
//   them back skewed by index, raw[r][jl - r + 15] (the skew of
//   rel_flash_tiles.cuh), adds S, scales, and stages the 64 x 64 fp32 tile;
//   the block then stores whole 256-byte rows with 16-byte stores (element
//   stores where T is not a multiple of 4), guarding rows and columns past
//   T.
// - float32 (the card's reference path, no TF32) runs the same tiling
//   through the FMA fragments of mma_tiles.cuh.
// No atomics: deterministic.
//
// Bound: the operations are 2*T*T*D (q_u.k) plus 2*T*T*D (the band)
// multiply-adds per head against the fp32 (T, T) output and ~4 T*D inputs.
// At the encoder's D 192 the output's bytes bound it (about 148 operations a
// byte at T 960, under the ~295 at which the bf16 tensor cores become the
// limit); at the decoder's D 768 the operations do. This version issues
// mma.sync from a cp.async ring; wgmma, TMA and persistent blocks are later
// work.
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

namespace tc = s2s::tc;

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // key columns per block
constexpr int NW = 4;    // warps: 16 query rows each
constexpr int NT = 32 * NW;
constexpr int WIN = 128;  // table window rows staged (BM + BN - 1 used)
constexpr int SUB = 80;   // a warp's sub-window of the table window
constexpr int NSTAGE = 2;
constexpr int LDR = SUB + 4;  // a staged raw band row, floats
constexpr int LDO = BN + 4;   // a staged output row, floats

template <typename T>
struct Cfg {
  static constexpr int DK = 64 / (int)sizeof(T);   // depth of one D-chunk
  static constexpr int LDC = DK + tc::kPad<T>;     // staged row, elements
  // one ring buffer: q_u, q_v, k, the window
  static constexpr int QU = 0, QV = BM * LDC, K = 2 * BM * LDC, W = (2 * BM + BN) * LDC;
  static constexpr int STAGE = (2 * BM + BN + WIN) * LDC;
  static constexpr int RING_BYTES = NSTAGE * STAGE * (int)sizeof(T);
  // the epilogue reuses it: each warp's raw band, then the output tile
  static constexpr int OUT_OFF = NW * 16 * LDR;  // floats
  static constexpr int EPI_BYTES = (OUT_OFF + BM * LDO) * 4;
  static constexpr int BYTES = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

template <typename T>
__global__ void __launch_bounds__(NT) rel_scores_fwd_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
    const T* __restrict__ pos, float* __restrict__ out, int H, int L, int D, float scale,
    bool aligned) {
  using C = Cfg<T>;
  constexpr int DK = C::DK, LDC = C::LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / 32;

  const int j0 = blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const int bh = blockIdx.z;
  const int h = bh % H;
  const int n_pos = 2 * L - 1;
  const int r0 = L - BM - i0 + j0;  // first table row of the tile's window

  const size_t base = (size_t)bh * L * D;
  const T* qu_b = qu + base;
  const T* qv_b = qv + base;
  const T* k_b = k + base;
  const T* pos_h = pos + (size_t)h * n_pos * D;
  const int nchunks = (D + DK - 1) / DK;

  auto issue = [&](int c) {
    if (c < nchunks) {
      T* buf = ring + (c % NSTAGE) * C::STAGE;
      const int d0 = c * DK;
      tc::stage<NT, DK>(buf + C::QU, LDC, qu_b, D, i0, BM, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + C::QV, LDC, qv_b, D, i0, BM, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + C::K, LDC, k_b, D, j0, BN, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + C::W, LDC, pos_h, D, r0, WIN, 0, n_pos, d0, D, aligned);
    }
    tc::cp_async_commit();  // an empty group keeps the wait count uniform
  };

  float sacc[BN / 8][4];   // q_u . K^T: the warp's 16 rows x 64 keys
  float raw[SUB / 8][4];   // q_v . W^T over the warp's sub-window
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[n][e] = 0.f;

  issue(0);
  for (int c = 0; c < nchunks; ++c) {
    issue(c + 1);
    tc::cp_async_wait<1>();
    __syncthreads();
    const T* buf = ring + (c % NSTAGE) * C::STAGE;
    const T* a_u = buf + C::QU + 16 * warp * LDC;
    const T* a_v = buf + C::QV + 16 * warp * LDC;
    const T* kb = buf + C::K;
    const T* wb = buf + C::W + (48 - 16 * warp) * LDC;  // the warp's sub-window
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      if (c * DK + 16 * ks >= D) break;  // staged zeros past D
      tc::AFrag<T> af;
      tc::load_a(af, a_u + 16 * ks, LDC);
#pragma unroll
      for (int n = 0; n < BN / 8; n += 2)
        tc::mma2<false>(sacc[n], sacc[n + 1], af, kb + 8 * n * LDC + 16 * ks, LDC);
      tc::load_a(af, a_v + 16 * ks, LDC);
#pragma unroll
      for (int n = 0; n < SUB / 8; n += 2)
        tc::mma2<false>(raw[n], raw[n + 1], af, wb + 8 * n * LDC + 16 * ks, LDC);
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // skew: the warp's raw band to shared memory, read back along the
  // diagonals (cell (r, jl) of the warp's rows: sub-window row jl - r + 15)
  float* s_raw = reinterpret_cast<float*>(smem) + warp * 16 * LDR;
  float* s_out = reinterpret_cast<float*>(smem) + C::OUT_OFF;
#pragma unroll
  for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_raw[tc::frag_row(e) * LDR + 8 * n + tc::frag_col(e)] = raw[n][e];
  __syncwarp();
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tc::frag_row(e), jl = 8 * n + tc::frag_col(e);
      s_out[(16 * warp + r) * LDO + jl] = (sacc[n][e] + s_raw[r * LDR + jl - r + 15]) * scale;
    }
  __syncthreads();

  // whole rows of the tile, 16 bytes a store
  float* out_b = out + (size_t)bh * L * L;
  const bool vec = L % 4 == 0;  // every row starts on 16 bytes
  for (int e = threadIdx.x; e < BM * BN / 4; e += NT) {
    const int r = e / (BN / 4), c4 = 4 * (e % (BN / 4));
    const int i = i0 + r, j = j0 + c4;
    if (i >= L || j >= L) continue;
    const float* src = s_out + r * LDO + c4;
    float* dst = out_b + (size_t)i * L + j;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < L) dst[q] = src[q];
    }
  }
}

template <typename T>
cudaError_t launch(const void* qu, const void* qv, const void* k, const void* pos,
                   float* out, int BH, int H, int L, int D, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T>;
  void (*kernel)(const T*, const T*, const T*, const T*, float*, int, int, int, float, bool) =
      &rel_scores_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const bool aligned = tc::rows_aligned<T>(D, {qu, qv, k, pos});
  const dim3 grid((L + BN - 1) / BN, (L + BM - 1) / BM, BH);
  kernel<<<grid, NT, C::BYTES, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(pos), out, H, L, D, scale, aligned);
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
