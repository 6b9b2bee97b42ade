// Standard multi-head flash attention, backward: the dq kernel and the
// dk/dv kernel (FlashAttention-2 style: the score tiles are recomputed from
// q, k and the forward's saved logsumexp; the (Tq, Tk) matrices never reach
// device memory), on the tensor cores.
//
// Replace the TPU kernels of seq2seq_vc_tpu/ops/flash_attention.py
// (launched by `_flash_core.core_bwd`, entry `flash_attention`):
//   flash_bwd_dq  <- `_flash_bwd_dq_kernel`  (dq = sum_j ds[i, j] k[j])
//   flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (dk = sum_i ds[i, j] q[i],
//                                             dv = sum_i pd[i, j] dO[i])
// with the tile recomputation of `_std_block_grads`:
//   p[i, j]  = live(i, j) ? exp(q[i] . k[j] * scale - lse[i]) : 0
//   pd[i, j] = keep(i, j) * p[i, j] / (1 - rate)    (p itself at rate 0)
//   ds[i, j] = (pd[i, j] * (dO[i] . v[j]) - p[i, j] * delta[i]) * scale
// where live(i, j) is j < kv_len[b] (and j <= i when causal), keep is the
// forward's dropout hash (csrc/common.cuh, the same padded lengths), and
// delta[i] = dO[i] . out[i], which the caller computes (one float a row).
// A row with no live key has lse = -1e30 and gets p = 0 through `live`.
//
// Design (FlashAttention-2's backward on mma.sync, csrc/mma_tiles.cuh).
// The TPU kernels carry their sums over a sequential grid axis in VMEM
// scratch at D padded to 128 with a lane-broadcast logsumexp; here blocks
// run in parallel, each sum is a loop inside a block, and D is padded only
// to the next of 96, 128, 256, 768 (a template parameter, DP).
// - dq: a block of 4 warps owns BM = 64 query rows, 16 a warp, and walks
//   the key tiles of BN = 64 up to kv_len (under the causal mask up to its
//   last row). A warp takes a tile in chunks of 16 keys: S = q . K^T and
//   dP = dO . V^T as two m16n8 fragments each (tc::mma2 over D), (pd, ds)
//   per cell in those registers (mask, exp, the dropout hash on the global
//   (i, j)), then dq += dS . K on the same staged K rows read as [k][n]
//   (ldmatrix.trans). Chunks wholly past kv_len or above the causal
//   diagonal are skipped by the warp.
// - dk/dv: the same, key-major. A block owns 64 keys, 16 a warp, and walks
//   the query tiles of 64 (under the causal mask from the first tile that
//   can see its keys); S^T = K . Q^T, dP^T = V . dO^T, then dv += Pd^T . dO
//   and dk += dS^T . Q on the staged Q and dO rows. The tile's lse and
//   delta are staged beside it. A block of keys at or past kv_len writes
//   zeros with no loop.
// - Scores stay in registers: two adjacent m16n8 fragments of a warp's 16 x
//   16 chunk are one m16k16 A fragment once packed to bf16x2
//   (tc::acc_to_a), so in bf16 no score goes through shared memory. Each
//   weight (pd, ds) goes in as hi + lo, two bf16 fragments, two products
//   (tc::AFrag2): a single rounding (2^-9 relative, as the rel-pos kernels
//   take it) broke the bf16 tolerance against the float32 plain version in
//   1 of 6 random draws of the causal T 640 check with dropout, where rows
//   near the diagonal put large weights on few keys and the sum cancels.
//   The float32 instantiation writes the chunk to a 16 x 16 scratch of the
//   warp's own and runs the same fragments in FMA (no TF32: it is the
//   card's reference path).
// - The block's own rows (q and dO, or k and v) are staged once; in bf16 at
//   DP <= 96 (dk/dv) or 128 (dq) each warp then holds its 16 rows as A
//   fragments in registers for the whole walk (DP 96: 2 x 6 k-steps x 4
//   registers), else it reads them from shared memory each k-step. The
//   walked K and V (or Q and dO) tiles come in by cp.async into a ring of
//   two buffers, in the storage type, rows padded 16 bytes.
// - Register budget: dk/dv at DP 96 holds 2 x 12 n-tiles x 4 = 96
//   accumulators; at DP 256 a warp cannot hold 16 full-width rows of dk and
//   dv (256), so the output columns are split over two warps per 16 keys
//   (8 warps a block), each recomputing the same 16 x 16 chunk of scores.
//   float32 at DP 256 halves the tiles (BM = BN = 32) to fit shared memory.
//   At DP 768 both kernels split the output columns over six warps of 128
//   columns (dq too), each recomputing the chunk's scores over the full D;
//   a block owns 16 rows and walks tiles of 16, float32 through a ring of
//   one buffer, so that the own rows and the walked tiles fit shared memory.
//   All under __launch_bounds__(threads, 1).
// No atomics: every output element has one owner, so both are
// deterministic. D <= 768.
//
// Bound: per (b, h) about 3 (dq) or 4 (dk/dv) x 2 x live scores x D flops
// (two recomputed products, then one or two accumulations) against ~(3 Tq
// + 2 keys) x D inputs read once: bound by the tensor cores' rate at the
// main path's shapes. This version walks with mma.sync from a cp.async ring;
// wgmma, TMA and warp specialisation are later work.
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using s2s::from_f;
namespace tc = s2s::tc;

constexpr int MAX_D = 768;

struct Args {
  const void *q, *k, *v;
  const int* kv_lens;
  const float *lse, *delta;
  const void* d_out;
  void *o1, *o2;  // dq; or dk, dv
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
  float rate, keep_scale;
  unsigned seed;
  int tq_pad, tk_pad;
};

// The tiling of one variant: storage type T, head dim padded to DP, dq or
// dk/dv. "Own" rows are the block's (q and dO for dq, k and v for dk/dv);
// "walked" tiles are the ring's (k and v, or q and dO).
template <typename T, int DP, bool DKV>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  // DP 768 ("wide"): 16 own rows a block, output columns over 6 warps,
  // walked tiles of 16 rows, and in float32 a ring of one buffer, to fit
  // shared memory
  static constexpr bool WIDE = DP > 256;
  static constexpr int WM = WIDE ? 1 : (F32 && DP > 128) ? 2 : 4;  // 16-row groups a block owns
  static constexpr int NWR = WIDE ? DP / 128 : (DKV && DP > 128) ? 2 : 1;  // warps a group
  static constexpr int NW = WM * NWR, NT = 32 * NW;
  static constexpr int BM = 16 * WM;                                    // own rows a block
  static constexpr int BN = WIDE ? 16 : (F32 && DP > 128) ? 32 : 64;  // rows a walked tile
  static constexpr int NSTAGE = (WIDE && F32) ? 1 : 2;  // buffers of the cp.async ring
  static constexpr int NTW = DP / 8 / NWR;                // output n-tiles a warp owns
  static constexpr int KS = DP / 16;                      // k-steps of a score product
  static constexpr bool AREG = !F32 && DP <= (DKV ? 96 : 128);  // own rows in registers
  static constexpr int LD = DP + tc::kPad<T>;             // staged row, elements
  static constexpr int TILE = BN * LD;                    // one walked tensor's tile
  // elements of T: own rows (none with AREG: they are staged into ring
  // buffer 1 and moved to registers before the walk needs it), the ring
  static constexpr int OWN = AREG ? 0 : 2 * BM * LD;
  static constexpr int RING_BYTES = (OWN + NSTAGE * 2 * TILE) * (int)sizeof(T);
  // then float: the walked tile's lse and delta per buffer (dk/dv), and a
  // 16 x 16 scratch per warp (float32's A operand from registers)
  static constexpr int ROWS_OFF = RING_BYTES;
  static constexpr int SCR_OFF = ROWS_OFF + (DKV ? NSTAGE * 2 * BN * 4 : 0);
  static constexpr int BYTES = SCR_OFF + (F32 ? NW * 16 * tc::kLdScratch * 4 : 0);
  static_assert(!AREG || 2 * TILE >= 2 * BM * LD, "own rows fit in ring buffer 1");
  static_assert(BN % 16 == 0 && NTW % 2 == 0, "whole chunks and n-tile pairs");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// (pd, ds) of one live-or-not cell from its two dot products; ds includes
// the softmax scale (`_std_block_grads`)
__device__ __forceinline__ void cell_grads(const Args& a, int bh, int i, int j, bool live,
                                           float qk, float dp, float lse_i, float delta_i,
                                           float& pd, float& ds) {
  const float p = live ? expf(qk * a.scale - lse_i) : 0.f;
  if (a.rate > 0.f) {
    pd = (live && s2s::dropout_keep(a.seed, bh, i, j, a.tq_pad, a.tk_pad, a.rate))
             ? p * a.keep_scale
             : 0.f;
    ds = (pd * dp - p * delta_i) * a.scale;
  } else {
    pd = p;
    ds = p * (dp - delta_i) * a.scale;
  }
}

// s and dp (two m16n8 fragments each: a 16 x 16 chunk) += A . B^T over D:
// A the warp's own 16 rows (fragments in registers, or rows in shared memory
// at `own`), B two tiles of 16 walked rows at `b1`, `b2`
template <typename T, int KS, bool AREG>
__device__ __forceinline__ void chunk_scores(float s[2][4], float dp[2][4],
                                             const tc::AFrag<T>* f1, const tc::AFrag<T>* f2,
                                             const T* own1, const T* own2, int ld,
                                             const T* b1, const T* b2, int D) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (16 * ks >= D) break;  // staged zeros past D
    if constexpr (AREG) {
      tc::mma2<false>(s[0], s[1], f1[ks], b1 + 16 * ks, ld);
      tc::mma2<false>(dp[0], dp[1], f2[ks], b2 + 16 * ks, ld);
    } else {
      tc::AFrag<T> af;
      tc::load_a(af, own1 + 16 * ks, ld);
      tc::mma2<false>(s[0], s[1], af, b1 + 16 * ks, ld);
      tc::load_a(af, own2 + 16 * ks, ld);
      tc::mma2<false>(dp[0], dp[1], af, b2 + 16 * ks, ld);
    }
  }
}

// The block's own rows staged and, with AREG, moved to fragments: issued
// before the first walked tile, into ring buffer 1 with AREG (free until
// the walk's second tile), else into their own region. Returns their
// shared-memory rows (valid after `own_ready`).
template <typename C, typename T>
__device__ __forceinline__ T* stage_own(T* smem_t, const T* src1, const T* src2, int row0,
                                        int hi, int D, bool aligned) {
  T* own = C::AREG ? smem_t + 2 * C::TILE : smem_t;  // ring buffer 1, or the own region
  tc::stage<C::NT, C::KS * 16>(own, C::LD, src1, D, row0, C::BM, 0, hi, 0, D, aligned);
  tc::stage<C::NT, C::KS * 16>(own + C::BM * C::LD, C::LD, src2, D, row0, C::BM, 0, hi, 0, D,
                               aligned);
  tc::cp_async_commit();
  return own;
}

template <typename C, typename T>
__device__ __forceinline__ void own_ready(tc::AFrag<T>* f1, tc::AFrag<T>* f2, const T* own,
                                          int row16) {
  if constexpr (C::AREG) {
    tc::cp_async_wait<1>();  // the own rows' group (the first walked tile may be in flight)
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      tc::load_a(f1[ks], own + row16 * C::LD + 16 * ks, C::LD);
      tc::load_a(f2[ks], own + (C::BM + row16) * C::LD + 16 * ks, C::LD);
    }
    __syncthreads();  // ring buffer 1 is free for the walk
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP, false>::NT, 1) flash_bwd_dq_kernel(const Args a,
                                                                             bool aligned) {
  using C = Cfg<T, DP, false>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, TILE = C::TILE, NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* smem_t = reinterpret_cast<T*>(smem);
  T* ring = smem_t + C::OWN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + C::SCR_OFF) + warp * 16 * tc::kLdScratch;
  const int grp = warp / C::NWR;               // the warp's 16 rows
  const int col0 = (warp % C::NWR) * NTW * 8;  // and its output columns

  const int D = a.D, bh = blockIdx.y, i0 = blockIdx.x * BM;
  const int iw = i0 + 16 * grp;  // the warp's first row
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], a.Tk));
  const int kv_end = a.causal ? min(kv_len, i0 + BM) : kv_len;  // keys the block sees
  const int ntiles = (kv_end + BN - 1) / BN;
  const size_t qbase = (size_t)bh * a.Tq * D, kbase = (size_t)bh * a.Tk * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  const T* own = stage_own<C>(smem_t, static_cast<const T*>(a.q) + qbase,
                              static_cast<const T*>(a.d_out) + qbase, i0, a.Tq, D, aligned);
  auto issue = [&](int t) {
    if (t < ntiles) {
      T* buf = ring + (t % C::NSTAGE) * 2 * TILE;
      tc::stage<C::NT, DP>(buf, LD, k, D, t * BN, BN, 0, kv_end, 0, D, aligned);
      tc::stage<C::NT, DP>(buf + TILE, LD, v, D, t * BN, BN, 0, kv_end, 0, D, aligned);
    }
    tc::cp_async_commit();  // an empty group keeps the wait count uniform
  };
  issue(0);

  // this thread's rows: l/4 and l/4 + 8 of the warp's 16
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = iw + g + 8 * h;
    lse_r[h] = i < a.Tq ? a.lse[(size_t)bh * a.Tq + i] : 0.f;
    dl_r[h] = i < a.Tq ? a.delta[(size_t)bh * a.Tq + i] : 0.f;
  }
  tc::AFrag<T> fq[C::AREG ? C::KS : 1], fdo[C::AREG ? C::KS : 1];
  own_ready<C>(fq, fdo, own, 16 * grp);
  const T* own_q = own + 16 * grp * LD;
  const T* own_do = own + (BM + 16 * grp) * LD;

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    tc::walk_wait<C::NSTAGE>([&] { issue(t + 1); });
    const T* sk = ring + (t % C::NSTAGE) * 2 * TILE;
    const T* sv = sk + TILE;
#pragma unroll 1
    for (int c = 0; c < BN / 16; ++c) {
      const int jc = t * BN + 16 * c;
      // warp-uniform: no live cell in the chunk
      if (jc >= kv_end || iw >= a.Tq || (a.causal && jc > iw + 15)) continue;
      float s[2][4], dp[2][4];
      chunk_scores<T, C::KS, C::AREG>(s, dp, fq, fdo, own_q, own_do, LD, sk + 16 * c * LD,
                                      sv + 16 * c * LD, D);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = iw + g + 8 * (e / 2), j = jc + 8 * n + t2 + e % 2;
          const bool live = i < a.Tq && j < kv_len && (!a.causal || j <= i);
          float pd;
          cell_grads(a, bh, i, j, live, s[n][e], dp[n][e], lse_r[e / 2], dl_r[e / 2], pd,
                     s[n][e]);  // s becomes ds
        }
      tc::AFrag2<T> fds;
      tc::acc_to_a(fds, s[0], s[1], scratch);
      tc::mma_cols<NTW>(acc, fds, sk + 16 * c * LD, LD, col0, D);  // dq += dS . K
    }
    __syncthreads();  // the buffer is free for the tile after next
    if constexpr (C::NSTAGE == 1) issue(t + 1);  // (one buffer: the next tile)
  }
  tc::cp_async_wait<0>();  // no copy outlives the block (the own rows with no tile)

  T* dq = static_cast<T*>(a.o1) + qbase;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = iw + tc::frag_row(e), c = col0 + 8 * n + tc::frag_col(e);
      if (i < a.Tq && c < D) dq[(size_t)i * D + c] = from_f<T>(acc[n][e]);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP, true>::NT, 1) flash_bwd_dkv_kernel(const Args a,
                                                                            bool aligned) {
  using C = Cfg<T, DP, true>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, TILE = C::TILE, NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* smem_t = reinterpret_cast<T*>(smem);
  T* ring = smem_t + C::OWN;
  float* rows = reinterpret_cast<float*>(smem + C::ROWS_OFF);  // per buffer: lse, delta
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + C::SCR_OFF) + warp * 16 * tc::kLdScratch;
  const int grp = warp / C::NWR;            // the warp's 16 keys
  const int col0 = (warp % C::NWR) * NTW * 8;  // and its output columns

  const int D = a.D, bh = blockIdx.y, j0 = blockIdx.x * BM;
  const int jw = j0 + 16 * grp;
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], a.Tk));
  const int nq = (a.Tq + BN - 1) / BN;
  // under the causal mask row i sees key j only from i = j on
  const int first = a.causal ? j0 / BN : 0;
  const int ntiles = j0 < kv_len ? max(0, nq - first) : 0;  // no live key: zeros
  const size_t qbase = (size_t)bh * a.Tq * D, kbase = (size_t)bh * a.Tk * D;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* dout = static_cast<const T*>(a.d_out) + qbase;

  float acc_k[NTW][4], acc_v[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  if (ntiles > 0) {
    const T* own = stage_own<C>(smem_t, static_cast<const T*>(a.k) + kbase,
                                static_cast<const T*>(a.v) + kbase, j0, kv_len, D, aligned);
    auto issue = [&](int t) {
      if (t < ntiles) {
        const int b = t % C::NSTAGE, r0 = (first + t) * BN;
        T* buf = ring + b * 2 * TILE;
        tc::stage<C::NT, DP>(buf, LD, q, D, r0, BN, 0, a.Tq, 0, D, aligned);
        tc::stage<C::NT, DP>(buf + TILE, LD, dout, D, r0, BN, 0, a.Tq, 0, D, aligned);
        float* st = rows + b * 2 * BN;  // read after the tile's barrier
        for (int e = threadIdx.x; e < BN; e += C::NT) {
          const int i = r0 + e;
          st[e] = i < a.Tq ? a.lse[(size_t)bh * a.Tq + i] : 0.f;
          st[BN + e] = i < a.Tq ? a.delta[(size_t)bh * a.Tq + i] : 0.f;
        }
      }
      tc::cp_async_commit();
    };
    issue(0);
    tc::AFrag<T> fk[C::AREG ? C::KS : 1], fv[C::AREG ? C::KS : 1];
    own_ready<C>(fk, fv, own, 16 * grp);
    const T* own_k = own + 16 * grp * LD;
    const T* own_v = own + (BM + 16 * grp) * LD;
    const int g = lane / 4, t2 = 2 * (lane % 4);

    for (int t = 0; t < ntiles; ++t) {
      tc::walk_wait<C::NSTAGE>([&] { issue(t + 1); });
      const T* sq = ring + (t % C::NSTAGE) * 2 * TILE;
      const T* sdo = sq + TILE;
      const float* s_lse = rows + (t % C::NSTAGE) * 2 * BN;
      const float* s_dl = s_lse + BN;
#pragma unroll 1
      for (int c = 0; c < BN / 16; ++c) {
        const int ic = (first + t) * BN + 16 * c;
        // warp-uniform: no live cell in the chunk
        if (ic >= a.Tq || jw >= kv_len || (a.causal && ic + 15 < jw)) continue;
        float s[2][4], dp[2][4];  // S^T and dP^T: rows keys, columns queries
        chunk_scores<T, C::KS, C::AREG>(s, dp, fk, fv, own_k, own_v, LD, sq + 16 * c * LD,
                                        sdo + 16 * c * LD, D);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = 16 * c + 8 * n + t2 + e % 2;
            const int j = jw + g + 8 * (e / 2), i = (first + t) * BN + il;
            const bool live = j < kv_len && i < a.Tq && (!a.causal || j <= i);
            cell_grads(a, bh, i, j, live, s[n][e], dp[n][e], s_lse[il], s_dl[il], s[n][e],
                       dp[n][e]);  // s becomes pd, dp becomes ds
          }
        tc::AFrag2<T> fa;
        tc::acc_to_a(fa, s[0], s[1], scratch);
        tc::mma_cols<NTW>(acc_v, fa, sdo + 16 * c * LD, LD, col0, D);  // dv += Pd^T . dO
        tc::acc_to_a(fa, dp[0], dp[1], scratch);
        tc::mma_cols<NTW>(acc_k, fa, sq + 16 * c * LD, LD, col0, D);   // dk += dS^T . Q
      }
      __syncthreads();
      if constexpr (C::NSTAGE == 1) issue(t + 1);  // (one buffer: the next tile)
    }
    tc::cp_async_wait<0>();
  }

  T* dk = static_cast<T*>(a.o1) + kbase;
  T* dv = static_cast<T*>(a.o2) + kbase;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jw + tc::frag_row(e), c = col0 + 8 * n + tc::frag_col(e);
      if (j >= a.Tk || c >= D) continue;
      dk[(size_t)j * D + c] = from_f<T>(acc_k[n][e]);
      dv[(size_t)j * D + c] = from_f<T>(acc_v[n][e]);
    }
}

template <typename T, int DP, bool DKV>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP, DKV>;
  void (*kernel)(const Args, bool) =
      DKV ? &flash_bwd_dkv_kernel<T, DP> : &flash_bwd_dq_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const bool aligned = tc::rows_aligned<T>(a.D, {a.q, a.k, a.v, a.d_out});
  const dim3 grid(((DKV ? a.Tk : a.Tq) + C::BM - 1) / C::BM, a.BH);
  kernel<<<grid, C::NT, C::BYTES, stream>>>(a, aligned);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(const Args& a, bool dkv, cudaStream_t stream) {
  return dkv ? launch_variant<T, DP, true>(a, stream) : launch_variant<T, DP, false>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, bool dkv, cudaStream_t stream) {
  if (a.D <= 96) return launch_dp<T, 96>(a, dkv, stream);
  if (a.D <= 128) return launch_dp<T, 128>(a, dkv, stream);
  if (a.D <= 256) return launch_dp<T, 256>(a, dkv, stream);
  return launch_dp<T, 768>(a, dkv, stream);
}

int run(int dtype, const Args& a, bool dkv, void* stream) {
  if (a.BH <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 || a.D > MAX_D ||
      a.BH % a.H != 0 || a.BH > 65535 || a.tq_pad < a.Tq || a.tk_pad < a.Tk || a.rate < 0.f ||
      a.rate >= 1.f)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(a, dkv, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(a, dkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared arguments: q, d_out (BH, Tq, D) and k, v (BH, Tk, D), contiguous,
// in one storage type; kv_lens (BH/H,) int32; lse and delta (BH, Tq)
// float32; D <= 768; causal 0 or 1; dropout rate in [0, 1) (0: none),
// keep_scale = 1/(1-rate) in float32, the seed, tq_pad = round_up(Tq, 128)
// and tk_pad = round_up(Tk, 128). Each returns the launch's cudaError_t.

// dq: (BH, Tq, D) in the input type.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* kv_lens, const void* lse, const void* delta,
                            const void* d_out, void* dq, int BH, int H, int Tq, int Tk, int D,
                            float scale, int causal, float rate, float keep_scale,
                            unsigned seed, int tq_pad, int tk_pad, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(kv_lens), static_cast<const float*>(lse),
               static_cast<const float*>(delta), d_out, dq, nullptr, BH, H, Tq, Tk, D, scale,
               causal, rate, keep_scale, seed, tq_pad, tk_pad};
  return run(dtype, a, false, stream);
}

// dk, dv: (BH, Tk, D) in the input type.
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* kv_lens, const void* lse, const void* delta,
                             const void* d_out, void* dk, void* dv, int BH, int H, int Tq,
                             int Tk, int D, float scale, int causal, float rate,
                             float keep_scale, unsigned seed, int tq_pad, int tk_pad,
                             void* stream) {
  const Args a{q, k, v, static_cast<const int*>(kv_lens), static_cast<const float*>(lse),
               static_cast<const float*>(delta), d_out, dk, dv, BH, H, Tq, Tk, D, scale,
               causal, rate, keep_scale, seed, tq_pad, tk_pad};
  return run(dtype, a, true, stream);
}
