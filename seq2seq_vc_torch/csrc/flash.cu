// Standard multi-head flash attention, forward, with a key-length mask, an
// optional causal mask, in-kernel attention dropout and the saved
// logsumexp, on the tensor cores.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_flash_core.fwd_impl`,
// entry `flash_attention`):
//
//   s[i, j] = q[i] . k[j] * scale
//   live(i, j) = j < kv_len[b]  and, when causal, j <= i
//   p[i, j] = exp(s[i, j] - max) / sum over the live keys of row i
//   out[i]  = sum_j keep(i, j) * p[i, j] / (1 - rate) * v[j]
//   lse[i]  = logsumexp of row i's live scores (-1e30 for a row with no
//             live key, whose output is 0)
//
// q is (BH, Tq, D) and k, v are (BH, Tk, D): the query and key lengths may
// differ (cross shapes); the causal rule is j <= i in global indices. Dropout
// acts on the normalised weights (the row sum is taken before the drop);
// keep(i, j) is the shared hash of csrc/common.cuh with the JAX package's
// padded lengths round_up(Tq, 128) and round_up(Tk, 128) in the index, so
// the backward kernels of csrc/flash_bwd.cu draw the same mask.
//
// Design (FlashAttention-2's forward on mma.sync, csrc/mma_tiles.cuh). The
// TPU kernel walks a sequential grid axis over kv blocks with its running
// max, sum and accumulator in VMEM scratch, its head dim padded to 128 lanes
// and its logsumexp broadcast over 128 lanes. Here blocks run in parallel
// and the walk is a loop inside a block; D is padded only to the next of
// 64, 96, 128, 256 (a template parameter, DP), and the logsumexp is one
// float a row.
// - A block of 4 warps owns BM = 64 query rows of one (b, h), 16 a warp,
//   and walks the key tiles of BN = 64 up to kv_len (under the causal mask
//   up to its last row). A warp skips a 16-key chunk in which no cell is
//   live (past kv_len, or wholly above the causal diagonal).
// - K and V tiles come in by cp.async into a ring of two buffers, in the
//   storage type, rows padded 16 bytes. In bf16 at DP <= 128 each warp holds
//   its 16 q rows as A fragments in registers for the whole walk (q is
//   staged into ring buffer 1 and moved to registers before the walk needs
//   it); at DP 256 it reads them from shared memory each k-step.
// - S = q . K^T for the tile's live chunks (tc::mma2), then the online
//   softmax in registers: a row's cells of a 16 x 64 tile lie in the 4
//   lanes of a quad, so its max takes two __shfl_xor_sync steps; the
//   running max is kept in log2 units, so a weight is one FFMA and one
//   exp2f. A masked cell gets an explicit zero. Each lane keeps the partial
//   sums of its own cells, reduced over the quad once at the end. The
//   dropout keep bit is drawn per live cell on the global (i, j), its hash
//   argument built from a per-row part and compared with an integer
//   threshold (csrc/common.cuh: the bits of dropout_keep); 1/(1 - rate) is
//   applied once to the output.
// - O = alpha . O + P . V: a 16 x 16 chunk of P is packed into A fragments
//   (tc::acc_to_a) and V is read as a [k][n] operand (ldmatrix.trans). P
//   goes in as hi + lo, two bf16 fragments (tc::AFrag2): rounded once to
//   bf16 (2^-9 relative), it broke the forward's bf16 tolerance in an
//   emulation of the causal T 640 checks, where rows near the diagonal
//   weigh a few keys heavily and the output can cancel.
// - At DP 256 a warp cannot hold 16 full-width output rows (128
//   accumulators a lane) beside its 64 scores without spilling, so the
//   output columns are split over two warps per 16 rows (8 warps a block),
//   each computing the same scores. float32 at DP 256 halves the tiles (BM =
//   BN = 32) to fit shared memory.
// - float32 (the card's reference path, no TF32) runs the same tiling in FMA
//   on the CUDA cores. The shared FMA fragments of mma_tiles.cuh read about
//   one shared-memory float per FMA, which bounds them; this kernel's
//   float32 products read their operands as float4 (scores: a lane's two q
//   rows and two key rows, four k at a time) and hold a P chunk's two rows in
//   registers across all output columns, about one shared-memory load per
//   five FMAs.
// No atomics: every output element has one owner, so the kernel is
// deterministic. Dropout and the logsumexp are template parameters, so the
// serving variant (rate 0, no lse) compiles without them.
//
// Bound: per (b, h) 2 * live scores * D multiply-adds (scores and P.V)
// against ~(2 Tq + 2 keys) * D inputs read once, so at the main path's
// shapes the card's tensor-core rate bounds it. This version issues
// mma.sync from a cp.async ring; wgmma, TMA and persistent blocks are later
// work.
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using s2s::from_f;
namespace tc = s2s::tc;

constexpr int MAX_D = 256;
constexpr int NSTAGE = 2;          // buffers of the cp.async ring
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v;
  const int* kv_lens;
  void* out;
  float* lse;
  int BH, H, Tq, Tk, D;
  float scale;
  int causal;
  float rate, keep_scale;
  unsigned seed;
  int tq_pad, tk_pad;
};

// The tiling of one variant: storage type T, head dim padded to DP.
template <typename T, int DP>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WM = (F32 && DP > 128) ? 2 : 4;  // 16-row groups a block owns
  static constexpr int NWR = DP > 128 ? 2 : 1;          // warps a group, splitting columns
  static constexpr int NW = WM * NWR, NT = 32 * NW;
  static constexpr int BM = 16 * WM;                      // query rows a block
  static constexpr int BN = (F32 && DP > 128) ? 32 : 64;  // keys a tile
  static constexpr int NS = BN / 8;                       // score n-tiles of a tile
  static constexpr int NTW = DP / 8 / NWR;                // output n-tiles a warp owns
  static constexpr int KS = DP / 16;                      // k-steps of the score product
  static constexpr bool AREG = !F32 && DP <= 128;         // q rows in registers
  static constexpr int LD = DP + tc::kPad<T>;             // staged row, elements
  static constexpr int TILE = BN * LD;                    // one of K, V
  // elements of T: the q rows (none with AREG: they are staged into ring
  // buffer 1 and moved to registers before the walk needs it), the ring
  static constexpr int OWN = AREG ? 0 : BM * LD;
  // then float: a 16 x 16 scratch per warp (float32's P chunk)
  static constexpr int SCR_OFF = (OWN + NSTAGE * 2 * TILE) * (int)sizeof(T);
  static constexpr int BYTES = SCR_OFF + (F32 ? NW * 16 * tc::kLdScratch * 4 : 0);
  static_assert(!AREG || 2 * TILE >= BM * LD, "q rows fit in ring buffer 1");
  static_assert(NS <= 8 && NTW % 2 == 0, "a 32-bit cell mask and n-tile pairs");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// s[n] = q . K^T, n-tiles 2c and 2c+1 for each live 16-key chunk c (bit c
// of `live`); the warp's 16 q rows are fragments `fq` (AREG) or rows at
// `own`, the tile's keys rows at `sk`.
template <typename C>
__device__ __forceinline__ void tile_scores(float s[C::NS][4], const tc::AFrag<__nv_bfloat16>* fq,
                                            const __nv_bfloat16* own,
                                            const __nv_bfloat16* sk, int D, unsigned live) {
#pragma unroll
  for (int n = 0; n < C::NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    if (16 * ks >= D) break;  // staged zeros past D
    tc::AFrag<__nv_bfloat16> af;
    if constexpr (C::AREG)
      af = fq[ks];
    else
      tc::load_a(af, own + 16 * ks, C::LD);
#pragma unroll
    for (int c = 0; c < C::NS / 2; ++c)
      if (live >> c & 1u)
        tc::mma2<false>(s[2 * c], s[2 * c + 1], af, sk + 16 * c * C::LD + 16 * ks, C::LD);
  }
}
// float32: the same cells in FMA, operands read as float4 (lane l: q rows
// l/4 and l/4 + 8, key rows 2(l%4) and 2(l%4) + 1 of each n-tile)
template <typename C>
__device__ __forceinline__ void tile_scores(float s[C::NS][4], const tc::AFrag<float>*,
                                            const float* own, const float* sk, int D,
                                            unsigned live) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < C::NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {  // staged zeros up to a multiple of 4 past D
    const float4 a0 = *reinterpret_cast<const float4*>(own + g * C::LD + k);
    const float4 a1 = *reinterpret_cast<const float4*>(own + (g + 8) * C::LD + k);
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      if (!(live >> (n / 2) & 1u)) continue;
      const float4 b0 = *reinterpret_cast<const float4*>(sk + (8 * n + t2) * C::LD + k);
      const float4 b1 = *reinterpret_cast<const float4*>(sk + (8 * n + t2 + 1) * C::LD + k);
      float* c = s[n];
      c[0] = fmaf(a0.x, b0.x, c[0]); c[1] = fmaf(a0.x, b1.x, c[1]);
      c[2] = fmaf(a1.x, b0.x, c[2]); c[3] = fmaf(a1.x, b1.x, c[3]);
      c[0] = fmaf(a0.y, b0.y, c[0]); c[1] = fmaf(a0.y, b1.y, c[1]);
      c[2] = fmaf(a1.y, b0.y, c[2]); c[3] = fmaf(a1.y, b1.y, c[3]);
      c[0] = fmaf(a0.z, b0.z, c[0]); c[1] = fmaf(a0.z, b1.z, c[1]);
      c[2] = fmaf(a1.z, b0.z, c[2]); c[3] = fmaf(a1.z, b1.z, c[3]);
      c[0] = fmaf(a0.w, b0.w, c[0]); c[1] = fmaf(a0.w, b1.w, c[1]);
      c[2] = fmaf(a1.w, b0.w, c[2]); c[3] = fmaf(a1.w, b1.w, c[3]);
    }
  }
}

// acc[n] += P . V[:, col0 + 8n, +8) for the 16 keys of one chunk, V rows at
// `vc` ([k][n]), P the chunk as an A operand
template <typename C>
__device__ __forceinline__ void chunk_pv(float acc[C::NTW][4],
                                         const tc::AFrag2<__nv_bfloat16>& p,
                                         const __nv_bfloat16* vc, int col0, int D) {
  tc::mma_cols<C::NTW>(acc, p, vc, C::LD, col0, D);
}
// float32: the lane's two P rows (16 keys each) held in registers across
// every n-tile, V as float2 (columns 2(l%4), +1)
template <typename C>
__device__ __forceinline__ void chunk_pv(float acc[C::NTW][4], const tc::AFrag2<float>& p,
                                         const float* vc, int col0, int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
  float a0[16], a1[16];
#pragma unroll
  for (int k = 0; k < 16; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(p.hi.p + g * p.hi.ld + k);
    const float4 x1 = *reinterpret_cast<const float4*>(p.hi.p + (g + 8) * p.hi.ld + k);
    a0[k] = x0.x, a0[k + 1] = x0.y, a0[k + 2] = x0.z, a0[k + 3] = x0.w;
    a1[k] = x1.x, a1[k + 1] = x1.y, a1[k + 2] = x1.z, a1[k + 3] = x1.w;
  }
#pragma unroll
  for (int n = 0; n < C::NTW; ++n) {
    if (col0 + 8 * n >= D) continue;
    float* c = acc[n];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float2 b = *reinterpret_cast<const float2*>(vc + k * C::LD + col0 + 8 * n + t2);
      c[0] = fmaf(a0[k], b.x, c[0]);
      c[1] = fmaf(a0[k], b.y, c[1]);
      c[2] = fmaf(a1[k], b.x, c[2]);
      c[3] = fmaf(a1[k], b.y, c[3]);
    }
  }
}

template <typename T, int DP, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(Cfg<T, DP>::NT, 1) flash_fwd_kernel(const Args a,
                                                                     bool aligned) {
  using C = Cfg<T, DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, TILE = C::TILE, NS = C::NS, NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* smem_t = reinterpret_cast<T*>(smem);
  T* ring = smem_t + C::OWN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + C::SCR_OFF) + warp * 16 * tc::kLdScratch;
  const int grp = warp / C::NWR;                  // the warp's 16 rows
  const int col0 = (warp % C::NWR) * NTW * 8;     // and its output columns

  const int D = a.D, bh = blockIdx.y, i0 = blockIdx.x * BM;
  const int iw = i0 + 16 * grp;  // the warp's first row
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], a.Tk));
  const int kv_end = a.causal ? min(kv_len, i0 + BM) : kv_len;  // keys the block sees
  const int ntiles = (kv_end + BN - 1) / BN;
  const size_t qbase = (size_t)bh * a.Tq * D, kbase = (size_t)bh * a.Tk * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  // the q rows: ring buffer 1 with AREG (free until the walk's second
  // tile), else their own region
  T* own = C::AREG ? ring + 2 * TILE : smem_t;
  tc::stage<C::NT, DP>(own, LD, static_cast<const T*>(a.q) + qbase, D, i0, BM, 0, a.Tq, 0, D,
                       aligned);
  tc::cp_async_commit();
  auto issue = [&](int t) {
    if (t < ntiles) {
      T* buf = ring + (t % NSTAGE) * 2 * TILE;
      tc::stage<C::NT, DP>(buf, LD, k, D, t * BN, BN, 0, kv_end, 0, D, aligned);
      tc::stage<C::NT, DP>(buf + TILE, LD, v, D, t * BN, BN, 0, kv_end, 0, D, aligned);
    }
    tc::cp_async_commit();  // an empty group keeps the wait count uniform
  };
  issue(0);
  tc::AFrag<T> fq[C::AREG ? C::KS : 1];
  if constexpr (C::AREG) {
    tc::cp_async_wait<1>();  // the q rows' group (the first tile may be in flight)
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) tc::load_a(fq[ks], own + 16 * grp * LD + 16 * ks, LD);
    __syncthreads();  // ring buffer 1 is free for the walk
  }
  const T* own_q = own + 16 * grp * LD;

  // this thread's rows: l/4 and l/4 + 8 of the warp's 16 (h = 0, 1)
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const float sl = a.scale * kLog2e;  // raw scores to log2 units
  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running max (log2 units), quad-uniform
  float l_run[2] = {0.f, 0.f};          // this lane's part of the running sum
  // the dropout hash's argument idx * kMixMul + seed, idx = (bh * tq_pad +
  // i) * tk_pad + j, as a row part (per h) plus j * kMixMul, and its
  // threshold (csrc/common.cuh: the same bits as dropout_keep)
  unsigned hrow[2] = {0u, 0u}, thr = 0u;
  if constexpr (DROPOUT) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hrow[h] = ((unsigned)bh * (unsigned)a.tq_pad + (unsigned)(iw + g + 8 * h)) *
                    (unsigned)a.tk_pad * s2s::kMixMul + a.seed;
    thr = s2s::dropout_threshold(a.rate);
  }

  for (int t = 0; t < ntiles; ++t) {
    issue(t + 1);
    tc::cp_async_wait<1>();
    __syncthreads();
    const T* sk = ring + (t % NSTAGE) * 2 * TILE;
    const T* sv = sk + TILE;
    const int j0 = t * BN;
    unsigned live = 0;  // warp-uniform: chunks with a live cell
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const int jc = j0 + 16 * c;
      if (jc < kv_len && iw < a.Tq && (!a.causal || jc <= iw + 15)) live |= 1u << c;
    }
    if (live) {
      float s[NS][4];
      tile_scores<C>(s, fq, own_q, sk, D, live);
      unsigned ok = 0;  // cell (n, e) live: bit 4n + e
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = iw + g + 8 * (e / 2), j = j0 + 8 * n + t2 + e % 2;
          const bool on = (live >> (n / 2) & 1u) && j < kv_len && (!a.causal || j <= i);
          ok |= (unsigned)on << (4 * n + e);
          if (on) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // in log2 units (sl > 0); a row with no live cell keeps its max
        const float m_new = fmaxf(m_run[h], mx[h] == kNegInf ? kNegInf : mx[h] * sl);
        alpha[h] = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // explicit zero for a masked cell, whose raw score is still in s
          const bool on = ok >> (4 * n + e) & 1u;
          float p = on ? exp2f(fmaf(s[n][e], sl, -m_run[e / 2])) : 0.f;
          l_run[e / 2] += p;  // the row sum is taken before the drop
          if constexpr (DROPOUT) {
            const unsigned j = (unsigned)(j0 + 8 * n + t2 + e % 2);
            if (s2s::fmix32(hrow[e / 2] + j * s2s::kMixMul) < thr) p = 0.f;
          }
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        if (!(live >> c & 1u)) continue;
        tc::AFrag2<T> fp;
        tc::acc_to_a(fp, s[2 * c], s[2 * c + 1], scratch);
        chunk_pv<C>(acc, fp, sv + 16 * c * LD, col0, D);  // O += P . V
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  tc::cp_async_wait<0>();  // no copy outlives the block (the q rows with no tile)

  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l_run[h] + __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float keep = DROPOUT ? a.keep_scale : 1.f;
  const float inv[2] = {l[0] > 0.f ? keep / l[0] : 0.f, l[1] > 0.f ? keep / l[1] : 0.f};
  T* out = static_cast<T*>(a.out) + qbase;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = iw + tc::frag_row(e), c = col0 + 8 * n + tc::frag_col(e);
      if (i < a.Tq && c < D) out[(size_t)i * D + c] = from_f<T>(acc[n][e] * inv[e / 2]);
    }
  if constexpr (LSE) {
    if (warp % C::NWR == 0 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = iw + g + 8 * h;
        if (i < a.Tq)
          a.lse[(size_t)bh * a.Tq + i] = l[h] > 0.f ? (m_run[h] + log2f(l[h])) * kLn2 : kNegInf;
      }
    }
  }
}

template <typename T, int DP, bool DROPOUT, bool LSE>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  void (*kernel)(const Args, bool) = &flash_fwd_kernel<T, DP, DROPOUT, LSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  const bool aligned = tc::rows_aligned<T>(a.D, {a.q, a.k, a.v});
  const dim3 grid((a.Tq + C::BM - 1) / C::BM, a.BH);
  kernel<<<grid, C::NT, C::BYTES, stream>>>(a, aligned);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(const Args& a, cudaStream_t stream) {
  if (a.lse == nullptr)
    return a.rate > 0.f ? launch_variant<T, DP, true, false>(a, stream)
                        : launch_variant<T, DP, false, false>(a, stream);
  return a.rate > 0.f ? launch_variant<T, DP, true, true>(a, stream)
                      : launch_variant<T, DP, false, true>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_dp<T, 64>(a, stream);
  if (a.D <= 96) return launch_dp<T, 96>(a, stream);
  if (a.D <= 128) return launch_dp<T, 128>(a, stream);
  return launch_dp<T, 256>(a, stream);
}

}  // namespace

// q: (BH, Tq, D), k, v: (BH, Tk, D), contiguous; kv_lens: (BH/H,) int32 on
// the device; out: (BH, Tq, D) in the input type; lse: (BH, Tq) float32, or
// null for none. D <= 256. causal: 0 or 1. Dropout: rate in [0, 1) (0:
// none), keep_scale = 1/(1-rate) in float32, the seed, tq_pad =
// round_up(Tq, 128) and tk_pad = round_up(Tk, 128) for the hash index.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* kv_lens, void* out, void* lse, int BH, int H, int Tq,
                         int Tk, int D, float scale, int causal, float rate, float keep_scale,
                         unsigned seed, int tq_pad, int tk_pad, void* stream) {
  if (BH <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > MAX_D || BH % H != 0 ||
      BH > 65535 || tq_pad < Tq || tk_pad < Tk || rate < 0.f || rate >= 1.f)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(kv_lens), out, static_cast<float*>(lse),
               BH, H, Tq, Tk, D, scale, causal, rate, keep_scale, seed, tq_pad, tk_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(a, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
