// Relative-position flash attention, backward: the table gradient dpos from
// recomputed score tiles (FlashAttention-2 style), on the tensor cores.
//
// Replaces the TPU kernel `_rel_bwd_dpos_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_rel_core.core_bwd`),
// legacy=False and legacy=True. With scale = 1/sqrt(D), the forward's
// logsumexp lse[i] and delta[i] = rowsum(dO[i] * O[i]) (both (BH, T)
// float32, from the caller), for each live score (i, j < kv_len[b]):
//
//   s    = (q_u[i] . k[j] + band(i, j)) * scale
//   p    = exp(s - lse[i]),  dp = dO[i] . v[j]
//   pd   = keep(i, j) ? p / (1 - rate) : 0          (pd = p at rate 0)
//   ds   = (pd * dp - p * delta[i]) * scale          (as `_rel_block_grads`)
//
// and dpos is the band's adjoint, summed over the batch:
//   new style (H, 2T-1, D):  dpos[r] = sum_b sum_i ds(i, i+r-(T-1)) q_v[i]
//   legacy (H, T, D), D wide: dpos[p] = sum_b sum_i ds(i, i+p-(T-1)) q_v[i]
//                                     + sum_b sum_i ds(i, i+p+2) q_v[i+1]
// (band(i, j) as in csrc/rel_flash.cu; the legacy terms are its "lo" and
// "hi" slots, csrc/rel_flash_tiles.cuh: the hi term exists for p <= T-3
// and i+1 <= T-1 only, and cell j = i+1 has no band). keep(i, j) is the
// hash of csrc/common.cuh over the cell's global (query i, key j) with
// t_pad = round_up(T, 128): the forward kernel's mask, bit for bit.
//
// Design. A block (8 warps) owns BR = 16 table rows of one head, one m16
// tile of dpos, and walks, for the batch items of its group, "units": a
// query tile of BQ = 64 and one slot (new style: one; legacy: lo, then hi),
// whose cells (i, r) read the keys j = i + r - (T-1) (lo) or i + r + 2 (hi),
// a window of BQ + BR - 1 keys; only units whose window meets [0, kv_len)
// are walked. Each unit:
// 1. scores, in four subtiles of 16 queries: S = q_u . K_win^T and dP = dO .
//    V_win^T (16 x 32 each: the 31 keys the subtile's cells touch, skewed
//    by index, key window row u = (i - i_sub) + (r - r0)) and the band
//    q_v . pos^T over the block's own 16 rows (16 x 16, q_v rows i, or i+1
//    in the hi slot), as m16n8k16 products (bf16: mma.sync; float32: the
//    same fragments in FMA, tc::mma) over D in chunks of 128 bytes a row;
// 2. 16 x 16 threads recompute ds per cell from the fragments in shared
//    memory and write dS^T (16 rows x 64 queries) in the storage type;
// 3. dpos_rows += dS^T . q_v (the slot's rows) as mma of depth 64, q_v
//    staged at full width 16 rows at a time and read as a [k][n] operand
//    (ldmatrix.trans); each warp owns D/8 output columns (D = 768: 12
//    n-tiles, 48 float accumulator registers a thread).
// Staging is cp.async into a ring of NSTAGE = 2 buffers, rows padded 16
// bytes for conflict-free ldmatrix, as csrc/rel_flash_bwd_dq.cu. Each table
// row's sum over a group is one block's, in a fixed order; a second pass in
// the same call adds the groups' float32 partial sums in a fixed order:
// deterministic, no atomics.
//
// Bound: per live score 3D multiply-adds to recompute (q_u.k, the band,
// dO.v) and D for the output, against ~5*T*D inputs per head read once:
// bound by the tensor cores' rate. This version computes S and dP 2x wide
// (32 window keys for 16 table rows) and stages q_u, q_v, dO and the key
// windows from L2 once per 16-row block and batch item; wgmma, TMA and
// larger row tiles are later work.
#include <stdint.h>

#include <algorithm>

#include "rel_flash_tiles.cuh"

namespace {

using namespace s2s::rel;
using s2s::from_f;
namespace tc = s2s::tc;

constexpr int BR = 16;            // table rows a block owns: one m16 tile of dpos
constexpr int BQ = 64;            // queries a unit walks: four m16 subtiles
constexpr int NSUB = BQ / 16;     // subtiles, one per lower (and upper) warp
constexpr int KWIN = 80;          // key window rows staged (BQ + BR - 1 used)
constexpr int SUBW = 32;          // key window rows of a subtile (BR + 15 used)
constexpr int NSTAGE = 2;         // buffers of the cp.async ring
constexpr int LDS = SUBW + 1;     // float S / dP row: [query][key window row]
constexpr int LDB = BR + 1;       // float band row: [query][table row]
constexpr int NOUT = BQ / VK;     // output stages a unit: q_v, 16 rows each
constexpr int kDposSplit = 4;     // batch groups, at most
static_assert(NSUB == NWARP / 2, "one subtile per lower and per upper warp");
static_assert(KWIN >= BQ + BR - 1 && KWIN >= 16 * (NSUB - 1) + SUBW, "the window fits");

// batch groups for batch size B
int dpos_groups(int B) { return std::max(1, std::min(B, kDposSplit)); }

template <typename T, int NTW>
struct Layout {
  static constexpr int LDC = kLDC<T>;
  static constexpr int LDV = kCols<NTW> + tc::kPad<T>;
  static constexpr int LDP = BQ + tc::kPad<T>;  // dS^T row: [table row][query]
  // a score stage: q_u, q_v, dO, the key and value windows, the 16 table rows
  static constexpr int QU = 0, QV = BQ * LDC, DO = QV + BQ * LDC, K = DO + BQ * LDC,
                       V = K + KWIN * LDC, P = V + KWIN * LDC;
  static constexpr int SCORE = P + BR * LDC;
  static constexpr int BUF = SCORE > VK * LDV ? SCORE : VK * LDV;  // elements
  static constexpr int DS_OFF = NSTAGE * BUF * (int)sizeof(T);
  static constexpr int S_OFF = DS_OFF + BR * LDP * (int)sizeof(T);
  static constexpr int DP_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int BAND_OFF = DP_OFF + BQ * LDS * 4;
  static constexpr int ROW_OFF = BAND_OFF + BQ * LDB * 4;
  static constexpr int BYTES = ROW_OFF + 2 * BQ * 4;
};

struct Args {
  const void *qu, *qv, *k, *v, *pos, *dout;
  const int* kv_lens;
  const float *lse, *delta;
  float* partial;  // (n_split, H, n_tab, D) float32
  int B, H, L, D;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

// A position of the walk: batch item b, slot (0: new style or legacy lo,
// 1: legacy hi), query tile t of the live range [t, t1).
struct Unit {
  int b, slot, t, t1;
};

// the key of window row 0 for query tile start i0 and table row r0
__device__ __forceinline__ int window_key(int slot, int L, int i0, int r0) {
  return slot == 0 ? i0 + r0 - (L - 1) : i0 + r0 + 2;
}

// the query tiles of (b, slot) whose key window meets [0, kv_len)
__device__ __forceinline__ void live_tiles(const Args& a, int r0, Unit& u) {
  const int L = a.L, kv_len = max(0, min(a.kv_lens[u.b], L));
  const int n_t = (L + BQ - 1) / BQ;
  u.t = u.t1 = 0;
  if (kv_len == 0) return;
  // window keys [j, j + BQ + BR - 2] with j = window_key(slot, L, i0, r0)
  const int j_at0 = window_key(u.slot, L, 0, r0);  // j = j_at0 + i0
  const int first = -(BQ + BR - 2) - j_at0;        // least i0: j + BQ + BR - 2 >= 0
  const int end = kv_len - j_at0;                  // i0 < end: j < kv_len
  u.t = first <= 0 ? 0 : (first + BQ - 1) / BQ;
  u.t1 = end <= 0 ? 0 : min(n_t, (end + BQ - 1) / BQ);
}

// move u to the first live unit at or after it, in the order (b, slot, t);
// u.b >= B when the walk is done
template <bool LEGACY>
__device__ __forceinline__ void settle(const Args& a, int n_split, int r0, Unit& u) {
  while (u.b < a.B && u.t >= u.t1) {
    if (++u.slot == (LEGACY ? 2 : 1)) u.slot = 0, u.b += n_split;
    if (u.b < a.B) live_tiles(a, r0, u);
  }
}

template <typename T, int NTW, bool LEGACY>
__global__ void __launch_bounds__(NT, 1) rel_flash_bwd_dpos_kernel(Args a, int n_split,
                                                                   bool aligned) {
  using Ly = Layout<T, NTW>;
  constexpr int DK = kDK<T>, LDC = Ly::LDC, LDV = Ly::LDV, LDP = Ly::LDP;
  constexpr int DW = kCols<NTW>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  T* s_dst = reinterpret_cast<T*>(smem + Ly::DS_OFF);
  float* s_s = reinterpret_cast<float*>(smem + Ly::S_OFF);
  float* s_dp = reinterpret_cast<float*>(smem + Ly::DP_OFF);
  float* s_band = reinterpret_cast<float*>(smem + Ly::BAND_OFF);
  float* s_lse = reinterpret_cast<float*>(smem + Ly::ROW_OFF);
  float* s_delta = s_lse + BQ;

  const int L = a.L, D = a.D;
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y % a.H, group = blockIdx.y / a.H;
  const int tid = threadIdx.x, warp = tid / 32;
  const int sub = warp % NSUB;
  const bool lower = warp < NWARP / 2;
  const int n_tab = LEGACY ? L : 2 * L - 1;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)h * n_tab * D;

  const int nc = (D + DK - 1) / DK;
  const int nst = nc + NOUT;  // stages a unit

  auto issue = [&](const Unit& u, int s, int b) {
    T* buf = bufs + b * Ly::BUF;
    const int bh = u.b * a.H + h, i0 = u.t * BQ;
    const size_t base = (size_t)bh * L * D;
    const T* qv = static_cast<const T*>(a.qv) + base;
    if (s < nc) {
      const int kv_len = max(0, min(a.kv_lens[u.b], L));
      const int j = window_key(u.slot, L, i0, r0), d0 = s * DK;
      tc::stage<NT, DK>(buf + Ly::QU, LDC, static_cast<const T*>(a.qu) + base, D, i0, BQ, 0, L,
                        d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::QV, LDC, qv, D, i0 + u.slot, BQ, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::DO, LDC, static_cast<const T*>(a.dout) + base, D, i0, BQ, 0,
                        L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::K, LDC, static_cast<const T*>(a.k) + base, D, j, KWIN, 0,
                        kv_len, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::V, LDC, static_cast<const T*>(a.v) + base, D, j, KWIN, 0,
                        kv_len, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::P, LDC, pos, D, r0, BR, 0, n_tab, d0, D, aligned);
    } else {
      // the slot's q_v rows (i, or i+1 in the hi slot), 16 at a time
      tc::stage<NT, DW>(buf, LDV, qv, D, i0 + u.slot + (s - nc) * VK, VK, 0, L, 0, D, aligned);
    }
    tc::cp_async_commit();
  };

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // the ring, as csrc/rel_flash_bwd_dq.cu: stage c of the walk lives in
  // buffer c % NSTAGE; the issuing side runs NSTAGE - 1 stages ahead on its
  // own copy of the walk
  Unit nu{group, 0, 0, 0}, cu;
  if (nu.b < a.B) live_tiles(a, r0, nu);
  settle<LEGACY>(a, n_split, r0, nu);
  cu = nu;
  int next_s = 0, issued = 0;
  auto issue_next = [&]() {
    if (nu.b < a.B) {
      issue(nu, next_s, issued % NSTAGE);
      if (++next_s == nst) {
        next_s = 0;
        ++nu.t;
        settle<LEGACY>(a, n_split, r0, nu);
      }
    } else {
      tc::cp_async_commit();  // an empty group keeps the wait count uniform
    }
    ++issued;
  };
  for (int p = 0; p < NSTAGE - 1; ++p) issue_next();
  int n_done = 0;  // stages multiplied
  for (; cu.b < a.B; ++cu.t, settle<LEGACY>(a, n_split, r0, cu)) {
    const int bh = cu.b * a.H + h, i0 = cu.t * BQ;
    const int kv_len = max(0, min(a.kv_lens[cu.b], L));
    const int j_win = window_key(cu.slot, L, i0, r0);
    if (tid < BQ) {  // read after the score stages' barriers
      const int i = i0 + tid;
      s_lse[tid] = i < L ? a.lse[(size_t)bh * L + i] : 0.f;
      s_delta[tid] = i < L ? a.delta[(size_t)bh * L + i] : 0.f;
    }
    // lower warps: sc[0..3] S n-tiles 0-3 of subtile `sub` (A q_u), sc[4..5]
    // the band's (A q_v); upper warps: sc[0..3] dP's (A dO)
    float sc[6][4];
#pragma unroll
    for (int q = 0; q < 6; ++q) sc[q][0] = sc[q][1] = sc[q][2] = sc[q][3] = 0.f;

    for (int s = 0; s < nst; ++s) {
      issue_next();
      tc::cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      const T* buf = bufs + (n_done % NSTAGE) * Ly::BUF;

      if (s < nc) {
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
          const int k16 = ks * 16;
          const int row = sub * 16 * LDC + k16;  // the subtile's queries and window rows
          tc::AFrag<T> af;
          if (lower) {
            tc::load_a(af, buf + Ly::QU + row, LDC);
            tc::mma2<false>(sc[0], sc[1], af, buf + Ly::K + row, LDC);
            tc::mma2<false>(sc[2], sc[3], af, buf + Ly::K + row + 16 * LDC, LDC);
            tc::load_a(af, buf + Ly::QV + row, LDC);
            tc::mma2<false>(sc[4], sc[5], af, buf + Ly::P + k16, LDC);
          } else {
            tc::load_a(af, buf + Ly::DO + row, LDC);
            tc::mma2<false>(sc[0], sc[1], af, buf + Ly::V + row, LDC);
            tc::mma2<false>(sc[2], sc[3], af, buf + Ly::V + row + 16 * LDC, LDC);
          }
        }
        if (s == nc - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = sub * 16 + tc::frag_row(e), c = tc::frag_col(e);
#pragma unroll
            for (int q = 0; q < 4; ++q) (lower ? s_s : s_dp)[r * LDS + q * 8 + c] = sc[q][e];
            if (lower) {
#pragma unroll
              for (int q = 0; q < 2; ++q) s_band[r * LDB + q * 8 + c] = sc[4 + q][e];
            }
          }
          __syncthreads();
          // ds of table row rl against queries il = tid / 16 + 16 c, written
          // transposed, [table row][query], in the storage type
          const int rl = tid % 16;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int il = tid / 16 + 16 * c, i = i0 + il;
            const int u = il % 16 + rl, j = j_win + il + rl;  // the subtile's window row
            const bool valid = i < L && r0 + rl < n_tab && j >= 0 && j < kv_len;
            float pd, ds;
            cell_grads(a, s_s[il * LDS + u] + s_band[il * LDB + rl], s_dp[il * LDS + u],
                       s_lse[il], s_delta[il], valid, bh, i, j, pd, ds);
            s_dst[rl * LDP + il] = from_f<T>(ds);
          }
        }
      } else {
        // dpos_rows += dS^T . q_v over 16 queries a stage
        tc::AFrag<T> af;
        tc::load_a(af, s_dst + (s - nc) * VK, LDP);
        tc::mma_cols<NTW>(acc, af, buf, LDV, warp * NTW * 8, D);
      }
      __syncthreads();
      ++n_done;
    }
  }

  float* part = a.partial + ((size_t)group * a.H + h) * n_tab * D;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int col0 = (warp * NTW + n) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + tc::frag_row(e), c = col0 + tc::frag_col(e);
      if (r < n_tab && c < D) part[(size_t)r * D + c] = acc[n][e];
    }
  }
}

// dpos = the groups' partial sums added in a fixed order
template <typename T>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dpos_sum_kernel(const float* __restrict__ partial,
                                                                    T* __restrict__ dpos,
                                                                    int n_split, size_t n) {
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n; e += (size_t)gridDim.x * NT) {
    float s = 0.f;
    for (int g = 0; g < n_split; ++g) s += partial[(size_t)g * n + e];
    dpos[e] = from_f<T>(s);
  }
}

template <typename T, int NTW, bool LEGACY>
cudaError_t launch_variant(const Args& a, void* dpos, cudaStream_t stream) {
  auto kernel = rel_flash_bwd_dpos_kernel<T, NTW, LEGACY>;
  constexpr int bytes = Layout<T, NTW>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned<T>(a.D, {a.qu, a.qv, a.k, a.v, a.pos, a.dout});
  const int n_split = dpos_groups(a.B), n_tab = LEGACY ? a.L : 2 * a.L - 1;
  kernel<<<dim3((n_tab + BR - 1) / BR, a.H * n_split), NT, bytes, stream>>>(a, n_split,
                                                                            aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)a.H * n_tab * a.D;
  const unsigned blocks = (unsigned)std::min<size_t>((n + NT - 1) / NT, 4096);
  rel_flash_bwd_dpos_sum_kernel<T><<<blocks, NT, 0, stream>>>(a.partial, static_cast<T*>(dpos),
                                                              n_split, n);
  return cudaGetLastError();
}

template <typename T, int NTW>
cudaError_t launch_ntw(const Args& a, void* dpos, bool legacy, cudaStream_t stream) {
  return legacy ? launch_variant<T, NTW, true>(a, dpos, stream)
                : launch_variant<T, NTW, false>(a, dpos, stream);
}

template <typename T>
cudaError_t launch(const Args& a, void* dpos, bool legacy, cudaStream_t stream) {
  // NTW = output n-tiles a warp owns: D <= 64 * NTW
  if (a.D <= 64) return launch_ntw<T, 1>(a, dpos, legacy, stream);
  if (a.D <= 192) return launch_ntw<T, 3>(a, dpos, legacy, stream);
  if (a.D <= 384) return launch_ntw<T, 6>(a, dpos, legacy, stream);
  if (a.D <= 768) return launch_ntw<T, 12>(a, dpos, legacy, stream);
  if (a.D <= 1024) return launch_ntw<T, 16>(a, dpos, legacy, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The kernel's number of batch groups for batch size B: the first dimension
// of its float32 scratch.
extern "C" int rel_flash_bwd_dpos_groups(int B) { return dpos_groups(B); }

// q_u, q_v, k, v, dout: (B*H, L, D) contiguous, in the storage type `dtype`;
// pos: (H, 2L-1, D), or with `legacy` the legacy table (H, L, D); kv_lens
// (B,) int32; lse, delta (B*H, L) float32; scale = 1/sqrt(D); dropout rate
// in [0, 1) (0: none), keep_scale = 1/(1-rate) in float32, the seed, t_pad =
// round_up(L, 128). Output dpos, pos's shape in the storage type, every
// element written; partial: (rel_flash_bwd_dpos_groups(B), pos's shape)
// float32 scratch. D <= 1024. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int rel_flash_bwd_dpos(int dtype, const void* qu, const void* qv, const void* k,
                                  const void* v, const void* pos, const void* kv_lens,
                                  const void* lse, const void* delta, const void* dout,
                                  void* dpos, void* partial, int B, int H, int L, int D,
                                  int legacy, float scale, float rate, float keep_scale,
                                  unsigned seed, int t_pad, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || H * dpos_groups(B) > 65535 || t_pad < L ||
      rate < 0.f || rate >= 1.f)
    return cudaErrorInvalidValue;
  const Args a{qu, qv, k, v, pos, dout, static_cast<const int*>(kv_lens),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<float*>(partial), B, H, L, D, scale, rate, keep_scale, seed, t_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(a, dpos, legacy != 0, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(a, dpos, legacy != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}
