// Relative-position flash attention, backward: dk and dv from recomputed
// score tiles (FlashAttention-2 style), on the tensor cores.
//
// Replaces the TPU kernel `_rel_bwd_dkv_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_rel_core.core_bwd`),
// legacy=False and legacy=True. With scale = 1/sqrt(D), the forward's
// logsumexp lse[i] and delta[i] = rowsum(dO[i] * O[i]) (both (BH, T)
// float32, from the caller), for each live score (i, j < kv_len[b]):
//
//   s    = (q_u[i] . k[j] + band(i, j)) * scale
//   p    = exp(s - lse[i]),  dp = dO[i] . v[j]
//   pd   = keep(i, j) ? p / (1 - rate) : 0          (pd = p at rate 0)
//   ds   = (pd * dp - p * delta[i]) * scale          (as `_rel_block_grads`)
//   dk[j] = sum_i ds q_u[i],   dv[j] = sum_i pd dO[i]
//
// band(i, j) as in csrc/rel_flash.cu: new style q_v[i] . pos[T-1-i+j];
// legacy, D wide on the (H, T, D) table, q_v[i] . pos[T-1-i+j] for j <= i,
// 0 for j = i+1, q_v[i+1] . pos[j-i-2] for j >= i+2 (the "slots" of
// csrc/rel_flash_tiles.cuh). dk and dv do not depend on the slot, so the
// legacy form adds only a second table window on tiles that straddle the
// diagonal. keep(i, j) is the hash of csrc/common.cuh over the cell's global
// (query i, key j) with t_pad = round_up(T, 128): the forward kernel's mask,
// bit for bit.
//
// Design. A block (8 warps) owns BK = 16 keys, one m16 tile of the outputs,
// and walks the query tiles of BQ = 64 up to T; a key block at or past
// kv_len writes zeros at once. Each tile:
// 1. scores, query-major in four subtiles of 16 queries: S = q_u . K^T and
//    dP = dO . V^T (16 x 16 each, the lower four warps, one subtile each)
//    and, per band slot, raw = q_v . W^T (16 x 32: the 31 table rows the
//    subtile's cells touch, the upper four warps), as m16n8k16 products
//    (bf16: mma.sync; float32: the same fragments in FMA, tc::mma) over D in
//    chunks of 128 bytes a row. The band is skewed by index in shared memory
//    (window row w = j - i + 15 within a subtile's 32);
// 2. 16 x 16 threads recompute (pd, ds) per cell from the fragments in
//    shared memory and write Pd^T and dS^T (16 keys x 64 queries) in the
//    storage type: the transpose is free, in the writes' indices;
// 3. dv += Pd^T . dO and dk += dS^T . q_u as mma of depth 64, dO and q_u
//    staged at full width 16 query rows at a time, read as [k][n] operands
//    (ldmatrix.trans); each warp owns D/8 output columns (D = 768: 12
//    n-tiles, 2 x 48 float accumulator registers a thread).
// Staging is cp.async into a ring of NSTAGE = 2 buffers, rows padded 16
// bytes for conflict-free ldmatrix, as csrc/rel_flash_bwd_dq.cu. Pd and dS
// go to the tensor cores in the storage type (bf16: one rounding, 2^-9
// relative, of each weight).
//
// Bound: per live score 3D multiply-adds to recompute (q_u.k, the band,
// dO.v) and 2D for the outputs, against ~5*T*D inputs per head read once:
// bound by the tensor cores' rate. This version computes the band 2x wide
// (32 window rows for 16 keys), stages q_u, q_v, dO and the window from L2
// once per 16-key block and dO and q_u a second time for the outputs; wgmma,
// TMA and larger key tiles are later work.
#include <stdint.h>

#include "rel_flash_tiles.cuh"

namespace {

using namespace s2s::rel;
using s2s::from_f;
namespace tc = s2s::tc;

constexpr int BK = 16;            // keys a block owns: one m16 tile of dk, dv
constexpr int BQ = 64;            // queries a tile walks: four m16 subtiles
constexpr int NSUB = BQ / 16;     // subtiles, one per lower (and upper) warp
constexpr int SUBW = 32;          // window rows of a subtile's band (BK + 15 used)
constexpr int NSTAGE = 2;         // buffers of the cp.async ring
constexpr int LDS = BK + 1;       // float S / dP row: [query][key]
constexpr int LDR = SUBW + 1;     // float raw band row: [slot][query][window row]
constexpr int NOUT = 2 * BQ / VK; // output stages a tile: dO, then q_u, 16 rows each
static_assert(NSUB == NWARP / 2, "one subtile per lower and per upper warp");
static_assert(WINR >= BQ + BK - 1, "a tile's window fits the staged rows");

template <typename T, int NTW>
struct Layout {
  static constexpr int LDC = kLDC<T>;
  static constexpr int LDV = kCols<NTW> + tc::kPad<T>;
  static constexpr int LDP = BQ + tc::kPad<T>;  // Pd^T, dS^T row: [key][query]
  // a score stage: q_u, q_v (BQ + 1 rows), dO, K, V, two table windows
  static constexpr int QU = 0, QV = BQ * LDC, DO = QV + (BQ + 1) * LDC, K = DO + BQ * LDC,
                       V = K + BK * LDC, W = V + BK * LDC;
  static constexpr int SCORE = W + 2 * WINR * LDC;
  static constexpr int BUF = SCORE > VK * LDV ? SCORE : VK * LDV;  // elements
  static constexpr int PD_OFF = NSTAGE * BUF * (int)sizeof(T);
  static constexpr int DS_OFF = PD_OFF + BK * LDP * (int)sizeof(T);
  static constexpr int S_OFF = DS_OFF + BK * LDP * (int)sizeof(T);
  static constexpr int DP_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int RAW_OFF = DP_OFF + BQ * LDS * 4;
  static constexpr int ROW_OFF = RAW_OFF + 2 * BQ * LDR * 4;
  static constexpr int BYTES = ROW_OFF + 2 * BQ * 4;
};

struct Args {
  const void *qu, *qv, *k, *v, *pos, *dout;
  const int* kv_lens;
  const float *lse, *delta;
  void *dk, *dv;
  int B, H, L, D;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

template <typename T, int NTW, bool LEGACY>
__global__ void __launch_bounds__(NT, 1) rel_flash_bwd_dkv_kernel(Args a, bool aligned) {
  using Ly = Layout<T, NTW>;
  constexpr int DK = kDK<T>, LDC = Ly::LDC, LDV = Ly::LDV, LDP = Ly::LDP;
  constexpr int DW = kCols<NTW>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  T* s_pdt = reinterpret_cast<T*>(smem + Ly::PD_OFF);
  T* s_dst = reinterpret_cast<T*>(smem + Ly::DS_OFF);
  float* s_s = reinterpret_cast<float*>(smem + Ly::S_OFF);
  float* s_dp = reinterpret_cast<float*>(smem + Ly::DP_OFF);
  float* s_raw = reinterpret_cast<float*>(smem + Ly::RAW_OFF);
  float* s_lse = reinterpret_cast<float*>(smem + Ly::ROW_OFF);
  float* s_delta = s_lse + BQ;

  const int L = a.L, D = a.D;
  const int j0 = blockIdx.x * BK;
  const int bh = blockIdx.y, h = bh % a.H;
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], L));
  const int tid = threadIdx.x, warp = tid / 32;
  const int sub = warp % NSUB;
  const bool lower = warp < NWARP / 2;
  const int n_tab = LEGACY ? L : 2 * L - 1;
  const size_t base = (size_t)bh * L * D;
  const T* qu = static_cast<const T*>(a.qu) + base;
  const T* qv = static_cast<const T*>(a.qv) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)h * n_tab * D;

  const int nc = (D + DK - 1) / DK;
  const int nst = nc + NOUT;                                  // stages a tile
  const int ntiles = j0 < kv_len ? (L + BQ - 1) / BQ : 0;     // no live key: zeros

  auto issue = [&](int t, int s, int b) {
    T* buf = bufs + b * Ly::BUF;
    const int i0 = t * BQ;
    if (s < nc) {
      const Slots sl = tile_slots<BQ, BK>(LEGACY, L, i0, j0);
      const int d0 = s * DK;
      tc::stage<NT, DK>(buf + Ly::QU, LDC, qu, D, i0, BQ, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::QV, LDC, qv, D, i0, LEGACY ? BQ + 1 : BQ, 0, L, d0, D,
                        aligned);
      tc::stage<NT, DK>(buf + Ly::DO, LDC, dout, D, i0, BQ, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::K, LDC, k, D, j0, BK, 0, kv_len, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::V, LDC, v, D, j0, BK, 0, kv_len, d0, D, aligned);
      for (int q = 0; q < sl.n; ++q)
        tc::stage<NT, DK>(buf + Ly::W + q * WINR * LDC, LDC, pos, D, sl.row0[q], WINR, 0,
                          n_tab, d0, D, aligned);
    } else {
      const int o = s - nc;  // dO rows, then q_u rows, 16 at a time
      tc::stage<NT, DW>(buf, LDV, o < NOUT / 2 ? dout : qu, D, i0 + (o % (NOUT / 2)) * VK, VK,
                        0, L, 0, D, aligned);
    }
    tc::cp_async_commit();
  };

  float acc_k[NTW][4], acc_v[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // the ring: stage c of the walk (tile t, stage s) lives in buffer c % NSTAGE;
  // NSTAGE - 1 stages load ahead of the one being multiplied
  int next_t = 0, next_s = 0, issued = 0;
  auto issue_next = [&]() {
    if (next_t < ntiles) {
      issue(next_t, next_s, issued % NSTAGE);
      if (++next_s == nst) next_s = 0, ++next_t;
    } else {
      tc::cp_async_commit();  // an empty group keeps the wait count uniform
    }
    ++issued;
  };
  for (int p = 0; p < NSTAGE - 1; ++p) issue_next();
  int n_done = 0;  // stages multiplied
  for (int t = 0; t < ntiles; ++t) {
    const int i0 = t * BQ;
    const Slots sl = tile_slots<BQ, BK>(LEGACY, L, i0, j0);
    if (tid < BQ) {  // read after the score stages' barriers
      const int i = i0 + tid;
      s_lse[tid] = i < L ? a.lse[(size_t)bh * L + i] : 0.f;
      s_delta[tid] = i < L ? a.delta[(size_t)bh * L + i] : 0.f;
    }
    // lower warps: sc[0..1] S n-tiles 0, 1 of subtile `sub` (A q_u), sc[2..3]
    // dP's (A dO); upper warps: sc[4 slot .. 4 slot + 3] the slot's raw band
    // n-tiles of subtile `sub` (A q_v rows i or i+1)
    float sc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q) sc[q][0] = sc[q][1] = sc[q][2] = sc[q][3] = 0.f;

    for (int s = 0; s < nst; ++s) {
      issue_next();
      tc::cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      const T* buf = bufs + (n_done % NSTAGE) * Ly::BUF;

      if (s < nc) {
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
          const int k16 = ks * 16;
          tc::AFrag<T> af;
          if (lower) {
            tc::load_a(af, buf + Ly::QU + sub * 16 * LDC + k16, LDC);
            tc::mma2<false>(sc[0], sc[1], af, buf + Ly::K + k16, LDC);
            tc::load_a(af, buf + Ly::DO + sub * 16 * LDC + k16, LDC);
            tc::mma2<false>(sc[2], sc[3], af, buf + Ly::V + k16, LDC);
          } else {
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
              if (slot >= sl.n) continue;
              // the subtile's 32 window rows: w = j - i + BQ - 1 from BQ - 16 (sub + 1)
              const T* w = buf + Ly::W + (slot * WINR + BQ - 16 * (sub + 1)) * LDC + k16;
              tc::load_a(af, buf + Ly::QV + (sub * 16 + sl.aoff[slot]) * LDC + k16, LDC);
              tc::mma2<false>(sc[4 * slot], sc[4 * slot + 1], af, w, LDC);
              tc::mma2<false>(sc[4 * slot + 2], sc[4 * slot + 3], af, w + 16 * LDC, LDC);
            }
          }
        }
        if (s == nc - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = sub * 16 + tc::frag_row(e), c = tc::frag_col(e);
            if (lower) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                s_s[r * LDS + q * 8 + c] = sc[q][e];
                s_dp[r * LDS + q * 8 + c] = sc[2 + q][e];
              }
            } else {
#pragma unroll
              for (int slot = 0; slot < 2; ++slot) {
                if (slot >= sl.n) continue;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  s_raw[(slot * BQ + r) * LDR + q * 8 + c] = sc[4 * slot + q][e];
              }
            }
          }
          __syncthreads();
          // (pd, ds) of key jl against queries il = tid / 16 + 16 c; written
          // transposed, [key][query], in the storage type
          const int jl = tid % 16, j = j0 + jl;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int il = tid / 16 + 16 * c, i = i0 + il;
            const bool valid = i < L && j < kv_len;
            const int w = jl - il % 16 + 15, d = j - i;  // the subtile's window row
            float band = 0.f;
            if (!LEGACY) {
              band = s_raw[il * LDR + w];
            } else if (d != 1) {
              band = s_raw[((d <= 0 ? 0 : sl.n - 1) * BQ + il) * LDR + w];
            }
            float pd, ds;
            cell_grads(a, s_s[il * LDS + jl] + band, s_dp[il * LDS + jl], s_lse[il],
                       s_delta[il], valid, bh, i, j, pd, ds);
            s_pdt[jl * LDP + il] = from_f<T>(pd);
            s_dst[jl * LDP + il] = from_f<T>(ds);
          }
        }
      } else {
        // dv += Pd^T . dO, then dk += dS^T . q_u, over 16 queries a stage
        const int o = s - nc, q0 = (o % (NOUT / 2)) * VK;
        tc::AFrag<T> af;
        if (o < NOUT / 2) {
          tc::load_a(af, s_pdt + q0, LDP);
          tc::mma_cols<NTW>(acc_v, af, buf, LDV, warp * NTW * 8, D);
        } else {
          tc::load_a(af, s_dst + q0, LDP);
          tc::mma_cols<NTW>(acc_k, af, buf, LDV, warp * NTW * 8, D);
        }
      }
      __syncthreads();
      ++n_done;
    }
  }

  T* dk = static_cast<T*>(a.dk) + base;
  T* dv = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int col0 = (warp * NTW + n) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + tc::frag_row(e), c = col0 + tc::frag_col(e);
      if (j >= L || c >= D) continue;
      const size_t off = (size_t)j * D + c;
      dk[off] = from_f<T>(acc_k[n][e]);
      dv[off] = from_f<T>(acc_v[n][e]);
    }
  }
}

template <typename T, int NTW, bool LEGACY>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  auto kernel = rel_flash_bwd_dkv_kernel<T, NTW, LEGACY>;
  constexpr int bytes = Layout<T, NTW>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned<T>(a.D, {a.qu, a.qv, a.k, a.v, a.pos, a.dout});
  kernel<<<dim3((a.L + BK - 1) / BK, a.B * a.H), NT, bytes, stream>>>(a, aligned);
  return cudaGetLastError();
}

template <typename T, int NTW>
cudaError_t launch_ntw(const Args& a, bool legacy, cudaStream_t stream) {
  return legacy ? launch_variant<T, NTW, true>(a, stream)
                : launch_variant<T, NTW, false>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, bool legacy, cudaStream_t stream) {
  // NTW = output n-tiles a warp owns: D <= 64 * NTW
  if (a.D <= 64) return launch_ntw<T, 1>(a, legacy, stream);
  if (a.D <= 192) return launch_ntw<T, 3>(a, legacy, stream);
  if (a.D <= 384) return launch_ntw<T, 6>(a, legacy, stream);
  if (a.D <= 768) return launch_ntw<T, 12>(a, legacy, stream);
  if (a.D <= 1024) return launch_ntw<T, 16>(a, legacy, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_u, q_v, k, v, dout: (B*H, L, D) contiguous, in the storage type `dtype`;
// pos: (H, 2L-1, D), or with `legacy` the legacy table (H, L, D); kv_lens
// (B,) int32; lse, delta (B*H, L) float32; scale = 1/sqrt(D); dropout rate
// in [0, 1) (0: none), keep_scale = 1/(1-rate) in float32, the seed, t_pad =
// round_up(L, 128). Outputs dk, dv (B*H, L, D) in the storage type, every
// element written. D <= 1024. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int rel_flash_bwd_dkv(int dtype, const void* qu, const void* qv, const void* k,
                                 const void* v, const void* pos, const void* kv_lens,
                                 const void* lse, const void* delta, const void* dout, void* dk,
                                 void* dv, int B, int H, int L, int D, int legacy, float scale,
                                 float rate, float keep_scale, unsigned seed, int t_pad,
                                 void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || B * H > 65535 || t_pad < L || rate < 0.f ||
      rate >= 1.f)
    return cudaErrorInvalidValue;
  const Args a{qu, qv, k, v, pos, dout, static_cast<const int*>(kv_lens),
               static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv,
               B, H, L, D, scale, rate, keep_scale, seed, t_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(a, legacy != 0, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(a, legacy != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}
