// Relative-position flash attention, backward: dq_u and dq_v from
// recomputed score tiles (FlashAttention-2 style), on the tensor cores.
//
// Replaces the TPU kernel `_rel_bwd_dq_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_rel_core.core_bwd`),
// legacy=False and legacy=True. With scale = 1/sqrt(D), the forward's
// logsumexp lse[i] and delta[i] = rowsum(dO[i] * O[i]) (both (BH, T)
// float32, from the caller), for each live score (i, j < kv_len[b]):
//
//   s    = (q_u[i] . k[j] + band(i, j)) * scale
//   p    = exp(s - lse[i]),  dp = dO[i] . v[j]
//   pd   = keep(i, j) ? p / (1 - rate) : 0          (pd = p at rate 0)
//   ds   = (pd * dp - p * delta[i]) * scale          (as `_rel_block_grads`)
//   dq_u[i] = sum_j ds k[j]
//   dq_v    = the band's adjoint: new style dq_v[i] = sum_j ds pos[T-1-i+j];
//             legacy, two halves (csrc/rel_flash_tiles.cuh):
//             lo[i] = sum_{j <= i} ds pos[T-1-i+j]
//             hi[i] = sum_{j >= i+2} ds pos[j-i-2]
//
// band(i, j) as in csrc/rel_flash.cu. The legacy hi half belongs to q_v row
// i+1, which can be the next block's, so the kernel writes lo and hi as two
// float32 (BH, T, D) outputs and the wrapper adds hi one row down
// (ops/flash_attention.py `shift_legacy_dqv`): one rounding to the storage
// type, no column chunks, no grid z axis. keep(i, j) is the hash of
// csrc/common.cuh over the cell's global (i, j) with t_pad = round_up(T,
// 128): the forward kernel's mask, bit for bit.
//
// Design. A block (8 warps) owns BM = 16 query rows and walks the key tiles
// of BN = 64 up to kv_len. Each tile:
// 1. scores: S = q_u . K^T, dP = dO . V^T (16 x 64 each) and, per band
//    slot, raw = q_v . W^T (16 x 80), as m16n8k16 products (bf16: mma.sync;
//    float32: the same fragments in FMA) over D in chunks of 128 bytes a
//    row: 26 or 36 n-tiles over the 8 warps, each warp's sharing their A
//    operands (rel_flash_tiles.cuh);
// 2. 16 x 16 threads recompute (pd, ds) per cell from the fragments in
//    shared memory and write dS (16 x 64) in the storage type; then each
//    slot's skewed dS' (16 x 80) with dS'[r][w] = dS[r][w + r - 15], zero
//    off the band and off the slot's side of the diagonal;
// 3. dq_u += dS . K and, per slot, dq_v (lo or hi) += dS' . W: K (4 chunks
//    of 16 rows) and each window (5 chunks) staged at full width, each warp
//    owning D/8 output columns (D = 768: 12 n-tiles, 48 float registers a
//    thread per accumulator: 96 in the new style, 144 legacy).
// Staging is cp.async into a ring of NSTAGE = 2 buffers (the next stage
// loads while one multiplies; a third buffer measured no faster on an H100);
// rows are padded 16 bytes for conflict-free ldmatrix. dS goes to the tensor
// cores in the storage type (bf16: one rounding, 2^-9 relative, of each ds).
//
// Bound: per live score 3D multiply-adds to recompute (q_u.k, the band,
// dO.v) and 2D for the outputs, against ~5*T*D inputs per head read once:
// bound by the tensor cores' rate. This version stages K, V and the window
// twice a tile (D-chunks for the scores, row chunks for the outputs), from
// L2, once per 16-row block; wgmma, TMA and larger row tiles are later work.
#include <stdint.h>

#include "rel_flash_tiles.cuh"

namespace {

using namespace s2s::rel;
using s2s::from_f;
namespace tc = s2s::tc;

constexpr int NSTAGE = 2;      // buffers of the cp.async ring
constexpr int LDS = BN + 4;    // float score / dP tile row
constexpr int LDR = WINR + 1;  // float raw band row
constexpr int NOUT_K = BN / VK;      // output stages of the K tile
constexpr int NOUT_W = WINR / VK;    // output stages of one window

template <typename T, int NTW>
struct Layout {
  static constexpr int LDC = kLDC<T>;
  static constexpr int LDV = kCols<NTW> + tc::kPad<T>;
  static constexpr int LDD = BN + tc::kPad<T>;    // dS row
  static constexpr int LDW = WINR + tc::kPad<T>;  // dS' row
  // a score stage: q_u, q_v (BM + 1 rows), dO, K, V, two table windows
  static constexpr int QU = 0, QV = BM * LDC, DO = QV + (BM + 1) * LDC, K = DO + BM * LDC,
                       V = K + BN * LDC, W = V + BN * LDC;
  static constexpr int SCORE = W + 2 * WINR * LDC;
  static constexpr int BUF = SCORE > VK * LDV ? SCORE : VK * LDV;  // elements
  static constexpr int DS_OFF = NSTAGE * BUF * (int)sizeof(T);
  static constexpr int DSW_OFF = DS_OFF + BM * LDD * (int)sizeof(T);
  static constexpr int S_OFF = DSW_OFF + 2 * BM * LDW * (int)sizeof(T);
  static constexpr int DP_OFF = S_OFF + BM * LDS * 4;
  static constexpr int RAW_OFF = DP_OFF + BM * LDS * 4;
  static constexpr int ROW_OFF = RAW_OFF + 2 * BM * LDR * 4;
  static constexpr int BYTES = ROW_OFF + 2 * BM * 4;
};

struct Args {
  const void *qu, *qv, *k, *v, *pos, *dout;
  const int* kv_lens;
  const float *lse, *delta;
  void *dqu, *dqv, *dqv_hi;  // dq_v (storage type), or legacy lo and hi (float32)
  int B, H, L, D;
  bool legacy;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

template <typename T, int NTW, bool LEGACY>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dq_kernel(Args a, bool aligned) {
  using Ly = Layout<T, NTW>;
  constexpr int DK = kDK<T>, LDC = Ly::LDC, LDV = Ly::LDV, LDD = Ly::LDD, LDW = Ly::LDW;
  constexpr int DW = kCols<NTW>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  T* s_ds = reinterpret_cast<T*>(smem + Ly::DS_OFF);
  T* s_dsw = reinterpret_cast<T*>(smem + Ly::DSW_OFF);
  float* s_s = reinterpret_cast<float*>(smem + Ly::S_OFF);
  float* s_dp = reinterpret_cast<float*>(smem + Ly::DP_OFF);
  float* s_raw = reinterpret_cast<float*>(smem + Ly::RAW_OFF);
  float* s_lse = reinterpret_cast<float*>(smem + Ly::ROW_OFF);
  float* s_delta = s_lse + BM;

  const int L = a.L, D = a.D;
  const int i0 = blockIdx.x * BM;
  const int bh = blockIdx.y, h = bh % a.H;
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], L));
  const int tid = threadIdx.x, warp = tid / 32;
  const int quarter = warp % 4;
  const bool lower = warp < NWARP / 2;
  const int tx = tid % 16, ty = tid / 16;
  const int n_tab = LEGACY ? L : 2 * L - 1;
  const size_t base = (size_t)bh * L * D;
  const T* qu = static_cast<const T*>(a.qu) + base;
  const T* qv = static_cast<const T*>(a.qv) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)h * n_tab * D;

  if (tid < BM) {
    const int i = i0 + tid;
    s_lse[tid] = i < L ? a.lse[(size_t)bh * L + i] : 0.f;
    s_delta[tid] = i < L ? a.delta[(size_t)bh * L + i] : 0.f;
  }

  const int nc = (D + DK - 1) / DK;
  const int ntiles = (kv_len + BN - 1) / BN;
  auto n_stages = [&](const Slots& sl) { return nc + NOUT_K + sl.n * NOUT_W; };

  auto issue = [&](int t, int s, int b) {
    T* buf = bufs + b * Ly::BUF;
    const int j0 = t * BN;
    const Slots sl = tile_slots(LEGACY, L, i0, j0);
    if (s < nc) {
      const int d0 = s * DK;
      tc::stage<NT, DK>(buf + Ly::QU, LDC, qu, D, i0, BM, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::QV, LDC, qv, D, i0, LEGACY ? BM + 1 : BM, 0, L, d0, D,
                        aligned);
      tc::stage<NT, DK>(buf + Ly::DO, LDC, dout, D, i0, BM, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::K, LDC, k, D, j0, BN, 0, kv_len, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::V, LDC, v, D, j0, BN, 0, kv_len, d0, D, aligned);
      for (int q = 0; q < sl.n; ++q)
        tc::stage<NT, DK>(buf + Ly::W + q * WINR * LDC, LDC, pos, D, sl.row0[q], WINR, 0,
                          n_tab, d0, D, aligned);
    } else if (s < nc + NOUT_K) {
      tc::stage<NT, DW>(buf, LDV, k, D, j0 + (s - nc) * VK, VK, 0, kv_len, 0, D, aligned);
    } else {
      const int w = s - nc - NOUT_K, slot = w / NOUT_W;
      tc::stage<NT, DW>(buf, LDV, pos, D, sl.row0[slot] + (w % NOUT_W) * VK, VK, 0, n_tab, 0,
                        D, aligned);
    }
    tc::cp_async_commit();
  };

  float acc_u[NTW][4], acc_v[NTW][4], acc_h[LEGACY ? NTW : 1][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_u[n][e] = acc_v[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (LEGACY ? NTW : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_h[n][e] = 0.f;

  // the ring: stage c of the walk (tile t, stage s) lives in buffer c % NSTAGE;
  // NSTAGE - 1 stages load ahead of the one being multiplied
  int next_t = 0, next_s = 0, issued = 0;
  auto issue_next = [&]() {
    if (next_t < ntiles) {
      issue(next_t, next_s, issued % NSTAGE);
      if (++next_s == n_stages(tile_slots(LEGACY, L, i0, next_t * BN))) next_s = 0, ++next_t;
    } else {
      tc::cp_async_commit();  // an empty group keeps the wait count uniform
    }
    ++issued;
  };
  for (int p = 0; p < NSTAGE - 1; ++p) issue_next();
  int n_done = 0;  // stages multiplied
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * BN;
    const Slots sl = tile_slots(LEGACY, L, i0, j0);
    const int nst = n_stages(sl);
    // lower warps: sc[0..1] S n-tiles 2q, 2q+1 (A q_u), sc[2..3] dP n-tiles
    // 2q, 2q+1 (A dO); upper warps: sc[0..2] slot 0's raw n-tiles, sc[3..5]
    // slot 1's (rel_flash_tiles.cuh)
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
          tc::AFrag<T> af;
          if (lower) {
            tc::load_a(af, buf + Ly::QU + k16, LDC);
            tc::mma2<false>(sc[0], sc[1], af, buf + Ly::K + 2 * quarter * 8 * LDC + k16, LDC);
            tc::load_a(af, buf + Ly::DO + k16, LDC);
            tc::mma2<false>(sc[2], sc[3], af, buf + Ly::V + 2 * quarter * 8 * LDC + k16, LDC);
          } else {
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
              if (slot >= sl.n) continue;
              const T* w = buf + Ly::W + slot * WINR * LDC + k16;
              tc::load_a(af, buf + Ly::QV + sl.aoff[slot] * LDC + k16, LDC);
              tc::mma2<false>(sc[3 * slot], sc[3 * slot + 1], af,
                              w + raw_n(quarter, 0) * 8 * LDC, LDC);
              if (raw_n(quarter, 2) < kRawN)
                tc::mma<false>(sc[3 * slot + 2], af, w + raw_n(quarter, 2) * 8 * LDC, LDC);
            }
          }
        }
        if (s == nc - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = tc::frag_row(e), c = tc::frag_col(e);
            if (lower) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                s_s[r * LDS + (2 * quarter + q) * 8 + c] = sc[q][e];
                s_dp[r * LDS + (2 * quarter + q) * 8 + c] = sc[2 + q][e];
              }
            } else {
#pragma unroll
              for (int slot = 0; slot < 2; ++slot) {
                if (slot >= sl.n) continue;
#pragma unroll
                for (int q = 0; q < 3; ++q) {
                  const int n = raw_n(quarter, q);
                  if (n < kRawN) s_raw[(slot * BM + r) * LDR + n * 8 + c] = sc[3 * slot + q][e];
                }
              }
            }
          }
          __syncthreads();
          // (pd, ds) of row ty's four cells; dS in the storage type
          const int i = i0 + ty;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            const bool valid = i < L && j < kv_len;
            const float x = s_s[ty * LDS + jl] + band(s_raw, LDR, LEGACY, sl, ty, jl, j - i);
            float pd, ds;
            cell_grads(a, x, s_dp[ty * LDS + jl], s_lse[ty], s_delta[ty], valid, bh, i, j, pd,
                       ds);
            s_ds[ty * LDD + jl] = from_f<T>(ds);
          }
          __syncthreads();
          // each slot's skewed dS': row r, window row w <-> key jl = w + r - (BM-1)
          for (int e = tid; e < sl.n * BM * WINR; e += NT) {
            const int slot = e / (BM * WINR), r = (e / WINR) % BM, w = e % WINR;
            const int jl = w + r - (BM - 1);
            const int d = j0 + jl - (i0 + r);
            const bool on = jl >= 0 && jl < BN && in_slot(LEGACY, sl, slot, d);
            s_dsw[(slot * BM + r) * LDW + w] = on ? s_ds[r * LDD + jl] : from_f<T>(0.f);
          }
        }
      } else {
        // dq_u += dS . K (chunk of 16 keys), or dq_v += dS' . W (16 window rows)
        tc::AFrag<T> af;
        const int o = s - nc;
        if (o < NOUT_K) {
          tc::load_a(af, s_ds + o * VK, LDD);
          tc::mma_cols<NTW>(acc_u, af, buf, LDV, warp * NTW * 8, D);
        } else {
          const int w = o - NOUT_K, slot = w / NOUT_W;
          tc::load_a(af, s_dsw + slot * BM * LDW + (w % NOUT_W) * VK, LDW);
          if (!LEGACY || sl.aoff[slot] == 0)
            tc::mma_cols<NTW>(acc_v, af, buf, LDV, warp * NTW * 8, D);
          else if constexpr (LEGACY)
            tc::mma_cols<NTW>(acc_h, af, buf, LDV, warp * NTW * 8, D);
        }
      }
      __syncthreads();
      ++n_done;
    }
  }

  T* dqu = static_cast<T*>(a.dqu) + base;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int col0 = (warp * NTW + n) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + tc::frag_row(e), c = col0 + tc::frag_col(e);
      if (i >= L || c >= D) continue;
      const size_t off = (size_t)i * D + c;
      dqu[off] = from_f<T>(acc_u[n][e]);
      if constexpr (LEGACY) {
        static_cast<float*>(a.dqv)[base + off] = acc_v[n][e];
        static_cast<float*>(a.dqv_hi)[base + off] = acc_h[n][e];
      } else {
        static_cast<T*>(a.dqv)[base + off] = from_f<T>(acc_v[n][e]);
      }
    }
  }
}

template <typename T, int NTW, bool LEGACY>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  auto kernel = rel_flash_bwd_dq_kernel<T, NTW, LEGACY>;
  constexpr int bytes = Layout<T, NTW>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned<T>(a.D, {a.qu, a.qv, a.k, a.v, a.pos, a.dout});
  kernel<<<dim3((a.L + BM - 1) / BM, a.B * a.H), NT, bytes, stream>>>(a, aligned);
  return cudaGetLastError();
}

template <typename T, int NTW>
cudaError_t launch_ntw(const Args& a, cudaStream_t stream) {
  return a.legacy ? launch_variant<T, NTW, true>(a, stream)
                  : launch_variant<T, NTW, false>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // NTW = output n-tiles a warp owns: D <= 64 * NTW
  if (a.D <= 64) return launch_ntw<T, 1>(a, stream);
  if (a.D <= 192) return launch_ntw<T, 3>(a, stream);
  if (a.D <= 384) return launch_ntw<T, 6>(a, stream);
  if (a.D <= 768) return launch_ntw<T, 12>(a, stream);
  if (a.D <= 1024) return launch_ntw<T, 16>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_u, q_v, k, v, dout: (B*H, L, D) contiguous, in the storage type `dtype`;
// pos: (H, 2L-1, D), or with `legacy` the legacy table (H, L, D); kv_lens
// (B,) int32; lse, delta (B*H, L) float32; scale = 1/sqrt(D); dropout rate
// in [0, 1) (0: none), keep_scale = 1/(1-rate) in float32, the seed, t_pad =
// round_up(L, 128). Outputs, every element written: dq_u (B*H, L, D) in the
// storage type; new style dq_v the same and dq_v_hi unused; legacy dq_v the
// lo half and dq_v_hi the hi half, both (B*H, L, D) float32 (dq_v = lo + hi
// one row down). D <= 1024. Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_flash_bwd_dq(int dtype, const void* qu, const void* qv, const void* k,
                                const void* v, const void* pos, const void* kv_lens,
                                const void* lse, const void* delta, const void* dout, void* dqu,
                                void* dqv, void* dqv_hi, int B, int H, int L, int D,
                                int legacy, float scale, float rate, float keep_scale,
                                unsigned seed, int t_pad, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || B * H > 65535 || t_pad < L || rate < 0.f ||
      rate >= 1.f || (legacy && dqv_hi == nullptr))
    return cudaErrorInvalidValue;
  const Args a{qu, qv, k, v, pos, dout, static_cast<const int*>(kv_lens),
               static_cast<const float*>(lse), static_cast<const float*>(delta), dqu, dqv,
               dqv_hi, B, H, L, D, legacy != 0, scale, rate, keep_scale, seed, t_pad};
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
