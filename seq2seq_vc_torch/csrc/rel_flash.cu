// Relative-position flash attention, forward, with in-kernel attention
// dropout and the saved logsumexp, on the tensor cores.
//
// Replaces the TPU kernel `_rel_fwd_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_rel_core.fwd_impl`,
// entry `rel_flash_attention`), legacy=False and legacy=True:
//
//   s[i, j] = (q_u[i] . k[j] + band(i, j)) * scale,  j < kv_len[b]
//   p[i, j] = softmax_j(s[i, :])
//   out[i]  = sum_j keep(i, j) * p[i, j] / (1 - rate) * v[j]
//   lse[i]  = logsumexp_j s[i, :]   (-1e30 for a row with no live key)
//
// band(i, j) = q_v[i] . pos[h, T-1-i+j] in the new style (table (H, 2T-1,
// D)); in the legacy form (table (H, T, D)) q_v[i] . pos[T-1-i+j] for
// j <= i, 0 for j = i+1 and q_v[i+1] . pos[j-i-2] for j >= i+2
// (csrc/rel_flash_tiles.cuh). Every input is D wide; scale = 1/sqrt(D).
//
// Dropout acts on the normalised weights: the row sum is taken before the
// drop, and keep(i, j) is the shared hash of csrc/common.cuh, a pure
// function of (seed, b*H+h, i, j) with the JAX package's padded length
// t_pad = round_up(T, 128) in the index (not this kernel's tiles), computed
// from each cell's global (i, j), so the backward kernels draw the same
// mask. Rate 0 and no lse output (lse == nullptr) is the serving path.
//
// Design. A block (8 warps) owns BM = 16 query rows and walks the keys in
// tiles of BN = 64, stopping at the batch row's kv_len. Each tile:
// 1. scores: S = q_u . K^T (16 x 64) and, per band slot, raw = q_v . W^T
//    (16 x 80, W the table window) as m16n8k16 products (bf16: mma.sync on
//    the tensor cores; float32: the same fragments in FMA). D is staged in
//    chunks of 128 bytes a row, the 8 S tiles and 10 raw tiles of each slot
//    spread over the warps so that each warp's tiles share their A operand
//    (rel_flash_tiles.cuh: 18 or 28 tiles, a warp takes 2-5);
// 2. the fragments go to shared memory, where 16 x 16 threads skew the band
//    by index (raw[r][jl - r + 15]), mask, run the online softmax (row max
//    and sum across the row's 16 lanes) and the dropout, and write P in the
//    storage type;
// 3. O = alpha * O + P . V: V staged in four 16-key chunks at full width,
//    each warp owning D/8 output columns (D = 768: 12 n-tiles, 48 float
//    registers a thread).
// Staging is cp.async into a ring of NSTAGE = 2 buffers: while one stage (a
// D-chunk of the scores, or a V chunk) is multiplied, the next one loads
// (a third buffer, or a 256-byte D-chunk, leaves one block an SM where two
// fit and measured slower on an H100); rows are padded
// 16 bytes for conflict-free ldmatrix. P goes to the tensor cores in the
// storage type (bf16 rounds the weights in [0, 1] once, 2^-9 relative),
// the output is divided by the row sum of the unrounded weights.
//
// Bound: per head 3*T*keys*D multiply-adds (q_u.k, the band and P.V;
// the legacy form the same) against ~4*T*D inputs read once, so bound by
// the tensor cores' rate. This version reads K, V and the window from L2
// once per 16-row block (~11 MB a block at T 2304, D 768) and issues two
// ldmatrix per mma in the score products; wgmma, TMA and larger row tiles
// are later work. The dropout hash adds ~10 integer operations per score;
// it is compiled in only where the rate is above 0.
#include <stdint.h>

#include "rel_flash_tiles.cuh"

namespace {

using namespace s2s::rel;
using s2s::from_f;
namespace tc = s2s::tc;

constexpr int NSTAGE = 2;      // buffers of the cp.async ring
constexpr int LDS = BN + 4;    // float score tile row
constexpr int LDR = WINR + 1;  // float raw band row

// shared memory, in bytes from the dynamic base: the stage buffers, then
// P (storage type), then the float tiles
template <typename T, int NTW>
struct Layout {
  static constexpr int LDC = kLDC<T>;
  static constexpr int LDV = kCols<NTW> + tc::kPad<T>;
  static constexpr int LDP = BN + tc::kPad<T>;
  // a score stage: q_u (BM rows), q_v (BM + 1: the legacy hi slot reads
  // rows 1..BM), K (BN), two table windows (WINR each)
  static constexpr int QU = 0, QV = BM * LDC, K = QV + (BM + 1) * LDC, W = K + BN * LDC;
  static constexpr int SCORE = W + 2 * WINR * LDC;
  static constexpr int BUF = SCORE > VK * LDV ? SCORE : VK * LDV;  // elements
  static constexpr int P_OFF = NSTAGE * BUF * (int)sizeof(T);
  static constexpr int S_OFF = P_OFF + BM * LDP * (int)sizeof(T);
  static constexpr int RAW_OFF = S_OFF + BM * LDS * 4;
  static constexpr int ROW_OFF = RAW_OFF + 2 * BM * LDR * 4;
  static constexpr int BYTES = ROW_OFF + BM * 4;
};

template <typename T, int NTW, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(NT) rel_flash_fwd_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ pos, const int* __restrict__ kv_lens,
    T* __restrict__ out, float* __restrict__ lse, int H, int L, int D, bool legacy,
    bool aligned, float scale, float rate, float keep_scale, unsigned seed, int t_pad) {
  using Ly = Layout<T, NTW>;
  constexpr int DK = kDK<T>, LDC = Ly::LDC, LDV = Ly::LDV, LDP = Ly::LDP;
  constexpr int DW = kCols<NTW>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  T* s_p = reinterpret_cast<T*>(smem + Ly::P_OFF);
  float* s_s = reinterpret_cast<float*>(smem + Ly::S_OFF);
  float* s_raw = reinterpret_cast<float*>(smem + Ly::RAW_OFF);
  float* s_row = reinterpret_cast<float*>(smem + Ly::ROW_OFF);

  const int i0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int kv_len = max(0, min(kv_lens[bh / H], L));
  const int tid = threadIdx.x, warp = tid / 32;
  const int quarter = warp % 4;
  const bool lower = warp < NWARP / 2;
  const int tx = tid % 16, ty = tid / 16;  // the softmax's cells: row ty, keys tx + 16b
  const int n_tab = legacy ? L : 2 * L - 1;
  const size_t base = (size_t)bh * L * D;
  const T* qu_b = qu + base;
  const T* qv_b = qv + base;
  const T* k_b = k + base;
  const T* v_b = v + base;
  const T* pos_h = pos + (size_t)h * n_tab * D;

  const int nc = (D + DK - 1) / DK;  // score stages a tile
  const int nst = nc + BN / VK;      // + the V chunks
  const int ntiles = (kv_len + BN - 1) / BN;

  // the loads of stage s of key tile t into buffer b, as one cp.async group
  auto issue = [&](int t, int s, int b) {
    T* buf = bufs + b * Ly::BUF;
    const int j0 = t * BN;
    if (s < nc) {
      const int d0 = s * DK;
      const Slots sl = tile_slots(legacy, L, i0, j0);
      tc::stage<NT, DK>(buf + Ly::QU, LDC, qu_b, D, i0, BM, 0, L, d0, D, aligned);
      tc::stage<NT, DK>(buf + Ly::QV, LDC, qv_b, D, i0, legacy ? BM + 1 : BM, 0, L, d0, D,
                        aligned);
      tc::stage<NT, DK>(buf + Ly::K, LDC, k_b, D, j0, BN, 0, kv_len, d0, D, aligned);
      for (int q = 0; q < sl.n; ++q)
        tc::stage<NT, DK>(buf + Ly::W + q * WINR * LDC, LDC, pos_h, D, sl.row0[q], WINR, 0,
                          n_tab, d0, D, aligned);
    } else {
      tc::stage<NT, DW>(buf, LDV, v_b, D, j0 + (s - nc) * VK, VK, 0, kv_len, 0, D, aligned);
    }
    tc::cp_async_commit();
  };

  float o[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run = kNegInf;  // running max of row ty (same in its 16 lanes)
  float l_run = 0.f;      // running sum of row ty

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
    const int j0 = t * BN;
    const Slots sl = tile_slots(legacy, L, i0, j0);
    // lower warps: sc[0..1] S n-tiles 2q, 2q+1, sc[2..4] slot 1's raw n-tiles;
    // upper warps: sc[2..4] slot 0's raw n-tiles (rel_flash_tiles.cuh)
    const int rslot = lower ? 1 : 0;
    float sc[5][4];
#pragma unroll
    for (int q = 0; q < 5; ++q) sc[q][0] = sc[q][1] = sc[q][2] = sc[q][3] = 0.f;

    for (int s = 0; s < nst; ++s) {
      issue_next();
      tc::cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      const T* buf = bufs + (n_done % NSTAGE) * Ly::BUF;

      if (s < nc) {
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
          const int k16 = ks * 16;
          tc::AFrag<T> a;
          if (lower) {
            tc::load_a(a, buf + Ly::QU + k16, LDC);
            tc::mma2<false>(sc[0], sc[1], a, buf + Ly::K + 2 * quarter * 8 * LDC + k16, LDC);
          }
          if (rslot < sl.n) {
            const T* w = buf + Ly::W + rslot * WINR * LDC + k16;
            tc::load_a(a, buf + Ly::QV + sl.aoff[rslot] * LDC + k16, LDC);
            tc::mma2<false>(sc[2], sc[3], a, w + raw_n(quarter, 0) * 8 * LDC, LDC);
            if (raw_n(quarter, 2) < kRawN)
              tc::mma<false>(sc[4], a, w + raw_n(quarter, 2) * 8 * LDC, LDC);
          }
        }
        if (s == nc - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = tc::frag_row(e), c = tc::frag_col(e);
            if (lower) {
#pragma unroll
              for (int q = 0; q < 2; ++q) s_s[r * LDS + (2 * quarter + q) * 8 + c] = sc[q][e];
            }
            if (rslot < sl.n) {
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const int n = raw_n(quarter, q);
                if (n < kRawN) s_raw[(rslot * BM + r) * LDR + n * 8 + c] = sc[2 + q][e];
              }
            }
          }
          __syncthreads();
          // skew + mask + online softmax + dropout for row ty (16 lanes of one warp)
          const int i = i0 + ty;
          float sv[4];
          float mx = kNegInf;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            const float x =
                (s_s[ty * LDS + jl] + band(s_raw, LDR, legacy, sl, ty, jl, j - i)) * scale;
            sv[c] = j < kv_len ? x : kNegInf;
            mx = fmaxf(mx, sv[c]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m_run, mx);
          const float alpha = expf(m_run - m_new);
          float psum = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            const float p = j < kv_len ? expf(sv[c] - m_new) : 0.f;
            psum += p;  // the row sum is taken before the drop
            float pk = p;
            if constexpr (DROPOUT)
              pk = s2s::dropout_keep(seed, bh, i, j, t_pad, t_pad, rate) ? p * keep_scale : 0.f;
            s_p[ty * LDP + jl] = from_f<T>(pk);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, off);
          l_run = alpha * l_run + psum;
          m_run = m_new;
          if (tx == 0) s_row[ty] = alpha;
        }
      } else {
        // O = alpha * O + P . V over this chunk's 16 keys
        const int vc = s - nc;
        const int g = (tid % 32) / 4;
        if (vc == 0) {
          const float a0 = s_row[g], a1 = s_row[g + 8];
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            o[n][0] *= a0;
            o[n][1] *= a0;
            o[n][2] *= a1;
            o[n][3] *= a1;
          }
        }
        tc::AFrag<T> a;
        tc::load_a(a, s_p + vc * VK, LDP);
        tc::mma_cols<NTW>(o, a, buf, LDV, warp * NTW * 8, D);
      }
      __syncthreads();
      ++n_done;
    }
  }

  if (tx == 0) {
    s_row[ty] = l_run;
    if constexpr (LSE) {
      if (i0 + ty < L)
        lse[(size_t)bh * L + i0 + ty] = l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-37f)) : kNegInf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int col0 = (warp * NTW + n) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tc::frag_row(e), c = col0 + tc::frag_col(e), i = i0 + r;
      if (i < L && c < D) {
        const float l = s_row[r];
        out[base + (size_t)i * D + c] = from_f<T>(o[n][e] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

struct Args {
  const void *qu, *qv, *k, *v, *pos;
  const int* kv_lens;
  void* out;
  float* lse;
  int BH, H, L, D;
  bool legacy;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

template <typename T, int NTW, bool DROPOUT, bool LSE>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  auto kernel = rel_flash_fwd_kernel<T, NTW, DROPOUT, LSE>;
  constexpr int bytes = Layout<T, NTW>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned<T>(a.D, {a.qu, a.qv, a.k, a.v, a.pos});
  const dim3 grid((a.L + BM - 1) / BM, a.BH);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(a.qu), static_cast<const T*>(a.qv), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.pos), a.kv_lens,
      static_cast<T*>(a.out), a.lse, a.H, a.L, a.D, a.legacy, aligned, a.scale, a.rate,
      a.keep_scale, a.seed, a.t_pad);
  return cudaGetLastError();
}

template <typename T, int NTW>
cudaError_t launch_ntw(const Args& a, cudaStream_t stream) {
  if (a.lse == nullptr)
    return a.rate > 0.f ? launch_variant<T, NTW, true, false>(a, stream)
                        : launch_variant<T, NTW, false, false>(a, stream);
  return a.rate > 0.f ? launch_variant<T, NTW, true, true>(a, stream)
                      : launch_variant<T, NTW, false, true>(a, stream);
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

// q_u, q_v, k, v: (BH, L, D) contiguous; pos: (H, 2L-1, D), or with
// `legacy` the legacy table (H, L, D); kv_lens: (BH/H,) int32 on the
// device; out: (BH, L, D) in the input type; lse: (BH, L) float32, or null
// for none. D <= 1024. Dropout: rate in [0, 1) (0: none), keep_scale =
// 1/(1-rate) in float32, the seed, and t_pad = round_up(L, 128) for the
// hash index. Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_flash_fwd(int dtype, const void* qu, const void* qv,
                             const void* k, const void* v, const void* pos,
                             const void* kv_lens, void* out, void* lse, int BH, int H,
                             int L, int D, int legacy, float scale, float rate, float keep_scale,
                             unsigned seed, int t_pad, void* stream) {
  if (BH <= 0 || H <= 0 || L <= 0 || D <= 0 || BH % H != 0 || BH > 65535 || t_pad < L ||
      rate < 0.f || rate >= 1.f)
    return cudaErrorInvalidValue;
  const Args a{qu, qv, k, v, pos, static_cast<const int*>(kv_lens), out,
               static_cast<float*>(lse), BH, H, L, D, legacy != 0, scale, rate, keep_scale,
               seed, t_pad};
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
