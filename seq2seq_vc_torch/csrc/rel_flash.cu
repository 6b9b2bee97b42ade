// Relative-position flash attention, forward, with in-kernel attention
// dropout and the saved logsumexp.
//
// Replaces the TPU kernel `_rel_fwd_kernel` of
// seq2seq_vc_tpu/ops/flash_attention.py (launched by `_rel_core.fwd_impl`,
// entry `rel_flash_attention`), legacy=False and legacy=True:
//
//   s[i, j] = (q_u[i] . k[j] + q_v[i] . pos[h, T-1-i+j]) * scale,  j < kv_len[b]
//   p[i, j] = softmax_j(s[i, :])
//   out[i]  = sum_j keep(i, j) * p[i, j] / (1 - rate) * v[j]
//   lse[i]  = logsumexp_j s[i, :]   (-1e30 for a row with no live key)
//
// q_u, k and v have the head dim D; q_v and the table have their own width
// QW: D in the new style, 2*D in the legacy form, whose wrapper folds the
// three cases of the legacy rel_shift into this one band product by
// widening q_v to [q_v[i], q_v[i+1]] and stacking a second table beside the
// first (ops/flash_attention.py `legacy_rel_inputs`). The D-chunk loop runs
// the three products over the first D columns and then the band alone over
// the columns past D; scale = 1/sqrt(D) either way.
//
// Dropout acts on the normalised weights: the row sum is taken before the
// drop, and keep(i, j) is the shared hash of csrc/common.cuh, a pure
// function of (seed, b*H+h, i, j) with the JAX package's padded length
// t_pad = round_up(T, 128) in the index (not this kernel's tiles), so the
// backward kernels of csrc/rel_flash_bwd.cu draw the same mask. Rate 0 and
// no lse output (lse == nullptr) is the serving path.
//
// One block owns BM = 16 query rows and walks the keys in tiles of BN = 64,
// stopping at the batch row's kv_len (keys past it carry no weight). Each
// tile's scores come from the same windowed band product as
// csrc/rel_scores.cu: q_v times the BM+BN-1 pos rows the tile touches,
// skewed by index arithmetic in shared memory. An online softmax (running
// max and sum per row) rescales the output accumulator, which lives in
// registers: each thread owns the columns tid + 256*m of all 16 rows, so
// the decoder's head dim D = 768 (16 x 768 fp32 = 48 KB) costs 48 registers
// a thread and no shared memory. V rows are read straight from device
// memory, coalesced along D. A row whose kv_len is 0 returns zeros.
//
// Bound: per head (2*D + QW)*T*T multiply-adds at most (q_u.k, the band
// and P.V: 3*T*T*D in the new style) against ~4*T*D inputs read
// once, so at the main path's shapes the card's tensor-core rate would make
// it bound by operations. This first version multiplies on the CUDA cores
// in float FMA, so it is bound by FMA issue and shared-memory reads; tensor
// cores (mma/wgmma) are later work. The dropout hash adds ~10 integer
// operations per score, against 2*D+ multiply-adds; it is compiled in only
// where the rate is above 0.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;        // query rows per block (one per 16-lane group)
constexpr int BN = 64;        // keys per tile
constexpr int DK = 32;        // depth of one D-chunk
constexpr int WIN = BM + BN;  // pos window rows staged (BM+BN-1 used)
constexpr int LDS = DK + 1;
constexpr int NT = 256;
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernel's _NEG_INF

using s2s::from_f;
using s2s::to_f;

// DROPOUT and LSE are template parameters so that the serving path (rate 0,
// no logsumexp) compiles to the kernel without them: the logsumexp epilogue
// alone, as a runtime branch, made the D = 768 serving launch 1.6x slower
// on an H100.
template <typename T, int NC, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(NT) rel_flash_fwd_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ pos,
    const int* __restrict__ kv_lens, T* __restrict__ out, float* __restrict__ lse,
    int H, int L, int D, int QW, float scale, float rate, float keep_scale, unsigned seed,
    int t_pad) {
  __shared__ float s_qu[BM * LDS];
  __shared__ float s_qv[BM * LDS];
  __shared__ float s_k[BN * LDS];
  __shared__ float s_p[WIN * LDS];
  __shared__ float s_raw[BM][WIN + 1];
  __shared__ float s_prob[BM][BN + 1];
  __shared__ float s_row[BM];  // per-row rescale factor, then the row sum

  const int i0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int kv_len = min(kv_lens[bh / H], L);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group within the row
  const int ty = tid / 16;  // the row this thread scores
  const int n_pos = 2 * L - 1;

  const size_t base = (size_t)bh * L * D;
  const T* qu_b = qu + base;
  const T* qv_b = qv + (size_t)bh * L * QW;
  const T* k_b = k + base;
  const T* v_b = v + base;
  const T* pos_h = pos + (size_t)h * n_pos * QW;

  float acc[BM][NC];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[r][m] = 0.f;
  }
  float m_run = kNegInf;  // running max of row ty (same in all 16 lanes)
  float l_run = 0.f;      // running sum of row ty

  for (int j0 = 0; j0 < kv_len; j0 += BN) {
    const int r0 = L - BM - i0 + j0;
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    float racc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    int d0 = 0;
    for (; d0 < D; d0 += DK) {
      for (int e = tid; e < BM * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        const int i = i0 + r, d = d0 + c;
        const bool ok = i < L && d < D;
        s_qu[r * LDS + c] = ok ? to_f(qu_b[(size_t)i * D + d]) : 0.f;
        s_qv[r * LDS + c] = (i < L && d < QW) ? to_f(qv_b[(size_t)i * QW + d]) : 0.f;
      }
      for (int e = tid; e < BN * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        const int j = j0 + r, d = d0 + c;
        s_k[r * LDS + c] = (j < L && d < D) ? to_f(k_b[(size_t)j * D + d]) : 0.f;
      }
      for (int e = tid; e < WIN * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        const int p = r0 + r, d = d0 + c;
        s_p[r * LDS + c] =
            (p >= 0 && p < n_pos && d < QW) ? to_f(pos_h[(size_t)p * QW + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
        const float a_u = s_qu[ty * LDS + c];
        const float a_v = s_qv[ty * LDS + c];
#pragma unroll
        for (int b = 0; b < 4; ++b) sacc[b] = fmaf(a_u, s_k[(tx + 16 * b) * LDS + c], sacc[b]);
#pragma unroll
        for (int w = 0; w < 5; ++w) racc[w] = fmaf(a_v, s_p[(tx + 16 * w) * LDS + c], racc[w]);
      }
      __syncthreads();
    }
    // the legacy form: the band over the q_v/table columns past D
    for (; d0 < QW; d0 += DK) {
      for (int e = tid; e < BM * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        const int i = i0 + r, d = d0 + c;
        s_qv[r * LDS + c] = (i < L && d < QW) ? to_f(qv_b[(size_t)i * QW + d]) : 0.f;
      }
      for (int e = tid; e < WIN * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        const int p = r0 + r, d = d0 + c;
        s_p[r * LDS + c] =
            (p >= 0 && p < n_pos && d < QW) ? to_f(pos_h[(size_t)p * QW + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
        const float a_v = s_qv[ty * LDS + c];
#pragma unroll
        for (int w = 0; w < 5; ++w) racc[w] = fmaf(a_v, s_p[(tx + 16 * w) * LDS + c], racc[w]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int w = 0; w < 5; ++w) s_raw[ty][tx + 16 * w] = racc[w];
    __syncthreads();

    // skew + mask + online softmax for row ty (16 lanes of one warp)
    float sv[4];
    float mx = kNegInf;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jl = tx + 16 * b;
      const float s = (sacc[b] + s_raw[ty][jl - ty + BM - 1]) * scale;
      sv[b] = (j0 + jl < kv_len) ? s : kNegInf;
      mx = fmaxf(mx, sv[b]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jl = tx + 16 * b;
      const float p = (j0 + jl < kv_len) ? expf(sv[b] - m_new) : 0.f;
      psum += p;  // the row sum is taken before the drop
      if constexpr (DROPOUT) {
        s_prob[ty][jl] =
            s2s::dropout_keep(seed, bh, i0 + ty, j0 + jl, t_pad, t_pad, rate) ? p * keep_scale : 0.f;
      } else {
        s_prob[ty][jl] = p;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    if (tx == 0) s_row[ty] = alpha;
    __syncthreads();

    // acc = acc * alpha + P @ V over this tile's live keys
    const int nk = min(BN, kv_len - j0);
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = tid + NT * m;
      if (c < D) {
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r][m] *= s_row[r];
        const T* v_col = v_b + (size_t)j0 * D + c;
        for (int n = 0; n < nk; ++n) {
          const float vv = to_f(v_col[(size_t)n * D]);
#pragma unroll
          for (int r = 0; r < BM; ++r) acc[r][m] = fmaf(s_prob[r][n], vv, acc[r][m]);
        }
      }
    }
    __syncthreads();
  }

  if (tx == 0) {
    s_row[ty] = l_run;
    if constexpr (LSE) {
      if (i0 + ty < L)
        lse[(size_t)bh * L + i0 + ty] =
            l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-37f)) : kNegInf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int c = tid + NT * m;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int i = i0 + r;
      if (i < L) {
        const float l = s_row[r];
        out[base + (size_t)i * D + c] = from_f<T>(acc[r][m] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

struct Args {
  const void *qu, *qv, *k, *v, *pos;
  const int* kv_lens;
  void* out;
  float* lse;
  int BH, H, L, D, QW;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

template <typename T, int NC, bool DROPOUT, bool LSE>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.L + BM - 1) / BM, a.BH);
  rel_flash_fwd_kernel<T, NC, DROPOUT, LSE><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a.qu), static_cast<const T*>(a.qv), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.pos), a.kv_lens,
      static_cast<T*>(a.out), a.lse, a.H, a.L, a.D, a.QW, a.scale, a.rate, a.keep_scale,
      a.seed, a.t_pad);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_nc(const Args& a, cudaStream_t stream) {
  if (a.lse == nullptr)
    return a.rate > 0.f ? launch_variant<T, NC, true, false>(a, stream)
                        : launch_variant<T, NC, false, false>(a, stream);
  return a.rate > 0.f ? launch_variant<T, NC, true, true>(a, stream)
                      : launch_variant<T, NC, false, true>(a, stream);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // NC = output columns per thread: D <= 256 * NC
  if (a.D <= NT) return launch_nc<T, 1>(a, stream);
  if (a.D <= 2 * NT) return launch_nc<T, 2>(a, stream);
  if (a.D <= 3 * NT) return launch_nc<T, 3>(a, stream);
  if (a.D <= 4 * NT) return launch_nc<T, 4>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_u, k, v: (BH, L, D) contiguous; q_v: (BH, L, QW); pos: (H, 2L-1, QW);
// kv_lens: (BH/H,) int32 on the device; out: (BH, L, D) in the input type;
// lse: (BH, L) float32, or null for none. D <= 1024; QW = D (new style) or
// 2*D (legacy), any width the wrapper allows. Dropout: rate in [0, 1) (0: none),
// keep_scale = 1/(1-rate) in float32, the seed, and t_pad = round_up(L, 128)
// for the hash index. Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_flash_fwd(int dtype, const void* qu, const void* qv,
                             const void* k, const void* v, const void* pos,
                             const void* kv_lens, void* out, void* lse, int BH, int H,
                             int L, int D, int QW, float scale, float rate, float keep_scale,
                             unsigned seed, int t_pad, void* stream) {
  if (BH <= 0 || H <= 0 || L <= 0 || D <= 0 || QW <= 0 || BH % H != 0 || BH > 65535 ||
      t_pad < L || rate < 0.f || rate >= 1.f)
    return cudaErrorInvalidValue;
  const Args a{qu, qv, k, v, pos, static_cast<const int*>(kv_lens), out,
               static_cast<float*>(lse), BH, H, L, D, QW, scale, rate, keep_scale, seed, t_pad};
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
