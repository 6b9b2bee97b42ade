// Standard multi-head flash attention, forward, with a key-length mask, an
// optional causal mask, in-kernel attention dropout and the saved
// logsumexp.
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
// differ (cross shapes). Dropout acts on the normalised weights (the row sum
// is taken before the drop); keep(i, j) is the shared hash of
// csrc/common.cuh with the JAX package's padded lengths round_up(Tq, 128)
// and round_up(Tk, 128) in the index, so the backward kernels of
// csrc/flash_bwd.cu draw the same mask.
//
// Design. The TPU kernel walks a sequential grid over kv blocks with the
// running max, sum and accumulator in VMEM scratch, its head dim padded to
// 128 lanes and its logsumexp broadcast over 128 lanes. Here blocks run in
// parallel: one block owns BM = 16 query rows of one (b, h) and walks the
// keys in tiles of BN = 64 inside the block, stopping at the row block's
// last live key (kv_len, and under the causal mask the block's last row).
// The 16 lanes of a half-warp own one row: each scores 4 keys of the tile
// (q staged once in shared memory, the k tile beside it, both padded to
// D + 1 floats a row against bank conflicts), the row's max and sum are
// reduced over the 16 lanes with shuffles, and the same lanes own the row's
// output columns tx + 16 m, so the rescale by exp(m_old - m_new) needs no
// shared memory. No D padding: D <= 256, NC = ceil(D / 16) accumulators a
// thread (6 at VTN's D = 96). The logsumexp is one float a row.
//
// Bound: per (b, h) 2 * Tq * keys * D multiply-adds (scores and P.V) against
// ~(2 Tq + 2 keys) * D inputs read once, so at the main path's shapes the
// card's tensor-core rate makes it bound by operations. This first version
// multiplies on the CUDA cores in float FMA and is bound by shared-memory
// reads (about 1.2 per FMA); tensor cores (mma/wgmma) are later work.
// Dropout and the logsumexp are template parameters, so the serving variant
// (rate 0, no lse) compiles without them.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;   // query rows per block (one per 16-lane group)
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr int MAX_D = 256;
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernel's _NEG_INF

using s2s::from_f;
using s2s::stage_rows;

template <typename T, int NC, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_lens, T* __restrict__ out, float* __restrict__ lse, int H,
    int Tq, int Tk, int D, float scale, int causal, float rate, float keep_scale,
    unsigned seed, int tq_pad, int tk_pad) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* s_q = smem;             // BM x ld
  float* s_k = s_q + BM * ld;    // BN x ld
  float* s_v = s_k + BN * ld;    // BN x D
  float* s_p = s_v + BN * D;     // BM x (BN + 1)

  const int i0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // the lane within the row's 16
  const int ty = tid / 16;  // the row this thread works on
  const int i = i0 + ty;
  int kv_end = min(kv_lens[bh / H], Tk);
  if (causal) kv_end = min(kv_end, i0 + BM);  // no row of the block sees a later key
  const int row_end = causal ? min(kv_end, i + 1) : kv_end;  // live keys of row i: j < row_end

  const size_t qbase = (size_t)bh * Tq * D, kbase = (size_t)bh * Tk * D;
  stage_rows<NT>(s_q, ld, q + qbase, i0, BM, Tq, D);

  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.f;
  float m_run = kNegInf;  // running max of row i (the same in all 16 lanes)
  float l_run = 0.f;      // running sum of row i

  for (int j0 = 0; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's reads are done (and s_q is staged)
    stage_rows<NT>(s_k, ld, k + kbase, j0, BN, kv_end, D);
    stage_rows<NT>(s_v, D, v + kbase, j0, BN, kv_end, D);
    __syncthreads();

    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float a = s_q[ty * ld + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) sacc[b] = fmaf(a, s_k[(tx + 16 * b) * ld + c], sacc[b]);
    }
    float sv[4];
    float mx = kNegInf;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      sv[b] = (j0 + tx + 16 * b < row_end) ? sacc[b] * scale : kNegInf;
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
      // explicit zero for a masked key: in a row with no live key so far,
      // sv == m_new and exp(sv - m_new) would be 1
      const float p = (j0 + jl < row_end) ? expf(sv[b] - m_new) : 0.f;
      psum += p;  // the row sum is taken before the drop
      if constexpr (DROPOUT) {
        s_p[ty * (BN + 1) + jl] =
            s2s::dropout_keep(seed, bh, i, j0 + jl, tq_pad, tk_pad, rate) ? p * keep_scale : 0.f;
      } else {
        s_p[ty * (BN + 1) + jl] = p;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncthreads();

    // acc = acc * alpha + P @ V over this tile's keys (row i, columns tx + 16 m)
    const int nk = min(BN, kv_end - j0);
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[m] *= alpha;
    for (int n = 0; n < nk; ++n) {
      const float p = s_p[ty * (BN + 1) + n];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int c = tx + 16 * m;
        if (c < D) acc[m] = fmaf(p, s_v[n * D + c], acc[m]);
      }
    }
  }

  if (i < Tq) {
    const float inv = 1.f / (l_run == 0.f ? 1.f : l_run);
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = tx + 16 * m;
      if (c < D) out[qbase + (size_t)i * D + c] = from_f<T>(acc[m] * inv);
    }
    if constexpr (LSE) {
      if (tx == 0)
        lse[(size_t)bh * Tq + i] = l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-37f)) : kNegInf;
    }
  }
}

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

size_t smem_bytes(int D) { return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1)); }

template <typename T, int NC, bool DROPOUT, bool LSE>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, const int*, T*, float*, int, int, int, int,
                 float, int, float, float, unsigned, int, int) =
      &flash_fwd_kernel<T, NC, DROPOUT, LSE>;
  const size_t smem = smem_bytes(a.D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BM - 1) / BM, a.BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_lens, static_cast<T*>(a.out), a.lse, a.H, a.Tq, a.Tk, a.D, a.scale, a.causal,
      a.rate, a.keep_scale, a.seed, a.tq_pad, a.tk_pad);
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
  // NC = output columns per thread: D <= 16 * NC
  if (a.D <= 64) return launch_nc<T, 4>(a, stream);
  if (a.D <= 96) return launch_nc<T, 6>(a, stream);
  if (a.D <= 128) return launch_nc<T, 8>(a, stream);
  return launch_nc<T, 16>(a, stream);
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
