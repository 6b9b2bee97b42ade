// Standard multi-head flash attention, backward: the dq kernel and the
// dk/dv kernel (FlashAttention-2 style: the score tiles are recomputed from
// q, k and the forward's saved logsumexp; the (Tq, Tk) matrices never reach
// device memory).
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
//
// Design. The TPU kernels carry their sums over a sequential grid axis in
// VMEM scratch (dq over kv blocks, dk/dv over q blocks with the grid
// transposed) at D padded to 128 and with a lane-broadcast logsumexp. Here
// blocks run in parallel and the accumulation is a loop inside the block:
// - dq: a block owns 16 query rows and walks the live keys in tiles of 64;
//   the 16 lanes of a half-warp own one row, score 4 keys of a tile (q.k
//   and dO.v in one pass over D), write ds to shared memory and accumulate
//   the row's dq columns tx + 16 m from the staged k tile;
// - dk/dv: a block owns 16 keys and walks the query rows in tiles of 64
//   (under the causal mask from the first row that can see its keys); the
//   16 lanes of a half-warp own one key, score 4 rows of a tile, and
//   accumulate the key's dk and dv columns from the staged q and dO tiles.
//   Keys at or past kv_len get zeros without a loop.
// No atomics: every output element has one owner, so both are
// deterministic. D <= 256, no padding.
//
// Bound: per (b, h) about 4 * Tq * keys * D multiply-adds in each kernel
// (two recomputed products, then one or two accumulations) against
// ~(3 Tq + 2 keys) * D inputs read once: bound by operations at the main
// path's shapes. These first versions multiply on the CUDA cores in float
// FMA and are bound by shared-memory reads; tensor cores are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BR = 16;   // rows (dq) or keys (dk/dv) a block owns: one per 16-lane group
constexpr int BT = 64;   // keys (dq) or query rows (dk/dv) a tile walks
constexpr int NT = 256;  // threads per block
constexpr int MAX_D = 256;

using s2s::from_f;
using s2s::stage_rows;

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

// The recomputed (pd, ds) of one score from its two dot products; ds
// includes the softmax scale.
template <bool DROPOUT>
__device__ __forceinline__ void block_grads(const Args& a, int bh, int i, int j, bool live,
                                            float qk, float dov, float lse_i, float delta_i,
                                            float& pd, float& ds) {
  const float p = live ? expf(qk * a.scale - lse_i) : 0.f;
  if constexpr (DROPOUT) {
    pd = (live && s2s::dropout_keep(a.seed, bh, i, j, a.tq_pad, a.tk_pad, a.rate))
             ? p * a.keep_scale
             : 0.f;
    ds = (pd * dov - p * delta_i) * a.scale;
  } else {
    pd = p;
    ds = p * (dov - delta_i) * a.scale;
  }
}

template <typename T, int NC, bool DROPOUT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* s_q = smem;              // BR x ld
  float* s_do = s_q + BR * ld;    // BR x ld
  float* s_k = s_do + BR * ld;    // BT x ld
  float* s_v = s_k + BT * ld;     // BT x ld
  float* s_ds = s_v + BT * ld;    // BR x (BT + 1)

  const int i0 = blockIdx.x * BR;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i = i0 + ty;
  int kv_end = min(a.kv_lens[bh / a.H], a.Tk);
  if (a.causal) kv_end = min(kv_end, i0 + BR);
  const int row_end = i < a.Tq ? (a.causal ? min(kv_end, i + 1) : kv_end) : 0;

  const size_t qbase = (size_t)bh * a.Tq * D, kbase = (size_t)bh * a.Tk * D;
  stage_rows<NT>(s_q, ld, static_cast<const T*>(a.q) + qbase, i0, BR, a.Tq, D);
  stage_rows<NT>(s_do, ld, static_cast<const T*>(a.d_out) + qbase, i0, BR, a.Tq, D);
  const float lse_i = i < a.Tq ? a.lse[(size_t)bh * a.Tq + i] : 0.f;
  const float delta_i = i < a.Tq ? a.delta[(size_t)bh * a.Tq + i] : 0.f;

  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BT) {
    __syncthreads();
    stage_rows<NT>(s_k, ld, static_cast<const T*>(a.k) + kbase, j0, BT, kv_end, D);
    stage_rows<NT>(s_v, ld, static_cast<const T*>(a.v) + kbase, j0, BT, kv_end, D);
    __syncthreads();

    float qk[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float aq = s_q[ty * ld + c], ad = s_do[ty * ld + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        qk[b] = fmaf(aq, s_k[(tx + 16 * b) * ld + c], qk[b]);
        dv[b] = fmaf(ad, s_v[(tx + 16 * b) * ld + c], dv[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      float pd, ds;
      block_grads<DROPOUT>(a, bh, i, j, j < row_end, qk[b], dv[b], lse_i, delta_i, pd, ds);
      s_ds[ty * (BT + 1) + tx + 16 * b] = ds;
    }
    __syncthreads();

    const int nk = min(BT, kv_end - j0);
    for (int n = 0; n < nk; ++n) {
      const float g = s_ds[ty * (BT + 1) + n];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int c = tx + 16 * m;
        if (c < D) acc[m] = fmaf(g, s_k[n * ld + c], acc[m]);
      }
    }
  }

  if (i < a.Tq) {
    T* dq = static_cast<T*>(a.o1) + qbase + (size_t)i * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = tx + 16 * m;
      if (c < D) dq[c] = from_f<T>(acc[m]);
    }
  }
}

template <typename T, int NC, bool DROPOUT>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* s_k = smem;               // BR x ld
  float* s_v = s_k + BR * ld;      // BR x ld
  float* s_q = s_v + BR * ld;      // BT x ld
  float* s_do = s_q + BT * ld;     // BT x ld
  float* s_lse = s_do + BT * ld;   // BT
  float* s_dl = s_lse + BT;        // BT (delta)
  float* s_pd = s_dl + BT;         // BR x (BT + 1)
  float* s_ds = s_pd + BR * (BT + 1);  // BR x (BT + 1)

  const int j0 = blockIdx.x * BR;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int j = j0 + ty;
  const int kv_len = min(a.kv_lens[bh / a.H], a.Tk);
  const size_t qbase = (size_t)bh * a.Tq * D, kbase = (size_t)bh * a.Tk * D;

  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc_k[m] = acc_v[m] = 0.f;

  if (j0 < kv_len) {  // a block of dead keys writes zeros
    stage_rows<NT>(s_k, ld, static_cast<const T*>(a.k) + kbase, j0, BR, kv_len, D);
    stage_rows<NT>(s_v, ld, static_cast<const T*>(a.v) + kbase, j0, BR, kv_len, D);
    // under the causal mask row i sees key j only from i = j on
    const int first = a.causal ? (j0 / BT) * BT : 0;
    for (int r0 = first; r0 < a.Tq; r0 += BT) {
      __syncthreads();
      stage_rows<NT>(s_q, ld, static_cast<const T*>(a.q) + qbase, r0, BT, a.Tq, D);
      stage_rows<NT>(s_do, ld, static_cast<const T*>(a.d_out) + qbase, r0, BT, a.Tq, D);
      for (int e = tid; e < BT; e += NT) {
        const int i = r0 + e;
        s_lse[e] = i < a.Tq ? a.lse[(size_t)bh * a.Tq + i] : 0.f;
        s_dl[e] = i < a.Tq ? a.delta[(size_t)bh * a.Tq + i] : 0.f;
      }
      __syncthreads();

      float qk[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float ak = s_k[ty * ld + c], av = s_v[ty * ld + c];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          qk[b] = fmaf(ak, s_q[(tx + 16 * b) * ld + c], qk[b]);
          dv[b] = fmaf(av, s_do[(tx + 16 * b) * ld + c], dv[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int il = tx + 16 * b, i = r0 + il;
        const bool live = j < kv_len && i < a.Tq && (!a.causal || j <= i);
        float pd, ds;
        block_grads<DROPOUT>(a, bh, i, j, live, qk[b], dv[b], s_lse[il], s_dl[il], pd, ds);
        s_pd[ty * (BT + 1) + il] = pd;
        s_ds[ty * (BT + 1) + il] = ds;
      }
      __syncthreads();

      const int nq = min(BT, a.Tq - r0);
      for (int n = 0; n < nq; ++n) {
        const float pd = s_pd[ty * (BT + 1) + n], ds = s_ds[ty * (BT + 1) + n];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int c = tx + 16 * m;
          if (c < D) {
            acc_v[m] = fmaf(pd, s_do[n * ld + c], acc_v[m]);
            acc_k[m] = fmaf(ds, s_q[n * ld + c], acc_k[m]);
          }
        }
      }
    }
  }

  if (j < a.Tk) {
    T* dk = static_cast<T*>(a.o1) + kbase + (size_t)j * D;
    T* dvo = static_cast<T*>(a.o2) + kbase + (size_t)j * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = tx + 16 * m;
      if (c < D) {
        dk[c] = from_f<T>(acc_k[m]);
        dvo[c] = from_f<T>(acc_v[m]);
      }
    }
  }
}

size_t dq_smem(int D) { return sizeof(float) * (2 * BR * (D + 1) + 2 * BT * (D + 1) + BR * (BT + 1)); }
size_t dkv_smem(int D) {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BT * (D + 1) + 2 * BT + 2 * BR * (BT + 1));
}

template <typename T, int NC, bool DROPOUT>
cudaError_t launch_variant(const Args& a, bool dkv, cudaStream_t stream) {
  void (*kernel)(const Args) =
      dkv ? &flash_bwd_dkv_kernel<T, NC, DROPOUT> : &flash_bwd_dq_kernel<T, NC, DROPOUT>;
  const size_t smem = dkv ? dkv_smem(a.D) : dq_smem(a.D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? a.Tk : a.Tq) + BR - 1) / BR, a.BH);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_nc(const Args& a, bool dkv, cudaStream_t stream) {
  return a.rate > 0.f ? launch_variant<T, NC, true>(a, dkv, stream)
                      : launch_variant<T, NC, false>(a, dkv, stream);
}

template <typename T>
cudaError_t launch(const Args& a, bool dkv, cudaStream_t stream) {
  if (a.D <= 64) return launch_nc<T, 4>(a, dkv, stream);
  if (a.D <= 96) return launch_nc<T, 6>(a, dkv, stream);
  if (a.D <= 128) return launch_nc<T, 8>(a, dkv, stream);
  return launch_nc<T, 16>(a, dkv, stream);
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
// float32; D <= 256; causal 0 or 1; dropout rate in [0, 1) (0: none),
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
