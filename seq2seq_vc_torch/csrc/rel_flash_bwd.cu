// Relative-position flash attention, backward: two kernels that recompute
// the score tiles FlashAttention-2 style, so the (T, T) scores, weights and
// dropout mask never reach device memory. (The third, dq, is on the tensor
// cores in csrc/rel_flash_bwd_dq.cu.)
//
// Replaces the TPU kernels of seq2seq_vc_tpu/ops/flash_attention.py
// (launched by `_rel_core.core_bwd`), legacy=False and legacy=True:
//   - rel_flash_bwd_dkv  <- `_rel_bwd_dkv_kernel`  (dk, dv)
//   - rel_flash_bwd_dpos <- `_rel_bwd_dpos_kernel` (the table gradient)
//
// With scale = 1/sqrt(D), the forward's logsumexp lse[i] and
// delta[i] = rowsum(dO[i] * O[i]) (both (BH, T) float32, from the caller),
// every kernel recomputes, for each live score (i, j < kv_len[b]):
//
//   s    = (q_u[i] . k[j] + q_v[i] . pos[h, T-1-i+j]) * scale
//   p    = exp(s - lse[i]),  dp = dO[i] . v[j]
//   pd   = keep(i, j) ? p / (1 - rate) : 0          (pd = p at rate 0)
//   ds   = (pd * dp - p * delta[i]) * scale          (as `_rel_block_grads`)
//
// and then:
//   dk[j]   = sum_i ds q_u[i]            dv[j]   = sum_i pd dO[i]
//   dpos[r] = sum_b sum_i ds(i, j = i + r - (T-1)) q_v[i]
//
// q_u, k, v and dO have the head dim D; q_v, the table and dpos have
// their own width QW: D in the new style, 2*D in the legacy form, whose
// wrapper folds the three cases of the legacy rel_shift into this one band
// product by widening q_v to [q_v[i], q_v[i+1]] and stacking a second table
// beside the first (ops/flash_attention.py `legacy_rel_inputs`). Each
// recompute runs the three products over the first D columns, then the band
// alone over the columns past D.
//
// keep(i, j) is the hash of csrc/common.cuh over the index
// (bh * t_pad + i) * t_pad + j with t_pad = round_up(T, 128), the JAX
// package's padded length: the tiles below never enter it, so the mask is
// the forward kernel's, bit for bit.
//
// The band term needs, for a tile of cells, only the window of table rows
// T-1-i+j that the tile touches (tile rows + tile columns - 1 of them),
// staged in shared memory; each cell reads its own row of the window by
// index arithmetic (no skew buffer, no zero-padded 3T table). The TPU
// kernel's row-reversed table, `_block_rel_unshift_flipped` with its
// anti-diagonal matmul, the strided roll, D padded to 128 and the
// (H, n_tab, B, nq) grid with a resident VMEM accumulator were Mosaic and
// VMEM workarounds and have no counterpart here.
//
// Layout, shared by the two kernels: 256 threads as 16 rows x 16 lanes;
// a tile has 16 "owned" rows (the block's output rows: keys for dk/dv,
// table rows for dpos) against 64 "walked" rows (queries), 4 cells per
// thread. D is staged in
// chunks of 32. The recomputed ds (and pd) tile then goes to shared memory,
// and each thread accumulates its output columns tid + 256*m of all 16 owned
// rows in registers, reading the walked rows (k, pos, dO, q_u, q_v) straight
// from device memory, coalesced along D: at the decoder's D = 768 that is
// two 16 x 768 float accumulators, 96 registers a thread. An output wider
// than 1024 columns (dpos in the legacy form at D = 768: QW = 1536) is split into column chunks of at most 1024 over the grid's z axis,
// each block recomputing the same tiles for its chunk, so that no thread
// holds more than 4 columns of each accumulator; every other launch has one
// chunk.
//
// - dk/dv: a block owns 16 keys and walks every query tile; a key block at
//   or past kv_len writes zeros at once.
// - dpos: a block owns 16 table rows of one head and walks, for the batch
//   items of its group, every query tile whose diagonal reaches a live key
//   (keys j = i + r - (T-1) in [0, kv_len)). Each table row's sum over a
//   group is one block's, in a fixed order; a second pass in the same call
//   adds the groups' partial sums in a fixed order: deterministic, no atomics.
//
// Bound: each kernel recomputes the scores (q_u.k, the band and dO.v:
// 2*D + QW multiply-adds per live score) and adds 2*D (dk/dv) or QW (dpos)
// for its outputs: ~12*D multiply-adds per live score over the two in the
// new style (16*D in the legacy form), against
// ~5*T*D inputs per head read once. At the main path's shapes the
// tensor-core rate would make them bound by operations; this first version
// multiplies on the CUDA cores in float FMA from shared memory, so it is
// bound by FMA issue and shared-memory reads. Tensor cores (mma/wgmma) and
// TMA are later work.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads: 16 rows x 16 lanes
constexpr int OWN = 16;            // owned rows per block
constexpr int WALK = 64;           // walked rows per tile (4 per lane)
constexpr int WIN = OWN + WALK - 1;  // table (or key) window rows of a tile
constexpr int DK = 32;             // depth of one staged D-chunk
constexpr int LDS = DK + 1;        // padded row stride of staged tiles
constexpr int LDT = OWN + 1;       // padded row stride of (WALK, OWN) tiles
constexpr int kDposSplit = 4;      // batch groups of the dpos kernel, at most
constexpr int kMaxNC = 4;          // output columns a thread owns, at most (per accumulator)

using s2s::from_f;
using s2s::to_f;

// batch groups of the dpos kernel for batch size B
int dpos_groups(int B) { return std::max(1, std::min(B, kDposSplit)); }

// An output of W columns in nz chunks of NT*nc columns each (grid z): as few
// chunks as hold W at kMaxNC columns a thread, then the fewest columns a
// thread that still cover W.
struct Chunks {
  int nc, nz;
};
Chunks column_chunks(int W) {
  const int nz = (W + kMaxNC * NT - 1) / (kMaxNC * NT);
  return {(W + nz * NT - 1) / (nz * NT), nz};
}

struct Args {
  const void *qu, *qv, *k, *v, *pos, *dout;
  const int* kv_lens;
  const float *lse, *delta;
  void *out0, *out1;  // dk, dv | dpos, -
  float* partial;     // dpos only: (n_split, H, 2L-1, QW) float32
  int B, H, L, D, QW;
  float scale, rate, keep_scale;
  unsigned seed;
  int t_pad;
};

// rows [row0, row0+nrows) of a (rows, D) matrix, columns [d0, d0+DK), into
// dst[r * LDS + c] as float; zero outside rows [lo, hi) or past D
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int nrows,
                                      int row0, int lo, int hi, int d0, int D) {
  for (int e = threadIdx.x; e < nrows * DK; e += NT) {
    const int r = e / DK, c = e % DK;
    const int row = row0 + r, d = d0 + c;
    dst[r * LDS + c] = (row >= lo && row < hi && d < D) ? to_f(src[(size_t)row * D + d]) : 0.f;
  }
}

// (pd, ds * scale) of one cell from its raw score sum and dO.v
__device__ __forceinline__ void cell(const Args& a, float s_raw, float dp, float lse_i,
                                     float delta_i, bool valid, int bh, int i, int j,
                                     float& pd, float& ds) {
  const float p = valid ? expf(s_raw * a.scale - lse_i) : 0.f;
  if (a.rate > 0.f) {
    pd = (valid && s2s::dropout_keep(a.seed, bh, i, j, a.t_pad, a.t_pad, a.rate)) ? p * a.keep_scale
                                                                           : 0.f;
    ds = (pd * dp - p * delta_i) * a.scale;
  } else {
    pd = p;
    ds = p * (dp - delta_i) * a.scale;
  }
}

// ---------------------------------------------------------------- dk, dv
template <typename T, int NC>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dkv_kernel(Args a) {
  // staging, then (after each tile's D loop) the pd and ds tiles in place
  __shared__ float smem[3 * WALK * LDS + 2 * OWN * LDS + WIN * LDS];
  __shared__ float s_lse[WALK], s_delta[WALK];
  float* s_qu = smem;
  float* s_qv = s_qu + WALK * LDS;
  float* s_do = s_qv + WALK * LDS;
  float* s_k = s_do + WALK * LDS;
  float* s_v = s_k + OWN * LDS;
  float* s_p = s_v + OWN * LDS;
  float* s_pd = smem;              // (WALK, LDT), over the staging
  float* s_ds = smem + WALK * LDT;

  const int L = a.L, D = a.D, QW = a.QW, n_pos = 2 * L - 1;
  const int j0 = blockIdx.x * OWN;
  const int bh = blockIdx.y, h = bh % a.H;
  const int kv_len = max(0, min(a.kv_lens[bh / a.H], L));
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t base = (size_t)bh * L * D;
  const T* qu = static_cast<const T*>(a.qu) + base;
  const T* qv = static_cast<const T*>(a.qv) + (size_t)bh * L * QW;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const T* pos = static_cast<const T*>(a.pos) + (size_t)h * n_pos * QW;
  const int j = j0 + ty;  // the key this thread scores

  float acc_k[OWN][NC], acc_v[OWN][NC];
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
#pragma unroll
    for (int m = 0; m < NC; ++m) acc_k[r][m] = acc_v[r][m] = 0.f;
  }

  for (int i0 = 0; j0 < kv_len && i0 < L; i0 += WALK) {
    const int r_lo = L - WALK - i0 + j0;  // table row of window row 0
    if (tid < WALK) {
      const int i = i0 + tid;
      s_lse[tid] = i < L ? a.lse[(size_t)bh * L + i] : 0.f;
      s_delta[tid] = i < L ? a.delta[(size_t)bh * L + i] : 0.f;
    }
    float ss[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    int d0 = 0;
    for (; d0 < D; d0 += DK) {
      stage(s_qu, qu, WALK, i0, 0, L, d0, D);
      stage(s_qv, qv, WALK, i0, 0, L, d0, QW);
      stage(s_do, dout, WALK, i0, 0, L, d0, D);
      stage(s_k, k, OWN, j0, 0, L, d0, D);
      stage(s_v, v, OWN, j0, 0, L, d0, D);
      stage(s_p, pos, WIN, r_lo, 0, n_pos, d0, QW);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
        const float ak = s_k[ty * LDS + c], avv = s_v[ty * LDS + c];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int il = tx + 16 * b;
          ss[b] = fmaf(s_qu[il * LDS + c], ak, ss[b]);
          ss[b] = fmaf(s_qv[il * LDS + c], s_p[(ty - il + WALK - 1) * LDS + c], ss[b]);
          dp[b] = fmaf(s_do[il * LDS + c], avv, dp[b]);
        }
      }
      __syncthreads();
    }
    for (; d0 < QW; d0 += DK) {  // the legacy form: the band past column D
      stage(s_qv, qv, WALK, i0, 0, L, d0, QW);
      stage(s_p, pos, WIN, r_lo, 0, n_pos, d0, QW);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int il = tx + 16 * b;
          ss[b] = fmaf(s_qv[il * LDS + c], s_p[(ty - il + WALK - 1) * LDS + c], ss[b]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int il = tx + 16 * b, i = i0 + il;
      float pd, ds;
      cell(a, ss[b], dp[b], s_lse[il], s_delta[il], i < L && j < kv_len, bh, i, j, pd, ds);
      s_pd[il * LDT + ty] = pd;
      s_ds[il * LDT + ty] = ds;
    }
    __syncthreads();

    // dv += pd^T . dO, dk += ds^T . q_u over this tile's queries
    const int nq = min(WALK, L - i0);
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = tid + NT * m;
      if (c >= D) continue;
      for (int n = 0; n < nq; ++n) {
        const size_t off = (size_t)(i0 + n) * D + c;
        const float o = to_f(dout[off]), q = to_f(qu[off]);
#pragma unroll
        for (int r = 0; r < OWN; ++r) {
          acc_v[r][m] = fmaf(s_pd[n * LDT + r], o, acc_v[r][m]);
          acc_k[r][m] = fmaf(s_ds[n * LDT + r], q, acc_k[r][m]);
        }
      }
    }
    __syncthreads();
  }

  T* dk = static_cast<T*>(a.out0) + base;
  T* dv = static_cast<T*>(a.out1) + base;
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int c = tid + NT * m;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      if (j0 + r < L) {
        dk[(size_t)(j0 + r) * D + c] = from_f<T>(acc_k[r][m]);
        dv[(size_t)(j0 + r) * D + c] = from_f<T>(acc_v[r][m]);
      }
    }
  }
}

// ---------------------------------------------------------------- dpos
template <typename T, int NC>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dpos_kernel(Args a, int n_split) {
  // staging, then (after each tile's D loop) the ds tile in place
  __shared__ float smem[3 * WALK * LDS + 2 * WIN * LDS + OWN * LDS];
  __shared__ float s_lse[WALK], s_delta[WALK];
  float* s_qu = smem;
  float* s_qv = s_qu + WALK * LDS;
  float* s_do = s_qv + WALK * LDS;
  float* s_kw = s_do + WALK * LDS;  // key window rows j_lo + w
  float* s_vw = s_kw + WIN * LDS;
  float* s_pos = s_vw + WIN * LDS;
  float* s_ds = smem;               // (WALK, LDT), over the staging

  const int L = a.L, D = a.D, QW = a.QW, n_pos = 2 * L - 1;
  const int r0 = blockIdx.x * OWN;
  const int h = blockIdx.y % a.H, group = blockIdx.y / a.H;
  const int c0 = blockIdx.z * NT * NC;  // this block's column chunk of dpos
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r = r0 + ty;  // the table row this thread scores
  const T* pos = static_cast<const T*>(a.pos) + (size_t)h * n_pos * QW;

  float acc[OWN][NC];
#pragma unroll
  for (int rr = 0; rr < OWN; ++rr) {
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[rr][m] = 0.f;
  }

  for (int b = group; b < a.B; b += n_split) {
    const int bh = b * a.H + h;
    const int kv_len = max(0, min(a.kv_lens[b], L));
    const size_t base = (size_t)bh * L * D;
    const T* qu = static_cast<const T*>(a.qu) + base;
    const T* qv = static_cast<const T*>(a.qv) + (size_t)bh * L * QW;
    const T* k = static_cast<const T*>(a.k) + base;
    const T* v = static_cast<const T*>(a.v) + base;
    const T* dout = static_cast<const T*>(a.dout) + base;
    // query tiles whose keys j = i + r - (L-1), r in [r0, r0+OWN), meet [0, kv_len)
    const int i_first = max(0, (L - 1 - r0 - (OWN - 1)) / WALK * WALK);
    for (int i0 = i_first; i0 < L; i0 += WALK) {
      const int j_lo = i0 + r0 - (L - 1);  // key of window row 0
      if (j_lo >= kv_len) break;
      if (j_lo + WIN - 1 < 0) continue;
      if (tid < WALK) {
        const int i = i0 + tid;
        s_lse[tid] = i < L ? a.lse[(size_t)bh * L + i] : 0.f;
        s_delta[tid] = i < L ? a.delta[(size_t)bh * L + i] : 0.f;
      }
      float ss[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      int d0 = 0;
      for (; d0 < D; d0 += DK) {
        stage(s_qu, qu, WALK, i0, 0, L, d0, D);
        stage(s_qv, qv, WALK, i0, 0, L, d0, QW);
        stage(s_do, dout, WALK, i0, 0, L, d0, D);
        stage(s_kw, k, WIN, j_lo, 0, kv_len, d0, D);
        stage(s_vw, v, WIN, j_lo, 0, kv_len, d0, D);
        stage(s_pos, pos, OWN, r0, 0, n_pos, d0, QW);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < DK; ++c) {
          const float ap = s_pos[ty * LDS + c];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int il = tx + 16 * q;
            ss[q] = fmaf(s_qu[il * LDS + c], s_kw[(il + ty) * LDS + c], ss[q]);
            ss[q] = fmaf(s_qv[il * LDS + c], ap, ss[q]);
            dp[q] = fmaf(s_do[il * LDS + c], s_vw[(il + ty) * LDS + c], dp[q]);
          }
        }
        __syncthreads();
      }
      for (; d0 < QW; d0 += DK) {  // the legacy form: the band past column D
        stage(s_qv, qv, WALK, i0, 0, L, d0, QW);
        stage(s_pos, pos, OWN, r0, 0, n_pos, d0, QW);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < DK; ++c) {
          const float ap = s_pos[ty * LDS + c];
#pragma unroll
          for (int q = 0; q < 4; ++q) ss[q] = fmaf(s_qv[(tx + 16 * q) * LDS + c], ap, ss[q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int il = tx + 16 * q, i = i0 + il, j = j_lo + il + ty;
        float pd, ds;
        cell(a, ss[q], dp[q], s_lse[il], s_delta[il],
             i < L && r < n_pos && j >= 0 && j < kv_len, bh, i, j, pd, ds);
        s_ds[il * LDT + ty] = ds;
      }
      __syncthreads();

      // dpos[r] += sum_i ds(i, r) q_v[i] over this tile's queries
      const int nq = min(WALK, L - i0);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int c = c0 + tid + NT * m;
        if (c >= QW) continue;
        for (int n = 0; n < nq; ++n) {
          const float q = to_f(qv[(size_t)(i0 + n) * QW + c]);
#pragma unroll
          for (int rr = 0; rr < OWN; ++rr) acc[rr][m] = fmaf(s_ds[n * LDT + rr], q, acc[rr][m]);
        }
      }
      __syncthreads();
    }
  }

  float* part = a.partial + ((size_t)group * a.H + h) * n_pos * QW;
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int c = c0 + tid + NT * m;
    if (c >= QW) continue;
#pragma unroll
    for (int rr = 0; rr < OWN; ++rr) {
      if (r0 + rr < n_pos) part[(size_t)(r0 + rr) * QW + c] = acc[rr][m];
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

enum Which { kDkv, kDpos };

template <typename T, int NC>
cudaError_t launch_nc(Which which, const Args& a, int nz, cudaStream_t stream) {
  const int BH = a.B * a.H;
  if (which == kDkv) {
    rel_flash_bwd_dkv_kernel<T, NC><<<dim3((a.L + OWN - 1) / OWN, BH), NT, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const int n_split = dpos_groups(a.B);
  const int n_pos = 2 * a.L - 1;
  rel_flash_bwd_dpos_kernel<T, NC>
      <<<dim3((n_pos + OWN - 1) / OWN, a.H * n_split, nz), NT, 0, stream>>>(a, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)a.H * n_pos * a.QW;
  const unsigned blocks = (unsigned)std::min<size_t>((n + NT - 1) / NT, 4096);
  rel_flash_bwd_dpos_sum_kernel<T><<<blocks, NT, 0, stream>>>(a.partial, static_cast<T*>(a.out0),
                                                              n_split, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  // the output's columns: dk and dv, or dpos; NC = columns a thread owns
  // in its chunk
  const int W = which == kDkv ? a.D : a.QW;
  const Chunks ch = column_chunks(W);
  if (which == kDkv && ch.nz != 1) return cudaErrorInvalidValue;
  switch (ch.nc) {
    case 1:
      return launch_nc<T, 1>(which, a, ch.nz, stream);
    case 2:
      return launch_nc<T, 2>(which, a, ch.nz, stream);
    case 3:
      return launch_nc<T, 3>(which, a, ch.nz, stream);
    case 4:
      return launch_nc<T, 4>(which, a, ch.nz, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Which which, int dtype, const Args& a, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.L <= 0 || a.D <= 0 || a.QW <= 0 || a.B * a.H > 65535 ||
      a.t_pad < a.L || a.rate < 0.f || a.rate >= 1.f)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(which, a, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(which, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared arguments: q_u, k, v, dout (B*H, L, D), q_v (B*H, L, QW) and pos
// (H, 2L-1, QW), contiguous, in the storage type `dtype`; kv_lens (B,)
// int32; lse, delta (B*H, L) float32; scale = 1/sqrt(D); dropout rate in
// [0, 1) (0: none), keep_scale = 1/(1-rate) in float32, the seed, t_pad =
// round_up(L, 128). Outputs in the storage type, every element written.
// D <= 1024, QW <= 2048 (QW = D new style, 2*D legacy). Each returns the
// launch's cudaError_t (0 = launched).
#define S2S_BWD_ARGS                                                                    \
  int dtype, const void *qu, const void *qv, const void *k, const void *v,            \
      const void *pos, const void *kv_lens, const void *lse, const void *delta,       \
      const void *dout
#define S2S_BWD_TAIL                                                                    \
  int B, int H, int L, int D, int QW, float scale, float rate, float keep_scale,         \
      unsigned seed, int t_pad, void *stream

static Args make_args(const void* qu, const void* qv, const void* k, const void* v,
                      const void* pos, const void* kv_lens, const void* lse,
                      const void* delta, const void* dout, void* out0, void* out1,
                      float* partial, int B, int H, int L, int D, int QW, float scale,
                      float rate, float keep_scale, unsigned seed, int t_pad) {
  return Args{qu, qv, k, v, pos, dout, static_cast<const int*>(kv_lens),
              static_cast<const float*>(lse), static_cast<const float*>(delta), out0, out1,
              partial, B, H, L, D, QW, scale, rate, keep_scale, seed, t_pad};
}

// dk, dv: (B*H, L, D)
extern "C" int rel_flash_bwd_dkv(S2S_BWD_ARGS, void* dk, void* dv, S2S_BWD_TAIL) {
  return run(kDkv, dtype,
             make_args(qu, qv, k, v, pos, kv_lens, lse, delta, dout, dk, dv, nullptr, B, H, L,
                       D, QW, scale, rate, keep_scale, seed, t_pad),
             stream);
}

// The dpos kernel's number of batch groups for batch size B: the first
// dimension of its float32 scratch.
extern "C" int rel_flash_bwd_dpos_groups(int B) { return dpos_groups(B); }

// dpos: (H, 2L-1, QW); partial: (rel_flash_bwd_dpos_groups(B), H, 2L-1, QW)
// float32 scratch
extern "C" int rel_flash_bwd_dpos(S2S_BWD_ARGS, void* dpos, void* partial, S2S_BWD_TAIL) {
  return run(kDpos, dtype,
             make_args(qu, qv, k, v, pos, kv_lens, lse, delta, dout, dpos, nullptr,
                       static_cast<float*>(partial), B, H, L, D, QW, scale, rate, keep_scale,
                       seed, t_pad),
             stream);
}
