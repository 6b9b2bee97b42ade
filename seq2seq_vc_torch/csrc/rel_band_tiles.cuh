// Tensor-core tiles of the band cotangent, shared by csrc/rel_scores_bwd.cu
// (kernel 3: dq_v and the table gradient in one launch) and
// csrc/rel_scores_bwd_pair.cu (the bwd="pallas" pair, each half a launch of
// its own: kernel 4 dq_v, kernel 5 the table gradient).
//
// With g the float32 cotangent of the (B, H, T, T) scores, the band
// cotangent is G[b,h,i,r] = g[b,h,i, i+r-(T-1)] (zero where that key leaves
// [0, T)). It never reaches device memory: row i of G over table rows
// [k0, k0+n) is the CONTIGUOUS run g[i, i+k0-(T-1) .. +n) of row i of g, so
// a tile reads it straight from g along the diagonals, with no skew.
//
// A block (4 warps, 16 output rows a warp) owns 64 output rows and a chunk of
// DC = 8 * NTW columns of D (DC/2 float accumulators a lane), and walks
// steps of depth BK = 64. A step stages
// - the 64 x 64 G tile of queries i0.. and table rows k0.. ([i][r], row m the
//   run g[i0+m, i0+m+k0-(T-1) .. +64)): 4-byte loads, since a run starts one
//   float further on along each row and no 16-byte copy fits, taken into
//   registers one step ahead and stored after the step's products;
// - the 64 rows of the B operand (the table for dq_v, q_v for dpos), DC
//   columns, by cp.async (tc::stage: element loads where rows are not 16-byte
//   aligned), read as the [k][n] operand (ldmatrix.trans, tc::mma_cols);
// in two buffers, one barrier a step. Two products read the same tile:
// - dq_v (`dqv_block`, kernels 3 and 4): acc(64 queries, DC) += G . pos
//   over the T+63 table rows its queries touch; A is the tile as staged;
// - dpos (`dpos_block`, kernels 3 and 5): acc(64 table rows, DC) += G^T . q_v
//   over every (b, i) whose g row reaches those rows; A is the tile read
//   transposed (tc::load_a_t, ldmatrix.trans).
// bfloat16: g is float32, and one bf16 rounding of it put the table
// gradient's sums of B*T products (and some dq_v outputs at D 192) past
// the bf16 tolerance in an emulation, so the tile is staged as two bf16
// planes, hi = bf16(x) and lo = bf16(x - hi), both multiplied into the
// same accumulators (twice the products, ~2^-16 relative). float32 (the
// card's reference path, no TF32): one float plane, the same fragments in
// FMA.
//
// The table gradient sums over the batch. Its blocks are split over the
// grid into groups of batch items (`dpos_groups`), one block a group, and
// the G blocks of one output tile form a thread-block cluster: each walks
// its group into its own float32 accumulators, parks them in its shared
// memory, and after a cluster barrier every block adds one slice of the
// tile over the G blocks' shared memory in rank order (distributed shared
// memory) and stores it. A fixed order, no atomics, no device-memory
// partials: deterministic.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "mma_tiles.cuh"

namespace s2s {
namespace band {

namespace tc = s2s::tc;

constexpr int BM = 64;       // output rows a block: queries (dq_v), table rows (dpos)
constexpr int BK = 64;       // depth of one step: table rows (dq_v), queries (dpos)
constexpr int NW = 4;        // warps, 16 output rows each
constexpr int NT = 32 * NW;  // threads
constexpr int GV = BM * BK / NT;  // G tile elements a thread stages: 16 rows x 2
constexpr int kMaxGroups = 8;     // batch groups of the table gradient: a portable cluster

template <typename T>
constexpr int kPlanes = sizeof(T) == 2 ? 2 : 1;  // bf16: hi and lo

template <typename T, int NTW>
struct Tiles {
  static constexpr int DC = 8 * NTW;             // output columns a block
  static constexpr int LDB = DC + tc::kPad<T>;   // a staged B row, elements
  static constexpr int LDG = BK + tc::kPad<T>;   // a staged G row, elements
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int G_ELEMS = kPlanes<T> * BM * LDG;
  static constexpr int BUF = B_ELEMS + G_ELEMS;  // one buffer: B, then the G plane(s)
  static constexpr int RING_BYTES = 2 * BUF * (int)sizeof(T);
  static constexpr int LDR = DC + 4;             // a parked accumulator row, floats
  static constexpr int RED_BYTES = BM * LDR * 4;
  static constexpr int BYTES = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// The arguments of kernels 3-5. Kernel 4 passes no q_v and no dpos,
// kernel 5 no table and no dq_v.
template <typename T>
struct Args {
  const float* g;
  const T *qv, *pos;
  T *dqv, *dpos;
  int B, H, L, D;
  float scale;
  bool aligned;  // every q_v and table row starts on 16 bytes
};

// One step of a walk: the G tile of rows i0.. and table rows k0.. of g_bh,
// and rows row0.. of the B source (rows at or past `hi` are zeros).
template <typename T>
struct Step {
  const float* g_bh;
  int i0, k0;
  const T* src;
  int row0, hi;
};

// the G tile into registers: thread (warp w, lane l) takes rows w + 4q and
// columns l, l + 32, each a coalesced run of one g row
__device__ __forceinline__ void load_g(float (&v)[GV], const float* __restrict__ g_bh, int L,
                                       int i0, int k0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < GV / 2; ++q) {
    const int i = i0 + warp + 4 * q;
    const int j = i + k0 + lane - (L - 1);
    const float* row = g_bh + (size_t)i * L;
    v[2 * q] = (i < L && j >= 0 && j < L) ? row[j] : 0.f;
    v[2 * q + 1] = (i < L && j + 32 >= 0 && j + 32 < L) ? row[j + 32] : 0.f;
  }
}

// ... and into shared memory: bf16 as hi and lo planes, float32 as it is
__device__ __forceinline__ void store_g(__nv_bfloat16* s, int ld, const float (&v)[GV]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < GV; ++q) {
    const int at = (warp + 4 * (q / 2)) * ld + lane + 32 * (q % 2);
    const __nv_bfloat16 hi = __float2bfloat16(v[q]);
    s[at] = hi;
    s[BM * ld + at] = __float2bfloat16(v[q] - __bfloat162float(hi));
  }
}
__device__ __forceinline__ void store_g(float* s, int ld, const float (&v)[GV]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < GV; ++q) s[(warp + 4 * (q / 2)) * ld + lane + 32 * (q % 2)] = v[q];
}

// acc += A . B over one step for the warp's 16 output rows: A = the G tile
// (rows 16w.., TRANS false) or its transpose (table rows 16w.., TRANS
// true), B = the staged [k][n] rows; n-tiles at or past `width` skipped
template <int NTW, bool TRANS>
__device__ __forceinline__ void step_product(float (&acc)[NTW][4], const __nv_bfloat16* sg,
                                             const __nv_bfloat16* sb, int ldg, int ldb,
                                             int width) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    tc::AFrag2<__nv_bfloat16> a;
    if constexpr (TRANS) {
      tc::load_a_t(a.hi, sg + 16 * ks * ldg + 16 * warp, ldg);
      tc::load_a_t(a.lo, sg + BM * ldg + 16 * ks * ldg + 16 * warp, ldg);
    } else {
      tc::load_a(a.hi, sg + 16 * warp * ldg + 16 * ks, ldg);
      tc::load_a(a.lo, sg + BM * ldg + 16 * warp * ldg + 16 * ks, ldg);
    }
    tc::mma_cols<NTW>(acc, a, sb + 16 * ks * ldb, ldb, 0, width);
  }
}
template <int NTW, bool TRANS>
__device__ __forceinline__ void step_product(float (&acc)[NTW][4], const float* sg,
                                             const float* sb, int ldg, int ldb, int width) {
  const int warp = threadIdx.x / 32;
  if constexpr (TRANS) {
    // tc::mma's FMA cells with A(m, k) = sg[k * ldg + m]
    const int lane = threadIdx.x % 32, gr = lane / 4, t = 2 * (lane % 4);
    const float* a = sg + 16 * warp;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      if (8 * n >= width) continue;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        const float a0 = a[k * ldg + gr], a1 = a[k * ldg + gr + 8];
        const float b0 = sb[k * ldb + 8 * n + t], b1 = sb[k * ldb + 8 * n + t + 1];
        acc[n][0] = fmaf(a0, b0, acc[n][0]);
        acc[n][1] = fmaf(a0, b1, acc[n][1]);
        acc[n][2] = fmaf(a1, b0, acc[n][2]);
        acc[n][3] = fmaf(a1, b1, acc[n][3]);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      tc::AFrag<float> a;
      tc::load_a(a, sg + 16 * warp * ldg + 16 * ks, ldg);
      tc::mma_cols<NTW>(acc, a, sb + 16 * ks * ldb, ldb, 0, width);
    }
  }
}

// acc += the products of n_steps steps, step s described by at(s); the B
// tiles are columns d0.. of their (rows, D) source. Leaves the ring busy
// (the caller waits and syncs before reusing the shared memory).
template <typename T, int NTW, bool TRANS, typename At>
__device__ __forceinline__ void walk(float (&acc)[NTW][4], unsigned char* smem, int n_steps,
                                     int L, int D, int d0, bool aligned, At at) {
  using C = Tiles<T, NTW>;
  T* ring = reinterpret_cast<T*>(smem);
  float v[GV];
  auto issue = [&](int s) {  // B by cp.async, G into registers
    const Step<T> st = at(s);
    T* buf = ring + (s % 2) * C::BUF;
    tc::stage<NT, C::DC>(buf, C::LDB, st.src, D, st.row0, BK, 0, st.hi, d0, D, aligned);
    tc::cp_async_commit();
    load_g(v, st.g_bh, L, st.i0, st.k0);
  };
  if (n_steps > 0) {
    issue(0);
    store_g(ring + C::B_ELEMS, C::LDG, v);
  }
  for (int s = 0; s < n_steps; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // step s staged; every warp is done with step s - 1's buffer
    const bool more = s + 1 < n_steps;
    if (more) issue(s + 1);
    const T* buf = ring + (s % 2) * C::BUF;
    step_product<NTW, TRANS>(acc, buf + C::B_ELEMS, buf, C::LDG, C::LDB, D - d0);
    if (more) store_g(ring + ((s + 1) % 2) * C::BUF + C::B_ELEMS, C::LDG, v);
  }
}

template <int NTW>
__device__ __forceinline__ void zero(float (&acc)[NTW][4]) {
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Blocks of the table gradient: n_groups x (D chunks) x (row blocks of
// 2T-1) x H, the group varying fastest (the blocks of one cluster)
template <int NTW>
inline long dpos_tiles(int H, int L, int D) {
  return (long)((D + 8 * NTW - 1) / (8 * NTW)) * ((2L * L - 1 + BM - 1) / BM) * H;
}

// Batch groups of the table gradient: enough blocks for about four a
// multiprocessor, at most kMaxGroups and B, every group non-empty
inline int dpos_groups(int B, long tiles, int n_sm) {
  long want = (4L * n_sm + tiles - 1) / tiles;
  want = std::max(1L, std::min<long>(want, std::min(B, kMaxGroups)));
  const int per = (B + (int)want - 1) / (int)want;  // batch items a group
  return (B + per - 1) / per;
}

// One block of the table gradient, blk in [0, n_groups * dpos_tiles):
// table rows r0.. and columns d0.. of head h, over the batch items of its
// group; the cluster of the tile's n_groups blocks then sums and stores it
//   dpos[h,r] = scale * sum_b sum_i G[b,h,i,r] * q_v[b,h,i].
template <typename T, int NTW>
__device__ __forceinline__ void dpos_block(const Args<T>& a, int blk, int n_groups,
                                           unsigned char* smem) {
  using C = Tiles<T, NTW>;
  const int L = a.L, D = a.D, n_pos = 2 * L - 1;
  const int n_dc = (D + C::DC - 1) / C::DC, n_rb = (n_pos + BM - 1) / BM;
  const int group = blk % n_groups;
  blk /= n_groups;
  const int d0 = (blk % n_dc) * C::DC;
  blk /= n_dc;
  const int r0 = (blk % n_rb) * BM, h = blk / n_rb;
  const int per = (a.B + n_groups - 1) / n_groups;
  const int b0 = group * per, nb = min(a.B, b0 + per) - b0;
  // the queries whose g row reaches a table row of this block
  const int i_lo = max(0, L - r0 - BM), i_hi = min(L - 1, 2 * L - 2 - r0);
  const int n_i = (i_hi - i_lo + BK) / BK;

  float acc[NTW][4];
  zero(acc);
  walk<T, NTW, true>(acc, smem, nb * n_i, L, D, d0, a.aligned, [&](int s) {
    const size_t bh = (size_t)(b0 + s / n_i) * a.H + h;
    const int i0 = i_lo + (s % n_i) * BK;
    return Step<T>{a.g + bh * L * L, i0, r0, a.qv + bh * L * D, i0, L};
  });
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: park the accumulators there

  float* red = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(16 * warp + tc::frag_row(e)) * C::LDR + 8 * n + tc::frag_col(e)] = acc[n][e];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every group's tile parked
  // this block's slice of the tile, summed over the groups in rank order
  const int rank = (int)cluster.block_rank();
  constexpr int N4 = BM * C::DC / 4;
  T* out = a.dpos + (size_t)h * n_pos * D;
  for (int e = N4 * rank / n_groups + threadIdx.x; e < N4 * (rank + 1) / n_groups; e += NT) {
    const int row = 4 * e / C::DC, col = 4 * e % C::DC;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < n_groups; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + row * C::LDR + col);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const int r = r0 + row, d = d0 + col;
    if (r >= n_pos) continue;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (d + c < D) out[(size_t)r * D + d + c] = from_f<T>(sv[c] * a.scale);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// One block of dq_v, blk in [0, dqv_tiles): query rows i0.. and columns
// d0.. of (b, h), over the table rows those queries touch
//   dq_v[b,h,i] = scale * sum_r G[b,h,i,r] * pos[h,r].
template <int NTW>
inline long dqv_tiles(int B, int H, int L, int D) {
  return (long)((D + 8 * NTW - 1) / (8 * NTW)) * ((L + BM - 1) / BM) * B * H;
}

template <typename T, int NTW>
__device__ __forceinline__ void dqv_block(const Args<T>& a, int blk, unsigned char* smem) {
  using C = Tiles<T, NTW>;
  const int L = a.L, D = a.D, n_pos = 2 * L - 1;
  const int n_dc = (D + C::DC - 1) / C::DC, n_ib = (L + BM - 1) / BM;
  const int d0 = (blk % n_dc) * C::DC;  // the chunk varies fastest: blocks sharing g run together
  blk /= n_dc;
  const int i0 = (blk % n_ib) * BM;
  const size_t bh = blk / n_ib;
  const float* g_bh = a.g + bh * L * L;
  const T* pos_h = a.pos + (bh % a.H) * n_pos * D;
  const int r_lo = max(0, L - i0 - BM), r_hi = min(n_pos - 1, 2 * L - 2 - i0);

  float acc[NTW][4];
  zero(acc);
  walk<T, NTW, false>(acc, smem, (r_hi - r_lo + BK) / BK, L, D, d0, a.aligned, [&](int s) {
    const int k0 = r_lo + s * BK;
    return Step<T>{g_bh, i0, k0, pos_h, k0, n_pos};
  });
  T* out = a.dqv + bh * L * D;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 16 * warp + tc::frag_row(e), d = d0 + 8 * n + tc::frag_col(e);
      if (i < L && d < D) out[(size_t)i * D + d] = from_f<T>(acc[n][e] * a.scale);
    }
}

// The multiprocessors of the current device (the group count's grid)
inline cudaError_t device_sms(int* n) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// f(std::integral_constant<int, NTW>) for the D chunk of 8 * NTW columns
// that kernels 3 and 5 take at width D (kernel 4 up to D 192)
template <typename F>
cudaError_t with_chunk(int D, F&& f) {
  if (D <= 64) return f(std::integral_constant<int, 8>());
  if (D <= 128) return f(std::integral_constant<int, 16>());
  return f(std::integral_constant<int, 24>());
}

// Launch `kernel` on `blocks` blocks of NT threads in clusters of `cluster`
// blocks (blocks a multiple of it), with `bytes` of shared memory
template <typename Kernel, typename... Params>
cudaError_t launch_clusters(Kernel kernel, long blocks, int cluster, int bytes,
                            cudaStream_t stream, Params... params) {
  if (blocks > 0x7fffffffL || blocks % cluster != 0) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, params...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace band
}  // namespace s2s
