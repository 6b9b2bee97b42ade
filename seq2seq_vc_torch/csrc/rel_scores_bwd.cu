// Fused relative-position attention scores, backward: dq_v and the table
// gradient (new-style rel-pos), on the tensor cores.
//
// Replaces the TPU kernel `_banded_bwd_kernel` of
// seq2seq_vc_tpu/ops/rel_scores.py (launched by `_scores_core.core_bwd`
// with bwd="banded"). With g the float32 cotangent of the (B, H, T, T)
// scores and scale = 1/sqrt(D):
//
//   dq_v[b,h,i]  = scale * sum_r G[b,h,i,r] * pos[h,r]
//   dpos[h,r]    = scale * sum_b sum_i G[b,h,i,r] * q_v[b,h,i]
//   G[b,h,i,r]   = g[b,h,i, i+r-(T-1)]   (zero where that key leaves [0,T))
//
// G is the (T, 2T-1) band cotangent. Both results are products with G,
// which never reaches device memory: a tile reads it straight from g along
// its diagonals, and both halves are mma.sync m16n8k16 products over 64 x 64
// G tiles (csrc/rel_band_tiles.cuh: G staged as bf16 hi + lo planes, the
// table or q_v by cp.async, two buffers, D in chunks of DC = 64, 128 or 192
// columns a block):
//
// - dq_v: a block owns 64 query rows and a D chunk, and walks the T+63
//   table rows its queries touch: acc(64, DC) += G . pos (`band::dqv_block`,
//   which kernel 4, csrc/rel_scores_bwd_pair.cu, runs alone);
// - dpos: a block owns 64 table rows and a D chunk, and walks every (b, i)
//   of its group of batch items whose g row reaches them: acc(64, DC) +=
//   G^T . q_v (`band::dpos_block`, which kernel 5 runs alone). The groups
//   of one tile form a cluster, which adds their float32 sums in rank order
//   through distributed shared memory.
//
// One launch runs both, in clusters of the group count: the grid's first
// blocks are the dpos tiles (each walks its group's rows of g), the rest
// the dq_v tiles (T+63 table rows each), so the short dq_v tiles fill the
// SMs while the long dpos tiles run. In each half the D chunk (or the
// group) varies fastest, so the blocks that share a g tile run side by side.
// No atomics: deterministic.
//
// The Pallas kernel's reversed table, `_block_rel_unshift_flipped`, its
// 128-multiple tiles and the VMEM-resident (2*t_pad, qw) table gradient
// were Mosaic workarounds and have no counterpart here.
//
// Bound: g (B*H*T*T fp32) dominates the bytes, and the work is
// 2*B*H*T*T*D multiply-adds (T*(2T-1) band cells per head, half of them
// zero, times D, for each of the two products). At D 768 the operations
// bound it; at D 192 and the training step's lengths, the bytes of g come
// close. This version pays twice the tensor-core products (hi + lo), walks
// the zero half of each band's edge tiles, and stages g with 4-byte loads
// (its rows' runs are not 16-byte aligned); wgmma, TMA and persistent
// blocks are later work.
#include <stdint.h>

#include "rel_band_tiles.cuh"

namespace {

namespace band = s2s::band;
namespace tc = s2s::tc;

template <typename T, int NTW>
__global__ void __launch_bounds__(band::NT, 1)
    rel_scores_bwd_kernel(band::Args<T> a, int n_groups, int n_dpos_blocks, int n_dqv_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = (int)blockIdx.x;
  if (blk < n_dpos_blocks) {
    band::dpos_block<T, NTW>(a, blk, n_groups, smem);
  } else if (blk - n_dpos_blocks < n_dqv_blocks) {
    band::dqv_block<T, NTW>(a, blk - n_dpos_blocks, smem);
  }  // else: padding of the last cluster
}

template <typename T, int NTW>
cudaError_t launch_ntw(const band::Args<T>& a, cudaStream_t stream) {
  int n_sm = 0;
  const cudaError_t err = band::device_sms(&n_sm);
  if (err != cudaSuccess) return err;
  const long tiles = band::dpos_tiles<NTW>(a.H, a.L, a.D);
  const int n_groups = band::dpos_groups(a.B, tiles, n_sm);
  const long n_dpos = n_groups * tiles;
  const long n_dqv = band::dqv_tiles<NTW>(a.B, a.H, a.L, a.D);
  const long blocks = n_dpos + (n_dqv + n_groups - 1) / n_groups * n_groups;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  return band::launch_clusters(rel_scores_bwd_kernel<T, NTW>, blocks, n_groups,
                               band::Tiles<T, NTW>::BYTES, stream, a, n_groups, (int)n_dpos,
                               (int)n_dqv);
}

template <typename T>
cudaError_t launch(const float* g, const void* qv, const void* pos, void* dqv, void* dpos,
                   int B, int H, int L, int D, float scale, cudaStream_t stream) {
  const band::Args<T> a{g, static_cast<const T*>(qv), static_cast<const T*>(pos),
                        static_cast<T*>(dqv), static_cast<T*>(dpos), B, H, L, D, scale,
                        tc::rows_aligned<T>(D, {qv, pos})};
  return band::with_chunk(
      D, [&](auto ntw) { return launch_ntw<T, decltype(ntw)::value>(a, stream); });
}

}  // namespace

// g: (B, H, L, L) fp32; q_v, dq_v: (B, H, L, D); pos, dpos: (H, 2L-1, D);
// all contiguous, q_v/pos/dq_v/dpos in the storage type `dtype`. Writes
// every element of dq_v and dpos. Returns the launch's cudaError_t (0 = launched).
extern "C" int rel_scores_bwd(int dtype, const void* g, const void* qv, const void* pos,
                              void* dqv, void* dpos, int B, int H, int L, int D,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch<float>(gf, qv, pos, dqv, dpos, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch<__nv_bfloat16>(gf, qv, pos, dqv, dpos, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
