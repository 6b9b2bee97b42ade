// Fused relative-position attention scores, backward: the diagonal-reduction
// pair (bwd="pallas"), dq_v and the table gradient in two launches, both on
// the tensor cores.
//
// Replaces the TPU kernels of seq2seq_vc_tpu/ops/rel_scores.py launched by
// `_scores_core.core_bwd` with bwd="pallas":
//   - rel_scores_bwd_dqv  <- `_dqv_kernel`  (kernel 4)
//   - rel_scores_bwd_dpos <- `_dtab_kernel` (kernel 5)
// They compute what kernel 3 (csrc/rel_scores_bwd.cu) computes in one
// launch, split into its two outputs, and run its two halves' tiles
// (csrc/rel_band_tiles.cuh) as kernels of their own. With g the float32
// cotangent of the (B, H, T, T) scores and scale = 1/sqrt(D):
//
//   dq_v[b,h,i] = scale * sum_j g[b,h,i,j] * pos[h, T-1-i+j]
//   dpos[h,r]   = scale * sum_b sum_i g[b,h,i, i+r-(T-1)] * q_v[b,h,i]
//
// - dq_v: `band::dqv_block`. A block owns 64 query rows of one (b, h) and a
//   D chunk, and walks the T+63 table rows its queries touch in steps of
//   64: acc(64, DC) += G . pos in mma.sync m16n8k16, the 64 x 64 G tile
//   read straight from g along its diagonals (as bf16 hi + lo planes) and
//   the table rows staged by cp.async, two buffers. The chunk varies
//   fastest over the grid, so the blocks that read the same g rows run
//   side by side and the re-reads hit L2.
// - dpos: `band::dpos_block`. A block owns 64 table rows of one head and a
//   D chunk, and walks, for the batch items of its group in order, the
//   query rows whose diagonal reaches them, acc += G^T . q_v; the groups of
//   one tile form a cluster that adds their float32 sums in rank order.
// Deterministic, no atomics. float32 (the card's reference path) runs the
// same tiles in FMA, no TF32.
//
// The TPU kernels' reversed table, `_block_rel_unshift_flipped` and the
// (H, n_tab, B, n_q) grid with a resident accumulator were Mosaic
// workarounds and have no counterpart here.
//
// Bound: g (B*H*T*T float32) dominates the bytes of each launch (both read
// all of it); the work is B*H*T*T*D multiply-adds for each output, which
// the tensor-core rate leaves near the bytes of g at the training step's
// shapes. Both pay twice the products (hi + lo) and walk the zero edge
// triangles of each band tile; g comes by 4-byte loads (its diagonal runs
// are not 16-byte aligned). dq_v's D chunk and blocks an SM are its own
// (launch_dqv, rel_scores_bwd_dqv_kernel below).
#include <stdint.h>

#include "rel_band_tiles.cuh"

namespace {

namespace band = s2s::band;

// ptxas budgets dq_v's registers for two blocks an SM: as fast as one on
// an H100 and no spill (three spill in bf16 and are slower).
template <typename T, int NTW>
__global__ void __launch_bounds__(band::NT, 2)
    rel_scores_bwd_dqv_kernel(band::Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  band::dqv_block<T, NTW>(a, (int)blockIdx.x, smem);
}

template <typename T, int NTW>
__global__ void __launch_bounds__(band::NT, 1)
    rel_scores_bwd_dpos_kernel(band::Args<T> a, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  band::dpos_block<T, NTW>(a, (int)blockIdx.x, n_groups, smem);
}

bool bad_shape(int B, int H, int L, int D) { return B <= 0 || H <= 0 || L <= 0 || D <= 0; }

template <typename T, int NTW>
cudaError_t launch_dqv_ntw(const band::Args<T>& a, cudaStream_t stream) {
  // a cluster of one: no block of dq_v shares its shared memory
  return band::launch_clusters(rel_scores_bwd_dqv_kernel<T, NTW>,
                               band::dqv_tiles<NTW>(a.B, a.H, a.L, a.D), 1,
                               band::Tiles<T, NTW>::BYTES, stream, a);
}

template <typename T>
cudaError_t launch_dqv(const float* g, const void* pos, void* dqv, int B, int H, int L, int D,
                       float scale, cudaStream_t stream) {
  const band::Args<T> a{g, nullptr, static_cast<const T*>(pos), static_cast<T*>(dqv), nullptr,
                        B, H, L, D, scale, s2s::tc::rows_aligned<T>(D, {pos})};
  auto run = [&](auto ntw) { return launch_dqv_ntw<T, decltype(ntw)::value>(a, stream); };
  // kernels 3 and 5's chunk up to D 192; past it 128-column chunks, which
  // were the faster on an H100 at D 768
  if (D > 192) return run(std::integral_constant<int, 16>());
  return band::with_chunk(D, run);
}

template <typename T, int NTW>
cudaError_t launch_dpos_ntw(const band::Args<T>& a, cudaStream_t stream) {
  int n_sm = 0;
  const cudaError_t err = band::device_sms(&n_sm);
  if (err != cudaSuccess) return err;
  const long tiles = band::dpos_tiles<NTW>(a.H, a.L, a.D);
  const int n_groups = band::dpos_groups(a.B, tiles, n_sm);
  return band::launch_clusters(rel_scores_bwd_dpos_kernel<T, NTW>, n_groups * tiles, n_groups,
                               band::Tiles<T, NTW>::BYTES, stream, a, n_groups);
}

template <typename T>
cudaError_t launch_dpos(const float* g, const void* qv, void* dpos, int B, int H, int L, int D,
                        float scale, cudaStream_t stream) {
  const band::Args<T> a{g, static_cast<const T*>(qv), nullptr, nullptr, static_cast<T*>(dpos),
                        B, H, L, D, scale, s2s::tc::rows_aligned<T>(D, {qv})};
  return band::with_chunk(
      D, [&](auto ntw) { return launch_dpos_ntw<T, decltype(ntw)::value>(a, stream); });
}

}  // namespace

// g: (B, H, L, L) fp32; q_v, dq_v: (B, H, L, D); pos, dpos: (H, 2L-1, D); all
// contiguous, q_v/pos/dq_v/dpos in the storage type `dtype`; scale =
// 1/sqrt(D). Each writes every element of its output and returns the
// launch's cudaError_t (0 = launched).
extern "C" int rel_scores_bwd_dqv(int dtype, const void* g, const void* qv, const void* pos,
                                  void* dqv, int B, int H, int L, int D, float scale,
                                  void* stream) {
  (void)qv;  // dq_v needs the table only; the argument list is the pair's
  if (bad_shape(B, H, L, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch_dqv<float>(gf, pos, dqv, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch_dqv<__nv_bfloat16>(gf, pos, dqv, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int rel_scores_bwd_dpos(int dtype, const void* g, const void* qv, const void* pos,
                                   void* dpos, int B, int H, int L, int D, float scale,
                                   void* stream) {
  (void)pos;  // the table gradient needs q_v only
  if (bad_shape(B, H, L, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  switch (dtype) {
    case s2s::kFloat32:
      return launch_dpos<float>(gf, qv, dpos, B, H, L, D, scale, s);
    case s2s::kBFloat16:
      return launch_dpos<__nv_bfloat16>(gf, qv, dpos, B, H, L, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
