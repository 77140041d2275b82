// Per-stratum (count, sum x*m, sum (x*m)*x) for Hopper (sm_90a), in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/stratified_stats.py:31
// (_stats_kernel, wrapper stratified_stats). On the TPU the segment
// reduction was recast as a one-hot matmul so that it ran on the MXU, with
// the three [1, S] accumulators carried in VMEM across the sequential
// grid. On this card blocks run in parallel and in no order, so nothing
// can be carried from one to the next; the reduction is the masked,
// deterministic segmented reduction of masked_reduce.cuh: per-thread
// folds, warp steps into per-warp rows in shared memory, and a cross-block
// sum in a fixed tree by the blocks that take the last tickets, all in one
// launch, without memset and without float atomics.
//
// What bounds it on this card: memory. The function needs every mask byte
// and the value and stratum id of each live slot, and writes 12 bytes per
// stratum: at the emission's [6 x 1,048,576] slots with about 0.75 of them
// live, about 44 MB, 0.0131 ms at 3.35 TB/s. Three adds and a multiply per
// live item are far below the f32 rate. What the design does about each
// limit of the earlier two-launch design (stats_partials and stats_final):
//   - dependent loads, one in flight per thread: a thread's loads are
//     vectors, issued together for a tile, and the next tile's values,
//     strata and the mask words after it are in flight while a tile is
//     reduced;
//   - 4- and 1-byte loads: 16-byte loads of values and stratum ids, a
//     vector's 4 mask bytes in one word, with a scalar head and tail for
//     a view that starts off a 16-byte boundary or a ragged M;
//   - bytes: a vector's values and stratum ids are read only if one of
//     its items is live;
//   - the walk over strata (two ballots and two butterflies per stratum
//     and item step): a thread folds its items of the warp's first key,
//     one butterfly per tile when a warp's items share a stratum (in the
//     emission's [G x N] view they almost always do); a warp with several
//     pays one segmented-tree step per item index still held;
//   - two launches (3,072 one-tile blocks, 2.9 waves, then a one-block
//     per stratum finish) and partials allocated per call: one launch of
//     at most 512 blocks walking the tiles with a grid stride, the
//     cross-block sum by tickets, the rows, tickets and count totals kept
//     in the caller's workspace.
//
// Every sum has one fixed shape for given tensors, so the result is the
// same from run to run, and it is tree-shaped, which keeps the rounding
// error of a sum of 10^6 f32 values near that of a pairwise sum. That
// matters for the Eq. 7 variance s2 = sumsqs - Y*mean^2, which cancels
// about three digits for a stratum with mean 10^4 and sigma 500.
// Sequential f32 additions per sum (masked_reduce.cuh): 31 at the
// emission's shape, at most 73. Counts are integers, so they are exact.
//
// Shared memory: 8 warps' rows of S (f32, f32) sums and one row of S
// int32 counts, so S <= 512 takes at most 34,816 B.

#include <cuda_runtime.h>
#include <stdint.h>

#include "masked_reduce.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 4)
    stats_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ sid,
                 const uint8_t* __restrict__ mask, Span sp, int s_cnt,
                 float* __restrict__ red, int32_t* __restrict__ zeroed,
                 float* __restrict__ counts, float* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);          // [kWarps][2][S]
  int32_t* cnt = reinterpret_cast<int32_t*>(rows + kWarps * 2 * s_cnt);
  const long long stride = gridDim.x;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int4 none4 = make_int4(-1, -1, -1, -1);
  // The pipeline: this tile's values and strata and the next tile's mask
  // words are in flight before the rows are cleared.
  uint32_t mk[kVecs], mk_next[kVecs];
  float4 x[kVecs];
  int4 s[kVecs];
  load_masks(mask, sp, blockIdx.x, mk);
  load_masks(mask, sp, blockIdx.x + stride, mk_next);
  load_tile(values, sp, blockIdx.x, mk, true, zero4, x);
  load_tile(sid, sp, blockIdx.x, mk, sp.vec & kIdsVec, none4, s);
  for (int k = threadIdx.x; k < kWarps * 2 * s_cnt; k += kThreads)
    rows[k] = 0.0f;
  for (int k = threadIdx.x; k < s_cnt; k += kThreads) cnt[k] = 0;
  __syncthreads();
  const long long n_tiles = ((sp.m + sp.d + 3) / 4 + kTileVecs - 1) /
                            kTileVecs;
  const int lane = threadIdx.x & 31;
  float* my_rows = rows + (threadIdx.x >> 5) * 2 * s_cnt;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += stride) {
    int key[kItems];
    float val[kItems][2];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int si = lane_of(s[k], i);
        const float xi = lane_of(x[k], i);
        key[4 * k + i] =
            byte_on(mk[k], i) && si >= 0 && si < s_cnt ? si : -1;
        val[4 * k + i][0] = xi;
        val[4 * k + i][1] = __fmul_rn(xi, xi);
      }
    // The next tile's values and strata and the mask words after it, in
    // flight while this tile is reduced.
    uint32_t mk_after[kVecs];
    load_tile(values, sp, tile + stride, mk_next, true, zero4, x);
    load_tile(sid, sp, tile + stride, mk_next, sp.vec & kIdsVec, none4, s);
    load_masks(mask, sp, tile + 2 * stride, mk_after);
    reduce_items<2>(key, val, my_rows, cnt, s_cnt, lane);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      mk[k] = mk_next[k];
      mk_next[k] = mk_after[k];
    }
  }
  __syncthreads();
  finish<2>(rows, cnt, s_cnt, red, zeroed, sums, counts);
}

}  // namespace

// Words (f32) of the workspace rows a call of m items over S strata
// needs; the zeroed words are sa_reduce_zeroed(S) int32.
extern "C" long long sa_stats_scratch_words(long long m, int s_cnt) {
  return scratch_words(m, s_cnt, 2);
}

// Outputs: counts f32 [S], then sums and sumsqs f32 [S] contiguous
// (sums[0..S) and sums[S..2S)). red and zeroed are the caller's
// workspace; the kernel leaves the zeroed words 0.
extern "C" int sa_stratified_stats(const void* values, const void* sid,
                                   const void* mask, long long m, int s_cnt,
                                   void* red, void* zeroed, void* counts,
                                   void* sums, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = (size_t)(2 * kWarps + 1) * s_cnt * 4;
  const cudaError_t err = allow_smem(stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<grid_blocks(m), kThreads, smem, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(sid),
      static_cast<const uint8_t*>(mask),
      make_span(m, values, mask, sid, nullptr), s_cnt,
      static_cast<float*>(red), static_cast<int32_t*>(zeroed),
      static_cast<float*>(counts), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
