// Per-stratum (count, sum x*m, sum (x*m)*x) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/stratified_stats.py::_stats_kernel
// (wrapper stratified_stats). On the TPU the segment reduction was recast
// as a one-hot matmul so that it ran on the MXU, with the three [1, S]
// accumulators carried in VMEM across the sequential grid. On this card
// blocks run in parallel and in no order, so nothing can be carried from
// one to the next; the reduction is done in two passes instead:
//
//   1. stats_partials  each block reduces a tile of kTile items. A warp
//                      walks the distinct strata among its 32 items
//                      (ballot + shuffle of the first pending lane's
//                      stratum), reduces each stratum's values with a
//                      butterfly of shuffles, and lane 0 adds the result
//                      to that warp's row of the per-warp partials in
//                      shared memory. The warps' rows are then summed in
//                      warp order into the block's partials [S, nblocks].
//   2. stats_final     one block per stratum sums the block partials in a
//                      fixed order (a strided per-thread sum, then a
//                      shuffle tree, then the warps in order).
//
// There is no float atomicAdd anywhere: every sum has one fixed shape,
// so the result is the same from run to run, and it is tree-shaped, which
// keeps the rounding error of a sum of 10^6 f32 values near that of a
// pairwise sum. That matters for the Eq. 7 variance s2 = sumsqs - Y*mean^2,
// which cancels about three digits for a stratum with mean 10^4 and
// sigma 500. Counts are summed as integers, so they are exact.
//
// What bounds it on this card: memory. Per item it reads 9 bytes (f32
// value, i32 stratum id, bool mask) and does three adds and a multiply;
// the output is 12 bytes per stratum. The loads are coalesced; in the
// emission's flattened [G*N] view a warp's 32 items almost always share
// one stratum, so the walk over distinct strata is one step per warp.
//
// Shared memory limits S: kWarps rows of S (int, float, float) partials
// must fit in the default 48 KB, so S <= 512 (8 * 512 * 12 B = 48 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerThread = 8;
constexpr int kTile = kThreads * kItemsPerThread;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__global__ void stats_partials(const float* __restrict__ values,
                               const int32_t* __restrict__ sid,
                               const uint8_t* __restrict__ mask, int64_t m,
                               int s_cnt, int n_blocks,
                               int32_t* __restrict__ part_cnt,
                               float* __restrict__ part_sum,
                               float* __restrict__ part_sq) {
  extern __shared__ unsigned char smem[];
  int32_t* w_cnt = reinterpret_cast<int32_t*>(smem);          // [kWarps][S]
  float* w_sum = reinterpret_cast<float*>(w_cnt + kWarps * s_cnt);
  float* w_sq = w_sum + kWarps * s_cnt;
  for (int k = threadIdx.x; k < kWarps * s_cnt; k += kThreads) {
    w_cnt[k] = 0;
    w_sum[k] = 0.0f;
    w_sq[k] = 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int it = 0; it < kItemsPerThread; ++it) {
    const int64_t j = base + (int64_t)it * kThreads + threadIdx.x;
    bool live = j < m && mask[j];
    int s = -1;
    float x = 0.0f;
    if (live) {
      s = sid[j];
      live = s >= 0 && s < s_cnt;
      x = values[j];
    }
    unsigned pending = __ballot_sync(kFull, live);
    while (pending) {
      const int t = __shfl_sync(kFull, s, __ffs(pending) - 1);
      const bool mine = live && s == t;
      const unsigned group = __ballot_sync(kFull, mine);
      const float sx = warp_sum(mine ? x : 0.0f);
      const float sq = warp_sum(mine ? __fmul_rn(x, x) : 0.0f);
      if (lane == 0) {
        w_cnt[warp * s_cnt + t] += __popc(group);
        w_sum[warp * s_cnt + t] = __fadd_rn(w_sum[warp * s_cnt + t], sx);
        w_sq[warp * s_cnt + t] = __fadd_rn(w_sq[warp * s_cnt + t], sq);
      }
      pending &= ~group;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s_cnt; k += kThreads) {
    int32_t c = 0;
    float a = 0.0f, q = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      c += w_cnt[w * s_cnt + k];
      a = __fadd_rn(a, w_sum[w * s_cnt + k]);
      q = __fadd_rn(q, w_sq[w * s_cnt + k]);
    }
    const int64_t o = (int64_t)k * n_blocks + blockIdx.x;
    part_cnt[o] = c;
    part_sum[o] = a;
    part_sq[o] = q;
  }
}

// One block per stratum: the block partials in a fixed order.
__global__ void stats_final(const int32_t* __restrict__ part_cnt,
                            const float* __restrict__ part_sum,
                            const float* __restrict__ part_sq, int n_blocks,
                            float* __restrict__ counts,
                            float* __restrict__ sums,
                            float* __restrict__ sumsqs) {
  __shared__ int32_t r_cnt[kWarps];
  __shared__ float r_sum[kWarps], r_sq[kWarps];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)s * n_blocks;
  int32_t c = 0;
  float a = 0.0f, q = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    c += part_cnt[row + b];
    a = __fadd_rn(a, part_sum[row + b]);
    q = __fadd_rn(q, part_sq[row + b]);
  }
  c = warp_sum_int(c);
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) {
    r_cnt[warp] = c;
    r_sum[warp] = a;
    r_sq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t tc = 0;
    float ta = 0.0f, tq = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      tc += r_cnt[w];
      ta = __fadd_rn(ta, r_sum[w]);
      tq = __fadd_rn(tq, r_sq[w]);
    }
    counts[s] = (float)tc;
    sums[s] = ta;
    sumsqs[s] = tq;
  }
}

}  // namespace

extern "C" int sa_stats_tile_items() { return kTile; }

// Scratch (allocated by the caller): part_cnt int32, part_sum and part_sq
// f32, each [S, n_blocks] with n_blocks = ceil(M / sa_stats_tile_items()).
extern "C" int sa_stratified_stats(const void* values, const void* sid,
                                   const void* mask, long long m, int s_cnt,
                                   void* part_cnt, void* part_sum,
                                   void* part_sq, void* counts, void* sums,
                                   void* sumsqs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_blocks = (int)((m + kTile - 1) / kTile);
  if (n_blocks == 0) {
    cudaMemsetAsync(counts, 0, sizeof(float) * s_cnt, stream);
    cudaMemsetAsync(sums, 0, sizeof(float) * s_cnt, stream);
    cudaMemsetAsync(sumsqs, 0, sizeof(float) * s_cnt, stream);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)kWarps * s_cnt * 3 * 4;
  stats_partials<<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(sid),
      static_cast<const uint8_t*>(mask), (int64_t)m, s_cnt, n_blocks,
      static_cast<int32_t*>(part_cnt), static_cast<float*>(part_sum),
      static_cast<float*>(part_sq));
  stats_final<<<s_cnt, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(part_cnt),
      static_cast<const float*>(part_sum), static_cast<const float*>(part_sq),
      n_blocks, static_cast<float*>(counts), static_cast<float*>(sums),
      static_cast<float*>(sumsqs));
  return (int)cudaGetLastError();
}
