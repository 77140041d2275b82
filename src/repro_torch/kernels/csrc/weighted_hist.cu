// Per-(cell, bin) HT-weighted mass and sampled-item count for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/weighted_hist.py::_whist_kernel
// (wrapper weighted_hist). On the TPU bin and cell membership were one-hot
// comparisons and the [G, B] accumulation two one-hot matmuls per item
// tile on the MXU, with the accumulators carried in VMEM across the
// sequential grid. Here an item's bin is found by a binary search over
// the edges held in shared memory, and the reduction is done in two
// deterministic passes, without float atomics and without tensor cores:
//
//   1. whist_partials  a fixed number of blocks walk the item tiles in a
//                      fixed order. Per step the lanes of a warp that share
//                      a (cell, bin) key are grouped by __match_any_sync,
//                      and each group's weights are summed by a segmented
//                      shuffle tree: at each of five levels a lane adds the
//                      partial of its group's lowest lane in the other half
//                      of its block, so every member ends with the same
//                      sum whatever the group's shape. The group's lowest
//                      lane adds that sum and the group's size to its
//                      warp's own row of accumulators in shared memory
//                      (one writer per key and warp, so no race). The rows
//                      are then summed in warp order into the block's
//                      partials [G*B, n_blocks].
//   2. whist_final     one block per key sums the block partials in a
//                      fixed order (a strided per-thread sum, a shuffle
//                      tree, the warps in order).
//
// Every sum has one fixed shape, so a second run gives the same bits:
// quantile refinement picks bins by searchsorted over cumulative masses,
// and a flip from run to run would change its answer. Counts are summed
// as integers and converted at the end, so they are exact. At the
// emission's 6,291,456 slots the mass of a key passes through at most
// about 55 sequential f32 additions (group tree, warp row, warps, block
// partials), which bounds its relative error by about 3.5e-6 for the
// positive weights it sums.
//
// Why a shuffle tree and not a serial sum in the group's lowest lane: the
// first round of quantile refinement puts nearly every flow size in bin 0,
// so whole warps share one key, and a serial sum is then a chain of 32
// dependent steps per item step; the tree costs five for any group shape.
//
// Bins. Bin b is [e_b, e_{b+1}) and the last bin is right-closed, as the
// reference's comparisons x >= lo, x < hi, x <= hi (last bin) say. The
// search finds the largest b <= B-1 with e_b <= x; the item is kept if
// x < e_{b+1}, or if b == B-1 and x <= e_B. For non-decreasing edges this
// is exactly the comparisons, duplicate edges included: when all B+1
// edges are equal (the collapsed bracket of a window of one repeated
// value), every such value lands in the last bin. NaN values, values
// below e_0 or above e_B, masked-out items and cell ids outside [0, G)
// add nothing.
//
// What bounds it on this card: memory. Per item it reads 13 bytes (f32
// value, i32 cell id, f32 weight, bool mask) and does about log2(B) + 3
// comparisons and one add; the edges and the accumulators stay in shared
// memory, and the workspace is G*B*n_blocks*8 bytes (1.5 MB at G*B = 192).
//
// Shared memory limits G*B: kWarps rows of G*B (int, float) accumulators
// plus the edges must fit the 227 KB a block can use, so G*B <= 3200 (the
// wrapper's MAX_CELLS_BINS).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerThread = 8;
constexpr int kTile = kThreads * kItemsPerThread;
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The bin of x over the edges e[0..nb], or -1 if no bin holds it.
__device__ __forceinline__ int find_bin(const float* e, int nb, float x) {
  if (!(e[0] <= x)) return -1;               // below e_0, or NaN
  int lo = 0, hi = nb - 1;                   // largest b with e_b <= x
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (e[mid] <= x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const bool keep = x < e[lo + 1] || (lo == nb - 1 && x <= e[nb]);
  return keep ? lo : -1;
}

__global__ void whist_partials(const float* __restrict__ values,
                               const int32_t* __restrict__ cell_ids,
                               const float* __restrict__ weights,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ edges, int64_t m,
                               int g_cnt, int nb, int n_blocks,
                               int32_t* __restrict__ part_cnt,
                               float* __restrict__ part_mass) {
  extern __shared__ unsigned char smem[];
  const int keys = g_cnt * nb;
  int32_t* w_cnt = reinterpret_cast<int32_t*>(smem);       // [kWarps][keys]
  float* w_mass = reinterpret_cast<float*>(w_cnt + kWarps * keys);
  float* e = w_mass + kWarps * keys;                       // [nb + 1]
  for (int k = threadIdx.x; k < kWarps * keys; k += kThreads) {
    w_cnt[k] = 0;
    w_mass[k] = 0.0f;
  }
  for (int k = threadIdx.x; k <= nb; k += kThreads) e[k] = edges[k];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* my_cnt = w_cnt + warp * keys;
  float* my_mass = w_mass + warp * keys;
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += n_blocks) {
    const int64_t base = tile * kTile;
    for (int it = 0; it < kItemsPerThread; ++it) {
      const int64_t j = base + (int64_t)it * kThreads + threadIdx.x;
      int key = -1;
      float w = 0.0f;
      if (j < m && mask[j]) {
        const int c = cell_ids[j];
        if (c >= 0 && c < g_cnt) {
          const int b = find_bin(e, nb, values[j]);
          if (b >= 0) {
            key = c * nb + b;
            w = weights[j];
          }
        }
      }
      const unsigned peers = __match_any_sync(kFull, key);
      // Segmented tree: after level d, s is the group's sum over this
      // lane's aligned block of 2d lanes. The other half's partial is read
      // from its lowest lane in the group (all of them hold the same one).
      float s = w;
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned other =
            (((1u << d) - 1u) << ((lane ^ d) & ~(d - 1))) & peers;
        const float got =
            __shfl_sync(kFull, s, other ? __ffs(other) - 1 : lane);
        if (other) s = __fadd_rn(s, got);
      }
      if (key >= 0 && lane == __ffs(peers) - 1) {
        my_cnt[key] += __popc(peers);
        my_mass[key] = __fadd_rn(my_mass[key], s);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < keys; k += kThreads) {
    int32_t c = 0;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      c += w_cnt[w * keys + k];
      s = __fadd_rn(s, w_mass[w * keys + k]);
    }
    const int64_t o = (int64_t)k * n_blocks + blockIdx.x;
    part_cnt[o] = c;
    part_mass[o] = s;
  }
}

// One block per (cell, bin) key: the block partials in a fixed order.
__global__ void whist_final(const int32_t* __restrict__ part_cnt,
                            const float* __restrict__ part_mass, int n_blocks,
                            float* __restrict__ whist,
                            float* __restrict__ counts) {
  __shared__ int32_t r_cnt[kWarps];
  __shared__ float r_mass[kWarps];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)k * n_blocks;
  int32_t c = 0;
  float s = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    c += part_cnt[row + b];
    s = __fadd_rn(s, part_mass[row + b]);
  }
  c = warp_sum_int(c);
  s = warp_sum(s);
  if (lane == 0) {
    r_cnt[warp] = c;
    r_mass[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t tc = 0;
    float ts = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      tc += r_cnt[w];
      ts = __fadd_rn(ts, r_mass[w]);
    }
    whist[k] = ts;
    counts[k] = (float)tc;
  }
}

size_t partials_smem(int g_cnt, int nb) {
  return (size_t)kWarps * g_cnt * nb * 8 + (size_t)(nb + 1) * 4;
}

}  // namespace

// Blocks of the partials pass for m items (the workspace's second dim).
extern "C" int sa_whist_blocks(long long m) {
  const long long tiles = (m + kTile - 1) / kTile;
  return (int)(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

// Scratch (allocated by the caller): part_cnt int32 and part_mass f32,
// each [G*B, n_blocks] with n_blocks = sa_whist_blocks(m). Outputs whist
// and counts are f32 [G, B].
extern "C" int sa_weighted_hist(const void* values, const void* cell_ids,
                                const void* weights, const void* mask,
                                const void* edges, long long m, int g_cnt,
                                int nb, void* part_cnt, void* part_mass,
                                void* whist, void* counts, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_blocks = sa_whist_blocks(m);
  const int keys = g_cnt * nb;
  if (n_blocks == 0) {
    cudaMemsetAsync(whist, 0, sizeof(float) * keys, stream);
    cudaMemsetAsync(counts, 0, sizeof(float) * keys, stream);
    return (int)cudaGetLastError();
  }
  const size_t smem = partials_smem(g_cnt, nb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        whist_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  whist_partials<<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(cell_ids),
      static_cast<const float*>(weights), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(edges), (int64_t)m, g_cnt, nb, n_blocks,
      static_cast<int32_t*>(part_cnt), static_cast<float*>(part_mass));
  whist_final<<<keys, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(part_cnt),
      static_cast<const float*>(part_mass), n_blocks,
      static_cast<float*>(whist), static_cast<float*>(counts));
  return (int)cudaGetLastError();
}
