// OASRS reservoir fold for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/reservoir.py::_fold_kernel
// (wrapper reservoir_fold). That kernel walks the chunk item by item in a
// fori_loop with the [S, N_max] reservoirs pinned in VMEM: one core, one
// item at a time. Here the same exact sequential Vitter semantics come
// from the parallel rank/scatter-max form of the reference's
// core/oasrs.py::apply_chunk_uniforms, which is bitwise equal to it:
//
//   1. fold_tile_counts   per-tile per-stratum counts of live items;
//   2. fold_tile_scan     exclusive scan of those counts over tiles, per
//                         stratum, and the new counts = counts + totals;
//   3. fold_decide        each item's in-tile rank, recomputed in item
//                         order (warp __match_any_sync + per-warp counts
//                         in shared memory), its arrival index
//                         c = counts[s] + rank + 1, the f32 acceptance
//                         test u*c < N_s, the slot, and
//                         atomicMax(winner[cell], j) so that the last
//                         accepted writer of each cell wins;
//   4. fold_write         every accepted item that won its cell copies its
//                         payload into the ring, in place.
//
// What bounds it on this card: memory. Per item it reads 17 bytes (sid,
// payload, two uniforms, mask) and does a few integer operations; the
// ring writes are one 4-byte store per won cell. The design streams the
// items with coalesced loads, keeps all per-tile bookkeeping in shared
// memory and registers, and touches the [S, N_max] ring only at cells
// that accepted items win: never a full pass over the ring. The one
// dense cost is clearing the winner table (4 bytes per ring cell, one
// cudaMemsetAsync); it keeps the kernel simple and is the first thing a
// faster version would remove.
//
// Arithmetic is kept exactly the reference's f32: __int2float_rn for the
// counts, __fmul_rn for u*c and u_slot*N (never contracted into an FMA;
// the library is also built with -fmad=false), floorf, then the clamp to
// [0, max(N_s - 1, 0)].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;               // items per block, one per thread
constexpr int kWarps = kTile / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int live_stratum(const int32_t* sid,
                                            const uint8_t* mask, int j, int m,
                                            int s_cnt) {
  if (j >= m || !mask[j]) return s_cnt;   // sentinel stratum S
  int s = sid[j];
  return (s < 0 || s >= s_cnt) ? s_cnt : s;
}

__global__ void fold_tile_counts(const int32_t* __restrict__ sid,
                                 const uint8_t* __restrict__ mask, int m,
                                 int s_cnt, int n_tiles,
                                 int32_t* __restrict__ tile_counts) {
  extern __shared__ int32_t cnt[];        // [S + 1]
  for (int k = threadIdx.x; k <= s_cnt; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  int j = blockIdx.x * kTile + threadIdx.x;
  atomicAdd(&cnt[live_stratum(sid, mask, j, m, s_cnt)], 1);
  __syncthreads();
  for (int k = threadIdx.x; k < s_cnt; k += blockDim.x)
    tile_counts[(int64_t)k * n_tiles + blockIdx.x] = cnt[k];
}

// One block per stratum: exclusive scan of its per-tile counts.
__global__ void fold_tile_scan(const int32_t* __restrict__ tile_counts,
                               int n_tiles,
                               const int32_t* __restrict__ counts,
                               int32_t* __restrict__ tile_offsets,
                               int32_t* __restrict__ counts_out) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t carry;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* row = tile_counts + (int64_t)s * n_tiles;
  int32_t* out = tile_offsets + (int64_t)s * n_tiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    int b = base + threadIdx.x;
    int32_t v = b < n_tiles ? row[b] : 0;
    int32_t incl = v;                     // inclusive warp scan
    for (int d = 1; d < 32; d <<= 1) {
      int32_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
      int32_t wi = w;
      for (int d = 1; d < 32; d <<= 1) {
        int32_t t = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += t;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = wi - w;  // exclusive
    }
    __syncthreads();
    int32_t c0 = carry;
    if (b < n_tiles) out[b] = c0 + warp_sums[warp] + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = c0 + warp_sums[warp] + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts_out[s] = counts[s] + carry;
}

__global__ void fold_decide(const int32_t* __restrict__ sid,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ u_accept,
                            const float* __restrict__ u_slot, int m,
                            int s_cnt, int n_max, int n_tiles,
                            const int32_t* __restrict__ counts,
                            const int32_t* __restrict__ capacity,
                            const int32_t* __restrict__ tile_offsets,
                            int32_t* __restrict__ cell,
                            int32_t* __restrict__ winner) {
  extern __shared__ int32_t wc[];         // [kWarps][S + 1] warp counts
  const int stride = s_cnt + 1;
  for (int k = threadIdx.x; k < kWarps * stride; k += blockDim.x) wc[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int s = live_stratum(sid, mask, j, m, s_cnt);
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  int rank = __popc(peers & ((1u << lane) - 1u));
  if (lane == __ffs(peers) - 1) wc[warp * stride + s] = __popc(peers);
  __syncthreads();
  for (int w = 0; w < warp; ++w) rank += wc[w * stride + s];
  if (j >= m) return;
  int32_t out = -1;
  if (s < s_cnt) {
    const int c = counts[s] + tile_offsets[(int64_t)s * n_tiles + blockIdx.x]
                  + rank + 1;
    const int cap = capacity[s];
    const float capf = __int2float_rn(cap);
    const bool filling = c <= cap;
    const bool replace = __fmul_rn(u_accept[j], __int2float_rn(c)) < capf;
    if (filling || replace) {
      int slot;
      if (filling) {
        slot = c - 1;
      } else {
        slot = (int)floorf(__fmul_rn(u_slot[j], capf));
        slot = min(max(slot, 0), max(cap - 1, 0));
      }
      out = s * n_max + slot;
      atomicMax(&winner[out], j);
    }
  }
  cell[j] = out;
}

__global__ void fold_write(const uint32_t* __restrict__ payload, int m,
                           const int32_t* __restrict__ cell,
                           const int32_t* __restrict__ winner,
                           uint32_t* __restrict__ values) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= m) return;
  const int f = cell[j];
  if (f >= 0 && winner[f] == j) values[f] = payload[j];
}

}  // namespace

// Scratch (allocated by the caller): tile_counts and tile_offsets are
// [S, n_tiles] int32, cell is [M] int32, winner is [S * N_max] int32.
// values and payload are 4-byte words (f32 or i32), copied as bits.
extern "C" int sa_reservoir_fold(const void* sid, const void* payload,
                                 const void* u_accept, const void* u_slot,
                                 const void* mask, const void* counts,
                                 const void* capacity, void* values,
                                 void* counts_out, void* tile_counts,
                                 void* tile_offsets, void* cell, void* winner,
                                 int m, int s_cnt, int n_max,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 0;
  cudaMemsetAsync(winner, 0xFF, sizeof(int32_t) * (size_t)s_cnt * n_max,
                  stream);
  if (n_tiles == 0) {
    cudaMemcpyAsync(counts_out, counts, sizeof(int32_t) * s_cnt,
                    cudaMemcpyDeviceToDevice, stream);
    return (int)cudaGetLastError();
  }
  const auto* sid_p = static_cast<const int32_t*>(sid);
  const auto* mask_p = static_cast<const uint8_t*>(mask);
  auto* tc = static_cast<int32_t*>(tile_counts);
  auto* to = static_cast<int32_t*>(tile_offsets);
  auto* cell_p = static_cast<int32_t*>(cell);
  auto* win_p = static_cast<int32_t*>(winner);
  fold_tile_counts<<<n_tiles, kTile, sizeof(int32_t) * (s_cnt + 1),
                     stream>>>(sid_p, mask_p, m, s_cnt, n_tiles, tc);
  fold_tile_scan<<<s_cnt, kScanThreads, 0, stream>>>(
      tc, n_tiles, static_cast<const int32_t*>(counts), to,
      static_cast<int32_t*>(counts_out));
  fold_decide<<<n_tiles, kTile, sizeof(int32_t) * kWarps * (s_cnt + 1),
                stream>>>(sid_p, mask_p, static_cast<const float*>(u_accept),
                          static_cast<const float*>(u_slot), m, s_cnt, n_max,
                          n_tiles, static_cast<const int32_t*>(counts),
                          static_cast<const int32_t*>(capacity), to, cell_p,
                          win_p);
  fold_write<<<n_tiles, kTile, 0, stream>>>(
      static_cast<const uint32_t*>(payload), m, cell_p, win_p,
      static_cast<uint32_t*>(values));
  return (int)cudaGetLastError();
}
