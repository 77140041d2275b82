// Device code of the OASRS reservoir fold, shared by reservoir_fold.cu and
// one_shot_ingest.cu (each includes it into its own anonymous namespace,
// so the two objects link without clashing symbols).
//
// The fold is the parallel rank/scatter-max form of the reference's
// core/oasrs.py::apply_chunk_uniforms, bitwise equal to the sequential
// Vitter fold:
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
// Arithmetic is kept exactly the reference's f32: __int2float_rn for the
// counts, __fmul_rn for u*c and u_slot*N (never contracted into an FMA;
// the library is also built with -fmad=false), floorf, then the clamp to
// [0, max(N_s - 1, 0)].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;               // items per block, one per thread
constexpr int kWarps = kTile / 32;
constexpr int kScanThreads = 1024;

// The item's stratum, or the sentinel S when it is out of the chunk, not
// masked, or has no valid stratum. A null mask means every item is masked
// in (the one-shot ingest passes precomputed cells, sentinel included).
__device__ __forceinline__ int live_stratum(const int32_t* sid,
                                            const uint8_t* mask, int j, int m,
                                            int s_cnt) {
  if (j >= m || (mask != nullptr && !mask[j])) return s_cnt;
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
