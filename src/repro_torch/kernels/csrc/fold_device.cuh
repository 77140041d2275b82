// Device code of the OASRS reservoir fold, shared by reservoir_fold.cu and
// one_shot_ingest.cu (each includes it into its own anonymous namespace,
// so the two objects link without clashing symbols). Its names live in
// namespace fold there: stratified_stats.cu and weighted_hist.cu include
// it (through parted_claim.cuh) beside masked_reduce.cuh, whose block
// shape (kThreads, kItems, ...) is another.
//
// The fold is the parallel rank/scatter-max form of the reference's
// core/oasrs.py::apply_chunk_uniforms, bitwise equal to the sequential
// Vitter fold. Item j of cell s is the c-th arrival of its cell,
//
//   c = counts[s] + (live items of s before j in the chunk) + 1,
//
// accepted if c <= N_s or u*c < N_s (f32), into slot c - 1 or
// clamp(floor(u_slot * N_s)); the last accepted writer of a ring cell
// wins it. Two passes, because one grid-wide dependency is real: every
// claim on a ring cell must be in before any write.
//
//   claim (one launch, in the caller's kernel): the chunk is cut into
//     tiles of kTile = 2,048 items, one tile per block of 512 threads,
//     tile ids taken in launch order from an atomic counter. A block loads
//     its items once into registers (4 a thread), ranks them in item
//     order within the tile (one warp per contiguous run of 128 items,
//     warp __match_any_sync plus a per-warp running count in shared
//     memory), publishes its per-cell live counts and finds the counts of
//     all earlier tiles by the decoupled look-back of Merrill & Garland
//     ("Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//     Then each live item gets its c, its verdict and its ring cell,
//     raises winner[cell] to its index with atomicMax, and appends
//     (j, cell) to its warp's list (one list per warp, so no atomics
//     place the entries).
//   write (second launch): each accepted item whose index is still the
//     winner of its cell copies its payload into the ring (each leaf of a
//     payload of several leaves), in place, and puts winner[cell] back to
//     -1 once every leaf is written. It also zeroes the tile's look-back
//     words and the tile counter.
//
// What bounds it on this card: memory, and at the main path's 524,288
// items the latency of dependent trips to memory more than the bytes.
// The function needs the mask of every item, the stratum of each live
// item, u_accept of each live item past its capacity, u_slot of each
// such item accepted, and per won cell the payload read and the ring
// word written. The claim reads 13 bytes of every item (sid, mask, two
// uniforms: waiting on the verdict before reading u_slot costs a
// dependent trip); per accepted item it does one 4-byte atomic and an
// 8-byte list entry each way; per won cell the write moves 12 bytes. The
// design reads each item once, issues every load of a block before it
// needs any, keeps ranks, cells and uniforms in registers between the
// scan and the claim, and never touches the ring or the winner table
// outside the cells that accepted items reach: no pass over the ring, no
// memset of it.
//
// Past the cells a block's shared memory holds (claim_smem_words), the
// claim is parted_claim.cuh's parted form instead; the write launches are
// these.
//
// The winner table is self-clearing: it is -1 everywhere between calls.
// In a call only accepted items raise entries, and each raised entry has
// exactly one winner, which resets it in the write; a losing item never
// finds its own index there, so it never writes. The look-back words and
// the counters are likewise left 0. The caller keeps this scratch from
// call to call and relies on the calls that share it being ordered on
// one CUDA stream (the wrappers keep one scratch per device and stream).
//
// Arithmetic is kept exactly the reference's f32: __int2float_rn for the
// counts, __fmul_rn for u*c and u_slot*N (never contracted into an FMA;
// the library is also built with -fmad=false), floorf, then the clamp to
// [0, max(N_s - 1, 0)].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {
namespace fold {

constexpr int kThreads = 512;                 // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                     // items per thread
constexpr int kWarpItems = 32 * kItems;       // one warp's contiguous run
constexpr int kTile = kThreads * kItems;      // 2048 items per tile
constexpr unsigned kFull = 0xffffffffu;

// Look-back word of one (cell, tile): a flag in the high half, the count
// in the low half. 0 means the tile has published nothing yet.
constexpr unsigned long long kFlagMask = 0xffffffff00000000ull;
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own
constexpr unsigned long long kPrefix = 2ull << 32;     // through the tile

// Shared-memory words of the claim pass over `cells` cells: per-warp
// running counts [kWarps][cells + 1], then agg, base and cap [cells].
// (The scratch's list counts are one word per (tile, warp).)
__host__ __device__ constexpr int claim_smem_words(int cells) {
  return kWarps * (cells + 1) + 3 * cells;
}

// The payload leaves of one fold: each accepted winner writes every
// leaf's word at its cell, from one decision. Passed by value (a
// __grid_constant__ kernel parameter, read in place), at most kMaxLeaves;
// every index into it is a compile-time constant.
constexpr int kMaxLeaves = 8;

struct Leaves {
  const uint32_t* payload[kMaxLeaves];
  uint32_t* values[kMaxLeaves];
  int n;                                      // 1 <= n <= kMaxLeaves
};

// The shards of a call batched over a leading shard axis (the
// reference's vmap of its kernel): a block works for shard
// shard_index() of n, and each array of that shard starts its stride
// (in elements, 64-bit) past the shard before's. The item arrays are
// the exception: `row` shards read one item row (shard sh reads row
// item_row(sh, sd)), so a fold call batched over W shards' K ring slots
// (row = K) reads each shard's items and uniforms once, not K copies;
// its masks are per fold (stride `mask`). The one-shot's row is 1. A
// call of one shard reads no stride.
struct Shards {
  int n;
  int row;             // shards that read one item row
  long long items;     // [M] item arrays, per item row
  long long mask;      // the fold's [M] masks, per shard
  long long cells;     // [cells] arrays: counts, capacities, new counts
  long long table;     // ring cells: the winner table, each values leaf
  long long ctrs;      // counter words (the tile counter first)
  long long status;    // look-back words
  long long lists;     // list entries (int2)
  long long list_n;    // list counts
  long long zeroed;    // parted_claim.cuh's zeroed words (and the caller's)
  long long meta;      // its meta words
  long long part;      // its partition entries (int4), both buffers
};

constexpr int kGridYMax = 65535;              // gridDim.y at most

// The shard of this block: blockIdx.y, then blockIdx.z past 65,535
// shards (shard_grid); a block past the last shard has none and returns.
__device__ __forceinline__ long long shard_index() {
  return (long long)blockIdx.z * gridDim.y + blockIdx.y;
}

// The grid of a launch of x blocks a shard over n shards.
inline dim3 shard_grid(int x, int n) {
  const int y = n < kGridYMax ? n : kGridYMax;
  return dim3(x, y, (n + y - 1) / y);
}

// An unbatched call: one shard.
inline Shards one_shard() {
  Shards sd{};
  sd.n = 1;
  sd.row = 1;
  return sd;
}

// The item row that shard sh reads. The item loads wait on it, so it is
// no 64-bit division (a call's shards fit int32): none for a row of one.
__device__ __forceinline__ long long item_row(long long sh,
                                              const Shards& sd) {
  return sd.row == 1 ? sh : (long long)((unsigned)sh / (unsigned)sd.row);
}

__device__ __forceinline__ void status_store(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The tile id of this block, in launch order (so that every tile a block
// looks back at belongs to a block that has already started).
__device__ __forceinline__ int take_tile(int32_t* tile_ctr) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(tile_ctr, 1);
  __syncthreads();
  return tile;
}

// Index of item r of this thread in `tile`: warp w owns the contiguous
// run [w * kWarpItems, (w + 1) * kWarpItems) of the tile, 32 items a
// round, so each load of a warp reads 32 neighbouring words.
__device__ __forceinline__ long long item_index(int tile, int r) {
  return (long long)tile * kTile + (threadIdx.x >> 5) * kWarpItems +
         r * 32 + (threadIdx.x & 31);
}

// Ranks of this thread's items among the tile's items of the same cell,
// in item order (cell == cells is the sentinel "no cell"), and the
// tile's per-cell totals in agg[cells], each published to the look-back
// words (status, cell-major) as soon as it is known. wrun is
// [kWarps][cells + 1].
__device__ __forceinline__ void tile_ranks(const int (&cell)[kItems],
                                           int (&rank)[kItems], int cells,
                                           int tile, int n_tiles,
                                           int32_t* wrun, int32_t* agg,
                                           unsigned long long* status) {
  const int stride = cells + 1;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * stride; i += kThreads) wrun[i] = 0;
  __syncthreads();
  int32_t* run = wrun + (threadIdx.x >> 5) * stride;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned peers = __match_any_sync(kFull, cell[r]);
    const int before = run[cell[r]];
    rank[r] = before + __popc(peers & below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) run[cell[r]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per cell: the runs of earlier warps (exclusive) and the tile total,
  // kWarps lanes a cell, by a shuffle scan.
  constexpr int kCellsPerWarp = 32 / kWarps;
  const int sub = lane / kWarps, w = lane % kWarps;
  for (int c0 = (threadIdx.x >> 5) * kCellsPerWarp; c0 < cells;
       c0 += kWarps * kCellsPerWarp) {
    const int c = c0 + sub;
    const int32_t v = c < cells ? wrun[w * stride + c] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, d, kWarps);
      if (w >= d) incl += t;
    }
    if (c < cells) {
      wrun[w * stride + c] = incl - v;
      if (w == kWarps - 1) {
        agg[c] = incl;
        status_store(status + (size_t)c * n_tiles + tile,
                     (tile == 0 ? kPrefix : kAggregate) | (uint32_t)incl);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (cell[r] < cells) rank[r] += run[cell[r]];
}

// Adds to base[cells] the live items of each cell in all earlier tiles,
// and publishes the tile's inclusive prefixes. One warp per cell walks
// back 32 predecessors a step, lane 0 the nearest, and sums them up to
// the first inclusive prefix. The look-back words are cell-major
// (status[c][tile]), so a step reads two cache lines: every tile walks
// back at once, and a tile-major layout made those reads a hot spot in
// L2. (Reading more predecessors a step measured slower, for the same
// reason.)
__device__ void tile_lookback(int tile, int n_tiles, int cells,
                              const int32_t* agg, int32_t* base,
                              unsigned long long* status) {
  const int lane = threadIdx.x & 31;
  // tile_ranks published the aggregates before its last barrier, so each
  // is out before this tile's prefix of the same cell.
  for (int c = threadIdx.x >> 5; c < cells; c += kWarps) {
    const unsigned long long* col = status + (size_t)c * n_tiles;
    int32_t sum = 0;
    for (int pred = tile - 1; pred >= 0; pred -= 32) {
      const int t = pred - lane;
      unsigned long long w = kPrefix;        // before tile 0: a prefix of 0
      if (t >= 0) {
        do {
          w = status_load(col + t);
        } while ((w & kFlagMask) == 0);
      }
      const unsigned prefixes =
          __ballot_sync(kFull, (w & kFlagMask) == kPrefix);
      const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
      sum += warp_sum(lane <= stop ? (int32_t)(uint32_t)w : 0);
      if (prefixes) break;
    }
    if (lane == 0) {
      base[c] += sum;
      if (tile > 0)
        status_store(status + (size_t)c * n_tiles + tile,
                     kPrefix | (uint32_t)(sum + agg[c]));
    }
  }
  __syncthreads();
}

// The ring cell that item j claims, or -1 when it is not accepted:
// c is its arrival index in its stratum s, cap = N_s.
__device__ __forceinline__ int32_t vitter_cell(int s, int c, int cap,
                                               float u_accept, float u_slot,
                                               int n_max) {
  const float capf = __int2float_rn(cap);
  const bool filling = c <= cap;
  const bool replace = __fmul_rn(u_accept, __int2float_rn(c)) < capf;
  if (!filling && !replace) return -1;
  int slot;
  if (filling) {
    slot = c - 1;
  } else {
    slot = (int)floorf(__fmul_rn(u_slot, capf));
    slot = min(max(slot, 0), max(cap - 1, 0));
  }
  return s * n_max + slot;
}

// The claim of this thread's items: verdict, atomicMax on the winner
// table, and a place in its warp's list. base[c] = counts[c] + earlier
// tiles' live items of c; cap[c] = N_c. A warp's list is its own
// kWarpItems entries of the tile's region, its count list_n[tile][warp].
__device__ __forceinline__ void claim_items(
    int tile, long long m, int cells, int n_max, const int (&cell)[kItems],
    const int (&rank)[kItems], const float (&ua)[kItems],
    const float (&us)[kItems], const int32_t* base, const int32_t* cap,
    int32_t* __restrict__ winner, int2* __restrict__ lists,
    int32_t* __restrict__ list_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int2* list = lists + (size_t)tile * kTile + warp * kWarpItems;
  int listed = 0;                            // the same in every lane
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long j = item_index(tile, r);
    int32_t f = -1;
    if (j < m && cell[r] < cells) {
      const int s = cell[r];
      f = vitter_cell(s, base[s] + rank[r] + 1, cap[s], ua[r], us[r], n_max);
      if (f >= 0) atomicMax(&winner[f], (int32_t)j);
    }
    const unsigned won = __ballot_sync(kFull, f >= 0);
    if (f >= 0) list[listed + __popc(won & below)] = make_int2((int32_t)j, f);
    listed += __popc(won);
  }
  if (lane == 0) list_n[tile * kWarps + warp] = listed;
}

// Each accepted item of the tile's lists that still holds its cell
// writes its payload there (every leaf's word) and, when kReset, resets
// the cell's winner word (only the last group of a payload's leaves
// resets). A warp takes its own list: its first 32 entries are read
// before the count is, the rest kItems a lane at a time. The pass is
// bound by L2 transactions (a scattered sector for each winner read and
// reset, payload read and ring write), so it reads no more list entries
// than that. The first leaf's payload is read beside the winner word;
// the other leaves', only by the items that won. A shard's leaves start
// pay_off items and val_off ring cells past shard 0's (the lists and the
// winner words are the caller's shard's already).
template <bool kReset = true>
__device__ __forceinline__ void write_entries(int first, int count, int n,
                                              const int2* __restrict__ list,
                                              const Leaves& lv,
                                              int32_t* __restrict__ winner,
                                              long long pay_off,
                                              long long val_off) {
  int2 e[kItems];
  int32_t w[kItems];
  uint32_t v[kItems];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    if (q < count) e[q] = list[first + 32 * q + lane];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {        // the payload read does not
    if (q < count && first + 32 * q + lane < n) {  // wait on the winner's
      w[q] = winner[e[q].y];
      v[q] = lv.payload[0][pay_off + e[q].x];
    }
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (q < count && first + 32 * q + lane < n && w[q] == e[q].x) {
      lv.values[0][val_off + e[q].y] = v[q];
#pragma unroll
      for (int l = 1; l < kMaxLeaves; ++l)
        if (l < lv.n)
          lv.values[l][val_off + e[q].y] = lv.payload[l][pay_off + e[q].x];
      if (kReset) winner[e[q].y] = -1;
    }
  }
}

template <bool kReset = true>
__device__ __forceinline__ void write_winners(
    int tile, const int2* __restrict__ lists,
    const int32_t* __restrict__ list_n, const Leaves& lv,
    int32_t* __restrict__ winner, long long pay_off = 0,
    long long val_off = 0) {
  const int warp = threadIdx.x >> 5;
  const int2* list = lists + (size_t)tile * kTile + warp * kWarpItems;
  const int n = list_n[tile * kWarps + warp];
  write_entries<kReset>(0, 1, n, list, lv, winner, pay_off, val_off);
  if (n > 32)                                // warp-uniform
    write_entries<kReset>(32, kItems - 1, n, list, lv, winner, pay_off,
                          val_off);
}

// The fold's write pass: one block per tile of the claim, one leaf, over
// the folds of sd (each its own lists, winner words, look-back words,
// tile counter and ring; its payload its item row's).
__global__ void __launch_bounds__(kThreads)
    fold_write(const int2* __restrict__ lists,
               const int32_t* __restrict__ list_n,
               const uint32_t* __restrict__ payload,
               int32_t* __restrict__ winner, uint32_t* __restrict__ values,
               unsigned long long* __restrict__ status, int cells,
               int32_t* __restrict__ tile_ctr, const Shards sd) {
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  winner += sh * sd.table;
  status += sh * sd.status;
  tile_ctr += sh * sd.ctrs;
  const int tile = blockIdx.x;
  Leaves lv;
  lv.payload[0] = payload + item_row(sh, sd) * sd.items;
  lv.values[0] = values + sh * sd.table;
  lv.n = 1;
  write_winners(tile, lists, list_n, lv, winner);
  for (int c = threadIdx.x; c < cells; c += kThreads)
    status[(size_t)c * gridDim.x + tile] = 0;
  if (tile == 0 && threadIdx.x == 0) *tile_ctr = 0;
}

}  // namespace fold
}  // namespace
