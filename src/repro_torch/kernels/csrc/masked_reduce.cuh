// Device code shared by stratified_stats.cu and weighted_hist.cu: a masked,
// deterministic segmented reduction over a flat [M] slot buffer, in one
// launch. Each file includes it into its own anonymous namespace, so the
// two objects link without clashing symbols.
//
// Partition. Items are taken four at a time ("vectors"): vector v holds
// items 4v - d .. 4v - d + 3, where d in [0, 3] puts every vector of the
// values array on a 16-byte boundary (a view may start on any 4-byte
// boundary). A tile is kThreads x kVecs vectors (2,048 items); thread t
// of a tile takes vectors t and t + kThreads, so each load instruction of
// a warp reads 512 contiguous bytes of a 4-byte array (128 of the mask).
// The grid has min(ceil((M + 3) / 2048), 512) blocks, a number fixed by
// M alone (never by the SM count or an occupancy query), and the blocks
// walk the tiles with a grid stride. So one tensor gives the same bits on
// any H100 part; a view of it at another 16-byte phase sums in another
// order.
//
// Loads. Every load of a vector is one 16-byte word (the 4 mask bytes one
// 4-byte word) when the array's phase agrees with the values' and the
// vector lies inside [0, M); otherwise, in the first and last vectors and
// for an array of another phase, one scalar per item. A vector's other
// fields are loaded only if one of its items needs them. The kernels keep
// loads one tile ahead in registers (the next tile's values, the mask
// words after it) while a tile is reduced.
//
// Per-item reduction (reduce_items). First one step for the key of the
// first pending item of the lowest lane that has one: every lane folds
// its items of that key in item order and a butterfly sums the lanes, so
// a warp whose items share one key (the emission's [G x N] views put a
// warp's 256 items in one row) is done in one step. Then the items left,
// one item index at a time, skipped when no lane has one: lanes of one
// key are grouped by __match_any_sync and summed by a segmented tree (at
// each of five levels a lane adds the partial of its group's lowest lane
// in the other half of its block, so every member ends with the same sum
// whatever the group's shape). One writer per key and warp adds the sums
// to its warp's row in shared memory; counts go to the block's row by
// shared integer atomics.
//
// Cross-block finish (finish), in the same launch, without memset and
// without float atomics: each block adds its counts to the count totals
// by integer atomics (order-free, so exact), writes its row of sums (the
// warps' rows by a fixed pairwise tree) to the workspace and takes a
// ticket of its group of 16 consecutive blocks. The group's last block
// sums the group's rows by a fixed pairwise tree (each thread one column,
// the rows read coalesced), writes the group's row, puts the group's
// ticket back to 0 and takes the final ticket; the last group's finisher
// sums the group rows by a fixed pairwise tree into the outputs, reads
// and clears the count totals and puts the final ticket back to 0. Every
// sum has a shape fixed by M and the tensors' phase, whichever block
// finishes last, so a second call gives the same bits; the tickets and
// totals are 0 between calls, as the caller's workspace keeps them.
//
// Sequential f32 additions per output: the fold (at most 8) and the
// butterfly (5), or one item and the segmented tree (5), then the warp's
// row (one add per step that meets the key), the warps (3), the group (4)
// and the groups (5). With one key per warp and tile, as in the emission's
// views, that is 8 + 5 + T + 12 for T tiles per block (31 at 6,291,456
// slots, T = 6); at most 13 + 8T + 12 (73 there) if every item step of
// every tile meets the key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                        // vectors per thread, tile
constexpr int kItems = 4 * kVecs;               // items per thread, tile
constexpr int kTileVecs = kThreads * kVecs;
constexpr long long kTile = 4LL * kTileVecs;    // 2,048 items per tile
constexpr int kMaxBlocks = 512;                 // grid, at most
constexpr int kGroup = 16;                      // blocks per group sum
constexpr int kMaxGroups = kMaxBlocks / kGroup;
constexpr int kTickets = kMaxGroups + 1;        // per group, and the final
constexpr unsigned kFull = 0xffffffffu;

// Which arrays may be read as 16-byte (mask: 4-byte) words at the values'
// phase; the values always can.
constexpr int kMaskVec = 1, kIdsVec = 2, kWeightsVec = 4;

// The vectors of one call: M items, d items before item 0 in vector 0.
struct Span {
  long long m;
  int d;
  int vec;        // kMaskVec | kIdsVec | kWeightsVec bits
};

int grid_blocks(long long m) {
  const long long tiles = (m + 3 + kTile - 1) / kTile;
  return (int)(tiles < 1 ? 1 : tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

__host__ __device__ inline int grid_groups(int blocks) {
  return (blocks + kGroup - 1) / kGroup;
}

// Workspace words of a call: one row of NF * keys f32 sums per block and
// per group. The zeroed words are kTickets tickets, then keys int32
// count totals.
long long scratch_words(long long m, int keys, int nf) {
  const int b = grid_blocks(m);
  return (long long)(b + grid_groups(b)) * nf * keys;
}

// The span of M items whose values start at address `values`; the other
// arrays' vector flags from their addresses.
Span make_span(long long m, const void* values, const void* mask,
               const void* ids, const void* weights) {
  const uintptr_t pv = reinterpret_cast<uintptr_t>(values);
  const int h = (int)(((16 - (pv & 15)) & 15) >> 2);   // first aligned item
  Span sp{m, (4 - h) & 3, 0};
  if (((reinterpret_cast<uintptr_t>(mask) + h) & 3) == 0) sp.vec |= kMaskVec;
  if (ids && ((reinterpret_cast<uintptr_t>(ids) + 4 * h) & 15) == 0)
    sp.vec |= kIdsVec;
  if (weights && ((reinterpret_cast<uintptr_t>(weights) + 4 * h) & 15) == 0)
    sp.vec |= kWeightsVec;
  return sp;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// First item of vector k of this thread in `tile`.
__device__ __forceinline__ long long vec_start(const Span& sp,
                                               long long tile, int k) {
  return 4 * (tile * kTileVecs + (long long)k * kThreads + threadIdx.x) -
         sp.d;
}

__device__ __forceinline__ bool whole(const Span& sp, long long s) {
  return s >= 0 && s + 4 <= sp.m;
}

// Byte i of a mask word: item i of the vector is live.
__device__ __forceinline__ bool byte_on(uint32_t w, int i) {
  return (w >> (8 * i)) & 0xffu;
}

// Mask words of this thread's vectors in `tile` (0 past the end).
__device__ __forceinline__ void load_masks(const uint8_t* __restrict__ mask,
                                           const Span& sp, long long tile,
                                           uint32_t (&mk)[kVecs]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long s = vec_start(sp, tile, k);
    uint32_t w = 0;
    if ((sp.vec & kMaskVec) && whole(sp, s)) {
      w = __ldg(reinterpret_cast<const unsigned int*>(mask + s));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s + i >= 0 && s + i < sp.m)
          w |= (uint32_t)(mask[s + i] != 0) << (8 * i);
    }
    mk[k] = w;
  }
}

// The 4 words of vector s of a 4-byte array, the items `want` names (a
// mask word), `fill` for the others; a whole vector is read as one
// 16-byte word when `vec`.
template <class T4, class T>
__device__ __forceinline__ T4 load_vec(const T* __restrict__ p, const Span& sp,
                                       long long s, uint32_t want, bool vec,
                                       T4 fill) {
  T4 r = fill;
  if (vec && whole(sp, s)) return __ldg(reinterpret_cast<const T4*>(p + s));
  if (byte_on(want, 0)) r.x = __ldg(p + s);
  if (byte_on(want, 1)) r.y = __ldg(p + s + 1);
  if (byte_on(want, 2)) r.z = __ldg(p + s + 2);
  if (byte_on(want, 3)) r.w = __ldg(p + s + 3);
  return r;
}

// The words of this thread's vectors in `tile` of a 4-byte array: the
// vectors whose mask word `want` names an item, `fill` elsewhere.
template <class T4, class T>
__device__ __forceinline__ void load_tile(const T* __restrict__ p,
                                          const Span& sp, long long tile,
                                          const uint32_t (&want)[kVecs],
                                          bool vec, T4 fill,
                                          T4 (&out)[kVecs]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    out[k] = fill;
    if (want[k])
      out[k] = load_vec(p, sp, vec_start(sp, tile, k), want[k], vec, fill);
  }
}

template <class T4>
__device__ __forceinline__ auto lane_of(const T4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A thread's kItems items (key -1: adds nothing) into the warp's rows
// [NF][keys] and the block's counts [keys]. First one step for the key of
// the first pending item of the lowest lane that has one: every lane folds
// its items of that key in item order, a butterfly sums the lanes (the
// count by __reduce_add_sync), lane 0 adds to the rows. Then the items
// left, one item index at a time (skipped when no lane has one): lanes
// of one key are grouped by __match_any_sync and summed by the segmented
// tree, and each group's lowest lane adds to the rows.
template <int NF>
__device__ __forceinline__ void reduce_items(const int (&key)[kItems],
                                             const float (&val)[kItems][NF],
                                             float* rows, int32_t* counts,
                                             int keys, int lane) {
  unsigned pending = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) pending |= (key[i] >= 0 ? 1u : 0u) << i;
  const unsigned active = __ballot_sync(kFull, pending != 0);
  if (!active) return;
  int first = -1;
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i)
    if ((pending >> i) & 1u) first = key[i];
  const int k0 = __shfl_sync(kFull, first, __ffs(active) - 1);
  int c = 0;
  float s[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) s[f] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (((pending >> i) & 1u) && key[i] == k0) {
      ++c;
#pragma unroll
      for (int f = 0; f < NF; ++f) s[f] = __fadd_rn(s[f], val[i][f]);
      pending &= ~(1u << i);
    }
  c = (int)__reduce_add_sync(kFull, (unsigned)c);
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      s[f] = __fadd_rn(s[f], __shfl_xor_sync(kFull, s[f], d));
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      rows[f * keys + k0] = __fadd_rn(rows[f * keys + k0], s[f]);
    atomicAdd(counts + k0, c);
  }
  if (!__any_sync(kFull, pending)) return;
  unsigned half[5];            // this lane's other half at each tree level
#pragma unroll
  for (int l = 0; l < 5; ++l)
    half[l] = ((1u << (1 << l)) - 1u) << ((lane ^ (1 << l)) & ~((1 << l) - 1));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool mine = (pending >> j) & 1u;
    if (!__any_sync(kFull, mine)) continue;
    const int kj = mine ? key[j] : -1;
    const unsigned peers = __match_any_sync(kFull, kj);
    float t[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) t[f] = mine ? val[j][f] : 0.0f;
    // After level d, t is the group's sum over this lane's aligned block
    // of 2d lanes; the other half's sum is read from its lowest lane in
    // the group (all of them hold the same one).
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const unsigned other = half[l] & peers;
      const int src = other ? __ffs(other) - 1 : lane;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float got = __shfl_sync(kFull, t[f], src);
        if (other) t[f] = __fadd_rn(t[f], got);
      }
    }
    __syncwarp();
    if (mine && lane == __ffs(peers) - 1) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        rows[f * keys + kj] = __fadd_rn(rows[f * keys + kj], t[f]);
      atomicAdd(counts + kj, __popc(peers));
    }
  }
  __syncwarp();
}

// Fixed pairwise tree over R registers (slots past the rows hold 0).
template <int R>
__device__ __forceinline__ float tree_sum(float (&r)[R]) {
#pragma unroll
  for (int h = 1; h < R; h <<= 1)
#pragma unroll
    for (int i = 0; i + h < R; i += 2 * h) r[i] = __fadd_rn(r[i], r[i + h]);
  return r[0];
}

// The block's row: the warps' rows [kWarps][NF][keys] by a fixed tree.
template <int NF>
__device__ __forceinline__ void write_block_row(const float* rows, int keys,
                                                float* __restrict__ row) {
  for (int col = threadIdx.x; col < NF * keys; col += kThreads) {
    float r[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r[w] = rows[w * NF * keys + col];
    row[col] = tree_sum<kWarps>(r);
  }
}

// Column col of n <= R rows of width w at p, summed by the fixed pairwise
// tree over R slots (+0 past the rows). A tree over R > 16 slots is the
// sum of the trees over its halves, taken one after the other to keep
// at most 16 loads live.
template <int R>
__device__ __forceinline__ float col_sum(const float* p, int n, int w) {
  if constexpr (R > 16) {
    const float a = col_sum<R / 2>(p, n, w);
    return __fadd_rn(a, col_sum<R / 2>(p + (size_t)(R / 2) * w, n - R / 2,
                                       w));
  } else {
    float f[R];
#pragma unroll
    for (int i = 0; i < R; ++i) f[i] = i < n ? __ldcg(p + (size_t)i * w) : 0.0f;
    return tree_sum<R>(f);
  }
}

// Column-wise fixed tree over n <= R rows of width w at src, each thread
// one column, so a row's words are read coalesced.
template <int R>
__device__ __forceinline__ void sum_rows(const float* src, int n, int w,
                                         float* dst) {
  for (int col = threadIdx.x; col < w; col += kThreads)
    dst[col] = col_sum<R>(src + col, n, w);
}

// A ticket: atomically add 1 to *p at gpu scope with acquire-release
// order; the value before. Taken by one thread after a block barrier, it
// releases every store the block made before the barrier, and acquires
// those of the blocks that took earlier tickets (the pattern of a grid
// barrier: bar.sync, then one thread's gpu-scope atomic).
__device__ __forceinline__ int take_ticket(int32_t* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// After the block's shared rows and counts are complete (the caller
// synchronised): the block's counts go to the count totals by integer
// atomics (exact in any order) and its row of sums to the workspace;
// then the group sum and the final sum by whichever blocks take the last
// tickets. The final block reads and clears the totals, so the zeroed
// words (tickets, totals) are 0 again when the launch ends. out_f: NF *
// keys sums, out_c: keys counts.
template <int NF>
__device__ void finish(const float* rows, const int32_t* counts, int keys,
                       float* __restrict__ red, int32_t* __restrict__ zeroed,
                       float* out_f, float* out_c) {
  __shared__ int s_last;
  int32_t* tickets = zeroed;
  int32_t* total = zeroed + kTickets;
  const int w = NF * keys;
  const int n_blocks = gridDim.x;
  write_block_row<NF>(rows, keys, red + (size_t)blockIdx.x * w);
  for (int k = threadIdx.x; k < keys; k += kThreads)
    if (counts[k]) atomicAdd(total + k, counts[k]);
  __syncthreads();
  const int g = blockIdx.x / kGroup;
  const int n_groups = grid_groups(n_blocks);
  const int g_size = min(kGroup, n_blocks - g * kGroup);
  if (threadIdx.x == 0) s_last = take_ticket(tickets + g) == g_size - 1;
  __syncthreads();
  if (!s_last) return;
  sum_rows<kGroup>(red + (size_t)g * kGroup * w, g_size, w,
                   red + (size_t)(n_blocks + g) * w);
  if (threadIdx.x == 0) tickets[g] = 0;
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = take_ticket(tickets + kMaxGroups) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  // A thread's first count total is read and cleared before its column
  // sums' loads, so the two round trips overlap.
  const int c0 = threadIdx.x < keys ? atomicExch(total + threadIdx.x, 0) : 0;
  sum_rows<kMaxGroups>(red + (size_t)n_blocks * w, n_groups, w, out_f);
  if (threadIdx.x < keys) out_c[threadIdx.x] = (float)c0;
  for (int k = threadIdx.x + kThreads; k < keys; k += kThreads)
    out_c[k] = (float)atomicExch(total + k, 0);
  if (threadIdx.x == 0) tickets[kMaxGroups] = 0;
}

}  // namespace
