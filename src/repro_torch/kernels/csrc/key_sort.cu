// Stable LSD radix sort of int32 keys with their item indices (see
// key_sort.cuh), for the large-key (sorted) forms of the stats and the
// histogram. The fold and the one-shot take their parted form instead
// (parted_claim.cuh).
//
// Replaces no TPU kernel. The TPU kernels keep their per-key state as
// whole VMEM blocks, so they have no limit on the count of keys; this
// card's kernels keep it in one block's shared memory (227 KB), and past
// that the large-key forms group each key's items by this sort instead.
// No library sort: a sort whose order is fixed by the keys alone is what
// makes the large-key forms give the same bits every call.
//
// Design: one launch of digit totals (ks_hist), then one launch per
// 8-bit digit (ks_pass). A pass ranks its tile's items by digit in item
// order and finds the counts of all earlier tiles by the decoupled
// look-back of fold_device.cuh (tile_ranks and tile_lookback over 256
// digits), so an item's place is the totals of lower digits + the
// earlier tiles' items of its digit + its rank in the tile. What bounds
// it: memory, each pass reading and writing 8 bytes an item.
//
// Scratch state: the look-back words are zeroed by ks_hist, each block
// its own tile's words, before any pass reads them; the digit totals and
// the tile counter are 0 between calls (each pass's last tile puts the
// counter back once every block has its tile, and the last block of the
// last pass clears the totals after every block has read them).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"
#include "key_sort.cuh"

namespace {

constexpr int kCtrSortTile = kSortMaxPasses * kSortRadix;  // in zeroed
constexpr int kCtrSortDone = kCtrSortTile + 1;

// A ticket: atomically add 1 at gpu scope with acquire-release order
// (taken by one thread after a block barrier); the value before.
__device__ __forceinline__ int take_ticket(int32_t* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Digit totals of every pass into zeroed[pass * 256 + digit] (shared
// counts by warp-aggregated atomics, then one global atomic per nonzero
// count), and this tile's look-back words of every pass set to 0.
__global__ void __launch_bounds__(kThreads)
    ks_hist(const int32_t* __restrict__ keys, int m, int passes,
            int32_t* __restrict__ zeroed,
            unsigned long long* __restrict__ status, int n_tiles) {
  __shared__ int32_t h[kSortMaxPasses * kSortRadix];
  const int words = passes * kSortRadix;
  for (int i = threadIdx.x; i < words; i += kThreads) {
    h[i] = 0;
    status[(size_t)i * n_tiles + blockIdx.x] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long j = item_index(blockIdx.x, r);
    const int k = j < m ? keys[j] : -1;
    for (int p = 0; p < passes; ++p) {
      const int d = k < 0 ? -1 : (k >> (8 * p)) & (kSortRadix - 1);
      const unsigned peers = __match_any_sync(kFull, d);
      if (d >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&h[p * kSortRadix + d], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += kThreads)
    if (h[i]) atomicAdd(&zeroed[i], h[i]);
}

// One pass: the stable scatter by the digit at `shift`. idx_in null: the
// item indices are the positions (the first pass).
__global__ void __launch_bounds__(kThreads)
    ks_pass(const int32_t* __restrict__ keys_in,
            const int32_t* __restrict__ idx_in,
            int32_t* __restrict__ keys_out, int32_t* __restrict__ idx_out,
            int m, int pass, int n_tiles, int last,
            int32_t* __restrict__ zeroed,
            unsigned long long* __restrict__ status) {
  __shared__ int32_t wrun[kWarps * (kSortRadix + 1)];
  __shared__ int32_t agg[kSortRadix], base[kSortRadix], off[kSortRadix];
  __shared__ int32_t wsum[kSortRadix / 32];
  __shared__ int s_last;
  const int tile = take_tile(zeroed + kCtrSortTile);
  if (tile == n_tiles - 1 && threadIdx.x == 0) zeroed[kCtrSortTile] = 0;
  const int shift = 8 * pass;
  unsigned long long* st = status + (size_t)pass * kSortRadix * n_tiles;

  int key[kItems], idx[kItems], dig[kItems], rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const long long j = item_index(tile, r);
    key[r] = idx[r] = 0;
    dig[r] = kSortRadix;                     // no digit: past the end
    if (j < m) {
      key[r] = keys_in[j];
      idx[r] = idx_in ? idx_in[j] : (int)j;
      dig[r] = (key[r] >> shift) & (kSortRadix - 1);
    }
  }
  // off[d]: the items of all tiles with a lower digit (an exclusive scan
  // of the pass's totals, 8 warps of 32 digits).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t v = 0, incl = 0;
  if (threadIdx.x < kSortRadix) {
    v = zeroed[pass * kSortRadix + threadIdx.x];
    incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    base[threadIdx.x] = 0;
  }
  __syncthreads();
  if (threadIdx.x < kSortRadix) {
    int32_t pre = 0;
    for (int w = 0; w < warp; ++w) pre += wsum[w];
    off[threadIdx.x] = pre + incl - v;
  }
  tile_ranks(dig, rank, kSortRadix, tile, n_tiles, wrun, agg, st);
  tile_lookback(tile, n_tiles, kSortRadix, agg, base, st);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (dig[r] < kSortRadix) {
      const int pos = off[dig[r]] + base[dig[r]] + rank[r];
      keys_out[pos] = key[r];
      idx_out[pos] = idx[r];
    }
  }
  if (!last) return;
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = take_ticket(zeroed + kCtrSortDone) == n_tiles - 1;
  __syncthreads();
  if (!s_last) return;
  for (int i = threadIdx.x; i < kSortMaxPasses * kSortRadix; i += kThreads)
    zeroed[i] = 0;
  if (threadIdx.x == 0) zeroed[kCtrSortDone] = 0;
}

}  // namespace

int ks_sort(const int32_t* keys, int m, int bits, const KeySortScratch& s,
            const int32_t** keys_out, const int32_t** idx_out,
            cudaStream_t stream) {
  const int passes = (bits + 7) / 8;
  if (passes < 1 || passes > kSortMaxPasses) return (int)cudaErrorInvalidValue;
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  ks_hist<<<n_tiles, kThreads, 0, stream>>>(keys, m, passes, s.zeroed,
                                            s.status, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int32_t* k_in = keys;
  const int32_t* i_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    int32_t* k_out = p % 2 == 0 ? s.keys_a : s.keys_b;
    int32_t* i_out = p % 2 == 0 ? s.idx_a : s.idx_b;
    ks_pass<<<n_tiles, kThreads, 0, stream>>>(k_in, i_in, k_out, i_out, m,
                                              p, n_tiles, p == passes - 1,
                                              s.zeroed, s.status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k_in = k_out;
    i_in = i_out;
  }
  *keys_out = k_in;
  *idx_out = i_in;
  return 0;
}

// Words of the sort's scratch: look-back words (u64) of a sort of m keys
// below 2^bits, and the zeroed int32 words.
extern "C" long long sa_sort_status_words(long long m, int bits) {
  const long long tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  return tiles * ((bits + 7) / 8) * kSortRadix;
}

extern "C" int sa_sort_zeroed_words() { return kSortZeroed; }

// The sort alone, for tests: keys int32 [m] in [0, 2^bits) to sorted keys
// and indices (copied to keys_sorted / idx_sorted).
extern "C" int sa_key_sort(const void* keys, int m, int bits,
                           void* const* lg, void* keys_sorted,
                           void* idx_sorted, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t *ko, *io;
  const int err = ks_sort(static_cast<const int32_t*>(keys), m, bits,
                          sort_scratch(lg), &ko, &io, stream);
  if (err != 0) return err;
  cudaError_t e = cudaMemcpyAsync(keys_sorted, ko, sizeof(int32_t) * m,
                                  cudaMemcpyDeviceToDevice, stream);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(idx_sorted, io, sizeof(int32_t) * m,
                        cudaMemcpyDeviceToDevice, stream);
  return (int)e;
}
