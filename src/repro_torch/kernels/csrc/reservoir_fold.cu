// OASRS reservoir fold for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/reservoir.py:36
// (_fold_kernel, wrapper reservoir_fold). That kernel walks the chunk item
// by item in a fori_loop with the [S, N_max] reservoirs pinned in VMEM:
// one core, one item at a time. Here the same exact sequential Vitter
// semantics come from the parallel rank/scatter-max form of the
// reference's core/oasrs.py::apply_chunk_uniforms, bitwise equal to it
// (device code in fold_device.cuh, shared with one_shot_ingest.cu).
//
// What bounds it on this card: memory. The function must read the mask of
// every item, the stratum of each live item, u_accept of each live item
// past its cell's capacity, u_slot of each such item accepted and the
// payload of each ring cell won, and write that cell: 5,583,924 B at the
// replacement chunk that chip_smoke.py times (524,288 items, 83,633
// accepted, 82,156 cells won, into [6, 1,048,576]), 0.0017 ms at
// 3.35 TB/s. The claim reads the stratum, mask and both uniforms of every
// item once (13 bytes), rather than wait on the verdict for u_slot; the
// write reads the payloads of the winners only. The design is two
// launches, one per real grid-wide dependency:
//
//   1. fold_claim  single-pass scan with decoupled look-back over tiles of
//                  2,048 items (counts, offsets and the verdict in one
//                  pass over the items, which stay in registers), the
//                  atomicMax claims, the per-warp lists of accepted
//                  items; the tile that comes last writes the new counts;
//   2. fold_write  the winners' payloads into the ring; the winner table,
//                  the look-back words and the tile counter left as the
//                  next call needs them (-1, 0, 0).
//
// No memset and no pass over the ring: the winner table is self-clearing
// (see fold_device.cuh) and kept by the wrapper, which assumes the calls
// sharing it are ordered on one stream and drops it if a launch fails.
// Loads are 4-byte words, 32 neighbouring ones per warp, because the
// item-order rank takes a warp's items 32 at a time in order.
//
// A payload of several leaves, or of one leaf that is not a 4-byte
// scalar (a leaf [M, *item] of any dtype is one row of prod(item) *
// itemsize bytes per item), takes the same claim and then one write
// launch per group of at most kMaxLeaves leaves (fold_write_rows): each
// winner copies its row of every leaf of the group, in 4-byte words where
// the row and both base pointers allow it, else in bytes; only the last
// group's launch puts the winner words back to -1 and clears the
// look-back words and the tile counter.
//
// Large-key form. The claim keeps 16 x (S + 1) + 3 S int32 in shared
// memory (78 KB at S = 1,024) and S look-back words per tile, so past
// S = 1,024 (the wrapper's MAX_STRATA) the wrapper asks for the large-key
// form instead: fold_keys writes each item's cell (S for none), key_sort
// sorts the cells stably, fold_heads finds each cell's first sorted
// position, and fold_sorted_claim claims over the sorted positions
// (fold_device.cuh), writing the same per-warp lists, so the write
// launches are the same. Its scratch grows with M + S, not with tiles x
// S; 2 + passes + 2 launches (passes = 2 up to 65,535 strata), then the
// writes. The only limit left is S * N_max + 1 < 2^31 (int32 ring
// index), which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"
#include "key_sort.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    fold_claim(const int32_t* __restrict__ sid,
               const uint8_t* __restrict__ mask,
               const float* __restrict__ u_accept,
               const float* __restrict__ u_slot, int m, int s_cnt,
               int n_max, int n_tiles, const int32_t* __restrict__ counts,
               const int32_t* __restrict__ capacity,
               int32_t* __restrict__ counts_out,
               int32_t* __restrict__ winner,
               unsigned long long* __restrict__ status,
               int2* __restrict__ lists, int32_t* __restrict__ list_n,
               int32_t* __restrict__ tile_ctr) {
  extern __shared__ int32_t sm[];
  int32_t* wrun = sm;
  int32_t* agg = wrun + kWarps * (s_cnt + 1);
  int32_t* base = agg + s_cnt;
  int32_t* cap = base + s_cnt;
  const int tile = take_tile(tile_ctr);

  int cell[kItems], rank[kItems];
  float ua[kItems], us[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const long long j = item_index(tile, r);
    bool mk = false;
    int s = s_cnt;
    ua[r] = us[r] = 0.0f;
    if (j < m) {
      mk = mask[j] != 0;
      s = sid[j];
      ua[r] = u_accept[j];
      us[r] = u_slot[j];
    }
    cell[r] = mk && s >= 0 && s < s_cnt ? s : s_cnt;  // s_cnt: no cell
  }
  for (int c = threadIdx.x; c < s_cnt; c += kThreads) {  // beside the items
    base[c] = counts[c];
    cap[c] = capacity[c];
  }
  tile_ranks(cell, rank, s_cnt, tile, n_tiles, wrun, agg, status);
  tile_lookback(tile, n_tiles, s_cnt, agg, base, status);
  if (tile == n_tiles - 1)
    for (int c = threadIdx.x; c < s_cnt; c += kThreads)
      counts_out[c] = base[c] + agg[c];
  claim_items(tile, m, s_cnt, n_max, cell, rank, ua, us, base, cap, winner,
              lists, list_n);
}

// The leaves of one write launch of a payload tree, by value: base
// pointers, the bytes of one item's row, and whether the row is copied in
// 4-byte words.
struct RowLeaves {
  const uint8_t* payload[kMaxLeaves];
  uint8_t* values[kMaxLeaves];
  long long row_bytes[kMaxLeaves];
  int words[kMaxLeaves];
  int n;                                      // 1 <= n <= kMaxLeaves
};

__device__ __forceinline__ void copy_row(const RowLeaves& lv, int l, int j,
                                         int cell) {
  const long long rb = lv.row_bytes[l];
  if (lv.words[l]) {
    const long long nw = rb >> 2;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(lv.payload[l]) + j * nw;
    uint32_t* dst = reinterpret_cast<uint32_t*>(lv.values[l]) + cell * nw;
    for (long long i = 0; i < nw; ++i) dst[i] = src[i];
  } else {
    const uint8_t* src = lv.payload[l] + j * rb;
    uint8_t* dst = lv.values[l] + cell * rb;
    for (long long i = 0; i < rb; ++i) dst[i] = src[i];
  }
}

// The write pass of a payload tree for one group of leaves: one block per
// tile of the claim, each warp over its own list, a lane per entry. An
// entry whose item still holds its cell copies its row of every leaf of
// the group; in the last group it then resets the cell's winner word (a
// cell has one winning entry, and a losing entry never finds its own
// index there, before or after the reset).
__global__ void __launch_bounds__(kThreads)
    fold_write_rows(const int2* __restrict__ lists,
                    const int32_t* __restrict__ list_n,
                    const __grid_constant__ RowLeaves lv,
                    int32_t* __restrict__ winner,
                    unsigned long long* __restrict__ status, int cells,
                    int last, int32_t* __restrict__ tile_ctr) {
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2* list = lists + (size_t)tile * kTile + warp * kWarpItems;
  const int n = list_n[tile * kWarps + warp];
  for (int q = lane; q < n; q += 32) {
    const int2 e = list[q];
    if (winner[e.y] != e.x) continue;
    for (int l = 0; l < lv.n; ++l) copy_row(lv, l, e.x, e.y);
    if (last) winner[e.y] = -1;
  }
  if (!last) return;
  for (int c = threadIdx.x; c < cells; c += kThreads)
    status[(size_t)c * gridDim.x + tile] = 0;
  if (tile == 0 && threadIdx.x == 0) *tile_ctr = 0;
}

// The large-key form's sort keys: each item's stratum, or s_cnt (no
// cell) when it is masked out or its stratum is outside [0, S).
__global__ void __launch_bounds__(kThreads)
    fold_keys(const int32_t* __restrict__ sid,
              const uint8_t* __restrict__ mask, int m, int s_cnt,
              int32_t* __restrict__ keys) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long j = item_index(blockIdx.x, r);
    if (j < m) {
      const int s = sid[j];
      keys[j] = mask[j] != 0 && s >= 0 && s < s_cnt ? s : s_cnt;
    }
  }
}

// The claim of the large-key form: keys, sort, heads, sorted claim (the
// scratch in the host array lg, key_sort.cuh's slots).
int launch_large_claim(const void* sid, const void* u_accept,
                       const void* u_slot, const void* mask,
                       const void* counts, const void* capacity,
                       void* counts_out, void* winner, void* lists,
                       void* list_n, void* const* lg, int m, int s_cnt,
                       int n_max, int n_tiles, cudaStream_t stream) {
  auto* keys = static_cast<int32_t*>(lg[kLgKeys]);
  auto* head = static_cast<int32_t*>(lg[kLgHead]);
  fold_keys<<<n_tiles, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(sid), static_cast<const uint8_t*>(mask), m,
      s_cnt, keys);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int32_t *skeys, *sidx;
  const int err = ks_sort(keys, m, key_bits(s_cnt), sort_scratch(lg), &skeys,
                          &sidx, stream);
  if (err != 0) return err;
  fold_heads<<<n_tiles, kThreads, 0, stream>>>(
      skeys, m, s_cnt, head, static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(counts_out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_sorted_claim<<<n_tiles, kThreads, 0, stream>>>(
      skeys, sidx, static_cast<const float*>(u_accept),
      static_cast<const float*>(u_slot), m, s_cnt, n_max, head,
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(capacity), static_cast<int32_t*>(counts_out),
      static_cast<int32_t*>(winner), static_cast<int2*>(lists),
      static_cast<int32_t*>(list_n));
  return (int)cudaGetLastError();
}

// The claim launch, shared by the scalar and the tree entry points.
int launch_claim(const void* sid, const void* u_accept, const void* u_slot,
                 const void* mask, const void* counts, const void* capacity,
                 void* counts_out, void* winner, void* status, void* lists,
                 void* list_n, void* ctrs, int m, int s_cnt, int n_max,
                 int n_tiles, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * claim_smem_words(s_cnt);
  cudaError_t err = allow_smem(fold_claim, smem);
  if (err != cudaSuccess) return (int)err;
  fold_claim<<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(sid), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(u_accept), static_cast<const float*>(u_slot),
      m, s_cnt, n_max, n_tiles, static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(capacity),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(winner),
      static_cast<unsigned long long*>(status), static_cast<int2*>(lists),
      static_cast<int32_t*>(list_n), static_cast<int32_t*>(ctrs));
  return (int)cudaGetLastError();
}

}  // namespace

// Items one tile (one block of either launch) covers, and its lists.
extern "C" int sa_fold_tile_items() { return kTile; }
extern "C" int sa_fold_tile_lists() { return kWarps; }

// Scratch (kept by the caller between calls): winner i32[S * N_max], all
// -1; status u64[S * n_tiles], all 0; ctrs i32[3], 0 (the tile counter
// first); lists int2[n_tiles * kTile] and list_n i32[n_tiles * kWarps],
// no state. The kernels leave winner, status and ctrs as they found them.
// values and payload are 4-byte words (f32 or i32), copied as bits.
// lg: null for the small form, else the large-key form's scratch
// (key_sort.cuh's slots kLgKeys to kLgHead); the large form uses no
// look-back words of its own (status is untouched).
extern "C" int sa_reservoir_fold(const void* sid, const void* payload,
                                 const void* u_accept, const void* u_slot,
                                 const void* mask, const void* counts,
                                 const void* capacity, void* values,
                                 void* counts_out, void* winner,
                                 void* status, void* lists, void* list_n,
                                 void* ctrs, void* const* lg, int m,
                                 int s_cnt, int n_max, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  int err = lg ? launch_large_claim(sid, u_accept, u_slot, mask, counts,
                                    capacity, counts_out, winner, lists,
                                    list_n, lg, m, s_cnt, n_max, n_tiles,
                                    stream)
               : launch_claim(sid, u_accept, u_slot, mask, counts, capacity,
                              counts_out, winner, status, lists, list_n,
                              ctrs, m, s_cnt, n_max, n_tiles, stream);
  if (err != 0) return err;
  fold_write<<<n_tiles, kThreads, 0, stream>>>(
      static_cast<const int2*>(lists), static_cast<const int32_t*>(list_n),
      static_cast<const uint32_t*>(payload), static_cast<int32_t*>(winner),
      static_cast<uint32_t*>(values),
      static_cast<unsigned long long*>(status), lg ? 0 : s_cnt,
      static_cast<int32_t*>(ctrs));
  return (int)cudaGetLastError();
}

// The fold of a payload tree: payloads and values are host arrays of
// n_leaves pointers (leaf l [M, *item] into [S, N_max, *item], row_bytes[l]
// bytes an item), any dtype; the scratch and lg as sa_reservoir_fold's.
// The claim, then one write launch per group of kMaxLeaves leaves.
extern "C" int sa_reservoir_fold_rows(
    const void* sid, const void* const* payloads, const void* u_accept,
    const void* u_slot, const void* mask, const void* counts,
    const void* capacity, void* const* values, const long long* row_bytes,
    void* counts_out, void* winner, void* status, void* lists, void* list_n,
    void* ctrs, void* const* lg, int m, int s_cnt, int n_max, int n_leaves,
    void* stream_ptr) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  int err = lg ? launch_large_claim(sid, u_accept, u_slot, mask, counts,
                                    capacity, counts_out, winner, lists,
                                    list_n, lg, m, s_cnt, n_max, n_tiles,
                                    stream)
               : launch_claim(sid, u_accept, u_slot, mask, counts, capacity,
                              counts_out, winner, status, lists, list_n,
                              ctrs, m, s_cnt, n_max, n_tiles, stream);
  if (err != 0) return err;
  const int status_cells = lg ? 0 : s_cnt;
  for (int g = 0; g < n_leaves; g += kMaxLeaves) {
    RowLeaves lv;
    lv.n = n_leaves - g < kMaxLeaves ? n_leaves - g : kMaxLeaves;
    for (int l = 0; l < kMaxLeaves; ++l) {
      const bool used = l < lv.n;
      lv.payload[l] =
          used ? static_cast<const uint8_t*>(payloads[g + l]) : nullptr;
      lv.values[l] = used ? static_cast<uint8_t*>(values[g + l]) : nullptr;
      lv.row_bytes[l] = used ? row_bytes[g + l] : 0;
      lv.words[l] = used && row_bytes[g + l] % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(lv.payload[l]) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(lv.values[l]) % 4 == 0;
    }
    const int last = g + kMaxLeaves >= n_leaves;
    fold_write_rows<<<n_tiles, kThreads, 0, stream>>>(
        static_cast<const int2*>(lists), static_cast<const int32_t*>(list_n),
        lv, static_cast<int32_t*>(winner),
        static_cast<unsigned long long*>(status), status_cells, last,
        static_cast<int32_t*>(ctrs));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
