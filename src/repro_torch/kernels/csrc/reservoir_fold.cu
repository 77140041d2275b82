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
// Limits: S <= 1024 (the claim keeps 16 x (S + 1) + 3 S int32 in shared
// memory, 78 KB at the limit) and S * N_max + 1 < 2^31 (int32 ring index);
// the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"

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

}  // namespace

// Items one tile (one block of either launch) covers, and its lists.
extern "C" int sa_fold_tile_items() { return kTile; }
extern "C" int sa_fold_tile_lists() { return kWarps; }

// Scratch (kept by the caller between calls): winner i32[S * N_max], all
// -1; status u64[S * n_tiles], all 0; ctrs i32[3], 0 (the tile counter
// first); lists int2[n_tiles * kTile] and list_n i32[n_tiles * kWarps],
// no state. The kernels leave winner, status and ctrs as they found them.
// values and payload are 4-byte words (f32 or i32), copied as bits.
extern "C" int sa_reservoir_fold(const void* sid, const void* payload,
                                 const void* u_accept, const void* u_slot,
                                 const void* mask, const void* counts,
                                 const void* capacity, void* values,
                                 void* counts_out, void* winner,
                                 void* status, void* lists, void* list_n,
                                 void* ctrs, int m, int s_cnt, int n_max,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  const size_t smem = sizeof(int32_t) * claim_smem_words(s_cnt);
  auto* win_p = static_cast<int32_t*>(winner);
  auto* status_p = static_cast<unsigned long long*>(status);
  auto* lists_p = static_cast<int2*>(lists);
  auto* list_n_p = static_cast<int32_t*>(list_n);
  auto* tile_ctr = static_cast<int32_t*>(ctrs);
  cudaError_t err = allow_smem(fold_claim, smem);
  if (err != cudaSuccess) return (int)err;
  fold_claim<<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(sid), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(u_accept), static_cast<const float*>(u_slot),
      m, s_cnt, n_max, n_tiles, static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(capacity),
      static_cast<int32_t*>(counts_out), win_p, status_p, lists_p, list_n_p,
      tile_ctr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_write<<<n_tiles, kThreads, 0, stream>>>(
      lists_p, list_n_p, static_cast<const uint32_t*>(payload), win_p,
      static_cast<uint32_t*>(values), status_p, s_cnt, tile_ctr);
  return (int)cudaGetLastError();
}
