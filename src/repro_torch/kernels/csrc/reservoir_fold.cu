// OASRS reservoir fold for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/reservoir.py::_fold_kernel
// (wrapper reservoir_fold). That kernel walks the chunk item by item in a
// fori_loop with the [S, N_max] reservoirs pinned in VMEM: one core, one
// item at a time. Here the same exact sequential Vitter semantics come
// from the parallel rank/scatter-max form of the reference's
// core/oasrs.py::apply_chunk_uniforms, bitwise equal to it: tile counts,
// a scan over tiles, the in-tile rank and atomicMax winner, the
// gather-write (device code in fold_device.cuh, shared with
// one_shot_ingest.cu).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"

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
