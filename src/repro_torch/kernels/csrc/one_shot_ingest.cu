// One-shot ingest for Hopper (sm_90a): the whole accepted-item path of one
// chunk (watermark routing, ring-slot reset, (slot, stratum) cell
// assignment, the Vitter fold and the obs counter rows) in one call.
//
// Replaces the TPU kernel src/repro/kernels/reservoir.py:146
// (_one_shot_kernel, wrapper one_shot_ingest). That kernel is a two-phase
// sequential grid: phase 0 scans the item tiles for the frontier maxima,
// phase 1 walks every item through a fori_loop with the [K·S, N_max] ring,
// the cell counters and the counter rows pinned in VMEM. Neither maps to
// this card: blocks run in parallel and in no order, and the ring of the
// main path ([2, 3, 1,048,576] f32 = 25,165,824 B) is a hundred times
// what one block's shared memory holds. So the call is a chain of
// launches on one stream, every intermediate in a caller-allocated
// workspace:
//
//   1. osi_frontier   per-block masked maxima of t and floor(t * 1/span);
//   2. osi_prologue   (one block) the final maxima -> new frontier and
//                     newest interval; the desired occupant of each slot;
//                     the per-cell reset of counts and capacity IN PLACE;
//                     a copy c0 of the post-reset counts;
//   3. osi_route      each item's verdict against the PRE-chunk watermark
//                     and the POST-chunk oldest live interval, its cell
//                     (tgt mod K)*S + sid, the per-tile cell counts of live
//                     items, and per-block per-stratum histograms of the
//                     ingested/accepted/late/dropped rows and the
//                     on-time/late/dropped/item totals, added to the state
//                     with one integer atomicAdd per (block, stratum, row):
//                     integer atomics, so the result is the same every run;
//   4-6. the fold's own kernels (fold_device.cuh) over the K·S cells:
//                     fold_tile_scan (new counts written in place),
//                     fold_decide, fold_write (ring written in place);
//   7. osi_finalize   (one block) the replaced and occupancy rows from
//                     c0 and the post-fold counts, the new frontier and
//                     newest interval, chunks + 1.
//
// Every watermark scalar stays on the device: the pre-chunk values are
// read through their pointers and the new ones written in place.
//
// Arithmetic is the reference's f32: the interval is floor(t * f32(1/span))
// (__fmul_rn; the reciprocal comes rounded from the host), which is what
// the reference's compiled step computes; the watermark is
// max_time - f32(lateness) (__fsub_rn); the fold's verdicts are its own
// __fmul_rn products. The library is built with -fmad=false.
//
// What bounds it on this card: memory. Per item it must read 21 bytes
// (times, sid, payload, two uniforms, mask) and it writes 4 bytes per ring
// cell that an accepted item wins: about 11.5 MB at M = 524,288, or
// 0.0034 ms at 3.35 TB/s. This first version is simple, not fast: it
// re-reads its per-item cell words between launches and, like the fold,
// clears a winner table of 4 bytes per ring cell with one memset per chunk
// (25,165,824 B at [2, 3, 1,048,576]; the fold's memset of the same table
// took 0.0088 ms of device time on an H100).
//
// Limits: K*S <= 1024 (the rank pass keeps 8 warps x (K*S + 1) int32
// counts in shared memory, 32.8 KB at the limit) and K*S*N_max + 1 < 2^31
// (int32 ring index); the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"

namespace {

constexpr float kNegTime = -3.0e38f;          // the reference's _NEG
constexpr int32_t kIMin = -2147483647;        // -(2^31) + 1, its _IMIN
constexpr int kOneBlock = 1024;

// Workspace header written by osi_prologue (int32 words; two hold f32).
constexpr int kHdrWmark = 0, kHdrNewMax = 1, kHdrOpenBefore = 2,
              kHdrNewOpen = 3, kHdrWords = 4;

__device__ __forceinline__ int32_t interval_of(float t, float recip) {
  return __float2int_rz(floorf(__fmul_rn(t, recip)));
}

__device__ __forceinline__ int32_t pymod(int32_t a, int32_t k) {
  int32_t r = a % k;
  return r < 0 ? r + k : r;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int d = 16; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// Block-wide max of (t, iv); the result is valid in thread 0.
__device__ void block_max(float& t, int32_t& iv) {
  __shared__ float wt[32];
  __shared__ int32_t wi[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t = warp_max(t);
  iv = warp_max(iv);
  if (lane == 0) {
    wt[warp] = t;
    wi[warp] = iv;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    t = lane < n_warps ? wt[lane] : kNegTime;
    iv = lane < n_warps ? wi[lane] : kIMin;
    t = warp_max(t);
    iv = warp_max(iv);
  }
}

__global__ void osi_frontier(const float* __restrict__ times,
                             const uint8_t* __restrict__ mask, int m,
                             float recip, float* __restrict__ part_t,
                             int32_t* __restrict__ part_i) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  float t = kNegTime;
  int32_t iv = kIMin;
  if (j < m && mask[j]) {
    t = times[j];
    iv = interval_of(t, recip);
  }
  block_max(t, iv);
  if (threadIdx.x == 0) {
    part_t[blockIdx.x] = t;
    part_i[blockIdx.x] = iv;
  }
}

__global__ void osi_prologue(const float* __restrict__ part_t,
                             const int32_t* __restrict__ part_i, int n_parts,
                             const float* __restrict__ max_time,
                             const int32_t* __restrict__ open_interval,
                             float lateness,
                             int32_t* __restrict__ slot_interval,
                             const int32_t* __restrict__ adopt,
                             int32_t* __restrict__ counts,
                             int32_t* __restrict__ capacity,
                             int32_t* __restrict__ c0,
                             int32_t* __restrict__ hdr, int k, int s) {
  __shared__ int32_t new_open_s;
  float t = kNegTime;
  int32_t iv = kIMin;
  for (int b = threadIdx.x; b < n_parts; b += blockDim.x) {
    t = fmaxf(t, part_t[b]);
    iv = max(iv, part_i[b]);
  }
  block_max(t, iv);
  if (threadIdx.x == 0) {
    const float before = max_time[0];
    const int32_t open_before = open_interval[0];
    const int32_t new_open = max(open_before, iv);
    float* hdr_f = reinterpret_cast<float*>(hdr);
    hdr_f[kHdrWmark] = __fsub_rn(before, lateness);   // PRE-chunk watermark
    hdr_f[kHdrNewMax] = fmaxf(before, t);
    hdr[kHdrOpenBefore] = open_before;
    hdr[kHdrNewOpen] = new_open;
    new_open_s = new_open;
  }
  __syncthreads();
  const int32_t new_open = new_open_s;
  for (int c = threadIdx.x; c < k * s; c += blockDim.x) {
    const int slot = c / s;
    const int32_t desired = new_open - pymod(new_open - slot, k);
    const bool reset = desired != slot_interval[slot];
    const int32_t cnt = reset ? 0 : counts[c];
    counts[c] = cnt;
    c0[c] = cnt;
    if (reset) capacity[c] = adopt[c - slot * s];
  }
  __syncthreads();                 // every read of slot_interval is done
  for (int slot = threadIdx.x; slot < k; slot += blockDim.x)
    slot_interval[slot] = new_open - pymod(new_open - slot, k);
}

__global__ void osi_route(const float* __restrict__ times,
                          const int32_t* __restrict__ sid,
                          const uint8_t* __restrict__ mask, int m,
                          float recip, const int32_t* __restrict__ hdr, int k,
                          int s, int n_tiles, int32_t* __restrict__ cell_of,
                          int32_t* __restrict__ tile_counts,
                          int32_t* __restrict__ rows,
                          int32_t* __restrict__ on_time,
                          int32_t* __restrict__ late,
                          int32_t* __restrict__ dropped,
                          int32_t* __restrict__ items) {
  extern __shared__ int32_t sm[];  // [K*S + 1] cells, [4][S] rows, [4] totals
  const int cells = k * s;
  int32_t* cnt = sm;
  int32_t* hist = sm + cells + 1;
  int32_t* tot = hist + 4 * s;
  for (int i = threadIdx.x; i < cells + 1 + 4 * s + 4; i += blockDim.x)
    sm[i] = 0;
  __syncthreads();
  const float wmark = reinterpret_cast<const float*>(hdr)[kHdrWmark];
  const int32_t open_before = hdr[kHdrOpenBefore];
  const int32_t oldest_live = hdr[kHdrNewOpen] - k + 1;
  const int j = blockIdx.x * kTile + threadIdx.x;
  int cell = cells;                // sentinel: no cell
  if (j < m) {
    const bool mk = mask[j] != 0;
    const float t = times[j];
    const int32_t tgt = interval_of(t, recip);
    const int st = sid[j];
    const bool live = mk && !(t < wmark) && !(tgt < oldest_live);
    const bool late_v = live && tgt < open_before;
    const bool valid = st >= 0 && st < s;
    if (live && valid) cell = pymod(tgt, k) * s + st;
    if (valid) {
      if (mk) atomicAdd(&hist[st], 1);                 // ingested
      if (live) atomicAdd(&hist[s + st], 1);           // accepted
      if (late_v) atomicAdd(&hist[2 * s + st], 1);     // late
      if (mk && !live) atomicAdd(&hist[3 * s + st], 1);  // dropped
    }
    if (live && !late_v) atomicAdd(&tot[0], 1);
    if (late_v) atomicAdd(&tot[1], 1);
    if (mk && !live) atomicAdd(&tot[2], 1);
    if (mk) atomicAdd(&tot[3], 1);
    cell_of[j] = cell;
  }
  atomicAdd(&cnt[cell], 1);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x)
    tile_counts[(int64_t)c * n_tiles + blockIdx.x] = cnt[c];
  for (int i = threadIdx.x; i < 4 * s; i += blockDim.x)
    if (hist[i] != 0) atomicAdd(&rows[i], hist[i]);
  if (threadIdx.x == 0) {
    if (tot[0]) atomicAdd(on_time, tot[0]);
    if (tot[1]) atomicAdd(late, tot[1]);
    if (tot[2]) atomicAdd(dropped, tot[2]);
    if (tot[3]) atomicAdd(items, tot[3]);
  }
}

__global__ void osi_finalize(const int32_t* __restrict__ c0,
                             const int32_t* __restrict__ counts,
                             const int32_t* __restrict__ capacity,
                             const int32_t* __restrict__ hdr, int k, int s,
                             int32_t* __restrict__ rows,
                             float* __restrict__ max_time,
                             int32_t* __restrict__ open_interval,
                             int32_t* __restrict__ chunks) {
  for (int st = threadIdx.x; st < s; st += blockDim.x) {
    int32_t repl = 0, occ = 0;
    for (int slot = 0; slot < k; ++slot) {
      const int c = slot * s + st;
      const int32_t a = c0[c], b = counts[c], cap = capacity[c];
      const int32_t f0 = min(a, cap), f1 = min(b, cap);
      repl += (b - a) - (f1 - f0);
      occ += f1;
    }
    rows[4 * s + st] += repl;      // replaced
    rows[5 * s + st] = occ;        // occupancy gauge
  }
  if (threadIdx.x == 0) {
    max_time[0] = reinterpret_cast<const float*>(hdr)[kHdrNewMax];
    open_interval[0] = hdr[kHdrNewOpen];
    chunks[0] += 1;
  }
}

struct Workspace {
  float* part_t;
  int32_t* part_i;
  int32_t* hdr;
  int32_t* c0;
  int32_t* tile_counts;
  int32_t* tile_offsets;
  int32_t* cell_of;
  int32_t* cell;
  int32_t* winner;
  long long words;
};

Workspace carve(int32_t* base, int m, int cells, int n_max) {
  const long long n_tiles = m > 0 ? (m + kTile - 1) / kTile : 0;
  Workspace w;
  long long off = 0;
  auto take = [&](long long n) {
    int32_t* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  w.part_t = reinterpret_cast<float*>(take(n_tiles));
  w.part_i = take(n_tiles);
  w.hdr = take(kHdrWords);
  w.c0 = take(cells);
  w.tile_counts = take(cells * n_tiles);
  w.tile_offsets = take(cells * n_tiles);
  w.cell_of = take(m);
  w.cell = take(m);
  w.winner = take((long long)cells * n_max);
  w.words = off;
  return w;
}

}  // namespace

// int32 words of workspace one call needs.
extern "C" long long sa_one_shot_workspace_words(int m, int cells,
                                                 int n_max) {
  return carve(nullptr, m, cells, n_max).words;
}

// Pointers: times f32[M], sid i32[M], payload 4-byte words [M], mask
// u8[M], u_accept/u_slot f32[M]; the state, updated in place: max_time
// f32[], open_interval/on_time/late/dropped/chunks/items i32[],
// slot_interval i32[K], counts/capacity i32[K, S], values [K, S, N_max]
// 4-byte words, counters i32[6, S]; adopt i32[S] (read only, <= N_max);
// workspace of sa_one_shot_workspace_words(m, K*S, n_max) int32 words.
extern "C" int sa_one_shot_ingest(
    const void* times, const void* sid, const void* payload, const void* mask,
    const void* u_accept, const void* u_slot, void* max_time,
    void* open_interval, void* on_time, void* late, void* dropped,
    void* chunks, void* items, void* slot_interval, const void* adopt,
    void* counts, void* capacity, void* values, void* counters,
    void* workspace, int m, int k, int s, int n_max, float recip,
    float lateness, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int cells = k * s;
  const int n_tiles = m > 0 ? (m + kTile - 1) / kTile : 0;
  Workspace w = carve(static_cast<int32_t*>(workspace), m, cells, n_max);
  auto* times_p = static_cast<const float*>(times);
  auto* mask_p = static_cast<const uint8_t*>(mask);
  auto* counts_p = static_cast<int32_t*>(counts);
  auto* cap_p = static_cast<int32_t*>(capacity);
  auto* rows = static_cast<int32_t*>(counters);
  if (n_tiles > 0) {
    cudaMemsetAsync(w.winner, 0xFF, sizeof(int32_t) * (size_t)cells * n_max,
                    stream);
    osi_frontier<<<n_tiles, kTile, 0, stream>>>(times_p, mask_p, m, recip,
                                                w.part_t, w.part_i);
  }
  osi_prologue<<<1, kOneBlock, 0, stream>>>(
      w.part_t, w.part_i, n_tiles, static_cast<const float*>(max_time),
      static_cast<const int32_t*>(open_interval), lateness,
      static_cast<int32_t*>(slot_interval),
      static_cast<const int32_t*>(adopt), counts_p, cap_p, w.c0, w.hdr, k, s);
  if (n_tiles > 0) {
    const size_t route_smem = sizeof(int32_t) * (cells + 1 + 4 * s + 4);
    osi_route<<<n_tiles, kTile, route_smem, stream>>>(
        times_p, static_cast<const int32_t*>(sid), mask_p, m, recip, w.hdr, k,
        s, n_tiles, w.cell_of, w.tile_counts, rows,
        static_cast<int32_t*>(on_time), static_cast<int32_t*>(late),
        static_cast<int32_t*>(dropped), static_cast<int32_t*>(items));
    fold_tile_scan<<<cells, kScanThreads, 0, stream>>>(
        w.tile_counts, n_tiles, w.c0, w.tile_offsets, counts_p);
    fold_decide<<<n_tiles, kTile, sizeof(int32_t) * kWarps * (cells + 1),
                  stream>>>(w.cell_of, nullptr,
                            static_cast<const float*>(u_accept),
                            static_cast<const float*>(u_slot), m, cells,
                            n_max, n_tiles, w.c0, cap_p, w.tile_offsets,
                            w.cell, w.winner);
    fold_write<<<n_tiles, kTile, 0, stream>>>(
        static_cast<const uint32_t*>(payload), m, w.cell, w.winner,
        static_cast<uint32_t*>(values));
  }
  osi_finalize<<<1, kOneBlock, 0, stream>>>(
      w.c0, counts_p, cap_p, w.hdr, k, s, rows,
      static_cast<float*>(max_time), static_cast<int32_t*>(open_interval),
      static_cast<int32_t*>(chunks));
  return (int)cudaGetLastError();
}
