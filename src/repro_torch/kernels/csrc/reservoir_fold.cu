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
// Parted form. The claim keeps 16 x (S + 1) + 3 S int32 in shared memory
// (78 KB at S = 1,024) and S look-back words per tile, so past S = 1,024
// (the wrapper's MAX_STRATA) the wrapper asks for the parted form
// (parted_claim.cuh): a stratum is (part, lo), its low lo_bits bits lo;
// fold_parts counts the live items per part (and copies the counts), one
// parted_partition pass scatters them stably by part (one more per
// further 10 bits of the part id past 2^20 strata), and parted_claim
// ranks and claims each part's tiles over lo alone, writing the same
// per-warp lists, so the write launches are the same: 4 launches up to
// 2^20 strata. The plan (kernels/_workspace.py::parted_plan) keeps every
// look-back at 1,024 keys or fewer; the scratch grows with M + S, never
// with tiles x S. What bounds it beyond the small form's bytes: the
// chain of launches (a few us each at these sizes) and the 16 bytes a
// live item (index, stratum, both uniforms) that the partition writes in
// runs of a part and the claim reads in order, rather than gather a
// sector for each uniform. The only limit left is S * N_max + 1 < 2^31
// (int32 ring index), which the wrapper checks.
//
// Batched folds. The reference's masked ingest vmaps this kernel over the
// K ring slots of a chunk, and its sharded core vmaps that over the W
// shards, which batches its pallas_call into one call over [W, K] folds
// (fold (w, k): shard w's items under slot k's mask into slot k's
// [S, N_max] ring). Here too one call takes w * k folds: each launch of
// either form takes the fold as a grid axis (blockIdx.y, then z;
// fold_device.cuh's Shards), and a block offsets every pointer by its
// fold's stride in 64-bit arithmetic, into its fold's own scratch
// (counters, look-back words, lists, new counts, winner table, the parted
// form's scratch under one plan). The K folds of a shard read its item
// row (sid, uniforms, payload: Shards::row = K), not K copies of it; the
// masks are per fold. So a masked chunk is one call of 2 or 4 launches,
// not W * K; the form is chosen by S for the whole call, and each fold's
// bits are those of its unbatched call. The function needs every mask
// byte of every fold and, per live item, what the single fold needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"
#include "parted_claim.cuh"

using namespace fold;

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
               int32_t* __restrict__ tile_ctr, const Shards sd) {
  extern __shared__ int32_t sm[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  const long long row = item_row(sh, sd) * sd.items;
  sid += row;
  u_accept += row;
  u_slot += row;
  mask += sh * sd.mask;
  counts += sh * sd.cells;
  capacity += sh * sd.cells;
  counts_out += sh * sd.cells;
  winner += sh * sd.table;
  status += sh * sd.status;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  tile_ctr += sh * sd.ctrs;
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

__device__ __forceinline__ void copy_row(const RowLeaves& lv, int l,
                                         long long j, long long cell) {
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
// index there, before or after the reset). Over the folds of sd: each its
// own lists, winner words, look-back words, counter and ring rows, its
// payload rows its item row's.
__global__ void __launch_bounds__(kThreads)
    fold_write_rows(const int2* __restrict__ lists,
                    const int32_t* __restrict__ list_n,
                    const __grid_constant__ RowLeaves lv,
                    int32_t* __restrict__ winner,
                    unsigned long long* __restrict__ status, int cells,
                    int last, int32_t* __restrict__ tile_ctr,
                    const Shards sd) {
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  const long long j0 = item_row(sh, sd) * sd.items, c0 = sh * sd.table;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  winner += c0;
  status += sh * sd.status;
  tile_ctr += sh * sd.ctrs;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2* list = lists + (size_t)tile * kTile + warp * kWarpItems;
  const int n = list_n[tile * kWarps + warp];
  for (int q = lane; q < n; q += 32) {
    const int2 e = list[q];
    if (winner[e.y] != e.x) continue;
    for (int l = 0; l < lv.n; ++l) copy_row(lv, l, j0 + e.x, c0 + e.y);
    if (last) winner[e.y] = -1;
  }
  if (!last) return;
  for (int c = threadIdx.x; c < cells; c += kThreads)
    status[(size_t)c * gridDim.x + tile] = 0;
  if (tile == 0 && threadIdx.x == 0) *tile_ctr = 0;
}

// The parted form's cells: an item's stratum, or -1 (none) when it is
// masked out or its stratum is outside [0, S). A fold of a batch reads
// its item row's strata under its own mask.
struct FoldCells {
  const int32_t* sid;
  const uint8_t* mask;
  int s_cnt;
  __device__ __forceinline__ FoldCells at(long long sh,
                                          const Shards& sd) const {
    return FoldCells{sid + item_row(sh, sd) * sd.items, mask + sh * sd.mask,
                     s_cnt};
  }
  __device__ __forceinline__ const FoldCells& begin() const { return *this; }
  __device__ __forceinline__ int cell(long long j) const {
    const int s = sid[j];
    return mask[j] != 0 && s >= 0 && s < s_cnt ? s : -1;
  }
};

// The parted form's counting launch: each block's live items per digit
// (parted_claim.cuh), and every stratum's count copied to counts_out (the
// claim then writes the strata that have items); each fold of sd its own.
__global__ void __launch_bounds__(kThreads)
    fold_parts(const FoldCells cells, int m, const PartedPlan p,
               const int32_t* __restrict__ counts,
               int32_t* __restrict__ counts_out,
               int32_t* __restrict__ zeroed, int32_t* __restrict__ meta,
               const Shards sd) {
  extern __shared__ int32_t cnt[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  const FoldCells src = cells.at(sh, sd);
  counts += sh * sd.cells;
  counts_out += sh * sd.cells;
  zeroed += sh * sd.zeroed;
  meta += sh * sd.meta;
  for (int i = threadIdx.x; i < sum_keys(p); i += kThreads) cnt[i] = 0;
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < src.s_cnt;
       c += gridDim.x * kThreads)
    counts_out[c] = counts[c];
  __syncthreads();
  int32_t* ptot = part_totals(p, zeroed);
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int cell[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {  // all loads independent: one trip
      const long long j = item_index(tile, r);
      cell[r] = j < m ? src.cell(j) : -1;
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) count_part(cell[r], p, cnt, ptot);
  }
  __syncthreads();
  count_finish(cnt, p, zeroed, meta);
}

// The claim of the parted form: counts, partition, parted claim over the
// folds of sd (the scratch in the host array pt, parted_claim.cuh's
// slots, fold 0's).
int launch_parted(const void* sid, const void* u_accept, const void* u_slot,
                  const void* mask, const void* counts, const void* capacity,
                  void* counts_out, void* winner, void* status, void* lists,
                  void* list_n, void* ctrs, const PartedPlan& p,
                  void* const* pt, int m, int s_cnt, int n_max,
                  const Shards& sd, cudaStream_t stream) {
  const FoldCells src{static_cast<const int32_t*>(sid),
                      static_cast<const uint8_t*>(mask), s_cnt};
  auto* st = static_cast<unsigned long long*>(status);
  auto* tile_ctr = static_cast<int32_t*>(ctrs);
  const size_t smem = sizeof(int32_t) * count_smem_words(p, 0);
  cudaError_t e = allow_smem(fold_parts, smem);
  if (e != cudaSuccess) return (int)e;
  fold_parts<<<shard_grid(count_grid(p), sd.n), kThreads, smem, stream>>>(
      src, m, p, static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(pt[kPtZeroed]),
      static_cast<int32_t*>(pt[kPtMeta]), sd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int err = launch_partition(
      ClaimItems<FoldCells>{src, static_cast<const float*>(u_accept),
                            static_cast<const float*>(u_slot)},
      p, m, pt, st + claim_words(p), tile_ctr, sd, stream);
  if (err != 0) return err;
  return launch_parted_claim(
      p, pt, s_cnt, n_max,
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(capacity),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(winner),
      static_cast<int2*>(lists), static_cast<int32_t*>(list_n), st, tile_ctr,
      sd, stream);
}

// The claim launch, shared by the scalar and the tree entry points.
int launch_claim(const void* sid, const void* u_accept, const void* u_slot,
                 const void* mask, const void* counts, const void* capacity,
                 void* counts_out, void* winner, void* status, void* lists,
                 void* list_n, void* ctrs, int m, int s_cnt, int n_max,
                 int n_tiles, const Shards& sd, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * claim_smem_words(s_cnt);
  cudaError_t err = allow_smem(fold_claim, smem);
  if (err != cudaSuccess) return (int)err;
  fold_claim<<<shard_grid(n_tiles, sd.n), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(sid), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(u_accept), static_cast<const float*>(u_slot),
      m, s_cnt, n_max, n_tiles, static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(capacity),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(winner),
      static_cast<unsigned long long*>(status), static_cast<int2*>(lists),
      static_cast<int32_t*>(list_n), static_cast<int32_t*>(ctrs), sd);
  return (int)cudaGetLastError();
}

}  // namespace

// Items one tile (one block of either launch) covers, and its lists.
extern "C" int sa_fold_tile_items() { return kTile; }
extern "C" int sa_fold_tile_lists() { return kWarps; }

// 1 if `plan` (kPlanInts ints) is a parted plan of `cells` cells and m
// items that the kernels run, else 0.
extern "C" int sa_parted_plan_ok(const int* plan, long long cells, int m) {
  PartedPlan p;
  return read_plan(plan, cells, m, &p) ? 1 : 0;
}

// Scratch (kept by the caller between calls), for each of the w * k folds
// of a call, fold after fold: winner i32[S * N_max], all -1; status
// u64[S * n_tiles] (small form) or the plan's look-back words (parted
// form), all 0; ctrs i32[3], 0 (the tile counter first); lists
// int2[tiles * kTile] and list_n i32[tiles * kWarps] over the claim's
// tiles, no state. The kernels leave winner, status and ctrs as they
// found them. values and payload are 4-byte words (f32 or i32), copied
// as bits. plan: null for the small form, else the parted form's
// kPlanInts ints (kernels/_workspace.py::parted_plan), and pt its scratch
// (parted_claim.cuh's slots kPtZeroed to kPtItemsB, each fold's
// zeroed_words, meta_words rounded up to 4 and m (one pass) or 2 m int4
// items after the fold before's).
//
// A call folds w item rows (sid, payload, u_accept, u_slot: [w, m]) into
// w * k rings (values [w, k, S, N_max], counts and capacity [w, k, S]),
// fold b = (row b / k, slot b % k) under its own mask [w, k, m]; w = k = 1
// is one fold.
namespace {

constexpr int kFoldCtrWords = 3;              // a fold's counter words

// The folds of a call and every array's stride, under the form's grid.
Shards fold_shards(int w, int k, int m, int s_cnt, int n_max, int grid,
                   const PartedPlan* p) {
  Shards sd = one_shard();
  sd.n = w * k;
  sd.row = k;
  sd.items = m;
  sd.mask = m;
  sd.cells = s_cnt;
  sd.table = (long long)s_cnt * n_max;
  sd.ctrs = kFoldCtrWords;
  sd.status = p != nullptr ? (long long)pass_words(*p, p->passes)
                           : (long long)s_cnt * grid;
  sd.lists = (long long)grid * kTile;
  sd.list_n = (long long)grid * kWarps;
  if (p != nullptr) {
    sd.zeroed = zeroed_words(*p);
    sd.meta = (meta_words(*p) + 3) & ~3;  // the claim's map is read as int4
    sd.part = (long long)m * (p->passes > 1 ? 2 : 1);
  }
  return sd;
}

// The claim of either form over the w * k folds; *grid, *keys and *sd get
// the write launches' grid, the look-back words per tile they clear (the
// small form's) and the folds' strides.
int launch_either(const void* sid, const void* u_accept, const void* u_slot,
                  const void* mask, const void* counts, const void* capacity,
                  void* counts_out, void* winner, void* status, void* lists,
                  void* list_n, void* ctrs, const int* plan, void* const* pt,
                  int m, int s_cnt, int n_max, int w, int k,
                  cudaStream_t stream, int* grid, int* keys, Shards* sd) {
  if (w < 1 || k < 1 || w > INT32_MAX / k) return (int)cudaErrorInvalidValue;
  *grid = m > 0 ? (m + kTile - 1) / kTile : 1;
  *keys = s_cnt;
  if (plan == nullptr) {
    *sd = fold_shards(w, k, m, s_cnt, n_max, *grid, nullptr);
    return launch_claim(sid, u_accept, u_slot, mask, counts, capacity,
                        counts_out, winner, status, lists, list_n, ctrs, m,
                        s_cnt, n_max, *grid, *sd, stream);
  }
  PartedPlan p;
  if (!read_plan(plan, s_cnt, m, &p) || pt == nullptr)
    return (int)cudaErrorInvalidValue;
  *grid = p.claim_grid;
  *keys = 0;                   // the parted claim clears its own words
  *sd = fold_shards(w, k, m, s_cnt, n_max, *grid, &p);
  return launch_parted(sid, u_accept, u_slot, mask, counts, capacity,
                       counts_out, winner, status, lists, list_n, ctrs, p, pt,
                       m, s_cnt, n_max, *sd, stream);
}

}  // namespace

extern "C" int sa_reservoir_fold(const void* sid, const void* payload,
                                 const void* u_accept, const void* u_slot,
                                 const void* mask, const void* counts,
                                 const void* capacity, void* values,
                                 void* counts_out, void* winner,
                                 void* status, void* lists, void* list_n,
                                 void* ctrs, const int* plan,
                                 void* const* pt, int m, int s_cnt,
                                 int n_max, int w, int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int grid, keys;
  Shards sd;
  const int err = launch_either(sid, u_accept, u_slot, mask, counts,
                                capacity, counts_out, winner, status, lists,
                                list_n, ctrs, plan, pt, m, s_cnt, n_max, w, k,
                                stream, &grid, &keys, &sd);
  if (err != 0) return err;
  fold_write<<<shard_grid(grid, sd.n), kThreads, 0, stream>>>(
      static_cast<const int2*>(lists), static_cast<const int32_t*>(list_n),
      static_cast<const uint32_t*>(payload), static_cast<int32_t*>(winner),
      static_cast<uint32_t*>(values),
      static_cast<unsigned long long*>(status), keys,
      static_cast<int32_t*>(ctrs), sd);
  return (int)cudaGetLastError();
}

// The fold of a payload tree: payloads and values are host arrays of
// n_leaves pointers (leaf l [w, m, *item] into [w, k, S, N_max, *item],
// row_bytes[l] bytes an item), any dtype; the scratch, plan, pt, w and k
// as sa_reservoir_fold's. The claim, then one write launch per group of
// kMaxLeaves leaves.
extern "C" int sa_reservoir_fold_rows(
    const void* sid, const void* const* payloads, const void* u_accept,
    const void* u_slot, const void* mask, const void* counts,
    const void* capacity, void* const* values, const long long* row_bytes,
    void* counts_out, void* winner, void* status, void* lists, void* list_n,
    void* ctrs, const int* plan, void* const* pt, int m, int s_cnt,
    int n_max, int n_leaves, int w, int k, void* stream_ptr) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int grid, keys;
  Shards sd;
  const int err = launch_either(sid, u_accept, u_slot, mask, counts,
                                capacity, counts_out, winner, status, lists,
                                list_n, ctrs, plan, pt, m, s_cnt, n_max, w, k,
                                stream, &grid, &keys, &sd);
  if (err != 0) return err;
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
    fold_write_rows<<<shard_grid(grid, sd.n), kThreads, 0, stream>>>(
        static_cast<const int2*>(lists), static_cast<const int32_t*>(list_n),
        lv, static_cast<int32_t*>(winner),
        static_cast<unsigned long long*>(status), keys, last,
        static_cast<int32_t*>(ctrs), sd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
