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
// what one block's shared memory holds.
//
// What bounds it on this card: memory. The function must read the mask of
// every item, the time and stratum of each masked-in item, then what the
// fold needs of the live ones (fold_device.cuh), and write each ring cell
// won: 7,621,632 B at the steady replacement chunk that chip_smoke.py
// times (524,288 items, 508,473 live, 84,918 accepted, 81,965 cells won,
// into [2, 3, 1,048,576]), 0.0023 ms at 3.35 TB/s; at that size the
// latency of dependent trips to memory weighs more than the bytes. The
// call has two real grid-wide dependencies (the frontier maxima before
// any verdict, every claim before any write), so it is three launches on
// one stream, every intermediate in scratch the wrapper keeps:
//
//   1. osi_frontier    per-block masked maxima of t and floor(t * 1/span),
//                      folded into two words of scratch by integer
//                      atomicMax on order-preserving encodings;
//   2. osi_route_claim every tile reads those two words and the carried
//                      slot table, counts and capacities, and works out the
//                      slot reset itself (tiny, so each does it rather than
//                      wait on one block); then each item's verdict against
//                      the PRE-chunk watermark and the POST-chunk oldest
//                      live interval, its cell (tgt mod K)*S + sid, and the
//                      fold's single-pass look-back scan and claim over the
//                      K·S cells (fold_device.cuh). Per-block per-stratum
//                      counts of the ingested/accepted/late/dropped rows
//                      (per-warp rows in shared memory, no atomics there)
//                      and the on-time/late/dropped/item totals go out by
//                      one integer atomicAdd per (block, stratum, row), so
//                      the result is the same every run. The tile that
//                      comes last writes the new counts to scratch, the
//                      replaced and occupancy rows, and chunks + 1;
//   3. osi_write       the winners' payloads into the ring, in place, every
//                      leaf of the payload at each winner's cell (the
//                      reference's payload is a pytree of [M] 4-byte
//                      leaves folding through one set of decisions; the
//                      leaves' pointers come by value, at most kMaxLeaves);
//                      its block 0 writes the carried state that launch 2
//                      still read (counts, capacities, slot table,
//                      frontier, newest interval) and leaves the scratch
//                      as the next call needs it.
//
// No memset and no pass over the ring: the winner table is self-clearing
// (fold_device.cuh), kept by the wrapper, which assumes the calls sharing
// it are ordered on one stream and drops it if a launch fails. Each item
// is read once for the frontier (times, mask) and once for the rest.
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
// Shards. The reference's sharded core vmaps this kernel over W shards,
// which batches its pallas_call into one call whose grid leads with the
// shard. Here too a call may carry a leading [W] axis on every array:
// each launch takes the shard as a grid axis (blockIdx.y, fold_device.cuh's
// Shards), and a block offsets every pointer by its shard's stride in
// 64-bit arithmetic, into its shard's own scratch (counters, look-back
// words, lists, new counts, winner table, the parted form's scratch under
// one plan). So a sharded chunk is one call of 3 or 5 launches, not W;
// each shard's form, plan and bits are those of its unbatched call.
//
// Payload leaves: groups of kMaxLeaves, one write launch each; only the
// last group's launch (osi_write) resets the winner words and writes the
// carried state, the others (osi_write_group) copy their leaves' words.
//
// Parted form. The route-and-claim launch keeps 16 x (K*S + 1) + 4 K*S
// int32 and the per-warp rows 32 S + 4 int32 in shared memory (208 KB of
// the 227 KB a block may have at K = 1, S = 1024) and K*S look-back words
// per tile, so past K*S = 1,024 (the wrapper's MAX_CELLS) the wrapper asks
// for the parted form (parted_claim.cuh), whose scratch grows with M +
// K*S, never with tiles x K*S:
//   1. osi_frontier      as above;
//   2. osi_route_parts   each item's verdict and cell; the ingested
//                        items per stratum (into scratch) and the late row
//                        per block in shared memory (up to kSmemRowStrata
//                        strata, else warp-aggregated global atomics), one
//                        global add per nonzero word; the totals as above;
//                        the live items per part; every cell's slot reset
//                        into scratch; its last block scans the part
//                        totals;
//   3. parted_partition  the live items scattered stably by part (the
//                        cell recomputed from the items, as launch 2);
//   4. parted_claim      each part's tiles ranked and looked back over the
//                        cell's low bits alone, then the small form's
//                        verdicts, claims and lists; the last tile of each
//                        part writes its cells' new counts to scratch;
//   5. osi_write_parted  the winners' payloads, then grid-wide the carried
//                        counts and capacities, the ingested, accepted
//                        (the new counts less the old over a stratum's
//                        slots), dropped, replaced and occupancy rows, and
//                        in block 0 the slot table, frontier, newest
//                        interval and chunks.
// Up to 2^20 cells that is 5 launches; each further 10 bits of the part
// id past that adds one partition pass. What bounds it beyond the small
// form's bytes is the chain of launches (a few us each at these sizes).
// The only limit left is K*S*N_max + 1 < 2^31 (int32 ring index), which
// the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_device.cuh"
#include "parted_claim.cuh"

using namespace fold;

namespace {

constexpr float kNegTime = -3.0e38f;          // the reference's _NEG
constexpr int32_t kIMin = -2147483647;        // -(2^31) + 1, its _IMIN

// Scratch counters: the tile counter, then the chunk's frontier maxima as
// order-preserving unsigned encodings (0, below every encoding, when no
// item is masked in). All three are 0 between calls; a shard has its own.
constexpr int kCtrTile = 0, kCtrTime = 1, kCtrInterval = 2, kCtrWords = 3;

__device__ __forceinline__ unsigned enc_time(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float dec_time(unsigned u) {
  return u == 0 ? kNegTime
                : __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned enc_interval(int32_t v) {
  return (unsigned)v ^ 0x80000000u;
}

__device__ __forceinline__ int32_t dec_interval(unsigned u) {
  return u == 0 ? kIMin : (int32_t)(u ^ 0x80000000u);
}

__device__ __forceinline__ int32_t interval_of(float t, float recip) {
  return __float2int_rz(floorf(__fmul_rn(t, recip)));
}

__device__ __forceinline__ int32_t pymod(int32_t a, int32_t k) {
  int32_t r = a % k;
  return r < 0 ? r + k : r;
}

// The interval ring slot `slot` holds once the newest is `open`.
__device__ __forceinline__ int32_t desired_interval(int32_t open, int slot,
                                                    int k) {
  return open - pymod(open - slot, k);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int d = 16; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    osi_frontier(const float* __restrict__ times,
                 const uint8_t* __restrict__ mask, int m, float recip,
                 unsigned* __restrict__ ctrs, const Shards sd) {
  __shared__ float wt[kWarps];
  __shared__ int32_t wi[kWarps];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  times += sh * sd.items;
  mask += sh * sd.items;
  ctrs += sh * sd.ctrs;
  float t = kNegTime;
  int32_t iv = kIMin;
  bool any = false;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const long long j =
        (long long)blockIdx.x * kTile + r * kThreads + threadIdx.x;
    bool mk = false;
    float tj = kNegTime;
    if (j < m) {
      mk = mask[j] != 0;
      tj = times[j];
    }
    if (mk) {
      t = fmaxf(t, tj);
      iv = max(iv, interval_of(tj, recip));
      any = true;
    }
  }
  t = warp_max(t);
  iv = warp_max(iv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wt[warp] = t;
    wi[warp] = iv;
  }
  if (!__syncthreads_or(any)) return;   // nothing masked in this block
  if (warp == 0) {
    t = warp_max(lane < kWarps ? wt[lane] : kNegTime);
    iv = warp_max(lane < kWarps ? wi[lane] : kIMin);
    if (lane == 0) {
      atomicMax(ctrs + kCtrTime, enc_time(t));
      atomicMax(ctrs + kCtrInterval, enc_interval(iv));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    osi_route_claim(const float* __restrict__ times,
                    const int32_t* __restrict__ sid,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ u_accept,
                    const float* __restrict__ u_slot, int m, float recip,
                    float lateness, int k, int s, int n_max, int n_tiles,
                    const float* __restrict__ max_time,
                    const int32_t* __restrict__ open_interval,
                    const int32_t* __restrict__ slot_interval,
                    const int32_t* __restrict__ adopt,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ capacity,
                    int32_t* __restrict__ new_counts,
                    int32_t* __restrict__ winner,
                    unsigned long long* __restrict__ status,
                    int2* __restrict__ lists, int32_t* __restrict__ list_n,
                    unsigned* __restrict__ ctrs,
                    int32_t* __restrict__ rows,
                    int32_t* __restrict__ on_time,
                    int32_t* __restrict__ late,
                    int32_t* __restrict__ dropped,
                    int32_t* __restrict__ items,
                    int32_t* __restrict__ chunks, const Shards sd) {
  const int cells = k * s;
  extern __shared__ int32_t sm[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  times += sh * sd.items;
  sid += sh * sd.items;
  mask += sh * sd.items;
  u_accept += sh * sd.items;
  u_slot += sh * sd.items;
  max_time += sh;
  open_interval += sh;
  slot_interval += sh * k;
  adopt += sh * s;
  counts += sh * sd.cells;
  capacity += sh * sd.cells;
  new_counts += sh * sd.cells;
  winner += sh * sd.table;
  status += sh * sd.status;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  ctrs += sh * sd.ctrs;
  rows += sh * 6 * s;
  on_time += sh;
  late += sh;
  dropped += sh;
  items += sh;
  chunks += sh;
  int32_t* wrun = sm;
  int32_t* agg = wrun + kWarps * (cells + 1);
  int32_t* base = agg + cells;
  int32_t* cap = base + cells;
  int32_t* c0 = cap + cells;       // post-reset counts
  int32_t* tot = c0 + cells;       // on-time, late, dropped, items
  int32_t* rows_w = tot + 4;       // [kWarps][2][S]: ingested, late
  __shared__ float wmark_s;
  __shared__ int32_t open_before_s, new_open_s;
  const int tile = take_tile(reinterpret_cast<int32_t*>(ctrs + kCtrTile));
  // What the last tile updates, read now so that its finalize does not
  // wait on memory (the rows of strata beyond kThreads are read then).
  int32_t replaced = 0, n_chunks = 0;
  if (tile == n_tiles - 1) {
    if ((int)threadIdx.x < s) replaced = rows[4 * s + threadIdx.x];
    if (threadIdx.x == 0) n_chunks = chunks[0];
  }

  float tv[kItems], ua[kItems], us[kItems];
  int st[kItems];
  bool mk[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const long long j = item_index(tile, r);
    mk[r] = false;
    st[r] = -1;
    tv[r] = ua[r] = us[r] = 0.0f;
    if (j < m) {
      mk[r] = mask[j] != 0;
      tv[r] = times[j];
      st[r] = sid[j];
      ua[r] = u_accept[j];
      us[r] = u_slot[j];
    }
  }
  // The carried state as launch 1 left it (the pre-chunk values), beside
  // the items: slot table in base, adopt in agg until the reset below.
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const int slot = c / s;
    c0[c] = counts[c];
    cap[c] = capacity[c];
    base[c] = slot_interval[slot];
    agg[c] = adopt[c - slot * s];
  }
  for (int i = threadIdx.x; i < 4 + 2 * kWarps * s; i += kThreads) tot[i] = 0;
  if (threadIdx.x == 0) {
    const int32_t open_before = open_interval[0];
    wmark_s = __fsub_rn(max_time[0], lateness);      // PRE-chunk watermark
    open_before_s = open_before;
    new_open_s = max(open_before, dec_interval(ctrs[kCtrInterval]));
  }
  __syncthreads();
  const float wmark = wmark_s;
  const int32_t open_before = open_before_s, new_open = new_open_s;
  const int32_t oldest_live = new_open - k + 1;
  const int32_t open_slot = pymod(new_open, k);
  for (int c = threadIdx.x; c < cells; c += kThreads) {   // the slot reset
    if (desired_interval(new_open, c / s, k) != base[c]) {
      c0[c] = 0;
      cap[c] = agg[c];
    }
    base[c] = c0[c];
  }

  const int lane = threadIdx.x & 31;
  int32_t* my_rows = rows_w + (threadIdx.x >> 5) * 2 * s;
  int cell[kItems], rank[kItems];
  int32_t n_on_time = 0, n_late = 0, n_dropped = 0, n_items = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int32_t tgt = interval_of(tv[r], recip);
    const bool live = mk[r] && !(tv[r] < wmark) && !(tgt < oldest_live);
    const bool late_v = live && tgt < open_before;
    const int sr = st[r] >= 0 && st[r] < s ? st[r] : -1;
    // A live item is at most k - 1 intervals before the newest, so its
    // slot pymod(tgt, k) comes without a division.
    const int32_t back = new_open - tgt;
    const int slot = back <= open_slot ? open_slot - back : open_slot - back + k;
    cell[r] = live && sr >= 0 ? slot * s + sr : cells;
    // Ingested and late per stratum: the leader of each stratum's lanes
    // adds them to its warp's own rows (no other writer, no atomics).
    // Accepted per stratum is the rank pass's per-cell totals; dropped is
    // ingested less accepted.
    const unsigned grp = __match_any_sync(kFull, sr);
    const unsigned b_in = __ballot_sync(kFull, mk[r]);
    const unsigned b_live = __ballot_sync(kFull, live);
    const unsigned b_late = __ballot_sync(kFull, late_v);
    if (sr >= 0 && lane == __ffs(grp) - 1) {
      my_rows[sr] += __popc(b_in & grp);
      my_rows[s + sr] += __popc(b_late & grp);
    }
    __syncwarp();
    n_on_time += __popc(b_live & ~b_late);
    n_late += __popc(b_late);
    n_dropped += __popc(b_in & ~b_live);
    n_items += __popc(b_in);
  }
  if (lane == 0) {
    if (n_on_time) atomicAdd(&tot[0], n_on_time);
    if (n_late) atomicAdd(&tot[1], n_late);
    if (n_dropped) atomicAdd(&tot[2], n_dropped);
    if (n_items) atomicAdd(&tot[3], n_items);
  }

  tile_ranks(cell, rank, cells, tile, n_tiles, wrun, agg,
             status);                     // syncs: the rows are in
  for (int sr = threadIdx.x; sr < s; sr += kThreads) {
    int32_t n_in = 0, n_live = 0, n_lt = 0;
    for (int w = 0; w < kWarps; ++w) {
      n_in += rows_w[w * 2 * s + sr];
      n_lt += rows_w[w * 2 * s + s + sr];
    }
    for (int slot = 0; slot < k; ++slot) n_live += agg[slot * s + sr];
    if (n_in) atomicAdd(&rows[sr], n_in);                  // ingested
    if (n_live) atomicAdd(&rows[s + sr], n_live);          // accepted
    if (n_lt) atomicAdd(&rows[2 * s + sr], n_lt);          // late
    if (n_in - n_live) atomicAdd(&rows[3 * s + sr], n_in - n_live);
  }
  if (threadIdx.x == 0) {
    if (tot[0]) atomicAdd(on_time, tot[0]);
    if (tot[1]) atomicAdd(late, tot[1]);
    if (tot[2]) atomicAdd(dropped, tot[2]);
    if (tot[3]) atomicAdd(items, tot[3]);
  }
  tile_lookback(tile, n_tiles, cells, agg, base, status);
  claim_items(tile, m, cells, n_max, cell, rank, ua, us, base, cap, winner,
              lists, list_n);
  if (tile == n_tiles - 1) {
    // The new counts (to scratch: other tiles still read the carried
    // ones), then the replaced and occupancy rows from c0 and them.
    for (int c = threadIdx.x; c < cells; c += kThreads) {
      agg[c] += base[c];
      new_counts[c] = agg[c];
    }
    __syncthreads();
    for (int sr = threadIdx.x; sr < s; sr += kThreads) {
      int32_t repl = 0, occ = 0;
      for (int slot = 0; slot < k; ++slot) {
        const int c = slot * s + sr;
        const int32_t a = c0[c], b = agg[c], n = cap[c];
        const int32_t f0 = min(a, n), f1 = min(b, n);
        repl += (b - a) - (f1 - f0);
        occ += f1;
      }
      rows[4 * s + sr] =                    // replaced
          (sr == (int)threadIdx.x ? replaced : rows[4 * s + sr]) + repl;
      rows[5 * s + sr] = occ;               // occupancy gauge
    }
    if (threadIdx.x == 0) chunks[0] = n_chunks + 1;
  }
}

__global__ void __launch_bounds__(kThreads)
    osi_write(const int2* __restrict__ lists,
              const int32_t* __restrict__ list_n,
              const __grid_constant__ Leaves leaves,
              int32_t* __restrict__ winner,
              unsigned long long* __restrict__ status, int k, int s,
              const int32_t* __restrict__ new_counts,
              const int32_t* __restrict__ adopt, float* __restrict__ max_time,
              int32_t* __restrict__ open_interval,
              int32_t* __restrict__ slot_interval,
              int32_t* __restrict__ counts, int32_t* __restrict__ capacity,
              unsigned* __restrict__ ctrs, const Shards sd) {
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  winner += sh * sd.table;
  status += sh * sd.status;
  new_counts += sh * sd.cells;
  adopt += sh * s;
  max_time += sh;
  open_interval += sh;
  slot_interval += sh * k;
  counts += sh * sd.cells;
  capacity += sh * sd.cells;
  ctrs += sh * sd.ctrs;
  const int tile = blockIdx.x;
  const int cells = k * s;
  // Block 0 writes the carried state, now that no route tile reads it;
  // it reads what it needs before its share of the winners.
  __shared__ int32_t new_open_s;
  int32_t cnt = 0, adopted = 0, held = 0, open_before = 0;
  unsigned t_enc = 0, iv_enc = 0;
  float before = 0.0f;
  const int c_own = threadIdx.x;   // the cell this thread finalizes first
  if (tile == 0) {
    if (threadIdx.x == 0) {
      open_before = open_interval[0];
      before = max_time[0];
      t_enc = ctrs[kCtrTime];
      iv_enc = ctrs[kCtrInterval];
    }
    if (c_own < cells) {
      cnt = new_counts[c_own];
      adopted = adopt[c_own % s];
      held = slot_interval[c_own / s];
    }
  }
  write_winners(tile, lists, list_n, leaves, winner, sh * sd.items,
                sh * sd.table);
  for (int c = threadIdx.x; c < cells; c += kThreads)
    status[(size_t)c * gridDim.x + tile] = 0;
  if (tile != 0) return;
  if (threadIdx.x == 0) {
    const int32_t new_open = max(open_before, dec_interval(iv_enc));
    max_time[0] = fmaxf(before, dec_time(t_enc));
    open_interval[0] = new_open;
    new_open_s = new_open;
    ctrs[kCtrTile] = ctrs[kCtrTime] = ctrs[kCtrInterval] = 0;
  }
  __syncthreads();
  const int32_t new_open = new_open_s;
  for (int c = threadIdx.x; c < cells; c += kThreads) {
    const int slot = c / s;
    const bool own = c == c_own;
    if (desired_interval(new_open, slot, k) !=
        (own ? held : slot_interval[slot]))
      capacity[c] = own ? adopted : adopt[c - slot * s];
    counts[c] = own ? cnt : new_counts[c];
  }
  __syncthreads();                 // every read of slot_interval is done
  for (int slot = threadIdx.x; slot < k; slot += kThreads)
    slot_interval[slot] = desired_interval(new_open, slot, k);
}

// A write launch of a group of leaves that is not the payload's last:
// the winners copy their words and leave the winner table as it is, for
// the next group (one block per tile of the claim).
__global__ void __launch_bounds__(kThreads)
    osi_write_group(const int2* __restrict__ lists,
                    const int32_t* __restrict__ list_n,
                    const __grid_constant__ Leaves leaves,
                    int32_t* __restrict__ winner, const Shards sd) {
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  write_winners<false>(blockIdx.x, lists + sh * sd.lists,
                       list_n + sh * sd.list_n, leaves,
                       winner + sh * sd.table, sh * sd.items, sh * sd.table);
}

// One chunk's routing, as osi_route_claim works it out: the PRE-chunk
// watermark, the interval before the chunk and the newest after it (the
// frontier words of osi_frontier). cell() is an item's (slot, stratum)
// cell, or -1 when it is not live or its stratum is outside [0, S).
struct Route {
  const float* times;
  const int32_t* sid;
  const uint8_t* mask;
  float recip, wmark;
  int k, s;
  int32_t open_before, new_open, oldest_live, open_slot;

  __device__ __forceinline__ int cell(long long j, bool* mk, bool* live,
                                      bool* late_v, int* sr) const {
    *mk = mask[j] != 0;
    const float tv = times[j];
    const int st = sid[j];
    const int32_t tgt = interval_of(tv, recip);
    *live = *mk && !(tv < wmark) && !(tgt < oldest_live);
    *late_v = *live && tgt < open_before;
    *sr = st >= 0 && st < s ? st : -1;
    // A live item is at most k - 1 intervals before the newest, so its
    // slot pymod(tgt, k) comes without a division.
    const int32_t back = new_open - tgt;
    const int slot =
        back <= open_slot ? open_slot - back : open_slot - back + k;
    return *live && *sr >= 0 ? slot * s + *sr : -1;
  }

  __device__ __forceinline__ int cell(long long j) const {
    bool mk, live, late_v;
    int sr;
    return cell(j, &mk, &live, &late_v, &sr);
  }
};

// The parted form's cells (parted_partition's source): begin() reads the
// carried scalars once per block.
struct IngestCells {
  const float* times;
  const int32_t* sid;
  const uint8_t* mask;
  float recip, lateness;
  int k, s;
  const float* max_time;
  const int32_t* open_interval;
  const unsigned* ctrs;

  // Shard sh's items and carried scalars.
  __device__ __forceinline__ IngestCells at(long long sh,
                                            const Shards& sd) const {
    IngestCells c = *this;
    c.times += sh * sd.items;
    c.sid += sh * sd.items;
    c.mask += sh * sd.items;
    c.max_time += sh;
    c.open_interval += sh;
    c.ctrs += sh * sd.ctrs;
    return c;
  }

  __device__ Route begin() const {
    __shared__ float wmark_s;
    __shared__ int32_t open_before_s, new_open_s;
    if (threadIdx.x == 0) {
      const int32_t open_before = open_interval[0];
      wmark_s = __fsub_rn(max_time[0], lateness);    // PRE-chunk watermark
      open_before_s = open_before;
      new_open_s = max(open_before, dec_interval(ctrs[kCtrInterval]));
    }
    __syncthreads();
    Route r{times, sid, mask, recip, wmark_s, k, s, open_before_s,
            new_open_s, 0, 0};
    r.oldest_live = r.new_open - k + 1;
    r.open_slot = pymod(r.new_open, k);
    return r;
  }
};

// Strata whose ingested and late rows a block keeps in shared memory
// (past them, warp-aggregated global atomics).
constexpr int kSmemRowStrata = 4096;

// The chunk's ingested items per stratum, zeroed scratch after the parted
// form's own (osi_write_parted reads and clears it).
__host__ __device__ __forceinline__ int32_t* ingested_scratch(
    const PartedPlan& p, int32_t* zeroed) {
  return past_zeroed(p, zeroed);
}

// The parted form's counting launch: each item's verdict and cell; the
// chunk's ingested items per stratum into scratch and the late row (per
// block in shared memory, then one global add per nonzero word; past
// kSmemRowStrata by one global atomic per (warp, stratum, row)) and the
// totals, integers in any order; the live items per digit
// (parted_claim.cuh); and every cell's slot reset into scratch: base[c]
// its count before the chunk (0 if its slot resets), cap[c] its capacity
// (adopt's if its slot resets), new_counts[c] = base[c] (the claim then
// writes the cells with items). The accepted row is the cells' new counts
// less base, and dropped is ingested less accepted: osi_write_parted adds
// both from the scratch, with no atomic per item.
__global__ void __launch_bounds__(kThreads)
    osi_route_parts(const IngestCells src, int m,
                    const int32_t* __restrict__ slot_interval,
                    const int32_t* __restrict__ adopt,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ capacity,
                    int32_t* __restrict__ base, int32_t* __restrict__ cap,
                    int32_t* __restrict__ new_counts,
                    int32_t* __restrict__ rows, int32_t* __restrict__ on_time,
                    int32_t* __restrict__ late,
                    int32_t* __restrict__ dropped,
                    int32_t* __restrict__ items, const PartedPlan p,
                    int32_t* __restrict__ zeroed,
                    int32_t* __restrict__ meta, const Shards sd) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t tot[4];       // on-time, late, dropped, items
  const int k = src.k, s = src.s, cells = k * s;
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  slot_interval += sh * k;
  adopt += sh * s;
  counts += sh * sd.cells;
  capacity += sh * sd.cells;
  base += sh * sd.cells;
  cap += sh * sd.cells;
  new_counts += sh * sd.cells;
  rows += sh * 6 * s;
  on_time += sh;
  late += sh;
  dropped += sh;
  items += sh;
  zeroed += sh * sd.zeroed;
  meta += sh * sd.meta;
  const bool smem_rows = s <= kSmemRowStrata;
  int32_t* cnt = sm;
  int32_t* rows_s = cnt + sum_keys(p);       // [2, S]: ingested, late
  const int words = sum_keys(p) + (smem_rows ? 2 * s : 0);
  for (int i = threadIdx.x; i < words; i += kThreads) sm[i] = 0;
  if (threadIdx.x < 4) tot[threadIdx.x] = 0;
  const Route rt = src.at(sh, sd).begin();   // syncs: the zeroed words are in
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < cells;
       c += gridDim.x * kThreads) {
    const int slot = c / s;
    const bool reset =
        desired_interval(rt.new_open, slot, k) != slot_interval[slot];
    const int32_t c0 = reset ? 0 : counts[c];
    base[c] = c0;
    cap[c] = reset ? adopt[c - slot * s] : capacity[c];
    new_counts[c] = c0;
  }
  int32_t* ing = ingested_scratch(p, zeroed);
  int32_t* dst_in = smem_rows ? rows_s : ing;
  int32_t* dst_late = smem_rows ? rows_s + s : rows + 2 * s;
  int32_t* ptot = part_totals(p, zeroed);
  const int lane = threadIdx.x & 31;
  int32_t n_on_time = 0, n_late = 0, n_dropped = 0, n_items = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    bool mk[kItems], live[kItems], late_v[kItems];
    int sr[kItems], cell[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
      const long long j = item_index(tile, r);
      mk[r] = live[r] = late_v[r] = false;
      sr[r] = cell[r] = -1;
      if (j < m) cell[r] = rt.cell(j, &mk[r], &live[r], &late_v[r], &sr[r]);
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const unsigned grp = __match_any_sync(kFull, sr[r]);
      const unsigned b_in = __ballot_sync(kFull, mk[r]);
      const unsigned b_live = __ballot_sync(kFull, live[r]);
      const unsigned b_late = __ballot_sync(kFull, late_v[r]);
      if (sr[r] >= 0 && lane == __ffs(grp) - 1) {
        const int32_t n_in = __popc(b_in & grp);
        const int32_t n_lt = __popc(b_late & grp);
        if (n_in) atomicAdd(&dst_in[sr[r]], n_in);
        if (n_lt) atomicAdd(&dst_late[sr[r]], n_lt);
      }
      n_on_time += __popc(b_live & ~b_late);
      n_late += __popc(b_late);
      n_dropped += __popc(b_in & ~b_live);
      n_items += __popc(b_in);
      count_part(cell[r], p, cnt, ptot);
    }
  }
  if (lane == 0) {
    if (n_on_time) atomicAdd(&tot[0], n_on_time);
    if (n_late) atomicAdd(&tot[1], n_late);
    if (n_dropped) atomicAdd(&tot[2], n_dropped);
    if (n_items) atomicAdd(&tot[3], n_items);
  }
  __syncthreads();
  if (smem_rows)
    for (int i = threadIdx.x; i < s; i += kThreads) {
      if (rows_s[i]) atomicAdd(&ing[i], rows_s[i]);
      if (rows_s[s + i]) atomicAdd(&rows[2 * s + i], rows_s[s + i]);
    }
  if (threadIdx.x == 0) {
    if (tot[0]) atomicAdd(on_time, tot[0]);
    if (tot[1]) atomicAdd(late, tot[1]);
    if (tot[2]) atomicAdd(dropped, tot[2]);
    if (tot[3]) atomicAdd(items, tot[3]);
  }
  count_finish(cnt, p, zeroed, meta);
}

// The parted form's last launch: the winners' payloads (winner words
// reset), then, from the scratch of osi_route_parts
// and the claim, the carried counts and capacities and grid-wide per
// stratum the ingested, accepted (the new counts less base over its
// slots), dropped, replaced and occupancy rows, the ingested scratch
// cleared (no block of this launch reads the carried state), and in block
// 0 the frontier, newest interval, slot table and chunks; the frontier
// words and the tile counter are left 0.
__global__ void __launch_bounds__(kThreads)
    osi_write_parted(const int2* __restrict__ lists,
                    const int32_t* __restrict__ list_n,
                    const __grid_constant__ Leaves leaves,
                    int32_t* __restrict__ winner, int k, int s,
                    const int32_t* __restrict__ base,
                    const int32_t* __restrict__ cap,
                    const int32_t* __restrict__ new_counts,
                    float* __restrict__ max_time,
                    int32_t* __restrict__ open_interval,
                    int32_t* __restrict__ slot_interval,
                    int32_t* __restrict__ counts,
                    int32_t* __restrict__ capacity,
                    int32_t* __restrict__ rows, int32_t* __restrict__ chunks,
                    unsigned* __restrict__ ctrs,
                    int32_t* __restrict__ ing, const Shards sd) {
  __shared__ int32_t new_open_s;
  const int cells = k * s;
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  winner += sh * sd.table;
  base += sh * sd.cells;
  cap += sh * sd.cells;
  new_counts += sh * sd.cells;
  max_time += sh;
  open_interval += sh;
  slot_interval += sh * k;
  counts += sh * sd.cells;
  capacity += sh * sd.cells;
  rows += sh * 6 * s;
  chunks += sh;
  ctrs += sh * sd.ctrs;
  ing += sh * sd.zeroed;
  write_winners(blockIdx.x, lists, list_n, leaves, winner, sh * sd.items,
                sh * sd.table);
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  for (int c = first; c < cells; c += stride) {
    counts[c] = new_counts[c];
    capacity[c] = cap[c];
  }
  for (int sr = first; sr < s; sr += stride) {
    int32_t live = 0, repl = 0, occ = 0;
    for (int slot = 0; slot < k; ++slot) {
      const int c = slot * s + sr;
      const int32_t a = base[c], b = new_counts[c], n = cap[c];
      const int32_t f0 = min(a, n), f1 = min(b, n);
      live += b - a;
      repl += (b - a) - (f1 - f0);
      occ += f1;
    }
    const int32_t n_in = ing[sr];
    ing[sr] = 0;
    rows[sr] += n_in;                       // ingested
    rows[s + sr] += live;                   // accepted
    rows[3 * s + sr] += n_in - live;        // dropped
    rows[4 * s + sr] += repl;               // replaced
    rows[5 * s + sr] = occ;                 // occupancy gauge
  }
  if (blockIdx.x != 0) return;
  if (threadIdx.x == 0) {
    const int32_t new_open =
        max(open_interval[0], dec_interval(ctrs[kCtrInterval]));
    max_time[0] = fmaxf(max_time[0], dec_time(ctrs[kCtrTime]));
    open_interval[0] = new_open;
    new_open_s = new_open;
    chunks[0] += 1;
    ctrs[kCtrTile] = ctrs[kCtrTime] = ctrs[kCtrInterval] = 0;
  }
  __syncthreads();
  for (int slot = threadIdx.x; slot < k; slot += kThreads)
    slot_interval[slot] = desired_interval(new_open_s, slot, k);
}

int tiles_of(int m) { return m > 0 ? (m + kTile - 1) / kTile : 1; }

}  // namespace

// Pointers: times f32[M], sid i32[M], payloads a host array of n_leaves
// pointers to 4-byte words [M], mask u8[M], u_accept/u_slot f32[M]; the
// state, updated in place: max_time f32[], open_interval/on_time/late/
// dropped/chunks/items i32[], slot_interval i32[K], counts/capacity
// i32[K, S], values a host array of n_leaves pointers to [K, S, N_max]
// 4-byte words (leaf i takes payload i), counters i32[6, S]; adopt i32[S]
// (read only, <= N_max). n_leaves >= 1, written kMaxLeaves a launch.
// Scratch kept by the caller between calls, as for sa_reservoir_fold
// (winner i32[K*S*N_max] all -1, status u64 all 0: the small form's
// K*S*n_tiles words or the parted form's plan's, ctrs i32[3] all 0,
// lists, list_n over the claim's tiles), and aux i32[K*S] (the new
// counts). plan: null for the small form, else the parted form's
// kPlanInts ints (kernels/_workspace.py::parted_plan), and pt its scratch
// (parted_claim.cuh's slots, kPtBase and kPtCap included).
//
// Batched over w >= 1 shards (the reference's vmap of its kernel): every
// array above has a leading [w] axis, shard after shard, and so has the
// scratch, each shard's the size given (the parted form's zeroed words
// its plan's and S, its meta words its plan's rounded up to a multiple of
// 4, pt shard 0's). Every launch takes the shard as a grid
// axis, so a call is the same 3 (small) or 5 (parted) launches at any w;
// the form and the plan are the per-shard K*S's.
extern "C" int sa_one_shot_ingest(
    const void* times, const void* sid, const void* const* payloads,
    const void* mask, const void* u_accept, const void* u_slot,
    void* max_time, void* open_interval, void* on_time, void* late,
    void* dropped, void* chunks, void* items, void* slot_interval,
    const void* adopt, void* counts, void* capacity, void* const* values,
    void* counters, void* winner, void* status, void* lists, void* list_n,
    void* ctrs, void* aux, const int* plan, void* const* pt, int m, int k,
    int s, int n_max, int n_leaves, int w, float recip, float lateness,
    void* stream_ptr) {
  if (n_leaves < 1 || w < 1) return (int)cudaErrorInvalidValue;
  // The leaves of the group that starts at leaf g.
  auto group = [&](int g) {
    Leaves lv;
    lv.n = n_leaves - g < kMaxLeaves ? n_leaves - g : kMaxLeaves;
    for (int l = 0; l < kMaxLeaves; ++l) {
      lv.payload[l] = l < lv.n ? static_cast<const uint32_t*>(payloads[g + l])
                               : nullptr;
      lv.values[l] = l < lv.n ? static_cast<uint32_t*>(values[g + l])
                              : nullptr;
    }
    return lv;
  };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int cells = k * s;
  const int n_tiles = tiles_of(m);
  PartedPlan p;
  if (plan != nullptr && (!read_plan(plan, cells, m, &p) || pt == nullptr))
    return (int)cudaErrorInvalidValue;
  Shards sd = one_shard();
  sd.n = w;
  sd.items = m;
  sd.cells = cells;
  sd.table = (long long)cells * n_max;
  sd.ctrs = kCtrWords;
  const int grid = plan != nullptr ? p.claim_grid : n_tiles;
  sd.status = plan != nullptr ? (long long)pass_words(p, p.passes)
                              : (long long)cells * n_tiles;
  sd.lists = (long long)grid * kTile;
  sd.list_n = (long long)grid * kWarps;
  if (plan != nullptr) {
    sd.zeroed = zeroed_words(p) + s;
    sd.meta = (meta_words(p) + 3) & ~3;   // the claim's map is read as int4
    sd.part = (long long)m * (p.passes > 1 ? 2 : 1);
  }
  auto* mask_p = static_cast<const uint8_t*>(mask);
  auto* times_p = static_cast<const float*>(times);
  auto* sid_p = static_cast<const int32_t*>(sid);
  auto* ua_p = static_cast<const float*>(u_accept);
  auto* us_p = static_cast<const float*>(u_slot);
  auto* adopt_p = static_cast<const int32_t*>(adopt);
  auto* counts_p = static_cast<int32_t*>(counts);
  auto* cap_p = static_cast<int32_t*>(capacity);
  auto* win_p = static_cast<int32_t*>(winner);
  auto* status_p = static_cast<unsigned long long*>(status);
  auto* lists_p = static_cast<int2*>(lists);
  auto* list_n_p = static_cast<int32_t*>(list_n);
  auto* ctrs_p = static_cast<unsigned*>(ctrs);
  auto* new_counts = static_cast<int32_t*>(aux);
  auto* max_time_p = static_cast<float*>(max_time);
  auto* open_p = static_cast<int32_t*>(open_interval);
  auto* slot_iv = static_cast<int32_t*>(slot_interval);
  auto* rows_p = static_cast<int32_t*>(counters);
  auto* on_time_p = static_cast<int32_t*>(on_time);
  auto* late_p = static_cast<int32_t*>(late);
  auto* dropped_p = static_cast<int32_t*>(dropped);
  auto* items_p = static_cast<int32_t*>(items);
  auto* chunks_p = static_cast<int32_t*>(chunks);
  osi_frontier<<<shard_grid(n_tiles, w), kThreads, 0, stream>>>(
      times_p, mask_p, m, recip, ctrs_p, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (plan != nullptr) {
    auto* base_p = static_cast<int32_t*>(pt[kPtBase]);
    auto* caps_p = static_cast<int32_t*>(pt[kPtCap]);
    auto* tile_ctr = reinterpret_cast<int32_t*>(ctrs_p + kCtrTile);
    const IngestCells src{times_p, sid_p, mask_p, recip, lateness, k, s,
                          max_time_p, open_p, ctrs_p};
    const int smem = (int)sizeof(int32_t) *
                     count_smem_words(p, s <= kSmemRowStrata ? 2 * s : 0);
    err = allow_smem(osi_route_parts, smem);
    if (err != cudaSuccess) return (int)err;
    osi_route_parts<<<shard_grid(count_grid(p), w), kThreads, smem,
                      stream>>>(
        src, m, slot_iv, adopt_p, counts_p, cap_p, base_p, caps_p,
        new_counts, rows_p, on_time_p, late_p, dropped_p, items_p, p,
        static_cast<int32_t*>(pt[kPtZeroed]),
        static_cast<int32_t*>(pt[kPtMeta]), sd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int e = launch_partition(ClaimItems<IngestCells>{src, ua_p, us_p}, p, m,
                             pt, status_p + claim_words(p), tile_ctr, sd,
                             stream);
    if (e != 0) return e;
    e = launch_parted_claim(p, pt, cells, n_max, base_p, caps_p, new_counts,
                            win_p, lists_p, list_n_p, status_p, tile_ctr, sd,
                            stream);
    if (e != 0) return e;
  } else {
    const int smem = (int)sizeof(int32_t) *
                     (claim_smem_words(cells) + cells + 4 + 2 * kWarps * s);
    err = allow_smem(osi_route_claim, smem);
    if (err != cudaSuccess) return (int)err;
    osi_route_claim<<<shard_grid(n_tiles, w), kThreads, smem, stream>>>(
        times_p, sid_p, mask_p, ua_p, us_p, m, recip, lateness, k, s, n_max,
        n_tiles, max_time_p, open_p, slot_iv, adopt_p, counts_p, cap_p,
        new_counts, win_p, status_p, lists_p, list_n_p, ctrs_p, rows_p,
        on_time_p, late_p, dropped_p, items_p, chunks_p, sd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int g = 0;
  for (; g + kMaxLeaves < n_leaves; g += kMaxLeaves) {
    osi_write_group<<<shard_grid(grid, w), kThreads, 0, stream>>>(
        lists_p, list_n_p, group(g), win_p, sd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (plan != nullptr) {
    osi_write_parted<<<shard_grid(grid, w), kThreads, 0, stream>>>(
        lists_p, list_n_p, group(g), win_p, k, s,
        static_cast<int32_t*>(pt[kPtBase]), static_cast<int32_t*>(pt[kPtCap]),
        new_counts, max_time_p, open_p, slot_iv, counts_p, cap_p, rows_p,
        chunks_p, ctrs_p,
        ingested_scratch(p, static_cast<int32_t*>(pt[kPtZeroed])), sd);
  } else {
    osi_write<<<shard_grid(grid, w), kThreads, 0, stream>>>(
        lists_p, list_n_p, group(g), win_p, status_p, k, s, new_counts,
        adopt_p, max_time_p, open_p, slot_iv, counts_p, cap_p, ctrs_p, sd);
  }
  return (int)cudaGetLastError();
}
