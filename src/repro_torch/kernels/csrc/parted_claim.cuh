// The parted form of the fold's claim, shared by reservoir_fold.cu and
// one_shot_ingest.cu past the cells a block's shared memory holds (each
// includes it, after fold_device.cuh, into its own anonymous namespace).
// Its counting and partition launches also serve the parted form of the
// stats and the histogram (parted_reduce.cuh): the partition is generic
// over what an entry carries (the fold's int4 (item, cell, uniforms), the
// reductions' int2 (key, value)), read from an item source (Items below).
//
// The small form ranks a tile's items by cell and looks back over every
// cell of every earlier tile, so its shared tables and look-back words
// grow with the cells. Here a cell c is written as (part, lo) = (c >>
// lo_bits, c & (2^lo_bits - 1)), and the live items are partitioned
// stably by part, in item order within each part. A tile of the claim
// then holds the items of one part only, so an item's rank among its
// part's items with its lo, in item order, is its rank in its cell: the
// small form's rank and look-back run over 2^lo_bits keys, not the cells.
// The plan (kernels/_workspace.py::parted_plan) keeps every look-back at
// 1,024 keys or fewer: one partition pass up to 2^20 cells, and one more
// LSD pass over the part id for each further 10 bits or fewer.
//
// Launches (the caller's first launch counts, the last ones write):
//   counts   each block counts its live items per digit of each pass (in
//            shared memory, then one global add per nonzero digit), and
//            past one pass per part (global atomics), over every
//            gridDim.x-th tile (at most kCountBlocks blocks); the block
//            that takes the last ticket scans the totals into the digit
//            offsets, each part's first item, and the claim's map (part,
//            first position, items, index in the part of each claim
//            tile), and clears the totals and the ticket;
//   parted_partition, once a pass: a tile ranks its items by digit in
//            item order, finds the earlier tiles' items of each digit by a
//            decoupled look-back, and scatters (item index, cell, both
//            uniforms) to the digit's offset + that + its rank: a stable
//            partition, which carries the uniforms so that the claim
//            reads them in order instead of gathering a sector for each;
//   parted_claim: a tile of one part (tiles + parts blocks are launched,
//            each takes its tile from the map; blocks past the last tile
//            only clear their list counts); ranks by lo, looks back over
//            its part's earlier tiles, then the verdict, the atomicMax on
//            the winner table and the per-warp list entries of the small
//            form, so the write launches are the small form's. The last
//            tile of each part writes the new counts of its cells.
//
// The look-back of the new passes gives each key its own group of lanes
// (as many as kThreads / keys allows, up to a warp), each lane reading
// several earlier tiles a step with every load issued at once, so a tile
// walks all its keys' chains at once, 32 tiles a step up to 128 keys.
// Scratch grows with the items and the cells, never with tiles x cells:
// the partition's look-back words are tiles x keys (keys <= 1,024), the
// claim's (tiles + parts) x 2^lo_bits. Every look-back word, total and
// ticket is 0 between calls: the claim clears the partition's words, and
// of each part the claim tile that finishes its look-back last (by a
// ticket a part) the part's own; the scan clears the totals.
//
// A call batched over shards (fold_device.cuh's Shards: the one-shot's
// shards, the fold's W x K folds) runs each launch over a grid of shards:
// every shard with its own cells, ring and scratch, its items its item
// row's, under one plan (the same cells and M).

#pragma once

#include "fold_device.cuh"

namespace {
namespace fold {

constexpr int kPartMaxPasses = 3;
constexpr int kPartMaxKeys = 1024;            // keys of one look-back

// The plan as the wrapper passes it (kPlanInts ints, in this order).
struct PartedPlan {
  int lo_bits;                 // a cell is (part, lo), lo the low bits
  int parts;                   // ceil(cells / 2^lo_bits)
  int passes;                  // partition passes, LSD over the part id
  int tiles;                   // item tiles: ceil(M / kTile), at least 1
  int claim_grid;              // claim blocks: tiles + min(parts, M)
  int bits[kPartMaxPasses];    // digit d = (part >> shift[d]) % 2^bits[d]
  int shift[kPartMaxPasses];
  int keys[kPartMaxPasses];    // digit values of pass d
};
constexpr int kPlanInts = 5 + 3 * kPartMaxPasses;

__host__ __device__ __forceinline__ int sum_keys(const PartedPlan& p) {
  int n = 0;
  for (int d = 0; d < p.passes; ++d) n += p.keys[d];
  return n;
}

__host__ __device__ __forceinline__ int keys_before(const PartedPlan& p,
                                                    int pass) {
  int n = 0;
  for (int d = 0; d < pass; ++d) n += p.keys[d];
  return n;
}

// Zeroed scratch: digit totals of every pass, then (past one pass) the
// part totals, then the counting launch's ticket, then one claim ticket a
// part. One pass: the part totals are the digit totals.
__host__ __device__ __forceinline__ int32_t* part_totals(
    const PartedPlan& p, int32_t* zeroed) {
  return p.passes > 1 ? zeroed + sum_keys(p) : zeroed;
}

__host__ __device__ __forceinline__ int32_t* count_ticket(
    const PartedPlan& p, int32_t* zeroed) {
  return zeroed + sum_keys(p) + (p.passes > 1 ? p.parts : 0);
}

__host__ __device__ __forceinline__ int32_t* claim_tickets(
    const PartedPlan& p, int32_t* zeroed) {
  return count_ticket(p, zeroed) + 1;
}

// Zeroed words of the plan (the caller's scratch may follow them).
__host__ __device__ __forceinline__ int zeroed_words(const PartedPlan& p) {
  return sum_keys(p) + (p.passes > 1 ? p.parts : 0) + 1 + p.parts;
}

__host__ __device__ __forceinline__ int32_t* past_zeroed(
    const PartedPlan& p, int32_t* zeroed) {
  return zeroed + zeroed_words(p);
}

// Meta scratch, written before it is read in every call: the claim's map
// (one int4 a claim tile: its part, its first position, its items - 1 |
// the part's tiles - 1 << kTileBits, its index in the part; part -1 past
// the last tile), the digit offsets of every pass, each part's first item
// (parts + 1: the last is the live items).
constexpr int kTileBits = 11;                 // kTile == 2^kTileBits
static_assert(kTile == 1 << kTileBits, "the claim map packs kTile items");

__host__ __device__ __forceinline__ int meta_map_words(const PartedPlan& p) {
  return 4 * p.claim_grid;
}

__host__ __device__ __forceinline__ const int32_t* part_first(
    const PartedPlan& p, const int32_t* meta) {
  return meta + meta_map_words(p) + sum_keys(p);
}

__host__ __device__ __forceinline__ int meta_words(const PartedPlan& p) {
  return meta_map_words(p) + sum_keys(p) + p.parts + 1;
}

// A partitioned item: its index, its cell and its two uniforms' bits.
__device__ __forceinline__ int4 part_item(int j, int cell, float ua,
                                          float us) {
  return make_int4(j, cell, __float_as_int(ua), __float_as_int(us));
}

// Look-back words, tile-major: the claim's over its grid, then each
// pass's.
__host__ __device__ __forceinline__ size_t claim_words(const PartedPlan& p) {
  return ((size_t)1 << p.lo_bits) * p.claim_grid;
}

// The partition's look-back words before pass `pass` (a tile's words,
// its keys', tile-major).
__host__ __device__ __forceinline__ size_t partition_words(
    const PartedPlan& p, int pass) {
  return (size_t)p.tiles * keys_before(p, pass);
}

__host__ __device__ __forceinline__ size_t pass_words(const PartedPlan& p,
                                                      int pass) {
  return claim_words(p) + partition_words(p, pass);
}

// The plan from the wrapper's ints, or false if it is not one this code
// can run for `cells` cells and m items.
inline bool read_plan(const int* a, long long cells, int m, PartedPlan* p) {
  if (a == nullptr) return false;
  p->lo_bits = a[0];
  p->parts = a[1];
  p->passes = a[2];
  p->tiles = a[3];
  p->claim_grid = a[4];
  for (int d = 0; d < kPartMaxPasses; ++d) {
    p->bits[d] = a[5 + d];
    p->shift[d] = a[5 + kPartMaxPasses + d];
    p->keys[d] = a[5 + 2 * kPartMaxPasses + d];
  }
  const long long lo_keys = 1ll << (p->lo_bits & 31);
  const int tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  bool ok = p->lo_bits >= 1 && lo_keys <= kPartMaxKeys &&
            p->passes >= 1 && p->passes <= kPartMaxPasses &&
            p->parts == (cells + lo_keys - 1) / lo_keys &&
            p->tiles == tiles &&
            p->claim_grid == tiles + (p->parts < m ? p->parts : m);
  int shift = 0;
  for (int d = 0; ok && d < p->passes; ++d) {
    const long long top = ((long long)p->parts - 1) >> shift;
    ok = p->bits[d] >= 1 && p->bits[d] <= 10 && p->shift[d] == shift &&
         p->keys[d] >= 1 && p->keys[d] <= kPartMaxKeys &&
         p->keys[d] <= (1 << p->bits[d]) &&
         (d + 1 < p->passes ? p->keys[d] == (1 << p->bits[d])
                            : top < p->keys[d]);
    shift += p->bits[d];
  }
  return ok;
}

__device__ __forceinline__ int part_ticket(int32_t* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ int digit_of(const PartedPlan& p, int part,
                                        int pass) {
  return (part >> p.shift[pass]) & ((1 << p.bits[pass]) - 1);
}

// Counts the live item of `cell` (-1: none) into the block's digit counts
// cnt (shared, sum_keys words) and, past one pass, into the part totals
// (global). Every lane of the warp calls it.
__device__ __forceinline__ void count_part(int cell, const PartedPlan& p,
                                           int32_t* cnt, int32_t* ptot) {
  const int lane = threadIdx.x & 31;
  const int part = cell >= 0 ? cell >> p.lo_bits : -1;
  int off = 0;
  for (int d = 0; d < p.passes; ++d) {
    const int dig = part >= 0 ? digit_of(p, part, d) : -1;
    const unsigned peers = __match_any_sync(kFull, dig);
    if (dig >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[off + dig], __popc(peers));
    off += p.keys[d];
  }
  if (p.passes > 1) {
    const unsigned peers = __match_any_sync(kFull, part);
    if (part >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&ptot[part], __popc(peers));
  }
}

// Exclusive scan of one value a thread over the block; *total gets the
// sum. Every thread calls it; it synchronises.
__device__ __forceinline__ int32_t block_scan(int32_t x, int32_t* total) {
  __shared__ int32_t wsum[kWarps];
  __shared__ int32_t all;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t v = lane < kWarps ? wsum[lane] : 0;
    int32_t w = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += t;
    }
    if (lane < kWarps) wsum[lane] = w - v;
    if (lane == kWarps - 1) all = w;
  }
  __syncthreads();
  const int32_t out = wsum[warp] + incl - x;
  *total = all;
  __syncthreads();                           // wsum and all are reused
  return out;
}

// The scan of the totals, by the one block that took the last ticket:
// every total is read and cleared by one atomicExch (the other blocks'
// adds are in L2, and the ticket's acquire orders them before).
__device__ void plan_parts(const PartedPlan& p, int32_t* zeroed,
                           int32_t* meta) {
  int4* map = reinterpret_cast<int4*>(meta);
  int32_t* dig_off = meta + meta_map_words(p);
  // Digit offsets of every pass but the only one (one pass: the parts').
  if (p.passes > 1) {
    int off = 0;
    for (int d = 0; d < p.passes; ++d) {
      int32_t carry = 0;
      for (int i0 = 0; i0 < p.keys[d]; i0 += kThreads) {
        const int i = i0 + threadIdx.x;
        const int32_t n = i < p.keys[d] ? atomicExch(zeroed + off + i, 0) : 0;
        int32_t sum;
        const int32_t e = block_scan(n, &sum);
        if (i < p.keys[d]) dig_off[off + i] = carry + e;
        carry += sum;
      }
      off += p.keys[d];
    }
  }
  // Each part's first item, and the map of its claim tiles.
  int32_t* ptot = part_totals(p, zeroed);
  int32_t* first = dig_off + sum_keys(p);
  int32_t items = 0, tiles = 0;
  for (int i0 = 0; i0 < p.parts; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int32_t n = i < p.parts ? atomicExch(ptot + i, 0) : 0;
    const int32_t nt = (n + kTile - 1) / kTile;
    int32_t n_sum, t_sum;
    const int32_t e = block_scan(n, &n_sum);
    const int32_t et = block_scan(nt, &t_sum);
    if (i < p.parts) {
      first[i] = items + e;
      if (p.passes == 1) dig_off[i] = items + e;  // the only pass's offsets
      for (int t = 0; t < nt; ++t)
        map[tiles + et + t] =
            make_int4(i, items + e + t * kTile,
                      (min(kTile, n - t * kTile) - 1) | (nt - 1) << kTileBits,
                      t);
    }
    items += n_sum;
    tiles += t_sum;
  }
  if (threadIdx.x == 0) {
    first[p.parts] = items;
    *count_ticket(p, zeroed) = 0;
  }
  for (int g = tiles + threadIdx.x; g < p.claim_grid; g += kThreads)
    map[g] = make_int4(-1, 0, 0, 0);
}

// After the block's digit counts are complete (the caller synchronised):
// one global add per nonzero count, then the last block's scan.
__device__ void count_finish(const int32_t* cnt, const PartedPlan& p,
                             int32_t* zeroed, int32_t* meta) {
  __shared__ int s_last;
  const int nk = sum_keys(p);
  for (int i = threadIdx.x; i < nk; i += kThreads)
    if (cnt[i]) atomicAdd(zeroed + i, cnt[i]);
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = part_ticket(count_ticket(p, zeroed)) == (int)gridDim.x - 1;
  __syncthreads();
  if (s_last) plan_parts(p, zeroed, meta);
}

// Ranks of this thread's items among the tile's items of the same key,
// in item order (key == keys is the sentinel "none"), and the tile's
// per-key totals in agg[keys], each published at once: the word of key c
// is st[c * key_stride], flagged a prefix if `first` (the first tile of
// its run of tiles), else an aggregate. wrun is [kWarps][keys + 1]. As
// tile_ranks, with the layout and the flag the caller's.
__device__ __forceinline__ void part_ranks(const int (&key)[kItems],
                                           int (&rank)[kItems], int keys,
                                           int32_t* wrun, int32_t* agg,
                                           unsigned long long* st,
                                           size_t key_stride, bool first) {
  const int stride = keys + 1;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * stride; i += kThreads) wrun[i] = 0;
  __syncthreads();
  int32_t* run = wrun + (threadIdx.x >> 5) * stride;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned peers = __match_any_sync(kFull, key[r]);
    const int before = run[key[r]];
    rank[r] = before + __popc(peers & below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) run[key[r]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  constexpr int kKeysPerWarp = 32 / kWarps;
  const int sub = lane / kWarps, w = lane % kWarps;
  const unsigned long long flag = first ? kPrefix : kAggregate;
  for (int c0 = (threadIdx.x >> 5) * kKeysPerWarp; c0 < keys;
       c0 += kWarps * kKeysPerWarp) {
    const int c = c0 + sub;
    const int32_t v = c < keys ? wrun[w * stride + c] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, d, kWarps);
      if (w >= d) incl += t;
    }
    if (c < keys) {
      wrun[w * stride + c] = incl - v;
      if (w == kWarps - 1) {
        agg[c] = incl;
        status_store(st + (size_t)c * key_stride, flag | (uint32_t)incl);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (key[r] < keys) rank[r] += run[key[r]];
}

// Adds to base[keys] the items of each key in the tiles (first, tile) and
// publishes this tile's inclusive prefixes (the first tile published its
// own). The word of (key, t) is status[key * ks + t * ts]. Each key has a
// group of L lanes (L a power of two, L * keys <= kThreads where it can
// be), and each lane reads R earlier tiles a step, all R loads issued
// before any is waited on: a group covers L * R tiles a step (32 up to
// 128 keys, fewer past that, so that a tile reads at most kLookWords
// words a step). A step sums the group's words up to the nearest prefix:
// each lane its own R up to its first prefix, then a shuffle within the
// group over the lanes up to the first lane that holds one. Every group
// of a warp steps together until all have found a prefix.
constexpr int kLookReads = 8;                 // R at most
constexpr int kLookWords = 4096;              // words a tile reads a step

__device__ void part_lookback(int tile, int first, int keys,
                              const int32_t* agg, int32_t* base,
                              unsigned long long* status, size_t ks,
                              size_t ts) {
  int lanes = 32;
  while (lanes > 1 && lanes * keys > kThreads) lanes >>= 1;
  int cover = 32;                               // tiles a group covers
  while (cover > lanes && cover * keys > kLookWords) cover >>= 1;
  const int reads = min(cover / lanes, kLookReads);   // R: 8 at most here
  cover = reads * lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1), lead = lane - sub;
  const unsigned group =
      lanes == 32 ? kFull : ((1u << lanes) - 1u) << lead;
  const int per_round = kThreads / lanes;
  for (int k0 = 0; k0 < keys; k0 += per_round) {   // the same in every thread
    const int key = k0 + (int)threadIdx.x / lanes;
    bool done = key >= keys || tile == first;       // the same in a group
    int32_t sum = 0;
    int t = tile - 1 - sub * reads;                 // this lane's nearest
    unsigned long long* col = status + (size_t)key * ks;
    while (__any_sync(kFull, !done)) {
      unsigned long long w[kLookReads];
#pragma unroll
      for (int r = 0; r < kLookReads; ++r) {
        w[r] = kPrefix;                             // before `first`: 0
        if (r < reads && !done && t - r >= first)
          w[r] = status_load(col + (size_t)(t - r) * ts);
      }
      int32_t v = 0;
      bool pre = false;
#pragma unroll
      for (int r = 0; r < kLookReads; ++r) {
        if (r < reads && !done && t - r >= first)
          while ((w[r] & kFlagMask) == 0)
            w[r] = status_load(col + (size_t)(t - r) * ts);
        if (r < reads && !pre) {
          v += (int32_t)(uint32_t)w[r];
          pre = (w[r] & kFlagMask) == kPrefix;
        }
      }
      const unsigned pres = __ballot_sync(kFull, !done && pre) & group;
      const int stop = pres ? __ffs(pres) - 1 - lead : lanes - 1;
      v = !done && sub <= stop ? v : 0;
      for (int d = 1; d < lanes; d <<= 1) v += __shfl_xor_sync(kFull, v, d);
      if (!done) {
        sum += v;
        if (pres) done = true;
        t -= cover;
      }
    }
    if (key < keys && sub == 0) {
      base[key] += sum;
      if (tile != first)
        status_store(col + (size_t)tile * ts,
                     kPrefix | (uint32_t)(sum + agg[key]));
    }
  }
  __syncthreads();
}

// An item source of the partition (and of parted_count): what an entry
// carries and how pass 0 reads it.
//   Items::Entry        the entry type;
//   Items::key_of(e)    an entry's cell (-1: none), Items::none() one with
//                       none;
//   src.smem_words()    int32 shared words its reader takes (host too);
//   src.at(sh, sd)      shard sh's source;
//   .begin(extra)       the block's reader, given its shared words (every
//                       thread calls it; it may synchronise);
//   reader.cell(q)      item q's cell, -1 for none (parted_count);
//   reader.entry(q)     item q's entry (the first pass).
// The fold's source: its cells (src.at(shard, sd).begin(), then .cell(j))
// and both uniforms, each carried in the entry so that the claim reads
// them in order rather than gather a sector for each.
template <class R>
struct ClaimReader {
  R cells;
  const float* u_accept;
  const float* u_slot;
  __device__ __forceinline__ int cell(long long q) const {
    return cells.cell(q);
  }
  __device__ __forceinline__ int4 entry(long long q) const {
    return part_item((int)q, cells.cell(q), u_accept[q], u_slot[q]);
  }
};

template <class R>
__device__ __forceinline__ ClaimReader<R> claim_reader(const R& cells,
                                                       const float* ua,
                                                       const float* us) {
  return ClaimReader<R>{cells, ua, us};
}

template <class Cells>
struct ClaimItems {
  using Entry = int4;
  Cells cells;
  const float* u_accept;
  const float* u_slot;
  __host__ __device__ int smem_words() const { return 0; }
  __device__ __forceinline__ ClaimItems at(long long sh,
                                           const Shards& sd) const {
    const long long off = item_row(sh, sd) * sd.items;
    return ClaimItems{cells.at(sh, sd), u_accept + off, u_slot + off};
  }
  __device__ __forceinline__ auto begin(int32_t*) const {
    return claim_reader(cells.begin(), u_accept, u_slot);
  }
  __device__ static __forceinline__ int key_of(const int4& e) { return e.y; }
  __device__ static __forceinline__ int4 none() {
    return make_int4(0, -1, 0, 0);
  }
};

// One partition pass, the stable scatter of the live items by the digit
// of `pass` of their part: pass 0 reads each item's entry from src, a
// later pass the entries the pass before wrote to `in`. A tile's place
// for digit d is d's offset + the earlier tiles' items of d (look-back)
// + its rank. Tiles are taken in launch order; the block that takes the
// last ticket puts the counter back. status: the partition's look-back
// words (partition_words past it for each pass). Each shard of sd
// partitions its own items into its own scratch.
template <class Items>
__global__ void __launch_bounds__(kThreads)
    parted_partition(const Items src, const PartedPlan p, int pass, int m,
                     const typename Items::Entry* __restrict__ in,
                     typename Items::Entry* __restrict__ out,
                     const int32_t* __restrict__ meta,
                     unsigned long long* __restrict__ status,
                     int32_t* __restrict__ tile_ctr, const Shards sd) {
  using Entry = typename Items::Entry;
  extern __shared__ int32_t sm[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  if (in) in += sh * sd.part;
  out += sh * sd.part;
  meta += sh * sd.meta;
  status += sh * sd.status;
  tile_ctr += sh * sd.ctrs;
  const int keys = p.keys[pass];
  int32_t* wrun = sm;
  int32_t* agg = wrun + kWarps * (keys + 1);
  int32_t* base = agg + keys;
  const int tile = take_tile(tile_ctr);
  if (tile == (int)gridDim.x - 1 && threadIdx.x == 0) *tile_ctr = 0;
  const int n = in ? part_first(p, meta)[p.parts] : m;
  if ((long long)tile * kTile >= n) return;
  int key[kItems], rank[kItems];
  Entry e[kItems];
  if (in) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {  // all loads independent: one trip
      const long long q = item_index(tile, r);
      e[r] = q < n ? in[q] : Items::none();
    }
  } else {
    const auto rd = src.at(sh, sd).begin(base + keys);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long q = item_index(tile, r);
      e[r] = q < n ? rd.entry(q) : Items::none();
    }
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int c = Items::key_of(e[r]);
    key[r] = c >= 0 ? digit_of(p, c >> p.lo_bits, pass) : keys;
  }
  const int32_t* off = meta + meta_map_words(p) + keys_before(p, pass);
  for (int k = threadIdx.x; k < keys; k += kThreads) base[k] = off[k];
  unsigned long long* st = status + partition_words(p, pass);
  part_ranks(key, rank, keys, wrun, agg, st + (size_t)tile * keys, 1,
             tile == 0);
  part_lookback(tile, 0, keys, agg, base, st, 1, keys);
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (key[r] < keys) out[base[key[r]] + rank[r]] = e[r];
}

// Shared memory of the launches, in int32 words.
__host__ __device__ __forceinline__ int partition_smem_words(
    const PartedPlan& p, int pass) {
  return kWarps * (p.keys[pass] + 1) + 2 * p.keys[pass];
}

// The counting launch of a source's items: each block's live items per
// digit of each pass (count_part), over every gridDim.x-th tile, then the
// last block's scan (count_finish). Shared memory: count_smem_words(p,
// src.smem_words()). (The fold and the one-shot count in launches of
// their own, which do more.)
template <class Items>
__global__ void __launch_bounds__(kThreads)
    parted_count(const Items src, int m, const PartedPlan p,
                 int32_t* __restrict__ zeroed, int32_t* __restrict__ meta,
                 const Shards sd) {
  extern __shared__ int32_t cnt[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  zeroed += sh * sd.zeroed;
  meta += sh * sd.meta;
  for (int i = threadIdx.x; i < sum_keys(p); i += kThreads) cnt[i] = 0;
  __syncthreads();
  const auto rd = src.at(sh, sd).begin(cnt + sum_keys(p));
  int32_t* ptot = part_totals(p, zeroed);
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int cell[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {  // all loads independent: one trip
      const long long j = item_index(tile, r);
      cell[r] = j < m ? rd.cell(j) : -1;
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) count_part(cell[r], p, cnt, ptot);
  }
  __syncthreads();
  count_finish(cnt, p, zeroed, meta);
}

__host__ __device__ __forceinline__ int parted_claim_smem_words(
    const PartedPlan& p) {
  const int keys = 1 << p.lo_bits;
  return kWarps * (keys + 1) + 3 * keys;
}

// The claim over the partitioned items: a tile of one part (from the
// map), its items (item index, cell) in item order. cnt0[c] is cell c's
// count before the chunk, caps[c] its capacity; the last tile of each
// part writes counts_out for the part's cells. Every block first clears
// its share of the partition's look-back words; a block past the last
// tile clears its list counts and stops. Each shard of sd claims over its
// own items, cells, ring and scratch.
__global__ void __launch_bounds__(kThreads)
    parted_claim(const int4* __restrict__ items, const PartedPlan p,
                 int cells, int n_max, const int32_t* __restrict__ meta,
                 const int32_t* __restrict__ cnt0,
                 const int32_t* __restrict__ caps,
                 int32_t* __restrict__ counts_out,
                 int32_t* __restrict__ winner, int2* __restrict__ lists,
                 int32_t* __restrict__ list_n,
                 unsigned long long* __restrict__ status,
                 int32_t* __restrict__ zeroed,
                 int32_t* __restrict__ tile_ctr, const Shards sd) {
  extern __shared__ int32_t sm[];
  const long long sh = shard_index();
  if (sh >= sd.n) return;
  items += sh * sd.part;
  meta += sh * sd.meta;
  cnt0 += sh * sd.cells;
  caps += sh * sd.cells;
  counts_out += sh * sd.cells;
  winner += sh * sd.table;
  lists += sh * sd.lists;
  list_n += sh * sd.list_n;
  status += sh * sd.status;
  zeroed += sh * sd.zeroed;
  tile_ctr += sh * sd.ctrs;
  const int lo_keys = 1 << p.lo_bits;
  int32_t* wrun = sm;
  int32_t* agg = wrun + kWarps * (lo_keys + 1);
  int32_t* base = agg + lo_keys;
  int32_t* cap = base + lo_keys;
  const int g = take_tile(tile_ctr);
  if (g == (int)gridDim.x - 1 && threadIdx.x == 0) *tile_ctr = 0;
  {
    unsigned long long* pst = status + claim_words(p);
    const size_t words = (size_t)p.tiles * sum_keys(p);
    for (size_t i = (size_t)g * kThreads + threadIdx.x; i < words;
         i += (size_t)gridDim.x * kThreads)
      pst[i] = 0;
  }
  const int4 tm = reinterpret_cast<const int4*>(meta)[g];
  const int part = tm.x;
  if (part < 0) {
    if (threadIdx.x < kWarps) list_n[g * kWarps + threadIdx.x] = 0;
    return;
  }
  const int t0 = g - tm.w;                       // the part's first tile
  const int n = (tm.z & (kTile - 1)) + 1;
  const int nt = (tm.z >> kTileBits) + 1;
  const int cell0 = part << p.lo_bits;
  int lo[kItems], rank[kItems], j[kItems];
  float ua[kItems], us[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const int q = (int)item_index(0, r);
    lo[r] = lo_keys;
    j[r] = 0;
    ua[r] = us[r] = 0.0f;
    if (q < n) {
      const int4 e = items[tm.y + q];
      j[r] = e.x;
      lo[r] = e.y - cell0;
      ua[r] = __int_as_float(e.z);
      us[r] = __int_as_float(e.w);
    }
  }
  for (int k = threadIdx.x; k < lo_keys; k += kThreads) {
    const bool in_range = cell0 + k < cells;
    base[k] = in_range ? cnt0[cell0 + k] : 0;
    cap[k] = in_range ? caps[cell0 + k] : 0;
  }
  part_ranks(lo, rank, lo_keys, wrun, agg, status + (size_t)g * lo_keys, 1,
             g == t0);
  part_lookback(g, t0, lo_keys, agg, base, status, 1, lo_keys);
  // The part's tile that finishes its look-back last clears the part's
  // look-back words: no tile reads them after that.
  __shared__ int s_last;
  if (threadIdx.x == 0)
    s_last = part_ticket(claim_tickets(p, zeroed) + part) == nt - 1;
  __syncthreads();
  if (s_last) {
    unsigned long long* rows = status + (size_t)t0 * lo_keys;
    for (int i = threadIdx.x; i < nt * lo_keys; i += kThreads) rows[i] = 0;
    if (threadIdx.x == 0) claim_tickets(p, zeroed)[part] = 0;
  }
  if (tm.w == nt - 1)                            // the part's last tile
    for (int k = threadIdx.x; k < lo_keys && cell0 + k < cells;
         k += kThreads)
      counts_out[cell0 + k] = base[k] + agg[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int2* list = lists + (size_t)g * kTile + warp * kWarpItems;
  int listed = 0;                                // the same in every lane
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    int32_t f = -1;
    if (lo[r] < lo_keys) {
      f = vitter_cell(cell0 + lo[r], base[lo[r]] + rank[r] + 1, cap[lo[r]],
                      ua[r], us[r], n_max);
      if (f >= 0) atomicMax(&winner[f], j[r]);
    }
    const unsigned won = __ballot_sync(kFull, f >= 0);
    if (f >= 0) list[listed + __popc(won & below)] = make_int2(j[r], f);
    listed += __popc(won);
  }
  if (lane == 0) list_n[g * kWarps + warp] = listed;
}

// Blocks of the counting launches at most: each takes every gridDim.x-th
// tile, so a large chunk's totals take fewer global adds (two blocks an
// SM of an H100).
constexpr int kCountBlocks = 264;

__host__ __device__ __forceinline__ int count_grid(const PartedPlan& p) {
  return p.tiles < kCountBlocks ? p.tiles : kCountBlocks;
}

// The counting launch's shared memory: the digit counts, then `extra`.
__host__ __device__ __forceinline__ int count_smem_words(const PartedPlan& p,
                                                         int extra) {
  return sum_keys(p) + extra;
}

// The parted form's scratch, as the wrapper passes it (a host array of
// kPtSlots pointers).
enum PartedSlot {
  kPtZeroed,   // int32: digit and part totals, the ticket; 0 between calls
  kPtMeta,     // int32: the claim's map, offsets, first items
  kPtItemsA,   // Entry [M]: the partition's output (pass 0, 2)
  kPtItemsB,   // Entry [M]: pass 1's output (null for one pass)
  kPtBase,     // int32 [cells]: one-shot, a cell's count after the reset
  kPtCap,      // int32 [cells]: one-shot, its capacity after the reset
  kPtSlots
};

// The items the last pass wrote.
inline int4* parted_items(const PartedPlan& p, void* const* pt) {
  return static_cast<int4*>(pt[(p.passes - 1) % 2 ? kPtItemsB : kPtItemsA]);
}

// Launches the partition passes after the counting launch, each over
// the shards of sd (pt: shard 0's scratch; status: its partition's
// look-back words).
template <class Items>
int launch_partition(const Items& src, const PartedPlan& p, int m,
                     void* const* pt, unsigned long long* status,
                     int32_t* tile_ctr, const Shards& sd,
                     cudaStream_t stream) {
  using Entry = typename Items::Entry;
  const int32_t* meta = static_cast<const int32_t*>(pt[kPtMeta]);
  const Entry* in = nullptr;
  for (int d = 0; d < p.passes; ++d) {
    Entry* out = static_cast<Entry*>(pt[d % 2 ? kPtItemsB : kPtItemsA]);
    const size_t smem =
        sizeof(int32_t) * (partition_smem_words(p, d) + src.smem_words());
    cudaError_t e = allow_smem(parted_partition<Items>, smem);
    if (e != cudaSuccess) return (int)e;
    parted_partition<Items><<<shard_grid(p.tiles, sd.n), kThreads, smem,
                              stream>>>(src, p, d, m, in, out, meta, status,
                                        tile_ctr, sd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    in = out;
  }
  return 0;
}

// Launches parted_count over the shards of sd.
template <class Items>
int launch_count(const Items& src, const PartedPlan& p, int m,
                 void* const* pt, const Shards& sd, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * count_smem_words(p, src.smem_words());
  cudaError_t e = allow_smem(parted_count<Items>, smem);
  if (e != cudaSuccess) return (int)e;
  parted_count<Items><<<shard_grid(count_grid(p), sd.n), kThreads, smem,
                        stream>>>(src, m, p,
                                  static_cast<int32_t*>(pt[kPtZeroed]),
                                  static_cast<int32_t*>(pt[kPtMeta]), sd);
  return (int)cudaGetLastError();
}

// Launches the claim after the partition, over the shards of sd.
inline int launch_parted_claim(const PartedPlan& p, void* const* pt,
                               int cells, int n_max, const int32_t* cnt0,
                               const int32_t* caps, int32_t* counts_out,
                               int32_t* winner, int2* lists, int32_t* list_n,
                               unsigned long long* status, int32_t* tile_ctr,
                               const Shards& sd, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * parted_claim_smem_words(p);
  cudaError_t e = allow_smem(parted_claim, smem);
  if (e != cudaSuccess) return (int)e;
  parted_claim<<<shard_grid(p.claim_grid, sd.n), kThreads, smem, stream>>>(
      parted_items(p, pt), p, cells, n_max,
      static_cast<const int32_t*>(pt[kPtMeta]), cnt0, caps, counts_out,
      winner, lists, list_n, status, static_cast<int32_t*>(pt[kPtZeroed]),
      tile_ctr, sd);
  return (int)cudaGetLastError();
}

}  // namespace fold
}  // namespace
