// The parted form of the stats and the histogram, shared by
// stratified_stats.cu and weighted_hist.cu (each includes it into its own
// anonymous namespace), past the keys whose 8 warps' rows a block's
// shared memory holds (the wrappers' MAX_STRATA and MAX_CELLS_BINS, and a
// histogram's [G, N] view past MAX_ROW_BINS bins).
//
// Replaces no TPU kernel of its own: it is the large-key form of kernels 2
// and 4, whose TPU kernels keep their per-key sums as whole VMEM blocks and
// so have no key cap. A key k (a stratum, or cell * B + bin) is written
// (part, lo) = (k >> lo_bits, k & (2^lo_bits - 1)), as the fold's parted
// form writes a cell (kernels/_workspace.py::parted_plan, here with the
// small form's key cap: 2^lo_bits <= 512 strata, 1,024 histogram keys).
// Launches, 2 + the plan's partition passes (3 up to 2^19 strata or 2^20
// histogram keys, one more for each further 10 bits of the part id):
//   count      parted_count (parted_claim.cuh): each block counts the
//              live items (masked in, the key in range, for the histogram
//              in a bin) per digit; the last block scans the totals into
//              the digit offsets, each part's first item and the map of
//              reduce tiles (part, first position, items, index in the
//              part);
//   partition  parted_partition, once a pass: the live items' entries
//              (key, value bits), 8 bytes each, scattered stably by part,
//              in item order inside each part;
//   sums       parted_sums: a tile of at most 2,048 entries of one part,
//              read contiguously and reduced over the part's 2^lo_bits
//              keys by the small form's per-warp rows and fixed tree
//              (masked_reduce.cuh's reduce_items, write_block_row). A part
//              of one tile writes its keys; a part of several writes each
//              tile's row (NF sums, the counts) to scratch, and the tile
//              that takes the part's last ticket sums the rows in tile
//              order by a pairwise cascade and writes the part's keys.
//              Every block also clears its share of the partition's
//              look-back words and writes 0 to the keys of its share of
//              the parts that have no item.
// Every sum's order is fixed by the data and M (the partition is stable
// and every tree's shape is fixed by a part's items), so a second call
// gives the same bits; no float atomics, no memset. Counts are integers,
// exact in any order.
//
// What bounds it on this card: memory. The function needs each item's
// mask byte and key inputs, each live item's value, and writes the keys'
// outputs. The chain reads each item's key inputs twice (count and the
// first pass), writes and reads each live entry once a pass and once in
// the sums, and moves the look-back words: tiles x digit keys a pass, so
// a pass over 512 digits costs more in look-back than one over 32.
// Scratch grows with the items and the keys, never with tiles x keys.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "masked_reduce.cuh"
#include "parted_claim.cuh"
#include "row_reduce.cuh"

namespace {

// The reduction's scratch after parted_claim.cuh's slots, in the host
// array of pointers the wrapper passes (kRdSlots of them; the one-shot's
// kPtBase and kPtCap are null).
enum ReduceSlot {
  kRdStatus = fold::kPtSlots,  // u64: the partition's look-back words, 0
                               // between calls
  kRdCounter,                  // int32: its tile counter, 0 between calls
  kRdRows,                     // f32: a row a reduce tile, NF sums then the
                               // counts' int bits, over the part's keys
  kRdSlots
};

// Clears the partition's look-back words (each block its share) and
// writes 0 to the keys of this block's share of the parts with no item.
template <int NF>
__device__ __forceinline__ void sums_prologue(
    const fold::PartedPlan& p, long long keys, const int32_t* meta,
    unsigned long long* status, float* out_f, float* out_c) {
  const size_t words = fold::partition_words(p, p.passes);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < words;
       i += (size_t)gridDim.x * kThreads)
    status[i] = 0;
  const int32_t* first = fold::part_first(p, meta);
  for (int q = blockIdx.x; q < p.parts; q += gridDim.x) {
    if (first[q + 1] != first[q]) continue;
    const long long k0 = (long long)q << p.lo_bits;
    const long long k1 = min(k0 + (1LL << p.lo_bits), keys);
    for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
      out_c[k] = 0.0f;
#pragma unroll
      for (int f = 0; f < NF; ++f) out_f[f * keys + k] = 0.0f;
    }
  }
}

// The sums launch over the last pass's entries (key, value bits), one
// block a slot of the reduce map (parted_claim.cuh's claim map). out_f:
// NF x keys sums (the stats' x and x*x, the histogram's weights), out_c:
// keys counts. Shared memory: kWarps rows of NF x 2^lo_bits f32 sums, then
// 2^lo_bits int32 counts.
template <int NF>
__global__ void __launch_bounds__(kThreads)
    parted_sums(const int2* __restrict__ items, const fold::PartedPlan p,
                long long keys, const int32_t* __restrict__ meta,
                unsigned long long* __restrict__ status,
                int32_t* __restrict__ zeroed, float* __restrict__ part_rows,
                float* __restrict__ out_f, float* __restrict__ out_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int lo_keys = 1 << p.lo_bits;
  float* rows = reinterpret_cast<float*>(smem);   // [kWarps][NF][lo_keys]
  int32_t* cnt = reinterpret_cast<int32_t*>(rows + kWarps * NF * lo_keys);
  sums_prologue<NF>(p, keys, meta, status, out_f, out_c);
  const int4 tm = reinterpret_cast<const int4*>(meta)[blockIdx.x];
  const int part = tm.x;
  if (part < 0) return;
  const int n = (tm.z & (fold::kTile - 1)) + 1;
  const int nt = (tm.z >> fold::kTileBits) + 1;
  int2 e[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {    // all loads independent: one trip
    const int q = r * kThreads + threadIdx.x;
    e[r] = q < n ? items[tm.y + q] : make_int2(-1, 0);
  }
  for (int i = threadIdx.x; i < kWarps * NF * lo_keys; i += kThreads)
    rows[i] = 0.0f;
  for (int i = threadIdx.x; i < lo_keys; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int key[kItems];
  float val[kItems][NF];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    key[r] = e[r].x >= 0 ? e[r].x & (lo_keys - 1) : -1;
    val[r][0] = __int_as_float(e[r].y);
    if constexpr (NF == 2) val[r][1] = __fmul_rn(val[r][0], val[r][0]);
  }
  reduce_items<NF>(key, val, rows + (threadIdx.x >> 5) * NF * lo_keys, cnt,
                   lo_keys, threadIdx.x & 31);
  __syncthreads();
  const long long k0 = (long long)part << p.lo_bits;
  const int width = (int)min((long long)lo_keys, keys - k0);
  if (nt == 1) {                        // the part's one tile
    for (int k = threadIdx.x; k < width; k += kThreads) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float r[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          r[w] = rows[(w * NF + f) * lo_keys + k];
        out_f[f * keys + k0 + k] = tree_sum<kWarps>(r);
      }
      out_c[k0 + k] = __int2float_rn(cnt[k]);
    }
    return;
  }
  const size_t stride = (size_t)(NF + 1) * lo_keys;
  float* row = part_rows + (size_t)blockIdx.x * stride;
  write_block_row<NF>(rows, lo_keys, row);
  for (int k = threadIdx.x; k < lo_keys; k += kThreads)
    row[NF * lo_keys + k] = __int_as_float(cnt[k]);
  __syncthreads();
  int32_t* ticket = fold::claim_tickets(p, zeroed) + part;
  if (threadIdx.x == 0) s_last = take_ticket(ticket) == nt - 1;
  __syncthreads();
  if (!s_last) return;
  // The part's rows in tile order (its tiles are consecutive map slots),
  // each key's by one thread's cascade.
  const float* rows0 = part_rows + (size_t)(blockIdx.x - tm.w) * stride;
  for (int k = threadIdx.x; k < width; k += kThreads) {
    float st[kCascade][2];
    int32_t c = 0;
    for (int t = 0; t < nt; ++t) {
      const float* r = rows0 + t * stride;
      c += __float_as_int(__ldcg(r + NF * lo_keys + k));
      cascade_push(st, (unsigned)t, __ldcg(r + k),
                   NF == 2 ? __ldcg(r + lo_keys + k) : 0.0f);
    }
    float a, b;
    cascade_total(st, (unsigned)nt, a, b);
    out_f[k0 + k] = a;
    if constexpr (NF == 2) out_f[keys + k0 + k] = b;
    out_c[k0 + k] = __int2float_rn(c);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// f32 words of the reduce tiles' rows for the plan's grid.
__host__ __device__ inline long long reduce_row_words(
    const fold::PartedPlan& p, int nf) {
  return ((long long)p.claim_grid * (nf + 1)) << p.lo_bits;
}

// The count and partition launches over the items of src (an item
// source, as parted_claim.cuh's Items), `keys` keys and m items, into *p
// the plan read from the wrapper's kPlanInts ints; pt: kRdSlots pointers.
// The last pass's entries are left in the scratch, and its look-back
// words for the sums launch to clear.
template <class Items>
int launch_parted_items(const Items& src, long long keys, int m,
                        const int* plan, void* const* pt,
                        cudaStream_t stream, fold::PartedPlan* p) {
  if (!fold::read_plan(plan, keys, m, p)) return (int)cudaErrorInvalidValue;
  const fold::Shards sd = fold::one_shard();
  const int err = fold::launch_count(src, *p, m, pt, sd, stream);
  if (err != 0) return err;
  return fold::launch_partition(
      src, *p, m, pt, static_cast<unsigned long long*>(pt[kRdStatus]),
      static_cast<int32_t*>(pt[kRdCounter]), sd, stream);
}

// The parted form's launches: count, partition, sums (out_f: NF x keys
// sums, out_c: keys counts).
template <int NF, class Items>
int launch_parted_reduce(const Items& src, long long keys, int m,
                         const int* plan, void* const* pt, float* out_f,
                         float* out_c, cudaStream_t stream) {
  fold::PartedPlan p;
  const int err = launch_parted_items(src, keys, m, plan, pt, stream, &p);
  if (err != 0) return err;
  const size_t smem = (sizeof(float) * (kWarps * NF + 1)) << p.lo_bits;
  cudaError_t e = allow_smem(parted_sums<NF>, smem);
  if (e != cudaSuccess) return (int)e;
  const int last = (p.passes - 1) % 2 ? fold::kPtItemsB : fold::kPtItemsA;
  parted_sums<NF><<<p.claim_grid, kThreads, smem, stream>>>(
      static_cast<const int2*>(pt[last]), p, keys,
      static_cast<const int32_t*>(pt[fold::kPtMeta]),
      static_cast<unsigned long long*>(pt[kRdStatus]),
      static_cast<int32_t*>(pt[fold::kPtZeroed]),
      static_cast<float*>(pt[kRdRows]), out_f, out_c);
  return (int)cudaGetLastError();
}

}  // namespace
