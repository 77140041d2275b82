// Per-(cell, bin) HT-weighted mass and sampled-item count for Hopper
// (sm_90a), in one launch.
//
// Replaces the TPU kernel src/repro/kernels/weighted_hist.py:35
// (_whist_kernel, wrapper weighted_hist). On the TPU bin and cell
// membership were one-hot comparisons and the [G, B] accumulation two
// one-hot matmuls per item tile on the MXU, with the accumulators carried
// in VMEM across the sequential grid. Here an item's bin comes from a bin
// table and binary lifting over the edges in shared memory, and the
// [G*B] sums are the masked, deterministic segmented reduction of
// masked_reduce.cuh: no float atomics, no tensor cores, no memset, one
// launch whose last blocks sum the block rows in a fixed tree.
//
// What bounds it on this card: memory. The function needs every mask
// byte, the value of each live slot, and the cell id and weight of each
// item in a bin, then the edges and the two [G, B] outputs: at the
// emission's 6,291,456 slots with 32 uniform bins over the live range,
// about 4.65 M live slots, all in a bin, about 62 MB, 0.0186 ms at
// 3.35 TB/s; in a later refinement round (the bracket between two
// neighbouring quantiles) about 1% of the live slots are in a bin, about
// 25 MB. The comparisons are far below the f32 rate. What the design does
// about each limit of the earlier two-launch design (whist_partials and
// whist_final):
//   - dependent loads, one in flight per thread: a thread's loads are
//     vectors (below), issued together for a tile, and the next tile's
//     values and the mask words after it are in flight while a tile is
//     reduced;
//   - 4- and 1-byte loads: 16-byte loads of values, cell ids and weights,
//     a vector's 4 mask bytes in one word, with a scalar head and tail
//     for a view that starts off a 16-byte boundary or a ragged M;
//   - bytes: a vector's values are read only if one of its items is live,
//     its cell ids and weights only if one of its items is in a bin;
//   - a per-item step even with nothing to do: a warp whose items share a
//     key takes one butterfly per tile, the items left one step per item
//     index that some lane still holds, none for a warp with no key;
//   - the bin search (five dependent shared-memory loads per item): a
//     guess from a table of kLut buckets over the edges' ordered bit
//     patterns (so even, geometric and narrow edges alike get one or two
//     edges per bucket), then binary lifting as far as the widest bucket
//     needs (one step for the three timed edge sets), all items of a
//     tile at each step;
//   - two launches and partials allocated per call: one launch, the
//     cross-block sum by tickets, the rows, tickets and count totals kept
//     in the caller's workspace.
//
// Every sum has one fixed shape for given tensors, so a second run gives
// the same bits: quantile refinement picks bins by searchsorted over
// cumulative masses, and a flip from run to run would change its answer.
// Counts are integers (shared atomics, then global atomics into the
// totals) and converted at the end, so they are exact. Sequential f32
// additions per mass (masked_reduce.cuh): 31 at the emission's shape with
// one key per warp and tile (55 in the earlier design), at most 73 if
// every item step of every tile meets the key; for the positive weights
// it sums that bounds the relative error by 31 x 2^-24 = 1.8e-6 (4.4e-6).
//
// Bins. Bin b is [e_b, e_{b+1}) and the last bin is right-closed, as the
// reference's comparisons x >= lo, x < hi, x <= hi (last bin) say. For
// non-decreasing edges the bin of x in [e_0, e_B] is the largest b <= B-1
// with e_b <= x, which the search finds, duplicate edges included: when
// all B+1 edges are equal (the collapsed bracket of a window of one
// repeated value), every such value lands in the last bin. NaN values,
// values below e_0 or above e_B, masked-out items and cell ids outside
// [0, G) add nothing.
//
// Shared memory: 8 warps' rows of G*B f32 sums, one row of G*B int32
// counts, the bin table, the edges and their padded copy, so G*B <= 3200
// (the wrapper's MAX_CELLS_BINS) takes at most 150,024 B of the 227 KB a
// block can use.

#include <cuda_runtime.h>
#include <stdint.h>

#include "masked_reduce.cuh"

namespace {

constexpr int kLut = kThreads;   // buckets of the bin table

// A float as an int of the same order (-0 first made +0, so equal floats
// give equal ints).
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(__fadd_rn(x, 0.0f));
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The edges as find_bins reads them: e[0..nb] the edges, es[0..nb+top) a
// copy with NaN past e[nb-1] (a comparison with NaN is false; a probe
// from b <= nb-1 by a step <= top stays inside), lut[0..kLut] the bin
// table, lo = e[0] and hi = e[nb], base = ordered(lo), shift the bucket
// width in ordered units (log2), steps the power of two that the widest
// bucket's bins need.
struct Edges {
  const float* e;
  const float* es;
  const int* lut;
  int nb, base, shift, steps;
  float lo, hi;
};

// The bins of this thread's tile items (-1: masked out, outside the
// edges, NaN) and per vector which items have one. Bin b holds x if
// e_b <= x and (x < e_{b+1} or b = nb-1), given lo <= x <= hi; for
// non-decreasing edges that b is the largest b with e_b <= x. Bucket
// u = (ordered(x) - base) >> shift starts at lut[u], the largest b whose
// edge is at most the bucket's first value, and lut[u + 1] bounds the
// bin from above; binary lifting over es from lut[u] covers that range,
// every item of the tile at each step.
__device__ __forceinline__ void find_bins(const Edges& ed,
                                          const float4 (&x)[kVecs],
                                          const uint32_t (&mk)[kVecs],
                                          int (&bin)[kItems],
                                          uint32_t (&in_bin)[kVecs]) {
  float xi[kItems];
  unsigned cand = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * k + i;
      xi[j] = lane_of(x[k], i);
      const bool c = byte_on(mk[k], i) && ed.lo <= xi[j] && xi[j] <= ed.hi;
      cand |= (unsigned)c << j;
      const unsigned u =
          c ? ((unsigned)ordered(xi[j]) - (unsigned)ed.base) >> ed.shift : 0u;
      bin[j] = ed.lut[min(u, (unsigned)(kLut - 1))];
    }
  for (int step = ed.steps; step > 0; step >>= 1)
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (ed.es[bin[j] + step] <= xi[j]) bin[j] += step;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    in_bin[k] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * k + i;
      const bool keep = (cand >> j) & 1u;
      bin[j] = keep ? bin[j] : -1;
      in_bin[k] |= (uint32_t)keep << (8 * i);
    }
  }
}

// The largest b in [0, nb) with ordered(e_b) <= v (0 if none).
__device__ __forceinline__ int last_edge_at_most(const float* e, int nb,
                                                 int top, int v) {
  int b = 0;
  for (int step = top; step > 0; step >>= 1)
    if (b + step < nb && ordered(e[b + step]) <= v) b += step;
  return b;
}

__global__ void __launch_bounds__(kThreads, 4)
    weighted_hist_kernel(const float* __restrict__ values,
                         const int32_t* __restrict__ cell_ids,
                         const float* __restrict__ weights,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ edges, Span sp, int g_cnt,
                         int nb, float* __restrict__ red,
                         int32_t* __restrict__ zeroed,
                         float* __restrict__ whist,
                         float* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_width;
  const int keys = g_cnt * nb;
  int top = nb > 1 ? 1 : 0;
  while (2 * top <= nb - 1) top *= 2;
  float* rows = reinterpret_cast<float*>(smem);                // [kWarps][keys]
  int32_t* cnt = reinterpret_cast<int32_t*>(rows + kWarps * keys);  // [keys]
  int* lut = cnt + keys;                                       // [kLut + 1]
  float* e = reinterpret_cast<float*>(lut + kLut + 1);         // [nb + 1]
  float* es = e + nb + 1;                                      // [nb + top]
  const long long stride = gridDim.x;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // The pipeline: this tile's values and the next tile's mask words are
  // in flight before the edges are in shared memory.
  uint32_t mk[kVecs], mk_next[kVecs];
  float4 x[kVecs];
  load_masks(mask, sp, blockIdx.x, mk);
  load_masks(mask, sp, blockIdx.x + stride, mk_next);
  load_tile(values, sp, blockIdx.x, mk, true, zero4, x);
  for (int k = threadIdx.x; k < kWarps * keys; k += kThreads) rows[k] = 0.0f;
  for (int k = threadIdx.x; k < keys; k += kThreads) cnt[k] = 0;
  for (int k = threadIdx.x; k <= nb; k += kThreads) e[k] = edges[k];
  for (int k = threadIdx.x; k < nb + top; k += kThreads)
    es[k] = k < nb ? edges[k] : __int_as_float(0x7fffffff);
  if (threadIdx.x == 0) s_width = 0;
  __syncthreads();
  Edges ed{e, es, lut, nb, ordered(e[0]), 0, 0, e[0], e[nb]};
  const unsigned range = (unsigned)ordered(ed.hi) - (unsigned)ed.base;
  while ((range >> ed.shift) >= (unsigned)kLut) ++ed.shift;
  // Each thread builds entries k and k + 1 of the table (kLut == kThreads)
  // and the widest bucket comes from a warp max, one barrier in all.
  {
    int entry[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long v = (long long)ed.base +
                          ((long long)(threadIdx.x + h) << ed.shift);
      entry[h] = v > 0x7fffffffLL ? nb - 1
                                  : last_edge_at_most(e, nb, top, (int)v);
    }
    lut[threadIdx.x] = entry[0];
    if (threadIdx.x == kLut - 1) lut[kLut] = entry[1];
    const int width =
        (int)__reduce_max_sync(kFull, (unsigned)(entry[1] - entry[0]));
    if ((threadIdx.x & 31) == 0) atomicMax(&s_width, width);
  }
  __syncthreads();
  if (s_width > 0)                   // steps + ... + 1 >= s_width
    for (ed.steps = 1; 2 * ed.steps <= s_width;) ed.steps *= 2;
  const long long n_tiles = ((sp.m + sp.d + 3) / 4 + kTileVecs - 1) /
                            kTileVecs;
  const int lane = threadIdx.x & 31;
  float* my_rows = rows + (threadIdx.x >> 5) * keys;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += stride) {
    int bin[kItems];
    uint32_t in_bin[kVecs];
    find_bins(ed, x, mk, bin, in_bin);
  int4 c[kVecs];
    float4 w[kVecs];
    load_tile(cell_ids, sp, tile, in_bin, sp.vec & kIdsVec,
              make_int4(-1, -1, -1, -1), c);
    load_tile(weights, sp, tile, in_bin, sp.vec & kWeightsVec, zero4, w);
    // The next tile's values and the mask words after it, before this
    // tile's cell ids and weights are used.
    uint32_t mk_after[kVecs];
    load_tile(values, sp, tile + stride, mk_next, true, zero4, x);
    load_masks(mask, sp, tile + 2 * stride, mk_after);
    int key[kItems];
    float val[kItems][1];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = lane_of(c[k], i), b = bin[4 * k + i];
        key[4 * k + i] = b >= 0 && ci >= 0 && ci < g_cnt ? ci * nb + b : -1;
        val[4 * k + i][0] = lane_of(w[k], i);
      }
    reduce_items<1>(key, val, my_rows, cnt, keys, lane);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      mk[k] = mk_next[k];
      mk_next[k] = mk_after[k];
    }
  }
  __syncthreads();
  finish<1>(rows, cnt, keys, red, zeroed, whist, counts);
}

size_t smem_bytes(int g_cnt, int nb) {
  int top = nb > 1 ? 1 : 0;
  while (2 * top <= nb - 1) top *= 2;
  return (size_t)(kWarps + 1) * g_cnt * nb * 4 +
         (size_t)(kLut + 1 + nb + 1 + nb + top) * 4;
}

}  // namespace

// Words (f32) of the workspace rows a call of m items over G*B keys
// needs.
extern "C" long long sa_whist_scratch_words(long long m, int keys) {
  return scratch_words(m, keys, 1);
}

// Zeroed int32 words (tickets, then count totals) a call over `keys` keys
// needs; all 0 between calls.
extern "C" int sa_reduce_zeroed(int keys) { return kTickets + keys; }

// Outputs whist and counts are f32 [G, B]. red and zeroed are the
// caller's workspace (sa_whist_scratch_words, sa_reduce_zeroed); the
// kernel leaves the zeroed words 0.
extern "C" int sa_weighted_hist(const void* values, const void* cell_ids,
                                const void* weights, const void* mask,
                                const void* edges, long long m, int g_cnt,
                                int nb, void* red, void* zeroed, void* whist,
                                void* counts, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = smem_bytes(g_cnt, nb);
  const cudaError_t err = allow_smem(weighted_hist_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  weighted_hist_kernel<<<grid_blocks(m), kThreads, smem, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(cell_ids),
      static_cast<const float*>(weights), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(edges),
      make_span(m, values, mask, cell_ids, weights), g_cnt, nb,
      static_cast<float*>(red), static_cast<int32_t*>(zeroed),
      static_cast<float*>(whist), static_cast<float*>(counts));
  return (int)cudaGetLastError();
}
