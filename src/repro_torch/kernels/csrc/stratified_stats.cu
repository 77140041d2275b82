// Per-stratum (count, sum x*m, sum (x*m)*x) for Hopper (sm_90a), in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/stratified_stats.py:31
// (_stats_kernel, wrapper stratified_stats). On the TPU the segment
// reduction was recast as a one-hot matmul so that it ran on the MXU, with
// the three [1, S] accumulators carried in VMEM across the sequential
// grid. On this card blocks run in parallel and in no order, so nothing
// can be carried from one to the next; the reduction is the masked,
// deterministic segmented reduction of masked_reduce.cuh: per-thread
// folds, warp steps into per-warp rows in shared memory, and a cross-block
// sum in a fixed tree by the blocks that take the last tickets, all in one
// launch, without memset and without float atomics.
//
// What bounds it on this card: memory. The function needs every mask byte
// and the value and stratum id of each live slot, and writes 12 bytes per
// stratum: at the emission's [6 x 1,048,576] slots with about 0.75 of them
// live, about 44 MB, 0.0131 ms at 3.35 TB/s. Three adds and a multiply per
// live item are far below the f32 rate. What the design does about each
// limit of the earlier two-launch design (stats_partials and stats_final):
//   - dependent loads, one in flight per thread: a thread's loads are
//     vectors, issued together for a tile, and the next tile's values,
//     strata and the mask words after it are in flight while a tile is
//     reduced;
//   - 4- and 1-byte loads: 16-byte loads of values and stratum ids, a
//     vector's 4 mask bytes in one word, with a scalar head and tail for
//     a view that starts off a 16-byte boundary or a ragged M;
//   - bytes: a vector's values and stratum ids are read only if one of
//     its items is live;
//   - the walk over strata (two ballots and two butterflies per stratum
//     and item step): a thread folds its items of the warp's first key,
//     one butterfly per tile when a warp's items share a stratum (in the
//     emission's [G x N] view they almost always do); a warp with several
//     pays one segmented-tree step per item index still held;
//   - two launches (3,072 one-tile blocks, 2.9 waves, then a one-block
//     per stratum finish) and partials allocated per call: one launch of
//     at most 512 blocks walking the tiles with a grid stride, the
//     cross-block sum by tickets, the rows, tickets and count totals kept
//     in the caller's workspace.
//
// Every sum has one fixed shape for given tensors, so the result is the
// same from run to run, and it is tree-shaped, which keeps the rounding
// error of a sum of 10^6 f32 values near that of a pairwise sum. That
// matters for the Eq. 7 variance s2 = sumsqs - Y*mean^2, which cancels
// about three digits for a stratum with mean 10^4 and sigma 500.
// Sequential f32 additions per sum (masked_reduce.cuh): 31 at the
// emission's shape, at most 73. Counts are integers, so they are exact.
//
// Shared memory: 8 warps' rows of S (f32, f32) sums and one row of S
// int32 counts, 34,816 B at S = 512; the workspace holds a row of S per
// block and group. Past S = 512 (the wrapper's MAX_STRATA) the wrapper
// asks for the parted form instead (parted_reduce.cuh over StatsItems: a
// stratum is (part, low 9 bits or fewer), the live items' (stratum, x)
// partitioned stably by part, each part's tiles summed over its low bits
// by the small form's rows; 3 launches up to 2^19 strata, scratch that
// grows with M + S). Sequential f32 additions per sum there: a thread's
// fold and the butterfly (at most 13), its warp's row (one add per step
// that meets the key, at most 8), the warps' tree (3), and for a part of
// T > 1 tiles the cascade over its tiles (about log2 T).
//
// The row form (stats_rows_kernel, row_reduce.cuh), for a caller whose
// strata are the rows of a [G, N] view (the emission's), past S = 512:
// one launch, no sort, no ids, no per-slot scratch and no cap on G. The
// function needs every mask byte, the value of each live slot and 12
// bytes per row. Sequential f32 additions per sum: a thread's fold (at
// most 16), the unit's butterfly (at most 5) and its warps' tree (3 for
// the 8 warps of a 4,096-slot part): at most 24 for N <= 4,096 (21 at
// the sliding deployment's N = 512, 18 at N = 64); a longer row adds its
// parts' cascade (0 for up to 256 parts, N <= 1,048,576; about
// 2 log2(parts / 256) past that), the finisher's butterfly (5) and tree
// (3): 32 up to N = 1,048,576. Counts are integers, so they are exact.
// The sum order is fixed by (G, N) alone, so a second call gives the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "masked_reduce.cuh"
#include "parted_reduce.cuh"
#include "row_reduce.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 4)
    stats_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ sid,
                 const uint8_t* __restrict__ mask, Span sp, int s_cnt,
                 float* __restrict__ red, int32_t* __restrict__ zeroed,
                 float* __restrict__ counts, float* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);          // [kWarps][2][S]
  int32_t* cnt = reinterpret_cast<int32_t*>(rows + kWarps * 2 * s_cnt);
  const long long stride = gridDim.x;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int4 none4 = make_int4(-1, -1, -1, -1);
  // The pipeline: this tile's values and strata and the next tile's mask
  // words are in flight before the rows are cleared.
  uint32_t mk[kVecs], mk_next[kVecs];
  float4 x[kVecs];
  int4 s[kVecs];
  load_masks(mask, sp, blockIdx.x, mk);
  load_masks(mask, sp, blockIdx.x + stride, mk_next);
  load_tile(values, sp, blockIdx.x, mk, true, zero4, x);
  load_tile(sid, sp, blockIdx.x, mk, sp.vec & kIdsVec, none4, s);
  for (int k = threadIdx.x; k < kWarps * 2 * s_cnt; k += kThreads)
    rows[k] = 0.0f;
  for (int k = threadIdx.x; k < s_cnt; k += kThreads) cnt[k] = 0;
  __syncthreads();
  const long long n_tiles = ((sp.m + sp.d + 3) / 4 + kTileVecs - 1) /
                            kTileVecs;
  const int lane = threadIdx.x & 31;
  float* my_rows = rows + (threadIdx.x >> 5) * 2 * s_cnt;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += stride) {
    int key[kItems];
    float val[kItems][2];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int si = lane_of(s[k], i);
        const float xi = lane_of(x[k], i);
        key[4 * k + i] =
            byte_on(mk[k], i) && si >= 0 && si < s_cnt ? si : -1;
        val[4 * k + i][0] = xi;
        val[4 * k + i][1] = __fmul_rn(xi, xi);
      }
    // The next tile's values and strata and the mask words after it, in
    // flight while this tile is reduced.
    uint32_t mk_after[kVecs];
    load_tile(values, sp, tile + stride, mk_next, true, zero4, x);
    load_tile(sid, sp, tile + stride, mk_next, sp.vec & kIdsVec, none4, s);
    load_masks(mask, sp, tile + 2 * stride, mk_after);
    reduce_items<2>(key, val, my_rows, cnt, s_cnt, lane);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      mk[k] = mk_next[k];
      mk_next[k] = mk_after[k];
    }
  }
  __syncthreads();
  finish<2>(rows, cnt, s_cnt, red, zeroed, sums, counts);
}

// The parted form's items (parted_claim.cuh's item source): a live item
// is masked in with its stratum in [0, S); its key is the stratum and its
// entry (stratum, x). The value is read beside the id and the mask, which
// spares a dependent trip and, with a quarter of the items masked out,
// next to no sectors.
struct StatsItems {
  using Entry = int2;
  const float* values;
  const int32_t* sid;
  const uint8_t* mask;
  int s_cnt;
  __host__ __device__ int smem_words() const { return 0; }
  __device__ __forceinline__ StatsItems at(long long,
                                           const fold::Shards&) const {
    return *this;
  }
  __device__ __forceinline__ StatsItems begin(int32_t* = nullptr) const {
    return *this;
  }
  __device__ __forceinline__ int cell(long long q) const {
    const int s = sid[q];
    return mask[q] != 0 && s >= 0 && s < s_cnt ? s : -1;
  }
  __device__ __forceinline__ int2 entry(long long q) const {
    const float x = values[q];
    const int s = cell(q);
    return make_int2(s, s >= 0 ? __float_as_int(x) : 0);
  }
  __device__ static __forceinline__ int key_of(const int2& e) { return e.x; }
  __device__ static __forceinline__ int2 none() { return make_int2(-1, 0); }
};

// The row form (row_reduce.cuh): the sums of each unit of a [G, N] view
// (a row, or a part of a long row) by its tr = 2^tr_log threads. Part p's
// sums (x, x*x, count as int bits) go to part[3p..3p+2] when a row has
// several parts; tickets[g] counts the row's parts done (0 between
// calls). Outputs as sa_stratified_stats'.
__global__ void __launch_bounds__(kThreads)
    stats_rows_kernel(const float* __restrict__ values,
                      const uint8_t* __restrict__ mask, long long g,
                      long long n, int tr_log, long long parts,
                      float* __restrict__ part, int32_t* __restrict__ tickets,
                      float* __restrict__ counts, float* __restrict__ sums) {
  __shared__ float s_sum[kWarps][2];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_last;
  const int tr = 1 << tr_log;
  const int sub = threadIdx.x & (tr - 1);
  const long long unit =
      (long long)blockIdx.x * (kThreads >> tr_log) + (threadIdx.x >> tr_log);
  const long long row = unit / parts;
  const bool has = row < g;
  const long long first = (unit - row * parts) * kRowPart + sub;
  const float* __restrict__ xr = values + row * n;
  const uint8_t* __restrict__ mr = mask + row * n;
  // Every mask byte of the thread's slots in flight, then the values of
  // the live ones.
  uint8_t mk[kRowPer];
#pragma unroll
  for (int t = 0; t < kRowPer; ++t) {
    const long long i = first + (long long)t * tr;
    mk[t] = has && i < n ? __ldg(mr + i) : 0;
  }
  float x[kRowPer];
#pragma unroll
  for (int t = 0; t < kRowPer; ++t)
    x[t] = mk[t] ? __ldg(xr + first + (long long)t * tr) : 0.0f;
  float s = 0.0f, q = 0.0f;
  int c = 0;
#pragma unroll
  for (int t = 0; t < kRowPer; ++t)
    if (mk[t]) {
      ++c;
      s = __fadd_rn(s, x[t]);
      q = __fadd_rn(q, __fmul_rn(x[t], x[t]));
    }
  // The unit's lanes of each warp (all of a unit's lanes when tr <= 32).
  for (int d = (tr < 32 ? tr : 32) >> 1; d > 0; d >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, d));
    q = __fadd_rn(q, __shfl_xor_sync(kFull, q, d));
    c += __shfl_xor_sync(kFull, c, d);
  }
  const int warp = threadIdx.x >> 5;
  if (tr > 32) {                   // the unit's warps by a fixed tree
    if ((threadIdx.x & 31) == 0) {
      s_sum[warp][0] = s;
      s_sum[warp][1] = q;
      s_cnt[warp] = c;
    }
    __syncthreads();
    if (sub == 0) {
      float a[kWarps], b[kWarps];
      c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const bool in = w < (tr >> 5);
        a[w] = in ? s_sum[warp + w][0] : 0.0f;
        b[w] = in ? s_sum[warp + w][1] : 0.0f;
        c += in ? s_cnt[warp + w] : 0;
      }
      s = tree_sum<kWarps>(a);
      q = tree_sum<kWarps>(b);
    }
  }
  if (parts == 1) {
    if (has && sub == 0) {
      counts[row] = __int2float_rn(c);
      sums[row] = s;
      sums[g + row] = q;
    }
    return;
  }
  // A row of several parts (tr = 256, a block per unit): the part's sums
  // out, then the row's last block sums the parts.
  if (threadIdx.x == 0) {
    float* pp = part + 3 * unit;
    pp[0] = s;
    pp[1] = q;
    pp[2] = __int_as_float(c);
    s_last = take_ticket(tickets + row) == parts - 1;
  }
  __syncthreads();
  if (!s_last) return;
  const float* rp = part + 3 * row * parts;
  float st[kCascade][2];
  unsigned k = 0;
  c = 0;
  for (long long p = threadIdx.x; p < parts; p += kThreads, ++k) {
    c += __float_as_int(__ldcg(rp + 3 * p + 2));
    cascade_push(st, k, __ldcg(rp + 3 * p), __ldcg(rp + 3 * p + 1));
  }
  cascade_total(st, k, s, q);
  for (int d = 16; d > 0; d >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, d));
    q = __fadd_rn(q, __shfl_xor_sync(kFull, q, d));
    c += __shfl_xor_sync(kFull, c, d);
  }
  if ((threadIdx.x & 31) == 0) {
    s_sum[warp][0] = s;
    s_sum[warp][1] = q;
    s_cnt[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a[kWarps], b[kWarps];
    c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a[w] = s_sum[w][0];
      b[w] = s_sum[w][1];
      c += s_cnt[w];
    }
    counts[row] = __int2float_rn(c);
    sums[row] = tree_sum<kWarps>(a);
    sums[g + row] = tree_sum<kWarps>(b);
    tickets[row] = 0;
  }
}

}  // namespace

// The count and partition launches alone, for tests: the live items'
// entries partitioned stably by part into the scratch (plan and pt as
// sa_stratified_stats takes them), the stats' (stratum, x) when entry is
// 2, the fold's (item, stratum, u_accept, u_slot) when 4 (then the
// scratch's buffers hold 4 words an item). The partition's look-back
// words are left for the caller to clear (in a call the sums launch
// clears them).
extern "C" int sa_stats_partition(const void* values, const void* sid,
                                  const void* mask, const void* u_accept,
                                  const void* u_slot, long long m, int s_cnt,
                                  int entry, const int* plan,
                                  void* const* pt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const StatsItems items{static_cast<const float*>(values),
                         static_cast<const int32_t*>(sid),
                         static_cast<const uint8_t*>(mask), s_cnt};
  fold::PartedPlan p;
  if (entry == 2)
    return launch_parted_items(items, s_cnt, (int)m, plan, pt, stream, &p);
  if (entry != 4) return (int)cudaErrorInvalidValue;
  return launch_parted_items(
      fold::ClaimItems<StatsItems>{items,
                                   static_cast<const float*>(u_accept),
                                   static_cast<const float*>(u_slot)},
      s_cnt, (int)m, plan, pt, stream, &p);
}

// f32 words of the row form's part sums for a [g, n] view (0: no row is
// cut into parts).
extern "C" long long sa_stats_rows_part_words(long long g, long long n) {
  const StatsRows lay = stats_rows_layout(g, n);
  return lay.parts > 1 ? 3 * g * lay.parts : 0;
}

// Zeroed int32 words (a ticket per row) of the row form for a [g, n]
// view; 0 between calls.
extern "C" long long sa_stats_rows_zeroed(long long g, long long n) {
  return stats_rows_layout(g, n).parts > 1 ? g : 0;
}

// The row form over a [g, n] view (values f32, mask bool, both
// contiguous); outputs as sa_stratified_stats'. part and zeroed are the
// caller's workspace (sa_stats_rows_part_words, sa_stats_rows_zeroed);
// the kernel leaves the zeroed words 0.
extern "C" int sa_stats_rows(const void* values, const void* mask,
                             long long g, long long n, void* part,
                             void* zeroed, void* counts, void* sums,
                             void* stream_ptr) {
  const StatsRows lay = stats_rows_layout(g, n);
  if (lay.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stats_rows_kernel<<<(unsigned)lay.blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(values), static_cast<const uint8_t*>(mask),
      g, n, lay.tr_log, lay.parts, static_cast<float*>(part),
      static_cast<int32_t*>(zeroed), static_cast<float*>(counts),
      static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// Words (f32) of the workspace rows a call of m items over S strata
// needs; the zeroed words are sa_reduce_zeroed(S) int32.
extern "C" long long sa_stats_scratch_words(long long m, int s_cnt) {
  return scratch_words(m, s_cnt, 2);
}

// Outputs: counts f32 [S], then sums and sumsqs f32 [S] contiguous
// (sums[0..S) and sums[S..2S)). red and zeroed are the caller's
// workspace; the kernel leaves the zeroed words 0. plan: null for the
// one-launch form, else the parted form's plan (kPlanInts ints,
// kernels/_workspace.py::parted_plan) and pt its scratch (kRdSlots
// pointers, parted_reduce.cuh), whose zeroed words it leaves 0.
extern "C" int sa_stratified_stats(const void* values, const void* sid,
                                   const void* mask, long long m, int s_cnt,
                                   void* red, void* zeroed, void* counts,
                                   void* sums, const int* plan,
                                   void* const* pt, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (plan)
    return launch_parted_reduce<2>(
        StatsItems{static_cast<const float*>(values),
                   static_cast<const int32_t*>(sid),
                   static_cast<const uint8_t*>(mask), s_cnt},
        s_cnt, (int)m, plan, pt, static_cast<float*>(sums),
        static_cast<float*>(counts), stream);
  const size_t smem = (size_t)(2 * kWarps + 1) * s_cnt * 4;
  const cudaError_t err = allow_smem(stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<grid_blocks(m), kThreads, smem, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(sid),
      static_cast<const uint8_t*>(mask),
      make_span(m, values, mask, sid, nullptr), s_cnt,
      static_cast<float*>(red), static_cast<int32_t*>(zeroed),
      static_cast<float*>(counts), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
