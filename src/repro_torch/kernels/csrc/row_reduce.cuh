// Device code shared by stratified_stats.cu and weighted_hist.cu for their
// row form: the same functions over a [G, N] slot view whose cell is its
// row (the emission's view of a ring, where the flat forms would be given
// row ids and row weights repeated N times). Row g's slots are items
// g*N .. g*N + N - 1 of the values and of the mask; only the values of
// live slots are read, and nothing of the size G*N but those two.
//
// Ownership and grid. Each row, or a fixed part of a long row, belongs to
// one group of threads, and only that group sums it. Every layout below
// is a function of (G, N) (and B for the histogram) alone, never of the
// SM count or an occupancy query, so a call gives the same bits on any
// H100 part. Loads are scalar: a group's threads read neighbouring slots
// (a warp instruction reads 32 neighbouring slots of a row when a row
// has at least 32 threads), so a row that starts off a 16-byte boundary
// (g*N with N % 4 != 0) needs no head or tail.
//
// Stats (stats_rows_layout): a unit is a row or a part of one, summed by
// tr threads (a power of two, the least with tr * kRowPer >= N, at most
// the block's 256); a thread folds at most kRowPer live slots of its unit
// in slot order (slots sub, sub + tr, ...), a butterfly sums the unit's
// lanes of each warp and a fixed pairwise tree its warps. Rows of at most
// 4,096 slots are one unit each, several to a block when short (the
// stress view's N = 64: 4 threads a row, 64 rows a block). A longer row
// is cut into parts of 4,096 slots, one block each; each part's sums go
// to the workspace and the block that takes the row's last ticket sums
// the row's parts by a fixed pairwise tree (binary-counter cascade per
// thread, then the block's tree), writes the row and puts the ticket back
// to 0.
//
// Histogram (hist_rows_layout): no float sum at all. Every item of a row
// carries the row's weight, so a (row, bin) mass is its count times the
// weight: the counts are integers (shared atomics, exact in any order),
// and the mass is the product taken in f64, exact for counts below 2^29,
// rounded once to f32 - the value that a sum of the weights in f64
// rounded once gives (the plain version's), bit for bit. A block holds
// `rows` whole rows (rows * N <= 8,192 slots, rows * B <= 8,192 counts)
// or, for N > 8,192, one part of 8,192 slots of a row; a part's counts go
// to the row's totals by integer atomics, and the block that takes the
// row's last ticket writes the row and clears its totals and its ticket.
//
// The workspace (the stats' part sums, the tickets and totals, 0 between
// calls) is used only when a row is cut into parts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "masked_reduce.cuh"

namespace {

constexpr int kRowPer = 16;             // stats: live slots a thread folds
constexpr int kRowPart = kThreads * kRowPer;   // stats: 4,096 slots a part
constexpr int kRowBlockItems = 8192;    // histogram: slots a block, at most
constexpr int kRowCountInts = 8192;     // histogram: counts a block holds
constexpr int kMaxRowBins = 4096;       // histogram: bins of the row form
constexpr int kCascade = 32;            // levels of a thread's cascade

struct StatsRows {
  int tr_log;          // log2 of the threads of a unit
  long long parts;     // units of a row
  long long blocks;
};

inline StatsRows stats_rows_layout(long long g, long long n) {
  const long long need = (n + kRowPer - 1) / kRowPer;
  int tr_log = 0;
  while ((1LL << tr_log) < need && (1 << tr_log) < kThreads) ++tr_log;
  const long long parts =
      (1 << tr_log) == kThreads ? (n + kRowPart - 1) / kRowPart : 1;
  const long long per_block = kThreads >> tr_log;
  return StatsRows{tr_log, parts, (g * parts + per_block - 1) / per_block};
}

struct HistRows {
  int rows;            // whole rows of a block (1 when cut into parts)
  long long parts;     // blocks of a row
  long long blocks;
};

inline HistRows hist_rows_layout(long long g, long long n, int nb) {
  if (n > kRowBlockItems) {
    const long long parts = (n + kRowBlockItems - 1) / kRowBlockItems;
    return HistRows{1, parts, g * parts};
  }
  long long rows = kRowBlockItems / (n > 0 ? n : 1);
  if (rows > kRowCountInts / nb) rows = kRowCountInts / nb;
  if (rows > g) rows = g;
  if (rows < 1) rows = 1;
  return HistRows{(int)rows, 1, (g + rows - 1) / rows};
}

// Pushes (a, b) as the next value of a thread's pairwise cascade: st[l]
// holds the sum of a run of 2^l values, merged like a binary counter, so
// the depth of each sum is at most log2 of the values pushed, plus the
// levels left at the end (cascade_total).
__device__ __forceinline__ void cascade_push(float (&st)[kCascade][2],
                                             unsigned k, float a, float b) {
  int l = 0;
  for (unsigned m = k; m & 1u; m >>= 1, ++l) {
    a = __fadd_rn(st[l][0], a);
    b = __fadd_rn(st[l][1], b);
  }
  st[l][0] = a;
  st[l][1] = b;
}

// The cascade's sum after k values (0 if none): its levels from the
// lowest upward, each earlier run added before the later ones.
__device__ __forceinline__ void cascade_total(const float (&st)[kCascade][2],
                                              unsigned k, float& a,
                                              float& b) {
  bool any = false;
  a = 0.0f;
  b = 0.0f;
  for (int l = 0; l < kCascade; ++l) {
    if (!((k >> l) & 1u)) continue;
    a = any ? __fadd_rn(st[l][0], a) : st[l][0];
    b = any ? __fadd_rn(st[l][1], b) : st[l][1];
    any = true;
  }
}

}  // namespace
