// A stable sort of int32 keys with their item indices, for the large-key
// forms of the stats and the histogram (key_sort.cu). Host side only: each
// source that uses it calls ks_sort from its own host code.
//
// Keys lie in [0, 2^bits); the sort is an LSD radix sort of 8-bit digits
// (ceil(bits / 8) passes, at most kSortMaxPasses), each pass a stable
// scatter by one digit, so the result is ordered by (key, item index).
// Scratch, all the caller's:
//   keys_a, idx_a, keys_b, idx_b  int32 [m] each: the passes' outputs, in
//                                 turn (the sorted run ends in a or b);
//   status                        u64 [ks_status_words(m, bits)]: the
//                                 passes' look-back words, written before
//                                 they are read in every call;
//   zeroed                        int32 [kSortZeroed]: the digit totals and
//                                 two counters, 0 between calls (the sort
//                                 leaves them 0).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kSortMaxPasses = 4;
constexpr int kSortRadix = 256;
constexpr int kSortZeroed = kSortMaxPasses * kSortRadix + 2;

struct KeySortScratch {
  int32_t* keys_a;
  int32_t* idx_a;
  int32_t* keys_b;
  int32_t* idx_b;
  unsigned long long* status;
  int32_t* zeroed;
};

// The large-key scratch a wrapper passes as one host array of pointers
// (the slots a kernel does not use may be null).
enum LargeSlot {
  kLgKeys,     // int32 [m]: each item's key, the sort's input
  kLgKeysA,
  kLgIdxA,
  kLgKeysB,
  kLgIdxB,
  kLgStatus,
  kLgZeroed,
  kLgHead,     // int32 [keys]: each key's first sorted position
  kLgPart,     // f32: the segmented reduction's tile partials
  kLgSlots
};

inline KeySortScratch sort_scratch(void* const* lg) {
  return KeySortScratch{static_cast<int32_t*>(lg[kLgKeysA]),
                        static_cast<int32_t*>(lg[kLgIdxA]),
                        static_cast<int32_t*>(lg[kLgKeysB]),
                        static_cast<int32_t*>(lg[kLgIdxB]),
                        static_cast<unsigned long long*>(lg[kLgStatus]),
                        static_cast<int32_t*>(lg[kLgZeroed])};
}

// Bits of the keys [0, n] (n, the largest, is a caller's sentinel).
inline int key_bits(long long n) {
  int b = 1;
  while (b < 31 && (n >> b) != 0) ++b;
  return b;
}

// Sorts keys[0, m) stably; *keys_out / *idx_out point at the sorted keys
// and the item index of each (in the scratch). Returns a CUDA error code.
int ks_sort(const int32_t* keys, int m, int bits, const KeySortScratch& s,
            const int32_t** keys_out, const int32_t** idx_out,
            cudaStream_t stream);
