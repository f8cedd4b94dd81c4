// The exact selection that K6 (topk.cu) and K7's block path (beam_scan.cu)
// share: the k greatest of a row of uint32 keys, ties to the lower index,
// in one CTA, without sorting the row. The caller maps its scores to keys
// whose unsigned order is the order it wants (K6: jax.lax.top_k's total
// order, order_key; K7: its float order, where -0.0 ties with +0.0,
// order_key of the score with -0.0 made +0.0), and holds them in
// registers, a strip of consecutive indices a thread, so that thread order
// is index order.
//   1. Radix select of the k-th key, most significant digit first, 8 bits
//      a pass into a 256-bin shared histogram of the keys
//      that still match the digits fixed so far; one warp finds the bin
//      that holds the k-th key, and the loop stops once that bin is taken
//      whole (at most 4 passes, two barriers each). A beam pool puts many
//      keys in one bin, so each warp first groups its lanes by digit
//      (__match_any_sync) and one lane a group adds the group's count.
//   2. Compaction: every key above the selected prefix is taken and, of
//      the keys equal to it, the first k_rem in index order, by one
//      exclusive scan of each thread's (above, equal) counts packed in one
//      word. The survivors become 64-bit (key, ~index) words, whose
//      descending order is the output order.
//   3. The caller orders the survivors (by counting, or a sort).

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace dsjax_torch {
namespace radix {

constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;
constexpr uint32_t kFull = 0xffffffffu;

static_assert(kBins == 32 * 8, "the bin search gives each lane 8 bins");

// The key of a float whose unsigned order is the IEEE total order.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ ((b & 0x80000000u) ? kFull : 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float(key ^ ((key & 0x80000000u) ? 0x80000000u : kFull));
}

// The digits fixed so far: keys with (key & mask) == prefix are still open,
// and k_rem of them are still to take; done once they are taken whole.
struct Select {
  uint32_t prefix, mask;
  int k_rem, done;
};

// Step 1. Every thread calls it with its strip (n_mine <= per
// <= kMaxPer valid keys); hist (kPasses x kBins) must be zero and *sel
// {0, 0, k, 0}, both visible to every thread (after a barrier). Returns
// after a barrier, with *sel final.
template <int kMaxPer>
__device__ void block_select(const uint32_t (&key)[kMaxPer], int per, int n_mine,
                             int (*hist)[kBins], Select* sel) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int p = 0; p < kPasses; ++p) {
    const Select s = *sel;
    if (s.done) break;                                // uniform: every thread read one sel
    const int shift = 32 - kRadixBits * (p + 1);
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      if (j < per) {                                  // uniform, so every lane takes the match
        const bool open = j < n_mine && (key[j] & s.mask) == s.prefix;
        const uint32_t digit = open ? (key[j] >> shift) & (kBins - 1) : kBins;
        const uint32_t peers = __match_any_sync(kFull, digit);
        if (open && lane == __ffs(peers) - 1) atomicAdd(&hist[p][digit], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins kBins - 1 - 8 l - q, q = 0..7: the bins in
      // descending order across the warp
      int h[8];
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        h[q] = hist[p][kBins - 1 - 8 * lane - q];
        sum += h[q];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int above = incl - sum;                         // open keys in higher bins
      if (above < s.k_rem && s.k_rem <= incl) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (above + h[q] >= s.k_rem) {
            const uint32_t digit = kBins - 1 - 8 * lane - q;
            const int k_rem = s.k_rem - above;
            *sel = Select{s.prefix | (digit << shift), s.mask | (uint32_t(kBins - 1) << shift),
                          k_rem, h[q] == k_rem};
            break;
          }
          above += h[q];
        }
      }
    }
    __syncthreads();
  }
}

// A thread's (above, equal) counts of its strip against the selection,
// packed in one word (both at most 2^16 - 1).
template <int kMaxPer>
__device__ __forceinline__ uint32_t survivor_counts(const uint32_t (&key)[kMaxPer], int n_mine,
                                                    const Select& s) {
  uint32_t gt = 0, eq = 0;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (j < n_mine) {
      const uint32_t m = key[j] & s.mask;
      gt += m > s.prefix;
      eq += m == s.prefix;
    }
  }
  return (gt << 16) | eq;
}

__device__ __forceinline__ uint32_t warp_exclusive_scan(uint32_t v) {
  const int lane = threadIdx.x % 32;
  uint32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  return incl - v;
}

// The exclusive prefix of v over the block in thread order; warp_total is
// 32 words of shared memory. Every thread calls it; returns after a
// barrier, and the caller passes another before warp_total is reused.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const uint32_t excl = warp_exclusive_scan(v);
  if (lane == 31) warp_total[warp] = excl + v;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < static_cast<int>(blockDim.x / 32) ? warp_total[lane] : 0u;
    warp_total[lane] = warp_exclusive_scan(w);
  }
  __syncthreads();
  return warp_total[warp] + excl;
}

// Step 2: the thread's survivors of its strip (indices base + j) as
// (key, ~index) words into surv, from the exclusive prefix `excl` of the
// packed counts: above the prefix at [0, k - k_rem), the first k_rem equal
// to it after them.
template <int kMaxPer>
__device__ __forceinline__ void compact(const uint32_t (&key)[kMaxPer], int n_mine, int base,
                                        const Select& s, int k, uint32_t excl, uint64_t* surv) {
  const int c_gt = k - s.k_rem;
  int gt_pos = static_cast<int>(excl >> 16);
  int eq_pos = static_cast<int>(excl & 0xffffu);
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (j < n_mine) {
      const uint32_t m = key[j] & s.mask;
      const uint64_t word = (static_cast<uint64_t>(key[j]) << 32) | (kFull - (base + j));
      if (m > s.prefix) {
        surv[gt_pos++] = word;
      } else if (m == s.prefix) {
        if (eq_pos < s.k_rem) surv[c_gt + eq_pos] = word;
        ++eq_pos;
      }
    }
  }
}

// The index a (key, ~index) word holds.
__device__ __forceinline__ int word_index(uint64_t w) {
  return static_cast<int>(kFull - static_cast<uint32_t>(w));
}

}  // namespace radix
}  // namespace dsjax_torch
