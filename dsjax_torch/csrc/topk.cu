// Exact batched top-k for Hopper, sm_90a (K6).
//
// Replaces dsjax/ops/topk_pallas.py:topk_pallas (body _topk_kernel): the
// top k of each row of (B, N) float32 scores, as (values, int32 indices),
// in jax.lax.top_k's order: the IEEE total order of the scores descending
// (so -0.0 below +0.0, subnormals kept), ties to the lower index. The device
// beam search runs it on its candidate pool every step, e.g. (16, 3840) ->
// 128 at width 128, where half the slots tie at -1e30.
//
// The TPU kernel's shape came from the TPU's 128 lanes: rows of 128
// bitonic-sorted with lane rolls, merged by a halving tree that keeps each
// pair's top 128 (hence k <= 128 there). None of that carries over.
//
// What bounds it on this card. A beam pool row is 15 KB; the whole batch
// is a few hundred KB, so no bandwidth limit is near: the cost is the
// number of dependent block-wide steps (each a barrier) and the launch. A
// full sort of the padded row takes log2(n)(log2(n)+1)/2 of them (78 at
// n = 4096); this kernel selects instead, in about a dozen.
//
// What the design does about it. One CTA per row. Every score becomes a
// uint32 key that orders like the total order (order_key), so "greater key"
// is "earlier in the output"; each thread holds a contiguous strip of at
// most kMaxPer keys in registers, so thread order is index order. Then
// radix_select.cuh's block selection (shared with K7):
//   1. a radix select of the k-th key, 8 bits a pass, at most 4 passes;
//   2. one block-wide exclusive scan that compacts the k survivors in index
//      order into shared memory as 64-bit (key, ~index) words, whose
//      descending order is the output order;
//   3. only the survivors are ordered: up to kRankMaxK, each survivor's rank
//      is the count of survivors above it (k compares a survivor, no
//      barrier); above, a bitonic sort of next_pow2(k) words. Values come
//      back from the keys bit for bit, so -0.0 stays -0.0.
// Any k <= N <= kMaxN = 16384 is exact; the sort case holds 16384 words
// (128 KB) of dynamic shared memory at most.

#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "radix_select.cuh"

namespace {

constexpr int kMaxN = 16384;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = kMaxN / kMaxThreads;   // keys a thread at most: 16
constexpr int kKeysPerThread = 4;              // the strip aimed at when N is small
// survivors are ranked by counting up to this k, bitonic-sorted above: at
// k = 256 a ranking thread makes 256 broadcast compares, against the 36
// barrier stages of a 256-word sort
constexpr int kRankMaxK = 256;

using namespace dsjax_torch::radix;

// Sorts n (a power of two) words descending, every thread of the block
// taking part; returns after a barrier.
__device__ void bitonic_desc(uint64_t* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));     // bit `stride` of i is clear
        const uint64_t x = a[i], y = a[i + stride];
        if ((x < y) == ((i & size) == 0)) {           // descending blocks where bit `size` is clear
          a[i] = y;
          a[i + stride] = x;
        }
      }
      __syncthreads();
    }
  }
}

// One CTA a row; `per` keys a thread (per * blockDim >= n).
__global__ void __launch_bounds__(kMaxThreads)
topk_kernel(const float* __restrict__ scores, float* __restrict__ values,
            int* __restrict__ indices, int n, int k, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);   // k words, next_pow2(k) to sort
  __shared__ int hist[kPasses][kBins];
  __shared__ uint32_t warp_total[32];
  __shared__ Select sel;

  const int base = threadIdx.x * per;
  const int n_mine = max(0, min(per, n - base));
  const float* row = scores + static_cast<size_t>(blockIdx.x) * n;
  uint32_t key[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) key[j] = j < n_mine ? order_key(row[base + j]) : 0u;
  for (int i = threadIdx.x; i < kPasses * kBins; i += blockDim.x) (&hist[0][0])[i] = 0;
  if (threadIdx.x == 0) sel = Select{0u, 0u, k, 0};
  const int n_surv = k <= kRankMaxK ? k : 1 << (32 - __clz(k - 1));
  for (int i = k + threadIdx.x; i < n_surv; i += blockDim.x) surv[i] = 0;   // below any survivor
  __syncthreads();

  // 1. radix select; 2. compaction: every key above the prefix, the first
  // k_rem equal to it
  block_select(key, per, n_mine, hist, &sel);
  const Select s = sel;
  const uint32_t excl = block_exclusive_scan(survivor_counts(key, n_mine, s), warp_total);
  compact(key, n_mine, base, s, k, excl, surv);
  __syncthreads();

  // 3. order the survivors
  float* v_out = values + static_cast<size_t>(blockIdx.x) * k;
  int* i_out = indices + static_cast<size_t>(blockIdx.x) * k;
  if (k <= kRankMaxK) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const uint64_t w = surv[i];
      int r = 0;
      for (int q = 0; q < k; ++q) r += surv[q] > w;
      v_out[r] = key_value(static_cast<uint32_t>(w >> 32));
      i_out[r] = word_index(w);
    }
  } else {
    bitonic_desc(surv, n_surv);
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const uint64_t w = surv[i];
      v_out[i] = key_value(static_cast<uint32_t>(w >> 32));
      i_out[i] = word_index(w);
    }
  }
}

}  // namespace

extern "C" int dsjax_torch_topk(const void* scores, void* values, void* indices, int n_b,
                                int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || k > n || n_b < 1) return cudaErrorInvalidValue;
  const int want = (n + kKeysPerThread - 1) / kKeysPerThread;
  const int threads = std::min(kMaxThreads, std::max(32, (want + 31) / 32 * 32));
  const int per = (n + threads - 1) / threads;
  int n_surv = k;
  if (k > kRankMaxK) {
    n_surv = 1;
    while (n_surv < k) n_surv <<= 1;
  }
  const size_t smem = static_cast<size_t>(n_surv) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  topk_kernel<<<n_b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(values), static_cast<int*>(indices),
      n, k, per);
  return cudaGetLastError();
}
