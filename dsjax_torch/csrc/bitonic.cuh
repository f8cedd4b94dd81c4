// Block-wide bitonic sort of (score, index) pairs in shared memory, in the
// order of dsjax's Pallas top-k: score descending, ties to the lower index
// (dsjax/ops/topk_pallas.py:81-84). The fused beam scan (K7, beam_scan.cu)
// sorts its candidates with it, as dsjax's fused scan does.
//
// The comparator compares the floats, as dsjax's does: it assumes no NaN,
// and -0.0 ties with +0.0 (the exact top-k, K6 in topk.cu, follows
// jax.lax.top_k's total order instead, where -0.0 ranks below +0.0).
// Indices are distinct, so the order is total and the result unique under
// any number of equal scores.

#pragma once

#include <cuda_runtime.h>

namespace dsjax_torch {

__device__ __forceinline__ bool topk_before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sorts n pairs (n a power of two) into topk_before order, with every
// thread of the block taking part; the caller has synchronised after
// filling s and idx. Returns after a __syncthreads, so the sorted pairs
// are visible to the whole block.
__device__ inline void block_bitonic_sort(float* s, int* idx, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lj = __ffs(j) - 1;
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        // pair p: i has bit lj clear, partner l = i + j
        const int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
        const int l = i + j;
        const float si = s[i], sl = s[l];
        const int ii = idx[i], il = idx[l];
        // blocks of size k alternate: ascending blocks put the pair in
        // topk_before order, descending ones in the reverse
        const bool ascending = (i & k) == 0;
        if (topk_before(sl, il, si, ii) == ascending) {
          s[i] = sl;
          s[l] = si;
          idx[i] = il;
          idx[l] = ii;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace dsjax_torch
