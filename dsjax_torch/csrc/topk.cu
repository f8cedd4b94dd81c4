// Exact batched top-k for Hopper, sm_90a (K6).
//
// Replaces dsjax/ops/topk_pallas.py:topk_pallas (body _topk_kernel): the
// top k of each row of (B, N) float32 scores, as (values, int32 indices),
// in jax.lax.top_k's order (score descending, ties to the lower index).
// The device beam search runs it on its candidate pool every step, e.g.
// (16, 3840) -> 128 at width 128, where many slots tie at -1e30.
//
// The TPU kernel's shape came from the TPU's 128 lanes: rows of 128
// bitonic-sorted with lane rolls, merged by a halving tree that keeps each
// pair's top 128 (hence k <= 128 there). None of that carries over.
//
// What bounds it on this card. A beam pool row is 15 KB; the whole batch
// is a few hundred KB, so no bandwidth limit is near: the cost is the
// sort's log2(n)(log2(n)+1)/2 dependent stages (78 at n = 4096), each a
// pass over shared memory and a block barrier, plus the launch.
//
// What the design does about it. One CTA per row: the row goes into
// dynamic shared memory as (score, index) pairs padded to a power of two
// with (-inf, index >= N), is sorted by a block-wide bitonic network
// (bitonic.cuh), and the first k pairs are written. A real -inf score
// still precedes every pad, whose index is larger. Any k <= N is exact
// (no halving tree), up to N = 16384 pairs = 128 KB of shared memory.
// Sorting only the top k (a bitonic top-k with merges that drop halves)
// is later work.

#include <cuda_runtime.h>

#include <math.h>

#include "bitonic.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kMaxN = 16384;

__global__ void topk_kernel(const float* __restrict__ scores, float* __restrict__ values,
                            int* __restrict__ indices, int n, int n_pad, int k) {
  extern __shared__ float smem[];
  float* s = smem;                                   // (n_pad,) scores
  int* ix = reinterpret_cast<int*>(smem + n_pad);    // (n_pad,) indices
  const float* row = scores + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    s[i] = i < n ? row[i] : -INFINITY;
    ix[i] = i;
  }
  __syncthreads();
  block_bitonic_sort(s, ix, n_pad);
  float* v_out = values + static_cast<size_t>(blockIdx.x) * k;
  int* i_out = indices + static_cast<size_t>(blockIdx.x) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    v_out[i] = s[i];
    i_out[i] = ix[i];
  }
}

}  // namespace

extern "C" int dsjax_torch_topk(const void* scores, void* values, void* indices, int n_b,
                                int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || k > n || n_b < 1) return cudaErrorInvalidValue;
  int n_pad = 1;
  while (n_pad < n) n_pad <<= 1;
  const int threads = n_pad >= 2048 ? 1024 : (n_pad / 2 >= 32 ? n_pad / 2 : 32);
  const size_t smem = static_cast<size_t>(n_pad) * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  topk_kernel<<<n_b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(values), static_cast<int*>(indices),
      n, n_pad, k);
  return cudaGetLastError();
}
