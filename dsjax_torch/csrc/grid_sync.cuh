// What the persistent cooperative kernels share: the persistent scans K1
// and K4 (scan_persist.cuh) and the matmul-only chain K8 (mm_chain.cu).
// Each runs all T steps in one cooperative launch, one CTA an SM, and
// meets the other CTAs of its grid (or of its direction) at one barrier a
// step; what one CTA wrote for the next step (h) is read by the others only
// through L2 (cp.async.cg), never through L1 or the read-only path.
//
// The barrier, in two halves so that a CTA can issue its next copies
// between them. arrive: __syncthreads, then one thread's release add on a
// counter the wrapper zeroed (cumulative over the CTA's writes, which the
// __syncthreads orders before it); wait: that thread's acquire spin until
// `target` arrivals have been counted, then __syncthreads, after which
// every write made before the arrivals is visible at L2. The spin traps
// after kSpinLimitCycles, so a broken barrier fails the call instead of
// hanging it.

#pragma once

#include <cuda_runtime.h>

namespace dsjax_torch {
namespace grid {

constexpr long long kSpinLimitCycles = 10000000000ll;   // 5 s at one barrier at 2 GHz

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void barrier_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(counter, 1);
}

__device__ __forceinline__ void barrier_wait(const int* counter, int target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (load_acquire(counter) < target) {
      if (clock64() - start > kSpinLimitCycles) __trap();
    }
  }
  __syncthreads();
}

// The device's SM count and the shared memory a CTA may opt in to.
inline cudaError_t device_limits(int* sm_count, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, then refuses a
// grid of n_ctas that the card cannot hold at once (another process
// holding SMs, say) with cudaErrorCooperativeLaunchTooLarge: a cooperative
// launch must never wait on a CTA that is not resident.
template <typename Kernel>
cudaError_t fit_coresident(Kernel kernel, int threads, int smem, int n_ctas, int sm_count) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  return per_sm * sm_count < n_ctas ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace grid
}  // namespace dsjax_torch
