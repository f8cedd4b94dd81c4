// What the kernels that feed wgmma through the tensor memory accelerator
// share: the matmul-only chain K8 (mm_chain.cu) and K3's resident route
// (lstm_bwd.cu). Operands lie in shared memory K-major in 128-byte rows of
// 64 bf16 (a K atom), under the 128-byte swizzle (16-byte chunk q of row r
// at chunk q ^ (r % 8) of the row), in blocks that start on 1024 bytes;
// tensor copies (TMA) write that layout themselves, and each completes on
// an mbarrier in shared memory. The waits give up after
// grid::kSpinLimitCycles and the kernel traps, so a lost copy fails the
// call instead of hanging it.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <stdint.h>

#include "grid_sync.cuh"

namespace dsjax_torch {
namespace hopper {

constexpr int kAtomK = 64;                     // bf16 of K in one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kGroupBytes = 8 * kRowBytes;     // an 8-row swizzle group: wgmma's SBO
constexpr int kAlign = 1024;                   // a swizzle group starts on 1024 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk q (0-7) of row r in a block of 128-byte
// rows under the 128-byte swizzle (the block starts on kAlign)
__device__ __forceinline__ int swizzled(int r, int q) {
  return r * kRowBytes + ((q ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// arms the barrier for tensor copies of `bytes` in all
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the phase of the given parity to complete; false where it has
// not after grid::kSpinLimitCycles
__device__ __forceinline__ bool mbar_wait_bounded(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return true;
    if (clock64() - start > grid::kSpinLimitCycles) return false;
  }
}

// mbar_wait_bounded, trapping where the phase never completes. Not between
// asynchronous wgmma products: a trap there makes ptxas serialize every
// wgmma of the kernel, so such a caller traps once its products are done.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (!mbar_wait_bounded(bar, parity)) __trap();
}

// one tensor copy: the box at (x, y) of the map into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's descriptor of a K-major operand in that layout: start address,
// leading offset 1 (unused by swizzled K-major), stride offset one 8-row
// group, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once at run time (no link against libcuda).
inline cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The map of a row-major (rows, cols) bf16 matrix at `base` whose boxes are
// box_cols (one K atom, 64) columns of box_rows rows, written to shared
// memory in the 128-byte swizzle; columns past `cols` come as zeros.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base, uint64_t cols,
                                   uint64_t rows, uint32_t box_rows) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {kAtomK, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a row-major (planes, rows, cols) f32 tensor at `base` whose
// boxes are box_cols columns of box_rows rows of one plane, written to
// shared memory densely, unswizzled; rows past `rows` and columns past
// `cols` come as zeros.
inline cudaError_t f32_tensor_map_3d(CUtensorMap* map, const void* base, uint64_t cols,
                                     uint64_t rows, uint64_t planes, uint32_t box_cols,
                                     uint32_t box_rows) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * 4, rows * cols * 4};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace dsjax_torch
