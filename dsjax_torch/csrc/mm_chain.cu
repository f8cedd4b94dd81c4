// The matmul-only chain (K8) for Hopper, sm_90a: the floor of one step of
// the recurrent scans, without their gate math.
//
// Replaces the Pallas kernel _mm_kernel of tools/lstm_microbench.py (built
// in its main): per step t, z = h . W + xp[t] over all 4H columns in f32,
// then h <- z[:, :H] rounded to bf16. W is (H, 4H), xp (T, B, 4H), h (B, H),
// all bf16. The full (B, 4H) product of every step is written to a scratch
// buffer (bf16), so the chain does the work of one step of K1 (every gate
// column computed and stored), not just the H columns it carries on.
//
// What bounds it on this card. A step is 2 * B * H * 4H FLOP (537 MFLOP at
// B = 64, H = 1024): 0.54 us at the 989 TFLOP/s bf16 tensor-core peak, while
// it reads W (8 MB, from L2 after the first step) and xp[t] (0.5 MB). The
// steps are dependent, so each pays a launch and a pass over W from L2; the
// arithmetic alone would take a fraction of that.
//
// What the design does about it. The tensor cores through the warp-level
// WMMA interface (16 x 16 x 16 bf16 tiles, f32 accumulation): one launch per
// step, each CTA owning kCols = 32 output columns for every batch row, 128
// CTAs at H = 1024. The CTA stages h[:, k0:k0+kChunkK] and the matching rows
// of its W columns in shared memory with asynchronous 16-byte copies (rows
// padded by kPad elements against bank conflicts), then warp w multiplies the
// 16 x 16 tiles (row tile i, column tile w % 2) for i = w / 2, w / 2 + 4, ...
// from there: fragments loaded straight from device memory gather 2-byte
// elements with strided loads (27 us a step on an H100), and staging through
// registers waits out each load's L2 latency in turn (19 us; PERF.md), while
// cp.async's copies are all in flight at once. The CTA then adds xp[t],
// writes z and, for columns below H, the next h. h is double-buffered in
// device memory with the launch boundary as the barrier. Double-buffered
// staging, TMA, wgmma and a persistent form with W resident in shared memory
// are the work of the PR that redesigns K1.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;
constexpr int kCols = 32;                        // output columns per CTA
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColTiles = kCols / kTile;         // 2
constexpr int kRowStride = kWarps / kColTiles;   // row tiles between a warp's tiles
constexpr int kChunkK = 256;                     // k staged in shared memory at a time
constexpr int kPad = 8;                          // bf16 elements of padding per row
constexpr int kLdH = kChunkK + kPad;             // row stride of the staged h
constexpr int kLdW = kCols + kPad;               // row stride of the staged W
constexpr int kMaxRowTiles = 8;                  // B <= 128

// One step.
//   xp     (T, B, 4H)   h_in (B, H)   w (H, 4H)
//   z      (B, 4H)      the step's full product, overwritten every step
//   h_out  (B, H)       z[:, :H]
// Shared memory: h chunk (B, kLdH) and W chunk (kChunkK, kLdW) in bf16, then
// the f32 sums (B, kCols) in the same space.
__global__ void __launch_bounds__(kThreads)
mm_step_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ h_in, __nv_bfloat16* __restrict__ h_out,
               __nv_bfloat16* __restrict__ z, int n_b, int n_h, int t) {
  extern __shared__ __align__(32) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = h_s + static_cast<size_t>(n_b) * kLdH;
  float* acc_s = reinterpret_cast<float*>(smem);
  const int g4 = 4 * n_h;
  const int n0 = blockIdx.x * kCols;
  const int warp = threadIdx.x / 32;
  const int col_tile = warp % kColTiles;
  const int row_tiles = n_b / kTile;

  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> c[kMaxRowTiles / kRowStride];
#pragma unroll
  for (int r = 0; r < kMaxRowTiles / kRowStride; ++r) wmma::fill_fragment(c[r], 0.f);
  for (int k0 = 0; k0 < n_h; k0 += kChunkK) {
    const int nk = min(kChunkK, n_h - k0);
    // asynchronous 16-byte copies (8 bf16 of a row), all in flight at once
    for (int e = threadIdx.x; e < n_b * (nk / 8); e += kThreads) {
      const int b = e / (nk / 8);
      const int q = (e % (nk / 8)) * 8;
      __pipeline_memcpy_async(h_s + b * kLdH + q, h_in + static_cast<size_t>(b) * n_h + k0 + q,
                              16);
    }
    for (int e = threadIdx.x; e < nk * (kCols / 8); e += kThreads) {
      const int k = e / (kCols / 8);
      const int q = (e % (kCols / 8)) * 8;
      __pipeline_memcpy_async(w_s + k * kLdW + q, w + static_cast<size_t>(k0 + k) * g4 + n0 + q,
                              16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRowTiles / kRowStride; ++r) {
      const int i = warp / kColTiles + r * kRowStride;
      if (i < row_tiles) {
        for (int k = 0; k < nk; k += kTile) {
          wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, h_s + i * kTile * kLdH + k, kLdH);
          wmma::load_matrix_sync(b, w_s + k * kLdW + col_tile * kTile, kLdW);
          wmma::mma_sync(c[r], a, b, c[r]);
        }
      }
    }
    __syncthreads();                  // the chunk is read before the next overwrites it
  }
#pragma unroll
  for (int r = 0; r < kMaxRowTiles / kRowStride; ++r) {
    const int i = warp / kColTiles + r * kRowStride;
    if (i < row_tiles) {
      wmma::store_matrix_sync(acc_s + i * kTile * kCols + col_tile * kTile, c[r], kCols,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  const __nv_bfloat16* xp_t = xp + static_cast<size_t>(t) * n_b * g4;
  for (int e = threadIdx.x; e < n_b * kCols; e += kThreads) {
    const int b = e / kCols;
    const int col = n0 + e % kCols;
    const __nv_bfloat16 v = __float2bfloat16_rn(
        acc_s[e] + __bfloat162float(xp_t[static_cast<size_t>(b) * g4 + col]));
    z[static_cast<size_t>(b) * g4 + col] = v;
    if (col < n_h) h_out[static_cast<size_t>(b) * n_h + col] = v;
  }
}

}  // namespace

// Runs all n_t steps on `stream`. h_buf is (2, B, H) bf16: slot 0 holds the
// initial h, and the final h is left in slot n_t % 2. z is the (B, 4H) bf16
// scratch, holding the last step's product at the end. Requires n_b to be a
// multiple of 16 and at most 128, n_h a multiple of 16, and all pointers
// 32-byte aligned. Returns a cudaError_t: the first error any launch
// reported, or cudaSuccess.
extern "C" int dsjax_torch_mm_chain(const void* xp, const void* w, void* h_buf, void* z,
                                    int n_t, int n_b, int n_h, void* stream) {
  if (n_b % kTile != 0 || n_b > kMaxRowTiles * kTile || n_h % kTile != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t staged = (static_cast<size_t>(n_b) * kLdH + kChunkK * kLdW) * 2;
  const size_t sums = static_cast<size_t>(n_b) * kCols * sizeof(float);
  const size_t smem = staged > sums ? staged : sums;
  cudaError_t err = cudaFuncSetAttribute(
      mm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t state = static_cast<size_t>(n_b) * n_h;
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(h_buf);
  for (int t = 0; t < n_t; ++t) {
    mm_step_kernel<<<(4 * n_h) / kCols, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(w),
        h + (t & 1) * state, h + ((t + 1) & 1) * state, static_cast<__nv_bfloat16*>(z), n_b,
        n_h, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
