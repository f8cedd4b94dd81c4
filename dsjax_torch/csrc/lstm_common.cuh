// Helpers shared by the scan kernels (lstm_*.cu, gru_*.cu): the working
// types float and bfloat16 with float32 arithmetic, and the 2-wide loads
// and stores of a unit pair that the tensor-core scans' epilogues make.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace dsjax_torch {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two neighbouring elements, from or to a boundary of two elements.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// A unit pair as it lies in the working type, held across a step product
// (a bfloat16 pair takes one register), then widened by to_f32x2.
template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 load2_raw(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ __nv_bfloat162 load2_raw(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}
__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Time index of scan step `step` for a direction that scans backwards in
// time when `reverse` is set.
__device__ __forceinline__ int time_of(int step, int n_t, bool reverse) {
  return reverse ? n_t - 1 - step : step;
}

}  // namespace dsjax_torch
