// The step product of the reverse scans for Hopper, sm_90a: one CTA computes
//   out[r, u] = sum_{k < k_width} a[r, k] * b[u, k]
// for r < n_rows <= kRows and u < n_units <= kUnits, a and b in the working
// type (bfloat16 or float), the sums in float32. In the LSTM reverse scan
// (lstm_bwd.cu) a is the previous step's dgates, one row per batch row, and
// b the CTA's rows of W_hh^T, one contiguous row of 4H weights per hidden
// unit: out is dgates . W_hh for every batch row of the block at once. The K
// width is a parameter, so the GRU's (dr, dz, dn*r) . W_hh over 3H takes the
// same product.
//
// Tiles. Chunks of kChunkBytes of every row of a and b are staged in shared
// memory with 16-byte cp.async, in the working type, kStages deep (one chunk
// multiplied while the next ones are in flight); rows past n_rows or n_units
// and columns past k_width are zero-filled by the copy itself. A row is
// padded by 16 bytes, so the 8 rows that one ldmatrix (or one LDS.128 of
// the f32 path) reads land on 8 distinct 16-byte bank groups.
//
// bfloat16: mma.sync.aligned.m16n8k16.row.col with f32 accumulators, fed by
// ldmatrix: a is the row-major 16x16 A tile, b's rows (one per unit, K
// contiguous) are the "col" B operand as they lie. Each of the kWarps warps
// takes every 16-row tile of a and every 8-unit tile of b for its own k16
// steps (the K split), so a and b are each read from shared memory once.
// float32: the same staged tiles on CUDA cores (TF32 would round the f32
// sums past the reverse scan's tolerance): a thread holds a 4 x kUnits/4
// block of rows x units in registers and walks its K split 4 columns (one
// LDS.128 per row and unit) at a time. Either way the K split's partial
// sums are reduced through shared memory, in a fixed order, into out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace dsjax_torch {
namespace scan_mma {

constexpr int kRows = 64;                 // rows of a per product
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kChunkBytes = 512;          // of one row, per stage
constexpr int kPitch = kChunkBytes + 16;  // padded row in shared memory

template <typename T, int kUnits>
struct Shape {
  static_assert(kUnits % 16 == 0, "units come in pairs of n8 tiles");
  static constexpr int kChunk = kChunkBytes / static_cast<int>(sizeof(T));  // K columns a stage
  static constexpr int kStageBytes = (kRows + kUnits) * kPitch;
  // bf16: one K split a warp; f32: two row halves of 32 x four K splits
  static constexpr int kSplits = sizeof(T) == 2 ? kWarps : kWarps / 2;
  static constexpr int kPartBytes = kSplits * kRows * kUnits * 4;
  // the stages, reused for the partial sums once the last chunk is read
  static constexpr int kSmemBytes =
      kStages * kStageBytes > kPartBytes ? kStages * kStageBytes : kPartBytes;
  static_assert((kRows + kUnits) * (kChunkBytes / 16) % kThreads == 0,
                "a stage is whole 16-byte copies of every thread");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b on one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns [k0, k0 + kChunk) of every row of a and b into one stage.
template <typename T, int kUnits>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const T* a, int lda, int n_rows,
                                            const T* b, int ldb, int n_units, int k0,
                                            int k_width) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = kChunkBytes / 16;  // 16-byte copies a row
  constexpr int kCopies = (kRows + kUnits) * kVecs / kThreads;
#pragma unroll
  for (int it = 0; it < kCopies; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kVecs;
    const int v = i % kVecs;
    const int k = k0 + v * kVec;
    const bool is_a = r < kRows;
    const int row = is_a ? r : r - kRows;
    const bool valid = k < k_width && row < (is_a ? n_rows : n_units);
    const T* src = valid ? (is_a ? a + static_cast<size_t>(row) * lda
                                 : b + static_cast<size_t>(row) * ldb) + k
                         : a;
    cp_async16(buf + r * kPitch + v * 16, src, valid);
  }
}

template <typename T, int kUnits>
struct Acc;

template <int kUnits>
struct Acc<__nv_bfloat16, kUnits> {
  float v[kRows / 16][kUnits / 8][4];
};

template <int kUnits>
struct Acc<float, kUnits> {
  float v[4][kUnits / 4];
};

// One staged chunk on tensor cores; k_left > 0 columns of it are valid.
template <int kUnits>
__device__ __forceinline__ void chunk_product(const unsigned char* buf,
                                              Acc<__nv_bfloat16, kUnits>& acc, int n_rows,
                                              int k_left) {
  constexpr int kSteps = Shape<__nv_bfloat16, kUnits>::kChunk / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_steps = min(kSteps, (k_left + 15) / 16);
  const int m_tiles = (n_rows + 15) / 16;
  const uint32_t a_s = smem_u32(buf);
  const uint32_t b_s = a_s + kRows * kPitch;
  for (int ks = warp; ks < n_steps; ks += kWarps) {
    const uint32_t kb = ks * 32;  // bytes into the row
    uint32_t bf[kUnits / 8][2];
#pragma unroll
    for (int np = 0; np < kUnits / 16; ++np) {
      // matrices (units 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
      uint32_t r[4];
      ldmatrix_x4(b_s + (np * 16 + lane % 8 + (lane / 16) * 8) * kPitch + kb +
                      ((lane / 8) % 2) * 16,
                  r);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kRows / 16; ++mt) {
      if (mt < m_tiles) {
        // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        uint32_t af[4];
        ldmatrix_x4(a_s + (mt * 16 + lane % 16) * kPitch + kb + (lane / 16) * 16, af);
#pragma unroll
        for (int nt = 0; nt < kUnits / 8; ++nt) mma_bf16(acc.v[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
}

// One staged chunk on CUDA cores. Lanes: 8 row groups x 4 unit groups; a
// thread's rows are half * 32 + rg + 8 i and its units ug + 4 q, so the 8
// rows (and the 4 units) one load instruction reads are neighbours.
template <int kUnits>
__device__ __forceinline__ void chunk_product(const unsigned char* buf, Acc<float, kUnits>& acc,
                                              int n_rows, int k_left) {
  constexpr int kChunk = Shape<float, kUnits>::kChunk;
  constexpr int kPer = kChunk / Shape<float, kUnits>::kSplits;
  constexpr int kP = kPitch / 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = warp % 2;
  const int split = warp / 2;
  if (half * 32 >= n_rows) return;
  const float* a_s = reinterpret_cast<const float*>(buf) + (half * 32 + lane % 8) * kP;
  const float* b_s = reinterpret_cast<const float*>(buf + kRows * kPitch) + (lane / 8) * kP;
  const int k_end = min((split + 1) * kPer, k_left);
  for (int k = split * kPer; k < k_end; k += 4) {
    float4 av[4];
    float4 bv[kUnits / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a_s + 8 * i * kP + k);
#pragma unroll
    for (int q = 0; q < kUnits / 4; ++q)
      bv[q] = *reinterpret_cast<const float4*>(b_s + 4 * q * kP + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < kUnits / 4; ++q) {
        float s = acc.v[i][q];
        s = fmaf(av[i].x, bv[q].x, s);
        s = fmaf(av[i].y, bv[q].y, s);
        s = fmaf(av[i].z, bv[q].z, s);
        acc.v[i][q] = fmaf(av[i].w, bv[q].w, s);
      }
    }
  }
}

template <int kUnits>
__device__ __forceinline__ void store_partials(const Acc<__nv_bfloat16, kUnits>& acc,
                                               float* part) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = part + warp * kRows * kUnits;
#pragma unroll
  for (int mt = 0; mt < kRows / 16; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kUnits / 8; ++nt) {
      const int row = mt * 16 + lane / 4;
      const int col = nt * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p + row * kUnits + col) =
          make_float2(acc.v[mt][nt][0], acc.v[mt][nt][1]);
      *reinterpret_cast<float2*>(p + (row + 8) * kUnits + col) =
          make_float2(acc.v[mt][nt][2], acc.v[mt][nt][3]);
    }
  }
}

template <int kUnits>
__device__ __forceinline__ void store_partials(const Acc<float, kUnits>& acc, float* part) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = part + (warp / 2) * kRows * kUnits;
  const int row0 = (warp % 2) * 32 + lane % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < kUnits / 4; ++q)
      p[(row0 + 8 * i) * kUnits + lane / 8 + 4 * q] = acc.v[i][q];
  }
}

// out (kRows, kUnits) f32 in shared memory <- a . b^T as above. smem holds
// Shape<T, kUnits>::kSmemBytes (16-byte aligned) and must not overlap out.
// All kThreads threads of the CTA call it; it begins and ends with a
// barrier-complete state, so the caller may read out right after it.
template <typename T, int kUnits>
__device__ void product(const T* __restrict__ a, int lda, int n_rows, const T* __restrict__ b,
                        int ldb, int n_units, int k_width, unsigned char* smem,
                        float* __restrict__ out) {
  using S = Shape<T, kUnits>;
  const int n_chunks = (k_width + S::kChunk - 1) / S::kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      stage_chunk<T, kUnits>(smem + c * S::kStageBytes, a, lda, n_rows, b, ldb, n_units,
                             c * S::kChunk, k_width);
    cp_async_commit();
  }
  Acc<T, kUnits> acc = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk c - 1 is read by all
    const int next = c + kStages - 1;
    if (next < n_chunks)
      stage_chunk<T, kUnits>(smem + (next % kStages) * S::kStageBytes, a, lda, n_rows, b, ldb,
                             n_units, next * S::kChunk, k_width);
    cp_async_commit();
    chunk_product<kUnits>(smem + (c % kStages) * S::kStageBytes, acc, n_rows,
                          k_width - c * S::kChunk);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  store_partials<kUnits>(acc, part);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kUnits; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < S::kSplits; ++p) s += part[p * kRows * kUnits + i];
    out[i] = s;
  }
  __syncthreads();
}

}  // namespace scan_mma
}  // namespace dsjax_torch
