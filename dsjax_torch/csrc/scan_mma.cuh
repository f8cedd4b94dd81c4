// The step product of the scan kernels for Hopper, sm_90a: one CTA computes
//   out[r, u] = sum_{k < k_width} a[r, k] * b[u, k]
// for r < n_rows <= kRows and u < kCols columns, a and b in the working type
// (bfloat16 or float), the sums in float32. Two forms, one code path:
//   - the reverse scans (lstm_bwd.cu K3, gru_bwd.cu K5): kCols = 16 hidden
//     units, 4 stages. a is the previous step's dgates (or the GRU's
//     exchanged dG), one row per batch row, and b the CTA's rows of W_hh^T,
//     one contiguous row of 4H (3H) weights per unit: out is dgates . W_hh
//     for every batch row of a 64-row block at once, K = 4H (3H).
//   - the residual-saving forwards (lstm_fwd.cu K2, gru_fwd.cu K4 with
//     residuals): kCols = 64 (LSTM) or 48 (GRU) gate columns of 16 units,
//     3 stages (4 stages of 128 or 112 padded rows would pass the 227 KB a
//     CTA may take). a is h_{t-1}, b the CTA's gate rows of W_hh as torch
//     stores it, (G*H, H): gate g of unit j is row g*H + j, so b's rows come
//     in groups of 16 (one group a gate), group g at b + g * b_group, and
//     out is h_{t-1} . W_hh^T over K = H.
// b's valid rows are the first n_units of each group of 16 (the unit edge
// at H % 16 != 0); the reverse scans have one group.
//
// Tiles. Chunks of kChunkBytes of every row of a and b are staged in shared
// memory with 16-byte cp.async, in the working type, kStages deep (one chunk
// multiplied while the next ones are in flight); rows past n_rows or
// n_units and columns past k_width are zero-filled by the copy itself. A
// row is padded by 16 bytes, so the 8 rows that one ldmatrix (or one
// LDS.128 of the f32 path) reads land on 8 distinct 16-byte bank groups.
//
// The warps. Each takes a row half (kHalves), a column part (kParts) and a
// K split (kSplits) of the product; the K splits' partial sums are reduced
// through shared memory, in a fixed order, into out.
//   bfloat16: mma.sync.aligned.m16n8k16.row.col with f32 accumulators, fed
//   by ldmatrix: a is the row-major 16x16 A tile, b's rows (K contiguous)
//   are the "col" B operand as they lie. At 16 columns (K3, K5) each of the
//   8 warps takes every 16-row tile and every n8 tile for its own k16 steps
//   (8 K splits), so a and b are each read from shared memory once. Wider
//   (K2, K4r), that form held 4 x kCols / 8 x 4 accumulators a thread (128
//   at 64 columns) and spilled in K2; there the warps split into 2 row
//   halves x 2 column parts (where a part is whole pairs of n8 tiles: K2's
//   64 columns, not K4r's 48) x the rest as K splits, which reads the tiles
//   2 (2 x 2) times instead of once and keeps 32 (K2) or 48 (K4r)
//   accumulators a thread.
//   float32: the same staged tiles on CUDA cores (TF32 would round the f32
//   sums past the scans' tolerance): a thread holds a 4 x kPartCols/4 block
//   of rows x columns in registers and walks its K split 4 columns (one
//   LDS.128 per row and column) at a time. 16 columns: 2 row halves x 4 K
//   splits. Wider: 2 row halves x 4 column parts and no K split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace dsjax_torch {
namespace scan_mma {

constexpr int kRows = 64;                 // rows of a per product
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkBytes = 512;          // of one row, per stage
constexpr int kPitch = kChunkBytes + 16;  // padded row in shared memory

template <typename T, int kCols, int kStages = 4>
struct Shape {
  static_assert(kCols % 16 == 0, "columns come in pairs of n8 tiles");
  static_assert(kStages >= 2, "one chunk in flight while one is multiplied");
  static constexpr int kChunk = kChunkBytes / static_cast<int>(sizeof(T));  // K columns a stage
  static constexpr int kStageBytes = (kRows + kCols) * kPitch;
  // the warps' row halves x column parts x K splits (top of the file)
  static constexpr bool kWide = kCols > 16;
  static constexpr int kHalves = sizeof(T) == 2 && !kWide ? 1 : 2;
  static constexpr int kParts = !kWide ? 1 : sizeof(T) == 4 ? 4 : kCols % 32 == 0 ? 2 : 1;
  static constexpr int kSplits = kWarps / (kHalves * kParts);
  static constexpr int kPartCols = kCols / kParts;
  static_assert(kSplits >= 1 && kPartCols % (sizeof(T) == 2 ? 16 : 4) == 0,
                "a column part is whole ldmatrix (bf16) or LDS.128 (f32) column groups");
  static constexpr int kPartBytes = kSplits * kRows * kCols * 4;
  // the stages, reused for the partial sums once the last chunk is read
  static constexpr int kSmemBytes =
      kStages * kStageBytes > kPartBytes ? kStages * kStageBytes : kPartBytes;
  static_assert((kRows + kCols) * (kChunkBytes / 16) % kThreads == 0,
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

// Columns [k0, k0 + kChunk) of every row of a and b into one stage. Row r
// of b is row r % 16 of group r / 16, which starts at b + (r / 16) * b_group.
template <typename T, int kCols>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const T* a, int lda, int n_rows,
                                            const T* b, int ldb, size_t b_group, int n_units,
                                            int k0, int k_width) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = kChunkBytes / 16;  // 16-byte copies a row
  constexpr int kCopies = (kRows + kCols) * kVecs / kThreads;
#pragma unroll
  for (int it = 0; it < kCopies; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kVecs;
    const int v = i % kVecs;
    const int k = k0 + v * kVec;
    const bool is_a = r < kRows;
    const int row = is_a ? r : r - kRows;
    // one group when kCols is 16: the reverse scans' rows as they were
    const int group = kCols > 16 ? row / 16 : 0;
    const int unit = kCols > 16 ? row % 16 : row;
    const bool valid = k < k_width && (is_a ? row < n_rows : unit < n_units);
    const T* src = valid ? (is_a ? a + static_cast<size_t>(row) * lda
                                 : b + group * b_group + static_cast<size_t>(unit) * ldb) + k
                         : a;
    cp_async16(buf + r * kPitch + v * 16, src, valid);
  }
}

template <typename T, int kCols>
struct Acc;

template <int kCols>
struct Acc<__nv_bfloat16, kCols> {
  using S = Shape<__nv_bfloat16, kCols>;
  static constexpr int kTiles = kRows / 16 / S::kHalves;
  float v[kTiles][S::kPartCols / 8][4];   // a warp's 16-row tiles x n8 tiles
};

template <int kCols>
struct Acc<float, kCols> {
  float v[4][Shape<float, kCols>::kPartCols / 4];   // a thread's 4 rows x columns
};

// One staged chunk on tensor cores; k_left > 0 columns of it are valid.
template <int kCols>
__device__ __forceinline__ void chunk_product(const unsigned char* buf,
                                              Acc<__nv_bfloat16, kCols>& acc, int n_rows,
                                              int k_left) {
  using S = Shape<__nv_bfloat16, kCols>;
  using A = Acc<__nv_bfloat16, kCols>;
  constexpr int kSteps = S::kChunk / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = warp % S::kHalves;
  const int part = (warp / S::kHalves) % S::kParts;
  const int split = warp / (S::kHalves * S::kParts);
  const int n_steps = min(kSteps, (k_left + 15) / 16);
  const int m_tiles = (n_rows + 15) / 16;
  const uint32_t a_s = smem_u32(buf);
  const uint32_t b_s = a_s + (kRows + part * S::kPartCols) * kPitch;
  for (int ks = split; ks < n_steps; ks += S::kSplits) {
    const uint32_t kb = ks * 32;  // bytes into the row
    uint32_t bf[S::kPartCols / 8][2];
#pragma unroll
    for (int np = 0; np < S::kPartCols / 16; ++np) {
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
    for (int mt = 0; mt < A::kTiles; ++mt) {
      const int tile = half * A::kTiles + mt;
      if (tile < m_tiles) {
        // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        uint32_t af[4];
        ldmatrix_x4(a_s + (tile * 16 + lane % 16) * kPitch + kb + (lane / 16) * 16, af);
#pragma unroll
        for (int nt = 0; nt < S::kPartCols / 8; ++nt)
          mma_bf16(acc.v[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
}

// One staged chunk on CUDA cores. Lanes: 8 row groups x 4 column groups; a
// thread's rows are half * 32 + rg + 8 i and its columns part * kPartCols +
// cg + 4 q, so the 8 rows (and the 4 columns) one load instruction reads
// are neighbours.
template <int kCols>
__device__ __forceinline__ void chunk_product(const unsigned char* buf, Acc<float, kCols>& acc,
                                              int n_rows, int k_left) {
  using S = Shape<float, kCols>;
  constexpr int kPartCols = S::kPartCols;
  constexpr int kPer = S::kChunk / S::kSplits;
  constexpr int kP = kPitch / 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int half = warp % 2;
  const int part = (warp / 2) % S::kParts;
  const int split = warp / (2 * S::kParts);
  if (half * 32 >= n_rows) return;
  const float* a_s = reinterpret_cast<const float*>(buf) + (half * 32 + lane % 8) * kP;
  const float* b_s = reinterpret_cast<const float*>(buf + kRows * kPitch) +
                     (part * kPartCols + lane / 8) * kP;
  const int k_end = min((split + 1) * kPer, k_left);
  for (int k = split * kPer; k < k_end; k += 4) {
    float4 av[4];
    float4 bv[kPartCols / 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a_s + 8 * i * kP + k);
#pragma unroll
    for (int q = 0; q < kPartCols / 4; ++q)
      bv[q] = *reinterpret_cast<const float4*>(b_s + 4 * q * kP + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < kPartCols / 4; ++q) {
        float s = acc.v[i][q];
        s = fmaf(av[i].x, bv[q].x, s);
        s = fmaf(av[i].y, bv[q].y, s);
        s = fmaf(av[i].z, bv[q].z, s);
        acc.v[i][q] = fmaf(av[i].w, bv[q].w, s);
      }
    }
  }
}

template <int kCols>
__device__ __forceinline__ void store_partials(const Acc<__nv_bfloat16, kCols>& acc,
                                               float* part) {
  using S = Shape<__nv_bfloat16, kCols>;
  using A = Acc<__nv_bfloat16, kCols>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = part + (warp / (S::kHalves * S::kParts)) * kRows * kCols;
  const int col0 = ((warp / S::kHalves) % S::kParts) * S::kPartCols + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < A::kTiles; ++mt) {
#pragma unroll
    for (int nt = 0; nt < S::kPartCols / 8; ++nt) {
      const int row = ((warp % S::kHalves) * A::kTiles + mt) * 16 + lane / 4;
      const int col = col0 + nt * 8;
      *reinterpret_cast<float2*>(p + row * kCols + col) =
          make_float2(acc.v[mt][nt][0], acc.v[mt][nt][1]);
      *reinterpret_cast<float2*>(p + (row + 8) * kCols + col) =
          make_float2(acc.v[mt][nt][2], acc.v[mt][nt][3]);
    }
  }
}

template <int kCols>
__device__ __forceinline__ void store_partials(const Acc<float, kCols>& acc, float* part) {
  using S = Shape<float, kCols>;
  constexpr int kPartCols = S::kPartCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = part + (warp / (2 * S::kParts)) * kRows * kCols;
  const int row0 = (warp % 2) * 32 + lane % 8;
  const int col0 = ((warp / 2) % S::kParts) * kPartCols + lane / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < kPartCols / 4; ++q)
      p[(row0 + 8 * i) * kCols + col0 + 4 * q] = acc.v[i][q];
  }
}

// out (kRows, kCols) f32 in shared memory <- a . b^T as above. smem holds
// Shape<T, kCols, kStages>::kSmemBytes (16-byte aligned) and must not
// overlap out. b_group is the distance between b's groups of 16 rows in
// elements (unused when kCols is 16). All kThreads threads of the CTA call
// it; it begins and ends with a barrier-complete state, so the caller may
// read out right after it.
template <typename T, int kCols, int kStages = 4>
__device__ void product(const T* __restrict__ a, int lda, int n_rows, const T* __restrict__ b,
                        int ldb, int n_units, int k_width, unsigned char* smem,
                        float* __restrict__ out, size_t b_group = 0) {
  using S = Shape<T, kCols, kStages>;
  const int n_chunks = (k_width + S::kChunk - 1) / S::kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      stage_chunk<T, kCols>(smem + c * S::kStageBytes, a, lda, n_rows, b, ldb, b_group,
                            n_units, c * S::kChunk, k_width);
    cp_async_commit();
  }
  Acc<T, kCols> acc = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk c - 1 is read by all
    const int next = c + kStages - 1;
    if (next < n_chunks)
      stage_chunk<T, kCols>(smem + (next % kStages) * S::kStageBytes, a, lda, n_rows, b, ldb,
                            b_group, n_units, next * S::kChunk, k_width);
    cp_async_commit();
    chunk_product<kCols>(smem + (c % kStages) * S::kStageBytes, acc, n_rows,
                         k_width - c * S::kChunk);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  store_partials<kCols>(acc, part);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < S::kSplits; ++p) s += part[p * kRows * kCols + i];
    out[i] = s;
  }
  __syncthreads();
}

}  // namespace scan_mma
}  // namespace dsjax_torch
