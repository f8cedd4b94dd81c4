// The persistent forward scans for Hopper, sm_90a: K1 (lstm_fwd.cu) and K4
// (gru_fwd.cu), the LSTM and GRU recurrences without residuals that every
// serving, streaming, evaluation and transcription forward runs. One
// cooperative launch runs all T steps of every direction of a layer call.
//
// What bounds them: at the serving shapes (B = 8, H = 1024) a step of a
// direction is 2 * B * G * H * H = 50 (GRU) or 67 (LSTM) MFLOP, a few
// microseconds of CUDA cores in f32 and far less of the tensor cores in
// bf16, while h_{t-1} has to cross every CTA of its direction between two
// steps. The per-step kernels these replace (one launch a step, 256 CTAs
// that each re-read their W_hh rows from L2 and reduced every (column,
// row) pair across a warp) took 10.8 us a step in f32 and bf16 alike: the
// step's latency, not its bytes or operations, bounded them.
//
// The design, the counterpart of dsjax's pallas_call with the time loop
// inside and W_hh pinned in VMEM (dsjax/ops/lstm_pallas.py:204-215,
// gru_pallas.py:143-150):
// - Grid (ctas, D), one CTA an SM, launched with cudaLaunchCooperativeKernel
//   so that every CTA is resident at once. A CTA owns `units` hidden units
//   (a multiple of 8; D * ceil(H / units) <= SMs): their G * units gate
//   rows of W_hh, local column lc = g * units + u being row g * H + j0 + u
//   as torch stores it.
// - Residency. At the start of the call the CTA copies its first
//   `resident` rows into shared memory (row pitch H * size + 16 bytes, the
//   16 zeroed) and keeps them for all T steps. The plan (ops/lstm.py:
//   scan_plan, checked again by check_plan) keeps every row resident where
//   it fits. Where it does not (f32 LSTM, two directions, H = 1024: 64 rows
//   of 4 KB against 227 KB), a CTA of 16 units at H <= 1024 keeps its last
//   gate's 16 rows in registers for all T steps (64 a thread, Acc<float>)
//   and the other 48 in shared memory. Rows kept in neither (`streamed`:
//   none at the serving, evaluation and validation batches, 3 at B = 160
//   beside the registers, most at H = 4096) pass through the chunk ring
//   below every pass, from L2.
// - The step product Z[rows, cols] = h_{t-1}[rows, 0:H] . W[cols, 0:H]^T
//   runs in passes of `rows` batch rows (16 in bf16: one m16 tile; in f32
//   the plan's: 8 up to B = 8, else 8, 12, 16 or 20, the fewest passes
//   that keep the rows on the SM) and in chunks of `chunk_bytes` of K: a
//   ring of `stages` buffers
//   in shared memory, each holding a chunk of the pass's h rows and of the
//   streamed W rows, filled with 16-byte cp.async.cg (L2 only: h is
//   written by other CTAs inside this kernel, so it must never be read
//   through L1 or the read-only path); a wide pass's h by tensor copies. Units past H and K past H are
//   zero-filled by the copies; rows past B are not copied at all (a row of
//   the product only reaches its own outputs, which nothing reads). The
//   plan keeps the most bytes of h in flight that fit (at H = 1024 a whole
//   row of h in one chunk in bf16), a wide pass the fewest chunks.
//   Each warp takes one (column tile of 8 units, K split) item; the K
//   splits' partial sums meet in shared memory and the epilogue sums them
//   in a fixed order. A pass reads each resident W float once and pays one
//   epilogue and one issue of h's copies, so a step takes as few passes
//   as fit: a wide f32 pass (more than 8 rows) writes its partial sums over
//   the ring, idle once every warp has read its last chunk, and reads its
//   register rows in 512-byte chunks at 16 and 20 rows, so that its ring fits
//   beside 48 resident rows of 4 KB.
//     bf16: mma.sync m16n8k16 (f32 accumulators), h from the ring and W
//     from its resident row or the ring, both through ldmatrix.
//     f32: register-blocked FMA, no TF32. A lane takes all rows of the
//     pass and all G gate columns of one unit, and a quarter of its warp's
//     K split: at 8 rows 2.2 (GRU) to 2.7 (LSTM) FMA a float read from
//     shared memory, whose 128 bytes a clock (broadcasts included) bound the
//     f32 product; at 20 rows 2.6 and 3.3. The register rows add FMAs
//     without reads.
// - Exchange. Only h crosses CTAs, through the (2, D, B, H) buffer, step
//   s reading slot s % 2 and writing slot (s + 1) % 2. A CTA keeps the h
//   and c of its own units, and b_hh's columns, in shared memory for all T
//   steps (c leaves it once, as the final carry). After writing its h
//   slice, a CTA meets the other CTAs of its direction at one barrier a
//   step (grid_sync.cuh, shared with K8), on the direction's counter in
//   the wrapper's zeroed (D,) int32 workspace.
// - Latency hiding. Between its arrival and its wait a CTA issues the next
//   step's first pass's xp columns and mask row, and the streamed W rows of
//   its first chunks, with cp.async: they land while it waits. A later
//   pass of a step issues its own at its start and waits for them at its
//   first chunk.
// The roundings are those of the per-step kernels: sums and cell math in
// f32, the kept carry rounded to the working type every step, y from the
// unrounded h'.
//
// Where a step's time goes (clock64 of one CTA, K1 bf16 at T = 501, B = 8,
// H = 1024, two directions, before the barrier was split and empty rows
// skipped; H100 80GB HBM3 at 700 W): about 9.8k cycles, of which the
// barrier 2.4k, the epilogue 2.1k, the product 2.0k, issuing the copies of
// h 1.4k and of the next xp 0.9k. Every CTA of a direction reads the same
// h, so the copies' issue stalls behind L2; the product itself is not the
// limit in bf16.
// K1 f32 at the evaluation's T = 577, B = 20 (two directions, H = 1024;
// tools/torch_kernel_probe.py, thread 0 of every CTA, summed over a step's
// passes, the mean over CTAs; 1980 MHz), in three passes of 8 rows: 52.0k
// cycles a step (26.3 us, 15.18 ms a call), of which the product 25.9k,
// issuing the ring's next chunks 8.4k (each issue waits behind the other
// warps' shared-memory loads), the epilogue 6.9k, the next pass's xp 2.6k
// (its HBM read waited for at the pass's first chunk), the chunk waits
// 2.3k, the first chunks' issue 1.8k, storing the partial sums 1.1k, the
// barrier's arrival 0.9k, the next step's xp 0.8k and its wait 1.2k. The
// product removed, 13.2 us a step; the barrier's wait removed, 26.3: the
// passes, not the exchange, set the step. At T = 501, B = 8 (one pass):
// 18.8k cycles (9.8 us), the product 8.7k, the chunk issue 3.1k, the
// epilogue 2.3k. In one wide pass of 20 rows (h by tensor copies, 512-byte
// chunks, 2 stages): 31.0k cycles a step (16.0 us, 9.26 ms a call), of
// which the product 17.0k, the chunk waits 3.2k, the epilogue 3.1k,
// issuing the ring's next chunks 2.8k, storing the partial sums 1.5k, the
// next step's xp 1.0k, the barrier's arrival 0.9k and its wait 0.8k; the
// product removed, 7.3 us a step. The product is 1.7x its FMA floor
// (10.2k cycles).
//
// Tried and dropped (tools/torch_serving_scans.py on copies of the tree,
// in turns in one call; ms a call, K1 f32 / K4 f32 / K1 bf16 / K4 bf16,
// both directions): 512 threads a CTA (9.15 / 5.97 / 3.66 / 3.37 against
// 9.15-9.21 / 6.15-6.22 / 3.43-3.49 / 3.22-3.43); a 3-stage ring for the
// streamed rows, 42 resident (9.67 / 6.24 / 3.56 / 3.42); a chunk walk
// rotated by the CTA's index, so that the CTAs of a direction read h at
// different places (10.86-11.09 / 5.73-5.74 / 3.05 / 2.72-2.78 against
// 9.46-9.55 / 5.12-5.45 / 2.75-2.79 / 2.57-2.64); an f32 product in which
// a warp owns 8 columns of all 8 rows and a lane 16-byte K groups, 32 FMA
// a load, summed over the lanes by recursive halving (213 registers;
// 10.31-10.36 / 6.13-6.14 in f32 against 9.84 / 5.63). Kept: b_hh in
// shared memory, the barrier's arrival as one release add, whole-row
// chunks where every row is resident (K1 bf16 3.43-3.62 -> 2.75-2.79 ms),
// the barrier split around the next copies. The first form of the f32
// path streamed 17 of K1's 64 rows a CTA (two directions) through a
// 2-stage ring of 512-byte chunks, once for every 8-row pass, and ran its
// product with a lane of 2 rows x G columns (1.2 FMA a float read, about
// 30% of the FMA rate): K1 f32 9.23-9.45 ms against 5.73-5.82 for the
// per-step kernel. The last gate's rows in registers, alone: 6.34 ms (K4
// f32, unchanged, 5.03; at evaluation's T = 577, B = 20, 20.41 and 15.95);
// with the lane of 8 rows x one unit's G columns as well: 4.98-5.11 and
// 4.26-4.27 (15.66-15.68 and 13.13-13.26 at B = 20, where the per-step
// kernel takes 16.72-16.74 and 15.95-16.01). Wide f32 passes (K1 f32 at
// T = 577, B = 20, ms a call, tools/torch_kernel_probe.py and forced plans
// in one call): with h's chunks copied 16 bytes a thread, as in the other
// passes, one pass of 20 rows took 15.43-15.53 against 15.36 for three of
// 8 (the product 27.4k cycles a step, the copies' issue 11.3k: every
// warp's cp.async waits behind the other warps' loads), two passes of 12
// or 16 took 20.0 and 22.4; with h by bulk copies, a lane a row (20 a chunk
// from warp 0), 18.4 (the product fell to 15.3k cycles, but issuing the
// copies took 26.7k). With h by one tensor copy a chunk (kept): one pass
// of 20 in 256-byte chunks, 5 stages, 12.0-12.2 (39.8k cycles: the
// product 19.0k, the chunk waits 5.9k, their issue 5.6k), in 512-byte
// chunks, 2 stages, 9.5-10.0 (kept); two passes of 12 in 1024-byte chunks
// 11.5. Later forms: xp of the next pass copied during the current one
// (from HBM, now waited for at each pass's first chunk), the ring run on
// across passes, h multicast to a cluster.

#pragma once

#include <climits>

#include "grid_sync.cuh"
#include "hopper_async.cuh"
#include "lstm_common.cuh"
#include "scan_mma.cuh"

namespace dsjax_torch {
namespace persist {

namespace sm = dsjax_torch::scan_mma;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTiles = kWarps;        // column tiles of 8 units: at most one a warp
constexpr int kMaxStages = 5;
constexpr int kMaxChunkBytes = 2048;
// Register rows (f32 only): the last gate's rows of a CTA of kRegUnits
// units, at most kRegBytes of each (H <= 1024): 64 registers a thread
// (Acc<float>), read in chunks of reg_chunk_bytes(rows).
constexpr int kRegUnits = 16;
constexpr int kRegBytes = 4096;
// Batch rows a pass: bf16 one m16 tile; f32 8, or a wide pass of 12, 16 or
// 20 rows, each a build of the kernel (kernel_for).
constexpr int kBf16Rows = 16;
constexpr int kMaxRows = 20;

__host__ __device__ constexpr bool f32_rows(int rows) {
  return rows == 8 || rows == 12 || rows == 16 || rows == kMaxRows;
}

// The ring's chunk where register rows are read from it: 1024 bytes up to
// 12 rows a pass, 512 (two 16-byte groups of each of a lane's K streams)
// at 16 and 20, whose 2-stage ring of 1024-byte chunks would not fit
// beside the 48 resident rows.
__host__ __device__ constexpr int reg_chunk_bytes(int rows) { return rows <= 12 ? 1024 : 512; }

// A wide pass: f32 at more than 8 rows. It keeps its partial sums over the
// ring, idle by then, and takes each chunk of h's rows by one tensor copy
// (TMA: rows past B and K past H come as zeros; at most 1024 bytes of a
// row, 256 floats a box) into a ring of dense rows whose stages start on
// 128 bytes, completing on an mbarrier a ring stage, kept after `own`.
__host__ __device__ constexpr bool wide_pass(int esize, int rows) {
  return esize == 4 && rows > 8;
}
constexpr int kBarBytes = 48;   // kMaxStages mbarriers of 8 bytes, to 16
constexpr int kTmaAlign = 128;
constexpr int kWideMaxChunkBytes = 1024;

// The plan, as ops/lstm.py:scan_plan passes it: kPlanInts ints in this order.
// The CTA's W_hh rows are its local columns in order: `resident` in shared
// memory, then `streamed` through the ring, then `reg` in registers.
// `rows`: batch rows a pass.
struct Plan {
  int units, ctas, resident, streamed, reg, stages, chunk_bytes, smem_bytes, rows;
};
constexpr int kPlanInts = 9;

// A CTA's shared memory, in bytes from its start (scan_plan's _plan_smem
// computes the same total).
struct Layout {
  int rows;           // batch rows a pass
  int cols;           // gate columns a CTA: G * units
  int tiles, splits;  // column tiles of 8 units, K splits of a tile
  int w_pitch, ring_pitch, stage_bytes;
  int ring, part, xp, mask, bias, own, bars, total;   // the resident rows start at 0
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int gates, int esize, int n_h, int n_b, int n_state,
                                         const Plan& p) {
  Layout l;
  l.rows = p.rows;
  l.cols = gates * p.units;
  l.tiles = p.units / 8;
  l.splits = l.tiles > 0 ? kWarps / l.tiles : 0;
  const bool over = wide_pass(esize, l.rows);
  l.w_pitch = n_h * esize + 16;
  l.ring_pitch = over ? p.chunk_bytes : p.chunk_bytes + 16;
  l.stage_bytes = (l.rows + p.streamed) * l.ring_pitch;
  l.ring = p.resident * l.w_pitch;
  if (over) {
    l.stage_bytes = (l.stage_bytes + kTmaAlign - 1) / kTmaAlign * kTmaAlign;
    l.ring = (l.ring + kTmaAlign - 1) / kTmaAlign * kTmaAlign;
  }
  const int ring_bytes = p.stages * l.stage_bytes;
  const int part_bytes = l.splits * l.rows * l.cols * 4;
  l.part = over ? l.ring : l.ring + ring_bytes;              // (splits, rows, cols) f32
  l.xp = over ? l.ring + (ring_bytes > part_bytes ? ring_bytes : part_bytes)
              : l.part + part_bytes;                         // (rows, cols) working type
  l.mask = l.xp + round16(l.rows * l.cols * esize);          // (rows) f32
  l.bias = l.mask + round16(l.rows * 4);                     // (cols) f32: b_hh
  l.own = l.bias + round16(l.cols * 4);                      // (n_state, B, units) f32
  l.bars = l.own + n_state * n_b * p.units * 4;              // (stages) mbarriers, wide
  l.total = l.bars + (over ? kBarBytes : 0);
  return l;
}

// cudaSuccess if the plan is one that scan_plan can give for this call and
// this device, else cudaErrorInvalidValue.
inline cudaError_t check_plan(const Plan& p, const Layout& l, int gates, int esize, int n_dir,
                              int n_h, int sm_count, int smem_optin) {
  const int row32 = (n_h * esize + 31) / 32 * 32;
  const int n_chunks = p.chunk_bytes > 0 ? (n_h * esize + p.chunk_bytes - 1) / p.chunk_bytes : 0;
  const bool ok =
      p.units > 0 && p.units % 8 == 0 && l.tiles <= kMaxTiles &&
      p.ctas == (n_h + p.units - 1) / p.units && n_dir * p.ctas <= sm_count &&
      p.resident >= 0 && p.streamed >= 0 && p.reg >= 0 &&
      p.resident + p.streamed + p.reg == gates * p.units &&
      (esize == 2 ? p.rows == kBf16Rows : f32_rows(p.rows)) &&
      (p.reg == 0 || (p.reg == p.units && p.units == kRegUnits && esize == 4 &&
                      p.chunk_bytes == reg_chunk_bytes(p.rows) && n_h * esize <= kRegBytes)) &&
      p.stages >= 1 && p.stages <= kMaxStages && (p.stages >= 2 || n_chunks == 1) &&
      p.chunk_bytes > 0 &&
      p.chunk_bytes % 32 == 0 && p.chunk_bytes <= kMaxChunkBytes && p.chunk_bytes <= row32 &&
      (!wide_pass(esize, p.rows) || p.chunk_bytes <= kWideMaxChunkBytes) &&
      p.smem_bytes == l.total && l.total <= smem_optin;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
struct Args {
  CUtensorMap h_map;    // a wide pass's: h_buf as (2 D, B, H), boxes of (1, rows, chunk)
  const T* xp;          // (D, T, B, G*H)
  const float* mask;    // (T, B)
  const T* w_hh;        // (D, G*H, H)
  const T* b_hh;        // (D, G*H)
  T* h_buf;             // (2, D, B, H)
  T* c_buf;             // (2, D, B, H), LSTM only
  T* y;                 // (D, T, B, H)
  int* counters;        // (D,) zeroed: arrivals at the barriers of each direction
  int n_t, n_b, n_h, reverse_bits;
  Plan plan;
  Layout lay;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// cp.async.wait_group takes an immediate: wait until at most n groups are
// pending (n < kMaxStages - 1; a larger n waits for all, which is safe)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 1: sm::cp_async_wait<1>(); break;
    case 2: sm::cp_async_wait<2>(); break;
    case 3: sm::cp_async_wait<3>(); break;
    default: sm::cp_async_wait<0>(); break;
  }
}

// one tensor copy: the box at (x, y, z) of a 3-D map into dst, counted on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One CTA's view of a direction: its units, its rows of W_hh and b_hh.
template <typename T, int G>
struct Cta {
  const Args<T>& a;
  unsigned char* smem;
  int d, j0;
  const T* w_d;   // W_hh of direction d

  __device__ Cta(const Args<T>& args, unsigned char* s)
      : a(args), smem(s), d(blockIdx.y), j0(blockIdx.x * args.plan.units),
        w_d(args.w_hh + static_cast<size_t>(blockIdx.y) * G * args.n_h * args.n_h) {}

  // offsets of the (2, D, B, H) h and c buffers at slot q, batch row b and
  // unit j of this direction, and of y (D, T, B, H) at time t: the rows are
  // ints, widened by the last product only, so that the offsets a step
  // carries stay 32-bit (the launch checks that the rows fit an int)
  __device__ __forceinline__ size_t state_at(int q, int b, int j) const {
    return static_cast<size_t>((q * static_cast<int>(gridDim.y) + d) * a.n_b + b) * a.n_h + j;
  }
  __device__ __forceinline__ size_t y_at(int t, int b, int j) const {
    return static_cast<size_t>((d * a.n_t + t) * a.n_b + b) * a.n_h + j;
  }

  // global W_hh row of local column lc, or null past H
  __device__ __forceinline__ const T* w_row(int lc) const {
    const int j = j0 + lc % a.plan.units;
    return j < a.n_h ? w_d + (static_cast<size_t>(lc / a.plan.units) * a.n_h + j) * a.n_h
                     : nullptr;
  }

  // chunks staged before the first is read: all but one stage, or the one
  // chunk of a single-stage ring
  __device__ __forceinline__ int ahead() const { return max(1, a.plan.stages - 1); }

  __device__ __forceinline__ unsigned char* stage(int buf) const {
    return smem + a.lay.ring + buf * a.lay.stage_bytes;
  }

  // the resident rows, whole (their 16-byte pad zeroed)
  __device__ void load_resident() const {
    const int vecs = a.lay.w_pitch / 16;
    const int n_k = a.n_h * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < a.plan.resident * vecs; i += kThreads) {
      const int lc = i / vecs, v = i % vecs;
      const T* row = w_row(lc);
      const bool valid = row != nullptr && v < n_k;
      sm::cp_async16(smem + lc * a.lay.w_pitch + v * 16,
                     valid ? reinterpret_cast<const unsigned char*>(row) + v * 16
                           : reinterpret_cast<const unsigned char*>(a.w_hh),
                     valid);
    }
  }

  // chunk c of the pass's h rows [b0, b0 + nb) into ring buffer buf
  __device__ void stage_h(const T* h_in, int b0, int nb, int c, int buf) const {
    const int vecs = a.plan.chunk_bytes / 16;
    const int k0 = c * a.plan.chunk_bytes;   // bytes into a row
    const int row_bytes = a.n_h * static_cast<int>(sizeof(T));
    unsigned char* st = stage(buf);
    // rows past nb keep what they held: they only reach outputs of their
    // own row, which nothing reads
    for (int i = threadIdx.x; i < nb * vecs; i += kThreads) {
      const int r = i / vecs, v = i % vecs;
      const int k = k0 + v * 16;
      const bool valid = k < row_bytes;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(h_in);
      if (valid) src += static_cast<size_t>(b0 + r) * row_bytes + k;
      sm::cp_async16(st + r * a.lay.ring_pitch + v * 16, src, valid);
    }
  }

  // thread 0: chunk c of the pass's h rows [b0, b0 + rows) of slot `slot`
  // into ring buffer buf by one tensor copy, counted on bar (a wide pass)
  __device__ void tma_h(int slot, int b0, int c, int buf, uint64_t* bar) const {
    hopper::mbar_expect(bar, a.lay.rows * a.lay.ring_pitch);
    tma_load_3d(stage(buf), &a.h_map, c * a.plan.chunk_bytes / static_cast<int>(sizeof(T)), b0,
                slot * gridDim.y + d, bar);
  }

  // chunk c of the streamed W rows into ring buffer buf
  __device__ void stage_w(int c, int buf) const {
    const int vecs = a.plan.chunk_bytes / 16;
    const int k0 = c * a.plan.chunk_bytes;
    const int row_bytes = a.n_h * static_cast<int>(sizeof(T));
    unsigned char* st = stage(buf) + a.lay.rows * a.lay.ring_pitch;
    for (int i = threadIdx.x; i < a.plan.streamed * vecs; i += kThreads) {
      const int s = i / vecs, v = i % vecs;
      const int k = k0 + v * 16;
      const T* row = w_row(a.plan.resident + s);
      const bool valid = row != nullptr && k < row_bytes;
      sm::cp_async16(st + s * a.lay.ring_pitch + v * 16,
                     valid ? reinterpret_cast<const unsigned char*>(row) + k
                           : reinterpret_cast<const unsigned char*>(a.w_hh),
                     valid);
    }
  }

  // What the next pass needs before its h: its xp columns and mask row at
  // time t, and the streamed W rows of the chunks staged before the loop.
  // Not committed: the pass's first commit takes them into its group.
  __device__ void prefetch(int t, int b0, int nb, int n_chunks) const {
    const Layout& l = a.lay;
    const int units = a.plan.units;
    const int per_gate = units * static_cast<int>(sizeof(T)) / 16;   // copies of a gate's units
    const size_t g_h = static_cast<size_t>(G) * a.n_h;
    const T* xp_t = a.xp + static_cast<size_t>((d * a.n_t + t) * a.n_b + b0) * g_h;
    for (int i = threadIdx.x; i < l.rows * G * per_gate; i += kThreads) {
      const int r = i / (G * per_gate), g = (i / per_gate) % G, v = i % per_gate;
      const int u = v * (16 / static_cast<int>(sizeof(T)));
      const bool valid = r < nb && j0 + u < a.n_h;
      const T* src = valid ? xp_t + r * g_h + static_cast<size_t>(g) * a.n_h + j0 + u : a.xp;
      sm::cp_async16(smem + l.xp + (r * l.cols + g * units + u) * static_cast<int>(sizeof(T)),
                     src, valid);
    }
    float* mask_s = reinterpret_cast<float*>(smem + l.mask);
    for (int r = threadIdx.x; r < l.rows; r += kThreads) {
      const bool valid = r < nb;
      cp_async4(mask_s + r, valid ? a.mask + (t * a.n_b + b0 + r) : a.mask,
                valid);
    }
    for (int c = 0; c < min(ahead(), n_chunks); ++c) stage_w(c, c);
  }

  // shared address of local column lc's bytes [kb, ...) of chunk c in buffer buf
  __device__ __forceinline__ const unsigned char* w_chunk(int lc, int c, int buf) const {
    const int res = a.plan.resident;
    return lc < res ? smem + lc * a.lay.w_pitch + c * a.plan.chunk_bytes
                    : stage(buf) + (a.lay.rows + lc - res) * a.lay.ring_pitch;
  }
};

// A warp's accumulators and its share of a staged chunk. Warp w takes
// column tile w % tiles (8 units) and K split w / tiles. kReg: the plan
// keeps the last gate's rows in registers (float32 only). R: batch rows a
// pass (the plan's `rows`; bf16 takes 16).
template <typename T, int G, bool kReg, int R>
struct Acc;

// float32 on CUDA cores, no TF32. Shared memory feeds 128 bytes a clock to
// the lanes, broadcasts included, so a lane's FMAs per float it loads set
// the rate: lane (kh = lane / 8, u8 = lane % 8) owns unit tile * 8 + u8,
// all G gate columns of it and all R rows of the pass, and takes the
// 16-byte K groups kh + 4 * split + S * i (S = 4 * splits) of each chunk:
// a group's G W loads (one a gate) and R h loads (one address a
// quarter-warp), each h row's taken after the W's, feed 4G FMA a row,
// RG / (R + G) FMA a float (8 rows: 2.2 for the GRU, 2.7 for the LSTM; 20
// rows 2.6 and 3.3; a lane of 2 rows x G columns took 1.2 and ran the FMA
// pipes at 30%). With register rows the last gate's W comes from
// registers: wr[c][i] is the lane's group i of chunk c (kRegChunk bytes:
// 1024, 64 groups and 4 a lane, up to R = 12; else 512, 32 groups, 2 a lane;
// a lane's 16 groups in all). The 4 lanes of a (unit, warp) sum their
// partials by two shuffle rounds that halve the rows each, then the
// splits' partials meet in shared memory, summed by the epilogue in a fixed
// order.
template <int G, bool kReg, int R>
struct Acc<float, G, kReg, R> {
  static_assert(R % 4 == 0 && R <= kMaxRows, "rows a pass: a multiple of 4");
  static constexpr int Q = kReg ? G - 1 : G;   // gates read from shared memory
  static constexpr int kRegChunk = reg_chunk_bytes(R);
  static constexpr int kRegChunks = kRegBytes / kRegChunk;
  static constexpr int kPer = kRegChunk / 16 / kRegUnits;   // a lane's groups a chunk
  float v[R][G];
  float4 wr[kReg ? kRegChunks : 1][kReg ? kPer : 1];

  template <class CtaT>
  __device__ void load(const CtaT& cta, int tile, int split) {
    if constexpr (kReg) {
      const int lane = threadIdx.x % 32;
      const int ks = split * 4 + lane / 8;
      const float* row = cta.w_row((G - 1) * cta.a.plan.units + tile * 8 + lane % 8);
#pragma unroll
      for (int c = 0; c < kRegChunks; ++c) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = c * (kRegChunk / 4) + (ks + kRegUnits * i) * 4;
          wr[c][i] = row != nullptr && k < cta.a.n_h
                         ? __ldg(reinterpret_cast<const float4*>(row + k))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) v[r][g] = 0.f;
    }
  }

  // one 16-byte K group at byte kb of the chunk; wg: the register gate's.
  // At 8 rows the h rows are loaded first, then a gate's W at a time; a
  // wide pass loads the G W groups first and then an h row at a time (R
  // rows of h would not stay in registers beside R x G sums).
  __device__ __forceinline__ void group(const unsigned char* h, int pitch,
                                       const unsigned char* const (&w)[Q], int kb, float4 wg) {
    if constexpr (R == 8) {
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = *reinterpret_cast<const float4*>(h + r * pitch + kb);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b = g < Q ? *reinterpret_cast<const float4*>(w[g < Q ? g : 0] + kb) : wg;
#pragma unroll
        for (int r = 0; r < 8; ++r) fma4(v[r][g], a[r], b);
      }
    } else {
      float4 b[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        b[g] = g < Q ? *reinterpret_cast<const float4*>(w[g < Q ? g : 0] + kb) : wg;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(h + r * pitch + kb);
#pragma unroll
        for (int g = 0; g < G; ++g) fma4(v[r][g], a, b[g]);
      }
    }
  }

  static __device__ __forceinline__ void fma4(float& v, const float4& a, const float4& b) {
    float s = v;
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    v = fmaf(a.w, b.w, s);
  }

  template <int C>
  __device__ __forceinline__ void reg_chunk(const unsigned char* h, int pitch,
                                            const unsigned char* const (&w)[Q], int ks,
                                            int k_bytes) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kb = (ks + kRegUnits * i) * 16;
      if (kb < k_bytes) group(h, pitch, w, kb, wr[kReg ? C : 0][kReg ? i : 0]);
    }
  }

  // reg_chunk<c> for a chunk index known only at run time: the last case
  // takes every c past it
  template <int C = 0>
  __device__ __forceinline__ void reg_chunk_at(int c, const unsigned char* h, int pitch,
                                               const unsigned char* const (&w)[Q], int ks,
                                               int k_bytes) {
    if constexpr (C + 1 < kRegChunks) {
      if (c == C)
        reg_chunk<C>(h, pitch, w, ks, k_bytes);
      else
        reg_chunk_at<C + 1>(c, h, pitch, w, ks, k_bytes);
    } else {
      reg_chunk<C>(h, pitch, w, ks, k_bytes);
    }
  }

  template <class CtaT>
  __device__ void chunk(const CtaT& cta, int c, int buf, int tile, int split) {
    const Layout& l = cta.a.lay;
    const int lane = threadIdx.x % 32;
    const int ks = split * 4 + lane / 8;
    const int unit = tile * 8 + lane % 8;
    const int k_bytes = min(cta.a.plan.chunk_bytes,
                            cta.a.n_h * 4 - c * cta.a.plan.chunk_bytes);
    const unsigned char* h = cta.stage(buf);
    const unsigned char* w[Q];
#pragma unroll
    for (int g = 0; g < Q; ++g) w[g] = cta.w_chunk(g * cta.a.plan.units + unit, c, buf);
    if constexpr (kReg) {
      // the plan's chunks are kRegChunk bytes with kRegUnits splits, so the
      // ring's pitch is known here: each h row at an immediate offset
      constexpr int kPitch = wide_pass(4, R) ? kRegChunk : kRegChunk + 16;
      reg_chunk_at(c, h, kPitch, w, ks, k_bytes);
    } else {
      const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int kb = ks * 16; kb < k_bytes; kb += 4 * l.splits * 16)
        group(h, l.ring_pitch, w, kb, none);
    }
  }

  __device__ void store(float* part, const Layout& l, int tile, int split) const {
    constexpr int R2 = R / 2, R4 = R / 4;
    const int lane = threadIdx.x % 32;
    // lanes 16 apart: the upper keeps the last half of the rows, the lower the first
    const bool hi = lane & 16, mid = lane & 8;
    float a[R2][G], b[R4][G];
#pragma unroll
    for (int r = 0; r < R2; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float send = hi ? v[r][g] : v[r + R2][g];
        a[r][g] = (hi ? v[r + R2][g] : v[r][g]) + __shfl_xor_sync(0xffffffffu, send, 16);
      }
    }
    // lanes 8 apart: the upper keeps the last half of those rows, the lower the first
#pragma unroll
    for (int r = 0; r < R4; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float send = mid ? a[r][g] : a[r + R4][g];
        b[r][g] = (mid ? a[r + R4][g] : a[r][g]) + __shfl_xor_sync(0xffffffffu, send, 8);
      }
    }
    const int row0 = (hi ? R2 : 0) + (mid ? R4 : 0);
    const int units = l.cols / G;
    float* p = part + split * l.rows * l.cols + tile * 8 + lane % 8;
#pragma unroll
    for (int r = 0; r < R4; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) p[(row0 + r) * l.cols + g * units] = b[r][g];
    }
  }
};

// bfloat16 on tensor cores: one m16 tile x G n8 tiles a warp, both
// operands through ldmatrix.
template <int G, int R>
struct Acc<__nv_bfloat16, G, false, R> {
  float v[G][4];   // n8 tile nt: rows lane / 4 (+ 8), columns 2 (lane % 4) (+ 1)

  template <class CtaT>
  __device__ void load(const CtaT&, int, int) {}

  __device__ void zero() {
#pragma unroll
    for (int nt = 0; nt < G; ++nt) v[nt][0] = v[nt][1] = v[nt][2] = v[nt][3] = 0.f;
  }

  template <class CtaT>
  __device__ void chunk(const CtaT& cta, int c, int buf, int tile, int split) {
    const Layout& l = cta.a.lay;
    const int lane = threadIdx.x % 32;
    const int k_elems = min(cta.a.plan.chunk_bytes / 2,
                            cta.a.n_h - c * (cta.a.plan.chunk_bytes / 2));
    const int n_steps = (k_elems + 15) / 16;
    // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    const uint32_t a_s = sm::smem_u32(cta.stage(buf)) + (lane % 16) * l.ring_pitch +
                         (lane / 16) * 16;
    uint32_t b_s[G];
#pragma unroll
    for (int nt = 0; nt < G; ++nt) {
      // matrices (columns 0-7, k 0-7), (0-7, 8-15) of n8 tile nt
      b_s[nt] = sm::smem_u32(cta.w_chunk(tile * 8 * G + 8 * nt + lane % 8, c, buf)) +
                ((lane / 8) % 2) * 16;
    }
    for (int ks = split; ks < n_steps; ks += l.splits) {
      uint32_t af[4];
      sm::ldmatrix_x4(a_s + ks * 32, af);
#pragma unroll
      for (int nt = 0; nt < G; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2(b_s[nt] + ks * 32, b0, b1);
        sm::mma_bf16(v[nt], af, b0, b1);
      }
    }
  }

  __device__ void store(float* part, const Layout& l, int tile, int split) const {
    const int lane = threadIdx.x % 32;
    float* p = part + split * l.rows * l.cols;
    const int row = lane / 4;
#pragma unroll
    for (int nt = 0; nt < G; ++nt) {
      const int col = tile * 8 * G + 8 * nt + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p + row * l.cols + col) = make_float2(v[nt][0], v[nt][1]);
      *reinterpret_cast<float2*>(p + (row + 8) * l.cols + col) = make_float2(v[nt][2], v[nt][3]);
    }
  }
};

// All n_t steps of every direction of one layer call. Cell (lstm_fwd.cu,
// gru_fwd.cu) gives the gates G, the state kept a unit (h; h and c) and
//   float Cell::update<T>(zp[G], x[G], bias[G], m, state[kState])
// the cell update from the product's sums zp (without b_hh), xp's columns
// x and b_hh: it rounds the kept state in place and returns y. kReg: the
// plan holds the last gate's rows in registers (Acc<float>), float32 only.
// R: the plan's rows a pass.
template <typename T, class Cell, bool kReg, int R>
__global__ void __launch_bounds__(kThreads, 1)
persistent_scan(const __grid_constant__ Args<T> a) {
  constexpr int G = Cell::kGates;
  constexpr int S = Cell::kState;
  constexpr bool kWide = wide_pass(sizeof(T), R);
  static_assert(!kReg || sizeof(T) == 4, "register rows are float32");
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta<T, G> cta(a, smem);
  const Layout& l = a.lay;
  const int units = a.plan.units;
  const int warp = threadIdx.x / 32;
  const bool has_item = warp < l.tiles * l.splits;
  const int tile = warp % l.tiles, split = warp / l.tiles;
  const bool rev = (a.reverse_bits >> cta.d) & 1;
  const T* b_d = a.b_hh + static_cast<size_t>(cta.d) * G * a.n_h;
  float* own = reinterpret_cast<float*>(smem + l.own);      // (S, B, units)
  float* bias_s = reinterpret_cast<float*>(smem + l.bias);  // (cols)
  const float* part = reinterpret_cast<const float*>(smem + l.part);
  const T* xp_s = reinterpret_cast<const T*>(smem + l.xp);
  const float* mask_s = reinterpret_cast<const float*>(smem + l.mask);
  const int own_n = a.n_b * units;
  const int n_chunks = (a.n_h * static_cast<int>(sizeof(T)) + a.plan.chunk_bytes - 1) /
                       a.plan.chunk_bytes;
  const int ahead = cta.ahead();
  const int n_pass = (a.n_b + l.rows - 1) / l.rows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);   // a wide pass's
  uint32_t ring_phase = 0;   // bit b: the parity of ring stage b's next fill

  Acc<T, G, kReg, R> acc;
  cta.load_resident();
  sm::cp_async_commit();
  if (has_item) acc.load(cta, tile, split);
  for (int lc = threadIdx.x; lc < l.cols; lc += kThreads) {
    const int j = cta.j0 + lc % units;
    bias_s[lc] = j < a.n_h ? to_f32(b_d[(lc / units) * a.n_h + j]) : 0.f;
  }
  for (int i = threadIdx.x; i < own_n; i += kThreads) {
    const int j = cta.j0 + i % units;
    const size_t at = cta.state_at(0, i / units, j);
    own[i] = j < a.n_h ? to_f32(a.h_buf[at]) : 0.f;
    if (S == 2) own[own_n + i] = j < a.n_h ? to_f32(a.c_buf[at]) : 0.f;
  }
  if constexpr (kWide) {
    if (threadIdx.x == 0) {
      // the tensor copies' stages start on kTmaAlign from the window's start
      if (hopper::smem_u32(smem) % kTmaAlign != 0) __trap();
      for (int b = 0; b < a.plan.stages; ++b) hopper::mbar_init(bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  sm::cp_async_wait<0>();
  __syncthreads();

  cta.prefetch(time_of(0, a.n_t, rev), 0, min(l.rows, a.n_b), n_chunks);
  for (int s = 0; s < a.n_t; ++s) {
    const int t = time_of(s, a.n_t, rev);
    const T* h_in = a.h_buf + cta.state_at(s & 1, 0, 0);
    for (int pass = 0; pass < n_pass; ++pass) {
      const int b0 = pass * l.rows;
      const int nb = min(l.rows, a.n_b - b0);
      if (pass > 0) cta.prefetch(t, b0, nb, n_chunks);
      // h was written by other CTAs through the generic proxy; the tensor
      // copies read it through the async proxy
      if constexpr (kWide) {
        if (threadIdx.x == 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
      }
      const auto issue_h = [&](int c, int buf) {
        if constexpr (kWide) {
          if (threadIdx.x == 0) cta.tma_h(s & 1, b0, c, buf, bars + buf);
        } else {
          cta.stage_h(h_in, b0, nb, c, buf);
        }
      };

      // the step product of the pass's rows, chunk by chunk through the ring
      for (int c = 0; c < ahead; ++c) {
        if (c < n_chunks) issue_h(c, c);
        sm::cp_async_commit();
      }
      acc.zero();
      for (int c = 0; c < n_chunks; ++c) {
        const int buf = c % a.plan.stages;
        cp_async_wait_upto(ahead - 1);   // chunk c has landed (this thread's copies)
        if constexpr (kWide) {
          hopper::mbar_wait(bars + buf, (ring_phase >> buf) & 1);
          ring_phase ^= 1u << buf;
        }
        __syncthreads();                 // ... everyone's; chunk c - 1 is read by all
        const int next = c + ahead;
        if (next < n_chunks) {
          issue_h(next, next % a.plan.stages);
          cta.stage_w(next, next % a.plan.stages);
        }
        sm::cp_async_commit();
        if (has_item) acc.chunk(cta, c, buf, tile, split);
      }
      sm::cp_async_wait<0>();
      if constexpr (kWide) __syncthreads();   // every warp is done with the ring
      if (has_item) acc.store(reinterpret_cast<float*>(smem + l.part), l, tile, split);
      // the partial sums, over the ring, before the tensor copies that refill it
      if constexpr (kWide) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

      // the epilogue: a (row, unit) a thread, kItems at once (a wide pass
      // has more items than threads), with every load of them issued before
      // any update; the splits' partials summed in a fixed order
      constexpr int kItems = kWide ? 2 : 1;
      for (int i0 = threadIdx.x; i0 < nb * units; i0 += kItems * kThreads) {
        float zp[kItems][G], x[kItems][G], bias[kItems][G], st[kItems][S];
        bool live[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const int i = i0 + k * kThreads;
          const int r = i / units, u = i % units;
          live[k] = i < nb * units && cta.j0 + u < a.n_h;
          if (!live[k]) continue;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int lc = g * units + u;
            float sum = 0.f;
#pragma unroll
            for (int p = 0; p < kWarps; ++p) {
              if (p < l.splits) sum += part[(p * l.rows + r) * l.cols + lc];
            }
            zp[k][g] = sum;
            x[k][g] = to_f32(xp_s[r * l.cols + lc]);
            bias[k][g] = bias_s[lc];
          }
#pragma unroll
          for (int q = 0; q < S; ++q) st[k][q] = own[q * own_n + (b0 + r) * units + u];
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (!live[k]) continue;
          const int i = i0 + k * kThreads;
          const int r = i / units, u = i % units;
          const int b = b0 + r, j = cta.j0 + u;
          const float y = Cell::template update<T>(zp[k], x[k], bias[k], mask_s[r], st[k]);
#pragma unroll
          for (int q = 0; q < S; ++q) own[q * own_n + b * units + u] = st[k][q];
          a.h_buf[cta.state_at((s + 1) & 1, b, j)] = from_f32<T>(st[k][0]);
          a.y[cta.y_at(t, b, j)] = from_f32<T>(y);
        }
      }
      __syncthreads();
    }
    if (s + 1 < a.n_t) {
      grid::barrier_arrive(a.counters + cta.d);
      cta.prefetch(time_of(s + 1, a.n_t, rev), 0, min(l.rows, a.n_b), n_chunks);
      grid::barrier_wait(a.counters + cta.d, (s + 1) * a.plan.ctas);
    }
  }
  if (S == 2) {   // c leaves the CTA once, as the final carry in slot n_t % 2
    for (int i = threadIdx.x; i < own_n; i += kThreads) {
      const int j = cta.j0 + i % units;
      if (j < a.n_h)
        a.c_buf[cta.state_at(a.n_t & 1, i / units, j)] = from_f32<T>(own[own_n + i]);
    }
  }
}

// The kernel that runs a plan: with register rows or without, at the
// plan's rows a pass (null for rows it is not built for).
template <typename T, class Cell, int R>
auto kernel_at(bool reg) -> void (*)(Args<T>) {
  if constexpr (sizeof(T) == 4) {
    if (reg) return persistent_scan<T, Cell, true, R>;
  }
  return persistent_scan<T, Cell, false, R>;
}

template <typename T, class Cell>
auto kernel_for(bool reg, int rows) -> void (*)(Args<T>) {
  if constexpr (sizeof(T) == 2) {
    return rows == kBf16Rows ? kernel_at<T, Cell, kBf16Rows>(false) : nullptr;
  } else {
    switch (rows) {
      case 8: return kernel_at<T, Cell, 8>(reg);
      case 12: return kernel_at<T, Cell, 12>(reg);
      case 16: return kernel_at<T, Cell, 16>(reg);
      case kMaxRows: return kernel_at<T, Cell, kMaxRows>(reg);
      default: return nullptr;
    }
  }
}

// Checks the plan against the call and the device, then launches the
// persistent kernel once on `stream` for all n_t > 0 steps. Returns a
// cudaError_t: cudaErrorInvalidValue for a plan that does not fit,
// cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident,
// or the launch's own error.
template <typename T, class Cell>
cudaError_t launch(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
                   void* h_buf, void* c_buf, void* y, void* counters, const int* plan_ints,
                   int n_dir, int n_t, int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  if (plan_ints == nullptr || counters == nullptr) return cudaErrorInvalidValue;
  // the kernel's row indices (Cta::state_at, y_at) are ints
  if (2LL * n_dir * (n_t > 1 ? n_t : 1) * n_b > INT_MAX) return cudaErrorInvalidValue;
  const Plan p{plan_ints[0], plan_ints[1], plan_ints[2], plan_ints[3], plan_ints[4],
               plan_ints[5], plan_ints[6], plan_ints[7], plan_ints[8]};
  const Layout l = layout(Cell::kGates, sizeof(T), n_h, n_b, Cell::kState, p);
  int sm_count = 0, optin = 0;
  cudaError_t err = grid::device_limits(&sm_count, &optin);
  if (err != cudaSuccess) return err;
  err = check_plan(p, l, Cell::kGates, sizeof(T), n_dir, n_h, sm_count, optin);
  if (err != cudaSuccess || n_t == 0) return err;
  const auto kernel = kernel_for<T, Cell>(p.reg > 0, p.rows);
  err = grid::fit_coresident(kernel, kThreads, l.total, n_dir * p.ctas, sm_count);
  if (err != cudaSuccess) return err;
  Args<T> args{{},
               static_cast<const T*>(xp), static_cast<const float*>(mask),
               static_cast<const T*>(w_hh), static_cast<const T*>(b_hh),
               static_cast<T*>(h_buf), static_cast<T*>(c_buf), static_cast<T*>(y),
               static_cast<int*>(counters), n_t, n_b, n_h, reverse_bits, p, l};
  if (wide_pass(sizeof(T), p.rows)) {
    err = hopper::f32_tensor_map_3d(&args.h_map, h_buf, n_h, n_b, 2 * n_dir,
                                    p.chunk_bytes / 4, p.rows);
    if (err != cudaSuccess) return err;
  }
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.ctas, n_dir),
                                    dim3(kThreads), params, static_cast<size_t>(l.total),
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The persistent kernel as built for T, with register rows (reg) or
// without, at `rows` a pass: out[0] registers a thread, out[1] static
// shared memory a CTA in bytes, out[2] 0 (the dynamic shared memory is the
// plan's), out[3] local memory a thread in bytes, out[4] 0 (the units are
// the plan's).
template <typename T, class Cell>
cudaError_t attributes(bool reg, int rows, int* out) {
  const auto kernel = kernel_for<T, Cell>(reg, rows);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = 0;
  return cudaSuccess;
}

}  // namespace persist
}  // namespace dsjax_torch
