// Masked LSTM forward recurrence for Hopper, sm_90a: inference (K1) and the
// residual-saving forward of training (K2).
//
// Replaces dsjax/ops/lstm_pallas.py:_fwd_kernel: with save_residuals=False,
// the primal of lstm_scan (K1), and with save_residuals=True, the forward of
// its custom VJP (K2, _vjp_fwd). Contract, per direction d:
//   z    = h_{t-1} . W_hh^T + xp[t] + b_hh       (f32 sums, gates i, f, g, o)
//   c'   = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   h, c = m * (h', c') + (1 - m) * (h, c)         rounded to the working type
//   y[t] = h' * m                                  from the unrounded h'
// Direction d scans time backwards when bit d of reverse_bits is set. That
// equals flipping xp and the mask, scanning, and flipping y back, which is
// how dsjax runs its backward direction (dsjax/model/ds2.py:334-346).
// When saving (K2), step t also writes the post-activation gates
// (sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)) to gates[t] and the kept
// carry c to c_seq[t], both rounded to the working type and stored at
// natural time t, as y is (lstm_pallas.py:133-141). The reverse scan reads
// them back instead of recomputing h_{t-1} . W_hh^T.
//
// K1, inference, is one persistent cooperative launch a layer call on
// scan_persist.cuh (its header comment gives the design): the time loop
// runs inside the kernel, each CTA keeps its W_hh rows on the SM (all in
// shared memory in bf16; in f32 at H = 1024 with two directions the last
// gate's 16 rows in registers and the other 48 in shared memory; where
// even that does not fit, the rest streamed from L2 each step) and its own
// units' h and c for all T steps, and the CTAs of a direction meet at one
// barrier a step. LstmCell below is its update.
// Where its step's time goes, and the forms tried and dropped, are at the
// top of scan_persist.cuh.
//
// K2 runs one launch per time step for every direction, grid (units /
// units a CTA, directions); a CTA owns a set of hidden units and computes
// their four gate columns for every batch row, so it finishes the cell
// update itself and nothing crosses CTAs within a step. The launch
// boundary is the barrier between steps, so h and c are double-buffered in
// device memory.
//
// K2, the training forward (lstm_residual_step_kernel). What bounds it: at
// B = 64, H = 1024 a step of a direction is 2 * B * 4H * H = 537 MFLOP,
// about 0.5 us of the tensor cores; what remains in bf16 is the bytes that
// every CTA takes in from L2 each step (the 64-row h_{t-1} block and its
// own 64 W_hh rows: 128 + 128 KB) and the latency of one launch a step,
// 14.4 us a launch for both directions (H100 80GB HBM3 at 700 W,
// tools/torch_lstm_microbench.py), what K3's and K5's launches take for
// their bytes. In f32 the FMA pipes bound it: 64 x 64 x H FMA a CTA a step
// (24.4 ms a layer call at T = 512, chip_smoke.py). The first form of K2
// (the per-step K1 kernel with the writes) ran the product on CUDA cores from an f32
// copy of 8 rows of h, passing over its W_hh rows 8 times a step at B = 64
// and reducing every (column, row) pair across a warp: 69.6 us a launch,
// 36.9 ms a layer call in bf16 against 8.2 now (the microbench, in turns
// in one call).
//
// What the design does about it: K3's step product (scan_mma.cuh) with
// the operands swapped. A CTA owns kResUnits = 16 hidden units, 64 gate
// columns: at H = 1024, 64 CTAs a direction, 128 for both, one wave on the
// 132 SMs. Each step it computes
//   Z[64 rows, 64 cols] = h_{t-1}[rows, 0:H] . W_hh[cols, 0:H]^T
// for every batch row of a 64-row block in one pass over its W_hh rows:
// h_{t-1} straight from the carry in the working type (dsjax also
// multiplies h in W's dtype with f32 sums, lstm_pallas.py:105) and gate
// g's 16 rows at W_hh + (g * H + j0) * H (scan_mma's groups of b rows),
// staged with 16-byte cp.async 3 stages deep; bf16 on tensor cores
// (mma.sync m16n8k16, f32 accumulators), f32 on register-blocked FMA (no
// TF32: its rounding of the sums would pass the f32 tolerance). Batches
// past 64 rows take one pass a block. The epilogue's xp columns and mask
// do not depend on the product and are loaded before it; b_hh, h and c
// after it. A thread finishes a pair of neighbouring units of two rows with
// 2-wide loads and stores, with the first form's roundings. At H % 16 != 0
// the copy zero-fills the last CTA's missing W_hh rows.
//
// Tried and dropped (the microbench, bf16, both directions, a layer call):
// K3's product as it is at 64 columns (an 8-way K split, 128 accumulators
// a thread) spilled 272 bytes a thread in bf16 and 88 in f32 at 255
// registers and took 14.0 ms; split into row halves and column parts, with
// b_hh, h and c loaded after the product, the kernel takes 220 (bf16) and
// 238 (f32) registers and spills nothing. Timed in turns and not taken,
// each within 3%: no loads before the product (8.26 ms against 8.34-8.44,
// but 7.40 against 7.28 with one direction), and 2 stages (8.15-8.17).
// Later forms: multicast the h tile to a cluster of CTAs so that L2 is read
// once a cluster, wgmma with M = 64 = B, W_hh resident in shared memory.
//
// K1's earlier form ran one launch of 256 CTAs a step:
// 8 units a CTA, every step re-reading the CTA's W_hh rows from L2 and
// reducing every (column, row) pair across a warp, 10.8 us a step in f32
// and bf16 alike (5.4 and 5.9 ms a call at T = 501, B = 8, H = 1024, both
// directions; PERF.md). Its per-step latency, not its bytes, bounded it.

#include "lstm_common.cuh"
#include "scan_mma.cuh"
#include "scan_persist.cuh"

namespace {

using namespace dsjax_torch;
namespace sm = dsjax_torch::scan_mma;

// K2
constexpr int kResUnits = 16;                          // hidden units per CTA
constexpr int kResCols = 4 * kResUnits;                // their i, f, g, o columns
constexpr int kResStages = 3;
constexpr int kPairs = kResUnits / 2;                  // a thread's units are a pair
constexpr int kRowsPerPass = sm::kThreads / kPairs;    // 32
constexpr int kPasses = sm::kRows / kRowsPerPass;      // rows of a block per thread: 2

static_assert(sm::kThreads % kPairs == 0 && sm::kRows % kRowsPerPass == 0,
              "threads cover a row block in whole passes");

template <typename T>
constexpr int residual_smem_bytes() {
  return sm::Shape<T, kResCols, kResStages>::kSmemBytes +
         sm::kRows * kResCols * static_cast<int>(sizeof(float));
}

// The epilogue's inputs that are loaded before the product for one row and
// a unit pair, in the working type (x: unit j, y: unit j + 1). b_hh, h and c
// are loaded after it: kept across the product too, they made the kernel
// spill.
template <typename T>
struct Item {
  bool valid;
  float m;
  typename Pair<T>::type xp[4];
};

// One unit of the cell update, with the contract's roundings; returns the
// kept h and c, h' * m and the post-activation gates.
struct Cell {
  float h_keep, c_keep, y, gate[4];
};

__device__ __forceinline__ Cell lstm_cell(const float (&z)[4], float h_prev, float c_prev,
                                          float m) {
  Cell out;
  out.gate[0] = sigmoid(z[0]);
  out.gate[1] = sigmoid(z[1]);
  out.gate[2] = tanhf(z[2]);
  out.gate[3] = sigmoid(z[3]);
  const float c_new = out.gate[1] * c_prev + out.gate[0] * out.gate[2];
  const float h_new = out.gate[3] * tanhf(c_new);
  out.c_keep = m * c_new + (1.f - m) * c_prev;
  out.h_keep = m * h_new + (1.f - m) * h_prev;
  out.y = h_new * m;
  return out;
}

// K1's update for scan_persist.cuh: state {h, c} of one unit, rounded to
// the working type in place; returns y.
struct LstmCell {
  static constexpr int kGates = 4;
  static constexpr int kState = 2;

  template <typename T>
  __device__ __forceinline__ static float update(const float (&zp)[4], const float (&x)[4],
                                                 const float (&bias)[4], float m,
                                                 float (&state)[2]) {
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = (zp[g] + x[g]) + bias[g];
    const Cell c = lstm_cell(z, state[0], state[1], m);
    state[0] = persist::round_to<T>(c.h_keep);
    state[1] = persist::round_to<T>(c.c_keep);
    return c.y;
  }
};

// One time step of every direction, saving residuals (K2).
//   xp    (D, T, B, 4H)   input projections, b_ih included
//   mask  (T, B) f32      1 where t < length
//   w_hh  (D, 4H, H)      recurrent weights, rows in gate order i, f, g, o
//   b_hh  (D, 4H)
//   h_in, c_in  (D, B, H) carry entering the step; h_out, c_out leaving it
//   y     (D, T, B, H)
//   gates (D, T, B, 4H), c_seq (D, T, B, H)
template <typename T>
__global__ void __launch_bounds__(sm::kThreads, 1)
lstm_residual_step_kernel(const T* __restrict__ xp, const float* __restrict__ mask,
                          const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                          const T* __restrict__ h_in, const T* __restrict__ c_in,
                          T* __restrict__ h_out, T* __restrict__ c_out, T* __restrict__ y,
                          T* __restrict__ gates, T* __restrict__ c_seq, int n_t, int n_b,
                          int n_h, int step, int reverse_bits) {
  using S = sm::Shape<T, kResCols, kResStages>;
  extern __shared__ __align__(16) unsigned char stages[];
  float* z_s = reinterpret_cast<float*>(stages + S::kSmemBytes);  // (64, kResCols)

  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kResUnits;
  const int t = time_of(step, n_t, (reverse_bits >> d) & 1);
  const int u = 2 * (threadIdx.x % kPairs);
  const int j = j0 + u;
  const bool has_unit = j < n_h;   // H % 8 == 0: a pair is whole or past the edge
  const size_t g4 = 4 * static_cast<size_t>(n_h);
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;
  // gate g's rows of this CTA's units: w_rows + g * H * H, 16 rows of H
  const T* w_rows = w_hh + (d * g4 + j0) * n_h;

  for (int b0 = 0; b0 < n_b; b0 += sm::kRows) {
    const int nb = min(sm::kRows, n_b - b0);
    // the epilogue's inputs first: none depends on the product
    Item<T> in[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = threadIdx.x / kPairs + p * kRowsPerPass;
      const int b = b0 + r;
      Item<T>& it = in[p];
      it.valid = r < nb && has_unit;
      if (!it.valid) continue;
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
#pragma unroll
      for (int g = 0; g < 4; ++g) it.xp[g] = load2_raw(xp + row * g4 + g * n_h + j);
      it.m = mask[static_cast<size_t>(t) * n_b + b];
    }

    sm::product<T, kResCols, kResStages>(h_in + state_d + static_cast<size_t>(b0) * n_h, n_h,
                                         nb, w_rows, n_h, min(kResUnits, n_h - j0), n_h,
                                         stages, z_s, static_cast<size_t>(n_h) * n_h);

#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const Item<T>& it = in[p];
      if (!it.valid) continue;
      const int r = threadIdx.x / kPairs + p * kRowsPerPass;
      const int b = b0 + r;
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
      const size_t st = state_d + static_cast<size_t>(b) * n_h + j;
      float zx[4], zy[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 x = to_f32x2(it.xp[g]);
        const float2 bias = load2(b_hh + d * g4 + g * n_h + j);
        const float2 zp = *reinterpret_cast<const float2*>(z_s + r * kResCols + g * kResUnits + u);
        zx[g] = (zp.x + x.x) + bias.x;
        zy[g] = (zp.y + x.y) + bias.y;
      }
      const float2 h_prev = load2(h_in + st);
      const float2 c_prev = load2(c_in + st);
      const Cell cx = lstm_cell(zx, h_prev.x, c_prev.x, it.m);
      const Cell cy = lstm_cell(zy, h_prev.y, c_prev.y, it.m);
      store2(h_out + st, cx.h_keep, cy.h_keep);
      store2(c_out + st, cx.c_keep, cy.c_keep);
      store2(y + row * n_h + j, cx.y, cy.y);
      store2(c_seq + row * n_h + j, cx.c_keep, cy.c_keep);
      T* g_row = gates + row * g4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) store2(g_row + g * n_h, cx.gate[g], cy.gate[g]);
    }
  }
}

template <typename T>
int run_residual_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
                      void* h_buf, void* c_buf, void* y, void* gates, void* c_seq, int n_dir,
                      int n_t, int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  auto kernel = lstm_residual_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         residual_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((n_h + kResUnits - 1) / kResUnits, n_dir);
  const size_t state = static_cast<size_t>(n_dir) * n_b * n_h;
  T* h = static_cast<T*>(h_buf);
  T* c = static_cast<T*>(c_buf);
  for (int s = 0; s < n_t; ++s) {
    const size_t in = (s & 1) * state;
    const size_t out = ((s + 1) & 1) * state;
    kernel<<<grid, sm::kThreads, residual_smem_bytes<T>(), stream>>>(
        static_cast<const T*>(xp), static_cast<const float*>(mask),
        static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), h + in, c + in,
        h + out, c + out, static_cast<T*>(y), static_cast<T*>(gates), static_cast<T*>(c_seq),
        n_t, n_b, n_h, s, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Runs all n_t steps of one layer on `stream`. h_buf and c_buf are
// (2, D, B, H): slot 0 holds the initial carry, and the final carry is left
// in slot n_t % 2. gates (D, T, B, 4H) and c_seq (D, T, B, H) are both null
// for inference (K1) or both set for the residual-saving forward (K2).
// K1 is one cooperative launch (none at n_t = 0) with the plan of
// ops/lstm.py:scan_plan, persist::kPlanInts ints, checked again here, and
// `counters`, (D,) int32 zeroed; K2 reads neither. Requires n_h % 8 == 0,
// w_hh and h_buf on 16-byte boundaries, and K1 also xp; K2 also xp and b_hh
// on a boundary of two elements (it reads unit pairs). Returns a
// cudaError_t: the first error any launch reported, or cudaSuccess.
extern "C" int dsjax_torch_lstm_fwd(const void* xp, const void* mask,
                                    const void* w_hh, const void* b_hh,
                                    void* h_buf, void* c_buf, void* y, void* gates,
                                    void* c_seq, int n_dir, int n_t, int n_b, int n_h,
                                    int reverse_bits, int is_bf16, void* stream,
                                    const int* plan, void* counters) {
  if (n_h % 8 != 0) return cudaErrorInvalidValue;
  if ((gates == nullptr) != (c_seq == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates == nullptr) {
    return is_bf16 ? persist::launch<__nv_bfloat16, LstmCell>(xp, mask, w_hh, b_hh, h_buf,
                                                              c_buf, y, counters, plan, n_dir,
                                                              n_t, n_b, n_h, reverse_bits, s)
                   : persist::launch<float, LstmCell>(xp, mask, w_hh, b_hh, h_buf, c_buf, y,
                                                      counters, plan, n_dir, n_t, n_b, n_h,
                                                      reverse_bits, s);
  }
  if (is_bf16) {
    return run_residual_scan<__nv_bfloat16>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, gates,
                                            c_seq, n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  return run_residual_scan<float>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, gates, c_seq, n_dir,
                                  n_t, n_b, n_h, reverse_bits, s);
}

// K2's step kernel for the working type: out[0] registers a thread, out[1]
// static and out[2] dynamic shared memory a CTA in bytes, out[3] local
// memory a thread in bytes (spills), out[4] hidden units a CTA. Returns a
// cudaError_t.
extern "C" int dsjax_torch_lstm_fwd_attributes(int is_bf16, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      is_bf16 ? cudaFuncGetAttributes(&attr, lstm_residual_step_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&attr, lstm_residual_step_kernel<float>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = is_bf16 ? residual_smem_bytes<__nv_bfloat16>() : residual_smem_bytes<float>();
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kResUnits;
  return cudaSuccess;
}

// K1's persistent kernel for the working type, with register rows
// (register_rows > 0, float32 only) or without, at `rows` batch rows a pass
// (persist::attributes).
extern "C" int dsjax_torch_lstm_scan_attributes(int is_bf16, int register_rows, int rows,
                                                  int* out) {
  if (is_bf16 && register_rows > 0) return cudaErrorInvalidValue;
  return is_bf16 ? persist::attributes<__nv_bfloat16, LstmCell>(false, rows, out)
                 : persist::attributes<float, LstmCell>(register_rows > 0, rows, out);
}

extern "C" const char* dsjax_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
