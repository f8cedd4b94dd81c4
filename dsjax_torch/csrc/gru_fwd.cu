// Masked GRU forward recurrence for Hopper, sm_90a: inference (K4) and the
// residual-saving forward of training (K4 with residuals, K4r).
//
// Replaces dsjax/ops/gru_pallas.py:_fwd_kernel (_gru_fwd_pallas): with
// save_residuals=False, the primal of gru_scan (K4), and with
// save_residuals=True, the forward of its custom VJP. Contract, per
// direction d, in f32 (gate order r, z, n as torch's nn.GRU):
//   hp   = h_{t-1} . W_hh^T + b_hh
//   r    = sigmoid(xr + hr);  z = sigmoid(xz + hz)
//   n    = tanh(xn + r * hn)                       b_hn inside the product
//   h'   = (1 - z) * n + z * h_{t-1}
//   h    = m * h' + (1 - m) * h_{t-1}              rounded to the working type
//   y[t] = h' * m                                  from the unrounded h'
// Direction d scans time backwards when bit d of reverse_bits is set, which
// equals dsjax's flip of the whole padded array (dsjax/model/ds2.py:334-346).
// When saving, step t also writes (r, z, n, hn) to gates[t] (4H columns),
// rounded to the working type and stored at natural time t, as y is
// (gru_pallas.py:101-104). The reverse scan (gru_bwd.cu) reads them back
// instead of recomputing h_{t-1} . W_hh^T.
//
// K4, inference, is K1's persistent kernel (scan_persist.cuh) with three
// gates and no c: one cooperative launch a layer call, the time loop
// inside, each CTA's W_hh rows resident in shared memory (streamed from L2
// only where they do not fit), its own units' h kept there for all T
// steps, one barrier a step within each direction. GruCell below is its
// update. With one direction (the streaming GRU + Lookahead model) a CTA
// owns 8 units, with two 16 (H = 1024, 132 SMs).
// Where its step's time goes, and the forms tried and dropped, are at the
// top of scan_persist.cuh.
//
// K4r runs one launch per time step for every direction, grid (units /
// units a CTA, directions); a CTA owns a set of hidden units and computes
// their r, z and n columns for every batch row, so it finishes the update
// itself and nothing crosses CTAs within a step. The launch boundary is
// the barrier between steps, so h is double-buffered in device memory.
//
// K4r, the training forward (gru_residual_step_kernel), is lstm_fwd.cu's
// K2 with three gate columns a unit. What bounds it: at B = 64, H = 1024 a
// step of a direction is 2 * B * 3H * H = 403 MFLOP, about 0.4 us of the
// tensor cores; what remains in bf16 is the bytes every CTA takes in from
// L2 each step (the 64-row h_{t-1} block and its own 48 W_hh rows: 128 +
// 96 KB) and the latency of one launch a step, 12.4 us a launch for both
// directions (H100 80GB HBM3 at 700 W, tools/torch_lstm_microbench.py). In
// f32 the FMA pipes bound it (20.4 ms a layer call at T = 512,
// chip_smoke.py). The first form of K4r (the per-step K4 kernel with the writes) ran
// the product on CUDA cores from an f32 copy of 8 rows of h, 8 passes over
// its W_hh rows a step at B = 64 with a warp-wide reduction for every
// (column, row) pair: 67.4 us a launch, 35.3 ms a layer call in bf16
// against 7.1 now (the microbench, in turns in one call).
//
// What the design does about it: a CTA owns kResUnits = 16 hidden units,
// 48 gate columns (64 CTAs a direction at H = 1024, one wave for both
// directions), and computes
//   Z[64 rows, 48 cols] = h_{t-1}[rows, 0:H] . W_hh[cols, 0:H]^T
// for every batch row of a 64-row block in one pass over its W_hh rows
// (scan_mma.cuh, the product of K3 and K5 with the operands swapped):
// h_{t-1} in the working type straight from the carry (dsjax multiplies h
// in W's dtype with f32 sums, gru_pallas.py:73) and gate g's 16 rows at
// W_hh + (g * H + j0) * H, staged with 16-byte cp.async 3 stages deep;
// bf16 on tensor cores (mma.sync m16n8k16, f32 accumulators), f32 on
// register-blocked FMA (no TF32). b_hn stays inside r * (hn + b_hn). The
// epilogue's inputs (xp's 48 columns, b_hh, h_{t-1}, the mask) are loaded
// before the product: K4r keeps them across it without spilling (246
// registers in bf16, 255 in f32). A thread then finishes a pair of
// neighbouring units of two rows with 2-wide loads and stores, with the
// first form's roundings. At H % 16 != 0 the copy zero-fills the last
// CTA's missing W_hh rows. Tried and dropped: K3's product as it is at 48
// columns (an 8-way K split, 96 accumulators a thread) spilled 56 bytes a
// thread in bf16 and took 7.6 ms a layer call in bf16. Later forms: those
// of K2 (lstm_fwd.cu).
//
// K4's earlier form ran one launch of 256 CTAs a step (8 units a CTA):
// every step each CTA re-read its W_hh rows from L2, staged 8 rows of
// h_{t-1} in f32 and reduced every (column, row) pair across a warp; 5.5
// and 5.7 ms a call in f32 and bf16 at T = 501, B = 8, H = 1024, both
// directions, about 11 us a step (PERF.md): latency-bound.

#include "lstm_common.cuh"
#include "scan_mma.cuh"
#include "scan_persist.cuh"

namespace {

using namespace dsjax_torch;
namespace sm = dsjax_torch::scan_mma;

// K4r
constexpr int kResUnits = 16;                          // hidden units per CTA
constexpr int kResCols = 3 * kResUnits;                // their r, z, n columns
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

// The epilogue's inputs for one row and a unit pair, in the working type
// (x: unit j, y: unit j + 1).
template <typename T>
struct Item {
  bool valid;
  float m;
  typename Pair<T>::type xp[3], h;
};

// One unit of the update, with the contract's roundings, from the
// product's z[3] (without b_hh), b_hh, xp's columns, h_{t-1} and the mask.
struct Cell {
  float h_keep, y, r, z, n, hn;
};

__device__ __forceinline__ Cell gru_cell(const float (&zp)[3], const float (&bias)[3],
                                         const float (&xg)[3], float h_prev, float m) {
  Cell out;
  const float hr = zp[0] + bias[0];
  const float hz = zp[1] + bias[1];
  out.hn = zp[2] + bias[2];
  out.r = sigmoid(xg[0] + hr);
  out.z = sigmoid(xg[1] + hz);
  out.n = tanhf(xg[2] + out.r * out.hn);
  const float h_new = (1.f - out.z) * out.n + out.z * h_prev;
  out.h_keep = m * h_new + (1.f - m) * h_prev;
  out.y = h_new * m;
  return out;
}

// K4's update for scan_persist.cuh: state {h} of one unit, rounded to the
// working type in place; returns y.
struct GruCell {
  static constexpr int kGates = 3;
  static constexpr int kState = 1;

  template <typename T>
  __device__ __forceinline__ static float update(const float (&zp)[3], const float (&x)[3],
                                                 const float (&bias)[3], float m,
                                                 float (&state)[1]) {
    const Cell c = gru_cell(zp, bias, x, state[0], m);
    state[0] = persist::round_to<T>(c.h_keep);
    return c.y;
  }
};

// One time step of every direction, saving residuals (K4r).
//   xp    (D, T, B, 3H)   input projections, b_ih included
//   mask  (T, B) f32      1 where t < length
//   w_hh  (D, 3H, H)      recurrent weights, rows in gate order r, z, n
//   b_hh  (D, 3H)
//   h_in  (D, B, H)       carry entering the step; h_out leaving it
//   y     (D, T, B, H)
//   gates (D, T, B, 4H)   (r, z, n, hn)
template <typename T>
__global__ void __launch_bounds__(sm::kThreads, 1)
gru_residual_step_kernel(const T* __restrict__ xp, const float* __restrict__ mask,
                         const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                         const T* __restrict__ h_in, T* __restrict__ h_out, T* __restrict__ y,
                         T* __restrict__ gates, int n_t, int n_b, int n_h, int step,
                         int reverse_bits) {
  using S = sm::Shape<T, kResCols, kResStages>;
  extern __shared__ __align__(16) unsigned char stages[];
  float* z_s = reinterpret_cast<float*>(stages + S::kSmemBytes);  // (64, kResCols)

  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kResUnits;
  const int t = time_of(step, n_t, (reverse_bits >> d) & 1);
  const int u = 2 * (threadIdx.x % kPairs);
  const int j = j0 + u;
  const bool has_unit = j < n_h;   // H % 8 == 0: a pair is whole or past the edge
  const size_t g3 = 3 * static_cast<size_t>(n_h);
  const size_t g4 = 4 * static_cast<size_t>(n_h);
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;
  // gate g's rows of this CTA's units: w_rows + g * H * H, 16 rows of H
  const T* w_rows = w_hh + (d * g3 + j0) * n_h;
  float bx[3], by[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float2 v = has_unit ? load2(b_hh + d * g3 + g * n_h + j) : make_float2(0.f, 0.f);
    bx[g] = v.x;
    by[g] = v.y;
  }

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
      for (int g = 0; g < 3; ++g) it.xp[g] = load2_raw(xp + row * g3 + g * n_h + j);
      it.h = load2_raw(h_in + state_d + static_cast<size_t>(b) * n_h + j);
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
      float zx[3], zy[3], xx[3], xy[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 x = to_f32x2(it.xp[g]);
        const float2 zp = *reinterpret_cast<const float2*>(z_s + r * kResCols + g * kResUnits + u);
        zx[g] = zp.x;
        zy[g] = zp.y;
        xx[g] = x.x;
        xy[g] = x.y;
      }
      const float2 h_prev = to_f32x2(it.h);
      const Cell cx = gru_cell(zx, bx, xx, h_prev.x, it.m);
      const Cell cy = gru_cell(zy, by, xy, h_prev.y, it.m);
      store2(h_out + state_d + static_cast<size_t>(b) * n_h + j, cx.h_keep, cy.h_keep);
      store2(y + row * n_h + j, cx.y, cy.y);
      T* g_row = gates + row * g4 + j;
      store2(g_row, cx.r, cy.r);
      store2(g_row + n_h, cx.z, cy.z);
      store2(g_row + 2 * n_h, cx.n, cy.n);
      store2(g_row + 3 * n_h, cx.hn, cy.hn);
    }
  }
}

template <typename T>
int run_residual_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
                      void* h_buf, void* y, void* gates, int n_dir, int n_t, int n_b, int n_h,
                      int reverse_bits, cudaStream_t stream) {
  auto kernel = gru_residual_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         residual_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((n_h + kResUnits - 1) / kResUnits, n_dir);
  const size_t state = static_cast<size_t>(n_dir) * n_b * n_h;
  T* h = static_cast<T*>(h_buf);
  for (int s = 0; s < n_t; ++s) {
    const size_t in = (s & 1) * state;
    const size_t out = ((s + 1) & 1) * state;
    kernel<<<grid, sm::kThreads, residual_smem_bytes<T>(), stream>>>(
        static_cast<const T*>(xp), static_cast<const float*>(mask),
        static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), h + in, h + out,
        static_cast<T*>(y), static_cast<T*>(gates), n_t, n_b, n_h, s, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Runs all n_t steps of one layer on `stream`. h_buf is (2, D, B, H): slot 0
// holds the initial carry, and the final carry is left in slot n_t % 2.
// gates (D, T, B, 4H) is null for inference (K4) or set for the
// residual-saving forward (K4r). K4 is one cooperative launch (none at
// n_t = 0) with the plan of ops/lstm.py:scan_plan, persist::kPlanInts ints,
// checked again here, and `counters`, (D,) int32 zeroed; K4r reads
// neither. Requires n_h % 8 == 0, w_hh and h_buf on 16-byte boundaries,
// and K4 also xp; K4r also xp and b_hh on a boundary of two elements (it
// reads unit pairs). Returns a cudaError_t: the first error any launch
// reported, or cudaSuccess.
extern "C" int dsjax_torch_gru_fwd(const void* xp, const void* mask, const void* w_hh,
                                   const void* b_hh, void* h_buf, void* y, void* gates,
                                   int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
                                   int is_bf16, void* stream, const int* plan,
                                   void* counters) {
  if (n_h % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gates == nullptr) {
    return is_bf16 ? persist::launch<__nv_bfloat16, GruCell>(xp, mask, w_hh, b_hh, h_buf,
                                                             nullptr, y, counters, plan, n_dir,
                                                             n_t, n_b, n_h, reverse_bits, s)
                   : persist::launch<float, GruCell>(xp, mask, w_hh, b_hh, h_buf, nullptr, y,
                                                     counters, plan, n_dir, n_t, n_b, n_h,
                                                     reverse_bits, s);
  }
  if (is_bf16) {
    return run_residual_scan<__nv_bfloat16>(xp, mask, w_hh, b_hh, h_buf, y, gates, n_dir, n_t,
                                            n_b, n_h, reverse_bits, s);
  }
  return run_residual_scan<float>(xp, mask, w_hh, b_hh, h_buf, y, gates, n_dir, n_t, n_b,
                                  n_h, reverse_bits, s);
}

// K4r's step kernel for the working type: out[0] registers a thread, out[1]
// static and out[2] dynamic shared memory a CTA in bytes, out[3] local
// memory a thread in bytes (spills), out[4] hidden units a CTA. Returns a
// cudaError_t.
extern "C" int dsjax_torch_gru_fwd_attributes(int is_bf16, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      is_bf16 ? cudaFuncGetAttributes(&attr, gru_residual_step_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&attr, gru_residual_step_kernel<float>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = is_bf16 ? residual_smem_bytes<__nv_bfloat16>() : residual_smem_bytes<float>();
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kResUnits;
  return cudaSuccess;
}

// K4's persistent kernel for the working type, with register rows
// (register_rows > 0, float32 only) or without, at `rows` batch rows a pass
// (persist::attributes).
extern "C" int dsjax_torch_gru_scan_attributes(int is_bf16, int register_rows, int rows,
                                                  int* out) {
  if (is_bf16 && register_rows > 0) return cudaErrorInvalidValue;
  return is_bf16 ? persist::attributes<__nv_bfloat16, GruCell>(false, rows, out)
                 : persist::attributes<float, GruCell>(register_rows > 0, rows, out);
}
