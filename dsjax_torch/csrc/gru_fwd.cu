// Masked GRU forward recurrence for Hopper, sm_90a: inference (K4) and the
// residual-saving forward of training (K4 with residuals).
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
// What bounds it on this card. As for the LSTM (lstm_fwd.cu): each step of a
// direction reads all of W_hh (12 MB in f32, 6 MB in bf16 at H = 1024) and
// does 2 * B * H * 3H FLOP with it (50 MFLOP at B = 8), and the steps are
// dependent, so at serving shapes the kernel is bound by the rate at which
// W_hh streams from L2 (both directions' 24 MB fit in the 50 MB L2) and by
// each step's latency, not by the arithmetic units. At the training batch
// (B = 64) the 403 MFLOP per step and direction on CUDA cores bound it.
//
// What the design does about it. The LSTM kernel's design, with three gate
// columns per unit instead of four: one launch per time step covers both
// directions, grid (H / kUnits, directions), 256 CTAs at H = 1024. Each CTA
// owns kUnits hidden units and computes their r, z and n columns for every
// batch row, so it can finish the update itself: nothing crosses CTAs within
// a step. A warp takes kColsPerWarp rows of W_hh (stored (3H, H), so a gate
// column is one contiguous row) with 16-byte loads and multiplies them
// against h_{t-1}, which the CTA stages in shared memory in f32. The launch
// boundary is the barrier between steps, so h is double-buffered in device
// memory. The residual writes are a template flag. W_hh resident in shared
// memory across steps, and wgmma, are later work.

#include "lstm_common.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kUnits = 8;                      // hidden units per CTA
constexpr int kCols = 3 * kUnits;              // their r, z, n columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerWarp = kCols / kWarps;   // 3
constexpr int kRows = 8;                       // batch rows per pass over W_hh

static_assert(kCols % kWarps == 0, "columns must split evenly over warps");
static_assert(kRows * kUnits <= kThreads, "one thread per (row, unit)");

// One time step of every direction.
//   xp    (D, T, B, 3H)   input projections, b_ih included
//   mask  (T, B) f32      1 where t < length
//   w_hh  (D, 3H, H)      recurrent weights, rows in gate order r, z, n
//   b_hh  (D, 3H)
//   h_in  (D, B, H)       carry entering the step; h_out leaving it
//   y     (D, T, B, H)
//   gates (D, T, B, 4H)   (r, z, n, hn), written only when kSave
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const T* __restrict__ xp, const float* __restrict__ mask,
                const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                const T* __restrict__ h_in, T* __restrict__ h_out, T* __restrict__ y,
                T* __restrict__ gates, int n_t, int n_b, int n_h, int step, int reverse_bits) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* h_s = smem;                    // (kRows, H): h_{t-1} in f32
  float* z_s = smem + kRows * n_h;      // (kCols, kRows): h . W_hh^T

  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int t = time_of(step, n_t, (reverse_bits >> d) & 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t g3 = 3 * static_cast<size_t>(n_h);

  // Local column lc is gate lc / kUnits of unit j0 + lc % kUnits.
  const T* w_rows[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int lc = warp * kColsPerWarp + c;
    const size_t col = static_cast<size_t>(lc / kUnits) * n_h + j0 + lc % kUnits;
    w_rows[c] = w_hh + d * g3 * n_h + col * n_h;
  }
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;

  for (int b0 = 0; b0 < n_b; b0 += kRows) {
    const int nb = min(kRows, n_b - b0);
    const T* h_rows = h_in + state_d + static_cast<size_t>(b0) * n_h;
    for (int i = threadIdx.x; i < kRows * n_h; i += kThreads) {
      h_s[i] = i < nb * n_h ? to_f32(h_rows[i]) : 0.f;
    }
    __syncthreads();

    float acc[kColsPerWarp][kRows];
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
    }
#pragma unroll 2
    for (int k = lane * V; k < n_h; k += 32 * V) {
      float w[kColsPerWarp][V];
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c) load16(w_rows[c] + k, w[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float hv[V];
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(h_s + r * n_h + k + q);
          hv[q] = v.x; hv[q + 1] = v.y; hv[q + 2] = v.z; hv[q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
          for (int q = 0; q < V; ++q) acc[c][r] = fmaf(w[c][q], hv[q], acc[c][r]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s = acc[c][r];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) z_s[(warp * kColsPerWarp + c) * kRows + r] = s;
      }
    }
    __syncthreads();

    if (threadIdx.x < nb * kUnits) {
      const int r = threadIdx.x / kUnits;
      const int u = threadIdx.x % kUnits;
      const int j = j0 + u;
      const int b = b0 + r;
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
      const T* xp_row = xp + row * g3;
      const T* bias = b_hh + d * g3;
      float hp[3];
      float xg[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int col = g * n_h + j;
        hp[g] = z_s[(g * kUnits + u) * kRows + r] + to_f32(bias[col]);
        xg[g] = to_f32(xp_row[col]);
      }
      const float r_g = sigmoid(xg[0] + hp[0]);
      const float z_g = sigmoid(xg[1] + hp[1]);
      const float n_g = tanhf(xg[2] + r_g * hp[2]);
      const size_t s = state_d + static_cast<size_t>(b) * n_h + j;
      const float h_prev = h_s[r * n_h + j];
      const float h_new = (1.f - z_g) * n_g + z_g * h_prev;
      const float m = mask[static_cast<size_t>(t) * n_b + b];
      h_out[s] = from_f32<T>(m * h_new + (1.f - m) * h_prev);
      y[row * n_h + j] = from_f32<T>(h_new * m);
      if constexpr (kSave) {
        T* g_row = gates + row * 4 * static_cast<size_t>(n_h);
        g_row[j] = from_f32<T>(r_g);
        g_row[n_h + j] = from_f32<T>(z_g);
        g_row[2 * n_h + j] = from_f32<T>(n_g);
        g_row[3 * n_h + j] = from_f32<T>(hp[2]);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kSave>
int run_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
             void* h_buf, void* y, void* gates, int n_dir, int n_t, int n_b, int n_h,
             int reverse_bits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows * n_h + kCols * kRows) * sizeof(float);
  auto kernel = gru_step_kernel<T, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_h / kUnits, n_dir);
  const size_t state = static_cast<size_t>(n_dir) * n_b * n_h;
  T* h = static_cast<T*>(h_buf);
  for (int s = 0; s < n_t; ++s) {
    const size_t in = (s & 1) * state;
    const size_t out = ((s + 1) & 1) * state;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const float*>(mask),
        static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), h + in, h + out,
        static_cast<T*>(y), static_cast<T*>(gates), n_t, n_b, n_h, s, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int dispatch_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
                  void* h_buf, void* y, void* gates, int n_dir, int n_t, int n_b, int n_h,
                  int reverse_bits, cudaStream_t stream) {
  if (gates != nullptr) {
    return run_scan<T, true>(xp, mask, w_hh, b_hh, h_buf, y, gates, n_dir, n_t, n_b, n_h,
                             reverse_bits, stream);
  }
  return run_scan<T, false>(xp, mask, w_hh, b_hh, h_buf, y, nullptr, n_dir, n_t, n_b, n_h,
                            reverse_bits, stream);
}

}  // namespace

// Runs all n_t steps of one layer on `stream`. h_buf is (2, D, B, H): slot 0
// holds the initial carry, and the final carry is left in slot n_t % 2.
// gates (D, T, B, 4H) is null for inference (K4) or set for the
// residual-saving forward. Requires n_h % 8 == 0. Returns a cudaError_t: the
// first error any launch reported, or cudaSuccess.
extern "C" int dsjax_torch_gru_fwd(const void* xp, const void* mask, const void* w_hh,
                                   const void* b_hh, void* h_buf, void* y, void* gates,
                                   int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
                                   int is_bf16, void* stream) {
  if (n_h % kUnits != 0 || n_h % Vec<__nv_bfloat16>::N != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_scan<__nv_bfloat16>(xp, mask, w_hh, b_hh, h_buf, y, gates, n_dir, n_t,
                                        n_b, n_h, reverse_bits, s);
  }
  return dispatch_scan<float>(xp, mask, w_hh, b_hh, h_buf, y, gates, n_dir, n_t, n_b, n_h,
                              reverse_bits, s);
}
