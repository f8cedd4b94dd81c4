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
// What bounds it on this card. At serving shapes (B = 8, H = 1024) every
// step of a direction reads all of W_hh: 16 MB in f32, 8 MB in bf16, and
// does only 2 * B * H * 4H = 67 MFLOP with it. The steps are dependent, so
// the kernel is bound by the bandwidth at which W_hh streams in and by the
// latency of each step, not by the tensor cores. Both directions' W_hh
// (32 MB in f32) fit in the 50 MB L2, so after the first step they stream
// from L2, not from HBM. At training shapes (B = 64) a CTA passes over its
// W_hh rows once per kRows batch rows, 8 times a step; the residual writes
// add 5H working-type values per row and step.
//
// What the design does about it. One launch per time step covers both
// directions: grid (H / kUnits, directions), 256 CTAs at H = 1024. Each CTA
// owns kUnits hidden units, so it computes the four gate columns of those
// units for all batch rows and can finish the cell update itself: nothing
// crosses CTAs within a step. A warp takes kColsPerWarp rows of W_hh
// (W_hh is stored (4H, H), so a gate column is one contiguous row), reads
// them with 16-byte loads, and multiplies them against h_{t-1}, which the
// CTA stages in shared memory in f32. The launch boundary is the barrier
// between steps, so h and c are double-buffered in device memory and no
// grid-wide barrier exists to deadlock. The residual writes are a template
// flag: the inference kernel (K1) has none of them. Keeping W_hh resident in
// shared memory across steps (a persistent kernel with a grid barrier per
// step) and wgmma are later work.

#include "lstm_common.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kUnits = 8;                      // hidden units per CTA
constexpr int kCols = 4 * kUnits;              // their i, f, g, o columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerWarp = kCols / kWarps;   // 4
constexpr int kRows = 8;                       // batch rows per pass over W_hh

static_assert(kCols % kWarps == 0, "columns must split evenly over warps");
static_assert(kRows * kUnits <= kThreads, "one thread per (row, unit)");

// One time step of every direction.
//   xp    (D, T, B, 4H)   input projections, b_ih included
//   mask  (T, B) f32      1 where t < length
//   w_hh  (D, 4H, H)      recurrent weights, rows in gate order i, f, g, o
//   b_hh  (D, 4H)
//   h_in, c_in  (D, B, H) carry entering the step; h_out, c_out leaving it
//   y     (D, T, B, H)
//   gates (D, T, B, 4H), c_seq (D, T, B, H)   written only when kSave
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ xp, const float* __restrict__ mask,
                 const T* __restrict__ w_hh, const T* __restrict__ b_hh,
                 const T* __restrict__ h_in, const T* __restrict__ c_in,
                 T* __restrict__ h_out, T* __restrict__ c_out,
                 T* __restrict__ y, T* __restrict__ gates, T* __restrict__ c_seq,
                 int n_t, int n_b, int n_h, int step, int reverse_bits) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* h_s = smem;                    // (kRows, H): h_{t-1} in f32
  float* z_s = smem + kRows * n_h;      // (kCols, kRows): h . W_hh^T

  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int t = time_of(step, n_t, (reverse_bits >> d) & 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t g4 = 4 * static_cast<size_t>(n_h);

  // Local column lc is gate lc / kUnits of unit j0 + lc % kUnits.
  const T* w_rows[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int lc = warp * kColsPerWarp + c;
    const size_t col = static_cast<size_t>(lc / kUnits) * n_h + j0 + lc % kUnits;
    w_rows[c] = w_hh + d * g4 * n_h + col * n_h;
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
      const T* xp_row = xp + row * g4;
      const T* bias = b_hh + d * g4;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int col = g * n_h + j;
        z[g] = (z_s[(g * kUnits + u) * kRows + r] + to_f32(xp_row[col])) + to_f32(bias[col]);
      }
      const float i_s = sigmoid(z[0]);
      const float f_s = sigmoid(z[1]);
      const float g_t = tanhf(z[2]);
      const float o_s = sigmoid(z[3]);
      const size_t s = state_d + static_cast<size_t>(b) * n_h + j;
      const float c_prev = to_f32(c_in[s]);
      const float h_prev = h_s[r * n_h + j];
      const float c_new = f_s * c_prev + i_s * g_t;
      const float h_new = o_s * tanhf(c_new);
      const float m = mask[static_cast<size_t>(t) * n_b + b];
      const T c_keep = from_f32<T>(m * c_new + (1.f - m) * c_prev);
      h_out[s] = from_f32<T>(m * h_new + (1.f - m) * h_prev);
      c_out[s] = c_keep;
      y[row * n_h + j] = from_f32<T>(h_new * m);
      if constexpr (kSave) {
        T* g_row = gates + row * g4;
        g_row[j] = from_f32<T>(i_s);
        g_row[n_h + j] = from_f32<T>(f_s);
        g_row[2 * n_h + j] = from_f32<T>(g_t);
        g_row[3 * n_h + j] = from_f32<T>(o_s);
        c_seq[row * n_h + j] = c_keep;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kSave>
int run_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
             void* h_buf, void* c_buf, void* y, void* gates, void* c_seq, int n_dir,
             int n_t, int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows * n_h + kCols * kRows) * sizeof(float);
  auto kernel = lstm_step_kernel<T, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_h / kUnits, n_dir);
  const size_t state = static_cast<size_t>(n_dir) * n_b * n_h;
  T* h = static_cast<T*>(h_buf);
  T* c = static_cast<T*>(c_buf);
  for (int s = 0; s < n_t; ++s) {
    const size_t in = (s & 1) * state;
    const size_t out = ((s + 1) & 1) * state;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const float*>(mask),
        static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), h + in, c + in,
        h + out, c + out, static_cast<T*>(y), static_cast<T*>(gates),
        static_cast<T*>(c_seq), n_t, n_b, n_h, s, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int dispatch_scan(const void* xp, const void* mask, const void* w_hh, const void* b_hh,
             void* h_buf, void* c_buf, void* y, void* gates, void* c_seq, int n_dir,
             int n_t, int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  if (gates != nullptr) {
    return run_scan<T, true>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, gates, c_seq,
                             n_dir, n_t, n_b, n_h, reverse_bits, stream);
  }
  return run_scan<T, false>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, nullptr, nullptr,
                            n_dir, n_t, n_b, n_h, reverse_bits, stream);
}

}  // namespace

// Runs all n_t steps of one layer on `stream`. h_buf and c_buf are
// (2, D, B, H): slot 0 holds the initial carry, and the final carry is left
// in slot n_t % 2. gates (D, T, B, 4H) and c_seq (D, T, B, H) are both null
// for inference (K1) or both set for the residual-saving forward (K2).
// Requires n_h % 8 == 0. Returns a cudaError_t: the first error any launch
// reported, or cudaSuccess.
extern "C" int dsjax_torch_lstm_fwd(const void* xp, const void* mask,
                                    const void* w_hh, const void* b_hh,
                                    void* h_buf, void* c_buf, void* y, void* gates,
                                    void* c_seq, int n_dir, int n_t, int n_b, int n_h,
                                    int reverse_bits, int is_bf16, void* stream) {
  if (n_h % kUnits != 0 || n_h % Vec<__nv_bfloat16>::N != 0) return cudaErrorInvalidValue;
  if ((gates == nullptr) != (c_seq == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_scan<__nv_bfloat16>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, gates, c_seq,
                                   n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  return dispatch_scan<float>(xp, mask, w_hh, b_hh, h_buf, c_buf, y, gates, c_seq, n_dir,
                              n_t, n_b, n_h, reverse_bits, s);
}

extern "C" const char* dsjax_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
