// Masked LSTM reverse scan (the backward of training, K3) for Hopper, sm_90a.
//
// Replaces dsjax/ops/lstm_pallas.py:_bwd_kernel (_lstm_bwd_pallas), the
// backward of lstm_scan's custom VJP. It reads the post-activation gates and
// the kept carry c that the residual-saving forward (lstm_fwd.cu, K2) wrote,
// and walks the steps of each direction in reverse scan order. Per step, in
// f32 (dh, dc are the carries from the step after it in scan order):
//   c'    = f * c_prev + i * g;  tc = tanh(c')      (c_prev: the kept carry
//            of the previous scan step, c0 at the first)
//   dh_a  = dh + dy[t] * m;  dc_a = dc;  dh_n = dh_a * m;  dc_n = dc_a * m
//   dc_t  = dc_n + dh_n * o * (1 - tc^2)
//   dgates[t] = (dc_t g i (1 - i), dc_t c_prev f (1 - f), dc_t i (1 - g^2),
//                dh_n tc o (1 - o))                  rounded to the working type
//   dh    = dgates[t] . W_hh + dh_a * (1 - m);  dc = dc_t * f + dc_a * (1 - m)
// and after the last step dh0 = dh, dc0 = dc, rounded. dgates is dxp; the
// caller reduces dW and db from it with one matrix product each, as dsjax
// does outside its kernel (_vjp_bwd).
//
// Structure. The elementwise part is unit-local, but dh[b, j] = sum_k
// dgates[b, k] W_hh[k, j] needs all 4H dgates of a row, which every CTA
// writes: the step's result crosses CTAs. The dgates output is the exchange
// between CTAs, and the launch boundary is the barrier: launch k first
// finishes the product for the step that launch k - 1 wrote, then runs the
// elementwise part of its own step and writes that step's dgate columns. A
// last launch (k = T) only finishes the product and writes dh0, dc0. So
// T + 1 launches cover a layer, both directions in one grid
// (ceil(H / kUnits), directions). The dh and dc carries of a CTA's units
// stay in f32 buffers in device memory that only that CTA touches.
//
// The step product. A CTA owns kUnits = 16 hidden units and computes
// Z[rows, 16] = dgates[t_prev][rows, 0:4H] . W_hh^T[16 units, 0:4H]^T for
// every batch row at once, in blocks of 64 rows (scan_mma.cuh): one pass
// over its W_hh rows a step at B <= 64. The previous step's dgates and the
// CTA's W_hh^T rows are staged with 16-byte cp.async in the working type,
// 4 stages of 512 bytes a row; in bf16 the product runs on tensor cores
// (mma.sync m16n8k16, f32 accumulators, ldmatrix from padded rows), in f32
// on CUDA cores from the same tiles. dgates are read in the working type,
// which is dsjax's cast of dgates to W's dtype before the product
// (lstm_pallas.py:296-298); the sums run in f32. The epilogue's inputs of
// step s (gates, kept carry, dy, mask, the carries) do not depend on the
// product and are loaded before it; a thread then finishes a pair of
// neighbouring units of two rows, with 2-wide loads and stores.
//
// Why kUnits = 16. At H = 1024 that is 64 CTAs a direction, 128 for both
// directions: one wave on the H100's 132 SMs, each CTA reading its 128 KB
// (bf16) of W_hh^T and the 512 KB dgates block of B = 64 once a step, about
// 80 MB of L2 reads a step for both directions. 32 units would halve the
// CTAs re-reading dgates (49 MB a step) but leave half the SMs idle, and
// each CTA would pull 768 KB instead of 640 KB through its own L2 port (on
// an H100 at T = 512, B = 64, bf16: 20.0 ms a layer call against 13.1).
//
// What bounds it. Each step's 2 * B * 4H * H FLOP a direction (1.1 GFLOP
// for both directions at B = 64, H = 1024) are a few microseconds of the
// tensor cores; what remains is the dgates block that every CTA re-reads
// from L2 each step and the latency of one launch a step (the launch
// boundary is the only barrier across CTAs). Next: multicast the dgates
// tile to a cluster of CTAs (Hopper thread block clusters) so that L2 is
// read once per cluster; wgmma with M = 64 = B; then the persistent form
// with W_hh resident in shared memory and one grid barrier a step
// (ROADMAP Queue 2 item 4).

#include "lstm_common.cuh"
#include "scan_mma.cuh"

namespace {

using namespace dsjax_torch;
namespace sm = dsjax_torch::scan_mma;

constexpr int kUnits = 16;                           // hidden units per CTA
constexpr int kThreads = sm::kThreads;
constexpr int kPairs = kUnits / 2;                   // a thread's units are a pair
constexpr int kRowsPerPass = kThreads / kPairs;      // 32
constexpr int kPasses = sm::kRows / kRowsPerPass;    // rows of a block per thread: 2

static_assert(kThreads % kPairs == 0 && sm::kRows % kRowsPerPass == 0,
              "threads cover a row block in whole passes");

// The epilogue's inputs for one row and a unit pair, as 2-vectors (x: unit
// j, y: unit j + 1).
struct Item {
  bool valid;
  float m;
  float2 dh, dc, i, f, g, o, c_prev, dy;
};

// One unit of the elementwise step: the dgates of its 4 gate columns and
// the carries handed to the step before it.
__device__ __forceinline__ void cell(float dh, float dc_a, float i_s, float f_s, float g_t,
                                     float o_s, float c_prev, float dy, float m, float (&dg)[4],
                                     float& dh_rest, float& dc) {
  const float c_new = f_s * c_prev + i_s * g_t;
  const float tc = tanhf(c_new);
  const float dh_a = dh + dy * m;
  const float dh_n = dh_a * m;
  const float dc_n = dc_a * m;
  const float d_o = dh_n * tc;
  const float dc_t = dc_n + dh_n * o_s * (1.f - tc * tc);
  dg[0] = (dc_t * g_t) * i_s * (1.f - i_s);
  dg[1] = (dc_t * c_prev) * f_s * (1.f - f_s);
  dg[2] = (dc_t * i_s) * (1.f - g_t * g_t);
  dg[3] = d_o * o_s * (1.f - o_s);
  dh_rest = dh_a * (1.f - m);
  dc = dc_t * f_s + dc_a * (1.f - m);
}

template <typename T>
constexpr int smem_bytes() {
  return sm::Shape<T, kUnits>::kSmemBytes + sm::kRows * kUnits * static_cast<int>(sizeof(float));
}

// Launch `launch` of the reverse scan of every direction.
//   gates  (D, T, B, 4H)  post-activation gates i, f, g, o (from K2)
//   mask   (T, B) f32
//   w_t    (D, H, 4H)     W_hh transposed: row j holds unit j's 4H weights
//   c0     (D, B, H)      initial carry of the forward
//   c_seq  (D, T, B, H)   kept carry after each step (from K2)
//   dy     (D, T, B, H)
//   dg     (D, T, B, 4H)  dgates, written one step per launch
//   dh_rest, dc  (D, B, H) f32: dh_a * (1 - m) and dc of the last step run;
//                 on entry to launch 0, dh_T and dc_T
//   dh0, dc0     (D, B, H) written by the last launch
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_step_kernel(const T* __restrict__ gates, const float* __restrict__ mask,
                     const T* __restrict__ w_t, const T* __restrict__ c0,
                     const T* __restrict__ c_seq, const T* __restrict__ dy,
                     T* __restrict__ dg, float* __restrict__ dh_rest,
                     float* __restrict__ dc, T* __restrict__ dh0, T* __restrict__ dc0,
                     int n_t, int n_b, int n_h, int launch, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* z_s = reinterpret_cast<float*>(smem + sm::Shape<T, kUnits>::kSmemBytes);  // (64, kUnits)

  const int d = blockIdx.y;
  const bool rev = (reverse_bits >> d) & 1;
  const int j0 = blockIdx.x * kUnits;
  const int g4 = 4 * n_h;
  // this launch runs scan step s (none at the last launch, s = -1) and
  // finishes the product of step s + 1, which the previous launch ran
  const int s = n_t - 1 - launch;
  const bool has_prev = launch > 0;
  const int t = s >= 0 ? time_of(s, n_t, rev) : 0;
  const int t_prev = has_prev ? time_of(s + 1, n_t, rev) : 0;
  const int t_before = s > 0 ? time_of(s - 1, n_t, rev) : 0;
  const int u = 2 * (threadIdx.x % kPairs);
  const int j = j0 + u;
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;
  const T* w_rows = w_t + (static_cast<size_t>(d) * n_h + j0) * g4;

  for (int b0 = 0; b0 < n_b; b0 += sm::kRows) {
    const int nb = min(sm::kRows, n_b - b0);
    // the epilogue's inputs first: none depends on the product
    Item in[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = threadIdx.x / kPairs + p * kRowsPerPass;
      const int b = b0 + r;
      Item& it = in[p];
      it.valid = r < nb && j < n_h;
      if (!it.valid) continue;
      const size_t st = state_d + static_cast<size_t>(b) * n_h + j;
      it.dh = load2(dh_rest + st);
      it.dc = load2(dc + st);
      if (s < 0) continue;
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
      const T* g_row = gates + row * g4 + j;
      it.i = load2(g_row);
      it.f = load2(g_row + n_h);
      it.g = load2(g_row + 2 * n_h);
      it.o = load2(g_row + 3 * n_h);
      it.c_prev = s == 0 ? load2(c0 + st)
                         : load2(c_seq + ((static_cast<size_t>(d) * n_t + t_before) * n_b + b) *
                                             n_h + j);
      it.dy = load2(dy + row * n_h + j);
      it.m = mask[static_cast<size_t>(t) * n_b + b];
    }

    if (has_prev) {
      const T* a = dg + ((static_cast<size_t>(d) * n_t + t_prev) * n_b + b0) * g4;
      sm::product<T, kUnits>(a, g4, nb, w_rows, g4, min(kUnits, n_h - j0), g4, smem, z_s);
    }

#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const Item& it = in[p];
      if (!it.valid) continue;
      const int r = threadIdx.x / kPairs + p * kRowsPerPass;
      const int b = b0 + r;
      const size_t st = state_d + static_cast<size_t>(b) * n_h + j;
      const float2 z = has_prev ? make_float2(z_s[r * kUnits + u], z_s[r * kUnits + u + 1])
                                : make_float2(0.f, 0.f);
      const float dh_x = it.dh.x + z.x;
      const float dh_y = it.dh.y + z.y;
      if (s < 0) {
        store2(dh0 + st, dh_x, dh_y);
        store2(dc0 + st, it.dc.x, it.dc.y);
        continue;
      }
      float gx[4], gy[4];
      float rest_x, rest_y, dc_x, dc_y;
      cell(dh_x, it.dc.x, it.i.x, it.f.x, it.g.x, it.o.x, it.c_prev.x, it.dy.x, it.m, gx,
           rest_x, dc_x);
      cell(dh_y, it.dc.y, it.i.y, it.f.y, it.g.y, it.o.y, it.c_prev.y, it.dy.y, it.m, gy,
           rest_y, dc_y);
      T* dg_row = dg + ((static_cast<size_t>(d) * n_t + t) * n_b + b) * g4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) store2(dg_row + q * n_h, gx[q], gy[q]);
      store2(dh_rest + st, rest_x, rest_y);
      store2(dc + st, dc_x, dc_y);
    }
  }
}

template <typename T>
int run_bwd(const void* gates, const void* mask, const void* w_t, const void* c0,
            const void* c_seq, const void* dy, void* dg, void* dh_rest, void* dc,
            void* dh0, void* dc0, int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
            cudaStream_t stream) {
  auto kernel = lstm_bwd_step_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((n_h + kUnits - 1) / kUnits, n_dir);
  for (int k = 0; k <= n_t; ++k) {
    kernel<<<grid, kThreads, smem_bytes<T>(), stream>>>(
        static_cast<const T*>(gates), static_cast<const float*>(mask),
        static_cast<const T*>(w_t), static_cast<const T*>(c0), static_cast<const T*>(c_seq),
        static_cast<const T*>(dy), static_cast<T*>(dg), static_cast<float*>(dh_rest),
        static_cast<float*>(dc), static_cast<T*>(dh0), static_cast<T*>(dc0), n_t, n_b, n_h,
        k, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Runs the reverse scan of one layer (n_t + 1 launches) on `stream`.
// dh_rest and dc are f32 (D, B, H) scratch that must hold dh_T and dc_T on
// entry; they are overwritten. Requires n_h % 8 == 0 (every row of 4H
// columns is whole 16-byte copies) and every pointer on a 16-byte
// boundary. Returns a cudaError_t: the first error any launch reported, or
// cudaSuccess.
extern "C" int dsjax_torch_lstm_bwd(const void* gates, const void* mask, const void* w_t,
                                    const void* c0, const void* c_seq, const void* dy,
                                    void* dg, void* dh_rest, void* dc, void* dh0, void* dc0,
                                    int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
                                    int is_bf16, void* stream) {
  if (n_h % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run_bwd<__nv_bfloat16>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0,
                                  n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  return run_bwd<float>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0, n_dir,
                        n_t, n_b, n_h, reverse_bits, s);
}

// The step kernel's resources for the working type: out[0] registers a
// thread, out[1] static and out[2] dynamic shared memory a CTA in bytes,
// out[3] local memory a thread in bytes (spills), out[4] hidden units a
// CTA. Returns a cudaError_t.
extern "C" int dsjax_torch_lstm_bwd_attributes(int is_bf16, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      is_bf16 ? cudaFuncGetAttributes(&attr, lstm_bwd_step_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&attr, lstm_bwd_step_kernel<float>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = is_bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kUnits;
  return cudaSuccess;
}
