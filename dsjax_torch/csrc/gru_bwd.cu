// Masked GRU reverse scan (the backward of training, K5) for Hopper, sm_90a.
//
// Replaces dsjax/ops/gru_pallas.py:_bwd_kernel (_gru_bwd_pallas), the
// backward of gru_scan's custom VJP. It reads the (r, z, n, hn) residuals
// that the residual-saving forward (gru_fwd.cu) wrote and the carried
// h_prev, and walks the steps of each direction in reverse scan order. Per
// step, in f32 (dh is the carry from the step after it in scan order):
//   dh_a   = dh + dy[t] * m;  dh_n = dh_a * m
//   dz     = dh_n * (h_prev - n);  dn_pre = dh_n * (1 - z) * (1 - n^2)
//   dr_pre = dn_pre * hn * r * (1 - r);  dz_pre = dz * z * (1 - z)
//   dxp[t] = (dr_pre, dz_pre, dn_pre)                  rounded to the working type
//   dG     = (dr_pre, dz_pre, dn_pre * r)              rounded to the working type
//   dh     = dh_n * z + dG . W_hh + dh_a * (1 - m)
// and after the last step dh0 = dh, rounded. The caller reduces dW and db
// from dxp and r with one matrix product, as dsjax does outside its kernel
// (gru_pallas.py:300-325). h_prev is the h that entered step t: h0 before the
// first valid step. dsjax's kernel reads the masked y there (gru_pallas.py:
// 192), which is 0 under a suffix mask with a nonzero carry; this kernel
// follows the correct semantics, which agree with dsjax's kernel wherever
// that one is right.
//
// Structure, as K3's (lstm_bwd.cu). The elementwise part is unit-local, but
// dh[b, j] = sum_k dG[b, k] W_hh[k, j] needs all 3H h-side gradients of a
// row, which every CTA writes: the step's result crosses CTAs. dG is the
// exchange between CTAs, and the launch boundary is the barrier: launch k
// first finishes the product for the step that launch k - 1 ran, then runs
// the elementwise part of its own step and writes that step's dxp and dG
// columns. dG cannot be rebuilt from dxp (in bf16, round(dn_pre * r) is not
// round(round(dn_pre) * r)), so it has a buffer of its own, (2, D, B, 3H),
// double-buffered by the launch's parity so that no CTA overwrites what
// another still reads. A last launch (k = T) only finishes the product and
// writes dh0: T + 1 launches a layer, both directions in one grid
// (ceil(H / kUnits), directions). The f32 dh carry of a CTA's units stays
// in device memory that only that CTA touches.
//
// The step product. A CTA owns kUnits = 16 hidden units and computes
// Z[rows, 16] = dG[rows, 0:3H] . W_hh^T[16 units, 0:3H]^T for every batch
// row at once, in blocks of 64 rows (scan_mma.cuh, the product K3 runs with
// a K width of 4H): one pass over its W_hh rows a step at B <= 64. W_hh
// comes in transposed, (D, H, 3H), so unit j's 3H weights are one
// contiguous row; the previous step's dG and the CTA's W_hh^T rows are
// staged with 16-byte cp.async in the working type. In bf16 the product runs
// on tensor cores (mma.sync m16n8k16, f32 accumulators), in f32 on CUDA
// cores from the same tiles (no TF32: its rounding of the sums would pass
// the reverse scan's tolerance). The epilogue's inputs of step s (r, z, n,
// hn, h_prev, dy, mask and the carry) do not depend on the product and are
// loaded before it; a thread then finishes a pair of neighbouring units of
// two rows, with 2-wide loads and stores, and writes 3 dxp and 3 dG
// columns a unit.
//
// What bounds it. Each step's 2 * B * 3H * H FLOP a direction (0.8 GFLOP
// for both directions at B = 64, H = 1024) are a few microseconds of the
// tensor cores; what remains is the dG block (384 KB in bf16 at B = 64)
// that every CTA re-reads from L2 each step beside its own 96 KB of W_hh^T,
// and the latency of one launch a step. Next, as for K3: multicast the dG
// tile to a cluster of CTAs, then the persistent form (ROADMAP Queue 2).

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
  float2 dh, r, z, n, hn, h_prev, dy;
};

// One unit of the elementwise step: its 3 dxp columns, its 3 dG columns
// and the carry handed to the step before it, less the product.
__device__ __forceinline__ void cell(float dh, float r_g, float z_g, float n_g, float hn,
                                     float h_prev, float dy, float m, float (&dx)[3],
                                     float (&dg)[3], float& dh_rest) {
  const float dh_a = dh + dy * m;
  const float dh_n = dh_a * m;
  const float dz = dh_n * (h_prev - n_g);
  const float dn_pre = dh_n * (1.f - z_g) * (1.f - n_g * n_g);
  const float dr_pre = (dn_pre * hn) * r_g * (1.f - r_g);
  const float dz_pre = dz * z_g * (1.f - z_g);
  dx[0] = dg[0] = dr_pre;
  dx[1] = dg[1] = dz_pre;
  dx[2] = dn_pre;
  dg[2] = dn_pre * r_g;
  dh_rest = dh_n * z_g + dh_a * (1.f - m);
}

template <typename T>
constexpr int smem_bytes() {
  return sm::Shape<T, kUnits>::kSmemBytes + sm::kRows * kUnits * static_cast<int>(sizeof(float));
}

// Launch `launch` of the reverse scan of every direction.
//   gates   (D, T, B, 4H)  (r, z, n, hn) from the forward
//   mask    (T, B) f32
//   w_t     (D, H, 3H)     W_hh transposed: row j holds unit j's 3H weights
//   h_prev  (D, T, B, H)   the carry entering each step
//   dy      (D, T, B, H)
//   dxp     (D, T, B, 3H)  written one step per launch
//   dg      (2, D, B, 3H)  the exchanged dG, slot launch % 2 written
//   dh_rest (D, B, H) f32  dh_n * z + dh_a * (1 - m) of the last step run;
//                          on entry to launch 0, dh_T
//   dh0     (D, B, H)      written by the last launch
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_step_kernel(const T* __restrict__ gates, const float* __restrict__ mask,
                    const T* __restrict__ w_t, const T* __restrict__ h_prev,
                    const T* __restrict__ dy, T* __restrict__ dxp, T* __restrict__ dg,
                    float* __restrict__ dh_rest, T* __restrict__ dh0, int n_t, int n_b,
                    int n_h, int launch, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* z_s = reinterpret_cast<float*>(smem + sm::Shape<T, kUnits>::kSmemBytes);  // (64, kUnits)

  const int d = blockIdx.y;
  const int n_dir = gridDim.y;
  const bool rev = (reverse_bits >> d) & 1;
  const int j0 = blockIdx.x * kUnits;
  const int g3 = 3 * n_h;
  // this launch runs scan step s (none at the last launch, s = -1) and
  // finishes the product of step s + 1, which the previous launch ran
  const int s = n_t - 1 - launch;
  const bool has_prev = launch > 0;
  const int t = s >= 0 ? time_of(s, n_t, rev) : 0;
  const T* dg_in = dg + (static_cast<size_t>((launch + 1) & 1) * n_dir + d) * n_b * g3;
  T* dg_out = dg + (static_cast<size_t>(launch & 1) * n_dir + d) * n_b * g3;
  const int u = 2 * (threadIdx.x % kPairs);
  const int j = j0 + u;
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;
  const T* w_rows = w_t + (static_cast<size_t>(d) * n_h + j0) * g3;

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
      it.dh = load2(dh_rest + state_d + static_cast<size_t>(b) * n_h + j);
      if (s < 0) continue;
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
      const T* g_row = gates + row * 4 * static_cast<size_t>(n_h) + j;
      it.r = load2(g_row);
      it.z = load2(g_row + n_h);
      it.n = load2(g_row + 2 * n_h);
      it.hn = load2(g_row + 3 * n_h);
      it.h_prev = load2(h_prev + row * n_h + j);
      it.dy = load2(dy + row * n_h + j);
      it.m = mask[static_cast<size_t>(t) * n_b + b];
    }

    if (has_prev) {
      sm::product<T, kUnits>(dg_in + static_cast<size_t>(b0) * g3, g3, nb, w_rows, g3,
                             min(kUnits, n_h - j0), g3, smem, z_s);
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
        continue;
      }
      float dx_x[3], dx_y[3], dg_x[3], dg_y[3];
      float rest_x, rest_y;
      cell(dh_x, it.r.x, it.z.x, it.n.x, it.hn.x, it.h_prev.x, it.dy.x, it.m, dx_x, dg_x,
           rest_x);
      cell(dh_y, it.r.y, it.z.y, it.n.y, it.hn.y, it.h_prev.y, it.dy.y, it.m, dx_y, dg_y,
           rest_y);
      T* x_row = dxp + ((static_cast<size_t>(d) * n_t + t) * n_b + b) * g3 + j;
      T* e_row = dg_out + static_cast<size_t>(b) * g3 + j;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        store2(x_row + q * n_h, dx_x[q], dx_y[q]);
        store2(e_row + q * n_h, dg_x[q], dg_y[q]);
      }
      store2(dh_rest + st, rest_x, rest_y);
    }
  }
}

template <typename T>
int run_bwd(const void* gates, const void* mask, const void* w_t, const void* h_prev,
            const void* dy, void* dxp, void* dg, void* dh_rest, void* dh0, int n_dir, int n_t,
            int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  auto kernel = gru_bwd_step_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((n_h + kUnits - 1) / kUnits, n_dir);
  for (int k = 0; k <= n_t; ++k) {
    kernel<<<grid, kThreads, smem_bytes<T>(), stream>>>(
        static_cast<const T*>(gates), static_cast<const float*>(mask),
        static_cast<const T*>(w_t), static_cast<const T*>(h_prev), static_cast<const T*>(dy),
        static_cast<T*>(dxp), static_cast<T*>(dg), static_cast<float*>(dh_rest),
        static_cast<T*>(dh0), n_t, n_b, n_h, k, reverse_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Runs the reverse scan of one layer (n_t + 1 launches) on `stream`. dg is
// (2, D, B, 3H) scratch in the working type; dh_rest is f32 (D, B, H) scratch
// that must hold dh_T on entry and is overwritten. Requires n_h % 8 == 0
// (every row of 3H columns is whole 16-byte copies), w_t and dg on 16-byte
// boundaries, and gates, h_prev, dy on boundaries of two elements. Returns
// a cudaError_t: the first error any launch reported, or cudaSuccess.
extern "C" int dsjax_torch_gru_bwd(const void* gates, const void* mask, const void* w_t,
                                   const void* h_prev, const void* dy, void* dxp, void* dg,
                                   void* dh_rest, void* dh0, int n_dir, int n_t, int n_b,
                                   int n_h, int reverse_bits, int is_bf16, void* stream) {
  if (n_h % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run_bwd<__nv_bfloat16>(gates, mask, w_t, h_prev, dy, dxp, dg, dh_rest, dh0, n_dir,
                                  n_t, n_b, n_h, reverse_bits, s);
  }
  return run_bwd<float>(gates, mask, w_t, h_prev, dy, dxp, dg, dh_rest, dh0, n_dir, n_t, n_b,
                        n_h, reverse_bits, s);
}

// The step kernel's resources for the working type: out[0] registers a
// thread, out[1] static and out[2] dynamic shared memory a CTA in bytes,
// out[3] local memory a thread in bytes (spills), out[4] hidden units a
// CTA. Returns a cudaError_t.
extern "C" int dsjax_torch_gru_bwd_attributes(int is_bf16, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      is_bf16 ? cudaFuncGetAttributes(&attr, gru_bwd_step_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&attr, gru_bwd_step_kernel<float>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = is_bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kUnits;
  return cudaSuccess;
}
