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
// What bounds it on this card. The elementwise part is unit-local, but
// dh[b, j] = sum_k dG[b, k] W_hh[k, j] needs all 3H h-side gradients of a
// row, which every CTA writes: the step's result crosses CTAs. Per step and
// direction the product does 2 * B * 3H * H FLOP (0.8 GFLOP for both
// directions at B = 64, H = 1024) on CUDA cores and reads W_hh (6 MB bf16,
// 12 MB f32, from L2 after the first step) once per kRows batch rows, plus
// every row of dG once per CTA. Steps are dependent, so it is bound by those
// FLOPs, the L2 reads and the per-step latency, as the LSTM's (lstm_bwd.cu).
//
// What the design does about it. K3's design. dG is the exchange between
// CTAs, and the launch boundary is the barrier: launch k first finishes the
// product for the step that launch k - 1 ran, then runs the elementwise part
// of its own step and writes that step's dxp and dG columns. dG cannot be
// rebuilt from dxp (in bf16, round(dn_pre * r) is not round(round(dn_pre) *
// r)), so it has a buffer of its own, (2, D, B, 3H), double-buffered by the
// launch's parity so that no CTA overwrites what another still reads. A last
// launch (k = T) only finishes the product and writes dh0: T + 1 launches a
// layer, both directions in one grid (H / kUnits, directions). Each CTA owns
// kUnits hidden units; the f32 dh carry of its units stays in device memory
// that only its own threads touch. W_hh comes in transposed, (D, H, 3H), so
// unit j's 3H weights are one contiguous row for 16-byte loads; a warp owns
// kUnitsPerWarp such rows and multiplies them against the previous step's
// dG, which the CTA stages in shared memory in f32, kChunk columns at a time.

#include "lstm_common.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kUnits = 8;                            // hidden units per CTA
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnitsPerWarp = kUnits / kWarps;       // 2
constexpr int kRows = 8;                             // batch rows per pass over W_hh
constexpr int kChunk = 1024;                         // dG columns staged at a time

static_assert(kUnits % kWarps == 0, "units must split evenly over warps");
static_assert(kRows * kUnits <= kThreads, "one thread per (row, unit)");
static_assert(kChunk % (32 * 8) == 0, "a chunk is whole 16-byte loads of every lane");

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
__global__ void __launch_bounds__(kThreads)
gru_bwd_step_kernel(const T* __restrict__ gates, const float* __restrict__ mask,
                    const T* __restrict__ w_t, const T* __restrict__ h_prev,
                    const T* __restrict__ dy, T* __restrict__ dxp, T* __restrict__ dg,
                    float* __restrict__ dh_rest, T* __restrict__ dh0, int n_t, int n_b,
                    int n_h, int launch, int reverse_bits) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* g_s = smem;                        // (kRows, kChunk): dG in f32
  float* z_s = smem + kRows * kChunk;       // (kUnits, kRows): dG . W_hh

  const int d = blockIdx.y;
  const int n_dir = gridDim.y;
  const bool rev = (reverse_bits >> d) & 1;
  const int j0 = blockIdx.x * kUnits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g3 = 3 * n_h;
  // this launch runs scan step s (none at the last launch, s = -1) and
  // finishes the product of step s + 1, which the previous launch ran
  const int s = n_t - 1 - launch;
  const bool has_prev = launch > 0;
  const int t = s >= 0 ? time_of(s, n_t, rev) : 0;
  const T* dg_in = dg + (static_cast<size_t>((launch + 1) & 1) * n_dir + d) * n_b * g3;
  T* dg_out = dg + (static_cast<size_t>(launch & 1) * n_dir + d) * n_b * g3;

  const T* w_rows[kUnitsPerWarp];
#pragma unroll
  for (int c = 0; c < kUnitsPerWarp; ++c) {
    const int j = j0 + warp * kUnitsPerWarp + c;
    w_rows[c] = w_t + (static_cast<size_t>(d) * n_h + j) * g3;
  }
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;

  for (int b0 = 0; b0 < n_b; b0 += kRows) {
    const int nb = min(kRows, n_b - b0);
    if (has_prev) {
      const T* dg_rows = dg_in + static_cast<size_t>(b0) * g3;
      float acc[kUnitsPerWarp][kRows];
#pragma unroll
      for (int c = 0; c < kUnitsPerWarp; ++c) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
      }
      for (int k0 = 0; k0 < g3; k0 += kChunk) {
        const int nk = min(kChunk, g3 - k0);
        for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
          const int r = i / kChunk;
          const int k = i % kChunk;
          g_s[i] = (r < nb && k < nk) ? to_f32(dg_rows[static_cast<size_t>(r) * g3 + k0 + k])
                                      : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int k = lane * V; k < nk; k += 32 * V) {
          float w[kUnitsPerWarp][V];
#pragma unroll
          for (int c = 0; c < kUnitsPerWarp; ++c) load16(w_rows[c] + k0 + k, w[c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float gv[V];
#pragma unroll
            for (int q = 0; q < V; q += 4) {
              const float4 v = *reinterpret_cast<const float4*>(g_s + r * kChunk + k + q);
              gv[q] = v.x; gv[q + 1] = v.y; gv[q + 2] = v.z; gv[q + 3] = v.w;
            }
#pragma unroll
            for (int c = 0; c < kUnitsPerWarp; ++c) {
#pragma unroll
              for (int q = 0; q < V; ++q) acc[c][r] = fmaf(w[c][q], gv[q], acc[c][r]);
            }
          }
        }
        __syncthreads();              // the chunk is read before the next overwrites it
      }
#pragma unroll
      for (int c = 0; c < kUnitsPerWarp; ++c) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float v = acc[c][r];
#pragma unroll
          for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) z_s[(warp * kUnitsPerWarp + c) * kRows + r] = v;
        }
      }
      __syncthreads();
    }

    if (threadIdx.x < nb * kUnits) {
      const int r = threadIdx.x / kUnits;
      const int u = threadIdx.x % kUnits;
      const int j = j0 + u;
      const int b = b0 + r;
      const size_t st = state_d + static_cast<size_t>(b) * n_h + j;
      const float dh = dh_rest[st] + (has_prev ? z_s[u * kRows + r] : 0.f);
      if (s < 0) {
        dh0[st] = from_f32<T>(dh);
      } else {
        const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
        const T* g_row = gates + row * 4 * static_cast<size_t>(n_h);
        const float r_g = to_f32(g_row[j]);
        const float z_g = to_f32(g_row[n_h + j]);
        const float n_g = to_f32(g_row[2 * n_h + j]);
        const float hn = to_f32(g_row[3 * n_h + j]);
        const float m = mask[static_cast<size_t>(t) * n_b + b];
        const float dh_a = dh + to_f32(dy[row * n_h + j]) * m;
        const float dh_n = dh_a * m;
        const float dz = dh_n * (to_f32(h_prev[row * n_h + j]) - n_g);
        const float dn_pre = dh_n * (1.f - z_g) * (1.f - n_g * n_g);
        const float dr_pre = (dn_pre * hn) * r_g * (1.f - r_g);
        const float dz_pre = dz * z_g * (1.f - z_g);
        T* x_row = dxp + row * g3;
        x_row[j] = from_f32<T>(dr_pre);
        x_row[n_h + j] = from_f32<T>(dz_pre);
        x_row[2 * n_h + j] = from_f32<T>(dn_pre);
        T* e_row = dg_out + static_cast<size_t>(b) * g3;
        e_row[j] = from_f32<T>(dr_pre);
        e_row[n_h + j] = from_f32<T>(dz_pre);
        e_row[2 * n_h + j] = from_f32<T>(dn_pre * r_g);
        dh_rest[st] = dh_n * z_g + dh_a * (1.f - m);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int run_bwd(const void* gates, const void* mask, const void* w_t, const void* h_prev,
            const void* dy, void* dxp, void* dg, void* dh_rest, void* dh0, int n_dir, int n_t,
            int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows * kChunk + kUnits * kRows) * sizeof(float);
  auto kernel = gru_bwd_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_h / kUnits, n_dir);
  for (int k = 0; k <= n_t; ++k) {
    kernel<<<grid, kThreads, smem, stream>>>(
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
// that must hold dh_T on entry and is overwritten. Requires n_h % 8 == 0.
// Returns a cudaError_t: the first error any launch reported, or cudaSuccess.
extern "C" int dsjax_torch_gru_bwd(const void* gates, const void* mask, const void* w_t,
                                   const void* h_prev, const void* dy, void* dxp, void* dg,
                                   void* dh_rest, void* dh0, int n_dir, int n_t, int n_b,
                                   int n_h, int reverse_bits, int is_bf16, void* stream) {
  if (n_h % kUnits != 0 || n_h % Vec<__nv_bfloat16>::N != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run_bwd<__nv_bfloat16>(gates, mask, w_t, h_prev, dy, dxp, dg, dh_rest, dh0, n_dir,
                                  n_t, n_b, n_h, reverse_bits, s);
  }
  return run_bwd<float>(gates, mask, w_t, h_prev, dy, dxp, dg, dh_rest, dh0, n_dir, n_t, n_b,
                        n_h, reverse_bits, s);
}
