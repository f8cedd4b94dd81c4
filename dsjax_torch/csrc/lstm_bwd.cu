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
// What bounds it on this card. The elementwise part is unit-local, but
// dh[b, j] = sum_k dgates[b, k] W_hh[k, j] needs all 4H dgates of a row,
// which every CTA writes: the step's result crosses CTAs. Per step and
// direction the product does 2 * B * 4H * H FLOP (1.1 GFLOP for both
// directions at B = 64, H = 1024) and reads W_hh (8 MB bf16, 16 MB f32, from
// L2 after the first step) once per kRows batch rows, plus every row of
// dgates once per CTA. Steps are dependent, so it is bound by the bandwidth
// of those L2 reads and by the per-step latency, as the forward is.
//
// What the design does about it. The dgates output is the exchange between
// CTAs, and the launch boundary is the barrier: launch k first finishes the
// product for the step that launch k - 1 wrote, then runs the elementwise
// part of its own step and writes that step's dgate columns. A last launch
// (k = T) only finishes the product and writes dh0, dc0. So T + 1 launches
// cover a layer, both directions in one grid (H / kUnits, directions). Each
// CTA owns kUnits hidden units; the dh and dc carries of its units stay in
// f32 buffers in device memory that only its own threads touch. W_hh comes
// in transposed, (D, H, 4H), so the 4H weights of unit j are one contiguous
// row for 16-byte loads; a warp owns kUnitsPerWarp such rows and multiplies
// them against the previous step's dgates, which the CTA stages in shared
// memory in f32, kChunk columns at a time. dgates are read in the working
// type, which is dsjax's cast of dgates to W's dtype before the product
// (lstm_pallas.py:296-298); the sums run in f32. wgmma, TMA and a persistent
// form are later work.

#include "lstm_common.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kUnits = 8;                            // hidden units per CTA
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnitsPerWarp = kUnits / kWarps;       // 2
constexpr int kRows = 8;                             // batch rows per pass over W_hh
constexpr int kChunk = 1024;                         // dgate columns staged at a time

static_assert(kUnits % kWarps == 0, "units must split evenly over warps");
static_assert(kRows * kUnits <= kThreads, "one thread per (row, unit)");
static_assert(kChunk % (32 * 8) == 0, "a chunk is whole 16-byte loads of every lane");

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
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const T* __restrict__ gates, const float* __restrict__ mask,
                     const T* __restrict__ w_t, const T* __restrict__ c0,
                     const T* __restrict__ c_seq, const T* __restrict__ dy,
                     T* __restrict__ dg, float* __restrict__ dh_rest,
                     float* __restrict__ dc, T* __restrict__ dh0, T* __restrict__ dc0,
                     int n_t, int n_b, int n_h, int launch, int reverse_bits) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* g_s = smem;                        // (kRows, kChunk): dgates in f32
  float* z_s = smem + kRows * kChunk;       // (kUnits, kRows): dgates . W_hh

  const int d = blockIdx.y;
  const bool rev = (reverse_bits >> d) & 1;
  const int j0 = blockIdx.x * kUnits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = 4 * n_h;
  // this launch runs scan step s (none at the last launch, s = -1) and
  // finishes the product of step s + 1, which the previous launch ran
  const int s = n_t - 1 - launch;
  const bool has_prev = launch > 0;
  const int t = s >= 0 ? time_of(s, n_t, rev) : 0;
  const int t_prev = has_prev ? time_of(s + 1, n_t, rev) : 0;

  const T* w_rows[kUnitsPerWarp];
#pragma unroll
  for (int c = 0; c < kUnitsPerWarp; ++c) {
    const int j = j0 + warp * kUnitsPerWarp + c;
    w_rows[c] = w_t + (static_cast<size_t>(d) * n_h + j) * g4;
  }
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;

  for (int b0 = 0; b0 < n_b; b0 += kRows) {
    const int nb = min(kRows, n_b - b0);
    if (has_prev) {
      const T* dg_rows = dg + ((static_cast<size_t>(d) * n_t + t_prev) * n_b + b0) * g4;
      float acc[kUnitsPerWarp][kRows];
#pragma unroll
      for (int c = 0; c < kUnitsPerWarp; ++c) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
      }
      for (int k0 = 0; k0 < g4; k0 += kChunk) {
        const int nk = min(kChunk, g4 - k0);
        for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
          const int r = i / kChunk;
          const int k = i % kChunk;
          g_s[i] = (r < nb && k < nk) ? to_f32(dg_rows[static_cast<size_t>(r) * g4 + k0 + k])
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
        dc0[st] = from_f32<T>(dc[st]);
      } else {
        const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + b;
        const T* g_row = gates + row * g4;
        const float i_s = to_f32(g_row[j]);
        const float f_s = to_f32(g_row[n_h + j]);
        const float g_t = to_f32(g_row[2 * n_h + j]);
        const float o_s = to_f32(g_row[3 * n_h + j]);
        float c_prev;
        if (s == 0) {
          c_prev = to_f32(c0[st]);
        } else {
          const int t_before = time_of(s - 1, n_t, rev);
          c_prev = to_f32(c_seq[((static_cast<size_t>(d) * n_t + t_before) * n_b + b) * n_h + j]);
        }
        const float c_new = f_s * c_prev + i_s * g_t;
        const float tc = tanhf(c_new);
        const float m = mask[static_cast<size_t>(t) * n_b + b];
        const float dh_a = dh + to_f32(dy[row * n_h + j]) * m;
        const float dc_a = dc[st];
        const float dh_n = dh_a * m;
        const float dc_n = dc_a * m;
        const float d_o = dh_n * tc;
        const float dc_t = dc_n + dh_n * o_s * (1.f - tc * tc);
        T* dg_row = dg + row * g4;
        dg_row[j] = from_f32<T>((dc_t * g_t) * i_s * (1.f - i_s));
        dg_row[n_h + j] = from_f32<T>((dc_t * c_prev) * f_s * (1.f - f_s));
        dg_row[2 * n_h + j] = from_f32<T>((dc_t * i_s) * (1.f - g_t * g_t));
        dg_row[3 * n_h + j] = from_f32<T>(d_o * o_s * (1.f - o_s));
        dh_rest[st] = dh_a * (1.f - m);
        dc[st] = dc_t * f_s + dc_a * (1.f - m);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int run_bwd(const void* gates, const void* mask, const void* w_t, const void* c0,
            const void* c_seq, const void* dy, void* dg, void* dh_rest, void* dc,
            void* dh0, void* dc0, int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows * kChunk + kUnits * kRows) * sizeof(float);
  auto kernel = lstm_bwd_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_h / kUnits, n_dir);
  for (int k = 0; k <= n_t; ++k) {
    kernel<<<grid, kThreads, smem, stream>>>(
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
// entry; they are overwritten. Requires n_h % 8 == 0. Returns a
// cudaError_t: the first error any launch reported, or cudaSuccess.
extern "C" int dsjax_torch_lstm_bwd(const void* gates, const void* mask, const void* w_t,
                                    const void* c0, const void* c_seq, const void* dy,
                                    void* dg, void* dh_rest, void* dc, void* dh0, void* dc0,
                                    int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
                                    int is_bf16, void* stream) {
  if (n_h % kUnits != 0 || n_h % Vec<__nv_bfloat16>::N != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return run_bwd<__nv_bfloat16>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0,
                                  n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  return run_bwd<float>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0, n_dir,
                        n_t, n_b, n_h, reverse_bits, s);
}
