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
// does outside its kernel (_vjp_bwd). The elementwise part is unit-local,
// but dh[b, j] = sum_k dgates[b, k] W_hh[k, j] needs all 4H dgates of a row,
// which every CTA writes: each step's result crosses CTAs. dgates are read
// in the working type, which is dsjax's cast of dgates to W's dtype before
// the product (lstm_pallas.py:296-298); the sums run in f32.
//
// Two routes, chosen by ops/lstm.py:bwd_plan from the dtype and shapes
// alone, which lays the route out (checked here only for what the launch
// needs of it): the resident route wherever W_hh^T fits in
// shared memory beside a ring of dgates (bf16, D * ceil(H / U) CTAs of U =
// 16 or 20 units on the card's SMs, B in one or two 64-row tiles), else the
// per-step kernel (f32, larger H or B).
//
// The resident route (lstm_bwd_step_kernel_resident): one cooperative
// launch a layer call, launched with thread block clusters of C CTAs.
// - Grid. One CTA an SM and U units a CTA: D * ceil(H / U) CTAs rounded up
//   to whole clusters in each direction (the clusters never span two
//   directions). (C, U) is the first of bwd_plan's BWD_SHAPES whose layout
//   fits and whose clusters are all co-resident (cudaOccupancyMaxActiveClusters): U = 16,
//   or 20 where the card holds too few clusters of 16-unit CTAs. An H100
//   holds 15 clusters of 8 at one CTA an SM, so H = 1024 in two directions
//   runs 112 CTAs of 20 units in 14 clusters of 8. Where another kernel
//   holds SMs the grid needs (NCCL's under DDP), the cooperative launch
//   starts no CTA until all fit, so no resident CTA spins at a barrier on
//   one that is not (PERF.md, K3 beside other kernels).
// - The cluster splits K. The C CTAs of a cluster own N = C U units; CTA r
//   of the cluster owns the r-th of C slices of the 4H columns of dgates
//   (K atoms of 64). At the start it copies W_hh^T's N rows over its slice
//   into shared memory, once, K-major in the 128-byte swizzle that wgmma
//   reads its B operand from (160 KB in bf16 at H = 1024, C = 8, U = 20).
// - The step product. Each step the CTA loads its slice of the previous
//   step's dgates block (B rows) by tensor copies (TMA), an atom an
//   mbarrier, every atom resident where they fit beside W (64 KB at C = 8,
//   B <= 64), else through a ring refilled as wgmma frees it. One warpgroup
//   a 64-row tile runs wgmma.mma_async m64nNk16 on the atoms as they land
//   (f32 accumulators in registers): partial sums of the cluster's N units
//   over its slice of K. So the cluster reads each step's dgates block once
//   from L2, not once a CTA: L2 reads fall from about 80 MB a step (both
//   directions at B = 64) to 64 / C MB, and each SM takes 1/C of the block
//   into shared memory, where a multicast would still bring it the whole
//   block (and wgmma would read it all again at N = U).
// - The exchange. Each CTA writes its partial sums (f32) over its dgates
//   buffers, the cluster meets at its barrier, and each CTA adds its own
//   units' partial sums from every CTA of the cluster (distributed shared
//   memory, 16-byte loads, in rank order, so the sums are deterministic):
//   40 KB a CTA a step at B = 64, C = 8, U = 20. A second cluster barrier,
//   waited on only before the next step's copies, frees the buffers.
//   (Sending the partial sums from the accumulators to their owners with
//   distributed shared memory stores instead took 1.1x as long a call: the
//   stores scatter over two owners a warp.)
// - The epilogue is the per-step kernel's cell() with its roundings: f32
//   cell math, dgates rounded to the working type before they are stored and
//   multiplied, the dh and dc carries in f32 registers for the whole call,
//   dh0 and dc0 rounded once at the end; a thread finishes four
//   neighbouring units of a row at a time. A step's dgates reach the other
//   CTAs of the direction through L2 at one grid barrier a step
//   (grid_sync.cuh, as K1 and K8); the next step's gates, kept carry, dy
//   and mask are loaded between the barrier's arrival and its wait.
// What bounds it: a step's 2 * B * 4H * N FLOP a CTA (10.5 MFLOP at B = 64,
// H = 1024, N = 160) are about 1.3 us of an SM's tensor cores; the rest is
// the latency of the dependent parts of a step: the dgates copies, the two
// cluster barriers and the exchange, the cell, and the grid barrier. On an
// H100 at T = 512, B = 64, H = 1024 a call takes about 5.4 ms, 10.6 us a
// step (PERF.md gives the step's parts by clock64).
//
// The per-step kernel (lstm_bwd_step_kernel), one launch a scan step: T + 1
// launches cover a layer, both directions in one grid (ceil(H / 16), D).
// The dgates output is the exchange between CTAs, and the launch boundary
// is the barrier: launch k first finishes the product for the step that
// launch k - 1 wrote, then runs the elementwise part of its own step and
// writes that step's dgate columns; a last launch (k = T) only finishes the
// product and writes dh0, dc0. The dh and dc carries of a CTA's units stay
// in f32 buffers in device memory that only that CTA touches. A CTA owns 16
// units and computes Z[rows, 16] = dgates[t_prev][rows, 0:4H] .
// W_hh^T[16 units, 0:4H]^T for every batch row at once, in blocks of 64 rows
// (scan_mma.cuh): the previous step's dgates and the CTA's W_hh^T rows are
// staged with 16-byte cp.async, 4 stages of 512 bytes a row; in bf16 the
// product runs on tensor cores (mma.sync m16n8k16), in f32 on CUDA cores
// from the same tiles. The epilogue's inputs of step s do not depend on the
// product and are loaded before it; a thread then finishes a pair of
// neighbouring units of two rows, with 2-wide loads and stores. Every
// launch re-reads the CTA's W_hh^T rows and the whole dgates block of the
// step before from L2 (about 80 MB a step for both directions in bf16 at
// B = 64, H = 1024), which, with a launch a step, bounds it: about 24 us a
// step on an H100, against about 1 us of tensor-core work. The f32 route
// keeps it: its 256 KB of W_hh^T a CTA at H = 1024 would not fit.

#include "grid_sync.cuh"
#include "hopper_async.cuh"
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

// ---------------------------------------------------------------------------
// The resident route (top of the file).

namespace resident {

using namespace dsjax_torch::hopper;

constexpr int kMaxTiles = 2;       // 64-row tiles of the batch, one warpgroup each
constexpr int kPad = 8;            // floats past N in a row of partial sums (bank spread)

// The plan that ops/lstm.py:bwd_plan lays out, in its order: the route (1
// this one, 0 the per-step kernel), units a CTA U, 64-row tiles of the
// batch, the cluster size C, CTAs in all and a direction, K atoms of 64
// columns of 4H and the most a CTA owns, dgates buffers of one atom, and the
// dynamic shared memory a CTA (the alignment pad, W_hh^T's slice, the
// buffers and their mbarriers).
struct Plan {
  int route, units, tiles, cluster, ctas, ctas_dir, atoms, atoms_cta, stages, smem_bytes;
};

struct Args {
  CUtensorMap dg_map;            // dg as (D T B, 4H): boxes of 64 columns x B rows
  const __nv_bfloat16* gates;    // (D, T, B, 4H)
  const float* mask;             // (T, B)
  const __nv_bfloat16* w_t;      // (D, H, 4H)
  const __nv_bfloat16* c0;       // (D, B, H)
  const __nv_bfloat16* c_seq;    // (D, T, B, H)
  const __nv_bfloat16* dy;       // (D, T, B, H)
  __nv_bfloat16* dg;             // (D, T, B, 4H)
  const float* dh_t;             // (D, B, H) f32: the carries entering the scan
  const float* dc_t;
  __nv_bfloat16* dh0;            // (D, B, H)
  __nv_bfloat16* dc0;
  int* counters;                 // D zeroed: arrivals at each direction's barriers
  int n_t, n_b, n_h, reverse_bits;
  Plan plan;
};

// d (+)= A . B over one k16 slice: A a warpgroup's 64 rows of dgates, B N
// = C U units of W_hh^T, both K-major in swizzled shared memory. Thread (warp w,
// lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1):
// d[4 j] (row, col), d[4 j + 1] (row, col + 1), d[4 j + 2] (row + 8, col),
// d[4 j + 3] (row + 8, col + 1). DSJ_WGMMA(N, n, a, b, p) defines it for N
// of the built kernels: its N / 2 accumulators are n groups of eight
// operands (%0 ... in the instruction, DSJ_REGS_n; d[0] ..., DSJ_OUTS_n),
// then A's and B's descriptors and the accumulate flag (%a, %b, %p).
template <int kN>
struct Wgmma;

#define DSJ_REGS_1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define DSJ_REGS_2 DSJ_REGS_1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define DSJ_REGS_3 DSJ_REGS_2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define DSJ_REGS_4 DSJ_REGS_3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define DSJ_REGS_5 DSJ_REGS_4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define DSJ_REGS_6 DSJ_REGS_5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define DSJ_REGS_7 DSJ_REGS_6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define DSJ_REGS_8 DSJ_REGS_7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define DSJ_REGS_9 DSJ_REGS_8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define DSJ_REGS_10 DSJ_REGS_9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define DSJ_OUT8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define DSJ_OUTS_1 DSJ_OUT8(0)
#define DSJ_OUTS_2 DSJ_OUTS_1, DSJ_OUT8(8)
#define DSJ_OUTS_3 DSJ_OUTS_2, DSJ_OUT8(16)
#define DSJ_OUTS_4 DSJ_OUTS_3, DSJ_OUT8(24)
#define DSJ_OUTS_5 DSJ_OUTS_4, DSJ_OUT8(32)
#define DSJ_OUTS_6 DSJ_OUTS_5, DSJ_OUT8(40)
#define DSJ_OUTS_7 DSJ_OUTS_6, DSJ_OUT8(48)
#define DSJ_OUTS_8 DSJ_OUTS_7, DSJ_OUT8(56)
#define DSJ_OUTS_9 DSJ_OUTS_8, DSJ_OUT8(64)
#define DSJ_OUTS_10 DSJ_OUTS_9, DSJ_OUT8(72)
#define DSJ_WGMMA(N, n, a_op, b_op, p_op)                                                     \
  template <>                                                                                \
  struct Wgmma<N> {                                                                          \
    static __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b,     \
                                               int acc) {                                    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #p_op ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" DSJ_REGS_##n \
                   "}, %" #a_op ", %" #b_op ", p, 1, 1, 0, 0;\n}\n"                           \
                   : DSJ_OUTS_##n                                                            \
                   : "l"(a), "l"(b), "r"(acc));                                              \
    }                                                                                        \
  };
DSJ_WGMMA(16, 1, 8, 9, 10)
DSJ_WGMMA(32, 2, 16, 17, 18)
DSJ_WGMMA(64, 4, 32, 33, 34)
DSJ_WGMMA(80, 5, 40, 41, 42)
DSJ_WGMMA(128, 8, 64, 65, 66)
DSJ_WGMMA(160, 10, 80, 81, 82)

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous product (as mm_chain.cu's)
template <int kRegs>
__device__ __forceinline__ void hold(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four floats at p (16 bytes aligned) in the shared memory of the
// cluster's CTA `rank`
__device__ __forceinline__ float4 load_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// four neighbouring bf16 (8 bytes aligned) of the kernel's read-only
// inputs, as they lie
__device__ __forceinline__ uint2 load4_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float4 to_f32x4(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four floats rounded to bf16 (as store2 rounds two), 8 bytes aligned
__device__ __forceinline__ void store4(__nv_bfloat16* p, float x, float y, float z, float w) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x, y), __floats2bfloat162_rn(z, w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

__device__ __forceinline__ float& at(float4& v, int i) { return reinterpret_cast<float*>(&v)[i]; }

// The epilogue's inputs of one step for a row and four neighbouring units,
// as they lie (bf16 quads), loaded while the CTA waits at the grid barrier.
struct In {
  uint2 i, f, g, o, c_prev, dy;
  float m;
};

// The whole reverse scan of a layer. kC: the cluster size; kU: units a
// CTA (N = kC kU); kRing: the dgates buffers are fewer than a CTA's atoms,
// refilled as the product frees them (else every atom has its own). One
// warpgroup a 64-row tile of the batch.
template <int kC, int kU, bool kRing>
__global__ void __launch_bounds__(kMaxTiles * 128, 1)
lstm_bwd_step_kernel_resident(const __grid_constant__ Args a) {
  constexpr int kN = kC * kU;
  constexpr int kPitch = kN + kPad;
  constexpr int kQuads = kU / 4;                 // unit quads of a row
  constexpr int kItems = (kQuads + 1) / 2;       // (row, quad) items a thread: 64 t kQuads / 128 t
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (kAlign - smem_u32(smem_raw) % kAlign) % kAlign;
  const Plan& p = a.plan;
  const int n_t = a.n_t, n_b = a.n_b, n_h = a.n_h, g4 = 4 * n_h;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int d = blockIdx.x / p.ctas_dir, cta = blockIdx.x % p.ctas_dir;
  const int rank = cta % kC;                     // in the cluster
  const bool rev = (a.reverse_bits >> d) & 1;
  const int u0 = (cta - rank) * kU;              // the cluster's first unit
  const int first_atom = rank * p.atoms_cta;     // of the CTA's slice of K
  const int n_atoms = min(p.atoms_cta, p.atoms - first_atom);
  const int stages = p.stages;
  const int m_rows = 64 * p.tiles;
  const int stage_bytes = m_rows * kRowBytes;
  const int copy_bytes = kAtomK * 2 * n_b;       // one box: an atom's columns of B rows
  unsigned char* w_s = smem;
  unsigned char* a_s = smem + p.atoms_cta * kN * kRowBytes;
  // the partial sums, (64 t, kPitch) f32, over the dgates buffers once the
  // step's product is done
  float* part = reinterpret_cast<float*>(a_s);
  uint64_t* full = reinterpret_cast<uint64_t*>(a_s + stages * stage_bytes);   // one a buffer

  // W_hh^T's slice, once: row n of atom c's block holds unit u0 + n's
  // weights at columns (first_atom + c) 64 ... + 63, 16 bytes a thread;
  // units past H and columns past 4H zero. The buffers' rows past B are
  // never written by the copies: they only reach the product's rows past
  // B, which nothing reads.
  const __nv_bfloat16* w_d = a.w_t + static_cast<size_t>(d) * n_h * g4;
  for (int e = tid; e < n_atoms * kN * 8; e += threads) {
    const int c = e / (kN * 8), n = (e / 8) % kN, q = e % 8;
    const int j = u0 + n, k = (first_atom + c) * kAtomK + q * 8;
    const uint4 v = j < n_h && k < g4
                        ? *reinterpret_cast<const uint4*>(w_d + static_cast<size_t>(j) * g4 + k)
                        : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(w_s + c * kN * kRowBytes + swizzled(n, q)) = v;
  }
  if (tid == 0) {
    for (int b = 0; b < stages; ++b) mbar_init(full + b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the plain stores above, seen by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // atom c of the product after `done` products: its buffer's mbarrier and
  // the parity of that mbarrier when c lands (buffer b is filled
  // ceil((n_atoms - b) / stages) times a product)
  auto parity = [&](int done, int c) {
    const int b = c % stages;
    return (done * ((n_atoms - b + stages - 1) / stages) + c / stages) & 1;
  };
  auto load_atom = [&](int c, int row) {
    uint64_t* bar = full + c % stages;
    mbar_expect(bar, copy_bytes);
    tma_load(a_s + (c % stages) * stage_bytes, &a.dg_map, (first_atom + c) * kAtomK, row, bar);
  };

  // the thread's epilogue items: item q is (row, unit quad) e = tid + q
  // threads of the 64 t x kQuads of the CTA's own units
  const size_t state_d = static_cast<size_t>(d) * n_b * n_h;
  // item q's row and first unit (of the CTA's), recomputed where used
  auto row_of = [&](int q) { return (tid + q * threads) / kQuads; };
  auto quad_of = [&](int q) { return 4 * ((tid + q * threads) % kQuads); };
  bool valid[kItems];
  float4 dh[kItems], dc[kItems];   // the carries: dh_a (1 - m) and dc of the last step run
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int j = cta * kU + quad_of(q);
    valid[q] = tid + q * threads < m_rows * kQuads && row_of(q) < n_b && j < n_h;
    dh[q] = dc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!valid[q]) continue;
    const size_t st = state_d + static_cast<size_t>(row_of(q)) * n_h + j;
    dh[q] = *reinterpret_cast<const float4*>(a.dh_t + st);
    dc[q] = *reinterpret_cast<const float4*>(a.dc_t + st);
  }
  In in[kItems];
  auto load_in = [&](int s) {
    const int t = time_of(s, n_t, rev);
    const int t_before = s > 0 ? time_of(s - 1, n_t, rev) : 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!valid[q]) continue;
      const int r = row_of(q), j = cta * kU + quad_of(q);
      const size_t row = (static_cast<size_t>(d) * n_t + t) * n_b + r;
      const __nv_bfloat16* g_row = a.gates + row * g4 + j;
      In& x = in[q];
      x.i = load4_raw(g_row);
      x.f = load4_raw(g_row + n_h);
      x.g = load4_raw(g_row + 2 * n_h);
      x.o = load4_raw(g_row + 3 * n_h);
      x.c_prev = s == 0 ? load4_raw(a.c0 + state_d + static_cast<size_t>(r) * n_h + j)
                        : load4_raw(a.c_seq +
                                    ((static_cast<size_t>(d) * n_t + t_before) * n_b + r) * n_h +
                                    j);
      x.dy = load4_raw(a.dy + row * n_h + j);
      x.m = __ldg(a.mask + static_cast<size_t>(t) * n_b + r);
    }
  };
  if (n_t > 0) load_in(n_t - 1);

  const int row0 = wg * 64 + warp * 16 + lane / 4;   // the thread's accumulator rows
  const int col0 = 2 * (lane % 4);
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  // phase k runs the product of scan step s + 1 = n_t - k (k > 0), then the
  // cell of scan step s (none at k = n_t, which writes dh0 and dc0)
  for (int k = 0; k <= n_t; ++k) {
    const int s = n_t - 1 - k;
    float4 z[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k > 0) {
      const int row = (d * n_t + time_of(s + 1, n_t, rev)) * n_b;   // the map's row of the block
      // every CTA of the cluster has read the partial sums of the last
      // product, which lie over the buffers the copies refill
      if constexpr (kC > 1) {
        if (k > 1) cluster_wait();
      }
      if (tid < 32) {
        // the block was written by other CTAs through the generic proxy,
        // the buffers last by this cluster's: the copies are the async proxy
        asm volatile("fence.proxy.async;\n" ::: "memory");
        for (int c = tid; c < min(stages, n_atoms); c += 32) load_atom(c, row);
      }
      hold(acc);
      bool landed = true;
      for (int c = 0; c < n_atoms; ++c) {
        landed = mbar_wait_bounded(full + c % stages, parity(k - 1, c)) && landed;
        const uint32_t a0 = smem_u32(a_s + (c % stages) * stage_bytes + wg * 64 * kRowBytes);
        const uint32_t b0 = smem_u32(w_s + c * kN * kRowBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kAtomK / 16; ++kk)
          Wgmma<kN>::mma(acc, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32), c > 0 || kk > 0);
        wgmma_commit();
        if constexpr (kRing) {
          // atom c - 1 is done in every warpgroup; its buffer takes atom
          // c - 1 + stages
          wgmma_wait<1>();
          __syncthreads();
          if (tid == 0 && c >= 1 && c - 1 + stages < n_atoms) load_atom(c - 1 + stages, row);
        }
      }
      wgmma_wait<0>();
      hold(acc);
      if (!landed) __trap();   // a copy that never landed fails the call
      __syncthreads();   // every warpgroup's product is done with the buffers
      float* mine = part + static_cast<size_t>(row0) * kPitch + col0;
#pragma unroll
      for (int jn = 0; jn < kN / 8; ++jn) {
        *reinterpret_cast<float2*>(mine + 8 * jn) = make_float2(acc[4 * jn], acc[4 * jn + 1]);
        *reinterpret_cast<float2*>(mine + 8 * kPitch + 8 * jn) =
            make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
      }
      if constexpr (kC > 1) {
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      // the CTA's own units: the partial sums of every CTA of the cluster,
      // an item's loads all issued before the first is added, in rank order
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const float* own = part + static_cast<size_t>(row_of(q)) * kPitch + rank * kU + quad_of(q);
        float4 got[kC];
#pragma unroll
        for (int from = 0; from < kC; ++from) {
          got[from] = !valid[q]  ? make_float4(0.f, 0.f, 0.f, 0.f)
                      : kC > 1   ? load_cluster(own, from)
                                 : *reinterpret_cast<const float4*>(own);
        }
#pragma unroll
        for (int from = 0; from < kC; ++from) {
          z[q].x += got[from].x;
          z[q].y += got[from].y;
          z[q].z += got[from].z;
          z[q].w += got[from].w;
        }
      }
      if constexpr (kC > 1) cluster_arrive();
    }

    if (s < 0) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (!valid[q]) continue;
        const size_t st = state_d + static_cast<size_t>(row_of(q)) * n_h + cta * kU + quad_of(q);
        store4(a.dh0 + st, dh[q].x + z[q].x, dh[q].y + z[q].y, dh[q].z + z[q].z, dh[q].w + z[q].w);
        store4(a.dc0 + st, dc[q].x, dc[q].y, dc[q].z, dc[q].w);
      }
      break;
    }
    const int t = time_of(s, n_t, rev);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!valid[q]) continue;
      const In& x = in[q];
      float4 i = to_f32x4(x.i), f = to_f32x4(x.f), g = to_f32x4(x.g), o = to_f32x4(x.o);
      float4 cp = to_f32x4(x.c_prev), dyv = to_f32x4(x.dy);
      float dgs[4][4];   // [unit][gate]
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        cell(at(dh[q], v) + at(z[q], v), at(dc[q], v), at(i, v), at(f, v), at(g, v), at(o, v),
             at(cp, v), at(dyv, v), x.m, dgs[v], at(dh[q], v), at(dc[q], v));
      }
      __nv_bfloat16* dg_row = a.dg + ((static_cast<size_t>(d) * n_t + t) * n_b + row_of(q)) * g4 +
                              cta * kU + quad_of(q);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        store4(dg_row + gate * n_h, dgs[0][gate], dgs[1][gate], dgs[2][gate], dgs[3][gate]);
      }
    }
    // the step's dgates reach every CTA of the direction before its product
    grid::barrier_arrive(a.counters + d);
    if (s > 0) load_in(s - 1);
    grid::barrier_wait(a.counters + d, (k + 1) * p.ctas_dir);
  }
  // no CTA leaves while another of its cluster reads its shared memory
  if constexpr (kC > 1) {
    if (n_t > 0) cluster_wait();
  }
}

template <int kC, int kU, bool kRing>
const void* kernel() {
  return reinterpret_cast<const void*>(lstm_bwd_step_kernel_resident<kC, kU, kRing>);
}

// The kernel for a cluster size, units a CTA and ring, or nullptr where
// it is not built: bwd_plan's (C, U) pairs (BWD_SHAPES), each with and
// without a ring but (8, 20), which never takes one (where W_hh^T's slice
// of 8 x 20 units leaves too few buffers for every atom, it leaves too few
// for the partial sums too, and bwd_plan takes another pair).
const void* kernel_for(int cluster, int units, bool ring) {
  switch (cluster * 100 + units) {
    case 816: return ring ? kernel<8, 16, true>() : kernel<8, 16, false>();
    case 820: return ring ? nullptr : kernel<8, 20, false>();
    case 416: return ring ? kernel<4, 16, true>() : kernel<4, 16, false>();
    case 420: return ring ? kernel<4, 20, true>() : kernel<4, 20, false>();
    case 216: return ring ? kernel<2, 16, true>() : kernel<2, 16, false>();
    case 116: return ring ? kernel<1, 16, true>() : kernel<1, 16, false>();
    default: return nullptr;
  }
}

// What the launch needs of a plan, the layout being bwd_plan's: a built
// kernel; whole 64-row tiles covering the batch, at most kMaxTiles; whole
// clusters in each direction covering every unit; the cluster's slices of
// K atoms covering 4H, none empty; at least two buffers where they are a
// ring, and room in them for the partial sums; the shared memory the
// kernel lays out within the plan's, and that within what the card gives a
// CTA. (That the clusters are co-resident is checked at the launch.)
bool fits(const Plan& p, int n_dir, int n_b, int n_h, int smem_optin) {
  const int n = p.cluster * p.units;
  const int stage = 64 * p.tiles * kRowBytes;
  return kernel_for(p.cluster, p.units, p.stages < p.atoms_cta) != nullptr &&
         p.tiles == (n_b + 63) / 64 && p.tiles <= kMaxTiles && p.ctas_dir % p.cluster == 0 &&
         p.ctas_dir * p.units >= n_h && p.ctas == n_dir * p.ctas_dir &&
         p.atoms == (4 * n_h + kAtomK - 1) / kAtomK && p.atoms_cta * p.cluster >= p.atoms &&
         (p.cluster - 1) * p.atoms_cta < p.atoms &&
         p.stages >= (p.atoms_cta < 2 ? p.atoms_cta : 2) && p.stages <= p.atoms_cta &&
         p.stages * stage >= 64 * p.tiles * (n + kPad) * 4 &&
         kAlign + p.atoms_cta * n * kRowBytes + p.stages * (stage + 8) <= p.smem_bytes &&
         p.smem_bytes <= smem_optin;
}

// The launch's configuration: the plan's grid, clusters and shared memory
// (`attrs` holds the cluster size and, when `cooperative`, the
// cooperative flag: every CTA resident, or the launch fails).
cudaLaunchConfig_t launch_config(const Plan& p, cudaStream_t stream,
                                 cudaLaunchAttribute (&attrs)[2], bool cooperative) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(128 * p.tiles);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem_bytes);
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cfg;
}

// Clusters of the plan's kernel that the card holds at once, into *out.
cudaError_t active_clusters(const Plan& p, int* out) {
  const void* kernel = kernel_for(p.cluster, p.units, p.stages < p.atoms_cta);
  if (kernel == nullptr || p.tiles < 1 || p.tiles > kMaxTiles) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = launch_config(p, nullptr, attrs, false);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

cudaError_t run(const Plan& p, const void* gates, const void* mask, const void* w_t,
                const void* c0, const void* c_seq, const void* dy, void* dg, const void* dh_t,
                const void* dc_t, void* dh0, void* dc0, void* counters, int n_dir, int n_t,
                int n_b, int n_h, int reverse_bits, cudaStream_t stream) {
  int active = 0;
  cudaError_t err = active_clusters(p, &active);
  if (err != cudaSuccess) return err;
  // a cooperative launch must never wait on a CTA that is not resident
  if (active * p.cluster < p.ctas) return cudaErrorCooperativeLaunchTooLarge;
  Args args{};
  if (n_t > 0) {
    err = bf16_tensor_map(&args.dg_map, dg, 4 * static_cast<uint64_t>(n_h),
                          static_cast<uint64_t>(n_dir) * n_t * n_b, n_b);
    if (err != cudaSuccess) return err;
  }
  args.gates = static_cast<const __nv_bfloat16*>(gates);
  args.mask = static_cast<const float*>(mask);
  args.w_t = static_cast<const __nv_bfloat16*>(w_t);
  args.c0 = static_cast<const __nv_bfloat16*>(c0);
  args.c_seq = static_cast<const __nv_bfloat16*>(c_seq);
  args.dy = static_cast<const __nv_bfloat16*>(dy);
  args.dg = static_cast<__nv_bfloat16*>(dg);
  args.dh_t = static_cast<const float*>(dh_t);
  args.dc_t = static_cast<const float*>(dc_t);
  args.dh0 = static_cast<__nv_bfloat16*>(dh0);
  args.dc0 = static_cast<__nv_bfloat16*>(dc0);
  args.counters = static_cast<int*>(counters);
  args.n_t = n_t;
  args.n_b = n_b;
  args.n_h = n_h;
  args.reverse_bits = reverse_bits;
  args.plan = p;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = launch_config(p, stream, attrs, true);
  void* params[] = {&args};
  err = cudaLaunchKernelExC(&cfg, kernel_for(p.cluster, p.units, p.stages < p.atoms_cta),
                           params);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace resident

}  // namespace

// Runs the reverse scan of one layer on `stream` by the route of `plan`
// (bwd_plan's ten ints, resident::Plan): one cooperative launch of the
// resident kernel (bf16; counters: D zeroed int32), or n_t + 1 launches of
// the per-step kernel (counters unused). dh_rest and dc are f32 (D, B, H)
// and must hold dh_T and dc_T on entry; the per-step kernel overwrites them
// as its carries. Requires n_h % 8 == 0 (every row of 4H columns is whole
// 16-byte copies) and every pointer on a 16-byte boundary. Returns a
// cudaError_t: cudaErrorInvalidValue for a plan the resident kernel cannot
// run in its memory (resident::fits), cudaErrorCooperativeLaunchTooLarge where the resident
// grid's clusters cannot all be resident at once, else the first error any
// launch reported, or cudaSuccess.
extern "C" int dsjax_torch_lstm_bwd(const void* gates, const void* mask, const void* w_t,
                                    const void* c0, const void* c_seq, const void* dy,
                                    void* dg, void* dh_rest, void* dc, void* dh0, void* dc0,
                                    int n_dir, int n_t, int n_b, int n_h, int reverse_bits,
                                    int is_bf16, const int* plan_ints, void* counters,
                                    void* stream) {
  if (n_h % 8 != 0 || plan_ints == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_ints[0] == 1) {
    const resident::Plan p{plan_ints[0], plan_ints[1], plan_ints[2], plan_ints[3], plan_ints[4],
                           plan_ints[5], plan_ints[6], plan_ints[7], plan_ints[8], plan_ints[9]};
    int sm_count = 0, optin = 0;
    const cudaError_t err = grid::device_limits(&sm_count, &optin);
    if (err != cudaSuccess) return err;
    if (!is_bf16 || counters == nullptr || !resident::fits(p, n_dir, n_b, n_h, optin))
      return cudaErrorInvalidValue;
    return resident::run(p, gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0,
                         counters, n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  if (plan_ints[0] != 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    return run_bwd<__nv_bfloat16>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0,
                                  n_dir, n_t, n_b, n_h, reverse_bits, s);
  }
  return run_bwd<float>(gates, mask, w_t, c0, c_seq, dy, dg, dh_rest, dc, dh0, dc0, n_dir,
                        n_t, n_b, n_h, reverse_bits, s);
}

// The clusters of the resident kernel under `plan` (ten ints, a layout of
// bwd_plan's) that the card holds at once, into out[0]: what bwd_plan
// picks the cluster size by. Returns a cudaError_t.
extern "C" int dsjax_torch_lstm_bwd_clusters(const int* plan_ints, int* out) {
  const resident::Plan p{plan_ints[0], plan_ints[1], plan_ints[2], plan_ints[3], plan_ints[4],
                         plan_ints[5], plan_ints[6], plan_ints[7], plan_ints[8], plan_ints[9]};
  return resident::active_clusters(p, out);
}

// K3's kernel as built for a route: with cluster 0 the per-step kernel in
// the working type, else the resident kernel (bf16) for clusters of that
// size and CTAs of `units` units, with a ring of dgates buffers or not.
// out[0] registers a thread,
// out[1] static and out[2] dynamic shared memory a CTA in bytes (0 for the
// resident kernel, whose dynamic shared memory is its plan's), out[3]
// local memory a thread in bytes (spills), out[4] hidden units a CTA.
// Returns a cudaError_t.
extern "C" int dsjax_torch_lstm_bwd_attributes(int is_bf16, int cluster, int units, int ring,
                                               int* out) {
  cudaFuncAttributes attr;
  const void* kernel =
      cluster != 0 ? resident::kernel_for(cluster, units, ring != 0)
      : is_bf16    ? reinterpret_cast<const void*>(lstm_bwd_step_kernel<__nv_bfloat16>)
                   : reinterpret_cast<const void*>(lstm_bwd_step_kernel<float>);
  if (kernel == nullptr || (cluster != 0 && !is_bf16)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = cluster != 0 ? 0 : is_bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = cluster != 0 ? units : kUnits;
  return cudaSuccess;
}
