// The matmul-only chain (K8) for Hopper, sm_90a: the floor of one step of
// the recurrent scans, without their gate math.
//
// Replaces the Pallas kernel _mm_kernel of tools/lstm_microbench.py (built
// in its main): per step t, z = h . W + xp[t] over all 4H columns in f32,
// then h <- z[:, :H] rounded to bf16. W is (H, 4H), xp (T, B, 4H), h (B, H),
// all bf16. The full (B, 4H) product of every step is written to a scratch
// buffer (bf16), so the chain does the work of one step of K1 (every gate
// column computed and stored), not just the H columns it carries on.
//
// What bounds it on this card. A step is 2 * B * H * 4H FLOP (537 MFLOP at
// B = 64, H = 1024): 0.54 us at the 989 TFLOP/s bf16 tensor-core peak. The
// steps are dependent and h_t has to reach every CTA between two of them,
// so a step's latency (the exchange, the copy of h, the product) bounds the
// chain, not its bytes or operations. The first form, one WMMA launch a
// step whose 128 CTAs re-read their W columns from L2 every step, took
// 17.8 us a step (9.1-9.4 ms at T = 512; PERF.md).
//
// The design (ops/mm_chain.py:chain_plan lays it out; checked again here):
// - One cooperative launch runs all T steps, one CTA an SM, each CTA owning
//   kCols = 32 output columns for every batch row: 4H / 32 CTAs (128 at
//   H = 1024), one warpgroup a 64-row tile of the batch (B <= 64: one).
// - W resident. At the start the CTA copies its (H x 32) slice of W into
//   shared memory, once, in the layout wgmma reads its B operand from:
//   K-major (each of the 32 columns of W a row of 128-byte K atoms of 64
//   bf16), 128-byte swizzle (16-byte chunk q of row r at chunk q ^ (r % 8)
//   of the row), one 4 KB block a K atom: 64 KB at H = 1024.
// - The step. Warp 0 loads h_t (other CTAs wrote it) one K atom at a
//   time with the tensor memory accelerator, a lane issuing each unit of
//   copies: a 2D box of 64 columns x B rows a copy, written in the same
//   swizzled K-major layout (M = 64 or 128 rows, the rows past B zeroed
//   once), its completion counted on the buffer's mbarrier (four atoms to
//   one where all are resident). Each warpgroup waits for the atoms'
//   mbarrier and runs wgmma.mma_async m64n32k16 on them, four atoms
//   unrolled at a time (f32 accumulators in registers), while the next
//   atoms land. Where every atom fits beside W (B <= 64: 128 KB at H =
//   1024) all are in flight at once; else (B = 128) they stream through a
//   ring of `stages` buffers, a buffer refilled once every warpgroup's
//   wgmma on it has completed. The epilogue adds xp[t], loaded into
//   registers while the CTA waited at the barrier, in f32, rounds to bf16
//   and writes the next h (the columns below H) before the barrier's
//   release, z after it.
// - Exchange. h is double-buffered in device memory, step s reading slot
//   s % 2 and writing slot (s + 1) % 2; the CTAs meet at one grid barrier a
//   step (grid_sync.cuh, as K1 and K4 do).
// The roundings are the first form's: f32 sums of bf16 products, then one
// rounding to bf16 after adding xp.
//
// What the first form of this design taught: with h copied by every thread
// with cp.async and a proxy fence before each atom's product, a step took
// 13.9 us (chip_smoke.py; H100 80GB HBM3 at 700 W) against the per-step
// kernel's 17.8. Each fence compiled to a full memory barrier that waited
// for every copy in flight, and wgmma sat in a branch the compiler could
// not prove warpgroup-uniform (a CTA of two warpgroups at B <= 64, the
// second idle in the product), so ptxas serialized every wgmma. tools/torch_kernel_probe.py times
// the choices that remain, each undone in a variant of this source.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "grid_sync.cuh"
#include "hopper_async.cuh"

namespace {

using namespace dsjax_torch;
using namespace dsjax_torch::hopper;

constexpr int kCols = 32;                      // output columns a CTA: wgmma's N
constexpr int kMaxB = 128;                     // two m64 tiles, a warpgroup each
constexpr int kWBlock = kCols * kRowBytes;     // W's block of one K atom
constexpr int kUnit = 4;                       // atoms a step of the product loop
constexpr int kMaxAtoms = 20;                  // H <= 1056 (4H / 32 CTAs on 132 SMs), in 4s
constexpr int kMinStages = 2;                  // a streamed ring: one atom in use, one landing
constexpr int kSmemLimit = 232448;             // a CTA's shared memory on sm_90 (chain_plan's)

// chain_plan's plan, in its order: CTAs, columns a CTA, rows of the
// product (B padded to 64 or 128), h buffers of one K atom, whether every
// atom of h has its own buffer, and the dynamic shared memory a CTA (the
// W slice, the h buffers, their mbarriers, the alignment pad).
struct Plan {
  int ctas, cols, m_rows, stages, resident, smem_bytes;
};

// K atoms of 64 columns of h: enough for H, a multiple of kUnit (the last
// ones partial or zero)
__host__ __device__ inline int atoms_of(int n_h) {
  return (n_h + kUnit * kAtomK - 1) / (kUnit * kAtomK) * kUnit;
}

// What chain_plan gives for this call on a card of sm_count SMs, or
// ctas = 0 where it raises.
Plan make_plan(int n_b, int n_h, int sm_count) {
  Plan p{};
  const int atoms = atoms_of(n_h);
  const int fixed = kAlign + atoms * kWBlock + kMaxAtoms * 8;
  p.cols = kCols;
  p.m_rows = n_b <= 64 ? 64 : 128;
  const int stage = p.m_rows * kRowBytes;
  const int fit = (kSmemLimit - fixed) / stage;
  p.stages = fit < atoms ? fit : atoms;
  p.resident = p.stages == atoms;
  p.smem_bytes = fixed + p.stages * stage;
  const bool ok = 4 * n_h / kCols <= sm_count && atoms <= kMaxAtoms &&
                  (p.resident || p.stages >= kMinStages);
  p.ctas = ok ? 4 * n_h / kCols : 0;
  return p;
}

struct Args {
  CUtensorMap h_map;         // h_buf as (2B, H): boxes of 64 columns x B rows, 128-byte swizzle
  const __nv_bfloat16* xp;   // (T, B, 4H)
  const __nv_bfloat16* w;    // (H, 4H)
  __nv_bfloat16* h_buf;      // (2, B, H)
  __nv_bfloat16* z;          // (B, 4H)
  int* counter;              // zeroed: arrivals at the barriers
  int n_t, n_b, n_h;
  Plan plan;
};

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous product; only where no wgmma is in flight (touching them
// while one is makes the compiler wait for it)
__device__ __forceinline__ void hold(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B over one k16 slice: A the warpgroup's 64 rows of h, B 32
// columns of W, both K-major in swizzled shared memory. Thread (warp w,
// lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1):
// d[4 j] (row, col), d[4 j + 1] (row, col + 1), d[4 j + 2] (row + 8, col),
// d[4 j + 3] (row + 8, col + 1).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One warpgroup a 64-row tile of the batch (128 threads at B <= 64, 256 at
// B = 128), every one running the product, so that no branch the compiler
// must take for divergent surrounds wgmma. Warp 0 also issues the tensor
// copies of h. The product walks the atoms kUnit at a time, their 4 kUnit
// k16 products unrolled. kResident: every atom of h has its own buffer
// (the plan's `resident`) and a unit's atoms land on one mbarrier; else
// each atom lands on its own mbarrier in a ring of buffers.
template <bool kResident>
__global__ void __launch_bounds__(2 * 128, 1) mm_chain_kernel(const __grid_constant__ Args a) {
  constexpr int kAtoms = kResident ? kUnit : 1;    // atoms a copy unit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (kAlign - smem_u32(smem_raw) % kAlign) % kAlign;
  const int atoms = atoms_of(a.n_h);
  const int m_rows = a.plan.m_rows, stages = a.plan.stages;
  const int units = atoms / kAtoms;                          // copy units a step
  const int slots = kResident ? units : stages;              // their mbarriers
  const int stage_bytes = m_rows * kRowBytes;
  const int copy_bytes = kAtomK * 2 * a.n_b;    // one box: the atom's columns of B rows
  unsigned char* w_s = smem;
  unsigned char* h_s = smem + atoms * kWBlock;
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + stages * stage_bytes);   // one a slot
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols;
  const int g4 = 4 * a.n_h;
  const size_t state = static_cast<size_t>(a.n_b) * a.n_h;

  // W's slice, once: 8 columns of one row of W a thread, each element to
  // its place in the K-major block of its K atom; rows past H (a partial
  // atom, the atoms that round the count up to kUnit) zero, so that every
  // atom takes four whole k16 products (the copies fill h past H with zeros
  // too)
  for (int e = tid; e < atoms * kAtomK * (kCols / 8); e += blockDim.x) {
    const int k = e / (kCols / 8), q = e % (kCols / 8);
    const uint4 v = k < a.n_h ? *reinterpret_cast<const uint4*>(a.w + static_cast<size_t>(k) * g4 +
                                                                n0 + q * 8)
                              : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
    unsigned char* block = w_s + (k / kAtomK) * kWBlock;
    const int kk = k % kAtomK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<__nv_bfloat16*>(block + swizzled(q * 8 + i, kk / 8) + (kk % 8) * 2) = x[i];
    }
  }
  // the rows past B of every h buffer: zero for the whole call (the copies
  // write B rows)
  const int pad_rows = m_rows - a.n_b;
  for (int i = tid; i < stages * pad_rows * 8; i += blockDim.x) {
    const int s = i / (pad_rows * 8), r = a.n_b + (i / 8) % pad_rows;
    *reinterpret_cast<uint4*>(h_s + s * stage_bytes + swizzled(r, i % 8)) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int b = 0; b < slots; ++b) mbar_init(full + b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the plain stores above, seen by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // copy unit u of step s (atoms u kAtoms ...): its slot's mbarrier and
  // the parity of that mbarrier when u lands (slot b is filled ceil((units
  // - b) / slots) times a step)
  auto parity = [&](int s, int u) {
    const int b = u % slots;
    return (s * ((units - b + slots - 1) / slots) + u / slots) & 1;
  };
  auto load_unit = [&](int s, int u) {
    uint64_t* bar = full + u % slots;
    mbar_expect(bar, copy_bytes * kAtoms);
#pragma unroll
    for (int g = 0; g < kAtoms; ++g) {
      const int c = u * kAtoms + g;
      tma_load(h_s + (c % stages) * stage_bytes, &a.h_map, c * kAtomK, (s & 1) * a.n_b, bar);
    }
  };

  // the thread's outputs (see wgmma_m64n32k16): xp of the step at them, as
  // bf16 pairs, [2 j + half] for rows row0 + 8 half
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  uint32_t xv[8];
  auto load_xp = [&](int t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        xv[2 * j + half] =
            row < a.n_b ? __ldg(reinterpret_cast<const unsigned int*>(
                              a.xp + (static_cast<size_t>(t) * a.n_b + row) * g4 + n0 + 8 * j + col0))
                        : 0u;
      }
    }
  };

  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  load_xp(0);
  for (int s = 0; s < a.n_t; ++s) {
    __nv_bfloat16* h_out = a.h_buf + ((s + 1) & 1) * state;
    if (tid < 32) {
      // h_t was written by other CTAs through the generic proxy; the copies
      // read it through the async proxy. The units go out a lane each.
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      for (int u = tid; u < slots; u += 32) load_unit(s, u);
    }
    hold(d);
    for (int c0 = 0; c0 < atoms; c0 += kUnit) {
      if constexpr (kResident) mbar_wait(full + c0 / kUnit, s & 1);
#pragma unroll
      for (int u = 0; u < kUnit; ++u) {
        const int c = c0 + u;
        if constexpr (!kResident) mbar_wait(full + c % slots, parity(s, c));
        const uint32_t a0 = smem_u32(h_s + (c % stages) * stage_bytes + wg * 64 * kRowBytes);
        const uint32_t b0 = smem_u32(w_s + c * kWBlock);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kAtomK / 16; ++kk)
          wgmma_m64n32k16(d, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32), c > 0 || kk > 0);
        wgmma_commit();
        if constexpr (!kResident) {
          // atom c - 1 is done in every warpgroup; its buffer takes atom
          // c - 1 + stages
          wgmma_wait<1>();
          __syncthreads();
          if (tid == 0 && c >= 1 && c - 1 + stages < atoms) load_unit(s, c - 1 + stages);
        }
      }
    }
    wgmma_wait<0>();
    hold(d);
    __nv_bfloat162 zv[8];   // the step's outputs, [2 j + half] as xv
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= a.n_b) continue;
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[2 * j + half]));
        const __nv_bfloat162 v = __floats2bfloat162_rn(d[4 * j + 2 * half] + x.x,
                                                       d[4 * j + 2 * half + 1] + x.y);
        zv[2 * j + half] = v;
        const int col = n0 + 8 * j + col0;
        if (col < a.n_h)
          *reinterpret_cast<__nv_bfloat162*>(h_out + static_cast<size_t>(row) * a.n_h + col) = v;
      }
    }
    // only h has to reach the other CTAs before the barrier: z is stored
    // after the arrival, so that the release does not wait for it
    if (s + 1 < a.n_t) grid::barrier_arrive(a.counter);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < a.n_b)
          *reinterpret_cast<__nv_bfloat162*>(a.z + static_cast<size_t>(row) * g4 + n0 + 8 * j +
                                             col0) = zv[2 * j + half];
      }
    }
    if (s + 1 < a.n_t) {
      load_xp(s + 1);
      grid::barrier_wait(a.counter, (s + 1) * a.plan.ctas);
    }
  }
}

// The map of h_buf as a (2B, H) bf16 matrix whose boxes are 64 columns of
// B rows, written to shared memory in the 128-byte swizzle; columns past H
// (a last partial atom) come as zeros.
cudaError_t h_tensor_map(CUtensorMap* map, void* h_buf, int n_b, int n_h) {
  return bf16_tensor_map(map, h_buf, n_h, 2 * n_b, n_b);
}

}  // namespace

// Runs all n_t steps in one cooperative launch on `stream`. h_buf is
// (2, B, H) bf16: slot 0 holds the initial h, and the final h is left in
// slot n_t % 2. z is the (B, 4H) bf16 scratch, holding the last step's
// product at the end; counter one zeroed int32. plan: chain_plan's
// six ints (Plan). Requires n_b a multiple of 16 and at most 128, n_h a
// multiple of 16 up to 1056, h_buf and w on 16 bytes, xp and z on 4.
// Returns a cudaError_t: cudaErrorInvalidValue for a shape or plan it does
// not take, cudaErrorCooperativeLaunchTooLarge where the grid cannot be
// co-resident, or the launch's own error.
extern "C" int dsjax_torch_mm_chain(const void* xp, const void* w, void* h_buf, void* z,
                                    void* counter, const int* plan_ints, int n_t, int n_b,
                                    int n_h, void* stream) {
  if (n_b < 16 || n_b % 16 != 0 || n_b > kMaxB || n_h < 16 || n_h % 16 != 0 || n_t < 0 ||
      plan_ints == nullptr || counter == nullptr) {
    return cudaErrorInvalidValue;
  }
  int sm_count = 0, optin = 0;
  cudaError_t err = grid::device_limits(&sm_count, &optin);
  if (err != cudaSuccess) return err;
  const Plan want = make_plan(n_b, n_h, sm_count);
  const Plan p{plan_ints[0], plan_ints[1], plan_ints[2],
               plan_ints[3], plan_ints[4], plan_ints[5]};
  if (want.ctas == 0 || p.ctas != want.ctas || p.cols != want.cols ||
      p.m_rows != want.m_rows || p.stages != want.stages || p.resident != want.resident ||
      p.smem_bytes != want.smem_bytes || p.smem_bytes > optin) {
    return cudaErrorInvalidValue;
  }
  if (n_t == 0) return cudaSuccess;
  const int threads = 128 * (p.m_rows / 64);
  const auto kernel = p.resident ? mm_chain_kernel<true> : mm_chain_kernel<false>;
  err = grid::fit_coresident(kernel, threads, p.smem_bytes, p.ctas, sm_count);
  if (err != cudaSuccess) return err;
  Args args{};
  err = h_tensor_map(&args.h_map, h_buf, n_b, n_h);
  if (err != cudaSuccess) return err;
  args.xp = static_cast<const __nv_bfloat16*>(xp);
  args.w = static_cast<const __nv_bfloat16*>(w);
  args.h_buf = static_cast<__nv_bfloat16*>(h_buf);
  args.z = static_cast<__nv_bfloat16*>(z);
  args.counter = static_cast<int*>(counter);
  args.n_t = n_t;
  args.n_b = n_b;
  args.n_h = n_h;
  args.plan = p;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.ctas),
                                    dim3(threads), params, static_cast<size_t>(p.smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K8's kernel as built for a plan with every atom of h resident or not:
// out[0] registers a thread, out[1] static shared memory a CTA in bytes,
// out[2] 0 (the dynamic shared memory is the plan's), out[3] local memory
// a thread in bytes, out[4] the columns a CTA.
extern "C" int dsjax_torch_mm_chain_attributes(int resident, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(resident ? mm_chain_kernel<true>
                                                    : mm_chain_kernel<false>));
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kCols;
  return cudaSuccess;
}
