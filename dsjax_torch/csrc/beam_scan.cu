// The whole no-LM, no-pruning CTC prefix-beam scan for Hopper, sm_90a (K7).
//
// Replaces dsjax/ops/beam_pallas.py:fused_beam_scan (body _beam_kernel).
// Contract: bit for bit what dsjax_torch/decode/beam_device.py:_beam_scan
// computes without pruning, slot order included. Per utterance b and frame
// t < sizes[b], with (p_b, p_nb, last, h1, h2, ph1, ph2) the (W,) beam
// state:
//   total   = logaddexp(p_b, p_nb)
//   stays   stay_b = total + lp[blank];
//           stay_nb = last >= 0 ? p_nb + lp[last] : NEG
//   merge   for r with last_r >= 0 and live, the q with (h1, h2)_q ==
//           (ph1, ph2)_r and live: absorbed_r = max(NEG, max_q (last_q ==
//           last_r ? p_b_q : total_q) + lp[last_r]); extend (q, last_r)
//           is killed (NEG); nb_stay = logaddexp(stay_nb, absorbed)
//   pool    [W stays logaddexp(stay_b, nb_stay) | W*C extends, q-major:
//           (last_q == c ? p_b_q : total_q) + lp[c], NEG for c == blank
//           or killed]
//   select  the top W of the pool in lax.top_k's order (score desc, ties
//           to the lower pool index), then the new state from the parent
//           slot; dead slots (score <= NEG/2) get sentinel hashes -(k+2)
//           and NEG mass. Frames t >= sizes[b] leave the state as it is.
// Outputs per frame: backptr (parent or own slot), emit (char or -1), and
// the post-step h1, h2; at the end the totals, the carry, and the final
// beams ranked by total (the same top-k order), so a decode needs no
// separate ranking launch.
//
// Exactness. logaddexp is m + log1pf(expf(-|a - b|)), jnp's formula, with
// no fused multiply-add in it (there is no product), so the plain version's
// separate torch ops give the same floats; build without --use_fast_math.
// The prefix hashes roll as h * 1000003 + c + 1 and h * 10007 + c + 1
// modulo 2^32 (int32 wraparound in dsjax and torch), computed here in
// uint32_t, where wraparound is defined. Killed and blank extends keep
// NEG, not -inf, so they can still win dead slots by pool index, as in the
// scan; only the pool's padding to a power of two is -inf (index >= pool
// size), strictly below every real entry. The pool's index is the scan's
// own flat index, so no order keys are needed; and with no lane padding
// (dsjax pads the width to 128 lanes) there are no pad slots to seed or
// sentinel-hash on resume.
//
// What bounds it on this card. The work is small and serial in time: per
// frame an O(W^2) hash join and a sort of the (C+1)W-entry pool (3968 at
// W = 128, C = 29, padded to 4096: 78 bitonic stages, each a block barrier),
// so a frame costs a few microseconds of barrier-bound latency, and the T
// frames run one after another. The beam state never leaves shared memory.
//
// What the design does about it. One CTA per utterance with the time loop
// inside the kernel: one launch a decode, instead of T top-k launches plus
// the scan's elementwise ops. Every frame's state lives in shared memory
// (43 KB at W = 128); the join runs one thread per stay r scanning the W
// parents with broadcast shared reads; the sort is the block-wide bitonic
// network of bitonic.cuh. With 16 utterances a decode fills 16 of
// the 132 SMs: more CTAs per utterance (a split sort) is later work.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace {

using namespace dsjax_torch;

constexpr int kMaxW = 128;
constexpr int kMaxC = 30;
constexpr int kMaxPool = 4096;                 // next power of two of 31 * 128
constexpr int kThreads = 512;
constexpr float kNeg = -1e30f;                 // the scan's log zero
constexpr float kHalfNeg = -5e29f;             // NEG / 2: at or below it a slot is dead
constexpr uint32_t kP1 = 1000003u;
constexpr uint32_t kP2 = 10007u;

static_assert(kMaxW <= kThreads, "one thread per beam slot");
static_assert((kMaxC + 1) * kMaxW <= kMaxPool, "the pool fits");

struct Params {
  const float* lp;        // (B, T, C)
  const int* sizes;       // (B,)
  // initial state, (B, W) each, or all null for a new search
  const float* init_pb;
  const float* init_pnb;
  const int* init_last;
  const int* init_h1;
  const int* init_h2;
  const int* init_ph1;
  const int* init_ph2;
  int* backptr;           // (T, B, W)
  int* emit;
  int* h1_seq;
  int* h2_seq;
  float* totals;          // (B, W)
  float* ranked;          // (B, W) totals in rank order
  int* order;             // (B, W) their slots
  float* pb;              // final state, (B, W) each
  float* pnb;
  int* last;
  int* h1;
  int* h2;
  int* ph1;
  int* ph2;
  int n_b, n_t, n_c, w, blank;
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ int roll_hash(int h, uint32_t prime, int c) {
  return static_cast<int>(static_cast<uint32_t>(h) * prime + static_cast<uint32_t>(c + 1));
}

__global__ void __launch_bounds__(kThreads) beam_scan_kernel(Params p) {
  __shared__ float pool_s[kMaxPool];
  __shared__ int pool_i[kMaxPool];
  __shared__ float s_pb[kMaxW], s_pnb[kMaxW], s_total[kMaxW], s_lp_last[kMaxW];
  __shared__ float s_stay_b[kMaxW], s_nb_stay[kMaxW];
  __shared__ int s_last[kMaxW], s_h1[kMaxW], s_h2[kMaxW], s_ph1[kMaxW], s_ph2[kMaxW];
  __shared__ unsigned char s_killed[kMaxW * kMaxC];
  __shared__ float s_lp[kMaxC];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = p.w, C = p.n_c, blank = p.blank;
  const int n_pool = W + W * C;
  int n_pad = 1;
  while (n_pad < n_pool) n_pad <<= 1;
  const int size = p.sizes[b];
  const size_t row = static_cast<size_t>(b) * W;

  if (tid < W) {
    if (p.init_pb != nullptr) {
      s_pb[tid] = p.init_pb[row + tid];
      s_pnb[tid] = p.init_pnb[row + tid];
      s_last[tid] = p.init_last[row + tid];
      s_h1[tid] = p.init_h1[row + tid];
      s_h2[tid] = p.init_h2[row + tid];
      s_ph1[tid] = p.init_ph1[row + tid];
      s_ph2[tid] = p.init_ph2[row + tid];
    } else {
      // only beam 0 alive, holding the empty prefix (hash 1, no parent 0)
      s_pb[tid] = tid == 0 ? 0.f : kNeg;
      s_pnb[tid] = kNeg;
      s_last[tid] = -1;
      s_h1[tid] = s_h2[tid] = 1;
      s_ph1[tid] = s_ph2[tid] = 0;
    }
  }
  __syncthreads();

  for (int t = 0; t < p.n_t; ++t) {
    const size_t out = (static_cast<size_t>(t) * p.n_b + b) * W;
    if (t >= size) {
      // past the utterance: the state stays, each slot points to itself
      if (tid < W) {
        p.backptr[out + tid] = tid;
        p.emit[out + tid] = -1;
        p.h1_seq[out + tid] = s_h1[tid];
        p.h2_seq[out + tid] = s_h2[tid];
      }
      continue;
    }
    const float* lp_t = p.lp + (static_cast<size_t>(b) * p.n_t + t) * C;
    for (int c = tid; c < C; c += blockDim.x) s_lp[c] = lp_t[c];
    for (int i = tid; i < W * C; i += blockDim.x) s_killed[i] = 0;
    __syncthreads();

    // stays
    if (tid < W) {
      const float total = logaddexp(s_pb[tid], s_pnb[tid]);
      const int lq = s_last[tid];
      const float lp_last = s_lp[lq > 0 ? lq : 0];
      s_total[tid] = total;
      s_lp_last[tid] = lp_last;
      s_stay_b[tid] = total + s_lp[blank];
      s_nb_stay[tid] = lq >= 0 ? s_pnb[tid] + lp_last : kNeg;   // stay_nb for now
    }
    __syncthreads();

    // merge join: stay r absorbs extend (q, last_r) where q's prefix is
    // r's prefix minus its last char; that extend leaves the pool
    if (tid < W) {
      const int r = tid;
      const int lr = s_last[r];
      float absorbed = kNeg;
      if (lr >= 0 && s_total[r] > kHalfNeg) {
        const int a1 = s_ph1[r], a2 = s_ph2[r];
        const float lp_last = s_lp_last[r];
        for (int q = 0; q < W; ++q) {
          if (s_h1[q] == a1 && s_h2[q] == a2 && s_total[q] > kHalfNeg) {
            absorbed = fmaxf(absorbed, (s_last[q] == lr ? s_pb[q] : s_total[q]) + lp_last);
            s_killed[q * C + lr] = 1;
          }
        }
      }
      s_nb_stay[r] = logaddexp(s_nb_stay[r], absorbed);
    }
    __syncthreads();

    // the pool, in the scan's flat order [W stays | W*C extends]
    for (int i = tid; i < n_pad; i += blockDim.x) {
      float sc;
      if (i < W) {
        sc = logaddexp(s_stay_b[i], s_nb_stay[i]);
      } else if (i < n_pool) {
        const int e = i - W;
        const int q = e / C;
        const int c = e - q * C;
        sc = (s_last[q] == c ? s_pb[q] : s_total[q]) + s_lp[c];
        if (c == blank || s_killed[e]) sc = kNeg;
      } else {
        sc = -INFINITY;
      }
      pool_s[i] = sc;
      pool_i[i] = i;
    }
    __syncthreads();
    block_bitonic_sort(pool_s, pool_i, n_pad);

    // winners: a stay inherits its parent's fields; an extend's p_nb is its
    // pool score and its hashes roll on from the parent's
    float n_pb = 0.f, n_pnb = 0.f;
    int n_last = 0, n_h1 = 0, n_h2 = 0, n_ph1 = 0, n_ph2 = 0, parent = 0, ch = 0;
    if (tid < W) {
      const int k = tid;
      const float sc = pool_s[k];
      const int ix = pool_i[k];
      const bool stay = ix < W;
      const int e = ix - W;
      parent = stay ? ix : e / C;
      ch = stay ? -1 : e - (e / C) * C;
      const int g_h1 = s_h1[parent], g_h2 = s_h2[parent];
      n_pb = stay ? s_stay_b[parent] : kNeg;
      n_pnb = stay ? s_nb_stay[parent] : sc;
      n_last = stay ? s_last[parent] : ch;
      n_h1 = stay ? g_h1 : roll_hash(g_h1, kP1, ch);
      n_h2 = stay ? g_h2 : roll_hash(g_h2, kP2, ch);
      n_ph1 = stay ? s_ph1[parent] : g_h1;
      n_ph2 = stay ? s_ph2[parent] : g_h2;
      if (sc <= kHalfNeg) {
        // dead slots carry no mass and hashes that match no real prefix
        n_h1 = n_h2 = n_ph1 = n_ph2 = -(k + 2);
        n_pb = n_pnb = kNeg;
      }
    }
    __syncthreads();   // every winner has read the old state
    if (tid < W) {
      s_pb[tid] = n_pb;
      s_pnb[tid] = n_pnb;
      s_last[tid] = n_last;
      s_h1[tid] = n_h1;
      s_h2[tid] = n_h2;
      s_ph1[tid] = n_ph1;
      s_ph2[tid] = n_ph2;
      p.backptr[out + tid] = parent;
      p.emit[out + tid] = ch;
      p.h1_seq[out + tid] = n_h1;
      p.h2_seq[out + tid] = n_h2;
    }
    __syncthreads();
  }

  // totals, the carry, and the final beams ranked by total
  int rank_n = 1;
  while (rank_n < W) rank_n <<= 1;
  for (int i = tid; i < rank_n; i += blockDim.x) {
    if (i < W) {
      const float total = logaddexp(s_pb[i], s_pnb[i]);
      p.totals[row + i] = total;
      pool_s[i] = total;
      p.pb[row + i] = s_pb[i];
      p.pnb[row + i] = s_pnb[i];
      p.last[row + i] = s_last[i];
      p.h1[row + i] = s_h1[i];
      p.h2[row + i] = s_h2[i];
      p.ph1[row + i] = s_ph1[i];
      p.ph2[row + i] = s_ph2[i];
    } else {
      pool_s[i] = -INFINITY;
    }
    pool_i[i] = i;
  }
  __syncthreads();
  block_bitonic_sort(pool_s, pool_i, rank_n);
  if (tid < W) {
    p.ranked[row + tid] = pool_s[tid];
    p.order[row + tid] = pool_i[tid];
  }
}

}  // namespace

// Runs the whole scan of n_b utterances on `stream`, one CTA each. The
// seven init pointers are all null (a new search) or all set (resume from a
// carry). Requires 1 <= w <= 128, 1 <= n_c <= 30, 0 <= blank < n_c.
// Returns a cudaError_t: cudaSuccess, or the launch's error.
extern "C" int dsjax_torch_beam_scan(
    const void* lp, const void* sizes, const void* init_pb, const void* init_pnb,
    const void* init_last, const void* init_h1, const void* init_h2, const void* init_ph1,
    const void* init_ph2, void* backptr, void* emit, void* h1_seq, void* h2_seq, void* totals,
    void* ranked, void* order, void* pb, void* pnb, void* last, void* h1, void* h2, void* ph1,
    void* ph2, int n_b, int n_t, int n_c, int w, int blank, void* stream) {
  if (w < 1 || w > kMaxW || n_c < 1 || n_c > kMaxC || blank < 0 || blank >= n_c || n_b < 1 ||
      n_t < 0) {
    return cudaErrorInvalidValue;
  }
  const bool resume = init_pb != nullptr;
  if ((init_pnb != nullptr) != resume || (init_last != nullptr) != resume ||
      (init_h1 != nullptr) != resume || (init_h2 != nullptr) != resume ||
      (init_ph1 != nullptr) != resume || (init_ph2 != nullptr) != resume) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.lp = static_cast<const float*>(lp);
  p.sizes = static_cast<const int*>(sizes);
  p.init_pb = static_cast<const float*>(init_pb);
  p.init_pnb = static_cast<const float*>(init_pnb);
  p.init_last = static_cast<const int*>(init_last);
  p.init_h1 = static_cast<const int*>(init_h1);
  p.init_h2 = static_cast<const int*>(init_h2);
  p.init_ph1 = static_cast<const int*>(init_ph1);
  p.init_ph2 = static_cast<const int*>(init_ph2);
  p.backptr = static_cast<int*>(backptr);
  p.emit = static_cast<int*>(emit);
  p.h1_seq = static_cast<int*>(h1_seq);
  p.h2_seq = static_cast<int*>(h2_seq);
  p.totals = static_cast<float*>(totals);
  p.ranked = static_cast<float*>(ranked);
  p.order = static_cast<int*>(order);
  p.pb = static_cast<float*>(pb);
  p.pnb = static_cast<float*>(pnb);
  p.last = static_cast<int*>(last);
  p.h1 = static_cast<int*>(h1);
  p.h2 = static_cast<int*>(h2);
  p.ph1 = static_cast<int*>(ph1);
  p.ph2 = static_cast<int*>(ph2);
  p.n_b = n_b;
  p.n_t = n_t;
  p.n_c = n_c;
  p.w = w;
  p.blank = blank;
  beam_scan_kernel<<<n_b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
