// The whole no-LM, no-pruning CTC prefix-beam scan for Hopper, sm_90a (K7),
// and the backtrack that reads its output.
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
//   select  the top W of the pool in lax.top_k's order as dsjax's Pallas
//           top-k compares (dsjax/ops/topk_pallas.py:_before): score
//           descending, the floats compared as floats (so -0.0 ties with
//           +0.0; no NaN), ties to the lower pool index; then the new state
//           from the parent slot; dead slots (score <= NEG/2) get sentinel
//           hashes -(k+2) and NEG mass. Frames t >= sizes[b] leave the
//           state as it is.
// Outputs per frame: backptr (parent or own slot), emit (char or -1), and
// the post-step h1, h2; at the end the totals, the carry, and the final
// beams ranked by total (the same order), so a decode needs no separate
// ranking launch.
//
// Exactness. logaddexp is m + log1pf(expf(-|a - b|)), jnp's formula, with
// no fused multiply-add in it (there is no product), so the plain version's
// separate torch ops give the same floats; build without --use_fast_math.
// The prefix hashes roll as h * 1000003 + c + 1 and h * 10007 + c + 1
// modulo 2^32 (int32 wraparound in dsjax and torch), computed here in
// uint32_t, where wraparound is defined. Killed and blank extends keep
// NEG, not -inf, so they can still win dead slots by pool index, as in the
// scan. The selection's key is the score with -0.0 made +0.0, mapped to
// the uint32 whose unsigned order is the float order (radix::order_key):
// greater key, earlier in the output, equal keys exactly the tied floats,
// and the pool index breaks the tie. A winner's score is computed again
// from its pool index, so it keeps its sign of zero. The pool's index is
// the scan's own flat index; with no lane padding (dsjax pads the width to
// 128 lanes) there are no pad slots to seed or sentinel-hash on resume.
//
// What bounds it on this card. The work is small and serial in time: per
// frame a hash join of the W stays against the W parents and the
// selection of W of the (C+1)W-entry pool (3968 at W = 128, C = 29), so a
// frame costs a chain of dependent steps, a few microseconds, and the T
// frames run one after another; the beam state never leaves shared memory.
//
// What the design does about it. The time loop inside the kernel: one
// launch a decode. The first form sorted the whole pool every frame (a
// 4096-entry block bitonic network, 78 barriers, at W = 128; 512 entries
// sorted by 512 threads through 45 barriers at W = 10) and joined each
// stay against every slot (O(W^2)). This one selects instead: each thread
// builds the pool scores of a strip of consecutive indices straight into
// registers as keys, and only the W winners are ordered; the join looks
// each stay's parent hashes up in a table of the live slots (open
// addressing, 2W entries or more). A CTA of kThreads takes an utterance,
// at every W, with K6's selection (radix_select.cuh): a radix select of
// the W-th key, 8 bits a pass through a shared histogram (at most 4
// passes), one exclusive scan that compacts the W survivors in pool order,
// each ranked by counting the survivors above it: about 17 barriers a
// frame against the sort's 86.
// The backtrack (backtrack_kernel) follows: one thread per (utterance, beam
// to follow) chases the parent pointers from t = T - 1 to 0, the
// counterpart of dsjax/decode/beam_device.py:_backtrack's lax.scan, which
// the port first ran as two gathers and two casts a frame.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

using namespace dsjax_torch::radix;

constexpr int kMaxW = 128;
constexpr int kMaxC = 30;
constexpr int kThreads = 512;
// pool entries a thread at most: (C + 1) W over the CTA's threads
constexpr int kPer = ((kMaxC + 1) * kMaxW + kThreads - 1) / kThreads;   // 8
constexpr float kNeg = -1e30f;                 // the scan's log zero
constexpr float kHalfNeg = -5e29f;             // NEG / 2: at or below it a slot is dead
constexpr uint32_t kP1 = 1000003u;
constexpr uint32_t kP2 = 10007u;
constexpr int kBacktrackThreads = 128;

static_assert(kMaxC <= 32, "a parent's killed extends are the bits of one word, and a "
                           "warp loads a frame's log-probs a class a lane");
static_assert(kMaxW <= kThreads, "one thread per beam slot");

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

// the join's table for W slots: a power of two of at least 2W entries
__host__ __device__ constexpr int table_size(int w) {
  int n = 2;
  while (n < 2 * w) n <<= 1;
  return n;
}

// One utterance's beam state and the scratch of its frame, in shared memory.
struct State {
  float pb[kMaxW], pnb[kMaxW], total[kMaxW], lp_last[kMaxW], stay_b[kMaxW], nb_stay[kMaxW];
  float stay_pool[kMaxW];      // stay r's pool score
  int last[kMaxW], h1[kMaxW], h2[kMaxW], ph1[kMaxW], ph2[kMaxW];
  uint32_t killed[kMaxW];      // bit c of q: extend (q, c) merged into a stay
  float lp[kMaxC];
  uint64_t surv[kMaxW];        // the frame's survivors as (key, ~pool index)
  int winner[kMaxW];           // the pool index of the frame's rank k
  int table[table_size(kMaxW)];   // the live slots by prefix hash, -1 empty (the join's)
  int hist[kPasses][kBins];    // the selection's histogram
  Select sel;                  // and the digits it has fixed
  uint32_t warp_total[32];     // the compaction scan's warp sums
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ int roll_hash(int h, uint32_t prime, int c) {
  return static_cast<int>(static_cast<uint32_t>(h) * prime + static_cast<uint32_t>(c + 1));
}

// the join's table: a slot for prefix hashes (h1, h2) in a table of n (a
// power of two at least 2W) entries, probed linearly
__device__ __forceinline__ int table_slot(int h1, int h2, int n) {
  const uint32_t x = static_cast<uint32_t>(h1) * 2654435761u ^ static_cast<uint32_t>(h2);
  return static_cast<int>((x ^ (x >> 16)) & static_cast<uint32_t>(n - 1));
}

// the selection's key of a score: its float order, -0.0 tying with +0.0
__device__ __forceinline__ uint32_t score_key(float x) {
  return order_key(x == 0.f ? 0.f : x);
}

// pool entries of the frame, from its stays, join and lp: extend (q, c)
// from parent q's fields (NEG for blank or killed), and entry i of the flat
// order
__device__ __forceinline__ float extend_value(uint32_t killed, int last, float pb, float total,
                                              float lp_c, int c, int blank) {
  const bool dead = c == blank || ((killed >> c) & 1u);
  return dead ? kNeg : (last == c ? pb : total) + lp_c;
}

__device__ __forceinline__ float extend_score(const State& s, int q, int c, int blank) {
  return extend_value(s.killed[q], s.last[q], s.pb[q], s.total[q], s.lp[c], c, blank);
}

__device__ __forceinline__ float pool_score(const State& s, int i, int w, int n_c, int blank) {
  if (i < w) return s.stay_pool[i];
  const int q = (i - w) / n_c;
  return extend_score(s, q, i - w - q * n_c, blank);
}

// All frames of utterance b, by the threads of its CTA.
__device__ void scan_utterance(const Params& p, int b, State& s) {
  const int tid = threadIdx.x;
  const int W = p.w, C = p.n_c, blank = p.blank;
  const int n_pool = W + W * C;
  const int per = (n_pool + blockDim.x - 1) / blockDim.x;
  const int base = tid * per;
  const int n_mine = max(0, min(per, n_pool - base));
  const int size = p.sizes[b];
  const size_t row = static_cast<size_t>(b) * W;
  const int n_table = table_size(W);

  if (tid < W) {
    if (p.init_pb != nullptr) {
      s.pb[tid] = p.init_pb[row + tid];
      s.pnb[tid] = p.init_pnb[row + tid];
      s.last[tid] = p.init_last[row + tid];
      s.h1[tid] = p.init_h1[row + tid];
      s.h2[tid] = p.init_h2[row + tid];
      s.ph1[tid] = p.init_ph1[row + tid];
      s.ph2[tid] = p.init_ph2[row + tid];
    } else {
      // only beam 0 alive, holding the empty prefix (hash 1, no parent 0)
      s.pb[tid] = tid == 0 ? 0.f : kNeg;
      s.pnb[tid] = kNeg;
      s.last[tid] = -1;
      s.h1[tid] = s.h2[tid] = 1;
      s.ph1[tid] = s.ph2[tid] = 0;
    }
  }
  __syncthreads();

  // the frame's log-probs, a class a thread, loaded a frame ahead
  const float* lp_b = p.lp + static_cast<size_t>(b) * p.n_t * C;
  const int frames = min(size, p.n_t);
  float lp_next = tid < C && frames > 0 ? lp_b[tid] : 0.f;
  for (int t = 0; t < p.n_t; ++t) {
    const size_t out = (static_cast<size_t>(t) * p.n_b + b) * W;
    if (t >= size) {
      // past the utterance: the state stays, each slot points to itself
      if (tid < W) {
        p.backptr[out + tid] = tid;
        p.emit[out + tid] = -1;
        p.h1_seq[out + tid] = s.h1[tid];
        p.h2_seq[out + tid] = s.h2[tid];
      }
      continue;
    }
    if (tid < C) {
      s.lp[tid] = lp_next;
      if (t + 1 < frames) lp_next = lp_b[static_cast<size_t>(t + 1) * C + tid];
    }
    if (tid < W) s.killed[tid] = 0u;
    for (int i = tid; i < n_table; i += blockDim.x) s.table[i] = -1;
    for (int i = tid; i < kPasses * kBins; i += blockDim.x) (&s.hist[0][0])[i] = 0;
    if (tid == 0) s.sel = Select{0u, 0u, W, 0};
    __syncthreads();

    // stays; every live slot enters the join's table under its prefix hash
    if (tid < W) {
      const float total = logaddexp(s.pb[tid], s.pnb[tid]);
      const int lq = s.last[tid];
      const float lp_last = s.lp[lq > 0 ? lq : 0];
      s.total[tid] = total;
      s.lp_last[tid] = lp_last;
      s.stay_b[tid] = total + s.lp[blank];
      s.nb_stay[tid] = lq >= 0 ? s.pnb[tid] + lp_last : kNeg;   // stay_nb for now
      if (total > kHalfNeg) {
        int i = table_slot(s.h1[tid], s.h2[tid], n_table);
        while (atomicCAS(&s.table[i], -1, tid) != -1) i = (i + 1) & (n_table - 1);
      }
    }
    __syncthreads();

    // merge join: stay r absorbs extend (q, last_r) where q's prefix is
    // r's prefix minus its last char; that extend leaves the pool. The
    // live q with q's prefix hashes equal to r's parent hashes are the
    // table's entries under them (every one: equal hashes share a probe
    // run), so the join is O(W) a frame, not O(W^2)
    if (tid < W) {
      const int r = tid;
      const int lr = s.last[r];
      float absorbed = kNeg;
      if (lr >= 0 && s.total[r] > kHalfNeg) {
        const int a1 = s.ph1[r], a2 = s.ph2[r];
        const float lp_last = s.lp_last[r];
        for (int i = table_slot(a1, a2, n_table), q; (q = s.table[i]) >= 0;
             i = (i + 1) & (n_table - 1)) {
          if (s.h1[q] == a1 && s.h2[q] == a2) {
            absorbed = fmaxf(absorbed, (s.last[q] == lr ? s.pb[q] : s.total[q]) + lp_last);
            atomicOr(&s.killed[q], 1u << lr);
          }
        }
      }
      s.nb_stay[r] = logaddexp(s.nb_stay[r], absorbed);
      s.stay_pool[r] = logaddexp(s.stay_b[r], s.nb_stay[r]);
    }
    __syncthreads();

    // the pool as keys, a strip of the scan's flat order a thread
    // A strip holds at most C + 1 entries, so its extends come from at most
    // two parents, whose fields are read once; no branch: every entry
    // computes a stay and an extend and keeps the one its index names.
    uint32_t key[kPer];
    {
      const int e0 = max(base - W, 0);                // the strip's first extend
      const int qa = min(e0 / C, W - 1), qb = min(e0 / C + 1, W - 1);
      const uint32_t killed_a = s.killed[qa], killed_b = s.killed[qb];
      const int last_a = s.last[qa], last_b = s.last[qb];
      const float pb_a = s.pb[qa], pb_b = s.pb[qb], total_a = s.total[qa], total_b = s.total[qb];
      int c = e0 - (e0 / C) * C;
      bool second = false;                            // past the first parent's last class
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool stay = base + j < W;
        const float ext = extend_value(second ? killed_b : killed_a, second ? last_b : last_a,
                                       second ? pb_b : pb_a, second ? total_b : total_a, s.lp[c],
                                       c, blank);
        key[j] = j < n_mine ? score_key(stay ? s.stay_pool[min(base + j, W - 1)] : ext) : 0u;
        const int next = stay ? c : c + 1;
        second = second || next == C;
        c = next == C ? 0 : next;
      }
    }
    // the radix select of the W-th key, the survivors compacted in pool
    // order, each ranked by the count of survivors above it
    block_select(key, per, n_mine, s.hist, &s.sel);
    const Select chosen = s.sel;
    const uint32_t excl =
        block_exclusive_scan(survivor_counts(key, n_mine, chosen), s.warp_total);
    compact(key, n_mine, base, chosen, W, excl, s.surv);
    __syncthreads();
    if (tid < W) {
      const uint64_t mine = s.surv[tid];
      int r = 0;
      for (int q = 0; q < W; ++q) r += s.surv[q] > mine;
      s.winner[r] = word_index(mine);
    }
    __syncthreads();

    // winners: a stay inherits its parent's fields; an extend's p_nb is its
    // pool score and its hashes roll on from the parent's
    float n_pb = 0.f, n_pnb = 0.f;
    int n_last = 0, n_h1 = 0, n_h2 = 0, n_ph1 = 0, n_ph2 = 0, parent = 0, ch = 0;
    if (tid < W) {
      const int k = tid;
      const int ix = s.winner[k];
      const float sc = pool_score(s, ix, W, C, blank);
      const bool stay = ix < W;
      const int e = ix - W;
      parent = stay ? ix : e / C;
      ch = stay ? -1 : e - (e / C) * C;
      const int g_h1 = s.h1[parent], g_h2 = s.h2[parent];
      n_pb = stay ? s.stay_b[parent] : kNeg;
      n_pnb = stay ? s.nb_stay[parent] : sc;
      n_last = stay ? s.last[parent] : ch;
      n_h1 = stay ? g_h1 : roll_hash(g_h1, kP1, ch);
      n_h2 = stay ? g_h2 : roll_hash(g_h2, kP2, ch);
      n_ph1 = stay ? s.ph1[parent] : g_h1;
      n_ph2 = stay ? s.ph2[parent] : g_h2;
      if (sc <= kHalfNeg) {
        // dead slots carry no mass and hashes that match no real prefix
        n_h1 = n_h2 = n_ph1 = n_ph2 = -(k + 2);
        n_pb = n_pnb = kNeg;
      }
    }
    __syncthreads();   // every winner has read the old state
    if (tid < W) {
      s.pb[tid] = n_pb;
      s.pnb[tid] = n_pnb;
      s.last[tid] = n_last;
      s.h1[tid] = n_h1;
      s.h2[tid] = n_h2;
      s.ph1[tid] = n_ph1;
      s.ph2[tid] = n_ph2;
      p.backptr[out + tid] = parent;
      p.emit[out + tid] = ch;
      p.h1_seq[out + tid] = n_h1;
      p.h2_seq[out + tid] = n_h2;
    }
    __syncthreads();
  }

  // totals, the carry, and the final beams ranked by total in the same
  // order: every slot survives, so the ranking is the count above each
  if (tid < W) {
    const float total = logaddexp(s.pb[tid], s.pnb[tid]);
    s.total[tid] = total;
    s.surv[tid] = (static_cast<uint64_t>(score_key(total)) << 32) | (kFull - tid);
    p.totals[row + tid] = total;
    p.pb[row + tid] = s.pb[tid];
    p.pnb[row + tid] = s.pnb[tid];
    p.last[row + tid] = s.last[tid];
    p.h1[row + tid] = s.h1[tid];
    p.h2[row + tid] = s.h2[tid];
    p.ph1[row + tid] = s.ph1[tid];
    p.ph2[row + tid] = s.ph2[tid];
  }
  __syncthreads();
  if (tid < W) {
    const uint64_t mine = s.surv[tid];
    int r = 0;
    for (int q = 0; q < W; ++q) r += s.surv[q] > mine;
    p.ranked[row + r] = s.total[tid];
    p.order[row + r] = tid;
  }
}

__global__ void __launch_bounds__(kThreads) beam_kernel(Params p) {
  __shared__ State s;
  scan_utterance(p, blockIdx.x, s);
}

// One thread per (utterance b, beam k to follow): from slot order[b, k] at
// t = T - 1 back to t = 0, chars[t, b, k] = emit[t, b, slot], slot =
// backptr[t, b, slot]; start[b, k] the slot at t = 0. Only the backptr
// load is on the chain; the emit load beside it overlaps.
__global__ void __launch_bounds__(kBacktrackThreads)
backtrack_kernel(const int* __restrict__ backptr, const int* __restrict__ emit,
                 const int* __restrict__ order, short* __restrict__ chars,
                 int* __restrict__ start, int n_t, int n_b, int w, int n_k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_b * n_k) return;
  const int b = i / n_k, k = i - b * n_k;
  int slot = order[i];
  for (int t = n_t - 1; t >= 0; --t) {
    const size_t at = (static_cast<size_t>(t) * n_b + b) * w + slot;
    chars[(static_cast<size_t>(t) * n_b + b) * n_k + k] = static_cast<short>(__ldg(emit + at));
    slot = __ldg(backptr + at);
  }
  start[i] = slot;
}

}  // namespace

// Runs the whole scan of n_b utterances on `stream`, one CTA each. The
// seven init pointers are all null (a new search) or all set (resume from
// a carry). Requires 1 <= w <= 128,
// 1 <= n_c <= 30, 0 <= blank < n_c. Returns a cudaError_t: cudaSuccess, or
// the launch's error.
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
  beam_kernel<<<n_b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The backtrack of n_k beams of each of n_b utterances through (n_t, n_b,
// w) int32 backptr and emit: chars (n_t, n_b, n_k) int16, start (n_b, n_k)
// int32, from the (n_b, n_k) int32 slots in order (each in [0, w)).
// Returns a cudaError_t.
extern "C" int dsjax_torch_beam_backtrack(const void* backptr, const void* emit,
                                          const void* order, void* chars, void* start, int n_t,
                                          int n_b, int w, int n_k, void* stream) {
  if (n_t < 0 || n_b < 1 || w < 1 || n_k < 1) return cudaErrorInvalidValue;
  const int n = n_b * n_k;
  backtrack_kernel<<<(n + kBacktrackThreads - 1) / kBacktrackThreads, kBacktrackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(backptr), static_cast<const int*>(emit),
      static_cast<const int*>(order), static_cast<short*>(chars), static_cast<int*>(start), n_t,
      n_b, w, n_k);
  return cudaGetLastError();
}
