// Copy of dsjax/cpp/src/beam.cpp, built into the port's own host library
// so that dsjax_torch imports nothing of dsjax. ds_levenshtein, which
// dsjax defines at the end of this file, is defined once in the port's
// library, in levenshtein.cpp.
//
// CTC prefix beam search with optional n-gram LM fusion (native).
//
// Semantics match the Python reference implementation in
// dsjax/decode/beam.py (which itself mirrors the external ctcdecode C++
// package the reference wraps, reference: decoder.py:56-118): per-prefix
// (p_blank, p_nonblank) log masses, candidate pruning by cutoff_top_n /
// cutoff_prob, word-completion LM fusion alpha*ln P(w|h) + beta, trailing
// word scored at finalization. Prefixes live in a trie so extension is O(1)
// and word/history extraction walks parent pointers (no string churn).
//
// Exposed through a plain C ABI (ctypes-friendly, no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <string>
#include <vector>

#include "lm.h"

namespace dsjax {
namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double logaddexp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct BeamScore {
  double p_b = kNegInf;
  double p_nb = kNegInf;
  double total() const { return logaddexp(p_b, p_nb); }
};

// Prefix trie node, tuned for the beam hot loop: intrusive child list
// (child counts are <= n_keep, a linear scan beats hashing), arena
// allocation (std::deque, no per-node malloc/free), and in-node epoch
// stamping so per-step candidate merging needs NO hash map at all.
// Nodes live for one ds_beam_decode call (arena memory is retained;
// ctcdecode-style deletion just unlinks the node from the trie).
//
// Offsets semantics (ctcdecode parity, reference decoder.py:85-101 over
// parlance/ctcdecode path_trie.cpp): (log_prob_c, timestep) update on
// EVERY extension attempt whose frame char log-prob beats the stored one,
// while pruning a beam marks it dead and unlinks childless chains so a
// re-created prefix starts with fresh state.
struct TrieNode {
  TrieNode* parent = nullptr;
  TrieNode* first_child = nullptr;
  TrieNode* last_child = nullptr;
  TrieNode* next_sibling = nullptr;
  int label = -1;       // label id of the edge from parent
  int timestep = -1;    // loudest attempt frame (ctcdecode timestep)
  double log_prob_c = kNegInf;  // frame log-prob backing `timestep`
  int depth = 0;
  int epoch = -1;       // last step that touched this node
  bool exists = true;   // ctcdecode exists_: node is a live beam candidate
  BeamScore pending;    // per-step merged candidate mass
  double lm_memo = 0.0; // word-boundary LM bonus (prefix-invariant)
  bool lm_cached = false;
  // deterministic tie-breaking (python-twin parity): children append in
  // first-attempt order and carry a monotone per-parent sibling index, so
  // equal-score beam candidates can be ordered by trie PREORDER — exactly
  // the order the python twin's stable sort over iterate_to_vec produces.
  int sib = 0;          // insertion index within parent (monotone)
  int n_sibs = 0;       // next sibling index to hand out
  int fresh_epoch = -1; // per-step fresh-extension counter (virtual sibs)
  int fresh_n = 0;

  TrieNode* find_child(int l) const {
    for (TrieNode* c = first_child; c; c = c->next_sibling)
      if (c->label == l) return c;
    return nullptr;
  }

  void unlink_child(TrieNode* child) {
    TrieNode** slot = &first_child;
    TrieNode* prev = nullptr;
    while (*slot && *slot != child) {
      prev = *slot;
      slot = &(*slot)->next_sibling;
    }
    if (*slot) {
      *slot = child->next_sibling;
      if (last_child == child) last_child = prev;
    }
  }

  // ctcdecode PathTrie::remove(): mark dead; delete (unlink) childless
  // chains so their (log_prob_c, timestep) state is forgotten.
  void remove() {
    exists = false;
    if (!first_child && parent) {
      parent->unlink_child(this);
      TrieNode* p = parent;
      parent = nullptr;  // guard against double unlink
      if (!p->exists && !p->first_child) p->remove();
    }
  }
};

struct Arena {
  std::deque<TrieNode> pool;
  TrieNode* make(TrieNode* parent, int label, int t, double log_prob_c) {
    pool.emplace_back();
    TrieNode* n = &pool.back();
    n->parent = parent;
    n->label = label;
    n->timestep = t;
    n->log_prob_c = log_prob_c;
    n->depth = parent->depth + 1;
    // APPEND (python-dict insertion-order parity; preorder tie-breaks
    // downstream depend on it) with a monotone sibling index — deletion
    // never reuses an index, matching dict re-insertion at the end
    n->sib = parent->n_sibs++;
    if (parent->last_child) {
      parent->last_child->next_sibling = n;
    } else {
      parent->first_child = n;
    }
    parent->last_child = n;
    return n;
  }
};

struct Decoder {
  std::vector<std::string> labels;
  int blank;
  int space;
  const Lm* lm = nullptr;  // borrowed

  // Extract the last word ending at `node` (exclusive of the space at
  // node itself) plus up to (order-1) history words, oldest first.
  double lm_score(const TrieNode* node, double alpha, double beta) const {
    if (!lm) return 0.0;  // ctcdecode applies alpha/beta only via the LM
    // collect labels back to root
    std::vector<std::string> words;
    std::string cur;
    const TrieNode* p = node;
    int needed = lm->order();  // last word + order-1 history
    while (p && p->label >= 0 && (int)words.size() < needed + 1) {
      if (p->label == space) {
        if (!cur.empty()) {
          std::reverse(cur.begin(), cur.end());
          words.push_back(cur);
          cur.clear();
        }
      } else {
        // append utf-8 label reversed later; labels are usually 1 char
        const std::string& s = labels[p->label];
        for (auto it = s.rbegin(); it != s.rend(); ++it) cur.push_back(*it);
      }
      p = p->parent;
    }
    if (!cur.empty()) {
      std::reverse(cur.begin(), cur.end());
      words.push_back(cur);
    }
    if (words.empty()) return 0.0;
    // words is newest-first; word to score = words[0], context = rest
    std::vector<std::string> context(words.rbegin(), words.rend() - 1);
    return alpha * lm->score_word_ln(context, words[0]) + beta;
  }
};

}  // namespace
}  // namespace dsjax

extern "C" {

void* ds_lm_load(const char* path) {
  // sniffs the format: DSLMBIN1 binary (mmap'd) or ARPA text
  return dsjax::LoadLm(path).release();
}

void ds_lm_free(void* lm) { delete static_cast<dsjax::Lm*>(lm); }

double ds_lm_score_word(void* lm, const char** context, int n_context,
                        const char* word) {
  std::vector<std::string> ctx(context, context + n_context);
  return static_cast<dsjax::Lm*>(lm)->score_word(ctx, word);
}

int ds_lm_build_binary(const char* arpa_path, const char* out_path) {
  return dsjax::BuildBinaryLm(arpa_path, out_path);
}

int ds_lm_order(void* lm) { return static_cast<dsjax::Lm*>(lm)->order(); }

void* ds_beam_create(const char** labels, int num_labels, int blank_index,
                     int space_index, void* lm) {
  auto* d = new dsjax::Decoder();
  d->labels.assign(labels, labels + num_labels);
  d->blank = blank_index;
  d->space = space_index;
  d->lm = static_cast<dsjax::Lm*>(lm);
  return d;
}

void ds_beam_free(void* decoder) { delete static_cast<dsjax::Decoder*>(decoder); }

// Decode one utterance.
//   probs: T x C row-major posteriors (softmax output)
//   out_ids/out_offsets: [n_paths * max_len] flattened top-k sequences
//   out_lens: [n_paths] per-path lengths; out_scores: [n_paths]
// Returns number of paths written.
int ds_beam_decode(void* decoder, const float* probs, int t_dim, int c_dim,
                   double alpha, double beta, int beam_width,
                   int cutoff_top_n, double cutoff_prob, int n_paths,
                   int max_len, int* out_ids, int* out_offsets, int* out_lens,
                   double* out_scores) {
  using namespace dsjax;
  auto* d = static_cast<Decoder*>(decoder);

  Arena arena;
  TrieNode root;
  std::vector<std::pair<TrieNode*, BeamScore>> beams;
  beams.emplace_back(&root, BeamScore{0.0, kNegInf});

  // Per-step merging uses in-node epoch stamping instead of a hash map,
  // and extensions to NOT-yet-existing prefixes are kept as lightweight
  // "fresh" records — only the <= beam_width winners materialize trie
  // nodes (the naive formulation allocates beams x n_keep nodes per step,
  // which is what made large widths slow).
  struct Fresh {         // extension of `parent` with `label` (no node yet)
    TrieNode* parent;
    int label;
    double p_nb;
    double p_c;          // frame char log-prob (node state if it wins)
    int sib;             // virtual sibling index (preorder tie-breaks)
  };
  std::vector<TrieNode*> touched;
  std::vector<Fresh> fresh;
  struct Ranked {
    TrieNode* node;      // nullptr -> fresh[idx]
    int idx;
    double total;
  };
  std::vector<Ranked> ranked;
  std::vector<int> order(c_dim);
  std::vector<double> log_row(c_dim);
  std::vector<TrieNode*> fresh_nodes;

  // Preorder (trie DFS) comparison — the python twin prunes with a STABLE
  // sort over its preorder node collection, so equal-total candidates are
  // kept in preorder; reproducing that makes tie-breaking deterministic
  // and identical across the two implementations. Candidates are a trie
  // node or a fresh (virtual last-children) record; compare the root-paths
  // of sibling indices lexicographically (ancestor before descendant).
  std::vector<int> path_a, path_b;
  auto fill_path = [](const TrieNode* n, int extra, std::vector<int>& out) {
    out.clear();
    if (extra >= 0) out.push_back(extra);
    for (const TrieNode* p = n; p && p->parent; p = p->parent)
      out.push_back(p->sib);
    std::reverse(out.begin(), out.end());
  };
  auto preorder_less = [&](const Ranked& a, const Ranked& b) {
    const TrieNode* na = a.node ? a.node : fresh[a.idx].parent;
    const TrieNode* nb = b.node ? b.node : fresh[b.idx].parent;
    int ea = a.node ? -1 : fresh[a.idx].sib;
    int eb = b.node ? -1 : fresh[b.idx].sib;
    fill_path(na, ea, path_a);
    fill_path(nb, eb, path_b);
    return std::lexicographical_compare(path_a.begin(), path_a.end(),
                                        path_b.begin(), path_b.end());
  };

  // the word-boundary LM bonus depends only on the prefix node; memoize
  // in-node (recomputing would walk the trie + query the LM for every
  // (timestep x beam) extension of the same prefix)
  auto lm_bonus = [&](TrieNode* prefix) -> double {
    if (!d->lm) return 0.0;
    if (!prefix->lm_cached) {
      prefix->lm_memo = d->lm_score(prefix, alpha, beta);
      prefix->lm_cached = true;
    }
    return prefix->lm_memo;
  };

  for (int t = 0; t < t_dim; ++t) {
    const float* row = probs + (size_t)t * c_dim;
    // candidate pruning (ties by index, python-twin stable-argsort parity).
    // Compare the 1e-30-CLIPPED values, exactly what the python twin
    // argsorts (log(max(lp,1e-30)) — log is monotone so clipping suffices):
    // sub-clip denormals tie and fall back to index order in both.
    for (int c = 0; c < c_dim; ++c) order[c] = c;
    std::sort(order.begin(), order.end(), [&](int a, int b) {
      float ca = row[a] > 1e-30f ? row[a] : 1e-30f;
      float cb = row[b] > 1e-30f ? row[b] : 1e-30f;
      return ca != cb ? ca > cb : a < b;
    });
    int n_keep = c_dim;
    if (cutoff_prob < 1.0) {
      double cum = 0.0;
      n_keep = 0;
      for (int c = 0; c < c_dim; ++c) {
        cum += row[order[c]];
        ++n_keep;
        if (cum >= cutoff_prob) break;
      }
    }
    if (cutoff_top_n < n_keep) n_keep = cutoff_top_n;
    if (n_keep < 1) n_keep = 1;
    for (int ci = 0; ci < n_keep; ++ci)
      log_row[order[ci]] = std::log(std::max((double)row[order[ci]], 1e-30));

    touched.clear();
    fresh.clear();
    auto stamp = [&](TrieNode* n) -> BeamScore& {
      if (n->epoch != t) {
        n->epoch = t;
        n->pending = BeamScore{};
        touched.push_back(n);
      }
      return n->pending;
    };

    for (auto& kv : beams) {
      TrieNode* prefix = kv.first;
      const BeamScore& bs = kv.second;
      double p_total = bs.total();
      int last = prefix->label;  // -1 at root
      for (int ci = 0; ci < n_keep; ++ci) {
        int c = order[ci];
        double p_c = log_row[c];
        if (c == d->blank) {
          BeamScore& nb = stamp(prefix);
          nb.p_b = logaddexp(nb.p_b, p_total + p_c);
          continue;
        }
        double sc;
        if (c == last) {
          // repeat collapses into the same prefix...
          BeamScore& nb = stamp(prefix);
          nb.p_nb = logaddexp(nb.p_nb, bs.p_nb + p_c);
          // ...or extends after a blank (sc may be -inf: ctcdecode still
          // creates/updates the trie node for the attempt)
          sc = bs.p_b + p_c;
        } else {
          sc = p_total + p_c;
        }
        if (c == d->space && sc != kNegInf) sc += lm_bonus(prefix);
        if (TrieNode* ext = prefix->find_child(c)) {
          // ctcdecode get_path_trie: every attempt updates the node's
          // (log_prob_c, timestep) to the loudest frame, and revives a
          // dead node kept alive by its children
          if (ext->log_prob_c < p_c) {
            ext->log_prob_c = p_c;
            ext->timestep = t;
          }
          ext->exists = true;
          BeamScore& nb2 = stamp(ext);
          nb2.p_nb = logaddexp(nb2.p_nb, sc);
        } else {
          // distinct (prefix, c) pairs are distinct prefixes, so fresh
          // records never merge with each other — only existing nodes can
          // receive mass from more than one source. A losing fresh record
          // never materializes, which equals ctcdecode's create-then-
          // remove of a pruned childless leaf.
          if (prefix->fresh_epoch != t) {
            prefix->fresh_epoch = t;
            prefix->fresh_n = 0;
          }
          fresh.push_back(Fresh{prefix, c, sc, p_c,
                                prefix->n_sibs + prefix->fresh_n++});
        }
      }
    }

    // prune to beam width over (touched existing nodes + fresh records +
    // prior beams that received no mass this step, which ctcdecode keeps
    // as -inf candidates via iterate_to_vec)
    ranked.clear();
    for (TrieNode* n : touched)
      ranked.push_back(Ranked{n, -1, n->pending.total()});
    for (int i = 0; i < (int)fresh.size(); ++i)
      ranked.push_back(Ranked{nullptr, i, fresh[i].p_nb});
    for (auto& kv : beams) {
      if (kv.first->epoch != t) {
        kv.first->pending = BeamScore{};
        ranked.push_back(Ranked{kv.first, -1, kNegInf});
      }
    }
    int keep = std::min<int>(beam_width, (int)ranked.size());
    std::partial_sort(ranked.begin(), ranked.begin() + keep, ranked.end(),
                      [&](const Ranked& a, const Ranked& b) {
                        if (a.total != b.total) return a.total > b.total;
                        return preorder_less(a, b);
                      });
    // materialize winning fresh prefixes in ENCOUNTER order so their
    // sibling indices reproduce the python twin's attempt-time insertion
    // order (preorder ties in later steps depend on it)
    fresh_nodes.assign(fresh.size(), nullptr);
    {
      std::vector<int> winner_idx;
      for (int i = 0; i < keep; ++i)
        if (!ranked[i].node) winner_idx.push_back(ranked[i].idx);
      std::sort(winner_idx.begin(), winner_idx.end());
      for (int idx : winner_idx) {
        const Fresh& f = fresh[idx];
        fresh_nodes[idx] = arena.make(f.parent, f.label, t, f.p_c);
      }
    }
    beams.clear();
    for (int i = 0; i < keep; ++i) {
      if (ranked[i].node) {
        beams.emplace_back(ranked[i].node, ranked[i].node->pending);
      } else {
        beams.emplace_back(fresh_nodes[ranked[i].idx],
                           BeamScore{kNegInf, fresh[ranked[i].idx].p_nb});
      }
    }
    // ctcdecode removes every candidate beyond the beam: dead childless
    // chains unlink so their timestep state resets on re-creation
    for (int i = keep; i < (int)ranked.size(); ++i)
      if (ranked[i].node) ranked[i].node->remove();
  }

  // finalize: trailing-word LM score
  std::vector<std::pair<TrieNode*, double>> final_ranked;
  final_ranked.reserve(beams.size());
  for (auto& kv : beams) {
    double score = kv.second.total();
    if (d->lm && kv.first->label >= 0 && kv.first->label != d->space)
      score += d->lm_score(kv.first, alpha, beta);
    final_ranked.emplace_back(kv.first, score);
  }
  // stable over beams order (itself total-desc-then-preorder), matching
  // the python twin's stable final sort exactly on tied scores
  std::stable_sort(final_ranked.begin(), final_ranked.end(),
                   [](const auto& a, const auto& b) { return a.second > b.second; });

  int written = std::min<int>(n_paths, (int)final_ranked.size());
  for (int i = 0; i < written; ++i) {
    TrieNode* node = final_ranked[i].first;
    int depth = node->depth;
    int len = std::min(depth, max_len);
    out_lens[i] = len;
    out_scores[i] = final_ranked[i].second;
    // walk back filling reversed
    int pos = depth - 1;
    const TrieNode* p = node;
    while (p && p->label >= 0) {
      if (pos < len) {
        out_ids[(size_t)i * max_len + pos] = p->label;
        out_offsets[(size_t)i * max_len + pos] = p->timestep;
      }
      --pos;
      p = p->parent;
    }
  }
  return written;
}

}  // extern "C"
