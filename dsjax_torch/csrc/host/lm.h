// Copy of dsjax/cpp/src/lm.h, built into the port's own host library
// so that dsjax_torch imports nothing of dsjax.
//
// Word-level n-gram language models with Katz backoff.
// Native twin of dsjax/decode/lm.py (capability equivalent of the KenLM
// scorer the reference uses through ctcdecode, reference: decoder.py:69-74).
//
// Two implementations behind one interface:
//   * ArpaLM   — text ARPA parser, string-keyed hash maps (simple, always
//                available, slow/heavy for large LMs);
//   * BinaryLM — mmap'd "DSLMBIN1"/"DSLMBIN2" file (built once from ARPA
//                with BuildBinaryLm): sorted 64-bit-key arrays per order,
//                id-indexed unigram tables. Loads in O(1) (page faults on
//                demand, like KenLM's binary mmap format) and queries by
//                binary search — the production path for large LMs.
//                v2 (what BuildBinaryLm now writes) appends the vocab word
//                strings and per-order n-gram word-id arrays after the v1
//                sections, so dsjax.decode.lm_device can pack the ON-DEVICE
//                HBM tables straight from the binary (v1's one-way hashes
//                cannot support that); host queries ignore the extras.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace dsjax {

class Lm {
 public:
  virtual ~Lm() = default;
  virtual bool ok() const = 0;
  virtual int order() const = 0;
  // log10 P(word | context), context oldest-first, Katz backoff; OOV maps
  // to <unk> when present else a -100 penalty.
  virtual double score_word(const std::vector<std::string>& context,
                            const std::string& word) const = 0;
  // natural-log convenience (decoder fuses in ln space)
  double score_word_ln(const std::vector<std::string>& context,
                       const std::string& word) const;
};

class ArpaLM : public Lm {
 public:
  explicit ArpaLM(const std::string& path);

  bool ok() const override { return order_ > 0; }
  int order() const override { return order_; }
  double score_word(const std::vector<std::string>& context,
                    const std::string& word) const override;

 private:
  friend int BuildBinaryLm(const std::string&, const std::string&);
  struct Entry {
    float logp;
    float backoff;
  };
  // ngrams_[n-1]: map from space-joined n-gram to (logp, backoff)
  std::vector<std::unordered_map<std::string, Entry>> ngrams_;
  int order_ = 0;
  bool has_unk_ = false;

  double score_rec(const std::vector<std::string>& words, size_t start) const;
};

class BinaryLM : public Lm {
 public:
  explicit BinaryLM(const std::string& path);
  ~BinaryLM() override;

  bool ok() const override { return order_ > 0; }
  int order() const override { return order_; }
  double score_word(const std::vector<std::string>& context,
                    const std::string& word) const override;

 private:
  uint32_t word_id(const std::string& w) const;  // kOov when absent
  double score_ids(const uint32_t* ids, size_t n) const;

  void* map_ = nullptr;
  size_t map_len_ = 0;
  int fd_ = -1;
  int order_ = 0;
  uint32_t vocab_ = 0;
  uint32_t unk_id_ = 0;
  bool has_unk_ = false;
  const uint64_t* vocab_hashes_ = nullptr;  // sorted; id = index
  const float* uni_logp_ = nullptr;         // [vocab]
  const float* uni_backoff_ = nullptr;      // [vocab]
  // per order n>=2: sorted key array + params
  std::vector<uint64_t> counts_;
  std::vector<const uint64_t*> keys_;
  std::vector<const float*> logp_;
  std::vector<const float*> backoff_;
};

// Sniffs the file: "DSLMBIN1" -> BinaryLM, else ARPA text. nullptr when the
// model fails to load.
std::unique_ptr<Lm> LoadLm(const std::string& path);

// ARPA text -> DSLMBIN1 file. Returns 0 on success.
int BuildBinaryLm(const std::string& arpa_path, const std::string& out_path);

}  // namespace dsjax
