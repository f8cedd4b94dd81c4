// Copy of dsjax/cpp/src/lm.cpp, built into the port's own host library
// so that dsjax_torch imports nothing of dsjax.
//
#include "lm.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>

namespace dsjax {

namespace {
constexpr double kLog10ToLn = 2.302585092994046;
constexpr uint32_t kOov = 0xFFFFFFFFu;
constexpr char kMagic[8] = {'D', 'S', 'L', 'M', 'B', 'I', 'N', '1'};
// v2 appends (after the v1 sections): a '\n'-joined vocab-words blob and
// per-order n-gram word-id arrays — enough information to rebuild the
// ON-DEVICE LM tables (dsjax.decode.lm_device) from the binary, which v1's
// one-way hashes cannot provide. Host queries ignore the trailing
// sections, so v2 files load exactly like v1.
constexpr char kMagic2[8] = {'D', 'S', 'L', 'M', 'B', 'I', 'N', '2'};

std::string join(const std::vector<std::string>& words, size_t start,
                 size_t end) {
  std::string out;
  for (size_t i = start; i < end; ++i) {
    if (i > start) out.push_back(' ');
    out += words[i];
  }
  return out;
}

uint64_t fnv1a64(const std::string& s) {
  uint64_t h = 1469598103934665603ULL;
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

uint64_t ngram_key(const uint32_t* ids, size_t n) {
  uint64_t h = 0x51ed270b0a3f32d1ULL;
  for (size_t i = 0; i < n; ++i) h = mix64(h ^ (uint64_t)ids[i]);
  return h;
}

size_t align8(size_t x) { return (x + 7) & ~(size_t)7; }
}  // namespace

double Lm::score_word_ln(const std::vector<std::string>& context,
                         const std::string& word) const {
  return score_word(context, word) * kLog10ToLn;
}

// ---------------------------------------------------------------------------
// ArpaLM (text)
// ---------------------------------------------------------------------------

ArpaLM::ArpaLM(const std::string& path) {
  std::ifstream f(path);
  if (!f.is_open()) return;
  std::string line;
  int cur = 0;
  enum { NONE, DATA, NGRAMS } section = NONE;
  while (std::getline(f, line)) {
    // strip trailing CR / whitespace
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n' ||
                             line.back() == ' '))
      line.pop_back();
    if (line.empty()) continue;
    if (line == "\\data\\") {
      section = DATA;
      continue;
    }
    if (line.size() > 8 && line[0] == '\\' &&
        line.compare(line.size() - 7, 7, "-grams:") == 0) {
      cur = std::atoi(line.c_str() + 1);
      while ((int)ngrams_.size() < cur) ngrams_.emplace_back();
      section = NGRAMS;
      continue;
    }
    if (line == "\\end\\") break;
    if (section != NGRAMS || cur == 0) continue;

    // fields: logp \t w1 [w2 ...] [\t backoff]  (tabs or spaces)
    std::istringstream ss(line);
    double logp;
    if (!(ss >> logp)) continue;
    std::vector<std::string> words(cur);
    bool bad = false;
    for (int i = 0; i < cur; ++i) {
      if (!(ss >> words[i])) {
        bad = true;
        break;
      }
    }
    if (bad) continue;
    double backoff = 0.0;
    ss >> backoff;  // optional
    Entry e{(float)logp, (float)backoff};
    ngrams_[cur - 1].emplace(join(words, 0, words.size()), e);
  }
  order_ = (int)ngrams_.size();
  has_unk_ = order_ >= 1 && ngrams_[0].count("<unk>") > 0;
}

double ArpaLM::score_rec(const std::vector<std::string>& words,
                         size_t start) const {
  size_t n = words.size() - start;
  if (n == 0) return -99.0;
  if ((int)n <= order_) {
    auto& table = ngrams_[n - 1];
    auto it = table.find(join(words, start, words.size()));
    if (it != table.end()) return it->second.logp;
  }
  if (n == 1) {
    if (has_unk_) return ngrams_[0].at("<unk>").logp;
    return -100.0;
  }
  // backoff weight of the context (words[start..end-1))
  double bo = 0.0;
  size_t ctx_n = n - 1;
  if ((int)ctx_n <= order_) {
    auto& table = ngrams_[ctx_n - 1];
    auto it = table.find(join(words, start, words.size() - 1));
    if (it != table.end()) bo = it->second.backoff;
  }
  return bo + score_rec(words, start + 1);
}

double ArpaLM::score_word(const std::vector<std::string>& context,
                          const std::string& word) const {
  std::vector<std::string> ngram;
  size_t ctx_keep =
      order_ > 1 ? std::min(context.size(), (size_t)(order_ - 1)) : 0;
  for (size_t i = context.size() - ctx_keep; i < context.size(); ++i)
    ngram.push_back(context[i]);
  ngram.push_back(word);
  return score_rec(ngram, 0);
}

// ---------------------------------------------------------------------------
// BinaryLM (mmap'd DSLMBIN1 or DSLMBIN2 — v2 appends the device-build
// sections, which are validated here but only consumed by the Python
// device-LM loader, dsjax/decode/lm.py:read_binary_lm_v2)
// ---------------------------------------------------------------------------

BinaryLM::BinaryLM(const std::string& path) {
  fd_ = open(path.c_str(), O_RDONLY);
  if (fd_ < 0) return;
  struct stat st;
  if (fstat(fd_, &st) != 0 || st.st_size < 32) return;
  map_len_ = (size_t)st.st_size;
  map_ = mmap(nullptr, map_len_, PROT_READ, MAP_SHARED, fd_, 0);
  if (map_ == MAP_FAILED) {
    map_ = nullptr;
    return;
  }
  // untrusted input: validate every size BEFORE dereferencing, with
  // overflow-safe bounds arithmetic (a corrupt header must fail cleanly,
  // not memcpy gigabytes past the map or wrap `off` back into range)
  const uint8_t* p = (const uint8_t*)map_;
  bool v2 = memcmp(p, kMagic2, 8) == 0;
  if (!v2 && memcmp(p, kMagic, 8) != 0) return;
  uint32_t order, vocab, unk, reserved;
  memcpy(&order, p + 8, 4);
  memcpy(&vocab, p + 12, 4);
  memcpy(&unk, p + 16, 4);
  memcpy(&reserved, p + 20, 4);
  if (order < 1 || order > 64) return;
  size_t off = 24;
  // remaining-bytes check that cannot overflow: elem counts are compared
  // against (map_len_ - off) / elem_size
  auto fits = [&](size_t count, size_t elem) {
    return off <= map_len_ && count <= (map_len_ - off) / elem;
  };
  if (!fits(order, 8)) return;
  counts_.resize(order);
  memcpy(counts_.data(), p + off, 8 * order);
  off = align8(off + 8 * order);
  vocab_ = vocab;
  unk_id_ = unk;
  has_unk_ = unk != kOov;
  if (has_unk_ && unk >= vocab) return;
  if (!fits(vocab, 8)) return;
  vocab_hashes_ = (const uint64_t*)(p + off);
  off += 8 * (size_t)vocab;
  if (!fits(vocab, 4)) return;
  uni_logp_ = (const float*)(p + off);
  off += 4 * (size_t)vocab;
  if (!fits(vocab, 4)) return;
  uni_backoff_ = (const float*)(p + off);
  off = align8(off + 4 * (size_t)vocab);
  keys_.assign(order, nullptr);
  logp_.assign(order, nullptr);
  backoff_.assign(order, nullptr);
  for (uint32_t n = 2; n <= order; ++n) {
    uint64_t cnt = counts_[n - 1];
    if (!fits(cnt, 8)) return;
    keys_[n - 1] = (const uint64_t*)(p + off);
    off += 8 * cnt;
    if (!fits(cnt, 4)) return;
    logp_[n - 1] = (const float*)(p + off);
    off += 4 * cnt;
    if (!fits(cnt, 4)) return;
    backoff_[n - 1] = (const float*)(p + off);
    off = align8(off + 4 * cnt);
  }
  if (v2) {
    // validate (but don't use) the device-build sections: words blob
    // length + per-order id arrays must fit — a corrupt/truncated v2
    // file must fail cleanly like any other malformed input
    if (!fits(1, 8)) return;
    uint64_t words_bytes;
    memcpy(&words_bytes, p + off, 8);
    off += 8;
    if (!fits(words_bytes, 1)) return;
    off = align8(off + (size_t)words_bytes);
    for (uint32_t n = 2; n <= order; ++n) {
      if (!fits(counts_[n - 1], 4 * (size_t)n)) return;
      off = align8(off + 4 * (size_t)n * (size_t)counts_[n - 1]);
    }
  }
  if (off > map_len_) return;  // truncated file
  order_ = (int)order;
}

BinaryLM::~BinaryLM() {
  if (map_) munmap(map_, map_len_);
  if (fd_ >= 0) close(fd_);
}

uint32_t BinaryLM::word_id(const std::string& w) const {
  uint64_t h = fnv1a64(w);
  const uint64_t* lo = vocab_hashes_;
  const uint64_t* hi = vocab_hashes_ + vocab_;
  const uint64_t* it = std::lower_bound(lo, hi, h);
  if (it != hi && *it == h) return (uint32_t)(it - lo);
  return kOov;
}

double BinaryLM::score_ids(const uint32_t* ids, size_t n) const {
  if (n == 0) return -99.0;
  if (n == 1) {
    if (ids[0] != kOov) return uni_logp_[ids[0]];
    if (has_unk_) return uni_logp_[unk_id_];
    return -100.0;
  }
  if ((int)n <= order_) {
    uint64_t key = ngram_key(ids, n);
    const uint64_t* lo = keys_[n - 1];
    const uint64_t* hi = lo + counts_[n - 1];
    const uint64_t* it = std::lower_bound(lo, hi, key);
    if (it != hi && *it == key) return logp_[n - 1][it - lo];
  }
  double bo = 0.0;
  size_t ctx_n = n - 1;
  if (ctx_n == 1) {
    if (ids[0] != kOov) bo = uni_backoff_[ids[0]];
  } else if ((int)ctx_n <= order_) {
    uint64_t key = ngram_key(ids, ctx_n);
    const uint64_t* lo = keys_[ctx_n - 1];
    const uint64_t* hi = lo + counts_[ctx_n - 1];
    const uint64_t* it = std::lower_bound(lo, hi, key);
    if (it != hi && *it == key) bo = backoff_[ctx_n - 1][it - lo];
  }
  return bo + score_ids(ids + 1, n - 1);
}

double BinaryLM::score_word(const std::vector<std::string>& context,
                            const std::string& word) const {
  // order is validated <= 64 at load; size the ids buffer to match so a
  // high-order LM scores identically to the ArpaLM twin (a 16-entry
  // buffer silently dropped context beyond 15 words)
  uint32_t ids[64];
  size_t ctx_keep =
      order_ > 1
          ? std::min(context.size(), (size_t)std::min(order_ - 1, 63))
          : 0;
  size_t n = 0;
  for (size_t i = context.size() - ctx_keep; i < context.size(); ++i)
    ids[n++] = word_id(context[i]);
  ids[n++] = word_id(word);
  return score_ids(ids, n);
}

// ---------------------------------------------------------------------------
// loader + builder
// ---------------------------------------------------------------------------

std::unique_ptr<Lm> LoadLm(const std::string& path) {
  {
    std::ifstream f(path, std::ios::binary);
    if (!f.is_open()) return nullptr;
    char head[8] = {0};
    f.read(head, 8);
    if (f.gcount() == 8 && (memcmp(head, kMagic, 8) == 0 ||
                            memcmp(head, kMagic2, 8) == 0)) {
      auto lm = std::make_unique<BinaryLM>(path);
      return lm->ok() ? std::unique_ptr<Lm>(std::move(lm)) : nullptr;
    }
  }
  auto lm = std::make_unique<ArpaLM>(path);
  return lm->ok() ? std::unique_ptr<Lm>(std::move(lm)) : nullptr;
}

int BuildBinaryLm(const std::string& arpa_path, const std::string& out_path) {
  ArpaLM src(arpa_path);
  if (!src.ok()) return 1;
  const uint32_t order = (uint32_t)src.order_;

  // vocabulary: unigram words sorted by hash; id = sorted index
  std::vector<std::pair<uint64_t, const std::string*>> vh;
  vh.reserve(src.ngrams_[0].size());
  for (auto& kv : src.ngrams_[0]) vh.emplace_back(fnv1a64(kv.first), &kv.first);
  std::sort(vh.begin(), vh.end());
  for (size_t i = 1; i < vh.size(); ++i)
    if (vh[i].first == vh[i - 1].first) return 2;  // vocab hash collision
  std::unordered_map<std::string, uint32_t> word_ids;
  word_ids.reserve(vh.size());
  for (size_t i = 0; i < vh.size(); ++i) word_ids[*vh[i].second] = (uint32_t)i;
  const uint32_t vocab = (uint32_t)vh.size();
  uint32_t unk = kOov;
  auto unk_it = word_ids.find("<unk>");
  if (unk_it != word_ids.end()) unk = unk_it->second;

  FILE* out = fopen(out_path.c_str(), "wb");
  if (!out) return 3;
  // track I/O failures (disk full etc.): a silently truncated binary
  // would pass here and only surface as a corrupt LM at decode time
  bool io_error = false;
  auto w = [&](const void* ptr, size_t len) {
    if (fwrite(ptr, 1, len, out) != len) io_error = true;
  };
  auto pad8 = [&]() {
    long pos = ftell(out);
    static const char z[8] = {0};
    if (pos & 7) w(z, 8 - (pos & 7));
  };
  w(kMagic2, 8);
  w(&order, 4);
  w(&vocab, 4);
  w(&unk, 4);
  uint32_t reserved = 0;
  w(&reserved, 4);
  std::vector<uint64_t> counts(order);
  for (uint32_t n = 1; n <= order; ++n) counts[n - 1] = src.ngrams_[n - 1].size();
  counts[0] = vocab;
  w(counts.data(), 8 * order);
  pad8();

  // unigram tables, id-indexed
  {
    std::vector<uint64_t> hashes(vocab);
    std::vector<float> lp(vocab, -100.0f), bo(vocab, 0.0f);
    for (uint32_t i = 0; i < vocab; ++i) {
      hashes[i] = vh[i].first;
      auto& e = src.ngrams_[0].at(*vh[i].second);
      lp[i] = e.logp;
      bo[i] = e.backoff;
    }
    w(hashes.data(), 8 * (size_t)vocab);
    w(lp.data(), 4 * (size_t)vocab);
    w(bo.data(), 4 * (size_t)vocab);
    pad8();
  }

  // per-order sorted word-id sequences, buffered for the v2 trailing
  // sections (they follow ALL v1 sections so v1-shaped readers can stop
  // early)
  std::vector<std::vector<uint32_t>> all_ids(order);
  for (uint32_t n = 2; n <= order; ++n) {
    struct Rec {
      uint64_t key;
      float logp, backoff;
      uint32_t first_id;  // index into flat id storage / n
    };
    std::vector<Rec> recs;
    std::vector<uint32_t> flat;
    recs.reserve(src.ngrams_[n - 1].size());
    flat.reserve(src.ngrams_[n - 1].size() * n);
    std::vector<uint32_t> ids(n);
    for (auto& kv : src.ngrams_[n - 1]) {
      // split the space-joined n-gram back into words -> ids
      const std::string& s = kv.first;
      size_t start = 0, k = 0;
      bool ok = true;
      while (k < n) {
        size_t sp = s.find(' ', start);
        std::string wrd = sp == std::string::npos ? s.substr(start)
                                                  : s.substr(start, sp - start);
        auto it = word_ids.find(wrd);
        if (it == word_ids.end()) {
          ok = false;  // word missing from unigrams (malformed ARPA): skip
          break;
        }
        ids[k++] = it->second;
        if (sp == std::string::npos) break;
        start = sp + 1;
      }
      if (!ok || k != n) continue;
      recs.push_back({ngram_key(ids.data(), n), kv.second.logp,
                      kv.second.backoff, (uint32_t)(flat.size() / n)});
      flat.insert(flat.end(), ids.begin(), ids.end());
    }
    std::sort(recs.begin(), recs.end(),
              [](const Rec& a, const Rec& b) { return a.key < b.key; });
    for (size_t i = 1; i < recs.size(); ++i)
      if (recs[i].key == recs[i - 1].key) {
        fclose(out);
        remove(out_path.c_str());
        return 4;  // ngram key collision: caller keeps the text model
      }
    // count may shrink if malformed entries were skipped: rewrite header later
    counts[n - 1] = recs.size();
    std::vector<uint64_t> keys(recs.size());
    std::vector<float> lp(recs.size()), bo(recs.size());
    std::vector<uint32_t>& sorted_ids = all_ids[n - 1];
    sorted_ids.resize(recs.size() * n);
    for (size_t i = 0; i < recs.size(); ++i) {
      keys[i] = recs[i].key;
      lp[i] = recs[i].logp;
      bo[i] = recs[i].backoff;
      memcpy(&sorted_ids[i * n], &flat[(size_t)recs[i].first_id * n], 4 * n);
    }
    w(keys.data(), 8 * keys.size());
    w(lp.data(), 4 * lp.size());
    w(bo.data(), 4 * bo.size());
    pad8();
  }
  // ---- v2 trailing sections: vocab words + per-order id sequences ----
  {
    std::string blob;
    for (uint32_t i = 0; i < vocab; ++i) {
      if (i) blob.push_back('\n');
      blob += *vh[i].second;
    }
    uint64_t nb = blob.size();
    w(&nb, 8);
    w(blob.data(), blob.size());
    pad8();
  }
  for (uint32_t n = 2; n <= order; ++n) {
    w(all_ids[n - 1].data(), 4 * all_ids[n - 1].size());
    pad8();
  }
  // rewrite counts with any skip-adjusted values
  fseek(out, 24, SEEK_SET);
  w(counts.data(), 8 * order);
  if (fclose(out) != 0) io_error = true;
  if (io_error) {
    remove(out_path.c_str());
    return 5;  // short write (e.g. disk full): never leave a corrupt file
  }
  return 0;
}

}  // namespace dsjax
