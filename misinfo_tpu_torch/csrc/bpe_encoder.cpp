// Native byte-level BPE encoder for misinfo_tpu_torch's host pipeline.
//
// The port's own copy of the JAX package's native/bpe_encoder.cpp, built
// with the host C++ compiler at first use by ops/cuda_build.py::build_host
// into build/misinfo_tpu_torch/ and bound with ctypes by
// preprocess/native_bpe.py. It implements the GPT-2 / RoBERTa byte-level
// BPE dialect over raw bytes with a thread-pooled batch API behind a C ABI
// (bpe_create, bpe_destroy, bpe_encode_batch, bpe_vocab_size), so that
// tokenizing a b32/S512 batch does not hold the card back.
//
// Contract with the Python wrapper:
//   * vocab is supplied as a TSV of `id<TAB>hex(raw_bytes)` where raw_bytes
//     is the token AFTER inverting GPT-2's byte->printable-unicode mapping
//     (the wrapper does that inversion once at load).
//   * merges as lines `hex(left)<TAB>hex(right)` in rank order.
//   * pre-tokenization implements the GPT-2 regex exactly for ASCII input
//     ('s/'t/'re/'ve/'m/'ll/'d contractions, optional-space letter/digit/
//     other runs, trailing-whitespace splitting). Non-ASCII text never
//     reaches this file: the wrapper routes any text with a non-ASCII
//     character (or a NUL, which would end the C string early) to the
//     pure-Python reference, so the two give the same ids for every input.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003ULL ^ h(p.second);
  }
};

struct Encoder {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      merge_rank;
  int32_t unk_id = 3;
  // small shared LRU-ish cache for merged words
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;
  static constexpr size_t kCacheMax = 1 << 16;
};

std::string from_hex(const std::string& hex) {
  std::string out;
  out.reserve(hex.size() / 2);
  for (size_t i = 0; i + 1 < hex.size(); i += 2) {
    auto nib = [](char c) -> int {
      if (c >= '0' && c <= '9') return c - '0';
      if (c >= 'a' && c <= 'f') return c - 'a' + 10;
      if (c >= 'A' && c <= 'F') return c - 'A' + 10;
      return 0;
    };
    out.push_back(static_cast<char>(nib(hex[i]) * 16 + nib(hex[i + 1])));
  }
  return out;
}

inline bool is_letter(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }
inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// GPT-2 regex pre-tokenization, ASCII subset (see file header).
std::vector<std::string> pretokenize(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0, n = s.size();
  static const char* kContractions[] = {"'s", "'t", "'re", "'ve",
                                        "'m", "'ll", "'d"};
  while (i < n) {
    // contractions (case-sensitive, as in the GPT-2 pattern)
    if (s[i] == '\'') {
      bool matched = false;
      for (const char* c : kContractions) {
        size_t len = std::strlen(c);
        if (i + len <= n && s.compare(i, len, c) == 0) {
          out.emplace_back(s.substr(i, len));
          i += len;
          matched = true;
          break;
        }
      }
      if (matched) continue;
    }
    unsigned char c0 = s[i];
    // ` ?\p{L}+` / ` ?\p{N}+` / ` ?[^\s\p{L}\p{N}]+`
    size_t j = i;
    bool leading_space = false;
    if (c0 == ' ' && j + 1 < n && !is_space(s[j + 1])) {
      leading_space = true;
      ++j;
    }
    if (j < n && is_letter(s[j])) {
      size_t k = j;
      while (k < n && is_letter(s[k])) ++k;
      out.emplace_back(s.substr(i, k - i));
      i = k;
      continue;
    }
    if (j < n && is_digit(s[j])) {
      size_t k = j;
      while (k < n && is_digit(s[k])) ++k;
      out.emplace_back(s.substr(i, k - i));
      i = k;
      continue;
    }
    if (j < n && !is_space(s[j])) {
      size_t k = j;
      while (k < n && !is_space(s[k]) && !is_letter(s[k]) && !is_digit(s[k]))
        ++k;
      // a contraction start inside an "other" run ends the run
      out.emplace_back(s.substr(i, k - i));
      i = k;
      continue;
    }
    // whitespace run. `\s+(?!\S)` matches the run minus its last char when
    // a non-space follows; the leftover char then either prefixes the next
    // token (if it is a literal space, via the ` ?` alternatives) or forms
    // its own `\s+` token (tab/newline/etc).
    size_t k = i;
    while (k < n && is_space(s[k])) ++k;
    if (k < n) {
      if (k - 1 > i) out.emplace_back(s.substr(i, k - 1 - i));
      i = k - 1;
      if (s[i] != ' ') {
        out.emplace_back(s.substr(i, 1));
        i = k;
      }
      continue;
    }
    out.emplace_back(s.substr(i, k - i));
    i = k;
  }
  return out;
}

std::vector<int32_t> bpe_word(Encoder* e, const std::string& token) {
  {
    std::lock_guard<std::mutex> lk(e->cache_mu);
    auto it = e->cache.find(token);
    if (it != e->cache.end()) return it->second;
  }
  std::vector<std::string> word;
  word.reserve(token.size());
  for (char c : token) word.emplace_back(1, c);

  while (word.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = e->merge_rank.find({word[i], word[i + 1]});
      if (it != e->merge_rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    const std::string merged = word[best_i] + word[best_i + 1];
    std::vector<std::string> next;
    next.reserve(word.size() - 1);
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && i == best_i) {
        next.push_back(merged);
        i += 2;
        // subsequent identical pairs merge too (rank-greedy semantics:
        // re-scan handles them on the next loop iteration)
      } else if (i + 1 < word.size() && word[i] == word[best_i] &&
                 word[i + 1] == word[best_i + 1]) {
        next.push_back(merged);
        i += 2;
      } else {
        next.push_back(word[i]);
        ++i;
      }
    }
    word.swap(next);
  }
  std::vector<int32_t> ids;
  ids.reserve(word.size());
  for (const auto& piece : word) {
    auto it = e->vocab.find(piece);
    ids.push_back(it == e->vocab.end() ? e->unk_id : it->second);
  }
  {
    std::lock_guard<std::mutex> lk(e->cache_mu);
    if (e->cache.size() < Encoder::kCacheMax) e->cache[token] = ids;
  }
  return ids;
}

void encode_one(Encoder* e, const char* text, int32_t max_len, int32_t bos,
                int32_t eos, int32_t pad, int32_t* out_ids,
                int32_t* out_mask) {
  std::vector<int32_t> ids;
  ids.push_back(bos);
  const std::string s(text);
  for (const auto& tok : pretokenize(s)) {
    for (int32_t id : bpe_word(e, tok)) {
      if ((int32_t)ids.size() >= max_len - 1) break;
      ids.push_back(id);
    }
    if ((int32_t)ids.size() >= max_len - 1) break;
  }
  ids.push_back(eos);
  for (int32_t i = 0; i < max_len; ++i) {
    if (i < (int32_t)ids.size()) {
      out_ids[i] = ids[i];
      out_mask[i] = 1;
    } else {
      out_ids[i] = pad;
      out_mask[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

void* bpe_create(const char* vocab_tsv, const char* merges_tsv,
                 int32_t unk_id) {
  auto* e = new Encoder();
  e->unk_id = unk_id;
  std::ifstream vf(vocab_tsv);
  if (!vf.good()) {
    delete e;
    return nullptr;
  }
  std::string line;
  while (std::getline(vf, line)) {
    auto tab = line.find('\t');
    if (tab == std::string::npos) continue;
    int32_t id = std::stoi(line.substr(0, tab));
    e->vocab[from_hex(line.substr(tab + 1))] = id;
  }
  std::ifstream mf(merges_tsv);
  if (!mf.good()) {
    delete e;
    return nullptr;
  }
  int32_t rank = 0;
  while (std::getline(mf, line)) {
    auto tab = line.find('\t');
    if (tab == std::string::npos) continue;
    e->merge_rank[{from_hex(line.substr(0, tab)),
                   from_hex(line.substr(tab + 1))}] = rank++;
  }
  return e;
}

void bpe_destroy(void* handle) { delete static_cast<Encoder*>(handle); }

// Encode a batch of texts into [n, max_len] int32 ids + mask, using up to
// `num_threads` workers.
void bpe_encode_batch(void* handle, const char** texts, int32_t n,
                      int32_t max_len, int32_t bos, int32_t eos, int32_t pad,
                      int32_t* out_ids, int32_t* out_mask,
                      int32_t num_threads) {
  auto* e = static_cast<Encoder*>(handle);
  if (num_threads <= 1 || n <= 1) {
    for (int32_t i = 0; i < n; ++i)
      encode_one(e, texts[i], max_len, bos, eos, pad, out_ids + i * max_len,
                 out_mask + i * max_len);
    return;
  }
  int32_t workers = std::min<int32_t>(num_threads, n);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  std::mutex mu;
  int32_t next = 0;
  for (int32_t w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      while (true) {
        int32_t i;
        {
          std::lock_guard<std::mutex> lk(mu);
          if (next >= n) return;
          i = next++;
        }
        encode_one(e, texts[i], max_len, bos, eos, pad, out_ids + i * max_len,
                   out_mask + i * max_len);
      }
    });
  }
  for (auto& t : pool) t.join();
}

int32_t bpe_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Encoder*>(handle)->vocab.size());
}

}  // extern "C"
