// CTC prefix beam search with n-gram LM fusion — native host decoder.
//
// Replaces the reference's ctcdecode (C++) + KenLM (C++) dependency
// (decoders.py:19-55): same parameters (beam_width, alpha, beta,
// cutoff_top_n, cutoff_prob, blank id, labels) and the same fusion rule
// (word-level LM applied when a space closes a word:
// score += alpha * lm_logp(word | context) + beta).
//
// The LM is a self-contained ARPA-format n-gram reader (KenLM's input
// format) with standard Katz backoff scoring. Build: g++ -O3 -shared -fPIC.
//
// Algorithm: Hannun et al. 2014 prefix beam search in log space.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog10 = 2.302585092994046f;  // ARPA log10 -> natural log

inline float logsumexp(float a, float b) {
  if (a <= kNegInf / 2) return b;
  if (b <= kNegInf / 2) return a;
  float m = std::max(a, b);
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// ---------------- ARPA n-gram LM ----------------

// bit-identical to text/binlm.py ngram_hash: FNV-1a over (id + golden) with
// a murmur fmix64 avalanche
inline uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

inline uint64_t ngram_fingerprint(const std::vector<int>& ids, size_t begin,
                                  size_t end) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (size_t i = begin; i < end; ++i)
    h = (h ^ (static_cast<uint64_t>(static_cast<uint32_t>(ids[i])) +
              0x9e3779b97f4a7c15ULL)) *
        0x100000001b3ULL;
  return fmix64(h);
}

struct NgramLM {
  // TEXT storage — key: joined word-ids; value: (logp, backoff), natural log
  std::unordered_map<std::string, std::pair<float, float>> ngrams;
  std::unordered_map<std::string, int> vocab;
  int order = 0;
  int unk_id = -1;

  // BINARY (CNLM) storage: the n-gram bulk stays in the mmap — load cost is
  // O(vocab), independent of n-gram count (format: text/binlm.py)
  bool binary = false;
  void* map_base = nullptr;
  size_t map_len = 0;
  struct OrderView {
    const uint64_t* hash;
    const float* logp;
    const float* backoff;
    uint64_t count;
  };
  std::vector<OrderView> views;
  float unk_logp = 0.0f;
  bool has_unk_entry = false;

  ~NgramLM() {
    if (map_base != nullptr) munmap(map_base, map_len);
  }

  int word_id(const std::string& w) const {
    auto it = vocab.find(w);
    if (it != vocab.end()) return it->second;
    // binary mode: OOV -> id 0xFFFFFFFF (binlm.py OOV_ID; any n-gram
    // containing it misses, matching the python ArpaLM's string-key miss)
    return binary ? -1 : unk_id;
  }

  static std::string key(const std::vector<int>& ids, size_t begin, size_t end) {
    std::string k;
    for (size_t i = begin; i < end; ++i) {
      if (!k.empty()) k.push_back(' ');
      k += std::to_string(ids[i]);
    }
    return k;
  }

  bool lookup_binary(const std::vector<int>& ids, size_t begin, size_t end,
                     float* out_logp, float* out_backoff) const {
    size_t n = end - begin;
    if (n == 0 || n > views.size()) return false;
    const OrderView& v = views[n - 1];
    uint64_t h = ngram_fingerprint(ids, begin, end);
    const uint64_t* p = std::lower_bound(v.hash, v.hash + v.count, h);
    if (p == v.hash + v.count || *p != h) return false;
    size_t i = static_cast<size_t>(p - v.hash);
    *out_logp = v.logp[i];
    *out_backoff = v.backoff[i];
    return true;
  }

  bool load_binary(const std::string& path) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 24) {
      ::close(fd);
      return false;
    }
    map_len = static_cast<size_t>(st.st_size);
    map_base = mmap(nullptr, map_len, PROT_READ, MAP_SHARED, fd, 0);
    ::close(fd);
    if (map_base == MAP_FAILED) {
      map_base = nullptr;
      return false;
    }
    const uint8_t* p = static_cast<const uint8_t*>(map_base);
    uint32_t ord = 0, vocab_size = 0;
    uint64_t blob_bytes = 0;
    std::memcpy(&ord, p + 8, 4);
    std::memcpy(&vocab_size, p + 12, 4);
    std::memcpy(&blob_bytes, p + 16, 8);
    std::vector<uint64_t> counts(ord);
    std::memcpy(counts.data(), p + 24, 8 * ord);
    size_t off = 24 + 8 * static_cast<size_t>(ord);
    const char* blob = reinterpret_cast<const char*>(p + off);
    vocab.reserve(vocab_size);
    size_t pos = 0;
    for (uint32_t i = 0; i < vocab_size; ++i) {
      std::string w(blob + pos);
      pos += w.size() + 1;
      vocab.emplace(std::move(w), static_cast<int>(i));
    }
    off += blob_bytes;
    off += (8 - off % 8) % 8;
    views.resize(ord);
    for (uint32_t n = 0; n < ord; ++n) {
      uint64_t c = counts[n];
      views[n].hash = reinterpret_cast<const uint64_t*>(p + off);
      off += 8 * c;
      views[n].logp = reinterpret_cast<const float*>(p + off);
      off += 4 * c;
      views[n].backoff = reinterpret_cast<const float*>(p + off);
      off += 4 * c;
      off += (8 - off % 8) % 8;
      views[n].count = c;
    }
    order = static_cast<int>(ord);
    binary = true;
    auto it = vocab.find("<unk>");
    unk_id = it == vocab.end() ? -1 : it->second;
    if (unk_id >= 0) {
      std::vector<int> u{unk_id};
      float b;
      has_unk_entry = lookup_binary(u, 0, 1, &unk_logp, &b);
    }
    return order > 0;
  }

  bool load(const std::string& path) {
    {
      std::ifstream probe(path, std::ios::binary);
      char magic[8] = {0};
      if (probe.read(magic, 8) && std::memcmp(magic, "CNLMBIN1", 8) == 0)
        return load_binary(path);
    }
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    int current_order = 0;
    bool in_data = false;
    while (std::getline(f, line)) {
      if (line.empty()) continue;
      if (line.rfind("\\data\\", 0) == 0) { in_data = true; continue; }
      if (line.rfind("\\end\\", 0) == 0) break;
      if (line[0] == '\\') {  // "\N-grams:"
        current_order = std::atoi(line.c_str() + 1);
        order = std::max(order, current_order);
        continue;
      }
      if (current_order == 0) continue;
      std::istringstream ss(line);
      float logp, backoff = 0.0f;
      if (!(ss >> logp)) continue;
      std::vector<std::string> words(current_order);
      for (int i = 0; i < current_order; ++i)
        if (!(ss >> words[i])) goto next_line;
      ss >> backoff;  // optional
      {
        std::vector<int> ids(current_order);
        for (int i = 0; i < current_order; ++i) {
          auto it = vocab.find(words[i]);
          if (it == vocab.end()) {
            int id = static_cast<int>(vocab.size());
            vocab.emplace(words[i], id);
            ids[i] = id;
          } else {
            ids[i] = it->second;
          }
        }
        ngrams[key(ids, 0, ids.size())] = {logp * kLog10, backoff * kLog10};
      }
      next_line:;
    }
    auto it = vocab.find("<unk>");
    unk_id = it == vocab.end() ? -1 : it->second;
    return order > 0;
  }

  // score of word ids.back() given the preceding context (Katz backoff)
  float score(const std::vector<int>& ids) const {
    size_t begin = ids.size() > static_cast<size_t>(order)
                       ? ids.size() - order : 0;
    return score_from(ids, begin);
  }

  float score_from(const std::vector<int>& ids, size_t begin) const {
    if (begin >= ids.size()) return kNegInf;
    if (binary) return score_from_binary(ids, begin);
    auto it = ngrams.find(key(ids, begin, ids.size()));
    if (it != ngrams.end()) return it->second.first;
    if (begin + 1 == ids.size()) {
      // unseen unigram -> <unk> if present
      if (unk_id >= 0) {
        auto u = ngrams.find(std::to_string(unk_id));
        if (u != ngrams.end()) return u->second.first;
      }
      return -10.0f * kLog10;
    }
    float backoff = 0.0f;
    auto ctx = ngrams.find(key(ids, begin, ids.size() - 1));
    if (ctx != ngrams.end()) backoff = ctx->second.second;
    return backoff + score_from(ids, begin + 1);
  }

  // same Katz chain over the mmap'd arrays (binlm.py BinaryLM.score)
  float score_from_binary(const std::vector<int>& ids, size_t begin) const {
    float logp, bo;
    if (lookup_binary(ids, begin, ids.size(), &logp, &bo)) return logp;
    if (begin + 1 == ids.size())
      return has_unk_entry ? unk_logp : -10.0f * kLog10;
    float backoff = 0.0f;
    if (lookup_binary(ids, begin, ids.size() - 1, &logp, &bo)) backoff = bo;
    return backoff + score_from_binary(ids, begin + 1);
  }
};

// ---------------- prefix beam search ----------------
//
// Prefix identity lives in a TRIE ARENA (parent-pointer nodes), not in
// per-beam vectors: extending a beam is O(1) amortized (child-list walk over
// the few candidates) instead of the naive O(prefix_len) string-key/copy —
// the naive form is O(T^2 * beam * cand) over an utterance and measured
// ~370 ms for 6 s of audio at beam 16 on this host; the trie form is
// O(T * beam * cand). Same idea as ctcdecode's PathTrie.

struct TrieNode {
  int parent;             // node id, -1-rooted chain gives the prefix
  int ch;                 // label id (-1 at root)
  int first_child = -1;   // intrusive child list (at most ~cand children)
  int next_sibling = -1;
  int words = -1;         // LM word-context id (WordCtx arena), lazy
  float lm_score = 0.0f;  // accumulated alpha*lm + beta (prefix-determined)
  int stamp = -1;         // frame stamp: already has a next-beam this frame
  int slot = -1;          // its index in `next` when stamp matches
};

struct WordCtx {          // completed-word history as a parent-pointer chain
  int parent;
  int word_id;
};

struct Beam {
  int node;               // prefix identity (trie arena id)
  float p_b = kNegInf;    // log prob ending in blank
  float p_nb = kNegInf;   // log prob ending in non-blank
  float lm_score = 0.0f;  // copy of node lm_score (ordering hot path)

  float total() const { return logsumexp(p_b, p_nb) + lm_score; }
};

struct Decoder {
  std::vector<std::string> labels;
  int blank_id;
  int space_id = -1;
  NgramLM lm;
  bool has_lm = false;
  float alpha, beta;
  int beam_width, cutoff_top_n;
  float cutoff_prob;

  // NOTE: the LM context (completed words + accumulated alpha*lm + beta
  // bonuses) is a DETERMINISTIC function of the prefix, so it is computed
  // exactly once when a prefix node is created, regardless of which parent
  // created it or in which frame.
  std::vector<std::pair<std::vector<int>, float>> decode(
      const float* log_probs, int T, int C, int topk) {
    std::vector<TrieNode> trie(1);
    trie[0].parent = -1;
    trie[0].ch = -1;
    std::vector<WordCtx> wctx;  // node.words == -1 means empty history

    auto find_or_create_child = [&](int node, int c) -> int {
      for (int k = trie[node].first_child; k >= 0; k = trie[k].next_sibling)
        if (trie[k].ch == c) return k;
      int id = static_cast<int>(trie.size());
      trie.push_back(TrieNode());
      TrieNode& n = trie.back();
      n.parent = node;
      n.ch = c;
      n.next_sibling = trie[node].first_child;
      trie[node].first_child = id;
      // LM fusion at word boundaries (decoders.py:19-55 alpha/beta rule):
      // a space closes the word spelled since the previous space
      n.words = trie[node].words;
      n.lm_score = trie[node].lm_score;
      if (c == space_id && has_lm) {
        std::string word;
        for (int k = node; k >= 0 && trie[k].ch >= 0 &&
                           trie[k].ch != space_id; k = trie[k].parent)
          word = labels[trie[k].ch] + word;
        if (!word.empty()) {
          int wid = static_cast<int>(wctx.size());
          wctx.push_back(WordCtx{trie[node].words, lm.word_id(word)});
          n.words = wid;
          // score the word given the last (order-1) context words
          std::vector<int> ids;
          for (int w = wid; w >= 0 && static_cast<int>(ids.size()) < lm.order;
               w = wctx[w].parent)
            ids.push_back(wctx[w].word_id);
          std::reverse(ids.begin(), ids.end());
          n.lm_score += alpha * lm.score(ids) + beta;
        }
      }
      return id;
    };

    std::vector<Beam> beams(1);
    beams[0].node = 0;
    beams[0].p_b = 0.0f;
    std::vector<Beam> next;

    std::vector<int> cand(C);
    for (int t = 0; t < T; ++t) {
      const float* lp = log_probs + static_cast<int64_t>(t) * C;
      // candidate pruning: top cutoff_top_n classes w/ cumulative cutoff_prob
      for (int c = 0; c < C; ++c) cand[c] = c;
      int ncand = std::min(cutoff_top_n, C);
      std::partial_sort(cand.begin(), cand.begin() + ncand, cand.end(),
                        [&](int a, int b) { return lp[a] > lp[b]; });
      if (cutoff_prob < 1.0f) {
        float cum = 0.0f;
        int keep = 0;
        for (; keep < ncand; ++keep) {
          cum += std::exp(lp[cand[keep]]);
          if (cum >= cutoff_prob) { ++keep; break; }
        }
        ncand = std::max(1, keep);
      }

      next.clear();
      next.reserve(beams.size() * (ncand + 1));

      // frame-local dedup by trie node: the stamp marks nodes that already
      // have a next-beam this frame (slot = its index in `next`)
      auto slot_for = [&](int node) -> int {
        TrieNode& n = trie[node];
        if (n.stamp == t) return n.slot;
        n.stamp = t;
        n.slot = static_cast<int>(next.size());
        next.push_back(Beam());
        next.back().node = node;
        next.back().lm_score = n.lm_score;
        return n.slot;
      };

      for (const Beam& beam : beams) {
        float p_total = logsumexp(beam.p_b, beam.p_nb);
        int last = trie[beam.node].ch;
        for (int ci = 0; ci < ncand; ++ci) {
          int c = cand[ci];
          float p = lp[c];
          if (c == blank_id) {
            Beam& nb = next[slot_for(beam.node)];
            nb.p_b = logsumexp(nb.p_b, p_total + p);
          } else if (c == last) {
            // repeated char: continues the same prefix from p_nb; starts a
            // new (doubled) char only across a blank
            Beam& same = next[slot_for(beam.node)];
            same.p_nb = logsumexp(same.p_nb, beam.p_nb + p);
            if (beam.p_b > kNegInf / 2) {
              int child = find_or_create_child(beam.node, c);
              Beam& nb = next[slot_for(child)];
              nb.p_nb = logsumexp(nb.p_nb, beam.p_b + p);
            }
          } else {
            int child = find_or_create_child(beam.node, c);
            Beam& nb = next[slot_for(child)];
            nb.p_nb = logsumexp(nb.p_nb, p_total + p);
          }
        }
      }

      if (static_cast<int>(next.size()) > beam_width) {
        std::nth_element(next.begin(), next.begin() + beam_width, next.end(),
                         [](const Beam& a, const Beam& b) {
                           return a.total() > b.total();
                         });
        next.resize(beam_width);
      }
      beams.swap(next);
    }

    std::sort(beams.begin(), beams.end(),
              [](const Beam& a, const Beam& b) { return a.total() > b.total(); });
    std::vector<std::pair<std::vector<int>, float>> out;
    for (int i = 0; i < std::min<int>(topk, beams.size()); ++i) {
      std::vector<int> prefix;
      for (int k = beams[i].node; k > 0; k = trie[k].parent)
        prefix.push_back(trie[k].ch);
      std::reverse(prefix.begin(), prefix.end());
      out.emplace_back(std::move(prefix), beams[i].total());
    }
    return out;
  }
};

}  // namespace

extern "C" {

void* bsd_create(const char** labels, int num_labels, int blank_id,
                 const char* lm_path, float alpha, float beta, int beam_width,
                 int cutoff_top_n, float cutoff_prob) {
  auto* d = new Decoder();
  d->labels.assign(labels, labels + num_labels);
  d->blank_id = blank_id;
  for (int i = 0; i < num_labels; ++i)
    if (d->labels[i] == " ") d->space_id = i;
  if (lm_path != nullptr && lm_path[0] != '\0')
    d->has_lm = d->lm.load(lm_path);
  d->alpha = alpha;
  d->beta = beta;
  d->beam_width = beam_width;
  d->cutoff_top_n = cutoff_top_n > 0 ? cutoff_top_n : num_labels;
  d->cutoff_prob = cutoff_prob;
  return d;
}

int bsd_has_lm(void* handle) { return static_cast<Decoder*>(handle)->has_lm; }

// decode one utterance; returns number of hypotheses written.
// out_tokens: (topk, max_len) row-major, -1 padded; out_lens/out_scores: (topk,)
int bsd_decode(void* handle, const float* log_probs, int T, int C, int topk,
               int max_len, int* out_tokens, int* out_lens, float* out_scores) {
  auto* d = static_cast<Decoder*>(handle);
  auto hyps = d->decode(log_probs, T, C, topk);
  for (size_t i = 0; i < hyps.size(); ++i) {
    int len = std::min<int>(hyps[i].first.size(), max_len);
    for (int j = 0; j < len; ++j) out_tokens[i * max_len + j] = hyps[i].first[j];
    for (int j = len; j < max_len; ++j) out_tokens[i * max_len + j] = -1;
    out_lens[i] = len;
    out_scores[i] = hyps[i].second;
  }
  return static_cast<int>(hyps.size());
}

void bsd_free(void* handle) { delete static_cast<Decoder*>(handle); }

// ---------------- standalone word-LM scoring (hybrid decoder) ----------------
//
// The hybrid decoder (decode/beam.decode_device_with_lm) rescores K complete
// hypotheses per utterance with the word LM. Doing that per-word in Python
// costs ~1 ms/utt (hash + searchsorted per call) and binds the pipeline once
// the device beam is fast; these entry points batch the whole loop in C++
// over the same mmap'd CNLM (or text ARPA), with identical Katz semantics.

void* lm_create(const char* path) {
  auto* lm = new NgramLM();
  if (path == nullptr || path[0] == '\0' || !lm->load(path)) {
    delete lm;
    return nullptr;
  }
  return lm;
}

int lm_order(void* handle) { return static_cast<NgramLM*>(handle)->order; }

// texts: n_texts NUL-terminated UTF-8 strings (space-separated words),
// concatenated. Per text i: out_lm[i] = sum_j logP(word_j | preceding words)
// (full Katz backoff, context truncated to the LM order — exactly
// decode/beam.rescore_with_lm's python loop) and out_words[i] = word count.
void lm_rescore(void* handle, const char* texts, int n_texts, float* out_lm,
                int* out_words) {
  auto* lm = static_cast<NgramLM*>(handle);
  const char* p = texts;
  std::vector<int> ids;
  for (int i = 0; i < n_texts; ++i) {
    ids.clear();
    float total = 0.0f;
    int words = 0;
    const char* start = p;
    for (;; ++p) {
      if (*p == ' ' || *p == '\0') {
        if (p > start) {
          ids.push_back(lm->word_id(std::string(start, p - start)));
          size_t begin = ids.size() > static_cast<size_t>(lm->order)
                             ? ids.size() - lm->order : 0;
          total += lm->score_from(ids, begin);
          ++words;
        }
        start = p + 1;
        if (*p == '\0') break;
      }
    }
    ++p;  // past the NUL
    out_lm[i] = total;
    out_words[i] = words;
  }
}

void lm_destroy(void* handle) { delete static_cast<NgramLM*>(handle); }

}  // extern "C"
