// CTC prefix beam search decoder with LM rescoring (host-side native).
//
// Decoding is control-flow heavy and accelerator-hostile (SURVEY §7 hard parts:
// "keep decode on host"), so — as in the reference — it lives in C++ behind
// a C ABI. Three pieces, filling the roles of the reference's
// `native_client/ctcdecode/` stack with original designs:
//
// - **Path trie of beams** (the `path_trie.cpp:247` role): each beam is a
//   node with a parent pointer and last symbol, so prefix extension is O(1)
//   child lookup and prefix identity is pointer identity — no per-step
//   std::map<vector,...> rebuilds.
// - **Hash-based backoff n-gram word LM** (the KenLM `scorer.cpp:349` role):
//   n-grams live in one open-addressed-style unordered_map keyed by an
//   FNV-1a hash of (n, word ids); scoring tries the longest available
//   context and pays a fixed backoff penalty per shortened level. The model
//   file is built by `tosem_tpu_torch/data/scorer.py` (the
//   `generate_scorer_package` analog).
// - **Vocabulary trie**: words are label-id sequences; every beam carries
//   its position in the vocab trie for the current partial word, so when a
//   space is emitted the completed word's id (or OOV) is known without
//   string assembly. The word-boundary LM increment
//   `alpha * logP(w | context) + beta` is folded into the extension
//   probability exactly where the reference applies its scorer.
//
// Input:  logp [T, V] row-major float32 (log-softmax already applied).
// Output: best prefix labels + its log score.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int32_t kMaxCtx = 4;  // supports LM order up to 5

inline float log_add(float a, float b) {
  if (a <= kNegInf) return b;
  if (b <= kNegInf) return a;
  float m = a > b ? a : b;
  return m + std::log1p(std::exp(-(std::fabs(a - b))));
}

// ---------------------------------------------------------------- LM

struct VocabNode {
  std::map<int32_t, int32_t> ch;  // label -> node index
  int32_t word_id = -1;
};

inline uint64_t fnv1a(const int32_t* ids, int32_t n) {
  uint64_t h = 1469598103934665603ull ^ (uint64_t)n;
  for (int32_t i = 0; i < n; i++) {
    uint32_t v = (uint32_t)ids[i];
    for (int b = 0; b < 4; b++) {
      h ^= (v >> (8 * b)) & 0xff;
      h *= 1099511628211ull;
    }
  }
  return h;
}

struct NgramLM {
  int32_t order = 0;
  int32_t n_words = 0;
  float unk_logp = -20.0f;
  float backoff_logp = -0.91f;  // log 0.4, stupid-backoff style
  std::vector<VocabNode> trie;  // node 0 = root
  std::unordered_map<uint64_t, float> logp;

  int32_t advance(int32_t node, int32_t label) const {
    if (node < 0) return -1;
    auto it = trie[node].ch.find(label);
    return it == trie[node].ch.end() ? -1 : it->second;
  }

  // ctx: previous word ids, most recent last; -1 entries break context.
  float score(const int32_t* ctx, int32_t n_ctx, int32_t w) const {
    if (w < 0) return unk_logp;
    // usable context: longest suffix of ctx with no OOV breaks
    int32_t usable = 0;
    while (usable < n_ctx && usable < order - 1 &&
           ctx[n_ctx - 1 - usable] >= 0)
      usable++;
    int32_t key[kMaxCtx + 1];
    for (int32_t k = usable; k >= 0; k--) {
      for (int32_t i = 0; i < k; i++) key[i] = ctx[n_ctx - k + i];
      key[k] = w;
      auto it = logp.find(fnv1a(key, k + 1));
      if (it != logp.end()) return it->second + (usable - k) * backoff_logp;
    }
    return unk_logp;
  }
};

NgramLM* lm_from_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto fail = [&]() -> NgramLM* {
    std::fclose(f);
    return nullptr;
  };
  char magic[4];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "TLM1", 4) != 0)
    return fail();
  auto lm = std::make_unique<NgramLM>();
  int32_t n_entries = 0;
  if (std::fread(&lm->order, 4, 1, f) != 1 ||
      std::fread(&lm->n_words, 4, 1, f) != 1 ||
      std::fread(&lm->unk_logp, 4, 1, f) != 1 ||
      std::fread(&lm->backoff_logp, 4, 1, f) != 1)
    return fail();
  if (lm->order < 1 || lm->order > kMaxCtx + 1 || lm->n_words < 0)
    return fail();
  lm->trie.emplace_back();  // root
  for (int32_t w = 0; w < lm->n_words; w++) {
    int32_t len;
    if (std::fread(&len, 4, 1, f) != 1 || len <= 0 || len > 1 << 16)
      return fail();
    std::vector<int32_t> labels(len);
    if (std::fread(labels.data(), 4, len, f) != (size_t)len) return fail();
    int32_t node = 0;
    for (int32_t lab : labels) {
      auto it = lm->trie[node].ch.find(lab);
      if (it == lm->trie[node].ch.end()) {
        lm->trie.emplace_back();
        it = lm->trie[node].ch.emplace(lab, (int32_t)lm->trie.size() - 1)
                 .first;
      }
      node = it->second;
    }
    lm->trie[node].word_id = w;
  }
  if (std::fread(&n_entries, 4, 1, f) != 1 || n_entries < 0) return fail();
  lm->logp.reserve((size_t)n_entries * 2);
  for (int32_t i = 0; i < n_entries; i++) {
    int32_t n;
    if (std::fread(&n, 4, 1, f) != 1 || n < 1 || n > lm->order)
      return fail();
    int32_t ids[kMaxCtx + 1];
    float p;
    if (std::fread(ids, 4, n, f) != (size_t)n ||
        std::fread(&p, 4, 1, f) != 1)
      return fail();
    lm->logp[fnv1a(ids, n)] = p;
  }
  std::fclose(f);
  return lm.release();
}

// ---------------------------------------------------------- path trie

struct Beam {
  int32_t sym = -1;    // symbol on the edge from parent (-1 = root)
  Beam* parent = nullptr;
  int32_t vnode = 0;   // vocab-trie node of current partial word (-1 dead)
  int32_t ctx[kMaxCtx];  // previous word ids, most recent last (-1 empty)
  int32_t n_ctx = 0;
  float lm_inc = 0.0f;  // word-boundary increment, folded at creation
  float pb = kNegInf, pnb = kNegInf;    // current timestep
  float npb = kNegInf, npnb = kNegInf;  // next timestep accumulators
  bool touched = false;
  bool mark = false;
  std::map<int32_t, Beam*> children;

  float total() const { return log_add(pb, pnb); }
  float ntotal() const { return log_add(npb, npnb); }
};

struct BeamPool {
  std::deque<std::unique_ptr<Beam>> all;
  Beam* fresh() {
    all.emplace_back(std::make_unique<Beam>());
    return all.back().get();
  }
};

// Mark-sweep the trie: keep only live beams and their ancestors. The
// reference's path_trie prunes dead branches eagerly (`path_trie.cpp`
// remove); amortized sweeps bound memory at O(live prefixes) instead of
// O(T * beam_width * V) without per-step bookkeeping.
void compact(BeamPool& pool, const std::vector<Beam*>& beams) {
  for (auto& up : pool.all) up->mark = false;
  for (Beam* b : beams)
    for (Beam* a = b; a != nullptr && !a->mark; a = a->parent)
      a->mark = true;
  std::deque<std::unique_ptr<Beam>> kept;
  for (auto& up : pool.all) {
    if (up->mark) {
      kept.push_back(std::move(up));
    } else if (up->parent != nullptr && up->parent->mark) {
      up->parent->children.erase(up->sym);
    }
  }
  pool.all.swap(kept);
}

Beam* child_of(Beam* b, int32_t s, BeamPool& pool, const NgramLM* lm,
               float alpha, float beta, int32_t space) {
  auto it = b->children.find(s);
  if (it != b->children.end()) return it->second;
  Beam* c = pool.fresh();
  c->sym = s;
  c->parent = b;
  if (lm != nullptr) {
    if (s == space) {
      int32_t word_id =
          b->vnode >= 0 ? lm->trie[b->vnode].word_id : -1;
      c->lm_inc = alpha * lm->score(b->ctx, b->n_ctx, word_id) + beta;
      c->n_ctx = b->n_ctx < kMaxCtx ? b->n_ctx + 1 : kMaxCtx;
      for (int32_t i = 0; i < c->n_ctx - 1; i++)
        c->ctx[i] = b->ctx[b->n_ctx - (c->n_ctx - 1) + i];
      c->ctx[c->n_ctx - 1] = word_id;
      c->vnode = 0;  // new word starts at the vocab-trie root
    } else {
      c->vnode = lm->advance(b->vnode, s);
      std::memcpy(c->ctx, b->ctx, sizeof(c->ctx));
      c->n_ctx = b->n_ctx;
    }
  }
  b->children.emplace(s, c);
  return c;
}

int decode_impl(const float* logp, int32_t T, int32_t V, int32_t blank,
                int32_t beam_width, const NgramLM* lm, float alpha,
                float beta, int32_t space, const float* bonus,
                int32_t* out_labels, int32_t* out_len, float* out_score,
                int32_t max_out) {
  if (T < 0 || V <= 0 || blank < 0 || blank >= V || beam_width <= 0)
    return -1;
  BeamPool pool;
  Beam* root = pool.fresh();
  root->pb = 0.0f;  // empty prefix, log P = 0
  std::vector<Beam*> beams{root};
  std::vector<Beam*> touched;
  touched.reserve((size_t)beam_width * 4);

  auto touch = [&touched](Beam* b) {
    if (!b->touched) {
      b->touched = true;
      touched.push_back(b);
    }
  };

  for (int32_t t = 0; t < T; t++) {
    const float* row = logp + (size_t)t * V;
    touched.clear();
    for (Beam* b : beams) {
      float tot = b->total();
      // 1) emit blank: prefix unchanged, ends-in-blank
      touch(b);
      b->npb = log_add(b->npb, tot + row[blank]);
      // 2) repeat last symbol: prefix unchanged, ends-non-blank
      if (b->sym >= 0) b->npnb = log_add(b->npnb, b->pnb + row[b->sym]);
      // 3) extend with symbol s
      for (int32_t s = 0; s < V; s++) {
        if (s == blank) continue;
        // only the ends-in-blank mass extends into a repeated symbol
        float base = (s == b->sym) ? b->pb : tot;
        if (base <= kNegInf) continue;
        Beam* c = child_of(b, s, pool, lm, alpha, beta, space);
        float ps = row[s] + (bonus ? bonus[s] : 0.0f) + c->lm_inc;
        touch(c);
        c->npnb = log_add(c->npnb, base + ps);
      }
    }
    // advance + prune to beam_width among touched prefixes. Every live
    // beam is in `touched` (blank emission touches it unconditionally),
    // so resetting the touched list alone keeps the pool consistent.
    int32_t keep = std::min<int32_t>(beam_width, (int32_t)touched.size());
    if ((int32_t)touched.size() > beam_width)
      std::nth_element(touched.begin(), touched.begin() + beam_width - 1,
                       touched.end(), [](Beam* a, Beam* b) {
                         return a->ntotal() > b->ntotal();
                       });
    beams.clear();
    for (int32_t i = 0; i < (int32_t)touched.size(); i++) {
      Beam* b = touched[i];
      if (i < keep) {
        b->pb = b->npb;
        b->pnb = b->npnb;
        beams.push_back(b);
      } else {
        b->pb = kNegInf;
        b->pnb = kNegInf;
      }
      b->npb = kNegInf;
      b->npnb = kNegInf;
      b->touched = false;
    }
    if ((t & 63) == 63) compact(pool, beams);
  }

  // end-of-utterance: score the pending partial word (vnode != 0 means a
  // word is in progress) so the last word is LM-rescored even without a
  // trailing delimiter — the reference applies its scorer the same way
  // when emitting final results.
  Beam* best = nullptr;
  float best_score = kNegInf;
  for (Beam* b : beams) {
    float s = b->total();
    if (lm != nullptr && b->vnode != 0) {
      int32_t wid = b->vnode >= 0 ? lm->trie[b->vnode].word_id : -1;
      s += alpha * lm->score(b->ctx, b->n_ctx, wid) + beta;
    }
    if (s > best_score) {
      best_score = s;
      best = b;
    }
  }
  if (!best) return -1;
  std::vector<int32_t> rev;
  for (Beam* b = best; b->parent != nullptr; b = b->parent)
    rev.push_back(b->sym);
  int32_t n = (int32_t)rev.size();
  if (n > max_out) n = max_out;
  for (int32_t i = 0; i < n; i++) out_labels[i] = rev[rev.size() - 1 - i];
  *out_len = n;
  *out_score = best_score;
  return 0;
}

}  // namespace

extern "C" {

void* tosem_lm_load(const char* path) { return lm_from_file(path); }

void tosem_lm_free(void* lm) { delete (NgramLM*)lm; }

int32_t tosem_lm_order(void* lm) { return ((NgramLM*)lm)->order; }

int32_t tosem_lm_n_words(void* lm) { return ((NgramLM*)lm)->n_words; }

// Score one word given its context (word ids, most recent last); for the
// Python-side tests and the serve-layer hot-word API.
float tosem_lm_score(void* lm, const int32_t* ctx, int32_t n_ctx,
                     int32_t word) {
  return ((NgramLM*)lm)->score(ctx, n_ctx, word);
}

// Look up a word id from its label sequence (-1 if OOV).
int32_t tosem_lm_word_id(void* lm_, const int32_t* labels, int32_t n) {
  NgramLM* lm = (NgramLM*)lm_;
  int32_t node = 0;
  for (int32_t i = 0; i < n && node >= 0; i++)
    node = lm->advance(node, labels[i]);
  return node >= 0 ? lm->trie[node].word_id : -1;
}

// Returns 0 on success. out_labels has room for max_out entries.
int ctc_beam_decode(const float* logp, int32_t T, int32_t V, int32_t blank,
                    int32_t beam_width, const float* bonus /* V or null */,
                    int32_t* out_labels, int32_t* out_len, float* out_score,
                    int32_t max_out) {
  return decode_impl(logp, T, V, blank, beam_width, nullptr, 0.0f, 0.0f,
                     -1, bonus, out_labels, out_len, out_score, max_out);
}

// LM-scored variant: alpha/beta are the scorer weights, space is the
// word-delimiter label id.
int ctc_beam_decode_lm(const float* logp, int32_t T, int32_t V,
                       int32_t blank, int32_t beam_width, void* lm,
                       float alpha, float beta, int32_t space,
                       const float* bonus, int32_t* out_labels,
                       int32_t* out_len, float* out_score, int32_t max_out) {
  return decode_impl(logp, T, V, blank, beam_width, (const NgramLM*)lm,
                     alpha, beta, space, bonus, out_labels, out_len,
                     out_score, max_out);
}

}  // extern "C"
