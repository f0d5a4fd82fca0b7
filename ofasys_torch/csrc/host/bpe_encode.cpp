// GPT-2 byte-level BPE encoder for the host (the port's copy of
// ofasys_tpu's native encoder, with the same C interface).
//
// The Python tokenizer (ofasys_torch/preprocessor/tokenizer/gpt2_bpe.py) is
// the semantic reference; this library reproduces it exactly:
//   * the GPT-2 pre-tokenizer pattern
//       's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
//     is hand-compiled into a scanner; \p{L}/\p{N}/\s classification comes
//     from unicode_tables.h, generated FROM the same `regex` module the
//     Python side uses (ofasys_torch/tools/gen_unicode_tables.py) — so the
//     split is identical by construction.
//   * merges run in raw byte space: the byte->unicode remap is a per-byte
//     bijection, so vocab tokens and merge pairs are translated back to byte
//     strings on the Python side before being handed to ofa_bpe_create.
//     Every merged symbol is then a contiguous (offset, len) span of the
//     original word — no string concatenation in the loop.
//
// C ABI (driven from ctypes, ofasys_torch/preprocessor/tokenizer/native_bpe.py;
// built by ofasys_torch/ops/host_build.py):
//   void*   ofa_bpe_create(const uint8_t* blob, int64_t len);
//   void    ofa_bpe_free(void* h);
//   int64_t ofa_bpe_encode(void* h, const uint8_t* text, int64_t n,
//                          int32_t* out, int64_t cap);
//     returns #ids written; if cap is too small returns -(needed); -1 on a
//     malformed handle. Thread-safe (per-handle mutex guards the word cache).
//
// Blob layout (little-endian u32 sizes):
//   [n_tokens][ (len, bytes) x n_tokens ]        token id == position
//   [n_merges][ (len_a, bytes_a, len_b, bytes_b) x n_merges ]  rank == position

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

// ---------------------------------------------------------------- classes
bool in_ranges(uint32_t cp, const uint32_t (*r)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < r[mid][0])
      hi = mid;
    else if (cp > r[mid][1])
      lo = mid + 1;
    else
      return true;
  }
  return false;
}
inline bool is_letter(uint32_t cp) { return in_ranges(cp, UNI_LETTER, UNI_LETTER_n); }
inline bool is_number(uint32_t cp) { return in_ranges(cp, UNI_NUMBER, UNI_NUMBER_n); }
inline bool is_space(uint32_t cp) { return in_ranges(cp, UNI_SPACE, UNI_SPACE_n); }

// --------------------------------------------------------------- utf-8
// Decode one codepoint at byte offset i (returns its size; invalid bytes are
// treated as one-byte codepoints in the private range so they classify as
// "other", matching Python semantics where the input is always valid UTF-8).
inline uint32_t decode_utf8(const uint8_t* s, int64_t n, int64_t i, int* size) {
  uint8_t c = s[i];
  if (c < 0x80) {
    *size = 1;
    return c;
  }
  int len = (c >= 0xF0) ? 4 : (c >= 0xE0) ? 3 : (c >= 0xC0) ? 2 : 1;
  if (len == 1 || i + len > n) {
    *size = 1;
    return 0xDC00 + c;  // lone continuation / truncated: "other"
  }
  uint32_t cp = c & (0x7F >> len);
  for (int k = 1; k < len; ++k) {
    if ((s[i + k] & 0xC0) != 0x80) {
      *size = 1;
      return 0xDC00 + c;
    }
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  *size = len;
  return cp;
}

// ------------------------------------------------------------ hash maps
struct BytesHash {
  size_t operator()(const std::string& s) const {
    // FNV-1a
    size_t h = 1469598103934665603ull;
    for (unsigned char c : s) h = (h ^ c) * 1099511628211ull;
    return h;
  }
};

struct Handle {
  std::unordered_map<std::string, int32_t, BytesHash> vocab;   // bytes -> id
  std::unordered_map<std::string, int32_t, BytesHash> ranks;   // key(a,b) -> rank
  std::unordered_map<std::string, std::vector<int32_t>, BytesHash> cache;
  std::mutex cache_mu;
};

inline std::string pair_key(const char* a, size_t la, const char* b, size_t lb) {
  std::string k;
  k.reserve(4 + la + lb);
  uint32_t n = static_cast<uint32_t>(la);
  k.append(reinterpret_cast<const char*>(&n), 4);
  k.append(a, la);
  k.append(b, lb);
  return k;
}

// --------------------------------------------------------------- scanner
// One token of the GPT-2 pattern starting at byte offset i; returns the end
// offset (exclusive). Alternatives are tried in the pattern's order.
int64_t next_token(const uint8_t* s, int64_t n, int64_t i) {
  int sz0;
  uint32_t cp0 = decode_utf8(s, n, i, &sz0);

  // 1. contractions 's 't 're 've 'm 'll 'd (ASCII, case-sensitive)
  if (cp0 == '\'' && i + 1 < n) {
    uint8_t c1 = s[i + 1];
    if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') return i + 2;
    if (i + 2 < n) {
      uint8_t c2 = s[i + 2];
      if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
          (c1 == 'l' && c2 == 'l'))
        return i + 3;
    }
    // NOTE: 2-char forms already returned; "'re" needs both lookups above
    if (c1 == 'r' || c1 == 'v' || c1 == 'l') { /* fall through: not a contraction */ }
  }

  // helper state: optional single ASCII space then a class run
  int64_t j = i;
  uint32_t cp = cp0;
  int sz = sz0;
  bool led_space = false;
  if (cp0 == ' ' && i + 1 < n) {
    int sz1;
    uint32_t cp1 = decode_utf8(s, n, i + 1, &sz1);
    if (is_letter(cp1) || is_number(cp1) ||
        (!is_space(cp1) && !is_letter(cp1) && !is_number(cp1))) {
      led_space = true;
      j = i + 1;
      cp = cp1;
      sz = sz1;
    }
  }

  // 2./3./4.  ?\p{L}+ |  ?\p{N}+ |  ?[^\s\p{L}\p{N}]+
  if (is_letter(cp)) {
    int64_t k = j + sz;
    while (k < n) {
      int s2;
      uint32_t c2 = decode_utf8(s, n, k, &s2);
      if (!is_letter(c2)) break;
      k += s2;
    }
    return k;
  }
  if (is_number(cp)) {
    int64_t k = j + sz;
    while (k < n) {
      int s2;
      uint32_t c2 = decode_utf8(s, n, k, &s2);
      if (!is_number(c2)) break;
      k += s2;
    }
    return k;
  }
  if (!is_space(cp)) {
    int64_t k = j + sz;
    while (k < n) {
      int s2;
      uint32_t c2 = decode_utf8(s, n, k, &s2);
      if (is_space(c2) || is_letter(c2) || is_number(c2)) break;
      k += s2;
    }
    return k;
  }
  (void)led_space;

  // 5./6. whitespace: \s+(?!\S) backtracks to exclude a final space that
  // prefixes the next token; plain \s+ otherwise.
  int64_t k = i;
  int64_t last_start = i;
  while (k < n) {
    int s2;
    uint32_t c2 = decode_utf8(s, n, k, &s2);
    if (!is_space(c2)) break;
    last_start = k;
    k += s2;
  }
  if (k < n && last_start > i) return last_start;  // run minus last ws char
  return k;                                        // whole run (or single char)
}

// ------------------------------------------------------------- merge loop
void bpe_word(Handle* h, const uint8_t* w, size_t wn, std::vector<int32_t>* out) {
  // symbols are contiguous (offset, len) spans of w; start as single bytes
  struct Span {
    uint32_t off, len;
  };
  std::vector<Span> sym(wn);
  for (size_t k = 0; k < wn; ++k) sym[k] = {static_cast<uint32_t>(k), 1};

  const char* base = reinterpret_cast<const char*>(w);
  while (sym.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t k = 0; k + 1 < sym.size(); ++k) {
      auto it = h->ranks.find(pair_key(base + sym[k].off, sym[k].len,
                                       base + sym[k + 1].off, sym[k + 1].len));
      if (it != h->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = k;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every adjacent (a, b) occurrence of the winning pair, left to
    // right, exactly like GPT2BPE._bpe's single-pass rebuild
    const std::string a(base + sym[best_i].off, sym[best_i].len);
    const std::string b(base + sym[best_i + 1].off, sym[best_i + 1].len);
    std::vector<Span> merged;
    merged.reserve(sym.size());
    size_t k = 0;
    while (k < sym.size()) {
      if (k + 1 < sym.size() &&
          std::string(base + sym[k].off, sym[k].len) == a &&
          std::string(base + sym[k + 1].off, sym[k + 1].len) == b) {
        merged.push_back({sym[k].off, sym[k].len + sym[k + 1].len});
        k += 2;
      } else {
        merged.push_back(sym[k]);
        k += 1;
      }
    }
    sym.swap(merged);
  }

  for (auto& sp : sym) {
    auto it = h->vocab.find(std::string(base + sp.off, sp.len));
    out->push_back(it == h->vocab.end() ? -1 : it->second);
  }
}

inline uint32_t read_u32(const uint8_t*& p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  p += 4;
  return v;
}

}  // namespace

extern "C" {

void* ofa_bpe_create(const uint8_t* blob, int64_t len) {
  if (!blob || len < 8) return nullptr;
  const uint8_t* p = blob;
  const uint8_t* end = blob + len;
  Handle* h = new Handle();
  uint32_t n_tok = read_u32(p);
  h->vocab.reserve(n_tok * 2);
  for (uint32_t t = 0; t < n_tok; ++t) {
    if (p + 4 > end) goto fail;
    uint32_t l = read_u32(p);
    if (p + l > end) goto fail;
    h->vocab.emplace(std::string(reinterpret_cast<const char*>(p), l),
                     static_cast<int32_t>(t));
    p += l;
  }
  if (p + 4 > end) goto fail;
  {
    uint32_t n_merge = read_u32(p);
    h->ranks.reserve(n_merge * 2);
    for (uint32_t m = 0; m < n_merge; ++m) {
      if (p + 4 > end) goto fail;
      uint32_t la = read_u32(p);
      if (p + la + 4 > end) goto fail;
      const char* a = reinterpret_cast<const char*>(p);
      p += la;
      uint32_t lb = read_u32(p);
      if (p + lb > end) goto fail;
      const char* b = reinterpret_cast<const char*>(p);
      p += lb;
      h->ranks.emplace(pair_key(a, la, b, lb), static_cast<int32_t>(m));
    }
  }
  return h;
fail:
  delete h;
  return nullptr;
}

void ofa_bpe_free(void* hv) { delete static_cast<Handle*>(hv); }

int64_t ofa_bpe_encode(void* hv, const uint8_t* text, int64_t n, int32_t* out,
                       int64_t cap) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h) return -1;
  int64_t written = 0;
  int64_t i = 0;
  std::vector<int32_t> ids;
  while (i < n) {
    int64_t j = next_token(text, n, i);
    if (j <= i) j = i + 1;  // safety: always advance
    std::string word(reinterpret_cast<const char*>(text + i), j - i);
    ids.clear();
    {
      std::lock_guard<std::mutex> lk(h->cache_mu);
      auto it = h->cache.find(word);
      if (it != h->cache.end()) {
        ids = it->second;
      }
    }
    if (ids.empty()) {
      bpe_word(h, text + i, j - i, &ids);
      std::lock_guard<std::mutex> lk(h->cache_mu);
      if (h->cache.size() < (1u << 20)) h->cache.emplace(word, ids);
    }
    for (int32_t id : ids) {
      if (written < cap) out[written] = id;
      ++written;
    }
    i = j;
  }
  return written <= cap ? written : -written;
}

}  // extern "C"
