// Native byte-level BPE tokenizer engine of the CLIP vocabulary (the
// port's copy of the JAX package's engine).
//
// The scanner, merge loop and decoder of data/tokenizers.py's
// SimpleTokenizer in C++ behind a C ABI bound with ctypes
// (data/native_bpe.py), byte-exact with the Python implementation.
// The merges text comes from the caller (bpe_new), who reads it from a
// plain or a gzipped file.
//
// Parity-critical details mirrored from data/tokenizers.py:
//  - the GPT-2/CLIP byte<->printable-codepoint bijection (bytes_to_unicode)
//    is inverted at load time so the merge loop runs in the raw-byte domain;
//  - vocab assembly order: 256 base chars (in bytes_to_unicode value order),
//    256 "</w>" variants, 48894 merges (text lines [1, 48895)), then
//    <|startoftext|>, <|endoftext|>  => 49408 ids;
//  - the scanner reproduces the regex alternation
//      <|sot|> | <|eot|> | 's|'t|'re|'ve|'m|'ll|'d | \p{L}+ | \p{N} |
//      [^\s\p{L}\p{N}]+
//    with leftmost first-alternative semantics (NOT longest-match), using
//    classification tables generated from the Python `regex` module
//    (gen_unicode_tables.py);
//  - the merge pass copies the Python implementation's in-word scan
//    (word.index(first, i) / overlap handling, SimpleTokenizer.bpe).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

// ------------------------------------------------------------- classification

bool in_ranges(uint32_t cp, const CpRange* ranges, int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < ranges[mid].lo) {
      hi = mid - 1;
    } else if (cp > ranges[mid].hi) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

bool is_letter(uint32_t cp) { return in_ranges(cp, kLetterRanges, kLetterRanges_len); }
bool is_number(uint32_t cp) { return in_ranges(cp, kNumberRanges, kNumberRanges_len); }
bool is_other(uint32_t cp) { return in_ranges(cp, kOtherRanges, kOtherRanges_len); }

// ---------------------------------------------------------------------- utf-8

// Decodes the codepoint at s[i]; advances i past it. Invalid bytes decode as
// 0xFFFD and advance by one (the scanner then treats them as "other").
uint32_t utf8_next(const std::string& s, size_t& i) {
  uint8_t b0 = s[i];
  if (b0 < 0x80) { i += 1; return b0; }
  int extra; uint32_t cp;
  if ((b0 & 0xE0) == 0xC0) { extra = 1; cp = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; cp = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; cp = b0 & 0x07; }
  else { i += 1; return 0xFFFD; }
  if (i + (size_t)extra >= s.size()) { i += 1; return 0xFFFD; }
  for (int k = 1; k <= extra; ++k) {
    if ((s[i + k] & 0xC0) != 0x80) { i += 1; return 0xFFFD; }
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  i += extra + 1;
  return cp;
}

void utf8_append(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out += (char)cp;
  } else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
}

// ------------------------------------------------------------------- engine

struct Engine {
  // byte <-> remapped-codepoint bijection (bytes_to_unicode)
  uint32_t byte_to_cp[256];
  std::unordered_map<uint32_t, uint8_t> cp_to_byte;

  // interned symbols: raw bytes + end-of-word flag
  std::vector<std::string> sym_bytes;
  std::vector<uint8_t> sym_eow;
  std::vector<int32_t> sym_vocab;
  std::unordered_map<std::string, int32_t> sym_index;  // key: bytes + '\x01' eow

  // (left_sym, right_sym) -> {rank, merged_sym}
  struct Merge { int32_t rank, merged; };
  std::unordered_map<uint64_t, Merge> merges;

  // vocab id -> raw byte string ("</w>" and special tokens literal)
  std::vector<std::string> vocab_bytes;
  int32_t sot_id = -1, eot_id = -1;

  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;

  std::string error;

  int32_t intern(const std::string& bytes, bool eow, int32_t vocab_id) {
    std::string key = bytes;
    key += eow ? '\x01' : '\x00';
    auto it = sym_index.find(key);
    if (it != sym_index.end()) {
      if (vocab_id >= 0 && sym_vocab[it->second] < 0) sym_vocab[it->second] = vocab_id;
      return it->second;
    }
    int32_t id = (int32_t)sym_bytes.size();
    sym_bytes.push_back(bytes);
    sym_eow.push_back(eow ? 1 : 0);
    sym_vocab.push_back(vocab_id);
    sym_index.emplace(std::move(key), id);
    return id;
  }

  // remapped-domain symbol text -> (raw bytes, eow)
  bool parse_symbol(const std::string& text, std::string* bytes, bool* eow) {
    std::string t = text;
    *eow = false;
    if (t.size() >= 4 && t.compare(t.size() - 4, 4, "</w>") == 0) {
      *eow = true;
      t = t.substr(0, t.size() - 4);
    }
    bytes->clear();
    size_t i = 0;
    while (i < t.size()) {
      uint32_t cp = utf8_next(t, i);
      auto it = cp_to_byte.find(cp);
      if (it == cp_to_byte.end()) return false;
      *bytes += (char)it->second;
    }
    return true;
  }

  bool load(const char* merges_text, int64_t merges_len) {
    // bytes_to_unicode: printable ranges map to themselves, the rest to
    // 256+n in increasing byte order (data/tokenizers.py:59-75)
    std::vector<int> bs;
    for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
    for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
    for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
    std::vector<bool> present(256, false);
    for (int b : bs) present[b] = true;
    std::vector<uint32_t> cs(bs.begin(), bs.end());
    int n = 0;
    for (int b = 0; b < 256; ++b) {
      if (!present[b]) {
        bs.push_back(b);
        cs.push_back(256 + n++);
      }
    }
    for (size_t i = 0; i < bs.size(); ++i) {
      byte_to_cp[bs[i]] = cs[i];
      cp_to_byte[cs[i]] = (uint8_t)bs[i];
    }

    // base vocab: 256 chars in bytes_to_unicode VALUE order, then "</w>"s
    vocab_bytes.resize(512);
    for (size_t i = 0; i < bs.size(); ++i) {
      std::string raw(1, (char)bs[i]);
      intern(raw, false, (int32_t)i);
      vocab_bytes[i] = raw;
    }
    for (size_t i = 0; i < bs.size(); ++i) {
      std::string raw(1, (char)bs[i]);
      intern(raw, true, (int32_t)(256 + i));
      vocab_bytes[256 + i] = raw + "</w>";
    }

    std::istringstream f(std::string(merges_text, (size_t)merges_len));
    std::string line;
    std::vector<std::string> lines;
    while (std::getline(f, line)) lines.push_back(line);
    // SimpleTokenizer's slicing: merges = lines[1 : 49152-256-2+1]
    size_t lo = 1, hi = std::min<size_t>(lines.size(), 49152 - 256 - 2 + 1);
    int32_t rank = 0;
    for (size_t li = lo; li < hi; ++li, ++rank) {
      const std::string& ln = lines[li];
      size_t sp = ln.find(' ');
      if (sp == std::string::npos) { error = "bad merge line"; return false; }
      std::string s1 = ln.substr(0, sp), s2 = ln.substr(sp + 1);
      // strip trailing \r (file is \n separated; be safe)
      while (!s2.empty() && (s2.back() == '\r' || s2.back() == ' ')) s2.pop_back();
      std::string b1, b2;
      bool e1, e2;
      if (!parse_symbol(s1, &b1, &e1) || !parse_symbol(s2, &b2, &e2)) {
        error = "unparseable merge symbol at line " + std::to_string(li);
        return false;
      }
      int32_t l = intern(b1, e1, -1);
      int32_t r = intern(b2, e2, -1);
      int32_t vocab_id = 512 + rank;
      int32_t merged = intern(b1 + b2, e2, vocab_id);
      vocab_bytes.push_back(b1 + b2 + (e2 ? "</w>" : ""));
      merges.emplace(((uint64_t)(uint32_t)l << 32) | (uint32_t)r,
                     Merge{rank, merged});
    }
    sot_id = (int32_t)vocab_bytes.size();
    vocab_bytes.push_back("<|startoftext|>");
    eot_id = (int32_t)vocab_bytes.size();
    vocab_bytes.push_back("<|endoftext|>");
    return true;
  }

  // ---------------------------------------------------------------- bpe core

  void bpe_word(std::vector<int32_t>& w) {
    while (w.size() > 1) {
      int32_t best_rank = INT32_MAX, first = -1, second = -1, merged = -1;
      for (size_t i = 0; i + 1 < w.size(); ++i) {
        auto it = merges.find(((uint64_t)(uint32_t)w[i] << 32) | (uint32_t)w[i + 1]);
        if (it != merges.end() && it->second.rank < best_rank) {
          best_rank = it->second.rank;
          first = w[i];
          second = w[i + 1];
          merged = it->second.merged;
        }
      }
      if (first < 0) break;
      // SimpleTokenizer.bpe's merge pass (word.index(first, i) scan)
      std::vector<int32_t> out;
      out.reserve(w.size());
      size_t i = 0;
      while (i < w.size()) {
        size_t j = i;
        while (j < w.size() && w[j] != first) ++j;
        if (j == w.size()) {
          out.insert(out.end(), w.begin() + i, w.end());
          break;
        }
        out.insert(out.end(), w.begin() + i, w.begin() + j);
        i = j;
        if (i + 1 < w.size() && w[i] == first && w[i + 1] == second) {
          out.push_back(merged);
          i += 2;
        } else {
          out.push_back(w[i]);
          i += 1;
        }
      }
      w.swap(out);
    }
  }

  void encode_token(const std::string& tok, std::vector<int32_t>* out) {
    {
      std::lock_guard<std::mutex> g(cache_mu);
      auto it = cache.find(tok);
      if (it != cache.end()) {
        out->insert(out->end(), it->second.begin(), it->second.end());
        return;
      }
    }
    std::vector<int32_t> w;
    w.reserve(tok.size());
    for (size_t i = 0; i < tok.size(); ++i) {
      std::string key(1, tok[i]);
      key += (i + 1 == tok.size()) ? '\x01' : '\x00';
      w.push_back(sym_index.at(key));
    }
    bpe_word(w);
    std::vector<int32_t> ids;
    ids.reserve(w.size());
    for (int32_t s : w) ids.push_back(sym_vocab[s]);
    out->insert(out->end(), ids.begin(), ids.end());
    std::lock_guard<std::mutex> g(cache_mu);
    cache.emplace(tok, std::move(ids));
  }

  // --------------------------------------------------------------- scanner

  static bool starts_with(const std::string& s, size_t i, const char* lit) {
    size_t n = std::strlen(lit);
    return s.size() - i >= n && s.compare(i, n, lit) == 0;
  }

  // Case-insensitive equality with a contraction letter, matching the regex
  // module's IGNORECASE closure exactly: ASCII case pair, plus U+017F (long
  // s) which case-folds to 's' (verified against regex.fullmatch over all
  // codepoints — only 's' has a non-ASCII equivalent).
  static bool cp_eq(uint32_t cp, char c) {
    return cp == (uint32_t)c || cp == (uint32_t)(c - 32) ||
           (c == 's' && cp == 0x17F);
  }

  // Byte length of a contraction match ('s|'t|'re|'ve|'m|'ll|'d) starting at
  // the apostrophe at text[i]; 0 when none matches.
  size_t match_contraction(const std::string& text, size_t i) {
    size_t p = i + 1;
    if (p >= text.size()) return 0;
    size_t q1 = p;
    uint32_t c1 = utf8_next(text, q1);
    if (cp_eq(c1, 's') || cp_eq(c1, 't') || cp_eq(c1, 'm') || cp_eq(c1, 'd')) {
      return q1 - i;
    }
    if (q1 >= text.size()) return 0;
    size_t q2 = q1;
    uint32_t c2 = utf8_next(text, q2);
    if ((cp_eq(c1, 'r') && cp_eq(c2, 'e')) ||
        (cp_eq(c1, 'v') && cp_eq(c2, 'e')) ||
        (cp_eq(c1, 'l') && cp_eq(c2, 'l'))) {
      return q2 - i;
    }
    return 0;
  }

  void encode_text(const std::string& text, std::vector<int32_t>* out) {
    size_t i = 0;
    while (i < text.size()) {
      if (starts_with(text, i, "<|startoftext|>")) {
        out->push_back(sot_id);
        i += 15;
        continue;
      }
      if (starts_with(text, i, "<|endoftext|>")) {
        out->push_back(eot_id);
        i += 13;
        continue;
      }
      if (text[i] == '\'') {
        size_t n = match_contraction(text, i);
        if (n) {
          encode_token(text.substr(i, n), out);
          i += n;
          continue;
        }
      }
      size_t start = i;
      size_t peek = i;
      uint32_t cp = utf8_next(text, peek);
      if (is_letter(cp)) {  // [\p{L}]+
        i = peek;
        while (i < text.size()) {
          size_t nx = i;
          uint32_t c2 = utf8_next(text, nx);
          if (!is_letter(c2)) break;
          i = nx;
        }
        encode_token(text.substr(start, i - start), out);
        continue;
      }
      if (is_number(cp)) {  // [\p{N}] (single codepoint)
        i = peek;
        encode_token(text.substr(start, i - start), out);
        continue;
      }
      if (is_other(cp)) {
        // [^\s\p{L}\p{N}]+ — runs through special tokens/apostrophes too,
        // exactly like the regex alternation does mid-run
        i = peek;
        while (i < text.size()) {
          size_t nx = i;
          uint32_t c2 = utf8_next(text, nx);
          if (!is_other(c2)) break;
          i = nx;
        }
        encode_token(text.substr(start, i - start), out);
        continue;
      }
      // matches no alternative (whitespace, or case-closure gaps like
      // U+0345): findall skips it
      i = peek;
    }
  }

  // ---------------------------------------------------------------- decode

  std::string decode_ids(const int32_t* ids, int64_t n, const int32_t* skip,
                         int64_t n_skip) {
    std::string raw;
    for (int64_t i = 0; i < n; ++i) {
      int32_t id = ids[i];
      if (id == 0 || id < 0 || id >= (int32_t)vocab_bytes.size()) continue;
      bool skipped = false;
      for (int64_t k = 0; k < n_skip; ++k) {
        if (skip[k] == id) { skipped = true; break; }
      }
      if (!skipped) raw += vocab_bytes[id];
    }
    // utf-8 validate with U+FFFD replacement (python errors="replace")
    std::string valid;
    valid.reserve(raw.size());
    size_t i = 0;
    while (i < raw.size()) {
      size_t before = i;
      uint32_t cp = utf8_next(raw, i);
      if (cp == 0xFFFD && raw.compare(before, i - before, "\xEF\xBF\xBD") != 0) {
        valid += "\xEF\xBF\xBD";
      } else {
        valid.append(raw, before, i - before);
      }
    }
    // "</w>" -> " "
    std::string out;
    out.reserve(valid.size());
    i = 0;
    while (i < valid.size()) {
      if (starts_with(valid, i, "</w>")) {
        out += ' ';
        i += 4;
      } else {
        out += valid[i++];
      }
    }
    return out;
  }
};

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

// Builds an engine from the merges text (the file's bytes, gunzipped);
// nullptr when a merge line does not parse.
void* bpe_new(const char* merges_text, int64_t merges_len) {
  auto* e = new Engine();
  if (!e->load(merges_text, merges_len)) {
    delete e;
    return nullptr;
  }
  return e;
}

void bpe_free(void* h) { delete (Engine*)h; }

int32_t bpe_vocab_size(void* h) {
  return (int32_t)((Engine*)h)->vocab_bytes.size();
}

// Encodes UTF-8 text; writes up to max_out ids; returns the total id count
// (callers grow the buffer and retry when the return exceeds max_out).
int64_t bpe_encode(void* h, const char* text, int64_t text_len, int32_t* out,
                   int64_t max_out) {
  std::vector<int32_t> ids;
  ((Engine*)h)->encode_text(std::string(text, (size_t)text_len), &ids);
  int64_t n = (int64_t)ids.size();
  for (int64_t i = 0; i < std::min(n, max_out); ++i) out[i] = ids[i];
  return n;
}

// Decodes ids (skipping `skip` ids and 0); returns byte count written
// (retry with a larger buffer if it exceeds max_out).
int64_t bpe_decode(void* h, const int32_t* ids, int64_t n, const int32_t* skip,
                   int64_t n_skip, char* out, int64_t max_out) {
  std::string s = ((Engine*)h)->decode_ids(ids, n, skip, n_skip);
  int64_t len = (int64_t)s.size();
  for (int64_t i = 0; i < std::min(len, max_out); ++i) out[i] = s[i];
  return len;
}

}  // extern "C"
