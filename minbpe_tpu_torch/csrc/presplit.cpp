// Native GPT-2/GPT-4 pre-split scanner over UTF-8 bytes.
//
// Mirrors minbpe_tpu/utils/presplit.py (the semantics reference, itself
// differential-tested against the `regex` module that the reference uses,
// minbpe/regex.py:41,114) but runs directly over UTF-8 at C++ speed with a
// dense codepoint-class table. Emits chunk-end BYTE offsets, so the Python
// side can slice the encoded text without re-encoding.
//
// Build: make -C csrc   (produces libpresplit.so; loaded via ctypes)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t FLAG_L = 1;
constexpr uint8_t FLAG_N = 2;
constexpr uint8_t FLAG_WS = 4;
constexpr uint8_t FLAG_C1 = 8;
constexpr uint8_t FLAG_CI_L = 16;
constexpr uint8_t FLAG_CI_V = 32;
constexpr uint8_t FLAG_CI_E = 64;
constexpr uint8_t FLAG_CI_R = 128;
constexpr uint8_t FLAG_WLN = FLAG_WS | FLAG_L | FLAG_N;

std::vector<uint8_t> g_table;  // dense class flags per codepoint

struct Cp {
  uint32_t cp;
  int32_t len;  // bytes consumed
};

inline Cp decode_utf8(const uint8_t* p, int64_t remaining) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) return {b0, 1};
  if ((b0 >> 5) == 0x6 && remaining >= 2)
    return {uint32_t((b0 & 0x1Fu) << 6 | (p[1] & 0x3Fu)), 2};
  if ((b0 >> 4) == 0xE && remaining >= 3)
    return {uint32_t((b0 & 0x0Fu) << 12 | (p[1] & 0x3Fu) << 6 | (p[2] & 0x3Fu)), 3};
  if ((b0 >> 3) == 0x1E && remaining >= 4)
    return {uint32_t((b0 & 0x07u) << 18 | (p[1] & 0x3Fu) << 12 |
                     (p[2] & 0x3Fu) << 6 | (p[3] & 0x3Fu)), 4};
  return {0xFFFDu, 1};  // invalid byte: classify as replacement char
}

// Decoded view of the text: codepoints, their class flags, and the byte
// offset where each codepoint starts (plus a final end offset).
struct Decoded {
  std::vector<uint32_t> cp;
  std::vector<uint8_t> fl;
  std::vector<int64_t> off;
};

void decode_all(const uint8_t* buf, int64_t len, Decoded& d) {
  d.cp.reserve(len);
  d.fl.reserve(len);
  d.off.reserve(len + 1);
  int64_t i = 0;
  while (i < len) {
    Cp c = decode_utf8(buf + i, len - i);
    d.off.push_back(i);
    d.cp.push_back(c.cp);
    d.fl.push_back(c.cp < g_table.size() ? g_table[c.cp] : 0);
    i += c.len;
  }
  d.off.push_back(len);
}

inline bool is_crlf(uint32_t c) { return c == '\r' || c == '\n'; }

}  // namespace

extern "C" {

// starts[k], flags[k]: run-length intervals covering [0, 0x110000).
void presplit_init(const int32_t* starts, const uint8_t* flags, int64_t k) {
  g_table.assign(0x110000, 0);
  for (int64_t j = 0; j < k; ++j) {
    int64_t lo = starts[j];
    int64_t hi = (j + 1 < k) ? starts[j + 1] : 0x110000;
    std::memset(g_table.data() + lo, flags[j], size_t(hi - lo));
  }
}

// Returns number of chunks; writes chunk-end byte offsets into out (cap must
// be >= number of chunks; len is always enough). mode: 4 = GPT-4, 2 = GPT-2.
int64_t presplit_run(const uint8_t* buf, int64_t len, int64_t* out,
                     int64_t cap, int32_t mode) {
  if (len == 0) return 0;
  Decoded d;
  decode_all(buf, len, d);
  const int64_t n = int64_t(d.cp.size());
  int64_t count = 0;
  int64_t i = 0;
  const bool g4 = (mode == 4);

  while (i < n) {
    const uint32_t c = d.cp[i];
    const uint8_t f = d.fl[i];
    int64_t j = -1;

    // contractions: '(?i:[sdmt]|ll|ve|re)  (GPT-2: case-sensitive exact)
    if (c == '\'' && i + 1 < n) {
      if (g4) {
        const uint8_t f1 = d.fl[i + 1];
        if (f1 & FLAG_C1) {
          j = i + 2;
        } else if (i + 2 < n) {
          const uint8_t f2 = d.fl[i + 2];
          if (((f1 & FLAG_CI_L) && (f2 & FLAG_CI_L)) ||
              ((f1 & FLAG_CI_V) && (f2 & FLAG_CI_E)) ||
              ((f1 & FLAG_CI_R) && (f2 & FLAG_CI_E)))
            j = i + 3;
        }
      } else {
        const uint32_t c1 = d.cp[i + 1];
        if (c1 == 's' || c1 == 'd' || c1 == 'm' || c1 == 't') {
          j = i + 2;
        } else if (i + 2 < n) {
          const uint32_t c2 = d.cp[i + 2];
          if ((c1 == 'l' && c2 == 'l') || (c1 == 'v' && c2 == 'e') ||
              (c1 == 'r' && c2 == 'e'))
            j = i + 3;
        }
      }
    }

    // letters (GPT-4: [^\r\n\p{L}\p{N}]?+ \p{L}+ ; GPT-2: " "? \p{L}+)
    if (j < 0) {
      if (f & FLAG_L) {
        int64_t k2 = i + 1;
        while (k2 < n && (d.fl[k2] & FLAG_L)) ++k2;
        j = k2;
      } else {
        bool opt_ok = g4 ? (!is_crlf(c) && !(f & FLAG_N)) : (c == ' ');
        if (opt_ok && i + 1 < n && (d.fl[i + 1] & FLAG_L)) {
          int64_t k2 = i + 2;
          while (k2 < n && (d.fl[k2] & FLAG_L)) ++k2;
          j = k2;
        }
      }
    }

    // numbers (GPT-4: \p{N}{1,3} ; GPT-2: " "? \p{N}+)
    if (j < 0) {
      if (g4) {
        if (f & FLAG_N) {
          int64_t k2 = i + 1;
          while (k2 < n && k2 < i + 3 && (d.fl[k2] & FLAG_N)) ++k2;
          j = k2;
        }
      } else {
        int64_t k2 = (c == ' ') ? i + 1 : i;
        if (k2 < n && (d.fl[k2] & FLAG_N)) {
          ++k2;
          while (k2 < n && (d.fl[k2] & FLAG_N)) ++k2;
          j = k2;
        }
      }
    }

    // punctuation (GPT-4: " "? [^\s\p{L}\p{N}]++ [\r\n]* ; GPT-2 without
    // the CR/LF suffix)
    if (j < 0) {
      int64_t k2 = (c == ' ' && i + 1 < n) ? i + 1 : i;
      if (k2 < n && !(d.fl[k2] & FLAG_WLN)) {
        ++k2;
        while (k2 < n && !(d.fl[k2] & FLAG_WLN)) ++k2;
        if (g4)
          while (k2 < n && is_crlf(d.cp[k2])) ++k2;
        j = k2;
      }
    }

    // whitespace families
    if (j < 0 && (f & FLAG_WS)) {
      int64_t k2 = i + 1;
      while (k2 < n && (d.fl[k2] & FLAG_WS)) ++k2;
      int64_t last_nl = -1;
      if (g4) {
        for (int64_t m = k2 - 1; m >= i; --m) {
          if (is_crlf(d.cp[m])) { last_nl = m; break; }
        }
      }
      if (last_nl >= 0) j = last_nl + 1;       // \s*[\r\n]
      else if (k2 == n) j = k2;                // \s+(?!\S) at end
      else if (k2 - i >= 2) j = k2 - 1;        // \s+(?!\S) mid-text
      else j = k2;                             // \s+
    }

    if (j < 0) return -1;  // cannot happen: alternatives cover all chars
    if (count >= cap) return -2;
    out[count++] = d.off[j];
    i = j;
  }
  return count;
}

}  // extern "C"
