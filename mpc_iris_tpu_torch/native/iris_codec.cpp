// Native codec/ETL core — C++ equivalents of the reference's Rust runtime paths:
//
//   - hex <-> bytes codec            (reference hex serde, src/bits.rs:74-93)
//   - streaming template JSON parse  (reference src/json_stream.rs + hex decode,
//                                     the ~20k templates/s bottleneck noted at
//                                     src/main.rs:312)
//   - template JSON render           (reference generate, src/main.rs:186-267)
//   - additive share split over Z_2^16 (reference EncodedBits::share,
//                                     src/encoded_bits.rs:22-38 — the prepare
//                                     hot loop, RNG-bound)
//   - wrapping share sum             (decrypt reconstruction, stubbed in the
//                                     reference at src/main.rs:687)
//   - packed-bit -> Z_2^16 encode    (reference encode, src/lib.rs:16-26)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All record sizes are fixed by the iris-code geometry: 1,600-byte bit planes,
// 12,800-element u16 vectors, 3,200 hex chars per plane.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBits = 12800;
constexpr int64_t kPlaneBytes = kBits / 8;     // 1600
constexpr int64_t kPlaneHex = kPlaneBytes * 2; // 3200

// ----------------------------------------------------------------- hex tables

alignas(64) uint8_t g_hex_val[256];
alignas(64) char g_hex_chr[513];
struct HexInit {
  HexInit() {
    memset(g_hex_val, 0xFF, sizeof(g_hex_val));
    for (int i = 0; i < 10; ++i) g_hex_val['0' + i] = i;
    for (int i = 0; i < 6; ++i) {
      g_hex_val['a' + i] = 10 + i;
      g_hex_val['A' + i] = 10 + i;
    }
    static const char d[] = "0123456789abcdef";
    for (int i = 0; i < 256; ++i) {
      g_hex_chr[2 * i] = d[i >> 4];
      g_hex_chr[2 * i + 1] = d[i & 15];
    }
  }
} g_hex_init;

inline int hex_decode_n(const uint8_t* in, int64_t n_bytes, uint8_t* out) {
  uint8_t bad = 0;
  for (int64_t i = 0; i < n_bytes; ++i) {
    uint8_t hi = g_hex_val[in[2 * i]];
    uint8_t lo = g_hex_val[in[2 * i + 1]];
    bad |= hi | lo;
    out[i] = (uint8_t)((hi << 4) | lo);
  }
  return (bad & 0x80) ? -1 : 0;
}

inline void hex_encode_n(const uint8_t* in, int64_t n_bytes, char* out) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    out[2 * i] = g_hex_chr[2 * in[i]];
    out[2 * i + 1] = g_hex_chr[2 * in[i] + 1];
  }
}

// ------------------------------------------------------------------- threads

int hw_threads() {
  // IRIS_NATIVE_THREADS overrides (the reference's global --threads knob,
  // src/main.rs:53-57; 0/unset = all cores).
  if (const char* e = getenv("IRIS_NATIVE_THREADS")) {
    int v = atoi(e);
    if (v > 0) return v;
  }
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 4;
}

template <typename F>
void parallel_rows(int64_t n, F&& fn) {
  int t = hw_threads();
  if (n < 2 * t) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int64_t lo = i * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

// -------------------------------------------------------------------- CSPRNG
// ChaCha20 (RFC 8439: 256-bit key, 96-bit nonce, 32-bit block counter) is the
// only randomness source for share material. The reference draws every share
// from a fresh-OS-seeded ChaCha-based CSPRNG (thread_rng, src/encoded_bits.rs:
// 27-33); we match that security level while keeping streams *addressable*:
// each (key, stream id, row) names an independent keystream, so output is
// byte-reproducible regardless of threading or batching, and two parties can
// derive identical pairwise streams for re-randomization. Keys must come from
// OS entropy (>=256 bits) on the Python side; a low-entropy key is only
// acceptable for explicitly-insecure testing.

inline uint32_t le32_load(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

struct ChaCha20 {
  uint32_t key[8];
  explicit ChaCha20(const uint8_t* k32) {
    for (int i = 0; i < 8; ++i) key[i] = le32_load(k32 + 4 * i);
  }
  static inline uint32_t rotl(uint32_t x, int k) {
    return (x << k) | (x >> (32 - k));
  }
  static inline void qr(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
    a += b; d ^= a; d = rotl(d, 16);
    c += d; b ^= c; b = rotl(b, 12);
    a += b; d ^= a; d = rotl(d, 8);
    c += d; b ^= c; b = rotl(b, 7);
  }
  // One 64-byte keystream block, serialized little-endian (RFC 8439 sec 2.3).
  void block(uint32_t counter, const uint32_t nonce[3], uint8_t out[64]) const {
    uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                      key[0], key[1], key[2], key[3],
                      key[4], key[5], key[6], key[7],
                      counter, nonce[0], nonce[1], nonce[2]};
    uint32_t x[16];
    memcpy(x, s, sizeof(s));
    for (int i = 0; i < 10; ++i) {
      qr(x[0], x[4], x[8], x[12]);
      qr(x[1], x[5], x[9], x[13]);
      qr(x[2], x[6], x[10], x[14]);
      qr(x[3], x[7], x[11], x[15]);
      qr(x[0], x[5], x[10], x[15]);
      qr(x[1], x[6], x[11], x[12]);
      qr(x[2], x[7], x[8], x[13]);
      qr(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; ++i) {
      uint32_t v = x[i] + s[i];
      out[4 * i] = (uint8_t)v;
      out[4 * i + 1] = (uint8_t)(v >> 8);
      out[4 * i + 2] = (uint8_t)(v >> 16);
      out[4 * i + 3] = (uint8_t)(v >> 24);
    }
  }
  // Fill `out` with `nbytes` keystream bytes starting at block `counter`.
  void stream(uint32_t counter, const uint32_t nonce[3], uint8_t* out,
              int64_t nbytes) const {
    while (nbytes >= 64) {
      block(counter++, nonce, out);
      out += 64;
      nbytes -= 64;
    }
    if (nbytes > 0) {
      uint8_t tmp[64];
      block(counter, nonce, tmp);
      memcpy(out, tmp, (size_t)nbytes);
    }
  }
};

// One row's worth of keystream as native u16 lanes (little-endian pairs; all
// supported hosts are little-endian, matching the <u2 file format).
constexpr int64_t kRowBytes = kBits * 2;  // 25,600 B = 400 ChaCha blocks

inline void row_nonce(uint32_t stream_id, int64_t row, uint32_t nonce[3]) {
  nonce[0] = stream_id;
  nonce[1] = (uint32_t)((uint64_t)row);
  nonce[2] = (uint32_t)(((uint64_t)row) >> 32);
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ hex codec

// hex (2*n chars) -> bytes (n). Returns 0, or -1 on a non-hex character.
int ic_hex_decode(const uint8_t* hex, int64_t n_bytes, uint8_t* out) {
  std::atomic<int> rc{0};  // written from worker threads
  parallel_rows(n_bytes, [&](int64_t lo, int64_t hi) {
    if (hex_decode_n(hex + 2 * lo, hi - lo, out + lo) != 0)
      rc.store(-1, std::memory_order_relaxed);
  });
  return rc.load();
}

// bytes (n) -> lowercase hex (2*n chars, no NUL).
void ic_hex_encode(const uint8_t* in, int64_t n_bytes, char* out) {
  parallel_rows(n_bytes, [&](int64_t lo, int64_t hi) {
    hex_encode_n(in + lo, hi - lo, out + 2 * lo);
  });
}

// ------------------------------------------------- streaming template parsing

namespace {

inline const uint8_t* skip_ws(const uint8_t* p, const uint8_t* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

// Parse `"key" : "<3200 hex>"`; advances p past the value's closing quote.
// Sets which_out: 0 = pattern, 1 = mask. Returns 1 ok, 0 need-more-data,
// -1 malformed.
int parse_field(const uint8_t*& p, const uint8_t* end, uint8_t* pat, uint8_t* msk,
                int* which_out) {
  p = skip_ws(p, end);
  if (p >= end) return 0;
  if (*p != '"') return -1;
  const uint8_t* key = ++p;
  while (p < end && *p != '"') ++p;
  if (p >= end) return 0;
  int64_t key_len = p - key;
  int which;
  if (key_len == 7 && memcmp(key, "pattern", 7) == 0) which = 0;
  else if (key_len == 4 && memcmp(key, "mask", 4) == 0) which = 1;
  else return -1;
  *which_out = which;
  ++p;
  p = skip_ws(p, end);
  if (p >= end) return 0;
  if (*p != ':') return -1;
  ++p;
  p = skip_ws(p, end);
  if (p >= end) return 0;
  if (*p != '"') return -1;
  ++p;
  if (end - p < kPlaneHex + 1) return 0;
  if (hex_decode_n(p, kPlaneBytes, which == 0 ? pat : msk) != 0) return -1;
  p += kPlaneHex;
  if (*p != '"') return -1;
  ++p;
  return 1;
}

}  // namespace

// Incremental parse of a JSON array of {"pattern": hex, "mask": hex} objects
// (field order free; whitespace free). Call repeatedly with growing buffers:
//   state: inout, 0 = expect '[', 1 = in array, 2 = finished
//   consumed: out, bytes consumed (always at an element boundary)
// Returns the number of templates written (<= max_out), or -1 on malformed
// input. Parsing pauses (returns with partial consumption) when the buffer ends
// mid-element or max_out is reached; resume with the unconsumed tail.
int64_t ic_parse_templates(const uint8_t* buf, int64_t len, int is_final,
                           uint8_t* patterns, uint8_t* masks, int64_t max_out,
                           int64_t* consumed, int* state) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int64_t count = 0;
  *consumed = 0;

  if (*state == 2) return 0;
  if (*state == 0) {
    p = skip_ws(p, end);
    if (p >= end) return is_final ? -1 : 0;
    if (*p != '[') return -1;
    ++p;
    *state = 1;
    *consumed = p - buf;
  }

  while (count < max_out) {
    const uint8_t* elem_start = p;
    p = skip_ws(p, end);
    if (p >= end) {
      if (is_final) return -1;  // array never closed
      break;
    }
    if (*p == ']') {
      ++p;
      *state = 2;
      *consumed = p - buf;
      return count;
    }
    if (*p == ',') {
      ++p;
      p = skip_ws(p, end);
      if (p >= end) {
        if (is_final) return -1;
        break;
      }
    }
    if (*p != '{') return -1;
    ++p;
    uint8_t* pat = patterns + count * kPlaneBytes;
    uint8_t* msk = masks + count * kPlaneBytes;
    int which = -1;
    bool seen[2] = {false, false};
    int rc = parse_field(p, end, pat, msk, &which);
    if (rc < 0) return -1;
    if (rc == 0) { p = elem_start; break; }
    seen[which] = true;
    p = skip_ws(p, end);
    if (p >= end) { p = elem_start; break; }
    if (*p != ',') return -1;
    ++p;
    rc = parse_field(p, end, pat, msk, &which);
    if (rc < 0) return -1;
    if (rc == 0) { p = elem_start; break; }
    if (seen[which]) return -1;  // duplicate key: the other plane would be
    seen[which] = true;          // uninitialized memory
    p = skip_ws(p, end);
    if (p >= end) { p = elem_start; break; }
    if (*p != '}') return -1;
    ++p;
    ++count;
    *consumed = p - buf;
  }
  return count;
}

// ------------------------------------------------------------------ rendering

// Bytes per rendered template in the pretty layout written by the Python side
// (json.dumps(obj, indent=2)): '{\n  "pattern": "<3200>",\n  "mask": "<3200>"\n}'
// = 2 + 14 + 3200 + 3 + 11 + 3200 + 3 = 6433, plus a 1-byte ',' separator
// between records.
constexpr int64_t kRenderRec = 6433;
int64_t ic_rendered_size(int64_t n) { return n == 0 ? 0 : n * kRenderRec + (n - 1); }

// Render n templates into `out` (size >= ic_rendered_size(n)), matching the
// Python writer byte-for-byte (comma-separated, no surrounding brackets).
// Returns bytes written.
int64_t ic_render_templates(const uint8_t* patterns, const uint8_t* masks,
                            int64_t n, char* out) {
  static const char head[] = "{\n  \"pattern\": \"";
  static const char mid[] = "\",\n  \"mask\": \"";
  static const char tail[] = "\"\n}";
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      char* o = out + i * (kRenderRec + 1);
      if (i > 0) *(o - 1) = ',';
      memcpy(o, head, sizeof(head) - 1); o += sizeof(head) - 1;
      hex_encode_n(patterns + i * kPlaneBytes, kPlaneBytes, o); o += kPlaneHex;
      memcpy(o, mid, sizeof(mid) - 1); o += sizeof(mid) - 1;
      hex_encode_n(masks + i * kPlaneBytes, kPlaneBytes, o); o += kPlaneHex;
      memcpy(o, tail, sizeof(tail) - 1);
    }
  });
  return ic_rendered_size(n);
}

// ------------------------------------------------------------------ sharing

// Raw ChaCha20 keystream (RFC 8439) — exported so tests can pin the generator
// against independent implementations and published test vectors.
void ic_chacha20_stream(const uint8_t* key32, uint32_t counter,
                        const uint8_t* nonce12, int64_t nbytes, uint8_t* out) {
  ChaCha20 c(key32);
  uint32_t nonce[3] = {le32_load(nonce12), le32_load(nonce12 + 4),
                       le32_load(nonce12 + 8)};
  c.stream(counter, nonce, out, nbytes);
}

// Additive share split over Z_2^16 (reference src/encoded_bits.rs:22-38):
// out[s] for s < n_shares-1 are uniform u16 ChaCha20 keystreams; the last
// share makes the column sums equal enc. Layout: enc [n, 12800] u16;
// out [n_shares, n, 12800]. The keystream for share s of global row R is
// ChaCha20(key, nonce=[s, R_lo, R_hi], counter from 0) => byte-reproducible
// independent of threading or batching, and cryptographically secure given a
// >=256-bit OS-entropy key (matches the reference's thread_rng CSPRNG,
// src/encoded_bits.rs:27-33).
void ic_share_split(const uint16_t* enc, int64_t n, int n_shares,
                    const uint8_t* key32, int64_t row_offset, uint16_t* out) {
  const int64_t stride = n * kBits;
  ChaCha20 c(key32);
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      uint16_t* last = out + (int64_t)(n_shares - 1) * stride + r * kBits;
      const uint16_t* e = enc + r * kBits;
      for (int64_t i = 0; i < kBits; ++i) last[i] = e[i];
      for (int s = 0; s < n_shares - 1; ++s) {
        uint32_t nonce[3];
        row_nonce((uint32_t)s, row_offset + r, nonce);
        uint16_t* o = out + (int64_t)s * stride + r * kBits;
        c.stream(0, nonce, (uint8_t*)o, kRowBytes);
        for (int64_t i = 0; i < kBits; ++i)
          last[i] = (uint16_t)(last[i] - o[i]);
      }
    }
  });
}

// Share re-randomization: add (sign=+1) or subtract (sign=-1) a deterministic
// pairwise keystream to a share matrix in place. Two parties holding the same
// pairwise 256-bit key apply opposite signs, so the added noise sums to zero
// across the party set and the reconstructed secrets are unchanged while each
// stored share is refreshed to a fresh uniform value. (The reference's
// specification notebook describes this as future work — "re-randomization via
// correlated PRNGs" — with no implementation.) The stream for global row R is
// ChaCha20(key, nonce=[0xFFFFFFFF, R_lo, R_hi]) — the stream id is disjoint
// from any share index, so a key reused across both operations still yields
// independent streams; observed noise values reveal nothing about other rows.
void ic_rerandomize(uint16_t* data, int64_t n, const uint8_t* key32, int sign,
                    int64_t row_offset) {
  ChaCha20 c(key32);
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    uint16_t ks[kBits];
    for (int64_t r = lo; r < hi; ++r) {
      uint32_t nonce[3];
      row_nonce(0xFFFFFFFFu, row_offset + r, nonce);
      c.stream(0, nonce, (uint8_t*)ks, kRowBytes);
      uint16_t* row = data + r * kBits;
      if (sign >= 0) {
        for (int64_t i = 0; i < kBits; ++i)
          row[i] = (uint16_t)(row[i] + ks[i]);
      } else {
        for (int64_t i = 0; i < kBits; ++i)
          row[i] = (uint16_t)(row[i] - ks[i]);
      }
    }
  });
}

// Wrapping u16 sum of n_shares buffers of n*12800 elements (decrypt /
// coordinator share aggregation, reference src/main.rs:598-611).
void ic_share_sum(const uint16_t* const* shares, int n_shares, int64_t n_elems,
                  uint16_t* out) {
  parallel_rows(n_elems, [&](int64_t lo, int64_t hi) {
    memcpy(out + lo, shares[0] + lo, (hi - lo) * sizeof(uint16_t));
    for (int s = 1; s < n_shares; ++s) {
      const uint16_t* src = shares[s];
      for (int64_t i = lo; i < hi; ++i) out[i] = (uint16_t)(out[i] + src[i]);
    }
  });
}

// ------------------------------------------------------------------ encoding

// Packed bit planes [n, 1600] -> ring encoding u16 [n, 12800]:
// enc = mask - 2*(pattern & mask) per bit, i.e. {0: unset, 1: set} under mask,
// 0 outside (reference src/lib.rs:16-26). Bit i = byte i/8, bit i%8 (LSB-first,
// reference src/bits.rs:44-57).
void ic_encode_u16(const uint8_t* patterns, const uint8_t* masks, int64_t n,
                   uint16_t* out) {
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* p = patterns + r * kPlaneBytes;
      const uint8_t* m = masks + r * kPlaneBytes;
      uint16_t* o = out + r * kBits;
      for (int64_t byte = 0; byte < kPlaneBytes; ++byte) {
        uint8_t pb = p[byte], mb = m[byte];
        for (int bit = 0; bit < 8; ++bit) {
          uint16_t mv = (mb >> bit) & 1;
          uint16_t pv = (pb >> bit) & 1;
          o[byte * 8 + bit] = (uint16_t)(mv - 2 * (pv & mv));
        }
      }
    }
  });
}

int ic_version() { return 2; }  // 2: ChaCha20 share/rerandomize streams

}  // extern "C"
