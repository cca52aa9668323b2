// pathway_tpu native runtime tier.
//
// The reference keeps its hot host-side paths in Rust (key hashing in
// src/engine/value.rs, arrangement consolidation in differential dataflow);
// here the equivalents are C++ behind a C ABI consumed via ctypes:
//   - 128-bit stable key hashing, batched over columns
//   - Z-set consolidation (sum diffs per key, drop zeros)
// Deterministic across processes/restarts (persistence + multi-worker
// exchange depend on it).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 128-bit hashing: two independently-seeded 64-bit mix lanes.
// Each lane is a murmur3-style stream mixer with strong finalizer.
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

struct HashState {
  uint64_t a, b;
};

static inline void hs_init(HashState* s, uint64_t seed) {
  s->a = 0x9e3779b97f4a7c15ULL ^ seed;
  s->b = 0xbf58476d1ce4e5b9ULL ^ (seed * 0x94d049bb133111ebULL + 1);
}

static inline void hs_update_u64(HashState* s, uint64_t v) {
  s->a = mix64(s->a ^ v) * 0x2545f4914f6cdd1dULL;
  s->b = mix64(s->b + v + 0x165667b19e3779f9ULL);
}

static inline void hs_update_bytes(HashState* s, const uint8_t* data, uint64_t len) {
  uint64_t i = 0;
  while (i + 8 <= len) {
    uint64_t v;
    std::memcpy(&v, data + i, 8);
    hs_update_u64(s, v);
    i += 8;
  }
  uint64_t tail = 0;
  uint64_t rem = len - i;
  if (rem) {
    std::memcpy(&tail, data + i, rem);
    hs_update_u64(s, tail ^ (rem << 56));
  }
  hs_update_u64(s, len ^ 0xa5a5a5a5a5a5a5a5ULL);
}

static inline void hs_final(HashState* s, uint64_t* hi, uint64_t* lo) {
  *hi = mix64(s->a ^ (s->b >> 32));
  *lo = mix64(s->b ^ (s->a << 17) ^ 0x27d4eb2f165667c5ULL);
}

// hash one byte buffer -> 128 bits
void pw_hash128(const uint8_t* data, uint64_t len, uint64_t seed,
                uint64_t* hi, uint64_t* lo) {
  HashState s;
  hs_init(&s, seed);
  hs_update_bytes(&s, data, len);
  hs_final(&s, hi, lo);
}

// Batch-hash n rows built from k columns.
// Column kinds: 0 = int64 (values: int64[n]), 1 = float64 (float64[n]),
// 2 = bytes (concatenated buffer + offsets int64[n+1]).
// For each row: lanes absorb a per-column type tag then the value.
void pw_hash_rows(uint64_t n, uint64_t k,
                  const int32_t* kinds,
                  const void** values,
                  const int64_t** offsets,  // per column, only for kind 2
                  uint64_t seed,
                  uint64_t* out_hi, uint64_t* out_lo) {
  for (uint64_t i = 0; i < n; ++i) {
    HashState s;
    hs_init(&s, seed);
    for (uint64_t c = 0; c < k; ++c) {
      hs_update_u64(&s, 0x1000 + (uint64_t)kinds[c]);
      switch (kinds[c]) {
        case 0: {
          const int64_t* col = (const int64_t*)values[c];
          hs_update_u64(&s, (uint64_t)col[i]);
          break;
        }
        case 1: {
          const double* col = (const double*)values[c];
          uint64_t v;
          std::memcpy(&v, &col[i], 8);
          hs_update_u64(&s, v);
          break;
        }
        case 2: {
          const uint8_t* buf = (const uint8_t*)values[c];
          const int64_t* off = offsets[c];
          hs_update_bytes(&s, buf + off[i], (uint64_t)(off[i + 1] - off[i]));
          break;
        }
      }
    }
    hs_final(&s, &out_hi[i], &out_lo[i]);
  }
}

// ---------------------------------------------------------------------------
// Z-set consolidation: sum diffs per (key_hi, key_lo, row_tag); write the
// surviving entries' first-occurrence index and net diff.
// Returns number of surviving entries.
// ---------------------------------------------------------------------------

struct K128 {
  uint64_t hi, lo, tag;
  bool operator==(const K128& o) const {
    return hi == o.hi && lo == o.lo && tag == o.tag;
  }
};

struct K128Hash {
  size_t operator()(const K128& k) const {
    return (size_t)mix64(k.hi ^ mix64(k.lo) ^ (k.tag * 0x9e3779b97f4a7c15ULL));
  }
};

int64_t pw_consolidate(uint64_t n,
                       const uint64_t* key_hi, const uint64_t* key_lo,
                       const uint64_t* row_tag, const int64_t* diffs,
                       int64_t* out_index, int64_t* out_diff) {
  std::unordered_map<K128, std::pair<int64_t, int64_t>, K128Hash> acc;
  acc.reserve(n * 2);
  for (uint64_t i = 0; i < n; ++i) {
    K128 k{key_hi[i], key_lo[i], row_tag[i]};
    auto it = acc.find(k);
    if (it == acc.end()) {
      acc.emplace(k, std::make_pair((int64_t)i, diffs[i]));
    } else {
      it->second.second += diffs[i];
    }
  }
  // preserve first-occurrence order
  std::vector<std::pair<int64_t, int64_t>> entries;
  entries.reserve(acc.size());
  for (auto& kv : acc) {
    if (kv.second.second != 0) entries.push_back(kv.second);
  }
  struct ByIndex {
    bool operator()(const std::pair<int64_t, int64_t>& a,
                    const std::pair<int64_t, int64_t>& b) const {
      return a.first < b.first;
    }
  };
  std::sort(entries.begin(), entries.end(), ByIndex());
  int64_t m = 0;
  for (auto& e : entries) {
    out_index[m] = e.first;
    out_diff[m] = e.second;
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693), 16-byte digest, no key — bit-identical to Python's
// hashlib.blake2b(data, digest_size=16).  This is the CANONICAL row-key
// hash (internals/value.py hash_values); batching it here removes the
// per-row interpreter cost of key derivation for typed columns.
// ---------------------------------------------------------------------------

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

struct B2BState {
  uint64_t h[8];
  uint8_t buf[128];
  uint64_t buflen;
  uint64_t t;  // total bytes compressed (fits 64 bits for our inputs)
};

static void b2b_compress(B2BState* S, const uint8_t* block, int last) {
  uint64_t m[16], v[16];
  std::memcpy(m, block, 128);
  for (int i = 0; i < 8; ++i) v[i] = S->h[i];
  for (int i = 0; i < 8; ++i) v[i + 8] = B2B_IV[i];
  v[12] ^= S->t;
  // v[13] ^= t_hi (always 0 here)
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = B2B_SIGMA[r];
#define B2B_G(a, b, c, d, x, y)                       \
  do {                                                \
    v[a] = v[a] + v[b] + (x);                         \
    v[d] = rotr64(v[d] ^ v[a], 32);                   \
    v[c] = v[c] + v[d];                               \
    v[b] = rotr64(v[b] ^ v[c], 24);                   \
    v[a] = v[a] + v[b] + (y);                         \
    v[d] = rotr64(v[d] ^ v[a], 16);                   \
    v[c] = v[c] + v[d];                               \
    v[b] = rotr64(v[b] ^ v[c], 63);                   \
  } while (0)
    B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
#undef B2B_G
  }
  for (int i = 0; i < 8; ++i) S->h[i] ^= v[i] ^ v[i + 8];
}

static void b2b16_init(B2BState* S) {
  for (int i = 0; i < 8; ++i) S->h[i] = B2B_IV[i];
  S->h[0] ^= 0x01010000ULL ^ 16ULL;  // digest_len=16, fanout=1, depth=1
  S->buflen = 0;
  S->t = 0;
}

static void b2b16_update(B2BState* S, const uint8_t* data, uint64_t len) {
  while (len > 0) {
    if (S->buflen == 128) {
      S->t += 128;
      b2b_compress(S, S->buf, 0);
      S->buflen = 0;
    }
    uint64_t take = 128 - S->buflen;
    if (take > len) take = len;
    std::memcpy(S->buf + S->buflen, data, take);
    S->buflen += take;
    data += take;
    len -= take;
  }
}

static void b2b16_final(B2BState* S, uint64_t* hi, uint64_t* lo) {
  S->t += S->buflen;
  std::memset(S->buf + S->buflen, 0, 128 - S->buflen);
  b2b_compress(S, S->buf, 1);
  // digest = first 16 bytes of h, little-endian; Python's
  // int.from_bytes(d, "little") => lo = bytes 0..7, hi = bytes 8..15
  *lo = S->h[0];
  *hi = S->h[1];
}

// _ser's minimal signed little-endian int encoding (internals/value.py):
// nb = (bit_length + 8) // 8 + 1 bytes of two's complement.
static inline uint64_t ser_int(uint8_t* out, int64_t v) {
  // Python: (-x).bit_length() == x.bit_length(); for INT64_MIN abs is 2^63
  int bl;
  if (v == INT64_MIN) {
    bl = 64;
  } else {
    uint64_t av = v < 0 ? (uint64_t)(-v) : (uint64_t)v;
    bl = av == 0 ? 0 : 64 - __builtin_clzll(av);
  }
  uint64_t nb = (uint64_t)(bl + 8) / 8 + 1;
  unsigned __int128 tv = (unsigned __int128)(__int128)v;  // sign-extended
  for (uint64_t i = 0; i < nb; ++i) {
    out[i] = (uint8_t)(tv >> (8 * i));
  }
  return nb;
}

// Batched ref_scalar over typed columns — serialization identical to
// internals/value.py _ser for the supported kinds:
//   kind 0: int64   -> 'I' + minimal signed LE bytes
//   kind 1: float64 -> 'f' + 8 LE IEEE bytes ('f'+"nan" for NaN)
//   kind 2: utf-8   -> 'S' + len(8 LE) + bytes   (values+offsets arrays)
void pw_ref_scalar_rows(uint64_t n, uint64_t k, const int32_t* kinds,
                        const void* const* values,
                        const int64_t* const* offsets,
                        uint64_t* out_hi, uint64_t* out_lo) {
  std::vector<uint8_t> buf;
  for (uint64_t r = 0; r < n; ++r) {
    buf.clear();
    for (uint64_t c = 0; c < k; ++c) {
      if (kinds[c] == 0) {
        int64_t v = ((const int64_t*)values[c])[r];
        uint8_t tmp[16];
        buf.push_back('I');
        uint64_t nb = ser_int(tmp, v);
        buf.insert(buf.end(), tmp, tmp + nb);
      } else if (kinds[c] == 1) {
        double v = ((const double*)values[c])[r];
        buf.push_back('f');
        if (v != v) {
          buf.push_back('n'); buf.push_back('a'); buf.push_back('n');
        } else {
          uint8_t tmp[8];
          std::memcpy(tmp, &v, 8);
          buf.insert(buf.end(), tmp, tmp + 8);
        }
      } else {
        const uint8_t* base = (const uint8_t*)values[c];
        int64_t start = offsets[c][r], end = offsets[c][r + 1];
        uint64_t len = (uint64_t)(end - start);
        buf.push_back('S');
        for (int i = 0; i < 8; ++i) buf.push_back((uint8_t)(len >> (8 * i)));
        buf.insert(buf.end(), base + start, base + end);
      }
    }
    B2BState S;
    b2b16_init(&S);
    b2b16_update(&S, buf.data(), buf.size());
    b2b16_final(&S, &out_hi[r], &out_lo[r]);
  }
}

// Auto-row keys: blake2b16 of _ser("#row") + _ser(i) for i in
// [start, start+n) — the memoized fill loop's native tier.
void pw_auto_row_keys(int64_t start, uint64_t n,
                      uint64_t* out_hi, uint64_t* out_lo) {
  // prefix: 'S' + (4 as 8 LE bytes) + "#row" + 'I'
  uint8_t prefix[14] = {'S', 4, 0, 0, 0, 0, 0, 0, 0, '#', 'r', 'o', 'w', 'I'};
  uint8_t buf[32];
  std::memcpy(buf, prefix, 14);
  for (uint64_t j = 0; j < n; ++j) {
    uint64_t nb = ser_int(buf + 14, start + (int64_t)j);
    B2BState S;
    b2b16_init(&S);
    b2b16_update(&S, buf, 14 + nb);
    b2b16_final(&S, &out_hi[j], &out_lo[j]);
  }
}

}  // extern "C"
