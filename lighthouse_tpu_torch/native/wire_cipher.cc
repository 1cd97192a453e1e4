// The wire's ciphers: ChaCha20-Poly1305 (RFC 8439) for Noise transport
// frames, AES-128 in CTR mode for discv5's masked headers and AES-128-GCM
// (NIST SP 800-38D) for discv5's messages.
//
// Plain, portable C++17 with a C interface for ctypes: no assembly, no
// intrinsics, no other library.  Built with g++ at first use by
// ``native/__init__.py``, which holds the Python API.  The AES here is
// byte-oriented with a table S-box and GHASH is the bitwise multiply of
// SP 800-38D's Algorithm 1: both are correct and simple, not hardened
// against cache-timing side channels, and made for the wire's small
// frames, not for bulk data.  Tag comparisons are constant-time.
//
// Return codes: 0 for success, -1 where a tag does not verify (the
// output is then zeroed).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline uint32_t load32_le(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline void store32_le(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}

inline void store64_le(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = uint8_t(v >> (8 * i));
}

inline uint64_t load64_be(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = v << 8 | p[i];
  return v;
}

inline void store64_be(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = uint8_t(v >> (56 - 8 * i));
}

bool equal_ct(const uint8_t* a, const uint8_t* b, size_t n) {
  uint8_t d = 0;
  for (size_t i = 0; i < n; ++i) d |= a[i] ^ b[i];
  return d == 0;
}

// ------------------------------------------------------------- ChaCha20

inline uint32_t rotl32(uint32_t v, int c) { return v << c | v >> (32 - c); }

#define QUARTER(a, b, c, d)                 \
  a += b; d ^= a; d = rotl32(d, 16);        \
  c += d; b ^= c; b = rotl32(b, 12);        \
  a += b; d ^= a; d = rotl32(d, 8);         \
  c += d; b ^= c; b = rotl32(b, 7);

void chacha20_block(const uint8_t key[32], uint32_t counter, const uint8_t nonce[12],
                    uint8_t out[64]) {
  uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u};
  for (int i = 0; i < 8; ++i) s[4 + i] = load32_le(key + 4 * i);
  s[12] = counter;
  for (int i = 0; i < 3; ++i) s[13 + i] = load32_le(nonce + 4 * i);
  uint32_t x[16];
  std::memcpy(x, s, sizeof x);
  for (int i = 0; i < 10; ++i) {
    QUARTER(x[0], x[4], x[8], x[12]);
    QUARTER(x[1], x[5], x[9], x[13]);
    QUARTER(x[2], x[6], x[10], x[14]);
    QUARTER(x[3], x[7], x[11], x[15]);
    QUARTER(x[0], x[5], x[10], x[15]);
    QUARTER(x[1], x[6], x[11], x[12]);
    QUARTER(x[2], x[7], x[8], x[13]);
    QUARTER(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) store32_le(out + 4 * i, x[i] + s[i]);
}

#undef QUARTER

void chacha20_xor(const uint8_t key[32], uint32_t counter, const uint8_t nonce[12],
                  const uint8_t* in, uint64_t len, uint8_t* out) {
  uint8_t block[64];
  for (uint64_t off = 0; off < len; off += 64, ++counter) {
    chacha20_block(key, counter, nonce, block);
    uint64_t n = len - off < 64 ? len - off : 64;
    for (uint64_t i = 0; i < n; ++i) out[off + i] = in[off + i] ^ block[i];
  }
}

// ------------------------------------------------------------- Poly1305
// poly1305-donna's 32-bit form: five 26-bit limbs.  The AEAD pads its AD
// and ciphertext to 16 bytes with zeros, so every block is a full one.

struct Poly1305 {
  uint32_t r[5], h[5] = {0, 0, 0, 0, 0}, pad[4];

  explicit Poly1305(const uint8_t key[32]) {
    r[0] = load32_le(key + 0) & 0x3ffffff;
    r[1] = (load32_le(key + 3) >> 2) & 0x3ffff03;
    r[2] = (load32_le(key + 6) >> 4) & 0x3ffc0ff;
    r[3] = (load32_le(key + 9) >> 6) & 0x3f03fff;
    r[4] = (load32_le(key + 12) >> 8) & 0x00fffff;
    for (int i = 0; i < 4; ++i) pad[i] = load32_le(key + 16 + 4 * i);
  }

  void block(const uint8_t m[16]) {
    const uint32_t s1 = r[1] * 5, s2 = r[2] * 5, s3 = r[3] * 5, s4 = r[4] * 5;
    uint32_t h0 = h[0] + (load32_le(m + 0) & 0x3ffffff);
    uint32_t h1 = h[1] + ((load32_le(m + 3) >> 2) & 0x3ffffff);
    uint32_t h2 = h[2] + ((load32_le(m + 6) >> 4) & 0x3ffffff);
    uint32_t h3 = h[3] + ((load32_le(m + 9) >> 6) & 0x3ffffff);
    uint32_t h4 = h[4] + ((load32_le(m + 12) >> 8) | (1u << 24));
    uint64_t d0 = uint64_t(h0) * r[0] + uint64_t(h1) * s4 + uint64_t(h2) * s3 +
                  uint64_t(h3) * s2 + uint64_t(h4) * s1;
    uint64_t d1 = uint64_t(h0) * r[1] + uint64_t(h1) * r[0] + uint64_t(h2) * s4 +
                  uint64_t(h3) * s3 + uint64_t(h4) * s2;
    uint64_t d2 = uint64_t(h0) * r[2] + uint64_t(h1) * r[1] + uint64_t(h2) * r[0] +
                  uint64_t(h3) * s4 + uint64_t(h4) * s3;
    uint64_t d3 = uint64_t(h0) * r[3] + uint64_t(h1) * r[2] + uint64_t(h2) * r[1] +
                  uint64_t(h3) * r[0] + uint64_t(h4) * s4;
    uint64_t d4 = uint64_t(h0) * r[4] + uint64_t(h1) * r[3] + uint64_t(h2) * r[2] +
                  uint64_t(h3) * r[1] + uint64_t(h4) * r[0];
    uint32_t c = uint32_t(d0 >> 26);
    h0 = uint32_t(d0) & 0x3ffffff;
    d1 += c; c = uint32_t(d1 >> 26); h1 = uint32_t(d1) & 0x3ffffff;
    d2 += c; c = uint32_t(d2 >> 26); h2 = uint32_t(d2) & 0x3ffffff;
    d3 += c; c = uint32_t(d3 >> 26); h3 = uint32_t(d3) & 0x3ffffff;
    d4 += c; c = uint32_t(d4 >> 26); h4 = uint32_t(d4) & 0x3ffffff;
    h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
    h1 += c;
    h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
  }

  // ``data`` as full blocks, the last one padded with zeros.
  void padded(const uint8_t* data, uint64_t len) {
    uint64_t full = len & ~uint64_t(15);
    for (uint64_t off = 0; off < full; off += 16) block(data + off);
    if (len > full) {
      uint8_t last[16] = {0};
      std::memcpy(last, data + full, len - full);
      block(last);
    }
  }

  void finish(uint8_t tag[16]) {
    uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4], c;
    c = h1 >> 26; h1 &= 0x3ffffff;
    h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
    h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
    h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
    h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
    h1 += c;
    // h + -p: select it where it does not underflow.
    uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h4 + c - (1u << 26);
    uint32_t mask = (g4 >> 31) - 1;
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & mask);
    h3 = (h3 & ~mask) | (g3 & mask);
    h4 = (h4 & ~mask) | (g4 & mask);
    uint32_t w0 = h0 | h1 << 26, w1 = h1 >> 6 | h2 << 20;
    uint32_t w2 = h2 >> 12 | h3 << 14, w3 = h3 >> 18 | h4 << 8;
    uint64_t f = uint64_t(w0) + pad[0];
    store32_le(tag + 0, uint32_t(f));
    f = uint64_t(w1) + pad[1] + (f >> 32);
    store32_le(tag + 4, uint32_t(f));
    f = uint64_t(w2) + pad[2] + (f >> 32);
    store32_le(tag + 8, uint32_t(f));
    f = uint64_t(w3) + pad[3] + (f >> 32);
    store32_le(tag + 12, uint32_t(f));
  }
};

// RFC 8439 section 2.8: the tag over AD, ciphertext and their lengths,
// keyed by the first 32 bytes of ChaCha20's block 0.
void chacha_poly_tag(const uint8_t key[32], const uint8_t nonce[12], const uint8_t* ad,
                     uint64_t ad_len, const uint8_t* ct, uint64_t ct_len, uint8_t tag[16]) {
  uint8_t block0[64];
  chacha20_block(key, 0, nonce, block0);
  Poly1305 mac(block0);
  mac.padded(ad, ad_len);
  mac.padded(ct, ct_len);
  uint8_t lengths[16];
  store64_le(lengths, ad_len);
  store64_le(lengths + 8, ct_len);
  mac.block(lengths);
  mac.finish(tag);
}

// ------------------------------------------------------------------ AES

struct AesTables {
  uint8_t sbox[256];

  AesTables() {
    // FIPS-197's S-box: the multiplicative inverse in GF(2^8), then the
    // affine map; p walks the group by multiplying by 3, q by dividing.
    uint8_t p = 1, q = 1;
    do {
      p = uint8_t(p ^ (p << 1) ^ (p & 0x80 ? 0x1b : 0));
      q ^= uint8_t(q << 1);
      q ^= uint8_t(q << 2);
      q ^= uint8_t(q << 4);
      if (q & 0x80) q ^= 0x09;
      uint8_t x = uint8_t(q ^ rotl8(q, 1) ^ rotl8(q, 2) ^ rotl8(q, 3) ^ rotl8(q, 4));
      sbox[p] = uint8_t(x ^ 0x63);
    } while (p != 1);
    sbox[0] = 0x63;
  }

  static uint8_t rotl8(uint8_t v, int c) { return uint8_t(v << c | v >> (8 - c)); }
};

const AesTables& tables() {
  static const AesTables t;
  return t;
}

inline uint8_t xtime(uint8_t v) { return uint8_t(v << 1 ^ (v & 0x80 ? 0x1b : 0)); }

struct Aes128 {
  uint8_t rk[176];

  explicit Aes128(const uint8_t key[16]) {
    const uint8_t* sbox = tables().sbox;
    std::memcpy(rk, key, 16);
    uint8_t rcon = 1;
    for (int i = 4; i < 44; ++i) {
      uint8_t t[4];
      std::memcpy(t, rk + 4 * (i - 1), 4);
      if (i % 4 == 0) {
        uint8_t t0 = t[0];
        t[0] = uint8_t(sbox[t[1]] ^ rcon);
        t[1] = sbox[t[2]];
        t[2] = sbox[t[3]];
        t[3] = sbox[t0];
        rcon = xtime(rcon);
      }
      for (int j = 0; j < 4; ++j) rk[4 * i + j] = rk[4 * (i - 4) + j] ^ t[j];
    }
  }

  // The state is the 16 bytes in input order: byte r + 4c is row r of
  // column c.
  void encrypt(const uint8_t in[16], uint8_t out[16]) const {
    const uint8_t* sbox = tables().sbox;
    uint8_t s[16], t[16];
    for (int i = 0; i < 16; ++i) s[i] = in[i] ^ rk[i];
    for (int round = 1; round <= 10; ++round) {
      for (int c = 0; c < 4; ++c)  // SubBytes and ShiftRows
        for (int r = 0; r < 4; ++r) t[r + 4 * c] = sbox[s[r + 4 * ((c + r) & 3)]];
      if (round < 10) {
        for (int c = 0; c < 4; ++c) {  // MixColumns
          uint8_t* a = t + 4 * c;
          uint8_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3], all = a0 ^ a1 ^ a2 ^ a3;
          a[0] = a0 ^ all ^ xtime(a0 ^ a1);
          a[1] = a1 ^ all ^ xtime(a1 ^ a2);
          a[2] = a2 ^ all ^ xtime(a2 ^ a3);
          a[3] = a3 ^ all ^ xtime(a3 ^ a0);
        }
      }
      for (int i = 0; i < 16; ++i) s[i] = t[i] ^ rk[16 * round + i];
    }
    std::memcpy(out, s, 16);
  }
};

// CTR over a 16-byte counter block; ``width`` is how many of its low
// bytes count (16 for the ``cryptography`` package's CTR mode, 4 for
// GCM's inc32).
void aes_ctr(const Aes128& aes, const uint8_t iv[16], int width, const uint8_t* in,
             uint64_t len, uint8_t* out) {
  uint8_t counter[16], ks[16];
  std::memcpy(counter, iv, 16);
  for (uint64_t off = 0; off < len; off += 16) {
    aes.encrypt(counter, ks);
    uint64_t n = len - off < 16 ? len - off : 16;
    for (uint64_t i = 0; i < n; ++i) out[off + i] = in[off + i] ^ ks[i];
    for (int i = 15; i >= 16 - width; --i)
      if (++counter[i] != 0) break;
  }
}

// ----------------------------------------------------------------- GHASH

struct Ghash {
  uint64_t h_hi, h_lo, y_hi = 0, y_lo = 0;

  explicit Ghash(const uint8_t h[16]) : h_hi(load64_be(h)), h_lo(load64_be(h + 8)) {}

  // Y = (Y ^ X) * H in GF(2^128), SP 800-38D Algorithm 1.
  void block(const uint8_t x[16]) {
    uint64_t x_hi = y_hi ^ load64_be(x), x_lo = y_lo ^ load64_be(x + 8);
    uint64_t z_hi = 0, z_lo = 0, v_hi = h_hi, v_lo = h_lo;
    for (int i = 0; i < 128; ++i) {
      uint64_t bit = i < 64 ? x_hi >> (63 - i) & 1 : x_lo >> (127 - i) & 1;
      uint64_t take = 0 - bit;
      z_hi ^= v_hi & take;
      z_lo ^= v_lo & take;
      uint64_t reduce = 0 - (v_lo & 1);
      v_lo = v_lo >> 1 | v_hi << 63;
      v_hi = v_hi >> 1 ^ (0xe100000000000000ull & reduce);
    }
    y_hi = z_hi;
    y_lo = z_lo;
  }

  void padded(const uint8_t* data, uint64_t len) {
    uint64_t full = len & ~uint64_t(15);
    for (uint64_t off = 0; off < full; off += 16) block(data + off);
    if (len > full) {
      uint8_t last[16] = {0};
      std::memcpy(last, data + full, len - full);
      block(last);
    }
  }

  void lengths(uint64_t a_bytes, uint64_t b_bytes) {
    uint8_t l[16];
    store64_be(l, a_bytes * 8);
    store64_be(l + 8, b_bytes * 8);
    block(l);
  }

  void out(uint8_t s[16]) const {
    store64_be(s, y_hi);
    store64_be(s + 8, y_lo);
  }
};

// J0 of SP 800-38D section 7.1 and the tag E(K, J0) ^ GHASH(A, C).
void gcm_j0(const uint8_t h[16], const uint8_t* iv, uint64_t iv_len, uint8_t j0[16]) {
  if (iv_len == 12) {
    std::memcpy(j0, iv, 12);
    j0[12] = j0[13] = j0[14] = 0;
    j0[15] = 1;
    return;
  }
  Ghash g(h);
  g.padded(iv, iv_len);
  g.lengths(0, iv_len);
  g.out(j0);
}

void gcm_tag(const Aes128& aes, const uint8_t h[16], const uint8_t j0[16], const uint8_t* ad,
             uint64_t ad_len, const uint8_t* ct, uint64_t ct_len, uint8_t tag[16]) {
  Ghash g(h);
  g.padded(ad, ad_len);
  g.padded(ct, ct_len);
  g.lengths(ad_len, ct_len);
  uint8_t s[16], ek[16];
  g.out(s);
  aes.encrypt(j0, ek);
  for (int i = 0; i < 16; ++i) tag[i] = s[i] ^ ek[i];
}

struct Gcm {
  Aes128 aes;
  uint8_t h[16], j0[16], first[16];

  Gcm(const uint8_t key[16], const uint8_t* iv, uint64_t iv_len) : aes(key) {
    const uint8_t zero[16] = {0};
    aes.encrypt(zero, h);
    gcm_j0(h, iv, iv_len, j0);
    std::memcpy(first, j0, 16);
    for (int i = 15; i >= 12; --i)
      if (++first[i] != 0) break;
  }
};

}  // namespace

extern "C" {

// out: ciphertext || tag (pt_len + 16 bytes).
int wc_chacha20_poly1305_seal(const uint8_t* key, const uint8_t* nonce, const uint8_t* ad,
                              uint64_t ad_len, const uint8_t* pt, uint64_t pt_len, uint8_t* out) {
  chacha20_xor(key, 1, nonce, pt, pt_len, out);
  chacha_poly_tag(key, nonce, ad, ad_len, out, pt_len, out + pt_len);
  return 0;
}

// in: ciphertext || tag (ct_len >= 16); out: ct_len - 16 bytes.
int wc_chacha20_poly1305_open(const uint8_t* key, const uint8_t* nonce, const uint8_t* ad,
                              uint64_t ad_len, const uint8_t* in, uint64_t in_len, uint8_t* out) {
  if (in_len < 16) return -1;
  uint64_t n = in_len - 16;
  uint8_t tag[16];
  chacha_poly_tag(key, nonce, ad, ad_len, in, n, tag);
  if (!equal_ct(tag, in + n, 16)) {
    std::memset(out, 0, n);
    return -1;
  }
  chacha20_xor(key, 1, nonce, in, n, out);
  return 0;
}

// The ``cryptography`` package's CTR mode: the whole 16-byte IV is the
// counter block, incremented as one big-endian integer.
int wc_aes128_ctr(const uint8_t* key, const uint8_t* iv, const uint8_t* in, uint64_t len,
                  uint8_t* out) {
  Aes128 aes(key);
  aes_ctr(aes, iv, 16, in, len, out);
  return 0;
}

// out: ciphertext || tag (pt_len + 16 bytes).
int wc_aes128_gcm_seal(const uint8_t* key, const uint8_t* iv, uint64_t iv_len, const uint8_t* ad,
                       uint64_t ad_len, const uint8_t* pt, uint64_t pt_len, uint8_t* out) {
  Gcm gcm(key, iv, iv_len);
  aes_ctr(gcm.aes, gcm.first, 4, pt, pt_len, out);
  gcm_tag(gcm.aes, gcm.h, gcm.j0, ad, ad_len, out, pt_len, out + pt_len);
  return 0;
}

// in: ciphertext || tag (in_len >= 16); out: in_len - 16 bytes.
int wc_aes128_gcm_open(const uint8_t* key, const uint8_t* iv, uint64_t iv_len, const uint8_t* ad,
                       uint64_t ad_len, const uint8_t* in, uint64_t in_len, uint8_t* out) {
  if (in_len < 16) return -1;
  uint64_t n = in_len - 16;
  Gcm gcm(key, iv, iv_len);
  uint8_t tag[16];
  gcm_tag(gcm.aes, gcm.h, gcm.j0, ad, ad_len, in, n, tag);
  if (!equal_ct(tag, in + n, 16)) {
    std::memset(out, 0, n);
    return -1;
  }
  aes_ctr(gcm.aes, gcm.first, 4, in, n, out);
  return 0;
}

}  // extern "C"
