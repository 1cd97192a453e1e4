// Batched SHA-256 for SSZ Merkleization: one call hashes N consecutive
// 64-byte blocks into N 32-byte digests (the "hash pairs" primitive every
// Merkle layer reduces with).  The hot loop lives in C so per-hash cost is
// the compression function, not interpreter overhead — the role the
// reference fills with ethereum_hashing's assembly/SIMD sha2 backends
// (reference: common crate `ethereum_hashing`, Cargo.toml:119).
//
// Strategy: dlopen the system libcrypto (whose SHA256 dispatches to SHA-NI
// on this hardware) and fall back to a portable scalar implementation when
// it is absent.  Large batches are split across a few worker threads.

#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

typedef unsigned char *(*sha256_fn)(const unsigned char *, size_t,
                                    unsigned char *);

static sha256_fn g_openssl_sha256 = nullptr;
static bool g_has_shani = false;
static std::once_flag g_resolve_once;

// ctypes releases the GIL, so first calls can race here — call_once makes
// backend selection safe and visible to all threads.
static void resolve_backends_impl() {
#if defined(__x86_64__)
  unsigned a, b, c, d;
  if (__get_cpuid_count(7, 0, &a, &b, &c, &d)) g_has_shani = (b >> 29) & 1;
#endif
  if (g_has_shani) return;  // fastest path, no libcrypto needed
  // OpenSSL 3.x one-shot SHA256() pays an EVP fetch per call (~10x slower
  // than the compression itself for 64-byte inputs) — it is only the
  // fallback when SHA-NI is absent, still beating the scalar loop.
  const char *names[] = {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"};
  for (const char *name : names) {
    void *handle = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
    if (!handle) continue;
    void *sym = dlsym(handle, "SHA256");
    if (sym) {
      g_openssl_sha256 = reinterpret_cast<sha256_fn>(sym);
      return;
    }
  }
}

// ----------------------------------------------------------- scalar fallback

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void compress(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(block[4 * i]) << 24) | (uint32_t(block[4 * i + 1]) << 16) |
           (uint32_t(block[4 * i + 2]) << 8) | uint32_t(block[4 * i + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

static void sha256_64byte_scalar(const uint8_t *in, uint8_t *out) {
  uint32_t state[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  compress(state, in);
  // Padding block for an exactly-64-byte message: 0x80, zeros, bit length 512.
  uint8_t pad[64] = {0};
  pad[0] = 0x80;
  pad[62] = 0x02;  // 512 = 0x0200 big-endian in the final 8 bytes
  compress(state, pad);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(state[i] >> 24);
    out[4 * i + 1] = uint8_t(state[i] >> 16);
    out[4 * i + 2] = uint8_t(state[i] >> 8);
    out[4 * i + 3] = uint8_t(state[i]);
  }
}

// ------------------------------------------------------------ SHA-NI path

#if defined(__x86_64__)
// Canonical Intel SHA-NI two-rounds-per-instruction schedule (the same
// dataflow OpenSSL/blst's asm uses); processes one 64-byte block.
__attribute__((target("sha,sse4.1,ssse3")))
static inline void shani_block(__m128i &STATE0, __m128i &STATE1,
                               const __m128i W_in[4]) {
  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;
  __m128i MSGS[4] = {W_in[0], W_in[1], W_in[2], W_in[3]};
  __m128i MSG;
  for (int r = 0; r < 16; r++) {
    MSG = _mm_add_epi32(MSGS[r & 3],
                        _mm_loadu_si128(reinterpret_cast<const __m128i *>(&K[4 * r])));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    if (r < 12) {
      __m128i s = _mm_sha256msg1_epu32(MSGS[r & 3], MSGS[(r + 1) & 3]);
      s = _mm_add_epi32(s, _mm_alignr_epi8(MSGS[(r + 3) & 3], MSGS[(r + 2) & 3], 4));
      MSGS[r & 3] = _mm_sha256msg2_epu32(s, MSGS[(r + 3) & 3]);
    }
  }
  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
}

__attribute__((target("sha,sse4.1,ssse3")))
static void hash_range_shani(const uint8_t *in, uint8_t *out, uint64_t begin,
                             uint64_t end) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  // Initial state packed as ABEF / CDGH (sha256rnds2's register layout).
  const __m128i INIT0 = _mm_set_epi32(0x6a09e667, 0xbb67ae85, 0x510e527f, 0x9b05688c);
  const __m128i INIT1 = _mm_set_epi32(0x3c6ef372, 0xa54ff53a, 0x1f83d9ab, 0x5be0cd19);
  // Constant padding block for an exactly-64-byte message (big-endian words).
  const __m128i PAD0 = _mm_set_epi32(0, 0, 0, int(0x80000000));
  const __m128i PADZ = _mm_setzero_si128();
  const __m128i PAD3 = _mm_set_epi32(512, 0, 0, 0);
  const __m128i PAD[4] = {PAD0, PADZ, PADZ, PAD3};
  for (uint64_t i = begin; i < end; i++) {
    const uint8_t *block = in + 64 * i;
    __m128i W[4];
    for (int j = 0; j < 4; j++)
      W[j] = _mm_shuffle_epi8(
          _mm_loadu_si128(reinterpret_cast<const __m128i *>(block + 16 * j)), MASK);
    __m128i S0 = INIT0, S1 = INIT1;
    shani_block(S0, S1, W);
    shani_block(S0, S1, PAD);
    // Unpack ABEF/CDGH back to a..h big-endian bytes.
    uint32_t st[8];
    alignas(16) uint32_t abef[4], cdgh[4];
    _mm_store_si128(reinterpret_cast<__m128i *>(abef), S0);
    _mm_store_si128(reinterpret_cast<__m128i *>(cdgh), S1);
    st[0] = abef[3]; st[1] = abef[2]; st[4] = abef[1]; st[5] = abef[0];
    st[2] = cdgh[3]; st[3] = cdgh[2]; st[6] = cdgh[1]; st[7] = cdgh[0];
    uint8_t *dst = out + 32 * i;
    for (int j = 0; j < 8; j++) {
      dst[4 * j] = uint8_t(st[j] >> 24);
      dst[4 * j + 1] = uint8_t(st[j] >> 16);
      dst[4 * j + 2] = uint8_t(st[j] >> 8);
      dst[4 * j + 3] = uint8_t(st[j]);
    }
  }
}
#endif

// -------------------------------------------------------------- entry point

static void hash_range(const uint8_t *in, uint8_t *out, uint64_t begin,
                       uint64_t end) {
#if defined(__x86_64__)
  if (g_has_shani) {
    hash_range_shani(in, out, begin, end);
    return;
  }
#endif
  if (g_openssl_sha256) {
    for (uint64_t i = begin; i < end; i++)
      g_openssl_sha256(in + 64 * i, 64, out + 32 * i);
  } else {
    for (uint64_t i = begin; i < end; i++)
      sha256_64byte_scalar(in + 64 * i, out + 32 * i);
  }
}

extern "C" int hash_pairs(const uint8_t *in, uint64_t nblocks, uint8_t *out) {
  std::call_once(g_resolve_once, resolve_backends_impl);
  const uint64_t kParallelThreshold = 8192;
  unsigned hw = std::thread::hardware_concurrency();
  if (nblocks < kParallelThreshold || hw < 2) {
    hash_range(in, out, 0, nblocks);
    return 0;
  }
  unsigned nthreads = hw < 8 ? hw : 8;
  std::vector<std::thread> threads;
  uint64_t chunk = (nblocks + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; t++) {
    uint64_t begin = t * chunk;
    uint64_t end = begin + chunk < nblocks ? begin + chunk : nblocks;
    if (begin >= end) break;
    threads.emplace_back(hash_range, in, out, begin, end);
  }
  for (auto &th : threads) th.join();
  return 0;
}
