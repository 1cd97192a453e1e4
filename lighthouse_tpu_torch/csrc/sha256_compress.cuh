// The SHA-256 compression function on Hopper (sm_90a), shared by the port's
// CUDA sources that hash: sha256.cu (the pair hash and the fused subtree
// kernel) and shuffle.cu (the proposer walk's one-block digests).
//
// The compression is fully unrolled, so the message schedule is a ring of 16
// words in registers, every index a constant, and every round constant an
// operand from the constant bank; rotations are single funnel shifts
// (__funnelshift_r).  A round is 14 32-bit integer operations and a message
// schedule step 10 in the instruction forms the card has (a rotation one
// funnel shift, a three-input XOR or the choose / majority function one LOP3,
// two additions one IADD3): 64 x 14 + 48 x 10 + 8 = 1,384 operations a
// compression, 904 where the schedule is constant and folds away.
//
// Each source that includes this header gets its own copy of the table and
// the functions (an anonymous namespace): the sources are built into
// separate libraries.

#pragma once

#include <stdint.h>

namespace {

__constant__ uint32_t K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// One compression of the 16 message words `w` (used as the schedule ring,
// so overwritten) into the state `st`.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      // w[i] = w[i-16] + s0(w[i-15]) + w[i-7] + s1(w[i-2]); the ring's slot
      // i & 15 holds w[i-16] until it is overwritten here.
      const uint32_t w1 = w[(i - 15) & 15], w14 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3);
      const uint32_t s1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        K[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The SHA-256 initial hash value.
__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u;
  st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu;
  st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu;
  st[7] = 0x5be0cd19u;
}

}  // namespace
