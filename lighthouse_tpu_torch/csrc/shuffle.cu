// The epoch boundary's two walks on Hopper (sm_90a): the whole-list
// swap-or-not shuffle and the per-slot proposer candidate walk.
//
// Replaces two of the JAX package's XLA epoch programs (jitted jnp code, not
// Pallas kernels), bit for bit:
//
//   shuffle_round_kernel   lighthouse_tpu/ops/shuffle_device.py:112
//                          _shuffle_kernel (body _shuffle_core :93): one
//                          swap-or-not round over every lane of a registry
//                          bucket, launched once per round (R rounds, 90 on
//                          mainnet, 10 on the minimal preset);
//   proposer_walk_kernel   lighthouse_tpu/ops/shuffle_device.py:186
//                          _proposer_kernel (body _proposer_core :119): the
//                          spec's compute_shuffled_index walk of each
//                          (slot, candidate) lane through R rounds, hashing
//                          the round's 37-byte `seed | round | chunk_le`
//                          message as one padded SHA-256 block on the card.
//
// The fused boundary (shuffle_device.py:192 _boundary_kernel) is a PyTorch
// program around both (lighthouse_tpu_torch/ops/shuffle_device.py).
//
// What bounds them on an H100.  A shuffle round reads each lane's value and
// its partner's (a[flip]), one digest bit and writes the lane back: 8 bytes a
// lane of device memory counted once each way (4 in, 4 out) plus an eighth of
// a byte of digest, against a handful of integer operations (a floored
// 32-bit modulo, a max, a shift and a select), so a round is bound by bytes:
// at 2^20 lanes about 8.5 MB a round, 2.5 us at 3.35 TB/s.  Every round
// gathers across the whole array (a[flip] can be any lane), and the 4 MB
// array does not fit in one SM's shared memory, so a round is one launch and
// the rounds go through two buffers in turn, in device memory (the 50 MB L2
// holds both).  The proposer walk is bound by operations: each lane hashes
// one block a round, 1,384 operations for the compression
// (sha256_compress.cuh), so a mainnet epoch's 32 slots x 64 candidates x 90
// rounds is 255 M operations, 0.015 ms at 64 operations a clock on 132 SMs at
// 1.98 GHz.  With only 2,048 lanes (64 warps) it cannot fill the card's 528
// warp schedulers; each lane's 90 x 64 SHA rounds are one dependent chain.
//
// What the design does about it: the simple version, right first.  The
// shuffle is one thread a lane, 256 threads a block, each round a launch
// that reads the old buffer and writes the new one, so a round needs no
// synchronisation inside it (the pairs (lane, flip) are symmetric within a
// round, and every lane reads the values the round started from).
// Round rows arrive host-reversed (shuffle_tables), so launch r reads row r.
// The digest byte covering `position` is byte `position >> 3` of the round's
// flat row.  `flip = (pivot - lane) mod n_live` is a floored modulo: C's `%`
// truncates, and `pivot - lane` goes negative, on pad lanes past n_live too
// (their swap is masked off, but their reads must stay in the row).  The
// walk is one thread a (slot, candidate) lane, 32 threads a block so the 64
// blocks of a mainnet epoch land on 64 SMs; the seed is 8 message words in
// registers, words 8, 9 and 15 carry the round, the chunk and the length,
// and the digest word holding the bit is picked with a select chain rather
// than a dynamic index (which would spill the state to local memory).
// Acceptance (eff * 255 >= max_eb * random_byte, the first accepted
// candidate) stays in PyTorch.  Fusing the 90 rounds into one launch (a
// grid-wide barrier between rounds) is later work.
//
// Values are int32 indices; SHA words are int32 tensors that carry the same
// bits as uint32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_compress.cuh"

namespace {

constexpr int SHUFFLE_THREADS = 256;   // lanes per CUDA block, a round
constexpr int WALK_THREADS = 32;       // (slot, candidate) lanes per CUDA block

// One swap-or-not round: out[lane] = in[flip] where the round's bit at
// max(lane, flip) is set and lane < n_live, else in[lane].
__global__ void __launch_bounds__(SHUFFLE_THREADS)
shuffle_round_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                     const int32_t* __restrict__ pivots, const uint8_t* __restrict__ row,
                     int round, int n_live, int nb) {
  const int lane = blockIdx.x * SHUFFLE_THREADS + threadIdx.x;
  if (lane >= nb) return;
  const int n_mod = n_live > 1 ? n_live : 1;
  int flip = (pivots[round] - lane) % n_mod;
  if (flip < 0) flip += n_mod;
  const int position = lane > flip ? lane : flip;
  const int bit = (row[position >> 3] >> (position & 7)) & 1;
  out[lane] = (bit && lane < n_live) ? in[flip] : in[lane];
}

// The candidate walk of s_count x k lanes through `rounds` rounds: lane
// (s, c) starts at position c mod m_live and ends where the spec's
// compute_shuffled_index(c mod m_live, m_live, seed_s) does.
__global__ void __launch_bounds__(WALK_THREADS)
proposer_walk_kernel(const uint32_t* __restrict__ seed_words, const int32_t* __restrict__ pivots,
                     int32_t* __restrict__ out, int s_count, int rounds, int k, int m_live) {
  const int lane = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (lane >= s_count * k) return;
  const int s = lane / k, c = lane % k;
  const int m_mod = m_live > 1 ? m_live : 1;
  uint32_t seed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) seed[i] = seed_words[s * 8 + i];
  int idx = c % m_mod;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int flip = (pivots[s * rounds + r] + m_mod - idx) % m_mod;
    const int position = idx > flip ? idx : flip;
    // 37-byte message `seed(32) | round(1) | chunk_le(4)` in one padded
    // block: word 8 = round | chunk bytes 0-2, word 9 = chunk byte 3 | the
    // 0x80 terminator, word 15 = the bit length 296.
    const uint32_t chunk = (uint32_t)position >> 8;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = seed[i];
    w[8] = ((uint32_t)r << 24) | ((chunk & 0xFFu) << 16) | (((chunk >> 8) & 0xFFu) << 8) |
           ((chunk >> 16) & 0xFFu);
    w[9] = (((chunk >> 24) & 0xFFu) << 24) | 0x00800000u;
#pragma unroll
    for (int i = 10; i < 15; ++i) w[i] = 0;
    w[15] = 296u;
    uint32_t st[8];
    sha256_init(st);
    compress(st, w);
    const int byte_idx = (position & 255) >> 3;
    const int word_idx = byte_idx >> 2;
    uint32_t word = st[0];
#pragma unroll
    for (int q = 1; q < 8; ++q) word = word_idx == q ? st[q] : word;
    const uint32_t byte = (word >> ((3 - (byte_idx & 3)) * 8)) & 0xFFu;
    if ((byte >> (position & 7)) & 1u) idx = flip;
  }
  out[lane] = idx;
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

}  // namespace

extern "C" {

// The entry points act on the calling thread's current device, on `stream`,
// and return the first failing launch's cudaError_t (0 when all launched).

// `rounds` swap-or-not rounds over nb lanes of `values` into `out`, through
// `scratch` (nb words): launch r reads round r's pivot and its row of
// `row_bytes` digest bytes.  The launches alternate between the two buffers
// so that the last one writes `out`; with no rounds `values` is copied.
int lt_shuffle_rounds(const int32_t* values, int32_t* out, int32_t* scratch, const int32_t* pivots,
                      const uint8_t* digests, long long row_bytes, int rounds, int n_live, int nb,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb <= 0) return 0;
  if (rounds <= 0) {
    return (int)cudaMemcpyAsync(out, values, (size_t)nb * sizeof(int32_t), cudaMemcpyDeviceToDevice, st);
  }
  const int32_t* src = values;
  for (int r = 0; r < rounds; ++r) {
    int32_t* dst = ((rounds - 1 - r) % 2 == 0) ? out : scratch;
    shuffle_round_kernel<<<blocks(nb, SHUFFLE_THREADS), SHUFFLE_THREADS, 0, st>>>(src, dst, pivots, digests + (long long)r * row_bytes, r, n_live, nb);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

// The candidate walk: out holds s_count x k final positions.
int lt_proposer_walk(const uint32_t* seed_words, const int32_t* pivots, int32_t* out, int s_count,
                     int rounds, int k, int m_live, void* stream) {
  if (s_count <= 0 || k <= 0) return 0;
  proposer_walk_kernel<<<blocks((long long)s_count * k, WALK_THREADS), WALK_THREADS, 0, (cudaStream_t)stream>>>(seed_words, pivots, out, s_count, rounds, k, m_live);
  return (int)cudaGetLastError();
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
