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
// one block a round (sha256_compress.cuh), and since the block's rounds 0-7
// and schedule words W16 .. W22 read only the slot's seed, a round needs 56
// rounds and 41 schedule steps, 56 x 14 + 41 x 10 + 8 = 1,202 operations,
// beside 8 x 14 + 7 x 10 = 182 once a slot.  A mainnet epoch's 32 slots x
// 64 candidates x 90 rounds is 221.6 M operations, 0.0132 ms at 64
// operations a clock on 132 SMs at 1.98 GHz.  That bound is out of reach: each lane's 90 rounds are one
// dependent chain, and a warp alone runs its compression at its scheduler's
// integer rate (16 lanes a clock), so a compression is ~1.2 us however idle
// the card.  The walk's floor is its chain: ceil(R / lookahead) steps of one
// compression each.
//
// What the design does about it.  The shuffle is one thread a lane, 256
// threads a block, each round a launch that reads the old buffer and writes
// the new one, so a round needs no synchronisation inside it (the pairs
// (lane, flip) are symmetric within a round, and every lane reads the values
// the round started from).  A launch covers a block of lanes, `count` from
// `offset`, and reads the whole list: the unsharded shuffle launches offset 0
// and count nb, a shard of the device mesh its own block, one round a launch
// (lt_shuffle_round_block), the blocks gathered into the whole list on every
// member before the next round (ops/shuffle_device.py).  Round rows arrive
// host-reversed (shuffle_tables), so launch r reads row r.  The digest byte covering
// `position` is byte `position >> 3` of the round's flat row.
// `flip = (pivot - lane) mod n_live` is a floored modulo: C's `%` truncates,
// and `pivot - lane` goes negative, on pad lanes past n_live too (their swap
// is masked off, but their reads must stay in the row).
//
// The walk takes work out of the chain, then shortens it.  Rounds 0-7 of
// every compression read only the seed, and schedule words W16 .. W22 read
// no word 8, so each block computes its slot's midstate and those words once
// (slot_prefix) and every compression starts at round 8 (56 rounds and 41
// schedule steps instead of 64 and 48).  The slot's pivots sit in shared
// memory, reduced mod m_live as they are loaded, so the flip in the chain
// needs no modulo.  Then
// each lane is walked by a group of 2^k - 1 threads, k rounds a step
// (proposer_walk_kernel): they hash every position the lane can hold over
// the next k rounds at once, and the chain is ceil(R / k) compressions.  On
// an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py [timing]) the 32 x 64
// lanes x 90 rounds took 0.1122 ms at k = 1 (one thread a round, the
// earlier design 0.1267 ms), 0.0592 at k = 2, 0.0411 at k = 3 and 0.0579
// at k = 4; one lane alone took 0.1120, 0.0592, 0.0409 and 0.0320 ms.  So
// up to k = 3 (4 groups a warp, 512 one-warp blocks for 528 schedulers) the
// walk runs at its latency floor, and k = 4 (1,024 warps) is bound by the
// schedulers' issue instead: WALK_LOOKAHEAD is 3.  The digest word holding
// the bit is picked with a select chain rather than a dynamic index (which
// would spill the state to local memory).  Acceptance (eff * 255 >=
// max_eb * random_byte, the first accepted candidate) stays in PyTorch.
//
// Values are int32 indices; SHA words are int32 tensors that carry the same
// bits as uint32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_compress.cuh"

namespace {

constexpr int SHUFFLE_THREADS = 256;   // lanes per CUDA block, a round
constexpr int WALK_THREADS = 32;       // proposer_walk_kernel: one warp a CUDA block
constexpr int WALK_MAX_ROUNDS = 256;   // the round is one byte of the message
constexpr int WALK_LOOKAHEAD = 3;      // rounds resolved a step on the main path
constexpr unsigned FULL_WARP = 0xffffffffu;

// One swap-or-not round over the block of `count` lanes from `offset`:
// out[lane - offset] = in[flip] where the round's bit at max(lane, flip) is
// set and lane < n_live, else in[lane].  `in` is the whole list (a partner
// lane can sit anywhere in it); the whole-list round is offset 0, count nb.
__global__ void __launch_bounds__(SHUFFLE_THREADS)
shuffle_round_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                     const int32_t* __restrict__ pivots, const uint8_t* __restrict__ row,
                     int round, int n_live, int offset, int count) {
  const int i = blockIdx.x * SHUFFLE_THREADS + threadIdx.x;
  if (i >= count) return;
  const int lane = offset + i;
  const int n_mod = n_live > 1 ? n_live : 1;
  int flip = (pivots[round] - lane) % n_mod;
  if (flip < 0) flip += n_mod;
  const int position = lane > flip ? lane : flip;
  const int bit = (row[position >> 3] >> (position & 7)) & 1;
  out[i] = (bit && lane < n_live) ? in[flip] : in[lane];
}

// A slot's part of every round's message: the SHA-256 state after rounds
// 0-7 (which read only the seed, words 0-7), then the schedule words that
// read no word 8: W16 .. W22 and the seed's W7 (in ring slots 0 .. 7).
struct SlotPrefix {
  uint32_t mid[8];
  uint32_t ring[8];
};

__device__ void slot_prefix(const uint32_t* __restrict__ seed, SlotPrefix* out) {
  uint32_t w[23];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = seed[i];
  // Words 8-15 of `seed(32) | round(1) | chunk_le(4)` padded to one block;
  // word 8 (round and chunk) is read by none of W16 .. W22.
  w[8] = 0;
  w[9] = 0x00800000u;
#pragma unroll
  for (int i = 10; i < 15; ++i) w[i] = 0;
  w[15] = 296u;
#pragma unroll
  for (int i = 16; i < 23; ++i) {
    const uint32_t w1 = w[i - 15], w14 = w[i - 2];
    w[i] = w[i - 16] + (rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3)) + w[i - 7] +
           (rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10));
  }
  uint32_t v[8];
  sha256_init(v);
  compress_rounds<0, 8, 16>(v, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out->mid[i] = v[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) out->ring[i] = w[16 + i];
  out->ring[7] = w[7];
}

// Bit `position & 7` of byte (position & 255) >> 3 of
// SHA-256(seed | round | uint32_le(position >> 8)): rounds 8-63 of the
// one-block compression from the slot's midstate.  position < 2^31, so the
// chunk's top byte is 0 and word 9 is the constant 0x00800000.
__device__ __forceinline__ int digest_bit(const uint32_t mid[8], const uint32_t ring[8], int round,
                                          int position) {
  const uint32_t chunk = (uint32_t)position >> 8;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = ring[i];
  w[8] = ((uint32_t)round << 24) | ((chunk & 0xFFu) << 16) | (((chunk >> 8) & 0xFFu) << 8) |
         ((chunk >> 16) & 0xFFu);
  w[9] = 0x00800000u;
#pragma unroll
  for (int i = 10; i < 15; ++i) w[i] = 0;
  w[15] = 296u;
  uint32_t v[8], h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = mid[i];
  compress_rounds<8, 64, 23>(v, w);
  sha256_init(h);
  const int byte_idx = (position & 255) >> 3;
  const int word_idx = byte_idx >> 2;
  uint32_t word = v[0] + h[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) word = word_idx == q ? v[q] + h[q] : word;
  const uint32_t byte = (word >> ((3 - (byte_idx & 3)) * 8)) & 0xFFu;
  return (int)((byte >> (position & 7)) & 1u);
}

// The candidate walk of s_count x k lanes through `rounds` rounds: lane
// (s, c) starts at position c mod m_live and ends where the spec's
// compute_shuffled_index(c mod m_live, m_live, seed_s) does.
//
// A group of G = 2^LOOK - 1 threads walks one lane, LOOK rounds a step.
// Thread j of the group is node j of the step's binary tree in heap order:
// the node at depth l is the position the lane holds before round r + l
// when the bits of rounds r .. r + l - 1 are those of j + 1 below its
// leading one.  Each thread hashes its node's round (G independent
// compressions at once); one ballot gives every thread the group's bits,
// each resolves the path from the root in order, and one shuffle brings
// the lane's new position from the path's last node.  A block holds one
// slot's lanes (blocks_per_slot blocks a slot), so its prefix and pivots
// are made once, into shared memory, the pivots reduced mod m_live on the
// way (proposer_tables already reduces them; any int32 pivot gives the
// plain version's answer), so in the chain flip = pivot - position, plus m
// where negative.
template <int LOOK>
__global__ void __launch_bounds__(WALK_THREADS)
proposer_walk_kernel(const uint32_t* __restrict__ seed_words, const int32_t* __restrict__ pivots,
                     int32_t* __restrict__ out, int rounds, int k, int m_live, int blocks_per_slot) {
  constexpr int G = (1 << LOOK) - 1;
  constexpr int LANES = WALK_THREADS / G;
  __shared__ int32_t piv[WALK_MAX_ROUNDS];
  __shared__ SlotPrefix prefix;
  const int s = blockIdx.x / blocks_per_slot;
  const int tid = threadIdx.x;
  const int g = tid / G, j = tid - g * G;  // g == LANES: a spare thread past the last group
  const int c = (blockIdx.x - s * blocks_per_slot) * LANES + g;
  const int m_mod = m_live > 1 ? m_live : 1;
  for (int r = tid; r < rounds; r += WALK_THREADS) {
    const int p = pivots[(long long)s * rounds + r] % m_mod;
    piv[r] = p < 0 ? p + m_mod : p;
  }
  if (tid == 0) slot_prefix(seed_words + (long long)s * 8, &prefix);
  __syncthreads();
  uint32_t mid[8], ring[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mid[i] = prefix.mid[i];
    ring[i] = prefix.ring[i];
  }
  const int node1 = j + 1;
  int depth = 0;
  while ((node1 >> (depth + 1)) != 0) ++depth;
  const int first = (g < LANES ? g : 0) * G;  // the group's thread 0 (spares read group 0)
  int idx = c % m_mod;
#pragma unroll 1
  for (int r = 0; r < rounds; r += LOOK) {
    int p[LOOK];  // the step's pivots (past the last round: the last one's)
#pragma unroll
    for (int b = 0; b < LOOK; ++b) p[b] = piv[r + b < rounds ? r + b : rounds - 1];
    // This thread's node: the lane's position before round r + depth, and
    // that round's pivot.
    int pos = idx, pivot = p[0];
#pragma unroll
    for (int b = 0; b < LOOK - 1; ++b) {
      if (b < depth) {
        int flip = p[b] - pos;
        if (flip < 0) flip += m_mod;
        if ((node1 >> (depth - 1 - b)) & 1) pos = flip;
        pivot = p[b + 1];
      }
    }
    int flip = pivot - pos;
    if (flip < 0) flip += m_mod;
    // Nodes past the last round hash junk that no group reads.
    const int bit = digest_bit(mid, ring, r + depth, pos > flip ? pos : flip);
    // The group's bits, in heap order from bit 0 of `bits`: the path runs
    // from the root through the node each bit picks, and the lane moves to
    // where the last node on it sends it.
    const unsigned bits = __ballot_sync(FULL_WARP, bit) >> first;
    const int steps = rounds - r < LOOK ? rounds - r : LOOK;
    int node = 0;
#pragma unroll
    for (int b = 0; b < LOOK - 1; ++b) {
      if (b < steps - 1) node = 2 * node + 1 + (int)((bits >> node) & 1u);
    }
    idx = __shfl_sync(FULL_WARP, bit ? flip : pos, first + node);
  }
  if (g < LANES && j == 0 && c < k) out[(long long)s * k + c] = idx;
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

int launch_round(const int32_t* in, int32_t* out, const int32_t* pivots, const uint8_t* row,
                 int round, int n_live, int offset, int count, cudaStream_t stream) {
  shuffle_round_kernel<<<blocks(count, SHUFFLE_THREADS), SHUFFLE_THREADS, 0, stream>>>(in, out, pivots, row, round, n_live, offset, count);
  return (int)cudaGetLastError();
}

template <int LOOK>
int launch_walk(const uint32_t* seed_words, const int32_t* pivots, int32_t* out, int s_count,
                int rounds, int k, int m_live, cudaStream_t stream) {
  const int per_slot = (int)blocks(k, WALK_THREADS / ((1 << LOOK) - 1));
  const unsigned grid = (unsigned)s_count * per_slot;
  proposer_walk_kernel<LOOK><<<grid, WALK_THREADS, 0, stream>>>(seed_words, pivots, out, rounds, k, m_live, per_slot);
  return (int)cudaGetLastError();
}

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
    const int err = launch_round(src, dst, pivots, digests + (long long)r * row_bytes, r, n_live, 0, nb, st);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

// One swap-or-not round (pivots[0], digest row `row`) over the block of
// `count` lanes from `offset` of the whole nb-lane list `values`, into the
// `count` words of `out`: a mesh shard's part of a round, whose blocks the
// caller gathers into the whole list before the next round.
int lt_shuffle_round_block(const int32_t* values, int32_t* out, const int32_t* pivots,
                           const uint8_t* row, int n_live, int offset, int count, void* stream) {
  if (count <= 0) return 0;
  return launch_round(values, out, pivots, row, 0, n_live, offset, count, (cudaStream_t)stream);
}

// The candidate walk with `lookahead` (1-4) rounds a step: out holds
// s_count x k final positions.  For the tests and the card's timing; the
// main path takes lt_proposer_walk.
int lt_proposer_walk_k(const uint32_t* seed_words, const int32_t* pivots, int32_t* out,
                       int s_count, int rounds, int k, int m_live, int lookahead, void* stream) {
  if (s_count <= 0 || k <= 0) return 0;
  if (rounds < 0 || rounds > WALK_MAX_ROUNDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (lookahead) {
    case 1: return launch_walk<1>(seed_words, pivots, out, s_count, rounds, k, m_live, st);
    case 2: return launch_walk<2>(seed_words, pivots, out, s_count, rounds, k, m_live, st);
    case 3: return launch_walk<3>(seed_words, pivots, out, s_count, rounds, k, m_live, st);
    case 4: return launch_walk<4>(seed_words, pivots, out, s_count, rounds, k, m_live, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The candidate walk at WALK_LOOKAHEAD rounds a step.
int lt_proposer_walk(const uint32_t* seed_words, const int32_t* pivots, int32_t* out, int s_count,
                     int rounds, int k, int m_live, void* stream) {
  return lt_proposer_walk_k(seed_words, pivots, out, s_count, rounds, k, m_live, WALK_LOOKAHEAD,
                            stream);
}

// The lookahead lt_proposer_walk uses.
int lt_walk_lookahead(void) { return WALK_LOOKAHEAD; }

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
