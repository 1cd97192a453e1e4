// SHA-256 of 64-byte blocks on Hopper (sm_90a): the pair hash of SSZ
// Merkleization, as two kernels that share one compression function.
//
// Replaces the JAX package's two XLA hashing programs (jitted jnp code, not
// Pallas kernels), word for word:
//
//   sha256_pairs_kernel        lighthouse_tpu/ops/sha256_device.py:135
//                              _sha256_64byte_batch: (n, 16) big-endian
//                              message words -> (n, 8) digest words, the
//                              SHA-256 of each 64-byte block (the data block,
//                              then the constant padding block of a 64-byte
//                              message);
//   tree_hash_subtrees_kernel  lighthouse_tpu/ops/tree_hash.py:176
//                              _tree_hash_subtrees: (m, 32, 8) leaf words ->
//                              all five interior levels of each 32-leaf
//                              subtree, (m, 16, 8), (m, 8, 8), (m, 4, 8),
//                              (m, 2, 8) and (m, 1, 8), in one launch.
//
// What bounds it on an H100: integer operations.  One 64-byte block costs
// two compressions.  In the instruction forms the card has (a rotation is
// one funnel shift, a three-input XOR or the choose / majority function one
// LOP3, two additions one IADD3) a round is 14 operations and a message
// schedule step 10, so the data block's compression is 64 x 14 + 48 x 10 +
// 8 = 1,384 operations; the padding block's schedule is the same for every
// message, so its compression is 64 x 14 + 8 = 904.  That is 2,288
// operations against 96 bytes of device memory (64 in, 32 out): 23.8 per
// byte.  The card issues 64 such 32-bit integer operations per clock per SM
// on 132 SMs against 3.35 TB/s, a balance of 5 per byte at 1.98 GHz, so the
// work is bound by operations, about 4.8 times over.  A subtree hashes 31
// blocks against 2,016 bytes (1,024 in, 992 out): bound by operations too.
//
// What the design does about it: nothing is spent that the arithmetic does
// not need.  The compression (sha256_compress.cuh) is fully unrolled, so the
// message schedule is a ring of 16 words in registers, every index a
// constant, and every round constant an operand from the constant bank;
// rotations are single funnel shifts (__funnelshift_r).  The padding
// block's words are literals, so the
// compiler folds its whole message schedule away.  One thread hashes one
// 64-byte block in sha256_pairs_kernel (16-byte loads and stores, a bounds
// check for the ragged last block of threads).  In tree_hash_subtrees_kernel
// a group of 16 threads owns one subtree, 8 subtrees to a block: the block's
// leaves come into shared memory with coalesced 16-byte loads, then 16, 8,
// 4, 2 and 1 threads of each group hash the five levels, with __syncthreads
// between levels, nodes going back and forth between two shared buffers and
// every interior node written out.  Lanes idle as the levels narrow (31
// hashes over 5 x 16 thread slots), which a later version can win back by
// giving a thread several subtrees' upper levels.  A group whose subtree
// lies past the end of the batch hashes nothing but reaches every barrier.
// SHA-256 has no tensor-core form: all of it runs on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_compress.cuh"

namespace {

constexpr int PAIR_THREADS = 256;      // sha256_pairs_kernel: blocks per CUDA block
constexpr int SUB_LEAVES = 32;         // leaves of a subtree
constexpr int SUB_DEPTH = 5;           // interior levels of a subtree
constexpr int GROUP = 16;              // threads per subtree
constexpr int SUBS_PER_BLOCK = 8;      // subtrees per CUDA block
constexpr int TREE_THREADS = GROUP * SUBS_PER_BLOCK;

// SHA-256 of one 64-byte message given as 16 big-endian words (`w` is
// overwritten): the data block, then the constant padding block (0x80, zeros,
// the bit length 512).
__device__ __forceinline__ void hash_block(uint32_t w[16], uint32_t st[8]) {
  sha256_init(st);
  compress(st, w);
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 512u};
  compress(st, pad);
}

// out[i] = SHA-256(words[i]) for n rows of 16 words: one thread a row.
__global__ void __launch_bounds__(PAIR_THREADS)
sha256_pairs_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out, long long n) {
  const long long row = (long long)blockIdx.x * PAIR_THREADS + threadIdx.x;
  if (row >= n) return;
  const uint4* src = reinterpret_cast<const uint4*>(words + row * 16);
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = src[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  uint32_t st[8];
  hash_block(w, st);
  uint4* dst = reinterpret_cast<uint4*>(out + row * 8);
  dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
  dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// The five interior levels of m subtrees of 32 leaves (8 words each).  `out`
// holds the levels one after the other, each subtree's nodes contiguous:
// level d (width 16 >> d) starts at word m * 8 * (32 - 2 * width).
__global__ void __launch_bounds__(TREE_THREADS)
tree_hash_subtrees_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ out,
                          long long m) {
  __shared__ __align__(16) uint32_t bufa[SUBS_PER_BLOCK * SUB_LEAVES * 8];
  __shared__ __align__(16) uint32_t bufb[SUBS_PER_BLOCK * SUB_LEAVES / 2 * 8];
  const int tid = threadIdx.x, s = tid / GROUP, lane = tid % GROUP;
  const long long first = (long long)blockIdx.x * SUBS_PER_BLOCK;
  const long long sub = first + s;
  const long long left = m - first;
  const int live = left < SUBS_PER_BLOCK ? (int)left : SUBS_PER_BLOCK;
  // The block's live subtrees are contiguous in `leaves`: consecutive
  // threads load consecutive 16 bytes.
  const uint4* src = reinterpret_cast<const uint4*>(leaves + first * SUB_LEAVES * 8);
  uint4* dst = reinterpret_cast<uint4*>(bufa);
  for (int q = tid; q < live * SUB_LEAVES * 2; q += TREE_THREADS) dst[q] = src[q];
  __syncthreads();
  uint32_t* in = bufa + s * SUB_LEAVES * 8;
  uint32_t* next = bufb + s * SUB_LEAVES / 2 * 8;
  long long level_base = 0;
#pragma unroll 1
  for (int d = 0; d < SUB_DEPTH; ++d) {
    const int width = (SUB_LEAVES / 2) >> d;
    if (sub < m && lane < width) {
      const uint4* pair = reinterpret_cast<const uint4*>(in + lane * 16);
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = pair[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      uint32_t st[8];
      hash_block(w, st);
      const uint4 lo = make_uint4(st[0], st[1], st[2], st[3]);
      const uint4 hi = make_uint4(st[4], st[5], st[6], st[7]);
      uint4* node = reinterpret_cast<uint4*>(next + lane * 8);
      node[0] = lo;
      node[1] = hi;
      uint4* dev = reinterpret_cast<uint4*>(out + level_base + (sub * width + lane) * 8);
      dev[0] = lo;
      dev[1] = hi;
    }
    __syncthreads();
    // The level just written is the next one's input; the buffer it was
    // read from is free once every group has passed the barrier.
    uint32_t* t = in;
    in = next;
    next = t;
    level_base += m * width * 8;
  }
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

}  // namespace

extern "C" {

// The entry points act on the calling thread's current device, on `stream`,
// and return the launch's cudaError_t (0 when nothing is to be done).

// out[i] = SHA-256 of the 64-byte block words[i] (16 big-endian words), for
// n rows; out holds n x 8 words.
int lt_sha256_pairs(const uint32_t* words, uint32_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  sha256_pairs_kernel<<<blocks(n, PAIR_THREADS), PAIR_THREADS, 0, (cudaStream_t)stream>>>(words, out, n);
  return (int)cudaGetLastError();
}

// The five interior levels of m 32-leaf subtrees (leaves: m x 32 x 8 words);
// out holds m x 31 x 8 words, level after level (see the kernel).
int lt_tree_hash_subtrees(const uint32_t* leaves, uint32_t* out, long long m, void* stream) {
  if (m <= 0) return 0;
  tree_hash_subtrees_kernel<<<blocks(m, SUBS_PER_BLOCK), TREE_THREADS, 0, (cudaStream_t)stream>>>(leaves, out, m);
  return (int)cudaGetLastError();
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
