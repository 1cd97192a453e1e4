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
// not need, and every lane has a block to hash.  The compression
// (sha256_compress.cuh) is fully unrolled: the message schedule is a ring of
// 16 words in registers, every round constant an operand from the constant
// bank, every rotation one funnel shift, and the padding block's words are
// literals, so the compiler folds its whole schedule away.  One thread
// hashes one 64-byte block in sha256_pairs_kernel (16-byte loads and
// stores, a bounds check for the ragged last block of threads).
//
// tree_hash_subtrees_kernel: a subtree's levels need 16, 8, 4, 2 and 1
// hashes, and a warp issues a compression for all its lanes whatever its
// mask.  The first mapping (16 threads a subtree, a level at a time)
// filled 31 of 80 thread slots (38.75 %) and ran at 37.9 % of its bound at
// 32,768 subtrees: the idle lanes were the whole gap.  Now T threads share a
// subtree (T = 2, 4, 8 or 16, a template parameter).  Thread t owns leaves
// [32t/T, 32(t+1)/T) and hashes their lower log2(32/T) levels alone, depth
// first, with no barrier: each leaf pair comes from device memory in 16-byte
// loads (straight, not staged: bytes are ~15 % of the operation bound) and
// a pending left sibling waits in the thread's own column of shared memory.
// The top log2 T levels pair neighbouring threads' nodes through warp
// shuffles (eight words a node).  Every interior node goes from registers
// to `out`.  Thread slots for the 31 hashes: 32 at T = 2 (96.9 %), 16 deep;
// 36 at T = 4, 9 deep; 48 at T = 8, 6 deep; 80 at T = 16, 5 deep.  Fewer
// threads a subtree fill the lanes but lengthen each thread's chain, so a
// small batch, which cannot fill the card's 528 warp schedulers anyway,
// wants the shortest chain.  The caller (ops/tree_hash.py) pads every batch
// to one of four buckets, 8, 128, 2,048 and 32,768 subtrees, so
// subtree_threads takes, up to each bucket, the T that was fastest at it on
// an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py [timing], every T in
// turns): T = 16 up to 128 subtrees (0.0143 ms at 8 and 0.0148 at 128; T = 8
// 0.0168 and 0.0177), T = 8 up to 2,048 (0.0222 ms; T = 16 0.0275, T = 4
// 0.0326), T = 2 above (0.1609 ms at 32,768, 86 % of the 0.1389 ms bound;
// T = 4 0.1714, T = 16 0.3589).  T = 4 is fastest at no bucket; the forcing
// entry keeps it for the tests and the timing.  106-107 registers, no
// spills: four 128-thread blocks an SM.  A subtree past the end of the
// batch hashes zeros and stores nothing, but its threads reach every
// shuffle.  SHA-256 has no tensor-core form: all of it runs on the CUDA
// cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_compress.cuh"

namespace {

constexpr int PAIR_THREADS = 256;      // sha256_pairs_kernel: blocks per CUDA block
constexpr int SUB_LEAVES = 32;         // leaves of a subtree
constexpr int SUB_DEPTH = 5;           // interior levels of a subtree
constexpr int TREE_THREADS = 128;      // tree_hash_subtrees_kernel: threads per CUDA block
constexpr unsigned FULL_WARP = 0xffffffffu;

// Threads a subtree by batch size: the fastest T at each of the caller's
// buckets (the note above; PERF.md §6).
int subtree_threads(long long m) { return m <= 128 ? 16 : m <= 2048 ? 8 : 2; }

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

// The five interior levels of m subtrees of 32 leaves (8 words each), T
// threads a subtree.  `out` holds the levels one after the other, each
// subtree's nodes contiguous: level d (width 16 >> d) starts at word
// m * 8 * (32 - 2 * width).
//
// Thread t of a subtree owns its leaves [t * L, (t + 1) * L), L = 32 / T,
// and hashes their LOCAL = log2 L lower levels alone, depth first: a leaf
// pair comes from device memory, and a node whose left sibling is done
// combines with it at once, so only the pending left siblings wait, one a
// level, in this thread's column of shared memory.  Its last node is the
// subtree's node t of level LOCAL - 1.  The top log2 T levels then pair
// neighbouring threads' nodes through warp shuffles: at each, the thread
// whose index is a multiple of 2 * delta hashes its node and the node of
// thread t + delta.  Every thread of the block, those of a subtree past m
// too, runs every step, so every shuffle has all its lanes; a dead subtree
// hashes zeros and stores nothing.
template <int T>
__global__ void __launch_bounds__(TREE_THREADS, 4)
tree_hash_subtrees_kernel(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ out,
                          long long m) {
  constexpr int L = SUB_LEAVES / T;
  constexpr int LOCAL = L == 16 ? 4 : L == 8 ? 3 : L == 4 ? 2 : 1;
  constexpr int STEPS = L - 1 + SUB_DEPTH - LOCAL;  // local hashes, then the shuffled levels
  // Pending left siblings of levels 0 .. LOCAL - 2, one column a thread
  // (consecutive threads, consecutive 16 bytes: no bank conflict).
  __shared__ uint4 pending[LOCAL > 1 ? LOCAL - 1 : 1][2][TREE_THREADS];
  const int tid = threadIdx.x, t = tid % T;
  const long long sub = (long long)blockIdx.x * (TREE_THREADS / T) + tid / T;
  const bool live = sub < m;
  const uint4* mine = reinterpret_cast<const uint4*>(leaves + (sub * SUB_LEAVES + t * L) * 8);
  uint32_t node[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // the last node this thread made
  // The next local node: its level, and its index among this thread's
  // nodes of that level.
  int level = 0, index = 0;
#pragma unroll 1
  for (int step = 0; step < STEPS; ++step) {
    uint32_t w[16];
    bool hashes = true;
    int d, at;  // the level of the node this step makes, and its index in the subtree's level
    if (step < L - 1) {
      if (level == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 v = live ? mine[index * 4 + q] : make_uint4(0, 0, 0, 0);
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 v = pending[level - 1][q][tid];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) w[8 + q] = node[q];
      }
      d = level;
      at = t * (L >> (level + 1)) + index;
    } else {
      const int delta = 1 << (step - (L - 1));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        w[q] = node[q];
        w[8 + q] = __shfl_down_sync(FULL_WARP, node[q], delta, T);
      }
      hashes = (t & (2 * delta - 1)) == 0;
      d = LOCAL + step - (L - 1);
      at = t / (2 * delta);
    }
    if (hashes) {
      hash_block(w, node);
      if (live) {
        const int width = (SUB_LEAVES / 2) >> d;
        uint4* dst = reinterpret_cast<uint4*>(out + m * 8 * (SUB_LEAVES - 2 * width) +
                                              (sub * width + at) * 8);
        dst[0] = make_uint4(node[0], node[1], node[2], node[3]);
        dst[1] = make_uint4(node[4], node[5], node[6], node[7]);
      }
    }
    if (step < L - 1) {
      if (index & 1) {
        // A right child: the next step makes its parent from the pending
        // left sibling and this node.
        ++level;
        index >>= 1;
      } else {
        if (level < LOCAL - 1) {
          pending[level][0][tid] = make_uint4(node[0], node[1], node[2], node[3]);
          pending[level][1][tid] = make_uint4(node[4], node[5], node[6], node[7]);
        }
        index = (index + 1) << level;  // the next leaf pair
        level = 0;
      }
    }
  }
}

unsigned blocks(long long n, int per_block) { return (unsigned)((n + per_block - 1) / per_block); }

template <int T>
int launch_subtrees(const uint32_t* leaves, uint32_t* out, long long m, cudaStream_t stream) {
  tree_hash_subtrees_kernel<T><<<blocks(m, TREE_THREADS / T), TREE_THREADS, 0, stream>>>(leaves, out, m);
  return (int)cudaGetLastError();
}

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

// The five interior levels of m 32-leaf subtrees (leaves: m x 32 x 8 words)
// with `threads` (2, 4, 8 or 16) threads a subtree; out holds m x 31 x 8
// words, level after level (see the kernel).  For the tests and the card's
// timing; the main path takes lt_tree_hash_subtrees.
int lt_tree_hash_subtrees_t(const uint32_t* leaves, uint32_t* out, long long m, int threads,
                            void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 2: return launch_subtrees<2>(leaves, out, m, st);
    case 4: return launch_subtrees<4>(leaves, out, m, st);
    case 8: return launch_subtrees<8>(leaves, out, m, st);
    case 16: return launch_subtrees<16>(leaves, out, m, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with the threads a subtree that subtree_threads gives for m.
int lt_tree_hash_subtrees(const uint32_t* leaves, uint32_t* out, long long m, void* stream) {
  return lt_tree_hash_subtrees_t(leaves, out, m, subtree_threads(m), stream);
}

// The threads a subtree the entry above uses for m.
int lt_subtree_threads(long long m) { return subtree_threads(m); }

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
