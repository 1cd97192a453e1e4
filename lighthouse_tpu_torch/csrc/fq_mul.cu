// Batched BLS12-381 base-field products on Hopper (sm_90a): the Fq kernel
// and the fused Fq2 Karatsuba kernel.
//
// Replaces: lighthouse_tpu/ops/pallas_fq.py:_fq_mul_kernel (fq_mul_kernel)
// and lighthouse_tpu/ops/pallas_fq.py:_fq2_mul_kernel (fq2_mul_kernel).
// They compute the same function as the Pallas kernels and the JAX int32
// path (ops/fq.py:_fq_mul_int32), limb for limb:
//
//   25 int32 limbs (radix 2^16, |limb| <= 2^25)
//     -> fold16 x2 (27 limbs in [-1, 2^16]) -> split into 54 radix-2^8 digits
//     -> 54 x 54 schoolbook convolution (107 coefficients, < 2^24)
//     -> fold8 x2 (109 positions in [-52, 307])
//     -> reduction against REDMAT8[k][j] = byte j of (2^8k mod p) (109 -> 48)
//     -> fold8 x2 (50 positions) -> recombine to 25 radix-2^16 limbs
//        (|limb| < 2^16.3)
//
// What bounds it on an H100: on a large launch, integer multiply-adds.
// One Fq product needs 2,916 convolution IMADs and, in the reduction,
// 61 x 48 = 2,928 multiply-adds plus 48 adds: rows k < 48 of the table are
// unit vectors (2^8k < p), so they add e[j] to position j and multiply
// nothing.  That is 5,892 operations against 300 bytes of device memory
// (two 100-byte operands in, one out); the Fq2 product is three times
// both: 19.6 operations per byte.  The card does 64 int32 IMADs per clock
// per SM on 132 SMs against 3.35 TB/s, a balance of 19.6 per byte only at
// an SM clock of 7.8 GHz, so the work is bound by operations, not bytes
// (chip_smoke.py prints both bounds; it counts the reduction as IMADs
// whichever instruction runs it).  But the main path launches these
// kernels on few rows: in a 128 x 32 verify the mean Fq launch is 335
// rows, the mean Fq2 launch 118, and over half of the Fq launches are one
// row.  What bounds a launch there is the latency of one product.
//
// What the design does about it: a product group of G = 16 threads
// computes one Fq product, every stage split across the group, and the
// stages meet in the product's own words of shared memory between block
// barriers:
//
//   stage     thread l folds and splits radix-2^16 positions l and l+16 of
//             both operands (position i needs limbs i, i-1, i-2 only; the
//             loads are unconditional, so a warp makes one trip to memory)
//             into 64 digits each (54 and zeros), and zeroes the
//             coefficient words;
//   conv      thread l owns digits 4l..4l+3 of a and all of b (in
//             registers), forms its 57 partial coefficients 4l..4l+56 (216
//             multiply-adds) and adds them into the shared coefficients
//             with shared-memory atomics; the coefficients have a spare
//             word after every four, so the 32 threads of a warp (two
//             products) hit 32 distinct banks;
//   fold8x2   thread l forms positions 4w..4w+3 for w = l, l+16 (position
//             k needs coefficients k, k-1, k-2 only) and leaves positions
//             48..111 as two rows of packed bytes, e & 0xFF and
//             (e >> 8) + 1 (e lies in [-52, 307]);
//   reduce    thread l computes output positions l, l+16, l+32 as
//             e[j] + lo . t[j] + 256 (hi . t[j] - sum t[j]) with __dp4a,
//             four byte products an instruction, against the block's copy
//             of the table packed four bytes to a word (3,840 bytes);
//   recombine thread l forms output limbs l and l+16: limb i needs reduced
//             positions 2i-2..2i+1, folded twice and joined.
//
// The Fq2 kernel runs its three Karatsuba products (a0 b0, a1 b1,
// (a0 + a1)(b0 + b1)) on three product groups at once; the products meet
// in shared memory and the whole block forms (t0 - t1, t2 - t0 - t1) after
// a barrier, so t0, t1 and t2 never reach device memory.
//
// Blocks hold 8 Fq rows (128 threads) or 2 Fq2 rows (6 products, 96
// threads): a launch of 335 Fq rows runs on 42 SMs, one of 118 Fq2 rows on
// 59.  A product whose row lies past the end of the batch skips its
// arithmetic (it would compete for the SM's shared-memory bandwidth) but
// reaches every barrier, and nothing of it is stored.  G, FQ_ROWS and
// FQ2_ROWS were chosen on the card from the time per verify
// (lighthouse_tpu_torch/bench_kernels.py --variant; PERF.md).  The
// multiply-adds run on the CUDA cores, not the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L16 = 25;            // radix-2^16 limbs per element
constexpr int F16 = L16 + 2;       // after fold16 x2
constexpr int S8 = 2 * F16;        // 54 radix-2^8 digits
constexpr int CONV = 2 * S8 - 1;   // 107 convolution coefficients
constexpr int RED_K = 112;         // 109 positions after fold8 x2, padded
constexpr int RED_OUT = 48;        // radix-2^8 positions of 2^8k mod p
constexpr int RED_LO = RED_OUT;    // rows k < 48 of the table are unit vectors
constexpr int RED_W = RED_K - RED_LO;  // 64 table rows kept, 48..111

constexpr int G = 16;                         // threads per Fq product
constexpr int FQ_ROWS = 8;                    // Fq rows per block
constexpr int FQ2_ROWS = 2;                   // Fq2 rows per block
constexpr int FQ_THREADS = G * FQ_ROWS;       // 128
constexpr int FQ2_THREADS = 3 * G * FQ2_ROWS; // 96

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
constexpr int max_of(int x, int y) { return x > y ? x : y; }

// Digits per operand: 54 and zeros up to a multiple of 4G, so that each
// thread's D digits start on a multiple of 4.
constexpr int DIG = round_up(S8, 4 * G);
constexpr int D = DIG / G;             // digits of a per thread in the convolution
constexpr int PART = D + S8 - 1;       // partial coefficients per thread
constexpr int PAD = 4;                 // zero words before the coefficients
// Word of coefficient k (k >= -PAD): one spare word after every four, so
// that the 16 threads of a group, whose partial coefficients start 4 apart,
// hit 16 distinct banks.  cw(4w + x) = 5w + cw(x).
__host__ __device__ constexpr int cw(int k) { return k + PAD + ((k + PAD) >> 2); }
// Coefficient words (later the reduced positions, unskewed): room for every
// thread's partial coefficients and for the fold's reads up to RED_K.
constexpr int C_WORDS = round_up(cw(max_of(RED_K, DIG + S8 - 1)), 4);
// A product's shared words: digits of a and b (later the folded positions,
// then the Fq2 kernel's product), then the coefficients; 16 (mod 32) words,
// so that the two products of a warp use opposite halves of the banks.
constexpr int PROD_WORDS = round_up(2 * DIG + C_WORDS - 16, 32) + 16;
// The folded positions: e[0..48) as words, then positions 48..111 as two
// rows of packed bytes (E_LO: e & 0xFF; E_HI: (e >> 8) + 1).
constexpr int RED_Q = RED_W / 4;       // packed words per row
constexpr int E_LO = RED_LO;
constexpr int E_HI = E_LO + RED_Q;
// Table row: RED_Q words of packed bytes, the row's byte sum, zero padding;
// 20 words, so eight consecutive rows fall in eight distinct bank quads.
constexpr int TAB_SUM = RED_Q;
constexpr int TAB_STRIDE = RED_Q + 4;

static_assert(DIG % G == 0 && DIG >= S8 && D % 4 == 0, "digit padding");
static_assert(2 * DIG >= E_HI + RED_Q, "folded positions reuse the digit words");
static_assert(cw(DIG + S8 - 2) < C_WORDS && cw(RED_K - 1) < C_WORDS && cw(-1) == PAD - 1,
              "coefficients fit; words below PAD are the zeros below coefficient 0");
static_assert(2 * DIG + C_WORDS <= PROD_WORDS && PROD_WORDS % 32 == 16, "product words");
static_assert(RED_OUT % G == 0 && RED_LO % 4 == 0, "even split of positions");
static_assert(PAD + RED_OUT + 2 <= C_WORDS && CONV + 2 <= RED_K, "reduced positions fit");

// Rows 48..108 of the reduction table, transposed, as packed bytes: word q
// of row j holds byte j of (2^8k mod p) for k = 48 + 4q .. 48 + 4q + 3
// (zero for k >= 109) in its bytes 0..3; word TAB_SUM holds the row's sum.
__device__ __align__(16) unsigned g_redmat8[RED_OUT * TAB_STRIDE];

// The block's copy of the table; the first barrier of fq_product publishes it.
__device__ __forceinline__ void load_table(unsigned* table, int tid, int threads) {
  const uint4* src = reinterpret_cast<const uint4*>(g_redmat8);
  uint4* dst = reinterpret_cast<uint4*>(table);
  for (int q = tid; q < RED_OUT * TAB_STRIDE / 4; q += threads) dst[q] = src[q];
}

// Limb k of an operand, zero outside [0, 25).  The load is unconditional
// (at a clamped index) and the zero a select: a load under a condition that
// differs across a warp would cost the warp one trip to memory per branch.
template <class Load>
__device__ __forceinline__ int limb(Load load, int k) {
  const int v = load(k < 0 ? 0 : k < L16 ? k : L16 - 1);
  return k >= 0 && k < L16 ? v : 0;
}

// Radix-2^16 position i of fold16(fold16(x)), split into digits 2i and
// 2i + 1 (arithmetic >> keeps signed limbs exact, as in the JAX package's
// fold16 / split16_to_8).  Position i depends on limbs i, i-1 and i-2 only.
template <class Load>
__device__ __forceinline__ void stage_position(Load load, int i, int* dig) {
  const int x0 = limb(load, i);
  const int x1 = limb(load, i - 1);
  const int x2 = limb(load, i - 2);
  const int y0 = (x0 & 0xFFFF) + (x1 >> 16);
  const int y1 = (x1 & 0xFFFF) + (x2 >> 16);
  const int z = (y0 & 0xFFFF) + (y1 >> 16);
  dig[2 * i] = z & 0xFF;
  dig[2 * i + 1] = z >> 8;
}

__host__ __device__ __forceinline__ unsigned pack4(int b0, int b1, int b2, int b3) {
  return (unsigned)(b0 & 0xFF) | (unsigned)(b1 & 0xFF) << 8 | (unsigned)(b2 & 0xFF) << 16 |
         (unsigned)(b3 & 0xFF) << 24;
}

// One Fq product on the G threads of a product group.  lane is the
// thread's index in the group and s the product's PROD_WORDS shared words;
// load_x(i) and load_y(i) give limb i < 25 of the operands and store(i, v)
// takes output limb i.  A product whose row is not live skips its
// arithmetic, but every thread of the block calls this at once and reaches
// its four block barriers.
template <class LoadX, class LoadY, class Store>
__device__ __forceinline__ void fq_product(bool live, int lane, int* s, const unsigned* table,
                                           LoadX load_x, LoadY load_y, Store store) {
  int* dig_a = s;
  int* dig_b = s + DIG;
  int* e = s;               // folded positions, once the digits are spent
  int* c = s + 2 * DIG;     // coefficient k at c[cw(k)], zero below k = 0
  int* r = c;               // PAD zeros, then reduced positions, once c is spent

  // Stage.
  if (live) {
#pragma unroll
    for (int t = 0; t < (DIG / 2 + G - 1) / G; ++t) {
      const int i = lane + G * t;
      if (i < DIG / 2) {
        stage_position(load_x, i, dig_a);
        stage_position(load_y, i, dig_b);
      }
    }
#pragma unroll
    for (int t = 0; t < (C_WORDS + G - 1) / G; ++t) {
      const int k = lane + G * t;
      if (k < C_WORDS) c[k] = 0;
    }
  }
  __syncthreads();

  // Convolution: digits D*lane.. of a against all of b.
  if (live) {
    int av[D], bv[DIG];
#pragma unroll
    for (int ii = 0; ii < D; ++ii) av[ii] = dig_a[D * lane + ii];
    const int4* b4 = reinterpret_cast<const int4*>(dig_b);
#pragma unroll
    for (int q = 0; q < DIG / 4; ++q) {
      const int4 v = b4[q];
      bv[4 * q] = v.x;
      bv[4 * q + 1] = v.y;
      bv[4 * q + 2] = v.z;
      bv[4 * q + 3] = v.w;
    }
    int* cp = c + 5 * (D / 4) * lane;  // coefficient D*lane + m at cp[cw(m)]
#pragma unroll
    for (int m = 0; m < PART; ++m) {
      int acc = 0;
#pragma unroll
      for (int ii = 0; ii < D; ++ii) {
        const int j = m - ii;
        if (j >= 0 && j < S8) acc += av[ii] * bv[j];
      }
      atomicAdd(cp + cw(m), acc);
    }
  }
  __syncthreads();

  // fold8 x2: thread lane forms positions 4w..4w+3 for w = lane, lane + G,
  // ... from coefficients 4w-2 .. 4w+3 (position k needs k, k-1, k-2);
  // positions 48.. leave as packed bytes for the reduction.
  if (live) {
#pragma unroll
    for (int t = 0; t < (RED_K / 4 + G - 1) / G; ++t) {
      const int w = lane + G * t;
      if (w < RED_K / 4) {
        int cm[6];
#pragma unroll
        for (int u = 0; u < 6; ++u) cm[u] = c[5 * w + cw(u - 2)];
        int ev[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d0 = (cm[u + 2] & 0xFF) + (cm[u + 1] >> 8);
          const int d1 = (cm[u + 1] & 0xFF) + (cm[u] >> 8);
          ev[u] = (d0 & 0xFF) + (d1 >> 8);
        }
        if (w < RED_LO / 4) {
          reinterpret_cast<int4*>(e)[w] = make_int4(ev[0], ev[1], ev[2], ev[3]);
        } else {
          // e lies in [-52, 307] for any int32 operands, so e & 0xFF and
          // (e >> 8) + 1 are bytes and e = lo + 256 * (hi - 1).
          e[E_LO + w - RED_LO / 4] = (int)pack4(ev[0], ev[1], ev[2], ev[3]);
          e[E_HI + w - RED_LO / 4] = (int)pack4((ev[0] >> 8) + 1, (ev[1] >> 8) + 1,
                                                (ev[2] >> 8) + 1, (ev[3] >> 8) + 1);
        }
      }
    }
  }
  __syncthreads();

  // Reduction: positions lane, lane + G, ... of
  // r[j] = e[j] + sum_k e[k] t[j][k] = e[j] + lo . t[j] + 256 (hi . t[j] - sum t[j]),
  // four byte products a __dp4a.
  if (live) {
    constexpr int JN = RED_OUT / G;
    unsigned lo[JN], hi[JN];
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) lo[jj] = hi[jj] = 0;
    const uint4* elo = reinterpret_cast<const uint4*>(e + E_LO);
    const uint4* ehi = reinterpret_cast<const uint4*>(e + E_HI);
#pragma unroll
    for (int q = 0; q < RED_Q / 4; ++q) {
      const uint4 l4 = elo[q], h4 = ehi[q];
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        const uint4 t = reinterpret_cast<const uint4*>(table + (lane + G * jj) * TAB_STRIDE)[q];
        lo[jj] = __dp4a(l4.x, t.x, lo[jj]);
        lo[jj] = __dp4a(l4.y, t.y, lo[jj]);
        lo[jj] = __dp4a(l4.z, t.z, lo[jj]);
        lo[jj] = __dp4a(l4.w, t.w, lo[jj]);
        hi[jj] = __dp4a(h4.x, t.x, hi[jj]);
        hi[jj] = __dp4a(h4.y, t.y, hi[jj]);
        hi[jj] = __dp4a(h4.z, t.z, hi[jj]);
        hi[jj] = __dp4a(h4.w, t.w, hi[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      const int j = lane + G * jj;
      r[PAD + j] = e[j] + (int)lo[jj] + 256 * ((int)hi[jj] - (int)table[j * TAB_STRIDE + TAB_SUM]);
    }
    // Positions 48 and 49 are zero; r[0..PAD) kept the zeros below
    // coefficient 0.
    if (lane < 2) r[PAD + RED_OUT + lane] = 0;
  }
  __syncthreads();

  // fold8 x2 and recombine: limb i from reduced positions 2i-2 .. 2i+1.
  if (live) {
#pragma unroll
    for (int t = 0; t < (L16 + G - 1) / G; ++t) {
      const int i = lane + G * t;
      if (i < L16) {
        const int* rr = r + PAD + 2 * i - 2;
        const int f0 = (rr[1] & 0xFF) + (rr[0] >> 8);  // fold 1, position 2i-1
        const int f1 = (rr[2] & 0xFF) + (rr[1] >> 8);  // fold 1, position 2i
        const int f2 = (rr[3] & 0xFF) + (rr[2] >> 8);  // fold 1, position 2i+1
        const int g0 = (f1 & 0xFF) + (f0 >> 8);        // fold 2, position 2i
        const int g1 = (f2 & 0xFF) + (f1 >> 8);        // fold 2, position 2i+1
        store(i, g0 + g1 * 256);
      }
    }
  }
}

__global__ void __launch_bounds__(FQ_THREADS)
fq_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
              int* __restrict__ out, long long n) {
  __shared__ __align__(16) unsigned table[RED_OUT * TAB_STRIDE];
  __shared__ __align__(16) int prod[FQ_ROWS * PROD_WORDS];
  const int tid = threadIdx.x, p = tid / G, lane = tid % G;
  load_table(table, tid, FQ_THREADS);
  const long long row = (long long)blockIdx.x * FQ_ROWS + p;
  const bool live = row < n;
  const long long base = (live ? row : 0) * L16;
  const int* ar = a + base;
  const int* br = b + base;
  int* orow = out + base;
  fq_product(
      live, lane, prod + p * PROD_WORDS, table,
      [&](int i) { return ar[i]; },
      [&](int i) { return br[i]; },
      [&](int i, int v) { orow[i] = v; });
}

// Fq2 = Fq[u]/(u^2 + 1) product by Karatsuba on (n, 2, 25) rows:
// t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// out = (t0 - t1, t2 - t0 - t1).  Group 3r + h of the block computes t_h of
// its row r; each leaves its product in its first 25 shared words.
__global__ void __launch_bounds__(FQ2_THREADS)
fq2_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, long long n) {
  __shared__ __align__(16) unsigned table[RED_OUT * TAB_STRIDE];
  __shared__ __align__(16) int prod[3 * FQ2_ROWS * PROD_WORDS];
  const int tid = threadIdx.x, p = tid / G, lane = tid % G;
  const int h = p % 3;
  load_table(table, tid, FQ2_THREADS);
  const long long row = (long long)blockIdx.x * FQ2_ROWS + p / 3;
  const bool live = row < n;
  const long long base = (live ? row : 0) * 2 * L16;
  const int* a0 = a + base;
  const int* b0 = b + base;
  int* s = prod + p * PROD_WORDS;
  // x0, x1 or x0 + x1 for t0, t1, t2: both limbs loaded by every group (see limb()).
  auto operand = [&](const int* x0, int i) {
    const int v0 = x0[i], v1 = x0[L16 + i];
    return (h != 1 ? v0 : 0) + (h != 0 ? v1 : 0);
  };
  fq_product(
      live, lane, s, table,
      [&](int i) { return operand(a0, i); },
      [&](int i) { return operand(b0, i); },
      [&](int i, int v) { s[i] = v; });
  __syncthreads();
  // Recombination: the block's output limbs, consecutive threads on
  // consecutive limbs of device memory.
  for (int o = tid; o < FQ2_ROWS * 2 * L16; o += FQ2_THREADS) {
    const int lr = o / (2 * L16), i = o % L16;
    const long long orow = (long long)blockIdx.x * FQ2_ROWS + lr;
    if (orow < n) {
      const int* t = prod + 3 * lr * PROD_WORDS;
      const int t0 = t[i], t1 = t[PROD_WORDS + i], t2 = t[2 * PROD_WORDS + i];
      out[(long long)blockIdx.x * FQ2_ROWS * 2 * L16 + o] =
          o % (2 * L16) < L16 ? t0 - t1 : t2 - t0 - t1;
    }
  }
}

unsigned blocks(long long n, int rows) { return (unsigned)((n + rows - 1) / rows); }

}  // namespace

extern "C" {

// The entry points act on the calling thread's current device; the caller
// selects it (cuda_fq.py does so with a torch device guard).

// Upload the reduction table to the current device.  redmat_t is rows
// 48..108 of REDMAT8, transposed and zero padded (RED_OUT x RED_W int32
// bytes, host memory: redmat_t[j * RED_W + k - 48] = byte j of 2^8k mod p);
// it is packed here into g_redmat8's layout.  Returns a cudaError_t.
int lt_fq_init(const int* redmat_t) {
  unsigned packed[RED_OUT * TAB_STRIDE] = {};
  for (int j = 0; j < RED_OUT; ++j) {
    const int* row = redmat_t + j * RED_W;
    unsigned sum = 0;
    for (int q = 0; q < RED_Q; ++q) {
      packed[j * TAB_STRIDE + q] = pack4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
      for (int u = 0; u < 4; ++u) sum += (unsigned)(row[4 * q + u] & 0xFF);
    }
    packed[j * TAB_STRIDE + TAB_SUM] = sum;
  }
  return (int)cudaMemcpyToSymbol(g_redmat8, packed, sizeof(packed));
}

// out[i] = a[i] * b[i] mod p for n rows of 25 limbs, on `stream`.
int lt_fq_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  fq_mul_kernel<<<blocks(n, FQ_ROWS), FQ_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i] in Fq2 for n rows of (2, 25) limbs, on `stream`.
int lt_fq2_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  fq2_mul_kernel<<<blocks(n, FQ2_ROWS), FQ2_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
