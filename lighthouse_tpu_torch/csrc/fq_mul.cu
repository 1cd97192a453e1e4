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
// What bounds it on an H100: integer multiply-adds.  One Fq product needs
// 2,916 convolution IMADs and, in the reduction, 61 x 48 = 2,928 IMADs
// plus 48 adds: rows k < 48 of the table are unit vectors (2^8k < p), so
// they add e[j] to position j and multiply nothing.  That is 5,892
// operations against 300 bytes of device memory (two 100-byte operands in,
// one out); the Fq2 product is three times both: 19.6 operations per byte.
// The card does 64 int32 IMADs per clock per SM on 132 SMs against
// 3.35 TB/s of memory, a balance of 19.6 per byte only at an SM clock of
// 7.8 GHz, so at any real clock the kernels are bound by operations, not
// bytes (chip_smoke.py prints both bounds).
//
// What the design does about it: one thread per row keeps the pipeline in
// registers, so device memory is touched once per operand limb and once per
// output limb (the Pallas kernel stages operands through 128-lane VMEM
// tiles and does the folds as matmuls; none of that carries over).  The
// convolution is computed one output coefficient at a time and streamed
// through both fold8 rounds, so the 107 coefficients never exist at once:
// only the 2 x 54 digits and the 109 folded positions are live.  The
// reduction walks the 48 output positions in a rolled loop; each position
// starts from e[j] (the unit rows) and adds 64 IMADs (61 table rows, 3 of
// zero padding) against one row of the transposed table of rows 48..108,
// which every block copies from constant memory into shared memory and
// reads with 16-byte loads at one address across the warp (a broadcast).
// The rolled loop cannot index a register array, so each thread leaves
// e[0..47] in its own column of a shared array (one word per thread per
// position: no bank conflicts, no barrier).  The two reduction
// folds and the recombine stream along with it and store each output limb
// as soon as it is known.  The ragged edge of the batch is masked, not
// padded.  Only the convolution is unrolled: unrolling the reduction as
// well made nvcc take minutes.  This is the simple design; the IMADs run on
// the CUDA cores, not the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L16 = 25;            // radix-2^16 limbs per element
constexpr int F16 = L16 + 2;       // after fold16 x2
constexpr int S8 = 2 * F16;        // 54 radix-2^8 digits
constexpr int CONV = 2 * S8 - 1;   // 107 convolution coefficients
constexpr int RED_IN = CONV + 2;   // 109 positions after fold8 x2
constexpr int RED_K = 112;         // RED_IN padded to a multiple of 4
constexpr int RED_OUT = 48;        // radix-2^8 positions of 2^8k mod p
constexpr int RED_LO = RED_OUT;    // rows k < 48 of the table are unit vectors
constexpr int RED_W = RED_K - RED_LO;  // 64 table rows kept, 48..111
constexpr int THREADS = 128;

// Rows 48..108 of the reduction table, transposed and zero padded:
// c_redmat_t[j * RED_W + k - RED_LO] = byte j of (2^8k mod p) for
// RED_LO <= k < RED_IN, 0 above.
__constant__ int c_redmat_t[RED_OUT * RED_W];

// Every block copies the table into shared memory before any row returns.
__device__ __forceinline__ void load_table(int* table) {
  for (int i = threadIdx.x; i < RED_OUT * RED_W; i += THREADS) table[i] = c_redmat_t[i];
  __syncthreads();
}

// fold16 x2 then split into radix-2^8 digits (arithmetic >> keeps signed
// limbs exact, as in the JAX package's fold16 / split16_to_8).
__device__ __forceinline__ void stage(const int x[L16], int d[S8]) {
  int y[L16 + 1];
#pragma unroll
  for (int i = 0; i <= L16; ++i) {
    const int lo = i < L16 ? (x[i] & 0xFFFF) : 0;
    const int hi = i > 0 ? (x[i - 1] >> 16) : 0;
    y[i] = lo + hi;
  }
#pragma unroll
  for (int i = 0; i < F16; ++i) {
    const int lo = i < L16 + 1 ? (y[i] & 0xFFFF) : 0;
    const int hi = i > 0 ? (y[i - 1] >> 16) : 0;
    const int z = lo + hi;
    d[2 * i] = z & 0xFF;
    d[2 * i + 1] = z >> 8;
  }
}

// Convolution streamed through both fold8 rounds: e[k] is position k of
// fold8(fold8(a * b)), zero for k >= RED_IN.
__device__ __forceinline__ void conv_fold(const int a[S8], const int b[S8], int e[RED_K]) {
  int c_prev = 0;  // convolution coefficient k-1
  int d_prev = 0;  // first-fold position k-1
#pragma unroll
  for (int k = 0; k < RED_IN; ++k) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < S8; ++i) {
      const int j = k - i;
      if (j >= 0 && j < S8) c += a[i] * b[j];
    }
    const int d = (c & 0xFF) + (c_prev >> 8);  // fold8 round 1
    e[k] = (d & 0xFF) + (d_prev >> 8);         // fold8 round 2
    c_prev = c;
    d_prev = d;
  }
#pragma unroll
  for (int k = RED_IN; k < RED_K; ++k) e[k] = 0;
}

// Reduction r[j] = e[j] + sum_{k >= RED_LO} e[k] * table[j][k], streamed
// through both fold8 rounds and the radix-2^16 recombine: store(i, limb)
// receives output limb i as soon as it is known.  e_lo is the thread's
// column of a shared array holding e[0..RED_LO-1], one word every THREADS.
template <class Store>
__device__ __forceinline__ void reduce_store(const int e[RED_K], const int* e_lo,
                                             const int* table, Store store) {
  int r_prev = 0, f_prev = 0, g_prev = 0;
#pragma unroll 1
  for (int j = 0; j < RED_OUT; ++j) {
    const int4* row = reinterpret_cast<const int4*>(table + j * RED_W);
    int r = e_lo[j * THREADS];
#pragma unroll
    for (int q = 0; q < RED_W / 4; ++q) {
      const int4 t = row[q];
      const int k = RED_LO + 4 * q;
      r += e[k] * t.x + e[k + 1] * t.y + e[k + 2] * t.z + e[k + 3] * t.w;
    }
    const int f = (r & 0xFF) + (r_prev >> 8);  // fold8 round 1, position j
    const int g = (f & 0xFF) + (f_prev >> 8);  // fold8 round 2, position j
    if (j & 1) store(j >> 1, g_prev + g * 256);
    r_prev = r;
    f_prev = f;
    g_prev = g;
  }
  // Positions 48 and 49 of the second fold carry only the top bytes.
  const int f48 = r_prev >> 8;
  const int g48 = (f48 & 0xFF) + (f_prev >> 8);
  const int g49 = f48 >> 8;
  store(L16 - 1, g48 + g49 * 256);
}

// One full Fq product pipeline on register operands; e_lo is the thread's
// column of the block's shared e_lo array (see reduce_store).
template <class Store>
__device__ __forceinline__ void mul_pipeline(const int x[L16], const int y[L16],
                                             int* e_lo, const int* table, Store store) {
  int a[S8], b[S8], e[RED_K];
  stage(x, a);
  stage(y, b);
  conv_fold(a, b, e);
#pragma unroll
  for (int j = 0; j < RED_LO; ++j) e_lo[j * THREADS] = e[j];
  reduce_store(e, e_lo, table, store);
}

__global__ void __launch_bounds__(THREADS)
fq_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
              int* __restrict__ out, long long n) {
  __shared__ __align__(16) int table[RED_OUT * RED_W];
  __shared__ int e_lo[RED_LO * THREADS];
  load_table(table);
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const int* ar = a + row * L16;
  const int* br = b + row * L16;
  int x[L16], y[L16];
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    x[i] = ar[i];
    y[i] = br[i];
  }
  int* orow = out + row * L16;
  mul_pipeline(x, y, e_lo + threadIdx.x, table, [&](int i, int v) { orow[i] = v; });
}

// Fq2 = Fq[u]/(u^2 + 1) product by Karatsuba on (n, 2, 25) rows:
// t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// out = (t0 - t1, t2 - t0 - t1).  The three pipelines run in turn inside one
// thread, accumulating in the thread's own output row: after t0 it holds
// (t0, t0), after t1 (t0 - t1, t0 + t1), after t2 the result.
__global__ void __launch_bounds__(THREADS)
fq2_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ out, long long n) {
  __shared__ __align__(16) int table[RED_OUT * RED_W];
  __shared__ int e_lo[RED_LO * THREADS];
  load_table(table);
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const int* a0 = a + row * 2 * L16;
  const int* a1 = a0 + L16;
  const int* b0 = b + row * 2 * L16;
  const int* b1 = b0 + L16;
  int* o0 = out + row * 2 * L16;
  int* o1 = o0 + L16;

  int x[L16], y[L16];
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int i = 0; i < L16; ++i) {
      x[i] = p == 0 ? a0[i] : p == 1 ? a1[i] : a0[i] + a1[i];
      y[i] = p == 0 ? b0[i] : p == 1 ? b1[i] : b0[i] + b1[i];
    }
    mul_pipeline(x, y, e_lo + threadIdx.x, table, [&](int i, int v) {
      if (p == 0) {
        o0[i] = v;
        o1[i] = v;
      } else if (p == 1) {
        o0[i] -= v;
        o1[i] += v;
      } else {
        o1[i] = v - o1[i];
      }
    });
  }
}

unsigned grid_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// The entry points act on the calling thread's current device; the caller
// selects it (cuda_fq.py does so with a torch device guard).

// Upload the transposed reduction table (RED_OUT x RED_W int32, host
// memory, see c_redmat_t) to the current device's constant memory.
// Returns a cudaError_t.
int lt_fq_init(const int* redmat_t) {
  return (int)cudaMemcpyToSymbol(c_redmat_t, redmat_t, sizeof(int) * RED_OUT * RED_W);
}

// out[i] = a[i] * b[i] mod p for n rows of 25 limbs, on `stream`.
int lt_fq_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  fq_mul_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i] in Fq2 for n rows of (2, 25) limbs, on `stream`.
int lt_fq2_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  fq2_mul_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

const char* lt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
