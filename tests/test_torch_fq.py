"""The port's Fq kernels (plain versions on the CPU) vs the JAX package.

``lighthouse_tpu_torch.ops.cuda_fq`` holds two CUDA kernels and their plain
PyTorch versions; on a CPU tensor the wrappers run the plain versions.  They
must equal, limb for limb (tolerance zero: exact integers, same pipeline),
the JAX package's int32 path (``ops/fq.py:_fq_mul_int32``, ``tower.fq2_mul``)
and its Pallas kernels in interpret mode.  Inputs are made with numpy from a
seed and fed to both sides.  The CUDA kernels themselves run only on a card:
``test_kernels_on_card`` (marker ``cuda``) compares them with the plain
versions there and skips elsewhere; ``test_cuda_source_on_host_compiler``
runs the CUDA source's own arithmetic on the CPU through the host C++ compiler.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lighthouse_tpu.ops import fq as jfq  # noqa: E402
from lighthouse_tpu.ops import pallas_fq  # noqa: E402
from lighthouse_tpu.ops import tower as jtw  # noqa: E402
from lighthouse_tpu_torch.ops import cuda_fq, fq, tower  # noqa: E402

P = fq.P
N = 131  # crosses the Pallas kernels' 128-row tile
OUT_BOUND = 2 ** 16.3


def _values(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _limbs(values):
    return np.stack([fq.to_limbs16(v) for v in values])


def _operands(kind, n, seed):
    """(a, b) int32 limb arrays of one input family, and their integer values."""
    rng = np.random.default_rng(seed)
    va, vb = _values(rng, n), _values(rng, n)
    a, b = _limbs(va), _limbs(vb)
    if kind == "canonical":
        return a, b, va, vb
    if kind == "redundant":  # lazy-reduction sums, as the tower feeds fq_mul
        return (a * 37 - b * 12, b * 55 - a * 3,
                [37 * x - 12 * y for x, y in zip(va, vb)],
                [55 * y - 3 * x for x, y in zip(va, vb)])
    if kind == "negative":
        return -a, -(b * 3), [-x for x in va], [-3 * y for y in vb]
    if kind == "edge":
        edge = [0, 1, P - 1, P - 2, 2 ** 381 % P, (1 << 255) - 19]
        ve = [edge[i % len(edge)] for i in range(n)]
        vf = [edge[(i * 5 + 1) % len(edge)] for i in range(n)]
        return _limbs(ve), _limbs(vf), ve, vf
    if kind == "max_limbs":  # the documented input bound, |limb| <= 2^25
        x = rng.integers(-(1 << 25), (1 << 25) + 1, (n, fq.L16), dtype=np.int32)
        y = rng.integers(-(1 << 25), (1 << 25) + 1, (n, fq.L16), dtype=np.int32)
        return x, y, [fq.from_limbs16(r) for r in x], [fq.from_limbs16(r) for r in y]
    raise ValueError(kind)


KINDS = ["canonical", "redundant", "negative", "edge", "max_limbs"]


@pytest.mark.parametrize("kind", KINDS)
def test_fq_mul_equals_jax_int32_and_pallas(kind):
    a, b, va, vb = _operands(kind, N, seed=KINDS.index(kind))
    out = fq.fq_mul(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert out.dtype == np.int32 and out.shape == (N, fq.L16)
    assert np.array_equal(out, np.asarray(jfq._fq_mul_int32(a, b)))
    assert np.array_equal(out, np.asarray(pallas_fq.fq_mul_pallas(a, b, interpret=True)))
    assert np.abs(out).max() < OUT_BOUND
    for i in range(0, N, 13):
        assert fq.from_limbs16(out[i]) == va[i] * vb[i] % P


@pytest.mark.parametrize("kind", KINDS)
def test_fq2_mul_equals_jax_tower_and_pallas(kind):
    a, b, va, vb = _operands(kind, N, seed=10 + KINDS.index(kind))
    a2 = np.stack([a, np.roll(b, 1, axis=0)], axis=1)
    b2 = np.stack([b, np.roll(a, 2, axis=0)], axis=1)
    out = tower.fq2_mul(torch.as_tensor(a2), torch.as_tensor(b2)).numpy()
    assert out.shape == (N, 2, fq.L16)
    ref = np.asarray(jax.jit(lambda x, y: jtw.fq2_mul(x, y))(a2, b2))
    assert np.array_equal(out, ref)
    assert np.array_equal(out, np.asarray(pallas_fq.fq2_mul_pallas(a2, b2, interpret=True)))
    for i in range(0, N, 17):
        x0, x1, y0, y1 = va[i], vb[(i - 1) % N], vb[i], va[(i - 2) % N]
        assert fq.from_limbs16(out[i, 0]) == (x0 * y0 - x1 * y1) % P
        assert fq.from_limbs16(out[i, 1]) == (x0 * y1 + x1 * y0) % P


def test_plain_versions_broadcast_leading_dims():
    a, b, _, _ = _operands("redundant", 12, seed=30)
    flat = cuda_fq.fq_mul_plain(torch.as_tensor(a), torch.as_tensor(b))
    shaped = cuda_fq.fq_mul_plain(torch.as_tensor(a.reshape(3, 4, 25)),
                                  torch.as_tensor(b.reshape(3, 4, 25)))
    assert torch.equal(shaped.reshape(12, 25), flat)
    via_fq = fq.fq_mul(torch.as_tensor(a.reshape(3, 4, 25)), torch.as_tensor(b[:4]))
    assert torch.equal(via_fq[1], cuda_fq.fq_mul_plain(torch.as_tensor(a[4:8]),
                                                        torch.as_tensor(b[:4])))


def test_conv_and_folds_on_negative_limbs():
    """Arithmetic >> and two's-complement & on negative int32 limbs: the
    folds and the skewed convolution agree with Python integers."""
    rng = np.random.default_rng(31)
    x = rng.integers(-(1 << 25), 1 << 25, (7, 25), dtype=np.int32)
    t = torch.as_tensor(x)
    for fold, radix in ((fq.fold16_2, 16), (fq.fold8_2, 8)):
        y = fold(t).numpy()
        for r_in, r_out in zip(x, y):
            assert sum(int(v) << (radix * i) for i, v in enumerate(r_in)) == \
                sum(int(v) << (radix * i) for i, v in enumerate(r_out))
    a8 = fq.split16_to_8(fq.fold16_2(t))
    c = cuda_fq.conv54(a8, a8.flip(0)).numpy()
    a8n, b8n = a8.numpy(), a8.flip(0).numpy()
    for r in range(7):
        assert np.array_equal(c[r], np.convolve(a8n[r].astype(np.int64), b8n[r].astype(np.int64)))


def test_fq_inv_and_pow():
    vals = [1, 2, P - 1, 0xDEADBEEF ** 5 % P]
    x = torch.as_tensor(_limbs(vals))
    inv = fq.fq_inv(x)
    for i, v in enumerate(vals):
        assert fq.from_limbs16(inv[i]) == pow(v, P - 2, P)
    cube = fq.fq_pow_const(x, 3)
    assert [fq.from_limbs16(r) for r in cube] == [pow(v, 3, P) for v in vals]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "mismatch", "device"])
def test_wrappers_reject_bad_operands(bad):
    a = torch.zeros(4, 25, dtype=torch.int32)
    b = torch.zeros(4, 25, dtype=torch.int32)
    if bad == "dtype":
        a = a.long()
    elif bad == "shape":
        a, b = a[:, :24], b[:, :24]
    elif bad == "contiguity":
        a = torch.zeros(25, 4, dtype=torch.int32).t()
    elif bad == "mismatch":
        b = b[:3]
    elif bad == "device":
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cuda_fq.fq_mul(a, b)
    with pytest.raises((TypeError, ValueError)):
        cuda_fq.fq2_mul(a.reshape(2, 2, -1) if bad != "shape" else a, b)


def test_reduction_table_matches_jax():
    assert np.array_equal(fq.REDMAT8, jfq._red_rows(fq.RED_IN))


def test_cpu_path_launches_no_kernel():
    cuda_fq.reset_launch_counts()
    a = torch.as_tensor(_operands("canonical", 5, seed=40)[0])
    fq.fq_mul(a, a)
    tower.fq2_mul(a[:4].reshape(2, 2, 25), a[:4].reshape(2, 2, 25))
    assert cuda_fq.LAUNCHES == {"fq_mul": 0, "fq2_mul": 0}


@pytest.mark.cuda
def test_kernels_on_card():
    """Both CUDA kernels equal their plain versions limb for limb on the
    card, across a block boundary and on redundant and negative limbs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for kind in KINDS:
        a, b, _, _ = _operands(kind, N, seed=50)
        a, b = torch.as_tensor(a).cuda(), torch.as_tensor(b).cuda()
        before = dict(cuda_fq.LAUNCHES)
        out = cuda_fq.fq_mul(a, b)
        assert torch.equal(out, cuda_fq.fq_mul_plain(a, b))
        a2 = torch.stack([a, b], dim=1).contiguous()
        b2 = torch.stack([b, a.roll(1, 0)], dim=1).contiguous()
        assert torch.equal(cuda_fq.fq2_mul(a2, b2), cuda_fq.fq2_mul_plain(a2, b2))
        assert cuda_fq.LAUNCHES["fq_mul"] == before["fq_mul"] + 1
        assert cuda_fq.LAUNCHES["fq2_mul"] == before["fq2_mul"] + 1


# The CUDA source compiled by the host's C++ compiler: the CUDA keywords are
# defined away, each CUDA thread of a block is a std::thread, __syncthreads
# is a std::barrier and the <<<grid, block>>> launch is a loop over blocks.
# This runs the kernels' own arithmetic (not the plain versions) on the CPU.
_HOST_PRELUDE = r"""
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
struct D3 { unsigned x; };
struct int4 { int x, y, z, w; };
static thread_local D3 blockIdx, threadIdx;
static std::barrier<>* g_bar;
static void __syncthreads() { g_bar->arrive_and_wait(); }
#define cudaMemcpyToSymbol(sym, src, n) (memcpy(sym, src, n), 0)
static int cudaGetLastError() { return 0; }
static const char* cudaGetErrorString(int) { return ""; }
#define LAUNCH(kern, grid, ...)                                          \
  for (unsigned bx = 0; bx < grid; ++bx) {                               \
    std::barrier<> bar(THREADS);                                         \
    g_bar = &bar;                                                        \
    std::vector<std::thread> ts;                                         \
    for (unsigned tx = 0; tx < THREADS; ++tx)                            \
      ts.emplace_back([=] { blockIdx.x = bx; threadIdx.x = tx; kern(__VA_ARGS__); }); \
    for (auto& t : ts) t.join();                                         \
  }
"""


def test_cuda_source_on_host_compiler(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    src = cuda_fq.SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>", _HOST_PRELUDE)
    src, launches = re.subn(
        r"(\w+)<<<grid_for\(n\), THREADS, 0, \(cudaStream_t\)stream>>>\((.*?)\);",
        r"LAUNCH(\1, grid_for(n), \2);", src)
    assert launches == 2
    (tmp_path / "fq_mul_host.cc").write_text(src)
    lib_path = tmp_path / "libfq_mul_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-o", str(lib_path), str(tmp_path / "fq_mul_host.cc")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    lib.lt_fq_init.argtypes = [ptr]
    for fn in (lib.lt_fq_mul, lib.lt_fq2_mul):
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr]
    table = cuda_fq.reduction_table()
    assert lib.lt_fq_init(table.ctypes.data) == 0
    for kind in KINDS:
        a, b, _, _ = _operands(kind, N, seed=60 + KINDS.index(kind))
        a, b = np.ascontiguousarray(a, np.int32), np.ascontiguousarray(b, np.int32)
        out = np.empty_like(a)
        assert lib.lt_fq_mul(a.ctypes.data, b.ctypes.data, out.ctypes.data, N, None) == 0
        assert np.array_equal(out, cuda_fq.fq_mul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy())
        a2 = np.ascontiguousarray(np.stack([a, np.roll(b, 1, 0)], axis=1))
        b2 = np.ascontiguousarray(np.stack([b, np.roll(a, 2, 0)], axis=1))
        out2 = np.empty_like(a2)
        assert lib.lt_fq2_mul(a2.ctypes.data, b2.ctypes.data, out2.ctypes.data, N, None) == 0
        assert np.array_equal(out2, cuda_fq.fq2_mul_plain(torch.as_tensor(a2), torch.as_tensor(b2)).numpy())

