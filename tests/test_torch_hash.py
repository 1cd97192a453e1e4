"""The port's SHA-256 and tree-hashing slice vs the JAX package and hashlib.

``lighthouse_tpu_torch.ops.cuda_sha`` holds two CUDA kernels
(``csrc/sha256.cu``) and their plain PyTorch versions; on a CPU tensor the
wrappers run the plain versions.  Every comparison here is exact (digests
are bytes, levels are 32-bit words; tolerance zero):

- the plain versions against the JAX package's XLA programs
  (``sha256_device._sha256_64byte_batch``, ``tree_hash._tree_hash_subtrees``,
  jitted on the CPU) on the same words, made with numpy from a seed;
- ``hash_pairs_device(..., device="cpu")`` against the JAX package's
  ``hash_pairs_device`` and hashlib (the cases of
  ``tests/test_sha256_device.py``);
- the CUDA source itself, compiled by g++ with the CUDA keywords defined
  away (one std::thread per CUDA thread), against the plain versions,
  including counts that end inside a block;
- the cases of ``tests/test_tree_hash.py`` re-pointed at the port with
  ``device="cpu"``, each tree also held against the JAX package's
  ``golden_root``.  On the CPU the supervisor's failure routes may reach
  the host model, as in the JAX package; on the card they raise
  (``chip_smoke.py`` ``[faults]``).

``test_kernels_on_card`` (marker ``cuda``) runs the kernels themselves and
skips without a card.
"""

import contextlib
import ctypes
import hashlib
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lighthouse_tpu.ops import sha256_device as jsha  # noqa: E402
from lighthouse_tpu.ops import tree_hash as jth  # noqa: E402
from lighthouse_tpu_torch import (  # noqa: E402
    device_pipeline,
    device_supervisor,
    device_telemetry,
    fault_injection as fi,
    metrics,
)
from lighthouse_tpu_torch.ops import cuda_sha  # noqa: E402
from lighthouse_tpu_torch.ops import sha256_device as sd  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402

LIMIT = 1 << 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    fi.clear()
    device_pipeline.reset_for_tests()
    th.reset_for_tests()
    th.configure(device="cpu")
    yield
    fi.clear()
    device_pipeline.reset_for_tests()
    device_supervisor.reset_for_tests()
    th.reset_for_tests()


@contextlib.contextmanager
def _device(min_subtrees=1, min_blocks=1):
    th.configure(enabled=True, device_min_subtrees=min_subtrees,
                 device_min_blocks=min_blocks)
    try:
        yield
    finally:
        th.configure(enabled=False)


def _leaves(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint32)


def _hashlib_pairs(buf: bytes) -> bytes:
    return b"".join(hashlib.sha256(buf[i:i + 64]).digest() for i in range(0, len(buf), 64))


def _assert_levels(levels, golden):
    assert len(levels) == th.SUBTREE_DEPTH
    for lv, g in zip(levels, golden):
        assert np.array_equal(lv, th._words_to_chunks(g))


# ------------------------------------------- plain versions vs the JAX programs


def test_pair_plain_matches_jax_program():
    words = _words((256, 16), seed=1)
    ours = sd._sha256_64byte_batch(torch.from_numpy(words.view(np.int32)))
    theirs = np.asarray(jsha._sha256_64byte_batch(jnp.asarray(words)))
    assert np.array_equal(ours.numpy().view(np.uint32), theirs)


def test_subtree_plain_matches_jax_program():
    leaves = _words((8, 32, 8), seed=2)
    ours = th._tree_hash_subtrees(torch.from_numpy(leaves.view(np.int32)))
    theirs = jth._tree_hash_subtrees(jnp.asarray(leaves))
    assert len(ours) == len(theirs) == 5
    for o, t in zip(ours, theirs):
        assert np.array_equal(o.numpy().view(np.uint32), np.asarray(t))


@pytest.mark.parametrize("nblocks", [0, 1, 2, 31, 256, 257, 1000])
def test_hash_pairs_device_matches_jax_and_hashlib(nblocks):
    buf = np.random.default_rng(nblocks).integers(0, 256, 64 * nblocks, dtype=np.uint8).tobytes()
    ours = sd.hash_pairs_device(buf, device="cpu")
    assert ours == _hashlib_pairs(buf)
    assert ours == jsha.hash_pairs_device(buf)


def test_bucket_vocabulary_matches_jax():
    assert sd.N_BUCKETS == jsha.N_BUCKETS
    assert th.N_BUCKETS == jth.N_BUCKETS
    for n in (1, 256, 257, 262144):
        assert sd._bucket(n) == jsha._bucket(n, jsha.N_BUCKETS)
    with pytest.raises(ValueError):
        sd._bucket(sd.N_BUCKETS[-1] + 1)


def test_constants_match_jax():
    assert np.array_equal(cuda_sha._K, jsha._K)
    assert np.array_equal(cuda_sha._H0, jsha._H0)
    assert np.array_equal(cuda_sha._PAD_WORDS, jsha._PAD_WORDS)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrappers_reject_bad_operands(bad):
    words = torch.zeros(4, 16, dtype=torch.int32)
    leaves = torch.zeros(2, 32, 8, dtype=torch.int32)
    if bad == "dtype":
        words, leaves = words.long(), leaves.long()
    elif bad == "shape":
        words, leaves = words[:, :15], leaves[:, :31]
    elif bad == "contiguity":
        words = torch.zeros(16, 4, dtype=torch.int32).t()
        leaves = torch.zeros(8, 32, 2, dtype=torch.int32).permute(2, 1, 0)
    else:
        words, leaves = words.to("meta"), leaves.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cuda_sha.sha256_pairs(words)
    with pytest.raises((TypeError, ValueError)):
        cuda_sha.tree_hash_subtrees(leaves)


def test_cpu_path_launches_no_kernel():
    cuda_sha.reset_launch_counts()
    sd.hash_pairs_device(b"\x01" * 128, device="cpu")
    th.hash_subtree_levels(_leaves(32))
    assert cuda_sha.LAUNCHES == {"sha256_pairs": 0, "tree_hash_subtrees": 0}


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        sd.hash_pairs_device(b"\x00" * 64)
    th.reset_for_tests()  # the default device: the card
    with pytest.raises(RuntimeError, match="is_available"):
        th.hash_subtree_levels(_leaves(32))


@pytest.mark.cuda
def test_kernels_on_card():
    """Both CUDA kernels equal their plain versions word for word on the
    card, on counts that end inside a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for n in (1, 255, 256, 257, 1000):
        words = torch.from_numpy(_words((n, 16), seed=n).view(np.int32))
        before = cuda_sha.LAUNCHES["sha256_pairs"]
        out = cuda_sha.sha256_pairs(words.cuda()).cpu()
        assert torch.equal(out, cuda_sha.sha256_pairs_plain(words))
        assert cuda_sha.LAUNCHES["sha256_pairs"] == before + 1
    for m in (1, 7, 8, 9, 130):
        leaves = torch.from_numpy(_words((m, 32, 8), seed=m).view(np.int32))
        out = cuda_sha.tree_hash_subtrees(leaves.cuda())
        for o, p in zip(out, cuda_sha.tree_hash_subtrees_plain(leaves)):
            assert torch.equal(o.cpu(), p)


# ------------------------------------------- the CUDA source through g++

# The CUDA source compiled by the host's C++ compiler: the CUDA keywords are
# defined away, each CUDA thread of a block is a std::thread, __syncthreads
# is a std::barrier, __funnelshift_r is its definition on 64 bits, and each
# <<<grid, threads>>> launch is a loop over blocks.  This runs the kernels'
# own arithmetic and thread layout (not the plain versions) on the CPU.
_HOST_PRELUDE = r"""
#include <stdint.h>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __constant__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
struct D3 { unsigned x; };
struct uint4 { unsigned x, y, z, w; };
static uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
static unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
static thread_local D3 blockIdx, threadIdx;
static std::barrier<>* g_bar;
static void __syncthreads() { g_bar->arrive_and_wait(); }
static int cudaGetLastError() { return 0; }
static const char* cudaGetErrorString(int) { return ""; }
#define LAUNCH(kern, grid, threads, ...)                                 \
  for (unsigned bx = 0; bx < grid; ++bx) {                               \
    std::barrier<> bar(threads);                                         \
    g_bar = &bar;                                                        \
    std::vector<std::thread> ts;                                         \
    for (unsigned tx = 0; tx < (unsigned)threads; ++tx)                  \
      ts.emplace_back([=] { blockIdx.x = bx; threadIdx.x = tx; kern(__VA_ARGS__); }); \
    for (auto& t : ts) t.join();                                         \
  }
"""


@pytest.fixture(scope="module")
def host_sha(tmp_path_factory):
    """The CUDA source built by g++ into a shared library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    src = cuda_sha.SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>", _HOST_PRELUDE)
    src, launches = re.subn(
        r"(\w+)<<<(blocks\(\w+, \w+\)), (\w+), 0, \(cudaStream_t\)stream>>>\((.*?)\);",
        r"LAUNCH(\1, \2, \3, \4);", src)
    assert launches == 2
    tmp = tmp_path_factory.mktemp("host_sha")
    (tmp / "sha256_host.cc").write_text(src)
    lib_path = tmp / "libsha256_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(cuda_sha.SOURCE.parent),  # sha256_compress.cuh
                          "-o", str(lib_path), str(tmp / "sha256_host.cc")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.lt_sha256_pairs, lib.lt_tree_hash_subtrees):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("n", [1, 255, 256, 257, 600])
def test_cuda_source_pairs_on_host_compiler(host_sha, n):
    words = _words((n, 16), seed=100 + n)
    out = np.full((n + 1, 8), 0x5A5A5A5A, dtype=np.uint32)  # one guard row
    assert host_sha.lt_sha256_pairs(words.ctypes.data, out.ctypes.data, n, None) == 0
    plain = cuda_sha.sha256_pairs_plain(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(out[:n], plain.numpy().view(np.uint32))
    assert (out[n] == 0x5A5A5A5A).all()
    assert out[:n].astype(">u4").tobytes() == _hashlib_pairs(words.astype(">u4").tobytes())


@pytest.mark.parametrize("m", [1, 7, 8, 9, 20])
def test_cuda_source_subtrees_on_host_compiler(host_sha, m):
    leaves = _words((m, 32, 8), seed=200 + m)
    out = np.full(31 * m * 8 + 8, 0x5A5A5A5A, dtype=np.uint32)
    assert host_sha.lt_tree_hash_subtrees(leaves.ctypes.data, out.ctypes.data, m, None) == 0
    plain = cuda_sha.tree_hash_subtrees_plain(torch.from_numpy(leaves.view(np.int32)))
    start = 0
    for level in plain:
        size = level.numel()
        assert np.array_equal(out[start:start + size].reshape(level.shape),
                              level.numpy().view(np.uint32))
        start += size
    assert (out[start:] == 0x5A5A5A5A).all()
    golden = jth._host_subtree_levels(leaves)
    assert np.array_equal(out[start - 8 * m:start].reshape(m, 1, 8), golden[-1])


# --------------------------------- tests/test_tree_hash.py, re-pointed


class TestSubtreeKernel:
    def test_levels_match_hashlib_golden(self):
        chunks = _leaves(2 * th.SUBTREE_LEAVES)
        golden = th._host_subtree_levels(th._chunks_to_words(chunks))
        _assert_levels(th.hash_subtree_levels(chunks), golden)
        assert all(np.array_equal(a, b) for a, b in
                   zip(golden, jth._host_subtree_levels(jth._chunks_to_words(chunks))))

    def test_bucket_promotion(self):
        for m in (1, 8, 9, 128, 129):
            assert th._bucket(m) == jth._bucket(m)
        with pytest.raises(ValueError):
            th._bucket(th.N_BUCKETS[-1] + 1)

    def test_non_subtree_multiple_rejected(self):
        with pytest.raises(ValueError):
            th.hash_subtree_levels(_leaves(33))

    def test_oversized_level_chunks_through_top_bucket(self):
        chunks = _leaves(24 * th.SUBTREE_LEAVES, seed=29)
        golden = th._host_subtree_levels(th._chunks_to_words(chunks))
        real = th.N_BUCKETS
        th.N_BUCKETS = (8,)
        try:
            levels = th.hash_subtree_levels(chunks)
        finally:
            th.N_BUCKETS = real
        _assert_levels(levels, golden)
        recs = device_telemetry.FLIGHT_RECORDER.recent(3, op="tree_hash")
        assert [r["shape"] for r in recs] == ["8", "8", "8"]

    def test_padded_subtrees_are_sliced_off_and_recorded(self):
        chunks = _leaves(3 * th.SUBTREE_LEAVES)
        levels = th.hash_subtree_levels(chunks)
        assert [len(lv) for lv in levels] == [48, 24, 12, 6, 3]
        rec = device_telemetry.FLIGHT_RECORDER.recent(1, op="tree_hash")[0]
        assert (rec["shape"], rec["n_live"], rec["occupancy_sets"]) == ("8", 3, 0.375)


class TestDeviceLeafTree:
    @pytest.mark.parametrize("device", [False, True])
    def test_parity_through_sizes_and_mutations(self, device):
        ctx = _device() if device else contextlib.nullcontext()
        rng = np.random.default_rng(3)
        with ctx:
            for n in (0, 1, 31, 32, 33, 96, 100, 257):
                leaves = _leaves(n, seed=n)
                tree = th.DeviceLeafTree(LIMIT)
                root = tree.update(leaves)
                assert root == th.golden_root(leaves, LIMIT) == jth.golden_root(leaves, LIMIT)
                if not n:
                    continue
                mutated = leaves.copy()
                mutated[rng.integers(0, n)] ^= 0x5A
                assert tree.update(mutated) == jth.golden_root(mutated, LIMIT)
                grown = np.concatenate([mutated, _leaves(7, seed=n + 1)])
                assert tree.update(grown) == jth.golden_root(grown, LIMIT)
                assert tree.update(mutated[: n // 2 + 1]) == jth.golden_root(
                    mutated[: n // 2 + 1], LIMIT)

    def test_unchanged_update_hashes_nothing(self, monkeypatch):
        leaves = _leaves(64)
        tree = th.DeviceLeafTree(LIMIT)
        tree.update(leaves)
        calls = {"blocks": 0}
        real = th.hash_pairs

        def counting(data):
            calls["blocks"] += len(data) // 64
            return real(data)

        monkeypatch.setattr(th, "hash_pairs", counting)
        root = tree.update(leaves.copy())
        assert calls["blocks"] == 0
        assert root == jth.golden_root(leaves, LIMIT)

    def test_incremental_cost_scales_with_dirty_leaves(self, monkeypatch):
        n = 4096
        leaves = _leaves(n)
        tree = th.DeviceLeafTree(LIMIT)
        tree.update(leaves)
        calls = {"blocks": 0}
        real = th.hash_pairs

        def counting(data):
            calls["blocks"] += len(data) // 64
            return real(data)

        mutated = leaves.copy()
        mutated[123] ^= 0xFF
        monkeypatch.setattr(th, "hash_pairs", counting)
        root = tree.update(mutated)
        assert calls["blocks"] <= 16, calls["blocks"]
        assert root == jth.golden_root(mutated, LIMIT)

    def test_zero_cap_folding_matches_limit_semantics(self):
        leaves = _leaves(5)
        for limit in (8, 64, 1 << 12):
            tree = th.DeviceLeafTree(limit)
            assert tree.update(leaves) == jth.golden_root(leaves, limit)


class TestSupervisedTreeHash:
    def test_injected_fault_split_retries_then_matches_golden(self):
        chunks = _leaves(4 * th.SUBTREE_LEAVES, seed=9)
        fi.install("device.dispatch", "error", op="tree_hash", first_n=1)
        before = metrics.DEVICE_SPLIT_RETRIES.get(op="tree_hash", outcome="success")
        levels = th.hash_subtree_levels(chunks)
        assert metrics.DEVICE_SPLIT_RETRIES.get(op="tree_hash", outcome="success") == before + 1
        _assert_levels(levels, th._host_subtree_levels(th._chunks_to_words(chunks)))

    def test_pair_fault_split_retries_then_matches_hashlib(self):
        buf = _leaves(40, seed=31).tobytes()
        fi.install("device.dispatch", "error", op="sha256_pairs", first_n=1)
        before = metrics.DEVICE_SPLIT_RETRIES.get(op="sha256_pairs", outcome="success")
        assert sd.hash_pairs_device(buf, device="cpu") == _hashlib_pairs(buf)
        assert metrics.DEVICE_SPLIT_RETRIES.get(op="sha256_pairs", outcome="success") == before + 1

    def test_breaker_open_routes_to_hashlib_golden_on_cpu(self):
        device_supervisor.SUPERVISOR.configure(
            config=device_supervisor.BreakerConfig(failure_threshold=1, open_cooldown_s=300.0))
        device_supervisor.SUPERVISOR.breaker("tree_hash").record_failure("device_error")
        assert device_supervisor.breaker_state("tree_hash") == "open"
        before = metrics.DEVICE_HOST_FALLBACK.get(reason="breaker_open")
        chunks = _leaves(th.SUBTREE_LEAVES, seed=11)
        levels = th.hash_subtree_levels(chunks)
        assert metrics.DEVICE_HOST_FALLBACK.get(reason="breaker_open") == before + 1
        _assert_levels(levels, th._host_subtree_levels(th._chunks_to_words(chunks)))

    def test_tree_survives_every_dispatch_faulted_on_cpu(self):
        device_supervisor.SUPERVISOR.configure(
            config=device_supervisor.BreakerConfig(failure_threshold=1, open_cooldown_s=300.0))
        fi.install("device.dispatch", "error", op="tree_hash")
        with _device():
            leaves = _leaves(100, seed=13)
            tree = th.DeviceLeafTree(LIMIT)
            assert tree.update(leaves) == jth.golden_root(leaves, LIMIT)
        assert device_supervisor.SUPERVISOR.breaker("tree_hash").snapshot()["trips_total"] >= 1

    def test_failure_raises_when_host_route_is_off(self, monkeypatch):
        """The card's rule (``host_on_failure=False``), taken here on the CPU
        tensors: a failure past the split retry raises, no host digest."""
        real = device_supervisor.SUPERVISOR.run

        def card_rule(*args, **kwargs):
            kwargs["host_on_failure"] = False
            return real(*args, **kwargs)

        monkeypatch.setattr(device_supervisor.SUPERVISOR, "run", card_rule)
        fi.install("device.dispatch", "error", op="tree_hash")
        before = metrics.DEVICE_HOST_FALLBACK.snapshot()
        with pytest.raises(fi.InjectedFault):
            th.hash_subtree_levels(_leaves(2 * th.SUBTREE_LEAVES, seed=15))
        assert metrics.DEVICE_HOST_FALLBACK.snapshot() == before


class TestPipelineRouting:
    def test_dirty_batch_rides_hash_pipeline(self):
        device_pipeline.enable(device="cpu")
        with _device():
            leaves = _leaves(256, seed=17)
            tree = th.DeviceLeafTree(LIMIT)
            tree.update(leaves)
            mutated = leaves.copy()
            mutated[::2] ^= 0x33
            assert tree.update(mutated) == jth.golden_root(mutated, LIMIT)
        snap = device_pipeline.summary()
        assert snap["hash"]["batches_total"] >= 1
        assert snap["arbiter"]["grants"].get("sha256_pairs", 0) >= 1

    def test_other_device_keeps_the_direct_path(self):
        device_pipeline.enable(device="cuda")
        assert not device_pipeline.routes_hash(128, device="cpu")
        with _device():
            data = _leaves(128, seed=19).reshape(-1, 64).tobytes()
            assert th.hash_pairs(data) == jth.golden_hash_pairs(data)
        assert device_pipeline.summary() is None

    def test_pipeline_shutdown_falls_back_to_direct(self):
        device_pipeline.enable(device="cpu")
        device_pipeline.shutdown()
        with _device():
            data = _leaves(128, seed=19).reshape(-1, 64).tobytes()
            assert th.hash_pairs(data) == jth.golden_hash_pairs(data)


def test_routes_are_counted():
    sd.reset_routes()
    with _device(min_subtrees=1, min_blocks=8):
        th.hash_pairs(b"\x00" * 64 * 4)
        th.hash_pairs(b"\x00" * 64 * 8)
        th.hash_subtree_levels(_leaves(64))
    th.hash_pairs(b"\x00" * 64 * 2)
    assert dict(sd.ROUTE_BLOCKS) == {"host_below": 4, "device_pairs": 8,
                                     "device_subtree": 62, "host_off": 2}


def test_route_counts_are_exact_across_threads():
    """The hash pipeline's callers note routes from many threads at once."""
    sd.reset_routes()

    def note():
        for _ in range(5000):
            sd.note_route("device_pairs", 2, 0.5)

    threads = [threading.Thread(target=note) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sd.ROUTE_BLOCKS == {"device_pairs": 80000}
    assert sd.ROUTE_SECONDS == {"device_pairs": 20000.0}
    sd.reset_routes()
