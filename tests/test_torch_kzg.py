"""The port's blob-KZG batch verifier vs the JAX package.

Tolerance: exact.  The port keeps the JAX package's formulas and Fq
pipeline, so the same inputs give the same bytes, the same verdicts and the
same int32 limbs.  Inputs come from a seed (``random`` / numpy / SHA-256
counters) and go to both packages; the port runs on the CPU, where the Fq
wrappers use the kernels' plain versions.

- ``ec.scalar_mul_bits`` / ``point_neg`` / ``point_select`` on G1;
- ``_build_kzg_batch`` arrays at buckets 2 and 8;
- the device program's ``fe`` against the JAX ``_device_kzg_batch`` at
  bucket 2, on a valid and a tampered batch (one JAX compile, module scope);
- the ``tests/test_kzg.py`` cases through the port's ``Kzg`` on
  ``device="cpu"`` and on the host model (``device=None``), against the JAX
  package's host verdicts and bytes, on a width-64 dev setup;
- the vendored mainnet trusted setup loaded by both packages;
- the default device, the entry-point registry, and (on a card) card/CPU
  parity of ``fe``.
"""

import ast
import hashlib
import os
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.kzg import Kzg as JKzg  # noqa: E402
from lighthouse_tpu.crypto.kzg import KzgError as JKzgError  # noqa: E402
from lighthouse_tpu.crypto.kzg import TrustedSetup as JSetup  # noqa: E402
from lighthouse_tpu.ops import batch_axes as jbatch_axes  # noqa: E402
from lighthouse_tpu.ops import ec as jec  # noqa: E402
from lighthouse_tpu.ops import fq as jfq  # noqa: E402
from lighthouse_tpu.ops import kzg_device as jkd  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import curve  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.params import R  # noqa: E402
from lighthouse_tpu_torch.crypto.kzg import (  # noqa: E402
    BLS_MODULUS, Kzg, KzgError, TrustedSetup, blob_to_polynomial,
)
from lighthouse_tpu_torch.crypto.kzg.kzg import _bytes_to_g1, _g1_to_curve_point  # noqa: E402
from lighthouse_tpu_torch.ops import batch_axes, ec, kzg_device, pairing  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINNET_SETUP = os.path.join(REPO_ROOT, "tests", "vectors", "mainnet_trusted_setup.json")
WIDTH = 64
TAU = 0x5EC2E7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: on these tiny tensors its parallel
    regions cost more than they save, and in a parallel test run every
    worker's thread pool would compete for the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def jax_int32_backend():
    """Pin the JAX package's Fq lowering to the int32 path the port keeps
    (the fresh jitted closures below trace with it)."""
    prev = jfq.set_fq_backend("int32")
    yield
    jfq.set_fq_backend(prev)


def make_blob(seed: int, width: int = WIDTH) -> bytes:
    out = b""
    for i in range(width):
        x = int.from_bytes(hashlib.sha256(f"{seed}:{i}".encode()).digest(), "big")
        out += (x % BLS_MODULUS).to_bytes(32, "big")
    return out


@pytest.fixture(scope="module")
def setups():
    return (TrustedSetup.insecure_dev_setup(width=WIDTH, secret=TAU),
            JSetup.insecure_dev_setup(width=WIDTH, secret=TAU))


@pytest.fixture(scope="module")
def blobs(setups):
    """Five blobs with their commitments and proofs, made by the JAX
    package's host model."""
    ref = JKzg(setups[1])
    bl = [make_blob(40 + i) for i in range(5)]
    cs = [ref.blob_to_kzg_commitment(b) for b in bl]
    ps = [ref.compute_blob_kzg_proof(b, c) for b, c in zip(bl, cs)]
    return bl, cs, ps


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port_out, jax_out):
    if isinstance(port_out, tuple):
        assert len(port_out) == len(jax_out)
        for p, j in zip(port_out, jax_out):
            _same(p, j)
        return
    p, j = _np(port_out), _np(jax_out)
    assert p.dtype == j.dtype and p.shape == j.shape
    assert np.array_equal(p, j)


def _t(pt):
    return tuple(torch.as_tensor(np.asarray(c)) for c in pt)


# -------------------------------------------------------------- (a) curve ops


def _g1_rows(rng):
    """Three G1 rows: a random point, the identity, a random point."""
    pts = [curve.mul(curve.G1, rng.randrange(1, R)), None,
           curve.mul(curve.G1, rng.randrange(1, R))]
    limbs = [ec.g1_to_limbs(p) for p in pts]
    return pts, tuple(np.stack([row[c] for row in limbs]) for c in range(3))


@pytest.mark.parametrize("nbits", [16, 256])
def test_scalar_mul_bits_neg_select_equal_jax(nbits):
    rng = random.Random(0xEC + nbits)
    pts, p = _g1_rows(rng)
    ks = [rng.getrandbits(nbits) | 1, rng.getrandbits(nbits), 0]  # row 2: zero scalar
    bits = np.stack([ec.bits_msb(k, nbits) for k in ks])
    port = ec.scalar_mul_bits(ec.G1_OPS, _t(p), torch.as_tensor(bits))
    ref = jax.jit(lambda q, b: jec.scalar_mul_bits(jec.G1_OPS, q, b))(p, bits)
    _same(port, ref)
    for i, (pt, k) in enumerate(zip(pts, ks)):
        want = None if pt is None or k == 0 else curve.mul(pt, k)
        assert ec.g1_from_limbs(tuple(c[i] for c in port)) == want
    _same(ec.point_neg(port), jec.point_neg(ref))
    flag = np.array([True, False, True])
    _same(ec.point_select(torch.as_tensor(flag), port, _t(p)),
          jax.jit(lambda f, a, b: jec.point_select(f, a, b))(flag, ref, p))


def test_generator_limbs_equal_jax():
    _same(tuple(ec.G1_GEN_LIMBS), tuple(jec.G1_GEN_LIMBS))
    _same(tuple(ec.G2_GEN_LIMBS), tuple(jec.G2_GEN_LIMBS))


# ---------------------------------------------------------- (b) host marshal


def _batch_inputs(n, seed):
    """Parsed host inputs of an n-blob batch; the last proof is infinity."""
    rng = random.Random(seed)
    c_pts = [curve.mul(curve.G1, rng.randrange(1, R)) for _ in range(n)]
    p_pts = [curve.mul(curve.G1, rng.randrange(1, R)) for _ in range(n - 1)] + [None]
    r = rng.randrange(1, R)
    r_powers = [pow(r, i, R) for i in range(n)]
    zs = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    return c_pts, p_pts, r_powers, zs, ys, curve.mul(curve.G2, TAU)


@pytest.mark.parametrize("n,nb", [(2, 2), (5, 8)])
def test_build_kzg_batch_equals_jax(n, nb):
    args = _batch_inputs(n, seed=n)
    assert kzg_device._bucket(n) == jkd._bucket(n) == nb
    ours = kzg_device._build_kzg_batch(*args, nb)
    _same(ours, tuple(tuple(np.asarray(x) for x in a) if isinstance(a, tuple)
                      else np.asarray(a) for a in jkd._build_kzg_batch(*args, nb)))
    assert ours[0][0].shape == (nb, 25) and ours[2].shape == (nb, 256)
    tensors = kzg_device.batch_from_numpy(ours, "cpu")
    _same(tensors, ours)


def test_bucket_raises_above_512():
    assert kzg_device.N_BUCKETS == jkd.N_BUCKETS
    with pytest.raises(ValueError):
        kzg_device._bucket(513)


# ------------------------------------------------------ (c) device program fe


@pytest.fixture(scope="module")
def jax_kzg_program():
    """The JAX package's device program, traced once with the int32 Fq
    lowering (a fresh closure, so no earlier trace is reused)."""
    return jax.jit(lambda *a: jkd._device_kzg_batch.__wrapped__(*a))


def _two_blob_batch(setups, blobs, tamper: bool):
    """The host arrays of a bucket-2 batch of two valid blobs, with one
    ``y`` changed to ``y + 1 mod R`` if ``tamper``."""
    kzg = Kzg(setups[0], device=None)
    bl, cs, ps = blobs
    bl, cs, ps = bl[:2], cs[:2], ps[:2]
    zs = [kzg.compute_challenge(b, c) for b, c in zip(bl, cs)]
    ys = [kzg.evaluate_polynomial_in_evaluation_form(blob_to_polynomial(b, WIDTH), z)
          for b, z in zip(bl, zs)]
    r_powers = kzg._compute_r_powers(cs, zs, ys, ps)
    if tamper:
        ys[1] = (ys[1] + 1) % R
    c_pts = [_g1_to_curve_point(_bytes_to_g1(c)) for c in cs]
    p_pts = [_g1_to_curve_point(_bytes_to_g1(p)) for p in ps]
    return kzg_device._build_kzg_batch(c_pts, p_pts, r_powers, zs, ys,
                                       setups[0].g2_monomial[1], 2)


@pytest.mark.parametrize("tamper", [False, True], ids=["valid", "tampered"])
def test_fe_equals_jax_device_kzg_batch(setups, blobs, jax_kzg_program, tamper):
    host_batch = _two_blob_batch(setups, blobs, tamper)
    fe_j = jax_kzg_program(*host_batch)
    fe_p = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cpu"))
    assert fe_p.shape == (2, 3, 2, 25)
    assert np.array_equal(fe_p.numpy(), np.asarray(fe_j))
    assert pairing.fe_is_one(fe_p) is (not tamper)


def test_stacked_program_equals_separate_scalar_muls(setups, blobs):
    """The stacked 3N+1-row scalar multiplication and (3, N) tree-sum give
    the limbs of the reference's four scalar multiplications and three
    tree-sums, run one by one as the JAX package runs them (on the scalars'
    low 16 bits: every step is row-wise whatever the bit count)."""
    c, p, r_bits, rz_bits, ry_bits, _, _ = kzg_device.batch_from_numpy(
        _two_blob_batch(setups, blobs, tamper=False), "cpu")
    r_bits, rz_bits, ry_bits = r_bits[:, -16:], rz_bits[:, -16:], ry_bits[-16:]
    ops = ec.G1_OPS
    muls = [ec.scalar_mul_bits(ops, c, r_bits), ec.scalar_mul_bits(ops, p, r_bits),
            ec.scalar_mul_bits(ops, p, rz_bits)]
    sums = [ec.tree_sum(ops, m, axis=0) for m in muls]
    gen = tuple(torch.as_tensor(x) for x in ec.G1_GEN_LIMBS)
    gen_ry = ec.scalar_mul_bits(ops, gen, ry_bits)
    pts = tuple(torch.cat([ci, pi, pi, gi[None]]) for ci, pi, gi in zip(c, p, gen))
    stacked = ec.scalar_mul_bits(ops, pts, torch.cat([r_bits, r_bits, rz_bits, ry_bits[None]]))
    _same(tuple(x[6] for x in stacked), gen_ry)
    lincombs = ec.tree_sum(ops, tuple(x[:6].reshape(3, 2, -1) for x in stacked), axis=1)
    for i in range(3):
        _same(tuple(x[i] for x in lincombs), sums[i])


# ------------------------------------------------ (d) the test_kzg.py cases


DEVICES = ["cpu", None]


@pytest.fixture(scope="module")
def ports(setups):
    return {d: Kzg(setups[0], device=d) for d in DEVICES}


@pytest.fixture(scope="module")
def ref(setups):
    return JKzg(setups[1])


def test_commitment_and_proof_bytes_equal_jax(ports, ref, blobs):
    bl, cs, ps = blobs
    port = ports[None]
    for b, c, p in zip(bl[:2], cs, ps):
        assert port.blob_to_kzg_commitment(b) == c
        assert port.compute_blob_kzg_proof(b, c) == p
    z = (777777).to_bytes(32, "big")
    assert port.compute_kzg_proof(bl[0], z) == ref.compute_kzg_proof(bl[0], z)


@pytest.mark.parametrize("device", DEVICES, ids=["cpu", "host"])
@pytest.mark.parametrize("case", ["roundtrip", "one_bad_proof", "empty", "single_blob"])
def test_batch_verdict_equals_jax_host(ports, ref, blobs, device, case):
    bl, cs, ps = (list(x) for x in blobs)
    if case == "roundtrip":
        args = (bl[:4], cs[:4], ps[:4])
    elif case == "one_bad_proof":
        ps[1], ps[2] = ps[2], ps[1]
        args = (bl[:3], cs[:3], ps[:3])
    elif case == "empty":
        args = ([], [], [])
    else:
        args = (bl[4:], cs[4:], ps[4:])
    want = {"roundtrip": True, "one_bad_proof": False, "empty": True, "single_blob": True}[case]
    theirs = ref.verify_blob_kzg_proof_batch(*args)
    assert theirs is want
    assert ports[device].verify_blob_kzg_proof_batch(*args) is theirs


def _noncanonical(port):
    blob = BLS_MODULUS.to_bytes(32, "big") + make_blob(30)[32:]
    return port.blob_to_kzg_commitment, (blob,)


def _bad_length(port):
    return port.blob_to_kzg_commitment, (b"\x00" * 31,)


def _not_on_curve(port):
    proof = b"\xc0" + b"\x00" * 47  # infinity: fine
    bad_commitment = b"\x80" + b"\x11" * 47
    return port.verify_blob_kzg_proof, (make_blob(31), bad_commitment, proof)


@pytest.mark.parametrize("device", DEVICES, ids=["cpu", "host"])
@pytest.mark.parametrize("case", [_noncanonical, _bad_length, _not_on_curve],
                         ids=["noncanonical_blob", "bad_length", "not_on_curve_commitment"])
def test_rejections_equal_jax(ports, ref, device, case):
    fn, args = case(ref)
    with pytest.raises(JKzgError):
        fn(*args)
    fn, args = case(ports[device])
    with pytest.raises(KzgError):
        fn(*args)


def test_batch_rejects_bad_commitment_like_jax(ports, ref, blobs):
    bl, cs, ps = (list(x) for x in blobs)
    cs[1] = b"\x80" + b"\x11" * 47
    with pytest.raises(JKzgError):
        ref.verify_blob_kzg_proof_batch(bl[:2], cs[:2], ps[:2])
    with pytest.raises(KzgError):
        ports["cpu"].verify_blob_kzg_proof_batch(bl[:2], cs[:2], ps[:2])


# ---------------------------------------------------- (e) mainnet setup file


def test_mainnet_setup_equals_jax():
    with open(MAINNET_SETUP) as f:
        text = f.read()
    ours = TrustedSetup.from_json(text, validate=False)
    theirs = JSetup.from_json(text, validate=False)
    assert ours.width == theirs.width == 4096
    assert len(ours.g2_monomial) == len(theirs.g2_monomial) == 65
    ints = lambda pt: tuple((c.c0, c.c1) for c in pt)  # noqa: E731  (Fq2 pairs of two packages)
    assert ints(ours.g2_monomial[1]) == ints(theirs.g2_monomial[1])
    assert ours.g1_lagrange == theirs.g1_lagrange
    assert curve.in_g2(ours.g2_monomial[1])


# ----------------------------------------------------- (f) the default device


def test_default_device_is_cuda(setups):
    """``Kzg`` and the device entry point default to the card; without one
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        Kzg(setups[0])
    with pytest.raises(RuntimeError, match="cuda"):
        kzg_device.verify_kzg_proof_batch_device(*_batch_inputs(2, seed=1))
    assert Kzg(setups[0], device="cpu").device == torch.device("cpu")
    assert Kzg(setups[0], device=None).device is None


# ------------------------------------------------------------- the registry


def test_registry_agrees_with_jax():
    with open(os.path.join(REPO_ROOT, "lighthouse_tpu_torch", "ops", "batch_axes.py")) as f:
        tree = ast.parse(f.read())
    literal = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign) and node.targets[0].id == "BATCH_AXES")
    assert literal == batch_axes.BATCH_AXES
    keys = ("op", "batch_axis", "batched_args", "replicated_args",
            "reduces_over_batch", "out_batched")
    entries = ("ops/verify.py:_device_verify", "ops/kzg_device.py:_device_kzg_batch",
               "ops/sha256_device.py:_sha256_64byte_batch",
               "ops/tree_hash.py:_tree_hash_subtrees",
               "ops/epoch_device.py:_deltas_kernel",
               "ops/shuffle_device.py:_shuffle_kernel",
               "ops/shuffle_device.py:_proposer_kernel",
               "ops/shuffle_device.py:_boundary_kernel")
    for entry in entries:
        ours = batch_axes.BATCH_AXES[f"lighthouse_tpu_torch/{entry}"]
        theirs = jbatch_axes.BATCH_AXES[f"lighthouse_tpu/{entry}"]
        assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert set(batch_axes.BATCH_AXES) == {f"lighthouse_tpu_torch/{e}" for e in entries}


# -------------------------------------------------------- (g) on the card


@pytest.mark.cuda
def test_card_fe_equals_cpu(setups, blobs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    host_batch = _two_blob_batch(setups, blobs, tamper=False)
    fe_gpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cuda"))
    fe_cpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cpu"))
    assert torch.equal(fe_gpu.cpu(), fe_cpu)
    assert pairing.fe_is_one(fe_gpu)
