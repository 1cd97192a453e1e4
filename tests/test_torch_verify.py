"""The port's batch verifier vs the JAX package.

Every case of ``tests/test_backend_jax.py`` runs through the port's
``verify_signature_sets_device`` on the CPU (the kernels' plain versions) and
must give the JAX package's host-backend verdict.  The sets are built twice
from the same secret scalars, once with each package's API.  A fixed-seed
1-set batch goes through ``lighthouse_tpu.ops.verify._device_verify`` and the
port's device program from the same host arrays, and the two ``fe`` outputs
must be equal limb for limb.  Also: ``build_batch`` array equality,
``batch_from_numpy``, the W-at-infinity re-check (one host fallback,
counted under ``reason="w_at_infinity"``), the default device, and
import isolation from ``jax`` / ``lighthouse_tpu``.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.backends import host as jhost  # noqa: E402
from lighthouse_tpu.ops import fq as jfq  # noqa: E402
from lighthouse_tpu.ops import verify as jverify  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as papi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends.host import _rand_scalars  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.params import R  # noqa: E402
from lighthouse_tpu_torch.ops import verify as pverify  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = b"fixed"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: on these tiny tensors its parallel
    regions cost more than they save, and in a parallel test run every
    worker's thread pool would compete for the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Spec:
    """One signature set, as secret scalars and messages."""

    def __init__(self, msg, keys, sig_keys=None, sig_msg=None, infinity=False,
                 pubkeys=True):
        self.msg, self.keys = msg, keys
        self.sig_keys = keys if sig_keys is None else sig_keys
        self.sig_msg = msg if sig_msg is None else sig_msg
        self.infinity, self.pubkeys = infinity, pubkeys

    def build(self, api):
        if self.infinity:
            sig = api.AggregateSignature.infinity()
        else:
            sk = api.SecretKey(sum(self.sig_keys) % R)  # = the aggregate of the signers'
            sig = api.AggregateSignature.from_signature(sk.sign(self.sig_msg))
        pks = [api.SecretKey(k).public_key() for k in self.keys] if self.pubkeys else []
        return api.SignatureSet(sig, self.msg, pks)


def _keys(rng, n):
    return [rng.randrange(1, R) for _ in range(n)]


def _cases():
    rng = random.Random(0x5E7)
    k = lambda n=1: _keys(rng, n)  # noqa: E731
    return {
        "single_valid_set": ([Spec(b"hello", k())], True),
        "multi_key_aggregate": ([Spec(b"agg", k(5))], True),
        "batch_of_sets_valid": ([Spec(bytes([i]), k()) for i in range(5)], True),
        "one_bad_set_fails_batch": (
            [Spec(bytes([i]), k()) for i in range(3)]
            + [Spec(b"x", k(), sig_keys=k(), sig_msg=b"wrong message")], False),
        "wrong_message_fails": ([Spec(b"claim that", k(), sig_msg=b"signed this")], False),
        "wrong_key_fails": ([Spec(b"m", k(), sig_keys=k())], False),
        "infinity_signature_fails": ([Spec(b"m", k(), infinity=True)], False),
        "no_pubkeys_fails": ([Spec(b"m", k(), pubkeys=False)], False),
        "duplicate_messages_batched": ([Spec(b"same data", k()) for _ in range(6)], True),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_verdict_equals_jax_host_backend(name):
    specs, expected = CASES[name]
    host = jhost.verify_signature_sets([s.build(japi) for s in specs], seed=SEED)
    port = pverify.verify_signature_sets_device([s.build(papi) for s in specs],
                                                seed=SEED, device="cpu")
    assert host is expected
    assert port is host


def test_empty_batch_fails():
    assert pverify.verify_signature_sets_device([], device="cpu") is False
    assert jhost.verify_signature_sets([]) is False


def test_api_layer_uses_torch_backend():
    pbackends.set_backend("host")
    try:
        pbackends._ACTIVE = pbackends._NAME = None  # as on first use
        sets = [Spec(b"via api", _keys(random.Random(3), 2)).build(papi)]
        assert papi.verify_signature_sets(sets, seed=b"s", device="cpu") is True
        assert pbackends.backend_name() == "torch"
    finally:
        pbackends.set_backend("torch")


def _fixed_sets(n_sets, n_keys, seed):
    rng = random.Random(seed)
    specs = [Spec(b"msg-%d" % i, _keys(rng, n_keys)) for i in range(n_sets)]
    return [s.build(japi) for s in specs], [s.build(papi) for s in specs]


def test_build_batch_equals_jax_and_batch_from_numpy():
    jsets, psets = _fixed_sets(3, 3, seed=7)  # buckets (4, 4): padding rows and keys
    rands = _rand_scalars(3, SEED)
    ours = pverify.build_batch(psets, rands)
    theirs = jverify.build_batch(jsets, rands)
    flat = lambda b: [*b[0], *b[1], *b[2], b[3], b[4]]  # noqa: E731
    for x, y in zip(flat(ours), flat(theirs)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert ours[0][0].shape == (4, 4, 25) and ours[4].tolist() == [True] * 3 + [False]
    tensors = pverify.batch_from_numpy(theirs, "cpu")
    for t, a in zip([*tensors[0], *tensors[1], *tensors[2], tensors[3], tensors[4]], flat(theirs)):
        assert t.device.type == "cpu"
        assert np.array_equal(t.numpy(), a)
    assert tensors[3].dtype == torch.int32 and tensors[4].dtype == torch.bool


def test_fe_equals_jax_device_verify():
    """Fixed-seed 1x1 batch: the port's device program and the JAX
    package's ``_device_verify`` give the same fe and W_z, limb for limb."""
    jsets, _ = _fixed_sets(1, 1, seed=8)
    host_batch = jverify.build_batch(jsets, _rand_scalars(1, SEED))
    prev = jfq.set_fq_backend("int32")
    try:
        fe_j, wz_j = jax.jit(lambda *a: jverify._device_verify.__wrapped__(*a))(*host_batch)
    finally:
        jfq.set_fq_backend(prev)
    fe_p, wz_p = pverify._device_verify(*pverify.batch_from_numpy(host_batch, "cpu"))
    assert fe_p.shape == (2, 3, 2, 25)
    assert np.array_equal(fe_p.numpy(), np.asarray(fe_j))
    assert np.array_equal(wz_p.numpy(), np.asarray(wz_j))
    assert pverify.pairing.fe_is_one(fe_p)


def test_w_at_infinity_is_decided_on_host():
    """Two sets whose weighted signatures cancel (sig2 = -(r1/r2) sig1 for
    the seeded weights r1, r2): W is the identity, the device result is
    disclaimed, and the host golden model decides (False: the signatures do
    not sign these messages)."""
    from lighthouse_tpu_torch.crypto.bls import curve

    r1, r2 = _rand_scalars(2, SEED)
    base = papi.SecretKey(12345).sign(b"anything").point
    other = curve.mul(base, (-r1 * pow(r2, -1, R)) % R)
    pk = [papi.SecretKey(99).public_key()]
    sets = [papi.SignatureSet(papi.Signature(base), b"m1", pk),
            papi.SignatureSet(papi.Signature(other), b"m2", pk)]
    from lighthouse_tpu_torch import device_supervisor, device_telemetry, metrics

    before = metrics.DEVICE_HOST_FALLBACK.get(reason="w_at_infinity")
    assert pverify.verify_signature_sets_device(sets, seed=SEED, device="cpu") is False
    assert metrics.DEVICE_HOST_FALLBACK.get(reason="w_at_infinity") == before + 1
    # a disclaimer, not a device failure: it counts as a breaker success
    snap = device_supervisor.SUPERVISOR.breaker("bls_verify").snapshot()
    assert snap["consecutive_failures"] == 0
    rec = device_telemetry.FLIGHT_RECORDER.recent(op="bls_verify")[0]
    assert rec["host_fallback"] is True and rec["fallback_reason"] == "w_at_infinity"


def test_default_device_is_cuda():
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    sets = [Spec(b"m", [7]).build(papi)]
    with pytest.raises(RuntimeError, match="cuda"):
        pverify.verify_signature_sets_device(sets, seed=SEED)
    pbackends._ACTIVE = pbackends._NAME = None  # the selector's default
    with pytest.raises(RuntimeError, match="cuda"):
        papi.verify_signature_sets(sets, seed=SEED)
    assert pbackends.backend_name() == "torch"
    with pytest.raises(RuntimeError, match="cuda"):
        pverify.batch_from_numpy(pverify.build_batch(sets, [1]), "cuda")


def test_import_isolation():
    """Every module of the port, and chip_smoke.py, imports with ``jax`` and
    ``lighthouse_tpu`` poisoned."""
    pkg = os.path.join(REPO_ROOT, "lighthouse_tpu_torch")
    modules = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO_ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                modules.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    assert "lighthouse_tpu_torch.ops.cuda_fq" in modules
    assert "lighthouse_tpu_torch.ops.kzg_device" in modules
    assert "lighthouse_tpu_torch.crypto.kzg.kzg" in modules
    script = (
        "import builtins, importlib, runpy, sys\n"
        "pre = set(sys.modules)\n"
        "real_import = builtins.__import__\n"
        "def guarded(name, globals=None, locals=None, fromlist=(), level=0):\n"
        "    if level == 0 and name.split('.')[0] in ('lighthouse_tpu', 'jax', 'jaxlib'):\n"
        "        raise ImportError('the port must not import ' + name)\n"
        "    return real_import(name, globals, locals, fromlist, level)\n"
        "builtins.__import__ = guarded\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in set(sys.modules) - pre\n"
        "       if m.split('.')[0] in ('lighthouse_tpu', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=REPO_ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED" in res.stdout
