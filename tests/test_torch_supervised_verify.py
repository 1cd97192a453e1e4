"""The port's supervised verifiers on the CPU: the BLS/KZG cases of
``tests/test_device_supervisor.py``, held against the JAX package.

Every case runs the port's entry point on ``device="cpu"`` (the kernels'
plain versions) under the port's supervisor, with a fault plan installed
where the case needs one, at 1–2 sets x 1 key or a 2-blob KZG batch (every
device program of the BLS cases runs at bucket 1 x 1, so the JAX program
compiles once):
injected compile error -> host; split retry succeeds; split detects the
bad half; hang -> watchdog -> host; corrupt verdict; breaker trip and
half-open recovery; ``kzg_batch`` never splits.  A last case checks that
both entry points keep failures on the card (``host_on_failure=False``
there, True on the CPU).

Tolerance: exact.  Each verdict must equal the JAX package's host backend
on the same sets (built from the same secret scalars with each package's
API), and every ``fe`` the port's device program computed during a case
must equal the JAX ``_device_verify``'s on the same input arrays, limb for
limb (a spy records the port program's inputs and outputs; the JAX program
runs on the recorded inputs, traced with its int32 Fq lowering).
"""

import hashlib
import random
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.backends import host as jhost  # noqa: E402
from lighthouse_tpu.crypto.kzg import Kzg as JKzg  # noqa: E402
from lighthouse_tpu.crypto.kzg import TrustedSetup as JSetup  # noqa: E402
from lighthouse_tpu.ops import fq as jfq  # noqa: E402
from lighthouse_tpu.ops import verify as jverify  # noqa: E402
from lighthouse_tpu_torch import device_supervisor as ds  # noqa: E402
from lighthouse_tpu_torch import device_telemetry, metrics, tracing  # noqa: E402
from lighthouse_tpu_torch import fault_injection as fi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as papi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import torch_backend  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.params import R  # noqa: E402
from lighthouse_tpu_torch.crypto.kzg import BLS_MODULUS, Kzg, TrustedSetup  # noqa: E402
from lighthouse_tpu_torch.ops import kzg_device  # noqa: E402
from lighthouse_tpu_torch.ops import verify as pverify  # noqa: E402

SEED = b"supervised"
WIDTH = 64
TAU = 0x5EC2E7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def clean_state(tmp_path):
    from lighthouse_tpu_torch import blackbox

    blackbox.configure(directory=str(tmp_path))
    fi.reset_for_tests()
    ds.reset_for_tests()
    yield
    fi.reset_for_tests()
    ds.reset_for_tests()
    blackbox.reset_for_tests()


@pytest.fixture(scope="module")
def jax_program():
    """The JAX package's ``_device_verify``, traced once per shape with its
    int32 Fq lowering (the pipeline the port keeps)."""
    prev = jfq.set_fq_backend("int32")
    try:
        yield jax.jit(lambda *a: jverify._device_verify.__wrapped__(*a))
    finally:
        jfq.set_fq_backend(prev)


@pytest.fixture
def spy(monkeypatch, jax_program):
    """Record every run of the port's device program; ``check()`` holds
    each recorded ``(fe, W_z)`` against the JAX program on the same
    inputs and returns how many runs it checked."""
    runs = []
    real = pverify._device_verify

    def recording(pk, sig, msg, wbits, live):
        fe, w_z = real(pk, sig, msg, wbits, live)
        arrays = ([x.numpy() for x in pk], [x.numpy() for x in sig],
                  [x.numpy() for x in msg], wbits.numpy(), live.numpy())
        runs.append((arrays, fe.numpy(), w_z.numpy()))
        return fe, w_z

    monkeypatch.setattr(pverify, "_device_verify", recording)

    def check():
        done = list(runs)
        for (pk, sig, msg, wbits, live), fe, w_z in done:
            fe_j, wz_j = jax_program(tuple(pk), tuple(sig), tuple(msg), wbits, live)
            assert np.array_equal(fe, np.asarray(fe_j))
            assert np.array_equal(w_z, np.asarray(wz_j))
        return len(done)

    return check


def _sets(n, seed, bad=()):
    """``n`` single-key sets from secret scalars, built with each package's
    API; sets whose index is in ``bad`` are signed over another message."""
    rng = random.Random(seed)
    out = {"jax": [], "port": []}
    for i in range(n):
        k = rng.randrange(1, R)
        msg = b"supervised-%d-%d" % (seed, i)
        signed = b"something else" if i in bad else msg
        for name, api in (("jax", japi), ("port", papi)):
            sk = api.SecretKey(k)
            out[name].append(api.SignatureSet.single_pubkey(sk.sign(signed), sk.public_key(), msg))
    return out


def _verify(sets):
    """(port verdict on the card's plain versions, JAX host verdict)."""
    port = pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu")
    return port, jhost.verify_signature_sets(sets["jax"], seed=SEED)


def _fallbacks(reason):
    return metrics.DEVICE_HOST_FALLBACK.get(reason=reason)


def _last_record(op="bls_verify"):
    return device_telemetry.FLIGHT_RECORDER.recent(op=op)[0]


# ------------------------------------------------------------------- BLS


def test_injected_compile_error_falls_back_to_host(spy):
    device_telemetry.reset_for_tests()  # (1, 1) becomes "unseen" again
    fi.install("device.compile", "error", op="bls_verify")
    before = _fallbacks("device_error")
    port, ref = _verify(_sets(1, seed=1))
    assert port is ref is True
    assert _fallbacks("device_error") == before + 1
    rec = _last_record()
    assert rec["host_fallback"] is True and rec["fallback_reason"] == "device_error"
    assert rec["verdict"] is True and rec["breaker_state"] == "closed"
    assert spy() == 0  # the device program never ran


def test_transient_error_split_retry_succeeds(spy):
    fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
    ok_before = metrics.DEVICE_SPLIT_RETRIES.get(op="bls_verify", outcome="success")
    fb_before = _fallbacks("device_error")
    port, ref = _verify(_sets(2, seed=2))
    assert port is ref is True
    assert metrics.DEVICE_SPLIT_RETRIES.get(op="bls_verify", outcome="success") == ok_before + 1
    assert _fallbacks("device_error") == fb_before  # the halves decided on the device
    assert ds.SUPERVISOR.breaker("bls_verify").state == "closed"
    assert spy() == 2  # one 1x1 program per half


def test_split_retry_detects_bad_half(spy):
    fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
    port, ref = _verify(_sets(2, seed=3, bad=(1,)))
    assert port is ref is False
    assert _last_record()["host_fallback"] is False
    assert spy() == 2


def test_hang_trips_watchdog_and_host_decides(spy):
    ds.SUPERVISOR.configure(deadlines={"bls_verify": 0.3})
    fi.install("device.dispatch", "hang", op="bls_verify", sleep_s=1.0, first_n=1)
    to_before = metrics.DEVICE_DISPATCH_TIMEOUTS.get(op="bls_verify")
    fb_before = _fallbacks("dispatch_timeout")
    sets = _sets(1, seed=4)
    port, ref = _verify(sets)
    assert port is ref is True
    assert metrics.DEVICE_DISPATCH_TIMEOUTS.get(op="bls_verify") == to_before + 1
    assert _fallbacks("dispatch_timeout") == fb_before + 1
    rec = _last_record()
    assert rec["fallback_reason"] == "dispatch_timeout"
    assert "dispatch" not in rec.get("stages_s", {})  # never read across a timeout
    # a fresh worker serves the next batch on the device
    ds.SUPERVISOR.configure(deadlines={"bls_verify": 300.0})
    assert pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu") is True
    rec = _last_record()
    assert rec["host_fallback"] is False
    # the last batch's stages, as the flight record has them
    st = rec["stages_s"]
    assert pverify.LAST_STAGES == pytest.approx({
        "build": st["setup"], "device": st["dispatch"] + st["wait"], "verdict": st["verdict"]},
        abs=1e-6)
    assert ds.SUPERVISOR.breaker("bls_verify").state == "closed"
    assert spy() >= 1


def test_corrupt_verdict_fault(spy):
    sets = _sets(1, seed=5)
    port, ref = _verify(sets)
    assert port is ref is True
    fi.install("device.result", "corrupt", op="bls_verify", first_n=1)
    assert pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu") is False
    assert pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu") is True
    assert spy() == 3


def test_breaker_trip_and_half_open_recovery(spy):
    clock = [0.0]
    ds.set_cooldown_clock(lambda: clock[0])
    ds.SUPERVISOR.configure(config=ds.BreakerConfig(
        failure_threshold=2, open_cooldown_s=60.0, probe_successes=1))
    plan = fi.install("device.dispatch", "error", op="bls_verify")
    sets = _sets(1, seed=6)
    fb_open_before = _fallbacks("breaker_open")
    for _ in range(2):  # two failures (a 1-set batch cannot split)
        port, ref = _verify(sets)
        assert port is ref is True
    br = ds.SUPERVISOR.breaker("bls_verify")
    assert br.state == "open"
    hits_after_trip = fi.plans()[0]["hits"]
    # OPEN: routed to the host without touching the device (no new hits)
    assert pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu") is True
    assert _fallbacks("breaker_open") == fb_open_before + 1
    assert fi.plans()[0]["hits"] == hits_after_trip
    rec = _last_record()
    assert rec["breaker_state"] == "open" and rec["fallback_reason"] == "breaker_open"
    assert "occupancy_sets" not in rec  # never dispatched
    # clear the fault, step past the cooldown: HALF_OPEN probe -> CLOSED
    fi.clear(plan_id=plan.plan_id)
    clock[0] += 61.0
    assert pverify.verify_signature_sets_device(sets["port"], seed=SEED, device="cpu") is True
    assert br.state == "closed" and br.probes_total == 1
    assert spy() == 1


def test_flight_record_and_trace_stamp_fallback():
    fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
    sets = _sets(1, seed=7)
    with tracing.span("import_root") as root:
        assert torch_backend.verify_signature_sets(sets["port"], seed=SEED, device="cpu") is True
    dv = root.children[0]
    assert dv.name == "device_verify" and dv.fields["backend"] == "torch"
    assert dv.fields["host_fallback"] is True and dv.fields["fallback_reason"] == "device_error"
    rec = device_telemetry.FLIGHT_RECORDER.recent(trace_id=root.trace.trace_id)[0]
    assert rec["host_fallback"] is True and rec["fallback_reason"] == "device_error"
    assert dv.fields["flight_seq"] == rec["seq"]


def test_asking_for_a_missing_card_raises_not_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    before = metrics.DEVICE_HOST_FALLBACK.snapshot()
    with pytest.raises(RuntimeError, match="cuda"):
        pverify.verify_signature_sets_device(_sets(1, seed=8)["port"], seed=SEED)
    assert metrics.DEVICE_HOST_FALLBACK.snapshot() == before


class _Captured(Exception):
    """Raised by the stand-in supervisor once it has the call's keywords."""


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("entry", ["bls_verify", "kzg_batch"])
def test_failures_stay_on_the_card(monkeypatch, entry, device_type):
    """Both entry points hand the supervisor ``host_on_failure=False`` when
    their tensors are on the card (failures raise into the caller; only
    the w-at-infinity disclaimer reaches the host) and True on the CPU.
    The supervisor is a stand-in that records the keywords, so no card
    is needed."""
    seen = {}

    def fake_run(op, device_fn, host_fn=None, **kwargs):
        seen.update(kwargs, op=op, host_fn=host_fn)
        raise _Captured()

    monkeypatch.setattr(ds, "run", fake_run)
    dev = torch.device(device_type)
    with pytest.raises(_Captured):
        if entry == "bls_verify":
            sets = _sets(1, seed=9)["port"]
            pverify.execute_built_batch(types.SimpleNamespace(
                sets=sets, seed=SEED, device=dev, nb=1, kb=1, live_keys=1, setup_s=0.0))
        else:
            monkeypatch.setattr(kzg_device, "resolve_device", torch.device)
            kzg_device.verify_kzg_proof_batch_device(
                [None], [None], [1], [0], [0], None, device=device_type,
                host_fn=lambda: True)
    assert seen["op"] == entry and seen["host_fn"] is not None
    assert seen["host_on_failure"] is (device_type == "cpu")


# ------------------------------------------------------------------- KZG


def _blob(seed):
    return b"".join(
        (int.from_bytes(hashlib.sha256(f"{seed}:{i}".encode()).digest(), "big")
         % BLS_MODULUS).to_bytes(32, "big") for i in range(WIDTH))


@pytest.fixture(scope="module")
def kzg_pair():
    ref = JKzg(JSetup.insecure_dev_setup(width=WIDTH, secret=TAU))
    port = Kzg(TrustedSetup.insecure_dev_setup(width=WIDTH, secret=TAU), device="cpu")
    blobs = [_blob(70 + i) for i in range(2)]
    cs = [ref.blob_to_kzg_commitment(b) for b in blobs]
    ps = [ref.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    return port, ref, blobs, cs, ps


@pytest.mark.parametrize("swap", [False, True], ids=["valid", "swapped_proofs"])
def test_kzg_batch_dispatch_error_never_splits(kzg_pair, swap):
    port, ref, blobs, cs, ps = kzg_pair
    if swap:
        ps = ps[::-1]
    fi.install("device.dispatch", "error", op="kzg_batch")
    splits = metrics.DEVICE_SPLIT_RETRIES.snapshot()
    before = _fallbacks("device_error")
    want = ref.verify_blob_kzg_proof_batch(blobs, cs, ps)
    assert want is (not swap)
    assert port.verify_blob_kzg_proof_batch(blobs, cs, ps) is want
    assert metrics.DEVICE_SPLIT_RETRIES.snapshot() == splits
    assert _fallbacks("device_error") == before + 1
    rec = _last_record("kzg_batch")
    assert rec["shape"] == "2" and rec["host_fallback"] is True and rec["verdict"] is want


def test_kzg_batch_supervised_on_the_device(kzg_pair):
    port, ref, blobs, cs, ps = kzg_pair
    before = metrics.DEVICE_HOST_FALLBACK.snapshot()
    assert port.verify_blob_kzg_proof_batch(blobs, cs, ps) is True
    assert ref.verify_blob_kzg_proof_batch(blobs, cs, ps) is True
    rec = _last_record("kzg_batch")
    assert rec["host_fallback"] is False and rec["breaker_state"] == "closed"
    assert set(rec["stages_s"]) == {"setup", "dispatch", "wait", "verdict"}
    assert set(kzg_device.LAST_STAGES) == {"build", "device", "verdict"}
    assert metrics.DEVICE_HOST_FALLBACK.snapshot() == before
