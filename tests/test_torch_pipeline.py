"""The port's async device pipeline: the BLS cases of
``tests/test_device_pipeline.py``, held against the JAX package.

Cross-work-type coalescing under a pinned linger (the same gated sequence
through both packages' pipelines gives the same batches), per-group
verdict attribution with one bad group (verdicts equal the JAX package's
host backend), the linger flush, breaker-open host routing with futures
still resolving, seeded / oversized / other-device calls bypassing the
pipeline at the api seam, a build or upload failure reaching the futures
as an error, shutdown drain and the telemetry sections.  The
``host``/``fake`` backends and the test seam carry most cases; a few run
small batches through the torch backend's device program on the CPU.
"""

import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import device_pipeline as j_pipeline  # noqa: E402
from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.backends import host as jhost  # noqa: E402
from lighthouse_tpu_torch import device_pipeline, device_supervisor, device_telemetry, metrics  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.device_pipeline import DevicePipeline, HashPipeline, PipelineShutdown  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    device_pipeline.reset_for_tests()
    yield
    device_pipeline.reset_for_tests()
    device_supervisor.reset_for_tests()
    set_backend("torch")


def _sets(n, seed=1, message=b"m" * 32, apis=(api,)):
    """n valid single-key signature sets (distinct keys), once per API."""
    out = [[] for _ in apis]
    for i in range(n):
        for lst, a in zip(out, apis):
            sk = a.SecretKey(seed + i * 7919)
            lst.append(a.SignatureSet.single_pubkey(sk.sign(message), sk.public_key(), message))
    return out if len(apis) > 1 else out[0]


def _bad_set(seed=99, a=api):
    """Valid points, wrong message: builds fine, verifies False."""
    sk = a.SecretKey(seed)
    return a.SignatureSet.single_pubkey(
        sk.sign(b"signed-this" * 3), sk.public_key(), b"claims-this" * 3)


class _StubSet:
    """Structurally valid for the fake backend (which checks signing_keys)."""

    signing_keys = [1]


class GatedVerify:
    """verify_flat_fn test seam: blocks each batch until released."""

    def __init__(self, verdict=True):
        self.gate = threading.Event()
        self.verdict = verdict
        self.batches = []

    def __call__(self, flat_sets):
        self.batches.append(list(flat_sets))
        assert self.gate.wait(10.0)
        return self.verdict


def _wait_in_flight(gated):
    deadline = time.monotonic() + 5
    while not gated.batches and time.monotonic() < deadline:
        time.sleep(0.005)  # until the warm batch is IN FLIGHT
    assert gated.batches, "warm batch never reached the executor"


# ------------------------------------------------- per-group attribution


def test_mixed_batch_attributes_per_group():
    """One bad group inside a coalesced batch: the batch verdict is False,
    each group gets ONE host re-check, and only the bad group's future
    resolves False — the JAX host backend's verdict for each group."""
    set_backend("host")
    good_p, good_j = _sets(1, seed=5, apis=(api, japi))
    bad_p, bad_j = [_bad_set(a=api)], [_bad_set(a=japi)]
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=8, linger_s=0.5)
    try:
        good = pipe.submit(good_p, work="gossip_attestation")
        bad = pipe.submit(bad_p, work="block_import")
        assert good.result(timeout=30.0) is jhost.verify_signature_sets(good_j) is True
        assert bad.result(timeout=30.0) is jhost.verify_signature_sets(bad_j) is False
        snap = pipe.snapshot()
        assert snap["batches_total"] == 1
        rec = snap["recent_batches"][-1]
        assert rec["n_groups"] == 2 and rec["verdict"] is False
        assert rec["group_rechecks"] == 2
        assert rec["work_mix"] == {"gossip_attestation": 1, "block_import": 1}
    finally:
        pipe.shutdown()


def test_single_group_batch_needs_no_recheck():
    set_backend("host")
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=8, linger_s=0.02)
    try:
        assert pipe.submit([_bad_set()]).result(timeout=30.0) is False
        rec = pipe.snapshot()["recent_batches"][-1]
        assert rec["n_groups"] == 1 and rec["group_rechecks"] == 0
    finally:
        pipe.shutdown()


def test_empty_group_resolves_false_immediately():
    pipe = DevicePipeline("bls_verify", verify_flat_fn=lambda s: True)
    try:
        fut = pipe.submit([])
        assert fut.done() and fut.result(0.0) is False
    finally:
        pipe.shutdown()


def test_coalesced_device_batch_on_the_cpu():
    """The torch backend's staged path: two groups from two threads ride
    ONE device batch (bucket 2 x 1, CPU plain versions); the bad group is
    attributed by its host re-check, and the flight record carries the
    batch's composition with no supervisor fallback."""
    set_backend("torch")
    device_pipeline.enable(device="cpu")
    device_pipeline.get_pipeline().linger_s = 2.0  # both threads submit well inside it
    good = _sets(1, seed=31)
    bad = [_bad_set(seed=32)]
    out = {}

    def call(name, sets):
        with device_pipeline.work_context(name):
            out[name] = api.verify_signature_sets(sets)

    threads = [threading.Thread(target=call, args=a)
               for a in (("block_import", good), ("gossip_attestation", bad))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert out == {"block_import": True, "gossip_attestation": False}
    rec = device_telemetry.FLIGHT_RECORDER.recent(op="bls_verify")[0]
    assert rec["n_groups"] == 2 and rec["shape"] == "2x1"
    assert rec["work_mix"] == {"block_import": 1, "gossip_attestation": 1}
    assert rec["host_fallback"] is False and rec["verdict"] is False
    snap = device_pipeline.summary()
    assert snap["batches_total"] == 1 and snap["recent_batches"][-1]["group_rechecks"] == 2
    assert snap["builder_busy_s"] > 0 and snap["executor_busy_s"] > 0


# ------------------------------------------------ cross-work-type coalescing


def _coalesce(module):
    """The reference test's sequence: one warm batch in flight, 40 one-set
    groups of four work types pile up, then the gate opens."""
    gated = GatedVerify()
    pipe = module.DevicePipeline("bls_verify", target_sets=32, linger_s=0.3,
                                 verify_flat_fn=gated)
    try:
        kinds = ["block_import", "gossip_attestation", "gossip_aggregate", "sync_committee"]
        first = pipe.submit(["w"], work="warm")
        _wait_in_flight(gated)
        futs = [pipe.submit([f"s{i}"], work=kinds[i % len(kinds)]) for i in range(40)]
        gated.gate.set()
        assert first.result(10.0) is True
        assert all(f.result(10.0) is True for f in futs)
        assert pipe.wait_idle(5.0)
        return [(b["n_sets"], b["n_groups"], b["work_mix"], b["verdict"])
                for b in pipe.snapshot()["recent_batches"]]
    finally:
        pipe.shutdown()


def test_cross_work_type_coalescing_matches_reference():
    port = _coalesce(device_pipeline)
    assert port == _coalesce(j_pipeline)
    assert [b[0] for b in port] == [1, 32, 8]
    assert len(port[1][2]) == 4  # the full batch mixes all four work types


def test_group_never_splits_across_batches():
    """A group is atomic: packing stops before target overflow."""
    gated = GatedVerify()
    pipe = DevicePipeline("bls_verify", target_sets=4, linger_s=0.3, verify_flat_fn=gated)
    try:
        first = pipe.submit(["w"], work="warm")
        _wait_in_flight(gated)
        f3 = pipe.submit(["a", "b", "c"])
        f2 = pipe.submit(["d", "e"])
        gated.gate.set()
        assert first.result(10.0) and f3.result(10.0) and f2.result(10.0)
        sizes = [b["n_sets"] for b in pipe.snapshot()["recent_batches"]]
        assert sizes[:1] == [1] and sorted(sizes[1:]) == [2, 3]
    finally:
        pipe.shutdown()


def test_linger_deadline_flushes_lone_set():
    pipe = DevicePipeline("bls_verify", target_sets=4096, linger_s=0.05,
                          verify_flat_fn=lambda s: True)
    try:
        t0 = time.perf_counter()
        assert pipe.submit(["solo"], work="gossip_attestation").result(timeout=5.0) is True
        assert time.perf_counter() - t0 < 2.0
        rec = pipe.snapshot()["recent_batches"][-1]
        assert rec["n_sets"] == 1 and rec["linger_s"] >= 0.04
    finally:
        pipe.shutdown()


def _no_host_verify(monkeypatch):
    """Make any host-model verify in the port fail the test loudly."""
    from lighthouse_tpu_torch.crypto.bls.backends import host

    def forbidden(*a, **k):
        raise AssertionError("a build failure was answered by the host model")

    monkeypatch.setattr(host, "verify_signature_sets", forbidden)


def test_build_error_reaches_the_futures_not_the_host(monkeypatch):
    """A build error must surface as an error, never as a verdict: a LONE
    valid group's future raises it, and no host model answers instead."""
    from lighthouse_tpu_torch.ops import verify as verify_mod

    set_backend("torch")

    def boom(sets, seed=None, device="cuda"):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(verify_mod, "build_device_batch", boom)
    _no_host_verify(monkeypatch)
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=8, linger_s=0.02)
    try:
        with pytest.raises(RuntimeError, match="injected build failure"):
            pipe.submit(_sets(1, seed=21), work="block_import").result(timeout=30.0)
        assert pipe.snapshot()["batches_total"] == 0
    finally:
        pipe.shutdown()


def test_upload_failure_reaches_every_coalesced_group(monkeypatch):
    """The build stage's upload to the card fails (a CUDA out-of-memory
    error, here injected into the upload): both groups of the coalesced
    batch get the error — no host verdict, no host-fallback count, no
    flight record — and the pipeline runs the next batch as usual."""
    from lighthouse_tpu_torch.ops import verify as verify_mod

    set_backend("torch")
    real_upload = verify_mod.batch_from_numpy
    calls = []

    def failing_upload(host_batch, device):
        calls.append(device)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real_upload(host_batch, device)

    monkeypatch.setattr(verify_mod, "batch_from_numpy", failing_upload)
    before = dict(device_telemetry.host_fallback_counts())
    recorded = device_telemetry.FLIGHT_RECORDER.recorded_total
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=8, linger_s=1.0)
    try:
        futs = [pipe.submit(_sets(1, seed=41 + i), work=w)
                for i, w in enumerate(("block_import", "gossip_attestation"))]
        for f in futs:
            with pytest.raises(torch.cuda.OutOfMemoryError, match="injected"):
                f.result(timeout=30.0)
        assert len(calls) == 1
        assert device_telemetry.host_fallback_counts() == before
        assert device_telemetry.FLIGHT_RECORDER.recorded_total == recorded
        _no_host_verify(monkeypatch)
        assert pipe.submit(_sets(1, seed=45), work="block_import").result(timeout=120.0) is True
        assert device_telemetry.FLIGHT_RECORDER.recorded_total == recorded + 1
        assert device_telemetry.FLIGHT_RECORDER.recent(op="bls_verify")[0]["host_fallback"] is False
    finally:
        pipe.shutdown()


def test_target_clamped_to_dispatch_ceiling():
    pipe = DevicePipeline("bls_verify", target_sets=999_999, verify_flat_fn=lambda s: True)
    try:
        assert pipe.target_sets <= device_pipeline.MAX_GROUP_SETS <= 4096
        assert device_pipeline.MAX_GROUP_SETS == j_pipeline.MAX_GROUP_SETS
    finally:
        pipe.shutdown()


def test_module_verify_refuses_resurrection_after_shutdown():
    device_pipeline.enable(device="cpu")
    device_pipeline.get_pipeline()
    device_pipeline.shutdown()
    with pytest.raises(PipelineShutdown):
        device_pipeline.verify([_StubSet()])
    assert device_pipeline.summary() is None


# --------------------------------------------------- breaker-open routing


def test_breaker_open_routes_to_host_and_futures_resolve():
    """With the bls_verify breaker OPEN, a pipeline batch of the torch
    backend routes to the host golden model without touching the device,
    and every group's future still resolves with its correct verdict."""
    set_backend("torch")
    device_supervisor.SUPERVISOR.configure(
        config=device_supervisor.BreakerConfig(failure_threshold=1, open_cooldown_s=300.0))
    device_supervisor.SUPERVISOR.breaker("bls_verify").record_failure("device_error")
    assert device_supervisor.breaker_state("bls_verify") == "open"
    before = metrics.DEVICE_HOST_FALLBACK.get(reason="breaker_open")
    good_sets, bad_sets = _sets(1, seed=11), [_bad_set(seed=13)]
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=8, linger_s=0.5)
    try:
        good = pipe.submit(good_sets, work="block_import")
        bad = pipe.submit(bad_sets, work="gossip_attestation")
        assert good.result(timeout=60.0) is True
        assert bad.result(timeout=60.0) is False
        assert metrics.DEVICE_HOST_FALLBACK.get(reason="breaker_open") == before + 1
        assert pipe.snapshot()["batches_total"] == 1
        assert device_supervisor.breaker_state("bls_verify") == "open"
        rec = device_telemetry.FLIGHT_RECORDER.recent(op="bls_verify")[0]
        assert rec["fallback_reason"] == "breaker_open" and rec["n_groups"] == 2
    finally:
        pipe.shutdown()


# ------------------------------------------------------- shutdown drain


def test_shutdown_drains_pending_futures():
    gated = GatedVerify()
    pipe = DevicePipeline("bls_verify", target_sets=4, linger_s=5.0, verify_flat_fn=gated)
    first = pipe.submit(["w"], work="warm")
    pending = [pipe.submit([f"p{i}"]) for i in range(6)]
    done = threading.Event()

    def stop():
        pipe.shutdown()
        done.set()

    threading.Thread(target=stop, daemon=True).start()
    gated.gate.set()
    assert done.wait(15.0), "shutdown hung"
    assert first.result(1.0) is True
    assert all(f.result(1.0) is True for f in pending)
    assert pipe.wait_idle(1.0)
    with pytest.raises(PipelineShutdown):
        pipe.submit(["late"])


def test_module_shutdown_is_idempotent_and_disables():
    device_pipeline.enable(device="cpu")
    assert device_pipeline.enabled()
    device_pipeline.get_pipeline()
    device_pipeline.shutdown()
    assert not device_pipeline.enabled()
    device_pipeline.shutdown()


def test_env_zero_wins_over_enable(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_DEVICE_PIPELINE", "0")
    device_pipeline.enable(device="cpu")
    assert not device_pipeline.enabled()


# ------------------------------------------------------------ api seam


def test_verify_signature_sets_routes_through_pipeline():
    set_backend("fake")
    device_pipeline.enable(device="cpu")
    assert api.verify_signature_sets([_StubSet()]) is True
    assert api.verify_signature_sets([_StubSet()], device="cpu") is True
    snap = device_pipeline.summary()
    assert snap is not None and snap["batches_total"] >= 1 and snap["groups_total"] == 2


def test_seeded_oversized_and_other_device_calls_bypass_pipeline():
    set_backend("fake")
    device_pipeline.enable(device="cpu")
    api.verify_signature_sets([_StubSet()], seed=b"pinned")
    api.verify_signature_sets([_StubSet()] * (device_pipeline.MAX_GROUP_SETS + 1))
    assert not device_pipeline.routes([_StubSet()], None, device="cuda:0")
    assert device_pipeline.routes([_StubSet()], None, device="cpu")
    assert device_pipeline.summary() is None  # nothing started or fed a pipeline


@pytest.mark.parametrize("first,then", [("cpu", "cuda"), ("cuda", "cpu")])
def test_enable_on_another_device_retires_the_old_pipelines(first, then):
    """``enable(first)``, both pipelines started there, then
    ``enable(then)``: a call for ``then`` never rides a pipeline running on
    ``first`` (the pipelines it reaches run on ``then``), and a call for
    ``first`` keeps the direct path.  The pipelines run nothing here, so
    no card is needed."""
    device_pipeline.enable(device=first)
    old = (device_pipeline.get_pipeline(), device_pipeline.get_hash_pipeline())
    assert [p.device for p in old] == [first, first]
    device_pipeline.enable(device=then)
    for dev, rides in ((then, True), (first, False)):
        assert device_pipeline.routes([_StubSet()], None, device=dev) is rides
        assert device_pipeline.routes_hash(16, device=dev) is rides
    new = (device_pipeline.get_pipeline(), device_pipeline.get_hash_pipeline())
    assert [p.device for p in new] == [then, then]
    assert not any(n is o for n, o in zip(new, old))
    with pytest.raises(PipelineShutdown):
        old[1].submit(b"\x00" * 64)


def test_a_live_pipeline_on_another_device_takes_no_call(monkeypatch):
    """A live pipeline whose device is not the caller's (an ``enable``
    racing the call): ``routes`` reads the live pipeline's device under the
    module lock and says no, and a caller already past ``routes`` gets
    :class:`PipelineShutdown` (the seams fall back to the direct path)."""
    device_pipeline.enable(device="cpu")
    device_pipeline.get_pipeline()
    device_pipeline.get_hash_pipeline()
    monkeypatch.setattr(device_pipeline, "_DEVICE", "cuda")
    assert not device_pipeline.routes([_StubSet()], None, device="cuda")
    assert not device_pipeline.routes_hash(16, device="cuda")
    assert device_pipeline.routes([_StubSet()], None, device="cpu")
    with pytest.raises(PipelineShutdown):
        device_pipeline.verify([_StubSet()], device="cuda")
    with pytest.raises(PipelineShutdown):
        device_pipeline.hash_pairs(b"\x00" * 64, device="cuda")


def test_disabled_routes_nothing():
    set_backend("fake")
    assert not device_pipeline.enabled()
    api.verify_signature_sets([_StubSet()])
    assert device_pipeline.summary() is None


# ------------------------------------------------------------- telemetry


def test_metrics_and_summary_sections():
    pipe = DevicePipeline("bls_verify", target_sets=8, linger_s=0.02,
                          verify_flat_fn=lambda s: True)
    try:
        pipe.submit(["a"], work="block_import").result(5.0)
        assert metrics.DEVICE_PIPELINE_BATCHES.get(op="bls_verify") >= 1
        assert metrics.DEVICE_PIPELINE_GROUPS.get(op="bls_verify", work="block_import") >= 1
        assert metrics.DEVICE_PIPELINE_BATCH_FILL_RATIO.stats(op="bls_verify")[0] >= 1
        assert metrics.DEVICE_PIPELINE_LINGER_SECONDS.stats(op="bls_verify")[0] >= 1
        snap = pipe.snapshot()
        assert set(j_keys := _reference_snapshot_keys()) <= set(snap)
        assert set(snap) - set(j_keys) == {"builder_busy_s", "executor_busy_s"}
    finally:
        pipe.shutdown()


def _reference_snapshot_keys():
    pipe = j_pipeline.DevicePipeline("bls_verify", verify_flat_fn=lambda s: True)
    try:
        return list(pipe.snapshot())
    finally:
        pipe.shutdown()


def test_device_summary_carries_pipeline_section():
    assert device_telemetry.summary()["pipeline"] is None
    device_pipeline.enable(device="cpu")
    device_pipeline.get_pipeline()
    section = device_telemetry.summary()["pipeline"]
    assert section is not None and section["op"] == "bls_verify"


# ------------------------------------------------------------ hash pipeline
# tests/test_device_pipeline.py::TestHashPipeline, re-pointed at the port.


def _golden_pairs(data):
    from lighthouse_tpu.ops.tree_hash import golden_hash_pairs

    return golden_hash_pairs(data)


def test_hash_groups_coalesce_with_exact_slice_attribution():
    """Unequal-size groups coalesce into one batch; each future's digests
    are the exact slice for its blocks, and the batch record equals the
    JAX package's on the same sequence."""
    groups = [bytes([i]) * (64 * k) for i, k in ((1, 1), (2, 3), (3, 2))]
    records = []
    for pkg in (device_pipeline, j_pipeline):
        pipe = pkg.HashPipeline(target_blocks=64, linger_s=0.5, hash_flat_fn=_golden_pairs)
        try:
            futs = [pipe.submit(g, work=f"w{i}") for i, g in enumerate(groups)]
            for g, fut in zip(groups, futs):
                assert fut.result(timeout=30.0) == _golden_pairs(g)
            snap = pipe.snapshot()
            assert (snap["batches_total"], snap["groups_total"], snap["blocks_total"]) == (1, 3, 6)
            rec = snap["recent_batches"][-1]
            records.append({k: rec[k] for k in ("n_groups", "n_blocks", "work_mix",
                                                "group_rehashes")})
        finally:
            pipe.shutdown()
    assert records[0] == records[1] == {"n_groups": 3, "n_blocks": 6,
                                        "work_mix": {"w0": 1, "w1": 3, "w2": 2},
                                        "group_rehashes": 0}


def test_hash_flat_failure_rescues_each_group_on_host_on_cpu():
    """With ``device="cpu"`` a failure escaping the supervised leg re-hashes
    per group on the host kernel, as in the JAX package."""
    def poisoned(data):
        raise RuntimeError("flat leg poisoned")

    pipe = HashPipeline(device="cpu", target_blocks=64, linger_s=0.2, hash_flat_fn=poisoned)
    try:
        groups = [b"\xaa" * 64, b"\xbb" * 128]
        futs = [pipe.submit(g) for g in groups]
        for g, fut in zip(groups, futs):
            assert fut.result(timeout=30.0) == _golden_pairs(g)
        rec = pipe.snapshot()["recent_batches"][-1]
        assert (rec["group_rehashes"], rec["group_errors"]) == (2, 0)
    finally:
        pipe.shutdown()


def test_hash_flat_failure_on_the_card_reaches_every_future():
    """On the card (the one rule that differs from the JAX package) a
    failure escaping the supervised leg is every group's error: nothing is
    re-hashed on the host."""
    from lighthouse_tpu_torch.ops import sha256_device

    def poisoned(data):
        raise RuntimeError("card leg failed")

    host_calls = []
    real_host = sha256_device._host_hash_pairs
    sha256_device._host_hash_pairs = lambda data: host_calls.append(data) or real_host(data)
    pipe = HashPipeline(device="cuda", target_blocks=64, linger_s=0.2, hash_flat_fn=poisoned)
    try:
        futs = [pipe.submit(g) for g in (b"\xaa" * 64, b"\xbb" * 128)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="card leg failed"):
                fut.result(timeout=30.0)
        rec = pipe.snapshot()["recent_batches"][-1]
        assert (rec["group_rehashes"], rec["group_errors"]) == (0, 2)
        assert host_calls == []
    finally:
        pipe.shutdown()
        sha256_device._host_hash_pairs = real_host


def test_hash_misaligned_group_rejected_and_empty_resolves():
    pipe = HashPipeline(target_blocks=8, linger_s=0.01, hash_flat_fn=_golden_pairs)
    try:
        with pytest.raises(ValueError):
            pipe.submit(b"x" * 63)
        fut = pipe.submit(b"")
        assert fut.done() and fut.result(0.0) == b""
    finally:
        pipe.shutdown()


def test_module_hash_seam_and_shutdown_fallback():
    assert not device_pipeline.routes_hash(16)  # disabled
    device_pipeline.enable(device="cpu")
    assert device_pipeline.routes_hash(16)
    assert device_pipeline.routes_hash(16, device="cpu")
    assert not device_pipeline.routes_hash(16, device="cuda")
    assert not device_pipeline.routes_hash(device_pipeline.MAX_HASH_GROUP_BLOCKS + 1)
    assert device_pipeline.MAX_HASH_GROUP_BLOCKS == j_pipeline.MAX_HASH_GROUP_BLOCKS
    data = b"\x5a" * 256
    # module-level hash_pairs lazily starts the pipeline (on the CPU: the
    # pair kernel's plain version) and resolves
    assert device_pipeline.hash_pairs(data) == _golden_pairs(data)
    snap = device_pipeline.summary()
    assert snap["hash"]["groups_total"] >= 1
    assert snap["arbiter"]["grants"].get("sha256_pairs", 0) >= 1
    reference = j_pipeline.HashPipeline(hash_flat_fn=_golden_pairs)
    try:
        assert set(snap["hash"]) == set(reference.snapshot())
    finally:
        reference.shutdown()
    device_pipeline.shutdown()
    with pytest.raises(PipelineShutdown):
        device_pipeline.hash_pairs(data)


def test_bls_batches_take_the_arbiter_slot():
    set_backend("fake")
    device_pipeline.enable(device="cpu")
    assert api.verify_signature_sets([_StubSet()]) is True
    grants = device_pipeline.summary()["arbiter"]["grants"]
    assert grants.get("bls_verify", 0) >= 1
    assert metrics.DEVICE_ARBITER_GRANTS.get(op="bls_verify") >= 1
