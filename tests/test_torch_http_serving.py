"""The port's serving layer and operator routes vs the JAX package's.

- The JAX package's ``test_http_serving.py`` re-pointed at the port
  (``GET /lighthouse/autotune``: the controller's snapshot, every enrolled
  vocabulary, the admission state), the checkpoint-keyed response cache, bit-identical to an uncached server
  across a reorg and invalidated exactly, admission and shedding in front
  of the scheduler, SSE backpressure, and cache misses taking the device
  arbiter's slot;
- ``DeviceArbiter.api_slot`` and ``api_arbiter_slot``: a timed-out acquire
  proceeds ungated and is counted, ``hold=False`` lets a nested
  ``run_job`` through, and the same scenarios give the same grants and
  timeouts on the JAX package's arbiter;
- the HTTP-route cases of the JAX package's ``test_device_telemetry.py``
  (``/lighthouse/device*``; the profiler answers 501 without a card),
  ``test_fault_injection.py``, ``test_tracing.py``, ``test_blackbox.py``,
  ``test_fleet_observability.py``, ``test_subnet_service.py``, and the two
  quick cases of ``test_serve_load.py`` (its load generator, ``bench.py``'s
  ``_serve_run_phase``, drives the port's server).

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto.
"""

import http.client
import json
import os
import queue
import sys
import threading
import time
import urllib.request

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import device_pipeline as j_device_pipeline  # noqa: E402
from lighthouse_tpu_torch import (  # noqa: E402
    blackbox,
    device_pipeline,
    device_telemetry,
    fault_injection,
    metrics,
    telemetry_scope,
    tracing,
)
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.chain.events import EventBus  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.http_api import HttpApiServer  # noqa: E402
from lighthouse_tpu_torch.http_api.response_cache import VALID_INVALIDATION_TOPICS  # noqa: E402
from lighthouse_tpu_torch.http_api.server import CACHED_ROUTES  # noqa: E402
from lighthouse_tpu_torch.scheduler import (  # noqa: E402
    AdmissionController,
    BeaconProcessor,
    ClassPolicy,
    ShedError,
    W,
    WorkEvent,
)
from lighthouse_tpu_torch.scheduler.admission import (  # noqa: E402
    CLASS_BULK,
    CLASS_CRITICAL,
    CLASS_DUTIES,
)
from test_torch_http_api import one_torch_thread, port_cpu_module  # noqa: E402,F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port: int, path: str, method: str = "GET", body=None):
    """Raw request -> (status, headers, body bytes) — byte-exact compares
    need the wire bytes, not the client's parsed view."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    payload = None if body is None else json.dumps(body)
    headers = {"Content-Type": "application/json"} if payload else {}
    conn.request(method, path, body=payload, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def _request(port, method, path, body=None):
    """-> (status, parsed JSON body)."""
    status, _, data = _get(port, path, method, body)
    return status, json.loads(data)


#: Deterministic hot-route probe: duties, state queries, rewards, headers.
def _probe_requests(epoch: int):
    return [
        ("GET", f"/eth/v1/validator/duties/proposer/{epoch}", None),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch}",
         [str(i) for i in range(16)]),
        ("GET", "/eth/v1/beacon/states/head/validators", None),
        ("GET", "/eth/v1/beacon/states/head/validator_balances?id=0,1,2", None),
        ("GET", "/eth/v1/beacon/states/head/finality_checkpoints", None),
        ("GET", "/eth/v1/beacon/states/head/root", None),
        ("GET", "/eth/v1/beacon/headers", None),
        ("GET", "/eth/v1/beacon/headers/head", None),
        ("GET", "/eth/v1/debug/beacon/heads", None),
        ("GET", "/eth/v1/beacon/rewards/blocks/head", None),
    ]


@pytest.fixture()
def harness():
    set_backend("fake")
    h = BeaconChainHarness(validator_count=16, fake_crypto=True)
    h.extend_chain(4)
    yield h
    set_backend("host")


@pytest.fixture()
def served_pair(harness):
    """One chain, two servers: cached and uncached — the bit-identity
    oracle."""
    processor = BeaconProcessor(max_workers=2)
    cached = HttpApiServer(harness.chain, processor=processor).start()
    uncached = HttpApiServer(harness.chain, response_cache=False).start()
    yield harness, cached, uncached
    cached.stop()
    uncached.stop()
    processor.shutdown()


@pytest.fixture(scope="module")
def api_server():
    """One 8-validator chain served for the operator-route cases."""
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
    processor = BeaconProcessor(max_workers=2)
    server = HttpApiServer(harness.chain, processor=processor).start()
    yield harness, processor, server
    server.stop()
    processor.shutdown()
    set_backend("host")


# ------------------------------------------- the JAX package's serving tests


def test_lighthouse_autotune_route(served_pair):
    """GET /lighthouse/autotune: the self-tuning snapshot plus the live
    admission state — the operator's one-read triage surface."""
    # registration mirrors module imports: pull the ops in so every
    # tunable vocabulary is visible on the surface
    from lighthouse_tpu_torch.ops import epoch_device  # noqa: F401
    from lighthouse_tpu_torch.ops import sha256_device  # noqa: F401
    from lighthouse_tpu_torch.ops import shuffle_device  # noqa: F401
    from lighthouse_tpu_torch.ops import verify  # noqa: F401

    _, cached, _ = served_pair
    status, _, body = _get(cached.port, "/lighthouse/autotune")
    assert status == 200
    data = json.loads(body)["data"]
    assert data["mode"] in ("0", "pinned", "live")
    for vocab in ("bls_verify", "sha256_pairs", "epoch_deltas", "shuffle",
                  "proposer_select", "epoch_boundary"):
        v = data["vocabularies"][vocab]
        assert v["static"] and set(v["effective"]) >= set(v["static"])
    adm = data["admission"]
    assert set(adm["effective"]) == {CLASS_CRITICAL, CLASS_DUTIES, CLASS_BULK}
    for klass, eff in adm["effective"].items():
        assert eff["max_inflight"] <= adm["bounds"][klass]
        assert eff["deadline_s"] <= adm["deadlines_s"][klass]


class TestResponseCache:
    def test_hit_is_bit_identical_and_counted(self, served_pair):
        harness, cached, uncached = served_pair
        epoch = harness.chain.current_slot() // harness.spec.slots_per_epoch
        for method, path, body in _probe_requests(epoch):
            s1, _, b1 = _get(cached.port, path, method, body)   # miss
            s2, _, b2 = _get(cached.port, path, method, body)   # hit
            s3, _, b3 = _get(uncached.port, path, method, body)  # oracle
            assert s1 == s2 == s3 == 200, path
            assert b1 == b2, f"cached replay differs: {path}"
            assert b1 == b3, f"cached vs uncached differ: {path}"
        snap = cached.response_cache.snapshot()
        assert snap["hits"] >= len(_probe_requests(epoch))
        assert snap["misses"] >= len(_probe_requests(epoch))
        assert uncached.response_cache is None

    def test_head_event_invalidates_exactly_stale_keys(self, served_pair):
        harness, cached, _ = served_pair
        cache = cached.response_cache
        epoch = harness.chain.current_slot() // harness.spec.slots_per_epoch
        for method, path, body in _probe_requests(epoch):
            _get(cached.port, path, method, body)
        old_fp = cache.fingerprint()
        assert len(cache) > 0
        assert all(k[0] == old_fp for k in cache.keys_snapshot())

        harness.extend_chain(1)  # publishes a head event
        new_fp = cache.fingerprint()
        assert new_fp != old_fp
        assert all(k[0] != old_fp for k in cache.keys_snapshot())
        assert cache.invalidated > 0

        _get(cached.port, "/eth/v1/beacon/states/head/root")  # repopulate
        fresh_keys = [k for k in cache.keys_snapshot() if k[0] == new_fp]
        assert fresh_keys
        # a head event that does NOT change the fingerprint must keep them
        harness.chain.events.publish("head", {"slot": "0"})
        kept = [k for k in cache.keys_snapshot() if k[0] == new_fp]
        assert kept == fresh_keys, "same-fingerprint keys must survive"

    def test_stale_read_across_reorg(self, served_pair):
        """Bit-identical vs the uncached oracle before AND after a reorg."""
        harness, cached, uncached = served_pair
        chain = harness.chain
        roots = harness.extend_chain(2, attest=False)
        harness.advance_slot()
        slot = chain.current_slot()
        canonical = harness.produce_signed_block(slot=slot)
        fork_block = harness.produce_signed_block(
            slot=slot, parent_root=roots[0], graffiti=b"\x42" * 32)

        c_root = chain.process_block(canonical, block_delay_seconds=1.0)
        assert chain.head_root == c_root
        probe = [
            ("GET", "/eth/v1/beacon/states/head/root", None),
            ("GET", "/eth/v1/beacon/headers/head", None),
            ("GET", "/eth/v1/debug/beacon/heads", None),
        ]
        before = [_get(cached.port, p, m, b)[2] for m, p, b in probe]
        assert before == [_get(uncached.port, p, m, b)[2] for m, p, b in probe]

        inval_before = cached.response_cache.invalidated
        chain.process_block(fork_block, block_delay_seconds=20.0)
        after_cached = [_get(cached.port, p, m, b)[2] for m, p, b in probe]
        after_uncached = [_get(uncached.port, p, m, b)[2] for m, p, b in probe]
        assert after_cached == after_uncached
        assert cached.response_cache.invalidated > inval_before

    def test_put_refused_after_invalidation_event(self, served_pair):
        """An entry computed while any invalidation event fired is not
        stored (an A->B->A reorg passes the fingerprint check but not the
        generation check)."""
        from lighthouse_tpu_torch.http_api.response_cache import CacheEntry

        _, cached, _ = served_pair
        cache = cached.response_cache
        key = cache.make_key("GET", "/probe", {}, {}, None, False)
        entry = lambda: CacheEntry("json", b"{}", None, (), key[0], ("head",))  # noqa: E731
        gen = cache.generation
        cache.on_event("head", {})  # same fingerprint, but an event fired
        assert not cache.put(key, "/probe", entry(), generation=gen)
        assert cache.put(key, "/probe", entry(), generation=cache.generation)

    def test_cache_miss_contends_at_device_arbiter(self, served_pair):
        harness, cached, _ = served_pair
        grants_before = device_pipeline.ARBITER.snapshot()["grants"].get(
            "http_api", 0)
        _get(cached.port, "/eth/v1/beacon/states/head/validators")
        grants_after = device_pipeline.ARBITER.snapshot()["grants"].get(
            "http_api", 0)
        assert grants_after > grants_before

    def test_every_cached_route_declares_valid_topics(self):
        assert CACHED_ROUTES, "cache registry must not be empty"
        for (method, pattern), topics in CACHED_ROUTES.items():
            assert topics, f"{method} {pattern}: empty invalidation topics"
            bad = set(topics) - set(VALID_INVALIDATION_TOPICS)
            assert not bad, f"{method} {pattern}: unknown topics {bad}"
            assert "head" in topics, f"{method} {pattern}: missing 'head'"

    def test_duties_ride_their_own_queue(self, served_pair):
        harness, cached, _ = served_pair
        processor = cached.spawner.processor
        epoch = harness.chain.current_slot() // harness.spec.slots_per_epoch
        cached.response_cache.clear()
        _get(cached.port, f"/eth/v1/validator/duties/proposer/{epoch}")
        assert processor.metrics.received.get("api_request_duties", 0) >= 1


class TestAdmission:
    def test_admission_full_sheds_503_with_retry_after(self, harness):
        admission = AdmissionController([
            ClassPolicy(CLASS_CRITICAL, 64, 8.0, 1),
            ClassPolicy(CLASS_DUTIES, 64, 4.0, 2),
            ClassPolicy(CLASS_BULK, 0, 2.0, 5),  # shed every bulk request
        ])
        server = HttpApiServer(harness.chain, admission=admission,
                               response_cache=False).start()
        try:
            status, headers, body = _get(server.port, "/lighthouse/health")
            assert status == 503
            assert headers.get("Retry-After") == "5"
            assert b"overloaded" in body
            status, _, _ = _get(
                server.port,
                "/eth/v1/validator/attestation_data?slot=1&committee_index=0")
            assert status != 503
        finally:
            server.stop()
        snap = admission.snapshot()
        assert snap["shed_total"] >= 1
        from lighthouse_tpu_torch.scheduler.admission import HTTP_REQUESTS_SHED

        assert HTTP_REQUESTS_SHED.get(**{"class": CLASS_BULK,
                                         "reason": "admission_full"}) >= 1

    def test_deadline_shed_at_dequeue(self):
        admission = AdmissionController([ClassPolicy(CLASS_BULK, 8, 0.0, 5)])
        ticket = admission.try_admit(CLASS_BULK)
        time.sleep(0.01)
        with pytest.raises(ShedError) as e:
            ticket.check_deadline()
        assert e.value.reason == "deadline"
        ticket.release()
        snap = admission.snapshot()
        assert snap["inflight"][CLASS_BULK] == 0
        assert snap["shed_total"] == 1

    def test_inflight_accounting_releases(self):
        admission = AdmissionController([ClassPolicy(CLASS_BULK, 2, 5.0, 5)])
        t1 = admission.try_admit(CLASS_BULK)
        t2 = admission.try_admit(CLASS_BULK)
        with pytest.raises(ShedError):
            admission.try_admit(CLASS_BULK)
        t1.release()
        t3 = admission.try_admit(CLASS_BULK)
        t2.release()
        t3.release()
        assert admission.snapshot()["inflight"][CLASS_BULK] == 0

    def test_drop_policy_generalizes_drop_during_sync(self):
        from lighthouse_tpu_torch.scheduler import DropPolicy

        class DropEverything(DropPolicy):
            def should_drop(self, event):
                return "test"

        processor = BeaconProcessor(max_workers=1, drop_policy=DropEverything())
        try:
            ran = threading.Event()
            accepted = processor.send(WorkEvent(
                work_type=W.GOSSIP_ATTESTATION, process=lambda _i: ran.set()))
            assert not accepted
            assert processor.metrics.dropped.get(W.GOSSIP_ATTESTATION) == 1
            assert processor.metrics.dropped_during_sync.get(
                W.GOSSIP_ATTESTATION, 0) == 0
            assert not ran.wait(0.1)
        finally:
            processor.shutdown()


class TestSseBackpressure:
    def test_slow_subscriber_drops_without_blocking(self):
        bus = EventBus()
        sub = bus.subscribe(["head"])
        before = metrics.SSE_EVENTS_DROPPED.get(topic="head")
        t0 = time.perf_counter()
        for i in range(sub.q.maxsize + 50):
            bus.publish("head", {"slot": str(i)})
        elapsed = time.perf_counter() - t0
        assert elapsed < 1.0
        assert sub.q.qsize() == sub.q.maxsize  # bounded, not unbounded
        assert sub.dropped == 50
        assert metrics.SSE_EVENTS_DROPPED.get(topic="head") == before + 50
        bus.unsubscribe(sub)

    def test_drop_counter_is_the_required_serving_metric(self):
        assert metrics.SSE_EVENTS_DROPPED.name == "http_sse_events_dropped_total"
        assert metrics.SSE_EVENTS_SENT.name == "http_sse_events_sent_total"

    def test_publish_counts_drops_per_topic(self):
        from lighthouse_tpu_torch.chain import events as ev

        bus = ev.EventBus()
        sub = bus.subscribe([ev.TOPIC_HEAD, ev.TOPIC_BLOCK])
        sub.q = queue.Queue(maxsize=1)  # shrink to force drops
        before = metrics.SSE_EVENTS_DROPPED.get(topic=ev.TOPIC_HEAD)
        bus.publish(ev.TOPIC_HEAD, {"slot": "1"})   # fills the queue
        bus.publish(ev.TOPIC_HEAD, {"slot": "2"})   # dropped
        bus.publish(ev.TOPIC_BLOCK, {"slot": "2"})  # dropped (shared queue)
        assert sub.dropped == 2
        assert sub.dropped_by_topic == {ev.TOPIC_HEAD: 1, ev.TOPIC_BLOCK: 1}
        assert metrics.SSE_EVENTS_DROPPED.get(topic=ev.TOPIC_HEAD) == before + 1
        summary = bus.summary()
        assert summary[0]["dropped"] == 2
        assert summary[0]["queue_depth"] == 1

    def test_sse_stream_counts_sent(self):
        """Events written to a live /eth/v1/events stream bump
        http_sse_events_sent_total{topic}."""
        set_backend("fake")
        harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
        server = HttpApiServer(harness.chain).start()
        try:
            before = metrics.SSE_EVENTS_SENT.get(topic="head")
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
            conn.request("GET", "/eth/v1/events?topics=head")
            resp = conn.getresponse()  # the stream has subscribed by now
            harness.chain.events.publish("head", {"slot": "3", "block": "0x00"})
            buf = b""
            deadline = time.time() + 5
            while b"\n\n" not in buf and time.time() < deadline:
                chunk = resp.read1(4096)
                if not chunk:
                    break
                buf += chunk
            conn.close()
            assert b"event: head" in buf
            deadline = time.time() + 3
            while (metrics.SSE_EVENTS_SENT.get(topic="head") == before
                   and time.time() < deadline):
                time.sleep(0.05)
            assert metrics.SSE_EVENTS_SENT.get(topic="head") == before + 1
        finally:
            server.stop()
            set_backend("host")


# ---------------------------------------------------------- the API turnstile


def _arbiter_scenarios(pipeline_mod, metrics_counter) -> dict:
    """The same three scenarios on one package's arbiter: a held slot, a
    timed-out API acquire, a turnstile (``hold=False``) and a held API
    slot; -> grants, timeouts and what each body saw."""
    arb = pipeline_mod.DeviceArbiter()
    seen = {}
    before = metrics_counter.get(op="probe")
    with arb.slot("pipeline"):
        t0 = time.perf_counter()
        with arb.api_slot("probe", timeout=0.05):
            seen["ungated_wait_s"] = time.perf_counter() - t0
            seen["ungated_holder"] = arb.snapshot()["holding"]
    with arb.api_slot("probe", hold=False):
        seen["turnstile_holder"] = arb.snapshot()["holding"]
        # the slot is free again: a pipeline leg gets it at once
        got = arb._lock.acquire(timeout=0.5)
        seen["turnstile_free"] = got
        if got:
            arb._lock.release()
    with arb.api_slot("probe"):
        seen["held_holder"] = arb.snapshot()["holding"]
        seen["held_free"] = arb._lock.acquire(timeout=0.05)
    snap = arb.snapshot()
    return {"grants": snap["grants"], "holding": snap["holding"],
            "timeouts": metrics_counter.get(op="probe") - before,
            "ungated_waited": seen.pop("ungated_wait_s") >= 0.05, **seen}


def test_api_slot_matches_the_jax_arbiter():
    from lighthouse_tpu import device_pipeline as jdp

    got = _arbiter_scenarios(device_pipeline, metrics.DEVICE_ARBITER_API_TIMEOUTS)
    assert got == _arbiter_scenarios(jdp, jdp.DEVICE_ARBITER_API_TIMEOUTS)
    assert got == {"grants": {"pipeline": 1, "probe": 2}, "holding": None,
                   "timeouts": 1, "ungated_waited": True, "ungated_holder": "pipeline",
                   "turnstile_holder": None, "turnstile_free": True,
                   "held_holder": "probe", "held_free": False}


def test_api_arbiter_slot_lets_a_nested_run_job_through():
    """With the pipelines routing, ``api_arbiter_slot`` is a turnstile: a
    job submitted from inside it takes the arbiter slot on the pipeline
    worker without deadlocking (both packages alike)."""
    device_pipeline.reset_for_tests()
    device_pipeline.enable(device="cpu")
    j_device_pipeline.reset_for_tests()
    j_device_pipeline.enable()
    try:
        out = []
        for mod, kw in ((device_pipeline, {"device": "cpu"}), (j_device_pipeline, {})):
            def body(mod=mod, kw=kw):
                with mod.api_arbiter_slot("http_api"):
                    return mod.run_job("epoch_deltas", lambda: 42, **kw)

            result = []
            t = threading.Thread(target=lambda b=body: result.append(b()), daemon=True)
            t.start()
            t.join(timeout=20)
            assert not t.is_alive(), f"{mod.__name__}: the nested run_job deadlocked"
            grants = mod.ARBITER.snapshot()["grants"]
            out.append((result, grants.get("http_api"), grants.get("epoch_deltas")))
        assert out[0] == out[1] == ([42], 1, 1)
    finally:
        device_pipeline.reset_for_tests()
        j_device_pipeline.reset_for_tests()


def test_api_arbiter_slot_holds_while_the_pipelines_are_off():
    device_pipeline.reset_for_tests()
    with device_pipeline.api_arbiter_slot("http_api"):
        assert device_pipeline.ARBITER.snapshot()["holding"] == "http_api"
    assert device_pipeline.ARBITER.snapshot()["holding"] is None
    device_pipeline.reset_for_tests()


# ------------------------------------------------------- device telemetry


class TestDeviceEndpoints:
    def test_device_summary_shape(self, api_server):
        device_telemetry.reset_for_tests()
        device_telemetry.note_dispatch("bls_verify", (8, 4), 1.25)
        device_telemetry.record_batch(
            op="bls_verify", shape=(8, 4), n_live=6, live_keys=20,
            trace_id="abc", compiled=True)
        _, _, server = api_server
        status, out = _request(server.port, "GET", "/lighthouse/device")
        assert status == 200
        data = out["data"]
        assert {"programs", "occupancy", "host_fallbacks",
                "flight_recorder", "memory"} <= set(data)
        prog = next(p for p in data["programs"] if p["shape"] == "8x4")
        assert prog["op"] == "bls_verify"
        assert prog["compile_seconds"] == 1.25
        assert data["occupancy"]["bls_verify"]["sets"]["max"] == pytest.approx(0.75)
        assert data["flight_recorder"]["capacity"] >= 1
        for dev in data["memory"]:
            assert {"id", "platform"} <= set(dev)

    def test_device_batches_listing_and_filters(self, api_server):
        _, _, server = api_server
        status, out = _request(
            server.port, "GET", "/lighthouse/device/batches?op=bls_verify&limit=5")
        assert status == 200
        assert out["data"], "flight recorder should have records"
        for rec in out["data"]:
            assert rec["op"] == "bls_verify"
            assert {"seq", "t_ms", "shape", "n_live"} <= set(rec)
        status, filtered = _request(
            server.port, "GET", "/lighthouse/device/batches?trace_id=abc")
        assert status == 200
        assert all(r["trace_id"] == "abc" for r in filtered["data"])
        status, _ = _request(
            server.port, "GET", "/lighthouse/device/batches?limit=junk")
        assert status == 400

    def test_profiler_501_without_a_card(self, api_server, monkeypatch):
        monkeypatch.delenv("LIGHTHOUSE_TPU_FORCE_PROFILER", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, _, server = api_server
        status, out = _request(
            server.port, "POST", "/lighthouse/device/profile?seconds=1")
        assert status == 501
        assert "CUDA card" in out["message"]

    def test_profiler_409_while_busy(self, api_server, monkeypatch):
        monkeypatch.setenv("LIGHTHOUSE_TPU_FORCE_PROFILER", "1")
        _, _, server = api_server
        assert device_telemetry._PROFILE_LOCK.acquire(blocking=False)
        try:
            status, out = _request(
                server.port, "POST", "/lighthouse/device/profile?seconds=1")
        finally:
            device_telemetry._PROFILE_LOCK.release()
        assert status == 409
        assert out["message"].startswith("CONFLICT")

    def test_profiler_bad_seconds(self, api_server):
        _, _, server = api_server
        status, _ = _request(
            server.port, "POST", "/lighthouse/device/profile?seconds=zero")
        assert status == 400
        status, _ = _request(
            server.port, "POST", "/lighthouse/device/profile?seconds=-3")
        assert status == 400

    def test_events_subscribers_summary(self, api_server):
        harness, _, server = api_server
        sub = harness.chain.events.subscribe(["head"])
        try:
            harness.chain.events.publish("head", {"slot": "1"})
            status, out = _request(
                server.port, "GET", "/lighthouse/events/subscribers")
            assert status == 200
            entry = next(e for e in out["data"] if e["topics"] == ["head"])
            assert entry["queue_depth"] == 1
            assert entry["dropped"] == 0
            assert {"sent", "queue_capacity", "dropped_by_topic"} <= set(entry)
        finally:
            harness.chain.events.unsubscribe(sub)


# ---------------------------------------------------------- fault injection


@pytest.fixture()
def clean_faults():
    fault_injection.reset_for_tests()
    yield
    fault_injection.reset_for_tests()


class TestFaultsEndpoint:
    def test_install_list_clear_roundtrip(self, api_server, clean_faults):
        _, _, server = api_server
        status, out = _request(
            server.port, "POST", "/lighthouse/faults",
            body={"spec": "device.dispatch[op=bls_verify]=error:first_n=3"},
        )
        assert status == 200
        (plan,) = out["data"]
        assert plan["point"] == "device.dispatch"
        assert plan["op"] == "bls_verify" and plan["first_n"] == 3

        status, out = _request(server.port, "GET", "/lighthouse/faults")
        assert status == 200
        assert out["data"]["active"] is True
        assert len(out["data"]["plans"]) == 1
        assert "device.dispatch" in out["data"]["points"]

        status, out = _request(
            server.port, "DELETE", f"/lighthouse/faults?id={plan['id']}")
        assert status == 200
        assert out["data"]["cleared"] == 1
        assert fault_injection.ACTIVE is False

    def test_install_structured_plan(self, api_server, clean_faults):
        _, _, server = api_server
        status, out = _request(
            server.port, "POST", "/lighthouse/faults",
            body={"point": "device.result", "mode": "corrupt",
                  "probability": 0.5, "seed": 9},
        )
        assert status == 200
        assert out["data"][0]["mode"] == "corrupt"
        assert out["data"][0]["seed"] == 9
        status, out = _request(server.port, "DELETE", "/lighthouse/faults")
        assert status == 200 and out["data"]["cleared"] == 1

    def test_bad_plans_are_400(self, api_server, clean_faults):
        _, _, server = api_server
        for body in (
            {"spec": "unknown.point=error"},
            {"point": "device.dispatch", "mode": "explode"},
            {},
        ):
            status, _ = _request(
                server.port, "POST", "/lighthouse/faults", body=body)
            assert status == 400, body

    def test_delete_with_non_numeric_id_is_400(self, api_server, clean_faults):
        _, _, server = api_server
        status, _ = _request(server.port, "DELETE", "/lighthouse/faults?id=abc")
        assert status == 400


# ------------------------------------------------------------------ tracing


def test_block_import_trace_via_scheduler_and_api(api_server):
    """A block imported through the scheduler yields a retrievable trace
    whose tree has queue-wait, state-transition, device-batch, fork-choice
    and store-write spans, and the same stages reach the histograms."""
    harness, processor, server = api_server
    harness.advance_slot()
    signed = harness.produce_signed_block()
    st_before = metrics.BLOCK_STATE_TRANSITION_SECONDS.stats()[0]
    processor.send(WorkEvent(
        work_type=W.GOSSIP_BLOCK,
        process=lambda _: harness.chain.process_block(
            signed, block_delay_seconds=1.0),
    ))
    assert processor.wait_idle(15.0)

    status, listing = _request(
        server.port, "GET",
        f"/lighthouse/traces?root=work:gossip_block&slot={int(signed.message.slot)}")
    assert status == 200 and listing["data"]
    trace_id = listing["data"][0]["trace_id"]

    status, tree = _request(server.port, "GET", f"/lighthouse/traces/{trace_id}")
    assert status == 200
    names = set()

    def walk(sp):
        names.add(sp["name"])
        for c in sp["children"]:
            walk(c)

    walk(tree["data"]["root"])
    assert {"queue_wait", "block_import", "state_transition", "device_batch",
            "fork_choice", "store_write", "head_recompute"} <= names

    status, chrome = _request(
        server.port, "GET", f"/lighthouse/traces/{trace_id}?format=chrome")
    assert status == 200
    assert any(e["name"] == "block_import" for e in chrome["traceEvents"])

    assert metrics.BLOCK_STATE_TRANSITION_SECONDS.stats()[0] > st_before
    assert metrics.BLOCK_ARRIVAL_DELAY_SECONDS.stats()[0] >= 1
    assert metrics.BLOCK_IMPORTED_DELAY_SECONDS.stats()[0] >= 1

    status, _ = _request(server.port, "GET", "/lighthouse/traces/nope")
    assert status == 404


def test_http_requests_labeled_by_route_template(api_server):
    _, _, server = api_server
    _request(server.port, "GET", "/eth/v1/node/version")
    _request(server.port, "GET", "/eth/v1/beacon/states/head/root")
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    # the TEMPLATE, not the raw path, is the label (bounded cardinality)
    assert 'route="/eth/v1/beacon/states/{state_id}/root"' in text
    assert 'route="/eth/v1/node/version"' in text
    assert 'route="/eth/v1/beacon/states/head/root"' not in text
    assert metrics.HTTP_REQUESTS.get(
        method="GET", route="/eth/v1/node/version") >= 1
    assert tracing.TRACES.recent(root="http:GET /eth/v1/node/version")


# ---------------------------------------------------------------- black box


@pytest.fixture()
def clean_blackbox(tmp_path):
    blackbox.reset_for_tests()
    blackbox.configure(directory=str(tmp_path / "bundles"))
    yield
    blackbox.reset_for_tests()


class TestPostmortemEndpoints:
    def test_postmortems_summary_shape(self, api_server, clean_blackbox):
        _, _, server = api_server
        blackbox.emit("test_http", "warm")
        status, out = _request(server.port, "GET", "/lighthouse/postmortems")
        assert status == 200
        data = out["data"]
        assert {"dir", "retain", "journal", "captures", "bundles"} <= set(data)
        assert {"capacity", "stored", "emitted_total"} <= set(data["journal"])
        assert data["journal"]["stored"] >= 1

    def test_journal_endpoint_filters_and_limits(self, api_server, clean_blackbox):
        _, _, server = api_server
        for i in range(5):
            blackbox.emit("test_http_j", "tick", i=i)
        status, out = _request(
            server.port, "GET",
            "/lighthouse/postmortems/journal?source=test_http_j&limit=3")
        assert status == 200
        records = out["data"]
        assert [r["i"] for r in records] == [2, 3, 4]  # newest 3, oldest first
        assert all(r["source"] == "test_http_j" for r in records)
        status, _ = _request(
            server.port, "GET", "/lighthouse/postmortems/journal?limit=bogus")
        assert status == 400

    def test_manual_post_captures_and_bundle_fetch_roundtrips(self, api_server,
                                                              clean_blackbox):
        _, _, server = api_server
        status, out = _request(server.port, "POST", "/lighthouse/postmortem",
                               body={"reason": "ops_probe"})
        assert status == 200
        entry = out["data"]
        assert entry["reason"] == "manual:ops_probe"
        assert os.path.exists(entry["path"])
        name = os.path.basename(entry["path"])
        status, out = _request(server.port, "GET",
                               f"/lighthouse/postmortems?bundle={name}")
        assert status == 200
        bundle = out["data"]
        assert bundle["reason"] == "manual:ops_probe"
        # the admission controller's snapshot rode along (server-registered)
        assert "admission" in bundle["snapshots"]
        assert "error" not in (bundle["snapshots"]["admission"] or {})
        assert bundle["fleet"] == {"nodes": [], "timeline": []}
        status, _ = _request(server.port, "GET",
                             "/lighthouse/postmortems?bundle=../etc/passwd")
        assert status == 404

    def test_manual_post_default_reason(self, api_server, clean_blackbox):
        _, _, server = api_server
        status, out = _request(server.port, "POST", "/lighthouse/postmortem", body={})
        assert status == 200
        assert out["data"]["reason"] == "manual"

    def test_stopped_server_unregisters_its_snapshot(self, clean_blackbox):
        set_backend("fake")
        try:
            harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
            server = HttpApiServer(harness.chain).start()
            assert "admission" in blackbox._SNAPSHOTTERS
            server.stop()
            assert "admission" not in blackbox._SNAPSHOTTERS
        finally:
            set_backend("host")


# -------------------------------------------------------------------- fleet


class TestFleetEndpoint:
    def test_fleet_summary_shape_and_limit(self, api_server, clean_blackbox):
        _, _, server = api_server
        for node in ("n0", "n1"):
            scope = telemetry_scope.register(telemetry_scope.TelemetryScope(node))
            with telemetry_scope.activate(scope):
                blackbox.emit("fleet", "block_proposed", slot=1, root=node)
                blackbox.emit("fleet", "block_imported", slot=2, root=node)
        status, out = _request(server.port, "GET", "/lighthouse/fleet")
        assert status == 200
        data = out["data"]
        assert [n["node"] for n in data["nodes"]] == ["n0", "n1"]
        assert len(data["timeline"]) == 4
        status, out = _request(server.port, "GET", "/lighthouse/fleet?limit=1")
        assert status == 200
        assert len(out["data"]["timeline"]) == 1
        status, _ = _request(server.port, "GET", "/lighthouse/fleet?limit=junk")
        assert status == 400

    def test_device_batches_node_filter(self, api_server, clean_blackbox):
        _, _, server = api_server
        device_telemetry.reset_for_tests()
        scope = telemetry_scope.register(telemetry_scope.TelemetryScope("n0"))
        with telemetry_scope.activate(scope):
            device_telemetry.record_batch(op="bls_verify", shape=(8, 4), n_live=6)
        device_telemetry.record_batch(op="bls_verify", shape=(8, 4), n_live=6)
        status, out = _request(server.port, "GET",
                               "/lighthouse/device/batches?node=n0")
        assert status == 200
        assert out["data"], "node filter should match the scoped batch"
        assert all(r["node"] == "n0" for r in out["data"])
        # the journal cross-reference for a scoped batch is the fleet
        # (node, seq) pair — a plain int seq is ambiguous across N nodes
        scoped_seqs = {r["seq"] for r in out["data"]}
        journal = blackbox.JOURNAL.window(source="device_batch")
        assert any(r.get("flight_seq") == ["n0", s]
                   for r in journal for s in scoped_seqs)
        assert any(isinstance(r.get("flight_seq"), int) for r in journal)
        status, out = _request(server.port, "GET",
                               "/lighthouse/device/batches?node=ghost")
        assert status == 200
        assert out["data"] == []


# ------------------------------------------------------------ subnet service


def test_http_endpoint_feeds_subnet_service():
    """POST beacon_committee_subscriptions reaches the subnet service
    through the API server."""
    from lighthouse_tpu_torch.network.service import NetworkService
    from lighthouse_tpu_torch.network.subnet_service import SubnetService
    from lighthouse_tpu_torch.network.transport import Hub
    from lighthouse_tpu_torch.types.spec import minimal_spec

    set_backend("fake")
    try:
        harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
        hub = Hub()
        svc = NetworkService(hub.register("subnet-node"))
        sub = SubnetService(service=svc, digest=b"\x00\x01\x02\x03", spec=minimal_spec(),
                            node_id=int.from_bytes(b"\x77" * 32, "big"))
        server = HttpApiServer(harness.chain).start()
        server.subnet_service = sub
        try:
            body = json.dumps([{
                "validator_index": "1", "committee_index": "0",
                "committees_at_slot": "1", "slot": "5", "is_aggregator": True,
            }]).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/eth/v1/validator/beacon_committee_subscriptions",
                data=body, headers={"Content-Type": "application/json"},
                method="POST")
            urllib.request.urlopen(req, timeout=5)
            assert sub._duty_until_slot, "endpoint did not reach the service"
        finally:
            server.stop()
            svc.shutdown()
    finally:
        set_backend("host")


# ---------------------------------------------------------------- serve load


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, REPO_ROOT)
    import bench as bench_mod

    return bench_mod


def test_percentile_helper(bench):
    assert bench._percentile([], 0.99) == 0.0
    vals = [float(i) for i in range(1, 101)]
    assert bench._percentile(vals, 0.50) == 51.0
    assert bench._percentile(vals, 0.99) == 99.0
    assert bench._percentile(vals, 1.0) == 100.0


def test_phase_runner_smoke(bench):
    """A tiny phase run against the port's server: stats for every route,
    zero errors, and the cache serving hits on the second wave."""
    set_backend("fake")
    try:
        harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
        harness.extend_chain(4)
        server = HttpApiServer(harness.chain).start()
        try:
            epoch = harness.chain.current_slot() // harness.spec.slots_per_epoch
            mix = bench._serve_request_mix(epoch, 16)
            stats, errors, wall = bench._serve_run_phase(
                server.port, clients=6, reqs_per_client=len(mix), mix=mix,
                timeout_s=60.0)
            assert errors == 0
            assert set(stats) == {m[0] for m in mix}
            for label, s in stats.items():
                assert s["n"] == 6, label
                assert s["p99_s"] >= s["p50_s"] >= 0.0
            snap = server.response_cache.snapshot()
            assert snap["hits"] > 0, "second wave never hit the cache"
        finally:
            server.stop()
    finally:
        set_backend("host")
