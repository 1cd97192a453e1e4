"""The port's device runtime vs the JAX package's, on the same scripted inputs.

- ``fault_injection``: the same plan spec parses to the same plan dicts in
  both packages, and the same plans fire the same sequence of effects under
  the same seed (call-counted and slot-keyed).
- ``device_supervisor``: the same scripted sequence of device outcomes
  (success, error, split retry, hang past the watchdog, a HostFallback
  disclaimer, breaker trip, OPEN routing, cooldown, HALF_OPEN probes) gives
  the same routes, info dicts, breaker transitions, fallback counters and
  summaries in both.
- ``device_telemetry.record_batch``: the same arguments give the same
  flight-record fields (``seq``, ``t_ms`` and ``trace_id`` aside), and the
  same ``summary()``, apart from the device list of ``memory``, the mesh's
  topology generation and the port's device names.
- ``timeout_lock``, ``tracing``, ``metrics``: the copies behave as the
  reference does on small probes.
- ``host_on_failure=False`` (the port's callers on the card): device
  errors, timeouts and an OPEN breaker raise; only a disclaimer reaches
  the host.

Everything here is host-side Python: no device program runs.
"""

import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import blackbox as j_bb  # noqa: E402
from lighthouse_tpu import device_supervisor as j_ds  # noqa: E402
from lighthouse_tpu import device_telemetry as j_dt  # noqa: E402
from lighthouse_tpu import fault_injection as j_fi  # noqa: E402
from lighthouse_tpu import metrics as j_metrics  # noqa: E402
from lighthouse_tpu import tracing as j_tracing  # noqa: E402
from lighthouse_tpu_torch import blackbox as p_bb  # noqa: E402
from lighthouse_tpu_torch import device_supervisor as p_ds  # noqa: E402
from lighthouse_tpu_torch import device_telemetry as p_dt  # noqa: E402
from lighthouse_tpu_torch import fault_injection as p_fi  # noqa: E402
from lighthouse_tpu_torch import timeout_lock  # noqa: E402
from lighthouse_tpu_torch import metrics as p_metrics  # noqa: E402
from lighthouse_tpu_torch import tracing as p_tracing  # noqa: E402

PACKAGES = {
    "jax": (j_fi, j_ds, j_dt, j_metrics),
    "port": (p_fi, p_ds, p_dt, p_metrics),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does (in a
    parallel test run every worker's thread pool would compete for the
    same cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def clean_state(tmp_path):
    """Fresh supervisor, fault registry, flight recorder and black box in
    both packages; bundles go to this test's own directory."""
    for fi, ds, dt, _ in PACKAGES.values():
        fi.reset_for_tests()
        ds.reset_for_tests()
        dt.reset_for_tests()
    for bb in (j_bb, p_bb):
        bb.reset_for_tests()
        bb.configure(directory=str(tmp_path))
    yield
    for fi, ds, dt, _ in PACKAGES.values():
        fi.reset_for_tests()
        ds.reset_for_tests()
        dt.reset_for_tests()
    for bb in (j_bb, p_bb):
        bb.reset_for_tests()


# ------------------------------------------------------------ fault plans


SPECS = [
    "device.dispatch=error",
    "device.dispatch[op=bls_verify]=error",
    "device.dispatch[op=kzg_batch]=error:first_n=2",
    "device.result=corrupt:probability=0.5,seed=42",
    "device.compile=hang:sleep_s=0.25,probability=0.3",
    "device.dispatch[op=bls_verify]=hang:sleep_s=5,first_n=1;"
    "device.result[op=bls_verify]=corrupt:first_n=3;store.write=error:message=disk full",
    "net.deliver=error:probability=0.2;api.handler=hang:probability=0.7,seed=7,sleep_s=0.1",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_to_the_same_plans(spec):
    plans = {name: [p.to_dict() for p in pkg[0].parse_spec(spec)]
             for name, pkg in PACKAGES.items()}
    assert plans["port"] == plans["jax"]
    assert p_fi.POINTS == j_fi.POINTS and p_fi.MODES == j_fi.MODES


@pytest.mark.parametrize("bad", ["device.dispatch", "device.dispatch=explode", "nowhere=error",
                                 "device.dispatch=error:first_n=0",
                                 "device.dispatch[zone=x]=error",
                                 "device.dispatch=error:first_n=1,probability=0.5"])
def test_malformed_fault_specs_fail_alike(bad):
    with pytest.raises(ValueError):
        j_fi.parse_spec(bad)
    with pytest.raises(ValueError):
        p_fi.parse_spec(bad)


def _fire_sequence(fi, spec, calls, slots=None):
    """Install ``spec`` in a fresh registry and fire ``calls`` (point, op)
    pairs; record each call's effect.  Hangs are recorded, not slept."""
    slept = []
    fi.set_sleeper(slept.append)
    slot = {"now": None}
    if slots is not None:
        fi.set_slot_provider(lambda: slot["now"])
    reg = fi.FaultRegistry()
    for plan in fi.parse_spec(spec):
        reg.install(plan)
    out = []
    try:
        for i, (point, op) in enumerate(calls):
            if slots is not None:
                slot["now"] = slots[i]
            n_slept = len(slept)
            try:
                action = reg.fire(point, op=op)
            except fi.InjectedFault as e:
                action = f"error:{e}"
            out.append((action, tuple(slept[n_slept:])))
    finally:
        fi.set_sleeper(None)
        fi.set_slot_provider(None)
    return out, reg.plans()


CALLS = [(pt, op) for _ in range(12)
         for pt, op in (("device.dispatch", "bls_verify"), ("device.result", "bls_verify"),
                        ("device.compile", "kzg_batch"), ("device.dispatch", "kzg_batch"),
                        ("net.deliver", None), ("api.handler", "x"))]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("slotted", [False, True], ids=["call_order", "slot_keyed"])
def test_fault_plans_fire_the_same_sequence(spec, slotted):
    slots = [i // 5 for i in range(len(CALLS))] if slotted else None
    jax_seq, jax_plans = _fire_sequence(j_fi, spec, CALLS, slots)
    port_seq, port_plans = _fire_sequence(p_fi, spec, CALLS, slots)
    assert port_seq == jax_seq
    assert port_plans == jax_plans
    assert any(effect != (None, ()) for effect in jax_seq)


def test_inactive_registry_is_a_no_op():
    assert p_fi.ACTIVE is False
    assert p_fi.fire("device.dispatch", op="bls_verify") is None
    p_fi.check("device.dispatch")
    plan = p_fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
    assert p_fi.ACTIVE is True
    with pytest.raises(p_fi.InjectedFault):
        p_fi.check("device.dispatch", op="bls_verify")
    p_fi.check("device.dispatch", op="bls_verify")
    assert p_fi.plans()[0]["fired"] == 1 and plan.hits == 2
    assert p_fi.clear() == 1 and p_fi.ACTIVE is False


# ------------------------------------------------------------- supervisor


class Scripted:
    """The device and host legs of one scripted step, alike for both
    packages: ``ok`` returns "dev", ``error`` raises, ``hang`` sleeps past
    the watchdog, ``disclaim`` raises the package's HostFallback, ``split``
    fails whole but succeeds in halves."""

    def __init__(self, ds, kind):
        self.ds, self.kind = ds, kind
        self.release = threading.Event()

    def device(self):
        if self.kind in ("ok", "probe"):
            return "dev"
        if self.kind == "hang":
            self.release.wait(5.0)
            return "late"
        if self.kind == "disclaim":
            raise self.ds.HostFallback("w_at_infinity")
        raise RuntimeError(f"scripted {self.kind}")

    def split(self):
        if self.kind == "split":
            return [lambda: "half-a", lambda: "half-b"]
        if self.kind == "split_disclaim":
            def half():
                raise self.ds.HostFallback("w_at_infinity")
            return [half, half]
        raise RuntimeError("halves fail too")


SCRIPT = [
    ("bls_verify", "ok"),
    ("bls_verify", "error"),
    ("bls_verify", "split"),
    ("bls_verify", "hang"),
    ("bls_verify", "disclaim"),
    ("bls_verify", "split_disclaim"),
    ("kzg_batch", "ok"),
    ("kzg_batch", "split"),       # kzg_batch never splits: host decides
    ("bls_verify", "error"),
    ("bls_verify", "error"),      # threshold 2 in a row: OPEN
    ("bls_verify", "ok"),         # OPEN: routed to the host untouched
    ("cooldown", None),
    ("bls_verify", "error"),      # the HALF_OPEN probe fails: OPEN again
    ("cooldown", None),
    ("bls_verify", "probe"),
    ("bls_verify", "probe"),      # two probes: CLOSED
    ("bls_verify", "ok"),
]


def _counter_values(metrics):
    return {
        "fallback": metrics.DEVICE_HOST_FALLBACK.snapshot(),
        "timeouts": metrics.DEVICE_DISPATCH_TIMEOUTS.snapshot(),
        "splits": metrics.DEVICE_SPLIT_RETRIES.snapshot(),
        "transitions": metrics.DEVICE_BREAKER_TRANSITIONS.snapshot(),
    }


def _deltas(before, after):
    return {name: {k: v - before[name].get(k, 0.0) for k, v in after[name].items()
                   if v != before[name].get(k, 0.0)}
            for name in after}


def _run_script(pkg):
    fi, ds, dt, metrics = pkg
    clock = [1000.0]
    ds.set_cooldown_clock(lambda: clock[0])
    ds.SUPERVISOR.configure(
        config=ds.BreakerConfig(failure_threshold=2, open_cooldown_s=30.0,
                                probe_successes=2),
        deadlines={"bls_verify": 0.2, "kzg_batch": 5.0})
    before = _counter_values(metrics)
    # The recorder's sequence counts records since the process started;
    # earlier test files in the same worker may have recorded batches.
    seq0 = dt.FLIGHT_RECORDER.recorded_total
    steps, hangs = [], []
    for op, kind in SCRIPT:
        if op == "cooldown":
            clock[0] += 31.0
            steps.append("cooldown")
            continue
        leg = Scripted(ds, kind)
        if kind == "hang":
            hangs.append(leg)
        info = {}
        out = ds.run(op, leg.device, host_fn=lambda: "host", split_fn=leg.split,
                     combine_fn=lambda rs: "+".join(rs), info=info)
        info.pop("host_seconds", None)
        info.pop("device_error", None)
        dt.record_batch(op=op, shape=(2, 1), n_live=2, live_keys=2, verdict=True,
                        host_fallback=info.get("route") == "host",
                        fallback_reason=info.get("fallback_reason"),
                        breaker_state=info.get("breaker_state"),
                        dispatched=info.get("fallback_reason") != "breaker_open")
        steps.append((op, kind, out, info, ds.SUPERVISOR.breaker(op).snapshot()))
    for leg in hangs:
        leg.release.set()
    summary = dt.summary()
    summary["flight_recorder"]["recorded_total"] -= seq0
    return steps, _deltas(before, _counter_values(metrics)), summary


def test_scripted_supervisor_sequence_matches_reference():
    jax_steps, jax_counts, jax_summary = _run_script(PACKAGES["jax"])
    port_steps, port_counts, port_summary = _run_script(PACKAGES["port"])
    assert port_steps == jax_steps
    assert port_counts == jax_counts
    # What the script drove, spelled out.
    assert [s[2] for s in port_steps if s != "cooldown"] == [
        "dev", "host", "half-a+half-b", "host", "host", "host", "dev", "host",
        "host", "host", "host", "host", "dev", "dev", "dev"]
    assert port_counts["fallback"] == {
        (("reason", "device_error"),): 5.0, (("reason", "dispatch_timeout"),): 1.0,
        (("reason", "w_at_infinity"),): 2.0, (("reason", "breaker_open"),): 1.0}
    assert port_counts["transitions"] == {
        (("op", "bls_verify"), ("to", "open")): 2.0,
        (("op", "bls_verify"), ("to", "half_open")): 2.0,
        (("op", "bls_verify"), ("to", "closed")): 1.0}
    # The summaries: memory lists each package's own devices (jax's CPU
    # devices here, the port's CUDA cards); the mesh's generation counts
    # each process's own reconfigurations, and the port names its devices.
    jax_summary.pop("memory")
    port_summary.pop("memory")
    for summary in (jax_summary, port_summary):
        summary["mesh"].pop("generation")
    assert port_summary["mesh"].pop("device_names") == []
    assert port_summary == jax_summary


@pytest.mark.parametrize("op", ["bls_verify", "kzg_batch", "sha256_pairs", "tree_hash",
                                "epoch_deltas", "epoch_deltas_leak", "epoch_boundary",
                                "epoch_boundary_leak", "shuffle", "proposer_select",
                                "autotune_probe"])
def test_deadlines_and_split_policy_match_reference(op):
    assert p_ds.DEFAULT_DEADLINES[op] == j_ds.DEFAULT_DEADLINES[op]
    assert (op in p_ds.NO_SPLIT_OPS) == (op in j_ds.NO_SPLIT_OPS)
    assert p_ds.STATE_CODES == j_ds.STATE_CODES


def test_breaker_without_host_fn_requeues_like_reference():
    for ds in (j_ds, p_ds):
        ds.SUPERVISOR.configure(config=ds.BreakerConfig(failure_threshold=1))

        def boom():
            raise RuntimeError("down")

        with pytest.raises(RuntimeError, match="down"):
            ds.run("bls_verify", boom)
        with pytest.raises(ds.RequeueWork):
            ds.run("bls_verify", boom)


CARD_CASES = {
    # kind: (what run() does with host_on_failure=False, fallback delta)
    "ok": ("dev", {}),
    "split": ("half-a+half-b", {}),
    "error": (RuntimeError, {}),
    "hang": (p_ds.DispatchTimeout, {}),
    "disclaim": ("host", {(("reason", "w_at_infinity"),): 1.0}),
    "split_disclaim": ("host", {(("reason", "w_at_infinity"),): 1.0}),
    "open": (p_ds.RequeueWork, {}),
}


@pytest.mark.parametrize("kind", list(CARD_CASES))
def test_failures_raise_when_host_on_failure_is_off(kind):
    """The port's callers on the card pass ``host_on_failure=False``: a
    device error (after its split retry), a hang and an OPEN breaker raise
    into the caller with the reference's breaker and timeout accounting,
    and the host leg runs only for a disclaimer."""
    p_ds.SUPERVISOR.configure(
        config=p_ds.BreakerConfig(failure_threshold=1, open_cooldown_s=300.0),
        deadlines={"bls_verify": 0.2})
    if kind == "open":
        p_ds.SUPERVISOR.breaker("bls_verify").record_failure("device_error")
    leg = Scripted(p_ds, "ok" if kind == "open" else kind)
    host_calls = []
    before = _counter_values(p_metrics)
    expect, fallbacks = CARD_CASES[kind]
    try:
        call = lambda: p_ds.run(  # noqa: E731
            "bls_verify", leg.device, host_fn=lambda: host_calls.append(1) or "host",
            split_fn=leg.split, combine_fn=lambda rs: "+".join(rs),
            host_on_failure=False)
        if isinstance(expect, str):
            assert call() == expect
        else:
            with pytest.raises(expect):
                call()
    finally:
        leg.release.set()
    deltas = _deltas(before, _counter_values(p_metrics))
    assert deltas["fallback"] == fallbacks
    assert host_calls == ([1] if fallbacks else [])
    assert deltas["timeouts"] == ({(("op", "bls_verify"),): 1.0} if kind == "hang" else {})
    tripped = kind in ("error", "hang")
    assert p_ds.breaker_state("bls_verify") == ("open" if tripped or kind == "open" else "closed")


def test_breaker_transitions_reach_registered_event_bus():
    class Bus:
        def __init__(self):
            self.events = []

        def device_breaker(self, **payload):
            self.events.append((payload["op"], payload["from"], payload["to"]))

    bus = Bus()
    p_ds.register_event_bus(bus)
    p_ds.SUPERVISOR.configure(config=p_ds.BreakerConfig(
        failure_threshold=1, open_cooldown_s=0.0, probe_successes=1))

    def boom():
        raise RuntimeError("down")

    assert p_ds.run("t_bus", boom, host_fn=lambda: "host") == "host"
    assert p_ds.run("t_bus", lambda: "dev", host_fn=lambda: "host") == "dev"
    assert bus.events == [("t_bus", "closed", "open"), ("t_bus", "open", "half_open"),
                          ("t_bus", "half_open", "closed")]
    assert p_metrics.DEVICE_BREAKER_STATE.get(op="t_bus") == 0
    # the OPEN transition froze a postmortem bundle, as the reference does
    assert [c["reason"] for c in p_bb.captures()] == ["breaker_open:t_bus"]


# ------------------------------------------------------- flight recorder


RECORD_ARGS = [
    dict(op="bls_verify", shape=(128, 32), n_live=100, live_keys=3000,
         stages={"setup": 0.5, "dispatch": 1.25, "wait": 0.001, "verdict": 0.0002},
         verdict=True, compiled=True, breaker_state="closed"),
    dict(op="bls_verify", shape=(256, 32), n_live=200, live_keys=200 * 17, n_groups=10,
         work_mix={"block_import": 128, "gossip_attestation": 72}, verdict=False,
         breaker_state="closed"),
    dict(op="bls_verify", shape=(4, 1), n_live=4, live_keys=4, verdict=True,
         host_fallback=True, fallback_reason="device_error", breaker_state="closed"),
    dict(op="bls_verify", shape=(1, 1), n_live=1, live_keys=1, verdict=True,
         host_fallback=True, fallback_reason="breaker_open", breaker_state="open",
         dispatched=False),
    dict(op="kzg_batch", shape=(8,), n_live=6, stages={"setup": 0.001}, verdict=True,
         host_fallback=True, fallback_reason="dispatch_timeout", breaker_state="closed"),
    dict(op="kzg_batch", shape=(256,), n_live=192, verdict=True),
]


@pytest.mark.parametrize("args", RECORD_ARGS, ids=lambda a: f"{a['op']}-{a['shape']}")
def test_record_batch_fields_match_reference(args):
    with j_tracing.span("root"):
        jax_rec = j_dt.record_batch(**args, trace_id=j_dt.active_trace_id())
    with p_tracing.span("root"):
        port_rec = p_dt.record_batch(**args, trace_id=p_dt.active_trace_id())
    assert port_rec["trace_id"] is not None
    volatile = ("seq", "t_ms", "trace_id")
    assert ({k: v for k, v in port_rec.items() if k not in volatile}
            == {k: v for k, v in jax_rec.items() if k not in volatile})
    assert p_dt.host_fallback_counts() == j_dt.host_fallback_counts()
    # the journal saw the batch with its flight_seq, in both packages
    jax_j = j_bb.JOURNAL.window(source="device_batch")[-1]
    port_j = p_bb.JOURNAL.window(source="device_batch")[-1]
    assert port_j["flight_seq"] == port_rec["seq"]
    drop = ("seq", "t_ms", "trace_id", "flight_seq")
    assert ({k: v for k, v in port_j.items() if k not in drop}
            == {k: v for k, v in jax_j.items() if k not in drop})


def test_recent_inflight_seconds_matches_reference():
    for dt in (j_dt, p_dt):
        for i in range(5):
            dt.record_batch(op="bls_verify", shape=(8, 1), n_live=8,
                            stages={"dispatch": 0.1 * (i + 1), "wait": 0.01},
                            compiled=i == 0)
    assert p_dt.recent_inflight_seconds("bls_verify") == pytest.approx(
        j_dt.recent_inflight_seconds("bls_verify"))
    assert p_dt.recent_inflight_seconds("kzg_batch") is None


def test_first_dispatch_mirror_and_warmup_notes():
    assert p_dt.note_dispatch("bls_verify", (2, 1), 1.5) is True
    assert p_dt.note_dispatch("bls_verify", (2, 1), 0.1) is False
    p_dt.note_warmup("cuda_fq_build", (), 3.0, hit=False)
    p_dt.note_warmup("kzg_batch", (8,), 0.5, hit=True)
    inv = {(e["op"], e["shape"]): e for e in p_dt.COMPILE_CACHE.inventory()}
    assert inv[("bls_verify", "2x1")]["invocations"] == 2
    assert inv[("cuda_fq_build", "")]["warmup_outcome"] == "miss"
    assert inv[("kzg_batch", "8")]["warmup_outcome"] == "hit"
    assert p_dt.COMPILE_CACHE.seen("kzg_batch", (8,))
    assert not p_dt.COMPILE_CACHE.seen("kzg_batch", (16,))
    assert p_dt.device_memory_stats() == ([] if not torch.cuda.is_available()
                                          else p_dt.device_memory_stats())


def test_capture_profile_refused_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("LIGHTHOUSE_TPU_FORCE_PROFILER", raising=False)
    with pytest.raises(p_dt.ProfilerUnavailable):
        p_dt.capture_profile(0.05)


# ------------------------------------------------------- support modules


def test_timeout_lock_raises_instead_of_hanging():
    lk = timeout_lock.TimeoutLock("t", timeout=0.05)
    with lk:
        t = threading.Thread(target=lambda: pytest.raises(timeout_lock.LockTimeout, lk.acquire))
        t.start()
        t.join()
    assert not lk.locked()


def test_tracing_and_metrics_render_alike():
    for tracing, metrics in ((j_tracing, j_metrics), (p_tracing, p_metrics)):
        with tracing.span("probe_root", slot=7) as root:
            with tracing.span("probe_child", hist=metrics.DEVICE_VERDICT_SECONDS):
                tracing.annotate(flight_seq=3)
        assert tracing.TRACES.recent(root="probe_root", slot=7)[0] is root.trace
        assert tracing.trace_to_dict(root.trace)["root"]["children"][0]["fields"] == {"flight_seq": 3}
    for name in ("device_batch_host_fallback_total", "device_breaker_state",
                 "device_pipeline_batch_fill_ratio", "beacon_attestation_batch_size"):
        j, p = j_metrics._REGISTRY[name], p_metrics._REGISTRY[name]
        assert (p.kind, p.help, getattr(p, "buckets", None)) == (j.kind, j.help, getattr(j, "buckets", None))
    assert "# TYPE device_batch_host_fallback_total counter" in p_metrics.render_prometheus()


def test_watchdog_returns_before_a_hung_leg():
    release = threading.Event()
    p_ds.SUPERVISOR.configure(deadlines={"t_hang": 0.1})
    t0 = time.perf_counter()
    info = {}
    assert p_ds.run("t_hang", lambda: release.wait(5.0), host_fn=lambda: "host",
                    info=info) == "host"
    assert time.perf_counter() - t0 < 2.0
    assert info["fallback_reason"] == "dispatch_timeout"
    release.set()
    assert p_ds.run("t_hang", lambda: "dev", host_fn=lambda: "host") == "dev"
