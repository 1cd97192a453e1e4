"""A run of the harness with the timed path replaced underneath, the
per-layer readers and the roofline arithmetic on hand-counted inputs."""

import io
import json
import random
import subprocess
import sys
import threading
import time
import types
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from lhbench import gossip, harness
from lhbench.reference import curve, serde
from lhbench.reference.verify import control_hash, verify_call

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
CELL = BENCH["workloads"][0]
TINY = gossip.Deployment("tiny", 1 << 20, 2, 6, 2)


def _mix(**over):
    raw = {"item_sets": ["attestation"], "slots": 2, "offered_sets_per_s": 20, "max_in_flight_calls": 4, "items_per_call": 2,
           "warmup_s": 0.3, "sample_calls": 2}
    raw.update(over)
    return gossip.Mix.from_dict("tiny", raw)


class StandIn:
    """The system's methods around a verdict function of the call."""

    def __init__(self, traffic, verdict):
        self._traffic = traffic
        self._verdict = verdict

    def call(self, call):
        t = time.perf_counter()
        verdict = self._verdict(self._traffic, call)
        time.sleep(0.1)
        return verdict, (t, t + 0.005)

    def counters(self):
        return {"batches": 0, "sets": 0}

    def flight_records(self, after_seq):
        return []

    def last_seq(self):
        return 0

    def host_spans(self):
        return []

    def close(self):
        pass


def _run(traffic, verdict, monkeypatch, seconds=1.0, system=None):
    monkeypatch.setattr(gossip, "pool_size", lambda: 1)
    args = types.SimpleNamespace(seconds=seconds, trace=0, seed=traffic.seed)
    out, err = io.StringIO(), io.StringIO()
    stats = lambda card: {"platform": "gpu", "kind": card, "count": 1, "memory_peak_bytes": 1}
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.run(args, BENCH, CELL, traffic, system or StandIn(traffic, verdict),
                         time.perf_counter(), "stand-in", None, device_stats=stats)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def _reference(traffic, call, rng=None, **kwargs):
    keys = [[traffic.keys[v] for v in s] for s in call.signers]
    return verify_call(call.sigs, call.messages, keys, rng or random.Random(call.index), **kwargs)


@pytest.fixture(scope="module")
def traffic():
    return gossip.make(TINY, _mix(), 2**31 + 99, workers=1)


def test_last_line_has_the_result_shape(traffic, monkeypatch):
    result, err = _run(traffic, lambda t, c: c.valid, monkeypatch)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in
                                      harness.cell_metrics(BENCH, "end_to_end", CELL["name"])}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(result["checks"])
    assert all(ln.startswith("check ") and " limit " in ln for ln in tail)


@pytest.mark.parametrize("fault", ["answer_altered", "no_answer", "control"])
def test_faults_on_valid_traffic_come_out_not_correct(traffic, monkeypatch, fault):
    flip = traffic.calls[2].index

    def answer_altered(t, c):
        return c.valid if c.index != flip else not c.valid

    def no_answer(t, c):
        if c.index == flip:
            raise RuntimeError("the device leg failed")
        return c.valid

    def control(t, c):
        return _reference(t, c, hash_fn=control_hash)

    fn = {"answer_altered": answer_altered, "no_answer": no_answer, "control": control}[fault]
    result, _ = _run(traffic, fn, monkeypatch, seconds=2.0 if fault == "control" else 1.0)
    assert result["correct"] is False
    assert sum(c["value"] > c["limit"] for c in result["checks"].values()) >= 1


@pytest.mark.parametrize("fault", ["always_true", "first_half_left_out", "last_half_left_out"])
def test_the_tampered_probe_fails_a_verifier_that_leaves_sets_out(traffic, monkeypatch, fault):
    """A verifier that answers without verifying, or verifies half of each
    call's sets, is right on the load's valid calls; the probe's tampered
    calls make it come out not correct."""
    assert all(c.valid for c in traffic.calls)

    def half(keep_last):
        def verdict(t, c):
            h = c.n_sets // 2
            part = slice(h, None) if keep_last else slice(0, c.n_sets - h)
            return _reference(t, gossip.Call(c.index, c.sigs[part], c.messages[part],
                                             c.signers[part]))
        return verdict

    fn = {"always_true": lambda t, c: True, "first_half_left_out": half(True),
          "last_half_left_out": half(False)}[fault]
    result, _ = _run(traffic, fn, monkeypatch, seconds=1.0)
    assert result["correct"] is False
    assert result["checks"]["probe_wrong"]["value"] >= 1
    assert result["checks"]["wrong_verdicts"]["value"] == 0


class _Weights:
    """A stand-in verifier's weights: ``draw()`` in place of a random
    64-bit number."""

    def __init__(self, draw):
        self.getrandbits = lambda bits: draw()


class SharedVerdict(StandIn):
    """A pipeline without per-call attribution: calls that arrive within
    50 ms of the first form one batch, and each gets the batch's verdict."""

    def __init__(self, traffic):
        super().__init__(traffic, None)
        self._lock = threading.Lock()
        self._open = None
        self.batches = 0

    def call(self, call):
        t = time.perf_counter()
        with self._lock:
            lead = self._open is None
            if lead:
                self._open = {"calls": [], "done": threading.Event()}
            batch = self._open
            batch["calls"].append(call)
        if lead:
            time.sleep(0.05)
            with self._lock:
                self._open = None
                self.batches += 1
            batch["verdict"] = all(_reference(self._traffic, c) for c in batch["calls"])
            batch["done"].set()
        batch["done"].wait()
        return batch["verdict"], (t, t + 0.005)

    def counters(self):
        return {"batches": self.batches, "sets": 0}


@pytest.mark.parametrize("fault", ["no_subgroup_check", "no_weights", "shared_verdict"])
def test_the_probe_fails_a_verifier_without_a_guarantee(traffic, monkeypatch, fault):
    """Each fault is right on the load's valid calls, and the probe makes it
    come out not correct: a verifier without the subgroup check whose
    weights are multiples of 13 (as one in 13 of a real verifier's are,
    which is what lets the twist's torsion point through); one without the
    random weights; a pipeline that gives a coalesced batch's verdict to
    each of its calls."""

    def no_subgroup_check(t, c):
        rng = random.Random(c.index)
        return _reference(t, c, rng=_Weights(lambda: 13 * rng.getrandbits(59) or 13),
                          subgroup_check=False)

    def no_weights(t, c):
        return _reference(t, c, rng=_Weights(lambda: 1))

    system = None
    if fault == "shared_verdict":
        system = SharedVerdict(traffic)
    fn = {"no_subgroup_check": no_subgroup_check, "no_weights": no_weights,
          "shared_verdict": None}[fault]
    result, err = _run(traffic, fn, monkeypatch, seconds=1.0, system=system)
    assert result["correct"] is False
    assert result["checks"]["probe_wrong"]["value"] >= 1
    assert result["checks"]["wrong_verdicts"]["value"] == 0
    if fault == "shared_verdict":
        assert "probe round 1: 5 calls at once, 1 batch(es)" in err


def test_the_probe_calls_are_tampered_at_either_end(traffic):
    probes = harness.probe_calls(traffic)
    kinds = [(p.kind, p.together) for p in probes]
    assert kinds.count(("outside_g2", 0)) == harness.OUTSIDE_PROBES
    assert kinds.count(("valid", 1)) == 3 and kinds.count(("valid", 2)) == 2
    assert {("swapped_first", 0), ("swapped_last", 0), ("unweighted", 0), ("swapped", 1),
            ("unweighted", 1), ("outside_g2", 2)} <= set(kinds)
    by_index = {c.index: c for c in traffic.calls}
    for p in probes:
        orig = by_index[p.call.index]
        assert p.call.valid is (p.kind == "valid")
        assert p.call.messages == orig.messages[:p.call.n_sets]
        assert p.call.signers == orig.signers[:p.call.n_sets]
        changed = [i for i in range(p.call.n_sets) if p.call.sigs[i] != orig.sigs[i]]
        points = [serde.g2_decompress(p.call.sigs[i]) for i in changed]
        if p.kind == "valid":
            assert changed == []
        elif p.kind == "swapped_last":
            assert changed == [p.call.n_sets - 1]
        elif p.kind in ("swapped_first", "swapped", "outside_g2"):
            assert changed == [0]
            assert all(curve.in_g2(q) for q in points) is (p.kind != "outside_g2")
        else:   # unweighted: two signatures changed, their sum kept
            assert changed == [0, 1] and all(curve.in_g2(q) for q in points)
            assert curve.add(*points) == curve.add(*[serde.g2_decompress(orig.sigs[i])
                                                     for i in changed])
        assert _reference(traffic, p.call) is p.call.valid, p.kind


def test_an_outside_g2_probe_passes_without_the_subgroup_check_when_13_divides_the_weight(traffic):
    probe = next(p for p in harness.probe_calls(traffic) if p.kind == "outside_g2")
    one = gossip.Call(probe.call.index, probe.call.sigs[:1], probe.call.messages[:1],
                      probe.call.signers[:1])
    assert not _reference(traffic, one)
    for weight, verdict in ((13 * 977, True), (13 * 977 + 1, False)):
        assert _reference(traffic, one, rng=_Weights(lambda: weight),
                          subgroup_check=False) is verdict


def test_arrivals_keep_their_schedule_and_wait_for_a_free_slot():
    calls = [gossip.Call(i, [b""], [b""], [(0,)]) for i in range(6)]

    def entry(call):
        time.sleep(0.3)
        return True, (0.0, 0.0)

    loop = harness.OpenLoop(calls, entry, interval=0.05, max_in_flight=2)
    t = time.perf_counter()
    loop.start(t, t + 0.5)
    assert loop.drain(10) == 0
    dues = sorted(r.due - t for r in loop.records)
    assert dues == pytest.approx([0.0, 0.05, 0.1, 0.15], abs=1e-9)
    # two slots: the third call starts when the first returns, ~0.2 s late;
    # the fifth finds a slot only at ~0.6 s, after the close, and is shed
    # with the sixth
    assert loop.late_s >= 0.2 and not loop.exhausted and loop.shed == 2
    assert max(r.done - r.due for r in loop.records) >= 0.5
    assert all(r.start >= r.due for r in loop.records)


def _record(i, n, s, d, verdict=True, due=None):
    return harness.Record(i, n, s if due is None else due, s, d, verdict, None, (s, s))


def test_rate_counts_each_calls_work_inside_the_window():
    records = [_record(0, 10, 0.0, 2.0), _record(1, 10, 1.0, 3.0), _record(2, 10, 3.0, 5.0),
               _record(3, 10, 4.0, 6.0, verdict=None)]
    e2e = harness.end_to_end(records[1:3], 1.0, 4.0, records, setup_s=7.0)
    # call 0: half inside; call 1: whole; call 2: half; call 3: no verdict
    assert e2e["sets_per_s"] == pytest.approx((5 + 10 + 5) / 3.0)
    assert e2e["call_p95_s"] == pytest.approx(2.0)
    assert e2e["setup_s"] == 7.0
    assert harness.percentile(list(range(1, 101)), 0.95) == 95
    # a call submitted late counts its work from submission, its latency
    # from when it was due
    late = _record(4, 10, 2.0, 4.0, due=0.5)
    assert harness.in_window(late, 1.0, 4.0)
    e2e = harness.end_to_end([late], 1.0, 4.0, [late], setup_s=7.0)
    assert e2e["sets_per_s"] == pytest.approx(10 / 3.0)
    assert e2e["call_p95_s"] == pytest.approx(3.5)


def _trace(kernels, busy, t0=0.0, t1=10.0):
    return harness.DeviceTrace(window_s=t1 - t0, busy_s=sum(b - a for a, b in busy),
                               kernels=kernels, busy=busy, sm_clock_mhz=1980.0,
                               aligned=True, t_start=t0, t_stop=t1)


def test_readers_and_breakdown_on_a_hand_made_trace():
    kernels = [("fq_mul_kernel", 1.0, 1.5), ("add", 1.4, 2.0), ("fq_mul_kernel", 6.0, 6.5)]
    trace = _trace(kernels, harness.union([(s, e) for _, s, e in kernels]))
    flight = [{"seq": 1, "n_live": 100, "live_keys": 100,
               "stages_s": {"setup": 0.4, "dispatch": 1.0, "wait": 0.5}},
              {"seq": 2, "n_live": 300, "live_keys": 900,
               "stages_s": {"setup": 1.2, "dispatch": 2.0, "wait": 0.5}}]
    run = harness.RunData(flight=flight, counters={"batches": 2, "sets": 400}, trace=trace)
    read = {m["name"]: harness.load_reader(m["name"])(run) for m in BENCH["per_layer"]}
    assert read["batch_sets.bls"] == 200
    assert read["build_ms_per_set.bls"] == pytest.approx(1000 * 1.6 / 400)
    assert read["device_stage_s.bls"] == pytest.approx(2.0)
    assert read["launches_per_batch.bls"] == 1.5
    assert read["device_idle_share.bls"] == pytest.approx(100 * (1 - 1.5 / 10))
    assert 0 < read["bls_verify_roofline"] < 100
    empty = harness.RunData(flight=[], counters={"batches": 0, "sets": 0}, trace=None)
    assert all(harness.load_reader(m["name"])(empty) is None for m in BENCH["per_layer"])
    spans = [("pipeline_build", 2.0, 5.5), ("parse", 0.0, 0.9), ("device_batch_dispatch", 5.5, 6.0)]
    out = harness.breakdown(trace, spans)
    assert out["device_ops"][0] == ["fq_mul_kernel", 1.0]
    assert out["idle_gaps"][0] == ["pipeline_build+device_batch_dispatch", 4.0]
    assert [g[0] for g in out["idle_gaps"][1:]] == ["no_host_span", "parse"]


def test_roofline_counts_a_hand_counted_batch():
    roof = harness.load_reader("bls_verify_roofline").__globals__
    # one set of one key: per set 63*7 + 15*16 + 15*43 + 4,432 = 5,758; per
    # batch 63*16 + 4,432 + 62*36 + 5,670 = 13,342
    assert roof["fq_products"](1, 1) == 5758 + 13342
    # 1,000 sets over 250,000 keys adds 249,000 key additions of 11
    assert roof["fq_products"](1000, 250_000) == 11 * 249_000 + 5758 * 1000 + 13342
    products = roof["fq_products"](1, 1)
    by_bytes = products * 144 / 3.35e12
    by_macs = products * 300 / (64 * 132 * 1980e6)
    assert by_bytes > by_macs
    assert roof["least_seconds"](products, 1980.0) == pytest.approx(by_bytes)
    assert roof["least_seconds"](products, 500.0) == pytest.approx(products * 300 / (64 * 132 * 500e6))


def test_warm_buckets_span_one_call_to_every_call_in_flight(traffic):
    got = harness.warm_buckets(traffic, (1, 2, 4, 8, 16), (1, 2, 4), 4096)
    assert got == [(2, 1), (4, 1), (8, 1)]
    assert harness.warm_buckets(traffic, (1, 2, 4, 8, 16), (1, 2, 4), 4) == [(2, 1), (4, 1)]


def test_run_exits_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "lhbench/run.py", "--workload", CELL["name"],
                           "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card):
    proc = subprocess.run([sys.executable, "lhbench/run.py", "--workload", CELL["name"],
                           "--seed", str(2**33 + 3), "--seconds", "5", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["kind"] == cuda_card
