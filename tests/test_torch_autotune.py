"""The port's self-tuning control plane (``autotune.py``) vs the JAX package's.

- The classes of the JAX package's ``tests/test_autotune.py``, each
  scenario run through both controllers on the same flight-record
  evidence and pins: the decision logs must be equal.  The one difference
  is the adoption gate: the JAX package requires a committed XLA lowering
  budget for a bucket (``refused_no_budget``); the port, which lowers
  nothing, requires the bucket's warmup dispatch to have run and given
  the expected result (``refused_warmup_failed`` otherwise, in a pinned
  replay too).  The JAX side's vocabularies carry a committed budget key,
  so its budget gate passes wherever the port's warmup gate is what is
  tested.
- The measured kernel choice: ``measure_walk_lookahead`` (the port's
  counterpart of the JAX package's measured Fq lowering), its cache key,
  the mode-``0`` bypass, a corrupt cache read as none, a failing or
  disagreeing probe raising.
- The admission cases (latency-driven bounds, Retry-After from the drain
  rate) on the port's ``AdmissionController``, and ``adaptive=None``
  following the live mode.
- The warmup leg (``ops/compile_cache.aot_warmup_op``): every enrolled
  op's neutral dispatch on the kernels' plain versions, the telemetry
  mirror it seeds, and a live adoption end to end.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import autotune as jat  # noqa: E402
from lighthouse_tpu import device_telemetry as jdt  # noqa: E402
from lighthouse_tpu.ops import tree_hash as jth  # noqa: E402
from lighthouse_tpu_torch import autotune as pat  # noqa: E402
from lighthouse_tpu_torch import device_supervisor, metrics  # noqa: E402
from lighthouse_tpu_torch import device_telemetry as pdt  # noqa: E402
from lighthouse_tpu_torch.ops import compile_cache, cuda_epoch  # noqa: E402
from lighthouse_tpu_torch.scheduler.admission import (  # noqa: E402
    CLASS_BULK,
    AdmissionController,
    ClassPolicy,
    ShedError,
)

#: a committed JAX baseline key: the JAX side's budget gate passes with it
BUDGETED_SHA_KEY = "sha256_pairs|-|640|-"

PAIRS = ((jat, jdt), (pat, pdt))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    for at, dt in PAIRS:
        at.reset_for_tests()
        dt.reset_for_tests()
    yield
    for at, dt in PAIRS:
        # synthetic vocabularies must not leak into the rest of the suite
        for name in [n for n in at._VOCABS if n.startswith("t_")]:
            at._VOCABS.pop(name, None)
        at.reset_for_tests()
        dt.reset_for_tests()
    compile_cache.reset_for_tests()


def _feed(dt, op: str, nb: int, n_live: int, count: int) -> None:
    for _ in range(count):
        dt.record_batch(op=op, shape=(nb,), n_live=n_live)


def _register(at, name, static, warmup=None, op=None):
    if at is jat:
        at.register_vocabulary(name, static, telemetry_ops=(op or name,),
                               budget_key=lambda nb: BUDGETED_SHA_KEY, warmup=warmup)
    else:
        at.register_vocabulary(name, static, telemetry_ops=(op or name,), warmup=warmup)
    return at._VOCABS[name]


def _log(at) -> list:
    """The decision log with the one reason that names each package's
    gate spelled alike."""
    out = []
    for d in at.CONTROLLER.decision_log():
        if d.get("reason") in ("pinned replay (budget gate held)",
                               "pinned replay (warmup gate held)"):
            d["reason"] = "pinned replay (gate held)"
        out.append(d)
    return out


def _ok(nb):
    return None


# ------------------------------------------------------------ vocabulary


class TestBucketVocabulary:
    def test_off_path_returns_static_untouched(self):
        static = (256, 1024)
        for at, _ in PAIRS:
            assert at.bucket_vocabulary("nothing", static) is static

    def test_overlay_merges_sorted_and_mode_zero_disables(self):
        for at, _ in PAIRS:
            _register(at, "t_vocab", (256, 1024))
            at.set_mode("live")
            at._set_overlay("t_vocab", (640,))
            assert at.bucket_vocabulary("t_vocab", (256, 1024)) == (256, 640, 1024)
            at.set_mode("0")
            assert at.bucket_vocabulary("t_vocab", (256, 1024)) == (256, 1024)

    def test_sha_bucket_function_consults_overlay(self):
        from lighthouse_tpu.ops import sha256_device as jsd
        from lighthouse_tpu_torch.ops import sha256_device as psd

        for at, sd in ((jat, jsd), (pat, psd)):
            assert sd._bucket(500) == 1024
            at.set_mode("live")
            at._set_overlay("sha256_pairs", (640,))
            assert sd._bucket(500) == 640 and sd._bucket(700) == 1024
            at.reset_for_tests()
            assert sd._bucket(500) == 1024

    def test_port_vocabularies_match_the_jax_packages(self):
        """Every vocabulary the JAX ops enrol, the port's enrol with the same
        static tuple and telemetry ops."""
        from lighthouse_tpu.ops import epoch_device, sha256_device, shuffle_device, verify  # noqa: F401
        from lighthouse_tpu_torch.ops import (  # noqa: F401
            epoch_device as ped,
            sha256_device as psd,
            shuffle_device as pshd,
            verify as pv,
        )

        names = ("bls_verify", "sha256_pairs", "epoch_deltas", "shuffle",
                 "proposer_select", "epoch_boundary")
        for name in names:
            j, p = jat._VOCABS[name], pat._VOCABS[name]
            assert (p.static, p.telemetry_ops) == (j.static, j.telemetry_ops)
            assert p.warmup is not None

    def test_epoch_and_shuffle_buckets_consult_overlay(self):
        from lighthouse_tpu_torch.ops import epoch_device as ped
        from lighthouse_tpu_torch.ops import shuffle_device as pshd

        pat.set_mode("live")
        for name in ("epoch_deltas", "shuffle", "proposer_select", "epoch_boundary"):
            pat._set_overlay(name, (640,))
        assert ped._bucket(600) == 640 and ped._bucket(700) == 1024
        for op in ("shuffle", "proposer_select", "epoch_boundary"):
            assert pshd._bucket(600, op) == 640
        pat.reset_for_tests()
        assert ped._bucket(600) == pshd._bucket(600) == 1024


# ------------------------------------------------------------- guardrails


class TestAdoptionGuardrails:
    def test_no_adoption_without_a_passing_warmup(self):
        """The port's counterpart of the JAX package's budget gate: a
        candidate whose warmup dispatch fails is refused in live AND
        pinned mode (the JAX package refuses a bucket with no committed
        budget at the same points: ``refused_no_budget``)."""
        def broken(nb):
            raise RuntimeError("neutral batch gave the wrong result")

        _register(pat, "t_nowarm", (256, 1024), warmup=broken)
        pat.set_mode("live")
        _feed(pdt, "t_nowarm", 1024, 300, 12)
        (d1,) = pat.CONTROLLER.evaluate()
        assert (d1["outcome"], d1["bucket"]) == ("warmup_started", 640)
        deadline = time.time() + 5
        while pat.CONTROLLER.warmup_state("t_nowarm", 640) == "pending":
            assert time.time() < deadline
            time.sleep(0.01)
        (d2,) = pat.CONTROLLER.evaluate()
        assert d2["outcome"] == "refused_warmup_failed"
        assert pat.overlay() == {}
        # pinned replay: the warmup runs inline and hits the same wall
        pat.reset_for_tests()
        pat.set_mode("pinned")
        pat.CONTROLLER.install_pin([{"after_evaluation": 1, "vocab": "t_nowarm",
                                     "action": "adopt", "bucket": 640}])
        (d,) = pat.CONTROLLER.evaluate()
        assert d["outcome"] == "refused_warmup_failed"
        assert pat.overlay() == {}
        # a vocabulary with no warmup hook can never adopt
        _register(pat, "t_nohook", (256, 1024))
        pat.CONTROLLER.install_pin([{"after_evaluation": 2, "vocab": "t_nohook",
                                     "action": "adopt", "bucket": 640}])
        (d,) = pat.CONTROLLER.evaluate()
        assert d["outcome"] == "refused_warmup_failed"
        # the JAX package's gate at the same points
        jat.register_vocabulary("t_nowarm", (256, 1024), telemetry_ops=("t_nowarm",),
                                budget_key=lambda nb: f"t_nowarm|-|{nb}|-",
                                warmup=_ok)
        jat.set_mode("pinned")
        jat.CONTROLLER.install_pin([{"after_evaluation": 1, "vocab": "t_nowarm",
                                     "action": "adopt", "bucket": 640}])
        assert jat.CONTROLLER.evaluate()[0]["outcome"] == "refused_no_budget"

    def test_no_adoption_before_warmup_completes(self):
        """Live adoption waits for the off-path warmup: evaluation 1 starts
        it, later evaluations defer while it runs, only a COMPLETED warmup
        adopts — in both packages, with the same decision log."""
        for at, dt in PAIRS:
            gate, started = threading.Event(), threading.Event()

            def slow_warmup(nb, gate=gate, started=started):
                started.set()
                assert gate.wait(10)

            _register(at, "t_warm", (256, 1024), warmup=slow_warmup)
            at.set_mode("live")
            _feed(dt, "t_warm", 1024, 300, 12)
            (d1,) = [d for d in at.CONTROLLER.evaluate() if d.get("vocab") == "t_warm"]
            assert d1["outcome"] == "warmup_started" and at.overlay() == {}
            assert started.wait(5)
            (d2,) = [d for d in at.CONTROLLER.evaluate() if d.get("vocab") == "t_warm"]
            assert d2["outcome"] == "warmup_pending" and at.overlay() == {}
            gate.set()
            deadline = time.time() + 5
            while time.time() < deadline:
                done = [d for d in at.CONTROLLER.evaluate() if d.get("vocab") == "t_warm"]
                if done and done[0]["outcome"] == "adopted":
                    break
                time.sleep(0.05)
            assert at.overlay().get("t_warm") == (640,)
        j_log, p_log = _log(jat), _log(pat)
        for d in j_log + p_log:
            d.pop("reason", None)  # each package names its own gate
            d.pop("evaluation")    # polling counts differ
        assert [d["outcome"] for d in p_log] == [d["outcome"] for d in j_log] == [
            "warmup_started", "warmup_pending", "adopted"]
        assert [d["trigger"] for d in p_log[:2]] == [d["trigger"] for d in j_log[:2]]

    def test_failed_warmup_refuses_forever(self):
        def broken_warmup(nb):
            raise RuntimeError("dispatch exploded")

        for at, dt in PAIRS:
            _register(at, "t_broken", (256, 1024), warmup=broken_warmup)
            at.set_mode("live")
            _feed(dt, "t_broken", 1024, 300, 12)
            at.CONTROLLER.evaluate()  # starts the warmup
            deadline, outcome = time.time() + 5, None
            while time.time() < deadline:
                got = [d for d in at.CONTROLLER.evaluate() if d.get("vocab") == "t_broken"]
                if got and got[0]["outcome"] == "refused_warmup_failed":
                    outcome = got[0]["outcome"]
                    break
                time.sleep(0.05)
            assert outcome == "refused_warmup_failed"
            assert at.overlay() == {}

    def test_meshed_adoption_refused(self, monkeypatch):
        from lighthouse_tpu import device_mesh as jdm
        from lighthouse_tpu_torch import device_mesh as pdm

        for dm in (jdm, pdm):
            monkeypatch.setattr(dm, "enabled", lambda: True)
            monkeypatch.setattr(dm, "size", lambda: 8)
        logs = []
        for at, _ in PAIRS:
            _register(at, "t_mesh", (256, 1024), warmup=_ok)
            at.set_mode("pinned")
            at.CONTROLLER.install_pin([{"after_evaluation": 1, "vocab": "t_mesh",
                                        "action": "adopt", "bucket": 640}])
            (d,) = at.CONTROLLER.evaluate()
            assert d["outcome"] == "refused_meshed" and at.overlay() == {}
            logs.append([{k: v for k, v in x.items() if k != "reason"} for x in _log(at)])
        assert logs[0] == logs[1]

    def test_above_static_top_refused(self):
        for at, _ in PAIRS:
            _register(at, "t_top", (256, 1024), warmup=_ok)
            at.set_mode("pinned")
            at.CONTROLLER.install_pin([{"after_evaluation": 1, "vocab": "t_top",
                                        "action": "adopt", "bucket": 2048}])
            (d,) = at.CONTROLLER.evaluate()
            assert d["outcome"] == "refused_above_top" and at.overlay() == {}
        assert _log(pat) == _log(jat)

    def test_densify_skips_ratio2_vocabularies(self):
        for at, dt in PAIRS:
            _register(at, "t_pow2", (256, 512, 1024), warmup=_ok)
            at.set_mode("live")
            _feed(dt, "t_pow2", 512, 100, 12)
            assert [d for d in at.CONTROLLER.evaluate() if d.get("vocab") == "t_pow2"] == []


# ---------------------------------------------------------- pinned replay


class TestPinnedReplay:
    PIN = [{"after_evaluation": 2, "vocab": "t_pin", "action": "adopt", "bucket": 640},
           {"after_evaluation": 4, "vocab": "t_pin", "action": "drop", "bucket": 640}]

    def test_pin_applies_at_exact_evaluation_indices(self):
        for at, _ in PAIRS:
            _register(at, "t_pin", (256, 1024), warmup=_ok)
            at.set_mode("pinned")
            at.CONTROLLER.install_pin(self.PIN)
            assert at.CONTROLLER.evaluate() == []          # eval 1
            (d2,) = at.CONTROLLER.evaluate()               # eval 2
            assert (d2["outcome"], d2["via"]) == ("adopted", "pin")
            assert at.overlay() == {"t_pin": (640,)}
            assert at.CONTROLLER.evaluate() == []          # eval 3
            (d4,) = at.CONTROLLER.evaluate()               # eval 4
            assert d4["outcome"] == "dropped" and at.overlay() == {}
            assert at.CONTROLLER.export_pin() == self.PIN
        assert _log(pat) == _log(jat)

    def test_pin_from_environment(self, tmp_path, monkeypatch):
        path = tmp_path / "pin.json"
        path.write_text(json.dumps(self.PIN))
        monkeypatch.setenv(pat.PIN_ENV, str(path))
        for at, _ in PAIRS:
            _register(at, "t_pin", (256, 1024), warmup=_ok)
            at.set_mode("pinned")
            outcomes = [[d["outcome"] for d in at.CONTROLLER.evaluate()] for _ in range(4)]
            assert outcomes == [[], ["adopted"], [], ["dropped"]]
        assert _log(pat) == _log(jat)

    def test_pinned_mode_with_no_pin_is_static(self):
        for at, _ in PAIRS:
            at.set_mode("pinned")
            for _ in range(5):
                assert at.CONTROLLER.evaluate() == []
            assert at.overlay() == {}

    def test_mode_zero_evaluates_nothing(self):
        for at, _ in PAIRS:
            at.set_mode("0")
            assert at.CONTROLLER.evaluate() == []
            assert at.CONTROLLER.evaluations == 0

    def test_unknown_mode_degrades_to_pinned(self, monkeypatch):
        monkeypatch.setenv(pat.ENV, "turbo")
        for at, _ in PAIRS:
            at.set_mode(None)
            assert at.mode() == "pinned" and not at.live()


# ------------------------------------------------------------- drop logic


class TestDropIdle:
    def test_idle_adopted_bucket_dropped_busy_op_only(self):
        for at, dt in PAIRS:
            _register(at, "t_idle", (256, 1024), warmup=_ok)
            at.set_mode("live")
            at._set_overlay("t_idle", (640,))
            assert [d for d in at.CONTROLLER.evaluate() if d.get("action") == "drop"] == []
            assert at.overlay() == {"t_idle": (640,)}
            _feed(dt, "t_idle", 256, 200, 12)
            drops = [d for d in at.CONTROLLER.evaluate() if d.get("action") == "drop"]
            assert drops and drops[0]["bucket"] == 640 and at.overlay() == {}
        assert _log(pat) == _log(jat)

    def test_live_bucket_with_traffic_survives(self):
        for at, dt in PAIRS:
            _register(at, "t_live", (256, 1024), warmup=_ok)
            at.set_mode("live")
            at._set_overlay("t_live", (640,))
            _feed(dt, "t_live", 640, 500, 12)
            assert [d for d in at.CONTROLLER.evaluate() if d.get("action") == "drop"] == []
            assert at.overlay() == {"t_live": (640,)}

    def test_sharded_records_count_at_their_bucket(self):
        """A sharded dispatch's shape label (``640@dp2``) counts at its
        bucket, in both packages."""
        for at, dt in PAIRS:
            _register(at, "t_mesh_rec", (256, 1024), warmup=_ok)
            at.set_mode("live")
            at._set_overlay("t_mesh_rec", (640,))
            for _ in range(12):
                dt.record_batch(op="t_mesh_rec", shape=(640,), n_live=500, mesh=2,
                                shard_live=[320, 180])
            assert at._bucket_live_stats(at._VOCABS["t_mesh_rec"]) == {640: [500] * 12}


# ------------------------------------------------- the measured walk choice


@pytest.fixture()
def walk_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune_walk_lookahead.json"
    monkeypatch.setattr(pat, "walk_cache_path", lambda: str(path))
    return path


def _fake_probe(times, calls):
    out = torch.arange(pat.PROBE_SLOTS * pat.PROBE_CANDIDATES,
                       dtype=torch.int32).reshape(pat.PROBE_SLOTS, -1)

    def probe(device, k, reps):
        calls.append(k)
        return times[k], out.clone()

    return probe


class TestMeasuredWalkLookahead:
    def test_cache_key_names_device_torch_and_cuda(self):
        assert pat.walk_cache_key("cpu") == (
            f"cpu|torch-{torch.__version__}|cuda-{torch.version.cuda}")

    def test_measure_caches_and_walk_lookahead_consults(self, walk_cache, monkeypatch):
        calls = []
        monkeypatch.setattr(pat, "_probe_walk",
                            _fake_probe({1: 0.04, 2: 0.01, 3: 0.02, 4: 0.03}, calls))
        pat.set_mode("live")
        decision = pat.measure_walk_lookahead(force=True, device="cpu")
        assert decision["lookahead"] == 2 and calls == list(cuda_epoch.WALK_LOOKAHEADS)
        on_disk = json.loads(walk_cache.read_text())
        assert on_disk[pat.walk_cache_key("cpu")]["lookahead"] == 2
        calls.clear()
        assert pat.measure_walk_lookahead(device="cpu")["lookahead"] == 2
        assert calls == []  # the cache answers
        assert cuda_epoch.measured_lookahead("cpu") == 2
        assert cuda_epoch.walk_lookahead("cpu") == 2
        snap = pat.snapshot()
        assert snap["walk_lookahead"]["lookahead"] == 2 and snap["fq_backend"] is None
        assert any(d["knob"] == "walk_lookahead" and d["outcome"] == "measured"
                   for d in snap["decisions"])
        assert metrics.DEVICE_BREAKER_STATE.get(op="autotune_probe") == 0

    def test_mode_zero_ignores_cache(self, walk_cache, monkeypatch):
        monkeypatch.setattr(pat, "_probe_walk",
                            _fake_probe({1: 0.01, 2: 0.02, 3: 0.03, 4: 0.04}, []))
        pat.set_mode("live")
        pat.measure_walk_lookahead(force=True, device="cpu")
        assert cuda_epoch.measured_lookahead("cpu") == 1
        pat.set_mode("0")
        assert pat.cached_walk_lookahead("cpu") is None
        assert cuda_epoch.measured_lookahead("cpu") is None

    def test_corrupt_cache_reads_as_none(self, walk_cache):
        pat.set_mode("pinned")
        walk_cache.write_text("{not json")
        assert pat.cached_walk_lookahead("cpu") is None
        walk_cache.write_text(json.dumps({pat.walk_cache_key("cpu"): {"lookahead": 7}}))
        assert pat.cached_walk_lookahead("cpu") is None  # not a lookahead the kernel has
        walk_cache.write_text(json.dumps(["a list"]))
        assert pat.cached_walk_lookahead("cpu") is None

    def test_failing_probe_raises(self, walk_cache, monkeypatch):
        def broken(device, k, reps):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(pat, "_probe_walk", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            pat.measure_walk_lookahead(force=True, device="cpu")
        assert not walk_cache.exists()
        assert device_supervisor.SUPERVISOR.breaker("autotune_probe").snapshot()[
            "consecutive_failures"] == 1
        device_supervisor.reset_for_tests()

    def test_disagreeing_lookaheads_raise(self, walk_cache, monkeypatch):
        def probe(device, k, reps):
            return 0.01, torch.full((2, 2), k, dtype=torch.int32)

        monkeypatch.setattr(pat, "_probe_walk", probe)
        with pytest.raises(RuntimeError, match="disagrees"):
            pat.measure_walk_lookahead(force=True, device="cpu")
        assert not walk_cache.exists()

    def test_real_probe_walk_on_the_plain_version(self, walk_cache, monkeypatch):
        """The probe's own walk, shrunk: every lookahead's positions (the
        plain version on the CPU) equal ``proposer_walk_plain``'s."""
        monkeypatch.setattr(pat, "PROBE_SLOTS", 2)
        monkeypatch.setattr(pat, "PROBE_CANDIDATES", 4)
        monkeypatch.setattr(pat, "PROBE_ROUNDS", 10)
        decision = pat.measure_walk_lookahead(force=True, device="cpu", reps=1)
        assert decision["lookahead"] in cuda_epoch.WALK_LOOKAHEADS
        assert decision["shape"] == [2, 4, 10]
        seed_words, pivots = pat._probe_inputs(torch.device("cpu"))
        _, out = pat._probe_walk(torch.device("cpu"), 3, 1)
        want = cuda_epoch.proposer_walk_plain(seed_words, pivots, 4, pat.PROBE_ACTIVE)
        assert torch.equal(out, want)

    def test_startup_hook_starts_nothing_unless_live(self, monkeypatch):
        monkeypatch.delenv(pat.ENV, raising=False)
        assert pat.maybe_start_from_env(device="cpu") is None
        pat.set_mode("live")
        monkeypatch.setenv(pat.INTERVAL_ENV, "3600")
        thread = pat.maybe_start_from_env(device="cpu")
        try:
            assert thread is not None and thread.is_alive()
            assert pat.maybe_start_from_env(device="cpu") is thread
        finally:
            pat.stop()
        thread.join(timeout=5)
        assert not thread.is_alive()


# --------------------------------------------------- admission: the bounds


def _bulk_controller(adaptive=True, max_inflight=128, deadline_s=2.0, retry_after_s=5):
    return AdmissionController(
        [ClassPolicy(CLASS_BULK, max_inflight=max_inflight, deadline_s=deadline_s,
                     retry_after_s=retry_after_s)],
        adaptive=adaptive)


class TestLatencyDrivenAdmission:
    def test_static_without_observations_or_adaptive(self):
        assert _bulk_controller(adaptive=True).effective_bounds(CLASS_BULK) == (128, 2.0)
        ctrl = _bulk_controller(adaptive=False)
        ctrl._ewma[CLASS_BULK] = 0.5
        assert ctrl.effective_bounds(CLASS_BULK) == (128, 2.0)

    def test_bounds_track_ewma_inside_the_band(self):
        ctrl = _bulk_controller(adaptive=True)
        ctrl._ewma[CLASS_BULK] = 0.2
        assert ctrl.effective_bounds(CLASS_BULK) == (16, 0.8)
        ctrl._ewma[CLASS_BULK] = 1.0
        assert ctrl.effective_bounds(CLASS_BULK) == (16, 2.0)
        ctrl._ewma[CLASS_BULK] = 0.001
        assert ctrl.effective_bounds(CLASS_BULK) == (128, 0.5)

    def test_ewma_converges_from_released_tickets(self):
        ctrl = _bulk_controller(adaptive=True)
        for _ in range(30):
            t = ctrl.try_admit(CLASS_BULK)
            t.check_deadline()
            t.started_pc -= 0.2
            t.release()
        assert 0.15 < ctrl.snapshot()["latency_ewma_s"][CLASS_BULK] < 0.25
        bound, deadline = ctrl.effective_bounds(CLASS_BULK)
        assert bound < 128 and deadline < 2.0

    def test_tightened_inflight_bound_sheds(self):
        ctrl = _bulk_controller(adaptive=True, max_inflight=16)
        ctrl._ewma[CLASS_BULK] = 0.2
        bound, _ = ctrl.effective_bounds(CLASS_BULK)
        tickets = [ctrl.try_admit(CLASS_BULK) for _ in range(bound)]
        with pytest.raises(ShedError) as e:
            ctrl.try_admit(CLASS_BULK)
        assert e.value.reason == "admission_full"
        for t in tickets:
            t.release()

    def test_deadline_shed_uses_effective_deadline(self):
        ctrl = _bulk_controller(adaptive=True, deadline_s=5.0)
        ctrl._ewma[CLASS_BULK] = 0.01
        t = ctrl.try_admit(CLASS_BULK)
        t.admitted_pc -= 2.0
        with pytest.raises(ShedError) as e:
            t.check_deadline()
        assert e.value.reason == "deadline"
        t.release()
        assert abs(ctrl._ewma[CLASS_BULK] - 0.01) < 1e-9

    def test_snapshot_reports_effective_bounds(self):
        ctrl = _bulk_controller(adaptive=True)
        ctrl._ewma[CLASS_BULK] = 0.2
        snap = ctrl.snapshot()
        assert snap["effective"][CLASS_BULK] == {"max_inflight": 16, "deadline_s": 0.8}
        assert snap["bounds"][CLASS_BULK] == 128

    def test_adaptive_none_follows_the_live_mode(self):
        ctrl = _bulk_controller(adaptive=None)
        ctrl._ewma[CLASS_BULK] = 0.2
        pat.set_mode("pinned")
        assert ctrl.effective_bounds(CLASS_BULK) == (128, 2.0)
        assert ctrl.snapshot()["adaptive"] is False
        pat.set_mode("live")
        assert ctrl.effective_bounds(CLASS_BULK) == (16, 0.8)
        assert ctrl.snapshot()["adaptive"] is True


class TestRetryAfterDrainRate:
    def test_falls_back_to_constant_below_sample_floor(self):
        ctrl = _bulk_controller(retry_after_s=7)
        assert ctrl.retry_after(CLASS_BULK) == 7
        now = time.perf_counter()
        ctrl._done[CLASS_BULK].extend(now + i for i in range(4))
        assert ctrl.retry_after(CLASS_BULK) == 7

    def test_derived_from_observed_drain_rate(self):
        ctrl = _bulk_controller(retry_after_s=7, adaptive=False)
        base = time.perf_counter()
        ctrl._done[CLASS_BULK].extend(base + i * 1.0 for i in range(16))
        tickets = [ctrl.try_admit(CLASS_BULK) for _ in range(4)]
        assert ctrl.retry_after(CLASS_BULK) == 2
        for t in tickets:
            t.release()

    def test_derived_value_rides_the_shed_response(self):
        ctrl = _bulk_controller(max_inflight=2, retry_after_s=7, adaptive=False)
        base = time.perf_counter()
        ctrl._done[CLASS_BULK].extend(base + i * 1.0 for i in range(16))
        t1, t2 = ctrl.try_admit(CLASS_BULK), ctrl.try_admit(CLASS_BULK)
        with pytest.raises(ShedError) as e:
            ctrl.try_admit(CLASS_BULK)
        assert e.value.retry_after_s == 1
        t1.release(), t2.release()

    def test_clamped_to_ceiling_when_drain_is_glacial(self):
        ctrl = _bulk_controller(retry_after_s=7)
        base = time.perf_counter()
        ctrl._done[CLASS_BULK].extend(base + i * 100.0 for i in range(16))
        tickets = [ctrl.try_admit(CLASS_BULK) for _ in range(8)]
        assert ctrl.retry_after(CLASS_BULK) == 30
        for t in tickets:
            t.release()


# ----------------------------------------------------------- the warmup leg


@pytest.mark.parametrize("op,nb,shape", [
    ("bls_verify", 2, "2x32"), ("sha256_pairs", 640, "640"), ("epoch_deltas", 96, "96"),
    ("shuffle", 96, "96"), ("proposer_select", 96, "96"), ("epoch_boundary", 96, "96"),
])
def test_warmup_dispatches_a_neutral_batch(op, nb, shape):
    """Each enrolled op's warmup: one supervised neutral dispatch at the
    bucket (here on the plain versions), its result checked, noted in the
    telemetry mirror as a warmup so the bucket's first production
    dispatch is not counted as its first."""
    before = metrics.DEVICE_AOT_WARMUP.get(op=op, shape=shape, outcome="miss")
    (rec,) = compile_cache.aot_warmup_op(op, nb, device="cpu")
    assert (rec["op"], rec["shape"], rec["outcome"], rec["device"]) == (op, shape, "ok", "cpu")
    assert metrics.DEVICE_AOT_WARMUP.get(op=op, shape=shape, outcome="miss") == before + 1
    dims = tuple(int(x) for x in shape.split("x"))
    assert pdt.COMPILE_CACHE.seen(op, dims)
    entry = next(e for e in pdt.COMPILE_CACHE.inventory() if e["op"] == op)
    assert entry["source"] == "warmup" and entry["invocations"] == 0
    assert pdt.note_dispatch(op, dims, 0.001) is False


def test_warmup_with_a_wrong_result_raises(monkeypatch):
    from lighthouse_tpu_torch.ops import sha256_device

    monkeypatch.setattr(sha256_device, "_sha256_64byte_batch",
                        lambda words: torch.zeros((words.shape[0], 8), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="wrong digest"):
        compile_cache.aot_warmup_op("sha256_pairs", 256, device="cpu")
    assert not pdt.COMPILE_CACHE.seen("sha256_pairs", (256,))
    with pytest.raises(ValueError):
        compile_cache.aot_warmup_op("tree_hash", 8, device="cpu")
    device_supervisor.reset_for_tests()


def test_live_adoption_end_to_end():
    """The unmocked loop on the CPU: flight-record evidence at the
    sha256_pairs 1024 bucket -> midpoint 640 -> a real warmup dispatch ->
    adoption -> a 500-block layer dispatches at 640, bytes equal to the
    JAX package's hashlib golden model."""
    from lighthouse_tpu_torch.ops import sha256_device

    compile_cache.configure(device="cpu")
    pat.set_mode("live")
    _feed(pdt, "sha256_pairs", 1024, 300, 12)
    deadline = time.time() + 60
    while 640 not in pat.overlay().get("sha256_pairs", ()):
        assert time.time() < deadline, pat.CONTROLLER.decision_log()
        pat.CONTROLLER.evaluate()
        time.sleep(0.05)
    outcomes = [d["outcome"] for d in pat.CONTROLLER.decision_log()
                if d.get("vocab") == "sha256_pairs"]
    assert outcomes[0] == "warmup_started" and outcomes[-1] == "adopted"
    assert pat.CONTROLLER.warmup_state("sha256_pairs", 640) == "done"
    assert sha256_device._bucket(500) == 640
    data = np.random.default_rng(5).integers(0, 256, 500 * 64, dtype=np.uint8).tobytes()
    assert sha256_device.hash_pairs_device(data, device="cpu") == jth.golden_hash_pairs(data)
    assert pdt.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]["shape"] == "640"
    entry = next(e for e in pdt.COMPILE_CACHE.inventory()
                 if e["op"] == "sha256_pairs" and e["shape"] == "640")
    assert entry["source"] == "warmup" and entry["invocations"] == 1
