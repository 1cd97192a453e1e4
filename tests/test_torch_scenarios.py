"""The port's scenario soak engine (``scenarios.py``, ``adversary.py``) vs
the JAX package's.

``lighthouse_tpu_torch.scenarios`` and ``.adversary`` copy the JAX
package's modules; the runner adds the device of its device events
(``device="cuda"`` by default, ``"cpu"`` here: the kernels' plain
versions).  The port's nodes run on its CPU routes (host tree hashing, the
numpy epoch backend, fake crypto); the JAX package's under its own fake
backend, as its tests run them.  Both packages pin one version string (the
default graffiti names it).  Every comparison is exact:

- ``smoke_partition``: the JAX scenario once and the port's twice at one
  seed; the port's two runs equal each other and the JAX run in the
  result (head root, head slot, finalized epochs, ``per_node``), the
  per-slot timeline, the fabric counters and schedule digest, and the
  merged fleet timeline.  The JAX package's tier-1 smoke assertions and
  its fleet-observability determinism case run on the port's runs;
- ``byz_double_vote_smoke``: the same, plus the adversary section
  (offenses, offenders, latencies, the EIP-3076 veto) and the slashing
  pipeline's evidence;
- a failed gate still writes its artifact and a postmortem bundle;
- a postmortem capture's process-wide ``capture_seq`` stays out of the
  merged fleet timeline (the JAX package keeps it, so two runs of a
  breaker scenario in one process differ there);
- ``fused_epoch_boundary`` on ``device="cpu"``: the breaker trips, the
  host answers, the gate passes, and the head root and per-slot timeline
  equal a run of the same scenario without its device and fault events
  on the card's default tree-hash routes (plain versions), which never
  reach the device at 16 validators; the routes in force before each run
  are in force after it;
- the card's rule on the CPU (no host fallback): ``fused_epoch_boundary``
  ends at its first boundary in the breaker its faults opened, as
  ``chip_smoke.py``'s ``[soak]`` expects on the card;
- no card: the runner and ``python -m lighthouse_tpu_torch.scenarios``
  refuse ``device="cuda"``;
- wall-clock purity: the JAX package's ``wallclock_pass`` finds no
  control-path wall-clock read in the port's soak modules;
- the slow matrix: every built-in scenario twice on ``device="cpu"``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from lighthouse_tpu import blackbox as jblackbox  # noqa: E402
from lighthouse_tpu import fault_injection as jfault_injection  # noqa: E402
from lighthouse_tpu import scenarios as jscenarios  # noqa: E402
from lighthouse_tpu.chain import graffiti_calculator as jgraffiti  # noqa: E402
from lighthouse_tpu_torch import blackbox, fault_injection  # noqa: E402
from lighthouse_tpu_torch.chain import graffiti_calculator  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.ops import sha256_device  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.scenarios import (  # noqa: E402
    SCENARIOS,
    Scenario,
    ScenarioFailure,
    ScenarioRunner,
    byz_double_vote_smoke,
    fused_epoch_boundary,
    run_scenario,
    smoke_partition,
)
from test_torch_chain import jax_backend, one_torch_thread, port_cpu  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(postmortems: str) -> None:
    """Both packages' fault registries and black boxes, cleared."""
    for fi, bb in ((fault_injection, blackbox), (jfault_injection, jblackbox)):
        fi.reset_for_tests()
        bb.reset_for_tests()
        bb.configure(directory=postmortems)


@pytest.fixture(autouse=True)
def _fake(tmp_path):
    set_backend("fake")
    _reset(str(tmp_path / "postmortems"))
    yield
    for fi, bb in ((fault_injection, blackbox), (jfault_injection, jblackbox)):
        fi.reset_for_tests()
        bb.reset_for_tests()


def _three_runs(factory, tmp):
    """The JAX package's scenario once and the port's twice, at seed 0 on
    one version string; each port run's scenario journal is kept (the
    black box is cleared between runs)."""
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    set_backend("fake")
    runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graffiti_calculator, "_CL_VERSION", jgraffiti._CL_VERSION)
            for label in ("port0", "port1", "jax"):
                out = tmp / label
                _reset(str(out / "postmortems"))
                if label == "jax":
                    with jax_backend("fake"):
                        artifact = jscenarios.run_scenario(
                            factory(seed=0), out_dir=str(out))
                    journal = None
                else:
                    artifact = run_scenario(factory(seed=0), out_dir=str(out),
                                            device="cpu")
                    journal = blackbox.JOURNAL.window(source="scenario")
                runs[label] = {"artifact": artifact, "journal": journal,
                               "out": out}
    finally:
        pe.reset_for_tests()
        th.reset_for_tests()
    return runs


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    return _three_runs(smoke_partition, tmp_path_factory.mktemp("smoke"))


@pytest.fixture(scope="module")
def byz_runs(tmp_path_factory):
    return _three_runs(byz_double_vote_smoke, tmp_path_factory.mktemp("byz"))


def _assert_same_run(runs) -> None:
    """The port's two runs equal each other and the JAX package's run."""
    arts = [runs[k]["artifact"] for k in ("port0", "port1", "jax")]
    for a in arts:
        assert a["passed"]
    for key in ("result", "timeline"):
        assert arts[0][key] == arts[1][key] == arts[2][key], key
    for key in ("counters", "schedule_digest"):
        assert arts[0]["net"][key] == arts[1]["net"][key] == arts[2]["net"][key], key
    fleets = [json.dumps(a["fleet"]["timeline"], sort_keys=True) for a in arts]
    assert fleets[0] == fleets[1], "the port's fleet timelines diverged"
    assert fleets[0] == fleets[2], "the fleet timeline differs from the JAX package's"


# ----------------------------------------------------------- smoke_partition


def test_smoke_partition_scenario(smoke_runs):
    """The smoke scenario (partition -> fork -> heal -> reorg -> finality
    resumes) passes and writes a complete SOAK artifact."""
    run = smoke_runs["port0"]
    artifact = run["artifact"]
    assert artifact["passed"]
    result = artifact["result"]
    assert result["converged"]
    heads = {n["head_root"] for n in result["per_node"] if n["alive"]}
    assert len(heads) == 1
    assert result["final_finalized_epoch"] > result["finalized_at_window_end"]
    assert artifact["extra"]["max_distinct_heads"] >= 2
    assert artifact["net"]["counters"]["dropped_partition"] > 0
    assert artifact["delay_metrics"]["block_imported"]["count"] > 0
    assert artifact["delay_metrics"]["block_imported"]["mean_s"] is not None
    path = os.path.join(str(run["out"]), "SOAK_smoke_partition_seed0.json")
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["scenario"]["name"] == "smoke_partition"
    assert on_disk["passed"]
    assert "schedule_digest" in on_disk["net"]
    assert "timeline" in on_disk
    # the black box journaled the run keyed on the fleet's virtual slot
    window = run["journal"]
    assert any(r["event"] == "run_start"
               and r.get("scenario") == "smoke_partition" for r in window)
    timeline_events = [r for r in window
                       if r.get("scenario") == "smoke_partition"
                       and r["event"] != "run_start"]
    assert timeline_events, "scenario timeline events never hit the journal"
    assert all(isinstance(r["slot"], int) for r in timeline_events)


def test_smoke_partition_matches_jax_and_is_deterministic(smoke_runs):
    _assert_same_run(smoke_runs)
    artifact = smoke_runs["port0"]["artifact"]
    fleet = artifact["fleet"]
    assert fleet["timeline"], "fleet timeline is empty"
    assert all(blackbox.VOLATILE_FIELDS.isdisjoint(r) for r in fleet["timeline"])
    cross = [t for t in fleet["trace_trees"]
             if t["proposal"]["node"] != t["import"]["node"]]
    assert cross, "no cross-node trace tree in the SOAK artifact"
    for tree in cross:
        assert tree["import"]["remote_trace_id"] == tree["proposal"]["trace_id"]
    path = smoke_runs["port0"]["out"] / "SOAK_smoke_partition_seed0.json"
    with open(path) as f:
        assert json.load(f)["fleet"]["timeline"] == fleet["timeline"]


# ----------------------------------------------------- byz_double_vote_smoke


def test_byzantine_smoke_slashing_pipeline(byz_runs):
    """One double-voting validator: offense -> slasher detection ->
    gossiped slashing -> op-pool pack -> inclusion -> ``slashed`` -> zero
    fork-choice weight, while the honest majority's gates pass."""
    artifact = byz_runs["port0"]["artifact"]
    assert artifact["passed"]
    result = artifact["result"]
    assert result["final_finalized_epoch"] > result["finalized_at_window_end"]
    adv = artifact["adversary"]
    assert adv["offenses_emitted"] == 1
    assert adv["offenses_detected"] == 1
    assert adv["offenses_included"] == 1
    assert adv["veto_asserted"] == 1, "EIP-3076 veto was not asserted"
    (offense,) = adv["offenses"]
    assert offense["strategy"] == "double_vote"
    assert offense["detection_latency_slots"] <= 8
    assert offense["inclusion_latency_slots"] <= 8
    (conviction,) = artifact["extra"]["slashing_pipeline"]
    assert conviction["slashing_kind"] == "attester"
    assert conviction["validator"] == offense["validator"]
    path = byz_runs["port0"]["out"] / "SOAK_byz_double_vote_smoke_seed0.json"
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["adversary"]["offenders"] == [offense["validator"]]


def test_byz_double_vote_matches_jax_and_is_deterministic(byz_runs):
    _assert_same_run(byz_runs)
    arts = [byz_runs[k]["artifact"] for k in ("port0", "port1", "jax")]
    assert arts[0]["adversary"] == arts[1]["adversary"] == arts[2]["adversary"]
    pipelines = [a["extra"]["slashing_pipeline"] for a in arts]
    assert pipelines[0] == pipelines[1] == pipelines[2]
    # the offense on the byzantine node precedes the inclusion on another
    # node in the merged fleet timeline
    timeline = arts[0]["fleet"]["timeline"]
    offense = next(i for i, r in enumerate(timeline) if r["event"] == "offense")
    included = next(i for i, r in enumerate(timeline)
                    if r["event"] == "slashing_included")
    assert offense < included
    assert timeline[offense]["node"] != timeline[included]["node"]


# ------------------------------------------------------------------ the rest


def test_failed_gate_still_writes_artifact(tmp_path):
    """A scenario whose gates fail still leaves its evidence on disk, with
    a postmortem bundle named in it."""
    doomed = Scenario(name="doomed", seed=0, node_count=3,
                      validator_count=16, warmup_slots=2, fault_slots=1,
                      recovery_slots=1)
    with pytest.raises(ScenarioFailure):
        ScenarioRunner(doomed, out_dir=str(tmp_path), device="cpu").run()
    with open(os.path.join(str(tmp_path), "SOAK_doomed_seed0.json")) as f:
        artifact = json.load(f)
    assert not artifact["passed"]
    assert "failure" in artifact
    bundle_path = artifact.get("postmortem_bundle")
    assert bundle_path and os.path.exists(bundle_path)
    with open(bundle_path) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "scenario_gate:doomed"
    assert bundle["extra"]["failure"] == artifact["failure"]
    assert any(r["source"] == "scenario" and r["event"] == "run_start"
               and r.get("scenario") == "doomed"
               for r in bundle["journal"])


def _routes():
    return (pe._EPOCH_BACKEND, pe._FUSED_BOUNDARY, pe._DEVICE, th._ENABLED,
            th._DEVICE, th._DEVICE_MIN_SUBTREES, th._DEVICE_MIN_BLOCKS)


def test_fused_epoch_boundary_on_cpu_matches_the_host_route(tmp_path):
    """The fused boundary on the plain versions: the injected fault trips
    the breaker, the host golden model answers, the breaker recovers (the
    scenario's own gate), and the chain is the one a run without the
    device and fault events builds on the numpy route, with the card's
    default tree-hash thresholds keeping every layer on the host."""
    before = _routes()
    artifact = run_scenario(fused_epoch_boundary(seed=0),
                            out_dir=str(tmp_path / "fused"), device="cpu")
    assert artifact["passed"]
    extra = artifact["extra"]
    assert extra["breaker"]["trips_total"] >= 1
    assert extra["breaker"]["state"] == "closed"
    assert extra["device_boundary_dispatches"] >= 1
    assert extra["postmortem"]["fault_before_trip"]
    assert _routes() == before, "the run left the epoch routes changed"

    th.configure(enabled=True, device="cpu")
    sha256_device.reset_routes()
    plain = dataclasses.replace(fused_epoch_boundary(seed=0), events=(),
                                extra_checks=None)
    reference = run_scenario(plain, out_dir=str(tmp_path / "host"), device="cpu")
    routes = dict(sha256_device.ROUTE_BLOCKS)
    assert reference["passed"]
    assert reference["result"]["head_root"] == artifact["result"]["head_root"]
    assert reference["timeline"] == artifact["timeline"]
    # at 16 validators no layer reaches DEVICE_MIN_SUBTREES / _MIN_BLOCKS
    assert routes and set(routes) <= {"host_below", "host_above", "host_off"}, routes


def test_fused_epoch_boundary_ends_in_its_fault_without_host_fallback(tmp_path,
                                                                     monkeypatch):
    """The card's rule on the CPU (the supervisor never hands failed work to
    the host): ``chip_smoke.soak_fault``, ``[soak]``'s fault run, ends at
    the window's first boundary with the breaker its faults opened, the
    numpy composite never answering, its artifact naming the failure and a
    postmortem bundle, the routes as they were."""
    import chip_smoke
    from lighthouse_tpu_torch import device_supervisor

    real_run = device_supervisor.SUPERVISOR.run

    def card_rule(*args, **kw):
        kw["host_on_failure"] = False
        return real_run(*args, **kw)

    monkeypatch.setattr(device_supervisor.SUPERVISOR, "run", card_rule)
    out = chip_smoke.soak_fault(str(tmp_path), device="cpu")
    assert out["raised"].startswith("RequeueWork")
    assert out["hits"] == 2
    assert out["breaker"] == {"state": "open", "trips_total": 1}


def test_device_cuda_refused_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError):
        ScenarioRunner(smoke_partition(seed=0), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        run_scenario("smoke_partition", out_dir=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "lighthouse_tpu_torch.scenarios",
         "--scenario", "smoke_partition", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stdout
    assert not list(tmp_path.iterdir()), "a refused run wrote an artifact"


def test_capture_seq_stays_out_of_the_fleet_timeline(tmp_path):
    """A postmortem capture's process-wide ``capture_seq`` is dropped from
    the merged fleet timeline, so a breaker scenario's timeline is the same
    in a second run in one process.  The JAX package keeps it, and its own
    matrix fails ``device_breaker_mid_sync`` on it."""
    from lighthouse_tpu import telemetry_scope as jtelemetry_scope
    from lighthouse_tpu_torch import telemetry_scope

    def captures(bb, ts):
        bb.reset_for_tests()
        bb.configure(directory=str(tmp_path / "postmortems"))
        scope = ts.register(ts.TelemetryScope("sim0"))
        with ts.activate(scope):
            bb.capture("breaker_open:sha256_pairs")
        return [r for r in bb.fleet_summary()["timeline"] if r["event"] == "capture"]

    port = [captures(blackbox, telemetry_scope) for _ in range(2)]
    ref = [captures(jblackbox, jtelemetry_scope) for _ in range(2)]
    assert len(port[0]) == 1 and "capture_seq" not in port[0][0]
    assert port[0] == port[1]
    assert ref[0] != ref[1]
    assert [{k: v for k, v in r.items() if k != "capture_seq"} for r in ref[1]] == port[1]


def test_soak_modules_read_no_wall_clock(monkeypatch):
    """The JAX package's wall-clock purity pass on the port's soak modules:
    no control-path wall-clock read outside ``WallClock`` and
    ``telemetry_stamp``."""
    from scripts.analysis import wallclock_pass

    monkeypatch.setattr(wallclock_pass, "SANCTIONED_CONTEXTS", {
        "lighthouse_tpu_torch/virtual_clock.py": ("WallClock", "telemetry_stamp"),
    })
    files = tuple(f"lighthouse_tpu_torch/{f}" for f in (
        "scenarios.py", "simulator.py", "adversary.py", "fault_injection.py",
        "network/peer_manager.py", "virtual_clock.py"))
    for f in files:
        assert os.path.exists(os.path.join(REPO, f)), f
    assert wallclock_pass.run(REPO, scan_dirs=files) == []


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matrix_deterministic(name, tmp_path):
    """Every built-in scenario twice with one seed on the plain versions:
    both runs pass their gates, with identical final head roots,
    finalized epochs and merged fleet timelines."""
    results, timelines = [], []
    for run_index in range(2):
        _reset(str(tmp_path / f"postmortems{run_index}"))
        artifact = run_scenario(name, seed=7, out_dir=str(tmp_path / f"run{run_index}"),
                                device="cpu")
        assert artifact["passed"], f"{name} run {run_index} failed its gates"
        results.append(artifact["result"])
        timelines.append(json.dumps(
            artifact.get("fleet", {}).get("timeline", []), sort_keys=True))
    assert results[0]["head_root"] == results[1]["head_root"]
    assert results[0]["final_finalized_epoch"] == results[1]["final_finalized_epoch"]
    assert timelines[0] == timelines[1]
