"""The port's epoch-boundary device programs vs the JAX package's.

``ops/epoch_device.py`` (the deltas program) and ``ops/shuffle_device.py``
(the shuffle, the proposer walk and the fused boundary) are PyTorch
programs; the shuffle rounds and the proposer walk are the CUDA kernels of
``csrc/shuffle.cu`` (``ops/cuda_epoch.py``), which run their plain
PyTorch versions on a CPU tensor.  Every comparison here is exact (integer
arrays, tolerance zero):

- each of the four programs with ``device="cpu"`` against the JAX
  package's XLA program called directly under ``jax.enable_x64(True)``
  (its entry wrappers import ``jax.experimental.enable_x64``, which the
  installed jax lacks), and against the numpy goldens
  ``per_epoch._epoch_deltas_numpy`` / ``_epoch_boundary_numpy``, at the
  bucket edges 63, 64, 65, 255, 256 and 257, in both leak modes;
- the shuffle invariant ``out[i] == values[compute_shuffled_index(i)]``
  and the proposer walk against the scalar spec walk, including slots
  where no candidate is accepted;
- the fused boundary through ``per_slot.process_slots`` on a Deneb chain
  against the staged numpy transition and the JAX package's bytes;
- the job pipeline, the epoch ops' supervisor policy, and the card's
  failure rule (a fault raises, no numpy answer);
- the CUDA source itself, compiled by g++ with the CUDA keywords defined
  away (``test_torch_hash.py``'s prelude), against the plain versions.

``test_kernels_on_card`` (marker ``cuda``) runs the kernels themselves and
skips without a card.
"""

import hashlib
import re
import shutil
import subprocess
import threading
import types as pytypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lighthouse_tpu import device_supervisor as j_ds  # noqa: E402
from lighthouse_tpu.consensus import per_epoch as jpe  # noqa: E402
from lighthouse_tpu.consensus.per_slot import process_slots as j_process_slots  # noqa: E402
from lighthouse_tpu.ops import epoch_device as jed  # noqa: E402
from lighthouse_tpu.ops import shuffle_device as jsd  # noqa: E402
from lighthouse_tpu_torch import (  # noqa: E402
    device_pipeline,
    device_supervisor as ds,
    device_telemetry,
    fault_injection as fi,
    metrics,
)
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.consensus import per_slot  # noqa: E402
from lighthouse_tpu_torch.consensus.shuffling import compute_shuffled_index, shuffle_list  # noqa: E402
from lighthouse_tpu_torch.device_pipeline import JobPipeline, PipelineShutdown  # noqa: E402
from lighthouse_tpu_torch.ops import cuda_epoch, devices  # noqa: E402
from lighthouse_tpu_torch.ops import epoch_device as ped  # noqa: E402
from lighthouse_tpu_torch.ops import shuffle_device as psd  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from test_torch_consensus import boundary_pair, chain_state  # noqa: E402
from test_torch_hash import _HOST_PRELUDE, host_compile  # noqa: E402

ROUNDS = 10  # the minimal preset's shuffle_round_count
SLOTS = 8    # the minimal preset's slots_per_epoch
GWEI = 10 ** 9
FAR = 2 ** 63 - 1
SEED = hashlib.sha256(b"port-epoch-programs").digest()
EDGES = [63, 64, 65, 255, 256, 257]
LEAK = pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    """The host tree-hash engine and the epoch programs on the CPU (the
    kernels' plain versions); the defaults (the card) come back after."""
    fi.clear()
    device_pipeline.reset_for_tests()
    th.configure(enabled=False)
    pe.configure(backend="device", fused_boundary=True, device="cpu")
    yield
    fi.clear()
    device_pipeline.reset_for_tests()
    ds.reset_for_tests()
    pe.reset_for_tests()
    th.reset_for_tests()


# ------------------------------------------------------------------ inputs


def synth_plan(n, seed=3, plan_cls=psd.BoundaryPlan):
    """A BoundaryPlan of ``n`` validators in which every section of the
    boundary has work: flags, slashings, ejections, the activation queue,
    pending activations, exits, hysteresis in both directions, and an
    active set that drops some validators."""
    rng = np.random.default_rng(seed)
    eff = rng.integers(16, 33, n).astype(np.int64) * GWEI
    activation = np.zeros(n, dtype=np.int64)
    exit_epoch = np.full(n, FAR, dtype=np.int64)
    withdrawable = np.full(n, FAR, dtype=np.int64)
    elig = np.zeros(n, dtype=np.int64)
    roles = rng.integers(0, 10, n)
    queued, pending, exiting, slashed = (roles == 1), (roles == 2), (roles == 3), (roles == 4)
    elig[queued] = FAR
    activation[queued | pending] = FAR
    eff[queued] = 32 * GWEI
    exit_epoch[exiting] = 5
    withdrawable[exiting | slashed] = 7
    exit_epoch[slashed] = 6
    active_next = (activation <= 6) & (6 < exit_epoch)
    total = int(eff[(activation <= 5) & (5 < exit_epoch)].sum())
    return plan_cls(
        effective_balance=eff,
        activation_epoch=activation,
        exit_epoch=exit_epoch,
        withdrawable_epoch=withdrawable,
        slashed=slashed,
        prev_part=rng.integers(0, 8, n).astype(np.int64),
        inactivity=rng.integers(0, 40, n).astype(np.int64),
        balance=eff + rng.integers(-2 * GWEI, 2 * GWEI, n),
        activation_eligibility_epoch=elig,
        eb_cap=np.full(n, 32 * GWEI, dtype=np.int64),
        active_idx=np.nonzero(active_next)[0].astype(np.int64),
        attester_seed=hashlib.sha256(b"att-%d" % seed).digest(),
        slot_seeds=tuple(hashlib.sha256(b"slot-%d-%d" % (seed, s)).digest()
                         for s in range(SLOTS)),
        rounds=ROUNDS,
        previous_epoch=4,
        base_reward_per_increment=512,
        total_active_balance=max(total, GWEI),
        increment=GWEI,
        inactivity_score_bias=4,
        inactivity_score_recovery_rate=16,
        quotient=2 ** 24,
        current_epoch=5,
        downward=GWEI // 4,
        upward=(GWEI // 4) * 5,
        ejection_balance=16 * GWEI,
        far_future=FAR,
        finalized_epoch=3,
        max_effective_balance=32 * GWEI,
        queue_lo=32 * GWEI,
        queue_hi=32 * GWEI,
    )


def plans(n):
    """The same synthetic plan for the port and for the JAX package."""
    return synth_plan(n), synth_plan(n, plan_cls=jsd.BoundaryPlan)


def spec_of(plan):
    return pytypes.SimpleNamespace(
        effective_balance_increment=plan.increment,
        inactivity_score_bias=plan.inactivity_score_bias,
        inactivity_score_recovery_rate=plan.inactivity_score_recovery_rate)


def arrays_of(plan):
    arrays = pe.EpochArrays.__new__(pe.EpochArrays)
    arrays.n = plan.n
    for name in ("effective_balance", "activation_epoch", "exit_epoch",
                 "withdrawable_epoch", "slashed"):
        setattr(arrays, name, getattr(plan, name))
    return arrays


def deltas_kwargs(plan, leak):
    return dict(previous_epoch=plan.previous_epoch, in_leak=leak,
                base_reward_per_increment=plan.base_reward_per_increment,
                total_active_balance=plan.total_active_balance,
                quotient=plan.quotient, spec=spec_of(plan))


def to_jax(t):
    """A port tensor as the JAX program's operand (SHA words as uint32)."""
    a = t.numpy()
    if t.dtype == torch.int32 and t.dim() == 2 and t.shape[1] == 8:
        a = a.view(np.uint32)
    return jnp.asarray(a)


def scalar_walk(slot_seeds, active_idx, eff, rounds, max_eb):
    """The spec's compute_proposer_index walk, scalar Python, over at most
    PROPOSER_CANDIDATES candidates."""
    m = len(active_idx)
    proposer = np.full(len(slot_seeds), -1, dtype=np.int64)
    found = np.zeros(len(slot_seeds), dtype=bool)
    for si, seed in enumerate(slot_seeds):
        for i in range(psd.PROPOSER_CANDIDATES):
            cand = int(active_idx[compute_shuffled_index(i % m, m, seed, rounds)])
            rb = hashlib.sha256(seed + (i // 32).to_bytes(8, "little")).digest()[i % 32]
            if int(eff[cand]) * 255 >= max_eb * rb:
                proposer[si], found[si] = cand, True
                break
    return proposer, found


def test_constants_match_jax():
    assert ped.N_BUCKETS == jed.N_BUCKETS == psd.N_BUCKETS == jsd.N_BUCKETS
    assert ped._PAD_FILLS == jed._PAD_FILLS
    assert psd._PAD_FILLS == jsd._PAD_FILLS
    assert ped._PAD_ACTIVATION_EPOCH == jed._PAD_ACTIVATION_EPOCH
    assert psd.PROPOSER_CANDIDATES == jsd.PROPOSER_CANDIDATES
    for n in (1, 64, 65, 2 ** 20, 2 ** 20 + 1):
        assert ped._bucket(n) == psd._bucket(n) == jsd._bucket("shuffle", n)


# --------------------------------------------- the programs vs the JAX programs


@LEAK
@pytest.mark.parametrize("n", EDGES)
def test_deltas_program_matches_jax_and_numpy(n, leak):
    plan, j_plan = plans(n)
    kwargs = deltas_kwargs(plan, leak)
    ours = ped.epoch_deltas_device(arrays_of(plan), plan.prev_part, plan.inactivity,
                                   device="cpu", **kwargs)
    golden = pe._epoch_deltas_numpy(arrays_of(plan), plan.prev_part, plan.inactivity, **kwargs)
    j_golden = jpe._epoch_deltas_numpy(arrays_of(j_plan), j_plan.prev_part,
                                       j_plan.inactivity, **kwargs)
    nb = ped._bucket(n)
    batched = [ped.grow_rows(np.asarray(a), nb, f) for a, f in zip(
        (plan.effective_balance, plan.activation_epoch, plan.exit_epoch,
         plan.withdrawable_epoch, plan.slashed, plan.prev_part, plan.inactivity),
        ped._PAD_FILLS)]
    scalars = (plan.previous_epoch, plan.base_reward_per_increment, plan.total_active_balance,
               plan.increment, plan.inactivity_score_bias,
               plan.inactivity_score_recovery_rate, plan.quotient)
    with jax.enable_x64(True):
        theirs = jax.device_get(jed._deltas_kernel(
            *(jnp.asarray(a) for a in batched), *(jnp.int64(s) for s in scalars),
            in_leak=leak))
    for o, g, jg, t in zip(ours, golden, j_golden, theirs):
        assert o.dtype == np.int64
        assert np.array_equal(o, g)
        assert np.array_equal(o, jg)
        assert np.array_equal(o, np.asarray(t)[:n])


@LEAK
@pytest.mark.parametrize("n", EDGES)
def test_boundary_program_matches_jax_and_numpy(n, leak):
    plan, j_plan = plans(n)
    ours = psd.epoch_boundary_device(plan, in_leak=leak, device="cpu")
    golden = pe._epoch_boundary_numpy(plan, in_leak=leak)
    j_golden = jpe._epoch_boundary_numpy(j_plan, in_leak=leak)
    args, nb = psd.boundary_inputs(plan, torch.device("cpu"))
    assert nb == ped._bucket(n)
    with jax.enable_x64(True):
        theirs = jax.device_get(jsd._boundary_kernel(
            *(to_jax(a) for a in args[:16]), *(jnp.int64(s) for s in args[16:32]),
            jnp.int32(args[32]), in_leak=leak))
    theirs = [np.asarray(t) for t in theirs]
    theirs = [t[:n] for t in theirs[:6]] + [theirs[6][:plan.m], theirs[7], theirs[8]]
    assert ours[8].any()  # proposers found on the device path
    for i, (o, g, jg, t) in enumerate(zip(ours, golden, j_golden, theirs)):
        assert np.array_equal(o, g), i
        assert np.array_equal(o, jg), i
        assert np.array_equal(o, t.astype(o.dtype)), i


@pytest.mark.parametrize("n", EDGES)
def test_shuffle_program_matches_jax(n):
    nb = psd._bucket(n)
    values = np.zeros(nb, dtype=np.int32)
    values[:n] = np.random.default_rng(n).permutation(n)
    pivots, digests = psd.shuffle_tables(SEED, ROUNDS, n, nb)
    ours = psd._shuffle_kernel(torch.from_numpy(values), torch.from_numpy(pivots),
                               torch.from_numpy(digests), n).numpy()
    theirs = np.asarray(jsd._shuffle_kernel(jnp.asarray(values), jnp.asarray(pivots),
                                            jnp.asarray(digests), jnp.int32(n)))
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours[:n], shuffle_list(values[:n], SEED, ROUNDS))
    assert np.array_equal(ours[n:], values[n:])  # pad lanes never swap


@pytest.mark.parametrize("m", EDGES)
def test_proposer_program_matches_jax_and_scalar_walk(m):
    rng = np.random.default_rng(m)
    n = m + 13
    active = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
    eff = rng.integers(1, 33, n).astype(np.int64) * GWEI
    seeds = tuple(hashlib.sha256(b"slot-%d-%d" % (m, s)).digest() for s in range(SLOTS))
    nb = psd._bucket(m)
    seed_words, pivots, rbytes = psd.proposer_tables(seeds, ROUNDS, m)
    eff_act = np.zeros(nb, dtype=np.int64)
    eff_act[:m] = eff[active]
    pos, found = psd._proposer_kernel(
        torch.from_numpy(seed_words.view(np.int32)), torch.from_numpy(pivots),
        torch.from_numpy(rbytes), torch.from_numpy(eff_act), m, 32 * GWEI)
    with jax.enable_x64(True):
        j_pos, j_found = jax.device_get(jsd._proposer_kernel(
            jnp.asarray(seed_words), jnp.asarray(pivots), jnp.asarray(rbytes),
            jnp.asarray(eff_act), jnp.int32(m), jnp.int64(32 * GWEI)))
    assert np.array_equal(pos.numpy(), np.asarray(j_pos))
    assert np.array_equal(found.numpy(), np.asarray(j_found))
    proposer, dev_found = psd.proposer_select_device(
        seeds, active, eff, rounds=ROUNDS, max_effective_balance=32 * GWEI, device="cpu")
    walk, walk_found = scalar_walk(seeds, active, eff, ROUNDS, 32 * GWEI)
    assert np.array_equal(dev_found, walk_found)
    assert np.array_equal(proposer, walk)


def test_proposer_walk_reports_not_found_like_the_scalar_walk():
    """Zero effective balances accept a candidate only on a zero random
    byte, so most slots exhaust their candidates: the device reports them
    found=False with proposer -1, exactly where the scalar walk does."""
    m = 100
    active = np.arange(m, dtype=np.int64)
    eff = np.zeros(m, dtype=np.int64)
    seeds = tuple(hashlib.sha256(b"none-%d" % s).digest() for s in range(SLOTS))
    proposer, found = psd.proposer_select_device(
        seeds, active, eff, rounds=ROUNDS, max_effective_balance=32 * GWEI, device="cpu")
    walk, walk_found = scalar_walk(seeds, active, eff, ROUNDS, 32 * GWEI)
    assert not found.all()
    assert np.array_equal(found, walk_found)
    assert np.array_equal(proposer, walk)
    assert (proposer[~found] == -1).all()


@pytest.mark.parametrize("n", [0, 1, 2, 63, 64, 65, 255, 256, 257, 1023, 1024, 1025])
def test_shuffle_invariant_at_bucket_boundaries(n):
    values = np.random.default_rng(n).permutation(n).astype(np.int64)
    out = psd.shuffle_device(values, SEED, ROUNDS, device="cpu")
    assert out.shape == (n,) and out.dtype == values.dtype
    assert np.array_equal(out, shuffle_list(values, SEED, ROUNDS))
    for i in range(n):
        assert out[i] == values[compute_shuffled_index(i, n, SEED, ROUNDS)]


def test_cpu_programs_launch_no_kernel():
    cuda_epoch.reset_launch_counts()
    psd.epoch_boundary_device(synth_plan(64), in_leak=False, device="cpu")
    assert cuda_epoch.LAUNCHES == {"shuffle_round": 0, "proposer_walk": 0}


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    plan = synth_plan(64)
    with pytest.raises(RuntimeError, match="is_available"):
        psd.epoch_boundary_device(plan, in_leak=False)
    with pytest.raises(RuntimeError, match="is_available"):
        psd.shuffle_device(np.arange(10), SEED, ROUNDS)
    with pytest.raises(RuntimeError, match="is_available"):
        psd.proposer_select_device(plan.slot_seeds, plan.active_idx, plan.effective_balance,
                                   rounds=ROUNDS, max_effective_balance=32 * GWEI)
    with pytest.raises(RuntimeError, match="is_available"):
        ped.epoch_deltas_device(arrays_of(plan), plan.prev_part, plan.inactivity,
                                **deltas_kwargs(plan, False))


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_reject_bad_operands(bad):
    values = torch.zeros(64, dtype=torch.int32)
    pivots = torch.zeros(ROUNDS, dtype=torch.int32)
    digests = torch.zeros(ROUNDS, 32, dtype=torch.uint8)
    seeds = torch.zeros(2, 8, dtype=torch.int32)
    walk_pivots = torch.zeros(2, ROUNDS, dtype=torch.int32)
    if bad == "dtype":
        values, seeds = values.long(), seeds.long()
    elif bad == "shape":
        digests, seeds = digests[:, :4], seeds[:, :7]
    else:
        values, seeds = values.to("meta"), seeds.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cuda_epoch.shuffle_rounds(values, pivots, digests, 64)
    with pytest.raises((TypeError, ValueError)):
        cuda_epoch.proposer_walk(seeds, walk_pivots, 64, 10)


# ------------------------------------------- the boundary through process_slots


@pytest.fixture(scope="module")
def deneb_chain():
    return {"deneb": chain_state("deneb")}


@LEAK
def test_fused_boundary_through_process_slots(deneb_chain, leak):
    """A Deneb state crossing a boundary with the fused boundary on the CPU
    equals the staged numpy transition in balances, inactivity, every
    registry epoch field, every proposer and every committee, and the JAX
    package's bytes; the flight record shows the device program ran."""
    ref, port, target, j_spec, p_spec, p_types = boundary_pair(deneb_chain, "deneb", leak)
    numpy_state = p_types.state["deneb"].from_ssz_bytes(port.as_ssz_bytes())
    mark = device_telemetry.FLIGHT_RECORDER.recorded_total
    fused = per_slot.process_slots(port, target, p_types, p_spec)
    op = "epoch_boundary_leak" if leak else "epoch_boundary"
    records = [r for r in device_telemetry.FLIGHT_RECORDER.recent(limit=64)
               if r["seq"] > mark]
    assert [r["op"] for r in records] == [op]
    assert not records[0]["host_fallback"]
    pe.configure(backend="numpy")
    staged = per_slot.process_slots(numpy_state, target, p_types, p_spec)
    assert list(fused.balances) == list(staged.balances)
    assert list(fused.inactivity_scores) == list(staged.inactivity_scores)
    for vf, vs in zip(fused.validators, staged.validators):
        for name in ("effective_balance", "activation_eligibility_epoch", "activation_epoch",
                     "exit_epoch", "withdrawable_epoch"):
            assert getattr(vf, name) == getattr(vs, name)
    assert fused.as_ssz_bytes() == staged.as_ssz_bytes()
    assert fused.as_ssz_bytes() == j_process_slots(ref, target, deneb_chain["deneb"][1],
                                                   j_spec).as_ssz_bytes()
    # The fused dispatch primed the next epoch's duty caches; the staged
    # state computes them through the lazy scalar walk.
    assert h._caches(fused)["committees"]
    spe = p_spec.slots_per_epoch
    for slot in range(target, target + spe):
        assert h.get_beacon_proposer_index(fused, p_spec, slot) == \
            h.get_beacon_proposer_index(staged, p_spec, slot)
        for index in range(h.get_committee_count_per_slot(fused, target // spe, p_spec)):
            assert np.array_equal(h.get_beacon_committee(fused, slot, index, p_spec),
                                  h.get_beacon_committee(staged, slot, index, p_spec))


def test_staged_device_deltas_through_process_slots(deneb_chain):
    """The fused boundary off: the staged deltas program runs on the CPU
    and the state equals the numpy transition's."""
    ref, port, target, j_spec, p_spec, p_types = boundary_pair(deneb_chain, "deneb", False)
    pe.configure(fused_boundary=False)
    mark = device_telemetry.FLIGHT_RECORDER.recorded_total
    out = per_slot.process_slots(port, target, p_types, p_spec)
    ops = [r["op"] for r in device_telemetry.FLIGHT_RECORDER.recent(limit=64)
           if r["seq"] > mark]
    assert ops == ["epoch_deltas"]
    assert out.as_ssz_bytes() == j_process_slots(ref, target, deneb_chain["deneb"][1],
                                                 j_spec).as_ssz_bytes()


def test_overflow_guard_keeps_the_exact_numpy_path():
    """Inactivity scores whose penalty product cannot be represented in
    int64: neither the fused boundary nor the staged program runs; the
    exact numpy pass answers (an algorithm branch, not a failure)."""
    plan = synth_plan(64)
    inactivity = plan.inactivity.copy()
    inactivity[3] = 2 ** 62
    arrays, spec = arrays_of(plan), spec_of(plan)
    assert not pe._fused_boundary_eligible(arrays, inactivity, spec)
    kwargs = deltas_kwargs(plan, True)
    mark = device_telemetry.FLIGHT_RECORDER.recorded_total
    ours = pe.epoch_deltas(arrays, plan.prev_part, inactivity, **kwargs)
    assert device_telemetry.FLIGHT_RECORDER.recorded_total == mark
    for a, b in zip(ours, pe._epoch_deltas_numpy(arrays, plan.prev_part, inactivity, **kwargs)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- runtime


@pytest.mark.parametrize("op", ["epoch_deltas", "epoch_deltas_leak", "epoch_boundary",
                                "epoch_boundary_leak", "shuffle", "proposer_select"])
def test_epoch_ops_never_split(op):
    assert op in ds.NO_SPLIT_OPS and op in j_ds.NO_SPLIT_OPS
    assert ds.DEFAULT_DEADLINES[op] == j_ds.DEFAULT_DEADLINES[op]


def test_job_pipeline_runs_jobs_in_order_and_shuts_down():
    pipe = JobPipeline("epoch_boundary", device="cpu")
    gate = threading.Event()
    order = []
    first = pipe.submit(lambda: (gate.wait(10.0), order.append(1), 1)[-1], work="epoch_transition")
    second = pipe.submit(lambda: order.append(2) or 2)
    failing = pipe.submit(lambda: 1 // 0)
    gate.set()
    assert first.result(timeout=10.0) == 1 and second.result(timeout=10.0) == 2
    with pytest.raises(ZeroDivisionError):
        failing.result(timeout=10.0)
    assert order == [1, 2]
    assert pipe.snapshot() == {"op": "epoch_boundary", "device": "cpu",
                               "pending_jobs": 0, "jobs_total": 3}
    pipe.shutdown()
    with pytest.raises(PipelineShutdown):
        pipe.submit(lambda: 3)


def test_run_job_routes_only_on_the_pipelines_device():
    assert not device_pipeline.routes_job("cpu")  # disabled
    device_pipeline.enable(device="cpu")
    assert device_pipeline.routes_job("cpu")
    assert not device_pipeline.routes_job("cuda")
    assert device_pipeline.run_job("epoch_deltas", lambda: 7, device="cpu") == 7
    with pytest.raises(PipelineShutdown):
        device_pipeline.run_job("epoch_deltas", lambda: 7, device="cuda")
    jobs = device_pipeline.summary()["jobs"]
    assert jobs["epoch_deltas"]["jobs_total"] == 1 and jobs["epoch_deltas"]["device"] == "cpu"
    grants = device_pipeline.summary()["arbiter"]["grants"]
    assert grants.get("epoch_deltas") == 1
    device_pipeline.enable(device="cuda")  # retires the cpu job pipeline
    assert device_pipeline.routes_job("cuda") and not device_pipeline.routes_job("cpu")
    assert device_pipeline.summary() is None or not device_pipeline.summary()["jobs"]


def test_boundary_rides_the_job_pipeline(deneb_chain):
    """Pipeline on (on the CPU): the fused boundary queues for the shared
    arbiter slot as one job and returns the direct path's state."""
    ref, port, target, j_spec, p_spec, p_types = boundary_pair(deneb_chain, "deneb", False)
    device_pipeline.enable(device="cpu")
    out = per_slot.process_slots(port, target, p_types, p_spec)
    snap = device_pipeline.summary()
    assert snap["jobs"]["epoch_boundary"]["jobs_total"] == 1
    assert snap["arbiter"]["grants"]["epoch_boundary"] == 1
    assert out.as_ssz_bytes() == j_process_slots(ref, target, deneb_chain["deneb"][1],
                                                 j_spec).as_ssz_bytes()


def _fallback_total():
    return sum(metrics.DEVICE_HOST_FALLBACK.snapshot().values())


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_epoch_fault_raises_on_the_card(monkeypatch, device_type):
    """An injected dispatch fault on an epoch job: with the job's tensors
    bound for the card it raises into the caller and the numpy composite
    never runs; on the CPU the numpy composite answers.  The device check
    is bypassed, so no card is needed (the fault fires before any upload)."""
    monkeypatch.setattr(devices, "resolve_device", torch.device)
    monkeypatch.setattr(psd, "resolve_device", torch.device)
    host_calls = []
    real = pe._epoch_boundary_numpy
    monkeypatch.setattr(pe, "_epoch_boundary_numpy",
                        lambda plan, **kw: host_calls.append(1) or real(plan, **kw))
    pe.configure(device=device_type)
    plan = synth_plan(64)
    before = _fallback_total()
    fi.install("device.dispatch", "error", op="epoch_boundary")
    if device_type == "cuda":
        with pytest.raises(fi.InjectedFault):
            pe._run_boundary(plan, in_leak=False)
        assert host_calls == [] and _fallback_total() == before
    else:
        out = pe._run_boundary(plan, in_leak=False)
        assert host_calls == [1] and _fallback_total() == before + 1
        for a, b in zip(out, real(plan, in_leak=False)):
            assert np.array_equal(a, b)
    snap = ds.SUPERVISOR.breaker("epoch_boundary").snapshot()
    assert snap["consecutive_failures"] == 1 and snap["last_failure"] == "device_error"


# ------------------------------------------- the CUDA source through g++

_EPOCH_PRELUDE = _HOST_PRELUDE + r"""
#include <string.h>
enum { cudaMemcpyDeviceToDevice = 3 };
static int cudaMemcpyAsync(void* dst, const void* src, size_t n, int, cudaStream_t) {
  memcpy(dst, src, n);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_shuffle(tmp_path_factory):
    """The CUDA source built by g++ into a shared library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the host")
    return cuda_epoch.load_library(host_compile(cuda_epoch.SOURCE, _EPOCH_PRELUDE,
                                                tmp_path_factory.mktemp("host_shuffle"),
                                                launches=2))


@pytest.mark.parametrize("n,rounds", [(1, 10), (2, 10), (63, 10), (64, 3), (255, 1),
                                      (256, 0), (257, 10), (600, 30)])
def test_cuda_source_shuffle_on_host_compiler(host_shuffle, n, rounds):
    nb = psd._bucket(n)
    values = np.zeros(nb, dtype=np.int32)
    values[:n] = np.random.default_rng(n).permutation(n)
    pivots, digests = psd.shuffle_tables(SEED, rounds, n, nb)
    out = np.full(nb + 1, 0x5A5A5A5A, dtype=np.int32)  # one guard word
    scratch = np.zeros(nb, dtype=np.int32)
    err = host_shuffle.lt_shuffle_rounds(
        values.ctypes.data, out.ctypes.data, scratch.ctypes.data, pivots.ctypes.data,
        digests.ctypes.data, digests.shape[1], rounds, n, nb, None)
    assert err == 0
    plain = cuda_epoch.shuffle_rounds_plain(torch.from_numpy(values), torch.from_numpy(pivots),
                                            torch.from_numpy(digests), n)
    assert np.array_equal(out[:nb], plain.numpy())
    assert np.array_equal(out[:n], shuffle_list(values[:n], SEED, rounds))
    assert out[nb] == 0x5A5A5A5A


@pytest.mark.parametrize("n,offset,count", [(97, 0, 128), (97, 64, 64), (97, 90, 20),
                                            (97, 100, 28), (600, 512, 512), (600, 0, 1)])
def test_cuda_source_shuffle_block_on_host_compiler(host_shuffle, n, offset, count):
    """``lt_shuffle_round_block``: a mesh shard's block of one round, read
    from the whole list (blocks before, across and past ``n_live``),
    equals the plain version's block form and the whole-list round."""
    nb = psd._bucket(n)
    values = np.random.default_rng(n).permutation(nb).astype(np.int32)
    pivots, digests = psd.shuffle_tables(SEED, 3, n, nb)
    for r in range(3):
        out = np.full(count + 1, 0x5A5A5A5A, dtype=np.int32)  # one guard word
        err = host_shuffle.lt_shuffle_round_block(
            values.ctypes.data, out.ctypes.data, pivots[r:].ctypes.data,
            digests[r].ctypes.data, n, offset, count, None)
        assert err == 0
        one = (torch.from_numpy(pivots[r:r + 1]), torch.from_numpy(digests[r:r + 1]))
        plain = cuda_epoch.shuffle_rounds_plain(torch.from_numpy(values), *one, n, offset, count)
        whole = cuda_epoch.shuffle_rounds_plain(torch.from_numpy(values), *one, n)
        assert np.array_equal(out[:count], plain.numpy())
        assert np.array_equal(out[:count], whole.numpy()[offset:offset + count])
        assert out[count] == 0x5A5A5A5A


def _walk_seeds(m: int, slots: int, top_bits: bool) -> tuple:
    """Slot seeds from hashlib; with ``top_bits`` every big-endian word of
    each seed has its top bit set (the signed-word edge of the kernel's
    per-slot prefix)."""
    seeds = [hashlib.sha256(b"walk-%d-%d" % (m, s)).digest() for s in range(slots)]
    if top_bits:
        seeds = [bytes(b | 0x80 if i % 4 == 0 else b for i, b in enumerate(seed))
                 for seed in seeds]
    return tuple(seeds)


def _walk_cases():
    """(m, slots, k, rounds, lookahead, top_bits): the default lookahead at
    the minimal preset's rounds (the first cases' ids unchanged), then every
    lookahead at those cases, at 7 rounds (not a multiple of 2, 3 or 4) and
    at the mainnet preset's 90, with top-bit seeds and m_live of 1 and 2."""
    base = [(1, 2, 64), (5, 8, 64), (300, 8, 64), (70000, 3, 33)]
    cases = [pytest.param(m, slots, k, ROUNDS, None, False, id=f"{m}-{slots}-{k}")
             for m, slots, k in base]
    for look in cuda_epoch.WALK_LOOKAHEADS:
        extra = [(m, slots, k, ROUNDS, False) for m, slots, k in base]
        extra += [(2, 4, 64, 7, True), (300, 4, 64, 7, False), (70000, 2, 33, 7, True),
                  (1, 2, 8, 7, True), (1000, 2, 16, 90, True)]
        cases += [pytest.param(m, slots, k, rounds, look, top,
                               id=f"{m}-{slots}-{k}-R{rounds}-L{look}{'-top' if top else ''}")
                  for m, slots, k, rounds, top in extra]
    return cases


@pytest.mark.parametrize("m,slots,k,rounds,lookahead,top_bits", _walk_cases())
def test_cuda_source_proposer_walk_on_host_compiler(host_shuffle, m, slots, k, rounds, lookahead,
                                                    top_bits):
    seeds = _walk_seeds(m, slots, top_bits)
    seed_words, pivots, _ = psd.proposer_tables(seeds, rounds, m, k)
    out = np.full(slots * k + 1, 0x5A5A5A5A, dtype=np.int32)
    args = (seed_words.ctypes.data, pivots.ctypes.data, out.ctypes.data, slots, rounds, k, m)
    if lookahead is None:
        err = host_shuffle.lt_proposer_walk(*args, None)
    else:
        err = host_shuffle.lt_proposer_walk_k(*args, lookahead, None)
    assert err == 0
    plain = cuda_epoch.proposer_walk_plain(torch.from_numpy(seed_words.view(np.int32)),
                                           torch.from_numpy(pivots), k, m)
    assert np.array_equal(out[:-1].reshape(slots, k), plain.numpy())
    assert out[-1] == 0x5A5A5A5A
    for s, seed in enumerate(seeds):
        for c in range(0, k, 7):
            assert out[s * k + c] == compute_shuffled_index(c % m, m, seed, rounds)


def test_cuda_source_walk_rejects_bad_lookahead_and_rounds(host_shuffle):
    seed_words, pivots, _ = psd.proposer_tables((SEED,), ROUNDS, 5, 4)
    out = np.zeros(4, dtype=np.int32)
    args = (seed_words.ctypes.data, pivots.ctypes.data, out.ctypes.data, 1)
    assert host_shuffle.lt_walk_lookahead() in cuda_epoch.WALK_LOOKAHEADS
    for look in (0, 5):
        assert host_shuffle.lt_proposer_walk_k(*args, ROUNDS, 4, 5, look, None) != 0
    assert host_shuffle.lt_proposer_walk_k(*args, cuda_epoch.WALK_MAX_ROUNDS + 1, 4, 5, 1,
                                           None) != 0
    with pytest.raises(ValueError, match="lookahead"):
        cuda_epoch._proposer_walk_k(torch.from_numpy(seed_words.view(np.int32)),
                                    torch.from_numpy(pivots), 4, 5, 5)


@pytest.mark.parametrize("lookahead", (None,) + cuda_epoch.WALK_LOOKAHEADS)
@pytest.mark.parametrize("m", [1, 2, 300])
def test_cuda_source_walk_takes_any_pivot_mod_m(host_shuffle, m, lookahead):
    """Pivots outside [0, m_live) (negative, past m_live, at the int32
    limits) give the plain version's walk: the kernel reduces each pivot as
    it loads it, as the plain version does."""
    slots, k, rounds = 3, 16, 10
    seed_words, pivots, _ = psd.proposer_tables(_walk_seeds(m, slots, True), rounds, m, k)
    rng = np.random.default_rng(m)
    wild = pivots.astype(np.int64) + m * rng.integers(-1000, 1000, pivots.shape)
    wild[0, :3] = (-1, m, np.iinfo(np.int32).min)
    wild[1, :2] = (np.iinfo(np.int32).max, -m)
    wild = wild.astype(np.int32)
    out = np.zeros(slots * k, dtype=np.int32)
    args = (seed_words.ctypes.data, wild.ctypes.data, out.ctypes.data, slots, rounds, k, m)
    if lookahead is None:
        assert host_shuffle.lt_proposer_walk(*args, None) == 0
    else:
        assert host_shuffle.lt_proposer_walk_k(*args, lookahead, None) == 0
    sw = torch.from_numpy(seed_words.view(np.int32))
    plain = cuda_epoch.proposer_walk_plain(sw, torch.from_numpy(wild), k, m)
    assert np.array_equal(out.reshape(slots, k), plain.numpy())


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_kernels_on_card():
    """Both CUDA kernels equal their plain versions on the card, on lane
    counts that end inside a block, and the boundary program equals the
    numpy golden."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for n in (1, 63, 255, 256, 257, 1000):
        nb = psd._bucket(n)
        values = torch.from_numpy(np.random.default_rng(n).permutation(nb).astype(np.int32))
        pivots, digests = (torch.from_numpy(t) for t in psd.shuffle_tables(SEED, 90, n, nb))
        before = cuda_epoch.LAUNCHES["shuffle_round"]
        out = cuda_epoch.shuffle_rounds(values.cuda(), pivots.cuda(), digests.cuda(), n)
        assert torch.equal(out.cpu(), cuda_epoch.shuffle_rounds_plain(values, pivots, digests, n))
        assert cuda_epoch.LAUNCHES["shuffle_round"] == before + 90
        for offset, count in ((0, nb // 2), (nb // 2, nb - nb // 2), (n - 1, nb - n + 1)):
            one = (pivots[:1], digests[:1])
            block = cuda_epoch.shuffle_rounds(values.cuda(), *(t.cuda() for t in one), n,
                                              offset, count)
            assert torch.equal(block.cpu(), cuda_epoch.shuffle_rounds_plain(
                values, *one, n, offset, count))
    for m in (1, 2, 5, 300):
        for rounds in (90, 10, 7):
            seeds = tuple(hashlib.sha256(b"card-%d-%d" % (m, s)).digest() for s in range(32))
            seed_words, pivots, _ = psd.proposer_tables(seeds, rounds, m)
            sw = torch.from_numpy(seed_words.view(np.int32))
            pv = torch.from_numpy(pivots)
            plain = cuda_epoch.proposer_walk_plain(sw, pv, 64, m)
            for look in (None,) + cuda_epoch.WALK_LOOKAHEADS:
                out = cuda_epoch._proposer_walk_k(sw.cuda(), pv.cuda(), 64, m, look)
                assert torch.equal(out.cpu(), plain), (m, rounds, look)
    plan = synth_plan(300)
    for leak in (False, True):
        for a, b in zip(psd.epoch_boundary_device(plan, in_leak=leak, device="cuda"),
                        pe._epoch_boundary_numpy(plan, in_leak=leak)):
            assert np.array_equal(a, b)
