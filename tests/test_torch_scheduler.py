"""The port's scheduler (``scheduler/processor.py``, ``admission.py``) vs the
JAX package's.

``lighthouse_tpu_torch.scheduler`` copies the JAX package's scheduler on
plain ``threading`` locks.  Every comparison here is exact (orders, batch
compositions, counters, decisions, seconds from one scripted clock):

- the JAX package's ``test_scheduler.py`` cases, each run on both
  packages' processors;
- a ``RequeueWork`` raised by a batch handler: both processors requeue the
  same events the same number of times and count the same;
- a scripted trace through one gated worker: the same processing order and
  the same batches from both;
- ``AdmissionController`` on a scripted clock: the same admit / deadline /
  release script gives the same decisions, ``retry_after``,
  ``effective_bounds`` and ``snapshot()`` from both, with ``adaptive``
  True, False and None (None is static in both: the JAX package's
  autotune mode is ``pinned`` unless its environment says ``live``);
- the router's batch handler (``Router._process_gossip_attestations``,
  recorded by ``chip_smoke.RoutedBatches`` as ``chip_smoke.py``'s
  ``[network]`` records it on the card) fed gossip events through the
  processor of a ``LocalNode`` on a minimal-preset harness: the attestations
  it applies give the fork-choice weights and head of the JAX chain's
  ``process_attestation`` on the same attestations; with real crypto on
  the CPU (the ``"torch"`` backend) a tampered item is refused alone, as the
  JAX chain refuses it.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest
import torch

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from lighthouse_tpu import metrics as jmetrics  # noqa: E402
from lighthouse_tpu import scheduler as jsched  # noqa: E402
from lighthouse_tpu.chain.beacon_chain import AttestationError as JAttestationError  # noqa: E402
from lighthouse_tpu.consensus import helpers as jh  # noqa: E402
from lighthouse_tpu.scheduler import admission as jadmission  # noqa: E402
from lighthouse_tpu.scheduler import processor as jprocessor  # noqa: E402
from lighthouse_tpu.scheduler import work as jwork  # noqa: E402
from lighthouse_tpu_torch import metrics as pmetrics  # noqa: E402
from lighthouse_tpu_torch import scheduler as psched  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.network import LocalNode  # noqa: E402
from lighthouse_tpu_torch.network.transport import Hub  # noqa: E402
from lighthouse_tpu_torch.scheduler import admission as padmission  # noqa: E402
from lighthouse_tpu_torch.scheduler import processor as pprocessor  # noqa: E402
from lighthouse_tpu_torch.scheduler import work as pwork  # noqa: E402
from test_torch_chain import (  # noqa: E402,F401
    GRAFFITI,
    JGraffitiOrigin,
    harnesses,
    jax_backend,
    port_cpu,
)

PACKAGES = {
    "jax": SimpleNamespace(sched=jsched, processor=jprocessor, work=jwork,
                           metrics=jmetrics, admission=jadmission),
    "port": SimpleNamespace(sched=psched, processor=pprocessor, work=pwork,
                            metrics=pmetrics, admission=padmission),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture()
def processor(pkg):
    p = pkg.sched.BeaconProcessor(max_workers=1)
    yield p
    p.shutdown()


def gate_event(pkg, work_type, gate, started=None):
    def run(_):
        if started is not None:
            started.set()
        gate.wait(5.0)

    return pkg.sched.WorkEvent(work_type=work_type, process=run)


def hold(pkg, processor):
    """Occupy the single worker; returns the gate that releases it."""
    gate, started = threading.Event(), threading.Event()
    processor.send(gate_event(pkg, pkg.sched.W.STATUS, gate, started))
    assert started.wait(2.0)
    return gate


# ------------------------------------------- the JAX package's cases, both


class TestPriority:
    def test_blocks_before_attestations(self, pkg, processor):
        W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
        order = []
        gate = hold(pkg, processor)
        done = threading.Event()

        def make(wt):
            return WorkEvent(work_type=wt, process=lambda _: order.append(wt))

        processor.send(make(W.GOSSIP_ATTESTATION))
        processor.send(make(W.BACKFILL_SYNC))
        processor.send(make(W.GOSSIP_AGGREGATE))
        processor.send(make(W.GOSSIP_BLOCK))
        processor.send(WorkEvent(work_type=W.API_REQUEST_P1, process=lambda _: done.set()))
        gate.set()
        assert done.wait(5.0)
        assert order == [W.GOSSIP_BLOCK, W.GOSSIP_AGGREGATE, W.GOSSIP_ATTESTATION,
                         W.BACKFILL_SYNC]

    def test_metrics_counted(self, pkg, processor):
        W = pkg.sched.W
        processor.send(pkg.sched.WorkEvent(work_type=W.GOSSIP_BLOCK, process=lambda _: None))
        assert processor.wait_idle(5.0)
        assert processor.metrics.received[W.GOSSIP_BLOCK] == 1
        assert processor.metrics.processed[W.GOSSIP_BLOCK] == 1


class TestBatching:
    def test_attestations_coalesce(self, pkg, processor, monkeypatch):
        W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
        monkeypatch.setitem(pkg.work.BATCH_RULES, W.GOSSIP_ATTESTATION,
                            (W.GOSSIP_ATTESTATION_BATCH, 64))
        gate = hold(pkg, processor)
        batches, singles = [], []
        for i in range(70):
            processor.send(WorkEvent(work_type=W.GOSSIP_ATTESTATION, process=singles.append,
                                     process_batch=lambda items: batches.append(list(items)),
                                     item=i))
        gate.set()
        assert processor.wait_idle(5.0)
        assert sum(len(b) for b in batches) + len(singles) == 70
        assert any(len(b) == 64 for b in batches)
        assert processor.metrics.batch_items[W.GOSSIP_ATTESTATION_BATCH] >= 64

    def test_single_event_takes_batch_path(self, pkg, processor):
        W = pkg.sched.W
        batches, singles = [], []
        done = threading.Event()

        def batch(items):
            batches.append(list(items))
            done.set()

        processor.send(pkg.sched.WorkEvent(work_type=W.GOSSIP_ATTESTATION,
                                           process=singles.append, process_batch=batch,
                                           item="lone"))
        assert done.wait(5.0)
        assert batches == [["lone"]]
        assert singles == []
        assert processor.metrics.batch_items[W.GOSSIP_ATTESTATION_BATCH] == 1

    def test_mixed_batch_shapeless_events_run_per_item(self, pkg, processor):
        W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
        gate = hold(pkg, processor)
        batches, loose = [], []
        for i in range(3):
            processor.send(WorkEvent(work_type=W.GOSSIP_ATTESTATION,
                                     process=lambda it: loose.append(("single", it)),
                                     process_batch=lambda items: batches.append(list(items)),
                                     item=i))
        processor.send(WorkEvent(work_type=W.GOSSIP_ATTESTATION,
                                 process=lambda _=None: loose.append(("shapeless", None))))
        gate.set()
        assert processor.wait_idle(5.0)
        assert batches == [[0, 1, 2]]
        assert loose == [("shapeless", None)]
        assert processor.metrics.processed[W.GOSSIP_ATTESTATION] == 4
        assert W.GOSSIP_ATTESTATION not in processor.metrics.dropped

    def test_queue_depth_gauge_sampled(self, pkg, processor):
        W = pkg.sched.W
        depth = pkg.metrics.BEACON_PROCESSOR_QUEUE_DEPTH
        gate = hold(pkg, processor)
        for _ in range(5):
            processor.send(pkg.sched.WorkEvent(work_type=W.BACKFILL_SYNC, process=lambda _: None))
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and depth.get(work=W.BACKFILL_SYNC) < 5:
            time.sleep(0.05)
        assert depth.get(work=W.BACKFILL_SYNC) >= 5
        gate.set()
        assert processor.wait_idle(5.0)

    def test_worker_error_does_not_kill_processor(self, pkg, processor):
        W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent

        def boom(_):
            raise RuntimeError("injected")

        processor.send(WorkEvent(work_type=W.GOSSIP_BLOCK, process=boom))
        assert processor.wait_idle(5.0)
        done = threading.Event()
        processor.send(WorkEvent(work_type=W.GOSSIP_BLOCK, process=lambda _: done.set()))
        assert done.wait(5.0)


def test_full_queue_drops(pkg):
    W = pkg.sched.W
    p = pkg.sched.BeaconProcessor(max_workers=1, queue_lengths={W.GOSSIP_ATTESTATION: 4})
    try:
        gate = hold(pkg, p)
        accepted = sum(p.send(pkg.sched.WorkEvent(work_type=W.GOSSIP_ATTESTATION,
                                                  process=lambda _: None))
                       for _ in range(10))
        assert accepted == 4
        assert p.metrics.dropped[W.GOSSIP_ATTESTATION] == 6
        gate.set()
    finally:
        p.shutdown()


class TestReprocess:
    def test_delayed_event_fires(self, pkg, processor):
        rq = pkg.sched.ReprocessQueue(processor)
        try:
            done = threading.Event()
            rq.schedule_at(time.monotonic() + 0.15, pkg.sched.WorkEvent(
                work_type=pkg.sched.W.DELAYED_IMPORT_BLOCK, process=lambda _: done.set()))
            assert not done.wait(0.05)
            assert done.wait(2.0)
        finally:
            rq.shutdown()

    def test_await_block_release(self, pkg, processor):
        rq = pkg.sched.ReprocessQueue(processor)
        try:
            done = threading.Event()
            root = b"\xaa" * 32
            rq.await_block(root, pkg.sched.WorkEvent(
                work_type=pkg.sched.W.UNKNOWN_BLOCK_ATTESTATION, process=lambda _: done.set()))
            assert not done.wait(0.05)
            assert rq.block_imported(root) == 1
            assert done.wait(2.0)
            assert rq.block_imported(root) == 0
        finally:
            rq.shutdown()


class TestDropDuringSync:
    def test_flagged_work_dropped_while_syncing(self, pkg):
        W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
        syncing = [True]
        p = pkg.sched.BeaconProcessor(max_workers=1, is_syncing=lambda: syncing[0])
        try:
            ran = threading.Event()
            ev = WorkEvent(work_type=W.GOSSIP_ATTESTATION, process=lambda _: ran.set(),
                           drop_during_sync=True)
            assert p.send(ev) is False
            assert not ran.wait(0.2)
            assert p.metrics.dropped_during_sync[W.GOSSIP_ATTESTATION] == 1
            assert W.GOSSIP_ATTESTATION not in p.metrics.received
            done = threading.Event()
            assert p.send(WorkEvent(work_type=W.GOSSIP_BLOCK, process=lambda _: done.set()))
            assert done.wait(5.0)
            syncing[0] = False
            done2 = threading.Event()
            assert p.send(WorkEvent(work_type=W.GOSSIP_ATTESTATION,
                                    process=lambda _: done2.set(), drop_during_sync=True))
            assert done2.wait(5.0)
            assert p.metrics.dropped_during_sync[W.GOSSIP_ATTESTATION] == 1
        finally:
            p.shutdown()

    def test_prometheus_counter_bumped(self, pkg):
        W = pkg.sched.W
        p = pkg.sched.BeaconProcessor(max_workers=1, is_syncing=lambda: True)
        try:
            before = pkg.processor.DROPPED_DURING_SYNC.get(work=W.GOSSIP_AGGREGATE)
            p.send(pkg.sched.WorkEvent(work_type=W.GOSSIP_AGGREGATE, process=lambda _: None,
                                       drop_during_sync=True))
            assert pkg.processor.DROPPED_DURING_SYNC.get(work=W.GOSSIP_AGGREGATE) == before + 1
        finally:
            p.shutdown()


# ----------------------------------------------------- requeue, both packages


def requeue_run(pkg, failures: int) -> dict:
    """Five attestation events drained as one batch whose handler raises
    ``RequeueWork`` on its first ``failures`` calls; returns the batches the
    handler saw and every counter delta."""
    W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
    wt = W.GOSSIP_ATTESTATION
    counters = {"requeued": pkg.processor.WORK_EVENTS_REQUEUED,
                "dropped": pkg.processor.WORK_EVENTS_DROPPED,
                "processed": pkg.processor.WORK_EVENTS_PROCESSED}
    before = {k: c.get(work=wt) for k, c in counters.items()}
    seen = []

    def batch(items):
        seen.append(list(items))
        if len(seen) <= failures:
            raise pkg.work.RequeueWork("breaker open")

    p = pkg.sched.BeaconProcessor(max_workers=1)
    try:
        gate = hold(pkg, p)
        for i in range(5):
            p.send(WorkEvent(work_type=wt, process=lambda it: batch([it]), process_batch=batch,
                             item=i))
        gate.set()
        assert p.wait_idle(5.0)
        return {"seen": seen, "metrics": dict(p.metrics.dropped),
                **{k: c.get(work=wt) - before[k] for k, c in counters.items()}}
    finally:
        p.shutdown()


@pytest.mark.parametrize("failures", [1, 2])
def test_requeue_matches_jax(failures):
    """A batch that raises ``RequeueWork`` once is requeued and then
    processed; twice, it is dropped after ``MAX_WORK_RETRIES`` (1)."""
    j_out, p_out = requeue_run(PACKAGES["jax"], failures), requeue_run(PACKAGES["port"], failures)
    assert p_out == j_out
    assert p_out["requeued"] == 5
    if failures == 1:
        assert p_out["seen"] == [[0, 1, 2, 3, 4]] * 2 and p_out["processed"] == 5
        assert p_out["dropped"] == 0
    else:
        assert p_out["dropped"] == 5 and p_out["processed"] == 0


# ------------------------------------------------------- scripted trace


def scripted_trace(pkg) -> list:
    """A mixed script queued behind one gated worker (attestation and
    aggregate caps of 3): the order in which events ran and the batches."""
    W, WorkEvent = pkg.sched.W, pkg.sched.WorkEvent
    trace = []
    rng = random.Random(7)
    kinds = [W.GOSSIP_ATTESTATION, W.GOSSIP_AGGREGATE, W.GOSSIP_BLOCK, W.BACKFILL_SYNC,
             W.API_REQUEST_P1, W.STATUS, W.RPC_BLOCK, W.CHAIN_SEGMENT]
    script = [(rng.choice(kinds), i, rng.random() < 0.8) for i in range(60)]
    p = pkg.sched.BeaconProcessor(max_workers=1)
    try:
        rules = pkg.work.BATCH_RULES
        saved = dict(rules)
        rules[W.GOSSIP_ATTESTATION] = (W.GOSSIP_ATTESTATION_BATCH, 3)
        rules[W.GOSSIP_AGGREGATE] = (W.GOSSIP_AGGREGATE_BATCH, 3)
        try:
            gate = hold(pkg, p)
            for wt, i, shaped in script:
                batch = (lambda items, wt=wt: trace.append(("batch", wt, list(items)))) \
                    if shaped else None
                p.send(WorkEvent(work_type=wt, item=i, process_batch=batch,
                                 process=lambda it, wt=wt: trace.append(("item", wt, it))))
            gate.set()
            assert p.wait_idle(5.0)
        finally:
            rules.clear()
            rules.update(saved)
        return trace + [dict(p.metrics.batches), dict(p.metrics.processed)]
    finally:
        p.shutdown()


def test_scripted_trace_matches_jax():
    j_trace, p_trace = scripted_trace(PACKAGES["jax"]), scripted_trace(PACKAGES["port"])
    assert p_trace == j_trace
    assert any(kind == "batch" and len(items) == 3 for kind, _, items in p_trace[:-2])


# ----------------------------------------------------------- admission


class ScriptClock:
    """``time`` for the admission module: every reading is the script's."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def monotonic(self):
        return self.now

    def time(self):
        return self.now


def admission_script(pkg, adaptive, monkeypatch) -> list:
    """One seeded admit / deadline / release script on a controller with
    small policies; every decision and reading, in order."""
    adm = pkg.admission
    clock = ScriptClock()
    monkeypatch.setattr(adm, "time", clock)
    policies = (adm.ClassPolicy(adm.CLASS_CRITICAL, max_inflight=6, deadline_s=1.0,
                                retry_after_s=1),
                adm.ClassPolicy(adm.CLASS_DUTIES, max_inflight=4, deadline_s=0.5,
                                retry_after_s=2),
                adm.ClassPolicy(adm.CLASS_BULK, max_inflight=2, deadline_s=0.25,
                                retry_after_s=5))
    ctl = adm.AdmissionController(policies, adaptive=adaptive)
    classes = [p.name for p in policies] + ["unlisted"]
    rng = random.Random(11)
    held, out = [], []
    for step in range(400):
        op = rng.random()
        if op < 0.45:
            klass = rng.choice(classes)
            try:
                held.append(ctl.try_admit(klass))
                out.append(("admit", klass))
            except adm.ShedError as err:
                out.append(("shed", err.klass, err.reason, err.retry_after_s, str(err)))
        elif op < 0.75 and held:
            ticket = held[rng.randrange(len(held))]
            if ticket.started_pc is None and not ticket.shed:
                try:
                    out.append(("wait", round(ticket.check_deadline(), 9)))
                except adm.ShedError as err:
                    out.append(("late", err.klass, err.retry_after_s, str(err)))
        elif held:
            ticket = held.pop(rng.randrange(len(held)))
            ticket.release()
            out.append(("release", ticket.policy.name))
        clock.now += rng.choice([0.0002, 0.001, 0.005, 0.05])
        out.append(tuple((k, ctl.effective_bounds(k), ctl.retry_after(k)) for k in classes))
    out.append(ctl.snapshot())
    return out


@pytest.mark.parametrize("adaptive", [True, False, None])
def test_admission_matches_jax(adaptive, monkeypatch):
    j_out = admission_script(PACKAGES["jax"], adaptive, monkeypatch)
    p_out = admission_script(PACKAGES["port"], adaptive, monkeypatch)
    assert p_out == j_out
    snapshot = p_out[-1]
    assert snapshot["adaptive"] is bool(adaptive)
    assert snapshot["shed_total"] > 0
    static = {"critical": (6, 1.0), "duties": (4, 0.5), "bulk": (2, 0.25)}
    tightened = any(bounds != static[k] for reading in p_out[:-1] if type(reading) is tuple
                    and type(reading[0]) is tuple for k, bounds, _ in reading if k in static)
    assert tightened is bool(adaptive)


# ---------------------------- the router's batch handler, a harness


def unaggregated(hs, helpers, slot: int, root: bytes) -> list:
    """An unaggregated attestation of ``slot`` for ``root`` from every
    member of the slot's committees, signed by the harness."""
    state, spec = hs.chain.get_state(root), hs.spec
    epoch = helpers.compute_epoch_at_slot(slot, spec)
    target = hs.chain.fork_choice.proto.ancestor_at_slot(
        root, helpers.compute_start_slot_at_epoch(epoch, spec))
    out = []
    for c in range(helpers.get_committee_count_per_slot(state, epoch, spec)):
        committee = helpers.get_beacon_committee(state, slot, c, spec)
        data = hs.types.AttestationData(
            slot=slot, index=c, beacon_block_root=root,
            source=state.current_justified_checkpoint.copy(),
            target=hs.types.Checkpoint(epoch=epoch, root=target))
        for pos, vidx in enumerate(committee):
            bits = [False] * len(committee)
            bits[pos] = True
            out.append(hs.types.Attestation(
                aggregation_bits=bits, data=data,
                signature=hs.sign_attestation_data(state, data, int(vidx)).to_bytes()))
    return out


def through_processor(chain, attestations) -> "chip_smoke.RoutedBatches":
    """``attestations`` sent as the router's gossip events into the
    processor of a ``LocalNode`` on ``chain`` (one worker, held), drained
    as one batch through its router's batch handler, recorded by
    ``chip_smoke.RoutedBatches``."""
    node = LocalNode(hub=Hub(), peer_id="node", chain=chain, max_workers=1)
    try:
        items = [chip_smoke.gossip_item(node.router.fork_digest, chain.head_state, att,
                                        chain.spec, "peer") for att in attestations]
        with chip_smoke.RoutedBatches(node) as handler:
            gate = hold(PACKAGES["port"], node.processor)
            for ev in chip_smoke.gossip_events(node.router._process_gossip_attestations, items):
                assert node.processor.send(ev)
            gate.set()
            assert node.processor.wait_idle(60.0)
            assert not node.processor.metrics.dropped
    finally:
        node.shutdown()
    return handler


def test_stand_in_handler_weights_match_jax():
    """Two slots' committees attest to the head of a 64-validator harness
    (fake crypto): the port's processor and router apply them all in one
    batch, the JAX chain takes each through ``process_attestation``; the
    fork choice's weights and head are equal after the next slot."""
    jhs, phs = harnesses({})
    with jax_backend("fake"):
        roots = jhs.extend_chain(2, attest=False)
        assert phs.extend_chain(2, attest=False) == roots
        atts = [a for slot, root in zip((1, 2), roots)
                for a in unaggregated(phs, h, slot, root)]
        j_atts = [a for slot, root in zip((1, 2), roots)
                  for a in unaggregated(jhs, jh, slot, root)]
        assert [a.as_ssz_bytes() for a in atts] == [a.as_ssz_bytes() for a in j_atts]
        for att in j_atts:
            jhs.chain.process_attestation(att)
        jhs.advance_slot()
    handler = through_processor(phs.chain, atts)
    phs.advance_slot()
    assert [b["n"] for b in handler.batches] == [len(atts)]
    assert len(handler.applied) == len(atts) and not handler.refused
    weights = {n.root: n.weight for n in phs.chain.fork_choice.proto.nodes}
    assert weights == {n.root: n.weight for n in jhs.chain.fork_choice.proto.nodes}
    assert phs.head_root == jhs.head_root
    assert any(w > 0 for w in weights.values())


def test_stand_in_handler_refuses_one_like_jax():
    """Real crypto, the port's ``"torch"`` backend on the CPU against the
    JAX package's host backend: one attestation of a slot's committee under
    another member's signature; the port's batch is False, the per-item
    fallback refuses that item alone and applies the rest, and the JAX
    chain refuses the same item and accepts the others."""
    from lighthouse_tpu.chain import BeaconChainHarness as JHarness
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.chain.graffiti_calculator import GraffitiOrigin

    with jax_backend("host"):
        jhs = JHarness(validator_count=16, fake_crypto=False)
        jhs.chain.graffiti_calculator.beacon_graffiti = JGraffitiOrigin.user(GRAFFITI)
        (root,) = jhs.extend_chain(1, attest=False, sync_participation=False)
        j_atts = unaggregated(jhs, jh, 1, root)
        j_atts[1].signature = bytes(j_atts[0].signature)
        refused = []
        for i, att in enumerate(j_atts):
            try:
                jhs.chain.process_attestation(att)
            except JAttestationError:
                refused.append(i)
    phs = BeaconChainHarness(validator_count=16, fake_crypto=False)
    phs.chain.graffiti_calculator.beacon_graffiti = GraffitiOrigin.user(GRAFFITI)
    assert phs.extend_chain(1, attest=False, sync_participation=False) == [root]
    atts = unaggregated(phs, h, 1, root)
    atts[1].signature = bytes(atts[0].signature)
    handler = through_processor(phs.chain, atts)
    committee = [int(v) for v in h.get_beacon_committee(phs.chain.head_state, 1, 0, phs.spec)]
    assert refused == [1]
    assert [(b["n"], b["verdict"]) for b in handler.batches] == [(len(atts), False)]
    assert handler.refused == [committee[1]]
    assert handler.applied == [v for i, v in enumerate(committee) if i != 1]
