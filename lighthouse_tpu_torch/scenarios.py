"""Deterministic multi-node scenario soak engine.

The port of ``lighthouse_tpu/scenarios.py``.  The adversarial half of the
in-process simulator (``simulator.py`` mirrors the reference's
``basic-sim``/``fallback-sim`` happy path; this module is the reference's
fault matrix grown past it): a declarative :class:`Scenario` spec — seed,
node/validator counts, a timeline of :class:`Event`\\ s (partition/heal,
kill/restart, checkpoint-sync join under lossy links, spam/slow peers,
device fault plans, byzantine actor strategies via ``adversary.py``) —
executed by :class:`ScenarioRunner` on top of the
:class:`~.network.transport.Hub` fault fabric and the ``fault_injection``
registry, with **convergence gates** at the end: every live node must
agree on one head and finality must advance strictly past its value at the
end of the fault window.

Everything is seeded and deterministic: link-level fault decisions are a
pure function of ``(seed, directed link, message index)``
(``transport.LinkPlan``), timeline events fire at fixed window-relative
slots, and a node that restarts or joins is pumped to the fleet head
*before* slots resume so thread scheduling cannot change which blocks get
built.  Two runs with the same seed produce identical final head roots —
the slow test matrix asserts exactly that.

Every run writes a **SOAK JSON** artifact: per-node convergence/finality
evidence, slot-relative delay metric deltas from the tracing layer's
histograms, fabric fault counters plus the per-link schedule digest,
fault-injection plan hit counts, and device circuit-breaker states.

The device: the events that switch a device route (``epoch_device``,
``device_pipeline``, ``device_mesh``, ``device_hashing``,
``state_hashing``, and the warmups of ``autotune``) put it on the
runner's ``device`` — ``"cuda"`` by default (raises where there is no
card), ``"cpu"`` for the CUDA kernels' plain versions.  On the card a
device fault raises into the run (the supervisor never hands card work to
the host), so a scenario that injects one ends with the fault in its
artifact; on the CPU the host golden model answers, as in the JAX package.
A run puts back the routes that were in force before it.

Run the full matrix::

    python -m lighthouse_tpu_torch.scenarios --seed 1

or one scenario with two determinism runs, on the CPU::

    python -m lighthouse_tpu_torch.scenarios --device cpu --scenario smoke_partition --runs 2
"""

from __future__ import annotations

import importlib
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import blackbox, fault_injection, metrics, telemetry_scope, tracing
from .logs import get_logger
from .network.transport import LinkPlan
from .simulator import SimNode, Simulator
from .virtual_clock import VirtualClock, telemetry_stamp

log = get_logger("scenarios")

SCENARIO_RUNS = metrics.counter(
    "scenario_runs_total",
    "scenario soak runs, by scenario and outcome (passed|failed|error)",
)
SCENARIO_EVENTS = metrics.counter(
    "scenario_events_applied_total",
    "timeline events applied by the scenario runner, by action",
)
SOAK_LEAK_CHECKS = metrics.counter(
    "soak_leak_checks_total",
    "production-soak leak-gate evaluations, by gate and outcome "
    "(passed|failed)",
)

#: Envelope kinds that carry gossipsub traffic (vs the rpc_* stream) — the
#: usual target of lossy-link plans, so sync RPC stays merely slow.
GOSSIP_KINDS = frozenset(
    {"gossip", "ihave", "iwant", "graft", "prune", "subscribe", "unsubscribe"}
)

#: The slot-relative delay histograms (the tracing layer's) sampled into
#: every SOAK artifact as before/after deltas.
DELAY_HISTOGRAMS = {
    "block_arrival": metrics.BLOCK_ARRIVAL_DELAY_SECONDS,
    "block_imported": metrics.BLOCK_IMPORTED_DELAY_SECONDS,
    "attestation_arrival": metrics.ATTESTATION_ARRIVAL_DELAY_SECONDS,
}


#: Members of the CPU device mesh ``device_mesh`` builds with
#: ``device="cpu"`` (the JAX package's test suite runs its mesh on eight
#: virtual CPU devices); on the card the mesh takes every visible card.
CPU_MESH_MEMBERS = 8

#: The module-level device routes the device events switch, by module and
#: attribute: a run saves them before it starts and puts them back in
#: ``_cleanup``, so a soak leaves the routes as it found them.
_ROUTES = (
    ("consensus.per_epoch", ("_EPOCH_BACKEND", "_FUSED_BOUNDARY", "_DEVICE")),
    ("ops.tree_hash", ("_ENABLED", "_DEVICE", "_DEVICE_MIN_SUBTREES",
                       "_DEVICE_MIN_BLOCKS")),
    ("ops.compile_cache", ("_WARMUP_DEVICE",)),
    ("device_pipeline", ("_DEVICE",)),
)


class ScenarioFailure(AssertionError):
    """A convergence gate (or a scenario's extra check) did not hold."""


@dataclass
class Event:
    """One timeline entry: ``action`` applied at ``at_slot`` (0-based,
    relative to the start of the fault window)."""

    at_slot: int
    action: str
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"at_slot": self.at_slot, "action": self.action,
                "args": self.args}


@dataclass
class Scenario:
    """Declarative scenario spec.  ``warmup_slots`` run with the happy-path
    convergence assert (the fabric is clean), ``fault_slots`` run the event
    timeline without it, ``recovery_slots`` run after every fault is
    cleared; then the gates fire."""

    name: str
    description: str = ""
    seed: int = 0
    node_count: int = 3
    validator_count: int = 16
    warmup_slots: int = 8
    fault_slots: int = 8
    recovery_slots: int = 24
    #: run a per-node slasher (required by byzantine scenarios — the
    #: detect→slash pipeline must be live on every node).  Off by default:
    #: the per-attestation detection work adds real per-slot CPU that the
    #: purely-lossy scenarios don't need.
    slasher: bool = False
    events: Tuple[Event, ...] = ()
    #: optional callable(runner) -> dict of extra evidence; raises
    #: AssertionError to fail the scenario (kept out of the artifact spec)
    extra_checks: Optional[Callable[["ScenarioRunner"], dict]] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name, "description": self.description,
            "seed": self.seed, "node_count": self.node_count,
            "validator_count": self.validator_count,
            "warmup_slots": self.warmup_slots,
            "fault_slots": self.fault_slots,
            "recovery_slots": self.recovery_slots,
            "slasher": self.slasher,
            "events": [e.to_dict() for e in self.events],
        }


def _plan_from(spec: Dict[str, Any]) -> LinkPlan:
    kwargs = dict(spec)
    if "kinds" in kwargs and kwargs["kinds"] is not None:
        kinds = kwargs["kinds"]
        kwargs["kinds"] = GOSSIP_KINDS if kinds == "gossip" else frozenset(kinds)
    return LinkPlan(**kwargs)


class ScenarioRunner:
    """Executes one :class:`Scenario` and writes its SOAK JSON artifact."""

    #: pump cadence while waiting on sync/backfill — each iteration drains
    #: one fabric tick, so plan latency resolves in milliseconds of wall
    #: time instead of one simulated slot
    PUMP_SLEEP_S = 0.02
    SYNC_DEADLINE_S = 60.0
    CONVERGE_DEADLINE_S = 30.0
    #: rekick cadence in VIRTUAL seconds.  The old wall-clock 1.0 s compare
    #: meant a loaded box rekicked at a different virtual point than an
    #: idle one — the cadence is now a property of the run, not the host.
    REKICK_VIRTUAL_S = 1.0
    #: per-step quiescence budget.  Settle returns False on timeout and the
    #: slot proceeds un-quiesced — silent nondeterminism.  The busiest slots
    #: (a byzantine burst: votes + slashing gossip + packing) can exceed
    #: Simulator.settle's 10 s default on a cold first run, so the runner's
    #: own steps get triple the room; a quiet fabric still exits instantly.
    SETTLE_TIMEOUT_S = 30.0

    def __init__(self, scenario: Scenario, out_dir: Optional[str] = None,
                 device: str = "cuda"):
        from .ops.devices import resolve_device

        self.scenario = scenario
        # the device of the device events' routes; raises where it names a
        # card this machine does not have
        self.device = str(resolve_device(device))
        self.out_dir = out_dir or os.environ.get("LIGHTHOUSE_TPU_SOAK_DIR", ".")
        self.sim: Optional[Simulator] = None
        self.byz = None  # ByzantineController, created by the first byz event
        self.ctx: Dict[str, Any] = {}  # cross-event state for extra checks
        self.timeline: List[dict] = []
        # The run's virtual clock: owned here, injected into the Simulator
        # and installed into every control-path seam (breaker cooldowns,
        # pipeline linger, fault hang sleeps) for the run's duration.
        self.clock = VirtualClock()
        self._saved_hash_impl = None
        self._saved_host_impl = None
        self._state_hashing_on = False
        self._breakers_touched = False
        self._pipeline_enabled = False
        self._mesh_touched = False
        self._autotune_touched = False
        self._autotune_prev_mode: Optional[str] = None
        self._spam_endpoints: List[str] = []
        self._api_servers: List[Any] = []  # (cached, uncached) HTTP pairs
        self._offense_seen = 0  # byz.offenses already journaled (fleet)
        self._saved_routes: Optional[dict] = None

    # ------------------------------------------------------------ helpers

    def _node(self, index: int) -> SimNode:
        return self.sim.nodes[index]

    def _current_slot(self) -> Optional[int]:
        """The fleet's logical slot — the fault registry's slot provider.
        Fault plans key their fire decisions on this instead of arrival
        order, so thread interleaving across slots cannot move which
        dispatch faults (the ``device_breaker_mid_sync`` flake)."""
        sim = self.sim
        if sim is None:
            return None
        for n in sim.live_nodes:
            try:
                return int(n.chain.current_slot())
            except Exception:
                continue
        return None

    def _settle(self) -> None:
        """Quiesce the fabric or fail LOUDLY.  A silent settle timeout
        let the slot proceed un-quiesced — the nondeterminism it exists
        to prevent, reported only as a downstream head mismatch."""
        if not self.sim.settle(timeout=self.SETTLE_TIMEOUT_S):
            raise ScenarioFailure(
                f"fabric failed to quiesce within {self.SETTLE_TIMEOUT_S}s "
                f"at slot {self._current_slot()} — un-quiesced slots race "
                "thread scheduling into block content")

    def _pump_until(self, cond: Callable[[], bool], timeout: float,
                    rekick: Optional[Callable[[], None]] = None) -> bool:
        """Advance fabric ticks (so delayed envelopes drain) until ``cond``
        holds; ``rekick`` fires about once a virtual second (re-triggering
        sync for a node whose first attempt lost a race).

        Runs on the scenario's virtual clock: the deadline is a budget of
        virtual seconds and the rekick cadence is keyed on virtual ticks,
        so a loaded box pumps/rekicks at the same virtual points as an
        idle one (the determinism gate's structural guarantee)."""
        clock = self.clock
        deadline = clock.now() + timeout
        next_kick = clock.now()
        while clock.now() < deadline:
            if cond():
                return True
            if self.sim.hub.pending_delayed():
                self.sim.hub.advance_tick()
            if rekick is not None and clock.now() >= next_kick:
                next_kick = clock.now() + self.REKICK_VIRTUAL_S
                rekick()
            clock.lull(self.PUMP_SLEEP_S)
        return cond()

    def _pump_node_to_head(self, node: SimNode, donor: SimNode,
                           deadline: Optional[float] = None) -> None:
        """Block until ``node`` reaches ``donor``'s head, re-kicking range
        sync via a fresh status push — a restarted/joined node resumes
        duties only once synced, so thread scheduling cannot change which
        blocks the fleet builds."""

        def rekick() -> None:
            try:
                node.node.sync.on_peer_status(
                    donor.peer_id, donor.node.router.local_status())
            except Exception:
                pass  # donor churning mid-kick: the next kick retries

        ok = self._pump_until(
            lambda: node.chain.head_root == donor.chain.head_root,
            deadline or self.SYNC_DEADLINE_S, rekick=rekick)
        if not ok:
            raise ScenarioFailure(
                f"node {node.peer_id} failed to sync to {donor.peer_id} "
                f"within {deadline or self.SYNC_DEADLINE_S}s")

    def _donor(self) -> SimNode:
        """A live full node to sync against (lowest index, the convention
        every built-in scenario follows for its anchor)."""
        for n in self.sim.live_nodes:
            if n.harness is not None:
                return n
        raise ScenarioFailure("no live full node left to sync against")

    def _step_slot(self) -> int:
        """One fault-window/recovery slot: advance clocks, run duties on
        every live node, drain one fabric tick, then ``Simulator.settle``
        until the fabric is quiescent — each slot's gossip lands before
        the next slot proposes, keeping block content deterministic (but
        no convergence assert: fault windows diverge by design).

        The byzantine controller (adversary.py) hooks in three places:
        BEFORE duties (forged-content strategies need the slot's honest
        block to not exist yet), INTO duties (suppressing validators whose
        honest messages a strategy replaces), and AFTER duties settle
        (equivocations ride on top of the honest message); its per-slot
        evidence probe runs at the end of every step, recovery included."""
        sim = self.sim
        settle = self._settle
        slot = None
        for n in sim.live_nodes:
            slot = n.advance_slot()
        if self.byz is not None:
            self.byz.pre_duties(slot)
            settle()
        for n in sim.live_nodes:
            n.run_duties(
                slot,
                skip_validators=(self.byz.suppressed_for(n)
                                 if self.byz is not None else None))
            settle()  # per-node: see Simulator.run_slot
        if self.byz is not None:
            self.byz.act(slot)
            settle()
        sim.hub.advance_tick()
        settle()
        if self._autotune_touched:
            # The controller's clock inside a scenario is the per-slot
            # evaluation index — never wall-clock — so a pinned decision
            # list replays at the same slots in both determinism-gate runs.
            from . import autotune

            autotune.CONTROLLER.evaluate()
        if self.byz is not None:
            self.byz.observe_slot(slot)
            self._journal_offenses()
        # quiescent: fold worker-deferred fleet events into the scoped
        # journals on this (runner) thread — see Simulator.drain_fleet_events
        sim.drain_fleet_events()
        heads = {n.chain.head_root for n in sim.live_nodes}
        max_final = max(
            n.chain.finalized_checkpoint()[0] for n in sim.live_nodes)
        self.timeline.append(
            {"slot": slot, "distinct_heads": len(heads),
             "head_root": sim.live_nodes[0].chain.head_root.hex(),
             "max_finalized_epoch": max_final})
        # re-anchor virtual time to the slot boundary: slot-spanning
        # durations (breaker cooldowns, score decay) become deterministic
        # functions of the slot timeline, not of settle-round counts
        self.clock.snap_to_next_slot()
        return slot

    def _finalized(self, agg) -> int:
        return agg(n.chain.finalized_checkpoint()[0]
                   for n in self.sim.live_nodes)

    def _journal_offenses(self) -> None:
        """Journal freshly-recorded byzantine offenses under the OFFENDING
        node's telemetry scope (the node whose validator misbehaved) — the
        head of the cross-node causal chain the fleet-timeline gate asserts
        (offense on A precedes slashing inclusion on B in merge order)."""
        offenses = self.byz.offenses
        fresh, self._offense_seen = (
            offenses[self._offense_seen:], len(offenses))
        for off in fresh:
            node = next((n for n in self.sim.live_nodes
                         if off.validator in n.keys), None)
            scope = getattr(node, "scope", None) if node is not None else None
            # forger strategies (invalid_block, invalid_aggregate, ...) have
            # no offending validator — they journal without one, under the
            # global scope (no node's validator misbehaved)
            fields = {"slot": int(off.slot), "strategy": off.strategy}
            if off.validator is not None:
                fields["validator"] = int(off.validator)
            with telemetry_scope.activate(scope):
                blackbox.emit("adversary", "offense", **fields)

    # ------------------------------------------------------- event actions

    def _apply(self, event: Event) -> None:
        handler = getattr(self, f"_ev_{event.action}", None)
        if handler is None:
            raise ValueError(f"unknown scenario action {event.action!r}")
        log.info("scenario event", scenario=self.scenario.name,
                 action=event.action, at_slot=event.at_slot)
        SCENARIO_EVENTS.inc(action=event.action)
        blackbox.emit("scenario", event.action,
                      scenario=self.scenario.name, at_slot=event.at_slot)
        handler(**event.args)

    def _ev_partition(self, groups: Sequence[Sequence[int]]) -> None:
        for gid, group in enumerate(groups):
            for index in group:
                self.sim.hub.set_partition(self._node(index).peer_id, gid)

    def _ev_heal(self) -> None:
        self.sim.hub.clear_partitions()

    def _ev_kill(self, node: int) -> None:
        self.sim.kill_node(node)

    def _ev_restart(self, node: int) -> None:
        restarted = self.sim.restart_node(node)
        self._pump_node_to_head(restarted, self._donor())

    def _ev_link_plan(self, a: int, b: int, plans: Sequence[dict]) -> None:
        pa, pb = self._node(a).peer_id, self._node(b).peer_id
        for i, spec in enumerate(plans):
            self.sim.hub.set_link_plan(pa, pb, _plan_from(spec), append=i > 0)

    def _ev_clear_link_plans(self) -> None:
        self.sim.hub.clear_link_plans()

    def _ev_install_faults(self, spec: str) -> None:
        for plan in fault_injection.parse_spec(spec):
            fault_injection.REGISTRY.install(plan)

    def _ev_clear_faults(self) -> None:
        fault_injection.clear()

    def _ev_breaker_config(self, **kwargs) -> None:
        from . import device_supervisor

        self._breakers_touched = True
        device_supervisor.SUPERVISOR.configure(
            config=device_supervisor.BreakerConfig(**kwargs))

    def _ev_autotune(self, mode: str = "pinned",
                     pin: Optional[Sequence[dict]] = None) -> None:
        """Enable the self-tuning controller for this scenario.  ``pinned``
        (the only mode a deterministic scenario should run) replays the
        given ``pin`` — a recorded decision list keyed by evaluation
        index; the runner then drives one evaluation per stepped slot, so
        both determinism-gate runs apply identical decisions at identical
        slots.  The adoptions' bucket warmups dispatch on the runner's
        device."""
        from . import autotune
        from .ops import compile_cache

        compile_cache.configure(device=self.device)
        prev = autotune.set_mode(mode)
        if not self._autotune_touched:
            self._autotune_prev_mode = prev
        self._autotune_touched = True
        if pin is not None:
            autotune.CONTROLLER.install_pin(pin)

    def _ev_epoch_device(self, enable: bool, fused: bool = True) -> None:
        """Route every node's epoch-boundary processing through the device
        backend — with ``fused`` the whole boundary (deltas + balances +
        shuffling + proposer selection) runs as ONE supervised dispatch
        (``op=epoch_boundary``), so a fault plan on it exercises the
        breaker/host-golden fallback on the fused program.  Host and device
        produce identical bytes, so enabling it never changes chain
        content — the determinism gate covers exactly that."""
        from .consensus import per_epoch

        if enable:
            per_epoch.configure(backend="device", fused_boundary=fused,
                                device=self.device)
        else:
            per_epoch.configure(backend="numpy", fused_boundary=False)

    def _ev_device_pipeline(self, enable: bool, linger_s: float = 0.002) -> None:
        """Route every node's ``verify_signature_sets`` through the async
        device pipeline (device_pipeline.py) — coalescing stays active over
        whatever BLS backend the scenario runs, so the determinism gate
        covers batching-composition variance: batch makeup may differ
        between runs, but verdicts (and therefore heads) must not."""
        from . import device_pipeline

        if enable:
            self._pipeline_enabled = True
            # enable first: it drops a pipeline started on another device.
            # A tight linger keeps scenario wall time sane: the point is the
            # coalescing seam in the path, not big batches
            device_pipeline.enable(device=self.device)
            device_pipeline.get_pipeline().linger_s = float(linger_s)
        else:
            device_pipeline.disable()

    def _ev_device_mesh(self, enable: bool, spec: str = "auto") -> None:
        """Shard the bucketed device ops over the data-parallel mesh
        (device_mesh.py).  Sharded and single-device programs produce
        identical bytes, so enabling the mesh never changes chain content —
        the determinism gate covers exactly that.  Records whether a real
        mesh came up (``ctx["mesh_enabled"]``): on a 1-device interpreter
        the fallback is transparent, and the extra check fails loudly
        rather than passing vacuously."""
        from . import device_mesh

        self._mesh_touched = True
        if enable:
            devices = ([self.device] * CPU_MESH_MEMBERS
                       if self.device == "cpu" else None)
            size = device_mesh.configure(spec, devices=devices)
            self.ctx["mesh_enabled"] = size >= 2
            self.ctx["mesh_size"] = size
        else:
            device_mesh.reset_for_tests()

    def _ev_mesh_trip_device(self, device: int) -> None:
        """Kill one mesh device mid-scenario: its breaker trips, the mesh
        re-shards over the survivors, and every subsequent sharded dispatch
        runs on the shrunk topology.  The full-strength evidence is
        snapshotted HERE — the flight recorder is a bounded ring, and the
        post-trip sync traffic would evict the pre-trip records before the
        end-of-run check reads them."""
        from . import device_mesh, device_telemetry

        self.ctx["meshes_before_trip"] = sorted({
            r["mesh"]
            for r in device_telemetry.FLIGHT_RECORDER.recent(
                limit=device_telemetry.FLIGHT_RECORDER.capacity)
            if r.get("mesh")
        })
        self.ctx["mesh_tripped"] = device_mesh.force_trip(
            int(device), reason="scenario_kill")

    def _ev_device_hashing(self, enable: bool, threshold_blocks: int = 4) -> None:
        """Route Merkle pair-hash layers of ``threshold_blocks``+ through
        the supervised device op (so a ``device.dispatch[op=sha256_pairs]``
        fault plan has a seam to bite mid-sync); host and device produce
        identical bytes, so enabling it never changes chain content.  The
        swap mirrors ``sha256_device.install_device_hash`` but is
        reversible, and ``_HOST_IMPL`` is pointed at the saved kernel so
        the supervisor's fallback cannot recurse into the hybrid."""
        from .ops import sha256_device
        from .types import ssz as ssz_mod

        if enable:
            if self._saved_hash_impl is not None:
                return
            host = self._saved_hash_impl = ssz_mod._hash_pairs
            self._saved_host_impl = sha256_device._HOST_IMPL
            sha256_device._HOST_IMPL = host

            def hybrid(data: bytes) -> bytes:
                n = len(data) // 64
                if threshold_blocks <= n <= sha256_device.N_BUCKETS[-1]:
                    return sha256_device.hash_pairs_device(
                        data, device=self.device)
                return host(data)

            ssz_mod.set_hash_pairs_impl(hybrid)
        elif self._saved_hash_impl is not None:
            ssz_mod.set_hash_pairs_impl(self._saved_hash_impl)
            sha256_device._HOST_IMPL = self._saved_host_impl
            self._saved_hash_impl = None

    def _ev_state_hashing(self, enable: bool, threshold_blocks: int = 4) -> None:
        """Route Merkle pair-hash layers of ``threshold_blocks``+ through
        ``ops/tree_hash.hash_pairs`` — the pipeline-aware hash seam: with
        the device pipeline on, layers coalesce through the
        ``sha256_pairs`` hash pipeline (supervised inside — a
        ``device.dispatch[op=sha256_pairs]`` fault plan bites the exact
        production path, and breaker-open batches resolve through the host
        kernel with identical bytes).  The tree-hash state PR's analog of
        ``device_hashing``; reversible, with ``sha256_device._HOST_IMPL``
        pointed at the saved kernel so the supervisor's fallback cannot
        recurse into the hybrid."""
        from .ops import sha256_device, tree_hash
        from .types import ssz as ssz_mod

        if enable:
            if self._saved_hash_impl is not None:
                return
            host = self._saved_hash_impl = ssz_mod._hash_pairs
            self._saved_host_impl = sha256_device._HOST_IMPL
            sha256_device._HOST_IMPL = host
            self._state_hashing_on = True
            tree_hash.configure(enabled=True,
                                device_min_blocks=threshold_blocks,
                                device=self.device)
            # pin a tight linger (same rationale as _ev_device_pipeline):
            # the adaptive default tracks observed in-flight durations,
            # which on the 1-core gate box would park every per-level
            # Merkle batch far longer than the scenario budget tolerates.
            # Starting the hash pipeline here makes THIS event a pipeline
            # owner too — flag it so teardown shuts the worker down even
            # when the scenario never ran a device_pipeline event
            from . import device_pipeline

            device_pipeline.get_hash_pipeline().linger_s = 0.002
            self._pipeline_enabled = True

            def hybrid(data: bytes) -> bytes:
                n = len(data) // 64
                if threshold_blocks <= n <= sha256_device.N_BUCKETS[-1]:
                    return tree_hash.hash_pairs(data)
                return host(data)

            ssz_mod.set_hash_pairs_impl(hybrid)
        elif self._saved_hash_impl is not None:
            ssz_mod.set_hash_pairs_impl(self._saved_hash_impl)
            sha256_device._HOST_IMPL = self._saved_host_impl
            self._saved_hash_impl = None
            self._state_hashing_on = False
            self._restore_routes("ops.tree_hash")

    def _ev_join_checkpoint(self, anchor_from: int = 0, lossy: bool = False,
                            backfill: bool = False,
                            churn_kill: Optional[int] = None) -> None:
        """A new node joins from ``anchor_from``'s finalized checkpoint.
        ``lossy``: its links get a seeded lossy-gossip + slow-RPC plan
        BEFORE sync starts.  ``backfill``: it then backfills history; with
        ``churn_kill`` the named peer is killed first and listed as the
        preferred backfill server, so the dead-peer timeout/retry path is
        what actually fills history."""
        donor = self._node(anchor_from)
        joined = self.sim.add_checkpoint_node(anchor_from=anchor_from)
        self.ctx["joined"] = joined
        if lossy:
            for other in self.sim.live_nodes:
                if other is joined:
                    continue
                self.sim.hub.set_link_plan(
                    joined.peer_id, other.peer_id,
                    LinkPlan(drop=0.2, delay=1, jitter=1, duplicate=0.1,
                             reorder=0.3, kinds=GOSSIP_KINDS))
                self.sim.hub.set_link_plan(
                    joined.peer_id, other.peer_id,
                    LinkPlan(delay=1, kinds=frozenset(
                        {"rpc_request", "rpc_response"})),
                    append=True)
        self._pump_node_to_head(joined, donor)
        if not backfill:
            return
        from .network.backfill import BackfillSync

        sync = BackfillSync(chain=joined.chain, service=joined.node.service)
        self.ctx["backfill"] = sync
        dead_peer = None
        if churn_kill is not None:
            dead_peer = self._node(churn_kill).peer_id
            self.sim.kill_node(churn_kill)
        serving = dead_peer or donor.peer_id
        fallbacks = [n.peer_id for n in self.sim.live_nodes
                     if n is not joined and n.peer_id != serving]
        done: Dict[str, Any] = {}

        def run_backfill() -> None:
            try:
                done["filled"] = sync.backfill_from(
                    serving, request_timeout=2.0, fallback_peers=fallbacks)
            except Exception as e:  # surfaced by the gate below
                done["error"] = repr(e)

        worker = threading.Thread(target=run_backfill, daemon=True,
                                  name="scenario-backfill")
        worker.start()
        self._pump_until(lambda: not worker.is_alive(), self.SYNC_DEADLINE_S)
        if worker.is_alive() or "error" in done:
            raise ScenarioFailure(
                f"backfill did not finish cleanly: {done.get('error', 'stuck')}")
        self.ctx["backfill_filled"] = done.get("filled", 0)
        if churn_kill is not None:
            restarted = self.sim.restart_node(churn_kill)
            self._pump_node_to_head(restarted, donor)

    def _ev_byzantine(self, strategy: str, node: int, validators=None,
                      max_offenses: int = 1, **kwargs) -> None:
        """Arm a byzantine misbehavior strategy (adversary.py) on a subset
        of ``node``'s validators.  Every decision the controller takes is
        keyed on sha256(seed | strategy | slot | validator), so the 2-run
        determinism gate covers the adversary."""
        from .adversary import ByzantineController

        if self.byz is None:
            self.byz = ByzantineController(self.sim, seed=self.scenario.seed)
            self.ctx["byz"] = self.byz
        self.byz.arm(strategy, node, validators=validators,
                     max_offenses=max_offenses, **kwargs)

    def _ev_spam(self, target: int = 0, count: int = 64) -> None:
        """An ephemeral hub peer floods the target with undecodable gossip
        on a real subscribed topic — the peer-scoring path must absorb and
        penalize it without disturbing the honest mesh."""
        import hashlib

        from .network import topics as topics_mod
        from .network.transport import Envelope

        victim = self._node(target)
        spammer_id = f"spammer{len(self._spam_endpoints)}"
        endpoint = self.sim.hub.register(spammer_id)
        self._spam_endpoints.append(spammer_id)
        self.sim.hub.connect(spammer_id, victim.peer_id)
        topic = str(topics_mod.GossipTopic(
            victim.node.router.fork_digest, topics_mod.BEACON_BLOCK))
        for i in range(count):
            junk = hashlib.sha256(
                f"{self.scenario.seed}:spam:{i}".encode()).digest()
            endpoint.send(victim.peer_id, Envelope(
                kind="gossip", sender=spammer_id, topic=topic, data=junk))
        self.ctx["spammer"] = (spammer_id, victim)

    def _ev_api_serve(self, node: int = 0) -> None:
        """Stand up the serving pair over ``node``'s chain — one server with
        the checkpoint-keyed response cache, one without (the bit-identity
        oracle) — and leave both running across subsequent slots so the
        cache's event-driven invalidation is exercised by real head /
        finalization traffic, not by synthetic events."""
        from .http_api import HttpApiServer

        chain = self._node(node).chain
        cached = HttpApiServer(chain).start()
        uncached = HttpApiServer(chain, response_cache=False).start()
        self._api_servers.extend([cached, uncached])
        self.ctx["api_pair"] = (cached, uncached)
        self.ctx["api_probes"] = []

    def _ev_api_probe(self, label: str = "window") -> None:
        """Replay the deterministic hot-route request list against both
        servers — twice, so the second pass hits the cache — and record
        byte-identity plus a response digest."""
        import hashlib

        cached, uncached = self.ctx["api_pair"]
        chain = cached.chain
        digest = hashlib.sha256()
        mismatches: List[str] = []
        n_requests = 0
        for method, path, body in _api_probe_requests(chain):
            for _pass in (0, 1):
                sc, bc = _api_http(cached.port, method, path, body)
                su, bu = _api_http(uncached.port, method, path, body)
                n_requests += 1
                if (sc, bc) != (su, bu):
                    mismatches.append(f"{method} {path} [pass {_pass}]")
                digest.update(bc)
        self.ctx["api_probes"].append({
            "label": label,
            "n_requests": n_requests,
            "mismatches": mismatches,
            "digest": digest.hexdigest(),
            "cache": cached.response_cache.snapshot(),
        })

    def _ev_leak_baseline(self) -> None:
        """Snapshot every bounded ring and every monotone counter at the
        start of the fault window — the reference point the leak gates
        (``_check_leak_gates``) diff the end-of-run state against.  Only
        ``Counter`` series are snapshotted: gauges may legally fall, and
        histograms ride on counters of their own."""
        from . import device_telemetry

        with metrics._REGISTRY_LOCK:
            counters = {name: m.snapshot()
                        for name, m in metrics._REGISTRY.items()
                        if isinstance(m, metrics.Counter)}
        self.ctx["leak_baseline"] = {
            "counters": counters,
            "journal_emitted": blackbox.JOURNAL.emitted_total,
            "flight_recorded":
                device_telemetry.FLIGHT_RECORDER.recorded_total,
        }

    # ------------------------------------------------------------ the run

    def run(self) -> dict:
        scenario = self.scenario
        started = telemetry_stamp()  # telemetry only: artifact duration_s
        delay_before = {k: h.stats() for k, h in DELAY_HISTOGRAMS.items()}
        # fault-window evidence, captured before recovery clears the plans
        breakers: Optional[dict] = None
        fault_plans: Optional[list] = None
        # byzantine scenarios run a slasher on every node (the detect→slash
        # pipeline under test) — which is also an implicit honest-traffic
        # gate: a false-positive slashing would flip validators[i].slashed
        # and fail the finality gate
        self.sim = Simulator(
            node_count=scenario.node_count,
            validator_count=scenario.validator_count,
            seed=scenario.seed,
            enable_slasher=scenario.slasher,
            clock=self.clock,
        )
        self.sim.hub.record_schedule()
        self._save_routes()
        # Install the virtual clock into every control-path wall-time seam
        # for the run's duration (restored in _cleanup): breaker cooldowns,
        # pipeline linger decisions, and fault-injection hang sleeps all
        # burn virtual time while the scenario owns the process.
        self._install_clock_seams()
        # Fault plans key on the fleet's logical slot for the whole run —
        # see fault_injection's slot-keying section; cleared in _cleanup.
        fault_injection.set_slot_provider(self._current_slot)
        blackbox.emit("scenario", "run_start", scenario=scenario.name,
                      seed=scenario.seed)
        artifact: dict = {"scenario": scenario.to_dict(), "passed": False}
        try:
            for _ in range(scenario.warmup_slots):
                self.sim.run_slot()
                self.clock.snap_to_next_slot()
            finalized_at_window_start = self._finalized(max)

            events = sorted(scenario.events, key=lambda e: e.at_slot)
            queue = list(events)
            for offset in range(scenario.fault_slots):
                while queue and queue[0].at_slot <= offset:
                    self._apply(queue.pop(0))
                self._step_slot()
            for event in queue:  # events past the window still apply once
                self._apply(event)
            finalized_at_window_end = self._finalized(max)
            breakers = self._breaker_summary()
            fault_plans = fault_injection.plans()

            # implicit recovery: every fabric fault heals, injected faults
            # clear; churned nodes must have been restarted by the timeline;
            # byzantine actors stop offending (their evidence probe keeps
            # running so detection latency spans into recovery)
            self.sim.hub.clear_partitions()
            self.sim.hub.clear_link_plans()
            fault_injection.clear()
            if self.byz is not None:
                self.byz.deactivate()
            for _ in range(scenario.recovery_slots):
                self._step_slot()

            converged = self.sim.wait_converged(self.CONVERGE_DEADLINE_S)
            # late imports during the convergence pump defer fleet events
            # too — fold them in before the gates read the merged timeline
            self.sim.drain_fleet_events()
            final_finalized_min = self._finalized(min)
            per_node = [self._node_summary(n) for n in self.sim.nodes]
            if self.byz is not None:
                self._check_fleet_causality()
            extra = {}
            if scenario.extra_checks is not None:
                extra = scenario.extra_checks(self) or {}

            if not converged:
                raise ScenarioFailure(
                    f"live nodes did not converge: "
                    f"{[p['head_root'][:16] for p in per_node if p['alive']]}")
            if final_finalized_min <= finalized_at_window_end:
                raise ScenarioFailure(
                    f"finality did not advance past the fault window "
                    f"({final_finalized_min} <= {finalized_at_window_end})")

            head = self.sim.live_nodes[0].chain.head_root
            artifact.update({
                "passed": True,
                "result": {
                    "converged": True,
                    "head_root": head.hex(),
                    "head_slot": self.sim.live_nodes[0].chain.head_slot(),
                    "finalized_at_window_start": finalized_at_window_start,
                    "finalized_at_window_end": finalized_at_window_end,
                    "final_finalized_epoch": final_finalized_min,
                    "per_node": per_node,
                },
                "extra": extra,
            })
            SCENARIO_RUNS.inc(scenario=scenario.name, outcome="passed")
            return artifact
        except ScenarioFailure as e:
            artifact["failure"] = str(e)
            SCENARIO_RUNS.inc(scenario=scenario.name, outcome="failed")
            self._capture_postmortem(
                artifact, f"scenario_gate:{scenario.name}", str(e))
            raise
        except Exception as e:
            artifact["failure"] = f"{type(e).__name__}: {e}"
            SCENARIO_RUNS.inc(scenario=scenario.name, outcome="error")
            self._capture_postmortem(
                artifact, f"scenario_crash:{scenario.name}",
                artifact["failure"])
            raise
        finally:
            try:
                if breakers is None:  # failed before the window-end snapshot
                    breakers = self._breaker_summary()
                    fault_plans = fault_injection.plans()
                if self.byz is not None:
                    # adversarial coverage is a tracked artifact: offenses
                    # emitted/detected/included + detection latency ride in
                    # every byzantine SOAK JSON alongside the fabric evidence
                    artifact["adversary"] = self.byz.summary()
                artifact.update({
                    "net": {
                        "counters": self.sim.hub.fault_counters(),
                        "schedule_digest": self.sim.hub.schedule_digest(),
                        "pending_delayed": self.sim.hub.pending_delayed(),
                    },
                    "faults": fault_plans,
                    "breakers": breakers,
                    "delay_metrics": self._delay_deltas(delay_before),
                    "timeline": self.timeline,
                    # frozen BEFORE _cleanup unregisters the node scopes
                    "fleet": self._fleet_section(),
                    "duration_s": round(telemetry_stamp() - started, 3),
                })
                self._write_artifact(artifact)
            finally:
                self._cleanup()

    # ---------------------------------------------------------- reporting

    def _capture_postmortem(self, artifact: dict, reason: str,
                            failure: str) -> None:
        """Freeze the black box at a gate failure and attach the bundle
        path to the SOAK artifact — an unattended soak failure triages
        from one file."""
        try:
            cap = blackbox.capture(reason, extra={
                "scenario": self.scenario.name, "failure": failure})
            artifact["postmortem_bundle"] = cap["path"]
        except Exception as e:  # noqa: BLE001 — must not mask the gate
            log.warning("postmortem capture failed",
                        scenario=self.scenario.name,
                        error=f"{type(e).__name__}: {e}")

    def _check_fleet_causality(self) -> None:
        """Gate: the merged fleet timeline must order every cross-node
        slashing pipeline causally — the first journaled offense (on the
        offending node's scope) precedes the first ``slashing_included``
        (journaled under the including proposer's scope) in merge order."""
        included = [o for o in self.byz.offenses if o.included_slot is not None]
        if not included:
            return  # nothing reached inclusion: nothing to order
        timeline = blackbox.fleet_summary()["timeline"]
        first_off = next((i for i, r in enumerate(timeline)
                          if r.get("event") == "offense"), None)
        first_inc = next((i for i, r in enumerate(timeline)
                          if r.get("event") == "slashing_included"), None)
        if first_off is None or first_inc is None:
            raise ScenarioFailure(
                f"fleet timeline is missing the slashing causal chain "
                f"(offense at {first_off}, inclusion at {first_inc})")
        if first_off >= first_inc:
            raise ScenarioFailure(
                f"fleet timeline orders slashing inclusion (index "
                f"{first_inc}) before the offense (index {first_off}) — "
                "cross-node causality broken in the merge")

    def _fleet_section(self) -> dict:
        """The SOAK artifact's fleet-observability evidence: per-node scope
        snapshots, the merged causally-ordered timeline, and cross-node
        trace trees — each joins a ``propose_block`` span on the origin
        node to a ``gossip_block_import`` span on a receiving node via the
        envelope-propagated trace context (``remote_trace_id``)."""
        try:
            summary = blackbox.fleet_summary()
        except Exception as e:  # noqa: BLE001 — evidence must not mask gates
            return {"error": f"{type(e).__name__}: {e}"}
        proposals = {t.trace_id: t for t in tracing.TRACES.recent(
            root="propose_block", limit=512)}
        trees = []
        for t in tracing.TRACES.recent(root="gossip_block_import", limit=1024):
            origin = proposals.get(t.root.fields.get("remote_trace_id"))
            if origin is None:
                continue  # import of a non-traced (pre-scope) publish
            trees.append({
                "proposal": {
                    "trace_id": origin.trace_id,
                    "node": origin.root.fields.get("node"),
                    "slot": origin.root.fields.get("slot"),
                    "root": origin.root.fields.get("root"),
                },
                "import": {
                    "trace_id": t.trace_id,
                    "node": t.root.fields.get("node"),
                    "remote_trace_id": t.root.fields.get("remote_trace_id"),
                    "slot": t.root.fields.get("slot"),
                    "root": t.root.fields.get("root"),
                },
            })
        trees.sort(key=lambda e: (
            e["import"].get("slot") or -1, str(e["import"].get("root")),
            str(e["import"].get("node"))))
        summary["trace_trees"] = trees
        return summary

    def _node_summary(self, n: SimNode) -> dict:
        f_epoch, _ = n.chain.finalized_checkpoint()
        return {
            "peer_id": n.peer_id,
            "alive": n.alive,
            "validators": len(n.keys),
            "head_slot": n.chain.head_slot(),
            "head_root": n.chain.head_root.hex(),
            "finalized_epoch": f_epoch,
        }

    def _breaker_summary(self) -> dict:
        from . import device_supervisor

        summary = device_supervisor.summary()
        return {
            b["op"]: {"state": b["state"], "trips_total": b.get("trips_total", 0)}
            for b in summary.get("breakers", [])
        }

    def _delay_deltas(self, before: Dict[str, Tuple[int, float]]) -> dict:
        """Slot-relative delay deltas over this run (the tracing layer's
        histograms are process-cumulative; a per-scenario artifact wants
        just this scenario's traffic)."""
        out = {}
        for key, hist in DELAY_HISTOGRAMS.items():
            n0, s0 = before[key]
            n1, s1 = hist.stats()
            count = n1 - n0
            out[key] = {
                "count": count,
                "mean_s": round((s1 - s0) / count, 6) if count else None,
            }
        return out

    def _write_artifact(self, artifact: dict) -> Optional[str]:
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"SOAK_{self.scenario.name}_seed{self.scenario.seed}.json")
            with open(path, "w") as f:
                json.dump(artifact, f, indent=2, sort_keys=True)
            artifact["artifact_path"] = path
            log.info("soak artifact written", path=path,
                     passed=artifact.get("passed", False))
            return path
        except OSError:
            log.warning("soak artifact not written", out_dir=self.out_dir)
            return None

    def _install_clock_seams(self) -> None:
        """Point every control-path wall-time seam at the run's virtual
        clock.  _cleanup restores the wall defaults unconditionally, so a
        crashed run cannot leak virtual time into the next test."""
        from . import device_pipeline, device_supervisor

        device_supervisor.set_cooldown_clock(self.clock.now)
        device_pipeline.set_linger_clock(self.clock.now)
        fault_injection.set_sleeper(self.clock.sleep)

    def _restore_clock_seams(self) -> None:
        from . import device_pipeline, device_supervisor

        device_supervisor.set_cooldown_clock(None)
        device_pipeline.set_linger_clock(None)
        fault_injection.set_sleeper(None)

    def _save_routes(self) -> None:
        """Note the device routes, the pipeline and the mesh in force
        before the run (``_cleanup`` puts them back)."""
        from . import device_mesh, device_pipeline

        routes = {}
        for name, attrs in _ROUTES:
            mod = importlib.import_module(f"{__package__}.{name}")
            routes[name] = {a: getattr(mod, a) for a in attrs}
        self._saved_routes = {
            "routes": routes,
            "pipeline_enabled": device_pipeline.enabled(),
            "mesh": [str(d) for _, d in device_mesh.STATE.members()],
        }

    def _restore_routes(self, *names: str) -> None:
        """Put back the saved module routes (all of them, or ``names``)."""
        if self._saved_routes is None:
            return
        for name, values in self._saved_routes["routes"].items():
            if names and name not in names:
                continue
            mod = importlib.import_module(f"{__package__}.{name}")
            for attr, value in values.items():
                setattr(mod, attr, value)

    def _cleanup(self) -> None:
        self._restore_clock_seams()
        fault_injection.set_slot_provider(None)
        fault_injection.clear()
        saved = self._saved_routes or {}
        if self._mesh_touched:
            from . import device_mesh

            device_mesh.reset_for_tests()
            if len(saved.get("mesh", ())) >= 2:
                device_mesh.configure("auto", devices=saved["mesh"])
        if self._pipeline_enabled:
            from . import device_pipeline

            device_pipeline.reset_for_tests()
        if self._saved_hash_impl is not None:
            if self._state_hashing_on:
                self._ev_state_hashing(enable=False)
            else:
                self._ev_device_hashing(enable=False)
        if self._breakers_touched:
            from . import device_supervisor

            device_supervisor.reset_for_tests()
        if self._autotune_touched:
            from . import autotune

            autotune.reset_for_tests()
            autotune.set_mode(self._autotune_prev_mode)
        # the epoch backend, tree hashing, the warmups' device and the
        # pipeline's device as they were before the run (the port's
        # defaults are the card's routes, not the host's)
        self._restore_routes()
        if self._pipeline_enabled and saved.get("pipeline_enabled"):
            from . import device_pipeline

            device_pipeline.enable(device=device_pipeline._DEVICE)
        if self.byz is not None:
            self.byz.cleanup()
        for server in self._api_servers:
            try:
                server.stop()
            except Exception:
                pass
        self._api_servers = []
        if self.sim is not None:
            for spammer in self._spam_endpoints:
                self.sim.hub.unregister(spammer)
            self.sim.shutdown()


# ------------------------------------------------------- api-load helpers


def _api_http(port: int, method: str, path: str, body) -> Tuple[int, bytes]:
    """One raw request -> (status, body bytes); byte-exact comparison needs
    the wire bytes, not a parsed view."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        payload = None if body is None else json.dumps(body)
        headers = {"Content-Type": "application/json"} if payload else {}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _api_probe_requests(chain) -> List[Tuple[str, str, Any]]:
    """The deterministic hot-route list: duties, state queries, rewards,
    headers/heads — every family the response cache covers."""
    epoch = chain.current_slot() // chain.spec.slots_per_epoch
    n_validators = len(chain.head_state.validators)
    ids = [str(i) for i in range(n_validators)]
    return [
        ("GET", f"/eth/v1/validator/duties/proposer/{epoch}", None),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch}", ids),
        ("POST", f"/eth/v1/validator/duties/sync/{epoch}", ids),
        ("GET", "/eth/v1/beacon/states/head/validators", None),
        ("GET", "/eth/v1/beacon/states/head/validator_balances", None),
        ("GET", "/eth/v1/beacon/states/head/finality_checkpoints", None),
        ("GET", "/eth/v1/beacon/states/head/root", None),
        ("GET", f"/eth/v1/beacon/states/head/committees?epoch={epoch}", None),
        ("GET", "/eth/v1/beacon/headers", None),
        ("GET", "/eth/v1/beacon/headers/head", None),
        ("GET", "/eth/v1/debug/beacon/heads", None),
        ("GET", "/eth/v1/beacon/rewards/blocks/head", None),
        ("POST", f"/eth/v1/beacon/rewards/attestations/{max(epoch - 1, 0)}",
         None),
    ]


# --------------------------------------------------------------- built-ins


def smoke_partition(seed: int = 0) -> Scenario:
    """Tier-1 smoke: a 3-node fleet partitions {0} | {1, 2} for four slots,
    both sides fork, the heal converges them and finality resumes."""
    return Scenario(
        name="smoke_partition",
        description="partition/heal smoke with a small fork and reorg",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=6, recovery_slots=24,
        events=(
            Event(0, "partition", {"groups": [[0], [1, 2]]}),
            Event(4, "heal"),
        ),
        extra_checks=_check_reorg,
    )


def api_load(seed: int = 0) -> Scenario:
    """The serving-layer scenario: the cached beacon API rides a
    partition/heal/reorg cycle and must stay byte-identical to an uncached
    server at every probe point — while its cache is populated, invalidated
    by real head events, and repopulated.  The 2-run determinism gate makes
    the probe digests reproducible evidence."""
    return Scenario(
        name="api_load",
        description="cached vs uncached beacon API bit-identity across "
                    "partition, heal, and reorg",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=6, recovery_slots=24,
        events=(
            Event(0, "api_serve", {"node": 0}),
            Event(0, "partition", {"groups": [[0], [1, 2]]}),
            # mid-partition: node 0's minority fork is what's being served
            Event(2, "api_probe", {"label": "partitioned"}),
            Event(4, "heal"),
            # post-heal: the reorg just invalidated the minority entries
            Event(5, "api_probe", {"label": "healed"}),
        ),
        extra_checks=_check_api_load,
    )


def partition_deep_reorg(seed: int = 0) -> Scenario:
    """A minority node builds alone for a full epoch, then reorgs back to
    the majority fork — the deepest reorg the parent-lookup path must walk."""
    return Scenario(
        name="partition_deep_reorg",
        description="epoch-long minority partition, deep reorg on heal",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=10, recovery_slots=24,
        events=(
            Event(0, "partition", {"groups": [[0], [1, 2]]}),
            Event(8, "heal"),
        ),
        extra_checks=_check_reorg,
    )


def nonfinality_spell(seed: int = 0) -> Scenario:
    """>1/3 of validators go offline: finality stalls for two epochs, the
    nodes come back, sync, and finality resumes (the reference's
    fallback-sim liveness property plus recovery)."""
    return Scenario(
        name="nonfinality_spell",
        description=">1/3 offline non-finality spell with recovery",
        seed=seed, node_count=5, validator_count=20,
        warmup_slots=32, fault_slots=24, recovery_slots=24,
        events=(
            Event(0, "kill", {"node": 3}),
            Event(0, "kill", {"node": 4}),
            Event(16, "restart", {"node": 3}),
            Event(16, "restart", {"node": 4}),
        ),
        extra_checks=_check_stall,
    )


def checkpoint_join_lossy(seed: int = 0) -> Scenario:
    """A node checkpoint-syncs into a lossy fabric (seeded gossip drop /
    delay / duplication / reordering, slow RPC), then backfills history
    through a dead preferred peer — the timeout+retry path fills it."""
    return Scenario(
        name="checkpoint_join_lossy",
        description="checkpoint-sync join under lossy links + backfill churn",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=40, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "join_checkpoint",
                  {"anchor_from": 0, "lossy": True, "backfill": True,
                   "churn_kill": 1}),
        ),
        extra_checks=_check_backfill,
    )


def device_breaker_mid_sync(seed: int = 0) -> Scenario:
    """A joining node range-syncs while every ``sha256_pairs`` device
    dispatch faults: the supervisor's breaker trips OPEN, imports resolve
    through the host golden model, and sync still converges."""
    return Scenario(
        name="device_breaker_mid_sync",
        description="device.dispatch fault plan trips the breaker mid-sync",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=32, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "breaker_config",
                  {"failure_threshold": 2, "open_cooldown_s": 300.0,
                   "probe_successes": 1}),
            Event(0, "device_hashing", {"enable": True}),
            Event(0, "install_faults",
                  {"spec": "device.dispatch[op=sha256_pairs]=error"}),
            Event(1, "join_checkpoint", {"anchor_from": 0}),
            Event(4, "clear_faults"),
            Event(4, "device_hashing", {"enable": False}),
        ),
        extra_checks=_check_breaker_tripped,
    )


def mesh_degradation(seed: int = 0) -> Scenario:
    """A device dies mid-sync and the mesh re-shards around it: the fleet
    runs Merkle pair-hashing on the 8-device mesh (sha256_pairs sharded
    over ``("dp",)``), a joining node range-syncs through it, and one mesh
    device is killed mid-window — its per-device breaker trips, the mesh
    re-shards to 7 survivors, and every later sharded dispatch runs on the
    shrunk topology with identical bytes.  Gates: the fleet still
    converges + finalizes (standard), the re-shard really happened, and
    sharded work really flowed both before and after it.  Needs a mesh of
    8: on the CPU the runner builds it from ``CPU_MESH_MEMBERS`` CPU
    members; on the card it takes every visible card, so one card cannot
    run it (the mesh stays off and the extra check fails loudly)."""
    return Scenario(
        name="mesh_degradation",
        description="device killed mid-sync: mesh re-shards, fleet converges",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=32, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "device_mesh", {"enable": True}),
            Event(0, "device_hashing", {"enable": True}),
            Event(1, "join_checkpoint", {"anchor_from": 0}),
            Event(2, "mesh_trip_device", {"device": 7}),
            Event(6, "device_hashing", {"enable": False}),
        ),
        extra_checks=_check_mesh_resharded,
    )


def pipeline_mid_sync(seed: int = 0) -> Scenario:
    """``device_breaker_mid_sync`` with the async device pipeline enabled:
    every gossip/import verification rides the coalescing pipeline while a
    joining node range-syncs and the ``sha256_pairs`` breaker trips OPEN.
    The determinism gate (2 identical runs) proves batch COMPOSITION
    variance — which groups coalesce together is timing-dependent — cannot
    leak into chain content, and the breaker interplay proves pipeline
    futures still resolve while device work routes to the host."""
    return Scenario(
        name="pipeline_mid_sync",
        description="async device pipeline on during breaker-tripping sync",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=32, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "device_pipeline", {"enable": True}),
            Event(0, "breaker_config",
                  {"failure_threshold": 2, "open_cooldown_s": 300.0,
                   "probe_successes": 1}),
            Event(0, "device_hashing", {"enable": True}),
            Event(0, "install_faults",
                  {"spec": "device.dispatch[op=sha256_pairs]=error"}),
            Event(1, "join_checkpoint", {"anchor_from": 0}),
            Event(4, "clear_faults"),
            Event(4, "device_hashing", {"enable": False}),
        ),
        extra_checks=_check_pipeline_active,
    )


def state_hash_pipeline(seed: int = 0) -> Scenario:
    """Tree-hash traffic through the async pipeline's shared arbiter:
    Merkle pair-hash layers route through ``ops/tree_hash.hash_pairs``
    (coalescing into ``sha256_pairs`` hash-pipeline batches) while every
    bls verification rides the verify pipeline, a joining node range-syncs
    through it all, and a fault plan trips the sha breaker mid-window —
    hash futures must still resolve bit-identically through the host
    kernel.  The 2-run gate proves batch COMPOSITION variance (which hash
    groups coalesce together is timing-dependent) cannot leak into chain
    content."""
    return Scenario(
        name="state_hash_pipeline",
        description="pipelined tree-hash + bls traffic under sha faults",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=32, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "device_pipeline", {"enable": True}),
            Event(0, "breaker_config",
                  {"failure_threshold": 2, "open_cooldown_s": 300.0,
                   "probe_successes": 1}),
            Event(0, "state_hashing", {"enable": True}),
            Event(0, "install_faults",
                  {"spec": "device.dispatch[op=sha256_pairs]=error"}),
            Event(1, "join_checkpoint", {"anchor_from": 0}),
            Event(4, "clear_faults"),
            Event(4, "state_hashing", {"enable": False}),
        ),
        extra_checks=_check_hash_pipeline,
    )


def autotune_pinned(seed: int = 0) -> Scenario:
    """The self-tuning controller in its deterministic mode, under device
    faults: the fleet hashes through the supervised sha path while a fault
    plan trips the ``sha256_pairs`` breaker mid-sync, and the autotune
    controller replays a PINNED decision list — adopt the 640 midpoint
    sha bucket at evaluation 2, drop it at evaluation 6, adopt 900 at
    evaluation 8.  Each adoption is gated on its bucket's warmup, one
    supervised neutral ``sha256_pairs`` dispatch; the fault plan has
    tripped that breaker OPEN by evaluation 2, so both warmups fail and
    both adoptions are refused (``refused_warmup_failed``).  The 2-run
    determinism gate then proves the controller's whole machinery — mode
    plumbing, per-slot evaluation clock, overlay swap in the live
    ``_bucket`` path — cannot leak wall-clock into chain content: both
    runs must apply the identical adopted-bucket sequence AND finish on
    identical heads."""
    pin = [
        {"after_evaluation": 2, "vocab": "sha256_pairs",
         "action": "adopt", "bucket": 640},
        {"after_evaluation": 6, "vocab": "sha256_pairs",
         "action": "drop", "bucket": 640},
        # the JAX package refuses this entry on its static gate (no
        # committed hlo_budget key for 900); the port has no such gate and
        # refuses it on its warmup, as the first adoption
        {"after_evaluation": 8, "vocab": "sha256_pairs",
         "action": "adopt", "bucket": 900},
    ]
    return Scenario(
        name="autotune_pinned",
        description="pinned autotune decisions replay under device faults",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=32, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "autotune", {"mode": "pinned", "pin": pin}),
            Event(0, "breaker_config",
                  {"failure_threshold": 2, "open_cooldown_s": 300.0,
                   "probe_successes": 1}),
            Event(0, "device_hashing", {"enable": True}),
            Event(0, "install_faults",
                  {"spec": "device.dispatch[op=sha256_pairs]=error"}),
            Event(1, "join_checkpoint", {"anchor_from": 0}),
            Event(4, "clear_faults"),
            Event(4, "device_hashing", {"enable": False}),
        ),
        extra_checks=_check_autotune_pinned,
    )


def fused_epoch_boundary(seed: int = 0) -> Scenario:
    """The fused epoch-boundary dispatch under chaos: every
    node's epoch transition runs as ONE supervised device program
    (deltas + balance updates + next-epoch shuffling + proposer selection),
    a fault plan errors the ``epoch_boundary`` dispatch at the first
    boundary inside the window — the breaker trips, transitions resolve
    through the host golden model verdict-identically (on the CPU; on the
    card the fault raises into the run) — and after the
    plan clears the breaker probes shut and later boundaries run on the
    device again.  Warmup of 15 puts the epoch 1 -> 2 transition (the
    first boundary PAST genesis — the genesis transition skips the delta
    pass entirely) at window offset 0, so the faulted dispatch lands
    there deterministically (slot-keyed fault firing makes WHICH dispatch
    faults independent of thread arrival order)."""
    return Scenario(
        name="fused_epoch_boundary",
        description="fused epoch dispatch faults, host fallback, recovery",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=15, fault_slots=8, recovery_slots=24,
        events=(
            Event(0, "breaker_config",
                  {"failure_threshold": 2, "open_cooldown_s": 0.5,
                   "probe_successes": 1}),
            Event(0, "epoch_device", {"enable": True, "fused": True}),
            Event(0, "install_faults",
                  {"spec": "device.dispatch[op=epoch_boundary]=error"}),
            Event(4, "clear_faults"),
        ),
        extra_checks=_check_fused_boundary,
    )


def spam_slow_peer(seed: int = 0) -> Scenario:
    """A spammer floods undecodable blocks at one node while another pair's
    RPC link turns slow: scoring graylists the spammer, the mesh converges
    anyway."""
    return Scenario(
        name="spam_slow_peer",
        description="gossip spam + slow RPC link, mesh unharmed",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=8, recovery_slots=16,
        events=(
            Event(0, "link_plan",
                  {"a": 1, "b": 2,
                   "plans": [{"delay": 1, "jitter": 1,
                              "kinds": ["rpc_request", "rpc_response"]}]}),
            Event(1, "spam", {"target": 0, "count": 64}),
        ),
        extra_checks=_check_spammer_penalized,
    )


# ------------------------------------------------------- byzantine actors


def byz_double_vote_smoke(seed: int = 0) -> Scenario:
    """Tier-1 byzantine smoke: ONE double-voting validator, the complete
    slashing pipeline asserted — offense → slasher detection → gossiped
    slashing → op-pool pack → block inclusion → ``slashed`` flag → zeroed
    fork-choice weight — while the honest majority still finalizes.
    Warmup of 7 aligns the fault window on an epoch boundary, so the armed
    validator's one duty slot per epoch is guaranteed inside the window."""
    return Scenario(
        name="byz_double_vote_smoke",
        description="single double-voting validator, slashing pipeline gate",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=7, fault_slots=8, recovery_slots=24,
        slasher=True,
        events=(
            Event(0, "byzantine",
                  {"strategy": "double_vote", "node": 1, "validators": [1]}),
        ),
        extra_checks=_check_slashing_pipeline,
    )


def byz_minority_equivocation(seed: int = 0) -> Scenario:
    """Minority equivocation under partition: while one node is partitioned
    off, a byzantine proposer on node 1 double-proposes — the honest block
    to everyone, a conflicting block to half the mesh.  The observed-
    producer cache flags the equivocation, the slasher builds the
    ProposerSlashing, and the pipeline gate asserts conviction while the
    partitioned node still reorgs back and the fleet finalizes."""
    return Scenario(
        name="byz_minority_equivocation",
        description="double-proposing validator during a partition",
        seed=seed, node_count=4, validator_count=16,
        warmup_slots=8, fault_slots=16, recovery_slots=24,
        slasher=True,
        events=(
            Event(0, "partition", {"groups": [[0, 1, 2], [3]]}),
            Event(0, "byzantine",
                  {"strategy": "double_propose", "node": 1,
                   "max_offenses": 2}),
            Event(12, "heal"),
        ),
        extra_checks=_check_slashing_pipeline,
    )


def byz_surround_nonfinality(seed: int = 0) -> Scenario:
    """Surround voter during a non-finality spell: >1/3 of validators go
    offline (finality stalls), and a byzantine validator on node 0 seeds an
    honest vote in one epoch then signs a surrounding (source-1, target+1)
    vote the next.  Detection, gossip, and inclusion all happen while
    finality is stalled; the gate then proves conviction and that finality
    resumed past the window after the nodes return."""
    return Scenario(
        name="byz_surround_nonfinality",
        description="surround vote emitted during a non-finality spell",
        seed=seed, node_count=5, validator_count=20,
        warmup_slots=32, fault_slots=24, recovery_slots=24,
        slasher=True,
        events=(
            Event(0, "kill", {"node": 3}),
            Event(0, "kill", {"node": 4}),
            Event(0, "byzantine",
                  {"strategy": "surround_vote", "node": 0,
                   "validators": [0]}),
            Event(16, "restart", {"node": 3}),
            Event(16, "restart", {"node": 4}),
        ),
        extra_checks=_check_surround_pipeline,
    )


def byz_invalid_block_spam(seed: int = 0) -> Scenario:
    """Invalid-block spammer vs peer scoring: forged blocks that are
    perfectly decodable but consensus-invalid (bad state root, wrong
    proposer, future slot, unknown parent) plus malformed gossip
    (truncated SSZ, broken snappy) flood one node.  Every REJECT path must
    count (``gossip_rejected_total``), score, and graylist the forger —
    with zero effect on honest convergence or finality."""
    return Scenario(
        name="byz_invalid_block_spam",
        description="forged invalid blocks + malformed gossip vs scoring",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=8, recovery_slots=16,
        slasher=True,
        events=(
            # the three deterministic REJECT modes; unknown_parent (also
            # implemented) triggers the sync parent-chase, whose wall-clock
            # retry cadence is not determinism-gate material
            Event(0, "byzantine",
                  {"strategy": "invalid_block", "node": 1, "target": 0,
                   "modes": ["bad_state_root", "wrong_proposer",
                             "future_slot"],
                   "count": 3, "max_offenses": 4}),
            Event(1, "byzantine",
                  {"strategy": "malformed_gossip", "node": 1, "target": 0,
                   "count": 8, "max_offenses": 4}),
        ),
        extra_checks=_check_forgers_penalized,
    )


def byz_slashing_flood(seed: int = 0) -> Scenario:
    """Slashing flood at the op-pool cap: three validators double-vote in
    one window, producing more attester slashings than one block may carry
    (``max_attester_slashings``).  The pool must pack deterministically
    under the cap, spread conviction over several blocks, slash all three,
    and then prune itself empty (dead slashings are dropped)."""
    return Scenario(
        name="byz_slashing_flood",
        description="more slashings than one block can carry",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=7, fault_slots=16, recovery_slots=24,
        slasher=True,
        events=(
            Event(0, "byzantine",
                  {"strategy": "double_vote", "node": 1,
                   "validators": [1, 4, 7], "max_offenses": 3,
                   "burst": True}),
        ),
        extra_checks=_check_slashing_flood,
    )


def byz_invalid_aggregate(seed: int = 0) -> Scenario:
    """Forged ``SignedAggregateAndProof`` wraps vs the aggregate gossip
    rules: HONEST inner attestations (real committee data, a real member's
    signature) wrapped by aggregators that are not in the committee, past
    the registry's end, or simply undecodable SSZ.  Every mode must count
    its REJECT reason on the aggregate topic, score its forger below the
    graylist, and leave honest convergence/finality untouched — the
    aggregate half of the adversarial coverage."""
    return Scenario(
        name="byz_invalid_aggregate",
        description="forged aggregate-and-proof wraps vs gossip validation",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=8, recovery_slots=16,
        slasher=True,
        events=(
            Event(0, "byzantine",
                  {"strategy": "invalid_aggregate", "node": 1, "target": 0,
                   "max_offenses": 2}),
        ),
        extra_checks=_check_aggregate_rejected,
    )


def byz_malformed_sync_contribution(seed: int = 0) -> Scenario:
    """Forged ``SignedContributionAndProof`` messages vs the sync gossip
    rules: contributions at the CURRENT slot (the ±1-slot window IGNOREs
    anything else, proving nothing) with an out-of-range subcommittee, a
    subcommittee the aggregator holds no seat in, zero participation bits,
    or undecodable SSZ.  Counts, graylisting, and untouched honest
    finality gate it — the sync half of the adversarial coverage."""
    return Scenario(
        name="byz_malformed_sync_contribution",
        description="malformed sync contributions vs gossip validation",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=8, recovery_slots=16,
        slasher=True,
        events=(
            Event(0, "byzantine",
                  {"strategy": "malformed_sync_contribution", "node": 1,
                   "target": 0, "max_offenses": 2}),
        ),
        extra_checks=_check_sync_contribution_rejected,
    )


# ------------------------------------------------------- production soaks


def long_horizon_soak(seed: int = 0) -> Scenario:
    """The long-horizon production soak: 128+ epochs of continuous fleet
    operation in minutes of wall time (the virtual clock is what makes the
    horizon affordable), with the whole epoch boundary fused on the device
    backend and a brief partition/heal cycle early in the window.  The
    leak gates then assert the run's residue: bounded rings honored their
    bounds over the whole horizon, counters moved monotonically, and the
    evidence is read back off the blackbox journal itself."""
    return Scenario(
        name="long_horizon_soak",
        description="128-epoch virtual-time soak with leak-check gates",
        seed=seed, node_count=3, validator_count=16,
        warmup_slots=8, fault_slots=8, recovery_slots=1008,
        events=(
            Event(0, "leak_baseline"),
            Event(0, "epoch_device", {"enable": True, "fused": True}),
            Event(2, "partition", {"groups": [[0, 1], [2]]}),
            Event(6, "heal"),
        ),
        extra_checks=_check_long_horizon,
    )


def production_fleet_soak(seed: int = 0) -> Scenario:
    """The production-scale fleet soak: 16 SimNodes sharing thousands of
    validators, every node's duty evaluation riding the device epoch ops
    (shuffling + proposer selection at registry scale), a partition/heal
    cycle mid-window, and the same leak gates as the long-horizon soak.
    Short horizon by design — the axis under test is fleet width and
    registry size, not epoch count.  The run ends at slot 32, the first
    slot at which a minimal-preset chain can finalize (the JAX package's
    12 recovery slots end at slot 24, where finality is still 0, so its
    finality gate cannot pass)."""
    return Scenario(
        name="production_fleet_soak",
        description="16-node fleet at registry scale with leak-check gates",
        seed=seed, node_count=16, validator_count=2048,
        warmup_slots=8, fault_slots=4, recovery_slots=20,
        events=(
            Event(0, "leak_baseline"),
            Event(0, "epoch_device", {"enable": True, "fused": True}),
            Event(1, "partition",
                  {"groups": [list(range(12)), [12, 13, 14, 15]]}),
            Event(3, "heal"),
        ),
        extra_checks=_check_fleet_soak,
    )


# ------------------------------------------------------------ extra checks


def _check_reorg(runner: ScenarioRunner) -> dict:
    """The minority side really forked and really reorged back."""
    forked = max(t["distinct_heads"] for t in runner.timeline)
    assert forked >= 2, "partition never produced distinct heads"
    return {"max_distinct_heads": forked}


def _check_api_load(runner: ScenarioRunner) -> dict:
    """Every probe byte-identical, the cache actually used (hits) and
    actually invalidated by chain traffic — plus one final probe on the
    converged chain."""
    runner._ev_api_probe(label="recovered")
    probes = runner.ctx.get("api_probes") or []
    assert len(probes) >= 3, "api probes did not run"
    for p in probes:
        assert not p["mismatches"], (
            f"cached vs uncached responses diverged: {p['mismatches']}")
    final = probes[-1]["cache"]
    assert final["hits"] > 0, "cache never served a hit"
    assert final["invalidated"] > 0, (
        "head/finalization traffic never invalidated a cache entry")
    # the partition really forked the fleet while we were serving it
    forked = max(t["distinct_heads"] for t in runner.timeline)
    assert forked >= 2, "partition never produced distinct heads"
    return {"api_load": {
        "probes": [{k: p[k] for k in ("label", "n_requests", "digest")}
                   for p in probes],
        "cache": final,
        "max_distinct_heads": forked,
    }}


def _check_stall(runner: ScenarioRunner) -> dict:
    """Finality stalled while >1/3 were offline (the timeline's
    max_finalized must be flat across the first half of the window)."""
    window = runner.timeline[: runner.scenario.fault_slots]
    stalled = window[: 16]
    assert stalled, "no fault-window timeline recorded"
    values = {t["max_finalized_epoch"] for t in stalled}
    assert len(values) == 1, f"finality advanced during the spell: {values}"
    return {"stalled_at_epoch": values.pop()}


def _check_backfill(runner: ScenarioRunner) -> dict:
    sync = runner.ctx.get("backfill")
    assert sync is not None and sync.complete, "backfill did not complete"
    retries = metrics.BACKFILL_BATCH_RETRIES.get(outcome="recovered")
    assert retries >= 1, "dead-peer backfill never exercised the retry path"
    return {"backfill_filled": runner.ctx.get("backfill_filled", 0),
            "backfill_retries_recovered": retries}


def _check_breaker_tripped(runner: ScenarioRunner) -> dict:
    joined = runner.ctx.get("joined")
    assert joined is not None, "join event never ran"
    from . import device_supervisor

    br = device_supervisor.SUPERVISOR.breaker("sha256_pairs")
    snapshot = br.snapshot()
    assert snapshot["trips_total"] >= 1, "breaker never tripped mid-sync"
    return {"breaker": snapshot}


def _check_mesh_resharded(runner: ScenarioRunner) -> dict:
    """The mesh really came up, the killed device really left it, and
    sharded dispatches ran on BOTH topologies (8 before the trip, 7
    after) — otherwise the scenario proved nothing about degradation."""
    from . import device_mesh, device_telemetry

    assert runner.ctx.get("mesh_enabled"), (
        "no device mesh came up — the runner's device has fewer than 2 "
        "mesh members")
    assert runner.ctx.get("mesh_tripped"), "the kill event never tripped"
    snap = device_mesh.summary()
    assert snap["reshards_total"] >= 1, "mesh never resharded"
    # <= rather than ==: an ORGANIC per-device trip on top of the scripted
    # kill (a watchdog timeout under gate-box load is exactly what this
    # layer exists to absorb) must not flake the gate
    assert snap["size"] <= runner.ctx["mesh_size"] - 1, snap
    assert 7 not in snap["devices"], "the killed device rejoined the mesh"
    before = runner.ctx.get("meshes_before_trip", [])
    after = {
        r.get("mesh") for r in device_telemetry.FLIGHT_RECORDER.recent(
            limit=device_telemetry.FLIGHT_RECORDER.capacity, op="sha256_pairs")
        if r.get("mesh")
    }
    assert runner.ctx["mesh_size"] in before, (
        f"no sharded dispatch ran on the full mesh before the kill "
        f"(saw {before})")
    assert any(m < runner.ctx["mesh_size"] for m in after), (
        f"no sharded dispatch ran on a shrunk mesh after the kill "
        f"(saw {sorted(after)})")
    return {"mesh": {k: snap[k] for k in
                     ("size", "full_size", "reshards_total", "generation")},
            "sharded_topologies_before_trip": before,
            "sharded_topologies_after_trip": sorted(after)}


def _check_pipeline_active(runner: ScenarioRunner) -> dict:
    """The pipeline really carried traffic AND the breaker really tripped —
    otherwise the scenario proved nothing about their interplay."""
    from . import device_pipeline, device_supervisor

    snap = device_pipeline.summary()
    assert snap is not None and snap["batches_total"] >= 1, (
        "no verification rode the pipeline")
    br = device_supervisor.SUPERVISOR.breaker("sha256_pairs").snapshot()
    assert br["trips_total"] >= 1, "breaker never tripped mid-sync"
    assert snap["pending_groups"] == 0 and snap["in_flight_groups"] == 0, (
        "pipeline did not drain")
    return {"pipeline": {k: snap[k] for k in
                         ("batches_total", "groups_total", "sets_total")},
            "breaker": br}


def _check_hash_pipeline(runner: ScenarioRunner) -> dict:
    """Tree-hash traffic really rode the hash pipeline, the sha breaker
    really tripped (so breaker-open host routing with futures resolving is
    what the convergence gate certified), and everything drained."""
    from . import device_pipeline, device_supervisor

    snap = device_pipeline.summary()
    assert snap is not None, "no pipeline ever started"
    hash_snap = snap.get("hash")
    assert hash_snap is not None and hash_snap["batches_total"] >= 1, (
        "no pair-hash batch rode the hash pipeline")
    assert hash_snap["pending_groups"] == 0 and \
        hash_snap["in_flight_groups"] == 0, "hash pipeline did not drain"
    br = device_supervisor.SUPERVISOR.breaker("sha256_pairs").snapshot()
    assert br["trips_total"] >= 1, "sha breaker never tripped mid-window"
    grants = snap["arbiter"]["grants"]
    assert grants.get("sha256_pairs", 0) >= 1, (
        f"no sha256_pairs arbiter grant recorded ({grants})")
    return {
        "hash_pipeline": {k: hash_snap[k] for k in
                          ("batches_total", "groups_total", "blocks_total")},
        "arbiter_grants": grants,
        "breaker": br,
    }


def _check_autotune_pinned(runner: ScenarioRunner) -> dict:
    """The pinned decision list really replayed — same sequence, same
    evaluation indices, guardrails live — and the device fault plan really
    bit (so the replay happened under the degraded conditions the scenario
    advertises).  Identity of this evidence ACROSS the two gate runs is
    what the matrix's head comparison certifies."""
    from . import autotune, device_supervisor

    log_ = autotune.CONTROLLER.decision_log()
    applied = [(d["action"], d["bucket"], d["evaluation"], d["outcome"])
               for d in log_ if d.get("knob") == "bucket"]
    # both adoptions meet the sha256_pairs breaker the fault plan tripped
    # OPEN: their warmup dispatch fails, so neither bucket is adopted
    assert applied == [
        ("adopt", 640, 2, "refused_warmup_failed"),
        ("drop", 640, 6, "dropped"),
        ("adopt", 900, 8, "refused_warmup_failed"),
    ], f"pinned replay diverged: {applied}"
    assert all(d.get("via") == "pin" for d in log_), log_
    assert autotune.overlay() == {}, (
        "overlay not empty after the pinned drop")
    # the scenario ran the controller every stepped slot (8 fault + 24
    # recovery), so the pin's indices were all reachable
    assert autotune.CONTROLLER.evaluations >= 10, (
        f"only {autotune.CONTROLLER.evaluations} evaluations ran")
    br = device_supervisor.SUPERVISOR.breaker("sha256_pairs").snapshot()
    assert br["trips_total"] >= 1, "sha breaker never tripped: the fault "\
        "plan did not bite"
    return {
        "autotune": {"decisions": applied,
                     "evaluations": autotune.CONTROLLER.evaluations},
        "breaker": br,
    }


def _check_fused_boundary(runner: ScenarioRunner) -> dict:
    """The fault really bit the fused dispatch (breaker tripped), the
    breaker really recovered once the plan cleared (closed at run end),
    boundary dispatches really reached the device, and the duty caches
    really got primed from the fused result — convergence + finality
    gates having passed is the verdict-identity evidence."""
    from . import device_supervisor, device_telemetry

    br = device_supervisor.SUPERVISOR.breaker("epoch_boundary").snapshot()
    assert br["trips_total"] >= 1, (
        "epoch_boundary breaker never tripped: the fault plan did not bite")
    assert br["state"] == "closed", (
        f"epoch_boundary breaker did not recover after the plan cleared: "
        f"{br}")
    recs = device_telemetry.FLIGHT_RECORDER.recent(
        limit=device_telemetry.FLIGHT_RECORDER.capacity, op="epoch_boundary")
    assert recs, "no fused boundary dispatch ever completed on the device"
    primes = device_telemetry.boundary_prime_counts()
    seeded = sum(v for k, v in primes.items() if k.startswith("seeded:"))
    assert seeded >= 1, (
        f"the fused boundary never seeded a duty cache ({primes})")

    # The black box: the injected fault must have frozen a
    # postmortem bundle at the breaker trip, and the bundle's journal
    # window must show the incident causally — the fault firing BEFORE the
    # breaker transition it caused, with the host-fallback verdict present
    # (the pre-trip fallback is IN the trip-time bundle; the tripping
    # batch's own fallback resolves after the freeze and must appear in
    # the live journal after the transition).
    caps = [c for c in blackbox.captures()
            if c["reason"] == "breaker_open:epoch_boundary"]
    assert caps, "no postmortem bundle captured at the injected fault"
    bundle = None
    for cap in reversed(caps):
        try:
            with open(cap["path"]) as f:
                bundle = json.load(f)
            break
        except (OSError, ValueError):
            continue  # pruned by retention — try the next-newest capture
    assert bundle is not None, "no captured bundle readable from disk"
    window = bundle["journal"]

    def _seqs(pred):
        return [r["seq"] for r in window if pred(r)]

    fault_seqs = _seqs(lambda r: r["source"] == "fault"
                       and r.get("op") == "epoch_boundary")
    open_seqs = _seqs(lambda r: r["source"] == "breaker"
                      and r.get("op") == "epoch_boundary"
                      and r.get("to") == "open")
    fb_seqs = _seqs(lambda r: r["source"] == "supervisor"
                    and r["event"] == "host_fallback"
                    and r.get("op") == "epoch_boundary")
    assert fault_seqs and open_seqs, (
        f"bundle journal missing the incident "
        f"(faults={fault_seqs}, opens={open_seqs})")
    assert min(fault_seqs) < min(open_seqs), (
        "fault firing did not precede the breaker trip in the journal")
    assert fb_seqs, "no host-fallback verdict in the bundle journal"
    # ... and the live journal carries the tripping batch's fallback AFTER
    # the transition: fault -> open -> host_fallback, in seq order.
    live = blackbox.JOURNAL.window()
    live_opens = [r["seq"] for r in live if r["source"] == "breaker"
                  and r.get("op") == "epoch_boundary"
                  and r.get("to") == "open"]
    live_fbs = [r["seq"] for r in live if r["source"] == "supervisor"
                and r["event"] == "host_fallback"
                and r.get("op") == "epoch_boundary"]
    assert live_opens and live_fbs and max(live_fbs) > min(live_opens), (
        "no host-fallback verdict followed the breaker trip in the journal")
    return {"breaker": br,
            "device_boundary_dispatches": len(recs),
            "boundary_primes": primes,
            "postmortem": {
                "captured": True,
                "journal_records": len(window),
                "fault_before_trip": True,
                "host_fallback_records": len(fb_seqs),
            }}


def _check_spammer_penalized(runner: ScenarioRunner) -> dict:
    spammer_id, victim = runner.ctx["spammer"]
    score = victim.node.service.peer_manager._peer(spammer_id).score
    assert score < 0, f"spammer was never penalized (score {score})"
    return {"spammer_score": score}


def _check_slashing_pipeline(runner: ScenarioRunner) -> dict:
    """The end-to-end byzantine gate — see adversary.slashing_pipeline_gate."""
    from .adversary import slashing_pipeline_gate

    return slashing_pipeline_gate(runner)


def _check_surround_pipeline(runner: ScenarioRunner) -> dict:
    """Pipeline gate + the spell really stalled finality (the shared
    ``_check_stall`` assertion) and the conviction really was a surround."""
    gate = _check_slashing_pipeline(runner)
    kinds = {e["strategy"] for e in gate["slashing_pipeline"]}
    assert "surround_vote" in kinds, f"no surround conviction (got {kinds})"
    gate.update(_check_stall(runner))
    return gate


def _check_forgers_penalized(runner: ScenarioRunner) -> dict:
    """Every forger identity scored below the graylist; the REJECT reasons
    all counted; the honest mesh converged regardless (standard gates)."""
    from .network import service as service_mod

    byz = runner.ctx.get("byz")
    assert byz is not None and byz.forger_ids, "no forger ever attacked"
    assert any(o.strategy == "invalid_block" for o in byz.offenses), (
        "no invalid blocks were emitted")
    assert any(o.strategy == "malformed_gossip" for o in byz.offenses), (
        "no malformed gossip was emitted")
    victim = runner._node(0)
    pm = victim.node.service.peer_manager
    forgers = {}
    for forger in byz.forger_ids:
        info = pm.peers.get(forger)
        assert info is not None, f"forger {forger} was never scored"
        forgers[forger] = round(info.score, 1)
        assert info.score < service_mod.GRAYLIST_THRESHOLD, (
            f"forger {forger} not graylisted (score {info.score})")
    # deltas against the controller's creation-time snapshot: the counter is
    # process-cumulative and must not satisfy a later run vacuously
    rejected = {
        "invalid_block": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline, topic="beacon_block",
            reason="invalid_block"),
        "undecodable": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline, topic="beacon_block",
            reason="undecodable"),
        "bad_snappy": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline, topic="attester_slashing",
            reason="bad_snappy"),
    }
    for reason, count in rejected.items():
        assert count >= 1, f"gossip_rejected_total never counted {reason}"
    return {"forger_scores": forgers, "gossip_rejected": rejected}


def _forger_scores_graylisted(runner: ScenarioRunner) -> dict:
    """Every forger identity the controller laundered traffic through must
    have been scored below the graylist on the victim (node 0)."""
    from .network import service as service_mod

    byz = runner.ctx["byz"]
    pm = runner._node(0).node.service.peer_manager
    forgers = {}
    for forger in byz.forger_ids:
        info = pm.peers.get(forger)
        assert info is not None, f"forger {forger} was never scored"
        forgers[forger] = round(info.score, 1)
        assert info.score < service_mod.GRAYLIST_THRESHOLD, (
            f"forger {forger} not graylisted (score {info.score})")
    return forgers


def _check_aggregate_rejected(runner: ScenarioRunner) -> dict:
    """Every forged-aggregate mode REJECTed and counted on the aggregate
    topic, every forger graylisted, honest convergence untouched (the
    runner's standard gates)."""
    from .network import service as service_mod

    byz = runner.ctx.get("byz")
    assert byz is not None and byz.forger_ids, "no forger ever attacked"
    assert any(o.strategy == "invalid_aggregate" for o in byz.offenses), (
        "no forged aggregates were emitted")
    forgers = _forger_scores_graylisted(runner)
    # deltas against the controller's creation-time snapshot — see
    # _check_forgers_penalized.  Both committee-rule modes (outside the
    # committee, index past the registry) land on invalid_attestation;
    # the truncation mode lands on undecodable.
    rejected = {
        "invalid_attestation": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline, topic="beacon_aggregate_and_proof",
            reason="invalid_attestation"),
        "undecodable": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline, topic="beacon_aggregate_and_proof",
            reason="undecodable"),
    }
    for reason, count in rejected.items():
        assert count >= 1, f"gossip_rejected_total never counted {reason}"
    return {"forger_scores": forgers, "gossip_rejected": rejected}


def _check_sync_contribution_rejected(runner: ScenarioRunner) -> dict:
    """Every malformed-contribution mode REJECTed and counted on the sync
    contribution topic, every forger graylisted, honest convergence
    untouched (the runner's standard gates)."""
    from .network import service as service_mod

    byz = runner.ctx.get("byz")
    assert byz is not None and byz.forger_ids, "no forger ever attacked"
    assert any(o.strategy == "malformed_sync_contribution"
               for o in byz.offenses), "no forged contributions were emitted"
    forgers = _forger_scores_graylisted(runner)
    # the three contribution-rule modes (bad subcommittee, no seat in the
    # subcommittee, zero participation) all land on invalid_op; the
    # truncation mode lands on undecodable
    rejected = {
        "invalid_op": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline,
            topic="sync_committee_contribution_and_proof",
            reason="invalid_op"),
        "undecodable": service_mod.GOSSIP_REJECTED.delta(
            byz.rejected_baseline,
            topic="sync_committee_contribution_and_proof",
            reason="undecodable"),
    }
    for reason, count in rejected.items():
        assert count >= 1, f"gossip_rejected_total never counted {reason}"
    return {"forger_scores": forgers, "gossip_rejected": rejected}


def _check_leak_gates(runner: ScenarioRunner) -> dict:
    """The production-soak leak gates.  Each gate reads the same surface
    an operator triages from (``blackbox.summary()``, the flight ring, the
    scoped journals, the metrics registry), diffs it against the
    ``leak_baseline`` snapshot taken at the fault window's start, and
    counts its verdict on ``soak_leak_checks_total`` before the combined
    assert fires — a failed soak still exports which gate leaked."""
    from . import device_telemetry, telemetry_scope as ts

    base = runner.ctx.get("leak_baseline")
    assert base is not None, "no leak_baseline event armed the gates"
    evidence: Dict[str, Any] = {}
    failures: List[str] = []

    def gate(name: str, ok: bool, detail) -> None:
        SOAK_LEAK_CHECKS.inc(gate=name, outcome="passed" if ok else "failed")
        evidence[name] = {"passed": bool(ok), "detail": detail}
        if not ok:
            failures.append(name)

    js = blackbox.summary()["journal"]
    gate("journal_bounded", js["stored"] <= js["capacity"], dict(js))
    gate("journal_monotone",
         js["emitted_total"] >= js["stored"]
         and js["emitted_total"] > base["journal_emitted"],
         {"emitted_total": js["emitted_total"],
          "at_baseline": base["journal_emitted"]})
    ring = device_telemetry.FLIGHT_RECORDER
    flight = {"stored": len(ring), "capacity": ring.capacity,
              "recorded_total": ring.recorded_total}
    gate("flight_ring_bounded", flight["stored"] <= flight["capacity"],
         flight)
    gate("flight_ring_monotone",
         flight["recorded_total"] >= flight["stored"]
         and flight["recorded_total"] >= base["flight_recorded"], flight)
    scoped, scoped_ok = {}, True
    for s in ts.all_scopes():
        j = s.journal
        ok = len(j) <= j.capacity and j.emitted_total >= len(j)
        scoped_ok = scoped_ok and ok
        scoped[s.node_id] = {"stored": len(j), "capacity": j.capacity,
                             "emitted_total": j.emitted_total}
    gate("scoped_journals_bounded", scoped_ok and bool(scoped), scoped)
    regressed: List[str] = []
    with metrics._REGISTRY_LOCK:
        current = {name: m.snapshot()
                   for name, m in metrics._REGISTRY.items()
                   if isinstance(m, metrics.Counter)}
    for name, baseline in sorted(base["counters"].items()):
        now = current.get(name)
        if now is None:
            regressed.append(f"{name}: vanished from the registry")
            continue
        for key, value in baseline.items():
            if now.get(key, 0.0) < value:
                regressed.append(
                    f"{name}{dict(key)}: {now.get(key, 0.0)} < {value}")
    gate("counters_monotone", not regressed,
         regressed or {"counters_checked": len(base["counters"])})
    assert not failures, (
        f"leak gates failed: {failures} — "
        + "; ".join(f"{n}={evidence[n]['detail']}" for n in failures))
    return {"leak_gates": evidence}


def _check_long_horizon(runner: ScenarioRunner) -> dict:
    """Leak gates plus the horizon itself: the fleet really stepped 128+
    epochs of virtual time, heads kept proposing across the whole span,
    and the fused device boundary seeded duty caches throughout."""
    from . import device_telemetry

    out = _check_leak_gates(runner)
    spec = runner.sim.live_nodes[0].harness.spec
    last_slot = runner.timeline[-1]["slot"]
    epochs = last_slot // spec.slots_per_epoch
    assert epochs >= 128, f"soak only reached epoch {epochs}"
    head_slot = runner.sim.live_nodes[0].chain.head_slot()
    assert head_slot >= last_slot - spec.slots_per_epoch, (
        f"head stalled at slot {head_slot} of {last_slot}")
    primes = device_telemetry.boundary_prime_counts()
    seeded = sum(v for k, v in primes.items() if k.startswith("seeded:"))
    assert seeded >= epochs, (
        f"fused boundary seeded {seeded} duty caches over {epochs} epochs")
    out["horizon"] = {"epochs": epochs, "head_slot": head_slot,
                      "boundary_seeded": seeded}
    return out


def _check_fleet_soak(runner: ScenarioRunner) -> dict:
    """Leak gates plus the fleet-scale evidence: all 16 nodes converged
    (standard gates), the registry really was thousands of validators,
    and epoch processing really rode the device backend."""
    from . import device_telemetry

    out = _check_leak_gates(runner)
    sim = runner.sim
    assert len(sim.nodes) >= 16, f"only {len(sim.nodes)} nodes"
    n_validators = len(sim.live_nodes[0].chain.head_state.validators)
    assert n_validators >= 2048, f"only {n_validators} validators"
    primes = device_telemetry.boundary_prime_counts()
    seeded = sum(v for k, v in primes.items() if k.startswith("seeded:"))
    assert seeded >= 1, f"no fused boundary seeded a duty cache ({primes})"
    out["fleet_scale"] = {"nodes": len(sim.nodes),
                          "validators": n_validators,
                          "boundary_seeded": seeded}
    return out


def _check_slashing_flood(runner: ScenarioRunner) -> dict:
    """Pipeline gate for all three offenders + flood-specific evidence: no
    block exceeded max_attester_slashings, conviction took >1 block, and
    every pool pruned itself empty once the offenders were slashed."""
    gate = _check_slashing_pipeline(runner)
    assert len(gate["slashing_pipeline"]) == 3, (
        f"expected 3 convictions, got {len(gate['slashing_pipeline'])}")
    from .adversary import iter_canonical_blocks

    node = runner._node(0)
    chain, spec = node.chain, node.harness.spec
    cap = spec.preset.max_attester_slashings
    blocks_with, total = 0, 0
    for block in iter_canonical_blocks(chain):
        n = len(block.message.body.attester_slashings)
        assert n <= cap, f"block packed {n} slashings (cap {cap})"
        if n:
            blocks_with += 1
            total += n
    assert blocks_with >= 2, (
        "3 slashings against a cap of 2 must spread over >1 block")
    for n_ in runner.sim.live_nodes:
        left = n_.chain.op_pool.num_attester_slashings()
        assert left == 0, (
            f"{n_.peer_id}: {left} dead slashings still pooled after "
            "conviction (prune failed)")
    gate.update({"blocks_with_slashings": blocks_with,
                 "included_slashings_total": total,
                 "per_block_cap": cap})
    return gate


#: name -> factory(seed); the full matrix in documentation order
SCENARIOS: Dict[str, Callable[[int], Scenario]] = {
    "smoke_partition": smoke_partition,
    "api_load": api_load,
    "partition_deep_reorg": partition_deep_reorg,
    "nonfinality_spell": nonfinality_spell,
    "checkpoint_join_lossy": checkpoint_join_lossy,
    "device_breaker_mid_sync": device_breaker_mid_sync,
    "mesh_degradation": mesh_degradation,
    "pipeline_mid_sync": pipeline_mid_sync,
    "state_hash_pipeline": state_hash_pipeline,
    "autotune_pinned": autotune_pinned,
    "fused_epoch_boundary": fused_epoch_boundary,
    "spam_slow_peer": spam_slow_peer,
    "byz_double_vote_smoke": byz_double_vote_smoke,
    "byz_minority_equivocation": byz_minority_equivocation,
    "byz_surround_nonfinality": byz_surround_nonfinality,
    "byz_invalid_block_spam": byz_invalid_block_spam,
    "byz_slashing_flood": byz_slashing_flood,
    "byz_invalid_aggregate": byz_invalid_aggregate,
    "byz_malformed_sync_contribution": byz_malformed_sync_contribution,
    "long_horizon_soak": long_horizon_soak,
    "production_fleet_soak": production_fleet_soak,
}


def run_scenario(name_or_scenario, seed: int = 0,
                 out_dir: Optional[str] = None, device: str = "cuda") -> dict:
    scenario = (SCENARIOS[name_or_scenario](seed)
                if isinstance(name_or_scenario, str) else name_or_scenario)
    return ScenarioRunner(scenario, out_dir=out_dir, device=device).run()


def route_device(device: str) -> None:
    """Point the nodes' module-level routes at ``device``, as ``bn
    --device`` does: tree hashing, the epoch programs and the bucket
    warmups (the scenario's nodes run fake crypto).  ``"cuda"`` raises
    where there is no card."""
    from .consensus import per_epoch
    from .ops import compile_cache, tree_hash
    from .ops.devices import resolve_device

    resolve_device(device)
    tree_hash.configure(enabled=True, device=device)
    per_epoch.configure(backend="device", device=device)
    compile_cache.configure(device=device)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from .crypto.bls.backends import set_backend

    parser = argparse.ArgumentParser(
        description="deterministic multi-node scenario soak")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scenario", choices=sorted(SCENARIOS),
                        help="run one scenario (default: the full matrix)")
    parser.add_argument("--out", default=None, help="artifact directory")
    parser.add_argument("--runs", type=int, default=1,
                        help="repeat each scenario N times and require "
                             "identical final head roots (determinism gate)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device routes' device: cuda (the card, "
                             "the default) or cpu (the kernels' plain "
                             "versions)")
    args = parser.parse_args(argv)

    try:
        route_device(args.device)
    except RuntimeError as e:
        print(f"scenario soak: no CUDA card ({e}); pass --device cpu to run "
              "the kernels' plain versions on the CPU")
        return 2
    set_backend("fake")
    names = [args.scenario] if args.scenario else list(SCENARIOS)
    failures = []
    for name in names:
        heads = []
        for run_index in range(max(1, args.runs)):
            print(f"=== {name} (seed {args.seed}, run {run_index + 1}) ===")
            try:
                artifact = run_scenario(name, seed=args.seed, out_dir=args.out,
                                        device=args.device)
            except Exception as e:  # noqa: BLE001 — report, keep the matrix going
                print(f"FAIL {name}: {e}")
                failures.append(name)
                break
            result = artifact["result"]
            heads.append(result["head_root"])
            print(f"ok {name}: head {result['head_root'][:16]} "
                  f"finalized {result['final_finalized_epoch']} "
                  f"({artifact['duration_s']}s) -> "
                  f"{artifact.get('artifact_path', '-')}")
        if len(set(heads)) > 1:
            print(f"FAIL {name}: nondeterministic heads {heads}")
            failures.append(name)
    if failures:
        print(f"scenario soak: FAILED {sorted(set(failures))}")
        return 1
    print(f"scenario soak: OK ({len(names)} scenarios)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
