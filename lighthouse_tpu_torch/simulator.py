"""In-process multi-node simulator.

The port of ``lighthouse_tpu/simulator.py``.  Its nodes are fake-crypto
harness chains (so the simulator never reaches the Fq kernels); their
tree hashing and epoch programs take the port's module-level routes.

Equivalent of the reference's ``testing/simulator`` (``basic-sim`` /
``fallback-sim``: N in-process beacon nodes + validator clients on one
runtime, liveness checks per epoch — ``checks.rs`` asserts finalization and
sync participation).  Nodes gossip over the in-process hub fabric; each node
owns a disjoint share of the validator keys and performs its duties locally,
publishing blocks and attestations to the others.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import blackbox, telemetry_scope, tracing
from .chain import BeaconChainHarness
from .consensus import helpers as h
from .network.node import LocalNode
from .network.transport import Hub
from .virtual_clock import WAIT_SLICE_S, ensure_clock


#: Slasher history window for simulator nodes — scenarios span a handful of
#: epochs; the production default (4096) would cost ~12 MB of dense arrays
#: per node for nothing.
SIM_SLASHER_HISTORY = 512


def _sim_slasher_kwargs(spec) -> dict:
    from .slasher import SlasherConfig

    return {
        "enable_slasher": True,
        "slasher_config": SlasherConfig(
            history_length=SIM_SLASHER_HISTORY,
            slots_per_epoch=spec.slots_per_epoch,
        ),
    }


class SimNode:
    def __init__(self, *, index: int, hub: Optional[Hub], validator_count: int,
                 keys: List[int], genesis_time: int, spec=None,
                 endpoint=None, chain=None, peer_id: Optional[str] = None,
                 enable_slasher: bool = False, clock=None):
        self.index = index
        self.clock = clock  # callable or None; threaded into peer scoring
        if chain is not None:
            # Chain-only node (checkpoint-sync join): no duty keys, no
            # harness — it follows the chain over gossip/sync.
            self.harness = None
            self._chain = chain
        else:
            self.harness = BeaconChainHarness(
                validator_count=validator_count, fake_crypto=True,
                genesis_time=genesis_time, spec=spec,
            )
            self._chain = self.harness.chain
        self.keys = set(keys)  # validator indices this node runs
        self._keys_mask: Optional[np.ndarray] = None  # bool over validators
        self.alive = True
        pid = peer_id or f"sim{index}"
        self.scope = telemetry_scope.register(telemetry_scope.TelemetryScope(pid))
        self.node = LocalNode(
            hub=hub, peer_id=pid,
            chain=self._chain, harness=self.harness, endpoint=endpoint,
            scope=self.scope, clock=clock,
            **(_sim_slasher_kwargs(self._chain.spec) if enable_slasher else {}),
        )

    @classmethod
    def resurrect(cls, old: "SimNode", *, hub: Hub) -> "SimNode":
        """A restarted node: same chain, same keys, same peer id, fresh
        network stack (the store survived the crash; the socket did not —
        and an in-memory slasher restarts empty, like the process did)."""
        fresh = cls.__new__(cls)
        fresh.index = old.index
        fresh.harness = old.harness
        fresh._chain = old.chain
        fresh.keys = old.keys
        fresh._keys_mask = None
        fresh.alive = True
        fresh.clock = old.clock
        # Fresh scope: a restarted process starts a NEW Lamport clock (and
        # an empty scoped journal) — merge_journals handles the reset via
        # the slot-major merge key.
        fresh.scope = telemetry_scope.register(
            telemetry_scope.TelemetryScope(old.peer_id))
        fresh.node = LocalNode(
            hub=hub, peer_id=old.peer_id, chain=old.chain, harness=old.harness,
            scope=fresh.scope, clock=old.clock,
            **(_sim_slasher_kwargs(old.chain.spec)
               if old.node.slasher is not None else {}),
        )
        return fresh

    @property
    def chain(self):
        return self._chain

    @property
    def peer_id(self) -> str:
        return self.node.peer_id

    def advance_slot(self) -> int:
        """Advance this node's clock one slot (harness nodes run the
        per-slot chain task too; chain-only nodes just move the clock)."""
        if self.harness is not None:
            return self.harness.advance_slot()
        clock = self.chain.slot_clock
        clock.set_slot((clock.now() or 0) + 1)
        return self.chain.current_slot()

    def run_duties(self, slot: int,
                   skip_validators: Optional[set] = None) -> Dict[str, int]:
        """One slot of duties for OUR validators: propose if ours, attest
        with our committee members (published over gossip).
        ``skip_validators``: indices whose honest duties are suppressed this
        slot — the byzantine controller's seam for replacing a validator's
        honest message with a crafted one (adversary.py).  Suppression
        covers the PROPOSAL duty too, deliberately: a suppressed validator's
        proposer slot goes empty (slightly weakening the honest baseline for
        a few slots) rather than interleaving an extra block whose packing
        races the controller's crafted traffic — determinism outranks the
        marginal baseline fidelity here."""
        out = {"proposed": 0, "attested": 0}
        if self.harness is None or not self.keys:
            return out
        # Duties run under this node's telemetry scope: journal records,
        # flight entries, and log lines emitted below land in the per-node
        # views as well as the process-global rings.
        with telemetry_scope.activate(self.scope):
            self._run_duties_scoped(slot, skip_validators or set(), out)
        return out

    def _run_duties_scoped(self, slot: int, skip: set,
                           out: Dict[str, int]) -> None:
        harness, chain = self.harness, self.chain
        spec = harness.spec
        state, parent_root = chain.state_at_slot(slot)
        proposer = h.get_beacon_proposer_index(state, spec)
        # a slashed validator is still SELECTED as proposer but its block
        # would fail process_block_header everywhere — the slot goes empty,
        # exactly as it would on mainnet
        if (proposer in self.keys and proposer not in skip
                and not state.validators[proposer].slashed):
            signed = harness.produce_signed_block(slot=slot)
            root = signed.message.hash_tree_root().hex()
            # publish_block runs INSIDE the proposal span: the outbound
            # envelope's trace context snapshots the active trace id, which
            # is what lets a remote import's resume_remote tree join back
            # to this proposal in the merged fleet artifact.
            with tracing.span("propose_block", slot=int(slot), root=root,
                              node=self.peer_id, proposer=int(proposer)):
                chain.process_block(signed)
                blackbox.emit("fleet", "block_proposed", slot=int(slot),
                              root=root, proposer=int(proposer))
                body = signed.message.body
                n_slashings = (len(body.attester_slashings)
                               + len(body.proposer_slashings))
                if n_slashings:
                    # the causal tail of the slashing pipeline: an offense
                    # on node A precedes this inclusion on node B in the
                    # merged fleet timeline (slot-major merge key)
                    blackbox.emit("fleet", "slashing_included",
                                  slot=int(slot), root=root,
                                  slashings=int(n_slashings))
                self.node.publish_block(signed)
            out["proposed"] = 1
        # committees are epoch-deterministic on the advanced state.  The
        # membership scan is vectorized: one boolean ownership mask over the
        # registry, one fancy-index per committee — the old per-member
        # Python loop was O(nodes x committees x committee_size) per slot,
        # the scale wall at fleet width.  Attestation data is only
        # produced for committees this node actually owns members of, and
        # emission order (committee index ascending, then position
        # ascending) is IDENTICAL to the loop it replaces — the scenario
        # soak's 2-run determinism gate hangs on that.
        epoch = slot // spec.slots_per_epoch
        committees = h.get_committee_count_per_slot(state, epoch, spec)
        own = self._ownership_mask(len(state.validators), skip)
        for index in range(committees):
            committee = np.asarray(
                h.get_beacon_committee(state, slot, index, spec))
            mine = np.nonzero(own[committee])[0]
            if mine.size == 0:
                continue
            data = chain.produce_attestation_data(slot, index)
            for pos in mine:
                pos = int(pos)
                vidx = int(committee[pos])
                bits = [False] * len(committee)
                bits[pos] = True
                sig = harness.sign_attestation_data(state, data, vidx)
                att = harness.types.Attestation(
                    aggregation_bits=bits, data=data, signature=sig.to_bytes()
                )
                try:
                    chain.process_attestation(att)
                except Exception:
                    continue
                self.node.publish_attestation(att)
                out["attested"] += 1

    def _ownership_mask(self, n_validators: int,
                        skip: set) -> np.ndarray:
        """Boolean (n_validators,) mask of validators whose duties this
        node performs this slot: our keys minus the suppressed set.  The
        keys half is cached (the registry only grows); the skip overlay is
        tiny and rebuilt per call."""
        mask = self._keys_mask
        if mask is None or len(mask) < n_validators:
            mask = np.zeros(n_validators, dtype=bool)
            owned = [k for k in self.keys if k < n_validators]
            if owned:
                mask[owned] = True
            self._keys_mask = mask
        own = mask[:n_validators]
        if skip:
            own = own.copy()
            suppressed = [v for v in skip if v < n_validators]
            if suppressed:
                own[suppressed] = False
        return own

    def shutdown(self) -> None:
        # sever the fabric links too: live peers must stop delivering into a
        # dead node's inbound queue (unbounded growth otherwise)
        self.alive = False
        endpoint = self.node.endpoint
        if hasattr(endpoint, "hub"):
            for peer in list(endpoint.connected_peers()):
                endpoint.hub.disconnect(self.node.peer_id, peer)
        self.node.shutdown()
        telemetry_scope.unregister(self.node.peer_id)


class Simulator:
    """N nodes, validators partitioned round-robin.

    ``transport="hub"`` (default) is the in-process fabric; "tcp_secured"
    runs every node on a real TCP endpoint upgraded through the libp2p
    ladder (multistream -> noise -> yamux).  ``discovery="discv5"`` (tcp
    only) has nodes find each other through a discv5 boot node instead of
    an explicit full mesh — the reference simulator's topology built the
    reference way."""

    def __init__(self, *, node_count: int = 3, validator_count: int = 16,
                 genesis_time: int = 1_600_000_000, spec=None,
                 transport: str = "hub", discovery: Optional[str] = None,
                 seed: int = 0, enable_slasher: bool = False,
                 clock=None):
        if transport not in ("hub", "tcp_secured"):
            raise ValueError(f"unknown transport {transport!r}")
        # The control-path clock (virtual_clock.Clock).  None -> WallClock;
        # scenario runs pass a VirtualClock so every deadline, decay, and
        # quiescence window below runs on virtual ticks.  Legacy callables
        # (clock=time.monotonic) are shimmed by ensure_clock.
        self.clock = ensure_clock(clock)
        tcp = transport == "tcp_secured"
        self.genesis_time = genesis_time
        self.validator_count = validator_count
        self.enable_slasher = enable_slasher
        self.nodes: List[SimNode] = []
        self.boot_discv5 = None
        self.hub = None if tcp else Hub(seed=seed)
        if self.hub is not None:
            # ticks = hub ticks: every fabric tick advances the virtual
            # clock (a WallClock advance is a no-op)
            self.hub.on_tick = self.clock.advance
        shares: List[List[int]] = [[] for _ in range(node_count)]
        for v in range(validator_count):
            shares[v % node_count].append(v)

        try:
            for i in range(node_count):
                endpoint = None
                if tcp:
                    from .network.tcp_transport import TcpEndpoint

                    endpoint = TcpEndpoint(f"sim{i}", secured=True)
                self.nodes.append(SimNode(
                    index=i, hub=self.hub, validator_count=validator_count,
                    keys=shares[i], genesis_time=genesis_time, spec=spec,
                    endpoint=endpoint, enable_slasher=enable_slasher,
                    clock=self.clock.now,
                ))
            # topology wiring
            if not tcp:
                for i in range(node_count):
                    for j in range(i + 1, node_count):
                        self.hub.connect(f"sim{i}", f"sim{j}")
            elif discovery == "discv5":
                from .network.discv5 import Discv5Service, KeyPair

                self.boot_discv5 = Discv5Service(KeyPair()).start()
                for n in self.nodes:  # register everyone with the boot node
                    n.node.enable_discv5()
                    n.node.discv5.ping(self.boot_discv5.enr)
                for n in self.nodes:  # then discover + dial over the fabric
                    n.node.discover_peers_discv5([self.boot_discv5.enr],
                                                 max_new=node_count)
            else:
                for i in range(node_count):
                    for j in range(i + 1, node_count):
                        self.nodes[i].node.endpoint.dial(
                            *self.nodes[j].node.endpoint.listen_addr)
        except Exception:
            # wiring failed mid-way: the caller never gets the object, so
            # release every listener/UDP socket/thread created so far
            self.shutdown()
            raise

    @property
    def live_nodes(self) -> List[SimNode]:
        return [n for n in self.nodes if n.alive]

    def run_slot(self, require_converged: bool = True) -> int:
        """Advance every live clock one slot and run all duties; returns the
        slot.  With ``require_converged`` (the happy-path default) raises if
        gossip fails to converge the heads — a divergence would otherwise
        burn the whole run before the final check reports it.  Scenario
        runs pass ``False`` while a fault window is open (partitioned or
        lossy fabrics diverge by design; the convergence GATE runs after
        recovery)."""
        slot = None
        for n in self.live_nodes:
            slot = n.advance_slot()
        for n in self.live_nodes:
            n.run_duties(slot)
            # settle between nodes: whether the NEXT node's attesters see
            # this node's freshly-published block must be a property of
            # the topology, never of thread scheduling (the scenario
            # soak's determinism gate hangs on this)
            self.settle()
        if self.hub is not None:
            # one fabric tick per slot: link-plan latency is slot-granular
            self.hub.advance_tick()
            self.settle()
        # the fabric is quiescent: worker-deferred fleet events are final
        # for this slot — drain them on this (runner) thread
        self.drain_fleet_events()
        if require_converged and not self.wait_converged():
            raise AssertionError(f"heads failed to converge at slot {slot}")
        return slot

    def run_epochs(self, epochs: int, require_converged: bool = True) -> None:
        spe = self.spec.slots_per_epoch
        for _ in range(epochs * spe):
            self.run_slot(require_converged=require_converged)

    @property
    def spec(self):
        for n in self.nodes:
            if n.harness is not None:
                return n.harness.spec
        return self.nodes[0].chain.spec

    def settle(self, timeout: float = 10.0, rounds: int = 2) -> bool:
        """Block until the fabric is quiescent: every live node's inbound
        queue empty, its network loop between envelopes, and its processor
        idle — for ``rounds`` consecutive checks (work can cascade: a
        drained envelope may forward gossip into another node's inbound).

        This, not head equality, is what makes a slot deterministic: the
        next proposer's op pool must hold every attestation the wire
        delivered, or block content races thread scheduling.

        Runs entirely on the injected clock: deadlines are virtual-time
        budgets.  A busy processor is granted a fixed REAL wait slice per
        round (workers need wall time to finish), and the clock is charged
        the equivalent virtual ticks so the budget tracks the waiting
        actually performed — host load can stretch a round's wall time
        without moving the virtual point at which the deadline fires."""
        clock = self.clock
        deadline = clock.now() + timeout
        consecutive = 0
        while consecutive < rounds:
            quiet = True
            for n in self.live_nodes:
                node = n.node
                # unfinished_tasks, not .empty(): the count covers an
                # envelope from the producer's put() until the service
                # loop's task_done() — including the instant it is popped
                # but not yet flagged _processing (the ~1/1000-slot
                # long-horizon determinism race)
                if node.endpoint.inbound.unfinished_tasks or \
                        getattr(node.service, "_processing", False):
                    quiet = False
                if node.sync.busy():  # background lookups still importing
                    quiet = False
                if not node.processor.wait_idle(WAIT_SLICE_S):
                    clock.charge(WAIT_SLICE_S)
                    quiet = False
            if quiet:
                consecutive += 1
            else:
                consecutive = 0
                if clock.now() > deadline:
                    return False
            clock.lull(0.002)
        return True

    def wait_converged(self, timeout: float = 10.0,
                       nodes: Optional[List[SimNode]] = None) -> bool:
        """Wait until every (live) node agrees on the head (gossip settled).
        Pumps the fabric's delayed queue while waiting so plan latency
        cannot deadlock convergence."""
        clock = self.clock
        group = [n for n in (nodes if nodes is not None else self.nodes)
                 if n.alive]
        if not group:
            return True
        deadline = clock.now() + timeout
        while clock.now() < deadline:
            heads = {n.chain.head_root for n in group}
            if len(heads) == 1:
                return True
            for n in group:
                n.node.wait_idle()
            if self.hub is not None and self.hub.pending_delayed():
                self.hub.advance_tick()
            # all idle yet diverged: don't busy-spin until the deadline
            clock.lull(0.05)
        return len({n.chain.head_root for n in group}) == 1

    def drain_fleet_events(self) -> None:
        """Drain worker-deferred fleet journal events into each node's
        scoped journal — on THIS (runner) thread, in stable node order, with
        each scope's stable-sorted batch — so per-node ``seq`` and Lamport
        assignment never depends on worker-thread interleaving (the 2-run
        fleet-timeline determinism gate hangs on this)."""
        for n in sorted(self.live_nodes, key=lambda n: n.peer_id):
            scope = getattr(n, "scope", None)
            if scope is None:
                continue
            events = scope.drain_pending()
            if not events:
                continue
            with telemetry_scope.activate(scope):
                for ev in events:
                    blackbox.emit(ev["source"], ev["event"],
                                  link=ev.get("link"), **ev["fields"])

    # ----------------------------------------------------------- churn

    def kill_node(self, index: int) -> SimNode:
        """Take a node offline (fallback-sim's killed BN): links severed,
        processor down, peer id freed for a later restart."""
        node = self.nodes[index]
        node.shutdown()
        if self.hub is not None:
            self.hub.unregister(node.peer_id)
        return node

    def restart_node(self, index: int) -> SimNode:
        """Bring a killed node back on its own persisted chain: clock
        fast-forwarded to the fleet's slot, fresh network stack, links
        re-dialed — the status handshake then range-syncs it to the head."""
        assert self.hub is not None, "restart is a hub-fabric operation"
        old = self.nodes[index]
        assert not old.alive, f"node {index} is not dead"
        current = max(n.chain.current_slot() for n in self.live_nodes)
        while old.chain.current_slot() < current:
            if old.harness is not None:
                old.harness.advance_slot()
            else:
                old.chain.slot_clock.set_slot(old.chain.current_slot() + 1)
        fresh = SimNode.resurrect(old, hub=self.hub)
        self.nodes[index] = fresh
        for other in self.live_nodes:
            if other is not fresh:
                self.hub.connect(fresh.peer_id, other.peer_id)
        return fresh

    def add_checkpoint_node(self, *, anchor_from: int = 0,
                            peer_id: Optional[str] = None) -> SimNode:
        """A new node joins from a checkpoint anchor (weak subjectivity):
        it boots from ``anchor_from``'s finalized (state, block) pair — no
        genesis replay — and is wired to every live peer; forward sync
        starts on the status handshake, backfill is the caller's second
        step (``BackfillSync``)."""
        assert self.hub is not None, "checkpoint join is a hub-fabric operation"
        from .chain.beacon_chain import BeaconChain
        from .chain.slot_clock import ManualSlotClock

        donor = self.nodes[anchor_from]
        assert donor.harness is not None, "anchor donor must be a full node"
        f_epoch, f_root = donor.chain.finalized_checkpoint()
        assert f_epoch >= 1, "checkpoint join needs a finalized anchor"
        anchor_block = donor.chain.get_block(f_root)
        anchor_state = donor.chain.get_state(f_root).copy()
        clock = ManualSlotClock(self.genesis_time, donor.chain.spec.seconds_per_slot)
        clock.set_slot(donor.chain.current_slot())
        chain = BeaconChain(
            genesis_state=anchor_state, types=donor.harness.types,
            spec=donor.harness.spec, slot_clock=clock,
            anchor_block=anchor_block,
        )
        index = len(self.nodes)
        joined = SimNode(
            index=index, hub=self.hub, validator_count=self.validator_count,
            keys=[], genesis_time=self.genesis_time, chain=chain,
            peer_id=peer_id or f"sim{index}",
            enable_slasher=self.enable_slasher, clock=self.clock.now,
        )
        self.nodes.append(joined)
        for other in self.live_nodes:
            if other is not joined:
                self.hub.connect(joined.peer_id, other.peer_id)
        return joined

    # ------------------------------------------------------------- checks

    def check_finalization(self, min_epoch: int) -> None:
        """The reference's per-epoch liveness check (checks.rs)."""
        for n in self.live_nodes:
            f_epoch, _ = n.chain.finalized_checkpoint()
            assert f_epoch >= min_epoch, (
                f"node {n.index} finalized epoch {f_epoch} < {min_epoch}"
            )

    def check_heads_agree(self) -> None:
        heads = {n.chain.head_root for n in self.live_nodes}
        assert len(heads) == 1, f"heads diverged: {len(heads)} distinct"

    def shutdown(self) -> None:
        for n in self.nodes:
            if n.alive:
                n.shutdown()
        if self.boot_discv5 is not None:
            self.boot_discv5.stop()
