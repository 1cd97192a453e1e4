"""Byzantine actor layer for the scenario soak engine.

The port of ``lighthouse_tpu/adversary.py``.

The fault fabric (``network/transport.py``) models lossy LINKS; this module
models lying PEERS: a :class:`ByzantineController` drives a configurable
subset of a node's validators through misbehavior strategies —

- ``double_propose``: two distinct signed blocks for one slot, the second
  delivered to a deterministic half of the mesh only;
- ``double_vote``: two attestations for the same target with different head
  roots;
- ``surround_vote``: an attestation whose (source, target) surrounds the
  validator's previous honest vote (seeded one epoch, sprung the next);
- ``invalid_block``: structurally valid SSZ carrying consensus-invalid
  content (bad state root, wrong proposer, future slot, unknown parent);
- ``malformed_gossip``: truncated SSZ / corrupted snappy on real topics;
- ``invalid_aggregate``: ``SignedAggregateAndProof`` wraps around an
  HONEST inner attestation whose aggregator fails the gossip rules (not
  in the committee, index out of the registry, undecodable SSZ);
- ``malformed_sync_contribution``: ``SignedContributionAndProof`` at the
  current slot whose contribution fails the sync gossip rules (bad or
  mismatched subcommittee, zero participation bits, undecodable SSZ).

Slashable messages are signed through the EXPLICIT unsafe seam on
:class:`~.validator_client.validator_store.ValidatorStore`
(``sign_*_unsafe``) — and before every unsafe signature the controller
proves the honest path still vetoes it (``veto_asserted`` in the evidence),
so the byzantine layer doubles as a live EIP-3076 regression.

Every byzantine decision is keyed on
``sha256(seed | strategy | slot | validator)`` — the same discipline as the
link fault fabric — so two runs with one seed misbehave identically and the
scenario matrix's 2-run determinism gate covers the adversary too.

The other half of the module is the **slashing pipeline gate**
(:func:`slashing_pipeline_gate`): scenario-level proof that within the run,
offense → slasher detection → gossiped slashing → op-pool packing → block
inclusion → ``state.validators[idx].slashed`` → fork-choice equivocation
mask all happened, while the honest majority's convergence/finality gates
(the runner's standard ones) still hold.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from . import metrics
from .consensus import helpers as h
from .logs import get_logger
from .network import topics as topics_mod
from .op_pool import attester_slashing_indices
from .network.snappy_codec import compress
from .network.transport import Envelope
from .validator_client.slashing_protection import SlashingProtectionError
from .validator_client.validator_store import ValidatorStore

log = get_logger("adversary")

BYZANTINE_OFFENSES = metrics.counter(
    "byzantine_offenses_total",
    "adversarial offenses emitted by the byzantine controller, by strategy",
)

#: Strategies that produce a slashable offense with a named offender (the
#: slashing pipeline gate asserts end-to-end conviction for these).
SLASHABLE_STRATEGIES = ("double_propose", "double_vote", "surround_vote")


class ByzantineSetupError(AssertionError):
    """The controller could not misbehave as armed — e.g. the honest-path
    veto it must first assert did NOT fire (a slashing-protection
    regression), or the scenario armed an impossible spec."""


@dataclass
class Offense:
    strategy: str
    slot: int
    validator: Optional[int] = None
    detail: str = ""
    #: first slot any honest node's op pool held a slashing convicting the
    #: offender (the DETECTION edge of the pipeline)
    detected_slot: Optional[int] = None
    #: first slot the offender showed ``slashed=True`` in an honest head
    #: state (the INCLUSION edge)
    included_slot: Optional[int] = None

    def to_dict(self) -> dict:
        out = {
            "strategy": self.strategy, "slot": self.slot,
            "validator": self.validator, "detail": self.detail,
            "detected_slot": self.detected_slot,
            "included_slot": self.included_slot,
        }
        if self.validator is not None:
            if self.detected_slot is not None:
                out["detection_latency_slots"] = self.detected_slot - self.slot
            if self.included_slot is not None:
                out["inclusion_latency_slots"] = self.included_slot - self.slot
        return out


class ByzantineController:
    """Drives armed misbehavior strategies against a live :class:`Simulator`.

    Lifecycle (wired by ``ScenarioRunner._step_slot``): ``pre_duties(slot)``
    fires before honest duties (invalid-block forgery wants the slot's real
    block to not exist yet), ``suppressed_for(node)`` removes byzantine
    validators' honest messages where a strategy replaces them,
    ``act(slot)`` fires after duties settle (equivocations ride on top of
    the honest message), ``observe_slot(slot)`` probes detection/inclusion
    evidence every slot — including recovery, after ``deactivate()`` stops
    emission."""

    def __init__(self, sim, seed: int):
        from .network.service import GOSSIP_REJECTED

        self.sim = sim
        self.seed = seed
        self.active = True
        self.offenses: List[Offense] = []
        self.veto_asserted = 0
        self._armed: List[dict] = []
        self._suppress: Dict[int, Set[int]] = {}  # node index -> validators
        self._stores: Dict[int, ValidatorStore] = {}
        self.forger_ids: List[str] = []
        self._forger_endpoints: Dict[str, object] = {}
        # metric counters are process-cumulative; the gates must assert on
        # THIS run's increments or a second run in the same process passes
        # vacuously on the first run's counts
        self.slashings_baseline = metrics.SLASHER_SLASHINGS.snapshot()
        self.rejected_baseline = GOSSIP_REJECTED.snapshot()

    # ------------------------------------------------------------- plumbing

    def _digest(self, *parts) -> bytes:
        raw = "|".join(str(p) for p in (self.seed, *parts)).encode()
        return hashlib.sha256(raw).digest()

    def _node(self, index: int):
        node = self.sim.nodes[index]
        return node if node.alive else None

    def _store(self, node) -> ValidatorStore:
        """A real ValidatorStore (with a live EIP-3076 DB) mirroring the
        byzantine node's validators — the seam every slashable signature
        must squeeze through."""
        store = self._stores.get(node.index)
        if store is None:
            harness = node.harness
            store = ValidatorStore(
                keys=[] if harness.fake_crypto else list(harness.keys),
                spec=harness.spec,
                genesis_validators_root=bytes(
                    harness.chain.genesis_state.genesis_validators_root),
                fake_signatures=harness.fake_crypto,
            )
            self._stores[node.index] = store
        return store

    @staticmethod
    def _pubkey(node, validator: int) -> bytes:
        return bytes(node.chain.genesis_state.validators[validator].pubkey)

    def _assert_veto(self, fn, what: str) -> None:
        """The honest signing path MUST refuse the slashable message; only
        then is the unsafe seam allowed to produce it."""
        try:
            fn()
        except SlashingProtectionError:
            self.veto_asserted += 1
            return
        raise ByzantineSetupError(
            f"EIP-3076 veto did not fire for {what} — the honest path would "
            "have signed a slashable message")

    def _send_gossip(self, endpoint, sender: str, peers, topic: str,
                     payload: bytes) -> int:
        env = Envelope(kind="gossip", sender=sender, topic=topic,
                       data=payload)
        n = 0
        for peer in peers:
            if endpoint.send(peer, env):
                n += 1
        return n

    def _other_peers(self, node) -> List[str]:
        return sorted(n.peer_id for n in self.sim.live_nodes if n is not node)

    def _half_of(self, peers: List[str], digest: bytes) -> List[str]:
        """A deterministic ceil-half of ``peers`` (mesh-half targeting for
        equivocations).  Ceil, not floor: with 3 peers one of which may be
        partitioned away, any 2-subset still reaches a connected peer — an
        equivocation nobody can see proves nothing."""
        if len(peers) <= 1:
            return list(peers)
        rot = digest[0] % len(peers)
        rotated = peers[rot:] + peers[:rot]
        return rotated[: (len(peers) + 1) // 2]

    def _record(self, strategy: str, slot: int, validator: Optional[int],
                detail: str) -> None:
        self.offenses.append(Offense(strategy, slot, validator, detail))
        BYZANTINE_OFFENSES.inc(strategy=strategy)
        log.warning("byzantine offense emitted", strategy=strategy,
                    slot=slot, validator=validator, detail=detail)

    def _forger(self, victim_peer: str) -> Tuple[str, object]:
        """An ephemeral hub peer to launder forged traffic through (invalid
        blocks / malformed gossip should score against a spammer identity,
        not desync the real byzantine node's mesh standing).

        The forger ANSWERS inbound RPC instead of going mute: a mute peer
        leaves the victim's STATUS dial blocking a worker for the full 5 s
        request timeout, and two such wall-clock windows overlapping is
        enough batching-composition drift to break the determinism gate.
        STATUS echoes the victim's own view (so no sync ever triggers);
        everything else gets an immediate empty stream."""
        import queue as queue_mod

        from .network import rpc as rpc_mod
        from .network.transport import Envelope

        forger_id = f"byz{len(self.forger_ids)}"
        endpoint = self.sim.hub.register(forger_id)
        self.forger_ids.append(forger_id)
        self._forger_endpoints[forger_id] = endpoint
        victim = next(n for n in self.sim.nodes if n.peer_id == victim_peer)

        def serve() -> None:
            while forger_id in self._forger_endpoints:
                try:
                    env = endpoint.inbound.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                if env is None or env.kind != "rpc_request":
                    continue
                chunks = []
                if env.protocol == rpc_mod.STATUS:
                    try:
                        status = victim.node.router.local_status()
                        chunks.append(rpc_mod.encode_response_chunk(
                            rpc_mod.SUCCESS, status.to_bytes()))
                    except Exception:
                        pass
                for data in (*chunks, b""):  # chunks + end-of-stream marker
                    endpoint.send(env.sender, Envelope(
                        kind="rpc_response", sender=forger_id,
                        request_id=env.request_id, data=data))

        threading.Thread(target=serve, daemon=True,
                         name=f"adversary-{forger_id}").start()
        self.sim.hub.connect(forger_id, victim_peer)
        return forger_id, endpoint

    # ------------------------------------------------------------ arming

    #: strategies whose armed validators stop performing honest attestation
    #: duties — the controller emits their (honest + crafted) votes itself,
    #: so message content and ordering are fully deterministic
    _SUPPRESSING = ("double_vote", "surround_vote")

    def arm(self, strategy: str, node: int, validators=None,
            max_offenses: int = 1, **kwargs) -> None:
        handler = getattr(self, f"_act_{strategy}", None)
        pre = getattr(self, f"_pre_{strategy}", None)
        if handler is None and pre is None:
            raise ValueError(f"unknown byzantine strategy {strategy!r}")
        vset = None if validators is None else {int(v) for v in validators}
        self._armed.append({
            "strategy": strategy, "node": node, "validators": vset,
            "max_offenses": max_offenses, "emitted": 0,
            "kwargs": kwargs, "state": {},
        })
        if strategy in self._SUPPRESSING:
            owned = set(self.sim.nodes[node].keys)
            self._suppress.setdefault(node, set()).update(
                owned if vset is None else (vset & owned))
        log.info("byzantine strategy armed", strategy=strategy, node=node,
                 validators=sorted(validators) if validators else "all")

    def deactivate(self) -> None:
        """End of the fault window: stop emitting, lift every suppression
        (observation continues through recovery)."""
        self.active = False
        self._suppress.clear()

    def cleanup(self) -> None:
        self._forger_endpoints.clear()  # stops the forger responder threads
        for forger in self.forger_ids:
            try:
                self.sim.hub.unregister(forger)
            except Exception:
                pass

    # ------------------------------------------------------ runner hooks

    def suppressed_for(self, node) -> Optional[Set[int]]:
        if not self.active:
            return None
        return self._suppress.get(node.index)

    def _dispatch(self, phase: str, slot: int) -> None:
        if not self.active:
            return
        for spec in self._armed:
            if spec["emitted"] >= spec["max_offenses"]:
                continue
            handler = getattr(self, f"_{phase}_{spec['strategy']}", None)
            if handler is not None:
                handler(spec, slot)

    def pre_duties(self, slot: int) -> None:
        """Before honest duties: forged-content strategies fire here, while
        the slot's real block does not exist yet (so a forgery can never
        collide with an honest (slot, proposer) observation and brand an
        honest proposer an equivocator)."""
        self._dispatch("pre", slot)

    def act(self, slot: int) -> None:
        """After honest duties settle: equivocation strategies ride on top
        of the honest message that was just published."""
        self._dispatch("act", slot)

    # ----------------------------------------------------- double propose

    def _act_double_propose(self, spec: dict, slot: int) -> None:
        node = self._node(spec["node"])
        if node is None or node.harness is None:
            return
        chain = node.chain
        if chain.head_slot() != slot:
            return  # this slot's proposer was not ours (or slot skipped)
        head_block = chain.get_block(chain.head_root)
        proposer = int(head_block.message.proposer_index)
        allowed = spec["validators"]
        if proposer not in node.keys or (
                allowed is not None and proposer not in allowed):
            return
        digest = self._digest("double_propose", slot, proposer)
        conflicting = node.harness.produce_signed_block(
            slot=slot, parent_root=bytes(head_block.message.parent_root),
            graffiti=digest,
        )
        store, pk = self._store(node), self._pubkey(node, proposer)
        store.sign_block(pk, head_block.message)  # mirror the honest block
        self._assert_veto(
            lambda: store.sign_block(pk, conflicting.message),
            f"double proposal at slot {slot}")
        signed_cls = node.harness.types.signed_block[
            type(conflicting.message).fork_name]
        equivocation = signed_cls(
            message=conflicting.message,
            signature=store.sign_block_unsafe(pk, conflicting.message),
        )
        # The honest block already reached everyone; the conflict goes to a
        # deterministic half of the mesh only — via a sybil relay identity.
        # (Any peer can relay a block; the equivocation REJECT penalty lands
        # on the relay, not on the byzantine node's mesh standing — whose
        # -10-per-offense score would otherwise hover exactly at the
        # disconnect threshold, where wall-clock score decay decides.)
        peers = self._half_of(self._other_peers(node), digest)
        st = spec["state"]
        if "forger" not in st:
            st["forger"], st["endpoint"] = self._forger(peers[0])
            st["connected"] = {peers[0]}
        for peer in peers:
            if peer not in st["connected"]:
                # connect() re-fires on_connect (and a 5 s status dial at a
                # mute peer) even for existing links — dial each peer once
                self.sim.hub.connect(st["forger"], peer)
                st["connected"].add(peer)
        topic = str(topics_mod.GossipTopic(
            node.node.router.fork_digest, topics_mod.BEACON_BLOCK))
        self._send_gossip(st["endpoint"], st["forger"], peers, topic,
                          compress(equivocation.as_ssz_bytes()))
        spec["emitted"] += 1
        self._record("double_propose", slot, proposer,
                     f"conflict to {len(peers)}/{len(self._other_peers(node))} peers")

    # -------------------------------------------------------- double vote

    def _committee_duty(self, node, slot: int, allowed: Optional[Set[int]]):
        """(validator, committee_index, position, committee) of the first
        armed validator with a committee seat this slot, or None."""
        chain, spec = node.chain, node.harness.spec
        state = chain.head_state
        epoch = slot // spec.slots_per_epoch
        committees = h.get_committee_count_per_slot(state, epoch, spec)
        for index in range(committees):
            committee = h.get_beacon_committee(state, slot, index, spec)
            for pos, vidx in enumerate(committee):
                v = int(vidx)
                if v not in node.keys:
                    continue
                if allowed is not None and v not in allowed:
                    continue
                return v, index, pos, committee
        return None

    def _build_attestation(self, node, data, committee_index: int, pos: int,
                           committee, signature: bytes):
        """``committee_index`` must be passed explicitly: post-electra the
        DATA's index is always 0 (EIP-7549) and the real committee rides in
        committee_bits — reading it back off ``data.index`` would convict
        committee 0's validators instead."""
        types, spec = node.harness.types, node.harness.spec
        bits = [False] * len(committee)
        bits[pos] = True
        if spec.fork_name_at_slot(int(data.slot)) == "electra":
            committee_bits = [False] * spec.preset.max_committees_per_slot
            committee_bits[int(committee_index)] = True
            return types.AttestationElectra(
                aggregation_bits=bits, data=data, signature=signature,
                committee_bits=committee_bits)
        return types.Attestation(
            aggregation_bits=bits, data=data, signature=signature)

    def _publish_attestation(self, node, attestation, peers=None) -> None:
        chain = node.chain
        committee_bits = getattr(attestation, "committee_bits", None)
        committee_index = (
            next(i for i, b in enumerate(committee_bits) if b)
            if committee_bits is not None  # electra: data.index is always 0
            else int(attestation.data.index))
        subnet = topics_mod.compute_subnet_for_attestation(
            chain.head_state, int(attestation.data.slot),
            committee_index, node.harness.spec)
        topic = str(topics_mod.attestation_subnet_topic(
            node.node.router.fork_digest, subnet))
        self._send_gossip(
            node.node.endpoint, node.peer_id,
            peers if peers is not None else self._other_peers(node),
            topic, compress(attestation.as_ssz_bytes()))

    def _attestation_data_at(self, node, duty_slot: int, index: int):
        """AttestationData for a validator's duty slot EARLIER in the
        current epoch — head root is the canonical block at that slot (an
        attestation's head must not be newer than its slot), source/target
        are epoch-stable so the head state's view is correct."""
        chain, sp, types = node.chain, node.harness.spec, node.harness.types
        state = chain.head_state
        epoch = duty_slot // sp.slots_per_epoch
        head_at = chain.block_root_at_slot(duty_slot)
        return types.AttestationData(
            slot=duty_slot,
            index=0 if sp.fork_name_at_slot(duty_slot) == "electra" else index,
            beacon_block_root=head_at,
            source=state.current_justified_checkpoint.copy(),
            target=types.Checkpoint(
                epoch=epoch, root=h.get_block_root(state, epoch, sp)),
        )

    def _duty_slot_in_epoch(self, node, validator: int, first_slot: int,
                            last_slot: int):
        """(duty_slot, committee_index, position, committee) of
        ``validator`` within [first_slot, last_slot], or None."""
        chain, sp = node.chain, node.harness.spec
        state = chain.head_state
        for s in range(first_slot, last_slot + 1):
            committees = h.get_committee_count_per_slot(
                state, s // sp.slots_per_epoch, sp)
            for index in range(committees):
                committee = h.get_beacon_committee(state, s, index, sp)
                for pos, vidx in enumerate(committee):
                    if int(vidx) == validator:
                        return s, index, pos, committee
        return None

    def _emit_vote_pair(self, node, v: int, honest, committee_index: int,
                        pos: int, committee, slot: int) -> None:
        """Sign (honest path) + publish the honest vote, then veto-assert
        and publish the same-target conflicting double."""
        double = self._double_of(node, honest)
        store, pk = self._store(node), self._pubkey(node, v)
        honest_att = self._build_attestation(
            node, honest, committee_index, pos, committee,
            store.sign_attestation(pk, honest))
        self._assert_veto(
            lambda: store.sign_attestation(pk, double),
            f"double vote by validator {v} at target "
            f"{int(honest.target.epoch)}")
        double_att = self._build_attestation(
            node, double, committee_index, pos, committee,
            store.sign_attestation_unsafe(pk, double))
        self._publish_attestation(node, honest_att)
        self._publish_attestation(node, double_att)
        self._record("double_vote", slot, v,
                     f"target {int(honest.target.epoch)} data "
                     f"{honest.hash_tree_root().hex()[:8]}/"
                     f"{double.hash_tree_root().hex()[:8]}")

    def _double_of(self, node, honest):
        """A same-target AttestationData ≠ ``honest`` that every honest node
        still fully processes: vote the target checkpoint block as head when
        the honest head is newer (a real fork's double), else keep the head
        and vary the SOURCE root (gossip never validates the source — only
        block packing does).  A fabricated head root would park in the
        unknown-head queue; a pre-boundary head would fail fork choice's
        target-ancestor check — either way no slasher would ever see it."""
        types = node.harness.types
        head_root = bytes(honest.beacon_block_root)
        target_root = bytes(honest.target.root)
        if head_root != target_root:
            return types.AttestationData(
                slot=honest.slot, index=honest.index,
                beacon_block_root=target_root,
                source=honest.source, target=honest.target,
            )
        src = bytes(honest.source.root)
        return types.AttestationData(
            slot=honest.slot, index=honest.index,
            beacon_block_root=honest.beacon_block_root,
            source=types.Checkpoint(
                epoch=honest.source.epoch,
                root=bytes([src[0] ^ 0xFF]) + src[1:]),
            target=honest.target,
        )

    def _act_double_vote(self, spec: dict, slot: int) -> None:
        """The armed validators' honest duties are suppressed (see ``arm``);
        the controller emits the honest vote AND a same-target different-head
        vote itself, in that order — everyone's slasher sees the pair.

        Default: one pair at the armed validator's own duty slot.  With
        ``burst=True`` every armed validator's pair is emitted together at
        the LAST slot of the epoch (back-dated to each duty slot), so all
        the resulting slashings hit the op pool simultaneously and the
        per-block ``max_attester_slashings`` cap is genuinely exercised."""
        node = self._node(spec["node"])
        if node is None or node.harness is None:
            return
        sp = node.harness.spec
        if spec["kwargs"].get("burst"):
            if (slot + 1) % sp.slots_per_epoch != 0:
                return  # burst fires once, at the epoch's last slot
            epoch_start = (slot // sp.slots_per_epoch) * sp.slots_per_epoch
            armed = sorted(spec["validators"]
                           if spec["validators"] is not None
                           else node.keys)
            for v in armed:
                duty = self._duty_slot_in_epoch(node, v, epoch_start, slot)
                if duty is None:
                    continue
                duty_slot, index, pos, committee = duty
                honest = self._attestation_data_at(node, duty_slot, index)
                self._emit_vote_pair(node, v, honest, index, pos, committee,
                                     slot)
                self._suppress.get(node.index, set()).discard(v)
                if spec["validators"] is not None:
                    spec["validators"].discard(v)
                spec["emitted"] += 1
                if spec["emitted"] >= spec["max_offenses"]:
                    break
            return
        duty = self._committee_duty(node, slot, spec["validators"])
        if duty is None:
            return
        v, index, pos, committee = duty
        honest = node.chain.produce_attestation_data(slot, index)
        self._emit_vote_pair(node, v, honest, index, pos, committee, slot)
        self._suppress.get(node.index, set()).discard(v)
        if spec["validators"] is not None:
            spec["validators"].discard(v)  # one offense per validator
        spec["emitted"] += 1

    # ------------------------------------------------------ surround vote

    def _act_surround_vote(self, spec: dict, slot: int) -> None:
        """Two-phase: epoch E the controller emits the validator's honest
        vote (source j) — recorded by every slasher; epoch E+1 it emits a
        crafted (j-1, E+1) vote instead, which surrounds (j, E).  The
        validator's duty-loop votes are suppressed throughout (see ``arm``)
        so the controller owns exactly what this validator signs."""
        node = self._node(spec["node"])
        if node is None or node.harness is None:
            return
        sp = node.harness.spec
        epoch = slot // sp.slots_per_epoch
        st = spec["state"]
        if "old" not in st:
            duty = self._committee_duty(node, slot, spec["validators"])
            if duty is None:
                return
            v, index, pos, committee = duty
            honest = node.chain.produce_attestation_data(slot, index)
            if int(honest.source.epoch) < 1:
                return  # need an earlier checkpoint to dip under
            st["old"] = (int(honest.source.epoch), int(honest.target.epoch))
            st["validator"] = v
            st["seed_epoch"] = epoch
            store, pk = self._store(node), self._pubkey(node, v)
            self._publish_attestation(node, self._build_attestation(
                node, honest, index, pos, committee,
                store.sign_attestation(pk, honest)))
            log.info("surround voter seeded", validator=v,
                     source=st["old"][0], target=st["old"][1])
            return
        if epoch <= st["seed_epoch"]:
            return
        v = st["validator"]
        duty = self._committee_duty(node, slot, {v})
        if duty is None:
            return  # v's duty slot of this epoch not reached yet
        _v, index, pos, committee = duty
        chain, types = node.chain, node.harness.types
        honest_now = chain.produce_attestation_data(slot, index)
        old_source, old_target = st["old"]
        new_source = old_source - 1
        surround = types.AttestationData(
            slot=honest_now.slot, index=honest_now.index,
            beacon_block_root=honest_now.beacon_block_root,
            source=types.Checkpoint(
                epoch=new_source,
                root=h.get_block_root(chain.head_state, new_source, sp)),
            target=honest_now.target,
        )
        store, pk = self._store(node), self._pubkey(node, v)
        self._assert_veto(
            lambda: store.sign_attestation(pk, surround),
            f"surround vote ({new_source},{int(surround.target.epoch)}) ⊃ "
            f"({old_source},{old_target}) by validator {v}")
        attestation = self._build_attestation(
            node, surround, index, pos, committee,
            store.sign_attestation_unsafe(pk, surround))
        self._publish_attestation(node, attestation)
        self._suppress.get(node.index, set()).discard(v)
        spec["emitted"] += 1
        self._record(
            "surround_vote", slot, v,
            f"({new_source},{int(surround.target.epoch)}) surrounds "
            f"({old_source},{old_target})")

    # ------------------------------------------------------ invalid block

    INVALID_MODES = ("bad_state_root", "wrong_proposer", "future_slot",
                     "unknown_parent")

    def _pre_invalid_block(self, spec: dict, slot: int) -> None:
        """Fires BEFORE honest duties: the forged blocks claim the current
        slot while its real block does not exist yet, so ``bad_state_root``
        reaches the state-transition REJECT instead of the equivocation
        branch (observe-after-verify keeps the later honest block clean)."""
        source = self._node(spec["node"])
        if source is None or source.harness is None:
            return
        target_index = spec["kwargs"].get("target", 0)
        victim = self._node(target_index)
        if victim is None:
            return
        st = spec["state"]
        if "forger" not in st:
            st["forger"], st["endpoint"] = self._forger(victim.peer_id)
        modes = spec["kwargs"].get("modes", list(self.INVALID_MODES))
        count = spec["kwargs"].get("count", len(modes))
        chain = source.chain
        parent_root = chain.head_root
        head_state = chain.head_state
        topic = str(topics_mod.GossipTopic(
            source.node.router.fork_digest, topics_mod.BEACON_BLOCK))
        sent = []
        for i in range(count):
            mode = modes[i % len(modes)]
            digest = self._digest("invalid_block", slot, mode, i)
            base = source.harness.produce_signed_block(
                slot=slot, parent_root=parent_root, graffiti=digest)
            msg = base.message.copy()
            if mode == "bad_state_root":
                msg.state_root = digest
            elif mode == "wrong_proposer":
                msg.proposer_index = (
                    int(msg.proposer_index) + 1) % len(head_state.validators)
            elif mode == "future_slot":
                msg.slot = slot + 2
            elif mode == "unknown_parent":
                msg.parent_root = digest
            else:
                raise ValueError(f"unknown invalid_block mode {mode!r}")
            signed_cls = source.harness.types.signed_block[
                type(msg).fork_name]
            forged = signed_cls(message=msg, signature=base.signature)
            payload = compress(forged.as_ssz_bytes())
            if mode == "unknown_parent":
                # must come from a real node: the victim's parent-chase asks
                # the SENDER, and a serving router answers "not found" fast
                # (a mute forger would stall the lookup on its timeout)
                self._send_gossip(source.node.endpoint, source.peer_id,
                                  [victim.peer_id], topic, payload)
            else:
                self._send_gossip(st["endpoint"], st["forger"],
                                  [victim.peer_id], topic, payload)
            sent.append(mode)
        spec["emitted"] += 1
        self._record("invalid_block", slot, None,
                     f"{len(sent)} forged blocks at {victim.peer_id} "
                     f"({','.join(sorted(set(sent)))})")

    # --------------------------------------------------- malformed gossip

    def _act_malformed_gossip(self, spec: dict, slot: int) -> None:
        source = self._node(spec["node"])
        if source is None or source.harness is None:
            return
        victim = self._node(spec["kwargs"].get("target", 0))
        if victim is None:
            return
        st = spec["state"]
        if "forger" not in st:
            st["forger"], st["endpoint"] = self._forger(victim.peer_id)
        count = spec["kwargs"].get("count", 8)
        digest_topics = [topics_mod.BEACON_BLOCK,
                         topics_mod.ATTESTER_SLASHING,
                         topics_mod.PROPOSER_SLASHING,
                         topics_mod.VOLUNTARY_EXIT]
        head_block = source.chain.get_block(source.chain.head_root)
        real_ssz = head_block.as_ssz_bytes()
        for i in range(count):
            digest = self._digest("malformed_gossip", slot, i)
            kind = digest_topics[i % len(digest_topics)]
            topic = str(topics_mod.GossipTopic(
                source.node.router.fork_digest, kind))
            if i % 2 == 0:
                # decodable snappy, truncated/garbled SSZ → router REJECT
                cut = 1 + digest[1] % max(1, len(real_ssz) - 1)
                payload = compress(real_ssz[:cut] + digest)
            else:
                # broken snappy → service-level REJECT
                payload = digest * (1 + digest[2] % 4)
            self._send_gossip(st["endpoint"], st["forger"],
                              [victim.peer_id], topic, payload)
        spec["emitted"] += 1
        self._record("malformed_gossip", slot, None,
                     f"{count} malformed messages at {victim.peer_id}")

    # -------------------------------------------------- invalid aggregate

    AGGREGATE_MODES = ("not_in_committee", "aggregator_out_of_range",
                       "undecodable")

    def _act_invalid_aggregate(self, spec: dict, slot: int) -> None:
        """``SignedAggregateAndProof`` wraps that fail the aggregate gossip
        rules.  The INNER attestation is honest (real committee data, a real
        member's signature) — the attack is the wrap, so the victim must
        reach the aggregate-specific checks in ``preverify_aggregate``
        rather than bounce off the inner preverify.  Each mode launders
        through its OWN forger identity: reject penalties graylist a forger
        after a couple of hits, and a shared forger would have later modes'
        traffic silently dropped instead of rejected (the per-reason metric
        gates need every mode to actually reach validation)."""
        source = self._node(spec["node"])
        if source is None or source.harness is None:
            return
        victim = self._node(spec["kwargs"].get("target", 0))
        if victim is None:
            return
        chain, sp = source.chain, source.harness.spec
        types = source.harness.types
        state = chain.head_state
        committee = h.get_beacon_committee(state, slot, 0, sp)
        committee_set = {int(i) for i in committee}
        data = chain.produce_attestation_data(slot, 0)
        modes = spec["kwargs"].get("modes", list(self.AGGREGATE_MODES))
        per_mode = spec["kwargs"].get("per_mode", 4)
        signer = min(source.keys)
        store, pk = self._store(source), self._pubkey(source, signer)
        topic = str(topics_mod.GossipTopic(
            source.node.router.fork_digest,
            topics_mod.BEACON_AGGREGATE_AND_PROOF))
        forgers = spec["state"].setdefault("forgers", {})
        for mode in modes:
            if mode not in forgers:
                forgers[mode] = self._forger(victim.peer_id)
            forger, endpoint = forgers[mode]
            for i in range(per_mode):
                digest = self._digest("invalid_aggregate", slot, mode, i)
                pos = i % len(committee)
                inner = self._build_attestation(
                    source, data, 0, pos, committee,
                    source.harness.sign_attestation_data(
                        state, data, int(committee[pos])).to_bytes())
                if mode == "not_in_committee":
                    aggregator = min(set(range(len(state.validators)))
                                     - committee_set)
                elif mode == "aggregator_out_of_range":
                    aggregator = len(state.validators) + 1 + digest[0] % 7
                elif mode == "undecodable":
                    aggregator = signer
                else:
                    raise ValueError(
                        f"unknown invalid_aggregate mode {mode!r}")
                message = types.AggregateAndProof(
                    aggregator_index=aggregator, aggregate=inner,
                    selection_proof=store.selection_proof(pk, slot))
                signed = types.SignedAggregateAndProof(
                    message=message,
                    signature=store.sign_aggregate_and_proof_unsafe(
                        pk, message))
                raw = signed.as_ssz_bytes()
                if mode == "undecodable":
                    raw = raw[: 1 + digest[1] % max(1, len(raw) - 1)]
                self._send_gossip(endpoint, forger, [victim.peer_id],
                                  topic, compress(raw))
        spec["emitted"] += 1
        self._record(
            "invalid_aggregate", slot, None,
            f"{len(modes)}x{per_mode} forged aggregates at {victim.peer_id} "
            f"({','.join(modes)})")

    # -------------------------------------- malformed sync contribution

    SYNC_CONTRIBUTION_MODES = ("bad_subcommittee", "not_in_subcommittee",
                               "empty_contribution", "undecodable")

    def _act_malformed_sync_contribution(self, spec: dict, slot: int) -> None:
        """``SignedContributionAndProof`` messages that fail the sync gossip
        rules.  Pinned to the CURRENT slot deliberately: the chain IGNOREs
        (no reject, no penalty) contributions outside the ±1-slot window, so
        a stale-slot forgery would prove nothing.  One forger per mode, as
        in ``_act_invalid_aggregate``."""
        source = self._node(spec["node"])
        if source is None or source.harness is None:
            return
        victim = self._node(spec["kwargs"].get("target", 0))
        if victim is None:
            return
        chain, sp = source.chain, source.harness.spec
        types = source.harness.types
        state = chain.head_state
        sub_size = chain.sync_contribution_pool._sub_size()
        # first owned validator with a seat in this period's sync committee
        # (a 32-seat committee over 16 validators leaves ~13% of validators
        # without a seat on any given seed — scan instead of betting on one)
        aggregator, positions = None, []
        for v in sorted(source.keys):
            positions = chain._sync_committee_positions(state, v, slot=slot)
            if positions:
                aggregator = v
                break
        if aggregator is None:
            return  # no owned seat this period; retry next slot
        covered = sorted({p // sub_size for p in positions})
        free = [s for s in range(sp.sync_committee_subnet_count)
                if s not in covered]
        modes = spec["kwargs"].get(
            "modes", list(self.SYNC_CONTRIBUTION_MODES))
        per_mode = spec["kwargs"].get("per_mode", 4)
        store, pk = self._store(source), self._pubkey(source, aggregator)
        head_root = chain.head_root
        topic = str(topics_mod.GossipTopic(
            source.node.router.fork_digest,
            topics_mod.SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF))
        forgers = spec["state"].setdefault("forgers", {})
        sent = []
        for mode in modes:
            if mode == "not_in_subcommittee" and not free:
                continue  # aggregator covers every subnet (tiny committee)
            if mode not in forgers:
                forgers[mode] = self._forger(victim.peer_id)
            forger, endpoint = forgers[mode]
            for i in range(per_mode):
                digest = self._digest(
                    "malformed_sync_contribution", slot, mode, i)
                bits = [False] * sub_size
                if mode == "bad_subcommittee":
                    sub = sp.sync_committee_subnet_count + digest[0] % 4
                    bits[i % sub_size] = True
                elif mode == "not_in_subcommittee":
                    sub = free[0]
                    bits[i % sub_size] = True
                elif mode == "empty_contribution":
                    sub = covered[0]  # member, so the zero-bits check fires
                elif mode == "undecodable":
                    sub = covered[0]
                    bits[i % sub_size] = True
                else:
                    raise ValueError(
                        f"unknown malformed_sync_contribution mode {mode!r}")
                contribution = types.SyncCommitteeContribution(
                    slot=slot, beacon_block_root=head_root,
                    subcommittee_index=sub, aggregation_bits=bits,
                    signature=store.sign_sync_committee_message(
                        pk, slot, head_root))
                message = types.ContributionAndProof(
                    aggregator_index=aggregator, contribution=contribution,
                    selection_proof=store.sync_selection_proof(
                        pk, slot, sub, types))
                signed = types.SignedContributionAndProof(
                    message=message,
                    signature=store.sign_contribution_and_proof_unsafe(
                        pk, message))
                raw = signed.as_ssz_bytes()
                if mode == "undecodable":
                    # fixed-size container: any truncation is a length error
                    raw = raw[: 1 + digest[1] % max(1, len(raw) - 1)]
                self._send_gossip(endpoint, forger, [victim.peer_id],
                                  topic, compress(raw))
            sent.append(mode)
        spec["emitted"] += 1
        self._record(
            "malformed_sync_contribution", slot, None,
            f"{len(sent)}x{per_mode} forged contributions at "
            f"{victim.peer_id} ({','.join(sent)})")

    # ---------------------------------------------------------- evidence

    def _honest_nodes(self):
        return [n for n in self.sim.live_nodes if n.harness is not None]

    def observe_slot(self, slot: int) -> None:
        """Per-slot detection/inclusion probe (fault window AND recovery)."""
        pending = [o for o in self.offenses
                   if o.validator is not None
                   and (o.detected_slot is None or o.included_slot is None)]
        if not pending:
            return
        nodes = self._honest_nodes()
        for offense in pending:
            v = offense.validator
            if offense.detected_slot is None:
                for n in nodes:
                    pool = n.chain.op_pool
                    in_att = any(
                        v in attester_slashing_indices(s)
                        for s in pool.attester_slashings())
                    if in_att or pool.has_proposer_slashing(v):
                        offense.detected_slot = slot
                        break
            if offense.included_slot is None:
                for n in nodes:
                    state = n.chain.head_state
                    if v < len(state.validators) and bool(
                            state.validators[v].slashed):
                        offense.included_slot = slot
                        break

    def summary(self) -> dict:
        strategies = sorted({s["strategy"] for s in self._armed})
        offenders = sorted({o.validator for o in self.offenses
                            if o.validator is not None})
        detected = [o for o in self.offenses
                    if o.validator is not None and o.detected_slot is not None]
        included = [o for o in self.offenses
                    if o.validator is not None and o.included_slot is not None]

        def stats(latencies):
            return {
                "max": max(latencies) if latencies else None,
                "mean": (round(sum(latencies) / len(latencies), 2)
                         if latencies else None),
            }

        return {
            "strategies": strategies,
            "offenses_emitted": len(self.offenses),
            "offenses_detected": len(detected),
            "offenses_included": len(included),
            "veto_asserted": self.veto_asserted,
            "offenders": offenders,
            # detection = the slasher's output reached an honest op pool;
            # inclusion = a canonical block carried the conviction
            "detection_latency_slots": stats(
                [o.detected_slot - o.slot for o in detected]),
            "inclusion_latency_slots": stats(
                [o.included_slot - o.slot for o in included]),
            "offenses": [o.to_dict() for o in self.offenses],
        }


# ------------------------------------------------------------------- gates


def iter_canonical_blocks(chain):
    """Yield the canonical chain's signed blocks, head back to the anchor
    (the ONE walk every gate shares — evidence walks must not drift)."""
    root = chain.head_root
    while root and root != chain.genesis_block_root:
        block = chain.get_block(root)
        if block is None:
            return
        yield block
        root = bytes(block.message.parent_root)


def find_inclusion(chain, validator: int):
    """Walk the canonical chain for the block that included a slashing
    convicting ``validator``; returns (slot, kind) or (None, None)."""
    for block in iter_canonical_blocks(chain):
        body = block.message.body
        for s in getattr(body, "attester_slashings", ()):
            if validator in attester_slashing_indices(s):
                return int(block.message.slot), "attester"
        for s in getattr(body, "proposer_slashings", ()):
            if int(s.signed_header_1.message.proposer_index) == validator:
                return int(block.message.slot), "proposer"
    return None, None


def slashing_pipeline_gate(runner, max_latency_slots: int = 24) -> dict:
    """The end-to-end slashing gate: every slashable offense the controller
    emitted was detected, gossiped, packed, block-included, flipped
    ``validators[idx].slashed`` on EVERY honest node, and (for attester
    offenses) zeroed the offender's fork-choice weight — within
    ``max_latency_slots`` of the offense.  The runner's standard gates
    prove the honest majority converged and finalized on top."""
    byz = runner.ctx.get("byz")
    assert byz is not None, "no byzantine controller armed"
    slashable = [o for o in byz.offenses
                 if o.strategy in SLASHABLE_STRATEGIES]
    assert slashable, (
        "byzantine strategies armed but no slashable offense was emitted — "
        "widen the fault window or re-seed")
    assert byz.veto_asserted >= len(slashable), (
        "an offense was signed without first asserting the EIP-3076 veto")
    nodes = [n for n in runner.sim.live_nodes if n.harness is not None]
    # conviction is PER VALIDATOR: a repeat offense by an already-convicted
    # validator is correctly rejected at the pool (stale — the offender is
    # slashed), so the pipeline proof anchors on each offender's FIRST
    # offense
    by_validator: Dict[int, List[Offense]] = {}
    for offense in slashable:
        by_validator.setdefault(offense.validator, []).append(offense)
    evidence = []
    for v, offenses in sorted(by_validator.items()):
        first = min(offenses, key=lambda o: o.slot)
        detected = [o.detected_slot for o in offenses
                    if o.detected_slot is not None]
        included = [o.included_slot for o in offenses
                    if o.included_slot is not None]
        assert detected, (
            f"{first.strategy} by validator {v} at slot {first.slot} "
            "never reached an honest op pool")
        assert included, (
            f"slashing for validator {v} never landed in a block")
        latency = min(included) - first.slot
        assert latency <= max_latency_slots, (
            f"slashing for validator {v} took {latency} slots "
            f"(> {max_latency_slots})")
        for n in nodes:
            state = n.chain.head_state
            assert bool(state.validators[v].slashed), (
                f"node {n.peer_id}: validator {v} not slashed in head state")
            if first.strategy in ("double_vote", "surround_vote"):
                votes = n.chain.fork_choice.votes
                assert (v < len(votes.equivocating)
                        and bool(votes.equivocating[v])), (
                    f"node {n.peer_id}: validator {v} still carries "
                    "fork-choice weight (equivocation mask unset)")
        slot_incl, kind = find_inclusion(nodes[0].chain, v)
        assert slot_incl is not None, (
            f"no canonical block carries the slashing for validator {v}")
        evidence.append({
            "validator": v, "strategy": first.strategy,
            "offense_slot": first.slot, "offenses": len(offenses),
            "included_in_block_at_slot": slot_incl,
            "slashing_kind": kind, "inclusion_latency_slots": latency,
        })
    pooled = metrics.SLASHER_SLASHINGS.delta(
        byz.slashings_baseline,
        kind=topics_mod.ATTESTER_SLASHING, outcome="pooled",
    ) + metrics.SLASHER_SLASHINGS.delta(
        byz.slashings_baseline,
        kind=topics_mod.PROPOSER_SLASHING, outcome="pooled")
    assert pooled >= 1, "no slasher-produced slashing was pooled+gossiped"
    return {"slashing_pipeline": evidence,
            "slasher_slashings_pooled": pooled}
