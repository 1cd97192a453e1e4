"""Validator-client services: duties polling, attesting, aggregating,
proposing — the per-slot production loop.

Equivalent of the reference's ``validator_client/src/{duties_service,
attestation_service, block_service}.rs``: duties are polled per epoch and
keyed by dependent_root; attestations are produced at slot+1/3, aggregates at
slot+2/3, blocks at slot start (``attestation_service.rs:1-60``,
``duties_service.rs:1-47``).  All beacon-node access goes through the
fallback (multi-BN redundancy, ``beacon_node_fallback.rs``).

A copy of the JAX package's ``lighthouse_tpu/validator_client/services.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..http_api.client import ApiClientError, BeaconNodeHttpClient
from ..http_api.serde import container_from_json
from .validator_store import ValidatorStore


from ..logs import get_logger

log = get_logger("vc")


class NoViableBeaconNode(Exception):
    pass


class BeaconNodeFallback:
    """Try each configured BN in order; first success wins
    (reference ``beacon_node_fallback.rs`` first_success)."""

    def __init__(self, clients: List[BeaconNodeHttpClient]):
        assert clients, "at least one beacon node required"
        self.clients = list(clients)

    def first_success(self, fn: Callable[[BeaconNodeHttpClient], object]):
        errors = []
        for client in self.clients:
            try:
                return fn(client)
            except (ApiClientError, OSError) as e:
                errors.append(f"{client.base_url}: {e}")
        raise NoViableBeaconNode("; ".join(errors))

    def measure_latency(self) -> List[dict]:
        """Round-trip time to every candidate BN (reference
        ``latency.rs``/``measure_latency``: a cheap GET per candidate, run
        11/12ths through the slot).  ``latency`` is None for unreachable
        nodes."""
        import time as _time

        out = []
        for client in self.clients:
            t0 = _time.monotonic()
            try:
                client.node_version()
                latency = _time.monotonic() - t0
            except (ApiClientError, OSError):
                latency = None
            out.append({"endpoint": client.base_url, "latency": latency})
        return out


class AttesterDuty:
    __slots__ = (
        "pubkey", "validator_index", "slot", "committee_index",
        "committee_length", "committees_at_slot", "validator_committee_index",
    )

    def __init__(self, d: dict):
        self.pubkey = bytes.fromhex(d["pubkey"][2:])
        self.validator_index = int(d["validator_index"])
        self.slot = int(d["slot"])
        self.committee_index = int(d["committee_index"])
        self.committee_length = int(d["committee_length"])
        self.committees_at_slot = int(d["committees_at_slot"])
        self.validator_committee_index = int(d["validator_committee_index"])


class DutiesService:
    def __init__(self, *, store: ValidatorStore, fallback: BeaconNodeFallback):
        self.store = store
        self.fallback = fallback
        # epoch -> {pubkey: AttesterDuty}
        self._attesters: Dict[int, Dict[bytes, List[AttesterDuty]]] = {}
        # epoch -> {slot: pubkey} (only our validators)
        self._proposers: Dict[int, Dict[int, bytes]] = {}
        self._dependent_roots: Dict[int, str] = {}
        self._indices: Dict[bytes, int] = {}  # pubkey -> validator index

    # ------------------------------------------------------------- indices

    def resolve_indices(self) -> Dict[bytes, int]:
        unknown = [pk for pk in self.store.pubkeys if pk not in self._indices]
        if unknown:
            ids = ["0x" + pk.hex() for pk in unknown]
            data = self.fallback.first_success(
                lambda c: c.validators("head", ids=ids)
            )
            for entry in data:
                pk = bytes.fromhex(entry["validator"]["pubkey"][2:])
                self._indices[pk] = int(entry["index"])
        return self._indices

    # -------------------------------------------------------------- duties

    def update(self, epoch: int) -> None:
        """Poll proposer + attester duties for ``epoch`` (and attesters for
        ``epoch+1`` so the first slot of the next epoch is never missed)."""
        indices = self.resolve_indices()
        if not indices:
            return
        self._poll_attesters(epoch, indices)
        self._poll_attesters(epoch + 1, indices)
        self._poll_proposers(epoch)
        for old in [e for e in self._attesters if e + 2 < epoch]:
            del self._attesters[old]
        for old in [e for e in self._proposers if e + 2 < epoch]:
            del self._proposers[old]
        for old in [e for e in self._dependent_roots if e + 2 < epoch]:
            del self._dependent_roots[old]

    def _poll_attesters(self, epoch: int, indices: Dict[bytes, int]) -> None:
        resp = self.fallback.first_success(
            lambda c: c.attester_duties(epoch, sorted(indices.values()))
        )
        dep = resp.get("dependent_root", "")
        if self._dependent_roots.get(epoch) == dep and epoch in self._attesters:
            return  # unchanged — same shuffling decision root
        self._dependent_roots[epoch] = dep
        by_pk: Dict[bytes, List[AttesterDuty]] = {}
        for d in resp["data"]:
            duty = AttesterDuty(d)
            by_pk.setdefault(duty.pubkey, []).append(duty)
        self._attesters[epoch] = by_pk

    def _poll_proposers(self, epoch: int) -> None:
        resp = self.fallback.first_success(lambda c: c.proposer_duties(epoch))
        ours: Dict[int, bytes] = {}
        for d in resp["data"]:
            pk = bytes.fromhex(d["pubkey"][2:])
            if self.store.has_key(pk):
                ours[int(d["slot"])] = pk
        self._proposers[epoch] = ours

    def attester_duties_at_slot(self, slot: int, spec) -> List[AttesterDuty]:
        epoch = slot // spec.slots_per_epoch
        out = []
        for duties in self._attesters.get(epoch, {}).values():
            out.extend(d for d in duties if d.slot == slot)
        return out

    def proposer_at_slot(self, slot: int, spec) -> Optional[bytes]:
        epoch = slot // spec.slots_per_epoch
        return self._proposers.get(epoch, {}).get(slot)


class PreparationService:
    """Fee-recipient preparations (reference ``preparation_service.rs``):
    POST prepare_beacon_proposer for every managed validator each epoch so
    the BN builds payloads paying OUR recipient.  (Builder/relay validator
    registration is a separate flow: register_validator, tests/test_builder.)"""

    def __init__(self, *, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback,
                 fee_recipient: bytes = b"\x00" * 20):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.fee_recipient = bytes(fee_recipient)
        self.per_validator: Dict[bytes, bytes] = {}  # pubkey -> recipient

    def set_fee_recipient(self, pubkey: bytes, recipient: bytes) -> None:
        self.per_validator[bytes(pubkey)] = bytes(recipient)

    def prepare(self) -> int:
        indices = self.duties.resolve_indices()
        entries = []
        for pk, idx in indices.items():
            recipient = self.per_validator.get(pk, self.fee_recipient)
            entries.append({
                "validator_index": str(idx),
                "fee_recipient": "0x" + recipient.hex(),
            })
        if entries:
            self.fallback.first_success(
                lambda c: c.prepare_beacon_proposer(entries)
            )
        return len(entries)


class SyncDuty:
    __slots__ = ("pubkey", "validator_index", "positions")

    def __init__(self, d: dict):
        self.pubkey = bytes.fromhex(d["pubkey"][2:])
        self.validator_index = int(d["validator_index"])
        self.positions = [int(p) for p in d["validator_sync_committee_indices"]]


class SyncCommitteeService:
    """Sync-committee duties (reference ``sync_committee_service.rs``):
    broadcast ``SyncCommitteeMessage``s over the head root at slot+1/3, and
    for elected sync aggregators, fetch + wrap + publish
    ``SignedContributionAndProof`` at slot+2/3."""

    def __init__(self, *, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, types):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.types = types
        self._sync_duties: Dict[int, List[SyncDuty]] = {}  # period -> duties

    def _period(self, epoch: int) -> int:
        return epoch // self.store.spec.preset.epochs_per_sync_committee_period

    def update_duties(self, epoch: int) -> None:
        period = self._period(epoch)
        if period in self._sync_duties:
            return
        indices = self.duties.resolve_indices()
        if not indices:
            # Don't cache emptiness: indices may simply not be resolvable yet
            # (BN syncing, validators pending) — retry on the next call
            # instead of skipping the whole ~27h period.
            return
        resp = self.fallback.first_success(
            lambda c: c.sync_duties(epoch, sorted(indices.values()))
        )
        self._sync_duties[period] = [SyncDuty(d) for d in resp["data"]]
        for old in [p for p in self._sync_duties if p + 2 < period]:
            del self._sync_duties[old]

    def _duties_now(self, slot: int) -> List[SyncDuty]:
        epoch = slot // self.store.spec.slots_per_epoch
        self.update_duties(epoch)
        return self._sync_duties.get(self._period(epoch), [])

    def produce_messages(self, slot: int) -> int:
        """Sign the current head root per sync duty and submit; returns count
        (the slot+1/3 half of the service)."""
        duties = self._duties_now(slot)
        if not duties:
            return 0
        head_root = self.fallback.first_success(lambda c: c.block_root("head"))
        messages = []
        for duty in duties:
            try:
                sig = self.store.sign_sync_committee_message(
                    duty.pubkey, slot, head_root
                )
            except Exception:
                continue  # missing key
            messages.append(self.types.SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=head_root,
                validator_index=duty.validator_index,
                signature=sig,
            ))
        if messages:
            self.fallback.first_success(
                lambda c: c.submit_sync_committee_messages(messages)
            )
        return len(messages)

    def aggregate(self, slot: int) -> int:
        """For subcommittees where a duty is an elected sync aggregator:
        fetch the pool contribution and publish the signed wrap (the
        slot+2/3 half)."""
        spec = self.store.spec
        duties = self._duties_now(slot)
        if not duties:
            return 0
        sub_size = spec.preset.sync_committee_size // spec.sync_committee_subnet_count
        head_root = self.fallback.first_success(lambda c: c.block_root("head"))
        published = []
        fetched: Dict[int, Optional[object]] = {}
        for duty in duties:
            for sub in sorted({p // sub_size for p in duty.positions}):
                proof = self.store.sync_selection_proof(
                    duty.pubkey, slot, sub, self.types
                )
                if not self.store.is_sync_aggregator(proof):
                    continue
                if sub not in fetched:
                    try:
                        fetched[sub] = self.fallback.first_success(
                            lambda c: c.sync_committee_contribution(
                                slot, sub, head_root, types=self.types
                            )
                        )
                    except NoViableBeaconNode:
                        fetched[sub] = None
                contribution = fetched[sub]
                if contribution is None:
                    continue
                message = self.types.ContributionAndProof(
                    aggregator_index=duty.validator_index,
                    contribution=contribution,
                    selection_proof=proof,
                )
                sig = self.store.sign_contribution_and_proof(duty.pubkey, message)
                published.append(self.types.SignedContributionAndProof(
                    message=message, signature=sig
                ))
        if published:
            self.fallback.first_success(
                lambda c: c.publish_contribution_and_proofs(published)
            )
        return len(published)


class DoppelgangerService:
    """Doppelganger protection (reference ``doppelganger_service.rs:1-13``):
    on startup, REFUSE all signing until our validators have shown no
    liveness on the network for ``DETECTION_EPOCHS`` full epochs — if another
    instance is attesting with our keys, signing would self-slash.

    The gate wraps the validator store: ``signing_enabled`` starts False and
    flips only after clean checks; a detection latches permanently until the
    operator intervenes."""

    DETECTION_EPOCHS = 2

    def __init__(self, *, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, start_epoch: int):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.start_epoch = start_epoch
        self.detected: List[int] = []  # validator indices seen live elsewhere
        self.complete = False  # satisfied: checks stop permanently
        self._clean_epochs: set = set()
        store.signing_enabled = False

    def check(self, current_epoch: int) -> bool:
        """Run a liveness round; returns True once signing is enabled.
        Call once per epoch (the reference polls at 3/4 of the last slot).
        Once satisfied, checks stop for good — after the gate lifts, OUR OWN
        duties show up as liveness and must not re-latch the block."""
        if self.complete:
            return True
        if self.detected:
            return False
        if current_epoch <= self.start_epoch:
            return False  # the startup epoch itself is never clean evidence
        indices = sorted(self.duties.resolve_indices().values())
        if not indices:
            # Indices not resolvable yet (BN syncing, validators pending):
            # keep the gate DOWN — 'unknown' must never mean 'safe'.
            return False
        # Check the *previous* epoch: it is complete, so absence is meaningful.
        # The startup epoch itself never counts — another instance may have
        # attested in it before we started watching.
        epoch_to_check = current_epoch - 1
        if epoch_to_check <= self.start_epoch:
            return False
        data = self.fallback.first_success(
            lambda c: c.liveness(epoch_to_check, indices)
        )
        live = [int(d["index"]) for d in data if d["is_live"]]
        if live:
            self.detected = live
            self.store.signing_enabled = False
            return False
        self._clean_epochs.add(epoch_to_check)
        if len(self._clean_epochs) >= self.DETECTION_EPOCHS:
            self.store.signing_enabled = True
            self.complete = True
            return True
        return False


class AttestationService:
    """Produce + publish attestations at slot+1/3, aggregates at slot+2/3
    (reference ``attestation_service.rs`` spawn_attestation_tasks)."""

    def __init__(self, *, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, types):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.types = types

    def attest(self, slot: int) -> int:
        """Sign + submit one attestation per duty at ``slot``; returns count."""
        spec = self.store.spec
        duties = self.duties.attester_duties_at_slot(slot, spec)
        if not duties:
            return 0
        by_committee: Dict[int, List[AttesterDuty]] = {}
        for d in duties:
            by_committee.setdefault(d.committee_index, []).append(d)
        attestations = []
        for committee_index, committee_duties in sorted(by_committee.items()):
            data = self.fallback.first_success(
                lambda c: c.attestation_data(slot, committee_index, types=self.types)
            )
            for duty in committee_duties:
                try:
                    sig = self.store.sign_attestation(duty.pubkey, data)
                except Exception:
                    continue  # slashing-protected or missing key: skip
                bits = [False] * duty.committee_length
                bits[duty.validator_committee_index] = True
                attestations.append(self.types.Attestation(
                    aggregation_bits=bits, data=data, signature=sig
                ))
        if attestations:
            self.fallback.first_success(
                lambda c: c.submit_attestations(attestations)
            )
            log.info("attestations published", slot=int(slot),
                     count=len(attestations))
        return len(attestations)

    def aggregate(self, slot: int) -> int:
        """For duties where we are the aggregator: fetch the pool aggregate,
        wrap in SignedAggregateAndProof, publish; returns count."""
        spec = self.store.spec
        duties = self.duties.attester_duties_at_slot(slot, spec)
        signed_aggregates = []
        fetched: Dict[int, Optional[object]] = {}  # committee -> aggregate (dedup fetch only)
        for duty in duties:
            proof = self.store.selection_proof(duty.pubkey, slot)
            if not self.store.is_aggregator(duty.committee_length, proof):
                continue
            # Every elected aggregator publishes, even when several of our
            # validators share a committee; only the FETCH is deduplicated.
            if duty.committee_index not in fetched:
                data = self.fallback.first_success(
                    lambda c: c.attestation_data(slot, duty.committee_index, types=self.types)
                )
                try:
                    fetched[duty.committee_index] = self.fallback.first_success(
                        lambda c: c.aggregate_attestation(
                            slot, data.hash_tree_root(), types=self.types,
                            committee_index=duty.committee_index,
                        )
                    )
                except NoViableBeaconNode:
                    fetched[duty.committee_index] = None
            aggregate = fetched[duty.committee_index]
            if aggregate is None:
                continue  # no aggregate in the pool for this data
            message = self.types.AggregateAndProof(
                aggregator_index=duty.validator_index,
                aggregate=aggregate,
                selection_proof=proof,
            )
            sig = self.store.sign_aggregate_and_proof(duty.pubkey, message)
            signed_aggregates.append(self.types.SignedAggregateAndProof(
                message=message, signature=sig
            ))
        if signed_aggregates:
            self.fallback.first_success(
                lambda c: c.publish_aggregate_and_proofs(signed_aggregates)
            )
        return len(signed_aggregates)


class BlockService:
    """Propose when we hold the proposer's key (``block_service.rs``)."""

    def __init__(self, *, store: ValidatorStore, duties: DutiesService,
                 fallback: BeaconNodeFallback, types,
                 graffiti: bytes = b"lighthouse-tpu".ljust(32, b"\x00"),
                 builder_proposals: bool = False, graffiti_file=None):
        self.store = store
        self.duties = duties
        self.fallback = fallback
        self.types = types
        self.graffiti = graffiti
        self.builder_proposals = builder_proposals
        # reference precedence: keymanager-set graffiti > per-validator
        # file entry > file default > VC-level graffiti flag
        self.graffiti_file = graffiti_file
        self.keymanager_graffiti = {}  # pubkey -> 32-byte graffiti

    def _graffiti_for(self, pubkey: bytes) -> bytes:
        km = self.keymanager_graffiti.get(bytes(pubkey))
        if km is not None:
            return km
        if self.graffiti_file is not None:
            try:
                g = self.graffiti_file.graffiti_for(pubkey)
            except Exception as e:
                # a broken file must not stop proposals — but it must be
                # LOUD: the operator configured per-validator graffiti and
                # is silently not getting it
                log.warning("graffiti file unusable, using default: %s", e)
                g = None
            if g is not None:
                return g
        return self.graffiti

    def propose(self, slot: int) -> Optional[bytes]:
        """Produce, sign (slashing-gated) and publish a block if it is our
        duty; returns the block root or None.  With ``builder_proposals``,
        try the blinded/MEV path first and fall back to local production
        (reference ``block_service.rs`` blinded-vs-full)."""
        spec = self.store.spec
        pubkey = self.duties.proposer_at_slot(slot, spec)
        if pubkey is None:
            return None
        epoch = slot // spec.slots_per_epoch
        reveal = self.store.randao_reveal(pubkey, epoch)
        if self.builder_proposals:
            try:
                return self._propose_blinded(slot, pubkey, reveal)
            except (ApiClientError, NoViableBeaconNode, KeyError, ValueError):
                pass  # builder path unavailable: local production below
        graffiti = self._graffiti_for(pubkey)
        resp = self.fallback.first_success(
            lambda c: c.produce_block(slot, reveal, graffiti=graffiti)
        )
        fork = resp["version"]
        if resp.get("execution_payload_blinded"):
            # A builder-enabled BN may serve a BLINDED body from v3 — sign
            # and publish it down the blinded path (spec v3 contract).
            block = container_from_json(self.types.blinded_block[fork], resp["data"])
            sig = self.store.sign_block(pubkey, block)
            signed = self.types.signed_blinded_block[fork](message=block, signature=sig)
            self.fallback.first_success(lambda c: c.publish_blinded_block(signed))
            return block.hash_tree_root()
        block = container_from_json(self.types.block[fork], resp["data"])
        sig = self.store.sign_block(pubkey, block)  # slashing DB veto point
        signed = self.types.signed_block[fork](message=block, signature=sig)
        self.fallback.first_success(lambda c: c.publish_block(signed))
        root = block.hash_tree_root()
        log.info("block proposed", slot=int(slot),
                 root="0x" + root.hex()[:16], path="local")
        return root

    def _propose_blinded(self, slot: int, pubkey: bytes, reveal: bytes) -> bytes:
        graffiti = self._graffiti_for(pubkey)
        resp = self.fallback.first_success(
            lambda c: c.produce_blinded_block(slot, reveal, graffiti=graffiti)
        )
        fork = resp["version"]
        block = container_from_json(self.types.blinded_block[fork], resp["data"])
        sig = self.store.sign_block(pubkey, block)  # same slashing veto
        signed = self.types.signed_blinded_block[fork](message=block, signature=sig)
        self.fallback.first_success(lambda c: c.publish_blinded_block(signed))
        root = block.hash_tree_root()
        log.info("block proposed", slot=int(slot),
                 root="0x" + root.hex()[:16], path="builder")
        return root
