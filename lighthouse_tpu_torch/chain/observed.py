"""Gossip dedup caches: the chain's first line of DoS defense.

Equivalent of the reference's ``beacon_node/beacon_chain/src/observed_*``
family (``observed_attesters.rs``, ``observed_aggregates.rs``,
``observed_block_producers.rs``): before any signature work, gossip
verification consults these caches so the same attestation/aggregate/block
can never be re-verified arbitrarily often under replay — the spec's p2p
validation rules made O(1).

Membership is checked during gossip pre-verification and inserted only after
successful signature verification (the reference's observe-after-verify
order), so an attacker cannot poison the cache with invalid items.

A copy of the JAX package's ``lighthouse_tpu/chain/observed.py``.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from ..timeout_lock import TimeoutLock


class ObservedAttesters:
    """One unaggregated attestation per (validator, target epoch) — the
    beacon_attestation_{subnet} gossip rule (observed_attesters.rs)."""

    def __init__(self) -> None:
        self._seen: Dict[int, Set[int]] = {}  # target_epoch -> {validator_index}
        self._lock = TimeoutLock("observed")

    def is_known(self, target_epoch: int, validator_index: int) -> bool:
        with self._lock:
            return validator_index in self._seen.get(target_epoch, ())

    def observe(self, target_epoch: int, validator_index: int) -> bool:
        """Record; returns False if it was already known."""
        with self._lock:
            s = self._seen.setdefault(target_epoch, set())
            if validator_index in s:
                return False
            s.add(validator_index)
            return True

    def prune(self, finalized_epoch: int) -> None:
        with self._lock:
            for e in [e for e in self._seen if e < finalized_epoch]:
                del self._seen[e]


class ObservedAggregators(ObservedAttesters):
    """One aggregate per (aggregator, target epoch) — the
    beacon_aggregate_and_proof gossip rule (observed_attesters.rs
    ``ObservedAggregators``)."""


class ObservedAggregates:
    """Seen aggregate attestation roots per slot, for exact-duplicate drops
    (observed_aggregates.rs ``ObservedAttestations``)."""

    def __init__(self) -> None:
        self._seen: Dict[int, Set[bytes]] = {}  # slot -> {attestation htr}
        self._lock = TimeoutLock("observed")

    def is_known(self, slot: int, attestation_root: bytes) -> bool:
        with self._lock:
            return attestation_root in self._seen.get(slot, ())

    def observe(self, slot: int, attestation_root: bytes) -> bool:
        with self._lock:
            s = self._seen.setdefault(slot, set())
            if attestation_root in s:
                return False
            s.add(attestation_root)
            return True

    def prune(self, finalized_slot: int) -> None:
        with self._lock:
            for s in [s for s in self._seen if s < finalized_slot]:
                del self._seen[s]


class ObservedBlockProducers:
    """One block per (proposer, slot); a second distinct root is an
    equivocation (observed_block_producers.rs)."""

    def __init__(self) -> None:
        self._seen: Dict[Tuple[int, int], bytes] = {}  # (slot, proposer) -> root
        self._lock = TimeoutLock("observed")

    def status(self, slot: int, proposer: int, block_root: bytes) -> str:
        """Read-only check: 'new', 'duplicate' (same root) or 'equivocation'.
        Used BEFORE import; ``observe`` records only after the block passes
        verification (observe-after-verify — an invalid block must not be
        able to brand the honest proposer an equivocator)."""
        with self._lock:
            prev = self._seen.get((slot, proposer))
            if prev is None:
                return "new"
            return "duplicate" if prev == block_root else "equivocation"

    def observe(self, slot: int, proposer: int, block_root: bytes) -> None:
        with self._lock:
            self._seen.setdefault((slot, proposer), block_root)

    def prune(self, finalized_slot: int) -> None:
        with self._lock:
            for k in [k for k in self._seen if k[0] < finalized_slot]:
                del self._seen[k]

    def proposer_seen_in_epoch(self, epoch: int, proposer: int,
                               slots_per_epoch: int) -> bool:
        """Did ``proposer`` produce any observed block in ``epoch``?  Liveness
        query (reference ``validator_seen_at_epoch``, beacon_chain.rs:6615)."""
        lo = epoch * slots_per_epoch
        hi = lo + slots_per_epoch
        with self._lock:
            return any(
                lo <= slot < hi and prod == proposer
                for (slot, prod) in self._seen
            )


class ObservedOperations:
    """Gossip dedup for pool operations (reference observed_operations.rs):
    one exit per validator, one slashing per offending proposer, one BLS
    change per validator — re-broadcasts are IGNOREd, not re-verified.
    Attester slashings dedup on their ssz root (index-set supersets are the
    pool's concern, not gossip's)."""

    KINDS = ("voluntary_exit", "proposer_slashing", "attester_slashing",
             "bls_to_execution_change")

    def __init__(self) -> None:
        self._seen = {kind: set() for kind in self.KINDS}

    def is_known(self, kind: str, key) -> bool:
        """Check WITHOUT marking — only verified ops get recorded (an
        invalid op must never censor the validator's real one)."""
        return key in self._seen[kind]

    def observe(self, kind: str, key) -> None:
        self._seen[kind].add(key)

    def prune(self) -> None:
        # exits/changes are one-shot per validator for the chain's life;
        # only the unbounded slashing-root set needs a cap
        seen = self._seen["attester_slashing"]
        while len(seen) > 4096:
            seen.pop()


class ObservedCaches:
    """The bundle a chain owns, pruned together each finalization."""

    def __init__(self) -> None:
        self.attesters = ObservedAttesters()
        self.aggregators = ObservedAggregators()
        self.aggregates = ObservedAggregates()
        self.block_producers = ObservedBlockProducers()
        self.sync_contributors = ObservedAttesters()  # (slot-as-epoch, validator)
        # Attester indices seen inside imported blocks, by target epoch.  A
        # node subscribed to few subnets sees most attestations only in
        # aggregates/blocks, so doppelganger liveness MUST consult this too
        # (reference observed_attesters.rs ``ObservedBlockAttesters``).
        self.block_attesters = ObservedAttesters()
        self.operations = ObservedOperations()

    def prune(self, finalized_epoch: int, slots_per_epoch: int) -> None:
        finalized_slot = finalized_epoch * slots_per_epoch
        self.attesters.prune(finalized_epoch)
        self.aggregators.prune(finalized_epoch)
        self.aggregates.prune(finalized_slot)
        self.block_producers.prune(finalized_slot)
        self.block_attesters.prune(finalized_epoch)
        self.operations.prune()

    def validator_seen_at_epoch(self, epoch: int, index: int,
                                slots_per_epoch: int) -> bool:
        """OR over every cache that can prove a validator was active in
        ``epoch``: gossip attestations, attestations inside imported blocks,
        aggregation duties, and block proposals (the reference's four-cache
        check, beacon_chain.rs:6615 ``validator_seen_at_epoch``)."""
        return (
            self.attesters.is_known(epoch, index)
            or self.block_attesters.is_known(epoch, index)
            or self.aggregators.is_known(epoch, index)
            or self.block_producers.proposer_seen_in_epoch(
                epoch, index, slots_per_epoch)
        )
