"""Attestation + sync-committee subnet subscription scheduling.

Equivalent of the reference's ``beacon_node/network/src/subnet_service/``
(``attestation_subnets.rs`` 687 LoC + ``sync_subnets.rs`` 359 LoC): a node
keeps two kinds of subnet subscriptions —

- **backbone**: ``SUBNETS_PER_NODE`` long-lived attestation subnets derived
  deterministically from the node id and rotated every
  ``EPOCHS_PER_SUBNET_SUBSCRIPTION`` epochs (consensus-spec phase0 p2p
  ``compute_subscribed_subnets``), so the network as a whole covers all 64
  subnets without anyone subscribing to everything;
- **duty-driven**: short-lived subscriptions requested by validator clients
  via ``POST /eth/v1/validator/beacon_committee_subscriptions`` (aggregators
  must see the unaggregated traffic for their slot) and
  ``.../sync_committee_subscriptions``, expiring after the duty.

``subscribe_all`` reproduces the reference's ``--subscribe-all-subnets``
flag — also the right mode for small in-process simulations, where two
backbone subnets per node would partition the traffic.

A copy of the JAX package's
``lighthouse_tpu/network/subnet_service.py``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Set

from . import topics as topics_mod

# consensus-spec phase0/p2p-interface constants
ATTESTATION_SUBNET_EXTRA_BITS = 0
EPOCHS_PER_SUBNET_SUBSCRIPTION = 256
SUBNETS_PER_NODE = 2
NODE_ID_BITS = 256


def compute_subscribed_subnets(node_id: int, epoch: int, spec) -> List[int]:
    """Spec ``compute_subscribed_subnets``: the node's backbone subnets at
    ``epoch`` (stable for EPOCHS_PER_SUBNET_SUBSCRIPTION epochs, offset
    per-node so the whole network doesn't rotate at once)."""
    from ..consensus.shuffling import compute_shuffled_index

    count = spec.attestation_subnet_count
    prefix_bits = (count - 1).bit_length() + ATTESTATION_SUBNET_EXTRA_BITS
    node_id_prefix = node_id >> (NODE_ID_BITS - prefix_bits)
    node_offset = node_id % EPOCHS_PER_SUBNET_SUBSCRIPTION
    period = (epoch + node_offset) // EPOCHS_PER_SUBNET_SUBSCRIPTION
    permutation_seed = hashlib.sha256(
        period.to_bytes(8, "little")).digest()
    permutated_prefix = compute_shuffled_index(
        node_id_prefix, 1 << prefix_bits, permutation_seed,
        spec.preset.shuffle_round_count,
    )
    return [(permutated_prefix + i) % count for i in range(SUBNETS_PER_NODE)]


class SubnetService:
    """Owns every subnet subscription decision for one node and applies the
    resulting subscribe/unsubscribe calls to the gossip service."""

    def __init__(self, *, service, digest: bytes, spec, node_id: int,
                 subscribe_all: bool = False):
        self.service = service
        self.digest = digest
        self.spec = spec
        self.node_id = node_id
        self.subscribe_all = subscribe_all
        self._lock = threading.RLock()
        self._backbone: Set[int] = set()
        # attestation subnet -> last slot it is needed for (duty-driven)
        self._duty_until_slot: Dict[int, int] = {}
        # sync subnet -> until_epoch (exclusive, per beacon-api semantics)
        self._sync_until_epoch: Dict[int, int] = {}

        if subscribe_all:
            for subnet in range(spec.attestation_subnet_count):
                self._subscribe_att(subnet)
            self._backbone = set(range(spec.attestation_subnet_count))

    # ------------------------------------------------------------ helpers

    def _subscribe_att(self, subnet: int) -> None:
        self.service.subscribe(
            str(topics_mod.attestation_subnet_topic(self.digest, subnet)))

    def _unsubscribe_att(self, subnet: int) -> None:
        self.service.unsubscribe(
            str(topics_mod.attestation_subnet_topic(self.digest, subnet)))

    def _sync_topic(self, subnet: int) -> str:
        return str(topics_mod.GossipTopic(
            self.digest, f"{topics_mod.SYNC_COMMITTEE_PREFIX}{subnet}"))

    # ----------------------------------------------------------- backbone

    def update_epoch(self, epoch: int) -> List[int]:
        """Rotate the backbone for ``epoch``; returns the active set."""
        if self.subscribe_all:
            return sorted(self._backbone)
        want = set(compute_subscribed_subnets(self.node_id, epoch, self.spec))
        # Decision AND side effect share one critical section: releasing
        # the lock between them lets a concurrent duty subscription for a
        # dropped subnet be immediately undone by our stale snapshot —
        # silently unsubscribing an aggregator for its whole duty window.
        with self._lock:
            drop = self._backbone - want
            add = want - self._backbone
            self._backbone = want
            for subnet in drop:
                if subnet not in self._duty_until_slot:
                    self._unsubscribe_att(subnet)
            for subnet in add:
                self._subscribe_att(subnet)
        return sorted(want)

    # --------------------------------------------------------- duty-driven

    def on_committee_subscriptions(self, entries: List[dict]) -> int:
        """``beacon_committee_subscriptions`` body: subscribe aggregators'
        subnets until their duty slot passes (attestation_subnets.rs
        handle_validator_subscriptions).  Returns #subnets touched."""
        touched = 0
        for entry in entries or []:
            try:
                slot = int(entry["slot"])
                committee_index = int(entry["committee_index"])
                committees_at_slot = int(entry["committees_at_slot"])
                is_aggregator = bool(entry.get("is_aggregator", False))
            except (KeyError, TypeError, ValueError):
                continue
            if not is_aggregator:
                continue  # non-aggregators only need their own attestation
            since_epoch_start = slot % self.spec.slots_per_epoch
            subnet = (
                committees_at_slot * since_epoch_start + committee_index
            ) % self.spec.attestation_subnet_count
            with self._lock:
                known = subnet in self._backbone or subnet in self._duty_until_slot
                prev = self._duty_until_slot.get(subnet, -1)
                self._duty_until_slot[subnet] = max(prev, slot)
                if not known and not self.subscribe_all:
                    self._subscribe_att(subnet)
            touched += 1
        return touched

    def on_sync_committee_subscriptions(self, entries: List[dict]) -> int:
        """``sync_committee_subscriptions`` body: subscribe the listed sync
        subnets until ``until_epoch`` (sync_subnets.rs)."""
        touched = 0
        for entry in entries or []:
            try:
                until_epoch = int(entry["until_epoch"])
                indices = [int(i) for i in entry["sync_committee_indices"]]
            except (KeyError, TypeError, ValueError):
                continue
            for idx in indices:
                subnet = idx // max(
                    1,
                    self.spec.preset.sync_committee_size
                    // self.spec.sync_committee_subnet_count,
                )
                if not 0 <= subnet < self.spec.sync_committee_subnet_count:
                    continue  # out-of-range index: never advertise a
                    # nonexistent sync topic to the network
                with self._lock:
                    fresh = subnet not in self._sync_until_epoch
                    prev = self._sync_until_epoch.get(subnet, -1)
                    self._sync_until_epoch[subnet] = max(prev, until_epoch)
                    if fresh:
                        self.service.subscribe(self._sync_topic(subnet))
                touched += 1
        return touched

    # ------------------------------------------------------------- expiry

    def prune(self, current_slot: int) -> None:
        """Drop expired duty subscriptions (called on the per-slot tick)."""
        current_epoch = current_slot // self.spec.slots_per_epoch
        # expiry decision + unsubscribe in ONE critical section (see
        # update_epoch: a stale snapshot applied after release races
        # concurrent re-subscriptions for the same subnet)
        with self._lock:
            expired_att = [s for s, until in self._duty_until_slot.items()
                           if until < current_slot]
            for s in expired_att:
                del self._duty_until_slot[s]
                if not self.subscribe_all and s not in self._backbone:
                    self._unsubscribe_att(s)
            expired_sync = [s for s, until in self._sync_until_epoch.items()
                            if until <= current_epoch]
            # sync subnets were never part of the subscribe-all initial set
            # — their until_epoch contract holds in EVERY mode
            for s in expired_sync:
                del self._sync_until_epoch[s]
                self.service.unsubscribe(self._sync_topic(s))

    # ----------------------------------------------------------- introspect

    def active_attestation_subnets(self) -> Set[int]:
        with self._lock:
            return set(self._backbone) | set(self._duty_until_slot)

    def active_sync_subnets(self) -> Set[int]:
        with self._lock:
            return set(self._sync_until_epoch)


# ----------------------------------------------------- ENR attnets field


def attnets_bitfield(subnets, count: int = 64) -> bytes:
    """SSZ Bitvector[64] bytes for the eth2 ENR ``attnets`` entry: bit i
    set = subscribed to attestation subnet i (consensus-spec p2p ENR
    structure)."""
    bits = bytearray((count + 7) // 8)
    for s in subnets:
        s = int(s)
        if 0 <= s < count:
            bits[s // 8] |= 1 << (s % 8)
    return bytes(bits)


def enr_attnets(enr) -> set:
    """Attestation subnets an ENR advertises (empty when the field is
    absent — pre-fork records; the predicate must not hard-fail them)."""
    raw = enr.pairs.get(b"attnets")
    if not raw:
        return set()
    out = set()
    for i in range(len(raw) * 8):
        if raw[i // 8] & (1 << (i % 8)):
            out.add(i)
    return out


def subnet_predicate(enr, wanted) -> bool:
    """True when the ENR advertises ANY of the wanted attestation subnets
    (reference discovery/subnet_predicate.rs)."""
    if not wanted:
        return True
    return bool(enr_attnets(enr) & set(int(s) for s in wanted))
