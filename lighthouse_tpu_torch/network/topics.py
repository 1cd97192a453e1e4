"""Gossip topics ↔ fork digests.

Equivalent of the reference's ``lighthouse_network/src/types/topics.rs``
(466 LoC): topic strings ``/eth2/{fork_digest}/{kind}/ssz_snappy`` with
subnet-indexed attestation / sync-committee / blob topics, and the set of
core topics a node subscribes for a fork.

A copy of the JAX package's ``lighthouse_tpu/network/topics.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..consensus import helpers as h
from ..types.spec import ChainSpec

ENCODING = "ssz_snappy"

BEACON_BLOCK = "beacon_block"
BEACON_AGGREGATE_AND_PROOF = "beacon_aggregate_and_proof"
BEACON_ATTESTATION_PREFIX = "beacon_attestation_"
VOLUNTARY_EXIT = "voluntary_exit"
PROPOSER_SLASHING = "proposer_slashing"
ATTESTER_SLASHING = "attester_slashing"
SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF = "sync_committee_contribution_and_proof"
SYNC_COMMITTEE_PREFIX = "sync_committee_"
BLS_TO_EXECUTION_CHANGE = "bls_to_execution_change"
LIGHT_CLIENT_FINALITY_UPDATE = "light_client_finality_update"
LIGHT_CLIENT_OPTIMISTIC_UPDATE = "light_client_optimistic_update"
BLOB_SIDECAR_PREFIX = "blob_sidecar_"


@dataclass(frozen=True)
class GossipTopic:
    fork_digest: bytes  # 4 bytes
    kind: str

    def __str__(self) -> str:
        return f"/eth2/{self.fork_digest.hex()}/{self.kind}/{ENCODING}"

    @classmethod
    def parse(cls, s: str) -> "GossipTopic":
        parts = s.split("/")
        if len(parts) != 5 or parts[1] != "eth2" or parts[4] != ENCODING:
            raise ValueError(f"bad topic {s!r}")
        return cls(bytes.fromhex(parts[2]), parts[3])

    @property
    def subnet_id(self) -> int:
        for prefix in (BEACON_ATTESTATION_PREFIX, SYNC_COMMITTEE_PREFIX, BLOB_SIDECAR_PREFIX):
            if self.kind.startswith(prefix):
                return int(self.kind[len(prefix):])
        raise ValueError(f"{self.kind} is not a subnet topic")


def fork_digest(state_or_version, genesis_validators_root: bytes, spec: ChainSpec = None) -> bytes:
    if isinstance(state_or_version, bytes):
        return h.compute_fork_digest(state_or_version, genesis_validators_root)
    state = state_or_version
    return h.compute_fork_digest(
        bytes(state.fork.current_version), bytes(state.genesis_validators_root)
    )


def core_topics(digest: bytes, fork_name: str, spec: ChainSpec) -> List[GossipTopic]:
    """Topics every beacon node subscribes (reference ``CORE_TOPICS`` +
    fork-dependent additions)."""
    kinds = [
        BEACON_BLOCK,
        BEACON_AGGREGATE_AND_PROOF,
        VOLUNTARY_EXIT,
        PROPOSER_SLASHING,
        ATTESTER_SLASHING,
    ]
    if fork_name != "phase0":
        kinds.append(SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF)
        # LC servers gossip their updates (p2p spec light_client topics)
        kinds.append(LIGHT_CLIENT_FINALITY_UPDATE)
        kinds.append(LIGHT_CLIENT_OPTIMISTIC_UPDATE)
    if fork_name in ("capella", "deneb", "electra"):
        kinds.append(BLS_TO_EXECUTION_CHANGE)
    if fork_name in ("deneb", "electra"):
        kinds += [f"{BLOB_SIDECAR_PREFIX}{i}" for i in range(spec.max_blobs_per_block)]
    return [GossipTopic(digest, k) for k in kinds]


def attestation_subnet_topic(digest: bytes, subnet_id: int) -> GossipTopic:
    return GossipTopic(digest, f"{BEACON_ATTESTATION_PREFIX}{subnet_id}")


def fork_name_for_digest(digest: bytes, genesis_validators_root: bytes,
                         spec: ChainSpec):
    """Which fork a topic's digest belongs to (reference types/topics.rs
    fork-digest mapping) — None for an unknown digest."""
    for fork in ("phase0", "altair", "bellatrix", "capella", "deneb",
                 "electra"):
        version = spec.fork_version_for(fork)
        if h.compute_fork_digest(version, genesis_validators_root) == digest:
            return fork
    return None


def compute_subnet_for_attestation(state, slot: int, committee_index: int, spec: ChainSpec) -> int:
    """Spec ``compute_subnet_for_attestation``."""
    committees_per_slot = h.get_committee_count_per_slot(
        state, h.compute_epoch_at_slot(slot, spec), spec
    )
    slots_since_epoch_start = slot % spec.slots_per_epoch
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (committees_since_epoch_start + committee_index) % spec.attestation_subnet_count
