"""SignatureSet constructors — one per signed object class (reference:
``consensus/state_processing/src/per_block_processing/signature_sets.rs``,
19 constructors at :74-:610).

Every constructor returns a ``bls.SignatureSet`` that the batched backend can
fold into one device multi-pairing (``ops/verify.py``), or raises
``SignatureSetError`` when the referenced validator doesn't exist.

Decompressed pubkeys are memoized process-wide in ``pubkey_cache`` — the
analog of the reference's disk-backed ``validator_pubkey_cache.rs`` (the
cache feeding every batch verification).

A copy of the JAX package's ``lighthouse_tpu/consensus/signature_sets.py``,
on the port's BLS API.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto.bls import api as bls
from ..types.spec import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_BLS_TO_EXECUTION_CHANGE,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    ChainSpec,
)
from ..types.ssz import hash_tree_root
from . import helpers as h


class SignatureSetError(ValueError):
    pass


_PUBKEY_CACHE: Dict[bytes, bls.PublicKey] = {}


def pubkey_cache(pubkey_bytes: bytes) -> bls.PublicKey:
    pk = _PUBKEY_CACHE.get(pubkey_bytes)
    if pk is None:
        pk = bls.PublicKey.from_bytes(bytes(pubkey_bytes))
        _PUBKEY_CACHE[bytes(pubkey_bytes)] = pk
    return pk


def validator_pubkey(state, index: int) -> bls.PublicKey:
    if index >= len(state.validators):
        raise SignatureSetError(f"unknown validator index {index}")
    return pubkey_cache(bytes(state.validators[index].pubkey))


_SIG_CACHE: Dict[bytes, bls.Signature] = {}


def _sig(signature_bytes: bytes) -> bls.Signature:
    """Decompressed-signature cache (the signature-side analog of the
    reference's ``validator_pubkey_cache``).  Raises ``BlsError`` on
    malformed bytes — the caller's block/attestation is invalid."""
    key = bytes(signature_bytes)
    sig = _SIG_CACHE.get(key)
    if sig is None:
        if len(_SIG_CACHE) > 1 << 16:
            _SIG_CACHE.clear()
        sig = _SIG_CACHE[key] = bls.Signature.from_bytes(key)
    return sig


# ---------------------------------------------------------------- blocks


def block_proposal_signature_set(
    state, signed_block, spec: ChainSpec, block_root: Optional[bytes] = None
) -> bls.SignatureSet:
    """signature_sets.rs:74 ``block_proposal_signature_set``."""
    block = signed_block.message
    proposer = validator_pubkey(state, block.proposer_index)
    domain = h.get_domain(
        state, DOMAIN_BEACON_PROPOSER, h.compute_epoch_at_slot(block.slot, spec), spec
    )
    root = block_root if block_root is not None else block.hash_tree_root()
    message = h.compute_signing_root(root, domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_block.signature), proposer, message)


def randao_signature_set(state, block, spec: ChainSpec) -> bls.SignatureSet:
    """signature_sets.rs:186 ``randao_signature_set``."""
    epoch = h.compute_epoch_at_slot(block.slot, spec)
    proposer = validator_pubkey(state, block.proposer_index)
    domain = h.get_domain(state, DOMAIN_RANDAO, epoch, spec)
    from ..types.ssz import UintType

    message = h.compute_signing_root(UintType(8).hash_tree_root(epoch), domain)
    return bls.SignatureSet.single_pubkey(_sig(block.body.randao_reveal), proposer, message)


def block_header_signature_set(state, signed_header, spec: ChainSpec) -> bls.SignatureSet:
    """Used by proposer slashings (signature_sets.rs:223)."""
    header = signed_header.message
    proposer = validator_pubkey(state, header.proposer_index)
    domain = h.get_domain(
        state, DOMAIN_BEACON_PROPOSER, h.compute_epoch_at_slot(header.slot, spec), spec
    )
    message = h.compute_signing_root(header.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_header.signature), proposer, message)


def proposer_slashing_signature_sets(state, slashing, spec: ChainSpec):
    return (
        block_header_signature_set(state, slashing.signed_header_1, spec),
        block_header_signature_set(state, slashing.signed_header_2, spec),
    )


# ---------------------------------------------------------- attestations


def indexed_attestation_signature_set(
    state, indexed, spec: ChainSpec
) -> bls.SignatureSet:
    """signature_sets.rs:271 — one set with N pubkeys for the aggregate."""
    pubkeys = [validator_pubkey(state, i) for i in indexed.attesting_indices]
    if not pubkeys:
        raise SignatureSetError("empty attesting indices")
    domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch, spec)
    message = h.compute_signing_root(indexed.data.hash_tree_root(), domain)
    return bls.SignatureSet(_sig(indexed.signature), message, pubkeys)


def attester_slashing_signature_sets(state, slashing, spec: ChainSpec):
    return (
        indexed_attestation_signature_set(state, slashing.attestation_1, spec),
        indexed_attestation_signature_set(state, slashing.attestation_2, spec),
    )


# -------------------------------------------------------- deposits / exits


def deposit_signature_message(deposit_data, types, spec: ChainSpec):
    """Deposits are verified individually against the deposit domain with no
    fork/genesis-root mixed in (signature_sets.rs:364 ``deposit_pubkey_signature_message``)."""
    msg = types.DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = h.compute_domain(DOMAIN_DEPOSIT, spec.genesis_fork_version, None)
    return h.compute_signing_root(msg.hash_tree_root(), domain)


def voluntary_exit_signature_set(state, signed_exit, spec: ChainSpec) -> bls.SignatureSet:
    """signature_sets.rs:377.  EIP-7044 (deneb+): always signed over the
    capella fork domain."""
    exit_ = signed_exit.message
    pubkey = validator_pubkey(state, exit_.validator_index)
    if type(state).fork_name in ("deneb", "electra"):
        domain = h.compute_domain(
            DOMAIN_VOLUNTARY_EXIT, spec.capella_fork_version, state.genesis_validators_root
        )
    else:
        domain = h.get_domain(state, DOMAIN_VOLUNTARY_EXIT, exit_.epoch, spec)
    message = h.compute_signing_root(exit_.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_exit.signature), pubkey, message)


def bls_to_execution_change_signature_set(
    state, signed_change, spec: ChainSpec
) -> bls.SignatureSet:
    """signature_sets.rs: bls_execution_change_signature_set — signed with the
    *genesis* fork version regardless of current fork."""
    change = signed_change.message
    pubkey = pubkey_cache(bytes(change.from_bls_pubkey))
    domain = h.compute_domain(
        DOMAIN_BLS_TO_EXECUTION_CHANGE, spec.genesis_fork_version, state.genesis_validators_root
    )
    message = h.compute_signing_root(change.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_change.signature), pubkey, message)


# -------------------------------------------------------- sync committee


def sync_aggregate_signature_set(
    state, sync_aggregate, slot: int, block_root: Optional[bytes], spec: ChainSpec
) -> Optional[bls.SignatureSet]:
    """signature_sets.rs:482 ``sync_aggregate_signature_set``.  Returns None
    when there are no participants (empty aggregate must be the infinity
    signature, checked by the caller)."""
    committee = state.current_sync_committee
    participants = [
        pubkey_cache(bytes(committee.pubkeys[i]))
        for i, bit in enumerate(sync_aggregate.sync_committee_bits)
        if bit
    ]
    if not participants:
        return None
    previous_slot = max(slot, 1) - 1
    if block_root is None:
        block_root = h.get_block_root_at_slot(state, previous_slot, spec)
    domain = h.get_domain(
        state, DOMAIN_SYNC_COMMITTEE, h.compute_epoch_at_slot(previous_slot, spec), spec
    )
    message = h.compute_signing_root(bytes(block_root), domain)
    return bls.SignatureSet(
        _sig(sync_aggregate.sync_committee_signature), message, participants
    )


def sync_committee_message_set(
    state, validator_index: int, beacon_block_root: bytes, slot: int, signature, spec: ChainSpec
) -> bls.SignatureSet:
    pubkey = validator_pubkey(state, validator_index)
    domain = h.get_domain(state, DOMAIN_SYNC_COMMITTEE, h.compute_epoch_at_slot(slot, spec), spec)
    message = h.compute_signing_root(bytes(beacon_block_root), domain)
    return bls.SignatureSet.single_pubkey(_sig(signature), pubkey, message)


# ---------------------------------------------- aggregation (gossip layer)


def selection_proof_signature_set(state, validator_index: int, slot: int, proof, spec: ChainSpec):
    """signature_sets.rs:417 ``aggregate_selection_proof_signature_set``."""
    from ..types.ssz import UintType

    pubkey = validator_pubkey(state, validator_index)
    domain = h.get_domain(
        state, DOMAIN_SELECTION_PROOF, h.compute_epoch_at_slot(slot, spec), spec
    )
    message = h.compute_signing_root(UintType(8).hash_tree_root(slot), domain)
    return bls.SignatureSet.single_pubkey(_sig(proof), pubkey, message)


def aggregate_and_proof_signature_set(state, signed_aggregate, spec: ChainSpec):
    """signature_sets.rs:447 ``aggregate_signature_set`` over the AggregateAndProof."""
    msg = signed_aggregate.message
    pubkey = validator_pubkey(state, msg.aggregator_index)
    epoch = h.compute_epoch_at_slot(msg.aggregate.data.slot, spec)
    domain = h.get_domain(state, DOMAIN_AGGREGATE_AND_PROOF, epoch, spec)
    message = h.compute_signing_root(msg.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_aggregate.signature), pubkey, message)


def sync_selection_proof_signature_set(
    state, validator_index: int, slot: int, subcommittee_index: int, proof, types, spec: ChainSpec
):
    data = types.SyncAggregatorSelectionData(slot=slot, subcommittee_index=subcommittee_index)
    pubkey = validator_pubkey(state, validator_index)
    domain = h.get_domain(
        state,
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        h.compute_epoch_at_slot(slot, spec),
        spec,
    )
    message = h.compute_signing_root(data.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(proof), pubkey, message)


def contribution_and_proof_signature_set(state, signed_contribution, spec: ChainSpec):
    msg = signed_contribution.message
    pubkey = validator_pubkey(state, msg.aggregator_index)
    epoch = h.compute_epoch_at_slot(msg.contribution.slot, spec)
    domain = h.get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch, spec)
    message = h.compute_signing_root(msg.hash_tree_root(), domain)
    return bls.SignatureSet.single_pubkey(_sig(signed_contribution.signature), pubkey, message)
