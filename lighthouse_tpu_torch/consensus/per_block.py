"""Block processing (reference: ``consensus/state_processing/src/per_block_processing.rs``).

``per_block_processing(state, signed_block, …, strategy)`` mirrors the
reference entry point (:100): header → withdrawals/execution payload → randao
→ eth1 data → operations → sync aggregate, with
``BlockSignatureStrategy.{NO_VERIFICATION, VERIFY_INDIVIDUAL, VERIFY_RANDAO,
VERIFY_BULK}`` (:54-63).

VERIFY_BULK is the device path: every block signature is collected into
``SignatureSet``s up front (``BlockSignatureVerifier``,
block_signature_verifier.rs:74-405) and verified in ONE batched multi-pairing
through the swappable BLS backend — with the port's default ``"torch"``
backend that is one supervised batch on the card (``ops/verify.py`` on the
CUDA Fq kernels).  Deposits are excluded by design (invalid deposit
signatures are skipped, not failed — spec behavior).

A copy of the JAX package's ``lighthouse_tpu/consensus/per_block.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto.bls import api as bls
from ..types.spec import (
    DOMAIN_RANDAO,
    FAR_FUTURE_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    WEIGHT_DENOMINATOR,
    ChainSpec,
)
from ..types.ssz import hash_two
from . import helpers as h
from . import safe_arith as sa
from . import signature_sets as sets
from .safe_arith import ArithError

DEPOSIT_CONTRACT_TREE_DEPTH = 32


class BlockProcessingError(ValueError):
    pass


class BlockSignatureStrategy:
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_RANDAO = "verify_randao"
    VERIFY_BULK = "verify_bulk"


class BlockSignatureVerifier:
    """Collects all of a block's signature sets, then verifies them in one
    batched call (block_signature_verifier.rs:396-404 → one device batch)."""

    def __init__(self, state, types, spec: ChainSpec):
        self.state = state
        self.types = types
        self.spec = spec
        self.sets: List[bls.SignatureSet] = []

    def include_all_signatures(self, signed_block, block_root: Optional[bytes] = None) -> None:
        self.sets.append(
            sets.block_proposal_signature_set(self.state, signed_block, self.spec, block_root)
        )
        self.include_all_signatures_except_proposal(signed_block)

    def include_all_signatures_except_proposal(self, signed_block) -> None:
        state, spec = self.state, self.spec
        block = signed_block.message
        body = block.body
        self.sets.append(sets.randao_signature_set(state, block, spec))
        for ps in body.proposer_slashings:
            self.sets.extend(sets.proposer_slashing_signature_sets(state, ps, spec))
        for asl in body.attester_slashings:
            self.sets.extend(sets.attester_slashing_signature_sets(state, asl, spec))
        for att in body.attestations:
            indexed = h.get_indexed_attestation(state, att, self.types, spec)
            self.sets.append(sets.indexed_attestation_signature_set(state, indexed, spec))
        for ex in body.voluntary_exits:
            self.sets.append(sets.voluntary_exit_signature_set(state, ex, spec))
        if hasattr(body, "bls_to_execution_changes"):
            for ch in body.bls_to_execution_changes:
                self.sets.append(
                    sets.bls_to_execution_change_signature_set(state, ch, spec)
                )
        if hasattr(body, "sync_aggregate"):
            s = sets.sync_aggregate_signature_set(
                state, body.sync_aggregate, block.slot, None, spec
            )
            if s is not None:
                self.sets.append(s)

    def verify(self) -> bool:
        from .. import device_pipeline

        # Block import submits its whole set list as ONE pipeline group:
        # through the async device pipeline it coalesces with concurrent
        # gossip/sync-committee groups into one maximal device batch.
        with device_pipeline.work_context("block_import"):
            return bls.verify_signature_sets(self.sets)


# ------------------------------------------------------------- entry point


def per_block_processing(
    state,
    signed_block,
    types,
    spec: ChainSpec,
    strategy: str = BlockSignatureStrategy.VERIFY_BULK,
    verify_block_root: bool = True,
    block_root: Optional[bytes] = None,
    payload_verifier=None,
) -> None:
    """Apply ``signed_block`` to ``state`` (already advanced to block.slot).

    ``payload_verifier``: optional callable(payload) -> bool, the
    execution-engine notify_new_payload seam (fake-EL in tests, engine API in
    the beacon node).

    A spec-arithmetic overflow anywhere in block processing means the block
    is INVALID (reference ``BlockProcessingError::ArithError``) — surfaced as
    ``BlockProcessingError``, never a wrapped value or a bare crash.
    """
    try:
        _per_block_processing(
            state,
            signed_block,
            types,
            spec,
            strategy=strategy,
            verify_block_root=verify_block_root,
            block_root=block_root,
            payload_verifier=payload_verifier,
        )
    except ArithError as e:
        raise BlockProcessingError(f"arithmetic out of u64 range: {e}") from e


def _per_block_processing(
    state,
    signed_block,
    types,
    spec: ChainSpec,
    strategy: str,
    verify_block_root: bool,
    block_root: Optional[bytes],
    payload_verifier,
) -> None:
    block = signed_block.message
    if block.slot != state.slot:
        raise BlockProcessingError(f"block slot {block.slot} != state slot {state.slot}")

    verify_individual = strategy == BlockSignatureStrategy.VERIFY_INDIVIDUAL
    if strategy == BlockSignatureStrategy.VERIFY_BULK:
        verifier = BlockSignatureVerifier(state, types, spec)
        verifier.include_all_signatures(signed_block, block_root)
        if not verifier.verify():
            raise BlockProcessingError("bulk signature verification failed")
    elif strategy == BlockSignatureStrategy.VERIFY_RANDAO:
        if not sets.randao_signature_set(state, block, spec).verify():
            raise BlockProcessingError("randao signature invalid")
    elif verify_individual:
        if not sets.block_proposal_signature_set(state, signed_block, spec, block_root).verify():
            raise BlockProcessingError("proposer signature invalid")

    process_block_header(state, block, types, spec, verify_block_root)

    fork = type(state).fork_name
    # Blinded bodies (MEV) carry the payload header in place of the payload;
    # the same per-fork dispatch applies with the header standing in.
    _payload_or_header = (
        block.body.execution_payload
        if hasattr(block.body, "execution_payload")
        else getattr(block.body, "execution_payload_header", None)
    )
    if fork == "capella":
        # capella gates withdrawals+payload on execution being enabled; deneb+
        # drops the gate (merge long complete) — spec process_block per fork.
        if is_execution_enabled(state, block.body):
            process_withdrawals(state, _payload_or_header, types, spec)
            process_execution_payload(state, block.body, types, spec, payload_verifier)
    elif fork in ("deneb", "electra"):
        process_withdrawals(state, _payload_or_header, types, spec)
        process_execution_payload(state, block.body, types, spec, payload_verifier)
    elif _payload_or_header is not None and is_execution_enabled(state, block.body):
        process_execution_payload(state, block.body, types, spec, payload_verifier)

    process_randao(state, block, spec, verify=verify_individual)
    process_eth1_data(state, block.body.eth1_data, spec)
    process_operations(state, block.body, types, spec, verify_individual)
    if hasattr(block.body, "sync_aggregate"):
        process_sync_aggregate(
            state, block.body.sync_aggregate, block.slot, spec, verify=verify_individual
        )


# -------------------------------------------------------------- components


def process_block_header(state, block, types, spec: ChainSpec, verify_block_root: bool = True) -> None:
    if block.slot != state.slot:
        raise BlockProcessingError("header slot mismatch")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block older than latest header")
    proposer_index = h.get_beacon_proposer_index(state, spec)
    if block.proposer_index != proposer_index:
        raise BlockProcessingError(
            f"wrong proposer: {block.proposer_index} != {proposer_index}"
        )
    if verify_block_root and bytes(block.parent_root) != state.latest_block_header.hash_tree_root():
        raise BlockProcessingError("parent root mismatch")
    state.latest_block_header = types.BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=bytes(32),
        body_root=block.body.hash_tree_root(),
    )
    proposer = state.validators[proposer_index]
    if proposer.slashed:
        raise BlockProcessingError("proposer is slashed")


def process_randao(state, block, spec: ChainSpec, verify: bool = False) -> None:
    epoch = h.get_current_epoch(state, spec)
    if verify:
        if not sets.randao_signature_set(state, block, spec).verify():
            raise BlockProcessingError("randao reveal invalid")
    mix = bytes(
        a ^ b
        for a, b in zip(
            h.get_randao_mix(state, epoch, spec), h.hash(bytes(block.body.randao_reveal))
        )
    )
    state.randao_mixes[epoch % spec.preset.epochs_per_historical_vector] = mix


def process_eth1_data(state, eth1_data, spec: ChainSpec) -> None:
    state.eth1_data_votes = list(state.eth1_data_votes) + [eth1_data]
    period_slots = spec.preset.epochs_per_eth1_voting_period * spec.slots_per_epoch
    count = sum(1 for v in state.eth1_data_votes if v == eth1_data)
    if count * 2 > period_slots:
        state.eth1_data = eth1_data


def process_operations(state, body, types, spec: ChainSpec, verify: bool) -> None:
    is_electra = type(state).fork_name == "electra"
    if is_electra:
        # EIP-6110: the eth1 bridge drains up to deposit_requests_start_index,
        # then deposits flow exclusively through execution requests.
        eth1_limit = min(
            int(state.eth1_data.deposit_count), int(state.deposit_requests_start_index)
        )
        if int(state.eth1_deposit_index) < eth1_limit:
            expected_deposits = min(
                spec.preset.max_deposits, eth1_limit - int(state.eth1_deposit_index)
            )
        else:
            expected_deposits = 0
    else:
        expected_deposits = min(
            spec.preset.max_deposits,
            state.eth1_data.deposit_count - state.eth1_deposit_index,
        )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, types, spec, verify)
    for asl in body.attester_slashings:
        process_attester_slashing(state, asl, types, spec, verify)
    for att in body.attestations:
        process_attestation(state, att, types, spec, verify)
    for dep in body.deposits:
        apply_deposit(state, dep, types, spec, verify_proof=True)
    for ex in body.voluntary_exits:
        process_voluntary_exit(state, ex, types, spec, verify)
    if hasattr(body, "bls_to_execution_changes"):
        for ch in body.bls_to_execution_changes:
            process_bls_to_execution_change(state, ch, types, spec, verify)
    if hasattr(body, "execution_requests"):
        from . import electra

        for req in body.execution_requests.deposits:
            electra.process_deposit_request(state, req, types, spec)
        for req in body.execution_requests.withdrawals:
            electra.process_withdrawal_request(state, req, types, spec)
        for req in body.execution_requests.consolidations:
            electra.process_consolidation_request(state, req, types, spec)


def process_proposer_slashing(state, slashing, types, spec: ChainSpec, verify: bool) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: slot mismatch")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: proposer mismatch")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: identical headers")
    proposer = state.validators[h1.proposer_index]
    if not h.is_slashable_validator(proposer, h.get_current_epoch(state, spec)):
        raise BlockProcessingError("proposer slashing: not slashable")
    if verify:
        for s in sets.proposer_slashing_signature_sets(state, slashing, spec):
            if not s.verify():
                raise BlockProcessingError("proposer slashing: bad signature")
    h.slash_validator(state, h1.proposer_index, spec)


def process_attester_slashing(state, slashing, types, spec: ChainSpec, verify: bool) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not h.is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attester slashing: data not slashable")
    # electra slashings carry committee-spanning indexed attestations with
    # the EIP-7549 size limit
    is_electra = type(state).fork_name == "electra"
    for att in (a1, a2):
        if not h.is_valid_indexed_attestation_structure(att, spec, electra=is_electra):
            raise BlockProcessingError("attester slashing: malformed indexed attestation")
        if verify:
            if not sets.indexed_attestation_signature_set(state, att, spec).verify():
                raise BlockProcessingError("attester slashing: bad signature")
    slashed_any = False
    current_epoch = h.get_current_epoch(state, spec)
    both = sorted(set(a1.attesting_indices) & set(a2.attesting_indices))
    for index in both:
        if h.is_slashable_validator(state.validators[index], current_epoch):
            h.slash_validator(state, index, spec)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing: no-one slashed")


def _validate_attestation_data(state, data, spec: ChainSpec) -> None:
    current_epoch = h.get_current_epoch(state, spec)
    previous_epoch = h.get_previous_epoch(state, spec)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessingError("attestation: target epoch out of range")
    if data.target.epoch != h.compute_epoch_at_slot(data.slot, spec):
        raise BlockProcessingError("attestation: target/slot mismatch")
    if data.slot + spec.min_attestation_inclusion_delay > state.slot:
        raise BlockProcessingError("attestation: too fresh")
    fork = type(state).fork_name
    if fork not in ("deneb", "electra"):
        if state.slot > data.slot + spec.slots_per_epoch:
            raise BlockProcessingError("attestation: too old")
    if data.index >= h.get_committee_count_per_slot(state, data.target.epoch, spec):
        raise BlockProcessingError("attestation: bad committee index")


def process_attestation(state, attestation, types, spec: ChainSpec, verify: bool) -> None:
    data = attestation.data
    _validate_attestation_data(state, data, spec)
    committee_bits = getattr(attestation, "committee_bits", None)
    if committee_bits is not None:
        # EIP-7549: data.index must be zero; committees are selected by bits;
        # the bitlist concatenates the selected committees (length checked
        # inside get_attesting_indices).
        if int(data.index) != 0:
            raise BlockProcessingError("attestation: electra data.index != 0")
        committee_indices = h.get_committee_indices(committee_bits)
        committees_per_slot = h.get_committee_count_per_slot(
            state, h.compute_epoch_at_slot(int(data.slot), spec), spec
        )
        if not committee_indices:
            raise BlockProcessingError("attestation: no committee bits set")
        if any(ci >= committees_per_slot for ci in committee_indices):
            raise BlockProcessingError("attestation: committee index out of range")
    else:
        committee = h.get_beacon_committee(state, data.slot, data.index, spec)
        if len(attestation.aggregation_bits) != len(committee):
            raise BlockProcessingError("attestation: bitlist/committee length mismatch")

    try:
        indexed = h.get_indexed_attestation(state, attestation, types, spec)
    except ValueError as e:
        raise BlockProcessingError(f"attestation: {e}") from e
    if not h.is_valid_indexed_attestation_structure(
        indexed, spec, electra=committee_bits is not None
    ):
        raise BlockProcessingError("attestation: malformed indexed attestation")
    if verify:
        if not sets.indexed_attestation_signature_set(state, indexed, spec).verify():
            raise BlockProcessingError("attestation: bad signature")

    fork = type(state).fork_name
    if fork == "phase0":
        # Spec: the attestation's FFG source must match the state's justified
        # checkpoint for its target epoch (altair+ gets this inside
        # get_attestation_participation_flag_indices).
        is_current = data.target.epoch == h.get_current_epoch(state, spec)
        expected_source = (
            state.current_justified_checkpoint
            if is_current
            else state.previous_justified_checkpoint
        )
        if data.source != expected_source:
            raise BlockProcessingError("attestation: source checkpoint mismatch")
        pending = types.PendingAttestation(
            aggregation_bits=list(attestation.aggregation_bits),
            data=data,
            inclusion_delay=state.slot - data.slot,
            proposer_index=h.get_beacon_proposer_index(state, spec),
        )
        if is_current:
            state.current_epoch_attestations = list(state.current_epoch_attestations) + [pending]
        else:
            state.previous_epoch_attestations = list(state.previous_epoch_attestations) + [
                pending
            ]
        return

    # altair+: set participation flags, reward proposer
    inclusion_delay = state.slot - data.slot
    flags = h.get_attestation_participation_flag_indices(state, data, inclusion_delay, spec)
    if data.target.epoch == h.get_current_epoch(state, spec):
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation
    base_reward_per_increment = h.get_base_reward_per_increment(state, spec)
    proposer_reward_numerator = 0
    for i in indexed.attesting_indices:
        increments = sa.safe_div(
            int(state.validators[i].effective_balance), spec.effective_balance_increment
        )
        base_reward = sa.safe_mul(increments, base_reward_per_increment)
        ep = participation[i]
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flags and not h.has_flag(ep, flag_index):
                ep = h.add_flag(ep, flag_index)
                proposer_reward_numerator = sa.safe_add(
                    proposer_reward_numerator, sa.safe_mul(base_reward, weight)
                )
        participation[i] = ep
    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    )
    proposer_reward = sa.safe_div(proposer_reward_numerator, proposer_reward_denominator)
    h.increase_balance(state, h.get_beacon_proposer_index(state, spec), proposer_reward)


# ---------------------------------------------------------------- deposits


def is_valid_merkle_branch(leaf: bytes, branch, depth: int, index: int, root: bytes) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hash_two(bytes(branch[i]), value)
        else:
            value = hash_two(value, bytes(branch[i]))
    return value == bytes(root)


def get_validator_from_deposit(pubkey, withdrawal_credentials, amount, types,
                               spec: ChainSpec, fork: str = "phase0"):
    if fork == "electra":
        # EIP-7251: cap by credential type (compounding -> 2048 ETH)
        probe = types.Validator(
            pubkey=bytes(pubkey),
            withdrawal_credentials=bytes(withdrawal_credentials),
            effective_balance=0,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        cap = h.get_max_effective_balance(probe, spec)
    else:
        cap = spec.max_effective_balance
    effective_balance = min(
        sa.safe_sub(int(amount), sa.safe_mod(int(amount), spec.effective_balance_increment)),
        cap,
    )
    return types.Validator(
        pubkey=bytes(pubkey),
        withdrawal_credentials=bytes(withdrawal_credentials),
        effective_balance=effective_balance,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )


def _pubkey_index_map(state) -> dict:
    cc = h._caches(state)
    m = cc.get("pubkey_index")
    if m is None or len(m) != len(state.validators):
        m = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
        cc["pubkey_index"] = m
    return m


def apply_deposit(state, deposit, types, spec: ChainSpec, verify_proof: bool = True) -> None:
    if verify_proof:
        leaf = deposit.data.hash_tree_root()
        if not is_valid_merkle_branch(
            leaf,
            deposit.proof,
            DEPOSIT_CONTRACT_TREE_DEPTH + 1,  # +1 for the mixed-in list length
            state.eth1_deposit_index,
            state.eth1_data.deposit_root,
        ):
            raise BlockProcessingError("deposit: invalid merkle proof")
    state.eth1_deposit_index += 1

    if type(state).fork_name == "electra":
        # EIP-6110: eth1-bridge deposits queue as pending (slot=GENESIS_SLOT);
        # validation + registry growth happen in process_pending_deposits.
        state.pending_deposits = list(state.pending_deposits) + [
            types.PendingDeposit(
                pubkey=bytes(deposit.data.pubkey),
                withdrawal_credentials=bytes(deposit.data.withdrawal_credentials),
                amount=int(deposit.data.amount),
                signature=bytes(deposit.data.signature),
                slot=0,  # GENESIS_SLOT
            )
        ]
        return

    pubkey = bytes(deposit.data.pubkey)
    index_map = _pubkey_index_map(state)
    if pubkey not in index_map:
        # New validator: the deposit signature must be valid (individually —
        # never batched; an invalid one is *skipped*, not a block failure).
        message = sets.deposit_signature_message(deposit.data, types, spec)
        try:
            pk = sets.pubkey_cache(pubkey)
            ok = bls.SignatureSet.single_pubkey(
                bls.Signature.from_bytes(bytes(deposit.data.signature)), pk, message
            ).verify()
        except (bls.BlsError, ValueError):
            ok = False
        if not ok:
            return
        state.validators = list(state.validators) + [
            get_validator_from_deposit(
                pubkey, deposit.data.withdrawal_credentials, deposit.data.amount, types, spec
            )
        ]
        state.balances = list(state.balances) + [deposit.data.amount]
        index_map[pubkey] = len(state.validators) - 1
        _on_registry_growth(state, types)
    else:
        h.increase_balance(state, index_map[pubkey], deposit.data.amount)


def _on_registry_growth(state, types) -> None:
    if hasattr(state, "previous_epoch_participation"):
        state.previous_epoch_participation = list(state.previous_epoch_participation) + [0]
        state.current_epoch_participation = list(state.current_epoch_participation) + [0]
    if hasattr(state, "inactivity_scores"):
        state.inactivity_scores = list(state.inactivity_scores) + [0]


# ------------------------------------------------------------------- exits


def process_voluntary_exit(state, signed_exit, types, spec: ChainSpec, verify: bool) -> None:
    exit_ = signed_exit.message
    current_epoch = h.get_current_epoch(state, spec)
    if exit_.validator_index >= len(state.validators):
        raise BlockProcessingError("exit: unknown validator")
    v = state.validators[exit_.validator_index]
    if not h.is_active_validator(v, current_epoch):
        raise BlockProcessingError("exit: validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("exit: already exiting")
    if current_epoch < exit_.epoch:
        raise BlockProcessingError("exit: not yet valid")
    if current_epoch < v.activation_epoch + spec.shard_committee_period:
        raise BlockProcessingError("exit: validator too young")
    if type(state).fork_name == "electra":
        # EIP-7251: only exit when no partial withdrawals are queued
        if h.get_pending_balance_to_withdraw(state, int(exit_.validator_index)) > 0:
            raise BlockProcessingError("exit: pending partial withdrawals")
    if verify:
        if not sets.voluntary_exit_signature_set(state, signed_exit, spec).verify():
            raise BlockProcessingError("exit: bad signature")
    h.initiate_validator_exit(state, exit_.validator_index, spec)


def process_bls_to_execution_change(state, signed_change, types, spec: ChainSpec, verify: bool):
    change = signed_change.message
    if change.validator_index >= len(state.validators):
        raise BlockProcessingError("bls change: unknown validator")
    v = state.validators[change.validator_index]
    creds = bytes(v.withdrawal_credentials)
    if creds[:1] != b"\x00":
        raise BlockProcessingError("bls change: not a BLS credential")
    if creds[1:] != h.hash(bytes(change.from_bls_pubkey))[1:]:
        raise BlockProcessingError("bls change: credential/pubkey mismatch")
    if verify:
        if not sets.bls_to_execution_change_signature_set(state, signed_change, spec).verify():
            raise BlockProcessingError("bls change: bad signature")
    v.withdrawal_credentials = b"\x01" + b"\x00" * 11 + bytes(change.to_execution_address)


# --------------------------------------------------------- sync aggregate


def sync_participant_reward(state, spec: ChainSpec) -> int:
    """Spec per-participant sync reward — the ONE definition shared by the
    transition and the rewards APIs (chain/rewards.py)."""
    total_active_increments = sa.safe_div(
        h.get_total_active_balance(state, spec), spec.effective_balance_increment
    )
    total_base_rewards = sa.safe_mul(
        h.get_base_reward_per_increment(state, spec), total_active_increments
    )
    max_participant_rewards = sa.safe_div(
        sa.safe_div(
            sa.safe_mul(total_base_rewards, SYNC_REWARD_WEIGHT), WEIGHT_DENOMINATOR
        ),
        spec.slots_per_epoch,
    )
    return sa.safe_div(max_participant_rewards, spec.preset.sync_committee_size)


def sync_proposer_reward_per_bit(state, spec: ChainSpec) -> int:
    return sa.safe_div(
        sa.safe_mul(sync_participant_reward(state, spec), PROPOSER_WEIGHT),
        WEIGHT_DENOMINATOR - PROPOSER_WEIGHT,
    )


def process_sync_aggregate(state, aggregate, slot: int, spec: ChainSpec, verify: bool) -> None:
    if verify:
        s = sets.sync_aggregate_signature_set(state, aggregate, slot, None, spec)
        if s is None:
            sig = bytes(aggregate.sync_committee_signature)
            if sig != bls.INFINITY_SIGNATURE:
                raise BlockProcessingError("sync aggregate: empty but non-infinity signature")
        elif not s.verify():
            raise BlockProcessingError("sync aggregate: bad signature")

    participant_reward = sync_participant_reward(state, spec)
    proposer_reward = sync_proposer_reward_per_bit(state, spec)
    proposer_index = h.get_beacon_proposer_index(state, spec)
    index_map = _pubkey_index_map(state)
    for i, bit in enumerate(aggregate.sync_committee_bits):
        participant_index = index_map[bytes(state.current_sync_committee.pubkeys[i])]
        if bit:
            h.increase_balance(state, participant_index, participant_reward)
            h.increase_balance(state, proposer_index, proposer_reward)
        else:
            h.decrease_balance(state, participant_index, participant_reward)


# ------------------------------------------------------ execution payloads


def is_merge_transition_complete(state) -> bool:
    if not hasattr(state, "latest_execution_payload_header"):
        return False
    hdr = state.latest_execution_payload_header
    return hdr != type(hdr)()


def is_merge_transition_block(state, body) -> bool:
    payload = (body.execution_payload if hasattr(body, "execution_payload")
               else body.execution_payload_header)
    return not is_merge_transition_complete(state) and payload != type(payload)()


def is_execution_enabled(state, body) -> bool:
    return is_merge_transition_block(state, body) or is_merge_transition_complete(state)


def compute_timestamp_at_slot(state, slot: int, spec: ChainSpec) -> int:
    return state.genesis_time + slot * spec.seconds_per_slot


def process_withdrawals(state, payload, types, spec: ChainSpec) -> None:
    if type(state).fork_name == "electra":
        expected, processed_partials = h.get_expected_withdrawals_electra(
            state, types, spec
        )
    else:
        expected = h.get_expected_withdrawals(state, types, spec)
        processed_partials = 0
    if hasattr(payload, "withdrawals"):
        if list(payload.withdrawals) != expected:
            raise BlockProcessingError("withdrawals: payload does not match expected set")
    else:
        # Blinded body: the header commits to the withdrawals by root only.
        from ..types.ssz import List as SszList

        wd_list = SszList(types.Withdrawal.ssz_type, spec.preset.max_withdrawals_per_payload)
        if bytes(payload.withdrawals_root) != wd_list.hash_tree_root(expected):
            raise BlockProcessingError("withdrawals: header root does not match expected set")
    for w in expected:
        h.decrease_balance(state, w.validator_index, w.amount)
    if processed_partials:
        state.pending_partial_withdrawals = list(state.pending_partial_withdrawals)[
            processed_partials:
        ]
    if expected:
        state.next_withdrawal_index = expected[-1].index + 1
    n = len(state.validators)
    if len(expected) == spec.preset.max_withdrawals_per_payload:
        state.next_withdrawal_validator_index = (expected[-1].validator_index + 1) % n
    else:
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index + spec.preset.max_validators_per_withdrawals_sweep
        ) % n


def process_execution_payload(state, body, types, spec: ChainSpec, payload_verifier=None) -> None:
    if not hasattr(body, "execution_payload"):
        # Blinded body (MEV path, reference process_execution_payload over
        # BlindedPayload): the header stands in for the payload — the same
        # consistency checks apply, minus the engine call (the payload is
        # unknown until the relay reveals it).
        header = body.execution_payload_header
        if is_merge_transition_complete(state):
            if bytes(header.parent_hash) != bytes(
                state.latest_execution_payload_header.block_hash
            ):
                raise BlockProcessingError("blinded payload: parent hash mismatch")
        epoch = h.get_current_epoch(state, spec)
        if bytes(header.prev_randao) != bytes(h.get_randao_mix(state, epoch, spec)):
            raise BlockProcessingError("blinded payload: prev_randao mismatch")
        if header.timestamp != compute_timestamp_at_slot(state, state.slot, spec):
            raise BlockProcessingError("blinded payload: bad timestamp")
        if hasattr(body, "blob_kzg_commitments"):
            max_blobs = (
                spec.max_blobs_per_block_electra
                if type(state).fork_name == "electra"
                else spec.max_blobs_per_block
            )
            if len(body.blob_kzg_commitments) > max_blobs:
                raise BlockProcessingError("blinded payload: too many blob commitments")
        state.latest_execution_payload_header = header.copy()
        return
    payload = body.execution_payload
    if is_merge_transition_complete(state):
        if bytes(payload.parent_hash) != bytes(state.latest_execution_payload_header.block_hash):
            raise BlockProcessingError("payload: parent hash mismatch")
    epoch = h.get_current_epoch(state, spec)
    if bytes(payload.prev_randao) != bytes(h.get_randao_mix(state, epoch, spec)):
        raise BlockProcessingError("payload: prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(state, state.slot, spec):
        raise BlockProcessingError("payload: bad timestamp")
    if hasattr(body, "blob_kzg_commitments"):
        max_blobs = (
            spec.max_blobs_per_block_electra
            if type(state).fork_name == "electra"
            else spec.max_blobs_per_block
        )
        if len(body.blob_kzg_commitments) > max_blobs:
            raise BlockProcessingError("payload: too many blob commitments")
    if payload_verifier is not None:
        if not payload_verifier(payload):
            raise BlockProcessingError("payload: execution engine rejected payload")

    state.latest_execution_payload_header = execution_payload_to_header(
        payload, types, type(state).fork_name
    )


def execution_payload_to_header(payload, types, fork: str):
    """Summarize a payload as its header; by construction
    ``header.hash_tree_root() == payload.hash_tree_root()`` — the identity
    the MEV blinded-block flow relies on (the proposer's signature over the
    blinded block is valid for the unblinded one)."""
    hdr_cls = types.payload_header[fork]
    kwargs = {}
    for name in hdr_cls.fields:
        if name == "transactions_root":
            t = payload.fields["transactions"]
            kwargs[name] = t.hash_tree_root(payload.transactions)
        elif name == "withdrawals_root":
            t = payload.fields["withdrawals"]
            kwargs[name] = t.hash_tree_root(payload.withdrawals)
        else:
            kwargs[name] = getattr(payload, name)
    return hdr_cls(**kwargs)
