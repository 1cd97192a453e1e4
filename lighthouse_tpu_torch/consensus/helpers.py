"""Beacon-chain accessor/mutator helpers (the spec's ``helpers`` +
``accessors``/``mutators`` the reference spreads across
``consensus/state_processing/src/common`` and ``consensus/types``).

Conventions:
- ``state`` is a fork-specific ``BeaconState*`` container
  (``types/containers.py``); its fork is ``type(state).fork_name``.
- ``spec`` is a ``ChainSpec`` (runtime constants); preset sizes via
  ``spec.preset``.
- Per-state derived data (committee shufflings, total active balance, exit
  queue) is memoized on the state instance under ``state._cc`` — the analog
  of the reference's ``BeaconState`` caches
  (``consensus/types/src/beacon_state.rs:34``, committee_cache etc.).
  Mutating helpers invalidate what they must.

A copy of the JAX package's ``lighthouse_tpu/consensus/helpers.py``;
``get_next_sync_committee`` aggregates through the port's BLS API
(``crypto/bls/api.py``) and ``signature_sets.pubkey_cache``.
"""

from __future__ import annotations

from hashlib import sha256
from typing import List, Optional, Sequence

import numpy as np

from ..types.spec import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_SYNC_COMMITTEE,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    ChainSpec,
)
from ..types.ssz import hash_two
from . import safe_arith as sa
from .shuffling import compute_shuffled_index, shuffle_list

MAX_RANDOM_BYTE = 2**8 - 1


def hash(data: bytes) -> bytes:  # spec name
    return sha256(data).digest()


def uint_to_bytes(n: int) -> bytes:
    return int(n).to_bytes(8, "little")


# ------------------------------------------------------------------ time


def compute_epoch_at_slot(slot: int, spec: ChainSpec) -> int:
    return slot // spec.slots_per_epoch


def compute_start_slot_at_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch * spec.slots_per_epoch


def compute_activation_exit_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch + 1 + spec.max_seed_lookahead


def get_current_epoch(state, spec: ChainSpec) -> int:
    return compute_epoch_at_slot(state.slot, spec)


def get_previous_epoch(state, spec: ChainSpec) -> int:
    cur = get_current_epoch(state, spec)
    return GENESIS_EPOCH if cur == GENESIS_EPOCH else cur - 1


# --------------------------------------------------------------- domains


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return hash_two(current_version + b"\x00" * 28, genesis_validators_root)


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: Optional[bytes] = None,
    genesis_validators_root: Optional[bytes] = None,
) -> bytes:
    if fork_version is None:
        fork_version = bytes(4)
    if genesis_validators_root is None:
        genesis_validators_root = bytes(32)
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def get_domain(state, domain_type: bytes, epoch: Optional[int], spec: ChainSpec) -> bytes:
    epoch = get_current_epoch(state, spec) if epoch is None else epoch
    fork_version = (
        state.fork.previous_version if epoch < state.fork.epoch else state.fork.current_version
    )
    return compute_domain(domain_type, fork_version, state.genesis_validators_root)


def compute_signing_root(obj, domain: bytes) -> bytes:
    """``hash_tree_root(SigningData(object_root, domain))``; accepts a
    container or a pre-computed 32-byte object root."""
    root = obj if isinstance(obj, bytes) else obj.hash_tree_root()
    return hash_two(root, domain)


# ------------------------------------------------------------- accessors


def get_randao_mix(state, epoch: int, spec: ChainSpec) -> bytes:
    return state.randao_mixes[epoch % spec.preset.epochs_per_historical_vector]


def get_seed(state, epoch: int, domain_type: bytes, spec: ChainSpec) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + spec.preset.epochs_per_historical_vector - spec.min_seed_lookahead - 1,
        spec,
    )
    return hash(domain_type + uint_to_bytes(epoch) + mix)


def get_block_root_at_slot(state, slot: int, spec: ChainSpec) -> bytes:
    assert slot < state.slot <= slot + spec.preset.slots_per_historical_root
    return state.block_roots[slot % spec.preset.slots_per_historical_root]


def get_block_root(state, epoch: int, spec: ChainSpec) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch, spec), spec)


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    acts = np.fromiter((v.activation_epoch for v in state.validators), dtype=np.uint64)
    exits = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64)
    return np.nonzero((acts <= epoch) & (np.uint64(epoch) < exits))[0].astype(np.int64)


def get_validator_churn_limit(state, spec: ChainSpec) -> int:
    # Constant within an epoch; memoized because mass ejections call this once
    # per exit and each miss re-scans the whole registry.
    cc = _caches(state)
    epoch = get_current_epoch(state, spec)
    hit = cc.get("churn_limit")
    if hit is not None and hit[0] == epoch:
        return hit[1]
    n_active = len(get_active_validator_indices(state, epoch))
    limit = max(spec.min_per_epoch_churn_limit, n_active // spec.churn_limit_quotient)
    cc["churn_limit"] = (epoch, limit)
    return limit


def get_validator_activation_churn_limit(state, spec: ChainSpec) -> int:
    """Deneb caps the activation churn (EIP-7514)."""
    limit = get_validator_churn_limit(state, spec)
    if type(state).fork_name in ("deneb", "electra"):
        return min(spec.max_per_epoch_activation_churn_limit, limit)
    return limit


# -------------------------------------------------------------- balances


def get_total_balance(state, indices, spec: ChainSpec) -> int:
    total = sum(int(state.validators[i].effective_balance) for i in indices)
    return max(spec.effective_balance_increment, total)


def get_total_active_balance(state, spec: ChainSpec) -> int:
    cc = _caches(state)
    epoch = get_current_epoch(state, spec)
    hit = cc.get("total_active_balance")
    if hit is not None and hit[0] == epoch:
        return hit[1]
    total = get_total_balance(state, get_active_validator_indices(state, epoch), spec)
    cc["total_active_balance"] = (epoch, total)
    return total


def increase_balance(state, index: int, delta: int) -> None:
    # Checked: a balance past u64 is an invalid block, not a bignum
    # (reference mutators.rs increase_balance -> safe_add_assign).
    state.balances[index] = sa.safe_add(int(state.balances[index]), int(delta))


def decrease_balance(state, index: int, delta: int) -> None:
    # Spec decrease_balance saturates at zero by definition.
    state.balances[index] = sa.saturating_sub(int(state.balances[index]), int(delta))


# ----------------------------------------------------- committee shuffling


class CommitteeCache:
    """One epoch's full shuffling + committee geometry, the analog of the
    reference's ``CommitteeCache`` (``consensus/types/src/beacon_state/
    committee_cache.rs``): compute the whole-list shuffle once, then every
    committee is an O(1) slice."""

    def __init__(self, state, epoch: int, spec: ChainSpec):
        self.epoch = epoch
        self.spec = spec
        self.active_indices = get_active_validator_indices(state, epoch)
        n = len(self.active_indices)
        if n == 0:
            raise ValueError(f"no active validators at epoch {epoch}")
        seed = get_seed(state, epoch, DOMAIN_BEACON_ATTESTER, spec)
        self.seed = seed
        self.shuffling = shuffle_list(self.active_indices, seed, spec.preset.shuffle_round_count)
        self.committees_per_slot = max(
            1,
            min(
                spec.preset.max_committees_per_slot,
                n // spec.slots_per_epoch // spec.preset.target_committee_size,
            ),
        )

    @classmethod
    def from_precomputed(cls, state, epoch: int, spec: ChainSpec,
                         active_indices, shuffling, seed: bytes
                         ) -> "CommitteeCache":
        """Build the cache from an already-computed shuffling (the fused
        epoch-boundary dispatch returns the next epoch's whole-list shuffle;
        recomputing it host-side would redo the O(n) work the device just
        did).  The caller is responsible for ``active_indices``/``seed``
        matching the state — ``per_epoch._prime_duty_caches`` validates
        both before seeding."""
        self = cls.__new__(cls)
        self.epoch = epoch
        self.spec = spec
        self.active_indices = np.asarray(active_indices, dtype=np.int64)
        n = len(self.active_indices)
        if n == 0:
            raise ValueError(f"no active validators at epoch {epoch}")
        self.seed = seed
        self.shuffling = np.asarray(shuffling, dtype=np.int64)
        self.committees_per_slot = max(
            1,
            min(
                spec.preset.max_committees_per_slot,
                n // spec.slots_per_epoch // spec.preset.target_committee_size,
            ),
        )
        return self

    def get_beacon_committee(self, slot: int, index: int) -> np.ndarray:
        spec = self.spec
        assert compute_epoch_at_slot(slot, spec) == self.epoch
        assert index < self.committees_per_slot
        committees_per_epoch = self.committees_per_slot * spec.slots_per_epoch
        global_index = (slot % spec.slots_per_epoch) * self.committees_per_slot + index
        n = len(self.active_indices)
        start = n * global_index // committees_per_epoch
        end = n * (global_index + 1) // committees_per_epoch
        return self.shuffling[start:end]


def _caches(state) -> dict:
    cc = getattr(state, "_cc", None)
    if cc is None:
        cc = {}
        state._cc = cc
    return cc


def invalidate_caches(state) -> None:
    """Drop memoized derived data after a registry-shape mutation."""
    state._cc = {}


def committee_cache(state, epoch: int, spec: ChainSpec) -> CommitteeCache:
    cur = get_current_epoch(state, spec)
    assert cur - 1 <= epoch <= cur + 1, f"epoch {epoch} out of committee range at {cur}"
    cc = _caches(state).setdefault("committees", {})
    hit = cc.get(epoch)
    if hit is None:
        hit = cc[epoch] = CommitteeCache(state, epoch, spec)
    return hit


def get_committee_count_per_slot(state, epoch: int, spec: ChainSpec) -> int:
    return committee_cache(state, epoch, spec).committees_per_slot


def get_beacon_committee(state, slot: int, index: int, spec: ChainSpec) -> np.ndarray:
    epoch = compute_epoch_at_slot(slot, spec)
    return committee_cache(state, epoch, spec).get_beacon_committee(slot, index)


def compute_proposer_index(state, indices: Sequence[int], seed: bytes, spec: ChainSpec) -> int:
    """Spec rejection sampling, weighted by effective balance."""
    assert len(indices) > 0
    total = len(indices)
    max_eb = spec.max_effective_balance
    i = 0
    while True:
        candidate = int(indices[compute_shuffled_index(i % total, total, seed, spec.preset.shuffle_round_count)])
        random_byte = hash(seed + uint_to_bytes(i // 32))[i % 32]
        lhs = sa.safe_mul(int(state.validators[candidate].effective_balance), MAX_RANDOM_BYTE)
        if lhs >= sa.safe_mul(max_eb, random_byte):
            return candidate
        i += 1


def get_beacon_proposer_index(state, spec: ChainSpec, slot: Optional[int] = None) -> int:
    slot = state.slot if slot is None else slot
    epoch = compute_epoch_at_slot(slot, spec)
    assert epoch == get_current_epoch(state, spec)
    cc = _caches(state).setdefault("proposers", {})
    hit = cc.get(slot)
    if hit is not None:
        return hit
    seed = hash(get_seed(state, epoch, DOMAIN_BEACON_PROPOSER, spec) + uint_to_bytes(slot))
    indices = get_active_validator_indices(state, epoch)
    proposer = compute_proposer_index(state, indices, seed, spec)
    cc[slot] = proposer
    return proposer


# ------------------------------------------------------------- predicates


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_slashable_attestation_data(data_1, data_2) -> bool:
    # Double vote or surround vote (attestation data inequality is implied
    # by differing hash_tree_root in callers).
    double = data_1 != data_2 and data_1.target.epoch == data_2.target.epoch
    surround = (
        data_1.source.epoch < data_2.source.epoch and data_2.target.epoch < data_1.target.epoch
    )
    return double or surround


def is_eligible_for_activation_queue(v, spec: ChainSpec, fork: str = "phase0") -> bool:
    if fork == "electra":
        # EIP-7251: any balance >= 32 ETH queues
        return (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance >= spec.min_activation_balance
        )
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == spec.max_effective_balance
    )


def is_eligible_for_activation(state, v) -> bool:
    return (
        v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and v.activation_epoch == FAR_FUTURE_EPOCH
    )


# ----------------------------------------------------------- attestations


def get_attesting_indices(state, data, aggregation_bits, spec: ChainSpec,
                          committee_bits=None) -> List[int]:
    if committee_bits is not None:
        # EIP-7549: one attestation spans the slot's committees, selected by
        # committee_bits; aggregation_bits concatenates those committees.
        output = set()
        offset = 0
        bits = list(aggregation_bits)
        for committee_index in get_committee_indices(committee_bits):
            committee = get_beacon_committee(state, data.slot, committee_index, spec)
            for pos, vidx in enumerate(committee):
                if offset + pos < len(bits) and bits[offset + pos]:
                    output.add(int(vidx))
            offset += len(committee)
        if offset != len(bits):
            raise ValueError("electra aggregation bitlist length mismatch")
        return sorted(output)
    committee = get_beacon_committee(state, data.slot, data.index, spec)
    if len(aggregation_bits) != len(committee):
        raise ValueError("aggregation bitlist length != committee size")
    return sorted(int(committee[i]) for i, bit in enumerate(aggregation_bits) if bit)


def get_indexed_attestation(state, attestation, types, spec: ChainSpec):
    committee_bits = getattr(attestation, "committee_bits", None)
    indices = get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits, spec,
        committee_bits=committee_bits,
    )
    cls = (
        types.IndexedAttestationElectra
        if committee_bits is not None
        else types.IndexedAttestation
    )
    return cls(
        attesting_indices=indices,
        data=attestation.data,
        signature=attestation.signature,
    )


def is_valid_indexed_attestation_structure(indexed, spec: ChainSpec,
                                           electra: bool = False) -> bool:
    """Structural half of ``is_valid_indexed_attestation`` (signature checks
    happen through the batched BLS path, signature_sets.py)."""
    indices = list(indexed.attesting_indices)
    limit = spec.preset.max_validators_per_committee
    if electra:
        limit *= spec.preset.max_committees_per_slot  # EIP-7549 span
    if not indices or len(indices) > limit:
        return False
    return indices == sorted(set(indices))


# --------------------------------------------------------------- mutators


def _exit_queue(state, spec: ChainSpec):
    """(exit_queue_epoch, churn) maintained incrementally — ExitCache analog
    (``beacon_chain``'s exit cache in the reference types crate)."""
    cc = _caches(state)
    hit = cc.get("exit_queue")
    if hit is None:
        exit_epochs = [v.exit_epoch for v in state.validators if v.exit_epoch != FAR_FUTURE_EPOCH]
        eq = max(
            exit_epochs + [compute_activation_exit_epoch(get_current_epoch(state, spec), spec)]
        )
        churn = sum(1 for e in exit_epochs if e == eq)
        hit = cc["exit_queue"] = [eq, churn]
    # exit queue epoch can never be before the current activation-exit epoch
    floor = compute_activation_exit_epoch(get_current_epoch(state, spec), spec)
    if hit[0] < floor:
        hit[0], hit[1] = floor, 0
    return hit


def initiate_validator_exit(state, index: int, spec: ChainSpec) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if type(state).fork_name == "electra":
        # EIP-7251: balance-weighted exit churn
        v.exit_epoch = compute_exit_epoch_and_update_churn(
            state, int(v.effective_balance), spec
        )
        v.withdrawable_epoch = v.exit_epoch + spec.min_validator_withdrawability_delay
        _caches(state).pop("total_active_balance", None)
        return
    eq = _exit_queue(state, spec)
    if eq[1] >= get_validator_churn_limit(state, spec):
        eq[0] += 1
        eq[1] = 0
    v.exit_epoch = eq[0]
    v.withdrawable_epoch = v.exit_epoch + spec.min_validator_withdrawability_delay
    eq[1] += 1
    _caches(state).pop("total_active_balance", None)


def slash_validator(
    state, slashed_index: int, spec: ChainSpec, whistleblower_index: Optional[int] = None
) -> None:
    fork = type(state).fork_name
    epoch = get_current_epoch(state, spec)
    initiate_validator_exit(state, slashed_index, spec)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(
        v.withdrawable_epoch,
        epoch + spec.preset.epochs_per_slashings_vector,  # safe-arith: ok(epoch arithmetic, not gwei)
    )
    slash_slot = epoch % spec.preset.epochs_per_slashings_vector
    state.slashings[slash_slot] = sa.safe_add(
        int(state.slashings[slash_slot]), int(v.effective_balance)
    )

    if fork == "phase0":
        min_quotient = spec.min_slashing_penalty_quotient
    elif fork == "altair":
        min_quotient = spec.min_slashing_penalty_quotient_altair
    elif fork == "electra":
        min_quotient = spec.min_slashing_penalty_quotient_electra
    else:
        min_quotient = spec.min_slashing_penalty_quotient_bellatrix
    decrease_balance(state, slashed_index, v.effective_balance // min_quotient)

    proposer_index = get_beacon_proposer_index(state, spec)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    wb_quotient = (
        spec.whistleblower_reward_quotient_electra
        if fork == "electra"
        else spec.whistleblower_reward_quotient
    )
    whistleblower_reward = sa.safe_div(int(v.effective_balance), wb_quotient)
    if fork == "phase0":
        proposer_reward = sa.safe_div(whistleblower_reward, spec.proposer_reward_quotient)
    else:
        from ..types.spec import PROPOSER_WEIGHT, WEIGHT_DENOMINATOR

        proposer_reward = sa.safe_div(
            sa.safe_mul(whistleblower_reward, PROPOSER_WEIGHT), WEIGHT_DENOMINATOR
        )
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, sa.safe_sub(whistleblower_reward, proposer_reward))


# ----------------------------------------------------------------- altair


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def get_base_reward_per_increment(state, spec: ChainSpec) -> int:
    return sa.safe_div(
        sa.safe_mul(spec.effective_balance_increment, spec.base_reward_factor),
        spec.integer_squareroot(get_total_active_balance(state, spec)),
    )


def get_base_reward(state, index: int, spec: ChainSpec) -> int:
    increments = sa.safe_div(
        int(state.validators[index].effective_balance), spec.effective_balance_increment
    )
    return sa.safe_mul(increments, get_base_reward_per_increment(state, spec))


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, spec: ChainSpec
) -> List[int]:
    fork = type(state).fork_name
    if data.target.epoch == get_current_epoch(state, spec):
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    if not is_matching_source:
        raise ValueError("attestation source does not match justified checkpoint")
    is_matching_target = data.target.root == get_block_root(state, data.target.epoch, spec)
    is_matching_head = (
        is_matching_target
        and data.beacon_block_root == get_block_root_at_slot(state, data.slot, spec)
    )

    flags = []
    if inclusion_delay <= spec.integer_squareroot(spec.slots_per_epoch):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and (
        fork in ("deneb", "electra") or inclusion_delay <= spec.slots_per_epoch
    ):
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_next_sync_committee_indices(state, spec: ChainSpec) -> List[int]:
    epoch = get_current_epoch(state, spec) + 1
    active = get_active_validator_indices(state, epoch)
    n = len(active)
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE, spec)
    max_eb = spec.max_effective_balance
    out: List[int] = []
    i = 0
    while len(out) < spec.preset.sync_committee_size:
        shuffled = compute_shuffled_index(i % n, n, seed, spec.preset.shuffle_round_count)
        candidate = int(active[shuffled])
        random_byte = hash(seed + uint_to_bytes(i // 32))[i % 32]
        lhs = sa.safe_mul(int(state.validators[candidate].effective_balance), MAX_RANDOM_BYTE)
        if lhs >= sa.safe_mul(max_eb, random_byte):
            out.append(candidate)
        i += 1
    return out


def get_next_sync_committee(state, types, spec: ChainSpec):
    from ..crypto.bls import api as bls
    from .signature_sets import pubkey_cache

    indices = get_next_sync_committee_indices(state, spec)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    agg = bls.AggregatePublicKey.aggregate([pubkey_cache(pk) for pk in pubkeys])
    return types.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=agg.to_public_key().to_bytes())


def compute_sync_committee_period(epoch: int, spec: ChainSpec) -> int:
    return epoch // spec.preset.epochs_per_sync_committee_period


# ---------------------------------------------------------------- capella


def has_eth1_withdrawal_credential(v) -> bool:
    return bytes(v.withdrawal_credentials)[:1] == b"\x01"


def is_fully_withdrawable_validator(v, balance: int, epoch: int) -> bool:
    return has_eth1_withdrawal_credential(v) and v.withdrawable_epoch <= epoch and balance > 0


def is_partially_withdrawable_validator(v, balance: int, spec: ChainSpec) -> bool:
    return (
        has_eth1_withdrawal_credential(v)
        and v.effective_balance == spec.max_effective_balance
        and balance > spec.max_effective_balance
    )


# ---------------------------------------------------------------- electra
# EIP-7251 (maxEB), EIP-7549 (committee-spanning attestations),
# EIP-7002/6110 (execution-triggered exits / deposits).  Reference:
# consensus/types + state_processing electra arms.


def has_compounding_withdrawal_credential(v, spec: ChainSpec) -> bool:
    return bytes(v.withdrawal_credentials)[:1] == spec.compounding_withdrawal_prefix


def has_execution_withdrawal_credential(v, spec: ChainSpec) -> bool:
    return has_compounding_withdrawal_credential(v, spec) or has_eth1_withdrawal_credential(v)


def get_max_effective_balance(v, spec: ChainSpec) -> int:
    if has_compounding_withdrawal_credential(v, spec):
        return spec.max_effective_balance_electra
    return spec.min_activation_balance


def is_fully_withdrawable_validator_electra(v, balance: int, epoch: int, spec) -> bool:
    return (
        has_execution_withdrawal_credential(v, spec)
        and v.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator_electra(v, balance: int, spec: ChainSpec) -> bool:
    max_eb = get_max_effective_balance(v, spec)
    return (
        has_execution_withdrawal_credential(v, spec)
        and v.effective_balance == max_eb
        and balance > max_eb
    )


def get_balance_churn_limit(state, spec: ChainSpec) -> int:
    """Per-epoch churn in GWEI (EIP-7251 replaces count-based churn)."""
    churn = max(
        spec.min_per_epoch_churn_limit_electra,
        sa.safe_div(get_total_active_balance(state, spec), spec.churn_limit_quotient),
    )
    return sa.safe_sub(churn, sa.safe_mod(churn, spec.effective_balance_increment))


def get_activation_exit_churn_limit(state, spec: ChainSpec) -> int:
    return min(spec.max_per_epoch_activation_exit_churn_limit,
               get_balance_churn_limit(state, spec))


def get_consolidation_churn_limit(state, spec: ChainSpec) -> int:
    return get_balance_churn_limit(state, spec) - get_activation_exit_churn_limit(state, spec)


def get_pending_balance_to_withdraw(state, validator_index: int) -> int:
    return sum(
        int(w.amount)
        for w in state.pending_partial_withdrawals
        if int(w.validator_index) == validator_index
    )


def compute_exit_epoch_and_update_churn(state, exit_balance: int, spec: ChainSpec) -> int:
    earliest = max(
        int(state.earliest_exit_epoch),
        compute_activation_exit_epoch(get_current_epoch(state, spec), spec),
    )
    per_epoch_churn = get_activation_exit_churn_limit(state, spec)
    if int(state.earliest_exit_epoch) < earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = int(state.exit_balance_to_consume)
    if exit_balance > balance_to_consume:
        balance_to_process = sa.safe_sub(exit_balance, balance_to_consume)
        additional_epochs = sa.safe_div(sa.safe_sub(balance_to_process, 1), per_epoch_churn) + 1
        earliest += additional_epochs
        balance_to_consume = sa.safe_add(
            balance_to_consume, sa.safe_mul(additional_epochs, per_epoch_churn)
        )
    state.exit_balance_to_consume = sa.safe_sub(balance_to_consume, exit_balance)
    state.earliest_exit_epoch = earliest
    return earliest


def compute_consolidation_epoch_and_update_churn(
    state, consolidation_balance: int, spec: ChainSpec
) -> int:
    earliest = max(
        int(state.earliest_consolidation_epoch),
        compute_activation_exit_epoch(get_current_epoch(state, spec), spec),
    )
    per_epoch_churn = get_consolidation_churn_limit(state, spec)
    if int(state.earliest_consolidation_epoch) < earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = int(state.consolidation_balance_to_consume)
    if consolidation_balance > balance_to_consume:
        balance_to_process = sa.safe_sub(consolidation_balance, balance_to_consume)
        additional_epochs = sa.safe_div(sa.safe_sub(balance_to_process, 1), per_epoch_churn) + 1
        earliest += additional_epochs
        balance_to_consume = sa.safe_add(
            balance_to_consume, sa.safe_mul(additional_epochs, per_epoch_churn)
        )
    state.consolidation_balance_to_consume = sa.safe_sub(
        balance_to_consume, consolidation_balance
    )
    state.earliest_consolidation_epoch = earliest
    return earliest


def switch_to_compounding_validator(state, index: int, types, spec: ChainSpec) -> None:
    v = state.validators[index]
    v.withdrawal_credentials = (
        spec.compounding_withdrawal_prefix + bytes(v.withdrawal_credentials)[1:]
    )
    queue_excess_active_balance(state, index, types, spec)


def queue_excess_active_balance(state, index: int, types, spec: ChainSpec) -> None:
    balance = int(state.balances[index])
    if balance > spec.min_activation_balance:
        excess = sa.safe_sub(balance, spec.min_activation_balance)
        state.balances[index] = spec.min_activation_balance
        v = state.validators[index]
        state.pending_deposits = list(state.pending_deposits) + [
            types.PendingDeposit(
                pubkey=bytes(v.pubkey),
                withdrawal_credentials=bytes(v.withdrawal_credentials),
                amount=excess,
                signature=b"\xc0" + b"\x00" * 95,  # G2_POINT_AT_INFINITY
                slot=0,  # GENESIS_SLOT
            )
        ]


def get_committee_indices(committee_bits) -> List[int]:
    return [i for i, bit in enumerate(committee_bits) if bit]


def attestation_dedup_key(attestation) -> bytes:
    """Pool dedup/merge key: data root, extended with committee_bits for
    electra attestations (identical data with different committee_bits index
    DIFFERENT committees and must never merge).  Single source of truth for
    the naive pool and the op pool."""
    cb = getattr(attestation, "committee_bits", None)
    key = attestation.data.hash_tree_root()
    if cb is not None:
        key += bytes(1 if b else 0 for b in cb)
    return key


def get_expected_withdrawals_electra(state, types, spec: ChainSpec):
    """(withdrawals, processed_partial_count): EIP-7002 pending partial
    withdrawals drain first, then the compounding-aware validator sweep."""
    epoch = get_current_epoch(state, spec)
    withdrawal_index = int(state.next_withdrawal_index)
    withdrawals = []
    processed_partials = 0
    for w in state.pending_partial_withdrawals:
        if (
            int(w.withdrawable_epoch) > epoch
            or len(withdrawals) == spec.preset.max_pending_partials_per_withdrawals_sweep
        ):
            break
        vidx = int(w.validator_index)
        v = state.validators[vidx]
        has_sufficient_eb = int(v.effective_balance) >= spec.min_activation_balance
        has_excess = int(state.balances[vidx]) > spec.min_activation_balance
        if v.exit_epoch == FAR_FUTURE_EPOCH and has_sufficient_eb and has_excess:
            withdrawable = min(
                sa.safe_sub(int(state.balances[vidx]), spec.min_activation_balance),
                int(w.amount),
            )
            withdrawals.append(types.Withdrawal(
                index=withdrawal_index,
                validator_index=vidx,
                address=bytes(v.withdrawal_credentials)[12:],
                amount=withdrawable,
            ))
            withdrawal_index += 1
        processed_partials += 1

    n = len(state.validators)
    validator_index = int(state.next_withdrawal_validator_index)
    bound = min(n, spec.preset.max_validators_per_withdrawals_sweep)
    for _ in range(bound):
        v = state.validators[validator_index]
        # subtract partials already included for this validator this payload
        partially_withdrawn = sum(
            int(w.amount) for w in withdrawals if int(w.validator_index) == validator_index
        )
        balance = sa.safe_sub(int(state.balances[validator_index]), partially_withdrawn)
        if is_fully_withdrawable_validator_electra(v, balance, epoch, spec):
            withdrawals.append(types.Withdrawal(
                index=withdrawal_index,
                validator_index=validator_index,
                address=bytes(v.withdrawal_credentials)[12:],
                amount=balance,
            ))
            withdrawal_index += 1
        elif is_partially_withdrawable_validator_electra(v, balance, spec):
            withdrawals.append(types.Withdrawal(
                index=withdrawal_index,
                validator_index=validator_index,
                address=bytes(v.withdrawal_credentials)[12:],
                amount=sa.safe_sub(balance, get_max_effective_balance(v, spec)),
            ))
            withdrawal_index += 1
        if len(withdrawals) == spec.preset.max_withdrawals_per_payload:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals, processed_partials


def get_expected_withdrawals(state, types, spec: ChainSpec):
    if type(state).fork_name == "electra":
        return get_expected_withdrawals_electra(state, types, spec)[0]
    epoch = get_current_epoch(state, spec)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals = []
    n = len(state.validators)
    bound = min(n, spec.preset.max_validators_per_withdrawals_sweep)
    for _ in range(bound):
        v = state.validators[validator_index]
        balance = state.balances[validator_index]
        if is_fully_withdrawable_validator(v, balance, epoch):
            withdrawals.append(
                types.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(v.withdrawal_credentials)[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif is_partially_withdrawable_validator(v, balance, spec):
            withdrawals.append(
                types.Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(v.withdrawal_credentials)[12:],
                    amount=sa.safe_sub(balance, spec.max_effective_balance),
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == spec.preset.max_withdrawals_per_payload:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals
