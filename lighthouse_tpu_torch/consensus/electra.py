"""Electra (Pectra) state-transition operations.

EIP-6110 (execution-layer deposits), EIP-7002 (execution-triggered exits),
EIP-7251 (maxEB / consolidations), EIP-7549 (committee-spanning
attestations).  Reference: the electra arms across
``consensus/state_processing`` and ``consensus/types`` in the reference tree
(``process_operations``'s requests loop, ``single_pass.rs`` pending
deposits/consolidations).

Block-level entry points are dispatched from ``per_block.py``; epoch phases
from ``per_epoch.py``.

A copy of the JAX package's ``lighthouse_tpu/consensus/electra.py``.
"""

from __future__ import annotations

from typing import List

from ..types.spec import FAR_FUTURE_EPOCH, ChainSpec
from . import helpers as h
from . import safe_arith as sa
from . import signature_sets as sets

GENESIS_SLOT = 0


class ElectraError(ValueError):
    pass


# ------------------------------------------------------------ block: requests


def process_deposit_request(state, request, types, spec: ChainSpec) -> None:
    """EIP-6110: deposits surfaced by the EL land in the pending queue."""
    if int(state.deposit_requests_start_index) == spec.unset_deposit_requests_start_index:
        state.deposit_requests_start_index = int(request.index)
    state.pending_deposits = list(state.pending_deposits) + [
        types.PendingDeposit(
            pubkey=bytes(request.pubkey),
            withdrawal_credentials=bytes(request.withdrawal_credentials),
            amount=int(request.amount),
            signature=bytes(request.signature),
            slot=int(state.slot),
        )
    ]


def process_withdrawal_request(state, request, types, spec: ChainSpec) -> None:
    """EIP-7002: full/partial exits triggered from the execution layer.
    Invalid requests are silently dropped (spec behavior — the EL cannot be
    trusted to pre-validate consensus state)."""
    amount = int(request.amount)
    is_full_exit = amount == spec.full_exit_request_amount
    if not is_full_exit and (
        len(state.pending_partial_withdrawals) == spec.preset.pending_partial_withdrawals_limit
    ):
        return
    from .per_block import _pubkey_index_map

    pubkey = bytes(request.validator_pubkey)
    index = _pubkey_index_map(state).get(pubkey)
    if index is None:
        return
    v = state.validators[index]
    if not h.has_execution_withdrawal_credential(v, spec):
        return
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    current_epoch = h.get_current_epoch(state, spec)
    if not h.is_active_validator(v, current_epoch):
        return
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if current_epoch < int(v.activation_epoch) + spec.shard_committee_period:
        return

    pending_balance = h.get_pending_balance_to_withdraw(state, index)
    if is_full_exit:
        if pending_balance == 0:
            h.initiate_validator_exit(state, index, spec)
        return
    has_sufficient_eb = int(v.effective_balance) >= spec.min_activation_balance
    has_excess = int(state.balances[index]) > sa.safe_add(
        spec.min_activation_balance, pending_balance
    )
    if h.has_compounding_withdrawal_credential(v, spec) and has_sufficient_eb and has_excess:
        to_withdraw = min(
            sa.safe_sub(
                sa.safe_sub(int(state.balances[index]), spec.min_activation_balance),
                pending_balance,
            ),
            amount,
        )
        exit_queue_epoch = h.compute_exit_epoch_and_update_churn(state, to_withdraw, spec)
        state.pending_partial_withdrawals = list(state.pending_partial_withdrawals) + [
            types.PendingPartialWithdrawal(
                validator_index=index,
                amount=to_withdraw,
                withdrawable_epoch=exit_queue_epoch
                + spec.min_validator_withdrawability_delay,
            )
        ]


def _is_valid_switch_to_compounding_request(state, request, spec: ChainSpec) -> bool:
    if bytes(request.source_pubkey) != bytes(request.target_pubkey):
        return False
    from .per_block import _pubkey_index_map

    pubkey = bytes(request.source_pubkey)
    index = _pubkey_index_map(state).get(pubkey)
    if index is None:
        return False
    v = state.validators[index]
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return False
    if not h.has_eth1_withdrawal_credential(v):
        return False
    current_epoch = h.get_current_epoch(state, spec)
    if not h.is_active_validator(v, current_epoch) or v.exit_epoch != FAR_FUTURE_EPOCH:
        return False
    return True


def process_consolidation_request(state, request, types, spec: ChainSpec) -> None:
    """EIP-7251: merge one validator's stake into another (or switch self to
    compounding credentials)."""
    from .per_block import _pubkey_index_map

    if _is_valid_switch_to_compounding_request(state, request, spec):
        index = _pubkey_index_map(state)[bytes(request.source_pubkey)]
        h.switch_to_compounding_validator(state, index, types, spec)
        return
    # churn must be available and the queue not full
    if h.get_consolidation_churn_limit(state, spec) <= spec.min_activation_balance:
        return
    if len(state.pending_consolidations) == spec.preset.pending_consolidations_limit:
        return
    src_pk, tgt_pk = bytes(request.source_pubkey), bytes(request.target_pubkey)
    if src_pk == tgt_pk:
        return
    index_map = _pubkey_index_map(state)
    src, tgt = index_map.get(src_pk), index_map.get(tgt_pk)
    if src is None or tgt is None:
        return
    sv, tv = state.validators[src], state.validators[tgt]
    if bytes(sv.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    if not h.has_execution_withdrawal_credential(sv, spec):
        return
    if not h.has_compounding_withdrawal_credential(tv, spec):
        return
    current_epoch = h.get_current_epoch(state, spec)
    if not h.is_active_validator(sv, current_epoch) or not h.is_active_validator(
        tv, current_epoch
    ):
        return
    if sv.exit_epoch != FAR_FUTURE_EPOCH or tv.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if current_epoch < int(sv.activation_epoch) + spec.shard_committee_period:
        return
    if h.get_pending_balance_to_withdraw(state, src) > 0:
        return

    sv.exit_epoch = h.compute_consolidation_epoch_and_update_churn(
        state, int(sv.effective_balance), spec
    )
    sv.withdrawable_epoch = sv.exit_epoch + spec.min_validator_withdrawability_delay
    state.pending_consolidations = list(state.pending_consolidations) + [
        types.PendingConsolidation(source_index=src, target_index=tgt)
    ]


# ------------------------------------------------------------- epoch phases


def _is_valid_deposit_signature(pubkey, withdrawal_credentials, amount, signature,
                                types, spec: ChainSpec) -> bool:
    from ..crypto.bls import api as bls

    msg_obj = types.DepositData(
        pubkey=pubkey,
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
        signature=signature,
    )
    message = sets.deposit_signature_message(msg_obj, types, spec)
    try:
        pk = sets.pubkey_cache(bytes(pubkey))
        return bls.SignatureSet.single_pubkey(
            bls.Signature.from_bytes(bytes(signature)), pk, message
        ).verify()
    except (bls.BlsError, ValueError):
        return False


def _add_validator_to_registry(state, pubkey, withdrawal_credentials, amount,
                               types, spec: ChainSpec) -> None:
    from .per_block import _on_registry_growth, get_validator_from_deposit

    state.validators = list(state.validators) + [
        get_validator_from_deposit(
            pubkey, withdrawal_credentials, amount, types, spec, fork="electra"
        )
    ]
    state.balances = list(state.balances) + [int(amount)]
    _on_registry_growth(state, types)
    h.invalidate_caches(state)


def _apply_pending_deposit(state, deposit, types, spec: ChainSpec) -> None:
    from .per_block import _pubkey_index_map

    pubkey = bytes(deposit.pubkey)
    index = _pubkey_index_map(state).get(pubkey)
    if index is None:
        if _is_valid_deposit_signature(
            deposit.pubkey, deposit.withdrawal_credentials, int(deposit.amount),
            deposit.signature, types, spec,
        ):
            _add_validator_to_registry(
                state, pubkey, bytes(deposit.withdrawal_credentials),
                int(deposit.amount), types, spec,
            )
    else:
        h.increase_balance(state, index, int(deposit.amount))


def process_pending_deposits(state, types, spec: ChainSpec) -> None:
    from .per_block import _pubkey_index_map

    next_epoch = h.get_current_epoch(state, spec) + 1
    available = sa.safe_add(
        int(state.deposit_balance_to_consume),
        h.get_activation_exit_churn_limit(state, spec),
    )
    processed_amount = 0
    next_deposit_index = 0
    deposits_to_postpone: List = []
    is_churn_limit_reached = False
    finalized_slot = h.compute_start_slot_at_epoch(
        int(state.finalized_checkpoint.epoch), spec
    )
    for deposit in state.pending_deposits:
        # eth1-bridge deposits must fully drain before REQUEST-era deposits
        # process; GENESIS_SLOT-stamped entries (bridge deposits, upgrade
        # re-queues, compounding excess) are exempt (spec: deposit.slot >
        # GENESIS_SLOT guard).
        if int(deposit.slot) > GENESIS_SLOT and int(state.eth1_deposit_index) < int(
            state.deposit_requests_start_index
        ):
            break
        if int(deposit.slot) > finalized_slot:
            break
        if next_deposit_index >= spec.preset.max_pending_deposits_per_epoch:
            break
        pubkey = bytes(deposit.pubkey)
        index = _pubkey_index_map(state).get(pubkey)
        is_exited = is_withdrawn = False
        if index is not None:
            v = state.validators[index]
            is_exited = v.exit_epoch < FAR_FUTURE_EPOCH
            is_withdrawn = int(v.withdrawable_epoch) < next_epoch
        if is_withdrawn:
            _apply_pending_deposit(state, deposit, types, spec)  # no churn charge
        elif is_exited:
            deposits_to_postpone.append(deposit)
        else:
            is_churn_limit_reached = (
                sa.safe_add(processed_amount, int(deposit.amount)) > available
            )
            if is_churn_limit_reached:
                break
            processed_amount = sa.safe_add(processed_amount, int(deposit.amount))
            _apply_pending_deposit(state, deposit, types, spec)
        next_deposit_index += 1

    state.pending_deposits = (
        list(state.pending_deposits)[next_deposit_index:] + deposits_to_postpone
    )
    if is_churn_limit_reached:
        state.deposit_balance_to_consume = sa.safe_sub(available, processed_amount)
    else:
        state.deposit_balance_to_consume = 0


def process_pending_consolidations(state, types, spec: ChainSpec) -> None:
    next_epoch = h.get_current_epoch(state, spec) + 1
    next_pending = 0
    for pc in state.pending_consolidations:
        source = state.validators[int(pc.source_index)]
        if source.slashed:
            next_pending += 1
            continue
        if int(source.withdrawable_epoch) > next_epoch:
            break
        # move at most the source's effective balance (excess stays behind
        # for the withdrawal sweep)
        amount = min(
            int(state.balances[int(pc.source_index)]), int(source.effective_balance)
        )
        h.decrease_balance(state, int(pc.source_index), amount)
        h.increase_balance(state, int(pc.target_index), amount)
        next_pending += 1
    state.pending_consolidations = list(state.pending_consolidations)[next_pending:]
