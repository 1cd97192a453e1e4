"""Fork upgrade functions (reference: ``consensus/state_processing/src/upgrade/``:
altair.rs, merge.rs, capella.rs, deneb.rs).

Each takes a pre-fork state and returns the post-fork state container,
copying shared fields and initializing the new ones per spec.

A copy of the JAX package's ``lighthouse_tpu/consensus/upgrades.py``.
"""

from __future__ import annotations

from ..types.spec import ChainSpec
from . import helpers as h


def _copy_shared(pre, new_cls, **overrides):
    kwargs = {}
    for name in new_cls.fields:
        if name in overrides:
            kwargs[name] = overrides[name]
        elif name in pre.fields:
            kwargs[name] = getattr(pre, name)
    out = new_cls(**kwargs)
    return out


def _convert_payload_header(pre_hdr, new_cls):
    kwargs = {name: getattr(pre_hdr, name) for name in new_cls.fields if name in pre_hdr.fields}
    return new_cls(**kwargs)


def translate_participation(post, pending_attestations, spec: ChainSpec) -> None:
    """Altair upgrade: replay phase0 pending attestations into participation
    flags (spec ``translate_participation``)."""
    for att in pending_attestations:
        data = att.data
        inclusion_delay = att.inclusion_delay
        flags = h.get_attestation_participation_flag_indices(post, data, inclusion_delay, spec)
        committee = h.get_beacon_committee(post, data.slot, data.index, spec)
        for i, bit in enumerate(att.aggregation_bits):
            if not bit:
                continue
            index = int(committee[i])
            ep = post.previous_epoch_participation[index]
            for flag in flags:
                ep = h.add_flag(ep, flag)
            post.previous_epoch_participation[index] = ep


def upgrade_to_altair(pre, types, spec: ChainSpec):
    epoch = h.get_current_epoch(pre, spec)
    n = len(pre.validators)
    post = _copy_shared(
        pre,
        types.state["altair"],
        fork=types.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.altair_fork_version,
            epoch=epoch,
        ),
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        inactivity_scores=[0] * n,
    )
    translate_participation(post, pre.previous_epoch_attestations, spec)
    sync_committee = h.get_next_sync_committee(post, types, spec)
    post.current_sync_committee = sync_committee
    post.next_sync_committee = h.get_next_sync_committee(post, types, spec)
    return post


def upgrade_to_bellatrix(pre, types, spec: ChainSpec):
    epoch = h.get_current_epoch(pre, spec)
    return _copy_shared(
        pre,
        types.state["bellatrix"],
        fork=types.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.bellatrix_fork_version,
            epoch=epoch,
        ),
        latest_execution_payload_header=types.ExecutionPayloadHeaderBellatrix(),
    )


def upgrade_to_capella(pre, types, spec: ChainSpec):
    epoch = h.get_current_epoch(pre, spec)
    return _copy_shared(
        pre,
        types.state["capella"],
        fork=types.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.capella_fork_version,
            epoch=epoch,
        ),
        latest_execution_payload_header=_convert_payload_header(
            pre.latest_execution_payload_header, types.ExecutionPayloadHeaderCapella
        ),
        next_withdrawal_index=0,
        next_withdrawal_validator_index=0,
        historical_summaries=[],
    )


def upgrade_to_deneb(pre, types, spec: ChainSpec):
    epoch = h.get_current_epoch(pre, spec)
    return _copy_shared(
        pre,
        types.state["deneb"],
        fork=types.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.deneb_fork_version,
            epoch=epoch,
        ),
        latest_execution_payload_header=_convert_payload_header(
            pre.latest_execution_payload_header, types.ExecutionPayloadHeaderDeneb
        ),
    )


def upgrade_to_electra(pre, types, spec: ChainSpec):
    """Deneb -> electra (EIP-7251 et al.): initialize the churn/queue fields,
    re-queue pre-activation validators' balances, and queue excess balances
    of compounding validators (reference: the electra fork upgrade in
    consensus/fork/src)."""
    from ..types.spec import FAR_FUTURE_EPOCH

    epoch = h.get_current_epoch(pre, spec)
    exit_epochs = [
        int(v.exit_epoch) for v in pre.validators if v.exit_epoch != FAR_FUTURE_EPOCH
    ]
    # spec: seed from compute_activation_exit_epoch(current), max with any
    # in-flight exits, then +1
    earliest_exit_epoch = (
        max(exit_epochs + [h.compute_activation_exit_epoch(epoch, spec)]) + 1
    )

    post = _copy_shared(
        pre,
        types.state["electra"],
        fork=types.Fork(
            previous_version=pre.fork.current_version,
            current_version=spec.electra_fork_version,
            epoch=epoch,
        ),
        latest_execution_payload_header=_convert_payload_header(
            pre.latest_execution_payload_header, types.ExecutionPayloadHeaderDeneb
        ),
        deposit_requests_start_index=spec.unset_deposit_requests_start_index,
        deposit_balance_to_consume=0,
        exit_balance_to_consume=0,
        earliest_exit_epoch=earliest_exit_epoch,
        consolidation_balance_to_consume=0,
        earliest_consolidation_epoch=h.compute_activation_exit_epoch(epoch, spec),
        pending_deposits=[],
        pending_partial_withdrawals=[],
        pending_consolidations=[],
    )
    post.exit_balance_to_consume = h.get_activation_exit_churn_limit(post, spec)
    post.consolidation_balance_to_consume = h.get_consolidation_churn_limit(post, spec)

    # Re-queue: validators still awaiting activation restart through the
    # pending-deposit queue with their entire balance.
    pre_activation = sorted(
        (
            i
            for i, v in enumerate(post.validators)
            if v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (int(post.validators[i].activation_eligibility_epoch), i),
    )
    for index in pre_activation:
        balance = int(post.balances[index])
        post.balances[index] = 0
        v = post.validators[index]
        v.effective_balance = 0
        v.activation_eligibility_epoch = FAR_FUTURE_EPOCH
        if balance > 0:
            post.pending_deposits = list(post.pending_deposits) + [
                types.PendingDeposit(
                    pubkey=bytes(v.pubkey),
                    withdrawal_credentials=bytes(v.withdrawal_credentials),
                    amount=balance,
                    signature=b"\xc0" + b"\x00" * 95,  # G2_POINT_AT_INFINITY
                    slot=0,
                )
            ]
    # Compounding validators bank their excess above 32 ETH.
    for index, v in enumerate(post.validators):
        if h.has_compounding_withdrawal_credential(v, spec):
            h.queue_excess_active_balance(post, index, types, spec)
    h.invalidate_caches(post)
    return post


UPGRADES = {
    "altair": upgrade_to_altair,
    "bellatrix": upgrade_to_bellatrix,
    "capella": upgrade_to_capella,
    "deneb": upgrade_to_deneb,
    "electra": upgrade_to_electra,
}


def upgrade_state(pre, target_fork: str, types, spec: ChainSpec):
    """Apply the chained upgrade functions from the state's fork up to
    ``target_fork``."""
    from ..types.spec import FORK_ORDER

    cur = FORK_ORDER.index(type(pre).fork_name)
    tgt = FORK_ORDER.index(target_fork)
    state = pre
    for fork in FORK_ORDER[cur + 1 : tgt + 1]:
        if fork not in UPGRADES:
            raise NotImplementedError(
                f"fork {fork!r} is scheduled but not implemented; "
                f"supported: phase0..{list(UPGRADES)[-1]}"
            )
        state = UPGRADES[fork](state, types, spec)
        h.invalidate_caches(state)
    return state
