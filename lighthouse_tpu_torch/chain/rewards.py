"""Reward calculators for the rewards HTTP APIs and the validator monitor.

Equivalent of the reference's ``beacon_chain/src/attestation_rewards.rs``,
``beacon_block_reward.rs`` and ``sync_committee_rewards.rs`` (the sources of
the ``/eth/v1/beacon/rewards/*`` endpoints), computed from the same dense
arrays the epoch processor uses.

A copy of the JAX package's ``lighthouse_tpu/chain/rewards.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..consensus import helpers as h
from ..consensus import per_epoch
from ..types.spec import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    ChainSpec,
)

_FLAG_NAMES = {
    TIMELY_SOURCE_FLAG_INDEX: "source",
    TIMELY_TARGET_FLAG_INDEX: "target",
    TIMELY_HEAD_FLAG_INDEX: "head",
}


def attestation_rewards(state, spec: ChainSpec,
                        validator_ids: Optional[Sequence[int]] = None) -> dict:
    """Per-validator attestation rewards for the state's PREVIOUS epoch
    (reference ``attestation_rewards.rs`` / the
    ``/eth/v1/beacon/rewards/attestations/{epoch}`` payload): the state must
    be in epoch E+1 for rewards of epoch E."""
    arrays = per_epoch.EpochArrays(state, spec)
    n = len(state.validators)
    previous_epoch = h.get_previous_epoch(state, spec)
    prev_part = per_epoch._participation_array(state.previous_epoch_participation, n)
    eligible = arrays.eligible_mask(previous_epoch)
    in_leak = per_epoch.is_in_inactivity_leak(state, spec)

    increment = spec.effective_balance_increment
    total_active_balance = h.get_total_active_balance(state, spec)
    base_reward_per_increment = (
        increment * spec.base_reward_factor // spec.integer_squareroot(total_active_balance)
    )
    base_reward = (arrays.effective_balance // increment) * base_reward_per_increment
    active_increments = total_active_balance // increment

    per_flag: Dict[str, np.ndarray] = {}
    ideal_per_flag: Dict[str, np.ndarray] = {}
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = per_epoch._unslashed_participating_mask(
            arrays, prev_part, flag_index, previous_epoch
        )
        participating_increments = int(
            arrays.effective_balance[participating].sum()
        ) // increment
        if in_leak:
            ideal = np.zeros(n, dtype=np.int64)
        else:
            ideal = (
                base_reward * weight * participating_increments
                // (active_increments * WEIGHT_DENOMINATOR)
            )
        name = _FLAG_NAMES[flag_index]
        ideal_per_flag[name] = ideal
        got = np.where(eligible & participating, ideal, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            got = got - np.where(
                eligible & ~participating,
                base_reward * weight // WEIGHT_DENOMINATOR, 0,
            )
        per_flag[name] = got

    # inactivity penalties against non-target-participants
    fork = type(state).fork_name
    quotient = (
        spec.inactivity_penalty_quotient_altair
        if fork == "altair"
        else spec.inactivity_penalty_quotient_bellatrix
    )
    target_participating = per_epoch._unslashed_participating_mask(
        arrays, prev_part, TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )
    scores = np.asarray([int(x) for x in state.inactivity_scores], dtype=np.int64)
    inactivity = -np.where(
        eligible & ~target_participating,
        arrays.effective_balance * scores
        // (spec.inactivity_score_bias * quotient),
        0,
    )

    if validator_ids is None:
        indices = list(range(n))
    else:
        indices = [int(i) for i in validator_ids]
        bad = [i for i in indices if not (0 <= i < n)]
        if bad:
            raise ValueError(f"unknown validator indices {bad}")
    total_rewards = [
        {
            "validator_index": str(i),
            "head": str(int(per_flag["head"][i])),
            "target": str(int(per_flag["target"][i])),
            "source": str(int(per_flag["source"][i])),
            "inactivity": str(int(inactivity[i])),
        }
        for i in indices
    ]
    # ideal rewards keyed by effective balance (the API's shape)
    ideal_rewards = []
    for eb in sorted({int(arrays.effective_balance[i]) for i in indices}):
        rep = next(i for i in indices if int(arrays.effective_balance[i]) == eb)
        ideal_rewards.append({
            "effective_balance": str(eb),
            "head": str(int(ideal_per_flag["head"][rep])),
            "target": str(int(ideal_per_flag["target"][rep])),
            "source": str(int(ideal_per_flag["source"][rep])),
        })
    return {"ideal_rewards": ideal_rewards, "total_rewards": total_rewards}


def sync_committee_rewards(state, block, spec: ChainSpec,
                           validator_ids: Optional[Sequence[int]] = None) -> List[dict]:
    """Per-participant sync rewards for ``block`` on its PRE-state
    (reference ``sync_committee_rewards.rs``): positive for set bits,
    negative for missed slots."""
    from ..consensus.per_block import sync_participant_reward

    aggregate = getattr(block.message.body, "sync_aggregate", None)
    if aggregate is None:
        return []
    participant_reward = sync_participant_reward(state, spec)
    pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    wanted = None if validator_ids is None else {int(i) for i in validator_ids}
    out: Dict[int, int] = {}
    for i, bit in enumerate(aggregate.sync_committee_bits):
        vidx = pk_to_idx[bytes(state.current_sync_committee.pubkeys[i])]
        if wanted is not None and vidx not in wanted:
            continue
        out[vidx] = out.get(vidx, 0) + (
            participant_reward if bit else -participant_reward
        )
    return [
        {"validator_index": str(i), "reward": str(r)} for i, r in sorted(out.items())
    ]


def block_rewards(chain, block_root: bytes) -> Optional[dict]:
    """Proposer reward breakdown for an imported block (reference
    ``beacon_block_reward.rs``): total from the proposer's balance delta
    across the transition; the sync-aggregate share from its closed-form
    formula; attestations as the remainder (slashing inclusion rewards fold
    into it — the reference separates them, noted in the payload)."""
    block = chain.get_block(block_root)
    if block is None:
        return None
    parent_state = chain.get_state(bytes(block.message.parent_root))
    post_state = chain.get_state(block_root)
    if parent_state is None or post_state is None:
        return None
    spec = chain.spec
    proposer = int(block.message.proposer_index)

    from ..consensus.per_slot import process_slots

    pre = parent_state.copy()
    if int(pre.slot) < int(block.message.slot):
        pre = process_slots(pre, int(block.message.slot), chain.types, spec)
    pre_balance = int(pre.balances[proposer])
    post_balance = int(post_state.balances[proposer])
    total = post_balance - pre_balance

    from ..consensus.per_block import sync_proposer_reward_per_bit

    sync_share = 0
    aggregate = getattr(block.message.body, "sync_aggregate", None)
    if aggregate is not None:
        sync_share = sync_proposer_reward_per_bit(pre, spec) * sum(
            aggregate.sync_committee_bits
        )

    return {
        "proposer_index": str(proposer),
        "total": str(total),
        "attestations": str(total - sync_share),
        "sync_aggregate": str(sync_share),
        "proposer_slashings": str(0),
        "attester_slashings": str(0),
    }
