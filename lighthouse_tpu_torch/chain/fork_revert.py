"""Destructive head-revert utilities for disaster recovery.

Equivalent of the reference's ``beacon_node/beacon_chain/src/fork_revert.rs``:

* ``revert_to_fork_boundary`` — after a hard fork activates and the head
  chain turns out to be invalid under the new rules (e.g. the node was
  offline during the fork and followed a pre-fork-only branch), walk the
  head's ancestry back to the last block BEFORE the fork boundary and adopt
  it as the new head.  Reverted blocks lie dormant in the database forever.
* ``reset_fork_choice_to_finalization`` — rebuild fork choice from the head
  state's finalized checkpoint by replaying the canonical blocks up to the
  head (the safe way to recover from a corrupt/unsound persisted fork
  choice; consensus-specs issue 2566 explains why replay beats patching).

A copy of the JAX package's ``lighthouse_tpu/chain/fork_revert.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..fork_choice import ExecutionStatus, ForkChoice


class ForkRevertError(Exception):
    pass


_FORK_EPOCH_ATTR = {
    "altair": "altair_fork_epoch",
    "bellatrix": "bellatrix_fork_epoch",
    "capella": "capella_fork_epoch",
    "deneb": "deneb_fork_epoch",
    "electra": "electra_fork_epoch",
}


def revert_to_fork_boundary(chain, current_slot: int) -> Tuple[bytes, object]:
    """(new_head_root, signed_block) for the last head-ancestor from before
    the currently-active fork.  Raises when already on phase0 or when no
    pre-fork ancestor exists (a corrupt database)."""
    spec = chain.spec
    fork = spec.fork_name_at_slot(int(current_slot))
    attr = _FORK_EPOCH_ATTR.get(fork)
    if attr is None:
        raise ForkRevertError("cannot revert to before the phase0 hard fork; "
                              "the database may be corrupt")
    fork_epoch = getattr(spec, attr)
    if fork_epoch is None:
        raise ForkRevertError(f"current fork {fork!r} never activates")
    boundary_slot = fork_epoch * spec.slots_per_epoch

    root = chain.head_root
    while True:
        block = chain.get_block(root)
        if block is None:
            if root == chain.genesis_block_root and boundary_slot > 0:
                return root, None  # genesis itself predates the fork
            raise ForkRevertError(
                "no pre-fork blocks found walking the head ancestry; "
                "the database may be corrupt"
            )
        if int(block.message.slot) < boundary_slot:
            return root, block
        root = bytes(block.message.parent_root)


def reset_fork_choice_to_finalization(
    chain, current_slot: Optional[int] = None
) -> ForkChoice:
    """A fresh ForkChoice anchored at the head state's finalized checkpoint
    with the canonical chain to the head replayed into it.

    Replayed blocks get ``ExecutionStatus.OPTIMISTIC`` (their payloads cannot
    be retroactively re-verified — the reference makes the same choice) and a
    zero block delay (reinforcing the canonical chain with proposer boost is
    intended).  All other branches are permanently forgotten.
    """
    spec = chain.spec
    head_root = chain.head_root
    head_state = chain.head_state
    f_epoch = int(head_state.finalized_checkpoint.epoch)
    f_root = bytes(head_state.finalized_checkpoint.root)
    if not any(f_root):
        f_root = chain.genesis_block_root  # nothing finalized yet
    f_state = chain.get_state(f_root)
    if f_state is None:
        raise ForkRevertError(
            f"finalized state missing for revert: {f_root.hex()[:16]}"
        )
    finalized_slot = f_epoch * spec.slots_per_epoch
    if int(f_state.slot) < finalized_slot:
        # advance across skipped slots to the checkpoint epoch start
        from ..consensus.per_slot import process_slots

        f_state = process_slots(f_state.copy(), finalized_slot, chain.types, spec)

    fc = ForkChoice(
        spec=spec,
        genesis_block_root=f_root,
        genesis_state=f_state,
        anchor_slot=finalized_slot,
    )
    fc.set_justified_state_provider(chain.get_state)

    # Canonical ancestry head -> finalized anchor, then replay oldest-first.
    replay = []
    root = head_root
    while root != f_root and root != chain.genesis_block_root:
        block = chain.get_block(root)
        if block is None:
            raise ForkRevertError(
                f"missing block {root.hex()[:16]} replaying to finalization"
            )
        replay.append((root, block))
        root = bytes(block.message.parent_root)
    if current_slot is None:
        current_slot = chain.current_slot()
    for block_root, block in reversed(replay):
        state = chain.get_state(block_root)
        if state is None:
            raise ForkRevertError(
                f"missing post-state {block_root.hex()[:16]} replaying to finalization"
            )
        status = (
            ExecutionStatus.OPTIMISTIC
            if hasattr(block.message.body, "execution_payload")
            else ExecutionStatus.IRRELEVANT
        )
        fc.on_block(
            current_slot=int(current_slot),
            block=block.message,
            block_root=block_root,
            state=state,
            payload_verification_status=status,
            block_delay_seconds=0.0,
        )
    fc.update_time(int(current_slot))
    return fc
