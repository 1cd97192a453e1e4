"""Top-level state transition (spec ``state_transition``), the equivalent of
the reference's ``state_processing::per_slot_processing`` +
``per_block_processing`` driven together (block_replayer.rs uses the same
shape).

A copy of the JAX package's ``lighthouse_tpu/consensus/state_transition.py``.
"""

from __future__ import annotations

from ..types.spec import ChainSpec
from .per_block import BlockProcessingError, BlockSignatureStrategy, per_block_processing
from .per_slot import process_slots
from .safe_arith import ArithError


class StateRootMismatch(ValueError):
    pass


def state_transition(
    state,
    signed_block,
    types,
    spec: ChainSpec,
    strategy: str = BlockSignatureStrategy.VERIFY_BULK,
    validate_result: bool = True,
    payload_verifier=None,
):
    """Advance ``state`` to the block's slot, apply the block, and (optionally)
    check the block's claimed post-state root.  Returns the post-state (a new
    object if a fork upgrade happened during slot processing)."""
    block = signed_block.message
    if state.slot < block.slot:
        try:
            state = process_slots(state, block.slot, types, spec)
        except ArithError as e:
            # Epoch-processing overflow while advancing to the block's slot:
            # the block that forced the advance is invalid, same contract as
            # per_block_processing.
            raise BlockProcessingError(f"arithmetic out of u64 range: {e}") from e
    per_block_processing(
        state,
        signed_block,
        types,
        spec,
        strategy=strategy,
        payload_verifier=payload_verifier,
    )
    if validate_result:
        actual = state.hash_tree_root()
        if actual != bytes(block.state_root):
            raise StateRootMismatch(
                f"state root mismatch: block claims {bytes(block.state_root).hex()[:16]}, "
                f"got {actual.hex()[:16]}"
            )
    return state
