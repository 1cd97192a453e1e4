"""Slot processing (reference: ``consensus/state_processing/src/per_slot_processing.rs``).

``process_slots`` advances the state to a target slot: caches roots, runs
epoch processing at boundaries, and applies scheduled fork upgrades (the
reference does the upgrade inside ``per_slot_processing`` too).  Returns the
(possibly new, fork-upgraded) state object.

A copy of the JAX package's ``lighthouse_tpu/consensus/per_slot.py``.
"""

from __future__ import annotations

from ..types.spec import ChainSpec
from . import helpers as h
from .per_epoch import process_epoch
from .upgrades import upgrade_state


def process_slot(state, spec: ChainSpec) -> None:
    previous_state_root = state.hash_tree_root()
    state.state_roots[state.slot % spec.preset.slots_per_historical_root] = previous_state_root
    if bytes(state.latest_block_header.state_root) == bytes(32):
        state.latest_block_header.state_root = previous_state_root
    previous_block_root = state.latest_block_header.hash_tree_root()
    state.block_roots[state.slot % spec.preset.slots_per_historical_root] = previous_block_root


def process_slots(state, slot: int, types, spec: ChainSpec):
    assert state.slot < slot, f"cannot rewind state from {state.slot} to {slot}"
    while state.slot < slot:
        process_slot(state, spec)
        if (state.slot + 1) % spec.slots_per_epoch == 0:
            process_epoch(state, types, spec)
        state.slot += 1
        if state.slot % spec.slots_per_epoch == 0:
            epoch = state.slot // spec.slots_per_epoch
            target_fork = spec.fork_name_at_epoch(epoch)
            if target_fork != type(state).fork_name:
                state = upgrade_state(state, target_fork, types, spec)
    return state
