"""Scripted proto-array scenario interpreter.

Executes the reference's ``ForkChoiceTestDefinition`` operation scripts
(``consensus/proto_array/src/fork_choice_test_definition.rs:75-287``) against
our ``ProtoArray``.  The thin vote/balance wrapper here mirrors the
reference's ``ProtoArrayForkChoice`` (proto_array_fork_choice.rs): latest-
message tracking, delta computation from old/new justified balances, proposer
boost as a committee fraction, and the find-head walk — all with mainnet
constants (32 slots/epoch, proposer_score_boost = 50), exactly as the
scripted suite runs them.

A copy of the JAX package's ``lighthouse_tpu/conformance/proto_array_runner.py``.
"""

from __future__ import annotations

import numpy as np

from ..fork_choice.proto_array import (
    NONE,
    ExecutionStatus,
    ProtoArray,
    ProtoArrayError,
    VoteTracker,
)

SLOTS_PER_EPOCH = 32  # MainnetEthSpec
PROPOSER_SCORE_BOOST = 50
ZERO = b"\x00" * 32


def _root(hex_str: str) -> bytes:
    return bytes.fromhex(hex_str[2:] if hex_str.startswith("0x") else hex_str)


def _cp(d: dict) -> tuple:
    return (int(d["epoch"]), _root(d["root"]))


class ScriptedForkChoice:
    """The reference ``ProtoArrayForkChoice`` shape, driven purely by ops."""

    def __init__(self, finalized_block_slot: int, justified_checkpoint: tuple,
                 finalized_checkpoint: tuple):
        self.array = ProtoArray(
            slots_per_epoch=SLOTS_PER_EPOCH,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            prune_threshold=256,
        )
        self.votes = VoteTracker()
        self.balances = np.zeros(0, dtype=np.int64)
        # The anchor: the finalized-checkpoint root at the finalized slot,
        # imported optimistically with the zero execution hash and unrealized
        # checkpoints equal to the realized ones
        # (proto_array_fork_choice.rs:384-399 ``ProtoArrayForkChoice::new``).
        self.array.on_block(
            slot=finalized_block_slot,
            root=finalized_checkpoint[1],
            parent_root=None,
            state_root=ZERO,
            target_root=finalized_checkpoint[1],
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            unrealized_justified_checkpoint=justified_checkpoint,
            unrealized_finalized_checkpoint=finalized_checkpoint,
            execution_status=ExecutionStatus.OPTIMISTIC,
            execution_block_hash=ZERO,
            current_slot=finalized_block_slot,
        )

    def process_block(self, op: dict) -> None:
        root = _root(op["root"])
        self.array.on_block(
            slot=int(op["slot"]),
            root=root,
            parent_root=_root(op["parent_root"]),
            state_root=ZERO,
            target_root=ZERO,
            justified_checkpoint=_cp(op["justified_checkpoint"]),
            finalized_checkpoint=_cp(op["finalized_checkpoint"]),
            unrealized_justified_checkpoint=None,
            unrealized_finalized_checkpoint=None,
            # All test blocks import optimistically with hash = root
            # (fork_choice_test_definition.rs:206-208).
            execution_status=ExecutionStatus.OPTIMISTIC,
            execution_block_hash=root,
            current_slot=int(op["slot"]),
        )

    def process_attestation(self, op: dict) -> None:
        v = int(op["validator_index"])
        epoch = int(op["target_epoch"])
        self.votes.ensure(v + 1)
        # Reference process_attestation: only a newer target epoch (or a
        # fresh tracker) replaces the pending vote.
        if epoch > self.votes.next_epoch[v] or self.votes.next_root_id[v] == NONE:
            self.votes.next_root_id[v] = self.array.root_id(_root(op["block_root"]))
            self.votes.next_epoch[v] = epoch

    def find_head(self, op: dict, boost_root_hex: str = None) -> bytes:
        new_balances = np.asarray(op["justified_state_balances"], dtype=np.int64)
        self.votes.ensure(max(len(new_balances), len(self.balances)))
        deltas = self.array.compute_deltas(self.votes, self.balances, new_balances)
        boost = (None, 0)
        if boost_root_hex is not None:
            boost_root = _root(boost_root_hex)
            if boost_root != ZERO:
                committee_weight = int(new_balances.sum()) // SLOTS_PER_EPOCH
                score = committee_weight * PROPOSER_SCORE_BOOST // 100
                boost = (boost_root, score)
        jcp = _cp(op["justified_checkpoint"])
        fcp = _cp(op["finalized_checkpoint"])
        self.array.apply_score_changes(
            deltas,
            justified_checkpoint=jcp,
            finalized_checkpoint=fcp,
            current_slot=0,  # the scripted suite always passes Slot::new(0)
            new_proposer_boost=boost,
        )
        self.balances = new_balances
        return self.array.find_head(jcp[1], current_slot=0)


def run_scenario(scenario: dict) -> int:
    """Run every operation; raises AssertionError/ProtoArrayError on any
    mismatch.  Returns the number of operations executed."""
    fc = ScriptedForkChoice(
        int(scenario.get("finalized_block_slot", 0)),
        _cp(scenario["justified_checkpoint"]),
        _cp(scenario["finalized_checkpoint"]),
    )
    for i, op in enumerate(scenario["operations"]):
        kind = op["op"]
        where = f"op {i} ({kind})"
        if kind == "FindHead" or kind == "ProposerBoostFindHead":
            head = fc.find_head(op, op.get("proposer_boost_root"))
            expected = _root(op["expected_head"])
            assert head == expected, (
                f"{where}: head {head.hex()[:16]} != expected {expected.hex()[:16]}"
            )
        elif kind == "InvalidFindHead":
            try:
                fc.find_head(op)
            except ProtoArrayError:
                pass
            else:
                raise AssertionError(f"{where}: find_head unexpectedly succeeded")
        elif kind == "ProcessBlock":
            fc.process_block(op)
        elif kind == "ProcessAttestation":
            fc.process_attestation(op)
        elif kind == "Prune":
            fc.array.prune_threshold = int(op["prune_threshold"])
            fc.array.prune(_root(op["finalized_root"]))
            got = len(fc.array.nodes)
            assert got == int(op["expected_len"]), (
                f"{where}: {got} nodes != expected {op['expected_len']}"
            )
        elif kind == "InvalidatePayload":
            lva = op.get("latest_valid_ancestor_root")
            fc.array.on_invalid_execution_payload(
                _root(op["head_block_root"]),
                _root(lva) if lva is not None else None,
                always_invalidate_head=True,
            )
        elif kind == "AssertWeight":
            node = fc.array.get_block(_root(op["block_root"]))
            assert node is not None, f"{where}: unknown block"
            assert node.weight == int(op["weight"]), (
                f"{where}: weight {node.weight} != expected {op['weight']}"
            )
        else:
            raise AssertionError(f"{where}: unknown operation")
    return len(scenario["operations"])
