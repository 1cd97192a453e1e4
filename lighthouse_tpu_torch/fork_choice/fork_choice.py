"""Spec fork choice on top of the proto-array DAG.

Equivalent of the reference's ``consensus/fork_choice`` crate
(`fork_choice/src/fork_choice.rs`: ``get_head:468``, ``on_block:642``,
``on_attestation:1037``, ``update_time:1104``) — the stateful wrapper that owns
the proto-array, the latest-message vote store, queued attestations, proposer
boost, and justification/finalization bookkeeping.

The unrealized-justification ("pull-up") computation reuses the epoch
processing's participation math but without mutating the state — the
reference computes this from its progressive-balances cache
(`beacon_chain/src/beacon_fork_choice_store.rs``); here the target balances
are one vectorized mask-reduction over the dense participation arrays, which
is the same cost class.

A copy of the JAX package's ``lighthouse_tpu/fork_choice/fork_choice.py``,
on the port's ``consensus.per_epoch.EpochArrays``.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..consensus import helpers as h
from ..consensus.per_epoch import (
    EpochArrays,
    _participation_array,
    _unslashed_participating_mask,
    compute_justification_and_finalization,
)
from ..types.spec import GENESIS_EPOCH, TIMELY_TARGET_FLAG_INDEX, ChainSpec
from .proto_array import ExecutionStatus, ProtoArray, ProtoArrayError, VoteTracker

Checkpoint = Tuple[int, bytes]  # (epoch, root)


class DoNotReOrg(Exception):
    """Proposer re-org declined; the message names the failed condition
    (reference ``proto_array_fork_choice.rs`` ``DoNotReOrg``)."""


class ForkChoiceError(Exception):
    pass


class InvalidBlock(ForkChoiceError):
    pass


class InvalidAttestation(ForkChoiceError):
    pass


# ---------------------------------------------------------------------------
# Unrealized justification (spec ``compute_pulled_up_tip``)
# ---------------------------------------------------------------------------


def compute_unrealized_checkpoints(
    state, spec: ChainSpec
) -> Tuple[Checkpoint, Checkpoint]:
    """Run justification/finalization math on the block's post-state *as if*
    the epoch ended now, without mutating the state.

    Mirrors ``weigh_justification_and_finalization``
    (``consensus/per_epoch.py``) on local variables only; reference:
    ``state_processing::per_epoch_processing::weigh_justification_and_finalization``
    driven by ``fork_choice.rs`` unrealized-justification handling.
    """
    current_epoch = h.get_current_epoch(state, spec)
    justified = (
        int(state.current_justified_checkpoint.epoch),
        bytes(state.current_justified_checkpoint.root),
    )
    finalized = (
        int(state.finalized_checkpoint.epoch),
        bytes(state.finalized_checkpoint.root),
    )
    if current_epoch <= GENESIS_EPOCH + 1:
        return justified, finalized

    previous_epoch = h.get_previous_epoch(state, spec)
    arrays = EpochArrays(state, spec)
    increment = spec.effective_balance_increment
    total_active = max(
        increment, int(arrays.effective_balance[arrays.active_mask(current_epoch)].sum())
    )

    if type(state).fork_name == "phase0":
        prev_target, curr_target = _phase0_target_balances(state, arrays, spec)
    else:
        n = arrays.n
        prev_part = _participation_array(state.previous_epoch_participation, n)
        curr_part = _participation_array(state.current_epoch_participation, n)
        prev_mask = _unslashed_participating_mask(
            arrays, prev_part, TIMELY_TARGET_FLAG_INDEX, previous_epoch
        )
        curr_mask = _unslashed_participating_mask(
            arrays, curr_part, TIMELY_TARGET_FLAG_INDEX, current_epoch
        )
        prev_target = max(increment, int(arrays.effective_balance[prev_mask].sum()))
        curr_target = max(increment, int(arrays.effective_balance[curr_mask].sum()))

    _, new_justified, new_finalized = compute_justification_and_finalization(
        bits=state.justification_bits,
        old_previous_justified=(
            int(state.previous_justified_checkpoint.epoch),
            bytes(state.previous_justified_checkpoint.root),
        ),
        old_current_justified=justified,
        previous_epoch=previous_epoch,
        current_epoch=current_epoch,
        previous_boundary_root=lambda: h.get_block_root(state, previous_epoch, spec),
        current_boundary_root=lambda: h.get_block_root(state, current_epoch, spec),
        total_active_balance=total_active,
        previous_target_balance=prev_target,
        current_target_balance=curr_target,
    )
    return (
        new_justified if new_justified is not None else justified,
        new_finalized if new_finalized is not None else finalized,
    )


def _phase0_target_balances(state, arrays: EpochArrays, spec: ChainSpec):
    """Phase0 target balances from pending attestations."""
    increment = spec.effective_balance_increment
    previous_epoch = h.get_previous_epoch(state, spec)
    current_epoch = h.get_current_epoch(state, spec)

    def target_indices(attestations, epoch):
        attestations = list(attestations)
        if not attestations:
            # No attestations ⇒ no boundary-root lookup: a state sitting on
            # the epoch-start slot has no current boundary root yet.
            return []
        out = set()
        boundary = h.get_block_root(state, epoch, spec)
        for a in attestations:
            if bytes(a.data.target.root) != boundary:
                continue
            for i in h.get_attesting_indices(state, a.data, a.aggregation_bits, spec):
                out.add(i)
        return [i for i in out if not arrays.slashed[i]]

    prev = target_indices(state.previous_epoch_attestations, previous_epoch)
    curr = target_indices(state.current_epoch_attestations, current_epoch)
    prev_bal = max(increment, int(arrays.effective_balance[prev].sum())) if prev else increment
    curr_bal = max(increment, int(arrays.effective_balance[curr].sum())) if curr else increment
    return prev_bal, curr_bal


# ---------------------------------------------------------------------------
# Queued attestations
# ---------------------------------------------------------------------------


@dataclass
class QueuedAttestation:
    """Attestation received in its own slot, applied one slot later
    (reference: ``fork_choice.rs`` ``QueuedAttestation``)."""

    slot: int
    attesting_indices: np.ndarray
    block_root: bytes
    target_epoch: int


def justified_balances(state, spec: ChainSpec) -> np.ndarray:
    """Effective balances of validators active at the justified state's
    current epoch; zeros elsewhere (reference: ``JustifiedBalances``,
    ``beacon_chain/src/beacon_fork_choice_store.rs``)."""
    epoch = h.get_current_epoch(state, spec)
    arrays = EpochArrays(state, spec)
    return np.where(arrays.active_mask(epoch), arrays.effective_balance, 0).astype(
        np.int64
    )


# ---------------------------------------------------------------------------
# ForkChoice
# ---------------------------------------------------------------------------


def _locked(fn):
    """Serialize a public ForkChoice entry point on the instance lock.

    The chain calls fork choice from several threads at once (processor
    workers importing blocks and applying attestations, sync lookup threads
    chasing parents, duty loops producing) and the proto-array walk is
    multi-step mutable arithmetic: two interleaved ``get_head`` calls
    double-consume vote deltas and drive node weights negative (observed as
    intermittent ``ProtoArrayError: negative weight`` under the scenario
    soak).  The reference wraps fork choice in an ``RwLock`` for exactly
    this reason; an RLock because the entry points nest (``on_block`` ->
    ``update_time``)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class ForkChoice:
    """Stateful fork choice: proto-array + votes + time + checkpoints."""

    def __init__(
        self,
        *,
        spec: ChainSpec,
        genesis_block_root: bytes,
        genesis_state,
        anchor_slot: Optional[int] = None,
    ):
        self.spec = spec
        self._lock = threading.RLock()  # see _locked
        anchor_slot = int(genesis_state.slot) if anchor_slot is None else anchor_slot
        anchor_epoch = anchor_slot // spec.slots_per_epoch
        # Spec ``get_forkchoice_store`` / reference ``ForkChoice::from_anchor``:
        # the anchor block IS the initial justified and finalized checkpoint —
        # the state's own checkpoint roots predate the anchor and are not in
        # the proto-array (checkpoint sync starts mid-chain).
        jc: Checkpoint = (anchor_epoch, genesis_block_root)
        fc: Checkpoint = (anchor_epoch, genesis_block_root)
        self.justified_checkpoint: Checkpoint = jc
        self.finalized_checkpoint: Checkpoint = fc
        self.unrealized_justified_checkpoint: Checkpoint = jc
        self.unrealized_finalized_checkpoint: Checkpoint = fc
        self.proposer_boost_root: Optional[bytes] = None
        self.current_slot = anchor_slot
        self.queued_attestations: List[QueuedAttestation] = []
        self.votes = VoteTracker()
        self._old_balances = np.zeros(0, dtype=np.int64)
        self.justified_balances = justified_balances(genesis_state, spec)

        self.proto = ProtoArray(
            slots_per_epoch=spec.slots_per_epoch,
            justified_checkpoint=jc,
            finalized_checkpoint=fc,
        )
        self.proto.on_block(
            slot=anchor_slot,
            root=genesis_block_root,
            parent_root=None,
            state_root=genesis_state.hash_tree_root(),
            target_root=genesis_block_root,
            justified_checkpoint=jc,
            finalized_checkpoint=fc,
            unrealized_justified_checkpoint=jc,
            unrealized_finalized_checkpoint=fc,
            execution_status=ExecutionStatus.IRRELEVANT,
            current_slot=anchor_slot,
        )
        # Maps justified root -> state for balance lookup; caller-provided.
        self._justified_state_provider = None

    def set_justified_state_provider(self, fn) -> None:
        """``fn(root: bytes) -> state`` used to refresh justified balances when
        the justified checkpoint advances (the reference reads these through
        ``ForkChoiceStore``; the chain provides them from its state cache)."""
        self._justified_state_provider = fn

    # ------------------------------------------------------------------ time

    @_locked
    def update_time(self, current_slot: int) -> None:
        """Reference: ``fork_choice.rs:1104`` ``update_time`` (spec
        ``on_tick_per_slot``), computed as ONE jump: per-slot iteration is
        equivalent because checkpoint promotion is a monotone max of the
        (unchanged) unrealized values and the queued-attestation dequeue at
        the final slot subsumes every intermediate dequeue.  The naive loop
        walks 10M+ slots on a wall-clock node booting from an old anchor —
        a multi-second stall inside block import."""
        if current_slot <= self.current_slot:
            return
        spe = self.spec.slots_per_epoch
        crossed_epoch = current_slot // spe > self.current_slot // spe
        self.current_slot = current_slot
        self.proposer_boost_root = None
        if crossed_epoch:
            self._update_checkpoints(
                self.unrealized_justified_checkpoint,
                self.unrealized_finalized_checkpoint,
            )
        self._process_queued_attestations()

    def _process_queued_attestations(self) -> None:
        remaining = []
        for qa in self.queued_attestations:
            if qa.slot < self.current_slot:
                self._apply_latest_messages(
                    qa.attesting_indices, qa.block_root, qa.target_epoch
                )
            else:
                remaining.append(qa)
        self.queued_attestations = remaining

    def _update_checkpoints(
        self, justified: Checkpoint, finalized: Checkpoint
    ) -> None:
        if justified[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = justified
            self._refresh_justified_balances()
        if finalized[0] > self.finalized_checkpoint[0]:
            self.finalized_checkpoint = finalized

    def _refresh_justified_balances(self) -> None:
        if self._justified_state_provider is None:
            return
        state = self._justified_state_provider(self.justified_checkpoint[1])
        if state is not None:
            self.justified_balances = justified_balances(state, self.spec)

    # ----------------------------------------------------------------- block

    @_locked
    def on_block(
        self,
        *,
        current_slot: int,
        block,
        block_root: bytes,
        state,
        payload_verification_status: str = ExecutionStatus.IRRELEVANT,
        block_delay_seconds: Optional[float] = None,
    ) -> None:
        """Reference: ``fork_choice.rs:642`` ``on_block``.

        ``state`` is the block's post-state.  ``block_delay_seconds`` (time
        since slot start when received) drives proposer boost.
        """
        self.update_time(current_slot)
        slot = int(block.slot)
        if slot > current_slot:
            raise InvalidBlock(f"block slot {slot} is in the future (now {current_slot})")
        f_epoch, f_root = self.finalized_checkpoint
        finalized_slot = f_epoch * self.spec.slots_per_epoch
        if slot <= finalized_slot:
            raise InvalidBlock(f"block slot {slot} not beyond finalized slot {finalized_slot}")
        parent_root = bytes(block.parent_root)
        if not self.proto.contains_block(parent_root):
            raise InvalidBlock(f"parent {parent_root.hex()[:16]} unknown")
        if f_epoch > 0 and self.proto.ancestor_at_slot(parent_root, finalized_slot) != f_root:
            raise InvalidBlock("block does not descend from finalized root")

        state_justified = (
            int(state.current_justified_checkpoint.epoch),
            bytes(state.current_justified_checkpoint.root),
        )
        state_finalized = (
            int(state.finalized_checkpoint.epoch),
            bytes(state.finalized_checkpoint.root),
        )
        unrealized_j, unrealized_f = compute_unrealized_checkpoints(state, self.spec)
        # Spec ``compute_pulled_up_tip``: unrealized store checkpoints always
        # advance; realized ones advance from the state, and for blocks from
        # prior epochs the unrealized values count as realized.
        if unrealized_j[0] > self.unrealized_justified_checkpoint[0]:
            self.unrealized_justified_checkpoint = unrealized_j
        if unrealized_f[0] > self.unrealized_finalized_checkpoint[0]:
            self.unrealized_finalized_checkpoint = unrealized_f
        self._update_checkpoints(state_justified, state_finalized)
        block_epoch = slot // self.spec.slots_per_epoch
        current_epoch = current_slot // self.spec.slots_per_epoch
        if block_epoch < current_epoch:
            self._update_checkpoints(unrealized_j, unrealized_f)

        # Proposer boost: first timely block for the current slot.
        if (
            slot == current_slot
            and self.proposer_boost_root is None
            and block_delay_seconds is not None
            and block_delay_seconds
            < self.spec.seconds_per_slot / self.spec.intervals_per_slot
        ):
            self.proposer_boost_root = block_root

        target_root = (
            block_root
            if slot % self.spec.slots_per_epoch == 0
            else self.proto.ancestor_at_slot(
                parent_root, block_epoch * self.spec.slots_per_epoch
            )
        )
        body = block.body
        exec_hash = None
        if hasattr(body, "execution_payload"):
            exec_hash = bytes(body.execution_payload.block_hash)
        self.proto.on_block(
            slot=slot,
            root=block_root,
            parent_root=parent_root,
            state_root=bytes(block.state_root),
            target_root=target_root,
            justified_checkpoint=state_justified,
            finalized_checkpoint=state_finalized,
            unrealized_justified_checkpoint=max(unrealized_j, state_justified),
            unrealized_finalized_checkpoint=max(unrealized_f, state_finalized),
            execution_status=payload_verification_status
            if exec_hash is not None and exec_hash != b"\x00" * 32
            else ExecutionStatus.IRRELEVANT,
            execution_block_hash=exec_hash,
            current_slot=current_slot,
        )

    # ----------------------------------------------------------- attestation

    @_locked
    def on_attestation(
        self,
        *,
        current_slot: int,
        attestation_slot: int,
        attesting_indices: Iterable[int],
        beacon_block_root: bytes,
        target_epoch: int,
        target_root: bytes,
        is_from_block: bool = False,
    ) -> None:
        """Reference: ``fork_choice.rs:1037`` ``on_attestation``.

        The caller has already signature-verified and indexed the attestation
        (the chain's attestation pipeline).  This applies LMD-GHOST votes.
        """
        self.update_time(current_slot)
        indices = np.asarray(list(attesting_indices), dtype=np.int64)
        if not is_from_block:
            current_epoch = current_slot // self.spec.slots_per_epoch
            if target_epoch not in (current_epoch, max(current_epoch - 1, 0)):
                raise InvalidAttestation(
                    f"target epoch {target_epoch} not current or previous"
                )
            if attestation_slot > current_slot:
                raise InvalidAttestation("attestation from the future")
        if attestation_slot // self.spec.slots_per_epoch != target_epoch:
            raise InvalidAttestation("attestation slot not in target epoch")
        block = self.proto.get_block(beacon_block_root)
        if block is None:
            raise InvalidAttestation("attestation head block unknown")
        if block.slot > attestation_slot:
            raise InvalidAttestation("attestation head newer than attestation slot")
        if target_root:
            # Spec ``validate_on_attestation``: the target block must be known
            # and be the checkpoint block of the attested head.
            if not self.proto.contains_block(target_root):
                raise InvalidAttestation("attestation target block unknown")
            epoch_start = target_epoch * self.spec.slots_per_epoch
            if self.proto.ancestor_at_slot(beacon_block_root, epoch_start) != target_root:
                raise InvalidAttestation("target root not an ancestor of head block")

        if attestation_slot >= current_slot and not is_from_block:
            self.queued_attestations.append(
                QueuedAttestation(
                    slot=attestation_slot,
                    attesting_indices=indices,
                    block_root=beacon_block_root,
                    target_epoch=target_epoch,
                )
            )
        else:
            self._apply_latest_messages(indices, beacon_block_root, target_epoch)

    def _apply_latest_messages(
        self, indices: np.ndarray, block_root: bytes, target_epoch: int
    ) -> None:
        if len(indices) == 0:
            return
        self.votes.ensure(int(indices.max()) + 1)
        rid = self.proto.root_id(block_root)
        newer = target_epoch > self.votes.next_epoch[indices]
        fresh = self.votes.next_epoch[indices] == -1
        m = (newer | fresh) & ~self.votes.equivocating[indices]
        upd = indices[m]
        self.votes.next_root_id[upd] = rid
        self.votes.next_epoch[upd] = target_epoch

    @_locked
    def on_attester_slashing(self, attesting_indices: Iterable[int]) -> None:
        """Mark equivocating validators; their weight is removed at the next
        ``get_head`` (reference: ``fork_choice.rs`` ``on_attester_slashing``)."""
        indices = np.asarray(list(attesting_indices), dtype=np.int64)
        if len(indices) == 0:
            return
        self.votes.ensure(int(indices.max()) + 1)
        self.votes.equivocating[indices] = True

    # ------------------------------------------------------------------ head

    @_locked
    def get_head(self, current_slot: Optional[int] = None) -> bytes:
        """Reference: ``fork_choice.rs:468`` ``get_head`` →
        ``proto_array_fork_choice`` delta computation + weight walk."""
        if current_slot is not None:
            self.update_time(current_slot)
        new_balances = self.justified_balances
        deltas = self.proto.compute_deltas(self.votes, self._old_balances, new_balances)
        boost = (None, 0)
        if self.proposer_boost_root is not None:
            total = int(new_balances.sum())
            committee_weight = total // self.spec.slots_per_epoch
            boost = (
                self.proposer_boost_root,
                committee_weight * self.spec.proposer_score_boost // 100,
            )
        self.proto.apply_score_changes(
            deltas,
            justified_checkpoint=self.justified_checkpoint,
            finalized_checkpoint=self.finalized_checkpoint,
            current_slot=self.current_slot,
            new_proposer_boost=boost,
        )
        self._old_balances = new_balances
        return self.proto.find_head(self.justified_checkpoint[1], self.current_slot)

    @_locked
    def get_proposer_head(
        self,
        current_slot: int,
        canonical_head: bytes,
        *,
        re_org_head_threshold: int = 20,
        re_org_parent_threshold: int = 160,
        max_epochs_since_finalization: int = 2,
        disallowed_offsets: tuple = (),
    ) -> bytes:
        """Late-block re-org decision for the proposer of ``current_slot``
        (reference ``proto_array_fork_choice.rs:508`` ``get_proposer_head``):
        returns the PARENT root to build on when the canonical head is a
        weakly-attested late block worth orphaning, else raises
        ``DoNotReOrg`` with the failed condition.  Thresholds are percent of
        one committee's weight (chain_config.rs:6-7 defaults: head < 20 %,
        parent > 160 %)."""
        spe = self.spec.slots_per_epoch
        head = self.proto.get_block(canonical_head)
        if head is None or head.parent is None:
            raise DoNotReOrg("missing head or parent node")
        parent = self.proto.nodes[head.parent]

        re_org_block_slot = head.slot + 1
        # Finalization distance (head's unrealized view).
        fin_cp = head.unrealized_finalized_checkpoint or head.finalized_checkpoint
        epochs_since_finalization = (
            re_org_block_slot // spe - int(fin_cp[0])
        )
        if epochs_since_finalization > max_epochs_since_finalization:
            raise DoNotReOrg(
                f"chain not finalizing ({epochs_since_finalization} epochs)"
            )
        if parent.slot + 1 != head.slot:
            raise DoNotReOrg("parent is not a single slot behind the head")
        if re_org_block_slot % spe == 0:
            raise DoNotReOrg("shuffling unstable at the epoch boundary")
        if (re_org_block_slot % spe) in disallowed_offsets:
            raise DoNotReOrg(f"slot offset {re_org_block_slot % spe} disallowed")
        # FFG competitiveness: orphaning the head must not lose justification.
        if (parent.unrealized_justified_checkpoint
                != head.unrealized_justified_checkpoint
                or parent.unrealized_finalized_checkpoint
                != head.unrealized_finalized_checkpoint):
            raise DoNotReOrg("justification/finalization not competitive")
        # Single-slot re-org only (prevents cascades during asynchrony).
        if head.slot + 1 != current_slot:
            raise DoNotReOrg("head is not from the previous slot")

        committee_weight = int(self.justified_balances.sum()) // spe
        head_threshold = committee_weight * re_org_head_threshold // 100
        parent_threshold = committee_weight * re_org_parent_threshold // 100
        if head.weight >= head_threshold:
            raise DoNotReOrg(
                f"head not weak ({head.weight} >= {head_threshold})"
            )
        if parent.weight <= parent_threshold:
            raise DoNotReOrg(
                f"parent not strong ({parent.weight} <= {parent_threshold})"
            )
        return parent.root

    # -------------------------------------------------------- optimistic sync

    @_locked
    def on_valid_execution_payload(self, block_root: bytes) -> None:
        self.proto.on_valid_execution_payload(block_root)

    @_locked
    def on_invalid_execution_payload(
        self, block_root: bytes, latest_valid_hash: Optional[bytes] = None
    ) -> None:
        self.proto.on_invalid_execution_payload(block_root, latest_valid_hash)

    # ----------------------------------------------------------------- misc

    def locked(self):
        """The instance lock, for callers doing multi-step reads straight
        off ``self.proto`` (HTTP debug dumps, migration walks): ``prune``
        rebuilds the node array in place, so an unlocked walker can read
        parent indices mid-remap."""
        return self._lock

    @_locked
    def ancestor_at_slot(self, root: bytes, slot: int) -> Optional[bytes]:
        """Locked canonical-ancestor walk (the ``block_root_at_slot`` and
        migration seam — see :meth:`locked`)."""
        return self.proto.ancestor_at_slot(root, slot)

    @_locked
    def contains_block(self, root: bytes) -> bool:
        return self.proto.contains_block(root)

    @_locked
    def is_descendant(self, ancestor: bytes, descendant: bytes) -> bool:
        return self.proto.is_descendant(ancestor, descendant)

    @_locked
    def prune(self) -> None:
        self.proto.prune(self.finalized_checkpoint[1])
