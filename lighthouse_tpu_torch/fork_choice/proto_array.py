"""Proto-array fork choice DAG.

Array-first re-design of the reference's ``consensus/proto_array`` crate
(`proto_array/src/proto_array.rs:369` ``on_block``,
`proto_array/src/proto_array_fork_choice.rs:900` ``compute_deltas``).

Key departures from the reference:

- **Votes are dense arrays, not per-validator structs.** The reference keeps a
  ``Vec<VoteTracker>`` and walks it in a scalar loop; here votes live in three
  numpy arrays (``current_root_id``, ``next_root_id``, ``next_epoch``) indexed
  by validator, and ``compute_deltas`` is a vectorized scatter-add
  (``np.add.at`` over balances).  At 1M validators this is the hot loop of
  ``get_head`` and maps directly onto a device ``index_add_`` if it ever
  needs to move on-device; the node-count-sized work (weight back-propagation) stays
  a host loop since the block DAG is small (hundreds of nodes).
- **Roots are interned.** Block roots are mapped to stable small integer ids
  (append-only table) so the vote arrays hold int32s instead of 32-byte
  objects; ids survive pruning even when node indices shift.

Semantics follow the Ethereum consensus spec (Deneb-era fork choice, with
unrealized-justification viability and proposer boost), which is what the
reference implements.

A copy of the JAX package's ``lighthouse_tpu/fork_choice/proto_array.py``;
like the JAX package, the port keeps the votes on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

NONE = -1  # sentinel for "no index" in int arrays


class ExecutionStatus:
    """Execution-payload status of a block, for optimistic sync
    (reference: ``proto_array/src/proto_array.rs`` ``ExecutionStatus``)."""

    VALID = "valid"
    INVALID = "invalid"
    OPTIMISTIC = "optimistic"  # payload present, EL verdict unknown
    IRRELEVANT = "irrelevant"  # pre-merge block (no payload)


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: Optional[int]  # index into ProtoArray.nodes
    state_root: bytes
    target_root: bytes
    justified_checkpoint: tuple  # (epoch, root)
    finalized_checkpoint: tuple
    unrealized_justified_checkpoint: tuple
    unrealized_finalized_checkpoint: tuple
    execution_status: str = ExecutionStatus.IRRELEVANT
    execution_block_hash: Optional[bytes] = None
    weight: int = 0
    best_child: Optional[int] = None
    best_descendant: Optional[int] = None


class ProtoArrayError(Exception):
    pass


class InvalidAncestorError(ProtoArrayError):
    """Payload invalidation named an ancestor that is already VALID."""


@dataclass
class VoteTracker:
    """Dense latest-message store (reference keeps ``Vec<VoteTracker>``)."""

    current_root_id: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64)
    )
    next_root_id: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    next_epoch: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    equivocating: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=bool))

    def ensure(self, n: int) -> None:
        cur = len(self.current_root_id)
        if n <= cur:
            return
        grow = n - cur
        self.current_root_id = np.concatenate(
            [self.current_root_id, np.full(grow, NONE, dtype=np.int64)]
        )
        self.next_root_id = np.concatenate(
            [self.next_root_id, np.full(grow, NONE, dtype=np.int64)]
        )
        self.next_epoch = np.concatenate(
            [self.next_epoch, np.full(grow, NONE, dtype=np.int64)]
        )
        self.equivocating = np.concatenate([self.equivocating, np.zeros(grow, dtype=bool)])


class ProtoArray:
    """The block DAG with cached weights and best-descendant links."""

    def __init__(
        self,
        *,
        slots_per_epoch: int,
        justified_checkpoint: tuple,
        finalized_checkpoint: tuple,
        prune_threshold: int = 256,
    ):
        self.slots_per_epoch = slots_per_epoch
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.prune_threshold = prune_threshold
        self.nodes: List[ProtoNode] = []
        self.indices: Dict[bytes, int] = {}
        # Root interning: id -> root is implicit (append order); root -> id:
        self._root_ids: Dict[bytes, int] = {}
        # root_id -> node index (NONE when pruned/unknown); grows with ids.
        self._id_to_node: np.ndarray = np.empty(0, dtype=np.int64)
        self.previous_proposer_boost: tuple = (None, 0)  # (root, score)

    # ------------------------------------------------------------ interning

    def root_id(self, root: bytes) -> int:
        rid = self._root_ids.get(root)
        if rid is None:
            rid = len(self._root_ids)
            self._root_ids[root] = rid
            self._id_to_node = np.concatenate(
                [self._id_to_node, np.full(1, NONE, dtype=np.int64)]
            )
        return rid

    def _set_id_mapping(self, root: bytes, node_index: int) -> None:
        rid = self.root_id(root)  # may reallocate _id_to_node; intern first
        self._id_to_node[rid] = node_index

    # ------------------------------------------------------------ mutation

    def on_block(
        self,
        *,
        slot: int,
        root: bytes,
        parent_root: Optional[bytes],
        state_root: bytes,
        target_root: bytes,
        justified_checkpoint: tuple,
        finalized_checkpoint: tuple,
        unrealized_justified_checkpoint: tuple,
        unrealized_finalized_checkpoint: tuple,
        execution_status: str = ExecutionStatus.IRRELEVANT,
        execution_block_hash: Optional[bytes] = None,
        current_slot: Optional[int] = None,
    ) -> None:
        """Register a block (reference: ``proto_array.rs:369``). Idempotent."""
        if root in self.indices:
            return
        parent = self.indices.get(parent_root) if parent_root is not None else None
        node_index = len(self.nodes)
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            state_root=state_root,
            target_root=target_root,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
            unrealized_justified_checkpoint=unrealized_justified_checkpoint,
            unrealized_finalized_checkpoint=unrealized_finalized_checkpoint,
            execution_status=execution_status,
            execution_block_hash=execution_block_hash,
        )
        # A block whose payload was already known invalid cannot enter.
        if parent is not None and self.nodes[parent].execution_status == ExecutionStatus.INVALID:
            node.execution_status = ExecutionStatus.INVALID
        self.nodes.append(node)
        self.indices[root] = node_index
        self._set_id_mapping(root, node_index)
        if parent is not None:
            self._maybe_update_best_child_and_descendant(
                parent, node_index, current_slot if current_slot is not None else slot
            )

    def apply_score_changes(
        self,
        deltas: np.ndarray,
        *,
        justified_checkpoint: tuple,
        finalized_checkpoint: tuple,
        current_slot: int,
        new_proposer_boost: tuple = (None, 0),
    ) -> None:
        """Back-propagate vote deltas and refresh best-child/descendant links
        (reference: ``proto_array.rs:212`` ``apply_score_changes``).

        ``deltas`` is one int64 per node.  Reference semantics preserved
        exactly: the zero-hash root (genesis alias in scripted tests) is
        skipped; a payload-INVALID node's delta is replaced with ``-weight``
        so its weight pins to zero and the removal propagates to ancestors
        (vote deltas ON the invalid node are discarded, not propagated);
        proposer boost is never applied to, nor removed from, invalid
        nodes."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError(
                f"delta length {len(deltas)} != node count {len(self.nodes)}"
            )
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint

        prev_root, prev_score = self.previous_proposer_boost
        boost_root, boost_score = new_proposer_boost
        applied_boost = 0  # recorded only if the boost node was credited
        zero_root = b"\x00" * 32

        # Children always have higher indices than parents (append order), so a
        # single reverse pass both applies deltas and propagates to parents.
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.root == zero_root:
                continue
            is_invalid = node.execution_status == ExecutionStatus.INVALID
            if is_invalid:
                d = -node.weight
            else:
                d = int(deltas[i])
                if prev_root is not None and prev_root == node.root:
                    d -= prev_score
                if boost_root is not None and boost_root == node.root and boost_score:
                    d += boost_score
                    applied_boost = boost_score
            if is_invalid:
                node.weight = 0
            else:
                node.weight += d
                if node.weight < 0:
                    raise ProtoArrayError(f"negative weight at node {i}")
            if node.parent is not None:
                deltas[node.parent] += d
        self.previous_proposer_boost = (
            (boost_root, applied_boost) if boost_root else (None, 0)
        )
        for i in range(len(self.nodes) - 1, -1, -1):
            parent = self.nodes[i].parent
            if parent is not None:
                self._maybe_update_best_child_and_descendant(parent, i, current_slot)

    def find_head(self, justified_root: bytes, current_slot: int) -> bytes:
        """Walk best-descendant from the justified root
        (reference: ``proto_array.rs`` ``find_head``)."""
        ji = self.indices.get(justified_root)
        if ji is None:
            raise ProtoArrayError(f"justified root unknown: {justified_root.hex()[:16]}")
        justified = self.nodes[ji]
        if justified.execution_status == ExecutionStatus.INVALID:
            # No valid descendant of an invalid justified block can exist:
            # fork choice is broken until a new justified root is set
            # (reference find_head, proto_array.rs:712).
            raise ProtoArrayError("justified block has an invalid payload")
        best = justified.best_descendant
        node = self.nodes[best] if best is not None else justified
        if not self._node_is_viable_for_head(node, current_slot):
            raise ProtoArrayError(
                "best descendant is not viable for head (justified "
                f"{self.justified_checkpoint}, node jc {node.justified_checkpoint})"
            )
        return node.root

    # ------------------------------------------------------------ viability

    def _voting_source(self, node: ProtoNode, current_slot: int) -> tuple:
        """Spec ``get_voting_source``: blocks from prior epochs are 'pulled up'
        to their unrealized justification."""
        current_epoch = current_slot // self.slots_per_epoch
        node_epoch = node.slot // self.slots_per_epoch
        if current_epoch > node_epoch:
            # Unrealized justification may be untracked (reference keeps an
            # Option and falls back to the realized checkpoint).
            if node.unrealized_justified_checkpoint is not None:
                return node.unrealized_justified_checkpoint
        return node.justified_checkpoint

    def _node_is_viable_for_head(self, node: ProtoNode, current_slot: int) -> bool:
        """Spec ``filter_block_tree`` viability; reference
        ``proto_array.rs`` ``node_is_viable_for_head``."""
        if node.execution_status == ExecutionStatus.INVALID:
            return False
        j_epoch, _ = self.justified_checkpoint
        f_epoch, f_root = self.finalized_checkpoint
        current_epoch = current_slot // self.slots_per_epoch
        voting_source = self._voting_source(node, current_slot)
        correct_justified = (
            j_epoch == 0
            or voting_source[0] == j_epoch
            # spec allowance: voting source within 2 epochs of current
            or voting_source[0] + 2 >= current_epoch
        )
        if not correct_justified:
            return False
        if f_epoch == 0:
            return True
        return self.is_finalized_checkpoint_or_descendant(node.root)

    def _node_leads_to_viable_head(self, node: ProtoNode, current_slot: int) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(
                self.nodes[node.best_descendant], current_slot
            )
        return self._node_is_viable_for_head(node, current_slot)

    def _maybe_update_best_child_and_descendant(
        self, parent_index: int, child_index: int, current_slot: int
    ) -> None:
        """Reference: ``proto_array.rs`` ``maybe_update_best_child_and_descendant``."""
        child = self.nodes[child_index]
        parent = self.nodes[parent_index]
        child_leads = self._node_leads_to_viable_head(child, current_slot)
        child_best_desc = (
            child.best_descendant if child.best_descendant is not None else child_index
        )

        def make_best() -> None:
            parent.best_child = child_index
            parent.best_descendant = child_best_desc

        def unset() -> None:
            parent.best_child = None
            parent.best_descendant = None

        if parent.best_child is None:
            if child_leads:
                make_best()
            return
        if parent.best_child == child_index:
            if not child_leads:
                unset()
            else:
                make_best()  # refresh best_descendant link
            return
        best = self.nodes[parent.best_child]
        best_leads = self._node_leads_to_viable_head(best, current_slot)
        if child_leads and not best_leads:
            make_best()
        elif child_leads and best_leads:
            if child.weight > best.weight or (
                child.weight == best.weight and child.root >= best.root
            ):
                make_best()
        elif not child_leads and not best_leads:
            # keep current (both non-viable); reference keeps the stale link too
            pass

    # ------------------------------------------------------------ ancestry

    def _ancestor_at_slot(self, node: ProtoNode, slot: int) -> Optional[bytes]:
        while node.slot > slot:
            if node.parent is None:
                return node.root
            node = self.nodes[node.parent]
        return node.root

    def ancestor_at_slot(self, root: bytes, slot: int) -> Optional[bytes]:
        idx = self.indices.get(root)
        if idx is None:
            return None
        return self._ancestor_at_slot(self.nodes[idx], slot)

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        ai = self.indices.get(ancestor_root)
        di = self.indices.get(descendant_root)
        if ai is None or di is None:
            return False
        return (
            self._ancestor_at_slot(self.nodes[di], self.nodes[ai].slot) == ancestor_root
        )

    def contains_block(self, root: bytes) -> bool:
        return root in self.indices

    def get_block(self, root: bytes) -> Optional[ProtoNode]:
        idx = self.indices.get(root)
        return self.nodes[idx] if idx is not None else None

    # ----------------------------------------------------- optimistic sync

    def on_valid_execution_payload(self, root: bytes) -> None:
        """Mark a block's payload VALID; validity propagates to all ancestors
        (reference: ``proto_array.rs`` ``propagate_execution_payload_validation``)."""
        idx = self.indices.get(root)
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == ExecutionStatus.INVALID:
                raise InvalidAncestorError(
                    f"marking VALID but ancestor {node.root.hex()[:16]} is INVALID"
                )
            if node.execution_status in (ExecutionStatus.VALID, ExecutionStatus.IRRELEVANT):
                break
            node.execution_status = ExecutionStatus.VALID
            idx = node.parent

    def execution_block_hash_to_beacon_block_root(
        self, block_hash: bytes
    ) -> Optional[bytes]:
        """Latest block whose payload hash matches (reference searches nodes
        in reverse — most recent wins)."""
        for node in reversed(self.nodes):
            if node.execution_block_hash == block_hash:
                return node.root
        return None

    def is_finalized_checkpoint_or_descendant(self, root: bytes) -> bool:
        """Reference ``proto_array.rs:1024``: checkpoint shortcuts first,
        then an ancestry walk down to the finalized slot."""
        f_epoch, f_root = self.finalized_checkpoint
        f_slot = f_epoch * self.slots_per_epoch
        idx = self.indices.get(root)
        if idx is None:
            return False
        node = self.nodes[idx]
        for cp in (
            node.finalized_checkpoint,
            node.justified_checkpoint,
            node.unrealized_finalized_checkpoint,
            node.unrealized_justified_checkpoint,
        ):
            if cp is not None and tuple(cp) == tuple(self.finalized_checkpoint):
                return True
        while True:
            if node.slot <= f_slot:
                return node.root == f_root
            if node.parent is None:
                return False
            node = self.nodes[node.parent]

    def on_invalid_execution_payload(
        self,
        head_root: bytes,
        latest_valid_hash: Optional[bytes] = None,
        always_invalidate_head: bool = True,
    ) -> None:
        """Mark payloads INVALID (reference:
        ``propagate_execution_payload_invalidation``, proto_array.rs:499).

        ``latest_valid_hash=None`` is the reference's ``InvalidateOne``:
        only ``head_root`` and its descendants are invalidated, never
        ancestors.  With a hash, ancestors between head and the latest valid
        ancestor are invalidated — but ONLY if that ancestor is known and is
        a finalized-checkpoint descendant; an unknown/junk hash invalidates
        just the head (the alternative — invalidating every ancestor — could
        brand the justified checkpoint invalid and halt the client)."""
        start = self.indices.get(head_root)
        if start is None:
            raise ProtoArrayError("invalidated block unknown")
        invalid: set = set()

        lva_root = (
            self.execution_block_hash_to_beacon_block_root(latest_valid_hash)
            if latest_valid_hash is not None
            else None
        )
        lva_is_descendant = lva_root is not None and (
            self.is_descendant(lva_root, head_root)
            and self.is_finalized_checkpoint_or_descendant(lva_root)
        )

        # Step 1: walk ancestors from the head, collecting invalidations.
        idx: Optional[int] = start
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status == ExecutionStatus.IRRELEVANT:
                break
            if not lva_is_descendant and node.root != head_root:
                break
            if (
                latest_valid_hash is not None
                and node.execution_block_hash == latest_valid_hash
            ):
                # The latest valid ancestor itself: scrub best links that
                # point into the invalidated set, then stop.
                if node.best_child in invalid:
                    node.best_child = None
                if node.best_descendant in invalid:
                    node.best_descendant = None
                break
            if (
                node.root != head_root
                or always_invalidate_head
                or lva_is_descendant
            ):
                if node.execution_status == ExecutionStatus.VALID:
                    raise InvalidAncestorError(
                        f"invalidation reaches VALID block {node.root.hex()[:16]}"
                    )
                if node.execution_status == ExecutionStatus.OPTIMISTIC:
                    invalid.add(idx)
                    node.execution_status = ExecutionStatus.INVALID
                    node.best_child = None
                    node.best_descendant = None
                # already INVALID: keep walking so ancestors update too
            idx = node.parent

        # Step 2: forward sweep — descendants of any invalidated node are
        # invalid (children always have higher indices than parents).
        start_root = lva_root if lva_is_descendant else head_root
        si = self.indices[start_root]
        for i in range(si + 1, len(self.nodes)):
            node = self.nodes[i]
            if node.parent in invalid:
                if node.execution_status == ExecutionStatus.VALID:
                    raise InvalidAncestorError(
                        f"VALID descendant {node.root.hex()[:16]} of invalid block"
                    )
                if node.execution_status == ExecutionStatus.IRRELEVANT:
                    raise ProtoArrayError(
                        f"irrelevant (pre-merge) descendant {node.root.hex()[:16]} "
                        "of a post-merge block"
                    )
                node.execution_status = ExecutionStatus.INVALID
                node.best_child = None
                node.best_descendant = None
                invalid.add(i)

    # -------------------------------------------------------------- prune

    def prune(self, finalized_root: bytes) -> List[ProtoNode]:
        """Drop nodes before the finalized root once enough have accumulated
        (reference: ``proto_array.rs`` ``maybe_prune``). Returns pruned nodes."""
        fi = self.indices.get(finalized_root)
        if fi is None:
            raise ProtoArrayError("finalized root unknown")
        if fi < self.prune_threshold:
            return []
        keep = self.nodes[fi:]
        pruned = self.nodes[:fi]
        shift = fi
        remap: Dict[int, int] = {old: old - shift for old in range(fi, len(self.nodes))}
        for node in keep:
            node.parent = remap.get(node.parent) if node.parent is not None else None
            node.best_child = (
                remap.get(node.best_child) if node.best_child is not None else None
            )
            node.best_descendant = (
                remap.get(node.best_descendant)
                if node.best_descendant is not None
                else None
            )
        self.nodes = keep
        self.indices = {n.root: i for i, n in enumerate(self.nodes)}
        self._id_to_node[:] = NONE
        for n, i in self.indices.items():
            self._id_to_node[self._root_ids[n]] = i
        return pruned

    # ----------------------------------------------------- delta computation

    def compute_deltas(
        self,
        votes: VoteTracker,
        old_balances: np.ndarray,
        new_balances: np.ndarray,
    ) -> np.ndarray:
        """Vectorized vote-delta computation (reference:
        ``proto_array_fork_choice.rs:900`` ``compute_deltas``).

        For every validator whose latest message moved (or whose balance
        changed), subtract the old balance from the old vote's node and add the
        new balance to the new vote's node.  Scalar loop in the reference;
        scatter-add here."""
        deltas = np.zeros(len(self.nodes), dtype=np.int64)
        n = len(votes.current_root_id)
        if n == 0:
            return deltas
        ob = np.zeros(n, dtype=np.int64)
        nb = np.zeros(n, dtype=np.int64)
        ob[: min(n, len(old_balances))] = old_balances[:n]
        nb[: min(n, len(new_balances))] = new_balances[:n]
        # Equivocating validators contribute nothing ever again.
        nb[votes.equivocating] = 0
        has_next = votes.next_root_id != NONE
        changed = (votes.current_root_id != votes.next_root_id) | (ob != nb)
        changed &= has_next | (votes.current_root_id != NONE)

        cur_idx = np.full(n, NONE, dtype=np.int64)
        m = votes.current_root_id != NONE
        cur_idx[m] = self._id_to_node[votes.current_root_id[m]]
        nxt_idx = np.full(n, NONE, dtype=np.int64)
        m = has_next
        nxt_idx[m] = self._id_to_node[votes.next_root_id[m]]

        sub_m = changed & (cur_idx != NONE)
        np.subtract.at(deltas, cur_idx[sub_m], ob[sub_m])
        add_m = changed & (nxt_idx != NONE)
        np.add.at(deltas, nxt_idx[add_m], nb[add_m])

        # Advance current <- next for everyone with a next vote.
        votes.current_root_id = np.where(
            has_next, votes.next_root_id, votes.current_root_id
        )
        # Equivocating votes are consumed: their balance was subtracted once
        # above; clearing both roots keeps later rounds from re-subtracting
        # (the reference empties the VoteTracker on equivocation too).
        eq = votes.equivocating
        votes.current_root_id[eq] = NONE
        votes.next_root_id[eq] = NONE
        return deltas
