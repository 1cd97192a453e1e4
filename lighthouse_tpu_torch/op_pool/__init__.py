"""Operation pool: attestations (max-cover packed), slashings, exits,
BLS-to-execution changes.

Equivalent of the reference's ``beacon_node/operation_pool`` (3.5k LoC):
compact attestation storage keyed by ``AttestationData`` root with multiple
(possibly overlapping) aggregates per key, greedy **max-cover** selection for
block production (`operation_pool/src/max_cover.rs`), and validity-filtered
pools for the other operation types.

A copy of the JAX package's ``lighthouse_tpu/op_pool/__init__.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..consensus import helpers as h
from ..types.spec import TIMELY_TARGET_FLAG_INDEX, ChainSpec


def attester_slashing_indices(slashing) -> List[int]:
    """Validators an attester slashing convicts: the intersection of the two
    attestations' index sets (spec ``process_attester_slashing``) — the ONE
    implementation every consumer (packing, pruning, fork-choice masking,
    adversary evidence) shares."""
    a1 = {int(i) for i in slashing.attestation_1.attesting_indices}
    a2 = {int(i) for i in slashing.attestation_2.attesting_indices}
    return sorted(a1 & a2)


def max_cover(candidates: Sequence[Tuple[object, Set[int]]], limit: int) -> List[object]:
    """Greedy maximum-coverage: repeatedly take the candidate covering the
    most yet-uncovered items (reference ``max_cover.rs`` — same greedy
    (1 - 1/e)-approximation, with covered items deducted from remaining
    candidates each round)."""
    remaining = [(item, set(cover)) for item, cover in candidates]
    covered: Set[int] = set()
    out: List[object] = []
    while remaining and len(out) < limit:
        best_i = max(range(len(remaining)), key=lambda i: len(remaining[i][1] - covered))
        item, cover = remaining.pop(best_i)
        fresh = cover - covered
        if not fresh:
            break
        covered |= fresh
        out.append(item)
    return out


@dataclass
class _AttestationGroup:
    """All aggregates seen for one AttestationData (reference
    ``attestation_storage.rs`` compact representation)."""

    data: object
    aggregates: List[object] = field(default_factory=list)  # Attestation objects

    def insert(self, attestation) -> None:
        new_bits = list(attestation.aggregation_bits)
        for existing in self.aggregates:
            if list(existing.aggregation_bits) == new_bits:
                return  # exact duplicate
        # keep only non-subsumed aggregates
        self.aggregates = [
            a
            for a in self.aggregates
            if not _is_subset(list(a.aggregation_bits), new_bits)
        ]
        if not any(
            _is_subset(new_bits, list(a.aggregation_bits)) for a in self.aggregates
        ):
            self.aggregates.append(attestation.copy())


def _is_subset(a: List[bool], b: List[bool]) -> bool:
    return all((not x) or y for x, y in zip(a, b))


class OperationPool:
    def __init__(self) -> None:
        self._attestations: Dict[Tuple[int, bytes], _AttestationGroup] = {}
        self._proposer_slashings: Dict[int, object] = {}  # by proposer index
        # keyed by hash_tree_root: the local slasher and the gossip topic can
        # both deliver the same container — the pool must not grow on replays
        self._attester_slashings: Dict[bytes, object] = {}
        self._voluntary_exits: Dict[int, object] = {}  # by validator index
        self._bls_changes: Dict[int, object] = {}  # by validator index

    # ------------------------------------------------------- attestations

    def insert_attestation(self, attestation) -> None:
        key = (int(attestation.data.slot), h.attestation_dedup_key(attestation))
        group = self._attestations.get(key)
        if group is None:
            group = self._attestations[key] = _AttestationGroup(data=attestation.data)
        group.insert(attestation)

    def num_attestations(self) -> int:
        return sum(len(g.aggregates) for g in self._attestations.values())

    def get_attestations(self, state, types, spec: ChainSpec, limit: int) -> List[object]:
        """Max-cover packing of attestations valid for a block on ``state``
        (reference ``op_pool.get_attestations`` → ``AttMaxCover``): coverage
        sets are the attesting validator indices not yet known to the state's
        participation."""
        from ..consensus.per_block import process_attestation

        candidates: List[Tuple[object, Set[int]]] = []
        state_slot = int(state.slot)
        fork = type(state).fork_name
        # Freshness filter (reference ``AttMaxCover::fresh_validators``):
        # a validator who already carries the timely-target flag for the
        # attestation's epoch contributes nothing, so it must not count as
        # coverage.  Without this, deneb's unbounded inclusion window
        # (EIP-7045) lets stale aggregates outscore fresh current-epoch
        # ones and crowd them out of the block — justification then lands
        # one epoch late and finalization trails by an epoch.  phase0
        # states keep raw coverage (participation is pending-attestation
        # based there; the inclusion window is one epoch anyway).
        participation_by_epoch = {}
        if fork != "phase0":
            participation_by_epoch = {
                int(h.get_previous_epoch(state, spec)):
                    state.previous_epoch_participation,
                int(h.get_current_epoch(state, spec)):
                    state.current_epoch_participation,
            }
        # Canonical candidate order (sorted keys, then bit patterns), NOT
        # gossip-arrival order: max_cover breaks ties by position, so two
        # nodes with the same pool contents — or one node across two runs —
        # must pack identical bodies whatever order the wire delivered the
        # attestations in (the scenario soak's determinism gate).
        is_electra_state = fork == "electra"
        for (slot, _), group in sorted(self._attestations.items()):
            if not spec.attestation_includable(slot, state_slot):
                continue
            for att in sorted(
                group.aggregates,
                key=lambda a: (tuple(a.aggregation_bits),
                               tuple(getattr(a, "committee_bits", ()) or ())),
            ):
                committee_bits = getattr(att, "committee_bits", None)
                # container families don't cross the electra boundary:
                # pre-fork attestations can't ride in electra bodies (and
                # vice versa) — EIP-7549 changed the container.
                if (committee_bits is not None) != is_electra_state:
                    continue
                try:
                    if committee_bits is not None:
                        # electra: indices derived through committee_bits
                        cover = set(h.get_attesting_indices(
                            state, att.data, att.aggregation_bits, spec,
                            committee_bits=committee_bits,
                        ))
                    else:
                        committee = h.get_beacon_committee(
                            state, int(att.data.slot), int(att.data.index), spec
                        )
                        cover = {
                            int(committee[i])
                            for i, bit in enumerate(att.aggregation_bits)
                            if bit and i < len(committee)
                        }
                except Exception:
                    continue
                if fork != "phase0":
                    part = participation_by_epoch.get(int(att.data.target.epoch))
                    if part is None:
                        continue  # target epoch not includable on this state
                    cover = {
                        i for i in cover
                        if i < len(part)
                        and not h.has_flag(int(part[i]), TIMELY_TARGET_FLAG_INDEX)
                    }
                if cover:
                    candidates.append((att, cover))
        picked = max_cover(candidates, limit)
        # Validity filter by trial application (the reference's per-op checks)
        scratch = state.copy()
        out = []
        for att in picked:
            try:
                process_attestation(scratch, att, types, spec, verify=False)
            except Exception:
                continue
            out.append(att)
        return out

    # ---------------------------------------------------------- slashings

    def insert_proposer_slashing(self, slashing) -> None:
        self._proposer_slashings[int(slashing.signed_header_1.message.proposer_index)] = slashing

    def insert_attester_slashing(self, slashing) -> None:
        self._attester_slashings.setdefault(slashing.hash_tree_root(), slashing)

    def attester_slashings(self) -> List[object]:
        """Pool contents in canonical (container-root) order.  Iterations
        snapshot via ``.copy()`` (GIL-atomic): the pool is lock-free and a
        worker may insert concurrently — the old list tolerated appends
        mid-iteration, the dict must too."""
        return [s for _root, s in sorted(self._attester_slashings.copy().items())]

    def num_proposer_slashings(self) -> int:
        return len(self._proposer_slashings)

    def has_proposer_slashing(self, proposer_index: int) -> bool:
        return int(proposer_index) in self._proposer_slashings

    def num_attester_slashings(self) -> int:
        return len(self._attester_slashings)

    def get_slashings(self, state, spec: ChainSpec, types) -> Tuple[List, List]:
        """(proposer_slashings, attester_slashings) valid against ``state``,
        bounded by the preset maxima.

        Packing order is canonical (proposer slashings by proposer index,
        attester slashings by container root), never arrival order: two
        nodes holding the same pool — or one node across two runs — must
        pack identical bodies (the scenario soak's determinism gate), and a
        slashing flood past the per-block cap must overflow into later
        blocks deterministically.  Slashings whose validators are all
        already slashed in ``state`` are dead block space and are skipped
        (``is_slashable_validator`` excludes slashed validators)."""
        epoch = h.get_current_epoch(state, spec)
        proposer = []
        for idx in sorted(self._proposer_slashings):
            s = self._proposer_slashings[idx]
            if idx < len(state.validators) and h.is_slashable_validator(
                state.validators[idx], epoch
            ):
                proposer.append(s)
            if len(proposer) >= spec.preset.max_proposer_slashings:
                break
        attester = []
        covered: Set[int] = set()
        is_electra_state = type(state).fork_name == "electra"
        max_attester = (
            spec.preset.max_attester_slashings_electra
            if is_electra_state
            else spec.preset.max_attester_slashings
        )
        for _root, s in sorted(self._attester_slashings.copy().items()):
            # container families don't cross the electra boundary (EIP-7549
            # changed IndexedAttestation's limits)
            if ("Electra" in type(s).__name__) != is_electra_state:
                continue
            # a mis-oriented pair would fail per_block processing and poison
            # every produced block — never hand one out
            if not h.is_slashable_attestation_data(
                s.attestation_1.data, s.attestation_2.data
            ):
                continue
            slashable = {
                i
                for i in attester_slashing_indices(s)
                if i < len(state.validators)
                and h.is_slashable_validator(state.validators[i], epoch)
            }
            if slashable - covered:
                covered |= slashable
                attester.append(s)
            if len(attester) >= max_attester:
                break
        return proposer, attester

    # -------------------------------------------------------------- exits

    def insert_voluntary_exit(self, signed_exit) -> None:
        self._voluntary_exits[int(signed_exit.message.validator_index)] = signed_exit

    def get_voluntary_exits(self, state, types, spec: ChainSpec) -> List[object]:
        """Exits includable in a block on ``state``: full spec validity via
        trial application (a stale pool entry must never break production —
        reference filters with ``verify_operation`` revalidation)."""
        from ..consensus.per_block import process_voluntary_exit

        scratch = None
        out = []
        for idx, ex in self._voluntary_exits.items():
            if idx >= len(state.validators):
                continue
            if scratch is None:
                scratch = state.copy()
            try:
                process_voluntary_exit(scratch, ex, types, spec, verify=False)
            except Exception:
                continue
            out.append(ex)
            if len(out) >= spec.preset.max_voluntary_exits:
                break
        return out

    # --------------------------------------------------- bls-to-execution

    def insert_bls_to_execution_change(self, signed_change) -> None:
        self._bls_changes[int(signed_change.message.validator_index)] = signed_change

    def get_bls_to_execution_changes(self, state, spec: ChainSpec) -> List[object]:
        out = []
        for idx, ch in self._bls_changes.items():
            if idx < len(state.validators) and bytes(
                state.validators[idx].withdrawal_credentials
            )[:1] == b"\x00":
                out.append(ch)
            if len(out) >= spec.preset.max_bls_to_execution_changes:
                break
        return out

    # ------------------------------------------------------------- pruning

    def prune(self, state, spec: ChainSpec, current_slot: Optional[int] = None) -> None:
        """Drop operations no longer includable (reference ``prune_all``).
        ``current_slot`` is the wall-clock slot (the head block may be old)."""
        from ..types.spec import FAR_FUTURE_EPOCH

        cur = int(state.slot) if current_slot is None else current_slot
        self._attestations = {
            k: g for k, g in self._attestations.items() if k[0] + spec.slots_per_epoch >= cur
        }
        n = len(state.validators)
        self._voluntary_exits = {
            i: e
            for i, e in self._voluntary_exits.items()
            if i < n and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
        }
        epoch = h.get_current_epoch(state, spec)
        self._proposer_slashings = {
            i: s
            for i, s in self._proposer_slashings.items()
            if i < n and h.is_slashable_validator(state.validators[i], epoch)
        }
        # Attester slashings with no still-slashable intersection validator
        # are dead weight forever — every offender is already slashed (or
        # withdrawn); drop them so a slashing flood cannot pin pool memory.
        def _still_slashable(s) -> bool:
            return any(
                i < n and h.is_slashable_validator(state.validators[i], epoch)
                for i in attester_slashing_indices(s)
            )

        self._attester_slashings = {
            root: s for root, s in self._attester_slashings.copy().items()
            if _still_slashable(s)
        }
