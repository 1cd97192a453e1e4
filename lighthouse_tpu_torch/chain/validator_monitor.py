"""Per-validator performance monitor.

Equivalent of the reference's ``beacon_chain/src/validator_monitor.rs``
(2.1k LoC): operators register the indices they care about; the monitor
watches on-chain inclusion (did my validator's attestation land in a block?
did my proposal land?), keeps per-epoch hit/miss state, and surfaces a
summary, cumulative per-validator metrics (the
``POST /lighthouse/ui/validator_metrics`` shape — reference
``http_api/src/ui.rs:152-258``), and Prometheus series.

A copy of the JAX package's ``lighthouse_tpu/chain/validator_monitor.py``.
"""

from __future__ import annotations

from ..timeout_lock import TimeoutLock
from typing import Dict, Iterable, Optional, Set

from .. import metrics

MONITOR_HISTORY_EPOCHS = 16

MONITORED_ATTESTATION_HITS = metrics.counter(
    "validator_monitor_attestation_included_total",
    "on-chain attestation inclusions for monitored validators",
)
MONITORED_BLOCKS = metrics.counter(
    "validator_monitor_blocks_proposed_total",
    "on-chain proposals by monitored validators",
)
MONITORED_COUNT = metrics.gauge(
    "validator_monitor_validators", "number of monitored validators",
)
MONITORED_SYNC_HITS = metrics.counter(
    "validator_monitor_sync_committee_hits_total",
    "sync-aggregate inclusions for monitored sync-committee members",
)
MONITORED_SYNC_MISSES = metrics.counter(
    "validator_monitor_sync_committee_misses_total",
    "sync-aggregate misses for monitored sync-committee members",
)
MONITORED_PROPOSAL_MISSES = metrics.counter(
    "validator_monitor_missed_blocks_total",
    "slots where a monitored validator was proposer but no block landed",
)
SIMULATOR_HEAD_HITS = metrics.counter(
    "validator_monitor_attestation_simulator_head_attester_hits_total",
    "simulated attestations whose head vote matched the canonical chain",
)
SIMULATOR_HEAD_MISSES = metrics.counter(
    "validator_monitor_attestation_simulator_head_attester_misses_total",
    "simulated attestations whose head vote missed",
)
SIMULATOR_TARGET_HITS = metrics.counter(
    "validator_monitor_attestation_simulator_target_attester_hits_total",
    "simulated attestations whose target vote matched",
)
SIMULATOR_TARGET_MISSES = metrics.counter(
    "validator_monitor_attestation_simulator_target_attester_misses_total",
    "simulated attestations whose target vote missed",
)

MAX_UNAGGREGATED_ATTESTATIONS = 64


def _pct(hits: int, misses: int) -> float:
    # Floor division on purpose: the reference computes
    # `(100 * hits / total) as f64` over u64s (ui.rs:219-232), which
    # truncates — wire parity beats precision here.
    total = hits + misses
    return 0.0 if total == 0 else float(100 * hits // total)


class ValidatorMonitor:
    def __init__(self, spec):
        self.spec = spec
        self.monitored: Set[int] = set()
        self._lock = TimeoutLock("validator_monitor")
        # target epoch -> monitored validators whose attestation was included
        self._included: Dict[int, Set[int]] = {}
        # target epoch -> vidx -> {"head": bool|None, "target": bool|None}
        self._flags: Dict[int, Dict[int, dict]] = {}
        # slot -> monitored proposer
        self._proposed: Dict[int, int] = {}
        # cumulative per-validator counters, advanced as epochs close
        self._counters: Dict[int, dict] = {}
        self._registered_epoch: Dict[int, int] = {}
        self._last_closed_epoch: int = -1
        # slot -> simulated AttestationData (attestation_simulator.rs feed)
        self._simulated: Dict[int, object] = {}
        self.simulator_stats = {"head_hits": 0, "head_misses": 0,
                                "target_hits": 0, "target_misses": 0}
        self._last_proposal_slot_checked: int = -1

    def register(self, indices: Iterable[int], current_epoch: int = 0) -> None:
        with self._lock:
            for i in indices:
                i = int(i)
                if i not in self.monitored:
                    self.monitored.add(i)
                    self._registered_epoch[i] = int(current_epoch)
                    self._counters.setdefault(i, {
                        "attestation_hits": 0, "attestation_misses": 0,
                        "attestation_head_hits": 0, "attestation_head_misses": 0,
                        "attestation_target_hits": 0, "attestation_target_misses": 0,
                        "latest_attestation_inclusion_distance": 0,
                        "sync_committee_hits": 0, "sync_committee_misses": 0,
                        "proposal_hits": 0, "proposal_misses": 0,
                    })
            MONITORED_COUNT.set(len(self.monitored))

    # ------------------------------------------------------------- feeding

    def on_attestation_included(
        self,
        target_epoch: int,
        attesting_indices: Iterable[int],
        head_hit: Optional[bool] = None,
        target_hit: Optional[bool] = None,
        inclusion_distance: Optional[int] = None,
    ) -> None:
        """Called per attestation in an imported block.  head_hit/target_hit
        say whether the attested head/target match the including chain
        (None = undeterminable, not counted either way)."""
        if not self.monitored:
            return
        hits = self.monitored.intersection(int(i) for i in attesting_indices)
        if not hits:
            return
        with self._lock:
            seen = self._included.setdefault(int(target_epoch), set())
            new = hits - seen
            seen.update(new)
            flags = self._flags.setdefault(int(target_epoch), {})
            for v in new:
                flags[v] = {"head": head_hit, "target": target_hit}
                if inclusion_distance is not None and v in self._counters:
                    self._counters[v]["latest_attestation_inclusion_distance"] = int(
                        inclusion_distance
                    )
        if new:
            MONITORED_ATTESTATION_HITS.inc(len(new))

    def on_block_imported(self, slot: int, proposer_index: int) -> None:
        if int(proposer_index) in self.monitored:
            with self._lock:
                self._proposed[int(slot)] = int(proposer_index)
                c = self._counters.get(int(proposer_index))
                if c is not None:
                    c["proposal_hits"] += 1
            MONITORED_BLOCKS.inc()

    def on_sync_aggregate(self, slot: int, participating: Iterable[int],
                          missing: Iterable[int]) -> None:
        """Per imported post-altair block: which monitored sync-committee
        members' bits were set / unset in its sync aggregate (reference
        validator_monitor.rs register_sync_aggregate_in_block)."""
        if not self.monitored:
            return
        hits = self.monitored.intersection(int(i) for i in participating)
        misses = self.monitored.intersection(int(i) for i in missing)
        if not hits and not misses:
            return
        with self._lock:
            for v in hits:
                c = self._counters.get(v)
                if c is not None:
                    c["sync_committee_hits"] += 1
            for v in misses:
                c = self._counters.get(v)
                if c is not None:
                    c["sync_committee_misses"] += 1
        if hits:
            MONITORED_SYNC_HITS.inc(len(hits))
        if misses:
            MONITORED_SYNC_MISSES.inc(len(misses))

    def on_proposal_outcome(self, slot: int, proposer_index: int,
                            block_seen: bool) -> None:
        """Called once per CLOSED slot with the slot's expected proposer:
        a monitored proposer with no canonical block is a missed block
        (reference validator_monitor.rs missed-block tracking).  Proposal
        HITS are counted at import (on_block_imported)."""
        v = int(proposer_index)
        with self._lock:
            # idempotent per slot: the tick can fire more than once per slot
            if int(slot) <= self._last_proposal_slot_checked:
                return
            self._last_proposal_slot_checked = int(slot)
            if block_seen or v not in self.monitored:
                return
            c = self._counters.get(v)
            if c is not None:
                c["proposal_misses"] += 1
        MONITORED_PROPOSAL_MISSES.inc()

    def _close_epochs(self, current_epoch: int) -> None:
        """Tally cumulative hit/miss counters for every epoch that can no
        longer gain inclusions (inclusion lags at most one full epoch, so
        epoch e closes once current_epoch >= e + 2).  Lock held by caller."""
        start = self._last_closed_epoch + 1
        for e in range(start, int(current_epoch) - 1):
            included = self._included.get(e, set())
            flags = self._flags.get(e, {})
            for v in self.monitored:
                if self._registered_epoch.get(v, 0) > e:
                    continue
                c = self._counters.get(v)
                if c is None:
                    continue
                if v in included:
                    c["attestation_hits"] += 1
                    f = flags.get(v, {})
                    if f.get("head") is True:
                        c["attestation_head_hits"] += 1
                    elif f.get("head") is False:
                        c["attestation_head_misses"] += 1
                    if f.get("target") is True:
                        c["attestation_target_hits"] += 1
                    elif f.get("target") is False:
                        c["attestation_target_misses"] += 1
                else:
                    c["attestation_misses"] += 1
            self._last_closed_epoch = e

    def set_unaggregated_attestation(self, slot: int, data) -> None:
        """Store one simulated per-slot attestation (the attestation
        simulator's feed, reference validator_monitor.rs
        ``set_unaggregated_attestation``); bounded like the reference."""
        with self._lock:
            if len(self._simulated) >= MAX_UNAGGREGATED_ATTESTATIONS:
                self._simulated.pop(min(self._simulated), None)
            self._simulated[int(slot)] = data

    def score_simulated_attestations(self, state, spec, helpers) -> None:
        """Compare stored simulated attestations against the now-canonical
        chain (called at block import, once the truth for their slots is
        knowable) and count head/target hit/miss metrics."""
        with self._lock:
            due = [(s, d) for s, d in self._simulated.items()
                   if s < int(state.slot)]
            for s, _ in due:
                del self._simulated[s]
        tally = {"head_hits": 0, "head_misses": 0,
                 "target_hits": 0, "target_misses": 0}
        for slot, data in due:
            try:
                head_hit = bytes(data.beacon_block_root) == bytes(
                    helpers.get_block_root_at_slot(state, slot, spec)
                )
            except Exception:
                continue
            try:
                target_hit = bytes(data.target.root) == bytes(
                    helpers.get_block_root(state, int(data.target.epoch), spec)
                )
            except Exception:
                target_hit = None
            if head_hit:
                SIMULATOR_HEAD_HITS.inc()
                tally["head_hits"] += 1
            else:
                SIMULATOR_HEAD_MISSES.inc()
                tally["head_misses"] += 1
            if target_hit is True:
                SIMULATOR_TARGET_HITS.inc()
                tally["target_hits"] += 1
            elif target_hit is False:
                SIMULATOR_TARGET_MISSES.inc()
                tally["target_misses"] += 1
        if any(tally.values()):
            with self._lock:  # shared stats follow the class's lock rule
                for k, v in tally.items():
                    self.simulator_stats[k] += v

    # ------------------------------------------------------------- queries

    def summary(self, epoch: int) -> dict:
        """Hit/miss summary for ``epoch`` (meaningful once epoch+1 ends —
        inclusion can lag a full epoch)."""
        with self._lock:
            included = sorted(self._included.get(int(epoch), set()))
            missed = sorted(self.monitored.difference(included))
            proposals = sorted(
                s for s, p in self._proposed.items()
                if s // self.spec.slots_per_epoch == int(epoch)
            )
        return {
            "epoch": int(epoch),
            "monitored": len(self.monitored),
            "attestation_included": included,
            "attestation_missed": missed,
            "proposal_slots": proposals,
        }

    def validator_metrics(self, indices: Iterable[int]) -> dict:
        """Reference ``post_validator_monitor_metrics``: cumulative counters
        for the intersection of the requested and monitored sets."""
        out = {}
        with self._lock:
            for raw in indices:
                v = int(raw)
                c = self._counters.get(v)
                if v not in self.monitored or c is None:
                    continue
                out[str(v)] = {
                    "attestation_hits": c["attestation_hits"],
                    "attestation_misses": c["attestation_misses"],
                    "attestation_hit_percentage": _pct(
                        c["attestation_hits"], c["attestation_misses"]),
                    "attestation_head_hits": c["attestation_head_hits"],
                    "attestation_head_misses": c["attestation_head_misses"],
                    "attestation_head_hit_percentage": _pct(
                        c["attestation_head_hits"], c["attestation_head_misses"]),
                    "attestation_target_hits": c["attestation_target_hits"],
                    "attestation_target_misses": c["attestation_target_misses"],
                    "attestation_target_hit_percentage": _pct(
                        c["attestation_target_hits"], c["attestation_target_misses"]),
                    "latest_attestation_inclusion_distance":
                        c["latest_attestation_inclusion_distance"],
                    "sync_committee_hits": c.get("sync_committee_hits", 0),
                    "sync_committee_misses": c.get("sync_committee_misses", 0),
                    "proposal_hits": c.get("proposal_hits", 0),
                    "proposal_misses": c.get("proposal_misses", 0),
                }
        return {"validators": out}

    def prune(self, current_epoch: int) -> None:
        cutoff = int(current_epoch) - MONITOR_HISTORY_EPOCHS
        with self._lock:
            self._close_epochs(int(current_epoch))
            for e in [e for e in self._included if e < cutoff]:
                del self._included[e]
                self._flags.pop(e, None)
            slot_cutoff = cutoff * self.spec.slots_per_epoch
            for s in [s for s in self._proposed if s < slot_cutoff]:
                del self._proposed[s]
