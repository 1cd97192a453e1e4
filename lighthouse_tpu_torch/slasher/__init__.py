"""The slasher: double-vote / surround-vote / double-proposal detection over
dense per-validator epoch arrays.

Equivalent of the reference's ``slasher`` crate (``src/array.rs`` — chunked
min/max-target span arrays over an LMDB/MDBX store; 625 LoC).  SURVEY.md
flags the 2D (validator x epoch) distance arrays as a natural dense-array
TPU candidate — this implementation keeps exactly that shape:

- ``sources[v, t % H]``: the source epoch the validator used when attesting
  target ``t`` (the transposed span representation).  Surround checks are
  single vectorized comparisons over an epoch window instead of the
  reference's per-chunk min/max update loops — same detection power, one
  ``numpy``/XLA-friendly pass per attestation batch.
- ``data_roots[v, t % H]``: attestation-data root per target, for double
  votes.

Detection rules (reference ``slasher/src/lib.rs``):
  double vote:      same (validator, target), different data root
  surround (new⊃old): exists t' in (source, target) with sources[t'] > source
  surround (old⊃new): exists t' in (target, head] with 0 < sources[t'] < source
  double proposal:  same (proposer, slot), different block root

A copy of the JAX package's ``lighthouse_tpu/slasher/__init__.py``: the
arrays stay numpy on the host, and the durable log goes to any of the
port's ``store`` key-value stores.  The three arrays take 48 bytes a
(validator, epoch) cell: at the default ``history_length`` of 4096 that is
192 KiB a validator, 192 GiB at 2^20 validators, so a mainnet-width run
passes a shorter history.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

UNSET = -1


class SlasherConfig:
    def __init__(self, history_length: int = 4096, max_validators: int = 1 << 14,
                 slots_per_epoch: int = 32):
        self.history_length = history_length
        self.max_validators = max_validators
        self.slots_per_epoch = slots_per_epoch


class SlasherDB:
    """Dense attestation-history arrays, grown on demand along the validator
    axis.  All updates are O(window) numpy ops."""

    def __init__(self, config: Optional[SlasherConfig] = None):
        self.config = config or SlasherConfig()
        H = self.config.history_length
        n0 = 64
        self._sources = np.full((n0, H), UNSET, dtype=np.int64)
        # actual target epoch stored per column: the circular axis aliases
        # every H epochs, and surround scans must never trust an aliased
        # entry.
        self._targets = np.full((n0, H), UNSET, dtype=np.int64)
        self._roots = np.zeros((n0, H, 32), dtype=np.uint8)
        # (validator, target) -> IndexedAttestation for building slashings
        self._attestations: Dict[Tuple[int, int], object] = {}
        self._proposals: Dict[Tuple[int, int], Tuple[bytes, object]] = {}
        self._lock = threading.Lock()

    def _ensure(self, max_validator: int) -> None:
        n = self._sources.shape[0]
        if max_validator < n:
            return
        new_n = max(n * 2, max_validator + 1)
        H = self.config.history_length
        grown = np.full((new_n, H), UNSET, dtype=np.int64)
        grown[:n] = self._sources
        self._sources = grown
        tgts = np.full((new_n, H), UNSET, dtype=np.int64)
        tgts[:n] = self._targets
        self._targets = tgts
        roots = np.zeros((new_n, H, 32), dtype=np.uint8)
        roots[:n] = self._roots
        self._roots = roots

    # ----------------------------------------------------------- ingestion

    def check_attestation(self, indexed) -> List[dict]:
        """Record an indexed attestation; returns slashing findings:
        ``{"kind": "double"|"surround", "validator": i, "prev": indexed}``."""
        source = int(indexed.data.source.epoch)
        target = int(indexed.data.target.epoch)
        data_root = indexed.data.hash_tree_root()
        H = self.config.history_length
        findings: List[dict] = []
        with self._lock:
            validators = [int(v) for v in indexed.attesting_indices]
            if validators:
                self._ensure(max(validators))
            root_arr = np.frombuffer(data_root, dtype=np.uint8)
            for v in validators:
                col = target % H
                prev_source = int(self._sources[v, col])
                prev_target = int(self._targets[v, col])
                same_target = prev_source != UNSET and prev_target == target
                if same_target and not np.array_equal(self._roots[v, col], root_arr):
                    findings.append({
                        "kind": "double", "validator": v,
                        "prev": self._attestations.get((v, target)),
                        "new_first": False,  # (a1=prev, a2=new): same target
                    })
                    continue  # double vote recorded; don't overwrite
                # --- surround checks over the dense window (vectorized)
                # ``new_first`` orients the slashing container so that
                # attestation_1 SURROUNDS attestation_2
                # (is_slashable_attestation_data requires a1.source < a2.source
                # and a2.target < a1.target).  Every window read is validated
                # against the stored target epoch so circular aliasing can
                # neither fake nor hide evidence.
                row = self._sources[v]
                trow = self._targets[v]
                # new surrounds old: old attestations with target in
                # (source, target) whose source > new source
                if target > source + 1:
                    ts = np.arange(max(source + 1, target - H + 1), target)
                    cols = ts % H
                    mask = (trow[cols] == ts) & (row[cols] > source)
                    if mask.any():
                        t_old = int(ts[mask.argmax()])
                        findings.append({
                            "kind": "surround", "validator": v,
                            "prev": self._attestations.get((v, t_old)),
                            "new_first": True,  # the new attestation surrounds
                        })
                # old surrounds new: old attestations with target > new target
                # whose source < new source (and set) — the FULL window ahead
                # (previously only H/2, dropping distant evidence)
                ts2 = np.arange(target + 1, target + H)
                cols2 = ts2 % H
                window2 = row[cols2]
                mask2 = (trow[cols2] == ts2) & (window2 != UNSET) & (window2 < source)
                if mask2.any():
                    t_old = int(ts2[mask2.argmax()])
                    findings.append({
                        "kind": "surround", "validator": v,
                        "prev": self._attestations.get((v, t_old)),
                        "new_first": False,  # the old attestation surrounds
                    })
                if prev_source == UNSET or (not same_target and prev_target < target):
                    self._sources[v, col] = source
                    self._targets[v, col] = target
                    self._roots[v, col] = root_arr
            for v in validators:
                self._attestations.setdefault((v, target), indexed)
        return findings

    def check_proposal(self, slot: int, proposer: int, block_root: bytes,
                       signed_header=None) -> Optional[dict]:
        """Record a block proposal; returns a double-proposal finding or None."""
        with self._lock:
            key = (int(slot), int(proposer))
            prev = self._proposals.get(key)
            if prev is None:
                self._proposals[key] = (bytes(block_root), signed_header)
                return None
            prev_root, prev_header = prev
            if prev_root == bytes(block_root):
                return None
            return {
                "kind": "double_proposal", "validator": int(proposer),
                "slot": int(slot), "prev_header": prev_header,
            }

    # ------------------------------------------------------------- pruning

    def prune(self, current_epoch: int) -> None:
        """Clear history older than the window (the circular arrays already
        overwrite; this drops the object maps)."""
        H = self.config.history_length
        cutoff = current_epoch - H
        with self._lock:
            for k in [k for k in self._attestations if k[1] < cutoff]:
                del self._attestations[k]
            # proposals keyed by slot; keep a matching horizon
            slot_cutoff = cutoff * self.config.slots_per_epoch
            for k in [k for k in self._proposals if k[0] < slot_cutoff]:
                del self._proposals[k]


class Slasher:
    """Chain-facing service: feed gossip attestations/blocks, collect
    slashings for the op pool (reference ``slasher/src/lib.rs`` +
    ``slasher_service``).

    ``store``: any ``KeyValueStore`` (lockbox-backed in production) makes the
    slasher durable (reference: ``SlasherDB`` over LMDB,
    ``slasher/src/database/interface.rs``).  The dense arrays are derived
    state, so persistence is an append-only log of unique indexed
    attestations (keyed ``target_epoch || att_root`` for range pruning) and
    proposal headers (``slot || proposer || block_root``), replayed through
    the detectors on startup — a restart loses nothing."""

    ATT_COLUMN = b"sia"
    PROPOSAL_COLUMN = b"sip"

    def __init__(self, types, config: Optional[SlasherConfig] = None, store=None):
        self.types = types
        self.db = SlasherDB(config)
        self.store = store
        self.attester_slashings: List[object] = []
        self.proposer_slashings: List[object] = []
        self.dropped_findings = 0  # findings whose evidence attestation aged out
        self._last_prune_epoch = 0
        if store is not None:
            self._load()

    # -------------------------------------------------------- persistence

    def _att_class(self, tag: str):
        return (
            self.types.IndexedAttestationElectra
            if tag == "electra"
            else self.types.IndexedAttestation
        )

    def _load(self) -> None:
        """Replay the durable attestation/proposal log through the detectors.
        Findings re-surface as queued slashings: anything detected before the
        restart but not yet drained into the op pool is recovered (slashings
        already included on chain get filtered by the pool's eligibility
        check — an already-slashed validator is not slashable again)."""
        for _key, value in self.store.iter_column(self.ATT_COLUMN):
            tag, data = value.split(b"\x00", 1)
            indexed = self._att_class(tag.decode()).from_ssz_bytes(data)
            self._queue_attester_findings(indexed, self.db.check_attestation(indexed))
        for key, value in self.store.iter_column(self.PROPOSAL_COLUMN):
            slot = int.from_bytes(key[:8], "big")
            proposer = int.from_bytes(key[8:16], "big")
            header = self.types.SignedBeaconBlockHeader.from_ssz_bytes(value)
            finding = self.db.check_proposal(slot, proposer, key[16:48], header)
            self._queue_proposal_finding(header, finding)

    def _persist_attestation(self, indexed) -> None:
        if self.store is None:
            return
        tag = b"electra" if "Electra" in type(indexed).__name__ else b"base"
        key = int(indexed.data.target.epoch).to_bytes(8, "big") + indexed.hash_tree_root()
        self.store.put(self.ATT_COLUMN, key, tag + b"\x00" + indexed.as_ssz_bytes())

    def _persist_proposal(self, slot: int, proposer: int, block_root: bytes,
                          header) -> None:
        if self.store is None:
            return
        key = (int(slot).to_bytes(8, "big") + int(proposer).to_bytes(8, "big")
               + bytes(block_root))
        self.store.put(self.PROPOSAL_COLUMN, key, header.as_ssz_bytes())

    def _prune_store(self, cutoff_epoch: int) -> None:
        if self.store is None:
            return
        cutoff_key = max(0, cutoff_epoch).to_bytes(8, "big")
        for key, _ in list(self.store.iter_column(self.ATT_COLUMN)):
            if key[:8] < cutoff_key:
                self.store.delete(self.ATT_COLUMN, key)
        slot_cutoff = max(0, cutoff_epoch * self.db.config.slots_per_epoch)
        slot_cutoff_key = slot_cutoff.to_bytes(8, "big")
        for key, _ in list(self.store.iter_column(self.PROPOSAL_COLUMN)):
            if key[:8] < slot_cutoff_key:
                self.store.delete(self.PROPOSAL_COLUMN, key)

    def _queue_attester_findings(self, indexed, findings) -> int:
        """Convert detector findings into queued attester slashings — the ONE
        conversion path (live ingestion and restart replay both use it)."""
        produced = 0
        for finding in findings:
            prev = finding.get("prev")
            if prev is None:
                self.dropped_findings += 1  # evidence aged out of the window
                continue
            cls = (
                self.types.AttesterSlashingElectra
                if "Electra" in type(indexed).__name__
                else self.types.AttesterSlashing
            )
            if finding.get("new_first"):
                a1, a2 = indexed, prev  # the new attestation surrounds
            else:
                a1, a2 = prev, indexed
            self.attester_slashings.append(cls(attestation_1=a1, attestation_2=a2))
            produced += 1
        return produced

    def _queue_proposal_finding(self, header, finding) -> int:
        if finding is None or finding.get("prev_header") is None:
            return 0
        self.proposer_slashings.append(self.types.ProposerSlashing(
            signed_header_1=finding["prev_header"],
            signed_header_2=header,
        ))
        return 1

    def on_attestation(self, indexed) -> int:
        """Process one indexed attestation; returns #slashings produced."""
        self._maybe_prune(int(indexed.data.target.epoch))
        self._persist_attestation(indexed)
        return self._queue_attester_findings(
            indexed, self.db.check_attestation(indexed)
        )

    PRUNE_INTERVAL_EPOCHS = 64

    def _maybe_prune(self, epoch: int) -> None:
        if epoch >= self._last_prune_epoch + self.PRUNE_INTERVAL_EPOCHS:
            self.db.prune(epoch)
            self._prune_store(epoch - self.db.config.history_length)
            self._last_prune_epoch = epoch

    def on_block(self, signed_block_or_header) -> int:
        msg = signed_block_or_header.message
        header = self._as_signed_header(signed_block_or_header)
        block_root = header.message.hash_tree_root()
        self._persist_proposal(int(msg.slot), int(msg.proposer_index),
                               block_root, header)
        finding = self.db.check_proposal(
            int(msg.slot), int(msg.proposer_index), block_root, header
        )
        return self._queue_proposal_finding(header, finding)

    def _as_signed_header(self, signed):
        msg = signed.message
        if hasattr(msg, "body_root"):
            return signed  # already a signed header
        return self.types.SignedBeaconBlockHeader(
            message=self.types.BeaconBlockHeader(
                slot=msg.slot,
                proposer_index=msg.proposer_index,
                parent_root=msg.parent_root,
                state_root=msg.state_root,
                body_root=msg.body.hash_tree_root(),
            ),
            signature=signed.signature,
        )

    def drain_slashings(self):
        """(attester_slashings, proposer_slashings), clearing the queues."""
        a, p = self.attester_slashings, self.proposer_slashings
        self.attester_slashings, self.proposer_slashings = [], []
        return a, p
