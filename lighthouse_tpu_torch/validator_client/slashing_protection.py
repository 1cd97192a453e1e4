"""EIP-3076 slashing-protection database.

Equivalent of the reference's ``validator_client/slashing_protection``
(``slashing_database.rs`` — SQLite; here the same interlock semantics over
our own ``lockbox`` KV engine, or in-memory for tests):

- a signed **block** is safe iff its slot is strictly greater than any
  previously signed block's slot for that pubkey (same-slot re-broadcast of
  the identical signing_root is allowed);
- a signed **attestation** is safe iff it is not a double vote (same target,
  different signing_root), does not surround and is not surrounded by any
  previously signed attestation, and its source/target do not move backwards
  from the recorded maxima.

Safety checks and the insert are atomic under one lock — the DB is the last
line of defense, exactly like the reference (interchange spec
https://eips.ethereum.org/EIPS/eip-3076, format version 5).

A copy of the JAX package's ``lighthouse_tpu/validator_client/slashing_protection.py``.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

INTERCHANGE_VERSION = "5"


class SlashingProtectionError(Exception):
    """Refusing to sign: doing so could be slashable."""


class _ValidatorRecord:
    __slots__ = ("blocks", "attestations")

    def __init__(self):
        # slot -> signing_root (may be None for imported min entries)
        self.blocks: Dict[int, Optional[bytes]] = {}
        # (source, target) -> signing_root
        self.attestations: Dict[Tuple[int, int], Optional[bytes]] = {}


class SlashingProtectionDB:
    """``store=None`` keeps everything in memory; otherwise a ``LockboxStore``
    (or any object with put/get/iter_column) persists each record."""

    BLK = b"spb"
    ATT = b"spa"

    def __init__(self, store=None):
        self._store = store
        self._lock = threading.Lock()
        self._records: Dict[bytes, _ValidatorRecord] = {}
        if store is not None:
            self._load()

    # ------------------------------------------------------------- loading

    def _load(self) -> None:
        for key, value in self._store.iter_column(self.BLK):
            pubkey, slot = key[:-8], int.from_bytes(key[-8:], "big")
            root = value if value else None
            self._rec(pubkey).blocks[slot] = root
        for key, value in self._store.iter_column(self.ATT):
            pubkey = key[:-16]
            source = int.from_bytes(key[-16:-8], "big")
            target = int.from_bytes(key[-8:], "big")
            root = value if value else None
            self._rec(pubkey).attestations[(source, target)] = root

    def _rec(self, pubkey: bytes) -> _ValidatorRecord:
        rec = self._records.get(pubkey)
        if rec is None:
            rec = self._records[pubkey] = _ValidatorRecord()
        return rec

    def _persist_block(self, pubkey: bytes, slot: int, root: Optional[bytes]) -> None:
        if self._store is not None:
            self._store.put(self.BLK, pubkey + slot.to_bytes(8, "big"), root or b"")

    def _persist_att(self, pubkey: bytes, source: int, target: int,
                     root: Optional[bytes]) -> None:
        if self._store is not None:
            key = pubkey + source.to_bytes(8, "big") + target.to_bytes(8, "big")
            self._store.put(self.ATT, key, root or b"")

    # ------------------------------------------------------------ blocks

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> None:
        """Raise ``SlashingProtectionError`` unless signing is safe; record it."""
        with self._lock:
            rec = self._rec(pubkey)
            if rec.blocks:
                max_slot = max(rec.blocks)
                existing = rec.blocks.get(slot)
                if slot == max_slot and existing is not None and existing == signing_root:
                    return  # identical re-sign is safe (idempotent broadcast)
                if slot <= max_slot:
                    raise SlashingProtectionError(
                        f"block at slot {slot} <= max signed slot {max_slot}"
                    )
            rec.blocks[slot] = signing_root
            self._persist_block(pubkey, slot, signing_root)

    # -------------------------------------------------------- attestations

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        if source_epoch > target_epoch:
            raise SlashingProtectionError("attestation source > target")
        with self._lock:
            rec = self._rec(pubkey)
            existing = rec.attestations.get((source_epoch, target_epoch))
            if existing is not None and existing == signing_root:
                return  # identical re-sign
            for (s, t), root in rec.attestations.items():
                if t == target_epoch and root != signing_root:
                    raise SlashingProtectionError(
                        f"double vote at target {target_epoch}"
                    )
                if source_epoch < s and target_epoch > t:
                    raise SlashingProtectionError(
                        f"({source_epoch},{target_epoch}) surrounds ({s},{t})"
                    )
                if source_epoch > s and target_epoch < t:
                    raise SlashingProtectionError(
                        f"({source_epoch},{target_epoch}) surrounded by ({s},{t})"
                    )
            # EIP-3076 minimal conditions: never move source/target backwards.
            if rec.attestations:
                max_source = max(s for s, _ in rec.attestations)
                max_target = max(t for _, t in rec.attestations)
                if source_epoch < max_source:
                    raise SlashingProtectionError(
                        f"source {source_epoch} < max signed source {max_source}"
                    )
                if target_epoch <= max_target:
                    raise SlashingProtectionError(
                        f"target {target_epoch} <= max signed target {max_target}"
                    )
            rec.attestations[(source_epoch, target_epoch)] = signing_root
            self._persist_att(pubkey, source_epoch, target_epoch, signing_root)

    # -------------------------------------------------------- interchange

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        """EIP-3076 interchange JSON (complete format)."""
        with self._lock:
            data = []
            for pubkey, rec in sorted(self._records.items()):
                data.append({
                    "pubkey": "0x" + pubkey.hex(),
                    "signed_blocks": [
                        {
                            "slot": str(slot),
                            **(
                                {"signing_root": "0x" + root.hex()}
                                if root is not None
                                else {}
                            ),
                        }
                        for slot, root in sorted(rec.blocks.items())
                    ],
                    "signed_attestations": [
                        {
                            "source_epoch": str(s),
                            "target_epoch": str(t),
                            **(
                                {"signing_root": "0x" + root.hex()}
                                if root is not None
                                else {}
                            ),
                        }
                        for (s, t), root in sorted(rec.attestations.items())
                    ],
                })
        return {
            "metadata": {
                "interchange_format_version": INTERCHANGE_VERSION,
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, obj: dict, genesis_validators_root: bytes) -> int:
        """Merge an interchange document; returns #validators imported.
        Records are unioned (the reference's ``minify``-free import): existing
        protections are never weakened."""
        meta = obj.get("metadata", {})
        gvr = meta.get("genesis_validators_root", "")
        if gvr and gvr.lower() != "0x" + genesis_validators_root.hex():
            raise SlashingProtectionError(
                f"interchange for different chain (gvr {gvr})"
            )
        count = 0
        with self._lock:
            for entry in obj.get("data", []):
                pubkey = bytes.fromhex(entry["pubkey"][2:])
                rec = self._rec(pubkey)
                for blk in entry.get("signed_blocks", []):
                    slot = int(blk["slot"])
                    root = (
                        bytes.fromhex(blk["signing_root"][2:])
                        if "signing_root" in blk
                        else None
                    )
                    if slot not in rec.blocks or rec.blocks[slot] is None:
                        rec.blocks[slot] = root
                        self._persist_block(pubkey, slot, root)
                for att in entry.get("signed_attestations", []):
                    s, t = int(att["source_epoch"]), int(att["target_epoch"])
                    root = (
                        bytes.fromhex(att["signing_root"][2:])
                        if "signing_root" in att
                        else None
                    )
                    if (s, t) not in rec.attestations or rec.attestations[(s, t)] is None:
                        rec.attestations[(s, t)] = root
                        self._persist_att(pubkey, s, t, root)
                count += 1
        return count

    def export_json(self, genesis_validators_root: bytes) -> str:
        return json.dumps(self.export_interchange(genesis_validators_root), indent=2)

    def import_json(self, text: str, genesis_validators_root: bytes) -> int:
        return self.import_interchange(json.loads(text), genesis_validators_root)
