"""Hot/cold split database.

Equivalent of the reference's ``HotColdDB``
(`beacon_node/store/src/hot_cold_store.rs`): the **hot** store holds
unfinalized full states plus ``HotStateSummary`` records; the **cold**
"freezer" holds finalized history compactly — full "restore point" states
every ``slots_per_restore_point`` slots plus chunked per-slot block/state-root
vectors (`store/src/chunked_vector.rs`), with intermediate states rebuilt by
replaying blocks (`store/src/reconstruct.rs` via ``BlockReplayer``).

Blocks always live in the block column (the reference keeps blocks hot-side
too).  Background finalization migration (`beacon_chain/src/migrate.rs`) maps
to ``migrate()``: called with the new finalized checkpoint, it moves
pre-finalized states into the freezer and prunes abandoned forks.

A copy of the JAX package's ``lighthouse_tpu/store/hot_cold.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..logs import get_logger
from .kv import DBColumn, KeyValueStore, MemoryStore, StoreError

log = get_logger("store")

CHUNK_SIZE = 128  # roots per freezer chunk (reference chunked_vector default)
SCHEMA_VERSION = 1


def encode_stored_block(signed_block, *, blinded: bool) -> bytes:
    """The BEACON_BLOCK column's on-disk framing — ONE owner shared by the
    store and `db prune-payloads`: ``[blinded:]<fork>\\x00<ssz>``."""
    fork = type(signed_block).fork_name
    prefix = b"blinded:" if blinded else b""
    return prefix + fork.encode() + b"\x00" + signed_block.as_ssz_bytes()


def decode_stored_block(types, raw: bytes):
    """Inverse of ``encode_stored_block``; returns (signed_block_or_blinded,
    is_blinded, fork_name)."""
    fork, data = raw.split(b"\x00", 1)
    if fork.startswith(b"blinded:"):
        name = fork[len(b"blinded:"):].decode()
        return types.signed_blinded_block[name].from_ssz_bytes(data), True, name
    name = fork.decode()
    return types.signed_block[name].from_ssz_bytes(data), False, name


def prune_blob_column(kv: "KeyValueStore", types, horizon_slot: int) -> int:
    """Delete every stored sidecar set whose block slot is below the
    horizon; returns the number of blocks pruned.  Shared by the node's
    periodic pruning (HotColdDB.prune_blobs) and `db prune-blobs` — one
    owner of the on-disk framing (u32-be length || sidecar ssz, repeated)."""
    pruned = 0
    for key, raw in kv.iter_column(DBColumn.BLOB_SIDECAR):
        n = int.from_bytes(raw[:4], "big")
        sc = types.BlobSidecar.from_ssz_bytes(raw[4:4 + n])
        if int(sc.signed_block_header.message.slot) < horizon_slot:
            kv.delete(DBColumn.BLOB_SIDECAR, key)
            pruned += 1
    return pruned


def _slot_key(slot: int) -> bytes:
    return struct.pack(">Q", slot)


@dataclass
class HotStateSummary:
    """Hot-side per-state record (reference ``HotStateSummary``)."""

    slot: int
    latest_block_root: bytes
    epoch_boundary_state_root: bytes

    def to_bytes(self) -> bytes:
        return struct.pack(">Q", self.slot) + self.latest_block_root + self.epoch_boundary_state_root

    @classmethod
    def from_bytes(cls, data: bytes) -> "HotStateSummary":
        (slot,) = struct.unpack(">Q", data[:8])
        return cls(slot, data[8:40], data[40:72])


@dataclass
class AnchorInfo:
    """Checkpoint-sync anchor metadata (reference ``metadata.rs``)."""

    anchor_slot: int
    oldest_block_slot: int
    oldest_block_parent: bytes

    def to_bytes(self) -> bytes:
        return struct.pack(">QQ", self.anchor_slot, self.oldest_block_slot) + self.oldest_block_parent

    @classmethod
    def from_bytes(cls, data: bytes) -> "AnchorInfo":
        a, o = struct.unpack(">QQ", data[:16])
        return cls(a, o, data[16:48])


class HotColdDB:
    def __init__(
        self,
        *,
        hot: Optional[KeyValueStore] = None,
        cold: Optional[KeyValueStore] = None,
        types=None,
        spec=None,
        slots_per_restore_point: Optional[int] = None,
    ):
        self.hot = hot if hot is not None else MemoryStore()
        self.cold = cold if cold is not None else MemoryStore()
        self.types = types
        self.spec = spec
        if slots_per_restore_point is None:
            slots_per_restore_point = (
                spec.slots_per_epoch * 2 if spec is not None else 64
            )
        self.slots_per_restore_point = slots_per_restore_point
        self._write_schema_version()

    # ------------------------------------------------------------ metadata

    def _write_schema_version(self) -> None:
        existing = self.hot.get(DBColumn.BEACON_META, b"schema")
        if existing is None:
            self.hot.put(DBColumn.BEACON_META, b"schema", struct.pack(">Q", SCHEMA_VERSION))
        else:
            (version,) = struct.unpack(">Q", existing)
            if version != SCHEMA_VERSION:
                raise StoreError(
                    f"schema version {version} on disk, code expects {SCHEMA_VERSION} "
                    "(run the database manager's migrate command)"
                )

    def schema_version(self) -> int:
        (version,) = struct.unpack(">Q", self.hot.get(DBColumn.BEACON_META, b"schema"))
        return version

    def put_anchor_info(self, info: AnchorInfo) -> None:
        self.hot.put(DBColumn.BEACON_META, b"anchor", info.to_bytes())

    def get_anchor_info(self) -> Optional[AnchorInfo]:
        raw = self.hot.get(DBColumn.BEACON_META, b"anchor")
        return AnchorInfo.from_bytes(raw) if raw else None

    def put_split(self, slot: int, state_root: bytes) -> None:
        """The hot/cold boundary (reference ``Split``)."""
        self.hot.put(DBColumn.BEACON_META, b"split", struct.pack(">Q", slot) + state_root)

    def get_split_slot(self) -> int:
        raw = self.hot.get(DBColumn.BEACON_META, b"split")
        if raw is None:
            return 0
        (slot,) = struct.unpack(">Q", raw[:8])
        return slot

    # -------------------------------------------------------------- blocks

    def put_block(self, block_root: bytes, signed_block) -> None:
        self.hot.put(DBColumn.BEACON_BLOCK, block_root,
                     encode_stored_block(signed_block, blinded=False))

    def put_blinded_block(self, block_root: bytes, signed_blinded) -> None:
        """Persist a block WITHOUT its execution payload (how the reference
        stores every post-merge block; the beacon_block_streamer analog
        reconstructs the payload from the EL on read)."""
        self.hot.put(DBColumn.BEACON_BLOCK, block_root,
                     encode_stored_block(signed_blinded, blinded=True))

    def get_block(self, block_root: bytes):
        """The stored block — a signed full block, or a signed BLINDED block
        when it was persisted payload-free (callers that must serve full
        blocks go through ``BeaconChain.get_block``, which reconstructs)."""
        raw = self.hot.get(DBColumn.BEACON_BLOCK, block_root)
        if raw is None:
            return None
        block, _blinded, _fork = decode_stored_block(self.types, raw)
        return block

    def delete_block(self, block_root: bytes) -> None:
        self.hot.delete(DBColumn.BEACON_BLOCK, block_root)

    # --------------------------------------------------------------- blobs

    def put_blobs(self, block_root: bytes, sidecars) -> None:
        """Persist a block's full sidecar set (index-ascending)."""
        payload = b"".join(
            len(raw).to_bytes(4, "big") + raw
            for raw in (sc.as_ssz_bytes() for sc in sidecars)
        )
        self.hot.put(DBColumn.BLOB_SIDECAR, block_root, payload)

    def get_blobs(self, block_root: bytes) -> list:
        raw = self.hot.get(DBColumn.BLOB_SIDECAR, block_root)
        if raw is None:
            return []
        out = []
        pos = 0
        while pos < len(raw):
            n = int.from_bytes(raw[pos:pos + 4], "big")
            pos += 4
            out.append(self.types.BlobSidecar.from_ssz_bytes(raw[pos:pos + n]))
            pos += n
        return out

    def delete_blobs(self, block_root: bytes) -> None:
        self.hot.delete(DBColumn.BLOB_SIDECAR, block_root)

    def prune_blobs(self, horizon_slot: int) -> int:
        """Drop stored sidecars older than the retention horizon; returns
        the number of blocks pruned (spec MIN_EPOCHS_FOR_BLOB_SIDECARS...)."""
        return prune_blob_column(self.hot, self.types, horizon_slot)

    # ---------------------------------------------------------- hot states

    def put_state(self, state_root: bytes, state, latest_block_root: bytes) -> None:
        """Store a full hot state + its summary."""
        epoch_boundary_slot = (
            int(state.slot) // self.spec.slots_per_epoch * self.spec.slots_per_epoch
        )
        if int(state.slot) == epoch_boundary_slot:
            boundary_root = state_root
        else:
            boundary_root = bytes(
                state.state_roots[epoch_boundary_slot % self.spec.preset.slots_per_historical_root]
            )
        summary = HotStateSummary(int(state.slot), latest_block_root, boundary_root)
        fork = type(state).fork_name
        self.hot.do_atomically(
            [
                ("put", DBColumn.BEACON_STATE, state_root, fork.encode() + b"\x00" + state.as_ssz_bytes()),
                ("put", DBColumn.BEACON_STATE_SUMMARY, state_root, summary.to_bytes()),
            ]
        )

    def get_hot_state(self, state_root: bytes):
        raw = self.hot.get(DBColumn.BEACON_STATE, state_root)
        if raw is None:
            return None
        fork, data = raw.split(b"\x00", 1)
        return self.types.state[fork.decode()].from_ssz_bytes(data)

    def get_state_summary(self, state_root: bytes) -> Optional[HotStateSummary]:
        raw = self.hot.get(DBColumn.BEACON_STATE_SUMMARY, state_root)
        return HotStateSummary.from_bytes(raw) if raw else None

    def delete_state(self, state_root: bytes) -> None:
        self.hot.do_atomically(
            [
                ("del", DBColumn.BEACON_STATE, state_root, None),
                ("del", DBColumn.BEACON_STATE_SUMMARY, state_root, None),
            ]
        )

    # ------------------------------------------------------ freezer chunks

    def _put_chunked_root(self, column: bytes, slot: int, root: bytes) -> None:
        chunk_idx = slot // CHUNK_SIZE
        key = _slot_key(chunk_idx)
        chunk = bytearray(self.cold.get(column, key) or b"\x00" * (32 * CHUNK_SIZE))
        off = (slot % CHUNK_SIZE) * 32
        chunk[off : off + 32] = root
        self.cold.put(column, key, bytes(chunk))

    def _put_chunked_roots(self, column: bytes, roots: Dict[int, bytes]) -> None:
        """Batched chunk update: one read+write per touched 128-slot chunk
        instead of one per slot (append-only backends amplify rewrites)."""
        by_chunk: Dict[int, Dict[int, bytes]] = {}
        for slot, root in roots.items():
            by_chunk.setdefault(slot // CHUNK_SIZE, {})[slot] = root
        for chunk_idx, items in by_chunk.items():
            key = _slot_key(chunk_idx)
            chunk = bytearray(self.cold.get(column, key) or b"\x00" * (32 * CHUNK_SIZE))
            for slot, root in items.items():
                off = (slot % CHUNK_SIZE) * 32
                chunk[off : off + 32] = root
            self.cold.put(column, key, bytes(chunk))

    def _get_chunked_root(self, column: bytes, slot: int) -> Optional[bytes]:
        chunk = self.cold.get(column, _slot_key(slot // CHUNK_SIZE))
        if chunk is None:
            return None
        off = (slot % CHUNK_SIZE) * 32
        root = chunk[off : off + 32]
        return root if root != b"\x00" * 32 else None

    def cold_block_root_at_slot(self, slot: int) -> Optional[bytes]:
        return self._get_chunked_root(DBColumn.BEACON_BLOCK_ROOTS, slot)

    def cold_state_root_at_slot(self, slot: int) -> Optional[bytes]:
        return self._get_chunked_root(DBColumn.BEACON_STATE_ROOTS, slot)

    # ----------------------------------------------------- freezer states

    def _put_restore_point(self, slot: int, state) -> None:
        fork = type(state).fork_name
        self.cold.put(
            DBColumn.BEACON_RESTORE_POINT,
            _slot_key(slot),
            fork.encode() + b"\x00" + state.as_ssz_bytes(),
        )

    def _get_restore_point(self, slot: int):
        raw = self.cold.get(DBColumn.BEACON_RESTORE_POINT, _slot_key(slot))
        if raw is None:
            return None
        fork, data = raw.split(b"\x00", 1)
        return self.types.state[fork.decode()].from_ssz_bytes(data)

    def load_cold_state_by_slot(self, slot: int):
        """Nearest restore point at/below ``slot`` + block replay up to
        ``slot`` (reference ``load_cold_state`` → ``reconstruct.rs``)."""
        rp_slot = slot // self.slots_per_restore_point * self.slots_per_restore_point
        state = self._get_restore_point(rp_slot)
        if state is None:
            return None
        if int(state.slot) == slot:
            return state
        return self._replay_to(state, slot)

    def _replay_to(self, state, target_slot: int):
        """Replay canonical blocks onto ``state`` (reference
        ``block_replayer.rs``; signature verification skipped — these blocks
        were verified at import)."""
        from ..consensus.per_block import BlockSignatureStrategy
        from ..consensus.per_slot import process_slots
        from ..consensus.state_transition import state_transition

        state = state.copy()
        prev_root = None
        for slot in range(int(state.slot) + 1, target_slot + 1):
            block_root = self.cold_block_root_at_slot(slot)
            if block_root is None or block_root == prev_root:
                continue  # skipped slot (root repeats in the chunked vector)
            prev_root = block_root
            block = self.get_block(block_root)
            if block is None or int(block.message.slot) != slot:
                continue
            state = state_transition(
                state,
                block,
                self.types,
                self.spec,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
                validate_result=False,
            )
        if int(state.slot) < target_slot:
            state = process_slots(state, target_slot, self.types, self.spec)
        return state

    # ----------------------------------------------------------- migration

    def migrate(
        self,
        *,
        finalized_slot: int,
        finalized_state,
        canonical_root_at_slot: Callable[[int], Optional[bytes]],
        state_for_root: Callable[[bytes], Optional[object]],
        abandoned_state_roots: Iterator[bytes] = (),
    ) -> int:
        """Move finalized history below ``finalized_slot`` into the freezer
        (reference ``migrate.rs`` + ``hot_cold_store.rs::migrate_database``).

        Per-slot block/state roots come from ``finalized_state``'s own
        ``block_roots``/``state_roots`` history vectors — the authoritative
        per-slot values, correct across skip slots (a skip slot's state root
        is the slot-advanced root, not the previous block's post-state root),
        and free of any re-hashing.  ``canonical_root_at_slot`` is the
        fallback beyond the vectors' ``slots_per_historical_root`` window.
        ``state_for_root(block_root) -> post-state`` supplies restore-point
        states; at a skip-slot restore point the nearest canonical state is
        advanced with empty slots.  Returns the number of slots frozen."""
        split = self.get_split_slot()
        if finalized_slot <= split:
            return 0
        sphr = self.spec.preset.slots_per_historical_root
        fstate_slot = int(finalized_state.slot)

        def root_from_vector(vector, slot: int) -> Optional[bytes]:
            if slot < fstate_slot <= slot + sphr:
                return bytes(vector[slot % sphr])
            return None

        block_roots: Dict[int, bytes] = {}
        state_roots: Dict[int, bytes] = {}
        for slot in range(split, finalized_slot):
            br = root_from_vector(finalized_state.block_roots, slot)
            if br is None:
                br = canonical_root_at_slot(slot)
            if br is None:
                continue
            block_roots[slot] = br
            sr = root_from_vector(finalized_state.state_roots, slot)
            if sr is not None:
                state_roots[slot] = sr
        self._put_chunked_roots(DBColumn.BEACON_BLOCK_ROOTS, block_roots)
        self._put_chunked_roots(DBColumn.BEACON_STATE_ROOTS, state_roots)

        # Restore points (skip slots get a slot-advanced state).
        rp = self.slots_per_restore_point
        first_rp = (split + rp - 1) // rp * rp
        for slot in range(first_rp, finalized_slot, rp):
            block_root = block_roots.get(slot) or canonical_root_at_slot(slot)
            if block_root is None:
                continue
            state = state_for_root(block_root)
            if state is None:
                continue
            if int(state.slot) != slot:
                from ..consensus.per_slot import process_slots

                state = process_slots(state.copy(), slot, self.types, self.spec)
            self._put_restore_point(slot, state)

        # Full hot states below the split are no longer needed: delete by the
        # block's claimed state root (already verified at import — no hash).
        seen = set()
        for slot, block_root in block_roots.items():
            if block_root in seen:
                continue
            seen.add(block_root)
            block = self.get_block(block_root)
            if block is not None and int(block.message.slot) < finalized_slot:
                self.delete_state(bytes(block.message.state_root))
        for state_root in abandoned_state_roots:
            self.delete_state(state_root)
        final_root = canonical_root_at_slot(finalized_slot)
        self.put_split(finalized_slot, final_root or b"\x00" * 32)
        log.info("freezer migration", split_slot=finalized_slot,
                 frozen_roots=len(block_roots))
        return len(block_roots)
