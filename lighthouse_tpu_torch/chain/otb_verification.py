"""Optimistic transition block (OTB) verification.

Equivalent of the reference's
``beacon_node/beacon_chain/src/otb_verification_service.rs``: a node that
imports the MERGE TRANSITION block optimistically (its EL was offline or
syncing) has accepted, unverified, the single block whose PoW parent must
meet the terminal total difficulty.  The root+slot is persisted; once the
EL can answer, the stored block's payload parent is checked against TTD —
valid removes the record, invalid invalidates the block in fork choice
(``INVALID_BLOCK_HASH``-equivalent).  Pre- and post-transition optimistic
blocks don't need this: their validity flows from forkchoiceUpdated.

A copy of the JAX package's ``lighthouse_tpu/chain/otb_verification.py``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ..logs import get_logger
from ..store.kv import DBColumn

log = get_logger("chain.otb")

_OTB_PREFIX = b"otb:"


class OtbStore:
    """Persisted registry of optimistically-imported transition blocks."""

    def __init__(self, db) -> None:
        self.db = db

    def register(self, block_root: bytes, slot: int) -> None:
        self.db.hot.put(
            DBColumn.BEACON_META, _OTB_PREFIX + bytes(block_root),
            struct.pack(">Q", int(slot)),
        )
        log.info("optimistic transition block registered",
                 root="0x" + bytes(block_root).hex()[:16], slot=int(slot))

    def remove(self, block_root: bytes) -> None:
        self.db.hot.delete(DBColumn.BEACON_META, _OTB_PREFIX + bytes(block_root))

    def all(self) -> List[Tuple[bytes, int]]:
        out = []
        for key, raw in self.db.hot.iter_column(DBColumn.BEACON_META):
            if key.startswith(_OTB_PREFIX):
                out.append((key[len(_OTB_PREFIX):], struct.unpack(">Q", raw)[0]))
        return out


def validate_merge_transition_block(chain, signed_block) -> Optional[bool]:
    """True = the transition is valid (PoW parent meets TTD), False =
    provably invalid, None = the EL cannot answer yet.  Accepts a full OR
    blinded block — the check needs only the payload's parent_hash, which
    the blinded header carries."""
    body = signed_block.message.body
    payload = getattr(body, "execution_payload",
                      getattr(body, "execution_payload_header", None))
    engine = chain.execution_engine
    if engine is None or not hasattr(engine, "get_pow_block"):
        return None
    try:
        pow_block = engine.get_pow_block(bytes(payload.parent_hash))
    except Exception:
        return None
    if pow_block is None:
        # Not-found is UNDECIDABLE, not invalid (reference
        # TerminalPoWBlockNotFound retries — the EL may still be syncing
        # or has pruned pre-merge history); only a found-and-failing
        # parent proves the transition invalid.
        return None
    ttd = chain.spec.terminal_total_difficulty
    try:
        total_td = int(pow_block["total_difficulty"])
        parent_td = int(pow_block["parent_total_difficulty"])
    except (KeyError, TypeError, ValueError):
        return None  # partial EL response: decide nothing on missing data
    return total_td >= ttd and parent_td < ttd


def verify_otbs(chain) -> int:
    """One verification sweep (the reference's background service loop body):
    resolves every stored OTB the EL can now answer for.  Returns the
    number of records resolved."""
    store: OtbStore = chain.otb_store
    resolved = 0
    for root, slot in store.all():
        # The BLINDED form suffices (parent_hash lives in the header) and
        # never round-trips the EL — get_block's payload reconstruction
        # would raise in exactly the EL-down state where OTBs exist.
        block = chain.get_blinded_block(root)
        if block is None:
            store.remove(root)  # pruned away: nothing left to verify
            resolved += 1
            continue
        verdict = validate_merge_transition_block(chain, block)
        if verdict is None:
            continue  # EL still can't answer; retry next sweep
        if verdict:
            log.info("optimistic transition block verified",
                     root="0x" + root.hex()[:16])
        else:
            log.warning("INVALID optimistic transition block",
                        root="0x" + root.hex()[:16], slot=slot)
            try:
                chain.fork_choice.on_invalid_execution_payload(
                    root, latest_valid_hash=None
                )
                chain.recompute_head()
            except Exception as e:
                log.error("failed to invalidate transition block",
                          root="0x" + root.hex()[:16], error=str(e)[:80])
                continue
        store.remove(root)
        resolved += 1
    return resolved
