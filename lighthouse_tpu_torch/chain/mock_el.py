"""Mock execution engine.

Equivalent of the reference's ``MockServer``/``MockExecutionLayer``
(`beacon_node/execution_layer/src/test_utils/`) — the fake EL that every
harness/simulator test runs against.  Builds payloads that satisfy
``process_execution_payload``'s checks (parent hash chain, prev_randao,
timestamp) and answers ``notify_new_payload`` with a configurable verdict so
tests can inject INVALID payloads (the reference's ``payload_invalidation.rs``
fault-injection pattern).

A copy of the JAX package's ``lighthouse_tpu/chain/mock_el.py``.
"""

from __future__ import annotations

from hashlib import sha256
from typing import Optional, Set

from ..consensus import helpers as h
from ..consensus.per_block import compute_timestamp_at_slot, is_merge_transition_complete
from ..types.spec import ChainSpec


class MockExecutionEngine:
    on_payload_attributes = None  # SSE hook, set by the chain

    def __init__(self) -> None:
        self.invalid_hashes: Set[bytes] = set()
        self.offline = False
        self.payloads_seen = 0
        # block_hash -> payload body, for engine_getPayloadBodiesByHash/Range
        # (reference MockServer keeps every payload it has seen).
        self._bodies: dict = {}
        # PoW chain stub for transition-block TTD checks (tests seed this).
        self.pow_blocks: dict = {}

    def _record_body(self, payload) -> None:
        self._bodies[bytes(payload.block_hash)] = {
            "block_number": int(payload.block_number),
            "transactions": [bytes(t) for t in payload.transactions],
            "withdrawals": [w.copy() for w in getattr(payload, "withdrawals", [])],
        }

    # ------------------------------------------------------------- produce

    def produce_payload(self, state, types, spec: ChainSpec,
                        suggested_fee_recipient=None):
        """Build the payload for a block on ``state`` (already advanced to the
        block's slot).  The analog of engine_getPayload against the mock EL."""
        fork = type(state).fork_name
        cls = {
            "bellatrix": types.ExecutionPayloadBellatrix,
            "capella": types.ExecutionPayloadCapella,
            "deneb": types.ExecutionPayloadDeneb,
            "electra": types.ExecutionPayloadDeneb,  # structurally identical
        }[fork]
        parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        if not is_merge_transition_complete(state):
            parent_hash = b"\x00" * 32
        timestamp = compute_timestamp_at_slot(state, state.slot, spec)
        prev_randao = h.get_randao_mix(state, h.get_current_epoch(state, spec), spec)
        if self.on_payload_attributes is not None:
            # mirror the real EL's SSE hook (same attribute shape) so
            # harness runs emit structurally identical events
            try:
                self.on_payload_attributes(fork, state, {
                    "timestamp": hex(timestamp),
                    "prevRandao": "0x" + bytes(prev_randao).hex(),
                    "suggestedFeeRecipient": "0x" + bytes(
                        suggested_fee_recipient or b"\x00" * 20).hex(),
                })
            except Exception:
                pass
        block_hash = sha256(
            b"mock-el" + parent_hash + int(state.slot).to_bytes(8, "little")
        ).digest()
        kwargs = dict(
            parent_hash=parent_hash,
            fee_recipient=bytes(suggested_fee_recipient or b"\x00" * 20),
            state_root=b"\x00" * 32,
            receipts_root=b"\x00" * 32,
            logs_bloom=b"\x00" * 256,
            prev_randao=prev_randao,
            block_number=int(state.slot),
            gas_limit=30_000_000,
            gas_used=0,
            timestamp=timestamp,
            extra_data=b"",
            base_fee_per_gas=7,
            block_hash=block_hash,
            transactions=[],
        )
        if fork in ("capella", "deneb", "electra"):
            kwargs["withdrawals"] = h.get_expected_withdrawals(state, types, spec)
        if fork in ("deneb", "electra"):
            kwargs["blob_gas_used"] = 0
            kwargs["excess_blob_gas"] = 0
        payload = cls(**kwargs)
        self._record_body(payload)
        return payload

    # -------------------------------------------------------------- verify

    def notify_new_payload(self, payload) -> bool:
        """engine_newPayload: VALID unless the hash was marked invalid."""
        if self.offline:
            raise ConnectionError("mock execution engine offline")
        self.payloads_seen += 1
        self._record_body(payload)
        return bytes(payload.block_hash) not in self.invalid_hashes

    def get_pow_block(self, block_hash: bytes):
        """PoW-chain lookup for transition-block TTD validation
        (otb_verification; reference MockServer's PoW block store).
        Returns {"total_difficulty", "parent_total_difficulty"} or None."""
        if self.offline:
            raise ConnectionError("mock execution engine offline")
        return self.pow_blocks.get(bytes(block_hash))

    def get_client_version(self) -> dict:
        """engine_getClientVersionV1 (graffiti_calculator's EL identity)."""
        if self.offline:
            raise ConnectionError("mock execution engine offline")
        return {"code": "MK", "name": "mock-el", "version": "0.1.0",
                "commit": "deadbeef"}

    # ------------------------------------------------------- payload bodies

    def get_payload_bodies_by_hash(self, hashes):
        """engine_getPayloadBodiesByHashV1 (body dict or None per hash)."""
        if self.offline:
            raise ConnectionError("mock execution engine offline")
        return [self._bodies.get(bytes(h)) for h in hashes]

    def get_payload_bodies_by_range(self, start: int, count: int):
        """engine_getPayloadBodiesByRangeV1 by block_number."""
        if self.offline:
            raise ConnectionError("mock execution engine offline")
        by_number = {b["block_number"]: b for b in self._bodies.values()}
        return [by_number.get(n) for n in range(start, start + count)]
