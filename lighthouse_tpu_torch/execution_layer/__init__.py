"""The execution layer: engine-API client + state machine + the chain-facing
facade.

Equivalent of the reference's ``beacon_node/execution_layer`` crate: JWT
HS256 auth (``engine_api/auth.rs``), the JSON-RPC engine client
(``engine_api/http.rs``), the offline→online engine state machine
(``engines.rs``), and the ``ExecutionLayer`` facade the beacon chain drives
(``lib.rs`` — notify_new_payload / notify_forkchoice_updated /
get_payload).

``ExecutionLayer`` is a drop-in for the harness's ``MockExecutionEngine``
slot on ``BeaconChain``: it implements the same two chain-facing methods
(``produce_payload``, ``notify_new_payload``) but speaks real engine-API
JSON-RPC over a socket, so a node can swap between the in-proc mock and a
real EL by construction argument alone.

A copy of the JAX package's
``lighthouse_tpu/execution_layer/__init__.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..consensus import helpers as h
from ..consensus.per_block import compute_timestamp_at_slot, is_merge_transition_complete
from .auth import JwtError, generate_token, strip_prefix, validate_token
from .engine_api import (
    STATUS_ACCEPTED,
    STATUS_INVALID,
    STATUS_SYNCING,
    STATUS_VALID,
    EngineApiClient,
    EngineApiError,
    EngineOffline,
    payload_from_json,
    payload_to_json,
)
from .engines import STATE_OFFLINE, STATE_ONLINE, Engine

__all__ = [
    "Engine",
    "EngineApiClient",
    "EngineApiError",
    "EngineOffline",
    "ExecutionLayer",
    "JwtError",
    "generate_token",
    "payload_from_json",
    "payload_to_json",
    "strip_prefix",
    "validate_token",
]


class ExecutionLayer:
    """Chain-facing facade over one engine (the reference supports one EL
    post-Capella too, ``engines.rs:1-12``)."""

    def __init__(self, *, url: str, jwt_secret: bytes,
                 fee_recipient: bytes = b"\x00" * 20, timeout: float = 8.0):
        self.engine = Engine(EngineApiClient(url, jwt_secret, timeout=timeout))
        self.fee_recipient = fee_recipient
        # Optimistic bookkeeping: payload hashes the EL reported SYNCING for.
        # The chain reads this after notify_new_payload to mark the block
        # ExecutionStatus.OPTIMISTIC in fork choice (not VALID).
        self.optimistic_hashes: set = set()
        # Last finalized payload hash the chain told us about — reused as the
        # finalized/safe hash in production fcU calls so we never tell the EL
        # an unfinalized block is final.
        self.latest_finalized_hash: bytes = b"\x00" * 32
        self._last_get_payload_response: Dict = {}
        # set by the chain: called with (fork, state, attributes) whenever
        # production sends forkchoiceUpdated WITH payload attributes
        self.on_payload_attributes = None

    # -------------------------------------------------- chain integration

    def notify_new_payload(self, payload, *, versioned_hashes=None,
                           parent_beacon_block_root=None,
                           execution_requests=None, fork=None) -> bool:
        """True=VALID, False=INVALID; SYNCING/ACCEPTED are treated
        optimistically (recorded, allowed through) — the reference's
        optimistic-sync behavior (``PayloadVerificationStatus::Optimistic``).
        ``execution_requests``: the block body's ExecutionRequests container
        (electra — encoded for engine_newPayloadV4); ``fork`` overrides the
        structural guess (deneb/electra payloads are identical)."""
        from .engine_api import execution_requests_to_json

        fork = fork or _payload_fork(payload)
        encoded_requests = (
            execution_requests_to_json(execution_requests)
            if execution_requests is not None
            else None
        )
        status = self.engine.request(
            lambda api: api.new_payload(
                payload, fork,
                versioned_hashes=versioned_hashes,
                parent_beacon_block_root=parent_beacon_block_root,
                execution_requests=encoded_requests,
            )
        )
        s = status.get("status")
        if s == STATUS_VALID:
            self.optimistic_hashes.discard(bytes(payload.block_hash))
            return True
        if s in (STATUS_SYNCING, STATUS_ACCEPTED):
            self.optimistic_hashes.add(bytes(payload.block_hash))
            return True
        return False

    def notify_forkchoice_updated(self, *, head_block_hash: bytes,
                                  finalized_block_hash: bytes,
                                  fork: str,
                                  payload_attributes: Optional[Dict] = None) -> Dict:
        self.latest_finalized_hash = bytes(finalized_block_hash)
        return self.engine.request(
            lambda api: api.forkchoice_updated(
                head_block_hash=head_block_hash,
                safe_block_hash=finalized_block_hash,
                finalized_block_hash=finalized_block_hash,
                fork=fork,
                payload_attributes=payload_attributes,
            )
        )

    def get_payload_bodies_by_hash(self, hashes) -> list:
        """Batched payload-body fetch for blinded-block reconstruction
        (beacon_block_streamer analog — chain/block_streamer.py)."""
        return self.engine.request(
            lambda api: api.get_payload_bodies_by_hash(hashes)
        )

    def get_payload_bodies_by_range(self, start: int, count: int) -> list:
        return self.engine.request(
            lambda api: api.get_payload_bodies_by_range(start, count)
        )

    def get_client_version(self) -> Optional[Dict]:
        """The EL's identity (graffiti_calculator + fork-readiness logs)."""
        return self.engine.request(lambda api: api.get_client_version())

    def produce_payload(self, state, types, spec,
                        suggested_fee_recipient=None):
        """The real getPayload flow: forkchoiceUpdated(head, attributes) →
        payloadId → getPayload (``lib.rs`` get_payload; the mock engine slot
        implements the same method signature in-proc).
        ``suggested_fee_recipient``: the prepared per-proposer recipient
        (prepare_beacon_proposer) — it must ride the payload ATTRIBUTES (the
        EL's block hash commits to it; rewriting after the fact would brick
        the payload)."""
        fork = type(state).fork_name
        parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        if not is_merge_transition_complete(state):
            parent_hash = b"\x00" * 32
        recipient = suggested_fee_recipient or self.fee_recipient
        attributes = {
            "timestamp": hex(compute_timestamp_at_slot(state, state.slot, spec)),
            "prevRandao": "0x" + h.get_randao_mix(
                state, h.get_current_epoch(state, spec), spec
            ).hex(),
            "suggestedFeeRecipient": "0x" + bytes(recipient).hex(),
        }
        if fork in ("capella", "deneb", "electra"):
            from .engine_api import withdrawal_to_json

            attributes["withdrawals"] = [
                withdrawal_to_json(w)
                for w in h.get_expected_withdrawals(state, types, spec)
            ]
        if fork in ("deneb", "electra"):
            # EIP-4788: the PARENT beacon block's root = hash_tree_root of
            # the state's latest header (state_root already backfilled by
            # process_slots), NOT header.parent_root (the grandparent).
            attributes["parentBeaconBlockRoot"] = (
                "0x" + state.latest_block_header.hash_tree_root().hex()
            )
        if self.on_payload_attributes is not None:
            # SSE payload_attributes (reference events.rs): external
            # builders watch exactly what rides forkchoiceUpdated
            try:
                self.on_payload_attributes(fork, state, attributes)
            except Exception:
                pass  # an SSE consumer must never break production
        result = self.notify_forkchoice_updated(
            head_block_hash=parent_hash,
            # Never report an unfinalized block as final to the EL — use the
            # last finalized hash the chain gave us (zeros before finality).
            finalized_block_hash=self.latest_finalized_hash,
            fork=fork,
            payload_attributes=attributes,
        )
        payload_id = result.get("payloadId")
        if payload_id is None:
            raise EngineApiError("engine returned no payloadId")
        got = self.engine.request(lambda api: api.get_payload(payload_id, fork))
        obj = got.get("executionPayload", got)
        self._last_get_payload_response = got
        return payload_from_json(obj, types, fork)

    def produce_payload_and_requests(self, state, types, spec,
                                     suggested_fee_recipient=None):
        """(payload, ExecutionRequests) for electra block production — the
        requests come from engine_getPayloadV4's executionRequests field."""
        from .engine_api import execution_requests_from_json

        payload = self.produce_payload(
            state, types, spec, suggested_fee_recipient=suggested_fee_recipient
        )
        requests = execution_requests_from_json(
            self._last_get_payload_response.get("executionRequests"), types
        )
        return payload, requests

    # ------------------------------------------------------------- status

    def is_online(self) -> bool:
        return self.engine.state == STATE_ONLINE or self.engine.upcheck()


def _payload_fork(payload) -> str:
    if hasattr(payload, "blob_gas_used"):
        return "deneb"
    if hasattr(payload, "withdrawals"):
        return "capella"
    return "bellatrix"
