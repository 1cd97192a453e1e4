"""Work taxonomy for the priority scheduler.

Mirrors the reference's ``Work`` enum — 36 priority classes drained in a
hard-coded order (``beacon_node/beacon_processor/src/lib.rs:549-615`` and the
drain order at ``:932-1110``).  The order encodes consensus-criticality:
chain-extending data (blocks, blobs) first, then priority-0 API requests,
aggregates, unaggregated attestations, sync work, and finally backfill and
low-priority API traffic.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class W:
    """Work type ids (reference ``WorkType``)."""

    # chain extension (highest priority)
    GOSSIP_BLOCK = "gossip_block"
    GOSSIP_BLOB_SIDECAR = "gossip_blob_sidecar"
    DELAYED_IMPORT_BLOCK = "delayed_import_block"
    RPC_BLOCK = "rpc_block"
    RPC_BLOBS = "rpc_blobs"
    CHAIN_SEGMENT = "chain_segment"
    # priority API
    API_REQUEST_P0 = "api_request_p0"
    # duties API: proposer/attester/sync duty queries — below
    # consensus-critical submissions, above bulk reads (the serving
    # admission layer's middle class; see scheduler/admission.py)
    API_REQUEST_DUTIES = "api_request_duties"
    # aggregates & proofs
    GOSSIP_AGGREGATE = "gossip_aggregate"
    GOSSIP_AGGREGATE_BATCH = "gossip_aggregate_batch"
    # unaggregated attestations
    GOSSIP_ATTESTATION = "gossip_attestation"
    GOSSIP_ATTESTATION_BATCH = "gossip_attestation_batch"
    UNKNOWN_BLOCK_ATTESTATION = "unknown_block_attestation"
    UNKNOWN_BLOCK_AGGREGATE = "unknown_block_aggregate"
    # sync committee
    GOSSIP_SYNC_SIGNATURE = "gossip_sync_signature"
    GOSSIP_SYNC_CONTRIBUTION = "gossip_sync_contribution"
    # other gossip ops
    GOSSIP_VOLUNTARY_EXIT = "gossip_voluntary_exit"
    GOSSIP_PROPOSER_SLASHING = "gossip_proposer_slashing"
    GOSSIP_ATTESTER_SLASHING = "gossip_attester_slashing"
    GOSSIP_BLS_TO_EXECUTION_CHANGE = "gossip_bls_to_execution_change"
    GOSSIP_LIGHT_CLIENT_FINALITY_UPDATE = "gossip_lc_finality"
    GOSSIP_LIGHT_CLIENT_OPTIMISTIC_UPDATE = "gossip_lc_optimistic"
    # RPC serving
    STATUS = "status"
    BLOCKS_BY_RANGE_REQUEST = "blocks_by_range"
    BLOCKS_BY_ROOTS_REQUEST = "blocks_by_roots"
    BLOBS_BY_RANGE_REQUEST = "blobs_by_range"
    BLOBS_BY_ROOTS_REQUEST = "blobs_by_roots"
    LIGHT_CLIENT_BOOTSTRAP_REQUEST = "lc_bootstrap"
    # low priority
    BACKFILL_SYNC = "backfill_sync"
    API_REQUEST_P1 = "api_request_p1"


# Drain order (reference ``beacon_processor/src/lib.rs:932-1110``): the
# manager always serves the first non-empty queue in this list.
DRAIN_ORDER = (
    W.GOSSIP_BLOCK,
    W.GOSSIP_BLOB_SIDECAR,
    W.DELAYED_IMPORT_BLOCK,
    W.RPC_BLOCK,
    W.RPC_BLOBS,
    W.CHAIN_SEGMENT,
    W.API_REQUEST_P0,
    W.GOSSIP_AGGREGATE,
    W.GOSSIP_ATTESTATION,
    W.UNKNOWN_BLOCK_AGGREGATE,
    W.UNKNOWN_BLOCK_ATTESTATION,
    W.API_REQUEST_DUTIES,
    W.GOSSIP_SYNC_CONTRIBUTION,
    W.GOSSIP_SYNC_SIGNATURE,
    W.GOSSIP_ATTESTER_SLASHING,
    W.GOSSIP_PROPOSER_SLASHING,
    W.GOSSIP_VOLUNTARY_EXIT,
    W.GOSSIP_BLS_TO_EXECUTION_CHANGE,
    W.STATUS,
    W.BLOCKS_BY_RANGE_REQUEST,
    W.BLOCKS_BY_ROOTS_REQUEST,
    W.BLOBS_BY_RANGE_REQUEST,
    W.BLOBS_BY_ROOTS_REQUEST,
    W.LIGHT_CLIENT_BOOTSTRAP_REQUEST,
    W.GOSSIP_LIGHT_CLIENT_FINALITY_UPDATE,
    W.GOSSIP_LIGHT_CLIENT_OPTIMISTIC_UPDATE,
    W.BACKFILL_SYNC,
    W.API_REQUEST_P1,
)

# Default per-queue bounds (reference scales these to the validator count,
# ``lib.rs:96``; these are the minimal-preset-scale defaults).
DEFAULT_QUEUE_LENGTHS = {
    W.GOSSIP_BLOCK: 1024,
    W.GOSSIP_BLOB_SIDECAR: 1024,
    W.GOSSIP_AGGREGATE: 4096,
    W.GOSSIP_ATTESTATION: 16384,
    W.UNKNOWN_BLOCK_ATTESTATION: 8192,
    W.UNKNOWN_BLOCK_AGGREGATE: 4096,
    W.BACKFILL_SYNC: 1024,
    W.API_REQUEST_P0: 1024,
    W.API_REQUEST_DUTIES: 1024,
    W.API_REQUEST_P1: 1024,
}
DEFAULT_QUEUE_LENGTH = 4096

#: How many times a worker-raised ``RequeueWork`` re-enqueues an event
#: before it is dropped for good.
MAX_WORK_RETRIES = 1


class RequeueWork(RuntimeError):
    """Raised by a work handler to ask the processor to re-enqueue the
    event(s) instead of counting them dropped.

    The canonical raiser is the device supervisor's ``DispatchTimeout``
    (``device_supervisor.py``): a dispatch that exceeded its watchdog
    deadline with no host fallback available is worth exactly one retry —
    by then the device has recovered, or the circuit breaker has opened and
    the retry routes to the host backend.  Each event retries at most
    :data:`MAX_WORK_RETRIES` times (``WorkEvent.retries``).
    """

# Batchable work: (batch_work_type, max batch size).  The reference caps
# coalescing at 64 attestations (``lib.rs:200-201``) because blst verifies
# on CPU threads; here the cap is the production standard device bucket
# (ops/verify.py ``N_BUCKETS[-1]``; kept as a literal so importing the work
# taxonomy never pulls jax).  Overridable for hosts where giant buckets are
# wrong (e.g. CPU-only deployments).
#
# Since the async device pipeline (device_pipeline.py), these caps are
# throughput HINTS — how much one worker drains per wakeup — not the batch
# formation mechanism: the pipeline coalesces what every worker submits
# ACROSS work types into the actual device batch, so a one-event drain
# still ends up in a maximal bucket.
def _standard_batch_from_env() -> int:
    raw = os.environ.get("LIGHTHOUSE_TPU_STANDARD_BATCH", "4096")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"LIGHTHOUSE_TPU_STANDARD_BATCH={raw!r}: expected a positive integer"
        ) from None
    if n < 1:
        raise ValueError(
            f"LIGHTHOUSE_TPU_STANDARD_BATCH={n}: must be >= 1"
        )
    return n


STANDARD_DEVICE_BATCH = _standard_batch_from_env()
BATCH_RULES = {
    W.GOSSIP_ATTESTATION: (W.GOSSIP_ATTESTATION_BATCH, STANDARD_DEVICE_BATCH),
    W.GOSSIP_AGGREGATE: (W.GOSSIP_AGGREGATE_BATCH, STANDARD_DEVICE_BATCH),
}


@dataclass
class WorkEvent:
    """One unit of work: ``process(*items)`` runs on a worker thread.

    ``drop_during_sync`` mirrors the reference's flag of the same name —
    gossip work that is stale while syncing can be discarded."""

    work_type: str
    process: Callable[..., Any]
    item: Any = None
    drop_during_sync: bool = False
    # Batch handler: called with a list of items when coalesced.
    process_batch: Optional[Callable[..., Any]] = None
    # Trace carriage across the enqueue→worker thread hop: the sender's
    # active span (stamped by BeaconProcessor.send unless pre-set) and the
    # enqueue instant, from which the worker records the queue-wait span.
    trace_parent: Any = None
    enqueued_at: float = 0.0
    # Times this event has been re-enqueued after a RequeueWork (bounded by
    # MAX_WORK_RETRIES).
    retries: int = 0
