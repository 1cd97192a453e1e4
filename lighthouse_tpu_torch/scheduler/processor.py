"""The priority work scheduler.

Equivalent of the reference's ``BeaconProcessor``
(`beacon_node/beacon_processor/src/lib.rs:753` ``spawn_manager``): a manager
thread drains bounded per-class queues in strict priority order into a pool of
``<= max_workers`` worker threads, coalescing attestation-class work into
batches sized to the device program's bucket shapes.

Design notes vs the reference:
- The reference's workers are tokio blocking threads; here they are plain
  threads.  CPU-bound Python work holds the GIL, but the workloads this
  scheduler feeds — the batched verification on the card, native SSZ/hash
  code, IO — all release it, which is exactly the deployment shape
  (host Python orchestrates, device/native code computes).
- Batch coalescing IS the device batch formation: one drained
  ``GossipAttestationBatch`` becomes one padded device invocation
  (``ops/verify.py`` buckets), so queue pressure directly widens device
  batches — the mechanism the reference uses to amortize multi-pairings
  (``attestation_verification/batch.rs``).

A copy of the JAX package's ``lighthouse_tpu/scheduler/processor.py``; its
locks come from the lock sanitizer's factory (``locksmith.condition``: a
plain ``threading.Condition`` while the sanitizer is off).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .work import (
    BATCH_RULES,
    DEFAULT_QUEUE_LENGTH,
    DEFAULT_QUEUE_LENGTHS,
    DRAIN_ORDER,
    MAX_WORK_RETRIES,
    RequeueWork,
    W,
    WorkEvent,
)


from .. import locksmith
from .. import metrics as _gm
from .. import tracing
from ..logs import get_logger

log = get_logger("scheduler.processor")

# Per-work-class series on /metrics (reference: the beacon_processor's
# per-queue event counters, task_executor's per-task metrics).
WORK_EVENTS_RECEIVED = _gm.counter(
    "beacon_processor_work_events_received_total",
    "work events enqueued, by work class",
)
WORK_EVENTS_PROCESSED = _gm.counter(
    "beacon_processor_work_events_processed_total",
    "work events completed, by work class",
)
WORK_EVENTS_DROPPED = _gm.counter(
    "beacon_processor_work_events_dropped_total",
    "work events dropped (full queue or worker panic), by work class",
)
DROPPED_DURING_SYNC = _gm.counter(
    "beacon_processor_dropped_during_sync_total",
    "gossip work discarded because the node is syncing, by work class",
)
WORK_EVENTS_REQUEUED = _gm.counter(
    "beacon_processor_work_requeued_total",
    "work events re-enqueued after a RequeueWork (device dispatch "
    "deadline exceeded and retryable), by work class",
)
QUEUE_DEPTH = _gm.BEACON_PROCESSOR_QUEUE_DEPTH


@dataclass
class ProcessorMetrics:
    received: Dict[str, int] = field(default_factory=dict)
    processed: Dict[str, int] = field(default_factory=dict)
    dropped: Dict[str, int] = field(default_factory=dict)
    dropped_during_sync: Dict[str, int] = field(default_factory=dict)
    batches: Dict[str, int] = field(default_factory=dict)
    batch_items: Dict[str, int] = field(default_factory=dict)

    def bump(self, table: Dict[str, int], key: str, n: int = 1) -> None:
        table[key] = table.get(key, 0) + n
        # mirror the event tables onto the Prometheus registry
        if table is self.received:
            WORK_EVENTS_RECEIVED.inc(n, work=key)
        elif table is self.processed:
            WORK_EVENTS_PROCESSED.inc(n, work=key)
        elif table is self.dropped:
            WORK_EVENTS_DROPPED.inc(n, work=key)
        elif table is self.dropped_during_sync:
            DROPPED_DURING_SYNC.inc(n, work=key)


class BeaconProcessor:
    def __init__(
        self,
        max_workers: int = 4,
        queue_lengths: Optional[dict] = None,
        is_syncing: Optional[Callable[[], bool]] = None,
        drop_policy: Optional["DropPolicy"] = None,
    ):
        """``is_syncing``: zero-arg callable consulted on enqueue; while it
        returns True, events flagged ``drop_during_sync`` are discarded
        (reference ``beacon_processor`` drops stale gossip during sync
        instead of queueing work the chain can't use yet).

        ``drop_policy``: the generalized form (scheduler/admission.py
        :class:`DropPolicy`) — decides per-event whether to discard instead
        of queue.  When omitted, ``is_syncing`` is wrapped in the original
        :class:`SyncDropPolicy`; passing both composes (either may drop)."""
        from .admission import SyncDropPolicy

        self.max_workers = max(1, max_workers)
        self.is_syncing = is_syncing
        self._drop_policies = [SyncDropPolicy(is_syncing)]
        if drop_policy is not None:
            self._drop_policies.append(drop_policy)
        self._drain_set = frozenset(DRAIN_ORDER)
        self._queues: Dict[str, deque] = {}
        self._limits = dict(DEFAULT_QUEUE_LENGTHS)
        if queue_lengths:
            self._limits.update(queue_lengths)
        self._lock = locksmith.condition("BeaconProcessor._lock")
        self._active_workers = 0
        self._last_depth_sample = 0.0
        self._shutdown = False
        self._idle = threading.Event()
        self._idle.set()
        self.metrics = ProcessorMetrics()
        self._manager = threading.Thread(target=self._manage, name="beacon-processor", daemon=True)
        self._manager.start()

    # ------------------------------------------------------------ ingress

    def send(self, event: WorkEvent) -> bool:
        """Enqueue; returns False when the class queue is full and the event
        was dropped (reference: queue-full drop + metric)."""
        if event.work_type not in self._drain_set:
            raise ValueError(f"unknown work type {event.work_type!r} (not in DRAIN_ORDER)")
        # Policy-driven discard (scheduler/admission.py): stale-while-syncing
        # gossip is the canonical case — attestations and aggregates against
        # a head we don't have yet would only fail later and crowd out the
        # sync work itself.  Only the "syncing" reason counts on the
        # dropped-during-sync series; custom policies' drops land on the
        # generic dropped counter so the sync metric never lies.
        for policy in self._drop_policies:
            reason = policy.should_drop(event)
            if reason is not None:
                table = (self.metrics.dropped_during_sync
                         if reason == "syncing" else self.metrics.dropped)
                self.metrics.bump(table, event.work_type)
                return False
        # Carry the sender's trace context across the thread hop; stamp the
        # enqueue instant for the worker-side queue-wait span.
        if event.trace_parent is None:
            event.trace_parent = tracing.current_span()
        event.enqueued_at = time.perf_counter()
        with self._lock:
            if self._shutdown:
                return False
            q = self._queues.setdefault(event.work_type, deque())
            limit = self._limits.get(event.work_type, DEFAULT_QUEUE_LENGTH)
            self.metrics.bump(self.metrics.received, event.work_type)
            if len(q) >= limit:
                self.metrics.bump(self.metrics.dropped, event.work_type)
                return False
            q.append(event)
            self._idle.clear()
            self._lock.notify_all()
            return True

    # ------------------------------------------------------------ manager

    def _next_work(self) -> Optional[List[WorkEvent]]:
        """First non-empty queue in drain order; batchable classes coalesce
        up to their batch size (must hold the lock).

        A batchable class with exactly ONE queued event still takes the
        batch path: the batch handlers are the seam that feeds the async
        device pipeline (device_pipeline.py), and a single attestation must
        enter it like any other group — the old ``len(q) > 1`` guard routed
        lone events through the per-item handler, so they never coalesced
        with anything.  With the pipeline doing the real cross-work-type
        batching, the per-class caps here are throughput hints (how much one
        worker drains per wakeup), not the batch-formation mechanism."""
        for wt in DRAIN_ORDER:
            q = self._queues.get(wt)
            if not q:
                continue
            rule = BATCH_RULES.get(wt)
            if rule is not None:
                _, max_batch = rule
                batch = []
                while q and len(batch) < max_batch:
                    batch.append(q.popleft())
                return batch
            return [q.popleft()]
        return None

    def _manage(self) -> None:
        while True:
            with self._lock:
                while not self._shutdown and (
                    self._active_workers >= self.max_workers or self._next_ready() is None
                ):
                    if self._active_workers == 0 and self._all_empty():
                        self._idle.set()
                    self._sample_queue_depths()
                    self._lock.wait(timeout=0.05)
                if self._shutdown:
                    return
                self._sample_queue_depths()
                batch = self._next_work()
                if batch is None:
                    continue
                self._active_workers += 1
            threading.Thread(target=self._run_worker, args=(batch,), daemon=True).start()

    def _sample_queue_depths(self) -> None:
        """Mirror per-class queue lengths onto
        ``beacon_processor_queue_depth{work}`` (throttled; must hold the
        lock).  Read next to ``device_pipeline_pending_sets``: queue
        pressure here vs batch fill there attributes a small-batches
        regression in one scrape."""
        now = time.monotonic()
        if now - self._last_depth_sample < 0.25:
            return
        self._last_depth_sample = now
        for wt, q in self._queues.items():
            QUEUE_DEPTH.set(len(q), work=wt)

    def _next_ready(self) -> Optional[str]:
        for wt in DRAIN_ORDER:
            if self._queues.get(wt):
                return wt
        return None

    def _all_empty(self) -> bool:
        return all(not q for q in self._queues.values())

    def _requeue(self, events: List[WorkEvent], wt: str) -> None:
        """Deadline-exceeded (or otherwise retryable) work: re-enqueue each
        event once instead of dropping it — by the retry, the device has
        recovered or its breaker has opened and routed the work to the host
        backend (device_supervisor.DispatchTimeout subclasses RequeueWork
        exactly for this seam)."""
        for ev in events:
            if ev.retries < MAX_WORK_RETRIES:
                ev.retries += 1
                WORK_EVENTS_REQUEUED.inc(work=wt)
                # A failed send already accounts for its own drop
                # (queue-full / during-sync) — don't double-count here.
                self.send(ev)
            else:
                self.metrics.bump(self.metrics.dropped, wt)

    def _run_worker(self, batch: List[WorkEvent]) -> None:
        wt = batch[0].work_type
        token = tracing.attach(batch[0].trace_parent)
        try:
            with tracing.span(f"work:{wt}", n_items=len(batch)):
                # enqueue→drain wait, measured from the OLDEST event in the
                # drained batch (its wait bounds everyone else's).
                tracing.record_span(
                    "queue_wait",
                    start_pc=min(ev.enqueued_at for ev in batch),
                    hist=_gm.QUEUE_WAIT_SECONDS,
                    hist_labels={"work": wt},
                    work=wt,
                )
                # Batch handler whenever one exists — including a batch of
                # ONE (the handler is the device-pipeline seam; see
                # _next_work).  Events without a batch handler run per-item.
                # A drained batch may MIX shapes: the same queue holds fresh
                # gossip (process_batch + item) and re-queued events from
                # the reprocess queue; feeding a shapeless event's
                # item=None through the batch handler would throw and take
                # every sibling down with it — so the batch call covers
                # only the events that opted into it, the rest run
                # per-item.
                if wt in BATCH_RULES:
                    grouped = [ev for ev in batch
                               if ev.process_batch is not None]
                    loose = [ev for ev in batch if ev.process_batch is None]
                else:
                    grouped, loose = [], batch
                if grouped:
                    batch_wt = BATCH_RULES[wt][0]
                    self.metrics.bump(self.metrics.batches, batch_wt)
                    self.metrics.bump(self.metrics.batch_items, batch_wt,
                                      len(grouped))
                    try:
                        grouped[0].process_batch([ev.item for ev in grouped])
                    except RequeueWork:
                        self._requeue(grouped, wt)
                    else:
                        self.metrics.bump(self.metrics.processed, wt,
                                          len(grouped))
                if loose:
                    idx = 0
                    try:
                        for idx, ev in enumerate(loose):
                            ev.process(ev.item)
                            self.metrics.bump(self.metrics.processed, wt)
                    except RequeueWork:
                        # Only the raiser and the unprocessed tail retry;
                        # events before it already ran to completion.
                        self._requeue(loose[idx:], wt)
        except Exception:
            # A worker panic must not kill the node (reference logs + metric)
            # — but it must not vanish either: the batch it took down is
            # real work (the silent-drop variant of this cost a soak run
            # its attestations), so leave a trace for triage.
            log.warning("worker panic", work=wt, n_items=len(batch),
                        exc_info=True)
            self.metrics.bump(self.metrics.dropped, wt, len(batch))
        finally:
            tracing.detach(token)
            with self._lock:
                self._active_workers -= 1
                if self._active_workers == 0 and self._all_empty():
                    self._idle.set()
                self._lock.notify_all()

    # ------------------------------------------------------------ control

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until all queues are drained and workers are done."""
        return self._idle.wait(timeout)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()
        self._manager.join(timeout=2.0)


class ReprocessQueue:
    """Delay queue for work that can't run yet: early blocks (before their
    slot), attestations referencing unknown blocks, backfill batches
    (reference: ``work_reprocessing_queue.rs``, doc ``:1-12``)."""

    MAX_DELAYED = 16384
    #: how long work may await a block that never imports (a lookup that
    #: aborts — dead peer, depth cap, bad response — must not strand its
    #: parked attestations forever, or the cap above eventually disables
    #: parking for the rest of the process)
    AWAIT_TTL_S = 12.0

    def __init__(self, processor: BeaconProcessor):
        self.processor = processor
        self._lock = locksmith.condition("ReprocessQueue._lock")
        self._by_time: List = []  # heap of (due, seq, event)
        # root -> [(expires_at, event)]
        self._awaiting_root: Dict[bytes, List[tuple]] = {}
        self._seq = 0
        self._n_awaiting = 0
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, name="reprocess-queue", daemon=True)
        self._thread.start()

    def schedule_at(self, due: float, event: WorkEvent) -> None:
        """Run ``event`` at ``time.monotonic()``-clock instant ``due``
        (early-block delay): ``schedule_at(time.monotonic() + d, ev)``."""
        import heapq

        with self._lock:
            self._seq += 1
            heapq.heappush(self._by_time, (due, self._seq, event))
            self._lock.notify_all()

    def await_block(self, block_root: bytes, event: WorkEvent) -> bool:
        """Queue ``event`` until ``block_imported(block_root)`` — or until
        ``AWAIT_TTL_S`` passes without it (then it is dropped)."""
        with self._lock:
            if self._n_awaiting >= self.MAX_DELAYED:
                return False
            self._awaiting_root.setdefault(block_root, []).append(
                (time.monotonic() + self.AWAIT_TTL_S, event))
            self._n_awaiting += 1
            return True

    def block_imported(self, block_root: bytes) -> int:
        """Release work waiting on a now-imported block; returns #released."""
        with self._lock:
            entries = self._awaiting_root.pop(block_root, [])
            self._n_awaiting -= len(entries)
        for _expires, ev in entries:
            self.processor.send(ev)
        return len(entries)

    def _expire_awaiting(self, now: float) -> None:
        """Drop parked work whose block never imported (caller holds the
        lock) — the sibling of the reference's queued-attestation expiry."""
        for root in list(self._awaiting_root):
            kept = [e for e in self._awaiting_root[root] if e[0] > now]
            dropped = len(self._awaiting_root[root]) - len(kept)
            if dropped:
                self._n_awaiting -= dropped
                if kept:
                    self._awaiting_root[root] = kept
                else:
                    del self._awaiting_root[root]

    def _run(self) -> None:
        import heapq

        while True:
            with self._lock:
                if self._shutdown:
                    return
                now = time.monotonic()
                self._expire_awaiting(now)
                due_events = []
                while self._by_time and self._by_time[0][0] <= now:
                    _, _, ev = heapq.heappop(self._by_time)
                    due_events.append(ev)
                timeout = (
                    max(0.0, self._by_time[0][0] - now) if self._by_time else 0.1
                )
            for ev in due_events:
                self.processor.send(ev)
            with self._lock:
                if not self._shutdown:
                    self._lock.wait(timeout=min(timeout, 0.1))

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()
        self._thread.join(timeout=2.0)
