"""Prioritized admission control and load shedding for API work.

The serving half of the reference's ``beacon_processor`` drop/requeue
semantics: the processor's bounded per-class queues protect the node from
*gossip* floods, but nothing protected it from *HTTP read* floods — every
duty/state/rewards query used to queue unconditionally and time out 30 s
later, long after the client gave up.  This module puts a policy object in
front of :class:`~lighthouse_tpu_torch.scheduler.processor.BeaconProcessor`:

- inbound HTTP work is classified (``critical`` > ``duties`` > ``bulk``),
- each class holds a bounded number of admitted-but-unfinished requests —
  past the bound the request is shed *immediately* (503 + Retry-After),
  which costs microseconds instead of a queue slot,
- admitted work that waited past its class deadline before a worker picked
  it up is shed at dequeue (the reference's stale-work drop: a duties
  answer delivered after the client's own timeout is pure waste),
- every decision is visible: ``http_requests_shed_total{class,reason}``
  and the ``http_admission_wait_seconds{class}`` queue-wait histogram.

It also generalizes the processor's ad-hoc ``is_syncing`` callable into
:class:`DropPolicy` — the one object that decides which enqueued work is
discarded instead of queued (``drop_during_sync`` was the first policy;
admission deadlines are the second).

**Latency-driven bounds.**  The configured
:class:`ClassPolicy` values are *static guesses*; the observed handler
latency is a *measurement* — every :class:`Ticket` release feeds a
per-class service-time EWMA.  When the autotune layer runs live
(``LIGHTHOUSE_TPU_AUTOTUNE=live``, or ``adaptive=True`` on the
controller), the effective dequeue deadline tracks
``DEADLINE_LATENCY_FACTOR`` × EWMA and the effective inflight bound tracks
how many requests one worker can clear inside that deadline — both clamped
to a band whose ceiling IS the configured static value (the statics remain
the contract; the controller only tightens inside it).  Fast handlers →
static bounds shed late and waste queue slots on stale answers;
slow handlers → static bounds admit work that cannot possibly be served in
time.  Both are visible on the ``http_admission_effective_*`` gauges.

**Measured Retry-After.**  A shed response's Retry-After used to be a
per-class constant.  It now reflects the class's *observed drain rate*
(completions over a sliding window): the hint is the time for roughly half
the currently-inflight requests to drain, clamped to
[1, :data:`RETRY_AFTER_MAX_S`] — falling back to the configured constant
below :data:`DRAIN_MIN_SAMPLES` completions.  This path is always on
(it shapes a response hint, not an admission decision).

A copy of the JAX package's ``lighthouse_tpu/scheduler/admission.py``; its
lock comes from the lock sanitizer's factory (``locksmith.lock``).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Tuple

from .. import blackbox, locksmith, metrics

# ------------------------------------------------------------ HTTP classes

#: Consensus-critical API work: block/attestation/aggregate submission and
#: production — shedding these risks missed duties network-wide, so their
#: bound is the loosest and their deadline the longest.
CLASS_CRITICAL = "critical"
#: Validator duties queries (proposer/attester/sync) — latency-sensitive
#: but recomputable; a VC retries on its own schedule.
CLASS_DUTIES = "duties"
#: Bulk read traffic: state dumps, rewards, analysis — the first thing to
#: shed under overload.
CLASS_BULK = "bulk"

HTTP_REQUESTS_SHED = metrics.counter(
    "http_requests_shed_total",
    "Beacon API requests shed by admission control, by class and reason "
    "(admission_full|deadline)",
)
HTTP_ADMISSION_WAIT_SECONDS = metrics.histogram(
    "http_admission_wait_seconds",
    "admission-to-execution wait for admitted API work, by class",
)
HTTP_ADMISSION_INFLIGHT = metrics.gauge(
    "http_admission_inflight",
    "admitted-but-unfinished API requests, by class",
)
HTTP_ADMISSION_LATENCY_EWMA = metrics.gauge(
    "http_admission_latency_ewma_seconds",
    "observed handler service-time EWMA feeding the latency-driven "
    "admission bounds, by class",
)
HTTP_ADMISSION_EFFECTIVE_DEADLINE = metrics.gauge(
    "http_admission_effective_deadline_seconds",
    "dequeue deadline currently in force (static, or latency-tracked in "
    "autotune live mode), by class",
)
HTTP_ADMISSION_EFFECTIVE_INFLIGHT = metrics.gauge(
    "http_admission_effective_max_inflight",
    "inflight bound currently in force (static, or latency-tracked in "
    "autotune live mode), by class",
)

#: Service-time EWMA smoothing (~20 samples to converge on a step).
EWMA_ALPHA = 0.2
#: The effective deadline targets this multiple of the observed service
#: time: an admitted request that already waited 4 service times is deep
#: into diminishing-value territory.
DEADLINE_LATENCY_FACTOR = 4.0
#: Band floors (the configured static value is the ceiling for both): the
#: controller may tighten a deadline to a quarter of its static value and
#: an inflight bound to an eighth — never below, so a latency spike can
#: only narrow service, not collapse it.
DEADLINE_FLOOR_FRACTION = 0.25
INFLIGHT_FLOOR_FRACTION = 0.125

#: Retry-After derivation: sliding completion window + sample floor.
DRAIN_WINDOW = 64
DRAIN_MIN_SAMPLES = 8
RETRY_AFTER_MAX_S = 30


class ShedError(Exception):
    """The request was shed; the server answers 503 with Retry-After."""

    def __init__(self, klass: str, reason: str, retry_after_s: int):
        super().__init__(
            f"overloaded: {klass} request shed ({reason}); "
            f"retry after {retry_after_s}s"
        )
        self.klass = klass
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class ClassPolicy:
    """Admission bounds for one work class.

    ``max_inflight`` caps admitted-but-unfinished requests (the cheap
    early shed); ``deadline_s`` bounds how stale an admitted request may
    be when a worker finally picks it up (the dequeue shed);
    ``retry_after_s`` is what a shed response tells the client when the
    drain rate is unobserved.  All three are the STATIC configuration —
    the latency-driven layer narrows inside them, never past them."""

    name: str
    max_inflight: int
    deadline_s: float
    retry_after_s: int


#: Defaults sized for the minimal-preset CI host; production deployments
#: scale ``max_inflight`` with worker count the way the reference scales
#: its queue lengths with the validator count.
DEFAULT_POLICIES = (
    ClassPolicy(CLASS_CRITICAL, max_inflight=512, deadline_s=8.0, retry_after_s=1),
    ClassPolicy(CLASS_DUTIES, max_inflight=256, deadline_s=4.0, retry_after_s=2),
    ClassPolicy(CLASS_BULK, max_inflight=128, deadline_s=2.0, retry_after_s=5),
)


class Ticket:
    """One admitted request: stamped at admission, released when finished
    (shed or served).  ``check_deadline`` is called by the worker just
    before running the handler — the dequeue-side shed."""

    __slots__ = ("controller", "policy", "admitted_pc", "started_pc", "shed")

    def __init__(self, controller: "AdmissionController", policy: ClassPolicy):
        self.controller = controller
        self.policy = policy
        self.admitted_pc = time.perf_counter()
        self.started_pc: Optional[float] = None
        self.shed = False

    def check_deadline(self) -> float:
        """Record the queue wait; raise :class:`ShedError` when this request
        waited past its class's EFFECTIVE deadline (static, or
        latency-tracked in live mode).  Returns the wait in seconds."""
        now = time.perf_counter()
        wait = now - self.admitted_pc
        HTTP_ADMISSION_WAIT_SECONDS.observe(wait, **{"class": self.policy.name})
        _, deadline_s = self.controller.effective_bounds(self.policy.name)
        if wait > deadline_s:
            self.shed = True
            HTTP_REQUESTS_SHED.inc(**{"class": self.policy.name,
                                      "reason": "deadline"})
            self.controller._count_shed()
            blackbox.emit("admission", "shed", klass=self.policy.name,
                          reason="deadline", wait_s=round(wait, 4))
            raise ShedError(self.policy.name, "deadline",
                            self.controller.retry_after(self.policy.name))
        self.started_pc = now
        return wait

    def release(self) -> None:
        # Only a request whose handler actually RAN (check_deadline set
        # started_pc) feeds the latency EWMA: a shed one never ran, and a
        # queue-full rejection released straight after try_admit would
        # record its ~microsecond enqueue failure as a 'service time' —
        # dragging the EWMA to zero exactly when the system is overloaded.
        duration: Optional[float] = None
        if not self.shed and self.started_pc is not None:
            duration = time.perf_counter() - self.started_pc
        self.controller._release(self.policy.name, duration)


class AdmissionController:
    """Bounded per-class admission in front of the processor.

    ``adaptive=None`` (production) follows the autotune mode — the bounds
    track latency only under ``LIGHTHOUSE_TPU_AUTOTUNE=live``; ``True`` /
    ``False`` pins the behavior (tests, the bench harness)."""

    def __init__(self, policies=DEFAULT_POLICIES,
                 adaptive: Optional[bool] = None):
        self._policies: Dict[str, ClassPolicy] = {p.name: p for p in policies}
        self._inflight: Dict[str, int] = {p.name: 0 for p in policies}
        self._lock = locksmith.lock("AdmissionController._lock")
        self._adaptive = adaptive
        self._ewma: Dict[str, float] = {}
        self._done: Dict[str, Deque[float]] = {
            p.name: deque(maxlen=DRAIN_WINDOW) for p in policies
        }
        self.shed = 0  # process-lifetime total, for snapshots/tests

    def policy(self, klass: str) -> ClassPolicy:
        return self._policies[klass]

    # ------------------------------------------------- latency-driven bounds

    def _adaptive_on(self) -> bool:
        if self._adaptive is not None:
            return self._adaptive
        from .. import autotune

        return autotune.live()

    def effective_bounds(self, klass: str) -> Tuple[int, float]:
        """(max_inflight, deadline_s) currently in force for ``klass``:
        the static policy values, or — adaptive mode with an observed
        EWMA — the latency-tracked values inside the static band.

        The deadline targets :data:`DEADLINE_LATENCY_FACTOR` × EWMA
        (floor ``static × DEADLINE_FLOOR_FRACTION``, ceiling static); the
        inflight bound is how many requests one worker clears inside that
        deadline, ``deadline / EWMA`` (floor ``static ×
        INFLIGHT_FLOOR_FRACTION``, ceiling static) — Little's law with the
        observed service rate.  Fast handlers pin both at the static
        ceiling's spirit: a tight deadline sheds stale work early while
        the large drain keeps the inflight bound at its ceiling."""
        policy = self._policies.get(klass)
        if policy is None:
            return (1 << 30, 60.0)
        with self._lock:
            ewma = self._ewma.get(klass)
        if ewma is None or ewma <= 0 or not self._adaptive_on():
            return (policy.max_inflight, policy.deadline_s)
        return self._bounds_from_ewma(policy, ewma)

    @staticmethod
    def _bounds_from_ewma(policy: ClassPolicy,
                          ewma: float) -> Tuple[int, float]:
        deadline = min(policy.deadline_s,
                       max(policy.deadline_s * DEADLINE_FLOOR_FRACTION,
                           DEADLINE_LATENCY_FACTOR * ewma))
        floor = max(1, int(policy.max_inflight * INFLIGHT_FLOOR_FRACTION))
        max_inflight = min(policy.max_inflight,
                           max(floor, int(deadline / ewma)))
        return (max_inflight, deadline)

    def retry_after(self, klass: str) -> int:
        """The Retry-After hint for a shed ``klass`` request: time for
        roughly half the inflight requests to drain at the observed
        completion rate, clamped to [1, :data:`RETRY_AFTER_MAX_S`].  Below
        :data:`DRAIN_MIN_SAMPLES` completions (cold start, idle class) the
        configured constant stands — a hint must never be derived from
        noise."""
        policy = self._policies.get(klass)
        fallback = policy.retry_after_s if policy is not None else 1
        with self._lock:
            done = self._done.get(klass)
            if done is None or len(done) < DRAIN_MIN_SAMPLES:
                return fallback
            span = done[-1] - done[0]
            if span <= 0:
                return fallback
            rate = (len(done) - 1) / span  # completions per second
            backlog = max(1, self._inflight.get(klass, 0))
        return max(1, min(RETRY_AFTER_MAX_S,
                          int(math.ceil((backlog / 2.0) / rate))))

    # ------------------------------------------------------------ admission

    def try_admit(self, klass: str) -> Ticket:
        """Admit or shed.  Unknown classes are admitted unbounded (a route
        added without a policy must not 503 by accident — it just isn't
        protected yet)."""
        policy = self._policies.get(klass)
        if policy is None:
            policy = ClassPolicy(klass, max_inflight=1 << 30,
                                 deadline_s=60.0, retry_after_s=1)
            with self._lock:
                self._policies.setdefault(klass, policy)
                self._inflight.setdefault(klass, 0)
                self._done.setdefault(klass, deque(maxlen=DRAIN_WINDOW))
        bound, _ = self.effective_bounds(policy.name)
        with self._lock:
            if self._inflight[policy.name] < bound:
                self._inflight[policy.name] += 1
                HTTP_ADMISSION_INFLIGHT.set(self._inflight[policy.name],
                                            **{"class": policy.name})
                return Ticket(self, policy)
            self.shed += 1
            HTTP_REQUESTS_SHED.inc(**{"class": policy.name,
                                      "reason": "admission_full"})
        # Retry-After derivation re-acquires the lock — raise outside it
        # (and the journal emit stays off the lock for the same reason).
        blackbox.emit("admission", "shed", klass=policy.name,
                      reason="admission_full", bound=bound)
        raise ShedError(policy.name, "admission_full",
                        self.retry_after(policy.name))

    def _count_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def _release(self, klass: str, duration: Optional[float] = None) -> None:
        with self._lock:
            self._inflight[klass] = max(0, self._inflight[klass] - 1)
            HTTP_ADMISSION_INFLIGHT.set(self._inflight[klass],
                                        **{"class": klass})
            if duration is not None:
                prev = self._ewma.get(klass)
                ewma = duration if prev is None else (
                    EWMA_ALPHA * duration + (1.0 - EWMA_ALPHA) * prev)
                self._ewma[klass] = ewma
                done = self._done.setdefault(klass,
                                             deque(maxlen=DRAIN_WINDOW))
                done.append(time.perf_counter())
        if duration is not None:
            # bounds derived from the ewma just computed — no second trip
            # through the lock on the per-completion hot path
            HTTP_ADMISSION_LATENCY_EWMA.set(ewma, **{"class": klass})
            policy = self._policies.get(klass)
            if policy is not None and self._adaptive_on():
                bound, deadline = self._bounds_from_ewma(policy, ewma)
            elif policy is not None:
                bound, deadline = policy.max_inflight, policy.deadline_s
            else:
                return
            HTTP_ADMISSION_EFFECTIVE_INFLIGHT.set(bound, **{"class": klass})
            HTTP_ADMISSION_EFFECTIVE_DEADLINE.set(deadline,
                                                  **{"class": klass})

    def snapshot(self) -> dict:
        with self._lock:
            # copy under the lock: try_admit registers unknown classes into
            # _policies concurrently, and effective_bounds/retry_after each
            # re-acquire the lock themselves (so they run on the copy)
            policies = dict(self._policies)
        effective = {k: self.effective_bounds(k) for k in policies}
        retry = {k: self.retry_after(k) for k in policies}
        adaptive = self._adaptive_on()  # resolves autotune mode: outside the lock
        with self._lock:
            return {
                "inflight": dict(self._inflight),
                "bounds": {k: p.max_inflight for k, p in policies.items()},
                "deadlines_s": {k: p.deadline_s for k, p in policies.items()},
                # the RESOLVED state (ctor pin, else the live autotune
                # mode) — OBSERVABILITY.md's triage reads this to decide
                # whether tightened bounds can be autotune's doing
                "adaptive": adaptive,
                "latency_ewma_s": {k: round(v, 6)
                                   for k, v in self._ewma.items()},
                "effective": {
                    k: {"max_inflight": b, "deadline_s": round(d, 4)}
                    for k, (b, d) in effective.items()
                },
                "retry_after_s": retry,
                "shed_total": self.shed,
            }


# ------------------------------------------------------------ drop policy


class DropPolicy:
    """Decides whether an enqueued :class:`WorkEvent` should be discarded
    instead of queued.  Returns a drop *reason* (metric label) or ``None``
    to admit — the generalization of the processor's original hard-coded
    ``drop_during_sync and is_syncing()`` test."""

    def should_drop(self, event) -> Optional[str]:  # pragma: no cover
        return None


class SyncDropPolicy(DropPolicy):
    """The original policy: while ``is_syncing()`` holds, events flagged
    ``drop_during_sync`` are discarded (stale gossip is useless to a
    syncing chain and crowds out the sync work itself)."""

    def __init__(self, is_syncing: Optional[Callable[[], bool]]):
        self.is_syncing = is_syncing

    def should_drop(self, event) -> Optional[str]:
        if (
            event.drop_during_sync
            and self.is_syncing is not None
            and self.is_syncing()
        ):
            return "syncing"
        return None
