"""Supervised device execution: watchdog, split-batch retry, circuit breaker.

The port of ``lighthouse_tpu/device_supervisor.py``.  Both of the port's
device entry points — ``ops/verify.py`` (``bls_verify``) and
``ops/kzg_device.py`` (``kzg_batch``) — run their device leg through
:meth:`DeviceSupervisor.run` (the reference's ``execution_layer/src/
engines.rs`` upcheck/cooldown discipline, applied to the device boundary).
Where their tensors are on the card they pass ``host_on_failure=False``:
a CUDA error, a failed kernel build, a hung launch or an OPEN breaker
then raises into the caller — counted, recorded and breaker-tracked, but
never answered from the host.  With ``device="cpu"`` the reference's
behaviour holds and those failures resolve through the host golden model:

- **dispatch watchdog** — each device leg runs on a per-op worker thread,
  which issues the eager program's launches and then waits on a
  ``torch.cuda.Event`` recorded after them (the counterpart of jax's
  ``block_until_ready``); the caller waits with a per-op deadline.  A hung
  device strands the *worker*, never the caller: on expiry the worker is
  abandoned (a fresh one serves the next batch) and the batch raises
  :class:`DispatchTimeout` (off the card: resolves on the host).  Unlike
  a jax dispatch, which is enqueued whole, an abandoned eager worker may
  still be issuing launches; its tensors are its own, so results stay
  right, but process-wide launch counters interleave — per-batch stages
  come from the flight record.
- **split-batch retry** — one retry on a device error, with the batch
  split in half; both halves still run under the watchdog.
- **circuit breaker** — per-op CLOSED → OPEN after N consecutive failures
  → HALF_OPEN probe batches after a cooldown → CLOSED.  While OPEN,
  batches fail fast without touching the card (off the card: route
  straight to the host golden model, ``crypto/bls/backends/host.py`` or
  ``Kzg``'s host MSM path).  A sticky CUDA error (an illegal address
  poisons the context) fails every later batch too; that is what trips
  the breaker.

A device error is any exception the device leg raises: ``torch.cuda``'s
errors, a ``RuntimeError`` from a launch or from the kernel build.  The
host route only ever calls the host golden model, never the plain PyTorch
versions of the kernels.

Every state transition is exported via ``metrics/``
(``device_breaker_state{op}``, ``device_breaker_transitions_total``),
journaled in ``blackbox``, and published as ``device_breaker`` events on
every registered event bus.

The ``w_at_infinity`` host re-verify of ``ops/verify.py`` also routes
through :meth:`DeviceSupervisor.run` (the device leg raises
:class:`HostFallback`), on the card too — it is part of the verification
algorithm, not a failure — so there is exactly ONE host-fallback
mechanism and one counter: ``device_batch_host_fallback_total{reason=w_at_infinity|
breaker_open|dispatch_timeout|device_error}``.

**Mesh-aware dispatch** (:meth:`DeviceSupervisor._dispatch_meshed`):
while the device mesh (``device_mesh.py``) is on, a device error or a
watchdog timeout is charged to a mesh member; a charge that trips that
member's breaker re-shards over the survivors and the batch retries on the
new topology (``device_mesh_reshards_total`` / ``device_mesh_size``).  A
failure that does not re-shard goes on into the split retry and the op
breaker above, so on the card it still raises.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import blackbox, metrics, tracing
from .logs import get_logger
from .scheduler.work import RequeueWork
from .timeout_lock import TimeoutLock

log = get_logger("device_supervisor")

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

#: Gauge encoding of the state machine (device_breaker_state{op}).
STATE_CODES = {STATE_CLOSED: 0, STATE_OPEN: 1, STATE_HALF_OPEN: 2}

#: Per-op dispatch deadlines (seconds).  Generous: the first batch of a
#: process pays the ``nvcc`` build of the kernels inside its dispatch, and
#: the watchdog exists to catch a *hung* device, not a slow first batch.
DEFAULT_DEADLINES = {
    "bls_verify": 300.0,
    "sha256_pairs": 120.0,
    "tree_hash": 120.0,
    "epoch_deltas": 300.0,
    "epoch_deltas_leak": 300.0,
    # the fused boundary composes deltas + shuffle + proposer walk into one
    # job; its first dispatch also builds the shuffle kernels
    "epoch_boundary": 600.0,
    "epoch_boundary_leak": 600.0,
    "shuffle": 300.0,
    "proposer_select": 300.0,
    "kzg_batch": 300.0,
    # the autotune A/B probe (autotune.measure_walk_lookahead): a small
    # walk, but the first run of a process pays the kernel build — the
    # deadline guards node startup against a hung device, not a compiler
    "autotune_probe": 120.0,
}
DEFAULT_DEADLINE_S = 300.0

#: Ops whose device programs compute batch-GLOBAL reductions (the kzg
#: program tree-sums its random linear combination over the blob axis; the
#: epoch deltas sum participating increments over the registry): the
#: halves of a split are not independent sub-problems, so split-batch
#: retry is forbidden for them no matter what a caller passes.  Failures
#: for these ops go straight to the failure route.  Must stay in sync with
#: the ``reduces_over_batch`` entries in ``ops/batch_axes.py``.
NO_SPLIT_OPS = frozenset({
    "epoch_deltas", "epoch_deltas_leak", "kzg_batch",
    # the fused boundary embeds the same registry-wide sums; the shuffle
    # and proposer walks are whole-permutation computations — no half of
    # a swap-or-not network is a smaller swap-or-not network
    "epoch_boundary", "epoch_boundary_leak", "shuffle", "proposer_select",
})


class DispatchTimeout(RequeueWork):
    """A device dispatch exceeded its watchdog deadline.

    Subclasses :class:`scheduler.work.RequeueWork`: if a caller without a
    host fallback lets it escape into a scheduler worker, the work is
    re-enqueued once instead of dropped (the device may have recovered — or
    the breaker opened, routing the retry to the host).
    """

    def __init__(self, op: str, deadline_s: float):
        super().__init__(f"device dispatch for {op!r} exceeded {deadline_s}s deadline")
        self.op = op
        self.deadline_s = deadline_s


class HostFallback(Exception):
    """Raised by a device path that executed fine but disclaims its verdict
    (the W-at-infinity check): the supervisor re-verifies on the host
    WITHOUT counting a breaker failure."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class BreakerConfig:
    """Tuning knobs, overridable via env (``LIGHTHOUSE_TPU_BREAKER_*``)."""

    def __init__(
        self,
        failure_threshold: int = 3,
        open_cooldown_s: float = 30.0,
        probe_successes: int = 2,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_cooldown_s = float(open_cooldown_s)
        self.probe_successes = max(1, int(probe_successes))

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        return cls(
            failure_threshold=int(
                os.environ.get("LIGHTHOUSE_TPU_BREAKER_FAILURES", "3")
            ),
            open_cooldown_s=float(
                os.environ.get("LIGHTHOUSE_TPU_BREAKER_COOLDOWN_S", "30")
            ),
            probe_successes=int(
                os.environ.get("LIGHTHOUSE_TPU_BREAKER_PROBES", "2")
            ),
        )


# Injectable cooldown clock: a breaker cooldown is control-path time — a
# harness (a scenario's virtual clock, a check that must not sleep out a
# 30 s cooldown) installs its own clock here and restores the default;
# production keeps wall time.
_cooldown_clock: Callable[[], float] = time.monotonic


def set_cooldown_clock(fn: Optional[Callable[[], float]] = None) -> None:
    global _cooldown_clock
    _cooldown_clock = fn if fn is not None else time.monotonic


class CircuitBreaker:
    """CLOSED → OPEN → HALF_OPEN → CLOSED, per device op.

    Lock discipline: the :class:`TimeoutLock` guards only the counters and
    state word; transition side effects (metrics, SSE, logs) run after
    release via the collected ``transitions`` list.
    """

    def __init__(self, op: str, config: BreakerConfig):
        self.op = op
        self.config = config
        self._lock = TimeoutLock(f"breaker[{op}]", label="CircuitBreaker._lock")
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0  # monotonic
        self._probe_successes = 0
        self.trips_total = 0       # CLOSED/HALF_OPEN -> OPEN transitions
        self.probes_total = 0      # batches admitted while HALF_OPEN
        self.last_failure: Optional[str] = None
        metrics.DEVICE_BREAKER_STATE.set(STATE_CODES[STATE_CLOSED], op=op)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str, reason: str,
                    transitions: List[Tuple[str, str, str]]) -> None:
        """Record a state change (lock held); effects are emitted later."""
        transitions.append((self._state, to, reason))
        self._state = to
        if to == STATE_OPEN:
            self.trips_total += 1
            self._opened_at = _cooldown_clock()
            self._probe_successes = 0
        elif to == STATE_CLOSED:
            self._consecutive_failures = 0
            self._probe_successes = 0

    def route(self) -> Tuple[str, List[Tuple[str, str, str]]]:
        """``("device"|"host", transitions)`` for the next batch.  OPEN past
        its cooldown flips to HALF_OPEN and admits a probe."""
        transitions: List[Tuple[str, str, str]] = []
        with self._lock:
            if self._state == STATE_OPEN:
                if _cooldown_clock() - self._opened_at >= self.config.open_cooldown_s:
                    self._transition(STATE_HALF_OPEN, "cooldown_elapsed", transitions)
                else:
                    return "host", transitions
            if self._state == STATE_HALF_OPEN:
                self.probes_total += 1
            return "device", transitions

    def record_success(self) -> List[Tuple[str, str, str]]:
        transitions: List[Tuple[str, str, str]] = []
        with self._lock:
            self._consecutive_failures = 0
            if self._state == STATE_HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.config.probe_successes:
                    self._transition(STATE_CLOSED, "probes_passed", transitions)
        return transitions

    def record_failure(self, reason: str) -> List[Tuple[str, str, str]]:
        transitions: List[Tuple[str, str, str]] = []
        with self._lock:
            self.last_failure = reason
            self._consecutive_failures += 1
            if self._state == STATE_HALF_OPEN:
                self._transition(STATE_OPEN, f"probe_failed:{reason}", transitions)
            elif (
                self._state == STATE_CLOSED
                and self._consecutive_failures >= self.config.failure_threshold
            ):
                self._transition(STATE_OPEN, reason, transitions)
        return transitions

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "op": self.op,
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "trips_total": self.trips_total,
                "probes_total": self.probes_total,
                "last_failure": self.last_failure,
                "failure_threshold": self.config.failure_threshold,
                "open_cooldown_s": self.config.open_cooldown_s,
                "probe_successes_required": self.config.probe_successes,
            }


# ---------------------------------------------------------- watchdog worker


class _Job:
    __slots__ = ("fn", "parent_span", "done", "value", "error")

    def __init__(self, fn: Callable[[], Any], parent_span):
        self.fn = fn
        self.parent_span = parent_span
        self.done = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None


class _OpWorker:
    """One long-lived dispatch thread per op.

    Steady state costs one queue handoff per batch (no thread spawn).  The
    device leg it runs selects its card (``torch.cuda.device``), issues the
    program and waits on an event recorded after it.  When a dispatch
    hangs past its deadline the supervisor *abandons* this worker — the
    stranded thread finishes its leg if it ever can, then exits; the next
    batch gets a fresh worker.  The caller is never the thread that blocks
    on the device.
    """

    def __init__(self, op: str):
        self.op = op
        self.abandoned = False
        self._q: "queue.SimpleQueue[Optional[_Job]]" = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, name=f"device-dispatch-{op}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            # Adopt the caller's span so dispatch/wait spans created inside
            # the device fn land in the caller's trace (the same cross-thread
            # seam the scheduler workers use).
            token = tracing.attach(job.parent_span)
            try:
                job.value = job.fn()
            except BaseException as e:  # noqa: BLE001 — marshalled to caller
                job.error = e
            finally:
                tracing.detach(token)
                job.done.set()
            if self.abandoned:
                return

    def submit(self, fn: Callable[[], Any]) -> _Job:
        job = _Job(fn, tracing.current_span())
        self._q.put(job)
        return job

    def stop(self) -> None:
        self.abandoned = True
        self._q.put(None)


# -------------------------------------------------------------- supervisor


class DeviceSupervisor:
    def __init__(self, config: Optional[BreakerConfig] = None,
                 deadlines: Optional[Dict[str, float]] = None):
        self._lock = TimeoutLock("device_supervisor", label="DeviceSupervisor._lock")
        self._config = config or BreakerConfig.from_env()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._workers: Dict[str, _OpWorker] = {}
        self._deadlines = dict(DEFAULT_DEADLINES)
        if deadlines:
            self._deadlines.update(deadlines)
        env_deadline = os.environ.get("LIGHTHOUSE_TPU_DISPATCH_DEADLINE_S")
        if env_deadline:
            self._default_deadline = float(env_deadline)
            for op in list(self._deadlines):
                self._deadlines[op] = float(env_deadline)
        else:
            self._default_deadline = DEFAULT_DEADLINE_S

    # ------------------------------------------------------------- config

    def configure(self, *, config: Optional[BreakerConfig] = None,
                  deadlines: Optional[Dict[str, float]] = None) -> None:
        """Re-tune (tests, admin tooling).  Existing breakers are rebuilt so
        new thresholds apply immediately."""
        cleared: List[str] = []
        with self._lock:
            if config is not None:
                self._config = config
                cleared = list(self._breakers)
                self._breakers.clear()
            if deadlines is not None:
                self._deadlines.update(deadlines)
        # A rebuilt breaker starts CLOSED; reset the gauge now rather than
        # leaving a stale OPEN reading until the op next dispatches.
        for op in cleared:
            metrics.DEVICE_BREAKER_STATE.set(STATE_CODES[STATE_CLOSED], op=op)

    def deadline_for(self, op: str) -> float:
        with self._lock:
            return self._deadlines.get(op, self._default_deadline)

    def breaker(self, op: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(op)
            if br is None:
                br = self._breakers[op] = CircuitBreaker(op, self._config)
            return br

    # ------------------------------------------------------------ plumbing

    def _worker(self, op: str) -> _OpWorker:
        with self._lock:
            w = self._workers.get(op)
            if w is None or w.abandoned:
                w = self._workers[op] = _OpWorker(op)
            return w

    def _dispatch(self, op: str, fn: Callable[[], Any],
                  deadline_s: float) -> Any:
        """Run ``fn`` under the watchdog; raise :class:`DispatchTimeout` on
        expiry (abandoning the worker), else return/raise ``fn``'s result."""
        if deadline_s <= 0:  # watchdog disabled: run inline
            return fn()
        worker = self._worker(op)
        job = worker.submit(fn)
        if not job.done.wait(deadline_s):
            worker.abandoned = True
            with self._lock:
                if self._workers.get(op) is worker:
                    del self._workers[op]
            metrics.DEVICE_DISPATCH_TIMEOUTS.inc(op=op)
            log.error("device dispatch watchdog fired",
                      op=op, deadline_s=deadline_s)
            blackbox.emit("watchdog", "timeout", op=op, deadline_s=deadline_s)
            blackbox.capture(f"dispatch_timeout:{op}")
            raise DispatchTimeout(op, deadline_s)
        if job.error is not None:
            raise job.error
        return job.value

    def _dispatch_meshed(self, op: str, fn: Callable[[], Any],
                         deadline_s: float, info: dict) -> Any:
        """The mesh-aware dispatch: while the device mesh is active, a
        failure (device error OR watchdog timeout) is charged to a mesh
        member (``device_mesh.note_failure`` — the one the error names,
        else the deterministic suspect).  A charge that trips that
        member's breaker re-shards the mesh over the survivors and the
        batch RETRIES on the new topology (``fn`` re-places its arrays
        against the new generation).  A failure that does not re-shard
        (threshold not reached, or the mesh off or exhausted) propagates
        into the split retry and the op breaker."""
        from . import device_mesh

        while True:
            meshed = device_mesh.enabled()
            try:
                result = self._dispatch(op, fn, deadline_s)
                if meshed:
                    # keep the per-member thresholds CONSECUTIVE: a clean
                    # dispatch clears every still-closed breaker's counter
                    device_mesh.note_success()
                return result
            except HostFallback:
                raise  # a disclaimer, not a device failure
            except DispatchTimeout as err:
                if meshed and device_mesh.note_failure(
                        "dispatch_timeout", err=err):
                    info["mesh_reshards"] = info.get("mesh_reshards", 0) + 1
                    log.warning("mesh resharded after dispatch timeout; "
                                "retrying batch", op=op,
                                survivors=device_mesh.size())
                    continue
                raise
            except Exception as err:  # noqa: BLE001 — charged + re-raised
                if meshed and device_mesh.note_failure(
                        "device_error", err=err):
                    info["mesh_reshards"] = info.get("mesh_reshards", 0) + 1
                    log.warning("mesh resharded after device error; "
                                "retrying batch", op=op,
                                error=f"{type(err).__name__}: {err}",
                                survivors=device_mesh.size())
                    continue
                raise

    def _emit(self, op: str, transitions: List[Tuple[str, str, str]]) -> None:
        """Metrics + SSE + log for breaker transitions (no locks held)."""
        for old, new, reason in transitions:
            metrics.DEVICE_BREAKER_STATE.set(STATE_CODES[new], op=op)
            metrics.DEVICE_BREAKER_TRANSITIONS.inc(op=op, to=new)
            log.warning("device breaker transition",
                        op=op, frm=old, to=new, reason=reason)
            blackbox.emit("breaker", "transition",
                          op=op, frm=old, to=new, reason=reason)
            payload = {
                "op": op,
                "from": old,
                "to": new,
                "reason": reason,
                "timestamp_ms": int(time.time() * 1000),
            }
            for bus in list(_EVENT_BUSES):
                try:
                    bus.device_breaker(**payload)
                except Exception:
                    pass  # a dead bus must never break the hot path
            if new == STATE_OPEN:
                # The trigger the black box exists for: freeze the journal
                # window (pre-trip context included) before the ring
                # evicts it.
                blackbox.capture(f"breaker_open:{op}",
                                 extra={"transition": payload})

    def _host(self, op: str, host_fn: Callable[[], Any], reason: str,
              info: dict) -> Any:
        """THE host-fallback path — every reason funnels through here, so
        ``device_batch_host_fallback_total{reason}`` is the one counter that
        tells the whole degradation story."""
        info["route"] = "host"
        info["fallback_reason"] = reason
        metrics.DEVICE_HOST_FALLBACK.inc(reason=reason)
        tracing.annotate(host_fallback=True, fallback_reason=reason)
        log.warning("device batch routed to host backend", op=op, reason=reason)
        blackbox.emit("supervisor", "host_fallback", op=op, reason=reason)
        t0 = time.perf_counter()
        try:
            return host_fn()
        finally:
            info["host_seconds"] = round(time.perf_counter() - t0, 6)

    # ----------------------------------------------------------- execution

    def run(
        self,
        op: str,
        device_fn: Callable[[], Any],
        host_fn: Optional[Callable[[], Any]] = None,
        *,
        split_fn: Optional[Callable[[], List[Callable[[], Any]]]] = None,
        combine_fn: Optional[Callable[[List[Any]], Any]] = None,
        deadline_s: Optional[float] = None,
        info: Optional[dict] = None,
        host_on_failure: bool = True,
    ) -> Any:
        """Execute one device batch under supervision.

        ``device_fn`` runs the dispatch + wait + verdict (on the watchdog
        worker); ``host_fn`` is the slow-but-correct fallback.  ``split_fn``
        returns per-half thunks for the one split-batch retry (each half
        still watchdogged); ``combine_fn`` merges the halves' results.
        ``info`` (if given) is filled with route/breaker/fallback details
        for the caller's flight-recorder entry.

        With ``host_fn=None`` failures propagate to the caller —
        :class:`DispatchTimeout` subclasses ``RequeueWork``, so inside a
        scheduler worker the work re-enqueues instead of dropping.
        ``host_on_failure=False`` propagates them too (a device error, a
        timeout, an OPEN breaker as ``RequeueWork``) while a
        :class:`HostFallback` disclaimer still resolves through
        ``host_fn``: the port's callers pass it when their tensors are on
        the card, so a failing card raises instead of answering from the
        host.
        """
        if info is None:
            info = {}
        if split_fn is not None and op in NO_SPLIT_OPS:
            log.warning("split_fn ignored for batch-global op", op=op)
            split_fn = None
        failure_host_fn = host_fn if host_on_failure else None
        br = self.breaker(op)
        route, transitions = br.route()
        self._emit(op, transitions)
        info["breaker_state"] = br.state
        if route == "host":
            if failure_host_fn is None:
                raise RequeueWork(f"{op}: breaker open and no host fallback for failures")
            return self._host(op, failure_host_fn, "breaker_open", info)
        deadline = self.deadline_for(op) if deadline_s is None else deadline_s

        try:
            result = self._dispatch_meshed(op, device_fn, deadline, info)
        except HostFallback as hf:
            # The device executed and disclaimed — not a device failure.
            self._emit(op, br.record_success())
            if host_fn is None:
                raise RuntimeError(
                    f"{op}: device disclaimed ({hf.reason}) and no host fallback"
                ) from hf
            return self._host(op, host_fn, hf.reason, info)
        except DispatchTimeout:
            self._emit(op, br.record_failure("dispatch_timeout"))
            info["breaker_state"] = br.state
            if failure_host_fn is None:
                raise
            return self._host(op, failure_host_fn, "dispatch_timeout", info)
        except Exception as err:
            # Transient device error: one split-batch retry, then host.
            if split_fn is not None:
                try:
                    halves = split_fn()
                    results = [
                        self._dispatch(op, thunk, deadline) for thunk in halves
                    ]
                    metrics.DEVICE_SPLIT_RETRIES.inc(op=op, outcome="success")
                    info["split_retry"] = "success"
                    info["route"] = "device"
                    tracing.annotate(split_retry=True)
                    self._emit(op, br.record_success())
                    return combine_fn(results) if combine_fn else results
                except HostFallback as hf:
                    # A half executed and disclaimed its verdict — the
                    # device is fine; re-verify on the host under the
                    # disclaimer's own reason, no breaker failure.
                    info["split_retry"] = "host_fallback"
                    self._emit(op, br.record_success())
                    if host_fn is None:
                        raise RuntimeError(
                            f"{op}: device disclaimed ({hf.reason}) "
                            "and no host fallback"
                        ) from hf
                    return self._host(op, host_fn, hf.reason, info)
                except DispatchTimeout:
                    # A half hung past the watchdog: label it what it is —
                    # a timeout, not a generic device error (the timeout
                    # counter already incremented for this op).
                    metrics.DEVICE_SPLIT_RETRIES.inc(op=op, outcome="failure")
                    info["split_retry"] = "failure"
                    self._emit(op, br.record_failure("dispatch_timeout"))
                    info["breaker_state"] = br.state
                    if failure_host_fn is None:
                        raise
                    return self._host(op, failure_host_fn, "dispatch_timeout", info)
                except Exception:
                    metrics.DEVICE_SPLIT_RETRIES.inc(op=op, outcome="failure")
                    info["split_retry"] = "failure"
            self._emit(op, br.record_failure("device_error"))
            info["breaker_state"] = br.state
            info["device_error"] = f"{type(err).__name__}: {err}"
            log.error("device batch failed", op=op,
                      error=f"{type(err).__name__}: {err}")
            if failure_host_fn is None:
                raise
            return self._host(op, failure_host_fn, "device_error", info)
        else:
            self._emit(op, br.record_success())
            info["route"] = "device"
            return result

    # ------------------------------------------------------------- surface

    def summary(self) -> dict:
        """The supervisor section of ``device_telemetry.summary()``."""
        with self._lock:
            breakers = list(self._breakers.values())
            deadlines = dict(self._deadlines)
        return {
            "breakers": [br.snapshot() for br in breakers],
            "deadlines_s": deadlines,
        }

    def reset_for_tests(self) -> None:
        with self._lock:
            cleared = list(self._breakers)
            self._breakers.clear()
            workers = list(self._workers.values())
            self._workers.clear()
            self._config = BreakerConfig.from_env()
            self._deadlines = dict(DEFAULT_DEADLINES)
        for w in workers:
            w.stop()
        for op in cleared:
            metrics.DEVICE_BREAKER_STATE.set(STATE_CODES[STATE_CLOSED], op=op)


SUPERVISOR = DeviceSupervisor()


def run(op: str, device_fn, host_fn=None, **kwargs) -> Any:
    return SUPERVISOR.run(op, device_fn, host_fn, **kwargs)


def summary() -> dict:
    return SUPERVISOR.summary()


def breaker_state(op: str) -> str:
    """Current breaker state for ``op`` (creates the breaker CLOSED on first
    ask) — the cheap probe the device pipeline's tests/scenarios use to
    assert breaker-open batches still resolve futures."""
    return SUPERVISOR.breaker(op).state


def reset_for_tests() -> None:
    set_cooldown_clock(None)
    SUPERVISOR.reset_for_tests()


# --------------------------------------------------------------- SSE wiring

# Breaker transitions publish to every live EventBus (weakly held: test
# harnesses build many chains per process; dead buses drop out on GC).
_EVENT_BUSES: "weakref.WeakSet" = weakref.WeakSet()


def register_event_bus(bus) -> None:
    """Publish breaker transitions to ``bus`` (any object with a
    ``device_breaker(**payload)`` method) as ``device_breaker`` events; the
    host node's event bus registers here."""
    _EVENT_BUSES.add(bus)
