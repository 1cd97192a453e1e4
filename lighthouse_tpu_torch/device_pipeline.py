"""Async device pipeline: a persistent device-worker queue between the
callers of ``verify_signature_sets`` and the card.

The port of ``lighthouse_tpu/device_pipeline.py``.  Without it every
caller of ``bls.verify_signature_sets`` — block import, a drained gossip
attestation batch, a sync-committee contribution — blocks its own thread
for the full build + dispatch + wait of its own batch, and many small,
launch-bound batches reach the card one by one.

Callers **submit** a group of ``SignatureSet``\\ s and receive a
:class:`VerifyFuture`; one long-lived pipeline per op owns the card and

- **coalesces** pending groups *across work types* into one batch up to
  its target, with a small linger window so a lone attestation never
  waits forever;
- **double-buffers** the host build against the device stage: a builder
  thread marshals batch N+1 (``ops/verify.py`` ``build_device_batch`` —
  validation, hash-to-curve, limb packing, upload) while the executor
  thread runs batch N, handing off through a depth-1 queue.  On the port
  both threads are Python holding the GIL (the build is pure-Python
  hash-to-G2, the device stage is Python issuing the eager program's
  launches), so the overlap is whatever the GIL leaves; each pipeline
  reports its builder-busy and executor-busy seconds;
- **dispatches through the device supervisor** (``device_supervisor.py``):
  watchdog, split-retry and circuit-breaker semantics are exactly those of
  the direct path — on the card a failed, hung or breaker-OPEN batch
  raises and every group's future gets the error (with ``device="cpu"``
  the host golden model decides and the futures resolve); a build stage
  that raises (an upload failing on the card) hands its error to the
  futures the same way;
- **attributes verdicts per group**: a passing batch resolves every group
  True; a failing (or host-disclaimed) batch re-checks each group once on
  the host golden model so only the actually-bad group fails — one host
  re-check per group, never per set.

The enrolment seam is ``crypto/bls/api.verify_signature_sets``.  The
caller enables the pipeline (:func:`enable`, naming its card); seedless
calls whose device is unset or the pipeline's own then ride it, while
calls that pin ``seed=`` (reproducibility), name another device, or
exceed the standard bucket keep the direct supervised path.  Routing
compares the caller's device with the device of the pipeline that would
take the call (the live one, read under the module lock), and
:func:`enable` naming another device retires the pipelines running on
the old one, so a call never runs on a device it did not ask for.

Beside the bls pipeline, :class:`HashPipeline` coalesces ``sha256_pairs``
pair-hash groups (``ops/tree_hash.py`` dirty-path batches) into one
dispatch of the supervised pair-hash op and slices the digests back per
group — 64-byte blocks are independent, so attribution is exact by
construction.  Both pipelines take the one slot of the shared
:class:`DeviceArbiter` around their device leg, so block import and
tree-hash traffic contend for the card in one visible place.  One rule
differs from the JAX package: where a hash batch fails past the
supervisor, the JAX package re-hashes every group on the host; on the
card the port hands the error to every group's future instead (with
``device="cpu"`` the host still re-hashes).  :class:`JobPipeline` runs
batch-global jobs (the epoch programs: registry-wide sums, nothing to
coalesce) FIFO under the same arbiter; the supervised call inside the job
keeps the direct path's failure rules.  The HTTP API's cache-miss
handlers take :func:`api_arbiter_slot`: a bounded acquire of the same
slot, a turnstile while the pipelines route.

**Adaptive linger**: unless pinned (env
``LIGHTHOUSE_TPU_PIPELINE_LINGER_S`` or an explicit ``linger_s``), the
effective linger follows the flight recorder's observed in-flight batch
duration (``device_telemetry.recent_inflight_seconds``).

Observability: ``device_pipeline_{pending_sets,depth,batch_fill_ratio,
linger_seconds,wait_seconds,batches_total,groups_total}`` metrics (by op;
the hash pipeline counts blocks where the bls one counts sets),
``device_arbiter_{wait_seconds,grants_total,api_timeouts_total}``, a ``pipeline_batch`` trace
root per coalesced dispatch, flight-recorder records carrying
``n_groups``/``work_mix``, and :func:`summary`.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from . import blackbox, locksmith, metrics, tracing
from .logs import get_logger
from .scheduler.work import STANDARD_DEVICE_BATCH

log = get_logger("device_pipeline")

#: Groups larger than this bypass the pipeline entirely (the direct path
#: chunks them through the standard bucket itself).  The scheduler's
#: standard device batch, clamped to the device's single-dispatch ceiling
#: (ops/verify.MAX_SETS_PER_DISPATCH == 4096 — kept as a literal here so
#: importing the pipeline never pulls torch, same convention as work.py):
#: a raised LIGHTHOUSE_TPU_STANDARD_BATCH must not let the pipeline build
#: batches the device entry point refuses.
MAX_GROUP_SETS = min(STANDARD_DEVICE_BATCH, 4096)

#: Default linger: how long the builder waits for more groups once the FIRST
#: pending group is older than this and the target bucket is not yet full.
#: Small on purpose — while a batch is in flight the pending queue fills for
#: free; the linger only bounds the latency of a lone set on an idle device.
DEFAULT_LINGER_S = float(os.environ.get("LIGHTHOUSE_TPU_PIPELINE_LINGER_S", "0.02"))

#: Default coalescing target (sets per dispatched batch).
DEFAULT_TARGET_SETS = int(
    os.environ.get("LIGHTHOUSE_TPU_PIPELINE_TARGET_SETS", str(STANDARD_DEVICE_BATCH))
)

#: Bounded ring of recent per-batch summaries for summary()/tests.
RECENT_BATCHES = 64

#: Hash groups larger than this many 64-byte blocks bypass the hash
#: pipeline (the direct supervised op buckets them itself).  The top
#: ``ops/sha256_device.N_BUCKETS`` bucket, kept as a literal so importing
#: the pipeline never pulls torch (same convention as MAX_GROUP_SETS).
MAX_HASH_GROUP_BLOCKS = 262144

#: Default coalescing target for the hash pipeline (blocks per dispatched
#: sha256_pairs batch).
DEFAULT_HASH_TARGET_BLOCKS = int(
    os.environ.get("LIGHTHOUSE_TPU_PIPELINE_HASH_TARGET_BLOCKS", "16384")
)

#: Adaptive linger clamps: the effective linger never exceeds the MAX (a
#: pathological in-flight observation must not park gossip for seconds) and
#: tracks ``FRACTION`` of the observed in-flight batch duration.
ADAPTIVE_LINGER_MAX_S = 0.25
ADAPTIVE_LINGER_FRACTION = 0.5

#: An explicit env linger pins every pipeline (the operator override the
#: adaptive default must never fight).
_LINGER_ENV_PINNED = "LIGHTHOUSE_TPU_PIPELINE_LINGER_S" in os.environ

# Injectable linger clock: how long a pending group has lingered is a
# control-path decision — a harness may run it on a virtual clock so batch
# cut points sit at virtual instants, not wall instants.
# Telemetry spans (pipeline_wait, batch linger observations) deliberately
# stay on ``submitted_pc``/``time.perf_counter``: an operator reading them
# wants real latency.
_linger_clock: Callable[[], float] = time.perf_counter


def set_linger_clock(fn: Optional[Callable[[], float]] = None) -> None:
    global _linger_clock
    # process-boundary: ok(clock seam: harness-only install, restored in _cleanup)
    _linger_clock = fn if fn is not None else time.perf_counter


def effective_linger(op: str, base_s: float, pinned: bool) -> float:
    """The linger actually applied to the next coalescing decision:
    ``base_s`` when pinned or unobserved, else ~half the flight recorder's
    median in-flight batch duration for ``op`` (clamped; never below the
    configured base — a fast device should not erase the floor)."""
    if pinned:
        return base_s
    from . import device_telemetry

    observed = device_telemetry.recent_inflight_seconds(op)
    if observed is None:
        return base_s
    return max(base_s, min(ADAPTIVE_LINGER_MAX_S,
                           observed * ADAPTIVE_LINGER_FRACTION))


# ------------------------------------------------------------- the arbiter


class DeviceArbiter:
    """THE device-access gate for pipelined dispatch: every pipeline
    (bls_verify batches, sha256_pairs hash batches) acquires one shared
    slot around its device leg, so concurrent work types *contend here* —
    visibly (``device_arbiter_wait_seconds{op}``) — instead of interleaving
    dispatches blindly.  Direct (non-pipelined) callers are deliberately
    not gated: the supervisor already serializes per-op dispatch through
    its worker."""

    def __init__(self) -> None:
        self._lock = locksmith.lock("DeviceArbiter._lock")
        self._stats = locksmith.lock("DeviceArbiter._stats")
        self._grants: Dict[str, int] = {}
        self._wait_s: Dict[str, float] = {}
        self._holder: Optional[str] = None

    @contextmanager
    def slot(self, op: str):
        t0 = time.perf_counter()
        with self._lock:
            wait = time.perf_counter() - t0
            with self._stats:
                self._grants[op] = self._grants.get(op, 0) + 1
                self._wait_s[op] = self._wait_s.get(op, 0.0) + wait
                self._holder = op
            metrics.DEVICE_ARBITER_WAIT_SECONDS.observe(wait, op=op)
            metrics.DEVICE_ARBITER_GRANTS.inc(op=op)
            try:
                yield
            finally:
                with self._stats:
                    self._holder = None

    @contextmanager
    def api_slot(self, op: str, timeout: float = 2.0, hold: bool = True):
        """Arbiter contention for a non-pipelined caller: the HTTP API's
        cache-miss state queries.  Differs from :meth:`slot` in two
        deliberate ways:

        - ``timeout``-bounded acquire: an API thread that cannot get the
          slot proceeds UNGATED (counted on
          ``device_arbiter_api_timeouts_total``) instead of deadlocking —
          a read query is never worth wedging the serving thread pool.
        - ``hold=False`` runs the body AFTER releasing the slot (a
          turnstile): the caller waits its turn behind in-flight device
          dispatch, but does not exclude the pipelines while its own body
          runs.  Required whenever the body may submit pipeline jobs
          (``run_job`` legs acquire the slot from the pipeline worker —
          holding here while waiting on their futures is a deadlock)."""
        t0 = time.perf_counter()
        acquired = self._lock.acquire(timeout=timeout)
        wait = time.perf_counter() - t0
        if not acquired:
            metrics.DEVICE_ARBITER_API_TIMEOUTS.inc(op=op)
            yield
            return
        with self._stats:
            self._grants[op] = self._grants.get(op, 0) + 1
            self._wait_s[op] = self._wait_s.get(op, 0.0) + wait
            self._holder = op
        metrics.DEVICE_ARBITER_WAIT_SECONDS.observe(wait, op=op)
        metrics.DEVICE_ARBITER_GRANTS.inc(op=op)
        if not hold:
            with self._stats:
                self._holder = None
            self._lock.release()
            yield
            return
        try:
            yield
        finally:
            with self._stats:
                self._holder = None
            self._lock.release()

    def snapshot(self) -> dict:
        with self._stats:
            return {
                "holding": self._holder,
                "grants": dict(self._grants),
                "wait_s": {k: round(v, 6) for k, v in self._wait_s.items()},
            }

    def reset_for_tests(self) -> None:
        with self._stats:
            self._grants.clear()
            self._wait_s.clear()
            self._holder = None


ARBITER = DeviceArbiter()


def _on_card(device) -> bool:
    """True when ``device`` names a CUDA card (torch imported lazily)."""
    import torch

    return torch.device(device).type == "cuda"


_WORK_KIND: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "lighthouse_tpu_pipeline_work_kind", default=None
)


@contextmanager
def work_context(kind: str):
    """Tag pipeline submissions made inside this context with ``kind`` (the
    ``work_mix`` attribution on coalesced batches)."""
    token = _WORK_KIND.set(kind)
    try:
        yield
    finally:
        _WORK_KIND.reset(token)


def current_work_kind() -> str:
    return _WORK_KIND.get() or "other"


class PipelineShutdown(RuntimeError):
    """The pipeline was shut down without draining this group."""


class _FutureBase:
    """Resolution handle for one submitted unit of pipeline work: the one
    Event/result/error pattern both pipelines share (verify groups and
    hash groups differ only in payload fields and result type)."""

    __slots__ = ("_done", "_result", "_error", "submitted_pc",
                 "submitted_lc", "work")

    #: result(timeout) message on expiry; subclasses name their unit.
    _timeout_msg = "pipeline result not available in time"

    def __init__(self, work: str):
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        # submitted_pc: real perf_counter, telemetry spans only.
        # submitted_lc: the linger clock's reading, the coalescing
        # decision's time base (virtual during scenarios).
        self.submitted_pc = time.perf_counter()
        self.submitted_lc = _linger_clock()
        self.work = work

    def done(self) -> bool:
        return self._done.is_set()

    def set_result(self, value) -> None:
        self._result = value
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolution; raises the pipeline's error if the work
        failed outside the op's own semantics (a build or device error)."""
        if not self._done.wait(timeout):
            raise TimeoutError(self._timeout_msg)
        if self._error is not None:
            raise self._error
        return self._result


class VerifyFuture(_FutureBase):
    """Resolution handle for one submitted group (bool verdict out)."""

    __slots__ = ("n_sets",)
    _timeout_msg = "pipeline verdict not available in time"

    def __init__(self, work: str, n_sets: int):
        super().__init__(work)
        self.n_sets = n_sets

    def set_result(self, value) -> None:
        super().set_result(bool(value))

    def result(self, timeout: Optional[float] = None) -> bool:
        return bool(super().result(timeout))


class _Group:
    __slots__ = ("sets", "future")

    def __init__(self, sets: list, future: VerifyFuture):
        self.sets = sets
        self.future = future


class _BuiltBatch:
    """One coalesced batch on its way to the executor."""

    __slots__ = ("groups", "flat_sets", "built", "unbuilt", "error",
                 "linger_s", "build_s", "work_mix")

    def __init__(self, groups: List[_Group], flat_sets: list, built,
                 unbuilt: bool, error: Optional[BaseException],
                 linger_s: float, build_s: float, work_mix: Dict[str, int]):
        self.groups = groups
        self.flat_sets = flat_sets
        self.built = built          # ops.verify.BuiltBatch | None (host modes)
        #: device mode only: host-side validation decided False before any
        #: upload, so no device batch exists — the batch verdict says only
        #: that SOME group is bad, so EVERY group (even a lone one) resolves
        #: via its own host re-check.
        self.unbuilt = unbuilt
        #: the build stage raised (an upload that failed on the card, an
        #: unexpected host error): every group's future gets this error —
        #: a failed build is neither a verdict nor answered by the host.
        self.error = error
        self.linger_s = linger_s
        self.build_s = build_s
        self.work_mix = work_mix


class DevicePipeline:
    """One persistent device-worker pipeline for one op (``bls_verify``).

    ``device``: the card the torch backend's batches run on (``"cuda"`` by
    default; ``"cpu"`` runs the kernels' plain versions).
    ``verify_flat_fn``: test seam — replaces the whole batch-execution leg
    (called with the flat set list, returns the combined verdict).
    ``recheck_fn``: test seam — replaces the per-group host re-check.
    """

    def __init__(self, op: str = "bls_verify", *,
                 device="cuda",
                 target_sets: Optional[int] = None,
                 linger_s: Optional[float] = None,
                 verify_flat_fn=None, recheck_fn=None):
        self.op = op
        self.device = device
        # clamped to the single-dispatch ceiling: one coalesced batch must
        # stay buildable by ops/verify.build_device_batch
        self.target_sets = max(1, min(int(target_sets or DEFAULT_TARGET_SETS),
                                      MAX_GROUP_SETS))
        # an explicit linger (ctor arg, later assignment, or the env var)
        # PINS the value; otherwise the effective linger adapts to the
        # observed in-flight batch duration (see effective_linger)
        self._linger_pinned = linger_s is not None or _LINGER_ENV_PINNED
        self._linger_s = (DEFAULT_LINGER_S if linger_s is None
                          else float(linger_s))
        self._verify_flat_fn = verify_flat_fn
        self._recheck_fn = recheck_fn
        self._cond = locksmith.condition("DevicePipeline._cond")
        self._pending: deque = deque()          # _Group FIFO
        self._pending_sets = 0
        self._in_flight_groups = 0              # taken but not yet resolved
        self._shutdown = False
        self._idle = threading.Event()
        self._idle.set()
        # depth-1 handoff: the double buffer.  The builder blocks here while
        # the executor still owns the previous batch, which is exactly when
        # the pending queue should keep filling.
        self._built_q: "queue.Queue[Optional[_BuiltBatch]]" = queue.Queue(maxsize=1)
        self._recent: deque = deque(maxlen=RECENT_BATCHES)
        self.batches_total = 0
        self.groups_total = 0
        self.sets_total = 0
        # seconds each thread spent on its stage (taking a batch off the
        # queue and waiting on the handoff excluded): their sum over the
        # wall time of a busy stretch says how much of the two stages the
        # GIL let overlap
        self.builder_busy_s = 0.0
        self.executor_busy_s = 0.0
        self._builder = threading.Thread(
            target=self._build_loop, name=f"device-pipeline-build-{op}", daemon=True
        )
        self._executor = threading.Thread(
            target=self._execute_loop, name=f"device-pipeline-exec-{op}", daemon=True
        )
        self._builder.start()
        self._executor.start()

    # ------------------------------------------------------------- ingress

    def submit(self, sets, work: Optional[str] = None,
               ) -> VerifyFuture:
        """Queue one group; returns its future.  Raises
        :class:`PipelineShutdown` after :meth:`shutdown`."""
        sets = list(sets)
        work = work or current_work_kind()
        fut = VerifyFuture(work, len(sets))
        if not sets:
            fut.set_result(False)  # empty batch fails (host-backend parity)
            return fut
        with self._cond:
            if self._shutdown:
                raise PipelineShutdown(f"{self.op}: pipeline is shut down")
            self._pending.append(_Group(sets, fut))
            self._pending_sets += len(sets)
            self.groups_total += 1
            self.sets_total += len(sets)
            self._idle.clear()
            metrics.DEVICE_PIPELINE_PENDING_SETS.set(self._pending_sets, op=self.op)
            metrics.DEVICE_PIPELINE_DEPTH.set(
                len(self._pending) + self._in_flight_groups, op=self.op)
            self._cond.notify_all()
        metrics.DEVICE_PIPELINE_GROUPS.inc(op=self.op, work=work)
        # submit marker in the caller's trace: the submit→resolve interval is
        # recorded by verify() as the pipeline_wait span.
        tracing.annotate(pipeline_submitted=True, pipeline_work=work)
        return fut

    def verify(self, sets, work: Optional[str] = None) -> bool:
        """Submit + block on the verdict (the drop-in form the bls api seam
        uses).  The caller's thread waits on a cheap event — never inside
        ``block_until_ready``."""
        fut = self.submit(sets, work=work)
        try:
            ok = fut.result()
        finally:
            tracing.record_span(
                "pipeline_wait", start_pc=fut.submitted_pc,
                hist=metrics.DEVICE_PIPELINE_WAIT_SECONDS,
                hist_labels={"op": self.op},
                n_sets=fut.n_sets, work=fut.work,
            )
        return ok

    # ------------------------------------------------------------- builder

    @property
    def linger_s(self) -> float:
        return self._linger_s

    @linger_s.setter
    def linger_s(self, value: float) -> None:
        # assigning a linger anywhere (tests, scenarios, bench) pins it —
        # the adaptive default must never fight an explicit choice
        self._linger_s = float(value)
        self._linger_pinned = True

    def _effective_linger(self) -> float:
        return effective_linger(self.op, self._linger_s, self._linger_pinned)

    def _effective_target(self) -> int:
        """The coalescing target scaled to the CURRENT mesh: a mesh shrunk
        by per-device breaker trips fills proportionally fewer lanes, so
        waiting for the full-strength target would only add linger latency
        (identity when the mesh is off or at full strength)."""
        from . import device_mesh

        return device_mesh.scale_target(self.target_sets)

    def _take_batch(self) -> Optional[List[_Group]]:
        """Block until a batch is worth dispatching (target fill reached, the
        oldest group's linger expired, or shutdown-drain); pop and return it.
        Returns None only when shut down AND drained."""
        with self._cond:
            # sampled once per take, at the moment the first group is seen:
            # the adaptive signal only moves when a batch completes, so
            # recomputing it (a flight-recorder scan) on every 50ms
            # wait-loop wake under the lock is wasted work — but sampling
            # at take ENTRY would bake a pre-pin value into a worker that
            # was already parked on an empty queue when a test/scenario
            # assigned linger_s
            linger = None
            frozen = 0
            while True:
                target = self._effective_target()
                if self._pending:
                    if self._shutdown or self._pending_sets >= target:
                        break
                    if linger is None:
                        linger = self._effective_linger()
                    now_lc = _linger_clock()
                    oldest = self._pending[0].future.submitted_lc
                    remaining = linger - (now_lc - oldest)
                    # a reading BEHIND the stamp means the group straddled
                    # a clock install/restore: dispatch rather than trust
                    # cross-clock arithmetic
                    if remaining <= 0 or now_lc < oldest:
                        break
                    # Stall-breaker: a linger clock frozen across
                    # consecutive waits means the thread that advances it
                    # (a virtual clock's runner) is blocked on one of OUR
                    # futures — dispatch now instead of deadlocking.  A
                    # wall clock always advances, so production coalescing
                    # is untouched.
                    if frozen >= 2:
                        break
                    self._cond.wait(timeout=min(remaining, 0.05))
                    frozen = frozen + 1 if _linger_clock() == now_lc else 0
                elif self._shutdown:
                    return None
                else:
                    self._cond.wait(timeout=0.1)
            groups: List[_Group] = []
            n_sets = 0
            while self._pending:
                g = self._pending[0]
                if groups and n_sets + len(g.sets) > target:
                    break
                self._pending.popleft()
                groups.append(g)
                n_sets += len(g.sets)
            self._pending_sets -= n_sets
            self._in_flight_groups += len(groups)
            metrics.DEVICE_PIPELINE_PENDING_SETS.set(self._pending_sets, op=self.op)
            return groups

    def _build_loop(self) -> None:
        while True:
            try:
                groups = self._take_batch()
            except Exception:
                log.error("pipeline builder take failed", exc_info=True)
                continue
            if groups is None:
                self._built_q.put(None)  # drained: wake + stop the executor
                return
            oldest = min(g.future.submitted_pc for g in groups)
            linger = max(0.0, time.perf_counter() - oldest)
            flat = [s for g in groups for s in g.sets]
            work_mix: Dict[str, int] = {}
            for g in groups:
                work_mix[g.future.work] = work_mix.get(g.future.work, 0) + len(g.sets)
            built = None
            unbuilt = False
            error = None
            t0 = time.perf_counter()
            if self._device_mode():
                try:
                    with tracing.span("pipeline_build", n_sets=len(flat),
                                      n_groups=len(groups)):
                        from .ops import verify as verify_mod

                        built = verify_mod.build_device_batch(
                            flat, device=self.device)
                    unbuilt = built is None
                except Exception as err:  # noqa: BLE001 — marshalled to futures
                    # The build raised (device OOM or a CUDA error mid-upload,
                    # ...): the executor hands the error to every group's
                    # future — never a host verdict, never "bad signature".
                    log.error("pipeline batch build failed", op=self.op,
                              error=f"{type(err).__name__}: {err}")
                    error = err
            build_s = time.perf_counter() - t0
            self.builder_busy_s += build_s
            self._built_q.put(_BuiltBatch(
                groups, flat, built, unbuilt, error, linger, build_s, work_mix,
            ))

    # ------------------------------------------------------------ executor

    def _device_mode(self) -> bool:
        """True when the batch should run the staged device path (torch
        backend); host/fake backends run their own verify over the flat
        batch instead — same coalescing, no device."""
        if self._verify_flat_fn is not None:
            return False
        from .crypto.bls.backends import backend_name

        return backend_name() == "torch"

    def _verify_flat(self, batch: _BuiltBatch) -> bool:
        if self._verify_flat_fn is not None:
            return bool(self._verify_flat_fn(batch.flat_sets))
        from .crypto.bls.backends import backend_name, get_backend

        if backend_name() == "torch":
            from .ops import verify as verify_mod

            # unbuilt batches never reach here (_execute_one re-checks
            # every group on the host instead)
            return verify_mod.execute_built_batch(
                batch.built, n_groups=len(batch.groups), work_mix=batch.work_mix
            )
        return bool(get_backend().verify_signature_sets(batch.flat_sets))

    def _recheck_group(self, sets: list) -> bool:
        """ONE host re-check per group — the per-group verdict attribution
        on a failed coalesced batch."""
        if self._recheck_fn is not None:
            return bool(self._recheck_fn(sets))
        from .crypto.bls.backends import backend_name

        if backend_name() == "fake":
            from .crypto.bls.backends import fake

            return bool(fake.verify_signature_sets(sets))
        from .crypto.bls.backends import host

        return bool(host.verify_signature_sets(sets))

    def _execute_loop(self) -> None:
        while True:
            batch = self._built_q.get()
            if batch is None:
                with self._cond:
                    if not self._pending and self._in_flight_groups == 0:
                        self._idle.set()
                return
            t0 = time.perf_counter()
            try:
                self._execute_one(batch)
            except Exception as err:  # noqa: BLE001 — marshalled to futures
                log.error("pipeline batch execution failed",
                          op=self.op, error=f"{type(err).__name__}: {err}")
                for g in batch.groups:
                    g.future.set_error(err)
            finally:
                self.executor_busy_s += time.perf_counter() - t0
                with self._cond:
                    self._in_flight_groups -= len(batch.groups)
                    metrics.DEVICE_PIPELINE_DEPTH.set(
                        len(self._pending) + self._in_flight_groups, op=self.op)
                    if (not self._pending and self._in_flight_groups == 0
                            and self._built_q.empty()):
                        self._idle.set()
                    self._cond.notify_all()

    def _execute_one(self, batch: _BuiltBatch) -> None:
        if batch.error is not None:
            raise batch.error  # _execute_loop sets it on every group's future
        n_sets = len(batch.flat_sets)
        fill = min(1.0, n_sets / self.target_sets)
        metrics.DEVICE_PIPELINE_BATCHES.inc(op=self.op)
        metrics.DEVICE_PIPELINE_BATCH_FILL_RATIO.observe(fill, op=self.op)
        metrics.DEVICE_PIPELINE_LINGER_SECONDS.observe(batch.linger_s, op=self.op)
        with tracing.span(
            "pipeline_batch", op=self.op, n_sets=n_sets,
            n_groups=len(batch.groups), fill_ratio=round(fill, 4),
            linger_s=round(batch.linger_s, 6), work_mix=dict(batch.work_mix),
        ):
            rechecked = 0
            if batch.unbuilt:
                # No device batch exists (host-side validation said False):
                # EVERY group — lone ones included — gets its own host
                # re-check, so only the bad group fails.
                tracing.annotate(group_recheck=True, unbuilt=True)
                verdict = True
                for g in batch.groups:
                    rechecked += 1
                    ok = self._recheck_group(g.sets)
                    verdict = verdict and ok
                    g.future.set_result(ok)
            else:
                # the one shared device slot: bls batches contend with hash
                # pipeline traffic here
                with ARBITER.slot(self.op):
                    verdict = self._verify_flat(batch)
                if verdict:
                    for g in batch.groups:
                        g.future.set_result(True)
                elif len(batch.groups) == 1:
                    # a single-group batch IS its own attribution
                    batch.groups[0].future.set_result(False)
                else:
                    tracing.annotate(group_recheck=True)
                    for g in batch.groups:
                        rechecked += 1
                        g.future.set_result(self._recheck_group(g.sets))
        self.batches_total += 1
        self._recent.append({
            "t_ms": int(time.time() * 1000),
            "n_sets": n_sets,
            "n_groups": len(batch.groups),
            "fill_ratio": round(fill, 4),
            "linger_s": round(batch.linger_s, 6),
            "build_s": round(batch.build_s, 6),
            "work_mix": dict(batch.work_mix),
            "verdict": bool(verdict),
            "group_rechecks": rechecked,
        })
        blackbox.emit("pipeline", "batch", op=self.op, n_sets=n_sets,
                      n_groups=len(batch.groups), verdict=bool(verdict),
                      group_rechecks=rechecked or None,
                      unbuilt=bool(batch.unbuilt) or None)

    # ------------------------------------------------------------- control

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no group is pending or in flight."""
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain: pending groups still execute (possibly as smaller final
        batches) and every future resolves; then both threads exit."""
        with self._cond:
            if self._shutdown:
                return
            self._shutdown = True
            self._cond.notify_all()
        self._builder.join(timeout=timeout)
        self._executor.join(timeout=timeout)
        # anything still unresolved (thread died / join timed out) must not
        # hang callers forever
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
            self._pending_sets = 0
        for g in leftovers:
            if not g.future.done():
                g.future.set_error(PipelineShutdown(
                    f"{self.op}: pipeline shut down before this group ran"))

    def snapshot(self) -> dict:
        with self._cond:
            pending_groups = len(self._pending)
            pending_sets = self._pending_sets
            in_flight = self._in_flight_groups
        return {
            "op": self.op,
            "target_sets": self.target_sets,
            # identical to target_sets unless the device mesh is degraded
            # (device_mesh.scale_target shrinks the fill target with it)
            "effective_target_sets": self._effective_target(),
            "linger_s": self._linger_s,
            # the linger actually applied to the next take: adaptive
            # (flight-recorder in-flight median) unless pinned
            "effective_linger_s": round(self._effective_linger(), 6),
            "linger_adaptive": not self._linger_pinned,
            "pending_groups": pending_groups,
            "pending_sets": pending_sets,
            "in_flight_groups": in_flight,
            "batches_total": self.batches_total,
            "groups_total": self.groups_total,
            "sets_total": self.sets_total,
            "builder_busy_s": round(self.builder_busy_s, 6),
            "executor_busy_s": round(self.executor_busy_s, 6),
            "recent_batches": list(self._recent),
        }


# ------------------------------------------------------------ hash pipeline


class HashFuture(_FutureBase):
    """Resolution handle for one submitted pair-hash group (bytes out)."""

    __slots__ = ("n_blocks",)
    _timeout_msg = "pipeline hash result not available in time"

    def __init__(self, work: str, n_blocks: int):
        super().__init__(work)
        self.n_blocks = n_blocks


class _HashGroup:
    __slots__ = ("data", "future")

    def __init__(self, data: bytes, future: HashFuture):
        self.data = data
        self.future = future


class HashPipeline:
    """One persistent pipeline for ``sha256_pairs`` pair-hash traffic.

    Groups are byte buffers of independent 64-byte blocks (Merkle pair
    batches from ``ops/tree_hash.py``), so coalescing is concatenation and
    per-group result attribution is an exact slice of the output digests —
    no re-check pass exists because none is needed.  The single worker
    dispatches the joined batch through the SUPERVISED direct op
    (``sha256_device.hash_pairs_device`` on ``device`` — watchdog,
    split-retry, breaker) under the shared :data:`ARBITER` slot.  A failure
    that escapes the supervisor reaches every group's future as an error
    on the card (a failing card never answers from the host); with
    ``device="cpu"`` each group is re-hashed on the host kernel instead,
    as in the JAX package, so one poisoned group cannot corrupt another's
    digest.

    ``hash_flat_fn``: test seam — replaces the supervised device leg.
    """

    def __init__(self, *, device="cuda", target_blocks: Optional[int] = None,
                 linger_s: Optional[float] = None, hash_flat_fn=None):
        self.op = "sha256_pairs"
        self.device = device
        self.target_blocks = max(1, min(
            int(target_blocks or DEFAULT_HASH_TARGET_BLOCKS),
            MAX_HASH_GROUP_BLOCKS))
        self._linger_pinned = linger_s is not None or _LINGER_ENV_PINNED
        self._linger_s = (DEFAULT_LINGER_S if linger_s is None
                          else float(linger_s))
        self._hash_flat_fn = hash_flat_fn
        self._cond = locksmith.condition("HashPipeline._cond")
        self._pending: deque = deque()          # _HashGroup FIFO
        self._pending_blocks = 0
        self._in_flight_groups = 0
        self._shutdown = False
        self._idle = threading.Event()
        self._idle.set()
        self._recent: deque = deque(maxlen=RECENT_BATCHES)
        self.batches_total = 0
        self.groups_total = 0
        self.blocks_total = 0
        self._worker = threading.Thread(
            target=self._run_loop, name="device-pipeline-hash", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- ingress

    @property
    def linger_s(self) -> float:
        return self._linger_s

    @linger_s.setter
    def linger_s(self, value: float) -> None:
        self._linger_s = float(value)
        self._linger_pinned = True

    def _effective_linger(self) -> float:
        return effective_linger(self.op, self._linger_s, self._linger_pinned)

    def submit(self, data: bytes, work: Optional[str] = None) -> HashFuture:
        """Queue one pair-hash group (``len(data)`` a multiple of 64);
        returns its future.  Raises :class:`PipelineShutdown` after
        :meth:`shutdown`."""
        n_blocks = len(data) // 64
        if len(data) % 64:
            raise ValueError("hash group must be a multiple of 64 bytes")
        work = work or current_work_kind()
        fut = HashFuture(work, n_blocks)
        if n_blocks == 0:
            fut.set_result(b"")
            return fut
        with self._cond:
            if self._shutdown:
                raise PipelineShutdown("sha256_pairs: pipeline is shut down")
            self._pending.append(_HashGroup(data, fut))
            self._pending_blocks += n_blocks
            self.groups_total += 1
            self.blocks_total += n_blocks
            self._idle.clear()
            metrics.DEVICE_PIPELINE_PENDING_SETS.set(
                self._pending_blocks, op=self.op)
            metrics.DEVICE_PIPELINE_DEPTH.set(
                len(self._pending) + self._in_flight_groups, op=self.op)
            self._cond.notify_all()
        metrics.DEVICE_PIPELINE_GROUPS.inc(op=self.op, work=work)
        return fut

    # -------------------------------------------------------------- worker

    def _take_batch(self) -> Optional[List[_HashGroup]]:
        with self._cond:
            # sampled once per take, at first-group observation — same
            # rationale as DevicePipeline._take_batch
            linger = None
            frozen = 0
            while True:
                if self._pending:
                    if (self._shutdown
                            or self._pending_blocks >= self.target_blocks):
                        break
                    if linger is None:
                        linger = self._effective_linger()
                    now_lc = _linger_clock()
                    oldest = self._pending[0].future.submitted_lc
                    remaining = linger - (now_lc - oldest)
                    # clock-straddle + stall-breaker — see
                    # DevicePipeline._take_batch
                    if remaining <= 0 or now_lc < oldest:
                        break
                    if frozen >= 2:
                        break
                    self._cond.wait(timeout=min(remaining, 0.05))
                    frozen = frozen + 1 if _linger_clock() == now_lc else 0
                elif self._shutdown:
                    return None
                else:
                    self._cond.wait(timeout=0.1)
            groups: List[_HashGroup] = []
            n_blocks = 0
            while self._pending:
                g = self._pending[0]
                if groups and n_blocks + g.future.n_blocks > self.target_blocks:
                    break
                self._pending.popleft()
                groups.append(g)
                n_blocks += g.future.n_blocks
            self._pending_blocks -= n_blocks
            self._in_flight_groups += len(groups)
            metrics.DEVICE_PIPELINE_PENDING_SETS.set(
                self._pending_blocks, op=self.op)
            return groups

    def _hash_flat(self, data: bytes) -> bytes:
        if self._hash_flat_fn is not None:
            return self._hash_flat_fn(data)
        from .ops.sha256_device import hash_pairs_device

        return hash_pairs_device(data, device=self.device)

    def _run_loop(self) -> None:
        while True:
            try:
                groups = self._take_batch()
            except Exception:
                log.error("hash pipeline take failed", exc_info=True)
                continue
            if groups is None:
                with self._cond:
                    if not self._pending and self._in_flight_groups == 0:
                        self._idle.set()
                return
            try:
                self._execute_one(groups)
            finally:
                with self._cond:
                    self._in_flight_groups -= len(groups)
                    metrics.DEVICE_PIPELINE_DEPTH.set(
                        len(self._pending) + self._in_flight_groups,
                        op=self.op)
                    if not self._pending and self._in_flight_groups == 0:
                        self._idle.set()
                    self._cond.notify_all()

    def _execute_one(self, groups: List[_HashGroup]) -> None:
        oldest = min(g.future.submitted_pc for g in groups)
        linger = max(0.0, time.perf_counter() - oldest)
        n_blocks = sum(g.future.n_blocks for g in groups)
        fill = min(1.0, n_blocks / self.target_blocks)
        work_mix: Dict[str, int] = {}
        for g in groups:
            work_mix[g.future.work] = (
                work_mix.get(g.future.work, 0) + g.future.n_blocks)
        metrics.DEVICE_PIPELINE_BATCHES.inc(op=self.op)
        metrics.DEVICE_PIPELINE_BATCH_FILL_RATIO.observe(fill, op=self.op)
        metrics.DEVICE_PIPELINE_LINGER_SECONDS.observe(linger, op=self.op)
        rehashed = 0
        failed = 0
        with tracing.span(
            "pipeline_batch", op=self.op, n_blocks=n_blocks,
            n_groups=len(groups), fill_ratio=round(fill, 4),
            linger_s=round(linger, 6), work_mix=dict(work_mix),
        ):
            try:
                joined = b"".join(g.data for g in groups)
                with ARBITER.slot(self.op):
                    out = self._hash_flat(joined)
                offset = 0
                for g in groups:
                    size = g.future.n_blocks * 32
                    g.future.set_result(out[offset: offset + size])
                    offset += size
            except Exception as err:  # noqa: BLE001 — marshalled to futures
                if _on_card(self.device):
                    # The card failed past the supervisor (a raised device
                    # error, a watchdog timeout, an OPEN breaker): every
                    # group's caller gets the error, never a host digest.
                    log.error("hash pipeline batch failed on the card",
                              error=f"{type(err).__name__}: {err}")
                    tracing.annotate(group_error=True)
                    for g in groups:
                        failed += 1
                        g.future.set_error(err)
                else:
                    # CPU runs keep the JAX package's per-group host rescue,
                    # so one poisoned buffer cannot corrupt the others.
                    log.error("hash pipeline batch failed; groups re-hash on "
                              "the host kernel",
                              error=f"{type(err).__name__}: {err}")
                    tracing.annotate(group_rehash=True)
                    from .ops.sha256_device import _host_hash_pairs

                    for g in groups:
                        rehashed += 1
                        try:
                            g.future.set_result(_host_hash_pairs(g.data))
                        except Exception as host_err:  # noqa: BLE001
                            g.future.set_error(host_err)
        self.batches_total += 1
        self._recent.append({
            "t_ms": int(time.time() * 1000),
            "n_blocks": n_blocks,
            "n_groups": len(groups),
            "fill_ratio": round(fill, 4),
            "linger_s": round(linger, 6),
            "work_mix": dict(work_mix),
            "group_rehashes": rehashed,
            "group_errors": failed,
        })
        blackbox.emit("pipeline", "batch", op=self.op, n_blocks=n_blocks,
                      n_groups=len(groups),
                      group_rehashes=rehashed or None,
                      group_errors=failed or None)

    # ------------------------------------------------------------- control

    def wait_idle(self, timeout: float = 10.0) -> bool:
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._shutdown = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
            self._pending_blocks = 0
        for g in leftovers:
            if not g.future.done():
                g.future.set_error(PipelineShutdown(
                    "sha256_pairs: pipeline shut down before this group ran"))

    def snapshot(self) -> dict:
        with self._cond:
            pending_groups = len(self._pending)
            pending_blocks = self._pending_blocks
            in_flight = self._in_flight_groups
        return {
            "op": self.op,
            "target_blocks": self.target_blocks,
            "linger_s": self._linger_s,
            "effective_linger_s": round(self._effective_linger(), 6),
            "linger_adaptive": not self._linger_pinned,
            "pending_groups": pending_groups,
            "pending_blocks": pending_blocks,
            "in_flight_groups": in_flight,
            "batches_total": self.batches_total,
            "groups_total": self.groups_total,
            "blocks_total": self.blocks_total,
            "recent_batches": list(self._recent),
        }


# ------------------------------------------------------------- job pipeline


class JobFuture(_FutureBase):
    """Resolution handle for one pipelined device job (arbitrary result)."""

    __slots__ = ()
    _timeout_msg = "pipeline job result not available in time"


class JobPipeline:
    """FIFO pipeline for batch-global device jobs (the epoch ops) on one
    device.

    An epoch transition is one registry-wide dispatch — its sums span the
    whole batch (``device_supervisor.NO_SPLIT_OPS``), so there is nothing
    to coalesce; what enrolment buys is the ARBITER: an epoch boundary
    queues for the same device slot block import and tree-hash traffic use,
    instead of dispatching into their middle.  The submitted thunk is the
    caller's full supervised call (watchdog, breaker and failure rules run
    inside it), so results and errors are exactly the direct path's."""

    def __init__(self, op: str, device="cuda"):
        self.op = op
        self.device = device
        self._q: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
        self._shutdown = False
        self._pending = 0
        self._lock = locksmith.lock("JobPipeline._lock")
        self.jobs_total = 0
        self._worker = threading.Thread(
            target=self._run_loop, name=f"device-pipeline-job-{op}",
            daemon=True)
        self._worker.start()

    def submit(self, fn, work: Optional[str] = None) -> JobFuture:
        work = work or current_work_kind()
        fut = JobFuture(work)
        with self._lock:
            if self._shutdown:
                raise PipelineShutdown(f"{self.op}: pipeline is shut down")
            self._pending += 1
            self.jobs_total += 1
            # enqueue under the lock (SimpleQueue.put never blocks): a job
            # can then never land BEHIND shutdown's poison pill, which sets
            # _shutdown under this same lock before putting None
            self._q.put((fn, fut))
        metrics.DEVICE_PIPELINE_GROUPS.inc(op=self.op, work=work)
        metrics.DEVICE_PIPELINE_DEPTH.set(self._pending, op=self.op)
        return fut

    def _run_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                with ARBITER.slot(self.op):
                    fut.set_result(fn())
            except BaseException as err:  # noqa: BLE001 — marshalled
                fut.set_error(err)
            finally:
                with self._lock:
                    self._pending -= 1
                metrics.DEVICE_PIPELINE_DEPTH.set(self._pending, op=self.op)
                metrics.DEVICE_PIPELINE_BATCHES.inc(op=self.op)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._q.put(None)
        self._worker.join(timeout=timeout)
        # The lock-ordered put above guarantees every accepted job precedes
        # the poison pill, so a clean worker exit leaves nothing behind;
        # this sweep only matters if the join TIMED OUT on a hung worker —
        # resolve whatever it abandoned so no caller blocks forever.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                # leave the pill in place: a worker stuck past the join
                # timeout may yet unstick, and swallowing its exit signal
                # would park that thread on _q.get() forever
                self._q.put(None)
                break
            _, fut = item
            with self._lock:
                self._pending -= 1
            if not fut.done():
                fut.set_error(PipelineShutdown(
                    f"{self.op}: pipeline shut down before this job ran"))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "op": self.op,
                "device": str(self.device),
                "pending_jobs": self._pending,
                "jobs_total": self.jobs_total,
            }


# ----------------------------------------------------------- module wiring

_LOCK = locksmith.lock("device_pipeline._LOCK")
_PIPELINE: Optional[DevicePipeline] = None
_HASH_PIPELINE: Optional[HashPipeline] = None
_JOB_PIPELINES: Dict[str, JobPipeline] = {}
_ENABLED = os.environ.get("LIGHTHOUSE_TPU_DEVICE_PIPELINE", "") == "1"
#: The device new pipelines run on (set by :func:`enable`).
_DEVICE = "cuda"


def _device_key(device) -> str:
    import torch

    return str(torch.device(device))


def _takes(pipe, device) -> bool:
    """Would a call for ``device`` (None: unset) run where it asked on
    ``pipe``, the live pipeline (None: the one a call would start, on
    ``_DEVICE``)?  Called under ``_LOCK``."""
    if device is None:
        return True
    target = pipe.device if pipe is not None else _DEVICE
    return _device_key(device) == _device_key(target)


def get_pipeline() -> DevicePipeline:
    """The process-wide bls_verify pipeline (lazily started)."""
    global _PIPELINE
    with _LOCK:
        if _PIPELINE is None:
            _PIPELINE = DevicePipeline("bls_verify", device=_DEVICE)
        return _PIPELINE


def enabled() -> bool:
    return _ENABLED


def enable(device="cuda") -> None:
    """Route ``bls.verify_signature_sets``, the tree-hash seam's device
    pair batches and the epoch jobs through the pipelines, their batches on
    ``device``.  The port has no client builder yet, so the caller enables
    it.  ``LIGHTHOUSE_TPU_DEVICE_PIPELINE=0`` wins over callers.  Pipelines
    running on another device are shut down (their in-flight work still
    resolves there); the next routed call starts its pipeline on
    ``device``."""
    global _ENABLED, _DEVICE, _PIPELINE, _HASH_PIPELINE, _JOB_PIPELINES
    if os.environ.get("LIGHTHOUSE_TPU_DEVICE_PIPELINE", "") == "0":
        return
    key = _device_key(device)
    with _LOCK:
        _DEVICE = device
        _ENABLED = True
        stale = [p for p in (_PIPELINE, _HASH_PIPELINE, *_JOB_PIPELINES.values())
                 if p is not None and _device_key(p.device) != key]
        if _PIPELINE in stale:
            _PIPELINE = None
        if _HASH_PIPELINE in stale:
            _HASH_PIPELINE = None
        _JOB_PIPELINES = {op: p for op, p in _JOB_PIPELINES.items() if p not in stale}
    for pipe in stale:
        pipe.shutdown()


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def routes(sets: list, seed, device=None) -> bool:
    """Should this verify_signature_sets call ride the pipeline?  Explicit
    seeds (reproducibility contracts), another device than the pipeline's
    and oversized batches keep the direct path; so does everything when
    the pipeline is off."""
    if not (_ENABLED and seed is None and 0 < len(sets) <= MAX_GROUP_SETS):
        return False
    with _LOCK:
        return _takes(_PIPELINE, device)


def verify(sets: list, device=None) -> bool:
    """The api-seam entry: resolve the live pipeline WITHOUT resurrecting
    one that a racing ``shutdown()`` just tore down — a caller already past
    ``routes()`` must fall back to the direct path (the api seam catches
    :class:`PipelineShutdown`), not leak a fresh thread pair post-stop.  A
    live pipeline on another device than ``device`` (a racing
    :func:`enable`) raises :class:`PipelineShutdown` too."""
    global _PIPELINE
    with _LOCK:
        pipe = _PIPELINE
        if pipe is None:
            if not _ENABLED:
                raise PipelineShutdown("pipeline disabled mid-call")
            pipe = _PIPELINE = DevicePipeline("bls_verify", device=_DEVICE)
        if not _takes(pipe, device):
            raise PipelineShutdown("the pipeline runs on another device")
    return pipe.verify(sets)


def get_hash_pipeline() -> HashPipeline:
    """The process-wide sha256_pairs hash pipeline (lazily started)."""
    global _HASH_PIPELINE
    with _LOCK:
        if _HASH_PIPELINE is None:
            _HASH_PIPELINE = HashPipeline(device=_DEVICE)
        return _HASH_PIPELINE


def routes_hash(n_blocks: int, device=None) -> bool:
    """Should a pair-hash batch of ``n_blocks`` 64-byte blocks ride the
    hash pipeline?  Oversized batches and batches for another device than
    the pipeline's keep the direct supervised path; so does everything
    when the pipeline is off."""
    if not (_ENABLED and 0 < n_blocks <= MAX_HASH_GROUP_BLOCKS):
        return False
    with _LOCK:
        return _takes(_HASH_PIPELINE, device)


def hash_pairs(data: bytes, work: Optional[str] = None, device=None) -> bytes:
    """Pair-hash ``data`` through the hash pipeline (the ``ops/tree_hash``
    seam calls this after :func:`routes_hash`): same no-resurrection and
    same-device discipline as :func:`verify` — a caller racing
    ``shutdown()`` or ``enable()`` gets :class:`PipelineShutdown` and falls
    back to the direct path."""
    global _HASH_PIPELINE
    with _LOCK:
        pipe = _HASH_PIPELINE
        if pipe is None:
            if not _ENABLED:
                raise PipelineShutdown("pipeline disabled mid-call")
            pipe = _HASH_PIPELINE = HashPipeline(device=_DEVICE)
        if not _takes(pipe, device):
            raise PipelineShutdown("the hash pipeline runs on another device")
    fut = pipe.submit(data, work=work)
    try:
        return fut.result()
    finally:
        tracing.record_span(
            "pipeline_wait", start_pc=fut.submitted_pc,
            hist=metrics.DEVICE_PIPELINE_WAIT_SECONDS,
            hist_labels={"op": "sha256_pairs"},
            n_blocks=fut.n_blocks, work=fut.work,
        )


def routes_job(device) -> bool:
    """Should a batch-global device job (the epoch ops) for ``device`` ride
    a job pipeline — i.e. queue for the shared arbiter slot?  Only where
    the job pipelines run on ``device``."""
    if not _ENABLED:
        return False
    with _LOCK:
        live = next(iter(_JOB_PIPELINES.values()), None)
        return _takes(live, device)


def run_job(op: str, fn, work: Optional[str] = None, device=None):
    """Run ``fn`` (a full supervised device call for ``device``) on
    ``op``'s job pipeline and return its result.  Raises
    :class:`PipelineShutdown` when racing a shutdown, or an
    :func:`enable` that moved the pipelines to another device — callers
    fall back to running ``fn`` directly."""
    with _LOCK:
        pipe = _JOB_PIPELINES.get(op)
        if pipe is None:
            if not _ENABLED:
                raise PipelineShutdown("pipeline disabled mid-call")
            pipe = _JOB_PIPELINES[op] = JobPipeline(op, device=_DEVICE)
        if not _takes(pipe, device):
            raise PipelineShutdown(f"{op}: the job pipeline runs on another device")
    fut = pipe.submit(fn, work=work)
    try:
        return fut.result()
    finally:
        tracing.record_span(
            "pipeline_wait", start_pc=fut.submitted_pc,
            hist=metrics.DEVICE_PIPELINE_WAIT_SECONDS,
            hist_labels={"op": op}, work=fut.work,
        )


@contextmanager
def api_arbiter_slot(op: str = "http_state_query"):
    """Arbiter contention for an API-side device-bearing computation (the
    HTTP layer's cache-miss state/duties/rewards work).  When the pipelines
    are routing, this is a turnstile — the caller queues for the slot like
    any pipelined work, then releases before running so its own nested
    ``run_job`` legs (epoch deltas, hash batches) can re-contend from the
    pipeline workers without deadlocking.  When the pipelines are off, the
    slot is held across the body: the API thread's direct device dispatches
    are then serialized against any other direct callers."""
    with ARBITER.api_slot(op, hold=not _ENABLED):
        yield


def summary() -> Optional[dict]:
    """The pipeline section of ``device_telemetry.summary()`` (None until
    any pipeline has been started).  The bls pipeline's snapshot keys stay
    top-level; the hash and job pipelines and the shared arbiter ride as
    sub-sections."""
    with _LOCK:
        pipe = _PIPELINE
        hash_pipe = _HASH_PIPELINE
        jobs = dict(_JOB_PIPELINES)
    if pipe is None and hash_pipe is None and not jobs:
        return None
    out = pipe.snapshot() if pipe is not None else {"op": "bls_verify"}
    out["hash"] = hash_pipe.snapshot() if hash_pipe is not None else None
    out["jobs"] = {op: p.snapshot() for op, p in sorted(jobs.items())} or None
    out["arbiter"] = ARBITER.snapshot()
    return out


def shutdown(timeout: float = 30.0) -> None:
    """Disable routing and drain every process pipeline.  New verify, hash
    and job calls fall back to the direct paths immediately; in-flight
    futures still resolve."""
    global _PIPELINE, _HASH_PIPELINE, _JOB_PIPELINES
    disable()
    with _LOCK:
        pipe, _PIPELINE = _PIPELINE, None
        hash_pipe, _HASH_PIPELINE = _HASH_PIPELINE, None
        jobs, _JOB_PIPELINES = _JOB_PIPELINES, {}
    if pipe is not None:
        pipe.shutdown(timeout=timeout)
    if hash_pipe is not None:
        hash_pipe.shutdown(timeout=timeout)
    for job_pipe in jobs.values():
        job_pipe.shutdown(timeout=timeout)


def reset_for_tests() -> None:
    set_linger_clock(None)
    shutdown(timeout=5.0)
    ARBITER.reset_for_tests()
