"""Device-layer telemetry: a first-dispatch and kernel-build mirror,
padding-waste accounting, a batch flight recorder, device memory and the
on-demand profiler hook.

The port of ``lighthouse_tpu/device_telemetry.py``.  Tracing
(``tracing.py``) shows that ``device_batch_wait`` was slow, not why; the
usual suspects each get their own accounting here:

- **first dispatches and kernel builds** — the port's device programs are
  eager PyTorch, so there is no per-shape compile; the first dispatch of
  an ``(op, shape)`` still pays one-time costs (allocator growth, constant
  uploads, and, for the first batch of the process, the ``nvcc`` builds
  of ``csrc/fq_mul.cu`` and ``csrc/sha256.cu``).  Each entry point reports its dispatch through
  :func:`note_dispatch`, which keeps a mirror ``(op, shape)`` → inventory
  entry, increments ``device_program_compiles_total{op,shape}`` once per
  shape and feeds ``device_program_compile_seconds`` on that first call.
  Each kernel library's build is its own entry (``ops/compile_cache.py``
  notes it through :func:`note_warmup`, a hit when an up-to-date library
  was found).
- **padding waste** — batches are padded up to bucket shapes;
  :func:`record_batch` accounts ``live/nb`` occupancy into
  ``device_batch_occupancy_ratio`` histograms plus wasted-lane counters.
- **device memory** — :func:`device_memory_stats` reads
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` per visible
  card; a registered collector mirrors the byte figures onto
  ``device_memory_bytes{device,stat}`` gauges on every scrape.

Every dispatched batch also lands in the bounded :class:`FlightRecorder`
ring (op, bucket shape, live sizes, per-stage durations, occupancy,
verdict, host-fallback flag, **trace id**).  The trace id links each
record to its span tree, and the trace carries ``flight_seq`` back.

:func:`capture_profile` wraps ``torch.profiler.profile`` with CUDA
activity for a Perfetto-loadable dump (refused without a card).

Everything here is host-side bookkeeping called outside the device
programs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import blackbox, metrics, tracing

#: Flight-recorder ring size.  ``LIGHTHOUSE_TPU_FLIGHT_RING`` is the
#: knob (long soaks size it up so pre-incident records survive to the
#: postmortem bundle); the older ``_FLIGHT_RECORDER_CAPACITY`` name is
#: honored as a fallback.
FLIGHT_RECORDER_CAPACITY = int(
    os.environ.get(
        "LIGHTHOUSE_TPU_FLIGHT_RING",
        os.environ.get("LIGHTHOUSE_TPU_FLIGHT_RECORDER_CAPACITY", "256"),
    )
)

#: Hard cap on one profiler capture (the capture sleeps for its whole
#: window).
MAX_PROFILE_SECONDS = 10.0


def _shape_label(shape: Tuple[int, ...], mesh: int = 0) -> str:
    label = "x".join(str(int(s)) for s in shape)
    # A sharded dispatch is a different program at the same bucket shape:
    # the mesh size is part of the identity ("128x32@dp2").
    return f"{label}@dp{int(mesh)}" if mesh else label


def active_trace_id() -> Optional[str]:
    """Trace id of the active span's trace (None outside any trace)."""
    sp = tracing.current_span()
    return sp.trace.trace_id if sp is not None else None


# ------------------------------------------------------- compile-cache mirror


class CompileCache:
    """Mirror of the first dispatch of each ``(op, shape)``.

    The JAX package mirrors jax's executable cache this way; the port's
    programs are eager, so "first seen here" marks the dispatch that paid
    the one-time costs of a shape (and of the process's first batch, the
    kernel build).  The bucketed entry points' dtypes are fixed, so
    ``(op, shape, mesh)`` is the whole identity (``mesh`` > 0 for a
    dispatch sharded over that many mesh members).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, Tuple[int, ...]], dict] = {}

    def note_dispatch(self, op: str, shape: Tuple[int, ...], seconds: float,
                      mesh: int = 0) -> bool:
        """Record one dispatch of ``op`` at ``shape`` (sharded over ``mesh``
        members, 0 for one device); True iff first seen."""
        shape = tuple(int(s) for s in shape)
        mesh = int(mesh)
        now = time.time()
        with self._lock:
            entry = self._programs.get((op, shape, mesh))
            if entry is not None:
                entry["invocations"] += 1
                entry["last_used_ms"] = int(now * 1000)
                return False
            self._programs[(op, shape, mesh)] = {
                "op": op,
                "shape": _shape_label(shape, mesh),
                "compile_seconds": round(seconds, 4),
                "invocations": 1,
                "first_seen_ms": int(now * 1000),
                "last_used_ms": int(now * 1000),
            }
        metrics.DEVICE_PROGRAM_COMPILES.inc(op=op, shape=_shape_label(shape, mesh))
        metrics.DEVICE_PROGRAM_COMPILE_SECONDS.observe(seconds, op=op)
        return True

    def note_warmup(self, op: str, shape: Tuple[int, ...], seconds: float,
                    hit: bool) -> None:
        """Record a warmup of ``(op, shape)`` off the caller's path — the
        kernel build (``ops/compile_cache.build_kernels``) or a bucket's
        neutral-batch dispatch (``ops/compile_cache.aot_warmup_op``).
        Pre-seeds the mirror so the entry's first production use is not
        counted as its first; only a MISS (work the warmup really did)
        increments ``device_program_compiles_total``."""
        shape = tuple(int(s) for s in shape)
        now = time.time()
        with self._lock:
            entry = self._programs.get((op, shape, 0))
            # A production dispatch can race the background warmup of the
            # same shape; if it won, note_dispatch already counted it.
            already_counted = entry is not None
            if entry is None:
                entry = self._programs[(op, shape, 0)] = {
                    "op": op,
                    "shape": _shape_label(shape),
                    "compile_seconds": round(seconds, 4),
                    "invocations": 0,
                    "first_seen_ms": int(now * 1000),
                    "last_used_ms": int(now * 1000),
                }
            entry["source"] = "warmup"
            entry["warmup_outcome"] = "hit" if hit else "miss"
        outcome = "hit" if hit else "miss"
        metrics.DEVICE_AOT_WARMUP.inc(op=op, shape=_shape_label(shape),
                                      outcome=outcome)
        metrics.DEVICE_AOT_WARMUP_SECONDS.observe(seconds, op=op)
        if not hit and not already_counted:
            metrics.DEVICE_PROGRAM_COMPILES.inc(op=op, shape=_shape_label(shape))
            metrics.DEVICE_PROGRAM_COMPILE_SECONDS.observe(seconds, op=op)

    def seen(self, op: str, shape: Tuple[int, ...], mesh: int = 0) -> bool:
        """True iff ``(op, shape, mesh)`` was dispatched or warmed already —
        lets fault-injection sites target ``device.compile``
        deterministically."""
        with self._lock:
            return (op, tuple(int(s) for s in shape), int(mesh)) in self._programs

    def invalidate_meshed(self) -> None:
        """Drop every sharded program's mirror entry (a device_mesh
        reshard: the old topology's placements are gone, and the
        survivors' first dispatches must count as the first ones they
        are)."""
        with self._lock:
            self._programs = {
                k: v for k, v in self._programs.items() if k[2] == 0
            }

    def inventory(self) -> List[dict]:
        with self._lock:
            return sorted(
                (dict(e) for e in self._programs.values()),
                key=lambda e: (e["op"], e["shape"]),
            )

    def clear(self) -> None:
        """Reset the mirror (tests)."""
        with self._lock:
            self._programs.clear()


COMPILE_CACHE = CompileCache()


def note_dispatch(op: str, shape: Tuple[int, ...], seconds: float,
                  mesh: int = 0) -> bool:
    return COMPILE_CACHE.note_dispatch(op, shape, seconds, mesh=mesh)


def note_warmup(op: str, shape: Tuple[int, ...], seconds: float, hit: bool) -> None:
    COMPILE_CACHE.note_warmup(op, shape, seconds, hit)


# ------------------------------------------------------------ flight recorder


class FlightRecorder:
    """Bounded ring of the last N device-batch records."""

    def __init__(self, capacity: int = FLIGHT_RECORDER_CAPACITY):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, entry: dict) -> dict:
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
        return entry

    def recent(self, limit: int = 64, op: Optional[str] = None,
               trace_id: Optional[str] = None,
               node: Optional[str] = None) -> List[dict]:
        """Newest-first records, optionally filtered by op / trace id /
        originating node (fleet runs stamp ``node`` via telemetry_scope)."""
        with self._lock:
            records = list(self._ring)
        records.reverse()
        if op is not None:
            records = [r for r in records if r.get("op") == op]
        if trace_id is not None:
            records = [r for r in records if r.get("trace_id") == trace_id]
        if node is not None:
            records = [r for r in records if r.get("node") == node]
        return [dict(r) for r in records[:max(1, limit)]]

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


FLIGHT_RECORDER = FlightRecorder()

# Host-fallback tally by reason (also on the Prometheus counter; kept here
# so the /lighthouse/device summary needs no registry introspection).
_FALLBACKS: Dict[str, int] = {}
_FALLBACKS_LOCK = threading.Lock()


def record_batch(
    *,
    op: str,
    shape: Tuple[int, ...],
    n_live: int,
    live_keys: Optional[int] = None,
    n_groups: Optional[int] = None,
    work_mix: Optional[Dict[str, int]] = None,
    stages: Optional[Dict[str, float]] = None,
    verdict: Optional[bool] = None,
    host_fallback: bool = False,
    fallback_reason: Optional[str] = None,
    trace_id: Optional[str] = None,
    compiled: bool = False,
    breaker_state: Optional[str] = None,
    dispatched: bool = True,
    mesh: int = 0,
    shard_live: Optional[List[int]] = None,
) -> dict:
    """Account one dispatched device batch: occupancy histograms +
    wasted-lane counters + a flight-recorder entry.  Returns the entry
    (with its ``seq``) so callers can stamp the linkage on their span.
    ``mesh`` > 0 marks a sharded dispatch; ``shard_live`` is the per-shard
    live-row split (bucket and mesh padding land on the last shards)."""
    shape = tuple(int(s) for s in shape)
    nb = shape[0]
    entry: Dict[str, Any] = {
        "t_ms": int(time.time() * 1000),
        "op": op,
        "shape": _shape_label(shape, mesh),
        "n_live": int(n_live),
        "compiled": bool(compiled),
        "host_fallback": bool(host_fallback),
        "trace_id": trace_id,
    }
    if mesh:
        entry["mesh"] = int(mesh)
    if n_groups is not None:
        # Pipeline-coalesced batches: how many caller groups rode this one
        # dispatch, and which work kinds contributed how many sets.
        entry["n_groups"] = int(n_groups)
    if work_mix:
        entry["work_mix"] = {str(k): int(v) for k, v in work_mix.items()}
    if stages:
        entry["stages_s"] = {k: round(float(v), 6) for k, v in stages.items()}
    if verdict is not None:
        entry["verdict"] = bool(verdict)
    if fallback_reason is not None:
        entry["fallback_reason"] = fallback_reason
    if breaker_state is not None:
        entry["breaker_state"] = breaker_state

    if dispatched and nb > 0:
        # A batch the breaker routed to the host never reached the device:
        # it is still flight-recorded, but stays out of the occupancy /
        # wasted-lane data that tunes K_BUCKETS/N_BUCKETS (no lanes were
        # actually dispatched).
        set_ratio = min(1.0, n_live / nb)
        entry["occupancy_sets"] = round(set_ratio, 4)
        metrics.DEVICE_BATCH_OCCUPANCY_RATIO.observe(set_ratio, op=op, axis="sets")
        metrics.DEVICE_BATCH_WASTED_LANES.inc(max(0, nb - n_live), op=op, axis="sets")
    if dispatched and live_keys is not None and len(shape) >= 2 and nb * shape[1] > 0:
        lanes = nb * shape[1]
        key_ratio = min(1.0, live_keys / lanes)
        entry["live_keys"] = int(live_keys)
        entry["occupancy_keys"] = round(key_ratio, 4)
        metrics.DEVICE_BATCH_OCCUPANCY_RATIO.observe(key_ratio, op=op, axis="keys")
        metrics.DEVICE_BATCH_WASTED_LANES.inc(
            max(0, lanes - live_keys), op=op, axis="keys"
        )
    if dispatched and mesh and shard_live and nb > 0 and len(shard_live) > 1:
        # Per-shard view: each member's live/padded ratio on this dispatch
        # (histogram axis "sets_per_shard" keeps the batch-level "sets"
        # signal clean; the flight record carries the exact split).
        rows = nb // len(shard_live)
        ratios = [round(min(1.0, live / rows), 4) if rows else 0.0
                  for live in shard_live]
        entry["shard_live"] = [int(v) for v in shard_live]
        entry["occupancy_per_shard"] = ratios
        for r in ratios:
            metrics.DEVICE_BATCH_OCCUPANCY_RATIO.observe(
                r, op=op, axis="sets_per_shard")
    if host_fallback:
        reason = fallback_reason or "unknown"
        with _FALLBACKS_LOCK:
            _FALLBACKS[reason] = _FALLBACKS.get(reason, 0) + 1
    # Node attribution (fleet runs): a batch dispatched under an active
    # telemetry scope is stamped with its node, mirrored into the scope's
    # flight tail, and cross-referenced as a (node, seq) flight_seq pair —
    # a plain int seq is ambiguous once N nodes share the process ring.
    from . import telemetry_scope

    scope = telemetry_scope.current()
    if scope is not None:
        entry["node"] = scope.node_id
    entry = FLIGHT_RECORDER.record(entry)
    if scope is not None:
        scope.note_flight(entry)
        fseq = (scope.node_id, entry["seq"])
    else:
        fseq = entry["seq"]
    # Every dispatched batch joins the incident journal with its
    # flight_seq, so a postmortem bundle's journal window cross-references
    # the ring (and, via trace_id, the span tree) record-for-record.
    blackbox.emit("device_batch", "dispatch", trace_id=entry["trace_id"],
                  flight_seq=fseq, op=op, shape=entry["shape"],
                  n_live=int(n_live), verdict=verdict,
                  host_fallback=bool(host_fallback) or None,
                  fallback_reason=fallback_reason,
                  breaker_state=breaker_state)
    return entry


def host_fallback_counts() -> Dict[str, int]:
    with _FALLBACKS_LOCK:
        return dict(_FALLBACKS)


# Fused-epoch duty-cache priming tally (``consensus/per_epoch.
# _prime_duty_caches``): how often the fused boundary's precomputed
# shuffling/proposers seeded the caches vs. were discarded, by reason.
_BOUNDARY_PRIMES: Dict[str, int] = {}
_BOUNDARY_PRIMES_LOCK = threading.Lock()


def note_boundary_prime(seeded: bool, reason: str) -> None:
    key = f"{'seeded' if seeded else 'discarded'}:{reason}"
    with _BOUNDARY_PRIMES_LOCK:
        _BOUNDARY_PRIMES[key] = _BOUNDARY_PRIMES.get(key, 0) + 1


def boundary_prime_counts() -> Dict[str, int]:
    with _BOUNDARY_PRIMES_LOCK:
        return dict(_BOUNDARY_PRIMES)


def recent_inflight_seconds(op: str, min_samples: int = 3,
                            window: int = 32) -> Optional[float]:
    """Median observed in-flight duration (dispatch + wait stages) of the
    last ``window`` dispatched ``op`` batches, or None below
    ``min_samples``.  The adaptive-linger feedback signal: while a batch is
    in flight the pipeline's pending queue fills for free, so the observed
    in-flight duration is exactly how long a linger is throughput-neutral
    (device_pipeline derives its effective linger from this)."""
    durations: List[float] = []
    for r in FLIGHT_RECORDER.recent(limit=window, op=op):
        stages = r.get("stages_s")
        # compiled batches carry jit time in their dispatch stage (minutes
        # on CPU) — poison for a linger signal meant to track steady state
        if not stages or r.get("host_fallback") or r.get("compiled"):
            continue
        d = stages.get("dispatch", 0.0) + stages.get("wait", 0.0)
        if d > 0:
            durations.append(d)
    if len(durations) < min_samples:
        return None
    durations.sort()
    return durations[len(durations) // 2]


# ------------------------------------------------------------- device memory


def device_memory_stats() -> List[dict]:
    """Per-card snapshot of ``torch.cuda.memory_stats`` (the caching
    allocator's figures) plus ``torch.cuda.mem_get_info`` (the CUDA runtime's
    free and total bytes), for every visible card.  Empty without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        entry: Dict[str, Any] = {
            "id": i,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
        }
        try:
            stats = {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                     if isinstance(v, (int, float))}
            free, total = torch.cuda.mem_get_info(i)
            stats["free_bytes"], stats["total_bytes"] = int(free), int(total)
        except Exception:
            stats = None
        if stats:
            entry["stats"] = stats
        out.append(entry)
    return out


def _collect_device_memory() -> None:
    """Scrape-time collector: mirror the byte figures onto gauges."""
    for entry in device_memory_stats():
        for stat, value in entry.get("stats", {}).items():
            if "bytes" in stat:
                metrics.DEVICE_MEMORY_BYTES.set(
                    value, device=str(entry["id"]), stat=stat
                )


metrics.register_collector(_collect_device_memory)


# ------------------------------------------------------------------ summary


def _percentiles(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    values = sorted(values)
    n = len(values)

    def pick(q: float) -> float:
        return values[min(n - 1, int(q * n))]

    return {
        "n": n,
        "min": round(values[0], 4),
        "p50": round(pick(0.50), 4),
        "p90": round(pick(0.90), 4),
        "p99": round(pick(0.99), 4),
        "max": round(values[-1], 4),
    }


def summary() -> dict:
    """The device section of the node's status: first-dispatch and build
    inventory, occupancy percentiles over the flight-recorder window (per
    op: ``bls_verify``, ``kzg_batch``, ``sha256_pairs``, ``tree_hash``),
    host-fallback tallies, the autotune mode and overlay, the device mesh,
    device memory, pipelines (the bls and hash pipelines and the shared
    arbiter's grants and waits) and supervisor."""
    records = FLIGHT_RECORDER.recent(limit=FLIGHT_RECORDER.capacity)
    # Percentiles are grouped per op, matching the labeled histograms.
    occ: Dict[str, dict] = {}
    for r in records:
        if "occupancy_sets" not in r and "occupancy_keys" not in r:
            continue
        per_op = occ.setdefault(r["op"], {"sets": [], "keys": []})
        if "occupancy_sets" in r:
            per_op["sets"].append(r["occupancy_sets"])
        if "occupancy_keys" in r:
            per_op["keys"].append(r["occupancy_keys"])
    occ = {
        op: {axis: _percentiles(vals) for axis, vals in axes.items() if vals}
        for op, axes in occ.items()
    }
    from . import autotune, device_mesh, device_pipeline, device_supervisor

    return {
        "programs": COMPILE_CACHE.inventory(),
        "occupancy": occ,
        "host_fallbacks": host_fallback_counts(),
        # Self-tuning control plane (autotune.py): mode + live vocabulary
        # overlay; GET /lighthouse/autotune is the full decision log.
        "autotune": {
            "mode": autotune.mode(),
            "overlay": {k: list(v) for k, v in autotune.overlay().items()},
        },
        # Mesh-sharding subsystem (device_mesh.py): topology, per-member
        # breakers, reshard count.
        "mesh": device_mesh.summary(),
        # Fused epoch boundary: duty-cache priming outcomes.
        "boundary_primes": boundary_prime_counts(),
        # Async device pipelines (device_pipeline.py): pending depth, fill
        # and linger of the coalescing layers feeding the batches above,
        # the hash pipeline and the arbiter as sub-sections (None until a
        # pipeline has started in this process).
        "pipeline": device_pipeline.summary(),
        "flight_recorder": {
            "capacity": FLIGHT_RECORDER.capacity,
            "stored": len(FLIGHT_RECORDER),
            "recorded_total": FLIGHT_RECORDER.recorded_total,
        },
        "memory": device_memory_stats(),
        # Supervisor surface (device_supervisor.py): per-op breaker state,
        # trip/probe counters, and the watchdog deadlines in force — the
        # first thing to check when host_fallbacks is climbing.
        "supervisor": device_supervisor.summary(),
    }


def reset_for_tests() -> None:
    """Clear all module state (compile mirror, ring, fallback tallies)."""
    COMPILE_CACHE.clear()
    FLIGHT_RECORDER.clear()
    with _FALLBACKS_LOCK:
        _FALLBACKS.clear()
    with _BOUNDARY_PRIMES_LOCK:
        _BOUNDARY_PRIMES.clear()


# ----------------------------------------------------------------- profiler


class ProfilerUnavailable(RuntimeError):
    """The device tracer cannot produce anything useful here (no card)."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight — one at a time."""


_PROFILE_LOCK = threading.Lock()

#: Dump directories retained under the profile root — older captures are
#: pruned before each new one.
PROFILE_RETAIN = int(os.environ.get("LIGHTHOUSE_TPU_PROFILE_RETAIN", "8"))


def _prune_profiles(root: str) -> None:
    import shutil

    try:
        dumps = sorted(
            e for e in os.listdir(root) if e.startswith("profile_")
        )
    except OSError:
        return
    for stale in dumps[: max(0, len(dumps) - (PROFILE_RETAIN - 1))]:
        shutil.rmtree(os.path.join(root, stale), ignore_errors=True)


def capture_profile(seconds: float, out_root: Optional[str] = None) -> dict:
    """Capture ``seconds`` of ``torch.profiler.profile`` (CPU and CUDA
    activity) into a fresh directory under ``$TMPDIR`` and return the path
    of its Chrome trace (loadable in Perfetto).

    Raises :class:`ProfilerUnavailable` without a card unless
    ``LIGHTHOUSE_TPU_FORCE_PROFILER=1`` (then CPU activity only), and
    :class:`ProfilerBusy` when a capture is already running.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    seconds = max(0.05, min(float(seconds), MAX_PROFILE_SECONDS))
    cuda = torch.cuda.is_available()
    if not cuda and not os.environ.get("LIGHTHOUSE_TPU_FORCE_PROFILER"):
        raise ProfilerUnavailable(
            "device profiling needs a CUDA card "
            "(set LIGHTHOUSE_TPU_FORCE_PROFILER=1 to trace the CPU alone)"
        )
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in progress")
    try:
        root = out_root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "lighthouse_tpu_profiles"
        )
        _prune_profiles(root)
        path = os.path.join(root, f"profile_{int(time.time() * 1000)}")
        os.makedirs(path, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        trace = os.path.join(path, "trace.json")
        try:
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(trace)
        except Exception as e:
            raise ProfilerUnavailable(f"torch.profiler failed: {e}")
        return {
            "path": trace,
            "seconds": round(time.perf_counter() - t0, 3),
            "platform": "gpu" if cuda else "cpu",
            "hint": "load the trace in Perfetto (ui.perfetto.dev)",
        }
    finally:
        _PROFILE_LOCK.release()
