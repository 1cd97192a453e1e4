"""Process-wide metrics registry: counters, gauges, histograms, stage timers.

Equivalent of the reference's ``common/lighthouse_metrics`` (lib.rs:1-18 —
thin helpers over a global prometheus registry) plus the hot-path stage
timers of batch verification and block import
(``beacon_node/beacon_chain/src/metrics.rs:40-271``).  The port keeps the
JAX package's registry and, of its metrics, those the device runtime, the
BLS API, the KZG path, the chain, the scheduler and the HTTP API touch,
with their names, labels and buckets (the mesh's beside the pipeline's;
``autotune.py`` registers its own three).  The network's and the slasher's
counters sit at the end.

Design: a plain-Python registry with lock-free-enough updates (single
attribute stores under the GIL), rendered on demand in the Prometheus text
exposition format by the HTTP server's ``/metrics`` route.  No external
dependency; histograms use fixed log-spaced buckets like the reference's
``exponential_buckets``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: "Dict[str, _Metric]" = {}

# Registration conflicts (same name, different kind or help), kept for
# inspection — the registry itself stays first-wins.
DUPLICATE_REGISTRATIONS: List[Tuple[str, str, str]] = []

# Callbacks run before each render (process metrics and other sampled-on-
# scrape values register here; see system_health.py, device_telemetry.py).
_COLLECTORS: List[Callable[[], None]] = []


def register_collector(fn: Callable[[], None]) -> None:
    with _REGISTRY_LOCK:
        if fn not in _COLLECTORS:
            _COLLECTORS.append(fn)


def _labels_key(labels: Optional[dict]) -> Tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._series: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def render(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError


def _escape_label_value(v) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote, and line-feed must be escaped inside the
    double-quoted value."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_labels(key: Tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key) + "}"


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def get(self, **labels) -> float:
        with self._lock:
            return self._series.get(_labels_key(labels), 0.0)

    def set_total(self, value: float, **labels) -> None:
        """Overwrite the running total — for collectors mirroring an external
        monotonic counter (e.g. /proc CPU seconds) onto the registry."""
        with self._lock:
            self._series[_labels_key(labels)] = float(value)

    def snapshot(self) -> Dict[Tuple, float]:
        """All series values right now — pair with :meth:`delta` so a check
        inside one run of a long-lived process asserts on THAT run's
        increments, not on the process-cumulative totals."""
        with self._lock:
            return dict(self._series)

    def delta(self, baseline: Dict[Tuple, float], **labels) -> float:
        """This label set's increment since ``baseline`` (a snapshot())."""
        return self.get(**labels) - baseline.get(_labels_key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._series.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_labels_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def get(self, **labels) -> float:
        with self._lock:
            return self._series.get(_labels_key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._series.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


# Log-spaced from 1ms to ~65s — the reference's exponential_buckets shape.
DEFAULT_BUCKETS = tuple(0.001 * (2.0 ** i) for i in range(17))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * len(self.buckets), "sum": 0.0, "n": 0}
                self._series[key] = series
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    series["counts"][i] += 1
            series["sum"] += value
            series["n"] += 1

    def time(self, **labels) -> "_HistTimer":
        return _HistTimer(self, labels)

    def stats(self, **labels) -> Tuple[int, float]:
        """(count, total_seconds) for a label set."""
        with self._lock:
            s = self._series.get(_labels_key(labels))
            return (0, 0.0) if s is None else (s["n"], s["sum"])

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = sorted(
                (key, {"counts": list(s["counts"]), "sum": s["sum"], "n": s["n"]})
                for key, s in self._series.items()
            )
        for key, s in snapshot:
            for i, ub in enumerate(self.buckets):
                lk = key + (("le", repr(ub)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {s['counts'][i]}")
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {s['n']}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {s['sum']}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {s['n']}")
        return out


class _HistTimer:
    """``with HIST.time():`` stage timer (reference ``start_timer``)."""

    def __init__(self, hist: Histogram, labels: dict):
        self._hist = hist
        self._labels = labels
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)
        return False


class LocalTally:
    """A scope-local metrics view: name → labeled counter totals, next to
    (not instead of) the process-global registry.

    ``telemetry_scope.TelemetryScope`` holds one per node so a fleet run
    can answer "how many journal events did node B emit" without parsing
    process-cumulative series — the per-node precursor of a per-process
    registry.  Never
    rendered on ``/metrics``; surfaced through scope snapshots and the
    fleet artifact."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[Tuple, float] = {}

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name,) + _labels_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def get(self, name: str, **labels) -> float:
        with self._lock:
            return self._series.get((name,) + _labels_key(labels), 0.0)

    def snapshot(self) -> Dict[str, float]:
        """``name{label="v",...} -> total`` in stable sorted order."""
        with self._lock:
            items = sorted(self._series.items())
        return {key[0] + _fmt_labels(key[1:]): v for key, v in items}


def _register(metric: _Metric) -> _Metric:
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(metric.name)
        if existing is not None:
            if existing.kind != metric.kind or (
                metric.help and existing.help != metric.help
            ):
                DUPLICATE_REGISTRATIONS.append(
                    (metric.name, existing.kind, metric.kind)
                )
            return existing
        _REGISTRY[metric.name] = metric
        return metric


def counter(name: str, help_text: str = "") -> Counter:
    return _register(Counter(name, help_text))  # type: ignore[return-value]


def gauge(name: str, help_text: str = "") -> Gauge:
    return _register(Gauge(name, help_text))  # type: ignore[return-value]


def histogram(name: str, help_text: str = "", buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _register(Histogram(name, help_text, buckets))  # type: ignore[return-value]


def render_prometheus() -> str:
    """The full registry in Prometheus text exposition format."""
    # Ensure the standard process-metric collector is registered (lazy: a
    # top-level import would be circular — system_health imports metrics).
    from .. import system_health  # noqa: F401

    with _REGISTRY_LOCK:
        collectors = list(_COLLECTORS)
        metrics = list(_REGISTRY.values())
    for fn in collectors:
        try:
            fn()
        except Exception:
            pass  # a broken collector must never take /metrics down
    lines: List[str] = []
    for m in metrics:
        lines.extend(m.render())
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ batch verify
# The BLS API seam (crypto/bls/api.py).

ATTESTATION_BATCH_SECONDS = histogram(
    "beacon_attestation_batch_verify_seconds", "device batch signature verification"
)

ATTESTATION_BATCH_SIZE = histogram(
    "beacon_attestation_batch_size", "signature sets per device batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)

SIGNATURE_SETS_VERIFIED = counter(
    "beacon_signature_sets_verified_total", "signature sets through the batch verifier"
)

DEVICE_BATCH_INVOCATIONS = counter(
    "beacon_device_batch_invocations_total", "batched device program invocations"
)

# Device batch stages (reference metrics.rs:247-271 batch setup / verify
# timers): host marshalling vs dispatch vs device execution vs verdict.
DEVICE_BATCH_SETUP_SECONDS = histogram(
    "device_batch_setup_seconds",
    "host-side batch marshalling (validation, hash-to-curve, limb packing)",
)

DEVICE_DISPATCH_SECONDS = histogram(
    "device_batch_dispatch_seconds",
    "async program dispatch (returns before execution completes)",
)

DEVICE_BLOCK_UNTIL_READY_SECONDS = histogram(
    "device_batch_block_until_ready_seconds",
    "wait for device results (the actual device execution window)",
)

DEVICE_VERDICT_SECONDS = histogram(
    "device_batch_verdict_seconds",
    "host-side verdict (W-at-infinity check + final-exp-is-one)",
)

# Device-layer telemetry (device_telemetry.py): first-dispatch mirror,
# padding-waste accounting, host-fallback tracking, device memory gauges.
DEVICE_PROGRAM_COMPILES = counter(
    "device_program_compiles_total",
    "first-seen (op, bucket shape) jit compilations, by op and shape",
)

DEVICE_PROGRAM_COMPILE_SECONDS = histogram(
    "device_program_compile_seconds",
    "trace+compile time of a first-seen bucket shape (the compiling dispatch)",
)

OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

DEVICE_BATCH_OCCUPANCY_RATIO = histogram(
    "device_batch_occupancy_ratio",
    "live/padded occupancy per device batch, by op and axis (sets|keys)",
    buckets=OCCUPANCY_BUCKETS,
)

DEVICE_BATCH_WASTED_LANES = counter(
    "device_batch_wasted_lanes_total",
    "padding lanes dispatched with no live work, by op and axis (sets|keys)",
)

DEVICE_HOST_FALLBACK = counter(
    "device_batch_host_fallback_total",
    "device batches re-verified entirely on the host, by reason",
)

DEVICE_AOT_WARMUP = counter(
    "device_aot_warmup_total",
    "ahead-of-time bucket compilations at startup, by op, shape and outcome (hit|miss)",
)

DEVICE_AOT_WARMUP_SECONDS = histogram(
    "device_aot_warmup_seconds",
    "wall time of one ahead-of-time bucket warmup (lower+compile), by op",
)

DEVICE_MEMORY_BYTES = gauge(
    "device_memory_bytes",
    "device memory_stats() figures sampled on scrape, by device and stat",
)

# Device-execution supervisor (device_supervisor.py).
DEVICE_BREAKER_STATE = gauge(
    "device_breaker_state",
    "per-op circuit breaker state (0=closed, 1=open, 2=half_open), by op",
)

DEVICE_BREAKER_TRANSITIONS = counter(
    "device_breaker_transitions_total",
    "circuit breaker state transitions, by op and destination state",
)

DEVICE_DISPATCH_TIMEOUTS = counter(
    "device_dispatch_timeouts_total",
    "device dispatches abandoned by the watchdog deadline, by op",
)

DEVICE_SPLIT_RETRIES = counter(
    "device_batch_split_retries_total",
    "split-batch retries after a transient device error, by op and outcome",
)

# Async device pipeline (device_pipeline.py): the bls_verify pipeline
# counts signature sets, the sha256_pairs hash pipeline 64-byte blocks,
# under the same series (label ``op``).
DEVICE_PIPELINE_PENDING_SETS = gauge(
    "device_pipeline_pending_sets",
    "signature sets queued in the device pipeline awaiting coalescing, by op",
)

DEVICE_PIPELINE_DEPTH = gauge(
    "device_pipeline_depth",
    "groups queued or in flight in the device pipeline, by op",
)

DEVICE_PIPELINE_BATCH_FILL_RATIO = histogram(
    "device_pipeline_batch_fill_ratio",
    "live sets dispatched / target batch size per coalesced pipeline batch, by op",
    buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)

DEVICE_PIPELINE_LINGER_SECONDS = histogram(
    "device_pipeline_linger_seconds",
    "oldest-submit to batch-take wait per coalesced pipeline batch, by op",
)

DEVICE_PIPELINE_WAIT_SECONDS = histogram(
    "device_pipeline_wait_seconds",
    "submit to future-resolution wait per pipeline group, by op",
)

DEVICE_PIPELINE_BATCHES = counter(
    "device_pipeline_batches_total",
    "coalesced batches executed by the device pipeline, by op",
)

DEVICE_PIPELINE_GROUPS = counter(
    "device_pipeline_groups_total",
    "signature-set groups submitted to the device pipeline, by op and work kind",
)

# The shared device arbiter (device_pipeline.DeviceArbiter): every pipeline
# takes its one slot around its device leg, so the bls and hash pipelines
# contend here, visibly.
DEVICE_ARBITER_WAIT_SECONDS = histogram(
    "device_arbiter_wait_seconds",
    "wait to acquire the shared device-dispatch arbiter slot, by op",
)

DEVICE_ARBITER_GRANTS = counter(
    "device_arbiter_grants_total",
    "device-dispatch slots granted by the shared pipeline arbiter, by op",
)

DEVICE_ARBITER_API_TIMEOUTS = counter(
    "device_arbiter_api_timeouts_total",
    "API-side arbiter acquisitions that timed out and proceeded ungated, "
    "by op",
)

# Mesh-sharding subsystem (device_mesh.py): the data-parallel device mesh
# the bucketed entry points shard their batch axis over, and the per-device
# breaker layer that shrinks it around a sick chip instead of tripping the
# whole op to host.
DEVICE_MESH_SIZE = gauge(
    "device_mesh_size",
    "devices in the active data-parallel mesh (0 = mesh disabled, "
    "single-device dispatch)",
)
DEVICE_MESH_RESHARDS = counter(
    "device_mesh_reshards_total",
    "mesh topology rebuilds after a per-device breaker trip, by reason",
)
DEVICE_MESH_DEVICE_FAILURES = counter(
    "device_mesh_device_failures_total",
    "device-attributed dispatch failures recorded by the mesh layer, by device",
)
DEVICE_MESH_DEVICE_STATE = gauge(
    "device_mesh_device_breaker_state",
    "per-device mesh breaker state (0=closed, 1=open), by device",
)

# ------------------------------------------------------------------- chain
# Chain stage timers (reference beacon_chain/src/metrics.rs:40-271), the
# block import's stages as ``chain/beacon_chain.py`` spans them.
BLOCK_IMPORT_SECONDS = histogram(
    "beacon_block_import_seconds", "Full block import pipeline time"
)
BLOCK_STATE_TRANSITION_SECONDS = histogram(
    "beacon_block_state_transition_seconds", "state_transition() inside import"
)
BLOCK_FORK_CHOICE_SECONDS = histogram(
    "beacon_block_fork_choice_seconds", "fork choice on_block inside import"
)
BLOCK_DA_CHECK_SECONDS = histogram(
    "beacon_block_da_check_seconds", "blob availability check inside import"
)
BLOCK_STORE_WRITE_SECONDS = histogram(
    "beacon_block_store_write_seconds", "block+state persistence inside import"
)
HEAD_RECOMPUTE_SECONDS = histogram(
    "beacon_head_recompute_seconds", "fork-choice get_head + head swap"
)
STATE_ADVANCE_SECONDS = histogram(
    "beacon_state_advance_seconds",
    "tail-of-slot head-state pre-advance (state_advance_timer role)",
)

# Slot-relative delay observability (reference block_times_cache +
# metrics.rs beacon_block_delay_* / attestation delay families): every
# figure is measured against the SLOT CLOCK's start of the object's own
# slot, not wall-clock-since-receipt.
BLOCK_ARRIVAL_DELAY_SECONDS = histogram(
    "beacon_block_arrival_delay_seconds",
    "block receipt relative to its own slot start",
)
BLOCK_IMPORTED_DELAY_SECONDS = histogram(
    "beacon_block_imported_delay_seconds",
    "block import completion relative to its own slot start",
)
ATTESTATION_ARRIVAL_DELAY_SECONDS = histogram(
    "beacon_attestation_arrival_delay_seconds",
    "gossip/API attestation application relative to its slot start",
)

# Scheduler queue depth, sampled by the manager loop (reference
# beacon_processor per-queue length gauges): read NEXT TO
# device_pipeline_pending_sets to attribute queue pressure vs batch fill.
BEACON_PROCESSOR_QUEUE_DEPTH = gauge(
    "beacon_processor_queue_depth",
    "events waiting in a priority queue, sampled by the manager, by work class",
)

# Scheduler queue wait: enqueue→drain per work class (reference
# beacon_processor queue latency metrics) — fed by the same seam that
# records the per-trace queue_wait span.
QUEUE_WAIT_SECONDS = histogram(
    "beacon_processor_queue_wait_seconds",
    "enqueue-to-drain wait in the priority queues, by work class",
)

# Validator-client remote signing (validator_client/web3signer.py).
WEB3SIGNER_RETRIES = counter(
    "web3signer_retries_total",
    "web3signer requests retried after a connection error, by request kind",
)

# The Beacon API (http_api/server.py): requests by method and route
# template (never the raw path: ids stay out of the label space).
HTTP_REQUESTS = counter(
    "http_api_requests_total",
    "Beacon API requests, by method and route template",
)
HTTP_REQUEST_SECONDS = histogram(
    "http_api_request_seconds",
    "Beacon API request time, by method and route template",
)

# Checkpoint-keyed HTTP response cache (http_api/response_cache.py): per
# route-template hit/miss (hit rate per route in one PromQL expression),
# invalidations by the chain event that fired them, and occupancy.
HTTP_CACHE_HITS = counter(
    "http_response_cache_hits_total",
    "Beacon API responses served from the checkpoint-keyed cache, by route",
)
HTTP_CACHE_MISSES = counter(
    "http_response_cache_misses_total",
    "cacheable Beacon API requests that missed the cache, by route",
)
HTTP_CACHE_INVALIDATIONS = counter(
    "http_response_cache_invalidations_total",
    "cache entries invalidated by a chain event, by topic",
)
HTTP_CACHE_ENTRIES = gauge(
    "http_response_cache_entries",
    "live entries in the checkpoint-keyed response cache",
)

# The chain's event bus (chain/events.py) and its SSE stream: per-topic
# delivery vs slow-consumer drops.  A slow subscriber loses events (bounded
# queue, non-blocking publish) and the loss is counted here.
SSE_EVENTS_SENT = counter(
    "http_sse_events_sent_total",
    "server-sent events written to a subscriber stream, by topic",
)
SSE_EVENTS_DROPPED = counter(
    "http_sse_events_dropped_total",
    "server-sent events dropped on a full subscriber queue, by topic",
)

# In-process fault fabric (network/transport.py Hub): what the seeded
# per-link fault plans and the net.deliver injection point did to traffic.
NET_ENVELOPES_DROPPED = counter(
    "net_envelopes_dropped_total",
    "fabric envelopes not delivered, by reason (unlinked|partition|plan|fault|dead)",
)
NET_ENVELOPES_DELAYED = counter(
    "net_envelopes_delayed_total",
    "fabric envelopes queued for delayed delivery by a link plan",
)
NET_ENVELOPES_DUPLICATED = counter(
    "net_envelopes_duplicated_total",
    "fabric envelopes delivered twice by a link plan",
)
NET_ENVELOPES_REORDERED = counter(
    "net_envelopes_reordered_total",
    "fabric envelopes delivered ahead of earlier-due traffic by a link plan",
)

# Sync hardening (network/sync.py, network/backfill.py): aborted lookups and
# backfill batches retried against a different peer — the churn scenarios'
# evidence that a dead or lying peer cannot stall sync.
SYNC_LOOKUP_ABORTED = counter(
    "sync_lookup_aborted_total",
    "single-block/parent lookups aborted before import, by reason",
)
BACKFILL_BATCH_RETRIES = counter(
    "backfill_batch_retries_total",
    "backfill batches retried against a different peer, by outcome",
)

# Slasher pipeline (slasher/__init__.py drained by network/router.py): every
# slashing the local slasher produced, by kind and what happened to it —
# pooled+gossiped, or stale (its validator was already slashed / the op
# failed chain validation).  The byzantine scenarios' detection evidence.
SLASHER_SLASHINGS = counter(
    "slasher_slashings_total",
    "slashings drained from the local slasher, by kind and outcome",
)

# The port's hand-written CUDA kernels (ops/cuda_fq.py, cuda_sha.py,
# cuda_epoch.py): each wrapper's launch count in this process, sampled on
# scrape, so a node started on its own shows what it ran on the card.
KERNEL_LAUNCHES = gauge(
    "device_kernel_launches",
    "hand-written CUDA kernel launches in this process, by kernel",
)


def _sample_kernel_launches() -> None:
    from ..ops import cuda_epoch, cuda_fq, cuda_sha

    for module in (cuda_fq, cuda_sha, cuda_epoch):
        for name, count in list(module.LAUNCHES.items()):
            KERNEL_LAUNCHES.set(count, kernel=name)


register_collector(_sample_kernel_launches)
