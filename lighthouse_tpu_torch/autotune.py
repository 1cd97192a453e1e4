"""Self-tuning device runtime: the telemetry→knob control plane.

The port of ``lighthouse_tpu/autotune.py``.  Every signal it reads already
exists — the flight recorder's per-batch occupancy, the admission wait
histograms — and each decision is observable (``GET /lighthouse/autotune``,
``autotune_decisions_total``) and pinnable:

1. **Live bucket vocabulary.**  An effective bucket whose median dispatched
   batch fills under half its lanes earns a midpoint bucket (only where the
   vocabulary has a real >2x gap — a ratio-2 vocabulary cannot waste more
   than half from bucket quantization).  **Adoption is gated on a warmup**:
   a candidate is adopted only after one supervised dispatch of a neutral
   batch at that bucket (``ops/compile_cache.aot_warmup_op``) has run off
   the request path on the node's device and given the expected result —
   on a background thread in live mode, inline in a pinned replay.  (The
   JAX package also requires a committed XLA lowering budget for the
   bucket; the port has no XLA lowering, so ``refused_no_budget`` is an
   outcome it never emits.)  Adopted buckets overlay the static
   vocabularies (``ops/verify.py``, ``ops/sha256_device.py``,
   ``ops/epoch_device.py``, ``ops/shuffle_device.py`` consult
   :func:`bucket_vocabulary`); the static tuples remain the floor and their
   top bucket the ceiling.

2. **A measured kernel choice.**  The port's kernel with real variants of
   one function is the proposer walk (``ops/cuda_epoch.py``,
   ``WALK_LOOKAHEADS``: rounds resolved a step).  :func:`measure_walk_lookahead`
   runs a short in-situ A/B of every lookahead on one small deterministic
   walk, under a supervised dispatch (``device_supervisor.run(
   "autotune_probe", ...)``, so a hung card cannot stall startup), checks
   every lookahead's output against the others, and caches the fastest in
   the port's build directory keyed on the device's name and the torch and
   CUDA versions.  ``cuda_epoch.walk_lookahead`` consults that cache before
   the source's static default.  (The JAX package's knob here is the Fq
   product's int8/int32 lowering; the port has one lowering of that
   product, its CUDA kernel, so the snapshot's ``fq_backend`` is always
   None.)

3. **Latency-driven admission.**  Implemented in ``scheduler/admission.py``
   against this module's mode: in live mode the per-class inflight bounds
   and dequeue deadlines track observed handler latency EWMAs inside a band
   around the configured statics, and Retry-After reflects the class's
   observed drain rate.

**Determinism by construction.**  ``LIGHTHOUSE_TPU_AUTOTUNE=0|pinned|live``
(default ``pinned``).  ``0`` disables everything (and ignores the walk
cache).  ``pinned`` applies only decisions replayed from an installed pin
(keyed by *evaluation index*, never wall-clock); with no pin installed it
is exactly static behavior.  ``live`` reads the telemetry.  A live run's
decisions export as a pin (:meth:`Controller.export_pin`).

Host-side only: the device-touching legs live with the device code (the
warmup in ``ops/compile_cache.py``, the A/B probe's walk in
``ops/cuda_epoch.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import blackbox, locksmith, metrics
from .logs import get_logger

log = get_logger("autotune")

ENV = "LIGHTHOUSE_TPU_AUTOTUNE"
PIN_ENV = "LIGHTHOUSE_TPU_AUTOTUNE_PIN"
INTERVAL_ENV = "LIGHTHOUSE_TPU_AUTOTUNE_INTERVAL_S"
MODES = ("0", "pinned", "live")

#: A bucket whose median dispatched batch fills under half its lanes is
#: waste-dominated.
DENSIFY_BELOW = 0.5
#: Minimum dispatched batches at one bucket before its occupancy is
#: evidence.
MIN_SAMPLES = 8
#: An adopted bucket with zero hits over a full recorder window while its
#: op stayed busy (>= MIN_SAMPLES batches) has stopped earning its keep.
DROP_IDLE_MIN_OP_SAMPLES = MIN_SAMPLES

#: Decision-log ring bound (the artifact of record for pins/scenarios).
MAX_DECISIONS = 256

AUTOTUNE_EVALUATIONS = metrics.counter(
    "autotune_evaluations_total",
    "controller evaluation passes (live telemetry reads or pin replays)",
)
AUTOTUNE_DECISIONS = metrics.counter(
    "autotune_decisions_total",
    "controller decisions, by knob and outcome (adopted|dropped|"
    "warmup_started|warmup_pending|refused_warmup_failed|"
    "refused_above_top|refused_meshed|measured)",
)
AUTOTUNE_OVERLAY_BUCKETS = metrics.gauge(
    "autotune_overlay_buckets",
    "live bucket-vocabulary overlay size, by vocabulary",
)
AUTOTUNE_WALK_LOOKAHEAD = metrics.gauge(
    "autotune_walk_lookahead_selected",
    "measured proposer-walk lookahead selection (1 = selected), by lookahead",
)
AUTOTUNE_WALK_MEASURE_SECONDS = metrics.histogram(
    "autotune_walk_lookahead_measure_seconds",
    "per-lookahead best time of the proposer-walk A/B probe, by lookahead",
)


# ------------------------------------------------------------------- mode

_MODE: Optional[str] = None
_MODE_LOCK = locksmith.lock("autotune._MODE_LOCK")


def mode() -> str:
    """The controller mode, resolved lazily from ``LIGHTHOUSE_TPU_AUTOTUNE``
    (default ``pinned`` — with no pin installed that is exactly static
    behavior)."""
    global _MODE
    if _MODE is None:
        with _MODE_LOCK:
            if _MODE is None:
                raw = os.environ.get(ENV, "pinned").strip().lower() or "pinned"
                if raw not in MODES:
                    # resolved lazily from hot paths (admission bounds,
                    # /lighthouse/device): a typo degrades to the do-nothing
                    # default with a loud log line
                    log.warning("invalid autotune mode, using 'pinned'",
                                env=ENV, value=raw, expected=list(MODES))
                    raw = "pinned"
                _MODE = raw
    return _MODE


def set_mode(new_mode: Optional[str]) -> Optional[str]:
    """Force the mode (tests/scenarios) or reset to env (None).  Returns
    the previous forced value."""
    global _MODE
    if new_mode is not None and new_mode not in MODES:
        raise ValueError(f"unknown autotune mode {new_mode!r}")
    with _MODE_LOCK:
        prev, _MODE = _MODE, new_mode
    _refresh_active()
    return prev


def enabled() -> bool:
    return mode() != "0"


def live() -> bool:
    return mode() == "live"


# ------------------------------------------------- bucket vocabulary overlay


class VocabSpec:
    """One tunable bucket vocabulary: its static tuple (the floor), the
    telemetry op names whose flight records evidence it, and the warmup
    hook its adoption is gated on."""

    __slots__ = ("name", "static", "telemetry_ops", "warmup")

    def __init__(self, name: str, static: Sequence[int],
                 telemetry_ops: Sequence[str],
                 warmup: Optional[Callable[[int], None]]):
        self.name = name
        self.static = tuple(int(b) for b in static)
        self.telemetry_ops = tuple(telemetry_ops)
        self.warmup = warmup


#: vocabulary name -> VocabSpec; populated by the ops modules at import
#: time.  Survives reset_for_tests (it mirrors imports).
_VOCABS: Dict[str, VocabSpec] = {}

#: vocabulary name -> merged (static + adopted) tuple.  Copy-on-write: the
#: hot bucket_vocabulary() path reads it without the lock.
_MERGED: Dict[str, Tuple[int, ...]] = {}
_OVERLAY: Dict[str, Tuple[int, ...]] = {}
_OVERLAY_LOCK = locksmith.lock("autotune._OVERLAY_LOCK")

#: Fast-path flag: True iff the overlay is non-empty AND the mode allows
#: it (bucket_vocabulary() is on every device dispatch).
_ACTIVE = False


def register_vocabulary(name: str, static: Sequence[int], *,
                        telemetry_ops: Sequence[str],
                        warmup: Optional[Callable[[int], None]] = None,
                        ) -> None:
    """Called by an ops module at import time to enroll its bucket
    vocabulary.  ``warmup(bucket)`` must dispatch a neutral batch at the
    bucket and raise unless it gave the expected result.  Idempotent."""
    _VOCABS[name] = VocabSpec(name, static, telemetry_ops, warmup)


def _refresh_active() -> None:
    global _ACTIVE
    _ACTIVE = bool(_OVERLAY) and mode() != "0"


def bucket_vocabulary(name: str, static: Tuple[int, ...]) -> Tuple[int, ...]:
    """The vocabulary a dispatch should bucket against: the static tuple,
    merged with any adopted overlay buckets.  The off path (no overlay, or
    autotune disabled) returns ``static`` untouched."""
    if not _ACTIVE:
        return static
    merged = _MERGED.get(name)
    return merged if merged is not None else static


def overlay() -> Dict[str, Tuple[int, ...]]:
    with _OVERLAY_LOCK:
        return dict(_OVERLAY)


def _set_overlay(name: str, buckets: Tuple[int, ...]) -> None:
    """Replace one vocabulary's overlay (copy-on-write merge rebuild)."""
    spec = _VOCABS[name]
    with _OVERLAY_LOCK:
        if buckets:
            _OVERLAY[name] = tuple(sorted(buckets))
            _MERGED[name] = tuple(sorted(set(spec.static) | set(buckets)))
        else:
            _OVERLAY.pop(name, None)
            _MERGED.pop(name, None)
    AUTOTUNE_OVERLAY_BUCKETS.set(len(buckets), vocabulary=name)
    _refresh_active()


# --------------------------------------------------------------- controller


class Controller:
    """The one decision-maker.  ``evaluate()`` is the clock: scenarios call
    it once per slot, the live background thread on an interval —
    decisions key on the evaluation index, so a pinned replay is
    wall-clock-free by construction."""

    def __init__(self) -> None:
        self._lock = locksmith.lock("Controller._lock")
        self.evaluations = 0
        self._decisions: List[dict] = []
        self._decision_seq = 0
        self._pin: List[dict] = []
        self._pin_applied = 0
        self._pin_loaded_env = False
        #: (vocab, bucket) -> "pending" | "done" | "failed"
        self._warmups: Dict[Tuple[str, int], str] = {}
        #: last recorded outcome per (knob, vocab, action, bucket): a
        #: standing live-mode refusal re-evaluates every tick and would
        #: otherwise flood the bounded decision ring
        self._last_outcome: Dict[Tuple, str] = {}
        #: (vocab, bucket) -> flight-recorder recorded_total at adoption: a
        #: fresh adoption gets a full recorder window of evidence before
        #: the idle-drop heuristic may judge it
        self._adopted_seq: Dict[Tuple[str, int], int] = {}
        self._walk_decision: Optional[dict] = None

    # ------------------------------------------------------------- records

    def _record(self, dedupe: bool = False, **fields) -> dict:
        entry = dict(fields)
        key = (entry.get("knob"), entry.get("vocab"), entry.get("action"),
               entry.get("bucket"))
        with self._lock:
            duplicate = (dedupe
                         and self._last_outcome.get(key) == entry.get("outcome"))
            if not duplicate:
                self._last_outcome[key] = entry.get("outcome")
                # a recorded adopt/drop resets the sibling action's memory,
                # so a genuine drop→re-adopt cycle records every leg
                if entry.get("action") in ("adopt", "drop"):
                    sibling = "drop" if entry["action"] == "adopt" else "adopt"
                    self._last_outcome.pop(
                        (entry.get("knob"), entry.get("vocab"), sibling,
                         entry.get("bucket")), None)
                self._decision_seq += 1
                entry["seq"] = self._decision_seq
                self._decisions.append(entry)
                if len(self._decisions) > MAX_DECISIONS:
                    self._decisions = self._decisions[-MAX_DECISIONS:]
        AUTOTUNE_DECISIONS.inc(knob=entry.get("knob", "?"),
                               outcome=entry.get("outcome", "?"))
        if duplicate:
            return entry
        log.info("autotune decision", **{
            k: v for k, v in entry.items() if k != "measurements_s"})
        blackbox.emit("autotune", "decision", knob=entry.get("knob"),
                      action=entry.get("action"), outcome=entry.get("outcome"),
                      vocab=entry.get("vocab"), bucket=entry.get("bucket"),
                      decision_seq=entry.get("seq"))
        return entry

    def decision_log(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._decisions]

    def export_pin(self) -> List[dict]:
        """The applied bucket decisions as a replayable pin: adopt/drop
        actions with their evaluation indices."""
        out = []
        for d in self.decision_log():
            if d.get("knob") == "bucket" and d.get("outcome") in (
                    "adopted", "dropped"):
                out.append({
                    "after_evaluation": d["evaluation"],
                    "vocab": d["vocab"],
                    "action": "adopt" if d["outcome"] == "adopted" else "drop",
                    "bucket": d["bucket"],
                })
        return out

    def install_pin(self, decisions: Sequence[dict]) -> None:
        """Install a pinned decision list (sorted by evaluation index).
        Only consulted in ``pinned`` mode."""
        pin = sorted((dict(d) for d in decisions),
                     key=lambda d: int(d.get("after_evaluation", 0)))
        with self._lock:
            self._pin = pin
            self._pin_applied = 0

    def _maybe_load_env_pin(self) -> None:
        with self._lock:
            if self._pin_loaded_env or self._pin:
                return
            self._pin_loaded_env = True
        path = os.environ.get(PIN_ENV, "").strip()
        if not path:
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                self.install_pin(json.load(f))
            log.info("autotune pin loaded", path=path)
        except (OSError, ValueError) as e:
            log.warning("autotune pin unreadable", path=path, error=str(e))

    # ------------------------------------------------------------ evaluate

    def evaluate(self) -> List[dict]:
        """One control pass.  Live: read the flight recorder, walk the
        densify/drop heuristics through the guardrails.  Pinned: apply the
        pin entries whose evaluation index has arrived.  Off: nothing."""
        m = mode()
        if m == "0":
            return []
        with self._lock:
            self.evaluations += 1
            n = self.evaluations
        AUTOTUNE_EVALUATIONS.inc()
        if m == "pinned":
            self._maybe_load_env_pin()
            return self._apply_pin(n)
        return self._evaluate_live(n)

    # --- pinned replay

    def _apply_pin(self, evaluation: int) -> List[dict]:
        applied: List[dict] = []
        while True:
            with self._lock:
                if self._pin_applied >= len(self._pin):
                    return applied
                entry = self._pin[self._pin_applied]
                if int(entry.get("after_evaluation", 0)) > evaluation:
                    return applied
                self._pin_applied += 1
            applied.append(self._apply_pinned_entry(entry, evaluation))

    def _apply_pinned_entry(self, entry: dict, evaluation: int) -> dict:
        name = entry.get("vocab")
        action = entry.get("action")
        bucket = int(entry.get("bucket", 0))
        spec = _VOCABS.get(name)
        if spec is None:
            return self._record(knob="bucket", vocab=name, action=action,
                                bucket=bucket, evaluation=evaluation,
                                via="pin", outcome="refused_unknown_vocab",
                                reason=f"no registered vocabulary {name!r}")
        if action == "drop":
            current = set(overlay().get(name, ()))
            current.discard(bucket)
            _set_overlay(name, tuple(current))
            return self._record(knob="bucket", vocab=name, action="drop",
                                bucket=bucket, evaluation=evaluation,
                                via="pin", outcome="dropped",
                                reason="pinned replay")
        # adopt: the warmup gate holds for a replay too, run inline — the
        # neutral dispatch's outcome is deterministic, so the replay stays
        # wall-clock-free
        refused = self._refuse_adopt(spec, bucket, require_warmup=False)
        if refused is not None:
            return self._record(knob="bucket", vocab=name, action="adopt",
                                bucket=bucket, evaluation=evaluation,
                                via="pin", **refused)
        self._adopt(spec, bucket)
        return self._record(knob="bucket", vocab=name, action="adopt",
                            bucket=bucket, evaluation=evaluation,
                            via="pin", outcome="adopted",
                            reason="pinned replay (warmup gate held)")

    # --- live telemetry

    def _evaluate_live(self, evaluation: int) -> List[dict]:
        decisions: List[dict] = []
        for name, spec in sorted(_VOCABS.items()):
            stats = _bucket_live_stats(spec)
            effective = bucket_vocabulary(name, spec.static)
            decisions.extend(
                self._densify(spec, effective, stats, evaluation))
            decisions.extend(
                self._drop_idle(spec, stats, evaluation))
        return decisions

    def _densify(self, spec: VocabSpec, effective: Tuple[int, ...],
                 stats: Dict[int, List[int]], evaluation: int) -> List[dict]:
        out: List[dict] = []
        for i, nb in enumerate(effective):
            live_sizes = stats.get(nb, ())
            if len(live_sizes) < MIN_SAMPLES:
                continue
            ordered = sorted(live_sizes)
            p50 = ordered[len(ordered) // 2] / nb
            if p50 >= DENSIFY_BELOW:
                continue
            prev = effective[i - 1] if i else 0
            if prev <= 0 or nb <= 2 * prev:
                # ratio-2 dense below this bucket: quantization cannot
                # waste more than half — the low p50 is a traffic question
                # (linger/coalescing), not a vocabulary one.
                continue
            mid = (prev + nb) // 2
            if mid in effective:
                continue
            out.append(self._try_adopt(
                spec, mid, evaluation,
                reason=(f"bucket {nb}: p50 occupancy {p50:.2f} < "
                        f"{DENSIFY_BELOW} over {len(live_sizes)} batches — "
                        f"midpoint {mid} bounds quantization waste at "
                        "~50%")))
        return out

    def _drop_idle(self, spec: VocabSpec, stats: Dict[int, List[int]],
                   evaluation: int) -> List[dict]:
        adopted = overlay().get(spec.name, ())
        if not adopted:
            return []
        op_samples = sum(len(v) for v in stats.values())
        if op_samples < DROP_IDLE_MIN_OP_SAMPLES:
            return []
        from . import device_telemetry

        recorded = device_telemetry.FLIGHT_RECORDER.recorded_total
        window = device_telemetry.FLIGHT_RECORDER.capacity
        out: List[dict] = []
        for bucket in adopted:
            if stats.get(bucket):
                continue
            seq = self._adopted_seq.get((spec.name, bucket))
            if seq is not None and recorded - seq < window:
                continue  # adopted inside the current evidence window
            current = set(overlay().get(spec.name, ()))
            current.discard(bucket)
            _set_overlay(spec.name, tuple(current))
            out.append(self._record(
                knob="bucket", vocab=spec.name, action="drop",
                bucket=bucket, evaluation=evaluation, via="live",
                outcome="dropped",
                reason=(f"zero dispatches at {bucket} across the last "
                        f"{op_samples} recorded batches — the traffic "
                        "that earned it has moved")))
        return out

    def _refuse_adopt(self, spec: VocabSpec, bucket: int,
                      require_warmup: bool) -> Optional[dict]:
        """The guardrails, in order.  Returns outcome/reason fields when
        the adoption must be refused (or deferred), None when it may
        proceed.  ``require_warmup`` (live mode) runs the warmup on a
        background thread and defers until it is done; otherwise (a pinned
        replay) the warmup runs inline."""
        if bucket >= spec.static[-1]:
            return {"outcome": "refused_above_top",
                    "reason": (f"{bucket} >= static top {spec.static[-1]} — "
                               "the top bucket bounds chunking semantics "
                               "and stays a reviewed-diff decision")}
        from . import device_mesh

        if device_mesh.enabled():
            # A meshed dispatch at the new bucket splits into row blocks no
            # warmup covered (the warmup dispatches single-device).
            return {"outcome": "refused_meshed",
                    "reason": (f"device mesh is enabled (size "
                               f"{device_mesh.size()}): the warmup covers the "
                               "single-device dispatch only — mesh-aware "
                               "adoption needs a per-topology warmup")}
        if bucket in bucket_vocabulary(spec.name, spec.static):
            return {"outcome": "noop", "reason": "already in the vocabulary"}
        if spec.warmup is None:
            return {"outcome": "refused_warmup_failed",
                    "reason": "vocabulary registered no warmup hook"}
        if not require_warmup:
            try:
                spec.warmup(bucket)
            except Exception as e:  # noqa: BLE001 — a refusal, logged
                log.warning("autotune warmup failed", vocab=spec.name,
                            bucket=bucket, error=f"{type(e).__name__}: {e}")
                return {"outcome": "refused_warmup_failed",
                        "reason": f"warmup dispatch failed: {type(e).__name__}"}
            return None
        with self._lock:
            state = self._warmups.get((spec.name, bucket))
        if state == "done":
            return None
        if state == "failed":
            return {"outcome": "refused_warmup_failed",
                    "reason": "off-path warmup dispatch failed — see logs"}
        if state == "pending":
            return {"outcome": "warmup_pending",
                    "reason": "off-path warmup dispatch still running"}
        self._start_warmup(spec, bucket)
        return {"outcome": "warmup_started",
                "reason": ("a neutral batch must run at the bucket on the "
                           "device, off the request path, before the first "
                           "production batch lands on it — warmup started "
                           "on a background thread")}

    def _try_adopt(self, spec: VocabSpec, bucket: int, evaluation: int,
                   reason: str) -> dict:
        refused = self._refuse_adopt(spec, bucket, require_warmup=True)
        if refused is not None:
            # dedupe: a standing refusal re-reached every evaluation must
            # not flood the bounded ring (it records once per outcome)
            return self._record(dedupe=True, knob="bucket", vocab=spec.name,
                                action="adopt", bucket=bucket,
                                evaluation=evaluation, via="live",
                                trigger=reason, **refused)
        self._adopt(spec, bucket)
        return self._record(knob="bucket", vocab=spec.name, action="adopt",
                            bucket=bucket, evaluation=evaluation, via="live",
                            outcome="adopted", reason=reason)

    def _adopt(self, spec: VocabSpec, bucket: int) -> None:
        from . import device_telemetry

        current = set(overlay().get(spec.name, ()))
        current.add(bucket)
        _set_overlay(spec.name, tuple(current))
        self._adopted_seq[(spec.name, bucket)] = \
            device_telemetry.FLIGHT_RECORDER.recorded_total

    def _start_warmup(self, spec: VocabSpec, bucket: int) -> None:
        key = (spec.name, bucket)
        with self._lock:
            self._warmups[key] = "pending"

        def work() -> None:
            try:
                spec.warmup(bucket)
            except Exception:
                log.warning("autotune warmup failed", vocab=spec.name,
                            bucket=bucket, exc_info=True)
                self._finish_warmup(key, "failed")
            else:
                self._finish_warmup(key, "done")

        threading.Thread(
            target=work, daemon=True,
            name=f"autotune-warm-{spec.name}-{bucket}").start()

    def _finish_warmup(self, key: Tuple[str, int], state: str) -> None:
        """Completion callback, generation-safe: a warmup finishing AFTER a
        reset finds its 'pending' entry gone and does not resurrect it."""
        with self._lock:
            if self._warmups.get(key) == "pending":
                self._warmups[key] = state

    def warmup_state(self, name: str, bucket: int) -> Optional[str]:
        """``pending`` / ``done`` / ``failed`` for a live-mode warmup."""
        with self._lock:
            return self._warmups.get((name, int(bucket)))

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        with self._lock:
            pin = [dict(d) for d in self._pin]
            pin_applied = self._pin_applied
            evaluations = self.evaluations
            warmups = {f"{k[0]}:{k[1]}": v for k, v in self._warmups.items()}
            walk = dict(self._walk_decision) if self._walk_decision else None
        return {
            "mode": mode(),
            "evaluations": evaluations,
            "vocabularies": {
                name: {
                    "static": list(spec.static),
                    "overlay": list(overlay().get(name, ())),
                    "effective": list(
                        bucket_vocabulary(name, spec.static)),
                }
                for name, spec in sorted(_VOCABS.items())
            },
            "warmups": warmups,
            "decisions": self.decision_log(),
            "pin": {"installed": len(pin), "applied": pin_applied,
                    "entries": pin},
            # the JAX package's measured Fq-lowering choice: the port has
            # one lowering (its CUDA kernel), so there is nothing to pick
            "fq_backend": None,
            "walk_lookahead": walk or cached_walk_lookahead(),
        }

    def reset(self) -> None:
        with self._lock:
            self.evaluations = 0
            self._decisions = []
            self._decision_seq = 0
            self._pin = []
            self._pin_applied = 0
            self._pin_loaded_env = False
            self._warmups = {}
            self._adopted_seq = {}
            self._last_outcome = {}
            self._walk_decision = None


CONTROLLER = Controller()


def _bucket_live_stats(spec: VocabSpec) -> Dict[int, List[int]]:
    """bucket size -> live sizes of the dispatched batches that ran at it,
    over the flight-recorder window of the spec's telemetry ops.  Records
    that never dispatched (no ``occupancy_sets``) stay out."""
    from . import device_telemetry

    stats: Dict[int, List[int]] = {}
    for op in spec.telemetry_ops:
        for r in device_telemetry.FLIGHT_RECORDER.recent(
                limit=device_telemetry.FLIGHT_RECORDER.capacity, op=op):
            if "occupancy_sets" not in r:
                continue
            shape = str(r.get("shape", ""))
            try:
                nb = int(shape.split("@")[0].split("x")[0])
            except ValueError:
                continue
            stats.setdefault(nb, []).append(int(r.get("n_live", 0)))
    return stats


# ------------------------------------------------- the measured walk choice

#: The A/B probe's walk: mainnet's 32 slots x 64 candidates x 90 rounds,
#: over a 2^20-validator active set (the pivots' modulus).
PROBE_SLOTS = 32
PROBE_CANDIDATES = 64
PROBE_ROUNDS = 90
PROBE_ACTIVE = 1 << 20


def walk_cache_path() -> str:
    """The decision cache lives in the port's build directory, beside the
    kernel libraries whose variants it picks between."""
    from .ops.cuda_build import BUILD_DIR

    return os.path.join(str(BUILD_DIR), "autotune_walk_lookahead.json")


def walk_cache_key(device=None) -> str:
    """``<device name>|torch-<version>|cuda-<version>``: what the measured
    choice depends on."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = dev.type
    return f"{name}|torch-{torch.__version__}|cuda-{torch.version.cuda}"


_WALK_MEMO: Dict[str, Tuple[float, dict]] = {}
_WALK_MEMO_LOCK = locksmith.lock("autotune._WALK_MEMO_LOCK")


def _read_walk_cache(path: str) -> dict:
    """The cache file's document (memoized by modification time); an
    unreadable or corrupt file reads as no cache."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    with _WALK_MEMO_LOCK:
        memo = _WALK_MEMO.get(path)
        if memo is not None and memo[0] == mtime:
            return memo[1]
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            doc = {}
    except (OSError, ValueError):
        doc = {}
    with _WALK_MEMO_LOCK:
        _WALK_MEMO[path] = (mtime, doc)
    return doc


def cached_walk_lookahead(device=None) -> Optional[dict]:
    """The cached measured decision for this device, torch and CUDA, or
    None (no measurement yet, no card, cache unreadable, or autotune off:
    mode ``0`` ignores the cache)."""
    if not enabled():
        return None
    try:
        import torch

        if device is None and not torch.cuda.is_available():
            return None
        key = walk_cache_key(device)
    except Exception:
        return None
    entry = _read_walk_cache(walk_cache_path()).get(key)
    from .ops.cuda_epoch import WALK_LOOKAHEADS

    if not isinstance(entry, dict) or entry.get("lookahead") not in WALK_LOOKAHEADS:
        return None
    return entry


def _probe_inputs(device):
    """The probe walk's deterministic inputs on ``device``."""
    import hashlib

    import numpy as np
    import torch

    seed_words = np.zeros((PROBE_SLOTS, 8), dtype=np.uint32)
    pivots = np.zeros((PROBE_SLOTS, PROBE_ROUNDS), dtype=np.int32)
    for s in range(PROBE_SLOTS):
        seed = hashlib.sha256(b"autotune walk probe" + s.to_bytes(8, "little")).digest()
        seed_words[s] = np.frombuffer(seed, dtype=">u4")
        for r in range(PROBE_ROUNDS):
            pivots[s, r] = int.from_bytes(
                hashlib.sha256(seed + bytes([r])).digest()[:8], "little") % PROBE_ACTIVE
    return (torch.from_numpy(seed_words.view(np.int32)).to(device),
            torch.from_numpy(pivots).to(device))


def _probe_walk(device, k: int, reps: int) -> Tuple[float, "object"]:
    """``reps`` walks at lookahead ``k`` on ``device``: the best seconds
    (CUDA events on a card) and the output (on the host)."""
    import torch

    from .ops import cuda_epoch
    from .ops.devices import on_device

    seed_words, pivots = _probe_inputs(device)
    best = float("inf")
    out = None
    with on_device(device):
        for _ in range(max(1, reps)):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = cuda_epoch._proposer_walk_k(seed_words, pivots, PROBE_CANDIDATES,
                                                  PROBE_ACTIVE, k)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1000.0
            else:
                t0 = time.perf_counter()
                out = cuda_epoch._proposer_walk_k(seed_words, pivots, PROBE_CANDIDATES,
                                                  PROBE_ACTIVE, k)
                seconds = time.perf_counter() - t0
            best = min(best, seconds)
    return best, out.cpu()


def measure_walk_lookahead(force: bool = False, device="cuda", reps: int = 3) -> dict:
    """Run (or reuse) the in-situ proposer-walk lookahead A/B.

    Every lookahead of ``cuda_epoch.WALK_LOOKAHEADS`` walks the same small
    deterministic batch ``reps`` times in one supervised dispatch each
    (op ``autotune_probe``: watchdogged; on the card a failure raises, it
    never answers from the host); every lookahead's positions must equal
    the others' or this raises.  The fastest is cached per
    :func:`walk_cache_key` in :func:`walk_cache_path` and read by
    ``cuda_epoch.walk_lookahead``."""
    import torch

    from . import device_supervisor
    from .ops.cuda_epoch import WALK_LOOKAHEADS
    from .ops.devices import resolve_device

    device = resolve_device(device)
    if not force:
        cached = cached_walk_lookahead(device)
        if cached is not None:
            return cached
    key = walk_cache_key(device)
    measurements: Dict[str, float] = {}
    outputs = {}
    for k in WALK_LOOKAHEADS:
        seconds, out = device_supervisor.run(
            "autotune_probe", lambda k=k: _probe_walk(device, k, reps),
            host_on_failure=False)
        measurements[str(k)] = round(float(seconds), 9)
        outputs[k] = out
        AUTOTUNE_WALK_MEASURE_SECONDS.observe(seconds, lookahead=str(k))
    first = outputs[WALK_LOOKAHEADS[0]]
    for k, out in outputs.items():
        if not torch.equal(out, first):
            raise RuntimeError(
                f"walk lookahead {k} disagrees with lookahead {WALK_LOOKAHEADS[0]}")
    winner = min(WALK_LOOKAHEADS, key=lambda k: measurements[str(k)])
    decision = {
        "lookahead": winner,
        "measurements_s": measurements,
        "source": "measured",
        "key": key,
        "shape": [PROBE_SLOTS, PROBE_CANDIDATES, PROBE_ROUNDS],
        "reps": reps,
    }
    for k in WALK_LOOKAHEADS:
        AUTOTUNE_WALK_LOOKAHEAD.set(1.0 if k == winner else 0.0, lookahead=str(k))
    _write_walk_cache(key, decision)
    with CONTROLLER._lock:
        CONTROLLER._walk_decision = decision
    CONTROLLER._record(knob="walk_lookahead", action="select", lookahead=winner,
                       outcome="measured", measurements_s=measurements,
                       reason=(f"A/B probe of {PROBE_SLOTS} x {PROBE_CANDIDATES} "
                               f"x {PROBE_ROUNDS} (best of {reps} walks per "
                               "lookahead, one supervised dispatch each)"))
    return decision


def _write_walk_cache(key: str, decision: dict) -> None:
    path = walk_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = dict(_read_walk_cache(path))
    doc[key] = decision
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


# ----------------------------------------------------------- startup hook

_THREAD: Optional[threading.Thread] = None
_THREAD_STOP: Optional[threading.Event] = None
_THREAD_LOCK = locksmith.lock("autotune._THREAD_LOCK")


def maybe_start_from_env(device="cuda") -> Optional[threading.Thread]:
    """Node-startup hook (``ClientBuilder.build``): in live mode, measure
    the walk lookahead on ``device`` when it is a card (cached across
    restarts; a failing probe raises to the caller) and start the periodic
    controller thread.  Pinned/off modes start nothing."""
    global _THREAD, _THREAD_STOP
    if not live():
        return None
    import torch

    if torch.device(device).type == "cuda":
        decision = measure_walk_lookahead(device=device)
        log.info("measured walk lookahead applied",
                 lookahead=decision["lookahead"])
    interval = float(os.environ.get(INTERVAL_ENV, "30"))
    with _THREAD_LOCK:
        if (_THREAD is not None and _THREAD.is_alive()
                and _THREAD_STOP is not None and not _THREAD_STOP.is_set()):
            return _THREAD
        # each controller thread owns its OWN stop event: a stop() racing
        # a restart can only stop the thread it targeted
        stop_event = threading.Event()

        def loop() -> None:
            while not stop_event.wait(interval):
                try:
                    CONTROLLER.evaluate()
                except Exception:
                    log.warning("autotune evaluation failed", exc_info=True)

        _THREAD_STOP = stop_event
        _THREAD = threading.Thread(target=loop, daemon=True, name="autotune")
        _THREAD.start()
        return _THREAD


def stop() -> None:
    with _THREAD_LOCK:
        if _THREAD_STOP is not None:
            _THREAD_STOP.set()


def snapshot() -> dict:
    return CONTROLLER.snapshot()


def reset_for_tests() -> None:
    """Clear controller state, overlay, the walk-cache memo and the forced
    mode (registrations persist — they mirror module imports)."""
    stop()
    CONTROLLER.reset()
    with _OVERLAY_LOCK:
        _OVERLAY.clear()
        _MERGED.clear()
    with _WALK_MEMO_LOCK:
        _WALK_MEMO.clear()
    set_mode(None)
