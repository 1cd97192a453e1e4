"""Deterministic fault injection for the device-execution boundary.

The port of ``lighthouse_tpu/fault_injection.py``.  Every hot-path
signature and blob batch funnels through a handful of device entry points
— which also makes those entry points a single point of failure.  The
supervisor (``device_supervisor.py``) exists to survive device errors,
failed kernel builds and hung dispatches; this module exists to *prove*
it does, on the CPU and on the card, without real hardware misbehaving on
cue.

Model: a registry of named **injection points** threaded through the
codebase (:data:`POINTS`) and a set of **fault plans** installed against
them.  A plan has a mode — ``error`` (raise :class:`InjectedFault`),
``hang`` (sleep, so dispatch watchdogs can be exercised), ``corrupt``
(return the "corrupt the verdict" action to the caller) — plus optional
scoping: fire only for a given ``op`` label, only the ``first_n`` matching
calls, or with ``probability`` p from a **seeded** RNG so a chaos run is
reproducible bit-for-bit.

Configured two ways:

- env ``LIGHTHOUSE_TPU_FAULTS`` at process start, e.g.
  ``device.dispatch[op=bls_verify]=error;store.write=error:first_n=2``
- at runtime through :func:`install` / :func:`clear` (the JAX package's
  HTTP admin surface over them comes with the port's HTTP API).

Disabled (the default) this is a no-op: injection sites call
:func:`check`/:func:`fire`, whose first instruction tests the module-level
:data:`ACTIVE` flag and returns — no lock, no dict lookup, no measurable
cost on the device dispatch path.
"""

from __future__ import annotations

import hashlib
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional

from . import metrics
from .logs import get_logger
from .timeout_lock import TimeoutLock

log = get_logger("faults")

#: Injection points, the JAX package's names.  The port wires the three
#: ``device.*`` points (``ops/verify.py``, ``ops/kzg_device.py``); the
#: others wait for the modules that hold their call sites (store, engine,
#: signer, network transport, the HTTP API).
POINTS = (
    "device.dispatch",   # ops/verify.py, ops/kzg_device.py
    "device.compile",    # same sites, fired only when the (op, shape) is first-seen
    "device.result",     # verdict stage (supports mode=corrupt)
    "store.write",
    "engine.request",
    "signer.request",
    "net.deliver",
    "api.handler",
)

MODES = ("error", "hang", "corrupt")

#: Fast-path flag: True iff at least one plan is installed.  Read without a
#: lock by every injection site (benign race: a stale read delays a plan by
#: at most one call).
ACTIVE = False

FAULT_INJECTIONS_FIRED = metrics.counter(
    "fault_injections_fired_total",
    "injected faults actually fired, by injection point and mode",
)


class InjectedFault(RuntimeError):
    """Raised at an injection point by an ``error``-mode fault plan."""


# ------------------------------------------------------------ slot keying
#
# Scenario runs route many concurrent dispatches through the same injection
# points, and the ARRIVAL ORDER of those calls is scheduler-dependent — a
# ``first_n``/``probability`` plan keyed on a call counter fires on a
# different dispatch from run to run (the ~1/6 ``device_breaker_mid_sync``
# determinism flake).  When the embedding harness can name the logical
# *slot* a call belongs to, plans key their decisions on (slot, per-slot
# call index) instead: same fault plan + same slot timeline => the same
# dispatches fault, regardless of thread interleaving across slots.

#: Returns the current logical slot, or ``None`` outside any slot context.
_SLOT_PROVIDER: Optional[Callable[[], Optional[int]]] = None


def set_slot_provider(fn: Optional[Callable[[], Optional[int]]]) -> None:
    """Install (or clear, with ``None``) the logical-slot source.  The
    scenario runner installs its simulator clock here for the duration of
    a run; production never sets one, so plans keep arrival-order
    semantics outside the harness."""
    global _SLOT_PROVIDER
    _SLOT_PROVIDER = fn


def current_slot() -> Optional[int]:
    fn = _SLOT_PROVIDER
    if fn is None:
        return None
    try:
        slot = fn()
    except Exception:
        return None
    return None if slot is None else int(slot)


class FaultPlan:
    """One installed fault: where, what, and how often."""

    def __init__(
        self,
        point: str,
        mode: str = "error",
        *,
        op: Optional[str] = None,
        sleep_s: float = 2.0,
        first_n: Optional[int] = None,
        probability: Optional[float] = None,
        seed: Optional[int] = None,
        message: Optional[str] = None,
    ):
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} (know: {POINTS})")
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (know: {MODES})")
        if first_n is not None and probability is not None:
            raise ValueError("first_n and probability are mutually exclusive")
        if probability is not None and not (0.0 <= probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if first_n is not None and first_n < 1:
            raise ValueError("first_n must be >= 1")
        self.point = point
        self.mode = mode
        self.op = op
        self.sleep_s = float(sleep_s)
        self.first_n = first_n
        self.probability = probability
        self.seed = seed
        self.message = message
        self.plan_id = 0  # assigned by the registry on install
        self.hits = 0     # matching calls evaluated
        self.fired = 0    # faults actually injected
        self._calls = 0
        # Seeded RNG => a probabilistic chaos run replays identically.
        self._rng = random.Random(0xFA17 if seed is None else seed)
        # Slot-keyed state (see the module's slot-keying section).
        self._first_slot: Optional[int] = None
        self._slot_calls: Dict[int, int] = {}

    def matches(self, op: Optional[str]) -> bool:
        return self.op is None or self.op == op

    def should_fire(self) -> bool:
        """Decide this call (caller holds the registry lock).  With a slot
        provider installed the decision is a pure function of
        ``(plan, slot, per-slot call index)`` — thread interleaving across
        slots cannot move which dispatch faults."""
        slot = current_slot()
        if slot is None:
            self._calls += 1
            if self.first_n is not None:
                return self._calls <= self.first_n
            if self.probability is not None:
                return self._rng.random() < self.probability
            return True
        k = self._slot_calls.get(slot, 0)
        self._slot_calls[slot] = k + 1
        if self.first_n is not None:
            # All first_n firings land in the first slot this plan SEES —
            # a later-slot call can never steal the budget from it.
            if self._first_slot is None:
                self._first_slot = slot
            return slot == self._first_slot and k < self.first_n
        if self.probability is not None:
            seed = 0xFA17 if self.seed is None else self.seed
            digest = hashlib.sha256(
                seed.to_bytes(8, "little", signed=True)
                + slot.to_bytes(8, "little", signed=True)
                + k.to_bytes(8, "little")
            ).digest()
            draw = int.from_bytes(digest[:8], "little") / 2.0 ** 64
            return draw < self.probability
        return True

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {
            "id": self.plan_id,
            "point": self.point,
            "mode": self.mode,
            "hits": self.hits,
            "fired": self.fired,
        }
        if self.op is not None:
            out["op"] = self.op
        if self.mode == "hang":
            out["sleep_s"] = self.sleep_s
        if self.first_n is not None:
            out["first_n"] = self.first_n
        if self.probability is not None:
            out["probability"] = self.probability
            out["seed"] = self.seed
        if self.message is not None:
            out["message"] = self.message
        return out


class FaultRegistry:
    def __init__(self) -> None:
        self._lock = TimeoutLock("fault_registry", label="FaultRegistry._lock")
        self._plans: List[FaultPlan] = []
        self._next_id = 1

    def install(self, plan: FaultPlan) -> FaultPlan:
        global ACTIVE
        with self._lock:
            plan.plan_id = self._next_id
            self._next_id += 1
            self._plans.append(plan)
            ACTIVE = True
        log.warning(
            "fault plan installed", point=plan.point, mode=plan.mode,
            op=plan.op or "*", plan_id=plan.plan_id,
        )
        return plan

    def clear(self, point: Optional[str] = None,
              plan_id: Optional[int] = None) -> int:
        """Remove plans (all, by point, or by id); returns how many."""
        global ACTIVE
        with self._lock:
            keep = [
                p for p in self._plans
                if (point is not None and p.point != point)
                or (plan_id is not None and p.plan_id != plan_id)
            ] if (point is not None or plan_id is not None) else []
            removed = len(self._plans) - len(keep)
            self._plans = keep
            ACTIVE = bool(self._plans)
        if removed:
            log.warning("fault plans cleared", n=removed, point=point or "*")
        return removed

    def plans(self) -> List[dict]:
        with self._lock:
            return [p.to_dict() for p in self._plans]

    def fire(self, point: str, op: Optional[str] = None) -> Optional[str]:
        """Evaluate every plan at ``point``; sleep for hang plans, raise for
        error plans, and return ``"corrupt"`` when a corrupt plan fired.
        Effects run OUTSIDE the registry lock (a hang must stall only the
        faulted call, never the admin surface)."""
        to_fire: List[FaultPlan] = []
        with self._lock:
            for plan in self._plans:
                if plan.point != point or not plan.matches(op):
                    continue
                plan.hits += 1
                if plan.should_fire():
                    plan.fired += 1
                    to_fire.append(plan)
        action: Optional[str] = None
        for plan in to_fire:
            FAULT_INJECTIONS_FIRED.inc(point=point, mode=plan.mode)
            log.warning(
                "injected fault fired", point=point, mode=plan.mode,
                op=op or "*", plan_id=plan.plan_id,
            )
            # Lazy import: blackbox imports this module for slot keying,
            # so the journal hook must not create an import-time cycle.
            from . import blackbox

            blackbox.emit("fault", "fired", point=point, mode=plan.mode,
                          op=op or "*", plan_id=plan.plan_id)
            if plan.mode == "hang":
                _sleeper(plan.sleep_s)
            elif plan.mode == "error":
                raise InjectedFault(
                    plan.message
                    or f"injected fault at {point} (plan {plan.plan_id})"
                )
            else:  # corrupt — the caller applies it to its verdict
                action = "corrupt"
        return action


REGISTRY = FaultRegistry()

# Injectable hang sleeper: a hang plan's stall is control-path
# time.  The scenario runner installs its virtual clock's ``sleep`` so an
# injected 2 s hang burns 2 VIRTUAL seconds (one real yield) — long-horizon
# soaks stay cheap and breaker/deadline interactions stay deterministic.
_sleeper: Callable[[float], None] = time.sleep


def set_sleeper(fn: Optional[Callable[[float], None]] = None) -> None:
    global _sleeper
    _sleeper = fn if fn is not None else time.sleep


# ------------------------------------------------------------- injection API


def fire(point: str, op: Optional[str] = None) -> Optional[str]:
    """The injection-site entry point: no-op unless a plan is installed.
    May raise :class:`InjectedFault`, sleep, or return ``"corrupt"``."""
    if not ACTIVE:
        return None
    return REGISTRY.fire(point, op=op)


def check(point: str, op: Optional[str] = None) -> None:
    """:func:`fire` for sites with no verdict to corrupt."""
    if not ACTIVE:
        return
    REGISTRY.fire(point, op=op)


def install(point: str, mode: str = "error", **kwargs) -> FaultPlan:
    return REGISTRY.install(FaultPlan(point, mode, **kwargs))


def clear(point: Optional[str] = None, plan_id: Optional[int] = None) -> int:
    return REGISTRY.clear(point=point, plan_id=plan_id)


def plans() -> List[dict]:
    return REGISTRY.plans()


# ------------------------------------------------------------- plan parsing


def _parse_value(key: str, raw: str):
    if key in ("first_n", "seed"):
        return int(raw)
    if key in ("probability", "sleep_s"):
        return float(raw)
    if key in ("op", "message"):
        return raw
    raise ValueError(f"unknown fault-plan argument {key!r}")


def parse_plan(entry: str) -> FaultPlan:
    """One plan from the compact spec syntax::

        point[op=<op>]=mode[:k=v[,k=v...]]

    e.g. ``device.dispatch[op=bls_verify]=error``,
    ``device.dispatch=hang:sleep_s=5``,
    ``store.write=error:first_n=2``,
    ``device.result=corrupt:probability=0.5,seed=42``.
    """
    entry = entry.strip()
    if "=" not in entry:
        raise ValueError(f"fault plan {entry!r}: expected point=mode")
    target, _, modespec = entry.partition("]=") if "]=" in entry else entry.partition("=")
    op = None
    if "[" in target:
        point, _, selector = target.partition("[")
        selector = selector.rstrip("]")
        skey, _, sval = selector.partition("=")
        if skey.strip() != "op" or not sval:
            raise ValueError(f"fault plan {entry!r}: only [op=<name>] selectors are supported")
        op = sval.strip()
    else:
        point = target
    point = point.strip()
    mode, _, argstr = modespec.partition(":")
    kwargs: Dict[str, Any] = {"op": op}
    for pair in filter(None, (a.strip() for a in argstr.split(","))):
        key, eq, raw = pair.partition("=")
        if not eq:
            raise ValueError(f"fault plan {entry!r}: argument {pair!r} is not k=v")
        kwargs[key.strip()] = _parse_value(key.strip(), raw.strip())
    return FaultPlan(point, mode.strip() or "error", **kwargs)


def parse_spec(text: str) -> List[FaultPlan]:
    """Parse a ``;``-separated list of plan entries (the env-var syntax)."""
    return [parse_plan(e) for e in filter(None, (s.strip() for s in text.split(";")))]


def configure_from_env(env_var: str = "LIGHTHOUSE_TPU_FAULTS") -> int:
    """Install every plan named in ``env_var``; returns how many."""
    text = os.environ.get(env_var, "")
    if not text:
        return 0
    installed = 0
    for plan in parse_spec(text):
        REGISTRY.install(plan)
        installed += 1
    return installed


def summary() -> dict:
    return {"active": ACTIVE, "plans": plans(), "points": list(POINTS)}


def reset_for_tests() -> None:
    set_sleeper(None)
    clear()


# Plans named in the environment apply from the first import — a node
# started under LIGHTHOUSE_TPU_FAULTS=... is faulted from genesis.
configure_from_env()
