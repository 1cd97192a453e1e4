"""Mesh-sharding subsystem: a data-parallel device mesh in the dispatch path.

The port of ``lighthouse_tpu/device_mesh.py``.  The layer between the
``ops/batch_axes.py`` contract and the bucketed entry points:

- **mesh construction** — :func:`configure` reads ``LIGHTHOUSE_TPU_MESH``
  (``0``/``off``/empty = disabled, ``N`` = the first N devices, ``auto`` =
  every device) over a list of ``torch.device``\\ s: by default
  ``cuda:0 … cuda:{torch.cuda.device_count()-1}``; a caller may pass its
  own list, and it may name one device more than once (``[cpu]*8``, or
  ``[cuda:0, cuda:0]``: two shards on one card).  Fewer than 2 usable
  devices disables the mesh: every op then runs the single-device path
  unchanged.  A member is known by its **mesh index** (its position in the
  configured list), so two shards on one card keep separate breakers.
- **placement derived from the registry** — :class:`ShardedEntry` reads an
  entry point's ``BATCH_AXES`` declaration.  PyTorch has no SPMD compiler
  behind it, so the port does what jax's partitioner did by hand:
  :meth:`ShardedEntry.place` splits each batched argument into contiguous
  row blocks, one per shard, uploaded to that shard's device, and copies
  each replicated argument to every shard (callers pad the batch axis to a
  multiple of the mesh size first, :func:`pad_rows`, with the same neutral
  rows the bucket padding uses); :meth:`ShardedEntry.run` runs a per-shard
  program on each shard's device and its own CUDA stream and brings the
  outputs to the mesh's first device.  The combine step is explicit per
  entry point (``ops/verify.py``, ``ops/kzg_device.py``: partial sums
  combined before one pairing check; ``ops/sha256_device.py``,
  ``ops/tree_hash.py``: rows concatenated in order;
  ``ops/epoch_device.py``, ``ops/shuffle_device.py``: the participating
  sums added on the first member and sent back to every shard
  (:func:`replicate`) before each finishes its rows, the shuffle's blocks
  gathered into the whole list on every member after each round
  (:meth:`ShardedEntry.blocks` names each shard's block), the proposer
  walk on the first member over the gathered rows).
- **per-device breakers** — a dispatch failure while the mesh is active is
  charged to a member (the one the error names — ``cuda:N`` or ``device
  N``, see :data:`_DEVICE_ID_RE` — else the deterministic suspect, the
  highest-index survivor).  A member whose breaker trips is removed and the
  mesh **re-shards over the survivors**: the generation moves, the
  telemetry mirror drops the old topology's entries
  (``device_telemetry.COMPILE_CACHE.invalidate_meshed``),
  ``device_mesh_size`` / ``device_mesh_reshards_total`` move, and the
  supervisor retries the batch on the shrunk mesh.  Below 2 survivors the
  mesh is off and the op-level breaker owns failures again (on the card
  they raise).

Thread discipline: the mutable state sits behind one ``TimeoutLock``;
``generation()`` is the cheap read callers key their placements on.  The
module imports neither torch nor ``ops/`` at import time (the pipeline
imports it for :func:`scale_target`).
"""

from __future__ import annotations

import inspect
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import blackbox, metrics
from .logs import get_logger
from .timeout_lock import TimeoutLock

log = get_logger("device_mesh")

#: The one mesh axis: pure data parallelism over the batch axis.
AXIS = "dp"

MESH_ENV = "LIGHTHOUSE_TPU_MESH"

#: Consecutive failures charged to one member before its breaker trips and
#: the mesh re-shards without it.  Deliberately lower than the op breaker's
#: threshold: shrinking the mesh is cheap and reversible-by-restart, while
#: an op trip fails every batch of the op.
DEVICE_FAILURE_THRESHOLD_ENV = "LIGHTHOUSE_TPU_MESH_DEVICE_FAILURES"
DEFAULT_DEVICE_FAILURE_THRESHOLD = 2

#: How the CUDA runtime and PyTorch name a failing card in an error:
#: ``cuda:1``, ``device 1``, ``device_ordinal: 1``.  The number is a CUDA
#: ordinal; :meth:`MeshState.suspect_device` maps it back to a mesh index.
_DEVICE_ID_RE = re.compile(
    r"(?:cuda:|device(?:_ordinal)?[ _:#]*)(\d+)", re.IGNORECASE
)


def _registry() -> dict:
    from .ops.batch_axes import BATCH_AXES

    return BATCH_AXES


def _default_devices() -> list:
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class _DeviceBreaker:
    """Per-member failure counter: CLOSED until ``threshold`` consecutive
    charged failures, then OPEN (sticky — a removed member rejoins only via
    an operator reset/restart)."""

    __slots__ = ("device_id", "threshold", "failures", "open", "last_reason")

    def __init__(self, device_id: int, threshold: int):
        self.device_id = device_id
        self.threshold = threshold
        self.failures = 0
        self.open = False
        self.last_reason: Optional[str] = None

    def record(self, reason: str) -> bool:
        """Charge one failure; True iff this charge tripped the breaker."""
        self.failures += 1
        self.last_reason = reason
        if not self.open and self.failures >= self.threshold:
            self.open = True
            return True
        return False

    def snapshot(self) -> dict:
        return {
            "device": self.device_id,
            "state": "open" if self.open else "closed",
            "failures": self.failures,
            "threshold": self.threshold,
            "last_reason": self.last_reason,
        }


class MeshState:
    """The process-wide mesh: members, breakers, topology generation."""

    def __init__(self) -> None:
        self._lock = TimeoutLock("device_mesh", label="MeshState._lock")
        self._configured = False
        #: live members in mesh-index order: (mesh index, torch.device)
        self._devices: List[Tuple[int, Any]] = []
        self._full_size = 0
        self._generation = 0
        self._reshards_total = 0
        self._breakers: Dict[int, _DeviceBreaker] = {}
        self._threshold = DEFAULT_DEVICE_FAILURE_THRESHOLD
        #: (generation, mesh index) -> the member's CUDA stream
        self._streams: Dict[Tuple[int, int], Any] = {}

    # ---------------------------------------------------------- configure

    def configure(self, spec: Optional[str] = None,
                  devices: Optional[Sequence[Any]] = None) -> int:
        """(Re)build the mesh per ``spec`` (default: the env var) over
        ``devices`` (default: every visible CUDA device).  Returns the
        active mesh size (0 = disabled).  An explicit call always rebuilds
        from the full list."""
        raw = (spec if spec is not None
               else os.environ.get(MESH_ENV, "0")).strip().lower()
        threshold = max(1, int(os.environ.get(
            DEVICE_FAILURE_THRESHOLD_ENV, str(DEFAULT_DEVICE_FAILURE_THRESHOLD))))
        chosen: list = []
        if raw not in ("", "0", "off", "false"):
            import torch

            available = ([torch.device(d) for d in devices] if devices is not None
                         else _default_devices())
            want = len(available) if raw == "auto" else int(raw)
            chosen = available[: max(0, want)]
        if len(chosen) < 2:
            chosen = []  # single device: the mesh buys nothing, stay off
        members = list(enumerate(chosen))
        with self._lock:
            self._configured = True
            self._threshold = threshold
            self._devices = members
            self._full_size = len(members)
            self._breakers = {i: _DeviceBreaker(i, threshold) for i, _ in members}
            self._generation += 1
            self._streams = {}
            size = len(members)
        metrics.DEVICE_MESH_SIZE.set(size)
        for i, _ in members:
            metrics.DEVICE_MESH_DEVICE_STATE.set(0, device=str(i))
        if size:
            log.info("device mesh enabled", size=size, axis=AXIS,
                     devices=[str(d) for _, d in members])
        else:
            log.info("device mesh disabled", spec=raw or "0",
                     reason="fewer than 2 devices" if raw not in (
                         "", "0", "off", "false") else "off")
        return size

    def _ensure_configured(self) -> None:
        with self._lock:
            configured = self._configured
        if not configured:
            self.configure()

    # ------------------------------------------------------------- reads

    def enabled(self) -> bool:
        self._ensure_configured()
        with self._lock:
            return len(self._devices) >= 2

    def size(self) -> int:
        with self._lock:
            return len(self._devices)

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def members(self) -> List[Tuple[int, Any]]:
        """The live members, ``(mesh index, torch.device)``, in order."""
        with self._lock:
            return list(self._devices)

    def pad_rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the mesh size (each shard gets
        the same number of rows); ``n`` unchanged when disabled."""
        with self._lock:
            m = len(self._devices)
        if m < 2:
            return n
        return -(-n // m) * m

    def stream(self, index: int, device) -> Any:
        """The CUDA stream member ``index`` runs its shard on (one per
        member and topology generation)."""
        import torch

        with self._lock:
            key = (self._generation, index)
            s = self._streams.get(key)
        if s is None:
            s = torch.cuda.Stream(device=device)
            with self._lock:
                s = self._streams.setdefault(key, s)
        return s

    # ------------------------------------------------- failure accounting

    def suspect_device(self, err: Optional[BaseException]) -> Optional[int]:
        """The mesh index a failure is charged to.  An error that names a
        CUDA ordinal (``cuda:N``, ``device N``) is charged to the member on
        that card — the highest-index one where several shards share it;
        on a mesh of devices without an ordinal (the CPU) the number names
        the mesh index.  Otherwise the deterministic suspect, the
        highest-index survivor (the degradation order is reproducible)."""
        with self._lock:
            if not self._devices:
                return None
            members = list(self._devices)
        fallback = members[-1][0]
        if err is not None:
            m = _DEVICE_ID_RE.search(str(err))
            if m:
                n = int(m.group(1))
                named = [i for i, d in members
                         if d.type == "cuda" and d.index == n]
                if not named and all(d.index is None for _, d in members):
                    named = [i for i, _ in members if i == n]
                if named:
                    return named[-1]
        return fallback

    def note_success(self) -> None:
        """A meshed dispatch completed: clear the failure counters of every
        still-CLOSED member breaker, so the threshold stays *consecutive*.
        OPEN breakers stay open: re-admission is operator-driven."""
        with self._lock:
            for br in self._breakers.values():
                if not br.open:
                    br.failures = 0

    def note_failure(self, reason: str,
                     device_id: Optional[int] = None,
                     err: Optional[BaseException] = None) -> bool:
        """Charge one dispatch failure to a member; True iff the charge
        tripped that member's breaker and the mesh re-sharded (the caller
        should then retry the batch on the survivors)."""
        if device_id is None:
            device_id = self.suspect_device(err)
        if device_id is None:
            return False
        transitions: List[int] = []
        with self._lock:
            br = self._breakers.get(device_id)
            if br is None or len(self._devices) < 2:
                return False
            tripped = br.record(reason)
            if tripped:
                transitions.append(device_id)
                self._shrink_locked(device_id, reason)
            size = len(self._devices)
            gen = self._generation
        metrics.DEVICE_MESH_DEVICE_FAILURES.inc(device=str(device_id))
        for dev in transitions:
            metrics.DEVICE_MESH_DEVICE_STATE.set(1, device=str(dev))
            metrics.DEVICE_MESH_RESHARDS.inc(reason=reason)
            metrics.DEVICE_MESH_SIZE.set(size)
            log.warning("mesh device breaker tripped; re-sharded",
                        device=dev, reason=reason, survivors=size,
                        generation=gen)
            blackbox.emit("mesh", "reshard", device=dev, reason=reason,
                          survivors=size, generation=gen)
            self._invalidate_topology()
        return bool(transitions)

    def force_trip(self, device_id: int, reason: str = "forced") -> bool:
        """Trip one member's breaker outright (admin/scenario seam)."""
        with self._lock:
            br = self._breakers.get(int(device_id))
            if br is None or len(self._devices) < 2 or br.open:
                return False
            br.failures = max(br.failures, br.threshold)
            br.open = True
            br.last_reason = reason
            self._shrink_locked(int(device_id), reason)
            size = len(self._devices)
        metrics.DEVICE_MESH_DEVICE_STATE.set(1, device=str(int(device_id)))
        metrics.DEVICE_MESH_RESHARDS.inc(reason=reason)
        metrics.DEVICE_MESH_SIZE.set(size)
        log.warning("mesh device force-tripped; re-sharded",
                    device=int(device_id), reason=reason, survivors=size)
        blackbox.emit("mesh", "reshard", device=int(device_id), reason=reason,
                      survivors=size, forced=True)
        self._invalidate_topology()
        return True

    def _shrink_locked(self, device_id: int, reason: str) -> None:
        """Remove member ``device_id`` and re-shard over the survivors
        (lock held).  Below 2 survivors the mesh disables entirely: the
        single-device path is the terminal degradation state."""
        self._devices = [(i, d) for i, d in self._devices if i != device_id]
        self._reshards_total += 1
        self._generation += 1
        self._streams = {}
        if len(self._devices) == 1:
            log.warning("mesh exhausted; single-device dispatch",
                        survivor=self._devices[0][0], reason=reason)

    def _invalidate_topology(self) -> None:
        """The old topology's first-dispatch mirror entries are stale: drop
        them, so telemetry re-attributes the survivors' first dispatches."""
        from . import device_telemetry

        device_telemetry.COMPILE_CACHE.invalidate_meshed()

    # ------------------------------------------------------------ surface

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": len(self._devices) >= 2,
                "axis": AXIS,
                "size": len(self._devices),
                "full_size": self._full_size,
                "generation": self._generation,
                "reshards_total": self._reshards_total,
                "device_failure_threshold": self._threshold,
                "devices": [i for i, _ in self._devices],
                "device_names": [str(d) for _, d in self._devices],
                "breakers": [b.snapshot()
                             for _, b in sorted(self._breakers.items())],
            }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._configured = False
            self._devices = []
            self._full_size = 0
            self._generation += 1
            self._reshards_total = 0
            self._breakers = {}
            self._streams = {}
        metrics.DEVICE_MESH_SIZE.set(0)


STATE = MeshState()


# ------------------------------------------------------------ module facade


def configure(spec: Optional[str] = None,
              devices: Optional[Sequence[Any]] = None) -> int:
    return STATE.configure(spec, devices)


def enabled() -> bool:
    return STATE.enabled()


def size() -> int:
    return STATE.size()


def generation() -> int:
    return STATE.generation()


def pad_rows(n: int) -> int:
    return STATE.pad_rows(n)


def first_device():
    """The device of the mesh's first live member (where the combine runs
    and results land); None while the mesh is off."""
    members = STATE.members()
    return members[0][1] if len(members) >= 2 else None


def note_success() -> None:
    STATE.note_success()


def note_failure(reason: str, device_id: Optional[int] = None,
                 err: Optional[BaseException] = None) -> bool:
    return STATE.note_failure(reason, device_id=device_id, err=err)


def grow_rows(arr, rows: int, fill):
    """Grow a host array's leading (batch) axis to ``rows`` with ``fill``
    (broadcast into the new rows) — the mesh-divisibility pad the ops'
    placement stages use next to :func:`pad_rows`."""
    import numpy as np

    if arr.shape[0] == rows:
        return arr
    out = np.empty((rows,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    out[arr.shape[0]:] = fill
    return out


def force_trip(device_id: int, reason: str = "forced") -> bool:
    return STATE.force_trip(device_id, reason)


def summary() -> dict:
    """The ``mesh`` section of ``GET /lighthouse/device``."""
    return STATE.snapshot()


def reset_for_tests() -> None:
    STATE.reset_for_tests()


def scale_target(target_sets: int) -> int:
    """A batch-fill target scaled to the CURRENT mesh (the device pipeline
    consults this per coalescing decision): a mesh shrunk from F to S
    members fills S/F of the configured target.  Identity when the mesh is
    off or at full strength."""
    with STATE._lock:
        full, current = STATE._full_size, len(STATE._devices)
    if full < 2 or current >= full or current < 2:
        return target_sets
    return max(1, target_sets * current // full)


# ------------------------------------------------------------ shard context

_SHARD = threading.local()


def current_shard() -> Optional[int]:
    """The mesh index of the shard this thread is running inside
    :meth:`ShardedEntry.run`, else None (instrumentation reads it to
    attribute kernel launches to a shard)."""
    return getattr(_SHARD, "index", None)


def _tree_map(fn: Callable, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _tensors(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return [x]


# ----------------------------------------------------------- sharded entry


class ShardedEntry:
    """One entry point's placement over the mesh, derived from
    ``BATCH_AXES``.

    ``fn`` is the entry point's device program; only its positional
    parameters are read (each must be declared batched or replicated).
    :meth:`place` splits a call's arguments into one argument tuple per
    live member, :meth:`run` runs a per-shard program (same parameters) on
    each and returns the outputs on the mesh's first device, in shard
    order.
    """

    def __init__(self, entry_key: str, fn):
        decl = _registry().get(entry_key)
        if decl is None:
            raise KeyError(
                f"{entry_key} has no ops/batch_axes.py declaration — the "
                "mesh layer cannot derive its placement")
        self.entry_key = entry_key
        self.op = decl["op"]
        self.batch_axis = int(decl["batch_axis"])
        raw_out = decl.get("out_batched", False)
        self.out_batched = (
            tuple(bool(b) for b in raw_out)
            if isinstance(raw_out, (list, tuple)) else bool(raw_out)
        )
        batched = list(decl["batched_args"])
        replicated = list(decl["replicated_args"])
        params = [
            p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        undeclared = [p for p in params if p not in batched + replicated]
        if undeclared:
            raise ValueError(
                f"{entry_key}: parameters {undeclared} are neither batched "
                "nor replicated in ops/batch_axes.py — declare them")
        #: positional arg index -> True when batched
        self.arg_batched: Tuple[bool, ...] = tuple(
            name in batched for name in params
        )

    # --------------------------------------------------------- placement

    def place(self, *args) -> List[tuple]:
        """Split the arguments over the live members: each batched leaf
        (a numpy array or tensor, possibly inside tuples) into contiguous
        row blocks along the batch axis, each replicated leaf copied whole;
        every leaf uploaded to its member's device, except a replicated
        Python number, which every shard gets as it is.  The batch axis must
        already be a multiple of the mesh size (:func:`pad_rows`)."""
        import numpy as np
        import torch

        members = STATE.members()
        m = len(members)
        if m < 2:
            raise RuntimeError("device mesh is not enabled")
        if len(args) != len(self.arg_batched):
            raise ValueError(f"{self.entry_key}: {len(args)} args vs "
                             f"{len(self.arg_batched)} declared parameters")
        axis = self.batch_axis
        out: List[tuple] = []
        for s, (_, dev) in enumerate(members):
            def upload(leaf, batched, s=s, dev=dev):
                if not batched and isinstance(leaf, (bool, int, float)):
                    return leaf  # a replicated Python number travels by value
                t = torch.as_tensor(np.asarray(leaf)) if not isinstance(
                    leaf, torch.Tensor) else leaf
                if batched:
                    rows = t.shape[axis]
                    if rows % m:
                        raise ValueError(
                            f"{self.entry_key}: batch axis of {rows} rows is "
                            f"not a multiple of the mesh size {m}")
                    block = rows // m
                    t = t.narrow(axis, s * block, block)
                return t.contiguous().to(dev)

            out.append(tuple(
                _tree_map(lambda leaf, b=b: upload(leaf, b), a)
                for a, b in zip(args, self.arg_batched)))
        return out

    # ---------------------------------------------------------- dispatch

    def run(self, shard_fn: Callable, placed: List[tuple]) -> list:
        """``shard_fn(*placed[s])`` for every live member ``s`` on its own
        device and (on a card) its own CUDA stream, issued in shard order;
        returns the outputs on the mesh's first device, in shard order,
        ordered after each shard's work on the first device's current
        stream."""
        import torch

        members = STATE.members()
        if len(members) != len(placed):
            raise RuntimeError(
                f"{self.entry_key}: placed for {len(placed)} shards, the mesh "
                f"has {len(members)} (re-place after a reshard)")
        first = members[0][1]
        outs = []
        for (index, dev), args in zip(members, placed):
            _SHARD.index = index
            try:
                if dev.type != "cuda":
                    outs.append((shard_fn(*args), None))
                    continue
                with torch.cuda.device(dev):
                    stream = STATE.stream(index, dev)
                    # the shard's inputs were uploaded on the device's
                    # current stream: order the shard after them
                    stream.wait_stream(torch.cuda.current_stream(dev))
                    for t in _tensors(args):
                        if isinstance(t, torch.Tensor):
                            t.record_stream(stream)
                    with torch.cuda.stream(stream):
                        fn_out = shard_fn(*args)
                        done = torch.cuda.Event()
                        done.record(stream)
                outs.append((fn_out, done))
            finally:
                _SHARD.index = None
        gathered = []
        for fn_out, done in outs:
            if done is not None:
                with torch.cuda.device(first):
                    main = torch.cuda.current_stream(first)
                    main.wait_event(done)

                    def land(t, main=main):
                        if not isinstance(t, torch.Tensor):
                            return t
                        if t.device == first:
                            # made on a side stream, read on the main one
                            t.record_stream(main)
                            return t
                        return t.to(first)

                    fn_out = _tree_map(land, fn_out)
            else:
                fn_out = _tree_map(
                    lambda t: t.to(first) if isinstance(t, torch.Tensor) else t,
                    fn_out)
            gathered.append(fn_out)
        return gathered

    def blocks(self, rows: int) -> List[Tuple[int, int]]:
        """``(offset, count)`` of each live member's row block of a batch
        axis of ``rows`` rows (a multiple of the mesh size), in shard
        order: the rows :meth:`place` gives it."""
        m = STATE.size()
        if m < 2 or rows % m:
            raise ValueError(f"{self.entry_key}: {rows} rows over a mesh of {m}")
        per = rows // m
        return [(s * per, per) for s in range(m)]

    def shard_live_counts(self, n_live: int, padded_rows: int) -> List[int]:
        """Host-side per-shard live-row counts (live rows are packed at the
        front of every batch): padding lands on the LAST shards, and this
        shows exactly where."""
        m = STATE.size()
        if m < 2 or padded_rows % m:
            return [n_live]
        rows = padded_rows // m
        return [max(0, min(rows, n_live - s * rows)) for s in range(m)]


# ------------------------------------------------------- exchange helpers


def replicate(t) -> list:
    """``t`` (a tensor on the mesh's first device) on every live member,
    in shard order: the tensor itself on a member of its own device, a
    copy on another (issued on the current streams, which
    :meth:`ShardedEntry.run` orders each shard after)."""
    return [t if t.device == dev else t.to(dev) for _, dev in STATE.members()]

