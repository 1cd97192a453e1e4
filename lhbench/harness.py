"""One run of one benchmark cell.

    python3 lhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
deployment (``lhbench/configs/<config>.json``), its traffic mix
(``lhbench/traffic/<traffic>.json``, read by the one generator,
``gossip.py``) and, in a traced run, a reader for each per-layer metric
(``lhbench/metrics/<metric>.py``).

A run:

1. Checks for the cards the cell asks for, and fails without them.
2. Set-up: makes the traffic from the seed; loads the port
   (``lighthouse_tpu_torch``) and its kernel libraries (``nvcc`` builds them
   into ``lighthouse_tpu_torch/build/`` on a checkout's first run); fills a
   pubkey cache with the signers' keys as a node's validator pubkey cache
   holds them; turns on the async device pipeline on ``cuda``, as a node's
   caller does; warms each (set, key) bucket the cell's batches can take
   with one neutral dispatch; then starts the cell's load and lets it run
   ``warmup_s`` seconds.
3. The window: ``--seconds`` of the load.  Calls arrive at the cell's
   fixed rate (``offered_sets_per_s``), one every ``sets_per_call /
   offered_sets_per_s`` seconds, whatever the system does (an open loop).
   Each runs on a thread of its own: it parses its signatures from their
   96 bytes (``Signature.from_bytes``), takes its keys from the pubkey
   cache and calls ``bls.api.verify_signature_sets``, which the pipeline
   coalesces with the other calls in flight.  A call's latency runs from
   when it was due to its verdict.  At most ``max_in_flight_calls`` are out
   at once; offered above what the system verifies, every slot stays busy
   and the calls start late.  At the close no call starts any more, and
   every call in flight is waited for.
4. The check: every verdict against what the traffic made (valid calls
   verify, tampered ones fail); the probe (``probe_calls``) through the
   same entry once the load has drained: tampered calls that only the
   per-set check, the random weights or the subgroup check fail, sent
   alone and coalesced with valid calls, each of which must get its own
   verdict; and a sample of the window's calls against the plain reference
   (``lhbench/reference``), worked out in worker processes after the
   program's pipeline has shut down.
5. The result: one JSON line on standard output, the compared numbers and
   their limits last on standard error and last in that line.

With ``--trace 0`` the line holds the cell's end-to-end metrics.  With
``--trace 1`` the window runs under ``torch.profiler`` (device activity
only), which stops once every call has returned, and the line holds the
cell's per-layer metrics, the device's busy and window seconds and a
breakdown of device time and idle gaps.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import random
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import gossip

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Modules that may not be loaded in the process that prints the result,
#: compared by their whole top-level name.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lighthouse_tpu")

#: How long after the close a call in flight is waited for.
DRAIN_TIMEOUT_S = 240.0


# ------------------------------------------------------------ the cells

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_reader(metric: str) -> Callable:
    """The ``read`` function of ``lhbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "lhbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# --------------------------------------------------------- the open loop

@dataclass
class Record:
    """One call as the load saw it: due on the schedule, submitted at
    ``start``, returned ``done``."""
    index: int
    n_sets: int
    due: float
    start: float
    done: float
    verdict: Optional[bool]
    error: Optional[str]
    parse: Tuple[float, float]


class OpenLoop:
    """Calls arrive on a fixed schedule, one every ``interval`` seconds from
    ``t_start`` until ``t_stop``, whatever the system does.  Each arrival
    runs ``entry(call)`` (which returns ``(verdict, (parse_start,
    parse_end))``) on a thread of its own, at most ``max_in_flight`` at
    once, in the order they are due; an arrival that finds them all busy
    waits for one, and its latency, timed from when it was due, counts the
    wait.  No call is submitted after ``t_stop``: one still waiting then is
    shed, as a node's full queue drops gossip.  Offered above what the
    system verifies, the load keeps every slot busy all through the run."""

    def __init__(self, calls: List[gossip.Call], entry: Callable, interval: float,
                 max_in_flight: int):
        self._calls = calls
        self._entry = entry
        self._interval = interval
        self._slots = threading.BoundedSemaphore(max_in_flight)
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.records: List[Record] = []
        self.exhausted = False
        #: the most an arrival started behind its due time
        self.late_s = 0.0
        #: calls due before ``t_stop`` that no slot took before it
        self.shed = 0

    def start(self, t_start: float, t_stop: float) -> None:
        self._dispatcher = threading.Thread(target=self._dispatch, args=(t_start, t_stop),
                                            name="lhbench-arrivals", daemon=True)
        self._dispatcher.start()

    def _dispatch(self, t_start: float, t_stop: float) -> None:
        for k, call in enumerate(self._calls):
            due = t_start + k * self._interval
            if due >= t_stop:
                return
            time.sleep(max(0.0, due - time.perf_counter()))
            self._slots.acquire()
            now = time.perf_counter()
            if now >= t_stop:
                self._slots.release()
                self.shed = min(len(self._calls), math.ceil((t_stop - t_start) / self._interval)) - k
                return
            self.late_s = max(self.late_s, now - due)
            t = threading.Thread(target=self._run, args=(call, due),
                                 name=f"lhbench-call-{k}", daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()
        self.exhausted = True

    def _run(self, call: gossip.Call, due: float) -> None:
        start = time.perf_counter()
        verdict, error, parse = None, None, (start, start)
        try:
            verdict, parse = self._entry(call)
        except Exception as exc:  # noqa: BLE001 — a call without a verdict is counted
            error = f"{type(exc).__name__}: {exc}"
        finally:
            self._slots.release()
        done = time.perf_counter()
        with self._lock:
            self.records.append(Record(call.index, call.n_sets, due, start, done, verdict, error, parse))

    def drain(self, timeout: float) -> int:
        """Wait for the schedule to end and every call to return; returns
        how many calls are still out at the deadline."""
        deadline = time.perf_counter() + timeout
        self._dispatcher.join(max(0.0, deadline - time.perf_counter()))
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return sum(t.is_alive() for t in threads) + int(self._dispatcher.is_alive())


# ----------------------------------------------------------- the system

class PortSystem:
    """The system under test: ``lighthouse_tpu_torch``'s batch verifier
    behind its async device pipeline on ``device``."""

    def __init__(self, traffic: gossip.Traffic, device: str = "cuda"):
        from lighthouse_tpu_torch import device_pipeline
        from lighthouse_tpu_torch.crypto.bls import api
        from lighthouse_tpu_torch.crypto.bls.fields import Fq
        from lighthouse_tpu_torch.ops import compile_cache
        from lighthouse_tpu_torch.ops import verify as verify_ops

        self._api = api
        self._pipeline = device_pipeline
        if device == "cuda":
            compile_cache.build_kernels()
        # A running node's validator pubkey cache: decoded, checked points.
        self._keys = [api.PublicKey((Fq(x), Fq(y)), _skip_checks=True) for x, y in traffic.keys]
        device_pipeline.enable(device=device)
        self.warmed = []
        for nb, kb in warm_buckets(traffic, verify_ops.N_BUCKETS, verify_ops.K_BUCKETS,
                                   device_pipeline.DEFAULT_TARGET_SETS):
            compile_cache.aot_warmup_op("bls_verify", nb, device=device, keys=kb)
            self.warmed.append((nb, kb))

    def call(self, call: gossip.Call):
        t0 = time.perf_counter()
        try:
            sigs = [self._api.Signature.from_bytes(raw) for raw in call.sigs]
        except self._api.BlsError:
            # a signature that does not decode is rejected, as gossip rejects it
            return False, (t0, time.perf_counter())
        t1 = time.perf_counter()
        keys = self._keys
        sets = [self._api.SignatureSet.multiple_pubkeys(sig, [keys[v] for v in signers], msg)
                for sig, msg, signers in zip(sigs, call.messages, call.signers)]
        return bool(self._api.verify_signature_sets(sets)), (t0, t1)

    def counters(self) -> dict:
        s = self._pipeline.summary() or {}
        return {"batches": s.get("batches_total", 0), "sets": s.get("sets_total", 0)}

    def flight_records(self, after_seq: int) -> List[dict]:
        from lighthouse_tpu_torch.device_telemetry import FLIGHT_RECORDER

        return [r for r in FLIGHT_RECORDER.recent(limit=FLIGHT_RECORDER.capacity, op="bls_verify")
                if r["seq"] > after_seq]

    def last_seq(self) -> int:
        from lighthouse_tpu_torch.device_telemetry import FLIGHT_RECORDER

        return FLIGHT_RECORDER.recorded_total

    def host_spans(self) -> List[Tuple[str, float, float]]:
        """The program's own host spans of its pipeline: each batch's build
        and the dispatch, wait and verdict of its device leg."""
        from lighthouse_tpu_torch import tracing

        out = []

        def walk(sp):
            if sp.end_pc is not None and sp.name in (
                    "pipeline_build", "device_batch_dispatch", "device_batch_wait",
                    "device_batch_verdict"):
                out.append((sp.name, sp.start_pc, sp.end_pc))
            for child in sp.children:
                walk(child)

        for root in ("pipeline_build", "pipeline_batch"):
            for trace in tracing.TRACES.recent(limit=tracing.TRACES_PER_ROOT, root=root):
                walk(trace.root)
        return out

    def close(self) -> None:
        self._pipeline.shutdown()


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def warm_buckets(traffic: gossip.Traffic, n_buckets, k_buckets, target: int) -> List[Tuple[int, int]]:
    """Every (set, key) bucket a batch of this traffic can take: from one
    call's sets to every call in flight at once, capped at the pipeline's
    target; a batch's key bucket is that of one of its calls' widest set."""
    mix = traffic.mix
    most = min(mix.max_in_flight_calls * mix.sets_per_call, target)
    sets = [b for b in n_buckets if _bucket(mix.sets_per_call, n_buckets) <= b <= _bucket(most, n_buckets)]
    keys = sorted({_bucket(max(len(s) for s in c.signers), k_buckets) for c in traffic.calls})
    return [(nb, kb) for kb in keys for nb in sets]


# ------------------------------------------------------------ the trace

@dataclass
class DeviceTrace:
    """The device's activity over a traced window, on the host's
    ``perf_counter`` clock."""
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start, end), kernels only
    busy: List[Tuple[float, float]]           # union of every device activity
    sm_clock_mhz: Optional[float]
    aligned: bool
    t_start: float
    t_stop: float


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


class Tracer:
    """``torch.profiler`` over the window, device activity only, with a
    marker kernel to put the device's clock on the host's and the SM
    clock sampled beside it."""

    MARKER = "spin_kernel"   # torch.cuda._sleep's kernel; the program launches none

    def __init__(self, device_index: int = 0):
        self._index = device_index
        self._clocks: List[float] = []
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._sample, name="lhbench-smi", daemon=True)

    def _sample(self) -> None:
        while True:
            clock = smi_query("clocks.sm", self._index)
            if clock:
                try:
                    self._clocks.append(float(clock))
                except ValueError:
                    pass
            if self._stop.wait(2.0):
                return

    def warm(self) -> None:
        """One short session around a marker kernel, in set-up before the
        load: the process's first session pays the profiler's start-up,
        which under load takes seconds of the window, and the log says
        whether it saw the device."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        seen = sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
        log(f"profiler warmed: {seen} device event(s) in its first session")

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._sampler.start()

    def stop(self) -> DeviceTrace:
        import torch

        torch.cuda.synchronize()
        t_stop = time.perf_counter()
        self._prof.stop()
        self._stop.set()
        self._sampler.join(30)
        events = []
        marker = None
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            start, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
            if self.MARKER in name and marker is None:
                marker = start
                continue
            events.append((name, start, start + dur))
        if not events:
            raise RuntimeError("the profiler recorded no device activity")
        aligned = marker is not None
        offset = (marker - self.t_marker) if aligned else (min(s for _, s, _ in events) - self.t_start)
        events = [(n, s - offset, e - offset) for n, s, e in events]
        busy = clip(union([(s, e) for _, s, e in events]), self.t_start, t_stop)
        kernels = [ev for ev in events if not ev[0].startswith(("Memcpy", "Memset"))]
        return DeviceTrace(window_s=t_stop - self.t_start,
                           busy_s=sum(b - a for a, b in busy), kernels=kernels, busy=busy,
                           sm_clock_mhz=max(self._clocks) if self._clocks else None,
                           aligned=aligned, t_start=self.t_start, t_stop=t_stop)


def smi_query(field_name: str, index: int = 0) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={field_name}",
                              "--format=csv,noheader,nounits", "-i", str(index)],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def breakdown(trace: DeviceTrace, spans: List[Tuple[str, float, float]]) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host span that covered most of it."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edge = trace.t_start
    for a, b in trace.busy + [(trace.t_stop, trace.t_stop)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    by_label: Dict[str, List[Tuple[float, float]]] = {}
    for name, s, e in spans:
        by_label.setdefault(name, []).append((s, e))
    merged = {k: union(v) for k, v in by_label.items()}
    idle = []
    for a, b in gaps:
        # Every span open over a tenth of the gap or more, the widest first:
        # the calls' parse spans stay open while they wait for the
        # interpreter lock, so the span that holds it may cover less.
        cover = {k: sum(y - x for x, y in clip(v, a, b)) for k, v in merged.items()}
        open_spans = sorted((k for k, c in cover.items() if c >= 0.1 * (b - a)),
                            key=lambda k: -cover[k])
        label = "+".join(open_spans) or "no_host_span"
        idle.append([label if trace.aligned else f"{label}?unaligned", b - a])
    return {"device_ops": [[n[:96], s] for n, s in ops], "idle_gaps": idle}


# ----------------------------------------------------------- the check

def _reference_task(args):
    from .reference.verify import verify_call
    sigs, messages, keys, rng_seed = args
    return verify_call(sigs, messages, keys, random.Random(rng_seed))


def reference_verdicts(traffic: gossip.Traffic, indices: List[int], seed: int,
                       workers: int) -> List[bool]:
    tasks = []
    for i in indices:
        call = traffic.calls[i]
        keys = [[traffic.keys[v] for v in signers] for signers in call.signers]
        tasks.append((call.sigs, call.messages, keys, f"lhbench-reference-{seed}-{i}"))
    return gossip.run_tasks(_reference_task, tasks, workers)


def sample_calls(records: List[Record], traffic: gossip.Traffic, n: int, seed: int) -> List[int]:
    """``n`` of the window's answered calls drawn from the seed, the one
    with the most keys among them."""
    answered = sorted(r.index for r in records if r.verdict is not None)
    if not answered:
        return []
    widest = max(answered, key=lambda i: traffic.calls[i].n_keys)
    rest = [i for i in answered if i != widest]
    rng = random.Random(f"lhbench-sample-{seed}")
    return [widest] + rng.sample(rest, min(n - 1, len(rest)))


#: The prime order of the twist's torsion point that the outside-G2 probes
#: add to a valid signature: the smallest prime factor of G2's cofactor.
TORSION_ORDER = 13
#: Outside-G2 probe calls, each sent alone.  The pairing rejects such a
#: signature unless its random weight kills the torsion point, so a verifier
#: that skips the subgroup check accepts each with probability 1/13, and a
#: run misses it with probability (12/13)^16, about 0.28.
OUTSIDE_PROBES = 16
#: Sets of each call of the outside-G2 probes and of the coalesced rounds.
SMALL_CALL_SETS = 2


@dataclass
class Probe:
    """One call sent through the timed entry after the load has drained:
    what it plants (``kind``), the call (its ``valid`` is the verdict it
    must get), and the round it is sent in: 0 alone, n > 0 at once with
    the other calls of round n, so that one coalesced batch has to give
    each call its own verdict."""
    kind: str
    call: gossip.Call
    together: int = 0


def _twist_torsion_point(seed: int):
    """A point of the twist of order ``TORSION_ORDER``, outside G2: the
    cofactor part of an uncleared hash-to-G2 output, made from the seed."""
    from .reference import curve
    from .reference.params import DST, H2, R
    from .reference.verify import control_hash

    k = TORSION_ORDER
    for attempt in range(64):
        q = control_hash(f"lhbench-probe-twist-{seed}-{attempt}".encode(), DST)
        t = curve.mul(q, R * (H2 // (k * k)))
        while t is not None and curve.mul(t, k) is not None:
            t = curve.mul(t, k)
        if t is not None:
            return t
    raise RuntimeError("no torsion point of the twist found")


def probe_calls(traffic: gossip.Traffic) -> List[Probe]:
    """The probes, made from the traffic's last calls (past what a window
    reaches) and the seed.  Alone:

    - ``swapped_first`` / ``swapped_last``: a whole call with its first
      (last) set's signature swapped for another call's, a point of G2 that
      signs another message by another key.  A verifier that answers
      without verifying, or leaves out either half of a call's sets, passes
      one.
    - ``unweighted``: a whole call whose first two signatures are
      ``sig_0 + D`` and ``sig_1 - D`` (``D`` a point of G2 from the seed):
      their sum is the valid one, so only the random weights fail it.
    - ``outside_g2``: ``OUTSIDE_PROBES`` small calls whose first signature
      is ``sig_0 + T``, ``T`` a torsion point of the twist outside G2: only
      the subgroup check fails it (see ``OUTSIDE_PROBES``).

    Coalesced, each call due its own verdict: round 1, three valid small
    calls with a swapped and an unweighted one (a batch the device fails,
    whose calls must be told apart); round 2, two valid small calls with an
    outside-G2 one (a batch the build refuses)."""
    from .reference import curve, serde

    calls = traffic.calls
    rng = random.Random(f"lhbench-probe-{traffic.seed}")
    twist = _twist_torsion_point(traffic.seed)
    shift = curve.mul(curve.G2, rng.randrange(1, 1 << 64))

    def source(k: int) -> gossip.Call:
        return calls[-1 - k % len(calls)]

    def small(k: int) -> gossip.Call:
        c = source(k)
        n = SMALL_CALL_SETS
        return gossip.Call(c.index, c.sigs[:n], c.messages[:n], c.signers[:n])

    def resign(call: gossip.Call, changes: Dict[int, object]) -> gossip.Call:
        sigs = list(call.sigs)
        for pos, addend in changes.items():
            sigs[pos] = serde.g2_compress(curve.add(serde.g2_decompress(sigs[pos]), addend))
        return gossip.Call(call.index, sigs, call.messages, call.signers, valid=False)

    def swapped(call: gossip.Call, pos: int, donor: gossip.Call) -> gossip.Call:
        sigs = list(call.sigs)
        sigs[pos] = donor.sigs[pos]
        return gossip.Call(call.index, sigs, call.messages, call.signers, valid=False)

    def unweighted(call: gossip.Call) -> gossip.Call:
        return resign(call, {0: shift, 1: curve.neg(shift)})

    def outside(call: gossip.Call) -> gossip.Call:
        return resign(call, {0: twist})

    probes = [Probe("swapped_first", swapped(source(1), 0, source(0))),
              Probe("swapped_last", swapped(source(0), -1, source(1))),
              Probe("unweighted", unweighted(source(2)))]
    probes += [Probe("outside_g2", outside(small(3 + k))) for k in range(OUTSIDE_PROBES)]
    k = 3 + OUTSIDE_PROBES
    probes += [Probe("valid", small(k + j), 1) for j in range(3)]
    probes += [Probe("swapped", swapped(small(k + 3), 0, small(k + 4)), 1),
               Probe("unweighted", unweighted(small(k + 5)), 1)]
    probes += [Probe("valid", small(k + 6 + j), 2) for j in range(2)]
    probes += [Probe("outside_g2", outside(small(k + 8)), 2)]
    return probes


def run_probe(system, probes: List[Probe]) -> List[Optional[bool]]:
    """Each probe's verdict through the timed entry once the load has
    drained: those of round 0 one at a time, each a batch of its own; those
    of each later round from threads started together (the pipeline's
    linger coalesces them).  A call that raises gets no verdict."""
    verdicts: List[Optional[bool]] = [None] * len(probes)

    def one(i: int) -> None:
        try:
            verdicts[i] = system.call(probes[i].call)[0]
        except Exception as exc:  # noqa: BLE001 — a probe without a verdict fails the check
            log(f"probe {probes[i].kind} (call {probes[i].call.index}): "
                f"{type(exc).__name__}: {exc}")

    for i, p in enumerate(probes):
        if not p.together:
            one(i)
    deadline = time.perf_counter() + DRAIN_TIMEOUT_S
    for rnd in sorted({p.together for p in probes} - {0}):
        members = [i for i, p in enumerate(probes) if p.together == rnd]
        before = system.counters()["batches"]
        threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        log(f"probe round {rnd}: {len(members)} calls at once, "
            f"{system.counters()['batches'] - before} batch(es)")
    return verdicts


@dataclass
class Check:
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def judge(all_records: List[Record], traffic: gossip.Traffic, sampled: List[int],
          reference: List[bool], unanswered: int, probes: List[Probe],
          probe: List[Optional[bool]]) -> Dict[str, Check]:
    """The numbers compared, each with its limit (an exact comparison:
    limit 0): verdicts of the load's calls that differ from what the
    traffic made, calls of the load without a verdict, sampled verdicts
    that differ from the reference's, and probe calls without the verdict
    they are due (tampered ones that did not fail, valid ones that did not
    pass, and any without a verdict)."""
    verdict_of = {r.index: r.verdict for r in all_records}
    wrong = sum(1 for r in all_records
                if r.verdict is not None and r.verdict != traffic.calls[r.index].valid)
    no_verdict = sum(1 for r in all_records if r.verdict is None) + unanswered
    disagree = sum(1 for i, ref in zip(sampled, reference) if verdict_of[i] != ref)
    return {"wrong_verdicts": Check(wrong, 0),
            "no_verdict": Check(no_verdict, 0),
            "reference_disagrees": Check(disagree, 0),
            "probe_wrong": Check(sum(v is not p.call.valid for p, v in zip(probes, probe)), 0)}


# ------------------------------------------------------- the end to end

def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def in_window(r: Record, t0: float, t_end: float) -> bool:
    """A call of the window: due inside it, or submitted inside it (above
    the rate the system verifies, every call starts late)."""
    return t0 <= r.due < t_end or t0 <= r.start < t_end


def end_to_end(window: List[Record], t0: float, t_end: float, records: List[Record],
               setup_s: float) -> Dict[str, float]:
    """``sets_per_s``: the sets of every call that returned a verdict, each
    call's sets spread evenly over its life from submission to verdict and
    counted for the part of it inside the window, over the window's length.
    A batch's calls return together, so whole calls counted at their return
    would make the rate jump by a batch with the phase of the window; a
    call's work is counted where it was done.  ``call_p95_s``: the 95th
    percentile (nearest rank) over every call of the window, from when it
    was due to its verdict, those that returned after the close included.
    ``setup_s``: from the start of the process to the window."""
    work = 0.0
    for r in records:
        life = r.done - r.start
        if r.verdict is None or life <= 0:
            continue
        inside = min(r.done, t_end) - max(r.start, t0)
        if inside > 0:
            work += r.n_sets * inside / life
    return {"sets_per_s": work / (t_end - t0),
            "call_p95_s": percentile([r.done - r.due for r in window], 0.95),
            "setup_s": setup_s}


# ----------------------------------------------------------------- main

@dataclass
class RunData:
    """What a per-layer metric's reader gets."""
    flight: List[dict]
    counters: Dict[str, int]
    trace: Optional[DeviceTrace]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="lhbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[lhbench] {msg}", file=sys.stderr, flush=True)


def main(argv, t_process: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    card = torch.cuda.get_device_name(0)
    power_limit = smi_query("power.limit")
    log(f"card {card}, power limit {power_limit} W, torch {torch.__version__}")

    dep = gossip.Deployment.load(cell["config"])
    mix = gossip.Mix.load(cell["traffic"])
    t = time.perf_counter()
    traffic = gossip.make(dep, mix, args.seed)
    log(f"traffic: {len(traffic.calls)} calls of {mix.sets_per_call} sets, "
        f"{len(traffic.keys)} keys, {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    system = PortSystem(traffic)
    log(f"port loaded, buckets {system.warmed} warmed, {time.perf_counter() - t:.1f} s")
    return run(args, bench, cell, traffic, system, t_process, card, power_limit)


def run(args, bench, cell, traffic, system, t_process: float, card: str,
        power_limit: Optional[str], device_stats: Optional[Callable] = None) -> int:
    """The load, the window, the check and the result line, on ``system``
    (``PortSystem`` or a stand-in with the same methods)."""
    mix = traffic.mix
    tracer = None
    if args.trace:
        tracer = Tracer()
        tracer.warm()
    loop = OpenLoop(traffic.calls, system.call, mix.sets_per_call / mix.offered_sets_per_s,
                    mix.max_in_flight_calls)
    t_start = time.perf_counter()
    t0 = t_start + mix.warmup_s
    t_end = t0 + args.seconds
    loop.start(t_start, t_end)
    time.sleep(max(0.0, t0 - time.perf_counter()))
    setup_s = time.perf_counter() - t_process
    if tracer is not None:
        tracer.start()
        # after the profiler is up (its start takes seconds under load), so
        # the batches read are those the trace can see
        seq0, counters0 = system.last_seq(), system.counters()
    time.sleep(max(0.0, t_end - time.perf_counter()))
    unanswered = loop.drain(DRAIN_TIMEOUT_S)
    trace = None
    if tracer is not None:
        trace = tracer.stop()
        data = RunData(flight=system.flight_records(seq0),
                       counters={k: v - counters0[k] for k, v in system.counters().items()},
                       trace=trace)
        spans = system.host_spans() + [("parse", *r.parse) for r in loop.records]
    device = (device_stats or _device_stats)(card)
    probes = probe_calls(traffic)
    probe = run_probe(system, probes)
    system.close()
    kinds = sorted({p.kind for p in probes})
    log("probe, right of sent: " + ", ".join(
        f"{k} {sum(v is p.call.valid for p, v in zip(probes, probe) if p.kind == k)}"
        f"/{sum(p.kind == k for p in probes)}" for k in kinds))

    records = list(loop.records)
    window = [r for r in records if in_window(r, t0, t_end)]
    if not window:
        log("no call was due or submitted inside the window: nothing to measure")
        return 4
    sampled = sample_calls(window, traffic, mix.sample_calls, args.seed)
    t = time.perf_counter()
    reference = reference_verdicts(traffic, sampled, args.seed, gossip.pool_size())
    log(f"reference: {len(sampled)} calls in {time.perf_counter() - t:.1f} s")
    checks = judge(records, traffic, sampled, reference, unanswered, probes, probe)
    correct = all(c.ok for c in checks.values())
    failed = sum(1 for r in window if r.verdict is None or r.verdict != traffic.calls[r.index].valid)
    if loop.exhausted:
        log("the traffic ran out inside the window: more slots are needed for this rate")

    result = {"correct": correct, "attempted": len(window), "failed": failed}
    if args.trace:
        metrics = {}
        for m in cell_metrics(bench, "per_layer", cell["name"]):
            value = load_reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = breakdown(trace, spans)
    else:
        e2e = end_to_end(window, t0, t_end, records, setup_s)
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell_metrics(bench, "end_to_end", cell["name"])}
        result["device"] = device
        lat = [r.done - r.due for r in sorted(window, key=lambda r: r.due)]
        half = len(lat) // 2
        log(f"window {t_end - t0:.1f} s at {mix.offered_sets_per_s:g} sets/s offered: {len(window)} calls, "
            f"latency median {statistics.median(lat):.3f} s (first half "
            f"{statistics.median(lat[:half] or lat):.3f}, second {statistics.median(lat[half:]):.3f}), "
            f"p95 {e2e['call_p95_s']:.3f} s; {e2e['sets_per_s']:.2f} sets/s; arrivals at most "
            f"{loop.late_s:.3f} s late, {loop.shed} shed at the close")
    result["power_limit_w"] = power_limit
    result["traffic_exhausted"] = loop.exhausted
    result["shed_at_close"] = loop.shed
    result["arrivals_late_s"] = loop.late_s
    result["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in checks.items()}

    found = forbidden_modules()
    if found:
        log(f"modules that must not load in this process were loaded: {found}")
        return 3
    for name, c in checks.items():
        print(f"check {name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _device_stats(card: str) -> dict:
    import torch

    return {"platform": "gpu", "kind": card, "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
