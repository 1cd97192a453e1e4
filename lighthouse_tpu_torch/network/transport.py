"""In-process network fabric.

The test/simulator transport: N nodes on one process exchanging gossip and
RPC bytes through queues — the topology of the reference's
``testing/simulator`` (N in-process beacon nodes on one runtime,
``testing/node_test_rig``).  The ``Endpoint`` interface is what a real
libp2p-style TCP/QUIC transport would implement; everything above it
(gossip dedup/forwarding, RPC codecs, peer scoring, sync) is
transport-agnostic.

Fault fabric (the levers the reference's sync tests and ``fallback-sim``
pull, plus the scenario soak's adversarial half):

- a partition map (``set_partition``) severing groups of peers,
- per-link :class:`LinkPlan` faults — drop probability, delivery latency in
  hub *ticks* with jitter, duplication, reordering — each decision derived
  from ``sha256(seed | directed link | per-link message index)``, so a run
  replays **byte-identically** per link regardless of thread interleaving,
- the ``net.deliver`` fault-injection point (``fault_injection.py``): an
  ``error`` plan drops the envelope, ``hang`` stalls the sender, and
  ``corrupt`` flips one payload byte before delivery,
- a delayed-delivery queue drained by :meth:`Hub.advance_tick` (the
  simulator calls it once per slot; scenario pumps call it faster).

Every drop/delay/duplicate is counted (``fault_counters``) and, when
recording is enabled, appended to a per-directed-link schedule whose
:meth:`Hub.schedule_digest` is the determinism fingerprint scenario soak
artifacts carry.

A copy of the JAX package's ``lighthouse_tpu/network/transport.py``; its
lock comes from the lock sanitizer's factory (``locksmith.lock``: a plain
``threading.Lock`` while the sanitizer is off), and the ``net.deliver``
point goes through the port's ``fault_injection``.
"""

from __future__ import annotations

import hashlib
import heapq
import queue
import random
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import locksmith
from ..metrics import (
    NET_ENVELOPES_DELAYED,
    NET_ENVELOPES_DROPPED,
    NET_ENVELOPES_DUPLICATED,
    NET_ENVELOPES_REORDERED,
)


@dataclass
class Envelope:
    # gossip-class kinds ("gossip", "ihave", "iwant", "graft", "prune",
    # "subscribe", "unsubscribe") ride the real gossipsub protobuf wire on
    # secured TCP connections; rpc kinds stay on the envelope stream
    kind: str
    sender: str
    topic: Optional[str] = None  # gossip
    protocol: Optional[str] = None  # rpc
    request_id: int = 0
    data: bytes = b""
    #: Cross-node trace propagation (telemetry_scope.envelope_trace_ctx):
    #: the sender's active trace id, node id, and a read-only Lamport stamp.
    #: Observability sidecar only — never serialized into ``data``, never
    #: part of ``Hub.record_schedule``'s determinism digest (the hub logs
    #: link names + delivery decisions, not envelope contents).
    trace_ctx: Optional[dict] = None


# ---------------------------------------------------------- prune payload
#
# A PRUNE's envelope data carries the v1.1 backoff + peer-exchange records
# (gossipsub rpc.proto ControlPrune: backoff seconds + PeerInfo list).  A
# PX record is our dialable form "host:port|peer_id" — the information the
# reference puts in a signed peer record.


def encode_prune_data(backoff_secs: int, px_records: Optional[list] = None) -> bytes:
    import struct as _struct

    # clamp: the wire allows uint64 backoffs but anything beyond an hour is
    # abuse — and must never raise out of a transport read loop
    backoff = max(0, min(int(backoff_secs), 3600))
    body = b"\n".join(r.encode() for r in (px_records or []))
    return _struct.pack(">I", backoff) + body


def decode_prune_data(data: bytes):
    """Returns (backoff_secs, [px_record str])."""
    import struct as _struct

    if len(data) < 4:
        return 60, []
    (backoff,) = _struct.unpack(">I", data[:4])
    records = [r.decode() for r in data[4:].split(b"\n") if r]
    return backoff, records


class Endpoint:
    def __init__(self, hub: "Hub", peer_id: str):
        self.hub = hub
        self.peer_id = peer_id
        self.inbound: "queue.Queue[Envelope]" = queue.Queue()
        self.on_connect: Optional[Callable[[str], None]] = None
        self.on_disconnect: Optional[Callable[[str], None]] = None
        #: The owning node's telemetry scope (set by LocalNode) — endpoints
        #: outlive any contextvar activation, so the scope rides here.
        self.scope = None

    def connected_peers(self) -> Set[str]:
        return self.hub.peers_of(self.peer_id)

    def send(self, to: str, env: Envelope) -> bool:
        if env.trace_ctx is None and self.scope is not None:
            from .. import telemetry_scope

            env.trace_ctx = telemetry_scope.envelope_trace_ctx(self.scope)
        return self.hub.deliver(self.peer_id, to, env)

    def disconnect(self, peer: str) -> None:
        self.hub.disconnect(self.peer_id, peer)


@dataclass
class LinkPlan:
    """Seeded fault plan for one link (or the whole fabric as default).

    ``delay``/``jitter`` are in hub *ticks* (the simulator advances one tick
    per slot; scenario pumps advance faster while waiting on sync) — a
    delayed envelope sits in the hub until :meth:`Hub.advance_tick` reaches
    its due tick.  ``kinds`` restricts the plan to envelope kinds (e.g.
    ``{"gossip"}`` to make gossip lossy while RPC stays reliable); ``None``
    affects everything."""

    drop: float = 0.0        # P(drop) per envelope
    delay: int = 0           # base delivery latency, in ticks
    jitter: int = 0          # + uniform [0, jitter] extra ticks
    duplicate: float = 0.0   # P(deliver a second copy)
    reorder: float = 0.0     # P(jump ahead of earlier-due traffic)
    kinds: Optional[frozenset] = None

    def applies_to(self, kind: str) -> bool:
        return self.kinds is None or kind in self.kinds

    def is_noop(self) -> bool:
        return (self.drop == 0.0 and self.delay == 0 and self.jitter == 0
                and self.duplicate == 0.0 and self.reorder == 0.0)

    def to_dict(self) -> dict:
        out = {"drop": self.drop, "delay": self.delay, "jitter": self.jitter,
               "duplicate": self.duplicate, "reorder": self.reorder}
        if self.kinds is not None:
            out["kinds"] = sorted(self.kinds)
        return out


class Hub:
    """The wire: tracks links, delivers envelopes, injects faults."""

    def __init__(self, seed: int = 0):
        self._endpoints: Dict[str, Endpoint] = {}
        self._links: Set[Tuple[str, str]] = set()
        self._lock = locksmith.lock("Hub._lock")
        self._rng = random.Random(seed)
        self.seed = seed
        self.drop_probability: float = 0.0
        self._partitions: Dict[str, int] = {}  # peer -> partition id
        # -------- fault fabric state (all guarded by self._lock) --------
        # unordered pair -> plans; the FIRST plan matching the envelope's
        # kind decides (so gossip can be lossy while RPC is merely slow)
        self._link_plans: Dict[Tuple[str, str], List[LinkPlan]] = {}
        self._default_plan: Optional[LinkPlan] = None
        self._link_seq: Dict[Tuple[str, str], int] = {}  # DIRECTED msg index
        self._delayed: List[tuple] = []  # heap of (due, prio, seq, to, env)
        self._delayed_seq = 0
        self._tick = 0
        self._counters: Dict[str, int] = {}
        self._schedule: Optional[Dict[str, List[str]]] = None
        # Optional per-tick hook, invoked outside the fabric lock after
        # each advance_tick.  The scenario engine installs the virtual
        # clock's advance here, making "ticks = hub ticks" structural.
        self.on_tick: Optional[Callable[[], None]] = None

    def register(self, peer_id: str) -> Endpoint:
        with self._lock:
            if peer_id in self._endpoints:
                raise ValueError(f"duplicate peer id {peer_id}")
            ep = Endpoint(self, peer_id)
            self._endpoints[peer_id] = ep
            return ep

    def unregister(self, peer_id: str) -> None:
        """Remove a peer and its links (node churn: a killed node's id must
        be re-registrable on restart, and in-flight delayed traffic to it
        must drop as ``dead``, not queue forever)."""
        peers = self.peers_of(peer_id)
        for other in peers:
            self.disconnect(peer_id, other)
        with self._lock:
            self._endpoints.pop(peer_id, None)

    def connect(self, a: str, b: str) -> None:
        """Symmetric dial (reference: libp2p connection established)."""
        with self._lock:
            self._links.add((min(a, b), max(a, b)))
        for x, y in ((a, b), (b, a)):
            ep = self._endpoints.get(x)
            if ep and ep.on_connect:
                ep.on_connect(y)

    def disconnect(self, a: str, b: str) -> None:
        with self._lock:
            self._links.discard((min(a, b), max(a, b)))
        for x, y in ((a, b), (b, a)):
            ep = self._endpoints.get(x)
            if ep and ep.on_disconnect:
                ep.on_disconnect(y)

    def peers_of(self, peer_id: str) -> Set[str]:
        with self._lock:
            out = set()
            for a, b in self._links:
                if a == peer_id:
                    out.add(b)
                elif b == peer_id:
                    out.add(a)
            return out

    def set_partition(self, peer_id: str, partition: int) -> None:
        with self._lock:
            self._partitions[peer_id] = partition

    def clear_partitions(self) -> None:
        with self._lock:
            self._partitions.clear()

    # ------------------------------------------------------- fault fabric

    def set_link_plan(self, a: str, b: str, plan: Optional[LinkPlan],
                      append: bool = False) -> None:
        """Install (or with ``None`` remove) a fault plan on the a<->b link.
        ``append=True`` stacks another plan; the first plan whose ``kinds``
        match an envelope decides for it.  Composes with partitions: a
        partition drops outright before the plan's dice ever roll."""
        key = (min(a, b), max(a, b))
        with self._lock:
            if plan is None:
                self._link_plans.pop(key, None)
            elif append and key in self._link_plans:
                self._link_plans[key].append(plan)
            else:
                self._link_plans[key] = [plan]

    def set_default_link_plan(self, plan: Optional[LinkPlan]) -> None:
        with self._lock:
            self._default_plan = plan

    def clear_link_plans(self) -> None:
        with self._lock:
            self._link_plans.clear()
            self._default_plan = None

    def record_schedule(self, enable: bool = True) -> None:
        """Start (or stop) recording per-directed-link delivery decisions —
        the byte-identical evidence the determinism tests compare."""
        with self._lock:
            self._schedule = {} if enable else None

    def schedule(self) -> Dict[str, List[str]]:
        with self._lock:
            return {k: list(v) for k, v in (self._schedule or {}).items()}

    def schedule_digest(self) -> str:
        """SHA-256 over the recorded per-link decision streams, link-sorted —
        stable under cross-link thread interleaving (each directed link's
        stream is already deterministic)."""
        h = hashlib.sha256()
        for link, entries in sorted(self.schedule().items()):
            h.update(link.encode())
            for e in entries:
                h.update(e.encode())
        return h.hexdigest()

    def fault_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    @property
    def tick(self) -> int:
        return self._tick

    def _count(self, key: str) -> None:
        self._counters[key] = self._counters.get(key, 0) + 1

    def _drop(self, reason: str) -> bool:
        with self._lock:
            self._count(f"dropped_{reason}")
        NET_ENVELOPES_DROPPED.inc(reason=reason)
        return False

    def _uniforms(self, sender: str, to: str, n: int) -> Tuple[float, float, float, int]:
        """Per-envelope decision randomness: a pure function of
        (seed, directed link, per-link message index) so the schedule of any
        one link replays byte-identically whatever the thread interleaving."""
        digest = hashlib.sha256(
            f"{self.seed}|{sender}>{to}|{n}".encode()).digest()
        u_drop = int.from_bytes(digest[0:8], "big") / 2.0 ** 64
        u_dup = int.from_bytes(digest[8:16], "big") / 2.0 ** 64
        u_reorder = int.from_bytes(digest[16:24], "big") / 2.0 ** 64
        jitter_raw = int.from_bytes(digest[24:28], "big")
        return u_drop, u_dup, u_reorder, jitter_raw

    def _log_schedule(self, sender: str, to: str, n: int, entry: str) -> None:
        if self._schedule is not None:
            self._schedule.setdefault(f"{sender}>{to}", []).append(f"{n}:{entry}")

    def deliver(self, sender: str, to: str, env: Envelope) -> bool:
        with self._lock:
            linked = (min(sender, to), max(sender, to)) in self._links
        if not linked:
            return self._drop("unlinked")
        if self._partitions.get(sender, 0) != self._partitions.get(to, 0):
            return self._drop("partition")
        if self.drop_probability and self._rng.random() < self.drop_probability:
            return self._drop("plan")
        # net.deliver injection point: error => drop, hang => stall the
        # sending thread, corrupt => flip one payload byte (the receiver's
        # decoders and penalties absorb it).
        from .. import fault_injection

        if fault_injection.ACTIVE:
            try:
                action = fault_injection.fire("net.deliver", op=env.kind)
            except fault_injection.InjectedFault:
                return self._drop("fault")
            if action == "corrupt" and env.data:
                flip = hashlib.sha256(env.data).digest()[0] % len(env.data)
                data = bytearray(env.data)
                data[flip] ^= 0xFF
                env = replace(env, data=bytes(data))
        # Decision, schedule log, and (for delayed traffic) heap insertion
        # happen under ONE lock hold with the per-link index assignment:
        # concurrent senders on the same directed link must not interleave
        # entries out of index order (the byte-identical-schedule contract).
        with self._lock:
            plan = None
            pair = (min(sender, to), max(sender, to))
            candidates = self._link_plans.get(pair)
            if candidates is None and self._default_plan is not None:
                candidates = [self._default_plan]
            for candidate in candidates or ():
                if candidate.applies_to(env.kind) and not candidate.is_noop():
                    plan = candidate
                    n = self._link_seq.get((sender, to), 0)
                    self._link_seq[(sender, to)] = n + 1
                    break
            if plan is not None:
                u_drop, u_dup, u_reorder, jitter_raw = self._uniforms(sender, to, n)
                if u_drop < plan.drop:
                    self._log_schedule(sender, to, n, "drop")
                    self._count("dropped_plan")
                    dropped = True
                else:
                    dropped = False
                    delay = plan.delay + (
                        jitter_raw % (plan.jitter + 1) if plan.jitter else 0)
                    dup = u_dup < plan.duplicate
                    reordered = delay > 0 and u_reorder < plan.reorder
                    entry = (f"d{delay}" + ("+dup" if dup else "")
                             + ("+ro" if reordered else ""))
                    self._log_schedule(sender, to, n, entry)
                    if delay > 0:
                        due = self._tick + delay
                        prio = 0 if reordered else 1
                        for _ in range(2 if dup else 1):
                            heapq.heappush(
                                self._delayed,
                                (due, prio, self._delayed_seq, to, env))
                            self._delayed_seq += 1
                        self._count("delayed")
                        if reordered:
                            self._count("reordered")
                    if dup:
                        self._count("duplicated")
        if plan is None:
            return self._put(to, env)
        if dropped:
            NET_ENVELOPES_DROPPED.inc(reason="plan")
            return False
        if delay == 0:
            ok = self._put(to, env)
            if dup:
                NET_ENVELOPES_DUPLICATED.inc()
                self._put(to, env)
            return ok
        NET_ENVELOPES_DELAYED.inc()
        if dup:
            NET_ENVELOPES_DUPLICATED.inc()
        if reordered:
            NET_ENVELOPES_REORDERED.inc()
        return True

    def _put(self, to: str, env: Envelope) -> bool:
        ep = self._endpoints.get(to)
        if ep is None:
            return self._drop("dead")
        ep.inbound.put(env)
        return True

    def advance_tick(self, tick: Optional[int] = None) -> int:
        """Advance the fabric clock and deliver every due delayed envelope.
        Reordered envelopes (prio 0) in a due batch deliver before normal
        ones; partitions and links are re-checked at drain time, so a
        message sent before a partition does not tunnel through it.
        Returns how many envelopes were delivered."""
        due_entries: List[tuple] = []
        with self._lock:
            self._tick = self._tick + 1 if tick is None else int(tick)
            while self._delayed and self._delayed[0][0] <= self._tick:
                due_entries.append(heapq.heappop(self._delayed))
            on_tick = self.on_tick
        if on_tick is not None:
            # outside the lock: the hook (a VirtualClock advance in
            # scenario runs) must not nest under the fabric lock
            on_tick()
        due_entries.sort(key=lambda e: (e[0], e[1], e[2]))
        delivered = 0
        for _due, _prio, _seq, to, env in due_entries:
            with self._lock:
                linked = (min(env.sender, to), max(env.sender, to)) in self._links
            if not linked:
                self._drop("unlinked")
                continue
            if self._partitions.get(env.sender, 0) != self._partitions.get(to, 0):
                self._drop("partition")
                continue
            if self._put(to, env):
                delivered += 1
        return delivered

    def pending_delayed(self) -> int:
        with self._lock:
            return len(self._delayed)
