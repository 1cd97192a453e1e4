"""Per-node network service: gossip pub/sub + RPC streams over a transport
endpoint.

The role of the reference's ``lighthouse_network`` service composition
(`service/mod.rs`): owns the transport endpoint, the peer manager, topic
subscriptions, the seen-message cache, and RPC request/response correlation.

Gossip is real gossipsub v1.1 behaviour: inbound messages dedup by the
eth2 message-id (SHA256(domain + uncompressed payload)[:20]), route to the
router for validation, and forward only after acceptance — into a mesh
maintained by SubOpts subscription exchange and heartbeat GRAFT/PRUNE
between D_low/D_high with v1.1 prune backoff + peer exchange, plus
IHAVE/IWANT lazy pull and score-threshold gates.  On secured TCP
connections these envelopes ride the wire as ``/meshsub/1.1.0`` protobuf
RPC frames (``tcp_transport`` + ``pb``); on the in-process hub they stay
envelopes — same behaviour either way.

A copy of the JAX package's ``lighthouse_tpu/network/service.py``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from . import rpc as rpc_mod
from .peer_manager import PeerManager
from .transport import Endpoint, Envelope

#: Every gossip validation REJECT, by topic kind and reason — the router's
#: rejection paths all funnel through ``NetworkService.reject_gossip`` so a
#: lying peer's junk is simultaneously counted here and scored into the
#: graylist/ban ladder (reference: gossipsub REJECT -> peer penalty).
GOSSIP_REJECTED = metrics.counter(
    "gossip_rejected_total",
    "gossip messages rejected at validation, by topic kind and reason",
)

MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
SEEN_CACHE_SIZE = 16384

# Gossipsub-shaped dissemination (reference vendored gossipsub: behaviour.rs
# mesh maintenance + IHAVE/IWANT lazy gossip).  Eager push goes to at most
# MESH_DEGREE peers per topic; up to LAZY_DEGREE others get an IHAVE with the
# message id and pull what they miss with IWANT.  With few peers everything
# degenerates to the old flood — same delivery, bounded amplification at
# scale.
MESH_DEGREE = 8  # gossipsub D
MESH_DEGREE_LOW = 4  # D_low: heartbeat grafts below this
MESH_DEGREE_HIGH = 12  # D_high: heartbeat prunes above this
LAZY_DEGREE = 6  # gossip_lazy
MCACHE_SIZE = 512  # message cache entries servable via IWANT
IWANT_RETRY_SECS = 5.0  # re-pull window when an advertiser never delivers
HEARTBEAT_SECS = 1.0  # gossipsub heartbeat_interval
PRUNE_BACKOFF_SECS = 60  # v1.1 prune_backoff: no re-graft window
MAX_PROMISES_PER_PEER = 32  # outstanding IWANTs we owe any one advertiser
PX_PEERS = 16  # v1.1 prune_peers: peer-exchange records per PRUNE

# Gossipsub v1.1 peer-score thresholds (reference PeerScoreThresholds /
# lighthouse_network's gossipsub config), mapped onto THIS peer manager's
# score scale (disconnect at -20, ban at -50 — peer_manager.py):
#  - below GOSSIP: the peer gets no eager push and no IHAVE from us
#  - below PUBLISH: our own publications skip it too
#  - below GRAYLIST: every incoming gossip/control message is ignored
GOSSIP_THRESHOLD = -5.0
PUBLISH_THRESHOLD = -10.0
GRAYLIST_THRESHOLD = -16.0


def message_id(uncompressed: bytes) -> bytes:
    """Spec gossip message-id for snappy-decodable messages."""
    return hashlib.sha256(MESSAGE_DOMAIN_VALID_SNAPPY + uncompressed).digest()[:20]


class NetworkService:
    def __init__(self, endpoint: Endpoint, peer_manager: Optional[PeerManager] = None,
                 rate_limiter=None, clock=None):
        from .rate_limiter import RPCRateLimiter

        self.endpoint = endpoint
        self.peer_id = endpoint.peer_id
        if peer_manager is not None:
            self.peer_manager = peer_manager
        else:
            # clock: optional callable for score decay / ban lifts — the
            # simulator threads its virtual clock here so peer scoring is
            # deterministic under host load
            self.peer_manager = (PeerManager(clock=clock) if clock is not None
                                 else PeerManager())
        self.rate_limiter = rate_limiter if rate_limiter is not None else RPCRateLimiter()
        # outbound throttle (self_limiter.rs): same quotas as we enforce
        # on peers — never send what we ourselves would reject
        self.self_limiter = RPCRateLimiter()
        self.subscriptions: set = set()
        # gossipsub mesh state (reference vendored gossipsub behaviour.rs):
        # peer_topics — which topics each connected peer announced via
        # SubOpts; mesh — full-message peers per topic (both grafted-by-us
        # and grafted-us); _graft_backoff — (peer, topic) -> monotonic
        # deadline before which re-GRAFT is refused (v1.1 prune backoff)
        self.peer_topics: Dict[str, set] = {}
        self.mesh: Dict[str, set] = {}
        self._graft_backoff: Dict[Tuple[str, str], float] = {}
        self._mesh_lock = threading.Lock()
        self._last_heartbeat = 0.0
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()
        # mid -> (topic, compressed, origin trace_ctx): the cached ctx rides
        # IWANT re-serves, so a pulled message still carries its ORIGINAL
        # publisher's trace context, not the re-server's.
        self._mcache: "OrderedDict[bytes, Tuple[str, bytes, Optional[dict]]]" = OrderedDict()
        # mid -> (sent_at, advertiser, topic): a peer whose IHAVE we
        # pulled owes us the message (gossip_promises.rs); broken promises
        # take the mild behaviour penalty, NEVER a violation-grade strike
        # (an honest peer's mcache eviction between IHAVE and IWANT is
        # normal churn)
        self._iwant_pending: "OrderedDict[bytes, Tuple[float, str, str]]" = OrderedDict()
        self._seen_lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._next_request_id = 1
        self._pending: Dict[int, dict] = {}
        # router hooks, set by Router.attach
        self.on_gossip: Optional[Callable] = None  # (topic, data, sender) -> bool accept
        # trace-aware variant: (topic, uncompressed, compressed, sender,
        # trace_ctx).  Preferred over on_gossip when set; the 4-arg hook
        # stays for callers (tests, harnesses) that don't care about ctx.
        self.on_gossip_ctx: Optional[Callable] = None
        self.on_rpc_request: Optional[Callable] = None  # (protocol, req, sender) -> chunks
        self.on_peer_connected: Optional[Callable] = None
        self.on_peer_disconnected: Optional[Callable] = None

        endpoint.on_connect = self._handle_connect
        endpoint.on_disconnect = self._handle_disconnect
        self._processing = False  # see _run: Simulator.settle quiescence
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._run, name=f"net-{self.peer_id}", daemon=True
        )
        self._thread.start()

    # ----------------------------------------------------------- lifecycle

    def _handle_connect(self, peer: str) -> None:
        if not self.peer_manager.on_connect(peer):
            self.endpoint.disconnect(peer)  # banned
            return
        # announce our topic interest (gossipsub: SubOpts on stream open)
        for topic in sorted(self.subscriptions):
            self.endpoint.send(
                peer, Envelope(kind="subscribe", sender=self.peer_id, topic=topic)
            )
        if self.on_peer_connected:
            self.on_peer_connected(peer)

    def _handle_disconnect(self, peer: str) -> None:
        with self._mesh_lock:
            self.peer_topics.pop(peer, None)
            for members in self.mesh.values():
                members.discard(peer)
        self.peer_manager.on_disconnect(peer)
        if self.on_peer_disconnected:
            self.on_peer_disconnected(peer)

    def shutdown(self) -> None:
        self._shutdown = True
        self.endpoint.inbound.put(None)  # wake the loop
        self._thread.join(timeout=2.0)

    # ------------------------------------------------------------- gossip

    def subscribe(self, topic: str) -> None:
        topic = str(topic)
        if topic in self.subscriptions:
            return
        self.subscriptions.add(topic)
        env = Envelope(kind="subscribe", sender=self.peer_id, topic=topic)
        for peer in self.endpoint.connected_peers():
            self.endpoint.send(peer, env)
        # mesh formation happens on the next heartbeat (gossipsub JOIN)

    def unsubscribe(self, topic: str) -> None:
        topic = str(topic)
        if topic not in self.subscriptions:
            return
        self.subscriptions.discard(topic)
        # promises for the topic we are LEAVING are void, not broken —
        # the delivery would be dropped at the subscription gate
        with self._seen_lock:
            for mid in [m for m, (_t, _a, t_) in self._iwant_pending.items()
                        if t_ == topic]:
                del self._iwant_pending[mid]
        # gossipsub LEAVE: PRUNE every mesh member, then announce
        with self._mesh_lock:
            members = self.mesh.pop(topic, set())
        for peer in members:
            self._send_prune(peer, topic)
        env = Envelope(kind="unsubscribe", sender=self.peer_id, topic=topic)
        for peer in self.endpoint.connected_peers():
            self.endpoint.send(peer, env)

    def _mark_seen(self, mid: bytes) -> bool:
        """True if newly seen."""
        with self._seen_lock:
            if mid in self._seen:
                return False
            self._seen[mid] = None
            while len(self._seen) > SEEN_CACHE_SIZE:
                self._seen.popitem(last=False)
            return True

    def _cache_message(self, mid: bytes, topic: str, compressed: bytes,
                       trace_ctx: Optional[dict] = None) -> None:
        with self._seen_lock:
            self._mcache[mid] = (topic, compressed, trace_ctx)
            while len(self._mcache) > MCACHE_SIZE:
                self._mcache.popitem(last=False)

    def _rank_key(self, topic: str):
        """Stable per-(node, topic) peer ranking.  OUR peer id is mixed
        into the order — a global order would make every node pick the same
        top peers and starve the tail; per-node orders give the
        random-graph connectivity gossipsub meshes rely on."""
        me = self.peer_id.encode()

        def key(p: str) -> bytes:
            return hashlib.sha256(me + p.encode() + topic.encode()).digest()

        return key

    def eager_lazy_split(self, topic: str, candidates, grafted) -> Tuple[list, list]:
        """The dissemination split: the grafted mesh topped up by ranked
        candidates to the target degree gets the full message; the next
        LAZY_DEGREE ranked peers get IHAVE."""
        grafted = set(grafted)
        ranked = sorted((p for p in candidates if p not in grafted),
                        key=self._rank_key(topic))
        eager = list(grafted) + ranked[:max(0, MESH_DEGREE - len(grafted))]
        lazy = [p for p in ranked if p not in eager][:LAZY_DEGREE]
        return eager, lazy

    def _topic_candidates(self, topic: str, exclude: Optional[str], floor: float):
        """Connected peers eligible for ``topic`` traffic: above the score
        floor and — when they have announced a subscription set — actually
        subscribed (gossipsub never pushes to peers outside the topic).  A
        peer with NO announcement yet is included: its SubOpts may still be
        in flight."""
        pm = self.peer_manager
        with self._mesh_lock:
            # membership-only reads under the lock — no per-message deep
            # copy of every peer's whole topic set
            excluded = {p for p, ts in self.peer_topics.items()
                        if topic not in ts}
        out = []
        for p in pm.connected_peers():
            if p == exclude or p in excluded or pm.score(p) < floor:
                continue
            out.append(p)
        return out

    def _disseminate(self, topic: str, mid: bytes, compressed: bytes,
                     exclude: Optional[str], publishing: bool = False,
                     trace_ctx: Optional[dict] = None) -> int:
        self._cache_message(mid, topic, compressed, trace_ctx=trace_ctx)
        # v1.1 score gates: low-scored peers fall out of gossip entirely,
        # and our OWN publications demand the stricter publish threshold.
        floor = PUBLISH_THRESHOLD if publishing else GOSSIP_THRESHOLD
        candidates = self._topic_candidates(topic, exclude, floor)
        with self._mesh_lock:
            grafted = set(self.mesh.get(topic, ())) & set(candidates)
        # Eager push: the grafted mesh, topped up by ranked candidates until
        # the target degree — a just-subscribed node has full delivery
        # before its first heartbeat forms the mesh.
        eager, lazy = self.eager_lazy_split(topic, candidates, grafted)
        env = Envelope(kind="gossip", sender=self.peer_id, topic=topic,
                       data=compressed, trace_ctx=trace_ctx)
        n = 0
        for peer in eager:
            if self.endpoint.send(peer, env):
                n += 1
        if lazy:
            ihave = Envelope(kind="ihave", sender=self.peer_id, topic=topic, data=mid)
            for peer in lazy:
                self.endpoint.send(peer, ihave)
        return n

    def publish(self, topic: str, uncompressed: bytes) -> int:
        """Publish locally-originated data; returns #peers eagerly reached.

        The publisher's trace context is resolved HERE (not lazily at
        ``Endpoint.send``) so the mcache entry carries it too — an IWANT
        re-serve must present the origin's context, deterministically,
        whichever node serves the pull."""
        from . import snappy_codec

        ctx = None
        if self.endpoint.scope is not None:
            from .. import telemetry_scope

            ctx = telemetry_scope.envelope_trace_ctx(self.endpoint.scope)
        mid = message_id(uncompressed)
        self._mark_seen(mid)
        return self._disseminate(
            str(topic), mid, snappy_codec.compress(uncompressed), exclude=None,
            publishing=True, trace_ctx=ctx,
        )

    def forward(self, topic: str, compressed: bytes, exclude: str,
                uncompressed: Optional[bytes] = None,
                trace_ctx: Optional[dict] = None) -> int:
        """Forward validated gossip.  Callers that hold the uncompressed
        bytes (the router always does) pass them to avoid re-decompressing
        multi-MB payloads on the propagation hot path.  ``trace_ctx``
        preserves the ORIGIN's envelope trace context across hops (the
        router passes through what it received)."""
        from . import snappy_codec

        if uncompressed is None:
            try:
                uncompressed = snappy_codec.decompress(compressed)
            except snappy_codec.SnappyError:
                return 0
        return self._disseminate(
            str(topic), message_id(uncompressed), compressed, exclude=exclude,
            trace_ctx=trace_ctx,
        )

    # ---------------------------------------------------------------- rpc

    def request(
        self, peer: str, protocol: str, request, timeout: float = 5.0
    ) -> List[Tuple[int, bytes, Optional[bytes]]]:
        """Blocking request; returns the response chunk list
        ``[(result, payload, context_bytes)]``.

        Outbound requests pass a SELF rate limiter first (reference
        ``rpc/self_limiter.rs``): we never send faster than peers are
        allowed to receive, so our own sync bursts cannot get us penalized
        or disconnected.  In this synchronous stack "queueing" = waiting
        for tokens, bounded by the request's own timeout."""
        from .rate_limiter import RateLimitExceeded, request_cost

        deadline = time.monotonic() + timeout
        cost = request_cost(protocol, request)
        throttled = False
        while True:
            try:
                self.self_limiter.allow(peer, protocol, cost)
                break
            except RateLimitExceeded as e:
                if e.fatal:
                    raise rpc_mod.RpcSelfLimited(
                        f"request to {peer} exceeds the {protocol} quota")
                if time.monotonic() >= deadline:
                    raise rpc_mod.RpcSelfLimited(
                        f"self-rate-limited to {peer} ({protocol})")
                throttled = True
                time.sleep(0.05)
        if throttled and deadline - time.monotonic() < 0.25:
            # the throttle consumed (almost) the whole budget: the network
            # wait below would time out instantly and be misread as the
            # PEER timing out — keep the attribution on our own limiter.
            # Only when the limiter actually waited: a small CALLER timeout
            # alone is not our throttle's fault.
            raise rpc_mod.RpcSelfLimited(
                f"self-rate-limited to {peer} ({protocol}): no budget left")
        with self._req_lock:
            rid = self._next_request_id
            self._next_request_id += 1
            entry = {"chunks": [], "done": threading.Event(), "protocol": protocol, "peer": peer}
            self._pending[rid] = entry
        env = Envelope(
            kind="rpc_request",
            sender=self.peer_id,
            protocol=protocol,
            request_id=rid,
            data=rpc_mod.encode_request(protocol, request),
        )
        if not self.endpoint.send(peer, env):
            with self._req_lock:
                self._pending.pop(rid, None)
            raise rpc_mod.RpcError(f"peer {peer} unreachable")
        # ONE budget covers throttle wait + network wait: time spent in the
        # self-limiter above comes out of the same deadline, so the caller
        # never blocks past its own timeout.
        if not entry["done"].wait(max(0.0, deadline - time.monotonic())):
            with self._req_lock:
                self._pending.pop(rid, None)
            raise rpc_mod.RpcError(f"request to {peer} timed out ({protocol})")
        return entry["chunks"]

    # ------------------------------------------------------------ inbound

    def _run(self) -> None:
        import queue as queue_mod

        while not self._shutdown:
            got_item = False
            try:
                env = self.endpoint.inbound.get(timeout=0.5)
                got_item = True
                # quiescence beacon for Simulator.settle().  NOTE: between
                # the get() above and this assignment the envelope is in
                # hand but invisible to both the queue and the flag — a
                # settle that read only .empty() + _processing could slip
                # into that gap.  Settle therefore keys on the queue's
                # task accounting (unfinished_tasks, decremented only in
                # the finally below), which has no such window; the flag
                # stays as a redundant beacon.
                self._processing = True
            except queue_mod.Empty:
                env = None
            # Drain score-triggered disconnects (reference: the peer
            # manager's heartbeat closes connections below the threshold).
            for peer in self.peer_manager.heartbeat():
                self.endpoint.disconnect(peer)
            now = time.monotonic()
            if now - self._last_heartbeat >= HEARTBEAT_SECS:
                self._last_heartbeat = now
                self._mesh_heartbeat(now)
                self._expire_gossip_promises(now)
            if env is None:
                if got_item:  # the stop() wake sentinel
                    self._processing = False
                    self.endpoint.inbound.task_done()
                continue
            # _processing stays True until the envelope's work is handed
            # off (router validation enqueues to the processor BEFORE the
            # finally clears it, so a settle check that sees False + empty
            # inbound + idle processor has seen every consequence)
            try:
                if env.kind == "gossip":
                    self._on_gossip(env)
                elif env.kind == "ihave":
                    self._on_ihave(env)
                elif env.kind == "iwant":
                    self._on_iwant(env)
                elif env.kind == "subscribe":
                    self._on_subscribe(env)
                elif env.kind == "unsubscribe":
                    self._on_unsubscribe(env)
                elif env.kind == "graft":
                    self._on_graft(env)
                elif env.kind == "prune":
                    self._on_prune(env)
                elif env.kind == "rpc_request":
                    self._on_rpc_request(env)
                elif env.kind == "rpc_response":
                    self._on_rpc_response(env)
            except Exception:
                # network loop must survive malformed input (reference:
                # codec errors → peer penalty, not a crash)
                from .peer_manager import PeerAction

                self.peer_manager.report(env.sender, PeerAction.LOW_TOLERANCE, "codec error")
            finally:
                self._processing = False
                self.endpoint.inbound.task_done()

    # -------------------------------------------------- mesh maintenance

    def _send_prune(self, peer: str, topic: str) -> None:
        """PRUNE with v1.1 backoff + peer exchange.  Recording the backoff
        locally serves both directions: we won't re-graft the peer during
        the window, and a GRAFT from it inside the window is a violation."""
        from .transport import encode_prune_data

        px: list = []
        book_fn = getattr(self.endpoint, "known_peer_addrs", None)
        if book_fn is not None:
            with self._mesh_lock:
                excluded = {p for p, ts in self.peer_topics.items()
                            if topic not in ts}
            for p, (host, port) in book_fn().items():
                if p in (peer, self.peer_id) or p in excluded:
                    continue
                px.append(f"{host}:{port}|{p}")
                if len(px) >= PX_PEERS:
                    break
        with self._mesh_lock:
            self._graft_backoff[(peer, topic)] = (
                time.monotonic() + PRUNE_BACKOFF_SECS
            )
            self._trim_backoff_locked()
        self.endpoint.send(
            peer,
            Envelope(kind="prune", sender=self.peer_id, topic=topic,
                     data=encode_prune_data(PRUNE_BACKOFF_SECS, px)),
        )

    def _trim_backoff_locked(self) -> None:
        while len(self._graft_backoff) > 4096:
            self._graft_backoff.pop(next(iter(self._graft_backoff)))

    MAX_PEER_TOPICS = 1024  # a real node needs ~100 (64 subnets + core)

    def _on_subscribe(self, env: Envelope) -> None:
        if not env.topic:
            return
        # a queued announcement from an already-disconnected peer must not
        # resurrect its peer_topics entry (disconnect cleanup ran first)
        if env.sender not in self.endpoint.connected_peers():
            return
        from .peer_manager import PeerAction

        with self._mesh_lock:
            topics = self.peer_topics.setdefault(env.sender, set())
            if len(topics) >= self.MAX_PEER_TOPICS:
                overflow = env.topic not in topics
            else:
                topics.add(env.topic)
                overflow = False
        if overflow:
            self.peer_manager.report(
                env.sender, PeerAction.LOW_TOLERANCE, "subscription flood")

    def _on_unsubscribe(self, env: Envelope) -> None:
        if not env.topic:
            return
        with self._mesh_lock:
            self.peer_topics.get(env.sender, set()).discard(env.topic)
            self.mesh.get(env.topic, set()).discard(env.sender)

    def _on_graft(self, env: Envelope) -> None:
        """gossipsub handle_graft: accept into the mesh, or PRUNE back —
        and penalize backoff violations (v1.1 behaviour.rs)."""
        from .peer_manager import PeerAction

        topic, peer = env.topic, env.sender
        if not topic:
            return
        if peer not in self.endpoint.connected_peers():
            return  # stale GRAFT from a peer that already disconnected
        if topic not in self.subscriptions or self.peer_manager.score(peer) < 0:
            self._send_prune(peer, topic)
            return
        with self._mesh_lock:
            deadline = self._graft_backoff.get((peer, topic), 0.0)
        if time.monotonic() < deadline:
            self.peer_manager.report(
                peer, PeerAction.LOW_TOLERANCE, "graft inside prune backoff")
            self._send_prune(peer, topic)
            return
        with self._mesh_lock:
            self.mesh.setdefault(topic, set()).add(peer)
            # grafting implies the peer treats itself as subscribed
            self.peer_topics.setdefault(peer, set()).add(topic)

    def _on_prune(self, env: Envelope) -> None:
        from .transport import decode_prune_data

        topic, peer = env.topic, env.sender
        if not topic:
            return
        backoff, px = decode_prune_data(env.data)
        with self._mesh_lock:
            self.mesh.get(topic, set()).discard(peer)
            self._graft_backoff[(peer, topic)] = (
                time.monotonic() + min(int(backoff), 3600)
            )
            self._trim_backoff_locked()
        # v1.1 peer exchange: feed dialable records to the address book
        # (never overriding established entries — PX is a hint, not proof)
        hint = getattr(self.endpoint, "px_hint", None)
        if hint is None:
            return
        for rec in px[:PX_PEERS]:
            try:
                addr_part, pid = rec.rsplit("|", 1)
                host, port_s = addr_part.rsplit(":", 1)
                hint(pid, (host, int(port_s)))
            except ValueError:
                continue

    def _mesh_heartbeat(self, now: float) -> None:
        """Per-heartbeat mesh maintenance (gossipsub behaviour.rs
        heartbeat): expire backoffs, evict negative-score members, GRAFT up
        to D when below D_low, PRUNE down to D when above D_high."""
        pm = self.peer_manager
        connected = set(self.endpoint.connected_peers())
        with self._mesh_lock:
            for key in [k for k, d in self._graft_backoff.items() if d <= now]:
                del self._graft_backoff[key]
            mesh_snapshot = {t: set(m) for t, m in self.mesh.items()}
            backoff = dict(self._graft_backoff)
        for topic in sorted(self.subscriptions):
            snapshot = mesh_snapshot.get(topic, set())
            members = snapshot & connected
            removals = snapshot - connected  # gone peers leave the mesh
            bad = {p for p in members if pm.score(p) < 0}
            for p in bad:
                self._send_prune(p, topic)
            members -= bad
            removals |= bad
            additions: set = set()
            if len(members) < MESH_DEGREE_LOW:
                with self._mesh_lock:
                    subscribed = {p for p, ts in self.peer_topics.items()
                                  if topic in ts}
                candidates = [
                    p for p in connected
                    if p not in members
                    and pm.score(p) >= 0
                    and p in subscribed
                    and backoff.get((p, topic), 0.0) <= now
                ]
                ranked = sorted(candidates, key=self._rank_key(topic))
                graft = Envelope(kind="graft", sender=self.peer_id, topic=topic)
                for p in ranked[:MESH_DEGREE - len(members)]:
                    additions.add(p)
                    self.endpoint.send(p, graft)
            elif len(members) > MESH_DEGREE_HIGH:
                ranked = sorted(members, key=self._rank_key(topic))
                for p in ranked[MESH_DEGREE:]:
                    removals.add(p)
                    self._send_prune(p, topic)
            # Apply as DELTAS under the lock — an unsubscribe() or
            # disconnect that raced this round's snapshot must not be
            # clobbered by writing the snapshot back wholesale.
            with self._mesh_lock:
                if topic not in self.subscriptions:
                    self.mesh.pop(topic, None)
                    continue
                cur = self.mesh.setdefault(topic, set())
                cur -= removals
                cur |= additions

    @staticmethod
    def _topic_kind_label(topic: str) -> str:
        """Bounded-cardinality topic label: the topic KIND with subnet
        indices collapsed (64 attestation subnets are one label)."""
        try:
            kind = topic.split("/")[3]
        except IndexError:
            return "unknown"
        for prefix in ("beacon_attestation_", "sync_committee_",
                       "blob_sidecar_"):
            if kind.startswith(prefix) and kind[len(prefix):].isdigit():
                return prefix.rstrip("_")
        return kind or "unknown"

    def reject_gossip(self, sender: str, topic: str, reason: str,
                      action: Optional[str] = None, detail: str = "",
                      penalize: bool = True) -> None:
        """One funnel for every gossip validation REJECT: count it
        (``gossip_rejected_total{topic,reason}``) and report the sender into
        the scoring/graylist ladder.  ``reason`` is a bounded slug (the
        metric label); ``detail`` is the free-form part of the peer-manager
        report only.  ``penalize=False`` counts without scoring — for
        IGNORE-grade drops (view-lag races) that must stay visible but must
        never bleed honest peers."""
        from .peer_manager import PeerAction

        GOSSIP_REJECTED.inc(topic=self._topic_kind_label(topic), reason=reason)
        if penalize:
            self.peer_manager.report(
                sender, action or PeerAction.LOW_TOLERANCE,
                f"{reason}: {detail}" if detail else reason)

    def _graylisted(self, peer: str) -> bool:
        return self.peer_manager.score(peer) < GRAYLIST_THRESHOLD

    def _below_gossip_threshold(self, peer: str) -> bool:
        return self.peer_manager.score(peer) < GOSSIP_THRESHOLD

    def _on_gossip(self, env: Envelope) -> None:
        from . import snappy_codec

        if env.topic not in self.subscriptions or self._graylisted(env.sender):
            return
        try:
            uncompressed = snappy_codec.decompress(env.data)
        except snappy_codec.SnappyError:
            self.reject_gossip(env.sender, env.topic, "bad_snappy")
            return
        mid = message_id(uncompressed)
        with self._seen_lock:
            self._iwant_pending.pop(mid, None)  # pull satisfied (if any)
        if not self._mark_seen(mid):
            return
        # Router validates (possibly via the beacon processor) and calls
        # ``forward`` itself on acceptance — mirrors the reference's
        # propagate-after-validation flow.  The ctx-aware hook wins when
        # set; the 4-arg hook keeps its signature for existing callers.
        if self.on_gossip_ctx is not None:
            self.on_gossip_ctx(env.topic, uncompressed, env.data, env.sender,
                               env.trace_ctx)
        elif self.on_gossip is not None:
            self.on_gossip(env.topic, uncompressed, env.data, env.sender)

    def _on_ihave(self, env: Envelope) -> None:
        """Lazy-gossip advert: pull the message if we haven't seen it
        (gossipsub handle_ihave → IWANT)."""
        mid = env.data
        if (len(mid) != 20 or env.topic not in self.subscriptions
                or self._below_gossip_threshold(env.sender)):
            # v1.1: IHAVE from below-gossip-threshold peers is ignored
            return
        now = time.monotonic()
        with self._seen_lock:
            if mid in self._seen or mid in self._mcache:
                return
            pending = self._iwant_pending.get(mid)
            if pending is not None and now - pending[0] < IWANT_RETRY_SECS:
                return  # an earlier pull is still in flight
            # per-peer cap (reference caps IHAVEs per heartbeat): an
            # IHAVE-spammer must not evict everyone else's promise
            # tracking — excess adverts are simply not pulled
            outstanding = sum(
                1 for (_t, adv, _topic) in self._iwant_pending.values()
                if adv == env.sender)
            if outstanding >= MAX_PROMISES_PER_PEER:
                return
            stale = self._iwant_pending.pop(mid, None)
            self._iwant_pending[mid] = (now, env.sender, env.topic)
            evicted = []
            if stale is not None:
                # replacing an EXPIRED promise: its advertiser broke it —
                # a re-advertising attacker must not reset its own clock
                evicted.append(stale[1])
            while len(self._iwant_pending) > MCACHE_SIZE:
                _mid, (t0, adv, _topic) = self._iwant_pending.popitem(last=False)
                if now - t0 >= IWANT_RETRY_SECS:
                    # only an already-EXPIRED promise is broken; an
                    # in-window eviction is our own capacity problem, not
                    # the advertiser's fault
                    evicted.append(adv)
        from .peer_manager import PeerAction

        for advertiser in evicted:
            self.peer_manager.report(
                advertiser, PeerAction.HIGH_TOLERANCE, "broken gossip promise")
        self.endpoint.send(
            env.sender,
            Envelope(kind="iwant", sender=self.peer_id, topic=env.topic, data=mid),
        )

    def _expire_gossip_promises(self, now: float) -> None:
        """v1.1 gossip promises (reference gossip_promises.rs): an
        advertiser that never delivers after our IWANT is penalized — an
        attacker spamming IHAVEs for messages it won't serve wastes our
        pull budget and delays real delivery."""
        from .peer_manager import PeerAction

        with self._seen_lock:
            broken = [(mid, adv) for mid, (t, adv, _topic)
                      in self._iwant_pending.items()
                      if now - t >= IWANT_RETRY_SECS]
            for mid, _ in broken:
                del self._iwant_pending[mid]
        for _mid, advertiser in broken:
            # mild behaviour penalty (reference applies a quadratic
            # behaviour_penalty, not a violation strike): honest churn
            # costs -1; a persistent promise-breaker still accumulates out
            self.peer_manager.report(
                advertiser, PeerAction.HIGH_TOLERANCE, "broken gossip promise")

    def _on_iwant(self, env: Envelope) -> None:
        """Serve a cached message to a puller (gossipsub handle_iwant)."""
        if self._below_gossip_threshold(env.sender):
            return  # v1.1: no pull access below the gossip threshold
        with self._seen_lock:
            entry = self._mcache.get(env.data)
        if entry is None:
            return
        topic, compressed, trace_ctx = entry
        self.endpoint.send(
            env.sender,
            Envelope(kind="gossip", sender=self.peer_id, topic=topic,
                     data=compressed, trace_ctx=trace_ctx),
        )

    def _on_rpc_request(self, env: Envelope) -> None:
        from .peer_manager import PeerAction
        from .rate_limiter import RateLimitExceeded, request_cost

        try:
            request = rpc_mod.decode_request(env.protocol, env.data)
        except (rpc_mod.RpcError, Exception):
            self.peer_manager.report(env.sender, PeerAction.LOW_TOLERANCE, "bad rpc request")
            chunk = rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"bad request")
            self._send_response(env.sender, env.request_id, [chunk])
            return
        # DoS protection (reference rpc/rate_limiter.rs): cost-weighted
        # token buckets per (peer, protocol) before any chain work.
        try:
            self.rate_limiter.allow(
                env.sender, env.protocol, request_cost(env.protocol, request)
            )
        except RateLimitExceeded as e:
            self.peer_manager.report(
                env.sender,
                PeerAction.LOW_TOLERANCE if e.fatal else PeerAction.HIGH_TOLERANCE,
                "rpc rate limit",
            )
            code = rpc_mod.INVALID_REQUEST if e.fatal else rpc_mod.RESOURCE_UNAVAILABLE
            chunk = rpc_mod.encode_response_chunk(code, b"rate limited")
            self._send_response(env.sender, env.request_id, [chunk])
            return
        chunks: List[bytes] = []
        if self.on_rpc_request is not None:
            chunks = self.on_rpc_request(env.protocol, request, env.sender)
        self._send_response(env.sender, env.request_id, chunks)

    def _send_response(self, peer: str, request_id: int, chunks: List[bytes]) -> None:
        for chunk in chunks:
            self.endpoint.send(
                peer,
                Envelope(
                    kind="rpc_response",
                    sender=self.peer_id,
                    request_id=request_id,
                    data=chunk,
                ),
            )
        # stream end marker
        self.endpoint.send(
            peer,
            Envelope(kind="rpc_response", sender=self.peer_id, request_id=request_id, data=b""),
        )

    def _on_rpc_response(self, env: Envelope) -> None:
        with self._req_lock:
            entry = self._pending.get(env.request_id)
        if entry is None:
            return
        if env.sender != entry["peer"]:
            # Only the peer the request was sent to may answer it: request ids
            # are a predictable counter, so without this check any connected
            # peer could inject forged chunks into another peer's pending
            # request (poisoning sync and misattributing penalties).
            from .peer_manager import PeerAction

            self.peer_manager.report(env.sender, PeerAction.LOW_TOLERANCE, "forged rpc response")
            return
        if env.data == b"":
            with self._req_lock:
                self._pending.pop(env.request_id, None)
            entry["done"].set()
            return
        has_context = entry["protocol"] in rpc_mod.CONTEXT_PROTOCOLS
        result, payload, context, _ = rpc_mod.decode_response_chunk(env.data, has_context)
        entry["chunks"].append((result, payload, context))
