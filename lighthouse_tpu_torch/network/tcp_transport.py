"""TCP transport: the socket-backed ``Endpoint`` implementation.

The second implementation of the transport seam: the
in-process ``Hub`` serves simulators; this one carries the same ``Envelope``
frames over real TCP sockets, so two OS processes can gossip and sync over
localhost (or a LAN) with the whole stack above the seam (gossip dedup, RPC,
peer scoring, range sync) unchanged.  Reference analog:
``lighthouse_network``'s libp2p TCP transport under the behaviour
composition (multistream-select's protocol negotiation maps to the envelope
header's topic/protocol strings).

Wire format per frame (all integers big-endian) — the
payload bytes on the wire ARE the spec ssz_snappy encodings (gossip data =
snappy-compressed SSZ exactly as the pubsub topic defines; rpc data = the
``rpc.py`` ssz_snappy request/response chunk bytes), with a fixed binary
header instead of the old JSON+base64 framing:

    u32 frame_len ||
    u8 kind (0 hello | 1 gossip | 2 rpc_request | 3 rpc_response)
    u8  sender_len  || sender utf8          (libp2p peer-id analog)
    u16 topic_len   || topic utf8           (gossip: /eth2/<digest>/<kind>/ssz_snappy)
    u16 proto_len   || protocol utf8        (rpc: /eth2/beacon_chain/req/<m>/<v>/ssz_snappy)
    u64 request_id
    u32 data_len    || data bytes (ssz_snappy)

A connection opens with a ``hello`` frame carrying the dialer's peer id; the
acceptor answers with its own.

A copy of the JAX package's ``lighthouse_tpu/network/tcp_transport.py``,
with one fault repaired: ``TcpEndpoint`` carries the ``scope`` attribute
that ``transport.Endpoint`` has and ``NetworkService.publish`` reads
(``None``: a socket endpoint stamps no trace context), so a service on a
bare ``TcpEndpoint`` publishes.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Callable, Dict, Optional, Set, Tuple

from .transport import Envelope

MAX_FRAME = 64 * 1024 * 1024

_KIND_TO_WIRE = {"hello": 0, "gossip": 1, "rpc_request": 2, "rpc_response": 3,
                 "ihave": 4, "iwant": 5, "subscribe": 6, "unsubscribe": 7,
                 "graft": 8, "prune": 9}
_WIRE_TO_KIND = {v: k for k, v in _KIND_TO_WIRE.items()}

# Per-stream protocols negotiated with multistream-select over yamux
# (secured mode).  Gossip-class traffic speaks the REAL gossipsub v1.1
# protobuf wire format (reference: vendored gossipsub protocol.rs
# PROTOCOL: "/meshsub/1.1.0" + varint-delimited rpc.proto frames); the
# envelope stream carries hello + the ssz_snappy req/resp chunks.
ENVELOPE_PROTOCOL = "/lighthouse-tpu/envelope/1.0.0"
MESHSUB_PROTOCOL = "/meshsub/1.1.0"
MESHSUB_KINDS = frozenset(
    {"gossip", "ihave", "iwant", "graft", "prune", "subscribe", "unsubscribe"})


class TcpTransportError(Exception):
    pass


def _encode(env: Envelope) -> bytes:
    sender = env.sender.encode()
    topic = (env.topic or "").encode()
    proto = (env.protocol or "").encode()
    if len(sender) > 0xFF or len(topic) > 0xFFFF or len(proto) > 0xFFFF:
        raise TcpTransportError("oversized envelope header field")
    payload = b"".join(
        (
            struct.pack(">BB", _KIND_TO_WIRE[env.kind], len(sender)),
            sender,
            struct.pack(">H", len(topic)),
            topic,
            struct.pack(">H", len(proto)),
            proto,
            struct.pack(">QI", env.request_id or 0, len(env.data)),
            env.data,
        )
    )
    return struct.pack(">I", len(payload)) + payload


def _decode(payload: bytes) -> Envelope:
    try:
        kind_b, sender_len = struct.unpack_from(">BB", payload, 0)
        pos = 2
        sender = payload[pos : pos + sender_len].decode()
        pos += sender_len
        (topic_len,) = struct.unpack_from(">H", payload, pos)
        pos += 2
        topic = payload[pos : pos + topic_len].decode() or None
        pos += topic_len
        (proto_len,) = struct.unpack_from(">H", payload, pos)
        pos += 2
        proto = payload[pos : pos + proto_len].decode() or None
        pos += proto_len
        request_id, data_len = struct.unpack_from(">QI", payload, pos)
        pos += 12
        data = payload[pos : pos + data_len]
        if len(data) != data_len or pos + data_len != len(payload):
            raise TcpTransportError("envelope length mismatch")
        kind = _WIRE_TO_KIND.get(kind_b)
        if kind is None:
            raise TcpTransportError(f"unknown envelope kind {kind_b}")
    except (struct.error, UnicodeDecodeError) as e:
        raise TcpTransportError(f"malformed envelope: {e}") from e
    return Envelope(
        kind=kind, sender=sender, topic=topic, protocol=proto,
        request_id=request_id, data=data,
    )


def _env_to_rpc(env: Envelope):
    """Gossip-class Envelope -> one gossipsub protobuf RPC."""
    from . import pb
    from .transport import decode_prune_data

    if env.kind == "gossip":
        return pb.RPC(publish=[pb.Message(data=env.data, topic=env.topic or "")])
    if env.kind == "subscribe":
        return pb.RPC(subscriptions=[pb.SubOpts(True, env.topic or "")])
    if env.kind == "unsubscribe":
        return pb.RPC(subscriptions=[pb.SubOpts(False, env.topic or "")])
    ctrl = pb.ControlMessage()
    if env.kind == "ihave":
        ctrl.ihave.append(pb.ControlIHave(env.topic or "", [env.data]))
    elif env.kind == "iwant":
        ctrl.iwant.append(pb.ControlIWant([env.data]))
    elif env.kind == "graft":
        ctrl.graft.append(pb.ControlGraft(env.topic or ""))
    elif env.kind == "prune":
        backoff, px = decode_prune_data(env.data)
        peers = []
        for rec in px:
            pid = rec.rsplit("|", 1)[1] if "|" in rec else ""
            peers.append(pb.PeerInfo(peer_id=pid.encode(),
                                     signed_peer_record=rec.encode()))
        ctrl.prune.append(pb.ControlPrune(env.topic or "", peers, backoff))
    else:
        raise TcpTransportError(f"not a meshsub kind: {env.kind}")
    return pb.RPC(control=ctrl)


def _rpc_to_envs(peer: str, rpc) -> list:
    """One inbound gossipsub RPC -> Envelopes for the service loop.  The
    sender is the connection's proven peer, never a wire field (Eth2
    StrictNoSign: gossipsub's anonymous mode)."""
    from .transport import encode_prune_data

    envs = []
    for sub in rpc.subscriptions:
        envs.append(Envelope(
            kind="subscribe" if sub.subscribe else "unsubscribe",
            sender=peer, topic=sub.topic_id))
    for msg in rpc.publish:
        envs.append(Envelope(kind="gossip", sender=peer, topic=msg.topic,
                             data=msg.data))
    ctrl = rpc.control
    if ctrl is not None:
        for ih in ctrl.ihave:
            for mid in ih.message_ids:
                envs.append(Envelope(kind="ihave", sender=peer,
                                     topic=ih.topic_id, data=mid))
        for iw in ctrl.iwant:
            for mid in iw.message_ids:
                envs.append(Envelope(kind="iwant", sender=peer, data=mid))
        for g in ctrl.graft:
            envs.append(Envelope(kind="graft", sender=peer, topic=g.topic_id))
        for pr in ctrl.prune:
            px = [p.signed_peer_record.decode("utf-8", "replace")
                  for p in pr.peers if p.signed_peer_record]
            envs.append(Envelope(
                kind="prune", sender=peer, topic=pr.topic_id,
                data=encode_prune_data(
                    pr.backoff if pr.backoff is not None else 60, px)))
    return envs


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(sock: socket.socket) -> Optional[bytes]:
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise TcpTransportError(f"frame of {length} bytes exceeds limit")
    return _read_exact(sock, length)


class _SecuredChannel:
    """Socket-shaped adapter over one yamux stream of a noise session, so
    every existing envelope path (sendall/recv/shutdown/close) works
    unchanged on a secured connection."""

    def __init__(self, session, stream, sock) -> None:
        self._session = session
        self._stream = stream
        self._sock = sock
        self._timeout = None
        self.remote_identity = session.conn.remote_identity

    def sendall(self, data: bytes) -> None:
        self._stream.send(data)

    def recv(self, n: int) -> bytes:
        try:
            return self._stream.recv(n, timeout=self._timeout)
        except Exception:
            return b""

    def settimeout(self, t) -> None:
        # A SOFT timeout on stream reads only — the raw socket must stay
        # timeout-free (the yamux rx thread owns it; a socket timeout
        # would tear down an idle healthy session).
        self._timeout = t

    def getpeername(self):
        return self._sock.getpeername()

    def shutdown(self, _how) -> None:
        self._session.close()

    def close(self) -> None:
        self._session.close()


class TcpEndpoint:
    """Drop-in for ``transport.Endpoint``: same attributes and methods, but
    peers live in other processes.

    ``secured=True`` upgrades every connection through the libp2p ladder
    (multistream-select -> Noise XX with a secp256k1 identity proof ->
    yamux) and runs the envelope protocol over one yamux stream — the
    reference's transport stack shape end to end."""

    def __init__(self, peer_id: str, host: str = "127.0.0.1", port: int = 0,
                 *, secured: bool = False, identity_priv: int = None):
        self.secured = secured
        if secured and identity_priv is None:
            from .discv5.enr import KeyPair

            identity_priv = KeyPair().priv
        self.identity_priv = identity_priv
        self.peer_id = peer_id
        # The owning node's telemetry scope, as on ``transport.Endpoint``
        # (``NetworkService.publish`` reads it; ``LocalNode`` sets it).
        self.scope = None
        self.inbound: "queue.Queue[Envelope]" = queue.Queue()
        self.on_connect: Optional[Callable[[str], None]] = None
        self.on_disconnect: Optional[Callable[[str], None]] = None
        self._conns: Dict[str, socket.socket] = {}
        # peer id -> Noise-proven secp256k1 identity (secured mode): while a
        # connection is LIVE, a second connection claiming its peer id with
        # a different key is refused (no eviction-by-impersonation).  The
        # binding lifts when the connection drops — peer ids here are
        # self-declared (the reference derives them from the key itself),
        # so pinning beyond the connection's life would lock out an
        # honestly-restarted peer with a fresh auto-generated key.
        self._peer_identities: Dict[str, bytes] = {}
        # peer id -> (host, listen_port) for re-dialing / peer exchange
        self.peer_listen_addrs: Dict[str, Tuple[str, int]] = {}
        # insertion-ordered ids whose address came from an UNAUTHENTICATED
        # PRUNE peer-exchange hint (bounded; only hints evict hints)
        self._px_hinted: Dict[str, None] = {}
        # peer -> live inbound meshsub reader count (DoS cap)
        self._meshsub_readers: Dict[str, int] = {}
        # per-connection write mutex: sendall from multiple threads must not
        # interleave partial frames on the stream
        self._write_locks: Dict[str, threading.Lock] = {}
        # peer -> (meshsub outbound yamux stream, its write lock): the
        # negotiated /meshsub/1.1.0 substream gossip-class envelopes ride
        # as protobuf RPC frames (secured mode only)
        self._meshsub_out: Dict[str, Tuple[object, threading.Lock]] = {}
        self._lock = threading.Lock()
        self._shutdown = False

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"tcp-accept-{peer_id}", daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------------- address

    @property
    def listen_addr(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    # ------------------------------------------------------------- dialing

    def _hello(self) -> "Envelope":
        # data carries OUR listen port (u16 be): the ephemeral socket port a
        # peer sees is useless for dialing us back or for peer exchange
        return Envelope(kind="hello", sender=self.peer_id,
                        data=struct.pack(">H", self.listen_addr[1]))

    def _record_peer_addr(self, peer: str, sock: socket.socket,
                          hello: "Envelope") -> None:
        if len(hello.data) >= 2:
            (listen_port,) = struct.unpack(">H", hello.data[:2])
            try:
                host = sock.getpeername()[0]
            except OSError:
                return  # connection already torn down — nothing to record
            self._store_peer_addr(peer, (host, listen_port))

    MAX_KNOWN_ADDRS = 1024  # bound the address book under peer churn

    def known_peer_addrs(self) -> Dict[str, Tuple[str, int]]:
        """Snapshot of known peer listen addresses (safe to iterate —
        handshake threads mutate the underlying dict under the lock)."""
        with self._lock:
            return dict(self.peer_listen_addrs)

    MAX_PX_HINTS = 256  # unauthenticated PX may only fill this many slots

    def px_hint(self, peer: str, addr: Tuple[str, int]) -> None:
        """PRUNE peer-exchange hint: record a dialable address only for
        peers we know NOTHING about — PX comes from an arbitrary peer and
        must never override OR DISPLACE an address learned from an
        established connection (address-book poisoning).  Hints live in a
        bounded sub-budget and only ever evict other hints; check and
        store are one critical section so a concurrent authoritative
        store wins."""
        with self._lock:
            if peer in self.peer_listen_addrs or peer == self.peer_id:
                return
            while len(self._px_hinted) >= self.MAX_PX_HINTS:
                victim = next(iter(self._px_hinted))
                self._px_hinted.pop(victim, None)
                self.peer_listen_addrs.pop(victim, None)
            if len(self.peer_listen_addrs) >= self.MAX_KNOWN_ADDRS:
                return  # book full of authoritative entries: drop the hint
            self._px_hinted[peer] = None
            self.peer_listen_addrs[peer] = addr

    def _store_peer_addr(self, peer: str, addr: Tuple[str, int]) -> None:
        with self._lock:
            # an authoritative store upgrades any PX hint for this peer
            self._px_hinted.pop(peer, None)
            self.peer_listen_addrs.pop(peer, None)
            self.peer_listen_addrs[peer] = addr
            while len(self.peer_listen_addrs) > self.MAX_KNOWN_ADDRS:
                victim = next(iter(self.peer_listen_addrs))
                self.peer_listen_addrs.pop(victim)
                self._px_hinted.pop(victim, None)

    def _upgrade_outbound(self, sock: socket.socket):
        """Shared ladder (noise.upgrade_outbound) + the envelope stream,
        negotiated per-stream with multistream-select like every libp2p
        substream.  The raw socket's timeout stays in force through the
        whole upgrade (a stalling peer fails the handshake instead of
        pinning it)."""
        from .noise import upgrade_outbound
        from .noise.multistream import negotiate_outbound

        session = upgrade_outbound(sock, self.identity_priv)
        stream = session.open_stream()
        negotiate_outbound(stream, [ENVELOPE_PROTOCOL])
        return _SecuredChannel(session, stream, sock)

    def _upgrade_inbound(self, sock: socket.socket):
        from .noise import upgrade_inbound
        from .noise.multistream import negotiate_inbound

        session = upgrade_inbound(sock, self.identity_priv)
        stream = session.accept_stream(timeout=10.0)
        negotiate_inbound(stream, [ENVELOPE_PROTOCOL])
        return _SecuredChannel(session, stream, sock)

    def dial(self, host: str, port: int, timeout: float = 5.0) -> str:
        """Connect to a remote endpoint; returns its peer id."""
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(timeout)
        try:
            if self.secured:
                sock = self._upgrade_outbound(sock)
                sock.settimeout(timeout)  # soft bound on the hello reads
            sock.sendall(_encode(self._hello()))
            payload = _read_frame(sock)
            if payload is None:
                raise TcpTransportError("peer closed during handshake")
            hello = _decode(payload)
            if hello.kind != "hello":
                raise TcpTransportError(
                    f"bad handshake frame kind {hello.kind!r}")
        except Exception:
            # no leaked fd (or yamux rx thread) on a failed handshake
            try:
                sock.close()
            except OSError:
                pass
            raise
        sock.settimeout(None)
        if not self._register_conn(hello.sender, sock):
            raise TcpTransportError(
                f"peer {hello.sender!r} refused: identity mismatch with a "
                "live connection")
        # the address we DIALED is authoritative for this peer (recorded
        # only for ESTABLISHED connections)
        self._store_peer_addr(hello.sender, (host, port))
        return hello.sender

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handshake_inbound, args=(sock,), daemon=True
            ).start()

    def _handshake_inbound(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(5.0)
            if self.secured:
                sock = self._upgrade_inbound(sock)
                sock.settimeout(5.0)  # soft bound on the hello reads
            payload = _read_frame(sock)
            if payload is None:
                sock.close()
                return
            hello = _decode(payload)
            if hello.kind != "hello":
                sock.close()
                return
            sock.sendall(_encode(self._hello()))
            sock.settimeout(None)
        except Exception:
            sock.close()
            return
        if self._register_conn(hello.sender, sock):
            # address recorded only for ESTABLISHED connections — a refused
            # impersonator must not poison the address book either
            self._record_peer_addr(hello.sender, sock, hello)

    def _register_conn(self, peer: str, sock: socket.socket) -> bool:
        """Returns False when the connection was REFUSED (identity
        mismatch against a live binding) — callers must not report it as
        established.  Check and install are ONE critical section: two
        concurrent handshakes for the same peer id must never leave the
        binding describing a key other than the surviving connection's."""
        identity = getattr(sock, "remote_identity", None)
        old = None
        with self._lock:
            bound = self._peer_identities.get(peer)
            if (identity is not None and bound is not None
                    and bound != identity and peer in self._conns):
                refused = True  # live conn + proven-key mismatch
            else:
                refused = False
                if identity is not None:
                    self._peer_identities[peer] = identity
                old = self._conns.pop(peer, None)
                self._conns[peer] = sock
                self._write_locks[peer] = threading.Lock()
                # the superseded connection's meshsub stream dies with its
                # session — a send through it would tear down THIS conn
                self._meshsub_out.pop(peer, None)
        if refused:
            try:
                sock.close()
            except OSError:
                pass
            return False
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        threading.Thread(
            target=self._read_loop, args=(peer, sock),
            name=f"tcp-read-{self.peer_id}-{peer}", daemon=True,
        ).start()
        session = getattr(sock, "_session", None)
        if session is not None:
            # Secured connection: accept the peer's substreams (its
            # outbound meshsub) BEFORE opening ours — two nodes opening
            # simultaneously must not deadlock on each other's accept.
            threading.Thread(
                target=self._stream_demux, args=(peer, sock, session),
                name=f"meshsub-demux-{self.peer_id}-{peer}", daemon=True,
            ).start()
            try:
                self._open_meshsub(peer, sock, session)
            except Exception:
                # gossip falls back to the envelope stream — same bytes
                # at the service layer, just not the protobuf framing
                pass
        if self.on_connect:
            self.on_connect(peer)
        return True

    # ------------------------------------------------------------ meshsub

    def _open_meshsub(self, peer: str, channel, session) -> None:
        """Open + negotiate OUR /meshsub/1.1.0 send stream (libp2p
        gossipsub keeps one unidirectional outbound stream per peer)."""
        from .noise.multistream import negotiate_outbound

        stream = session.open_stream()
        negotiate_outbound(stream, [MESHSUB_PROTOCOL])
        with self._lock:
            if self._conns.get(peer) is not channel:
                stream.close()  # superseded while negotiating
                return
            self._meshsub_out[peer] = (stream, threading.Lock())

    def _stream_demux(self, peer: str, channel, session) -> None:
        """Accept inbound substreams for the connection's lifetime and
        dispatch by negotiated protocol (the libp2p behaviour's inbound
        stream handler)."""
        from .noise.multistream import MultistreamError, negotiate_inbound
        from .noise.yamux import YamuxError

        while not self._shutdown and session._running:
            with self._lock:
                if self._conns.get(peer) is not channel:
                    return  # superseded
            try:
                stream = session.accept_stream(timeout=5.0)
            except YamuxError:
                continue
            except Exception:
                return
            try:
                proto = negotiate_inbound(stream, [MESHSUB_PROTOCOL])
            except (MultistreamError, YamuxError, OSError):
                try:
                    stream.close()
                except Exception:
                    pass
                continue
            if proto == MESHSUB_PROTOCOL:
                # libp2p gossipsub keeps ONE inbound stream per peer (a
                # replacement during re-negotiation makes two briefly);
                # anything beyond that is a thread-exhaustion attack.
                with self._lock:
                    live = self._meshsub_readers.get(peer, 0)
                    if live >= 2:
                        over = True
                    else:
                        over = False
                        self._meshsub_readers[peer] = live + 1
                if over:
                    try:
                        stream.close()
                    except Exception:
                        pass
                    continue
                threading.Thread(
                    target=self._meshsub_read_loop,
                    args=(peer, channel, stream),
                    name=f"meshsub-read-{self.peer_id}-{peer}", daemon=True,
                ).start()

    def _meshsub_read_loop(self, peer: str, channel, stream) -> None:
        """Decode varint-delimited protobuf RPC frames into Envelopes.
        A protocol violation (StrictNoSign field, bad framing) drops the
        CONNECTION — the reference's gossipsub handler does the same for
        invalid RPCs."""
        from . import pb

        violated = False
        try:
            while not self._shutdown:
                rpc = pb.read_frame(lambda n: stream.recv_exact(n, timeout=None))
                for env in _rpc_to_envs(peer, rpc):
                    self.inbound.put(env)
        except pb.PbError:
            violated = True
        except Exception:
            pass
        finally:
            with self._lock:
                live = self._meshsub_readers.get(peer, 0) - 1
                if live > 0:
                    self._meshsub_readers[peer] = live
                else:
                    self._meshsub_readers.pop(peer, None)
        if violated:
            with self._lock:
                current = self._conns.get(peer) is channel
            if current:
                self._drop_conn(peer, channel)

    # ---------------------------------------------------------------- io

    def _read_loop(self, peer: str, sock: socket.socket) -> None:
        try:
            while not self._shutdown:
                payload = _read_frame(sock)
                if payload is None:
                    break
                try:
                    env = _decode(payload)
                except (TcpTransportError, KeyError, ValueError):
                    break  # protocol violation: drop the connection
                self.inbound.put(env)
        except (OSError, TcpTransportError):
            pass
        self._drop_conn(peer, sock)

    def _drop_conn(self, peer: str, sock: socket.socket) -> None:
        with self._lock:
            if self._conns.get(peer) is sock:
                del self._conns[peer]
                self._write_locks.pop(peer, None)
                self._meshsub_out.pop(peer, None)
                # the identity binding lives as long as the connection
                self._peer_identities.pop(peer, None)
            else:
                return  # superseded by a reconnect
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        if self.on_disconnect and not self._shutdown:
            self.on_disconnect(peer)

    # -------------------------------------------------- Endpoint interface

    def connected_peers(self) -> Set[str]:
        with self._lock:
            return set(self._conns)

    def send(self, to: str, env: Envelope) -> bool:
        with self._lock:
            sock = self._conns.get(to)
            wlock = self._write_locks.get(to)
            meshsub = (self._meshsub_out.get(to)
                       if env.kind in MESHSUB_KINDS else None)
        if sock is None or wlock is None:
            return False
        try:
            if meshsub is not None:
                from . import pb

                stream, mlock = meshsub
                frame = pb.encode_frame(_env_to_rpc(env))
                with mlock:
                    stream.send(frame)
                return True
            with wlock:
                sock.sendall(_encode(env))
            return True
        except Exception as e:
            # secured channels raise YamuxError/NoiseError, raw sockets
            # OSError — the Endpoint contract is bool either way, and a
            # dead connection must be dropped (on_disconnect must fire)
            from .noise.protocol import NoiseError
            from .noise.yamux import YamuxError

            if not isinstance(e, (OSError, YamuxError, NoiseError)):
                raise
            self._drop_conn(to, sock)
            return False

    def disconnect(self, peer: str) -> None:
        with self._lock:
            sock = self._conns.get(peer)
        if sock is not None:
            self._drop_conn(peer, sock)

    def close(self) -> None:
        self._shutdown = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.items())
            self._conns.clear()
        for _, sock in conns:
            try:
                # shutdown() wakes the peer AND our own blocked reader thread
                # (close() alone doesn't interrupt an in-flight recv)
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
