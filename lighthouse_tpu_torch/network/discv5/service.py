"""The discv5 UDP node: sessions, handshake state machine, routing table.

Mirrors the role of the reference's ``discv5`` crate as driven by
``beacon_node/lighthouse_network/src/discovery/mod.rs``: nodes hold signed
ENRs, talk over masked UDP packets, establish AES-GCM sessions via the
WHOAREYOU handshake, answer PING/FINDNODE, and discover peers by querying
FINDNODE at descending log2-distances.

Threading model: one receive thread per service; requests are synchronous
with per-request events (discovery is control-plane traffic — latency, not
throughput).

A copy of the JAX package's ``lighthouse_tpu/network/discv5/service.py``.
"""

from __future__ import annotations

import secrets
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...logs import get_logger
from . import packets, rlp, secp256k1, session as session_mod
from .enr import ENR, EnrError, KeyPair

log = get_logger("discv5")

MSG_PING = 0x01
MSG_PONG = 0x02
MSG_FINDNODE = 0x03
MSG_NODES = 0x04

MAX_NODES_PER_PACKET = 3  # ENRs per NODES response (wire budget, spec ~4)
REQUEST_TIMEOUT = 3.0


class Discv5Error(Exception):
    pass


@dataclass
class Session:
    send_key: bytes
    recv_key: bytes


@dataclass
class _PendingRequest:
    message: bytes                    # full plaintext (type || rlp)
    request_id: bytes
    event: threading.Event = field(default_factory=threading.Event)
    responses: List = field(default_factory=list)
    total_expected: int = 1
    created: float = field(default_factory=time.monotonic)

PENDING_TTL = 10.0     # s: un-answered handshake elicitations
CHALLENGE_TTL = 30.0   # s: WHOAREYOU challenges we issued
MAX_ADDRS = 4096       # spoofed src-id flood bound


def _enr_to_item(enr: ENR):
    return rlp.decode(enr.to_rlp())


def _enr_from_item(item) -> ENR:
    return ENR.from_rlp(rlp.encode(item))


def log2_distance(a: bytes, b: bytes) -> int:
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


class Discv5Service:
    def __init__(self, keypair: Optional[KeyPair] = None, *,
                 ip: str = "127.0.0.1", port: int = 0):
        self.keypair = keypair or KeyPair()
        self.node_id = self.keypair.node_id
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((ip, port))
        self._sock.settimeout(0.2)
        self.ip, self.port = self._sock.getsockname()
        self.enr = ENR.build(self.keypair, seq=1, ip=self.ip, udp=self.port)
        # sessions + handshake state
        self._sessions: Dict[bytes, Session] = {}          # node-id -> keys
        self._pending: Dict[bytes, _PendingRequest] = {}   # nonce -> request
        self._requests: Dict[bytes, _PendingRequest] = {}  # request-id -> req
        self._challenges: Dict[bytes, Tuple[packets.Packet, float]] = {}  # node-id -> (WHOAREYOU, ts)
        self._addrs: Dict[bytes, Tuple[str, int]] = {}     # node-id -> addr
        # routing table: node-id -> ENR (flat; bucketized on query)
        self.table: Dict[bytes, ENR] = {}
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Discv5Service":
        self._running = True
        self._thread = threading.Thread(
            target=self._rx_loop, daemon=True,
            name=f"discv5-{self.node_id.hex()[:8]}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sock.close()

    # ------------------------------------------------------------- messages

    @staticmethod
    def _encode_message(msg_type: int, items) -> bytes:
        return bytes([msg_type]) + rlp.encode(items)

    def _new_request_id(self) -> bytes:
        return secrets.token_bytes(8)

    def _ping_message(self, request_id: bytes) -> bytes:
        return self._encode_message(
            MSG_PING, [request_id, rlp.encode_uint(self.enr.seq)]
        )

    # ------------------------------------------------------------ transport

    def _send_with_session(self, dest: ENR, plaintext: bytes,
                           req: Optional[_PendingRequest]) -> None:
        dest_id = dest.node_id
        addr = (dest.ip(), dest.udp_port())
        with self._lock:
            self._addrs[dest_id] = addr
            sess = self._sessions.get(dest_id)
        nonce = packets.random_nonce()
        if sess is None:
            # No session: send a random-content ordinary packet to elicit
            # WHOAREYOU (spec: the initiator may send junk; the real message
            # is replayed inside the handshake packet).
            header = packets.Header(packets.FLAG_ORDINARY, nonce,
                                    packets.ordinary_authdata(self.node_id))
            filler = secrets.token_bytes(16)
            datagram = packets.encode_packet(dest_id, header, filler)
            if req is not None:
                with self._lock:
                    self._pending[nonce] = req
            self._sock.sendto(datagram, addr)
            return
        header = packets.Header(packets.FLAG_ORDINARY, nonce,
                                packets.ordinary_authdata(self.node_id))
        masking_iv = secrets.token_bytes(16)
        ad = masking_iv + header.encode()
        ct = packets.encrypt_message(sess.send_key, nonce, plaintext, ad)
        datagram = packets.encode_packet(dest_id, header, ct, masking_iv=masking_iv)
        if req is not None:
            # Register even sessioned sends: if the peer LOST its session
            # (restart), it answers WHOAREYOU with this nonce and we must be
            # able to replay the request through a fresh handshake.
            with self._lock:
                self._pending[nonce] = req
        self._sock.sendto(datagram, addr)

    def _request(self, dest: ENR, plaintext: bytes, request_id: bytes,
                 timeout: float = REQUEST_TIMEOUT) -> List:
        # The handshake resolves the peer through the table: every request
        # target must be there (a hidden add_enr precondition otherwise).
        self.add_enr(dest)
        req = _PendingRequest(message=plaintext, request_id=request_id)
        with self._lock:
            self._requests[request_id] = req
        try:
            self._send_with_session(dest, plaintext, req)
            if not req.event.wait(timeout):
                raise Discv5Error("request timed out")
            return req.responses
        finally:
            with self._lock:
                self._requests.pop(request_id, None)
                for nonce in [n for n, r in self._pending.items() if r is req]:
                    del self._pending[nonce]

    # -------------------------------------------------------------- public

    def ping(self, dest: ENR) -> int:
        """PING -> PONG; returns the peer's advertised enr-seq."""
        rid = self._new_request_id()
        resp = self._request(dest, self._ping_message(rid), rid)
        return resp[0]

    def find_node(self, dest: ENR, distances: List[int]) -> List[ENR]:
        rid = self._new_request_id()
        msg = self._encode_message(
            MSG_FINDNODE,
            [rid, [rlp.encode_uint(d) for d in distances]],
        )
        resp = self._request(dest, msg, rid)
        out: List[ENR] = []
        for batch in resp:
            out.extend(batch)
        return out

    def bootstrap(self, boot: ENR, rounds: int = 4, batch: int = 8) -> int:
        """Ping a boot node then FINDNODE batches of descending distances
        from 256 (xor-metric distances concentrate just below 256, so the
        first batches cover almost the whole table — the reference's
        discovery queries walk the same space).  Returns the table size."""
        self.add_enr(boot)
        try:
            self.ping(boot)
        except Discv5Error:
            return len(self.table)
        asked = 0
        for i in range(rounds):
            hi = 256 - batch * i
            distances = list(range(hi, max(hi - batch, 0), -1))
            if not distances:
                break
            try:
                found = self.find_node(boot, distances)
            except Discv5Error:
                continue
            asked += 1
            for enr in found:
                self.add_enr(enr)
        log.info("discv5 bootstrap complete", table=len(self.table),
                 queries=asked)
        return len(self.table)

    def add_enr(self, enr: ENR) -> None:
        if not enr.verify():
            raise EnrError("refusing unverified ENR")
        nid = enr.node_id
        if nid == self.node_id:
            return
        with self._lock:
            known = self.table.get(nid)
            if known is None or enr.seq > known.seq:
                self.table[nid] = enr

    def nodes_at_distance(self, distances: List[int]) -> List[ENR]:
        out = []
        with self._lock:
            entries = list(self.table.values())
        for enr in entries:
            if log2_distance(self.node_id, enr.node_id) in distances:
                out.append(enr)
        if 0 in distances:
            out.append(self.enr)
        return out

    # ------------------------------------------------------------- receive

    def _gc(self) -> None:
        """Expire stale handshake state: timed-out pendings, old
        challenges, and the addr map's size bound — per-packet state must
        not accumulate under churn or a spoofed-src flood."""
        now = time.monotonic()
        with self._lock:
            for nonce in [n for n, r in self._pending.items()
                          if now - r.created > PENDING_TTL]:
                del self._pending[nonce]
            for nid in [n for n, (_, ts) in self._challenges.items()
                        if now - ts > CHALLENGE_TTL]:
                del self._challenges[nid]
            while len(self._addrs) > MAX_ADDRS:
                self._addrs.pop(next(iter(self._addrs)))

    def _rx_loop(self) -> None:
        last_gc = time.monotonic()
        while self._running:
            if time.monotonic() - last_gc > 5.0:
                self._gc()
                last_gc = time.monotonic()
            try:
                datagram, addr = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle_datagram(datagram, addr)
            except Exception as e:  # a bad packet must not kill the loop
                log.debug("discv5 packet dropped", error=str(e)[:80],
                          addr=f"{addr[0]}:{addr[1]}")

    def _handle_datagram(self, datagram: bytes, addr) -> None:
        pkt = packets.decode_packet(self.node_id, datagram)
        if pkt.header.flag == packets.FLAG_WHOAREYOU:
            self._on_whoareyou(pkt, addr)
        elif pkt.header.flag == packets.FLAG_HANDSHAKE:
            self._on_handshake(pkt, addr)
        else:
            self._on_ordinary(pkt, addr)

    # WHOAREYOU: we are the handshake initiator.
    def _on_whoareyou(self, pkt: packets.Packet, addr) -> None:
        with self._lock:
            req = self._pending.pop(pkt.header.nonce, None)
        if req is None:
            return  # unsolicited
        # Which peer is this? The one we addressed at `addr`.
        dest = None
        with self._lock:
            for nid, known in self._addrs.items():
                if known == addr:
                    enr = self.table.get(nid)
                    if enr is not None:
                        dest = enr
                        break
        if dest is None:
            return
        dest_id = dest.node_id
        # Any session we held with this peer is stale (it sent WHOAREYOU
        # because it cannot decrypt us — e.g. it restarted): drop it so the
        # fresh handshake keys take over.
        with self._lock:
            self._sessions.pop(dest_id, None)
        challenge_data = pkt.challenge_data
        eph = KeyPair()
        init_key, recp_key = session_mod.derive_keys(
            eph.priv, dest.public_key, self.node_id, dest_id, challenge_data
        )
        id_sig = session_mod.id_sign(
            self.keypair.priv, challenge_data, eph.compressed_pub, dest_id
        )
        _, enr_seq = packets.parse_whoareyou(pkt.header.authdata)
        enr_rlp = self.enr.to_rlp() if enr_seq < self.enr.seq else b""
        authdata = packets.handshake_authdata(
            self.node_id, id_sig, eph.compressed_pub, enr_rlp
        )
        nonce = packets.random_nonce()
        header = packets.Header(packets.FLAG_HANDSHAKE, nonce, authdata)
        masking_iv = secrets.token_bytes(16)
        ad = masking_iv + header.encode()
        ct = packets.encrypt_message(init_key, nonce, req.message, ad)
        datagram = packets.encode_packet(dest_id, header, ct, masking_iv=masking_iv)
        with self._lock:
            self._sessions[dest_id] = Session(send_key=init_key, recv_key=recp_key)
        self._sock.sendto(datagram, addr)

    # Handshake packet: we sent the WHOAREYOU; peer is the initiator.
    def _on_handshake(self, pkt: packets.Packet, addr) -> None:
        src_id, id_sig, eph_pub_bytes, enr_rlp = packets.parse_handshake(
            pkt.header.authdata
        )
        with self._lock:
            entry = self._challenges.pop(src_id, None)
        if entry is None:
            return
        challenge, _ts = entry
        challenge_data = challenge.challenge_data
        if enr_rlp:
            enr = ENR.from_rlp(enr_rlp)
            if enr.node_id != src_id:
                return
            self.add_enr(enr)
        with self._lock:
            enr = self.table.get(src_id)
        if enr is None:
            return
        if not session_mod.id_verify(
            enr.public_key, id_sig, challenge_data, eph_pub_bytes, self.node_id
        ):
            log.warning("discv5 handshake id-signature invalid",
                        peer=src_id.hex()[:12])
            return
        eph_pub = secp256k1.decompress(eph_pub_bytes)
        init_key, recp_key = session_mod.derive_keys_from_pubkey(
            self.keypair.priv, eph_pub, src_id, self.node_id, challenge_data
        )
        sess = Session(send_key=recp_key, recv_key=init_key)
        with self._lock:
            self._sessions[src_id] = sess
            self._addrs[src_id] = addr
        ad = pkt.masking_iv + pkt.header.encode()
        try:
            plaintext = packets.decrypt_message(
                sess.recv_key, pkt.header.nonce, pkt.message_ct, ad
            )
        except Exception:
            return
        self._dispatch(src_id, plaintext, addr)

    def _on_ordinary(self, pkt: packets.Packet, addr) -> None:
        src_id = pkt.header.authdata[:32]
        with self._lock:
            sess = self._sessions.get(src_id)
            known_seq = self.table[src_id].seq if src_id in self.table else 0
        plaintext = None
        if sess is not None:
            ad = pkt.masking_iv + pkt.header.encode()
            try:
                plaintext = packets.decrypt_message(
                    sess.recv_key, pkt.header.nonce, pkt.message_ct, ad
                )
            except Exception:
                plaintext = None  # stale keys: re-challenge below
        if plaintext is None:
            # No (working) session: WHOAREYOU, echoing the packet's nonce.
            authdata = packets.whoareyou_authdata(
                packets.random_id_nonce(), known_seq
            )
            header = packets.Header(packets.FLAG_WHOAREYOU,
                                    pkt.header.nonce, authdata)
            masking_iv = secrets.token_bytes(16)
            challenge = packets.Packet(masking_iv, header, b"")
            with self._lock:
                self._challenges[src_id] = (challenge, time.monotonic())
                self._addrs[src_id] = addr
            self._sock.sendto(
                packets.encode_packet(src_id, header, b"", masking_iv=masking_iv),
                addr,
            )
            return
        with self._lock:
            self._addrs[src_id] = addr
        self._dispatch(src_id, plaintext, addr)

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, src_id: bytes, plaintext: bytes, addr) -> None:
        msg_type = plaintext[0]
        body = rlp.decode(plaintext[1:])
        if msg_type == MSG_PING:
            rid, seq_raw = body
            pong = self._encode_message(MSG_PONG, [
                rid, rlp.encode_uint(self.enr.seq),
                bytes(int(x) for x in addr[0].split(".")),
                rlp.encode_uint(addr[1]),
            ])
            self._respond(src_id, pong, addr)
        elif msg_type == MSG_PONG:
            rid = body[0]
            self._complete(rid, rlp.decode_uint(body[1]))
        elif msg_type == MSG_FINDNODE:
            rid, dist_items = body
            distances = [rlp.decode_uint(d) for d in dist_items]
            found = self.nodes_at_distance(distances)
            batches = [found[i:i + MAX_NODES_PER_PACKET]
                       for i in range(0, len(found), MAX_NODES_PER_PACKET)] or [[]]
            total = len(batches)
            for batch in batches:
                nodes = self._encode_message(MSG_NODES, [
                    rid, rlp.encode_uint(total),
                    [_enr_to_item(e) for e in batch],
                ])
                self._respond(src_id, nodes, addr)
        elif msg_type == MSG_NODES:
            rid, total_raw, enr_items = body
            enrs = []
            for item in enr_items:
                try:
                    enrs.append(_enr_from_item(item))
                except EnrError:
                    continue  # a bad record poisons only itself
            self._complete(rid, enrs, total=rlp.decode_uint(total_raw) or 1)

    def _respond(self, dest_id: bytes, plaintext: bytes, addr) -> None:
        with self._lock:
            sess = self._sessions.get(dest_id)
        if sess is None:
            return
        nonce = packets.random_nonce()
        header = packets.Header(packets.FLAG_ORDINARY, nonce,
                                packets.ordinary_authdata(self.node_id))
        masking_iv = secrets.token_bytes(16)
        ad = masking_iv + header.encode()
        ct = packets.encrypt_message(sess.send_key, nonce, plaintext, ad)
        self._sock.sendto(
            packets.encode_packet(dest_id, header, ct, masking_iv=masking_iv),
            addr,
        )

    def _complete(self, request_id: bytes, response, total: int = 1) -> None:
        with self._lock:
            req = self._requests.get(bytes(request_id))
        if req is None:
            return
        req.responses.append(response)
        req.total_expected = total
        if len(req.responses) >= total:
            req.event.set()
