"""Gossipsub protobuf wire codec (libp2p ``/meshsub/1.1.0``).

Hand-rolled proto2 encode/decode for the gossipsub RPC schema the
reference vendors (`beacon_node/lighthouse_network/gossipsub/src/generated/
rpc.proto`): ``RPC { repeated SubOpts subscriptions = 1; repeated Message
publish = 2; ControlMessage control = 3 }`` with IHAVE/IWANT/GRAFT/PRUNE
control messages (PRUNE carries v1.1 peer-exchange ``PeerInfo`` + backoff
seconds).  Messages follow Eth2's ``StrictNoSign`` policy: only ``data`` and
``topic`` are populated; ``from``/``seqno``/``signature``/``key`` MUST be
absent on the wire and are rejected on receipt (consensus spec p2p:
``message.signature — this field MUST NOT be present``).

This module is pure wire math — no dependency on the transport.  Decode is
tolerant of unknown fields (skipped per wire type) so future protocol
revisions don't break framing, but strict about StrictNoSign and about
truncated/overlong varints.

A copy of the JAX package's ``lighthouse_tpu/network/pb.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class PbError(Exception):
    pass


# ------------------------------------------------------------ primitives


def write_uvarint(n: int) -> bytes:
    if n < 0:
        raise PbError("negative varint")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos).  Bounds to 64 bits like protobuf."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise PbError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >> 64:
                raise PbError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 70:
            raise PbError("varint too long")


def _utf8(val: bytes) -> str:
    """Topic strings must be valid UTF-8; anything else is a framing
    violation (PbError), not a stray UnicodeDecodeError that would slip
    past the transport's violation handling."""
    try:
        return val.decode()
    except UnicodeDecodeError as e:
        raise PbError(f"invalid utf-8 in string field: {e}") from e


def _key(field_no: int, wire_type: int) -> bytes:
    return write_uvarint((field_no << 3) | wire_type)


def _len_delim(field_no: int, payload: bytes) -> bytes:
    return _key(field_no, 2) + write_uvarint(len(payload)) + payload


def _varint_field(field_no: int, value: int) -> bytes:
    return _key(field_no, 0) + write_uvarint(value)


def _skip(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = read_uvarint(buf, pos)
        return pos
    if wire_type == 1:
        if pos + 8 > len(buf):
            raise PbError("truncated fixed64")
        return pos + 8
    if wire_type == 2:
        n, pos = read_uvarint(buf, pos)
        if pos + n > len(buf):
            raise PbError("truncated length-delimited field")
        return pos + n
    if wire_type == 5:
        if pos + 4 > len(buf):
            raise PbError("truncated fixed32")
        return pos + 4
    raise PbError(f"unsupported wire type {wire_type}")


def _fields(buf: bytes):
    """Iterate (field_no, wire_type, value_or_bytes, next_pos)."""
    pos = 0
    while pos < len(buf):
        key, pos = read_uvarint(buf, pos)
        field_no, wire_type = key >> 3, key & 7
        if field_no == 0:
            raise PbError("field number 0")
        if wire_type == 0:
            val, pos = read_uvarint(buf, pos)
            yield field_no, wire_type, val
        elif wire_type == 2:
            n, pos = read_uvarint(buf, pos)
            if pos + n > len(buf):
                raise PbError("truncated length-delimited field")
            yield field_no, wire_type, buf[pos:pos + n]
            pos += n
        else:
            start = pos
            pos = _skip(buf, pos, wire_type)
            yield field_no, wire_type, buf[start:pos]


# -------------------------------------------------------------- messages


@dataclass
class SubOpts:
    subscribe: bool = True
    topic_id: str = ""

    def encode(self) -> bytes:
        out = _varint_field(1, 1 if self.subscribe else 0)
        out += _len_delim(2, self.topic_id.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "SubOpts":
        sub = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 0:
                sub.subscribe = bool(val)
            elif fno == 2 and wt == 2:
                sub.topic_id = _utf8(val)
        return sub


@dataclass
class Message:
    """StrictNoSign message: topic (field 4, required) + data (field 2)."""

    data: bytes = b""
    topic: str = ""

    def encode(self) -> bytes:
        return _len_delim(2, self.data) + _len_delim(4, self.topic.encode())

    @classmethod
    def decode(cls, buf: bytes) -> "Message":
        msg = cls()
        saw_topic = False
        for fno, wt, val in _fields(buf):
            if fno == 2 and wt == 2:
                msg.data = val
            elif fno == 4 and wt == 2:
                msg.topic = _utf8(val)
                saw_topic = True
            elif fno in (1, 3, 5, 6):
                # StrictNoSign: from/seqno/signature/key MUST NOT be present
                raise PbError(f"StrictNoSign violation: field {fno} present")
        if not saw_topic:
            raise PbError("Message missing required topic")
        return msg


@dataclass
class ControlIHave:
    topic_id: str = ""
    message_ids: List[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        out = _len_delim(1, self.topic_id.encode())
        for mid in self.message_ids:
            out += _len_delim(2, mid)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ControlIHave":
        c = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                c.topic_id = _utf8(val)
            elif fno == 2 and wt == 2:
                c.message_ids.append(val)
        return c


@dataclass
class ControlIWant:
    message_ids: List[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(_len_delim(1, mid) for mid in self.message_ids)

    @classmethod
    def decode(cls, buf: bytes) -> "ControlIWant":
        c = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                c.message_ids.append(val)
        return c


@dataclass
class ControlGraft:
    topic_id: str = ""

    def encode(self) -> bytes:
        return _len_delim(1, self.topic_id.encode())

    @classmethod
    def decode(cls, buf: bytes) -> "ControlGraft":
        c = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                c.topic_id = _utf8(val)
        return c


@dataclass
class PeerInfo:
    """v1.1 peer exchange: an ENR-capable peer id (we carry the dialable
    ``host:port|peer_id`` record the PRUNEd peer can reconnect through)."""

    peer_id: bytes = b""
    signed_peer_record: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.peer_id:
            out += _len_delim(1, self.peer_id)
        if self.signed_peer_record:
            out += _len_delim(2, self.signed_peer_record)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "PeerInfo":
        p = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                p.peer_id = val
            elif fno == 2 and wt == 2:
                p.signed_peer_record = val
        return p


@dataclass
class ControlPrune:
    topic_id: str = ""
    peers: List[PeerInfo] = field(default_factory=list)
    backoff: Optional[int] = None  # seconds

    def encode(self) -> bytes:
        out = _len_delim(1, self.topic_id.encode())
        for p in self.peers:
            out += _len_delim(2, p.encode())
        if self.backoff is not None:
            out += _varint_field(3, self.backoff)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ControlPrune":
        c = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                c.topic_id = _utf8(val)
            elif fno == 2 and wt == 2:
                c.peers.append(PeerInfo.decode(val))
            elif fno == 3 and wt == 0:
                c.backoff = val
        return c


@dataclass
class ControlMessage:
    ihave: List[ControlIHave] = field(default_factory=list)
    iwant: List[ControlIWant] = field(default_factory=list)
    graft: List[ControlGraft] = field(default_factory=list)
    prune: List[ControlPrune] = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.ihave or self.iwant or self.graft or self.prune)

    def encode(self) -> bytes:
        out = b""
        for c in self.ihave:
            out += _len_delim(1, c.encode())
        for c in self.iwant:
            out += _len_delim(2, c.encode())
        for c in self.graft:
            out += _len_delim(3, c.encode())
        for c in self.prune:
            out += _len_delim(4, c.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ControlMessage":
        c = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                c.ihave.append(ControlIHave.decode(val))
            elif fno == 2 and wt == 2:
                c.iwant.append(ControlIWant.decode(val))
            elif fno == 3 and wt == 2:
                c.graft.append(ControlGraft.decode(val))
            elif fno == 4 and wt == 2:
                c.prune.append(ControlPrune.decode(val))
        return c


@dataclass
class RPC:
    subscriptions: List[SubOpts] = field(default_factory=list)
    publish: List[Message] = field(default_factory=list)
    control: Optional[ControlMessage] = None

    def encode(self) -> bytes:
        out = b""
        for s in self.subscriptions:
            out += _len_delim(1, s.encode())
        for m in self.publish:
            out += _len_delim(2, m.encode())
        if self.control is not None and self.control:
            out += _len_delim(3, self.control.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "RPC":
        rpc = cls()
        for fno, wt, val in _fields(buf):
            if fno == 1 and wt == 2:
                rpc.subscriptions.append(SubOpts.decode(val))
            elif fno == 2 and wt == 2:
                rpc.publish.append(Message.decode(val))
            elif fno == 3 and wt == 2:
                rpc.control = ControlMessage.decode(val)
        return rpc


# ------------------------------------------------------------- framing

MAX_RPC_SIZE = 10 * 1024 * 1024  # reference gossipsub max_transmit_size class


def encode_frame(rpc: RPC) -> bytes:
    """One length-prefixed RPC as it appears on a meshsub stream."""
    payload = rpc.encode()
    if len(payload) > MAX_RPC_SIZE:
        raise PbError("RPC exceeds max transmit size")
    return write_uvarint(len(payload)) + payload


def read_frame(recv_exact) -> RPC:
    """Read one varint-delimited RPC via a ``recv_exact(n) -> bytes``
    callable (a yamux stream).  Raises PbError on framing violations."""
    # uvarint arrives byte-at-a-time: up to 5 bytes covers MAX_RPC_SIZE
    length = 0
    shift = 0
    while True:
        chunk = recv_exact(1)
        if len(chunk) != 1:
            raise PbError("stream closed mid-length")
        b = chunk[0]
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift >= 35:
            raise PbError("frame length varint too long")
    if length > MAX_RPC_SIZE:
        raise PbError("frame exceeds max transmit size")
    payload = recv_exact(length)
    if len(payload) != length:
        raise PbError("stream closed mid-frame")
    return RPC.decode(payload)
