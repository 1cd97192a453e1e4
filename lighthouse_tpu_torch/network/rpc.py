"""Req/resp RPC protocol: typed requests/responses + ssz_snappy codec.

Equivalent of the reference's ``lighthouse_network/src/rpc/protocol.rs``
(Status/Goodbye/BlocksByRange/BlocksByRoot/BlobsByRange/BlobsByRoot/Ping/
Metadata protocol ids) and ``rpc/codec/ssz_snappy.rs`` (length-prefixed
snappy-framed SSZ chunks with a result byte and per-fork context bytes on
block responses).

Wire shape per response chunk:
    [u8 result] [varint ssz_length] [4-byte context (forked types only)]
    [snappy-framed SSZ payload]
result 0 = success, 1 = invalid request, 2 = server error, 3 = resource
unavailable (reference ``RPCResponseErrorCode``).

A copy of the JAX package's ``lighthouse_tpu/network/rpc.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import snappy_codec
from .snappy_codec import _read_varint, _write_varint  # shared varint

PROTOCOL_PREFIX = "/eth2/beacon_chain/req"
ENCODING_SUFFIX = "ssz_snappy"


def _pid(name_version: str) -> str:
    """Full spec protocol id (reference ``protocol.rs`` ``ProtocolId``)."""
    return f"{PROTOCOL_PREFIX}/{name_version}/{ENCODING_SUFFIX}"


STATUS = _pid("status/1")
GOODBYE = _pid("goodbye/1")
BLOCKS_BY_RANGE = _pid("beacon_blocks_by_range/2")
BLOCKS_BY_ROOT = _pid("beacon_blocks_by_root/2")
BLOBS_BY_RANGE = _pid("blob_sidecars_by_range/1")
BLOBS_BY_ROOT = _pid("blob_sidecars_by_root/1")
PING = _pid("ping/1")
METADATA = _pid("metadata/2")
# Not a consensus-spec protocol: this transport's discovery analog (the role
# discv5 plays for the reference) — peers exchange known listen addresses.
PEER_EXCHANGE = _pid("peer_exchange/1")
# light-client req/resp (reference rpc/protocol.rs SupportedProtocol::
# LightClient{Bootstrap,OptimisticUpdate,FinalityUpdate}V1)
LIGHT_CLIENT_BOOTSTRAP = _pid("light_client_bootstrap/1")
LIGHT_CLIENT_OPTIMISTIC_UPDATE = _pid("light_client_optimistic_update/1")
LIGHT_CLIENT_FINALITY_UPDATE = _pid("light_client_finality_update/1")

# Protocols whose SUCCESS chunks carry 4 context bytes (fork digest of the
# payload's era).  ONE owner: the router encodes and the service decodes
# from this same set — editing only one side silently corrupts decoding.
CONTEXT_PROTOCOLS = frozenset({
    BLOCKS_BY_RANGE, BLOCKS_BY_ROOT, BLOBS_BY_RANGE, BLOBS_BY_ROOT,
    LIGHT_CLIENT_BOOTSTRAP, LIGHT_CLIENT_OPTIMISTIC_UPDATE,
    LIGHT_CLIENT_FINALITY_UPDATE,
})

SUCCESS = 0
INVALID_REQUEST = 1
SERVER_ERROR = 2
RESOURCE_UNAVAILABLE = 3

MAX_REQUEST_BLOCKS = 1024


class RpcError(ValueError):
    pass


class RpcSelfLimited(RpcError):
    """Our OWN outbound throttle refused/timed out the request — the peer
    did nothing wrong and must not be penalized for it."""


@dataclass
class Status:
    """Reference ``StatusMessage`` — the handshake that drives sync."""

    fork_digest: bytes
    finalized_root: bytes
    finalized_epoch: int
    head_root: bytes
    head_slot: int

    def to_bytes(self) -> bytes:
        return (
            self.fork_digest
            + self.finalized_root
            + struct.pack("<Q", self.finalized_epoch)
            + self.head_root
            + struct.pack("<Q", self.head_slot)
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Status":
        if len(data) != 84:
            raise RpcError(f"status must be 84 bytes, got {len(data)}")
        return cls(
            fork_digest=data[0:4],
            finalized_root=data[4:36],
            finalized_epoch=struct.unpack_from("<Q", data, 36)[0],
            head_root=data[44:76],
            head_slot=struct.unpack_from("<Q", data, 76)[0],
        )


@dataclass
class Goodbye:
    reason: int  # 1 shutdown, 2 irrelevant network, 3 fault/error

    def to_bytes(self) -> bytes:
        return struct.pack("<Q", self.reason)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Goodbye":
        return cls(struct.unpack("<Q", data)[0])


@dataclass
class Ping:
    seq_number: int

    def to_bytes(self) -> bytes:
        return struct.pack("<Q", self.seq_number)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Ping":
        return cls(struct.unpack("<Q", data)[0])


@dataclass
class MetaData:
    seq_number: int
    attnets: int  # 64-bit bitfield
    syncnets: int  # 4-bit bitfield (1 byte on the wire)

    def to_bytes(self) -> bytes:
        return struct.pack("<Q", self.seq_number) + struct.pack("<Q", self.attnets) + bytes(
            [self.syncnets]
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "MetaData":
        return cls(
            struct.unpack_from("<Q", data, 0)[0],
            struct.unpack_from("<Q", data, 8)[0],
            data[16],
        )


@dataclass
class BlocksByRangeRequest:
    start_slot: int
    count: int

    def to_bytes(self) -> bytes:
        # v2 drops `step`; encoded as step=1 for v1 compat in the reference
        return struct.pack("<QQQ", self.start_slot, self.count, 1)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlocksByRangeRequest":
        start, count, _step = struct.unpack("<QQQ", data)
        return cls(start, count)


@dataclass
class BlocksByRootRequest:
    roots: List[bytes]

    def to_bytes(self) -> bytes:
        return b"".join(self.roots)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlocksByRootRequest":
        if len(data) % 32:
            raise RpcError("roots payload not a multiple of 32")
        return cls([data[i : i + 32] for i in range(0, len(data), 32)])


@dataclass
class BlobsByRangeRequest:
    start_slot: int
    count: int

    def to_bytes(self) -> bytes:
        return struct.pack("<QQ", self.start_slot, self.count)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlobsByRangeRequest":
        start, count = struct.unpack("<QQ", data)
        return cls(start, count)


@dataclass
class BlobsByRootRequest:
    """List of (block_root, index) blob identifiers (spec BlobIdentifier)."""

    ids: List[Tuple[bytes, int]]

    def to_bytes(self) -> bytes:
        return b"".join(r + struct.pack("<Q", i) for r, i in self.ids)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlobsByRootRequest":
        if len(data) % 40:
            raise RpcError("blob identifiers must be 40 bytes each")
        return cls([
            (data[i:i + 32], struct.unpack_from("<Q", data, i + 32)[0])
            for i in range(0, len(data), 40)
        ])


@dataclass
class PeerExchangeRequest:
    max_peers: int

    def to_bytes(self) -> bytes:
        return struct.pack("<Q", self.max_peers)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PeerExchangeRequest":
        return cls(struct.unpack("<Q", data)[0])


@dataclass
class PeerEntry:
    peer_id: str
    host: str
    port: int


def encode_peer_entries(entries) -> bytes:
    out = bytearray(struct.pack(">H", len(entries)))
    for e in entries:
        pid = e.peer_id.encode()
        host = e.host.encode()
        out += struct.pack(">B", len(pid)) + pid
        out += struct.pack(">B", len(host)) + host
        out += struct.pack(">H", e.port)
    return bytes(out)


def decode_peer_entries(data: bytes):
    (count,) = struct.unpack_from(">H", data, 0)
    pos = 2
    out = []
    for _ in range(count):
        (plen,) = struct.unpack_from(">B", data, pos); pos += 1
        pid = data[pos:pos + plen].decode(); pos += plen
        (hlen,) = struct.unpack_from(">B", data, pos); pos += 1
        host = data[pos:pos + hlen].decode(); pos += hlen
        (port,) = struct.unpack_from(">H", data, pos); pos += 2
        out.append(PeerEntry(pid, host, port))
    return out


def serve_peer_exchange(endpoint, sender: str, max_peers) -> bytes:
    """One answer for both the router and the boot node: known listen
    addresses, excluding the requester, capped."""
    addrs = (endpoint.known_peer_addrs()
             if hasattr(endpoint, "known_peer_addrs") else {})
    entries = [
        PeerEntry(pid, host, port)
        for pid, (host, port) in addrs.items()
        if pid != sender
    ][: max(0, min(int(max_peers), 64))]
    return encode_response_chunk(SUCCESS, encode_peer_entries(entries))


@dataclass
class LightClientBootstrapRequest:
    """Request body = the block root to bootstrap from (spec
    light_client_bootstrap req/resp)."""

    root: bytes

    def to_bytes(self) -> bytes:
        return bytes(self.root)

    @classmethod
    def from_bytes(cls, data: bytes) -> "LightClientBootstrapRequest":
        if len(data) != 32:
            raise RpcError("light_client_bootstrap request must be 32 bytes")
        return cls(data)


REQUEST_TYPES = {
    STATUS: Status,
    GOODBYE: Goodbye,
    PING: Ping,
    METADATA: type(None),  # metadata request has an empty body
    BLOCKS_BY_RANGE: BlocksByRangeRequest,
    BLOCKS_BY_ROOT: BlocksByRootRequest,
    BLOBS_BY_RANGE: BlobsByRangeRequest,
    BLOBS_BY_ROOT: BlobsByRootRequest,
    PEER_EXCHANGE: PeerExchangeRequest,
    LIGHT_CLIENT_BOOTSTRAP: LightClientBootstrapRequest,
    LIGHT_CLIENT_OPTIMISTIC_UPDATE: type(None),  # empty request body
    LIGHT_CLIENT_FINALITY_UPDATE: type(None),
}


def encode_request(protocol: str, request) -> bytes:
    body = b"" if request is None else request.to_bytes()
    return _write_varint(len(body)) + snappy_codec.frame_compress(body)


def decode_request(protocol: str, data: bytes):
    length, pos = _read_varint(data, 0)
    body = snappy_codec.frame_decompress(data[pos:])
    if len(body) != length:
        raise RpcError("request length prefix mismatch")
    cls = REQUEST_TYPES[protocol]
    return None if cls is type(None) else cls.from_bytes(body)


def encode_response_chunk(
    result: int, payload: bytes, context_bytes: Optional[bytes] = None
) -> bytes:
    out = bytes([result]) + _write_varint(len(payload))
    if context_bytes is not None:
        out += context_bytes
    return out + snappy_codec.frame_compress(payload)


def decode_response_chunk(
    data: bytes, has_context: bool = False
) -> Tuple[int, bytes, Optional[bytes], int]:
    """Returns (result, payload, context_bytes, bytes_consumed)."""
    if not data:
        raise RpcError("empty chunk")
    result = data[0]
    length, pos = _read_varint(data, 1)
    context = None
    if has_context and result == SUCCESS:
        context = data[pos : pos + 4]
        pos += 4
    # frames are self-delimiting only via content; chunks here are one
    # frame-stream each, delimited by the transport message boundary.
    payload = snappy_codec.frame_decompress(data[pos:])
    if len(payload) != length:
        raise RpcError("response length prefix mismatch")
    return result, payload, context, len(data)
