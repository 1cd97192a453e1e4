"""libp2p-noise over a socket: identity payloads + encrypted framing.

The libp2p-noise spec on top of ``protocol.py``:

* every handshake message and every transport frame rides a 2-byte
  big-endian length prefix (max 65535);
* messages 2 and 3 carry a protobuf ``NoiseHandshakePayload`` proving the
  peer's libp2p IDENTITY key (secp256k1 for eth2) owns this connection:
  ``identity_sig = Sign(identity_key, "noise-libp2p-static-key:" ||
  noise_static_pubkey)``;
* after the handshake the connection is an AEAD-framed byte stream.

A copy of the JAX package's ``lighthouse_tpu/network/noise/secure.py``.
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import Optional, Tuple

from ..discv5 import secp256k1
from .protocol import CipherState, HandshakeState, NoiseError


class ConnectionClosed(NoiseError):
    """Clean transport EOF — distinct from AEAD/parse failures, which MUST
    surface (a tampered frame must never read as a graceful close)."""

SIGNATURE_PREFIX = b"noise-libp2p-static-key:"
MAX_FRAME = 65535

# libp2p crypto.proto key types
KEY_TYPE_SECP256K1 = 2


# ------------------------------------------------------- minimal protobuf

def _pb_tag(field: int, wire: int) -> bytes:
    return bytes([(field << 3) | wire])


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _pb_tag(field, 2) + _pb_varint(len(data)) + data


def _read_pb_varint(data: bytes, pos: int):
    val = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise NoiseError("truncated protobuf varint")
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if shift > 63:
            raise NoiseError("oversized protobuf varint")
        if not b & 0x80:
            return val, pos


def _pb_read(data: bytes):
    """Yield (field, wire, value) triples of a flat protobuf message.
    Bounds-checked — remote handshake payloads are attacker-controlled and
    must be REJECTED (NoiseError), never crash the acceptor."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_pb_varint(data, pos)  # tags themselves are varints
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_pb_varint(data, pos)
            yield field, wire, val
        elif wire == 2:
            ln, pos = _read_pb_varint(data, pos)
            if pos + ln > len(data):
                raise NoiseError("truncated protobuf field")
            yield field, wire, data[pos:pos + ln]
            pos += ln
        else:
            raise NoiseError(f"unsupported protobuf wire type {wire}")


def _identity_key_proto(pubkey_compressed: bytes) -> bytes:
    """libp2p crypto.proto PublicKey{Type=Secp256k1, Data}."""
    return (_pb_tag(1, 0) + _pb_varint(KEY_TYPE_SECP256K1)
            + _pb_bytes(2, pubkey_compressed))


def _handshake_payload(identity_priv: int, noise_static_pub: bytes) -> bytes:
    """NoiseHandshakePayload{identity_key, identity_sig}."""
    pub = secp256k1.compress(secp256k1.pubkey(identity_priv))
    msg = hashlib.sha256(SIGNATURE_PREFIX + noise_static_pub).digest()
    sig = secp256k1.sign(identity_priv, msg)
    return (_pb_bytes(1, _identity_key_proto(pub)) + _pb_bytes(2, sig))


def _verify_payload(payload: bytes, noise_static_pub: bytes) -> bytes:
    """Returns the peer's compressed identity pubkey; raises on a bad proof."""
    identity_key_raw = identity_sig = None
    for field, _wire, value in _pb_read(payload):
        if field == 1:
            identity_key_raw = value
        elif field == 2:
            identity_sig = value
    if identity_key_raw is None or identity_sig is None:
        raise NoiseError("handshake payload missing identity key/signature")
    key_type = key_data = None
    for field, wire, value in _pb_read(identity_key_raw):
        if field == 1 and wire == 0:
            key_type = value
        elif field == 2:
            key_data = value
    if key_type != KEY_TYPE_SECP256K1 or key_data is None:
        raise NoiseError("unsupported libp2p identity key type")
    pub = secp256k1.decompress(key_data)
    msg = hashlib.sha256(SIGNATURE_PREFIX + noise_static_pub).digest()
    if not secp256k1.verify(pub, msg, identity_sig):
        raise NoiseError("libp2p identity signature invalid")
    return key_data


# ------------------------------------------------------------ connection


def _send_frame(sock: socket.socket, data: bytes) -> None:
    if len(data) > MAX_FRAME:
        raise NoiseError("noise frame exceeds 65535 bytes")
    sock.sendall(struct.pack(">H", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as e:
            raise ConnectionClosed(f"socket error: {e}") from e
        if not chunk:
            raise ConnectionClosed("connection closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    (ln,) = struct.unpack(">H", _recv_exact(sock, 2))
    return _recv_exact(sock, ln)


class NoiseConnection:
    """An AEAD-framed byte stream after a completed handshake."""

    def __init__(self, sock: socket.socket, send: CipherState,
                 recv: CipherState, remote_identity: bytes) -> None:
        self.sock = sock
        self._send = send
        self._recv = recv
        self.remote_identity = remote_identity  # compressed secp256k1 key
        self._rx_buf = b""

    @property
    def remote_peer_pub(self):
        return secp256k1.decompress(self.remote_identity)

    def send(self, data: bytes) -> None:
        # AEAD adds 16 bytes; chunk so every frame fits the u16 prefix.
        limit = MAX_FRAME - 16
        for off in range(0, len(data), limit):
            _send_frame(self.sock,
                        self._send.encrypt_with_ad(b"", data[off:off + limit]))

    def recv(self, n: int) -> bytes:
        """Up to ``n`` decrypted bytes (at least 1, blocking), '' on clean
        EOF.  An AEAD failure (tampered/injected frame) RAISES — active
        attacks must never masquerade as graceful close."""
        if not self._rx_buf:
            try:
                self._rx_buf = self._recv.decrypt_with_ad(
                    b"", _recv_frame(self.sock))
            except ConnectionClosed:
                return b""
        out, self._rx_buf = self._rx_buf[:n], self._rx_buf[n:]
        return out

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.recv(n - len(buf))
            if not chunk:
                raise ConnectionClosed("connection closed mid-read")
            buf += chunk
        return buf

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def secure_dial(sock: socket.socket, identity_priv: int) -> NoiseConnection:
    """Initiator side of the libp2p-noise XX handshake."""
    hs = HandshakeState(initiator=True)
    _send_frame(sock, hs.write_message_1())
    payload2 = hs.read_message_2(_recv_frame(sock))
    remote_identity = _verify_payload(payload2, hs.rs)
    msg3, send, recv = hs.write_message_3(
        _handshake_payload(identity_priv, hs.s_pub)
    )
    _send_frame(sock, msg3)
    return NoiseConnection(sock, send, recv, remote_identity)


def secure_accept(sock: socket.socket, identity_priv: int) -> NoiseConnection:
    """Responder side of the libp2p-noise XX handshake."""
    hs = HandshakeState(initiator=False)
    hs.read_message_1(_recv_frame(sock))
    _send_frame(sock, hs.write_message_2(
        _handshake_payload(identity_priv, hs.s_pub)
    ))
    payload3, send, recv = hs.read_message_3(_recv_frame(sock))
    remote_identity = _verify_payload(payload3, hs.rs)
    return NoiseConnection(sock, send, recv, remote_identity)
