"""multistream-select 1.0 — libp2p's protocol negotiation.

The first bytes on every libp2p connection (and on every new stream)
negotiate what is spoken next: each message is a uvarint length prefix,
the protocol path, and a trailing newline.  The reference's connection
upgrade runs ``/multistream/1.0.0`` then ``/noise`` on the raw TCP
connection, multistream again for ``/yamux/1.0.0`` on the secured one,
and once more per stream for the application protocol (an eth2 RPC
protocol id or gossipsub's ``/meshsub/1.1.0``).

``na\\n`` answers an unsupported proposal; the dialer may then propose an
alternative or give up.

A copy of the JAX package's ``lighthouse_tpu/network/noise/multistream.py``.
"""

from __future__ import annotations

from typing import Sequence

from ..snappy_codec import _write_varint as _uvarint  # shared varint encoder

MULTISTREAM_PROTO = "/multistream/1.0.0"
NA = "na"


class MultistreamError(Exception):
    pass


# A dialer proposing more than this many protocols on one negotiation is
# hostile or broken: answer-with-na loops must terminate.
MAX_PROPOSALS = 16


def _encode(msg: str) -> bytes:
    payload = msg.encode() + b"\n"
    return _uvarint(len(payload)) + payload


def _read_uvarint(conn) -> int:
    val = 0
    shift = 0
    while True:
        byte = conn.recv_exact(1)[0]
        val |= (byte & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise MultistreamError("oversized multistream length")
        if not byte & 0x80:
            return val

def _read_message(conn) -> str:
    length = _read_uvarint(conn)
    if length == 0 or length > 1024:
        raise MultistreamError("bad multistream message length")
    payload = conn.recv_exact(length)
    if not payload.endswith(b"\n"):
        raise MultistreamError("multistream message missing newline")
    try:
        return payload[:-1].decode()
    except UnicodeDecodeError as e:
        raise MultistreamError("non-UTF-8 multistream message") from e


def negotiate_outbound(conn, protocols: Sequence[str]) -> str:
    """Dialer side: propose ``protocols`` in order; returns the accepted
    one.  ``conn`` needs send()/recv_exact()."""
    conn.send(_encode(MULTISTREAM_PROTO))
    if _read_message(conn) != MULTISTREAM_PROTO:
        raise MultistreamError("peer does not speak multistream 1.0")
    for proto in protocols:
        conn.send(_encode(proto))
        answer = _read_message(conn)
        if answer == proto:
            return proto
        if answer != NA:
            raise MultistreamError(f"unexpected negotiation answer {answer!r}")
    raise MultistreamError(f"peer rejected all of {list(protocols)}")


def negotiate_inbound(conn, supported: Sequence[str]) -> str:
    """Listener side: echo the header, accept the first supported proposal."""
    if _read_message(conn) != MULTISTREAM_PROTO:
        raise MultistreamError("peer does not speak multistream 1.0")
    conn.send(_encode(MULTISTREAM_PROTO))
    for _ in range(MAX_PROPOSALS):
        proposal = _read_message(conn)
        if proposal in supported:
            conn.send(_encode(proposal))
            return proposal
        conn.send(_encode(NA))
    raise MultistreamError("peer exceeded the proposal budget")


class _SocketAdapter:
    """multistream over a raw socket (pre-noise stage)."""

    def __init__(self, sock) -> None:
        self.sock = sock

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise MultistreamError("connection closed mid-negotiation")
            buf += chunk
        return buf


def upgrade_outbound(sock, identity_priv: int):
    """The full dial-side libp2p ladder: multistream -> /noise -> secure
    handshake -> multistream -> /yamux/1.0.0 -> session.  Returns the
    YamuxSession."""
    from .secure import secure_dial
    from .yamux import YamuxSession

    raw = _SocketAdapter(sock)
    negotiate_outbound(raw, ["/noise"])
    conn = secure_dial(sock, identity_priv)
    negotiate_outbound(conn, ["/yamux/1.0.0"])
    # The yamux rx thread must NEVER run with a socket timeout: a timeout
    # set for the handshake would fire on the first idle gap and kill the
    # session (an in-flight recv also ignores later settimeout calls).
    # Every read before this point ran in the calling thread, bounded.
    sock.settimeout(None)
    return YamuxSession(conn, dialer=True)


def upgrade_inbound(sock, identity_priv: int, on_stream=None):
    """Listener-side ladder; returns the YamuxSession."""
    from .secure import secure_accept
    from .yamux import YamuxSession

    raw = _SocketAdapter(sock)
    negotiate_inbound(raw, ["/noise"])
    conn = secure_accept(sock, identity_priv)
    negotiate_inbound(conn, ["/yamux/1.0.0"])
    sock.settimeout(None)  # see upgrade_outbound: the rx thread starts now
    return YamuxSession(conn, dialer=False, on_stream=on_stream)
