"""yamux stream multiplexing on the real wire format.

The yamux spec (hashicorp/yamux, the multiplexer libp2p and the reference
negotiate over noise): 12-byte headers

    version(u8)=0 | type(u8) | flags(u16) | stream_id(u32) | length(u32)

big-endian; types Data=0 WindowUpdate=1 Ping=2 GoAway=3; flags SYN=1
ACK=2 FIN=4 RST=8.  Odd stream ids belong to the dialing side, even to
the accepting side.  Every stream starts with a 256 KiB receive window;
consumed bytes are re-credited with WindowUpdate frames.

A copy of the JAX package's ``lighthouse_tpu/network/noise/yamux.py``.
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Callable, Dict, Optional

TYPE_DATA = 0
TYPE_WINDOW_UPDATE = 1
TYPE_PING = 2
TYPE_GOAWAY = 3

FLAG_SYN = 0x1
FLAG_ACK = 0x2
FLAG_FIN = 0x4
FLAG_RST = 0x8

INITIAL_WINDOW = 256 * 1024
HEADER = struct.Struct(">BBHII")


class YamuxError(Exception):
    pass


class YamuxStream:
    def __init__(self, session: "YamuxSession", stream_id: int) -> None:
        self.session = session
        self.stream_id = stream_id
        self._rx: "queue.Queue[bytes]" = queue.Queue()
        self._rx_buf = b""
        self._recv_window = INITIAL_WINDOW  # what we granted the peer
        self._send_window = INITIAL_WINDOW  # what the peer granted us
        self._pending_credit = 0  # consumed bytes not yet re-credited
        self._window_cv = threading.Condition()
        self.closed_local = False
        self.closed_remote = False

    # ---------------------------------------------------------------- api

    def send(self, data: bytes) -> None:
        if self.closed_local:
            raise YamuxError("stream closed")
        view = memoryview(data)
        while view:
            with self._window_cv:
                while self._send_window == 0 and not self.closed_remote:
                    self._window_cv.wait(timeout=5.0)
                if self.closed_remote:
                    raise YamuxError("peer closed the stream")
                n = min(len(view), self._send_window)
                self._send_window -= n
            self.session._send_frame(TYPE_DATA, 0, self.stream_id,
                                     bytes(view[:n]))
            view = view[n:]

    def recv(self, n: int, timeout: Optional[float] = 10.0) -> bytes:
        """Up to n bytes; b'' on remote FIN with nothing buffered."""
        if not self._rx_buf:
            if self.closed_remote and self._rx.empty():
                return b""
            try:
                self._rx_buf = self._rx.get(timeout=timeout)
            except queue.Empty:
                if self.closed_remote:
                    return b""
                raise YamuxError("stream recv timeout")
            if self._rx_buf == b"":  # FIN sentinel
                self.closed_remote = True
                return b""
        out, self._rx_buf = self._rx_buf[:n], self._rx_buf[n:]
        # Re-credit the peer for consumed bytes, BATCHED at half a window
        # (hashicorp yamux's delta threshold): per-byte reads (multistream
        # varints) must not emit one encrypted frame per byte, and a
        # blocked sender always unblocks because its window only empties
        # after a full window of bytes was consumed here.  Best effort:
        # bytes already delivered must not be lost to a dead session.
        with self._window_cv:
            self._recv_window += len(out)
            self._pending_credit += len(out)
            credit = 0
            if self._pending_credit >= INITIAL_WINDOW // 2:
                credit, self._pending_credit = self._pending_credit, 0
        if credit:
            try:
                self.session._send_frame(TYPE_WINDOW_UPDATE, 0,
                                         self.stream_id, b"", length=credit)
            except Exception:
                pass
        return out

    def recv_exact(self, n: int, timeout: Optional[float] = 10.0) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.recv(n - len(buf), timeout=timeout)
            if not chunk:
                raise YamuxError("stream closed mid-read")
            buf += chunk
        return buf

    def close(self) -> None:
        if not self.closed_local:
            self.closed_local = True
            self.session._send_frame(TYPE_DATA, FLAG_FIN, self.stream_id, b"")

    # ------------------------------------------------------------ session

    def _on_data(self, data: bytes) -> bool:
        """Queue received bytes; False when the peer overran our window
        (flow-control violation — the caller RSTs the stream)."""
        with self._window_cv:
            if len(data) > self._recv_window:
                return False
            self._recv_window -= len(data)
        self._rx.put(data)
        return True

    def _on_fin(self) -> None:
        self._rx.put(b"")

    def _on_window_update(self, credit: int) -> None:
        with self._window_cv:
            self._send_window += credit
            self._window_cv.notify_all()


class YamuxSession:
    """One multiplexed session over a NoiseConnection (or any object with
    send()/recv_exact()/close())."""

    def __init__(self, conn, *, dialer: bool,
                 on_stream: Optional[Callable[[YamuxStream], None]] = None):
        self.conn = conn
        self.dialer = dialer
        self.on_stream = on_stream
        self._next_id = 1 if dialer else 2
        self.streams: Dict[int, YamuxStream] = {}
        self._accept_q: "queue.Queue[YamuxStream]" = queue.Queue()
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._running = True
        self._ping_seq = 0
        self._pings: Dict[int, threading.Event] = {}
        self._rx_thread = threading.Thread(
            target=self._rx_loop, daemon=True, name="yamux-rx")
        self._rx_thread.start()

    # ------------------------------------------------------------- frames

    def _send_frame(self, ftype: int, flags: int, stream_id: int,
                    payload: bytes, length: Optional[int] = None) -> None:
        if length is None:
            length = len(payload)
        header = HEADER.pack(0, ftype, flags, stream_id, length)
        with self._send_lock:
            self.conn.send(header + payload)

    # ---------------------------------------------------------------- api

    def open_stream(self) -> YamuxStream:
        with self._lock:
            sid = self._next_id
            self._next_id += 2
            stream = YamuxStream(self, sid)
            self.streams[sid] = stream
        self._send_frame(TYPE_WINDOW_UPDATE, FLAG_SYN, sid, b"", length=0)
        return stream

    def accept_stream(self, timeout: float = 10.0) -> YamuxStream:
        try:
            return self._accept_q.get(timeout=timeout)
        except queue.Empty:
            raise YamuxError("no inbound stream")

    def ping(self, timeout: float = 5.0) -> bool:
        with self._lock:
            self._ping_seq += 1
            opaque = self._ping_seq
            ev = self._pings[opaque] = threading.Event()
        try:
            self._send_frame(TYPE_PING, FLAG_SYN, 0, b"", length=opaque)
            return ev.wait(timeout)
        finally:
            with self._lock:
                self._pings.pop(opaque, None)

    def close(self) -> None:
        self._running = False
        try:
            self._send_frame(TYPE_GOAWAY, 0, 0, b"", length=0)
        except Exception:
            pass
        self.conn.close()

    # ------------------------------------------------------------ receive

    def _stream_for(self, sid: int, flags: int) -> Optional[YamuxStream]:
        created = None
        with self._lock:
            stream = self.streams.get(sid)
            if stream is None and flags & FLAG_SYN:
                stream = created = YamuxStream(self, sid)
                self.streams[sid] = stream
        if created is not None:
            # ACK + hand-off OUTSIDE the session lock: the callback may
            # call back into the session (open a reply stream), and the
            # ACK send can block on TCP backpressure — neither may wedge
            # the rx thread against _lock.
            self._send_frame(TYPE_WINDOW_UPDATE, FLAG_ACK, sid, b"",
                             length=0)
            if self.on_stream is not None:
                self.on_stream(created)  # the callback owns it...
            else:
                self._accept_q.put(created)  # ...or accept_stream() does
        return stream

    def _rx_loop(self) -> None:
        while self._running:
            try:
                header = self.conn.recv_exact(HEADER.size)
            except Exception:
                break
            version, ftype, flags, sid, length = HEADER.unpack(header)
            if version != 0:
                break
            if ftype == TYPE_DATA:
                payload = (self.conn.recv_exact(length) if length else b"")
                stream = self._stream_for(sid, flags)
                if stream is None:
                    continue
                if payload and not stream._on_data(payload):
                    # Flow-control violation: kill the stream, not the node.
                    self._send_frame(TYPE_DATA, FLAG_RST, sid, b"")
                    stream.closed_remote = True
                    stream._on_fin()
                    continue
                if flags & FLAG_FIN:
                    stream._on_fin()
                if flags & FLAG_RST:
                    stream.closed_remote = True
                    stream._on_fin()
            elif ftype == TYPE_WINDOW_UPDATE:
                stream = self._stream_for(sid, flags)
                if stream is not None and length:
                    stream._on_window_update(length)
                if stream is not None and flags & FLAG_FIN:
                    stream._on_fin()
            elif ftype == TYPE_PING:
                if flags & FLAG_SYN:
                    self._send_frame(TYPE_PING, FLAG_ACK, 0, b"", length=length)
                elif flags & FLAG_ACK:
                    # the opaque value pairs the ACK with ITS ping — a
                    # stale ACK must not satisfy a later probe
                    with self._lock:
                        ev = self._pings.get(length)
                    if ev is not None:
                        ev.set()
            elif ftype == TYPE_GOAWAY:
                break
        self._running = False
        # wake every blocked reader/writer
        with self._lock:
            for stream in self.streams.values():
                stream.closed_remote = True
                stream._on_fin()
                with stream._window_cv:
                    stream._window_cv.notify_all()
