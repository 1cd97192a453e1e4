"""Snappy codec (raw block format + streaming frame format).

The reference's wire encodings are ``ssz_snappy`` everywhere: raw snappy for
gossip payloads (``types/pubsub.rs``) and snappy *frames* for req/resp
streams (``rpc/codec/ssz_snappy.rs``, 1,680 LoC).  No snappy library ships in
this image, so the format is implemented here:

- ``decompress`` handles the full raw format (literals + all three copy
  element kinds) for interop with real peers;
- ``compress`` emits a spec-valid literal-only stream (snappy explicitly
  permits uncompressed literal runs).  Trading compression ratio for zero
  dependencies is fine for the in-process fabric; a native matcher can slot
  in later without touching callers.
- frame format: stream identifier + compressed/uncompressed chunks with
  masked CRC32C checksums, per the snappy framing spec.

A copy of the JAX package's ``lighthouse_tpu/network/snappy_codec.py``.
"""

from __future__ import annotations

import struct
from typing import List

MAX_UNCOMPRESSED = 1 << 24  # sanity bound for this stack's payloads


class SnappyError(ValueError):
    pass


# ------------------------------------------------------------- raw format


def _read_varint(data: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def compress(data: bytes) -> bytes:
    """Literal-only raw-snappy encoding (valid per the format spec)."""
    out = bytearray(_write_varint(len(data)))
    pos = 0
    while pos < len(data):
        run = data[pos : pos + 65536]
        n = len(run) - 1
        if n < 60:
            out.append(n << 2)
        elif n < 256:
            out.append(60 << 2)
            out.append(n)
        else:
            out.append(61 << 2)
            out += struct.pack("<H", n)
        out += run
        pos += len(run)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Full raw-snappy decoder (literals + 1/2/4-byte-offset copies)."""
    expected, pos = _read_varint(data, 0)
    if expected > MAX_UNCOMPRESSED:
        raise SnappyError(f"declared size {expected} too large")
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                if pos + extra > len(data):
                    raise SnappyError("truncated literal length")
                n = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            n += 1
            if pos + n > len(data):
                raise SnappyError("truncated literal")
            out += data[pos : pos + n]
            pos += n
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= len(data):
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > len(data):
                raise SnappyError("truncated copy-2")
            offset = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > len(data):
                raise SnappyError("truncated copy-4")
            offset = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        for _ in range(length):  # overlapping copies must go byte-by-byte
            out.append(out[-offset])
    if len(out) != expected:
        raise SnappyError(f"decoded {len(out)} bytes, header said {expected}")
    return bytes(out)


# ------------------------------------------------------------ frame format

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CRC_TABLE: List[int] = []


def _crc32c(data: bytes) -> int:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            _CRC_TABLE.append(crc)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def frame_compress(data: bytes) -> bytes:
    """Encode as a snappy frame stream (identifier + chunks of <=64KiB)."""
    out = bytearray(_STREAM_ID)
    pos = 0
    while pos < len(data) or (pos == 0 and not data):
        chunk = data[pos : pos + 65536]
        pos += len(chunk) or 1
        body = struct.pack("<I", _masked_crc(chunk)) + compress(chunk)
        if len(body) < 4 + len(chunk):
            out.append(0x00)  # compressed chunk
        else:
            body = struct.pack("<I", _masked_crc(chunk)) + chunk
            out.append(0x01)  # uncompressed chunk
        out += struct.pack("<I", len(body))[:3]
        out += body
        if not data:
            break
    return bytes(out)


def frame_decompress(data: bytes) -> bytes:
    if not data.startswith(_STREAM_ID):
        raise SnappyError("missing snappy stream identifier")
    pos = len(_STREAM_ID)
    out = bytearray()
    while pos < len(data):
        if pos + 4 > len(data):
            raise SnappyError("truncated chunk header")
        kind = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + length > len(data):
            raise SnappyError("truncated chunk")
        body = data[pos : pos + length]
        pos += length
        if kind == 0x00:
            (crc,) = struct.unpack_from("<I", body, 0)
            chunk = decompress(body[4:])
            if _masked_crc(chunk) != crc:
                raise SnappyError("chunk checksum mismatch")
            out += chunk
        elif kind == 0x01:
            (crc,) = struct.unpack_from("<I", body, 0)
            chunk = body[4:]
            if _masked_crc(chunk) != crc:
                raise SnappyError("chunk checksum mismatch")
            out += chunk
        elif 0x80 <= kind <= 0xFE:
            continue  # skippable padding
        else:
            raise SnappyError(f"unknown chunk kind {kind:#x}")
    return bytes(out)
