"""Recursive Length Prefix codec (Ethereum RLP) — ENR records and discv5
messages are RLP-structured.  Items are ``bytes`` or (nested) lists.

A copy of the JAX package's ``lighthouse_tpu/network/discv5/rlp.py``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

Item = Union[bytes, List["Item"]]


class RlpError(Exception):
    pass


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    ll = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(ll)]) + ll


def encode(item: Item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RlpError(f"cannot RLP-encode {type(item).__name__}")


def encode_uint(n: int) -> bytes:
    """Canonical integer form: big-endian, no leading zeros, 0 == empty."""
    if n == 0:
        return b""
    return n.to_bytes((n.bit_length() + 7) // 8, "big")


def decode_uint(b: bytes) -> int:
    if b.startswith(b"\x00"):
        raise RlpError("non-canonical integer (leading zero)")
    return int.from_bytes(b, "big")


def _decode_at(data: bytes, pos: int) -> Tuple[Item, int]:
    if pos >= len(data):
        raise RlpError("truncated")
    prefix = data[pos]
    if prefix < 0x80:
        return bytes([prefix]), pos + 1
    if prefix < 0xB8:
        length = prefix - 0x80
        end = pos + 1 + length
        out = data[pos + 1:end]
        if len(out) != length:
            raise RlpError("truncated string")
        if length == 1 and out[0] < 0x80:
            raise RlpError("non-canonical single byte")
        return out, end
    if prefix < 0xC0:
        ll = prefix - 0xB7
        length = int.from_bytes(data[pos + 1:pos + 1 + ll], "big")
        if length < 56:
            raise RlpError("non-canonical long string")
        start = pos + 1 + ll
        end = start + length
        if end > len(data):
            raise RlpError("truncated long string")
        return data[start:end], end
    if prefix < 0xF8:
        length = prefix - 0xC0
        end = pos + 1 + length
        if end > len(data):
            raise RlpError("truncated list")
        items, p = [], pos + 1
        while p < end:
            item, p = _decode_at(data, p)
            items.append(item)
        if p != end:
            raise RlpError("list payload overrun")
        return items, end
    ll = prefix - 0xF7
    length = int.from_bytes(data[pos + 1:pos + 1 + ll], "big")
    if length < 56:
        raise RlpError("non-canonical long list")
    start = pos + 1 + ll
    end = start + length
    if end > len(data):
        raise RlpError("truncated long list")
    items, p = [], start
    while p < end:
        item, p = _decode_at(data, p)
        items.append(item)
    if p != end:
        raise RlpError("list payload overrun")
    return items, end


def decode(data: bytes) -> Item:
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise RlpError("trailing bytes after RLP item")
    return item
