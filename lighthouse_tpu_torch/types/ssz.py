"""SSZ: simple-serialize encoding/decoding + Merkleized hash-tree-root.

Re-implements the capability of the reference's ``ethereum_ssz``/``tree_hash``
stack (used by every container in ``consensus/types``): fixed/variable-size
encoding with 4-byte offsets, chunk-based SHA-256 Merkleization with
zero-subtree memoization, ``mix_in_length`` for lists/bitlists.

Types are *descriptor objects* (instances of ``SszType``); container classes
declare an ordered ``fields`` mapping and get (de)serialization, equality and
hash-tree-root for free.  The pair-hash primitive is a seam
(``set_hash_pairs_impl``) so the Merkle layer can be swapped for a vectorized /
device implementation without touching any container code.

A copy of the JAX package's ``lighthouse_tpu/types/ssz.py`` (pure Python;
the native pair hasher is the port's own copy, ``native/hash_pairs.cc``).

Spec: consensus-specs ssz/simple-serialize.md (the same document the reference
implements; behavior checked against hand-derived known-answer roots in
tests/test_ssz.py and the vendored conformance vectors in tests/vectors/).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

BYTES_PER_CHUNK = 32
OFFSET_SIZE = 4
ZERO_CHUNK = b"\x00" * 32

# Precomputed roots of all-zero subtrees: ZERO_HASHES[d] = root of depth-d zero tree.
ZERO_HASHES = [ZERO_CHUNK]
for _ in range(64):
    h = hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest()
    ZERO_HASHES.append(h)


def _hash_pairs_hashlib(data: bytes) -> bytes:
    """Hash consecutive 64-byte blocks -> concatenated 32-byte digests."""
    out = bytearray()
    for i in range(0, len(data), 64):
        out += hashlib.sha256(data[i : i + 64]).digest()
    return bytes(out)


_hash_pairs = _hash_pairs_hashlib

# Incremental BeaconState tree hashing (types/tree_cache.py); disable with
# LIGHTHOUSE_TPU_TREE_CACHE=0 (a before/after switch for timing runs).
import os as _os

_TREE_CACHE_ENABLED = _os.environ.get("LIGHTHOUSE_TPU_TREE_CACHE", "1") != "0"


def set_hash_pairs_impl(fn) -> None:
    """Swap the Merkle pair-hash kernel (e.g. for a vectorized implementation)."""
    global _hash_pairs
    _hash_pairs = fn


def _try_install_native_hash_pairs() -> bool:
    """Install the batched C++ SHA-256 (native/hash_pairs.cc) as the Merkle
    pair-hash kernel.  Python-loop hashlib does ~0.6M hashes/s; the native
    loop removes the interpreter from the per-hash path (the reference's
    ethereum_hashing asm/SIMD role).  Returns True on success."""
    try:
        import ctypes

        from ..native import load_hash_pairs

        lib = load_hash_pairs()

        def _hash_pairs_native(data: bytes) -> bytes:
            n = len(data) // 64
            if n == 0:
                return b""
            out = ctypes.create_string_buffer(32 * n)
            lib.hash_pairs(data, n, out)
            return out.raw

        set_hash_pairs_impl(_hash_pairs_native)
        return True
    except Exception:
        return False


if _os.environ.get("LIGHTHOUSE_TPU_NATIVE_SHA", "1") != "0":
    _try_install_native_hash_pairs()


def hash_two(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def merkleize(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Merkleize 32-byte chunks, padding with zero subtrees to `limit` leaves."""
    count = len(chunks)
    if limit is None:
        limit = count
    elif count > limit:
        raise ValueError(f"merkleize: {count} chunks exceeds limit {limit}")
    if limit == 0:
        return ZERO_CHUNK
    depth = max(0, (limit - 1).bit_length())
    if count == 0:
        return ZERO_HASHES[depth]
    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2 == 1:
            layer.append(ZERO_HASHES[d])
        buf = b"".join(layer)
        hashed = _hash_pairs(buf)
        layer = [hashed[i : i + 32] for i in range(0, len(hashed), 32)]
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_two(root, length.to_bytes(32, "little"))


def merkle_branch(chunks: Sequence[bytes], limit: Optional[int], index: int) -> list:
    """Sibling branch (bottom-up) proving ``chunks[index]`` under the
    merkleize(chunks, limit) root — the proof-generation dual of
    ``is_valid_merkle_branch`` (reference ``consensus/merkle_proof``)."""
    count = len(chunks)
    if limit is None:
        limit = count
    depth = max(0, (limit - 1).bit_length())
    if index >= limit:
        raise ValueError(f"index {index} out of range for limit {limit}")
    branch = []
    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2 == 1:
            layer.append(ZERO_HASHES[d])
        sibling = index ^ 1
        branch.append(layer[sibling] if sibling < len(layer) else ZERO_HASHES[d])
        buf = b"".join(layer)
        hashed = _hash_pairs(buf)
        layer = [hashed[i : i + 32] for i in range(0, len(hashed), 32)]
        index //= 2
    return branch


def pack_bytes(data: bytes) -> list:
    """Pack bytes into zero-padded 32-byte chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i : i + 32] for i in range(0, len(data), 32)]


# ---------------------------------------------------------------- descriptors


class SszType:
    is_fixed_size: bool = True
    fixed_size: int = 0

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


class UintType(SszType):
    def __init__(self, byte_len: int):
        self.fixed_size = byte_len

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.fixed_size, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.fixed_size:
            raise ValueError(f"uint{self.fixed_size*8}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return int(value).to_bytes(self.fixed_size, "little").ljust(32, b"\x00")

    def default(self):
        return 0


class BooleanType(SszType):
    fixed_size = 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean")

    def hash_tree_root(self, value) -> bytes:
        return (b"\x01" if value else b"\x00").ljust(32, b"\x00")

    def default(self):
        return False


uint8 = UintType(1)
uint16 = UintType(2)
uint32 = UintType(4)
uint64 = UintType(8)
uint128 = UintType(16)
uint256 = UintType(32)
boolean = BooleanType()

_BASIC_SIZES = {1, 2, 4, 8, 16, 32}


class ByteVector(SszType):
    def __init__(self, length: int):
        self.length = length
        self.fixed_size = length

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)}")
        return value

    def deserialize(self, data: bytes) -> bytes:
        return self.serialize(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self):
        return b"\x00" * self.length


bytes4 = ByteVector(4)
bytes20 = ByteVector(20)
bytes32 = ByteVector(32)
bytes48 = ByteVector(48)
bytes96 = ByteVector(96)


class ByteList(SszType):
    is_fixed_size = False

    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = bytes(value)
        limit_chunks = (self.limit + 31) // 32
        return mix_in_length(merkleize(pack_bytes(value), limit_chunks), len(value))

    def default(self):
        return b""


class Vector(SszType):
    def __init__(self, elem: SszType, length: int):
        assert length > 0
        self.elem = elem
        self.length = length
        self.is_fixed_size = elem.is_fixed_size
        if self.is_fixed_size:
            self.fixed_size = elem.fixed_size * length

    def serialize(self, value) -> bytes:
        value = list(value)
        if len(value) != self.length:
            raise ValueError(f"Vector[{self.length}]: got {len(value)}")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        return _deserialize_homogeneous(self.elem, data, exact_count=self.length)

    def hash_tree_root(self, value) -> bytes:
        value = list(value)
        if isinstance(self.elem, (UintType, BooleanType)):
            return merkleize(pack_bytes(b"".join(self.elem.serialize(v) for v in value)))
        return merkleize([self.elem.hash_tree_root(v) for v in value])

    def default(self):
        return [self.elem.default() for _ in range(self.length)]


class List(SszType):
    is_fixed_size = False

    def __init__(self, elem: SszType, limit: int):
        self.elem = elem
        self.limit = limit

    def serialize(self, value) -> bytes:
        value = list(value)
        if len(value) > self.limit:
            raise ValueError("List over limit")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_homogeneous(self.elem, data, exact_count=None)
        if len(out) > self.limit:
            raise ValueError("List over limit")
        return out

    def hash_tree_root(self, value) -> bytes:
        value = list(value)
        if isinstance(self.elem, (UintType, BooleanType)):
            limit_chunks = (self.limit * self.elem.fixed_size + 31) // 32
            body = merkleize(
                pack_bytes(b"".join(self.elem.serialize(v) for v in value)), limit_chunks
            )
        else:
            body = merkleize([self.elem.hash_tree_root(v) for v in value], self.limit)
        return mix_in_length(body, len(value))

    def default(self):
        return []


class Bitvector(SszType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length
        self.fixed_size = (length + 7) // 8

    def serialize(self, value) -> bytes:
        bits = list(value)
        if len(bits) != self.length:
            raise ValueError(f"Bitvector[{self.length}]: got {len(bits)}")
        out = bytearray(self.fixed_size)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size:
            raise ValueError("Bitvector: bad length")
        if self.length % 8:
            if data[-1] >> (self.length % 8):
                raise ValueError("Bitvector: high bits set")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(self.length)]

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self):
        return [False] * self.length


class Bitlist(SszType):
    is_fixed_size = False

    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value) -> bytes:
        bits = list(value)
        if len(bits) > self.limit:
            raise ValueError("Bitlist over limit")
        out = bytearray((len(bits) // 8) + 1)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        out[len(bits) // 8] |= 1 << (len(bits) % 8)  # delimiter bit
        return bytes(out)

    def deserialize(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("Bitlist: missing delimiter")
        top = data[-1].bit_length() - 1
        length = (len(data) - 1) * 8 + top
        if length > self.limit:
            raise ValueError("Bitlist over limit")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(length)]

    def hash_tree_root(self, value) -> bytes:
        bits = list(value)
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        limit_chunks = (self.limit + 255) // 256
        return mix_in_length(merkleize(pack_bytes(bytes(out)), limit_chunks), len(bits))

    def default(self):
        return []


def _serialize_homogeneous(elem: SszType, values: list) -> bytes:
    if elem.is_fixed_size:
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    offset = OFFSET_SIZE * len(parts)
    out = bytearray()
    for p in parts:
        out += offset.to_bytes(4, "little")
        offset += len(p)
    for p in parts:
        out += p
    return bytes(out)


def _deserialize_homogeneous(elem: SszType, data: bytes, exact_count):
    if elem.is_fixed_size:
        size = elem.fixed_size
        if len(data) % size:
            raise ValueError("trailing bytes in fixed-size sequence")
        count = len(data) // size
        if exact_count is not None and count != exact_count:
            raise ValueError("wrong element count")
        return [elem.deserialize(data[i * size : (i + 1) * size]) for i in range(count)]
    if not data:
        if exact_count:
            raise ValueError("wrong element count")
        return []
    first = int.from_bytes(data[:4], "little")
    if first % 4 or first > len(data):
        raise ValueError("bad first offset")
    count = first // 4
    if exact_count is not None and count != exact_count:
        raise ValueError("wrong element count")
    offsets = [int.from_bytes(data[i * 4 : i * 4 + 4], "little") for i in range(count)]
    offsets.append(len(data))
    out = []
    for i in range(count):
        if offsets[i + 1] < offsets[i]:
            raise ValueError("offsets not monotonic")
        out.append(elem.deserialize(data[offsets[i] : offsets[i + 1]]))
    return out


# ----------------------------------------------------------------- containers


class _ContainerType(SszType):
    """Descriptor for a Container class (built by the metaclass)."""

    def __init__(self, cls):
        self.cls = cls
        self.field_types: Dict[str, SszType] = cls.fields
        self.is_fixed_size = all(t.is_fixed_size for t in self.field_types.values())
        if self.is_fixed_size:
            self.fixed_size = sum(t.fixed_size for t in self.field_types.values())
        # BeaconState-shaped containers get an incremental tree-hash cache
        # (the reference's cached_tree_hash/milhouse role).
        self.cacheable = "validators" in self.field_types and "balances" in self.field_types

    def serialize(self, value) -> bytes:
        fixed_parts = []
        var_parts = []
        for name, t in self.field_types.items():
            v = getattr(value, name)
            if t.is_fixed_size:
                fixed_parts.append(t.serialize(v))
            else:
                fixed_parts.append(None)
                var_parts.append(t.serialize(v))
        fixed_len = sum(len(p) if p is not None else 4 for p in fixed_parts)
        out = bytearray()
        offset = fixed_len
        vi = 0
        for p in fixed_parts:
            if p is None:
                out += offset.to_bytes(4, "little")
                offset += len(var_parts[vi])
                vi += 1
            else:
                out += p
        for p in var_parts:
            out += p
        return bytes(out)

    def deserialize(self, data: bytes):
        kwargs = {}
        pos = 0
        offsets: list = []
        var_fields = []
        for name, t in self.field_types.items():
            if t.is_fixed_size:
                kwargs[name] = t.deserialize(data[pos : pos + t.fixed_size])
                pos += t.fixed_size
            else:
                offsets.append(int.from_bytes(data[pos : pos + 4], "little"))
                var_fields.append(name)
                pos += 4
        offsets.append(len(data))
        if not var_fields and pos != len(data):
            raise ValueError("container: trailing bytes")
        if var_fields and offsets[0] != pos:
            raise ValueError("container: bad first offset")
        for i, name in enumerate(var_fields):
            if offsets[i + 1] < offsets[i] or offsets[i + 1] > len(data):
                raise ValueError("container: bad offsets")
            kwargs[name] = self.field_types[name].deserialize(
                data[offsets[i] : offsets[i + 1]]
            )
        return self.cls(**kwargs)

    def hash_tree_root(self, value) -> bytes:
        if self.cacheable and _TREE_CACHE_ENABLED:
            try:
                from .tree_cache import StateTreeHashCache
            except ImportError:
                pass  # degrade to the plain recursive path
            else:
                cache = getattr(value, "_thc", None)
                if cache is None:
                    cache = StateTreeHashCache(self)
                    value._thc = cache
                return cache.root(value)
        return merkleize(
            [t.hash_tree_root(getattr(value, name)) for name, t in self.field_types.items()]
        )

    def default(self):
        return self.cls()


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        if ns.get("fields"):
            cls.ssz_type = _ContainerType(cls)
        return cls


class Container(metaclass=_ContainerMeta):
    """Base for SSZ containers: subclass with an ordered ``fields`` dict."""

    fields: Dict[str, SszType] = {}

    def __init__(self, **kwargs):
        for fname, ftype in self.fields.items():
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, ftype.default())
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kwargs)}")

    @classmethod
    def from_ssz_bytes(cls, data: bytes):
        return cls.ssz_type.deserialize(data)

    def as_ssz_bytes(self) -> bytes:
        return self.ssz_type.serialize(self)

    def hash_tree_root(self) -> bytes:
        return self.ssz_type.hash_tree_root(self)

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f) for f in self.fields)

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in list(self.fields)[:4])
        more = "…" if len(self.fields) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"


def hash_tree_root(type_or_value, value=None) -> bytes:
    """hash_tree_root(container) or hash_tree_root(ssz_type, value)."""
    if value is None:
        return type_or_value.hash_tree_root()
    return type_or_value.hash_tree_root(value)
