"""EIP-778 Ethereum Node Records with the v4 identity scheme.

A record is ``[signature, seq, k1, v1, k2, v2, ...]`` (keys sorted,
RLP-encoded, <= 300 bytes); the v4 scheme signs ``keccak256(rlp([seq,
k1, v1, ...]))`` with secp256k1 and derives the node id as
``keccak256(uncompressed_pubkey_xy)``.  Text form: ``enr:`` +
unpadded base64url of the RLP.

A copy of the JAX package's ``lighthouse_tpu/network/discv5/enr.py``.
"""

from __future__ import annotations

import base64
import secrets
from typing import Dict, Optional

from . import rlp, secp256k1
from .keccak import keccak256

MAX_RECORD_BYTES = 300


class EnrError(Exception):
    pass


class KeyPair:
    def __init__(self, priv: Optional[int] = None):
        if priv is None:
            priv = (secrets.randbits(255) % (secp256k1.N - 1)) + 1
        self.priv = priv
        self.pub = secp256k1.pubkey(priv)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KeyPair":
        return cls(int.from_bytes(data, "big"))

    @property
    def node_id(self) -> bytes:
        return keccak256(secp256k1.uncompressed_xy(self.pub))

    @property
    def compressed_pub(self) -> bytes:
        return secp256k1.compress(self.pub)


class ENR:
    def __init__(self, seq: int, pairs: Dict[bytes, bytes], signature: bytes):
        self.seq = seq
        self.pairs = dict(pairs)
        self.signature = signature

    # -------------------------------------------------------------- create

    @classmethod
    def build(cls, keypair: KeyPair, seq: int = 1, *,
              ip: Optional[str] = None, udp: Optional[int] = None,
              tcp: Optional[int] = None,
              extra: Optional[Dict[bytes, bytes]] = None) -> "ENR":
        pairs: Dict[bytes, bytes] = {
            b"id": b"v4",
            b"secp256k1": keypair.compressed_pub,
        }
        if ip is not None:
            octets = ip.split(".")
            if len(octets) != 4 or not all(
                    o.isdigit() and 0 <= int(o) <= 255 for o in octets):
                raise EnrError(f"not an IPv4 address: {ip!r} (EIP-778 ip "
                               "must be exactly 4 bytes)")
            pairs[b"ip"] = bytes(int(x) for x in octets)
        for name, port in ((b"udp", udp), (b"tcp", tcp)):
            if port is None:
                continue
            if not 1 <= port <= 65535:
                raise EnrError(f"{name.decode()} port {port} outside "
                               "1..65535 (EIP-778 fields are 16-bit)")
            pairs[name] = rlp.encode_uint(port)
        if extra:
            pairs.update(extra)
        content = cls._content_rlp(seq, pairs)
        sig = secp256k1.sign(keypair.priv, keccak256(content))
        record = cls(seq, pairs, sig)
        if len(record.to_rlp()) > MAX_RECORD_BYTES:
            raise EnrError("ENR exceeds 300 bytes")
        return record

    @staticmethod
    def _content_rlp(seq: int, pairs: Dict[bytes, bytes]) -> bytes:
        items = [rlp.encode_uint(seq)]
        for k in sorted(pairs):
            items.append(k)
            items.append(pairs[k])
        return rlp.encode(items)

    # -------------------------------------------------------------- codecs

    def to_rlp(self) -> bytes:
        items = [self.signature, rlp.encode_uint(self.seq)]
        for k in sorted(self.pairs):
            items.append(k)
            items.append(self.pairs[k])
        return rlp.encode(items)

    @classmethod
    def from_rlp(cls, data: bytes) -> "ENR":
        if len(data) > MAX_RECORD_BYTES:
            raise EnrError("ENR exceeds 300 bytes")
        items = rlp.decode(data)
        if not isinstance(items, list) or len(items) < 2 or len(items) % 2:
            raise EnrError("malformed ENR structure")
        signature, seq_raw = items[0], items[1]
        pairs: Dict[bytes, bytes] = {}
        prev = None
        for i in range(2, len(items), 2):
            k, v = items[i], items[i + 1]
            if not isinstance(k, bytes) or not isinstance(v, bytes):
                raise EnrError("ENR keys/values must be byte strings")
            if prev is not None and k <= prev:
                raise EnrError("ENR keys out of order")
            prev = k
            pairs[k] = v
        record = cls(rlp.decode_uint(seq_raw), pairs, signature)
        if not record.verify():
            raise EnrError("invalid ENR signature")
        return record

    def to_text(self) -> str:
        return "enr:" + base64.urlsafe_b64encode(self.to_rlp()).rstrip(b"=").decode()

    @classmethod
    def from_text(cls, text: str) -> "ENR":
        if not text.startswith("enr:"):
            raise EnrError("missing enr: prefix")
        b64 = text[4:]
        b64 += "=" * (-len(b64) % 4)
        return cls.from_rlp(base64.urlsafe_b64decode(b64))

    # ------------------------------------------------------------- queries

    def verify(self) -> bool:
        if self.pairs.get(b"id") != b"v4":
            return False
        pub_bytes = self.pairs.get(b"secp256k1")
        if pub_bytes is None:
            return False
        try:
            pub = secp256k1.decompress(pub_bytes)
        except ValueError:
            return False
        content = self._content_rlp(self.seq, self.pairs)
        return secp256k1.verify(pub, keccak256(content), self.signature)

    @property
    def node_id(self) -> bytes:
        pub = secp256k1.decompress(self.pairs[b"secp256k1"])
        return keccak256(secp256k1.uncompressed_xy(pub))

    @property
    def public_key(self):
        return secp256k1.decompress(self.pairs[b"secp256k1"])

    def ip(self) -> Optional[str]:
        raw = self.pairs.get(b"ip")
        return ".".join(str(b) for b in raw) if raw else None

    def udp_port(self) -> Optional[int]:
        raw = self.pairs.get(b"udp")
        return rlp.decode_uint(raw) if raw else None

    def __repr__(self) -> str:
        return f"ENR(seq={self.seq}, id={self.node_id.hex()[:12]})"
