"""Discovery v5 (discv5) over UDP — the real wire format.

Equivalent of the reference's discovery layer
(``beacon_node/lighthouse_network/src/discovery/mod.rs`` + the ``discv5``
crate, ``Cargo.toml:115``): ENR records (EIP-778, v4 identity scheme),
masked packet headers, the WHOAREYOU handshake with ECDH-derived AES-GCM
session keys, and the PING/PONG/FINDNODE/NODES message set over UDP.

Modules:
- ``keccak``    — keccak-256 (pre-NIST padding; NOT hashlib's sha3_256)
- ``secp256k1`` — the secp256k1 group, deterministic ECDSA, ECDH
- ``rlp``       — recursive length prefix codec
- ``enr``       — EIP-778 records (sign/verify/encode + ``enr:`` text form)
- ``packets``   — discv5.1 masked header codec (ordinary/whoareyou/handshake)
- ``session``   — HKDF session-key derivation + id-signature
- ``service``   — the UDP node: handshake state machine, routing table,
                  FINDNODE-driven peer discovery

A copy of the JAX package's ``lighthouse_tpu/network/discv5/__init__.py``.
"""

from .enr import ENR, KeyPair
from .service import Discv5Service

__all__ = ["ENR", "KeyPair", "Discv5Service"]
