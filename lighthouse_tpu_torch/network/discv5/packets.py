"""discv5.1 wire packets: masked headers, three flags, AES-GCM messages.

Packet layout (discv5-wire.md):

    packet        = masking-iv || masked-header || message
    masked-header = aesctr_encrypt(masking-key, masking-iv, header)
    masking-key   = dest-node-id[:16]
    header        = static-header || authdata
    static-header = "discv5" || version(0x0001) || flag || nonce(12) || authdata-size(2)

Flags: 0 ordinary (authdata = src-node-id), 1 WHOAREYOU (authdata =
id-nonce(16) || enr-seq(8), no message), 2 handshake (authdata =
src-node-id || sig-size || eph-key-size || id-signature || eph-pubkey ||
[ENR]).  Messages are AES-GCM with the session key, the header nonce, and
``masking-iv || header`` as associated data.

A copy of the JAX package's ``lighthouse_tpu/network/discv5/packets.py``,
with AES-128-CTR and AES-128-GCM from the port's native cipher
(``native/wire_cipher.cc``) in place of the ``cryptography`` package.
"""

from __future__ import annotations

import os
import secrets
from dataclasses import dataclass, field
from typing import Optional, Tuple

from ... import native

PROTOCOL_ID = b"discv5"
VERSION = 0x0001

FLAG_ORDINARY = 0
FLAG_WHOAREYOU = 1
FLAG_HANDSHAKE = 2

STATIC_HEADER_LEN = 6 + 2 + 1 + 12 + 2


class PacketError(Exception):
    pass


def _aes_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    return native.aes128_ctr(key, iv, data)


@dataclass
class Header:
    flag: int
    nonce: bytes  # 12 bytes
    authdata: bytes

    def encode(self) -> bytes:
        return (
            PROTOCOL_ID
            + VERSION.to_bytes(2, "big")
            + bytes([self.flag])
            + self.nonce
            + len(self.authdata).to_bytes(2, "big")
            + self.authdata
        )


@dataclass
class Packet:
    masking_iv: bytes
    header: Header
    message_ct: bytes  # empty for WHOAREYOU

    @property
    def challenge_data(self) -> bytes:
        """masking-iv || static-header || authdata — the handshake binds its
        id-signature and session keys to this exact WHOAREYOU bytes."""
        return self.masking_iv + self.header.encode()


def encode_packet(dest_node_id: bytes, header: Header, message_ct: bytes = b"",
                  masking_iv: Optional[bytes] = None) -> bytes:
    if masking_iv is None:
        masking_iv = os.urandom(16)
    masked = _aes_ctr(dest_node_id[:16], masking_iv, header.encode())
    return masking_iv + masked + message_ct


def decode_packet(local_node_id: bytes, datagram: bytes) -> Packet:
    if len(datagram) < 16 + STATIC_HEADER_LEN:
        raise PacketError("datagram too short")
    masking_iv = datagram[:16]
    static = _aes_ctr(local_node_id[:16], masking_iv, datagram[16:16 + STATIC_HEADER_LEN])
    if static[:6] != PROTOCOL_ID:
        raise PacketError("bad protocol id")
    if int.from_bytes(static[6:8], "big") != VERSION:
        raise PacketError("unsupported version")
    flag = static[8]
    nonce = static[9:21]
    authdata_size = int.from_bytes(static[21:23], "big")
    start = 16 + STATIC_HEADER_LEN
    if len(datagram) < start + authdata_size:
        raise PacketError("truncated authdata")
    # one keystream over the static header and the authdata
    authdata = _aes_ctr(local_node_id[:16], masking_iv,
                        datagram[16:start + authdata_size])[STATIC_HEADER_LEN:]
    message_ct = datagram[start + authdata_size:]
    return Packet(masking_iv, Header(flag, nonce, authdata), message_ct)


# ------------------------------------------------------------- authdata


def ordinary_authdata(src_node_id: bytes) -> bytes:
    return src_node_id


def whoareyou_authdata(id_nonce: bytes, enr_seq: int) -> bytes:
    return id_nonce + enr_seq.to_bytes(8, "big")


def parse_whoareyou(authdata: bytes) -> Tuple[bytes, int]:
    if len(authdata) != 24:
        raise PacketError("bad whoareyou authdata")
    return authdata[:16], int.from_bytes(authdata[16:], "big")


def handshake_authdata(src_node_id: bytes, id_signature: bytes,
                       eph_pubkey: bytes, enr_rlp: bytes = b"") -> bytes:
    return (
        src_node_id
        + bytes([len(id_signature), len(eph_pubkey)])
        + id_signature
        + eph_pubkey
        + enr_rlp
    )


def parse_handshake(authdata: bytes) -> Tuple[bytes, bytes, bytes, bytes]:
    """(src_node_id, id_signature, eph_pubkey, enr_rlp)."""
    if len(authdata) < 34:
        raise PacketError("handshake authdata too short")
    src = authdata[:32]
    sig_size, key_size = authdata[32], authdata[33]
    pos = 34
    sig = authdata[pos:pos + sig_size]
    pos += sig_size
    eph = authdata[pos:pos + key_size]
    pos += key_size
    if len(sig) != sig_size or len(eph) != key_size:
        raise PacketError("truncated handshake authdata")
    return src, sig, eph, authdata[pos:]


# -------------------------------------------------------------- messages


def encrypt_message(key: bytes, nonce: bytes, plaintext: bytes, ad: bytes) -> bytes:
    return native.aes128_gcm_seal(key, nonce, plaintext, ad)


def decrypt_message(key: bytes, nonce: bytes, ciphertext: bytes, ad: bytes) -> bytes:
    return native.aes128_gcm_open(key, nonce, ciphertext, ad)


def random_nonce() -> bytes:
    return secrets.token_bytes(12)


def random_id_nonce() -> bytes:
    return secrets.token_bytes(16)
