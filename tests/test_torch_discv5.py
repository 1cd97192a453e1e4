"""The port's discv5 (``network/discv5/``) and ``persisted_dht`` vs the JAX
package's.

- parity: keccak-256, secp256k1 (keys, RFC 6979 signatures, ECDH), RLP,
  ENR records (bytes, ``enr:`` text, node ids), masked packets, AES-GCM
  messages, the handshake's session keys and id-signatures, and the
  persisted DHT's bytes are the JAX package's for the same inputs, and
  each package decodes what the other encodes;
- a port ``Discv5Service`` and a JAX one handshake, PING, FINDNODE and
  bootstrap each other over UDP on 127.0.0.1;
- the JAX package's ``test_discv5.py`` cases, re-pointed at the port (its
  32-round bootstrap among port nodes is the interop case's bootstrap of a
  port node from a JAX one here), and a node's table persisted at shutdown
  and reloaded;
- hostile-packet fuzzing as in its ``test_decoder_robustness.py``.

The JAX package's discv5 needs the ``cryptography`` package (its packet
ciphers); the cases that import it skip where it is missing.  The port's
own cases need it nowhere.
"""

import random
from types import SimpleNamespace

import pytest

from lighthouse_tpu_torch.network.discv5 import ENR, Discv5Service, KeyPair
from lighthouse_tpu_torch.network.discv5 import packets, rlp, secp256k1, session
from lighthouse_tpu_torch.network.discv5.enr import EnrError
from lighthouse_tpu_torch.network.discv5.keccak import keccak256
from lighthouse_tpu_torch.network.discv5.service import log2_distance
from lighthouse_tpu_torch.network.persisted_dht import (
    DHT_DB_KEY,
    clear_dht,
    load_dht,
    persist_dht,
)
from lighthouse_tpu_torch.store.kv import DBColumn, MemoryStore
from test_torch_chain import one_torch_thread, port_cpu  # noqa: F401

SEED = 0xD15C
N_RANDOM = 150  # random inputs per decoder target
N_MUTATE = 150  # mutated-valid inputs per decoder target
LENGTHS = (0, 1, 2, 3, 4, 7, 8, 15, 16, 31, 64, 100, 257, 1000)


def jax_discv5() -> SimpleNamespace:
    """The JAX package's discv5 modules (skips without ``cryptography``)."""
    pytest.importorskip("cryptography", reason="the JAX package's discv5 needs `cryptography`")
    from lighthouse_tpu.network import persisted_dht
    from lighthouse_tpu.network.discv5 import enr, keccak, packets, rlp, secp256k1, service, session
    from lighthouse_tpu.store import kv

    return SimpleNamespace(enr=enr, keccak=keccak, packets=packets, rlp=rlp, secp256k1=secp256k1,
                           service=service, session=session, persisted_dht=persisted_dht, kv=kv)


def private_keys(rng: random.Random, n: int) -> list:
    return [rng.randrange(1, secp256k1.N) for _ in range(n)]


def rlp_items(rng: random.Random, depth: int = 0):
    """A random RLP item: bytes of the lengths around each size class, or a
    list of such items."""
    if depth < 3 and rng.random() < 0.4:
        return [rlp_items(rng, depth + 1) for _ in range(rng.choice((0, 1, 3, 9)))]
    return rng.randbytes(rng.choice((0, 1, 1, 55, 56, 57, 300)))


# ---------------------------------------------------------------- parity


def test_keccak_matches_jax():
    j = jax_discv5()
    rng = random.Random(SEED)
    for n in (0, 1, 55, 135, 136, 137, 271, 272, 1000):
        data = rng.randbytes(n)
        assert keccak256(data) == j.keccak.keccak256(data)


def test_secp256k1_matches_jax():
    j = jax_discv5()
    rng = random.Random(SEED + 1)
    keys = private_keys(rng, 3)
    for a, b in zip(keys, keys[1:]):
        pub = secp256k1.pubkey(a)
        assert pub == j.secp256k1.pubkey(a)
        assert secp256k1.compress(pub) == j.secp256k1.compress(pub)
        assert secp256k1.uncompressed_xy(pub) == j.secp256k1.uncompressed_xy(pub)
        h = rng.randbytes(32)
        sig = secp256k1.sign(a, h)
        assert sig == j.secp256k1.sign(a, h)
        assert j.secp256k1.verify(pub, h, sig)
        assert secp256k1.ecdh(a, secp256k1.pubkey(b)) == j.secp256k1.ecdh(a, j.secp256k1.pubkey(b))


def test_rlp_matches_jax():
    j = jax_discv5()
    rng = random.Random(SEED + 2)
    for _ in range(200):
        item = rlp_items(rng)
        raw = rlp.encode(item)
        assert raw == j.rlp.encode(item)
        assert j.rlp.decode(raw) == item and rlp.decode(raw) == item
    for v in (0, 1, 127, 128, 255, 256, 2**64 - 1):
        assert rlp.encode_uint(v) == j.rlp.encode_uint(v)


def test_enr_bytes_and_text_match_jax():
    j = jax_discv5()
    rng = random.Random(SEED + 3)
    for i, priv in enumerate(private_keys(rng, 3)):
        kw = {"ip": f"10.{i}.{rng.randrange(256)}.{rng.randrange(1, 255)}",
              "udp": rng.randrange(1, 65536), "tcp": rng.randrange(1, 65536) if i % 2 else None,
              "extra": {b"attnets": rng.randbytes(8), b"eth2": rng.randbytes(16)} if i % 3 else None}
        seq = rng.randrange(1, 2**32)
        mine = ENR.build(KeyPair(priv), seq=seq, **kw)
        theirs = j.enr.ENR.build(j.enr.KeyPair(priv), seq=seq, **kw)
        assert mine.to_rlp() == theirs.to_rlp()
        assert mine.to_text() == theirs.to_text()
        assert mine.node_id == theirs.node_id == KeyPair(priv).node_id
        assert j.enr.ENR.from_text(mine.to_text()).verify()
        assert ENR.from_rlp(theirs.to_rlp()).verify()


def test_packets_cross_decode():
    """Each flag's masked packet, encoded by one package with the same
    masking IV, is the same bytes and decodes in the other; so are the
    AES-GCM messages."""
    j = jax_discv5()
    rng = random.Random(SEED + 4)
    dest = keccak256(b"dest")
    src = keccak256(b"src")
    headers = [
        (packets.FLAG_ORDINARY, packets.ordinary_authdata(src)),
        (packets.FLAG_WHOAREYOU, packets.whoareyou_authdata(rng.randbytes(16), 7)),
        (packets.FLAG_HANDSHAKE, packets.handshake_authdata(
            src, rng.randbytes(64), rng.randbytes(33), rng.randbytes(120))),
    ]
    for flag, authdata in headers:
        nonce, iv, key = rng.randbytes(12), rng.randbytes(16), rng.randbytes(16)
        header = packets.Header(flag, nonce, authdata)
        ad = iv + header.encode()
        ct = packets.encrypt_message(key, nonce, b"\x01" + rng.randbytes(40), ad)
        assert ct == j.packets.encrypt_message(key, nonce, packets.decrypt_message(
            key, nonce, ct, ad), ad)
        mine = packets.encode_packet(dest, header, ct, masking_iv=iv)
        theirs = j.packets.encode_packet(dest, j.packets.Header(flag, nonce, authdata), ct,
                                         masking_iv=iv)
        assert mine == theirs
        for decode, datagram in ((j.packets.decode_packet, mine), (packets.decode_packet, theirs)):
            pkt = decode(dest, datagram)
            assert (pkt.header.flag, pkt.header.nonce, pkt.header.authdata) == (
                flag, nonce, authdata)
            assert pkt.message_ct == ct and pkt.challenge_data == ad
        assert j.packets.decrypt_message(key, nonce, ct, ad) == packets.decrypt_message(
            key, nonce, ct, ad)


def test_session_matches_jax():
    j = jax_discv5()
    rng = random.Random(SEED + 5)
    a, b, eph = (KeyPair(k) for k in private_keys(rng, 3))
    challenge = rng.randbytes(63)
    keys = session.derive_keys(eph.priv, b.pub, a.node_id, b.node_id, challenge)
    assert keys == j.session.derive_keys(eph.priv, b.pub, a.node_id, b.node_id, challenge)
    assert keys == j.session.derive_keys_from_pubkey(b.priv, eph.pub, a.node_id, b.node_id,
                                                     challenge)
    sig = session.id_sign(a.priv, challenge, eph.compressed_pub, b.node_id)
    assert sig == j.session.id_sign(a.priv, challenge, eph.compressed_pub, b.node_id)
    assert j.session.id_verify(a.pub, sig, challenge, eph.compressed_pub, b.node_id)


def test_port_and_jax_services_find_each_other():
    """Over UDP on 127.0.0.1: the port pings the JAX node (the WHOAREYOU
    handshake both ways of the keys), then the JAX node pings the port;
    each FINDNODEs a record only the other holds; the port bootstraps from
    the JAX node and learns that record."""
    j = jax_discv5()
    rng = random.Random(SEED + 6)
    pk, jk, ck, dk = private_keys(rng, 4)
    port = Discv5Service(KeyPair(pk)).start()
    jax = j.service.Discv5Service(j.enr.KeyPair(jk)).start()
    c_enr = j.enr.ENR.build(j.enr.KeyPair(ck), seq=3, ip="127.0.0.1", udp=9, tcp=9000)
    d_enr = ENR.build(KeyPair(dk), seq=4, ip="127.0.0.1", udp=10, tcp=9001)
    try:
        jax.add_enr(c_enr)
        port.add_enr(d_enr)
        jax_enr = ENR.from_rlp(jax.enr.to_rlp())
        port_enr = j.enr.ENR.from_rlp(port.enr.to_rlp())
        assert port.ping(jax_enr) == jax.enr.seq
        assert jax.node_id in port._sessions and port.node_id in jax._sessions
        assert jax.ping(port_enr) == port.enr.seq
        found = port.find_node(jax_enr, [log2_distance(jax.node_id, c_enr.node_id)])
        assert c_enr.to_rlp() in [e.to_rlp() for e in found]
        found = jax.find_node(port_enr, [log2_distance(port.node_id, d_enr.node_id)])
        assert d_enr.to_rlp() in [e.to_rlp() for e in found]
        newcomer = Discv5Service(KeyPair(rng.randrange(1, secp256k1.N))).start()
        try:
            newcomer.bootstrap(jax_enr)
            assert c_enr.node_id in newcomer.table and jax.node_id in newcomer.table
        finally:
            newcomer.stop()
    finally:
        port.stop()
        jax.stop()


def test_persisted_dht_bytes_match_jax():
    j = jax_discv5()
    rng = random.Random(SEED + 7)
    mine, theirs = [], []
    for i, priv in enumerate(private_keys(rng, 4)):
        kw = {"ip": f"10.0.0.{i + 1}", "udp": 9000 + i, "tcp": 9100 + i}
        mine.append(ENR.build(KeyPair(priv), seq=i + 1, **kw))
        theirs.append(j.enr.ENR.build(j.enr.KeyPair(priv), seq=i + 1, **kw))
    store, j_store = MemoryStore(), j.kv.MemoryStore()
    assert persist_dht(store, mine) == j.persisted_dht.persist_dht(j_store, theirs) == 4
    raw = store.get(DBColumn.DHT, DHT_DB_KEY)
    assert raw == j_store.get(j.kv.DBColumn.DHT, j.persisted_dht.DHT_DB_KEY)
    assert DHT_DB_KEY == j.persisted_dht.DHT_DB_KEY and DBColumn.DHT == j.kv.DBColumn.DHT
    j_store.put(j.kv.DBColumn.DHT, DHT_DB_KEY, raw + b"\x00\x09garbage")
    store.put(DBColumn.DHT, DHT_DB_KEY, raw + b"\x00\x09garbage")
    assert [e.to_rlp() for e in load_dht(store)] == [
        e.to_rlp() for e in j.persisted_dht.load_dht(j_store)]


# ------------------------- the JAX package's test_discv5.py, re-pointed


class TestPrimitives:
    def test_keccak256_vectors(self):
        assert keccak256(b"").hex() == (
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
        assert keccak256(b"abc").hex() == (
            "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")

    def test_secp256k1_sign_verify_roundtrip(self):
        kp = KeyPair(0x1234)
        h = keccak256(b"message")
        sig = secp256k1.sign(kp.priv, h)
        assert secp256k1.verify(kp.pub, h, sig)
        assert not secp256k1.verify(kp.pub, keccak256(b"other"), sig)
        assert sig == secp256k1.sign(kp.priv, h)
        assert secp256k1.decompress(secp256k1.compress(kp.pub)) == kp.pub

    def test_ecdh_agreement(self):
        a, b = KeyPair(7), KeyPair(11)
        assert secp256k1.ecdh(a.priv, b.pub) == secp256k1.ecdh(b.priv, a.pub)

    def test_rlp_roundtrip(self):
        items = [b"cat", [b"dog", b""], b"\x01", b"x" * 60]
        assert rlp.decode(rlp.encode(items)) == items
        assert rlp.encode(b"\x01") == b"\x01"
        with pytest.raises(rlp.RlpError):
            rlp.decode(rlp.encode(items) + b"\x00")


class TestEnr:
    # The EIP-778 specification example record.
    SPEC_TEXT = (
        "enr:-IS4QHCYrYZbAKWCBRlAy5zzaDZXJBGkcnh4MHcBFZntXNFrdvJjX04jRzjzCBOo"
        "nrkTfj499SZuOh8R33Ls8RRcy5wBgmlkgnY0gmlwhH8AAAGJc2VjcDI1NmsxoQPKY0yu"
        "DUmstAHYpMa2_oxVtw0RW_QAdpzBQA8yWM0xOIN1ZHCCdl8"
    )
    SPEC_NODE_ID = "a448f24c6d18e575453db13171562b71999873db5b286df957af199ec94617f7"
    SPEC_PRIV = 0xB71C71A67E1177AD4E901695E1B4B9EE17AE16C6668D313EAC2F96DBCDA3F291

    def test_spec_vector_decodes_and_verifies(self):
        r = ENR.from_text(self.SPEC_TEXT)
        assert r.seq == 1
        assert r.ip() == "127.0.0.1"
        assert r.udp_port() == 30303
        assert r.node_id.hex() == self.SPEC_NODE_ID
        assert r.to_text() == self.SPEC_TEXT

    def test_own_signing_matches_spec_identity(self):
        kp = KeyPair(self.SPEC_PRIV)
        mine = ENR.build(kp, seq=1, ip="127.0.0.1", udp=30303)
        assert mine.node_id.hex() == self.SPEC_NODE_ID
        assert mine.verify()

    def test_tampered_record_rejected(self):
        r = ENR.from_text(self.SPEC_TEXT)
        r.pairs[b"udp"] = rlp.encode_uint(9)
        assert not r.verify()
        with pytest.raises(EnrError):
            ENR.from_rlp(r.to_rlp())


class TestPackets:
    def test_masked_header_roundtrip(self):
        dest = keccak256(b"dest-node")
        header = packets.Header(packets.FLAG_ORDINARY, b"\x01" * 12,
                                packets.ordinary_authdata(b"\x02" * 32))
        datagram = packets.encode_packet(dest, header, b"ciphertext")
        pkt = packets.decode_packet(dest, datagram)
        assert pkt.header.flag == packets.FLAG_ORDINARY
        assert pkt.header.nonce == b"\x01" * 12
        assert pkt.header.authdata == b"\x02" * 32
        assert pkt.message_ct == b"ciphertext"
        with pytest.raises(packets.PacketError):
            packets.decode_packet(keccak256(b"other"), datagram)

    def test_session_keys_agree(self):
        a, b = KeyPair(3), KeyPair(5)
        eph = KeyPair(9)
        challenge = b"\xaa" * 63
        ik1, rk1 = session.derive_keys(eph.priv, b.pub, a.node_id, b.node_id, challenge)
        ik2, rk2 = session.derive_keys_from_pubkey(
            b.priv, eph.pub, a.node_id, b.node_id, challenge)
        assert (ik1, rk1) == (ik2, rk2)
        sig = session.id_sign(a.priv, challenge, eph.compressed_pub, b.node_id)
        assert session.id_verify(a.pub, sig, challenge, eph.compressed_pub, b.node_id)
        assert not session.id_verify(a.pub, sig, challenge, eph.compressed_pub, a.node_id)


class TestLiveNodes:
    def test_handshake_ping_findnode(self):
        a = Discv5Service(KeyPair()).start()
        b = Discv5Service(KeyPair()).start()
        c_enr = ENR.build(KeyPair(), seq=1, ip="127.0.0.1", udp=9)
        try:
            b.add_enr(c_enr)
            a.add_enr(b.enr)
            assert a.ping(b.enr) == b.enr.seq
            assert b.node_id in a._sessions and a.node_id in b._sessions
            assert a.ping(b.enr) == b.enr.seq
            assert not a._pending and not b._challenges
            found = a.find_node(b.enr, [log2_distance(b.node_id, c_enr.node_id)])
            assert any(e.node_id == c_enr.node_id for e in found)
            me = a.find_node(b.enr, [0])
            assert any(e.node_id == b.node_id for e in me)
        finally:
            a.stop(); b.stop()

    def test_session_recovers_after_peer_restart(self):
        a = Discv5Service(KeyPair()).start()
        b = Discv5Service(KeyPair()).start()
        try:
            assert a.ping(b.enr) == 1
            b._sessions.clear()  # b restarted
            assert a.ping(b.enr) == 1
            assert a.ping(b.enr) == 1
        finally:
            a.stop(); b.stop()

    def test_ping_without_prior_add_enr(self):
        a = Discv5Service(KeyPair()).start()
        b = Discv5Service(KeyPair()).start()
        try:
            assert a.ping(b.enr) == 1
        finally:
            a.stop(); b.stop()


def test_persisted_dht_roundtrip():
    store = MemoryStore()
    enrs = [ENR.build(KeyPair(), seq=i + 1, ip="10.0.0.%d" % (i + 1), udp=9000 + i,
                      tcp=9100 + i) for i in range(3)]
    assert load_dht(store) == []
    assert persist_dht(store, enrs) == 3
    back = load_dht(store)
    assert [e.node_id for e in back] == [e.node_id for e in enrs]
    assert [e.seq for e in back] == [1, 2, 3]
    raw = store.get(DBColumn.DHT, DHT_DB_KEY)
    store.put(DBColumn.DHT, DHT_DB_KEY, raw + b"\x00\x09garbage")
    assert len(load_dht(store)) == 3
    clear_dht(store)
    assert load_dht(store) == []


def test_node_persists_and_reloads_its_table():
    """``LocalNode.shutdown`` persists the discv5 table into the chain's
    store and the next ``enable_discv5`` on that store seeds from it."""
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.tcp_transport import TcpEndpoint

    h = BeaconChainHarness(validator_count=8, fake_crypto=True)
    known = ENR.build(KeyPair(0xABCDEF), seq=2, ip="10.1.2.3", udp=9000, tcp=9001)
    node = LocalNode(peer_id="dht-a", harness=h, endpoint=TcpEndpoint("dht-a"))
    try:
        node.enable_discv5().add_enr(known)
    finally:
        node.shutdown()
    assert [e.to_rlp() for e in load_dht(h.chain.store)] == [known.to_rlp()]
    again = LocalNode(peer_id="dht-b", harness=h, endpoint=TcpEndpoint("dht-b"))
    try:
        assert known.node_id in again.enable_discv5().table
    finally:
        again.shutdown()


# ---------------- the JAX package's test_decoder_robustness.py, discv5


def _random_inputs(rng):
    for _ in range(N_RANDOM):
        yield bytes(rng.getrandbits(8) for _ in range(rng.choice(LENGTHS)))


def _mutations(rng, valid: bytes):
    for _ in range(N_MUTATE):
        data = bytearray(valid)
        kind = rng.randrange(4)
        if kind == 0 and data:  # flip bytes
            for _ in range(rng.randrange(1, 4)):
                data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        elif kind == 1:  # truncate
            data = data[: rng.randrange(len(data) + 1)]
        elif kind == 2:  # extend with noise
            data += bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 40)))
        elif data:  # splice a random window
            i = rng.randrange(len(data))
            j = min(len(data), i + rng.randrange(1, 16))
            data[i:j] = bytes(rng.getrandbits(8) for _ in range(j - i))
        yield bytes(data)


def _assert_clean(decode, inputs, allowed):
    """Decoding must either succeed or raise exactly an allowed error."""
    for data in inputs:
        try:
            decode(data)
        except allowed:
            pass


class TestDiscv5Decoders:
    def test_decode_packet_random_and_mutated(self):
        rng = random.Random(SEED + 8)
        node_id = bytes(rng.getrandbits(8) for _ in range(32))
        decode = lambda d: packets.decode_packet(node_id, d)  # noqa: E731
        _assert_clean(decode, _random_inputs(rng), (packets.PacketError,))
        for data in _random_inputs(rng):
            _assert_clean(decode, [b"\x00" * 16 + data], (packets.PacketError,))
        header = packets.Header(packets.FLAG_HANDSHAKE, rng.randbytes(12),
                                packets.handshake_authdata(node_id, rng.randbytes(64),
                                                           rng.randbytes(33)))
        valid = packets.encode_packet(node_id, header, rng.randbytes(40))
        _assert_clean(decode, _mutations(rng, valid), (packets.PacketError,))

    def test_rlp_and_enr_random_and_mutated(self):
        rng = random.Random(SEED + 9)
        _assert_clean(rlp.decode, _random_inputs(rng), (rlp.RlpError,))
        valid = ENR.build(KeyPair(7), seq=5, ip="10.0.0.1", udp=9000, tcp=9001).to_rlp()
        _assert_clean(rlp.decode, _mutations(rng, valid), (rlp.RlpError,))
        # each decoded record's signature is checked: 30 of them
        _assert_clean(ENR.from_rlp, list(_mutations(rng, valid))[:30], (EnrError, rlp.RlpError))

    def test_service_survives_hostile_datagrams(self):
        """A live node fed random and mutated datagrams keeps answering."""
        import socket

        rng = random.Random(SEED + 10)
        a = Discv5Service(KeyPair()).start()
        b = Discv5Service(KeyPair()).start()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            assert a.ping(b.enr) == 1
            header = packets.Header(packets.FLAG_ORDINARY, rng.randbytes(12),
                                    packets.ordinary_authdata(a.node_id))
            valid = packets.encode_packet(b.node_id, header, rng.randbytes(40))
            for data in list(_random_inputs(rng))[:50] + list(_mutations(rng, valid))[:50]:
                sock.sendto(data, (b.ip, b.port))
            assert b._thread.is_alive()
            assert a.ping(b.enr) == 1
        finally:
            sock.close()
            a.stop(); b.stop()
