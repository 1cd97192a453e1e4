"""The port's in-process network (``network/``) vs the JAX package's.

``lighthouse_tpu_torch.network`` copies the JAX package's ``network/``
without the wire (``tcp_transport``, ``noise/``, ``discv5/``,
``persisted_dht``, ``boot_node``).  Chains are the port's fake-crypto
harnesses on its CPU routes (``test_torch_chain.port_cpu``).  Here:

- parity: snappy's raw and framed bytes of seeded random payloads, the
  gossipsub protobuf bytes of seeded random RPCs, and the req/resp codec's
  bytes of seeded random requests are the JAX package's, byte for byte, and
  each package decodes the other's;
- the JAX package's ``test_network.py`` cases, re-pointed at the port;
- the cases of its ``test_subnet_service.py`` that need neither the wire
  nor the HTTP API (the ENR predicate case on a stand-in record: ENRs come
  with ``discv5/``);
- the gossipsub protobuf and snappy cases of its
  ``test_decoder_robustness.py``;
- the ``LocalNode`` cases of its ``test_da.py`` (blob gossip, range sync and
  backfill of blob blocks, on ``Kzg(setup, device="cpu")``) and the router
  case of its ``test_block_streamer.py``.
"""

import dataclasses
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

from lighthouse_tpu.network import pb as j_pb  # noqa: E402
from lighthouse_tpu.network import rpc as j_rpc  # noqa: E402
from lighthouse_tpu.network import snappy_codec as j_snappy  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.crypto.kzg.kzg import Kzg, TrustedSetup  # noqa: E402
from lighthouse_tpu_torch.network import (  # noqa: E402
    Hub,
    LocalNode,
    pb,
    rpc,
    snappy_codec,
    topics,
)
from lighthouse_tpu_torch.network.peer_manager import PeerAction, PeerManager  # noqa: E402
from lighthouse_tpu_torch.network.service import NetworkService  # noqa: E402
from lighthouse_tpu_torch.network.subnet_service import (  # noqa: E402
    EPOCHS_PER_SUBNET_SUBSCRIPTION,
    SUBNETS_PER_NODE,
    SubnetService,
    compute_subscribed_subnets,
)
from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET, minimal_spec  # noqa: E402
from test_torch_chain import one_torch_thread, port_cpu  # noqa: E402,F401

GENESIS_TIME = 1_600_000_000
SEED = 0xC0FFEE
N_RANDOM = 150  # random inputs per decoder target
N_MUTATE = 150  # mutated-valid inputs per decoder target
LENGTHS = (0, 1, 2, 3, 4, 7, 8, 15, 16, 31, 64, 100, 257, 1000)
WIDTH = 64  # small blobs: 64 field elements = 2 KiB, fast host math
PRESET = dataclasses.replace(MINIMAL_PRESET, field_elements_per_blob=WIDTH)


# ------------------------------------------------------------ parity, bytes


def payloads(rng: np.random.Generator, n: int) -> list:
    """Random payloads of assorted lengths, half of them repetitive so that
    snappy's copy elements (offsets of 1, 2 and 4 bytes) appear."""
    out = []
    for i in range(n):
        size = int(rng.choice([0, 1, 5, 60, 61, 255, 4096, 70_000]))
        if i % 2:
            unit = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
            out.append((unit * (size // len(unit) + 1))[:size])
        else:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return out


def test_snappy_bytes_match_jax():
    """Raw and framed snappy of seeded random payloads: the port's bytes are
    the JAX package's, and each package decodes the other's."""
    for data in payloads(np.random.default_rng(11), 24):
        raw, framed = snappy_codec.compress(data), snappy_codec.frame_compress(data)
        assert raw == j_snappy.compress(data)
        assert framed == j_snappy.frame_compress(data)
        assert j_snappy.decompress(raw) == data == snappy_codec.decompress(raw)
        assert j_snappy.frame_decompress(framed) == data == snappy_codec.frame_decompress(framed)


def random_rpc(mod, rng: np.random.Generator):
    """A gossipsub RPC of ``mod`` (either package's ``pb``) with every
    message kind, drawn from ``rng``."""
    def blob(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()

    def topic():
        return f"/eth2/{blob(4, 5).hex()}/beacon_attestation_{int(rng.integers(64))}/ssz_snappy"

    def some(lo, hi):
        return range(int(rng.integers(lo, hi)))

    control = None
    if rng.integers(2):
        control = mod.ControlMessage(
            ihave=[mod.ControlIHave(topic_id=topic(), message_ids=[blob(20, 21) for _ in some(0, 4)])
                   for _ in some(0, 3)],
            iwant=[mod.ControlIWant(message_ids=[blob(20, 21) for _ in some(1, 4)])
                   for _ in some(0, 3)],
            graft=[mod.ControlGraft(topic_id=topic()) for _ in some(0, 3)],
            prune=[mod.ControlPrune(
                topic_id=topic(),
                peers=[mod.PeerInfo(peer_id=blob(1, 39), signed_peer_record=blob(0, 80))
                       for _ in some(0, 3)],
                backoff=int(rng.integers(0, 1 << 20)) if rng.integers(2) else None)
                for _ in some(0, 3)])
    return mod.RPC(
        subscriptions=[mod.SubOpts(subscribe=bool(rng.integers(2)), topic_id=topic())
                       for _ in some(0, 4)],
        publish=[mod.Message(data=blob(0, 600), topic=topic()) for _ in some(0, 4)],
        control=control)


def test_gossipsub_protobuf_bytes_match_jax():
    """Seeded random RPCs (subscriptions, messages, IHAVE, IWANT, GRAFT,
    PRUNE with peer exchange and backoff): the port encodes the JAX
    package's bytes and frames, and decodes them to the JAX package's RPC."""
    for i in range(40):
        got = random_rpc(pb, np.random.default_rng(i)).encode()
        want = random_rpc(j_pb, np.random.default_rng(i)).encode()
        assert got == want
        assert pb.RPC.decode(want).encode() == want
        assert dataclasses.asdict(pb.RPC.decode(want)) == dataclasses.asdict(j_pb.RPC.decode(got))
        assert pb.encode_frame(pb.RPC.decode(got)) == j_pb.encode_frame(j_pb.RPC.decode(want))


def test_rpc_codec_bytes_match_jax():
    """Seeded req/resp requests and response chunks: the port's ssz_snappy
    bytes are the JAX package's, and it decodes them to equal values."""
    rng = np.random.default_rng(5)

    def draw(mod):
        r = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
        return [
            (mod.STATUS, mod.Status(r(4), r(32), int(rng.integers(1 << 40)), r(32),
                                    int(rng.integers(1 << 40)))),
            (mod.BLOCKS_BY_RANGE, mod.BlocksByRangeRequest(
                start_slot=int(rng.integers(1 << 40)), count=int(rng.integers(1, 1024)))),
            (mod.BLOCKS_BY_ROOT, mod.BlocksByRootRequest(
                roots=[r(32) for _ in range(int(rng.integers(1, 9)))])),
            (mod.PING, mod.Ping(int(rng.integers(1 << 60)))),
            (mod.GOODBYE, mod.Goodbye(int(rng.integers(1, 4)))),
        ]

    state = rng.bit_generator.state
    port = draw(rpc)
    rng.bit_generator.state = state
    ref = draw(j_rpc)
    for (proto, req), (j_proto, j_req) in zip(port, ref):
        assert proto == j_proto
        data = rpc.encode_request(proto, req)
        assert data == j_rpc.encode_request(j_proto, j_req)
        assert rpc.decode_request(proto, data) == req
    for payload in payloads(np.random.default_rng(6), 8):
        ctx = payload[:4].ljust(4, b"\x00")
        chunk = rpc.encode_response_chunk(rpc.SUCCESS, payload, context_bytes=ctx)
        assert chunk == j_rpc.encode_response_chunk(j_rpc.SUCCESS, payload, context_bytes=ctx)
        assert rpc.decode_response_chunk(chunk, has_context=True)[:3] == (rpc.SUCCESS, payload, ctx)


# ------------------------------------- the JAX package's test_network.py


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


class TestSnappy:
    def test_raw_roundtrip(self):
        for payload in [b"", b"a", b"hello" * 1000, bytes(range(256)) * 300]:
            assert snappy_codec.decompress(snappy_codec.compress(payload)) == payload

    def test_decoder_handles_copies(self):
        # Hand-built stream with a copy element: "abcdabcd"
        # varint len 8, literal "abcd", copy-1 offset 4 len 4
        data = bytes([8]) + bytes([3 << 2]) + b"abcd" + bytes([0b001 | (0 << 2)]) + bytes([4])
        # tag: kind=1, len=((tag>>2)&7)+4 = 4, offset = ((tag>>5)<<8)|next = 4
        assert snappy_codec.decompress(data) == b"abcdabcd"

    def test_frame_roundtrip(self):
        for payload in [b"", b"x" * 10, b"block" * 40000]:
            assert snappy_codec.frame_decompress(snappy_codec.frame_compress(payload)) == payload

    def test_frame_checksum_detects_corruption(self):
        framed = bytearray(snappy_codec.frame_compress(b"payload" * 100))
        framed[-1] ^= 0xFF
        with pytest.raises(snappy_codec.SnappyError):
            snappy_codec.frame_decompress(bytes(framed))


class TestRpcCodec:
    def test_status_roundtrip(self):
        st = rpc.Status(b"\x01\x02\x03\x04", b"\xaa" * 32, 7, b"\xbb" * 32, 123)
        data = rpc.encode_request(rpc.STATUS, st)
        back = rpc.decode_request(rpc.STATUS, data)
        assert back == st

    def test_blocks_by_range_roundtrip(self):
        req = rpc.BlocksByRangeRequest(start_slot=100, count=64)
        back = rpc.decode_request(rpc.BLOCKS_BY_RANGE, rpc.encode_request(rpc.BLOCKS_BY_RANGE, req))
        assert back.start_slot == 100 and back.count == 64

    def test_response_chunk_with_context(self):
        chunk = rpc.encode_response_chunk(rpc.SUCCESS, b"payload", context_bytes=b"\x01\x02\x03\x04")
        result, payload, ctx, _ = rpc.decode_response_chunk(chunk, has_context=True)
        assert (result, payload, ctx) == (rpc.SUCCESS, b"payload", b"\x01\x02\x03\x04")


class TestTopics:
    def test_roundtrip(self):
        t = topics.GossipTopic(b"\x01\x02\x03\x04", topics.BEACON_BLOCK)
        assert topics.GossipTopic.parse(str(t)) == t

    def test_subnet_id(self):
        t = topics.GossipTopic(b"\x00" * 4, "beacon_attestation_17")
        assert t.subnet_id == 17


class TestPeerScoring:
    def test_ban_at_threshold(self):
        pm = PeerManager()
        pm.on_connect("p1")
        for _ in range(4):
            pm.report("p1", PeerAction.LOW_TOLERANCE)
        assert not pm.is_banned("p1")
        pm.report("p1", PeerAction.LOW_TOLERANCE)  # 5th strike crosses -50
        assert pm.is_banned("p1")
        assert not pm.on_connect("p1")  # refused while banned

    def test_fatal_is_instant_ban(self):
        pm = PeerManager()
        pm.on_connect("p1")
        pm.report("p1", PeerAction.FATAL)
        assert pm.is_banned("p1")


def two_nodes(hub=None, **kw):
    hub = hub or Hub()
    ha = BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=GENESIS_TIME, **kw)
    hb = BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=GENESIS_TIME, **kw)
    na = LocalNode(hub=hub, peer_id="a", harness=ha)
    nb = LocalNode(hub=hub, peer_id="b", harness=hb)
    return hub, na, nb


class TestGossip:
    def test_block_propagates_and_imports(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            na.harness.advance_slot()
            nb.harness.advance_slot()
            signed = na.harness.produce_signed_block()
            root = na.chain.process_block(signed, block_delay_seconds=1.0)
            na.publish_block(signed)
            assert wait_until(lambda: nb.chain.head_root == root)
        finally:
            na.shutdown(); nb.shutdown()

    def test_attestation_propagates(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            na.harness.advance_slot()
            nb.harness.advance_slot()
            signed = na.harness.produce_signed_block()
            root = na.chain.process_block(signed, block_delay_seconds=1.0)
            na.publish_block(signed)
            assert wait_until(lambda: nb.chain.head_root == root)
            # one validator attests on node a; node b should pool it
            import lighthouse_tpu_torch.consensus.helpers as h

            state = na.chain.head_state
            committee = h.get_beacon_committee(state, 1, 0, na.chain.spec)
            data = na.chain.produce_attestation_data(1, 0)
            att = na.harness.types.Attestation(
                aggregation_bits=[True] + [False] * (len(committee) - 1),
                data=data,
                signature=na.harness.sign_attestation_data(state, data, int(committee[0])).to_bytes(),
            )
            na.chain.process_attestation(att)
            na.publish_attestation(att)
            assert wait_until(lambda: len(nb.chain.attestation_pool._pool) > 0)
        finally:
            na.shutdown(); nb.shutdown()

    def test_third_node_receives_via_relay(self):
        """a—b—c line topology: validated messages are re-forwarded."""
        hub = Hub()
        hs = [
            BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=GENESIS_TIME)
            for _ in range(3)
        ]
        nodes = [LocalNode(hub=hub, peer_id=p, harness=h) for p, h in zip("abc", hs)]
        try:
            hub.connect("a", "b")
            hub.connect("b", "c")
            for h in hs:
                h.advance_slot()
            signed = hs[0].produce_signed_block()
            root = nodes[0].chain.process_block(signed, block_delay_seconds=1.0)
            nodes[0].publish_block(signed)
            assert wait_until(lambda: nodes[2].chain.head_root == root)
        finally:
            for n in nodes:
                n.shutdown()

    def test_undecodable_block_penalizes_sender(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            topic = topics.GossipTopic(na.router.fork_digest, topics.BEACON_BLOCK)
            na.service.publish(str(topic), b"\x00" * 50)  # garbage SSZ
            assert wait_until(lambda: nb.service.peer_manager.score("a") < 0)
        finally:
            na.shutdown(); nb.shutdown()


class TestScoreThresholds:
    """Gossipsub v1.1 score gates (reference PeerScoreThresholds)."""

    def test_graylisted_sender_is_ignored(self):
        from lighthouse_tpu_torch.network.service import GRAYLIST_THRESHOLD

        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            na.harness.advance_slot(); nb.harness.advance_slot()
            # b graylists a BEFORE the gossip arrives
            info = nb.service.peer_manager._peer("a")
            info.score = GRAYLIST_THRESHOLD - 1
            signed = na.harness.produce_signed_block()
            root = na.chain.process_block(signed, block_delay_seconds=1.0)
            na.publish_block(signed)
            assert not wait_until(lambda: nb.chain.head_root == root,
                                  timeout=1.5)
            # score recovers -> the next message flows again
            info.score = 0.0
            na.harness.advance_slot(); nb.harness.advance_slot()
            nxt = na.harness.produce_signed_block()
            root2 = na.chain.process_block(nxt, block_delay_seconds=1.0)
            na.publish_block(nxt)
            assert wait_until(lambda: nb.chain.head_root == root2, timeout=10.0)
        finally:
            na.shutdown(); nb.shutdown()

    def test_low_scored_peer_excluded_from_publish(self):
        from lighthouse_tpu_torch.network.service import PUBLISH_THRESHOLD

        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            na.harness.advance_slot(); nb.harness.advance_slot()
            # a demotes b below the publish threshold: a's own messages
            # must not reach it
            info = na.service.peer_manager._peer("b")
            info.score = PUBLISH_THRESHOLD - 1
            signed = na.harness.produce_signed_block()
            root = na.chain.process_block(signed, block_delay_seconds=1.0)
            sent = na.publish_block(signed)
            assert not wait_until(lambda: nb.chain.head_root == root,
                                  timeout=1.5)
        finally:
            na.shutdown(); nb.shutdown()


class TestSync:
    def test_range_sync_catches_up(self):
        hub, na, nb = two_nodes()
        try:
            # a builds 2 epochs alone, then b connects and syncs via RPC
            roots = []
            for _ in range(16):
                na.harness.advance_slot()
                nb.harness.advance_slot()
                signed = na.harness.produce_signed_block()
                roots.append(na.chain.process_block(signed, block_delay_seconds=1.0))
            hub.connect("a", "b")
            assert wait_until(lambda: nb.chain.head_root == roots[-1], timeout=20.0)
        finally:
            na.shutdown(); nb.shutdown()

    def test_attestation_triggered_single_block_lookup(self):
        """An attestation to a block b never saw triggers the single-block
        lookup (reference block_lookups/single_block_lookup.rs), importing
        it by root from the sender."""
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            na.harness.advance_slot()
            nb.harness.advance_slot()
            signed = na.harness.produce_signed_block()
            root = na.chain.process_block(signed, block_delay_seconds=1.0)
            # b never hears the block on gossip; hand it the root directly
            nb.sync.lookup_block(root, "a")
            assert nb.chain.get_block(root) is not None
            assert nb.chain.fork_choice.contains_block(root)
        finally:
            na.shutdown(); nb.shutdown()

    def test_parent_lookup_on_gossip_gap(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            # Build 3 blocks on a but only gossip the LAST one; b must fetch
            # the ancestry by root.
            signed_blocks = []
            for _ in range(3):
                na.harness.advance_slot()
                nb.harness.advance_slot()
                signed = na.harness.produce_signed_block()
                na.chain.process_block(signed, block_delay_seconds=1.0)
                signed_blocks.append(signed)
            na.publish_block(signed_blocks[-1])
            want = na.chain.head_root
            assert wait_until(lambda: nb.chain.head_root == want, timeout=20.0)
        finally:
            na.shutdown(); nb.shutdown()


class TestForkTransitionGossip:
    def test_blocks_decode_across_fork_boundary(self):
        """Gossiped blocks on both sides of a scheduled fork must select the
        right container (regression: the slot was read from the wrong SSZ
        offset, always picking the newest fork)."""
        from lighthouse_tpu_torch.types.spec import minimal_spec

        spec = minimal_spec(
            altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=1,
            deneb_fork_epoch=None,
        )
        hub = Hub()
        ha = BeaconChainHarness(validator_count=16, fake_crypto=True, spec=spec,
                                genesis_time=GENESIS_TIME)
        hb = BeaconChainHarness(validator_count=16, fake_crypto=True, spec=spec,
                                genesis_time=GENESIS_TIME)
        na = LocalNode(hub=hub, peer_id="a", harness=ha)
        nb = LocalNode(hub=hub, peer_id="b", harness=hb)
        try:
            hub.connect("a", "b")
            for i in range(10):  # crosses the capella boundary at slot 8
                ha.advance_slot()
                hb.advance_slot()
                signed = ha.produce_signed_block()
                ha.chain.process_block(signed, block_delay_seconds=1.0)
                na.publish_block(signed)
            assert type(ha.chain.get_block(ha.head_root)).fork_name == "capella"
            head = ha.chain.head_root
            assert wait_until(lambda: nb.chain.head_root == head)
        finally:
            na.shutdown(); nb.shutdown()


class TestConvergence:
    def test_four_node_live_following(self):
        """One producer + three followers over a partial mesh stay in
        lock-step across 2 epochs (mini ``basic-sim``)."""
        hub = Hub()
        hs = [
            BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=GENESIS_TIME)
            for _ in range(4)
        ]
        nodes = [LocalNode(hub=hub, peer_id=f"n{i}", harness=h) for i, h in enumerate(hs)]
        try:
            hub.connect("n0", "n1")
            hub.connect("n1", "n2")
            hub.connect("n2", "n3")
            hub.connect("n0", "n3")
            for _ in range(16):
                for h in hs:
                    h.advance_slot()
                signed = hs[0].produce_signed_block()
                hs[0].chain.process_block(signed, block_delay_seconds=1.0)
                hs[0].attest_to_head()
                nodes[0].publish_block(signed)
                head = hs[0].chain.head_root
                assert wait_until(
                    lambda: all(n.chain.head_root == head for n in nodes), timeout=10.0
                )
        finally:
            for n in nodes:
                n.shutdown()


class TestOpGossip:
    """Pool-operation gossip handlers (reference gossip_methods.rs
    process_gossip_voluntary_exit / proposer_slashing / attester_slashing /
    bls_to_execution_change): validate, dedup, pool, forward."""

    def test_exit_propagates_into_peer_pool(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            # an exit valid against the head state needs an old-enough
            # validator: rewind the gate by publishing at epoch 0 with
            # shard_committee_period satisfied via spec on minimal... the
            # harness genesis validators activate at epoch 0, so craft the
            # exit and relax nothing: validity is exercised in
            # test_op_pool; HERE we assert the gossip path end to end with
            # a valid-by-construction exit.
            spec = na.chain.spec
            state = na.chain.head_state
            # make the exit pass process_voluntary_exit: validator must be
            # active and past shard_committee_period epochs since activation
            # — minimal spec shard_committee_period=64 epochs is too long to
            # simulate, so instead drive the handler directly with a
            # monkeypatched verifier to prove pool+forward plumbing, and
            # separately assert the REJECT path penalizes.
            exit_msg = na.chain.types.VoluntaryExit(epoch=0, validator_index=5)
            signed = na.chain.types.SignedVoluntaryExit(
                message=exit_msg, signature=na.harness._canned_sig)
            import lighthouse_tpu_torch.consensus.per_block as pb_mod
            orig = pb_mod.process_voluntary_exit
            pb_mod.process_voluntary_exit = lambda *a, **k: None
            try:
                assert na.chain.on_gossip_voluntary_exit(signed) is True
                # duplicate: dedup'd, not re-verified
                assert na.chain.on_gossip_voluntary_exit(signed) is False
                na.publish_operation("voluntary_exit", signed)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if nb.chain.op_pool._voluntary_exits:
                        break
                    time.sleep(0.05)
            finally:
                pb_mod.process_voluntary_exit = orig
            assert 5 in nb.chain.op_pool._voluntary_exits, (
                "exit gossip never reached the peer's op pool")
        finally:
            na.shutdown()
            nb.shutdown()

    def test_invalid_op_gossip_penalizes_sender(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            # an exit for a validator index that does not exist: REJECT
            exit_msg = na.chain.types.VoluntaryExit(epoch=0, validator_index=9999)
            signed = na.chain.types.SignedVoluntaryExit(
                message=exit_msg, signature=na.harness._canned_sig)
            na.publish_operation("voluntary_exit", signed)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                p = nb.service.peer_manager._peer("a")
                if p is not None and p.score < 0:
                    break
                time.sleep(0.05)
            assert nb.service.peer_manager._peer("a").score < 0, (
                "invalid exit should penalize the sender")
            assert not nb.chain.op_pool._voluntary_exits
        finally:
            na.shutdown()
            nb.shutdown()


class TestSelfRateLimiter:
    """Outbound self-throttle (reference rpc/self_limiter.rs): our own
    request bursts wait for quota instead of tripping the peer's limiter."""

    def test_burst_throttled_but_succeeds(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            from lighthouse_tpu_torch.network import rpc as rpc_mod
            from lighthouse_tpu_torch.network.rate_limiter import Quota, RPCRateLimiter

            # tight quota: 2 status requests per second
            na.service.self_limiter = RPCRateLimiter(
                quotas={rpc_mod.STATUS: Quota(2, 1.0)})
            t0 = time.monotonic()
            for _ in range(4):
                chunks = na.service.request(
                    "b", rpc_mod.STATUS, na.router.local_status(), timeout=5.0)
                assert chunks and chunks[0][0] == rpc_mod.SUCCESS
            elapsed = time.monotonic() - t0
            assert elapsed >= 0.8, (
                f"4 requests against a 2/s self-quota finished in {elapsed:.2f}s "
                "— the self limiter never throttled")
        finally:
            na.shutdown()
            nb.shutdown()

    def test_oversize_request_fatal(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            from lighthouse_tpu_torch.network import rpc as rpc_mod

            huge = rpc_mod.BlocksByRangeRequest(start_slot=0, count=10**6)
            with pytest.raises(rpc_mod.RpcError, match="quota"):
                na.service.request("b", rpc_mod.BLOCKS_BY_RANGE, huge, timeout=2.0)
        finally:
            na.shutdown()
            nb.shutdown()


class TestLightClientRpc:
    """Light-client req/resp (reference rpc/protocol.rs LightClient*V1):
    bootstrap by root, latest optimistic + finality updates."""

    def test_bootstrap_and_updates_served(self):
        hub, na, nb = two_nodes()
        try:
            hub.connect("a", "b")
            from lighthouse_tpu_torch.network import rpc as rpc_mod
            from lighthouse_tpu_torch.network.rate_limiter import Quota

            # production default is 1 request / 10 s per LC protocol (state
            # reads per request); this test makes four back-to-back, so
            # relax BOTH sides' limiters for the duration
            for proto in (rpc_mod.LIGHT_CLIENT_BOOTSTRAP,
                          rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE,
                          rpc_mod.LIGHT_CLIENT_FINALITY_UPDATE):
                na.service.rate_limiter.quotas[proto] = Quota(16, 10.0)
                nb.service.self_limiter.quotas[proto] = Quota(16, 10.0)

            # build a couple of blocks so node A has LC data
            for _ in range(3):
                slot = na.harness.advance_slot()
                nb.harness.advance_slot()
                signed = na.harness.produce_signed_block(slot=slot)
                na.chain.process_block(signed)
            root = na.chain.head_root
            chunks = nb.service.request(
                "a", rpc_mod.LIGHT_CLIENT_BOOTSTRAP,
                rpc_mod.LightClientBootstrapRequest(root=root), timeout=10.0)
            assert chunks and chunks[0][0] == rpc_mod.SUCCESS
            result, payload, context = chunks[0]
            assert context == na.router.fork_digest
            bootstrap = na.chain.produce_light_client_bootstrap(root)
            assert payload == bootstrap.as_ssz_bytes()

            chunks = nb.service.request(
                "a", rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE, None, timeout=10.0)
            assert chunks and chunks[0][0] == rpc_mod.SUCCESS
            assert chunks[0][1] == na.chain.lc_cache.latest_optimistic_update.as_ssz_bytes()

            chunks = nb.service.request(
                "a", rpc_mod.LIGHT_CLIENT_FINALITY_UPDATE, None, timeout=10.0)
            # finality update may be unavailable before any finalization
            assert chunks[0][0] in (rpc_mod.SUCCESS, rpc_mod.RESOURCE_UNAVAILABLE)

            # unknown root: RESOURCE_UNAVAILABLE, not an error teardown
            chunks = nb.service.request(
                "a", rpc_mod.LIGHT_CLIENT_BOOTSTRAP,
                rpc_mod.LightClientBootstrapRequest(root=b"\xee" * 32),
                timeout=10.0)
            assert chunks[0][0] == rpc_mod.RESOURCE_UNAVAILABLE
        finally:
            na.shutdown()
            nb.shutdown()


def test_goodbye_on_shutdown():
    """A shutting-down node says Goodbye(1): the peer disconnects it
    cleanly instead of scoring a dead connection."""
    hub, na, nb = two_nodes()
    try:
        hub.connect("a", "b")
        time.sleep(0.3)
        assert "a" in nb.service.endpoint.connected_peers()
        na.shutdown()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if "a" not in nb.service.endpoint.connected_peers():
                break
            time.sleep(0.05)
        assert "a" not in nb.service.endpoint.connected_peers()
        # a clean goodbye is not misbehavior
        p = nb.service.peer_manager._peer("a")
        assert p is None or p.score >= 0
    finally:
        nb.shutdown()


# --------------------- the JAX package's test_subnet_service.py cases


@pytest.fixture(scope="module")
def spec():
    return minimal_spec()


def test_backbone_is_deterministic_and_rotates(spec):
    node_id = int.from_bytes(b"\x5a" * 32, "big")
    subnets = compute_subscribed_subnets(node_id, epoch=10, spec=spec)
    assert len(subnets) == SUBNETS_PER_NODE
    assert all(0 <= s < spec.attestation_subnet_count for s in subnets)
    # stable across epochs within the same subscription period
    offset = node_id % EPOCHS_PER_SUBNET_SUBSCRIPTION
    for e in (10, 10 + 5):
        if (e + offset) // EPOCHS_PER_SUBNET_SUBSCRIPTION == (
                10 + offset) // EPOCHS_PER_SUBNET_SUBSCRIPTION:
            assert compute_subscribed_subnets(node_id, e, spec) == subnets
    # deterministic coverage: many node ids spread over MANY subnets — the
    # whole point of node-id-keyed backbones (a degenerate shuffle would
    # park everyone on the same two)
    union = set()
    for i in range(32):
        union.update(compute_subscribed_subnets(
            int.from_bytes(bytes([i]) * 32, "big"), 10, spec))
    assert len(union) > SUBNETS_PER_NODE * 4
    # rotation: across many periods the set eventually changes
    assert any(
        compute_subscribed_subnets(
            node_id, 10 + k * EPOCHS_PER_SUBNET_SUBSCRIPTION, spec) != subnets
        for k in range(1, 6)
    )


def _mk(spec, subscribe_all=False):
    hub = Hub()
    svc = NetworkService(hub.register("subnet-node"))
    sub = SubnetService(service=svc, digest=b"\x00\x01\x02\x03", spec=spec,
                        node_id=int.from_bytes(b"\x77" * 32, "big"),
                        subscribe_all=subscribe_all)
    return svc, sub


def test_subscribe_all_mode(spec):
    svc, sub = _mk(spec, subscribe_all=True)
    try:
        att_topics = [t for t in svc.subscriptions if "beacon_attestation_" in t]
        assert len(att_topics) == spec.attestation_subnet_count
        assert sub.update_epoch(5) == sorted(range(spec.attestation_subnet_count))
    finally:
        svc.shutdown()


def test_backbone_subscriptions_applied_and_rotated(spec):
    svc, sub = _mk(spec)
    try:
        active = sub.update_epoch(0)
        topics = {t for t in svc.subscriptions if "beacon_attestation_" in t}
        assert len(topics) == len(active) == SUBNETS_PER_NODE
        for s in active:
            assert any(t.endswith(f"beacon_attestation_{s}/ssz_snappy")
                       for t in topics)
        # forcing a rotation far in the future swaps the set cleanly
        sub.update_epoch(10 * EPOCHS_PER_SUBNET_SUBSCRIPTION)
        topics2 = {t for t in svc.subscriptions if "beacon_attestation_" in t}
        assert len(topics2) == SUBNETS_PER_NODE
    finally:
        svc.shutdown()


def test_duty_subscription_lifecycle(spec):
    svc, sub = _mk(spec)
    try:
        sub.update_epoch(0)
        backbone = set(sub.active_attestation_subnets())
        # choose an entry whose subnet is OUTSIDE the backbone
        slot, committees_at_slot = 3, 4
        target = None
        for ci in range(spec.attestation_subnet_count):
            subnet = (committees_at_slot * (slot % spec.slots_per_epoch) + ci) \
                % spec.attestation_subnet_count
            if subnet not in backbone:
                target = (ci, subnet)
                break
        ci, subnet = target
        n = sub.on_committee_subscriptions([
            {"validator_index": "1", "committee_index": str(ci),
             "committees_at_slot": str(committees_at_slot), "slot": str(slot),
             "is_aggregator": True},
            {"validator_index": "2", "committee_index": str(ci),
             "committees_at_slot": str(committees_at_slot), "slot": str(slot),
             "is_aggregator": False},  # non-aggregators don't subscribe
        ])
        assert n == 1
        topic = f"beacon_attestation_{subnet}/ssz_snappy"
        assert any(t.endswith(topic) for t in svc.subscriptions)
        # expiry: pruning after the duty slot unsubscribes
        sub.prune(current_slot=slot + 1)
        assert not any(t.endswith(topic) for t in svc.subscriptions)
        # backbone untouched by pruning
        assert sub.active_attestation_subnets() == backbone
    finally:
        svc.shutdown()


def test_sync_subscription_until_epoch(spec):
    svc, sub = _mk(spec)
    try:
        n = sub.on_sync_committee_subscriptions([
            {"validator_index": "7", "sync_committee_indices": ["0"],
             "until_epoch": "2"},
        ])
        assert n == 1
        assert any("sync_committee_0" in t for t in svc.subscriptions)
        sub.prune(current_slot=2 * spec.slots_per_epoch)  # epoch 2 reached
        assert not any("sync_committee_0" in t for t in svc.subscriptions)
    finally:
        svc.shutdown()


def test_attnets_bitfield_and_predicate(spec):
    """The JAX package's case on a stand-in record: the predicate reads only
    the record's ``attnets`` entry (signed ENRs come with ``discv5/``)."""
    from lighthouse_tpu_torch.network.subnet_service import (
        attnets_bitfield,
        enr_attnets,
        subnet_predicate,
    )

    bits = attnets_bitfield({3, 17, 63})
    assert len(bits) == 8
    enr = SimpleNamespace(pairs={b"attnets": bits})
    assert enr_attnets(enr) == {3, 17, 63}
    assert subnet_predicate(enr, {17, 40})
    assert not subnet_predicate(enr, {4, 40})
    assert subnet_predicate(enr, set())  # nothing wanted: everyone matches
    # pre-fork records without the field never hard-fail
    bare = SimpleNamespace(pairs={})
    assert enr_attnets(bare) == set()
    assert not subnet_predicate(bare, {1})


# ----------- the JAX package's test_decoder_robustness.py, pb and snappy


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
        else:  # splice a random window
            if data:
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
        # anything else (IndexError, KeyError, struct.error, ...) propagates
        # and fails the test with the offending input visible in the repr


class TestGossipPbDecoder:
    def test_rpc_random_and_mutated(self):
        rng = random.Random(SEED + 3)
        _assert_clean(pb.RPC.decode, _random_inputs(rng), (pb.PbError,))
        valid = pb.RPC(
            publish=[pb.Message(data=b"payload", topic="topic/x")]
        ).encode()
        _assert_clean(pb.RPC.decode, _mutations(rng, valid), (pb.PbError,))


class TestSnappyDecoders:
    def test_raw_random_and_mutated(self):
        rng = random.Random(SEED + 4)
        _assert_clean(
            snappy_codec.decompress, _random_inputs(rng), (snappy_codec.SnappyError,)
        )
        valid = snappy_codec.compress(bytes(range(256)) * 8)
        _assert_clean(
            snappy_codec.decompress, _mutations(rng, valid), (snappy_codec.SnappyError,)
        )

    def test_frames_random_and_mutated(self):
        rng = random.Random(SEED + 5)
        _assert_clean(
            snappy_codec.frame_decompress,
            _random_inputs(rng),
            (snappy_codec.SnappyError,),
        )
        valid = snappy_codec.frame_compress(b"block body bytes " * 64)
        _assert_clean(
            snappy_codec.frame_decompress,
            _mutations(rng, valid),
            (snappy_codec.SnappyError,),
        )


# --------------- the JAX package's test_da.py cases that need LocalNode


def _blob(i: int) -> bytes:
    return b"".join(((i * WIDTH + j) % 251).to_bytes(32, "big") for j in range(WIDTH))


@pytest.fixture(scope="module")
def setup():
    return TrustedSetup.insecure_dev_setup(width=WIDTH)


def test_blob_gossip_completes_pending_block(setup):
    """Two nodes on the hub: the block arrives before its blobs; the blob
    sidecars complete availability and trigger the deferred import."""
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.transport import Hub

    set_backend("fake")
    try:
        spec = minimal_spec(
            preset=PRESET,
            altair_fork_epoch=0, bellatrix_fork_epoch=0,
            capella_fork_epoch=0, deneb_fork_epoch=0,
        )
        mk = lambda: BeaconChainHarness(
            validator_count=16, spec=spec, fake_crypto=True, kzg=Kzg(setup, device="cpu")
        )
        ha, hb = mk(), mk()
        hub = Hub()
        na = LocalNode(hub=hub, peer_id="a", harness=ha)
        nb = LocalNode(hub=hub, peer_id="b", harness=hb)
        try:
            hub.connect("a", "b")
            ha.advance_slot()
            hb.advance_slot()
            signed, sidecars = ha.produce_signed_block_with_blobs([_blob(8), _blob(9)])
            ha.chain.process_block_with_blobs(signed, sidecars)
            root = signed.message.hash_tree_root()

            import time

            def wait_until(cond, timeout=15.0):
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    if cond():
                        return True
                    time.sleep(0.05)
                return cond()

            na.publish_block(signed)  # b: pending availability
            na.wait_idle()
            nb.wait_idle()
            for sc in sidecars:
                na.publish_blob_sidecar(sc)
            # the service loop may be mid-sync-handshake; poll for the import
            assert wait_until(lambda: hb.chain.get_block(root) is not None), (
                "blobs must complete the deferred import"
            )
            # sidecar storage lands a hair after block visibility: poll
            assert wait_until(
                lambda: [int(s.index) for s in hb.chain.get_blobs(root)] == [0, 1]
            ), "imported blob block must expose its sidecars"
        finally:
            na.shutdown()
            nb.shutdown()
    finally:
        set_backend("host")


def test_range_sync_fetches_blobs(setup):
    """A fresh node range-syncing a chain that CONTAINS blob blocks pulls
    sidecars over BlobsByRoot and imports with availability intact
    (reference network_context.rs block+blob coupling)."""
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.transport import Hub

    set_backend("fake")
    try:
        spec = minimal_spec(
            preset=PRESET,
            altair_fork_epoch=0, bellatrix_fork_epoch=0,
            capella_fork_epoch=0, deneb_fork_epoch=0,
        )
        mk = lambda: BeaconChainHarness(
            validator_count=16, spec=spec, fake_crypto=True, kzg=Kzg(setup, device="cpu")
        )
        ha, hb = mk(), mk()
        # chain with a blob block in the middle
        ha.extend_chain(2)
        ha.advance_slot()
        signed, sidecars = ha.produce_signed_block_with_blobs([_blob(3), _blob(4)])
        ha.chain.process_block_with_blobs(signed, sidecars)
        blob_root = signed.message.hash_tree_root()
        ha.extend_chain(2)
        for _ in range(5):
            hb.advance_slot()  # same wall clock on the fresh side

        hub = Hub()
        na = LocalNode(hub=hub, peer_id="a2", harness=ha)
        nb = LocalNode(hub=hub, peer_id="b2", harness=hb)
        try:
            hub.connect("a2", "b2")  # status exchange triggers range sync
            import time

            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if hb.chain.head_root == ha.chain.head_root:
                    break
                time.sleep(0.1)
            assert hb.chain.head_root == ha.chain.head_root, "sync did not complete"
            assert hb.chain.get_block(blob_root) is not None
            assert [int(s.index) for s in hb.chain.get_blobs(blob_root)] == [0, 1], (
                "synced node must hold the blob sidecars it fetched"
            )
        finally:
            na.shutdown()
            nb.shutdown()
    finally:
        set_backend("host")


def test_backfill_fetches_blobs_in_retention_window(setup):
    """Checkpoint-synced node backfills a blob block: sidecars come over
    BlobsByRoot, authenticated by commitment equality against the
    hash-chain-verified block."""
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain, genesis_block_root_of
    from lighthouse_tpu_torch.network.backfill import BackfillSync
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.transport import Hub

    set_backend("fake")
    try:
        spec = minimal_spec(
            preset=PRESET,
            altair_fork_epoch=0, bellatrix_fork_epoch=0,
            capella_fork_epoch=0, deneb_fork_epoch=0,
        )
        ha = BeaconChainHarness(
            validator_count=16, spec=spec, fake_crypto=True, kzg=Kzg(setup, device="cpu")
        )
        # history: 2 plain blocks, then a blob block, then 2 more
        ha.extend_chain(2)
        ha.advance_slot()
        signed, sidecars = ha.produce_signed_block_with_blobs([_blob(5)])
        ha.chain.process_block_with_blobs(signed, sidecars)
        blob_root = signed.message.hash_tree_root()
        ha.extend_chain(2)

        # checkpoint-boot a fresh node from the current head
        anchor_root = ha.chain.head_root
        anchor_block = ha.chain.get_block(anchor_root)
        anchor_state = ha.chain.get_state(anchor_root).copy()
        from lighthouse_tpu_torch.chain.slot_clock import ManualSlotClock

        chain_b = BeaconChain(
            genesis_state=anchor_state,
            types=ha.types, spec=spec,
            slot_clock=ManualSlotClock(
                int(anchor_state.genesis_time), spec.seconds_per_slot
            ),
            kzg=Kzg(setup, device="cpu"),
            anchor_block=anchor_block,
        )
        chain_b.slot_clock.set_slot(int(anchor_state.slot))
        hub = Hub()
        na = LocalNode(hub=hub, peer_id="bf-a", harness=ha)
        nb = LocalNode(hub=hub, peer_id="bf-b", chain=chain_b)
        try:
            hub.connect("bf-a", "bf-b")
            backfill = BackfillSync(chain=chain_b, service=nb.service)
            filled = backfill.backfill_from("bf-a")
            assert filled == 4  # blocks 1..4 behind the anchor at slot 5
            assert chain_b.db.get_block(blob_root) is not None
            got = chain_b.get_blobs(blob_root)
            assert [int(s.index) for s in got] == [0], (
                "backfill must fetch the blob sidecars in the retention window"
            )
        finally:
            na.shutdown()
            nb.shutdown()
    finally:
        set_backend("host")


# ------------- the JAX package's test_block_streamer.py router case


@pytest.fixture()
def blinded_harness():
    set_backend("fake")
    h = BeaconChainHarness(validator_count=16, fake_crypto=True)
    h.chain.store_payloads = False  # persist post-merge blocks blinded
    yield h
    set_backend("host")


def _evict(chain, root):
    """Simulate a cache miss: the store (blinded) copy is the only one."""
    chain._blocks.pop(root, None)
    chain.early_attester_cache.clear()


def test_blocks_by_range_streams_reconstructed(blinded_harness):
    from lighthouse_tpu_torch.network import rpc as rpc_mod
    from lighthouse_tpu_torch.network.router import Router

    harness = blinded_harness
    chain = harness.chain
    harness.extend_chain(4)
    for root in list(chain._blocks):
        _evict(chain, root)

    service = SimpleNamespace(peer_manager=SimpleNamespace(report=lambda *a: None))
    router = Router(chain=chain, service=service)
    try:
        req = rpc_mod.BlocksByRangeRequest(start_slot=1, count=4)
        chunks = router._serve_blocks_by_range(req, "peer-a")
        assert len(chunks) >= 3
        for chunk in chunks:
            code, data, _, _ = rpc_mod.decode_response_chunk(chunk, has_context=True)
            assert code == rpc_mod.SUCCESS
            slot = int.from_bytes(data[100:108], "little")
            fork = chain.spec.fork_name_at_slot(slot)
            block = chain.types.signed_block[fork].from_ssz_bytes(data)
            # full block: payload present with its real block_hash
            assert any(bytes(block.message.body.execution_payload.block_hash))
    finally:
        router.processor.shutdown()
