"""The port's router and gossip batch path (``network/router.py``) vs the
JAX package's.

``Router._process_gossip_attestations`` is the seam a node's gossip
attestations and aggregates drain through: decode, dedup against the
observed caches, preverify, one ``verify_signature_sets`` call for the
drained batch, the per-item fallback, the slasher feed, apply and forward.
Here:

- parity: the same gossip items (unaggregated attestations, one under
  another member's key, duplicates, aggregates valid, forged and with an
  aggregator outside the committee, undecodable bytes, a vote for an unknown
  block) through both packages' routers on the fake and on the host
  backends give the same outcomes: the same rejections with the same
  reasons, the same forwards, the same pool bytes, observed caches,
  fork-choice votes and peer scores;
- the JAX package's ``test_gossip_batch.py`` cases, re-pointed at the port
  (the real-crypto ones on the host backend, as there).
  ``test_lazy_peers_pull_via_iwant`` waits for the meshes before it
  publishes (see its docstring).
"""

import time

import pytest

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.network.node import LocalNode as JLocalNode  # noqa: E402
from lighthouse_tpu.network.transport import Hub as JHub  # noqa: E402
from lighthouse_tpu_torch import metrics  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.network import topics as topics_mod  # noqa: E402
from lighthouse_tpu_torch.network.node import LocalNode  # noqa: E402
from lighthouse_tpu_torch.network.snappy_codec import compress  # noqa: E402
from lighthouse_tpu_torch.network.transport import Hub  # noqa: E402
from test_torch_chain import one_torch_thread, port_cpu  # noqa: E402,F401

GENESIS_TIME = 1_600_000_000


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _mk_node(fake=True):
    harness = BeaconChainHarness(
        validator_count=16, fake_crypto=fake, genesis_time=GENESIS_TIME
    )
    hub = Hub()
    node = LocalNode(hub=hub, peer_id="n0", harness=harness)
    return harness, node


def _attestation_items(harness, node, slot, committee_index=0, tamper=()):
    """Build gossip items (topic, uncompressed, compressed, sender) — one
    single-attester attestation per committee member."""
    chain = harness.chain
    state, _ = (
        chain.state_at_slot(slot)
        if int(chain.head_state.slot) < slot
        else (chain.head_state, chain.head_root)
    )
    committee = h.get_beacon_committee(state, slot, committee_index, harness.spec)
    data = chain.produce_attestation_data(slot, committee_index)
    subnet = topics_mod.compute_subnet_for_attestation(
        state, slot, committee_index, harness.spec
    )
    topic = str(topics_mod.attestation_subnet_topic(node.router.fork_digest, subnet))
    items = []
    for pos, vidx in enumerate(committee):
        bits = [False] * len(committee)
        bits[pos] = True
        sig = harness.sign_attestation_data(state, data, int(vidx)).to_bytes()
        if pos in tamper:
            # valid G2 point, wrong signer => passes deserialization, fails
            # cryptographic verification (exercises the batch fallback)
            wrong = committee[(pos + 1) % len(committee)]
            sig = harness.sign_attestation_data(state, data, int(wrong)).to_bytes()
        att = harness.types.Attestation(
            aggregation_bits=bits, data=data, signature=sig
        )
        raw = att.as_ssz_bytes()
        items.append((topic, raw, compress(raw), "peer-x"))
    return items, committee


def test_one_device_batch_per_drained_batch():
    """N attestations in one drained batch => exactly ONE backend invocation
    (the padded device program), asserted via the batch counters."""
    set_backend("fake")
    try:
        harness, node = _mk_node(fake=True)
        slot = harness.advance_slot()
        items, committee = _attestation_items(harness, node, slot)
        assert len(items) >= 2

        before_inv = metrics.DEVICE_BATCH_INVOCATIONS.get()
        before_sets = metrics.SIGNATURE_SETS_VERIFIED.get()
        node.router._process_gossip_attestations(items)
        assert metrics.DEVICE_BATCH_INVOCATIONS.get() - before_inv == 1
        assert metrics.SIGNATURE_SETS_VERIFIED.get() - before_sets == len(items)
        # all applied to the pool
        assert len(harness.chain.attestation_pool._pool) == 1
        agg = next(iter(harness.chain.attestation_pool._pool.values()))
        assert sum(agg.aggregation_bits) == len(items)
    finally:
        set_backend("host")


def test_observed_cache_dedup_blocks_replay():
    """A replayed batch does no signature work at all (DoS defense)."""
    set_backend("fake")
    try:
        harness, node = _mk_node(fake=True)
        slot = harness.advance_slot()
        items, _ = _attestation_items(harness, node, slot)
        node.router._process_gossip_attestations(items)
        before = metrics.DEVICE_BATCH_INVOCATIONS.get()
        node.router._process_gossip_attestations(items)  # replay
        assert metrics.DEVICE_BATCH_INVOCATIONS.get() == before, (
            "replayed attestations must be dropped by the observed caches "
            "before any backend call"
        )
    finally:
        set_backend("host")


def test_fidelity_fallback_isolates_bad_items():
    """Real crypto: a batch with one bad signature fails as a whole, falls
    back to per-item verification, and only the bad item is dropped."""
    set_backend("host")
    harness, node = _mk_node(fake=False)
    slot = harness.advance_slot()
    items, committee = _attestation_items(harness, node, slot, tamper={1})

    before_inv = metrics.DEVICE_BATCH_INVOCATIONS.get()
    node.router._process_gossip_attestations(items)
    # 1 batch call + len(items) individual fallback calls
    assert metrics.DEVICE_BATCH_INVOCATIONS.get() - before_inv == 1 + len(items)
    agg = next(iter(harness.chain.attestation_pool._pool.values()))
    assert sum(agg.aggregation_bits) == len(items) - 1, (
        "exactly the tampered attestation must be rejected"
    )
    # the bad item's sender was penalized
    pm = node.service.peer_manager
    assert pm._peer("peer-x").score < 0


def test_equivocating_proposer_penalized():
    """Two distinct blocks from the same (slot, proposer) via gossip: the
    second is an equivocation — dropped and penalized, never imported."""
    set_backend("fake")
    try:
        harness, node = _mk_node(fake=True)
        slot = harness.advance_slot()
        b1 = harness.produce_signed_block(slot=slot, graffiti=b"\x01" * 32)
        b2 = harness.produce_signed_block(slot=slot, graffiti=b"\x02" * 32)
        assert b1.message.hash_tree_root() != b2.message.hash_tree_root()
        topic = str(
            topics_mod.GossipTopic(node.router.fork_digest, topics_mod.BEACON_BLOCK)
        )
        raw1, raw2 = b1.as_ssz_bytes(), b2.as_ssz_bytes()
        node.router._process_gossip_block(topic, raw1, compress(raw1), "peer-a")
        assert harness.chain.head_root == b1.message.hash_tree_root()
        node.router._process_gossip_block(topic, raw2, compress(raw2), "peer-b")
        assert harness.chain.get_block(b2.message.hash_tree_root()) is None
        assert node.service.peer_manager._peer("peer-b").score < 0
    finally:
        set_backend("host")


# --------------------------------------------------------------- aggregates


def _mk_signed_aggregate(harness, state, slot, committee_index=0,
                         aggregator_pos=0, signer_pos=None):
    """A full SignedAggregateAndProof over the whole committee.  With
    ``signer_pos`` set, the selection proof + outer signature are produced by
    a DIFFERENT key than ``aggregator_pos`` claims — a forged wrap."""
    from lighthouse_tpu_torch.crypto.bls import api as bls
    from lighthouse_tpu_torch.types.spec import (
        DOMAIN_AGGREGATE_AND_PROOF,
        DOMAIN_SELECTION_PROOF,
    )
    from lighthouse_tpu_torch.types.ssz import UintType

    chain = harness.chain
    committee = h.get_beacon_committee(state, slot, committee_index, harness.spec)
    data = chain.produce_attestation_data(slot, committee_index)
    epoch = slot // harness.spec.slots_per_epoch

    agg_sig = None
    for vidx in committee:
        s = harness.sign_attestation_data(state, data, int(vidx))
        if agg_sig is None:
            agg_sig = bls.AggregateSignature.from_bytes(s.to_bytes())
        else:
            agg_sig.add_assign(s)
    attestation = harness.types.Attestation(
        aggregation_bits=[True] * len(committee), data=data,
        signature=agg_sig.to_bytes(),
    )

    aggregator = int(committee[aggregator_pos])
    signer = aggregator if signer_pos is None else int(committee[signer_pos])
    sel_domain = harness._domain_at(state, DOMAIN_SELECTION_PROOF, epoch)
    sel_root = h.compute_signing_root(UintType(8).hash_tree_root(slot), sel_domain)
    selection_proof = harness._sign(signer, sel_root).to_bytes()

    message = harness.types.AggregateAndProof(
        aggregator_index=aggregator, aggregate=attestation,
        selection_proof=selection_proof,
    )
    out_domain = harness._domain_at(state, DOMAIN_AGGREGATE_AND_PROOF, epoch)
    out_root = h.compute_signing_root(message.hash_tree_root(), out_domain)
    signed = harness.types.SignedAggregateAndProof(
        message=message, signature=harness._sign(signer, out_root).to_bytes()
    )
    return signed, attestation, aggregator


def _agg_items(node, signed):
    topic = str(topics_mod.GossipTopic(
        node.router.fork_digest, topics_mod.BEACON_AGGREGATE_AND_PROOF
    ))
    raw = signed.as_ssz_bytes()
    return [(topic, raw, compress(raw), "peer-x")]


def test_valid_aggregate_verified_and_observed():
    """Real crypto: a spec-valid SignedAggregateAndProof passes the full
    3-set verification and records the aggregator as observed."""
    set_backend("host")
    harness, node = _mk_node(fake=False)
    slot = harness.advance_slot()
    state, _ = harness.chain.state_at_slot(slot)
    signed, attestation, aggregator = _mk_signed_aggregate(harness, state, slot)

    node.router._process_gossip_attestations(_agg_items(node, signed))
    epoch = int(attestation.data.target.epoch)
    assert harness.chain.observed.aggregators.is_known(epoch, aggregator)
    assert len(harness.chain.attestation_pool._pool) == 1


def test_forged_aggregate_wrap_cannot_censor_honest_aggregator():
    """A peer re-wrapping a public aggregate
    under a victim's aggregator_index (with signatures it cannot produce)
    must NOT mark the victim as having aggregated — and the victim's real
    aggregate must still be accepted afterwards."""
    set_backend("host")
    harness, node = _mk_node(fake=False)
    slot = harness.advance_slot()
    state, _ = harness.chain.state_at_slot(slot)
    # Attacker (position 1) wraps the aggregate claiming victim (position 0).
    forged, attestation, victim = _mk_signed_aggregate(
        harness, state, slot, aggregator_pos=0, signer_pos=1
    )
    node.router._process_gossip_attestations(_agg_items(node, forged))
    epoch = int(attestation.data.target.epoch)
    assert not harness.chain.observed.aggregators.is_known(epoch, victim), (
        "a forged wrap must never mark the victim aggregator as observed"
    )
    assert node.service.peer_manager._peer("peer-x").score < 0

    # The victim's genuine aggregate still goes through.
    genuine, _, _ = _mk_signed_aggregate(harness, state, slot, aggregator_pos=0)
    node.router._process_gossip_attestations(_agg_items(node, genuine))
    assert harness.chain.observed.aggregators.is_known(epoch, victim)


def test_aggregator_outside_committee_rejected():
    """An aggregator_index not in the attestation's committee is rejected
    before any signature work (spec gossip condition)."""
    set_backend("host")
    harness, node = _mk_node(fake=False)
    slot = harness.advance_slot()
    state, _ = harness.chain.state_at_slot(slot)
    signed, attestation, _ = _mk_signed_aggregate(harness, state, slot)
    committee = {int(i) for i in h.get_beacon_committee(state, slot, 0, harness.spec)}
    outsider = next(i for i in range(harness.validator_count) if i not in committee)
    signed.message.aggregator_index = outsider

    before = metrics.DEVICE_BATCH_INVOCATIONS.get()
    node.router._process_gossip_attestations(_agg_items(node, signed))
    assert metrics.DEVICE_BATCH_INVOCATIONS.get() == before
    epoch = int(attestation.data.target.epoch)
    assert not harness.chain.observed.aggregators.is_known(epoch, outsider)
    assert node.service.peer_manager._peer("peer-x").score < 0


# ------------------------------------------------------------ gossip mesh


def test_mesh_split_is_bounded_and_stable():
    """eager_lazy_split is the split _disseminate actually uses."""
    from lighthouse_tpu_torch.network.service import LAZY_DEGREE, MESH_DEGREE, NetworkService

    harness, node = _mk_node(fake=True)
    svc = node.service
    peers = [f"p{i:02d}" for i in range(20)]
    eager, lazy = svc.eager_lazy_split("topic-a", peers, grafted=())
    assert len(eager) == MESH_DEGREE and len(lazy) == LAZY_DEGREE
    assert set(eager).isdisjoint(lazy)
    # stable: the same split every call
    assert svc.eager_lazy_split("topic-a", peers, grafted=()) == (eager, lazy)
    # different topics pick different meshes (load spreading)
    eager_b, _ = svc.eager_lazy_split("topic-b", peers, grafted=())
    assert eager_b != eager
    # grafted mesh members always receive the full message, and top-up
    # only fills the remaining degree
    grafted = set(peers[:3])
    eager_g, lazy_g = svc.eager_lazy_split("topic-a", peers, grafted)
    assert grafted <= set(eager_g) and len(eager_g) == MESH_DEGREE
    assert set(eager_g).isdisjoint(lazy_g)


def test_lazy_peers_pull_via_iwant():
    """A 14-node clique: the publisher eagerly pushes to its mesh only —
    bounded by gossipsub v1.1's D_high (inbound GRAFTs legitimately grow
    the mesh past D until the heartbeat prunes at D_high) — strictly fewer
    than its 13 connected peers, so dissemination is NOT a flood; every
    node still converges on the block (mesh push + IHAVE -> IWANT pull).

    The JAX package's case publishes as soon as the block is imported; on
    a loaded machine all 13 peers can graft the publisher before its next
    heartbeat prunes the mesh back under D_high, and 13 pushes fail the
    bound.  Here the publish waits for the meshes (a deadline, no fixed
    sleep)."""
    from lighthouse_tpu_torch.network.service import MESH_DEGREE_HIGH

    n_nodes = 14
    set_backend("fake")
    try:
        hub = Hub()
        harnesses = []
        nodes = []
        for i in range(n_nodes):
            hs = BeaconChainHarness(
                validator_count=16, fake_crypto=True, genesis_time=GENESIS_TIME
            )
            harnesses.append(hs)
            nodes.append(LocalNode(hub=hub, peer_id=f"m{i:02d}", harness=hs))
        try:
            for i in range(n_nodes):
                for j in range(i + 1, n_nodes):
                    hub.connect(f"m{i:02d}", f"m{j:02d}")
            for hs in harnesses:
                hs.advance_slot()
            signed = harnesses[0].produce_signed_block(slot=1)
            root = signed.message.hash_tree_root()
            harnesses[0].chain.process_block(signed)
            # Inbound GRAFTs grow the publisher's mesh past D_high until its
            # next heartbeat prunes it (gossipsub v1.1); publish once every
            # node has grafted its mesh and the publisher's is within D_high.
            topic = str(topics_mod.GossipTopic(nodes[0].router.fork_digest,
                                               topics_mod.BEACON_BLOCK))
            assert wait_until(
                lambda: all(n.service.mesh.get(topic) for n in nodes)
                and len(nodes[0].service.mesh[topic]) <= MESH_DEGREE_HIGH,
                timeout=15.0), "the meshes did not form"
            sent = nodes[0].publish_block(signed)
            assert sent <= MESH_DEGREE_HIGH < n_nodes - 1, (
                f"publisher eagerly pushed to {sent} peers (flood, not mesh)"
            )
            import time

            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if all(h.chain.get_block(root) is not None for h in harnesses):
                    break
                time.sleep(0.1)
            missing = [n.peer_id for n, h in zip(nodes, harnesses)
                       if h.chain.get_block(root) is None]
            assert not missing, f"nodes never received the block: {missing}"
        finally:
            for n in nodes:
                n.shutdown()
    finally:
        set_backend("host")


def test_broken_gossip_promise_penalized():
    """A peer that advertises via IHAVE but never answers our IWANT is
    penalized (gossipsub v1.1 gossip_promises.rs)."""
    import time as _time

    from lighthouse_tpu_torch.network.service import IWANT_RETRY_SECS, NetworkService
    from lighthouse_tpu_torch.network.transport import Envelope, Hub

    hub = Hub()
    svc = NetworkService(hub.register("victim"))
    liar = hub.register("liar")
    hub.connect("victim", "liar")
    try:
        svc.subscribe("topic-p")
        # a fabricated IHAVE for a message the liar will never serve
        svc.endpoint.inbound.put(Envelope(
            kind="ihave", sender="liar", topic="topic-p", data=b"\x42" * 20))
        deadline = _time.monotonic() + IWANT_RETRY_SECS + 5
        while _time.monotonic() < deadline:
            if svc.peer_manager.score("liar") < 0:
                break
            _time.sleep(0.2)
        assert svc.peer_manager.score("liar") < 0, (
            "unfulfilled IHAVE advert was never penalized")
        # and the IWANT actually went out to the advertiser (skipping
        # subscription/mesh control envelopes sent on connect)
        deadline = _time.monotonic() + 5
        got = None
        while _time.monotonic() < deadline:
            env = liar.inbound.get(timeout=1)
            if env.kind == "iwant":
                got = env
                break
        assert got is not None and got.data == b"\x42" * 20
    finally:
        svc.shutdown()


# ------------------------------------------------------- parity, outcomes


def _router_outcomes(node, chain, batches) -> dict:
    """Each batch of ``batches`` through ``node``'s router, recording every
    rejection (sender, reason), every forward (topic, bytes, excluded peer)
    and the chain's pool, observed caches, votes and peer scores after."""
    rejected, forwarded = [], []
    service = node.service
    service.reject_gossip = lambda sender, topic, reason, **kw: rejected.append(
        (sender, topic.split("/")[3], reason, kw.get("penalize", True)))
    service.forward = lambda topic, compressed, exclude, **kw: forwarded.append(
        (topic.split("/")[3], compressed, exclude))
    for items in batches:
        node.router._process_gossip_attestations(items)
    observed = chain.observed
    votes = chain.fork_choice.votes
    return {
        "rejected": rejected, "forwarded": forwarded,
        "pool": sorted((k, v.as_ssz_bytes()) for k, v in chain.attestation_pool._pool.items()),
        "attesters": {e: sorted(s) for e, s in observed.attesters._seen.items()},
        "aggregators": {e: sorted(s) for e, s in observed.aggregators._seen.items()},
        "aggregates": {s: sorted(r) for s, r in observed.aggregates._seen.items()},
        "votes": (list(votes.next_epoch), [chain.fork_choice.proto.nodes[i].root
                                           if i >= 0 else None for i in votes.next_root_id]),
        "scores": {p: service.peer_manager.score(p) for p in ("peer-x", "peer-y", "peer-z")},
    }


def _gossip_batches(harness, node, fake: bool) -> list:
    """Two drained batches: first a mixed one (a committee's attestations,
    one of them under another member's key, a duplicate, undecodable bytes,
    a valid aggregate, with fake crypto a wrap of it signed by another
    member, an aggregate whose aggregator is outside the committee, an exact
    duplicate of the valid one), then the whole first batch replayed."""
    slot = harness.advance_slot()
    items, committee = _attestation_items(harness, node, slot, tamper={1})
    state, _ = harness.chain.state_at_slot(slot)
    valid, _, _ = _mk_signed_aggregate(harness, state, slot, committee_index=0)
    forged, _, _ = _mk_signed_aggregate(harness, state, slot, committee_index=0,
                                        aggregator_pos=1, signer_pos=0)
    outsider, _, _ = _mk_signed_aggregate(harness, state, slot)
    members = {int(i) for i in committee}
    outsider.message.aggregator_index = next(
        i for i in range(harness.validator_count) if i not in members)
    agg = _agg_items(node, valid)[0]
    wrap = _agg_items(node, forged)[0][:3] + ("peer-y",)
    out = _agg_items(node, outsider)[0][:3] + ("peer-z",)
    junk = (items[0][0], b"\x00" * 11, compress(b"\x00" * 11), "peer-y")
    # The forged wrap's refusal needs real signatures; on the host backend
    # it is left out to keep the per-item pairings few (the tampered item
    # takes the batch down the fallback all the same).
    first = items + [items[0], junk, agg] + ([wrap] if fake else []) + [out, agg]
    return [first, first]


@pytest.mark.parametrize("backend", ["fake", "host"])
def test_router_outcomes_match_jax(backend):
    """The same gossip items through both packages' routers, on the fake
    and on the host BLS backend: the same rejections with the same reasons,
    the same forwards, and the same pool, observed caches, fork-choice
    votes and peer scores."""
    fake = backend == "fake"
    prev = jbackends.backend_name()
    jbackends.set_backend(backend)
    try:
        jhs = JHarness(validator_count=16, fake_crypto=fake, genesis_time=GENESIS_TIME)
        jnode = JLocalNode(hub=JHub(), peer_id="n0", harness=jhs)
        set_backend(backend)
        phs = BeaconChainHarness(validator_count=16, fake_crypto=fake, genesis_time=GENESIS_TIME)
        pnode = LocalNode(hub=Hub(), peer_id="n0", harness=phs)
        try:
            batches = _gossip_batches(phs, pnode, fake)
            jhs.advance_slot()
            assert jnode.router.fork_digest == pnode.router.fork_digest
            want = _router_outcomes(jnode, jhs.chain, batches)
            got = _router_outcomes(pnode, phs.chain, batches)
        finally:
            jnode.shutdown()
            pnode.shutdown()
    finally:
        jbackends.set_backend(prev)
    assert got == want
    reasons = [r[2] for r in got["rejected"]]
    assert "undecodable" in reasons and "invalid_attestation" in reasons
    assert ("bad_signature" in reasons) is not fake
    assert got["pool"] and got["aggregators"] and got["forwarded"]
