"""The port's slasher (``slasher/``) vs the JAX package's.

``lighthouse_tpu_torch.slasher`` copies the JAX package's slasher: dense
numpy arrays on the host, its log in any of the port's key-value stores.
Here:

- parity: a seeded stream of indexed attestations (double votes and
  surround votes in both directions, validators that grow the arrays,
  targets that wrap the history ring) and of block headers (double
  proposals), fed to both packages' slashers over a ``MemoryStore`` with a
  restart from the store half way: the same findings after every item, the
  same slashings byte for byte, the same stored log and the same arrays;
- the JAX package's ``test_slasher.py`` cases, re-pointed at the port.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from lighthouse_tpu.slasher import Slasher as JSlasher  # noqa: E402
from lighthouse_tpu.slasher import SlasherConfig as JSlasherConfig  # noqa: E402
from lighthouse_tpu.store.kv import MemoryStore as JMemoryStore  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.slasher import Slasher, SlasherConfig  # noqa: E402
from lighthouse_tpu_torch.store.kv import MemoryStore  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_chain import one_torch_thread, port_cpu  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _fake():
    set_backend("fake")
    yield
    set_backend("host")


@pytest.fixture()
def harness():
    return BeaconChainHarness(validator_count=16, fake_crypto=True)


def _indexed(types, indices, source, target, root=b"\x01" * 32, beacon_root=b"\x02" * 32):
    return types.IndexedAttestation(
        attesting_indices=sorted(indices),
        data=types.AttestationData(
            slot=target * 8,
            index=0,
            beacon_block_root=beacon_root,
            source=types.Checkpoint(epoch=source, root=root),
            target=types.Checkpoint(epoch=target, root=root),
        ),
        signature=b"\xc0" + b"\x00" * 95,
    )


def test_double_vote_detected(harness):
    slasher = Slasher(harness.types)
    a1 = _indexed(harness.types, [3, 4], 0, 5, beacon_root=b"\xaa" * 32)
    a2 = _indexed(harness.types, [4, 7], 0, 5, beacon_root=b"\xbb" * 32)
    assert slasher.on_attestation(a1) == 0
    n = slasher.on_attestation(a2)
    assert n == 1, "validator 4 voted twice for target 5"
    slashings, _ = slasher.drain_slashings()
    s = slashings[0]
    both = set(s.attestation_1.attesting_indices) & set(s.attestation_2.attesting_indices)
    assert 4 in both


def test_identical_attestation_not_slashable(harness):
    slasher = Slasher(harness.types)
    a1 = _indexed(harness.types, [3], 0, 5)
    assert slasher.on_attestation(a1) == 0
    assert slasher.on_attestation(a1) == 0, "re-seen identical attestation is fine"


def test_new_surrounds_old(harness):
    from lighthouse_tpu_torch.consensus import helpers as h

    slasher = Slasher(harness.types)
    inner = _indexed(harness.types, [2], 3, 4)
    outer = _indexed(harness.types, [2], 1, 6)  # (1,6) surrounds (3,4)
    assert slasher.on_attestation(inner) == 0
    assert slasher.on_attestation(outer) == 1
    slashings, _ = slasher.drain_slashings()
    assert len(slashings) == 1
    s = slashings[0]
    # orientation: attestation_1 must SURROUND attestation_2 or the chain's
    # is_slashable_attestation_data check rejects the slashing
    assert h.is_slashable_attestation_data(s.attestation_1.data, s.attestation_2.data)


def test_old_surrounds_new(harness):
    from lighthouse_tpu_torch.consensus import helpers as h

    slasher = Slasher(harness.types)
    outer = _indexed(harness.types, [9], 1, 6)
    inner = _indexed(harness.types, [9], 3, 4)  # surrounded by (1,6)
    assert slasher.on_attestation(outer) == 0
    assert slasher.on_attestation(inner) == 1
    slashings, _ = slasher.drain_slashings()
    s = slashings[0]
    assert h.is_slashable_attestation_data(s.attestation_1.data, s.attestation_2.data)


def test_disjoint_votes_not_slashable(harness):
    slasher = Slasher(harness.types)
    assert slasher.on_attestation(_indexed(harness.types, [5], 0, 1)) == 0
    assert slasher.on_attestation(_indexed(harness.types, [5], 1, 2)) == 0
    assert slasher.on_attestation(_indexed(harness.types, [5], 2, 5)) == 0


def test_double_proposal_detected(harness):
    slasher = Slasher(harness.types)
    harness.advance_slot()
    b1 = harness.produce_signed_block(graffiti=b"\x01" * 32)
    b2 = harness.produce_signed_block(graffiti=b"\x02" * 32)
    assert slasher.on_block(b1) == 0
    assert slasher.on_block(b2) == 1
    _, proposer_slashings = slasher.drain_slashings()
    s = proposer_slashings[0]
    assert s.signed_header_1.message.slot == s.signed_header_2.message.slot
    assert (
        s.signed_header_1.message.body_root != s.signed_header_2.message.body_root
    )


def test_slashing_accepted_by_chain(harness):
    """The produced AttesterSlashing passes the chain's own processing and
    slashes the validator (end-to-end: detection -> op pool -> block)."""
    slasher = Slasher(harness.types)
    chain = harness.chain
    harness.extend_chain(2)
    state = chain.head_state
    # craft a double vote by validator 6 signed for real-data plausibility
    data1 = chain.produce_attestation_data(chain.current_slot(), 0)
    a1 = harness.types.IndexedAttestation(
        attesting_indices=[6],
        data=data1,
        signature=harness.sign_attestation_data(state, data1, 6).to_bytes(),
    )
    data2 = harness.types.AttestationData(
        slot=data1.slot, index=data1.index,
        beacon_block_root=b"\x13" * 32,  # different head vote, same target
        source=data1.source, target=data1.target,
    )
    a2 = harness.types.IndexedAttestation(
        attesting_indices=[6],
        data=data2,
        signature=harness.sign_attestation_data(state, data2, 6).to_bytes(),
    )
    slasher.on_attestation(a1)
    assert slasher.on_attestation(a2) == 1
    slashings, _ = slasher.drain_slashings()
    chain.op_pool.insert_attester_slashing(slashings[0])
    harness.extend_chain(1)
    assert chain.head_state.validators[6].slashed, (
        "the slashing must land in a block and slash the validator"
    )


def test_gossip_equivocation_feeds_slasher(harness):
    """A node with the slasher enabled catches a proposer equivocating over
    gossip and queues the ProposerSlashing in its op pool."""
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.snappy_codec import compress
    from lighthouse_tpu_torch.network import topics as topics_mod
    from lighthouse_tpu_torch.network.transport import Hub

    node = LocalNode(hub=Hub(), peer_id="s", harness=harness, enable_slasher=True)
    try:
        harness.advance_slot()
        b1 = harness.produce_signed_block(graffiti=b"\x01" * 32)
        b2 = harness.produce_signed_block(graffiti=b"\x02" * 32)
        topic = str(
            topics_mod.GossipTopic(node.router.fork_digest, topics_mod.BEACON_BLOCK)
        )
        r1, r2 = b1.as_ssz_bytes(), b2.as_ssz_bytes()
        node.router._process_gossip_block(topic, r1, compress(r1), "peer-1")
        node.router._process_gossip_block(topic, r2, compress(r2), "peer-2")
        assert len(harness.chain.op_pool._proposer_slashings) == 1, (
            "equivocation must produce a pooled ProposerSlashing"
        )
    finally:
        node.shutdown()


def test_history_window_grows_validators(harness):
    slasher = Slasher(harness.types, SlasherConfig(history_length=64))
    big = _indexed(harness.types, [5000], 0, 1)
    assert slasher.on_attestation(big) == 0  # growth along validator axis
    dbl = _indexed(harness.types, [5000], 0, 1, beacon_root=b"\xdd" * 32)
    assert slasher.on_attestation(dbl) == 1


# ------------------------------------------------------------- persistence


def test_restart_still_detects_surround(harness):
    """A surround pair whose first half was recorded
    before a restart is still detected after reload from the store."""
    from lighthouse_tpu_torch.store.kv import MemoryStore

    store = MemoryStore()
    s1 = Slasher(harness.types, store=store)
    a_old = _indexed(harness.types, [2], 3, 6)  # source 3, target 6
    assert s1.on_attestation(a_old) == 0
    del s1  # "shutdown"

    s2 = Slasher(harness.types, store=store)  # restart: replay the log
    a_new = _indexed(harness.types, [2], 1, 8)  # surrounds (3,6)
    assert s2.on_attestation(a_new) == 1
    slashings, _ = s2.drain_slashings()
    assert len(slashings) == 1
    # attestation_1 surrounds attestation_2
    s = slashings[0]
    assert int(s.attestation_1.data.source.epoch) < int(s.attestation_2.data.source.epoch)
    assert int(s.attestation_2.data.target.epoch) < int(s.attestation_1.data.target.epoch)


def test_restart_still_detects_double_proposal(harness):
    from lighthouse_tpu_torch.store.kv import MemoryStore

    store = MemoryStore()
    s1 = Slasher(harness.types, store=store)
    b1 = harness.produce_signed_block(slot=harness.advance_slot(), graffiti=b"\x01" * 32)
    b2 = harness.produce_signed_block(slot=int(b1.message.slot), graffiti=b"\x02" * 32)
    assert s1.on_block(b1) == 0
    del s1

    s2 = Slasher(harness.types, store=store)
    assert s2.on_block(b2) == 1
    _, proposals = s2.drain_slashings()
    assert len(proposals) == 1


def test_store_prunes_old_attestations(harness):
    from lighthouse_tpu_torch.store.kv import MemoryStore

    store = MemoryStore()
    cfg = SlasherConfig(history_length=64)
    s1 = Slasher(harness.types, cfg, store=store)
    s1.on_attestation(_indexed(harness.types, [1], 0, 5))
    # jump far ahead: the prune cadence fires and drops aged-out records
    s1.on_attestation(_indexed(harness.types, [1], 500, 600))
    keys = [k for k, _ in store.iter_column(Slasher.ATT_COLUMN)]
    targets = sorted(int.from_bytes(k[:8], "big") for k in keys)
    assert 5 not in targets, "aged-out attestation must be pruned from the store"
    assert 600 in targets


def test_aliased_column_does_not_fake_evidence(harness):
    """Circular-buffer aliasing (targets H apart map to one column) must not
    produce false double-vote findings."""
    cfg = SlasherConfig(history_length=64)
    slasher = Slasher(harness.types, cfg)
    a1 = _indexed(harness.types, [6], 4, 10, beacon_root=b"\xaa" * 32)
    # target 74 aliases column 10 (74 % 64) with a different data root
    a2 = _indexed(harness.types, [6], 70, 74, beacon_root=b"\xbb" * 32)
    assert slasher.on_attestation(a1) == 0
    assert slasher.on_attestation(a2) == 0, "aliased entry is not a double vote"


def test_restart_recovers_undrained_slashing(harness):
    """A slashing detected before shutdown but never drained re-surfaces
    after the restart replay."""
    from lighthouse_tpu_torch.store.kv import MemoryStore

    store = MemoryStore()
    s1 = Slasher(harness.types, store=store)
    s1.on_attestation(_indexed(harness.types, [5], 3, 6))
    assert s1.on_attestation(_indexed(harness.types, [5], 1, 8)) == 1
    # crash WITHOUT drain_slashings()
    del s1
    s2 = Slasher(harness.types, store=store)
    slashings, _ = s2.drain_slashings()
    assert len(slashings) >= 1, "undrained slashing lost across restart"


# ------------------------------------------------------ history-window ring


class TestHistoryWindowRing:
    """Detection correctness when target epochs wrap the ``history_length``
    ring (``t % H`` indexing), across validator-array growth, and the
    prune-beyond-window behavior, pinned."""

    H = 64

    def _slasher(self, harness):
        return Slasher(harness.types, SlasherConfig(history_length=self.H))

    def test_double_vote_detected_after_ring_wrap(self, harness):
        """A column that aliased an OLD target is overwritten by the newer
        epoch; doubles at the new target are still caught."""
        s = self._slasher(harness)
        t = 10
        assert s.on_attestation(_indexed(harness.types, [2], 0, t)) == 0
        # a full ring later the same column holds the NEW target
        assert s.on_attestation(
            _indexed(harness.types, [2], 90, t + self.H,
                     beacon_root=b"\xaa" * 32)) == 0
        n = s.on_attestation(
            _indexed(harness.types, [2], 90, t + self.H,
                     beacon_root=b"\xbb" * 32))
        assert n == 1, "double vote at the wrapped column missed"

    def test_surround_detected_across_ring_distance(self, harness):
        """new ⊃ old where the scan window wraps the circular axis."""
        s = self._slasher(harness)
        assert s.on_attestation(_indexed(harness.types, [3], 30, 40)) == 0
        # (10, 100): the backward scan spans 37..99 — columns wrap % 64
        assert s.on_attestation(_indexed(harness.types, [3], 10, 100)) == 1

    def test_old_surrounds_new_across_ring_distance(self, harness):
        s = self._slasher(harness)
        assert s.on_attestation(_indexed(harness.types, [4], 1, 70)) == 0
        # (3, 69): the forward scan 70..132 wraps and must validate stored
        # targets, not trust aliased columns
        assert s.on_attestation(_indexed(harness.types, [4], 3, 69)) == 1

    def test_evidence_beyond_window_not_detected(self, harness):
        """Surround evidence older than history_length is out of scope BY
        DESIGN (the reference prunes the same way) — pinned so a window
        regression is loud."""
        s = self._slasher(harness)
        assert s.on_attestation(_indexed(harness.types, [5], 30, 40)) == 0
        # new target a full ring past the old one: (10, 300) surrounds
        # (30, 40) mathematically, but 40 < 300 - H + 1 — aged out
        assert s.on_attestation(_indexed(harness.types, [5], 10, 300)) == 0

    def test_detection_survives_validator_array_growth(self, harness):
        """Growing the validator axis (new high index) must preserve the
        recorded history of existing validators mid-window."""
        s = self._slasher(harness)
        assert s.on_attestation(_indexed(harness.types, [6], 3, 6)) == 0
        # force _ensure() growth well past the initial 64 rows
        assert s.on_attestation(_indexed(harness.types, [9000], 0, 1)) == 0
        assert s.on_attestation(_indexed(harness.types, [6], 1, 8)) == 1, (
            "surround against pre-growth history lost after array growth")

    def test_pruned_evidence_drops_finding(self, harness):
        """A finding whose evidence attestation was pruned out of the
        object map queues NOTHING and counts as dropped (the dense arrays
        still flag it; the container cannot be built)."""
        s = self._slasher(harness)
        assert s.on_attestation(_indexed(harness.types, [7], 0, 5)) == 0
        # jump far ahead: prune cadence fires, (7, 5) evidence is dropped
        assert s.on_attestation(_indexed(harness.types, [7], 500, 600)) == 0
        before = s.dropped_findings
        # the (7,5) column survived in the dense arrays only if 5 % H aliases
        # nothing newer; craft the aliased double — with the evidence gone
        # the finding must be dropped, never a half-built slashing
        n = s.on_attestation(
            _indexed(harness.types, [7], 0, 5, beacon_root=b"\xee" * 32))
        assert n == 0
        assert s.dropped_findings >= before


# ------------------------------------------------------- parity, findings


def slasher_stream(types, seed: int, n: int) -> list:
    """``n`` items drawn from ``seed``: ("att", IndexedAttestation) or
    ("block", SignedBeaconBlockHeader).  A third of the attestations repeat
    an earlier (validators, target) with another head root (double votes),
    a third surround or sit inside an earlier one, the rest are fresh; one
    in ten headers repeats an earlier (slot, proposer) with another body."""
    rng = np.random.default_rng(seed)
    out, atts, blocks = [], [], []

    def root():
        return rng.integers(0, 256, 32, dtype=np.uint8).tobytes()

    def indexed(indices, source, target, head):
        return types.IndexedAttestation(
            attesting_indices=sorted(set(int(i) for i in indices)),
            data=types.AttestationData(
                slot=target * 8, index=0, beacon_block_root=head,
                source=types.Checkpoint(epoch=source, root=b"\x01" * 32),
                target=types.Checkpoint(epoch=target, root=b"\x01" * 32)),
            signature=b"\xc0" + b"\x00" * 95)

    for _ in range(n):
        if rng.integers(8) == 0:
            if blocks and rng.integers(10) == 0:
                slot, proposer = blocks[int(rng.integers(len(blocks)))]
            else:
                slot, proposer = int(rng.integers(1, 600)), int(rng.integers(0, 48))
                blocks.append((slot, proposer))
            out.append(("block", types.SignedBeaconBlockHeader(
                message=types.BeaconBlockHeader(slot=slot, proposer_index=proposer,
                                                parent_root=root(), state_root=root(),
                                                body_root=root()),
                signature=b"\xc0" + b"\x00" * 95)))
            continue
        kind = int(rng.integers(3)) if atts else 2
        if kind == 0:  # double vote
            indices, source, target = atts[int(rng.integers(len(atts)))]
        elif kind == 1:  # surrounding or surrounded
            indices, source, target = atts[int(rng.integers(len(atts)))]
            if rng.integers(2) and source > 0:
                source, target = int(rng.integers(0, source)), target + int(rng.integers(1, 9))
            elif target - source > 2:
                source, target = source + 1, target - 1
        else:
            big = [int(rng.integers(60, 5000))] if rng.integers(12) == 0 else []
            indices = list(rng.integers(0, 48, int(rng.integers(1, 5)))) + big
            source = int(rng.integers(0, 150))
            target = source + int(rng.integers(1, 12))
        atts.append((indices, source, target))
        out.append(("att", indexed(indices, source, target, root())))
    return out


def run_slasher(slasher_cls, config, store, types, stream) -> dict:
    """``stream`` through a slasher over ``store``, restarted from the store
    half way: the count of slashings each item produced, the drained
    slashings' bytes, the stored log and the arrays."""
    half = len(stream) // 2
    slasher = slasher_cls(types, config, store=store)
    counts, drained = [], []
    for i, (kind, item) in enumerate(stream):
        if i == half:
            drained.append(("restart", [[s.as_ssz_bytes() for s in q]
                                        for q in slasher.drain_slashings()]))
            slasher = slasher_cls(types, config, store=store)
        counts.append(slasher.on_attestation(item) if kind == "att" else slasher.on_block(item))
        if i % 25 == 24:
            drained.append((i, [[s.as_ssz_bytes() for s in q] for q in slasher.drain_slashings()]))
    drained.append(("end", [[s.as_ssz_bytes() for s in q] for q in slasher.drain_slashings()]))
    db = slasher.db
    return {"counts": counts, "drained": drained, "dropped": slasher.dropped_findings,
            "log": {col: sorted(store.iter_column(col))
                    for col in (slasher.ATT_COLUMN, slasher.PROPOSAL_COLUMN)},
            "arrays": (db._sources.tobytes(), db._targets.tobytes(), db._roots.tobytes())}


@pytest.mark.parametrize("seed", [0, 1])
def test_slasher_findings_match_jax(seed):
    """The same seeded stream through both packages' slashers (history of
    64 epochs, so targets wrap the ring), restarted from their stores half
    way: the same findings, slashing bytes, stored log and arrays."""
    spec, j_spec = minimal_spec(), j_minimal_spec()
    types, j_types = build_types(spec.preset), j_build_types(j_spec.preset)
    got = run_slasher(Slasher, SlasherConfig(history_length=64), MemoryStore(), types,
                      slasher_stream(types, seed, 400))
    want = run_slasher(JSlasher, JSlasherConfig(history_length=64), JMemoryStore(), j_types,
                       slasher_stream(j_types, seed, 400))
    assert got == want
    found = [b for _, queues in got["drained"] for q in queues for b in q]
    assert len(found) >= 10 and any(c for c in got["counts"])
