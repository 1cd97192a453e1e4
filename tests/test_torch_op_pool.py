"""The port's operation pool (``op_pool/``) vs the JAX package's.

``lighthouse_tpu_torch.op_pool`` copies the JAX package's ``op_pool``.
Chains are both packages' ``BeaconChainHarness`` (minimal preset, fake
crypto, the same user graffiti) on the port's CPU routes.  Every
comparison is exact:

- the same pool content (overlapping aggregates of three slots'
  committees, attester slashings with overlapping and already-slashed
  offenders, proposer slashings) gives the same packed attestations and
  slashings, byte for byte, for a block in both packages, at a limit that
  makes max-cover choose, and the same pool after pruning;
- the JAX package's ``test_op_pool.py`` cases re-pointed at the port.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from lighthouse_tpu.op_pool import OperationPool as JOperationPool  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.op_pool import OperationPool, max_cover  # noqa: E402
from test_torch_chain import (  # noqa: E402,F401
    harnesses,
    jax_backend,
    one_torch_thread,
    port_cpu,
)

#: Aggregates a committee, the chance a member's bit is set, the slots
#: attested and the packing limit (below the candidates, so max-cover picks).
AGGREGATES = 4
BIT_P = 0.4
SLOTS = 3
LIMIT = 6


def pool_content(jhs, rng):
    """Attestations (JAX types) for every committee of slots 1..SLOTS with
    seeded overlapping bits, and attester and proposer slashings."""
    chain, types, spec = jhs.chain, jhs.types, jhs.spec
    state = chain.head_state
    atts = []
    for slot in range(1, SLOTS + 1):
        root = chain.block_root_at_slot(slot)
        for index in range(h.get_committee_count_per_slot(state, 0, spec)):
            size = len(h.get_beacon_committee(state, slot, index, spec))
            data = types.AttestationData(
                slot=slot, index=index, beacon_block_root=root,
                source=state.current_justified_checkpoint.copy(),
                target=types.Checkpoint(epoch=0, root=chain.genesis_block_root))
            for _ in range(AGGREGATES):
                bits = (rng.random(size) < BIT_P).tolist()
                atts.append(types.Attestation(aggregation_bits=bits, data=data,
                                              signature=jhs._canned_sig))

    def indexed(indices, salt):
        return types.IndexedAttestation(
            attesting_indices=sorted(indices),
            data=types.AttestationData(
                slot=2, index=0, beacon_block_root=bytes([salt]) * 32,
                source=types.Checkpoint(epoch=0, root=b"\x01" * 32),
                target=types.Checkpoint(epoch=0, root=b"\x02" * 32)),
            signature=jhs._canned_sig)

    offenders = [[1, 2, 3], [3, 4], [5], [6, 7], [2, 8]]
    slashings = [types.AttesterSlashing(attestation_1=indexed(ix, 0xA0 + k),
                                        attestation_2=indexed(ix, 0xB0 + k))
                 for k, ix in enumerate(offenders)]

    def header(idx, salt):
        return types.SignedBeaconBlockHeader(
            message=types.BeaconBlockHeader(slot=2, proposer_index=idx,
                                            parent_root=b"\x03" * 32,
                                            state_root=bytes([salt]) * 32,
                                            body_root=b"\x04" * 32),
            signature=jhs._canned_sig)

    proposers = [types.ProposerSlashing(signed_header_1=header(i, 0x10 + i),
                                        signed_header_2=header(i, 0x40 + i))
                 for i in (9, 4, 11)]
    return atts, slashings, proposers


def test_packing_matches_jax():
    jhs, phs = harnesses({})
    with jax_backend("fake"):
        jhs.extend_chain(SLOTS, attest=False)
    phs.extend_chain(SLOTS, attest=False)
    atts, slashings, proposers = pool_content(jhs, np.random.default_rng(9))
    pools = (JOperationPool(), OperationPool())
    for obj in atts:
        pools[0].insert_attestation(obj)
        pools[1].insert_attestation(phs.types.Attestation.from_ssz_bytes(obj.as_ssz_bytes()))
    for obj in slashings:
        pools[0].insert_attester_slashing(obj)
        pools[1].insert_attester_slashing(
            phs.types.AttesterSlashing.from_ssz_bytes(obj.as_ssz_bytes()))
    for obj in proposers:
        pools[0].insert_proposer_slashing(obj)
        pools[1].insert_proposer_slashing(
            phs.types.ProposerSlashing.from_ssz_bytes(obj.as_ssz_bytes()))
    assert pools[1].num_attestations() == pools[0].num_attestations() > LIMIT
    with jax_backend("fake"):
        j_state, _ = jhs.chain.state_at_slot(SLOTS + 1)
    p_state, _ = phs.chain.state_at_slot(SLOTS + 1)
    j_state.validators[5].slashed = p_state.validators[5].slashed = True
    packed = []
    for pool, hs, state in ((pools[0], jhs, j_state), (pools[1], phs, p_state)):
        picked = pool.get_attestations(state, hs.types, hs.spec, LIMIT)
        proposer, attester = pool.get_slashings(state, hs.spec, hs.types)
        pool.prune(state, hs.spec)
        packed.append(([a.as_ssz_bytes() for a in picked],
                       [s.as_ssz_bytes() for s in proposer],
                       [s.as_ssz_bytes() for s in attester],
                       [s.as_ssz_bytes() for s in pool.attester_slashings()],
                       pool.num_attestations()))
    assert packed[1] == packed[0]
    assert len(packed[1][0]) == LIMIT and packed[1][1] and packed[1][2]


# ------------------------------------- the JAX package's op-pool tests, re-pointed


class TestMaxCover:
    def test_greedy_picks_largest_first(self):
        sets = [("a", {1, 2}), ("b", {1, 2, 3, 4}), ("c", {5})]
        assert max_cover(sets, 2) == ["b", "c"]

    def test_overlap_discounted(self):
        # After picking {1,2,3}, the set {2,3} covers nothing new while {4}
        # does — greedy must re-rank between rounds.
        sets = [("big", {1, 2, 3}), ("overlap", {2, 3}), ("tiny", {4})]
        assert max_cover(sets, 2) == ["big", "tiny"]

    def test_stops_when_nothing_new(self):
        sets = [("a", {1}), ("dup", {1})]
        assert max_cover(sets, 5) == ["a"]


class TestAggregateStorage:
    def test_subsumed_aggregates_dropped(self):
        h_ = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h_.extend_chain(1)
        chain = h_.chain
        state = chain.head_state
        committee = h.get_beacon_committee(state, 1, 0, chain.spec)
        data = chain.produce_attestation_data(1, 0)
        n = len(committee)

        def att(bits):
            return h_.types.Attestation(
                aggregation_bits=bits,
                data=data,
                signature=h_._canned_sig,
            )

        pool = OperationPool()
        small = [True] + [False] * (n - 1)
        big = [True, True] + [False] * (n - 2)
        pool.insert_attestation(att(small))
        pool.insert_attestation(att(big))  # supersedes `small`
        key = next(iter(pool._attestations))
        assert len(pool._attestations[key].aggregates) == 1
        pool.insert_attestation(att(small))  # subsumed: ignored
        assert len(pool._attestations[key].aggregates) == 1


class TestBlockIntegration:
    def test_produced_block_packs_pool_attestations(self):
        h_ = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h_.extend_chain(1)
        n_atts = h_.attest_to_head()
        h_.advance_slot()
        signed = h_.produce_signed_block()
        atts = list(signed.message.body.attestations)
        covered = sum(sum(1 for b in a.aggregation_bits if b) for a in atts)
        assert covered == n_atts
        # and the block imports cleanly
        root = h_.chain.process_block(signed, block_delay_seconds=1.0)
        assert h_.chain.head_root == root

    def test_exit_included_in_block(self):
        h_ = BeaconChainHarness(validator_count=16, fake_crypto=True)
        # shard_committee_period gates exits; use a far-future-free check via
        # spec override in genesis would be heavy — instead verify the pool
        # filter logic directly plus inclusion plumbing with an eligible exit.
        spec = h_.spec
        h_.extend_chain(1)
        chain = h_.chain
        exit_msg = h_.types.VoluntaryExit(epoch=0, validator_index=3)
        signed_exit = h_.types.SignedVoluntaryExit(
            message=exit_msg, signature=h_._canned_sig
        )
        chain.op_pool.insert_voluntary_exit(signed_exit)
        # Too-young validator (shard_committee_period): trial application
        # filters it — production must not crash nor include it.
        got = chain.op_pool.get_voluntary_exits(chain.head_state, h_.types, spec)
        assert got == []
        h_.advance_slot()
        block, _ = chain.produce_block(
            2, h_.randao_reveal(chain.head_state, 2, 0), parent_root=chain.head_root
        )
        assert list(block.body.voluntary_exits) == []


class TestPrune:
    def test_stale_attestations_pruned(self):
        h_ = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h_.extend_chain(1)
        h_.attest_to_head()
        h_.advance_slot()
        h_.produce_signed_block()  # matures naive pool into op pool
        assert h_.chain.op_pool.num_attestations() > 0
        for _ in range(12):  # > 1 epoch of slots
            h_.advance_slot()
        h_.chain.per_slot_task()
        assert h_.chain.op_pool.num_attestations() == 0


class TestSlashingHygiene:
    """ISSUE 11 satellite: dedup'd inserts, canonical (sorted) packing order
    under the per-block caps, and pruning of dead (already-slashed)
    slashings."""

    @staticmethod
    def _slashing(types, indices, target=3, salt=0):
        def att(root):
            return types.IndexedAttestation(
                attesting_indices=sorted(indices),
                data=types.AttestationData(
                    slot=target * 8,
                    index=0,
                    beacon_block_root=root,
                    source=types.Checkpoint(epoch=1, root=b"\x01" * 32),
                    target=types.Checkpoint(epoch=target, root=b"\x02" * 32),
                ),
                signature=b"\xc0" + b"\x00" * 95,
            )

        # a double vote: same (validator, target), different data roots
        return types.AttesterSlashing(
            attestation_1=att(bytes([0xA0 + salt]) * 32),
            attestation_2=att(bytes([0xB0 + salt]) * 32),
        )

    @pytest.fixture()
    def hstate(self):
        h_ = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h_.extend_chain(2)
        return h_, h_.chain.head_state

    def test_insert_dedup_by_root(self, hstate):
        h_, _state = hstate
        pool = OperationPool()
        s = self._slashing(h_.types, [3])
        pool.insert_attester_slashing(s)
        pool.insert_attester_slashing(s)
        pool.insert_attester_slashing(s.copy())
        assert pool.num_attester_slashings() == 1

    def test_packing_sorted_and_capped(self, hstate):
        h_, state = hstate
        spec = h_.spec
        slashings = [
            self._slashing(h_.types, [i], salt=i) for i in range(5)
        ]
        pool_fwd, pool_rev = OperationPool(), OperationPool()
        for s in slashings:
            pool_fwd.insert_attester_slashing(s)
        for s in reversed(slashings):
            pool_rev.insert_attester_slashing(s)
        _, att_fwd = pool_fwd.get_slashings(state, spec, h_.types)
        _, att_rev = pool_rev.get_slashings(state, spec, h_.types)
        assert len(att_fwd) == spec.preset.max_attester_slashings
        # arrival order must not leak into block content
        assert [s.hash_tree_root() for s in att_fwd] == [
            s.hash_tree_root() for s in att_rev
        ]
        assert [s.hash_tree_root() for s in att_fwd] == sorted(
            s.hash_tree_root() for s in att_fwd
        )

    def test_proposer_slashings_sorted_by_index(self, hstate):
        h_, state = hstate

        def pslash(idx, salt):
            def hdr(b):
                return h_.types.SignedBeaconBlockHeader(
                    message=h_.types.BeaconBlockHeader(
                        slot=4, proposer_index=idx, parent_root=b"\x03" * 32,
                        state_root=bytes([b]) * 32, body_root=b"\x04" * 32,
                    ),
                    signature=b"\xc0" + b"\x00" * 95,
                )

            return h_.types.ProposerSlashing(
                signed_header_1=hdr(0x10 + salt), signed_header_2=hdr(0x20 + salt)
            )

        pool = OperationPool()
        for idx in (7, 2, 11):
            pool.insert_proposer_slashing(pslash(idx, idx))
        proposer, _ = pool.get_slashings(state, h_.spec, h_.types)
        got = [int(s.signed_header_1.message.proposer_index) for s in proposer]
        assert got == [2, 7, 11]

    def test_already_slashed_is_dead_block_space(self, hstate):
        h_, state = hstate
        pool = OperationPool()
        pool.insert_attester_slashing(self._slashing(h_.types, [3], salt=1))
        pool.insert_attester_slashing(self._slashing(h_.types, [5], salt=2))
        scratch = state.copy()
        scratch.validators[3].slashed = True
        _, att = pool.get_slashings(scratch, h_.spec, h_.types)
        offenders = {
            int(i) for s in att for i in s.attestation_1.attesting_indices
        }
        assert offenders == {5}, "slashing for an already-slashed validator packed"
        # and prune drops the dead one while keeping the live one
        pool.prune(scratch, h_.spec)
        assert pool.num_attester_slashings() == 1
        assert {
            int(i)
            for s in pool.attester_slashings()
            for i in s.attestation_1.attesting_indices
        } == {5}
