"""In-process chain harness.

Equivalent of the reference's ``BeaconChainHarness``
(`beacon_node/beacon_chain/src/test_utils.rs`, 2.6k LoC): deterministic
interop keypairs + ``MemoryStore`` + ``ManualSlotClock`` + mock EL, able to
extend chains block-by-block with configurable attestation participation,
build forks, and drive the full L0–L4 stack with no networking — the topology
every integration test (and the north-star bench) runs on.

A copy of the JAX package's ``lighthouse_tpu/chain/harness.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..consensus import helpers as h
from ..consensus.genesis import interop_genesis_state, interop_secret_key
from ..crypto.bls import api as bls
from ..types.containers import build_types
from ..types.spec import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    ChainSpec,
)
from ..types.ssz import UintType
from .beacon_chain import BeaconChain
from .mock_el import MockExecutionEngine
from .slot_clock import ManualSlotClock


class BeaconChainHarness:
    def __init__(
        self,
        *,
        validator_count: int = 16,
        spec: Optional[ChainSpec] = None,
        genesis_time: int = 1_600_000_000,
        fake_crypto: bool = False,
        kzg=None,
    ):
        """``fake_crypto=True`` switches the BLS backend to the always-valid
        impl and signs with a canned G2 point — the reference's
        ``fake_crypto`` feature (``crypto/bls/src/impls/fake_crypto.rs``),
        which lets multi-epoch logic tests run in seconds.  Structural checks
        (non-empty keys) still apply."""
        from ..types.spec import minimal_spec

        self.spec = spec if spec is not None else minimal_spec(
            altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
            deneb_fork_epoch=None,
        )
        self.fake_crypto = fake_crypto
        if fake_crypto:
            from ..crypto.bls.backends import set_backend

            set_backend("fake")
            from ..crypto.bls import curve, serde

            self._canned_sig = serde.g2_compress(curve.G2)
        self.types = build_types(self.spec.preset)
        self.validator_count = validator_count
        self.keys = [interop_secret_key(i) for i in range(validator_count)]
        genesis_state = interop_genesis_state(
            validator_count, self.types, self.spec, genesis_time=genesis_time
        )
        self.chain = BeaconChain(
            genesis_state=genesis_state,
            types=self.types,
            spec=self.spec,
            slot_clock=ManualSlotClock(genesis_time, self.spec.seconds_per_slot),
            execution_engine=MockExecutionEngine(),
            kzg=kzg,
        )

    # ------------------------------------------------------------- signing

    def _domain_at(self, state, domain_type: bytes, epoch: int) -> bytes:
        return h.get_domain(state, domain_type, epoch, self.spec)

    def _sign(self, validator_index: int, root: bytes) -> bls.Signature:
        if self.fake_crypto:
            return bls.Signature.from_bytes(self._canned_sig)
        return self.keys[validator_index].sign(root)

    def sign_block(self, block, state) -> object:
        signed_cls = self.types.signed_block[type(block).fork_name]
        proposer = int(block.proposer_index)
        epoch = h.compute_epoch_at_slot(int(block.slot), self.spec)
        domain = self._domain_at(state, DOMAIN_BEACON_PROPOSER, epoch)
        root = h.compute_signing_root(block.hash_tree_root(), domain)
        sig = self._sign(proposer, root)
        return signed_cls(message=block, signature=sig.to_bytes())

    def randao_reveal(self, state, slot: int, proposer: int) -> bytes:
        epoch = h.compute_epoch_at_slot(slot, self.spec)
        domain = self._domain_at(state, DOMAIN_RANDAO, epoch)
        root = h.compute_signing_root(UintType(8).hash_tree_root(epoch), domain)
        return self._sign(proposer, root).to_bytes()

    def sign_attestation_data(self, state, data, validator_index: int) -> bls.Signature:
        domain = self._domain_at(state, DOMAIN_BEACON_ATTESTER, int(data.target.epoch))
        root = h.compute_signing_root(data.hash_tree_root(), domain)
        return self._sign(validator_index, root)

    def make_sync_aggregate(self, state, block_root: bytes, slot: int):
        """Full-participation sync aggregate over ``block_root`` for a block
        at ``slot`` (members sign the previous block root)."""
        spec, types = self.spec, self.types
        committee = state.current_sync_committee
        previous_slot = max(slot, 1) - 1
        domain = self._domain_at(
            state, DOMAIN_SYNC_COMMITTEE, h.compute_epoch_at_slot(previous_slot, spec)
        )
        root = h.compute_signing_root(bytes(block_root), domain)
        if self.fake_crypto:
            return types.SyncAggregate(
                sync_committee_bits=[True] * spec.preset.sync_committee_size,
                sync_committee_signature=self._canned_sig,
            )
        agg = bls.AggregateSignature.infinity()
        pk_to_index = {}
        for i, v in enumerate(state.validators):
            pk_to_index.setdefault(bytes(v.pubkey), i)
        for pk in committee.pubkeys:
            idx = pk_to_index[bytes(pk)]
            agg.add_assign(self.keys[idx].sign(root))
        return types.SyncAggregate(
            sync_committee_bits=[True] * spec.preset.sync_committee_size,
            sync_committee_signature=agg.to_bytes(),
        )

    # ----------------------------------------------------------- lifecycle

    def advance_slot(self) -> int:
        self.chain.slot_clock.advance_slot()
        self.chain.per_slot_task()
        return self.chain.current_slot()

    def produce_signed_block(
        self,
        slot: Optional[int] = None,
        sync_participation: bool = True,
        parent_root: Optional[bytes] = None,
        graffiti: bytes = b"\x00" * 32,
    ):
        chain = self.chain
        slot = chain.current_slot() if slot is None else slot
        pre_state, parent_root = chain.state_at_slot(slot, parent_root)
        proposer = h.get_beacon_proposer_index(pre_state, self.spec)
        reveal = self.randao_reveal(pre_state, slot, proposer)
        sync_aggregate = None
        if sync_participation and hasattr(pre_state, "current_sync_committee"):
            sync_aggregate = self.make_sync_aggregate(pre_state, parent_root, slot)
        block, _ = chain.produce_block(
            slot, reveal, graffiti=graffiti, sync_aggregate=sync_aggregate,
            parent_root=parent_root, pre_state=pre_state.copy(),
        )
        return self.sign_block(block, pre_state)

    def produce_signed_block_with_blobs(
        self,
        blobs: Sequence[bytes],
        slot: Optional[int] = None,
        sync_participation: bool = True,
    ):
        """Produce + sign a deneb block carrying ``blobs``, returning
        ``(signed_block, sidecars)`` with inclusion proofs + KZG proofs from
        the chain's KZG engine (the fake-EL analog of the blobsBundle flow)."""
        from .da import compute_blob_inclusion_proof

        chain, types = self.chain, self.types
        kzg = chain.kzg
        assert kzg is not None, "harness needs a Kzg engine for blob production"
        slot = chain.current_slot() if slot is None else slot
        pre_state, parent_root = chain.state_at_slot(slot)
        proposer = h.get_beacon_proposer_index(pre_state, self.spec)
        reveal = self.randao_reveal(pre_state, slot, proposer)
        sync_aggregate = None
        if sync_participation and hasattr(pre_state, "current_sync_committee"):
            sync_aggregate = self.make_sync_aggregate(pre_state, parent_root, slot)
        commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
        proofs = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
        block, _ = chain.produce_block(
            slot, reveal, sync_aggregate=sync_aggregate,
            parent_root=parent_root, pre_state=pre_state.copy(),
            blob_kzg_commitments=commitments,
        )
        signed = self.sign_block(block, pre_state)
        header = types.SignedBeaconBlockHeader(
            message=types.BeaconBlockHeader(
                slot=block.slot,
                proposer_index=block.proposer_index,
                parent_root=block.parent_root,
                state_root=block.state_root,
                body_root=block.body.hash_tree_root(),
            ),
            signature=signed.signature,
        )
        sidecars = [
            types.BlobSidecar(
                index=i,
                blob=blob,
                kzg_commitment=commitments[i],
                kzg_proof=proofs[i],
                signed_block_header=header,
                kzg_commitment_inclusion_proof=compute_blob_inclusion_proof(
                    block.body, i
                ),
            )
            for i, blob in enumerate(blobs)
        ]
        return signed, sidecars

    def attest_to_head(
        self, slot: Optional[int] = None, validators: Optional[Sequence[int]] = None
    ) -> int:
        """All (or the given) validators attest to the current head at
        ``slot``; attestations go through the chain's verification pipeline
        into fork choice + the aggregation pool.  Returns #attestations."""
        chain, spec, types = self.chain, self.spec, self.types
        slot = chain.current_slot() if slot is None else slot
        state, _ = chain.state_at_slot(slot) if int(chain.head_state.slot) < slot else (
            chain.head_state,
            chain.head_root,
        )
        included = 0
        committees = h.get_committee_count_per_slot(state, h.compute_epoch_at_slot(slot, spec), spec)
        allowed = set(validators) if validators is not None else None
        electra = spec.fork_name_at_slot(slot) == "electra"
        for index in range(committees):
            committee = h.get_beacon_committee(state, slot, index, spec)
            data = chain.produce_attestation_data(slot, index)
            for pos, vidx in enumerate(committee):
                if allowed is not None and int(vidx) not in allowed:
                    continue
                bits = [False] * len(committee)
                bits[pos] = True
                sig = self.sign_attestation_data(state, data, int(vidx)).to_bytes()
                if electra:
                    committee_bits = [False] * spec.preset.max_committees_per_slot
                    committee_bits[index] = True
                    att = types.AttestationElectra(
                        aggregation_bits=bits,
                        data=data,
                        signature=sig,
                        committee_bits=committee_bits,
                    )
                else:
                    att = types.Attestation(
                        aggregation_bits=bits, data=data, signature=sig
                    )
                chain.process_attestation(att)
                included += 1
        return included

    def extend_chain(
        self,
        num_blocks: int,
        attest: bool = True,
        participation: Optional[Sequence[int]] = None,
        sync_participation: bool = True,
    ) -> List[bytes]:
        """Advance one slot per block: produce → sign → import → attest
        (reference ``BeaconChainHarness::extend_chain``).  Returns the new
        block roots."""
        roots = []
        for _ in range(num_blocks):
            self.advance_slot()
            signed = self.produce_signed_block(sync_participation=sync_participation)
            root = self.chain.process_block(signed, block_delay_seconds=1.0)
            roots.append(root)
            if attest:
                self.attest_to_head(validators=participation)
        return roots

    # ------------------------------------------------------------- queries

    @property
    def head_root(self) -> bytes:
        return self.chain.head_root

    @property
    def head_state(self):
        return self.chain.head_state

    def finalized_epoch(self) -> int:
        return self.chain.finalized_checkpoint()[0]

    def justified_epoch(self) -> int:
        return self.chain.justified_checkpoint()[0]
