"""Validator store: keys + domain-aware signing, gated by slashing protection.

Equivalent of the reference's ``validator_client/src/validator_store.rs`` —
every signature a validator produces flows through here so the
EIP-3076 DB can veto it (``sign_block``/``sign_attestation`` →
``slashing_protection.check_and_insert_*``).

A copy of the JAX package's ``lighthouse_tpu/validator_client/validator_store.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..consensus import helpers as h
from ..crypto.bls import api as bls
from ..types.spec import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    ChainSpec,
)
from ..types.ssz import UintType
from .slashing_protection import SlashingProtectionDB

uint64 = UintType(8)


class DoppelgangerBlocked(Exception):
    """Signing refused: doppelganger protection has not cleared yet."""


class ValidatorStore:
    def __init__(
        self,
        *,
        keys: List[bls.SecretKey],
        spec: ChainSpec,
        genesis_validators_root: bytes,
        slashing_db: Optional[SlashingProtectionDB] = None,
        fake_signatures: bool = False,
    ):
        self.spec = spec
        self.genesis_validators_root = genesis_validators_root
        self.slashing_db = slashing_db if slashing_db is not None else SlashingProtectionDB()
        self._by_pubkey: Dict[bytes, bls.SecretKey] = {
            sk.public_key().to_bytes(): sk for sk in keys
        }
        self._fake = fake_signatures
        self._remote: Dict[bytes, object] = {}  # pubkey -> remote signer
        # Doppelganger gate: DoppelgangerService flips this to False at
        # startup and back to True only after clean liveness epochs.
        self.signing_enabled = True
        if fake_signatures:
            from ..crypto.bls import curve, serde

            self._canned = serde.g2_compress(curve.G2)

    @property
    def pubkeys(self) -> List[bytes]:
        return list(self._by_pubkey) + list(self._remote)

    def has_key(self, pubkey: bytes) -> bool:
        return bytes(pubkey) in self._by_pubkey or bytes(pubkey) in self._remote

    # -------------------------------------------------------- key lifecycle
    # (reference initialized_validators.rs + signing_method.rs: local
    # keystores and Web3Signer remotes behind one signing facade)

    def add_key(self, secret_key) -> bytes:
        pk = secret_key.public_key().to_bytes()
        self._by_pubkey[pk] = secret_key
        return pk

    def remove_local_key(self, pubkey: bytes) -> bool:
        return self._by_pubkey.pop(bytes(pubkey), None) is not None

    def remove_remote_key(self, pubkey: bytes) -> bool:
        return self._remote.pop(bytes(pubkey), None) is not None

    def remove_key(self, pubkey: bytes) -> bool:
        """Remove in either backing (CLI convenience; the keymanager API's
        typed DELETE endpoints use the specific removers)."""
        local = self.remove_local_key(pubkey)
        remote = self.remove_remote_key(pubkey)
        return local or remote

    def add_remote_key(self, pubkey: bytes, signer) -> None:
        """Register a Web3Signer-backed key: ``signer.sign(pubkey, root)``
        produces the signature bytes remotely (signing_method.rs:80-91)."""
        self._remote[bytes(pubkey)] = signer

    # ------------------------------------------------------------- signing

    def _domain(self, domain_type: bytes, epoch: int) -> bytes:
        fork_version = self.spec.fork_version_for(self.spec.fork_name_at_epoch(epoch))
        return h.compute_domain(domain_type, fork_version, self.genesis_validators_root)

    def _raw_sign(self, pubkey: bytes, signing_root: bytes) -> bytes:
        if not self.signing_enabled:
            raise DoppelgangerBlocked(
                "signing disabled: doppelganger protection has not cleared"
            )
        if self._fake:
            return self._canned
        remote = self._remote.get(bytes(pubkey))
        if remote is not None:
            return remote.sign(bytes(pubkey), signing_root)
        sk = self._by_pubkey.get(bytes(pubkey))
        if sk is None:
            raise KeyError(f"no key for pubkey {bytes(pubkey).hex()[:16]}")
        return sk.sign(signing_root).to_bytes()

    def sign_block(self, pubkey: bytes, block) -> bytes:
        """Slashing-gated block signature (validator_store.rs sign_block)."""
        slot = int(block.slot)
        epoch = slot // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_BEACON_PROPOSER, epoch)
        signing_root = h.compute_signing_root(block.hash_tree_root(), domain)
        self.slashing_db.check_and_insert_block_proposal(
            bytes(pubkey), slot, signing_root
        )
        return self._raw_sign(pubkey, signing_root)

    def sign_attestation(self, pubkey: bytes, data) -> bytes:
        """Slashing-gated attestation signature over ``AttestationData``."""
        domain = self._domain(DOMAIN_BEACON_ATTESTER, int(data.target.epoch))
        signing_root = h.compute_signing_root(data.hash_tree_root(), domain)
        self.slashing_db.check_and_insert_attestation(
            bytes(pubkey), int(data.source.epoch), int(data.target.epoch), signing_root
        )
        return self._raw_sign(pubkey, signing_root)

    # ------------------------------------------------- unsafe signing seam
    #
    # The ONLY way around the EIP-3076 veto.  Exists for the byzantine
    # actor layer (adversary.py): scenario adversaries must be able to
    # produce genuinely slashable messages while the honest sign_block /
    # sign_attestation path keeps its protection intact (and asserted —
    # the controller first proves the honest path refuses, then signs
    # here).  Nothing in the production duty path may ever call these;
    # neither checks NOR records in the slashing DB, so an adversary's
    # slashable signature cannot poison the honest history either.

    def sign_block_unsafe(self, pubkey: bytes, block) -> bytes:
        """UNSAFE: proposer signature with the slashing-protection veto
        bypassed.  Byzantine test seam only — see the section comment."""
        epoch = int(block.slot) // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_BEACON_PROPOSER, epoch)
        signing_root = h.compute_signing_root(block.hash_tree_root(), domain)
        return self._raw_sign(pubkey, signing_root)

    def sign_attestation_unsafe(self, pubkey: bytes, data) -> bytes:
        """UNSAFE: attestation signature with the slashing-protection veto
        bypassed.  Byzantine test seam only — see the section comment."""
        domain = self._domain(DOMAIN_BEACON_ATTESTER, int(data.target.epoch))
        signing_root = h.compute_signing_root(data.hash_tree_root(), domain)
        return self._raw_sign(pubkey, signing_root)

    def sign_aggregate_and_proof_unsafe(self, pubkey: bytes,
                                        aggregate_and_proof) -> bytes:
        """UNSAFE alias of ``sign_aggregate_and_proof`` for the byzantine
        seam.  Aggregate wraps are not EIP-3076-gated (there is no veto to
        bypass), but adversarial signing must stay greppable as ``_unsafe``
        — the audit invariant the byzantine layer is built on."""
        return self.sign_aggregate_and_proof(pubkey, aggregate_and_proof)

    def randao_reveal(self, pubkey: bytes, epoch: int) -> bytes:
        domain = self._domain(DOMAIN_RANDAO, epoch)
        root = h.compute_signing_root(uint64.hash_tree_root(epoch), domain)
        return self._raw_sign(pubkey, root)

    def selection_proof(self, pubkey: bytes, slot: int) -> bytes:
        """Aggregation-slot selection proof (sign the slot number)."""
        epoch = slot // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_SELECTION_PROOF, epoch)
        root = h.compute_signing_root(uint64.hash_tree_root(slot), domain)
        return self._raw_sign(pubkey, root)

    def sign_aggregate_and_proof(self, pubkey: bytes, aggregate_and_proof) -> bytes:
        epoch = int(aggregate_and_proof.aggregate.data.slot) // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_AGGREGATE_AND_PROOF, epoch)
        root = h.compute_signing_root(aggregate_and_proof.hash_tree_root(), domain)
        return self._raw_sign(pubkey, root)

    def sign_voluntary_exit(self, pubkey: bytes, voluntary_exit,
                            current_epoch: int) -> bytes:
        """EIP-7044: once the CHAIN is at deneb+, exits are perpetually signed
        over the CAPELLA fork domain regardless of the exit's own epoch — must
        match the verify side (signature_sets.voluntary_exit_signature_set,
        which keys off the state's fork), else the BN rejects our own exits
        (round-2 advisor finding).  ``current_epoch`` is the wall-clock epoch
        (required — the caller owns the slot clock); an exit may legally carry
        any past epoch, so the fork decision uses the later of the two."""
        epoch = int(voluntary_exit.epoch)
        decision_epoch = max(epoch, int(current_epoch))
        if self.spec.fork_name_at_epoch(decision_epoch) in ("deneb", "electra"):
            domain = h.compute_domain(
                DOMAIN_VOLUNTARY_EXIT,
                self.spec.capella_fork_version,
                self.genesis_validators_root,
            )
        else:
            domain = self._domain(DOMAIN_VOLUNTARY_EXIT, epoch)
        root = h.compute_signing_root(voluntary_exit.hash_tree_root(), domain)
        return self._raw_sign(pubkey, root)

    def sign_sync_committee_message(self, pubkey: bytes, slot: int,
                                    block_root: bytes) -> bytes:
        epoch = slot // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_SYNC_COMMITTEE, epoch)
        root = h.compute_signing_root(bytes(block_root), domain)
        return self._raw_sign(pubkey, root)

    # ---------------------------------------------------------- aggregation

    def is_aggregator(self, committee_length: int, selection_proof: bytes) -> bool:
        """spec ``is_aggregator``: hash(selection_proof) mod max(1, len//16) == 0."""
        import hashlib

        modulo = max(1, committee_length // self.spec.target_aggregators_per_committee)
        digest = hashlib.sha256(selection_proof).digest()
        return int.from_bytes(digest[:8], "little") % modulo == 0

    # ------------------------------------------------------ sync committee

    def sync_selection_proof(self, pubkey: bytes, slot: int,
                             subcommittee_index: int, types) -> bytes:
        """Sign ``SyncAggregatorSelectionData`` (the sync-duty analog of the
        attestation selection proof)."""
        data = types.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee_index
        )
        epoch = slot // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
        root = h.compute_signing_root(data.hash_tree_root(), domain)
        return self._raw_sign(pubkey, root)

    def is_sync_aggregator(self, selection_proof: bytes) -> bool:
        """spec ``is_sync_committee_aggregator``."""
        import hashlib

        sub_size = (
            self.spec.preset.sync_committee_size
            // self.spec.sync_committee_subnet_count
        )
        modulo = max(1, sub_size // self.spec.target_aggregators_per_sync_subcommittee)
        digest = hashlib.sha256(selection_proof).digest()
        return int.from_bytes(digest[:8], "little") % modulo == 0

    def sign_contribution_and_proof(self, pubkey: bytes, message) -> bytes:
        epoch = int(message.contribution.slot) // self.spec.slots_per_epoch
        domain = self._domain(DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
        root = h.compute_signing_root(message.hash_tree_root(), domain)
        return self._raw_sign(pubkey, root)

    def sign_contribution_and_proof_unsafe(self, pubkey: bytes,
                                           message) -> bytes:
        """UNSAFE alias of ``sign_contribution_and_proof`` for the byzantine
        seam — see ``sign_aggregate_and_proof_unsafe``."""
        return self.sign_contribution_and_proof(pubkey, message)
