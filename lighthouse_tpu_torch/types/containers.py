"""Consensus containers across forks (phase0 → deneb), preset-parameterized.

The reference expresses fork-variant containers with the ``superstruct`` macro
over compile-time ``EthSpec`` sizes (``consensus/types/src/beacon_state.rs:34``,
``beacon_block_body.rs``).  Here, ``build_types(preset)`` constructs the full
set of SSZ container classes for a preset (Mainnet/Minimal/Gnosis) and returns
a registry; per-fork variants are distinct classes related by explicit
``fork_name`` attributes and upgrade functions (``state_transition/upgrades``).

Field order follows the consensus specs exactly (SSZ stability is
consensus-critical); cross-checked against spec test vectors in tests.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

from .spec import Preset
from .ssz import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Vector,
    boolean,
    bytes4,
    bytes20,
    bytes32,
    bytes48,
    bytes96,
    uint64,
    uint8,
    uint256,
    _ContainerMeta,
)


@lru_cache(maxsize=None)
def build_types(preset: Preset) -> SimpleNamespace:
    P = preset
    JUSTIFICATION_BITS_LENGTH = 4
    DEPOSIT_CONTRACT_TREE_DEPTH = 32

    ns = SimpleNamespace(preset=P)

    # ---------------------------------------------------------- basic misc

    class Fork(Container):
        fields = {"previous_version": bytes4, "current_version": bytes4, "epoch": uint64}

    class ForkData(Container):
        fields = {"current_version": bytes4, "genesis_validators_root": bytes32}

    class Checkpoint(Container):
        fields = {"epoch": uint64, "root": bytes32}

    class Validator(Container):
        fields = {
            "pubkey": bytes48,
            "withdrawal_credentials": bytes32,
            "effective_balance": uint64,
            "slashed": boolean,
            "activation_eligibility_epoch": uint64,
            "activation_epoch": uint64,
            "exit_epoch": uint64,
            "withdrawable_epoch": uint64,
        }

    class AttestationData(Container):
        fields = {
            "slot": uint64,
            "index": uint64,
            "beacon_block_root": bytes32,
            "source": Checkpoint.ssz_type,
            "target": Checkpoint.ssz_type,
        }

    class IndexedAttestation(Container):
        fields = {
            "attesting_indices": List(uint64, P.max_validators_per_committee),
            "data": AttestationData.ssz_type,
            "signature": bytes96,
        }

    class PendingAttestation(Container):
        fields = {
            "aggregation_bits": Bitlist(P.max_validators_per_committee),
            "data": AttestationData.ssz_type,
            "inclusion_delay": uint64,
            "proposer_index": uint64,
        }

    class Eth1Data(Container):
        fields = {"deposit_root": bytes32, "deposit_count": uint64, "block_hash": bytes32}

    class HistoricalBatch(Container):
        fields = {
            "block_roots": Vector(bytes32, P.slots_per_historical_root),
            "state_roots": Vector(bytes32, P.slots_per_historical_root),
        }

    class DepositMessage(Container):
        fields = {"pubkey": bytes48, "withdrawal_credentials": bytes32, "amount": uint64}

    class DepositData(Container):
        fields = {
            "pubkey": bytes48,
            "withdrawal_credentials": bytes32,
            "amount": uint64,
            "signature": bytes96,
        }

    class BeaconBlockHeader(Container):
        fields = {
            "slot": uint64,
            "proposer_index": uint64,
            "parent_root": bytes32,
            "state_root": bytes32,
            "body_root": bytes32,
        }

    class SignedBeaconBlockHeader(Container):
        fields = {"message": BeaconBlockHeader.ssz_type, "signature": bytes96}

    class SigningData(Container):
        fields = {"object_root": bytes32, "domain": bytes32}

    # ----------------------------------------------------------- operations

    class ProposerSlashing(Container):
        fields = {
            "signed_header_1": SignedBeaconBlockHeader.ssz_type,
            "signed_header_2": SignedBeaconBlockHeader.ssz_type,
        }

    class AttesterSlashing(Container):
        fields = {
            "attestation_1": IndexedAttestation.ssz_type,
            "attestation_2": IndexedAttestation.ssz_type,
        }

    class Attestation(Container):
        fields = {
            "aggregation_bits": Bitlist(P.max_validators_per_committee),
            "data": AttestationData.ssz_type,
            "signature": bytes96,
        }

    class Deposit(Container):
        fields = {
            "proof": Vector(bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1),
            "data": DepositData.ssz_type,
        }

    class VoluntaryExit(Container):
        fields = {"epoch": uint64, "validator_index": uint64}

    class SignedVoluntaryExit(Container):
        fields = {"message": VoluntaryExit.ssz_type, "signature": bytes96}

    class SyncAggregate(Container):
        fields = {
            "sync_committee_bits": Bitvector(P.sync_committee_size),
            "sync_committee_signature": bytes96,
        }

    class SyncCommittee(Container):
        fields = {
            "pubkeys": Vector(bytes48, P.sync_committee_size),
            "aggregate_pubkey": bytes48,
        }

    class Withdrawal(Container):
        fields = {
            "index": uint64,
            "validator_index": uint64,
            "address": bytes20,
            "amount": uint64,
        }

    class BLSToExecutionChange(Container):
        fields = {
            "validator_index": uint64,
            "from_bls_pubkey": bytes48,
            "to_execution_address": bytes20,
        }

    class SignedBLSToExecutionChange(Container):
        fields = {"message": BLSToExecutionChange.ssz_type, "signature": bytes96}

    class HistoricalSummary(Container):
        fields = {"block_summary_root": bytes32, "state_summary_root": bytes32}

    # ---------------------------------------------------- execution payloads

    _payload_base = {
        "parent_hash": bytes32,
        "fee_recipient": bytes20,
        "state_root": bytes32,
        "receipts_root": bytes32,
        "logs_bloom": ByteVector(P.bytes_per_logs_bloom),
        "prev_randao": bytes32,
        "block_number": uint64,
        "gas_limit": uint64,
        "gas_used": uint64,
        "timestamp": uint64,
        "extra_data": ByteList(P.max_extra_data_bytes),
        "base_fee_per_gas": uint256,
        "block_hash": bytes32,
    }
    _txs = {"transactions": List(ByteList(P.max_bytes_per_transaction), P.max_transactions_per_payload)}
    _wds = {"withdrawals": List(Withdrawal.ssz_type, P.max_withdrawals_per_payload)}
    _blobgas = {"blob_gas_used": uint64, "excess_blob_gas": uint64}

    class ExecutionPayloadBellatrix(Container):
        fields = {**_payload_base, **_txs}

    class ExecutionPayloadCapella(Container):
        fields = {**_payload_base, **_txs, **_wds}

    class ExecutionPayloadDeneb(Container):
        fields = {**_payload_base, **_txs, **_wds, **_blobgas}

    _hdr_base = dict(_payload_base)
    _hdr_base["transactions_root"] = bytes32

    class ExecutionPayloadHeaderBellatrix(Container):
        fields = dict(_hdr_base)

    class ExecutionPayloadHeaderCapella(Container):
        fields = {**_hdr_base, "withdrawals_root": bytes32}

    class ExecutionPayloadHeaderDeneb(Container):
        fields = {**_hdr_base, "withdrawals_root": bytes32, **_blobgas}

    # -------------------------------------------------------- block bodies

    _body_base = {
        "randao_reveal": bytes96,
        "eth1_data": Eth1Data.ssz_type,
        "graffiti": bytes32,
        "proposer_slashings": List(ProposerSlashing.ssz_type, P.max_proposer_slashings),
        "attester_slashings": List(AttesterSlashing.ssz_type, P.max_attester_slashings),
        "attestations": List(Attestation.ssz_type, P.max_attestations),
        "deposits": List(Deposit.ssz_type, P.max_deposits),
        "voluntary_exits": List(SignedVoluntaryExit.ssz_type, P.max_voluntary_exits),
    }
    _sync_agg = {"sync_aggregate": SyncAggregate.ssz_type}
    _blschanges = {
        "bls_to_execution_changes": List(
            SignedBLSToExecutionChange.ssz_type, P.max_bls_to_execution_changes
        )
    }
    _blobkzg = {
        "blob_kzg_commitments": List(bytes48, P.max_blob_commitments_per_block)
    }

    class BeaconBlockBodyPhase0(Container):
        fork_name = "phase0"
        fields = dict(_body_base)

    class BeaconBlockBodyAltair(Container):
        fork_name = "altair"
        fields = {**_body_base, **_sync_agg}

    class BeaconBlockBodyBellatrix(Container):
        fork_name = "bellatrix"
        fields = {**_body_base, **_sync_agg, "execution_payload": ExecutionPayloadBellatrix.ssz_type}

    class BeaconBlockBodyCapella(Container):
        fork_name = "capella"
        fields = {
            **_body_base,
            **_sync_agg,
            "execution_payload": ExecutionPayloadCapella.ssz_type,
            **_blschanges,
        }

    class BeaconBlockBodyDeneb(Container):
        fork_name = "deneb"
        fields = {
            **_body_base,
            **_sync_agg,
            "execution_payload": ExecutionPayloadDeneb.ssz_type,
            **_blschanges,
            **_blobkzg,
        }

    # ------------------------------------------------------------- electra
    # EIP-7549: attestations span all committees of a slot, selected by
    # committee_bits; EIP-6110/7002/7251: execution-triggered requests ride
    # in an ExecutionRequests block-body field.

    _electra_agg_limit = P.max_validators_per_committee * P.max_committees_per_slot

    class AttestationElectra(Container):
        fields = {
            "aggregation_bits": Bitlist(_electra_agg_limit),
            "data": AttestationData.ssz_type,
            "signature": bytes96,
            "committee_bits": Bitvector(P.max_committees_per_slot),
        }

    class IndexedAttestationElectra(Container):
        fields = {
            "attesting_indices": List(uint64, _electra_agg_limit),
            "data": AttestationData.ssz_type,
            "signature": bytes96,
        }

    class AttesterSlashingElectra(Container):
        fields = {
            "attestation_1": IndexedAttestationElectra.ssz_type,
            "attestation_2": IndexedAttestationElectra.ssz_type,
        }

    class DepositRequest(Container):
        fields = {
            "pubkey": bytes48,
            "withdrawal_credentials": bytes32,
            "amount": uint64,
            "signature": bytes96,
            "index": uint64,
        }

    class WithdrawalRequest(Container):
        fields = {
            "source_address": bytes20,
            "validator_pubkey": bytes48,
            "amount": uint64,
        }

    class ConsolidationRequest(Container):
        fields = {
            "source_address": bytes20,
            "source_pubkey": bytes48,
            "target_pubkey": bytes48,
        }

    class ExecutionRequests(Container):
        fields = {
            "deposits": List(DepositRequest.ssz_type, P.max_deposit_requests_per_payload),
            "withdrawals": List(
                WithdrawalRequest.ssz_type, P.max_withdrawal_requests_per_payload
            ),
            "consolidations": List(
                ConsolidationRequest.ssz_type, P.max_consolidation_requests_per_payload
            ),
        }

    class PendingDeposit(Container):
        fields = {
            "pubkey": bytes48,
            "withdrawal_credentials": bytes32,
            "amount": uint64,
            "signature": bytes96,
            "slot": uint64,
        }

    class PendingPartialWithdrawal(Container):
        fields = {
            "validator_index": uint64,
            "amount": uint64,
            "withdrawable_epoch": uint64,
        }

    class PendingConsolidation(Container):
        fields = {"source_index": uint64, "target_index": uint64}

    _body_base_electra = dict(_body_base)
    _body_base_electra["attester_slashings"] = List(
        AttesterSlashingElectra.ssz_type, P.max_attester_slashings_electra
    )
    _body_base_electra["attestations"] = List(
        AttestationElectra.ssz_type, P.max_attestations_electra
    )

    class BeaconBlockBodyElectra(Container):
        fork_name = "electra"
        fields = {
            **_body_base_electra,
            **_sync_agg,
            # the electra execution payload is structurally deneb's
            "execution_payload": ExecutionPayloadDeneb.ssz_type,
            **_blschanges,
            **_blobkzg,
            "execution_requests": ExecutionRequests.ssz_type,
        }

    _bodies = {
        "phase0": BeaconBlockBodyPhase0,
        "altair": BeaconBlockBodyAltair,
        "bellatrix": BeaconBlockBodyBellatrix,
        "capella": BeaconBlockBodyCapella,
        "deneb": BeaconBlockBodyDeneb,
        "electra": BeaconBlockBodyElectra,
    }

    ns.attestation_by_fork = {}  # filled below

    # --------------------------------------------------- deneb blob sidecars

    Blob = ByteVector(32 * P.field_elements_per_blob)
    # proof depth: list subtree + length mixin + body field tree
    _commit_depth = max(0, (P.max_blob_commitments_per_block - 1).bit_length())
    _body_depth = max(
        0, (len(BeaconBlockBodyDeneb.fields) - 1).bit_length()
    )
    KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = _commit_depth + 1 + _body_depth

    class BlobSidecar(Container):
        """Deneb blob sidecar (reference ``consensus/types/src/blob_sidecar.rs``):
        the gossip unit carrying one blob + its commitment's merkle inclusion
        proof against the signed header's body root."""

        fields = {
            "index": uint64,
            "blob": Blob,
            "kzg_commitment": bytes48,
            "kzg_proof": bytes48,
            "signed_block_header": SignedBeaconBlockHeader.ssz_type,
            "kzg_commitment_inclusion_proof": Vector(
                bytes32, KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
            ),
        }

    class BlobIdentifier(Container):
        fields = {"block_root": bytes32, "index": uint64}

    ns.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = KZG_COMMITMENT_INCLUSION_PROOF_DEPTH
    ns.Blob = Blob

    _blocks = {}
    _signed_blocks = {}
    for _fork, _body in _bodies.items():
        _blk = type(
            f"BeaconBlock{_fork.capitalize()}",
            (Container,),
            {
                "fork_name": _fork,
                "fields": {
                    "slot": uint64,
                    "proposer_index": uint64,
                    "parent_root": bytes32,
                    "state_root": bytes32,
                    "body": _body.ssz_type,
                },
            },
        )
        _sblk = type(
            f"SignedBeaconBlock{_fork.capitalize()}",
            (Container,),
            {
                "fork_name": _fork,
                "fields": {"message": _blk.ssz_type, "signature": bytes96},
            },
        )
        _blocks[_fork] = _blk
        _signed_blocks[_fork] = _sblk

    # ------------------------------------------------- blinded blocks (MEV)
    # Reference ``consensus/types``: BlindedPayload variants — the body
    # carries the execution payload HEADER; the builder reveals the payload
    # only after the proposer signs (builder_client / blinded production).

    _payload_headers = {
        "bellatrix": ExecutionPayloadHeaderBellatrix,
        "capella": ExecutionPayloadHeaderCapella,
        "deneb": ExecutionPayloadHeaderDeneb,
        "electra": ExecutionPayloadHeaderDeneb,  # structurally deneb's
    }
    _blinded_bodies = {}
    _blinded_blocks = {}
    _signed_blinded_blocks = {}
    for _fork, _body in _bodies.items():
        if "execution_payload" not in _body.fields:
            continue
        _bf = {}
        for _fname, _ftype in _body.fields.items():
            if _fname == "execution_payload":
                _bf["execution_payload_header"] = _payload_headers[_fork].ssz_type
            else:
                _bf[_fname] = _ftype
        _bbody = type(
            f"BlindedBeaconBlockBody{_fork.capitalize()}",
            (Container,),
            {"fork_name": _fork, "fields": _bf},
        )
        _bblk = type(
            f"BlindedBeaconBlock{_fork.capitalize()}",
            (Container,),
            {
                "fork_name": _fork,
                "fields": {
                    "slot": uint64,
                    "proposer_index": uint64,
                    "parent_root": bytes32,
                    "state_root": bytes32,
                    "body": _bbody.ssz_type,
                },
            },
        )
        _sbblk = type(
            f"SignedBlindedBeaconBlock{_fork.capitalize()}",
            (Container,),
            {
                "fork_name": _fork,
                "fields": {"message": _bblk.ssz_type, "signature": bytes96},
            },
        )
        _blinded_bodies[_fork] = _bbody
        _blinded_blocks[_fork] = _bblk
        _signed_blinded_blocks[_fork] = _sbblk

    # ------------------------------------------------ builder API (relay)
    # Reference ``beacon_node/builder_client`` + eth2 builder-specs types.

    class ValidatorRegistrationV1(Container):
        fields = {
            "fee_recipient": bytes20,
            "gas_limit": uint64,
            "timestamp": uint64,
            "pubkey": bytes48,
        }

    class SignedValidatorRegistrationV1(Container):
        fields = {
            "message": ValidatorRegistrationV1.ssz_type,
            "signature": bytes96,
        }

    _builder_bids = {}
    _signed_builder_bids = {}
    for _fork, _hdr in _payload_headers.items():
        _bid_fields = {"header": _hdr.ssz_type}
        if _fork in ("deneb", "electra"):
            _bid_fields["blob_kzg_commitments"] = List(
                bytes48, P.max_blob_commitments_per_block
            )
        if _fork == "electra":
            # electra builder-specs: the bid carries the EL-triggered
            # requests the blinded body must embed (the reference's
            # BuilderBidElectra, builder_bid.rs:14-35, extended per the
            # final builder-specs electra fork).
            _bid_fields["execution_requests"] = ExecutionRequests.ssz_type
        _bid_fields["value"] = uint256
        _bid_fields["pubkey"] = bytes48
        _bid = type(
            f"BuilderBid{_fork.capitalize()}",
            (Container,),
            {"fork_name": _fork, "fields": _bid_fields},
        )
        _sbid = type(
            f"SignedBuilderBid{_fork.capitalize()}",
            (Container,),
            {"fork_name": _fork, "fields": {"message": _bid.ssz_type, "signature": bytes96}},
        )
        _builder_bids[_fork] = _bid
        _signed_builder_bids[_fork] = _sbid

    # -------------------------------------------------------------- states

    _state_pre = {
        "genesis_time": uint64,
        "genesis_validators_root": bytes32,
        "slot": uint64,
        "fork": Fork.ssz_type,
        "latest_block_header": BeaconBlockHeader.ssz_type,
        "block_roots": Vector(bytes32, P.slots_per_historical_root),
        "state_roots": Vector(bytes32, P.slots_per_historical_root),
        "historical_roots": List(bytes32, P.historical_roots_limit),
        "eth1_data": Eth1Data.ssz_type,
        "eth1_data_votes": List(
            Eth1Data.ssz_type, P.epochs_per_eth1_voting_period * P.slots_per_epoch
        ),
        "eth1_deposit_index": uint64,
        "validators": List(Validator.ssz_type, P.validator_registry_limit),
        "balances": List(uint64, P.validator_registry_limit),
        "randao_mixes": Vector(bytes32, P.epochs_per_historical_vector),
        "slashings": Vector(uint64, P.epochs_per_slashings_vector),
    }
    _state_justification = {
        "justification_bits": Bitvector(JUSTIFICATION_BITS_LENGTH),
        "previous_justified_checkpoint": Checkpoint.ssz_type,
        "current_justified_checkpoint": Checkpoint.ssz_type,
        "finalized_checkpoint": Checkpoint.ssz_type,
    }
    _participation = {
        "previous_epoch_participation": List(uint8, P.validator_registry_limit),
        "current_epoch_participation": List(uint8, P.validator_registry_limit),
    }
    _altair_tail = {
        "inactivity_scores": List(uint64, P.validator_registry_limit),
        "current_sync_committee": SyncCommittee.ssz_type,
        "next_sync_committee": SyncCommittee.ssz_type,
    }
    _capella_tail = {
        "next_withdrawal_index": uint64,
        "next_withdrawal_validator_index": uint64,
        "historical_summaries": List(HistoricalSummary.ssz_type, P.historical_roots_limit),
    }

    class BeaconStatePhase0(Container):
        fork_name = "phase0"
        fields = {
            **_state_pre,
            "previous_epoch_attestations": List(
                PendingAttestation.ssz_type, P.max_attestations * P.slots_per_epoch
            ),
            "current_epoch_attestations": List(
                PendingAttestation.ssz_type, P.max_attestations * P.slots_per_epoch
            ),
            **_state_justification,
        }

    class BeaconStateAltair(Container):
        fork_name = "altair"
        fields = {**_state_pre, **_participation, **_state_justification, **_altair_tail}

    class BeaconStateBellatrix(Container):
        fork_name = "bellatrix"
        fields = {
            **_state_pre,
            **_participation,
            **_state_justification,
            **_altair_tail,
            "latest_execution_payload_header": ExecutionPayloadHeaderBellatrix.ssz_type,
        }

    class BeaconStateCapella(Container):
        fork_name = "capella"
        fields = {
            **_state_pre,
            **_participation,
            **_state_justification,
            **_altair_tail,
            "latest_execution_payload_header": ExecutionPayloadHeaderCapella.ssz_type,
            **_capella_tail,
        }

    class BeaconStateDeneb(Container):
        fork_name = "deneb"
        fields = {
            **_state_pre,
            **_participation,
            **_state_justification,
            **_altair_tail,
            "latest_execution_payload_header": ExecutionPayloadHeaderDeneb.ssz_type,
            **_capella_tail,
        }

    class BeaconStateElectra(Container):
        fork_name = "electra"
        fields = {
            **_state_pre,
            **_participation,
            **_state_justification,
            **_altair_tail,
            "latest_execution_payload_header": ExecutionPayloadHeaderDeneb.ssz_type,
            **_capella_tail,
            "deposit_requests_start_index": uint64,
            "deposit_balance_to_consume": uint64,
            "exit_balance_to_consume": uint64,
            "earliest_exit_epoch": uint64,
            "consolidation_balance_to_consume": uint64,
            "earliest_consolidation_epoch": uint64,
            "pending_deposits": List(PendingDeposit.ssz_type, P.pending_deposits_limit),
            "pending_partial_withdrawals": List(
                PendingPartialWithdrawal.ssz_type, P.pending_partial_withdrawals_limit
            ),
            "pending_consolidations": List(
                PendingConsolidation.ssz_type, P.pending_consolidations_limit
            ),
        }

    _states = {
        "phase0": BeaconStatePhase0,
        "altair": BeaconStateAltair,
        "bellatrix": BeaconStateBellatrix,
        "capella": BeaconStateCapella,
        "deneb": BeaconStateDeneb,
        "electra": BeaconStateElectra,
    }

    # ------------------------------------------------- aggregation / duties

    class AggregateAndProof(Container):
        fields = {
            "aggregator_index": uint64,
            "aggregate": Attestation.ssz_type,
            "selection_proof": bytes96,
        }

    class SignedAggregateAndProof(Container):
        fields = {"message": AggregateAndProof.ssz_type, "signature": bytes96}

    class SyncAggregatorSelectionData(Container):
        fields = {"slot": uint64, "subcommittee_index": uint64}

    class SyncCommitteeMessage(Container):
        fields = {
            "slot": uint64,
            "beacon_block_root": bytes32,
            "validator_index": uint64,
            "signature": bytes96,
        }

    _sync_subcommittee_size = max(1, P.sync_committee_size // 4)

    class SyncCommitteeContribution(Container):
        fields = {
            "slot": uint64,
            "beacon_block_root": bytes32,
            "subcommittee_index": uint64,
            "aggregation_bits": Bitvector(_sync_subcommittee_size),
            "signature": bytes96,
        }

    class ContributionAndProof(Container):
        fields = {
            "aggregator_index": uint64,
            "contribution": SyncCommitteeContribution.ssz_type,
            "selection_proof": bytes96,
        }

    class SignedContributionAndProof(Container):
        fields = {"message": ContributionAndProof.ssz_type, "signature": bytes96}

    # ------------------------------------------------- light client protocol
    # Reference: consensus/types/src/light_client_{header,bootstrap,...}.rs.
    # Headers are per-era (light_client_header.rs:40-59): altair/bellatrix
    # carry only the beacon header; capella adds the execution payload
    # header + the 4-deep ``execution_branch`` proving it under the block's
    # body root (EXECUTION_PAYLOAD_GINDEX = 25); deneb/electra carry their
    # era's payload header.  Electra additionally deepens the state-side
    # branches (64-leaf state layout: depths 6/7).

    _exec_branch = Vector(bytes32, 4)  # floorlog2(EXECUTION_PAYLOAD_GINDEX)

    class LightClientHeader(Container):
        fields = {"beacon": BeaconBlockHeader.ssz_type}

    class LightClientHeaderCapella(Container):
        fields = {
            "beacon": BeaconBlockHeader.ssz_type,
            "execution": ExecutionPayloadHeaderCapella.ssz_type,
            "execution_branch": _exec_branch,
        }

    class LightClientHeaderDeneb(Container):
        fields = {
            "beacon": BeaconBlockHeader.ssz_type,
            "execution": ExecutionPayloadHeaderDeneb.ssz_type,
            "execution_branch": _exec_branch,
        }

    _sc_branch = Vector(bytes32, 5)  # depth of a 32-leaf state container
    _fin_branch = Vector(bytes32, 6)  # finalized root: one level deeper

    class LightClientBootstrap(Container):
        fields = {
            "header": LightClientHeader.ssz_type,
            "current_sync_committee": SyncCommittee.ssz_type,
            "current_sync_committee_branch": _sc_branch,
        }

    class LightClientUpdate(Container):
        fields = {
            "attested_header": LightClientHeader.ssz_type,
            "next_sync_committee": SyncCommittee.ssz_type,
            "next_sync_committee_branch": _sc_branch,
            "finalized_header": LightClientHeader.ssz_type,
            "finality_branch": _fin_branch,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    class LightClientFinalityUpdate(Container):
        fields = {
            "attested_header": LightClientHeader.ssz_type,
            "finalized_header": LightClientHeader.ssz_type,
            "finality_branch": _fin_branch,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    class LightClientOptimisticUpdate(Container):
        fields = {
            "attested_header": LightClientHeader.ssz_type,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    # Electra: the state grows past 32 fields (64 leaves), so the sync
    # committee / finality gindices gain one level (spec electra
    # light-client changes: branch depths 6 and 7).
    _sc_branch_electra = Vector(bytes32, 6)
    _fin_branch_electra = Vector(bytes32, 7)

    class LightClientBootstrapElectra(Container):
        fields = {
            "header": LightClientHeaderDeneb.ssz_type,
            "current_sync_committee": SyncCommittee.ssz_type,
            "current_sync_committee_branch": _sc_branch_electra,
        }

    class LightClientUpdateElectra(Container):
        fields = {
            "attested_header": LightClientHeaderDeneb.ssz_type,
            "next_sync_committee": SyncCommittee.ssz_type,
            "next_sync_committee_branch": _sc_branch_electra,
            "finalized_header": LightClientHeaderDeneb.ssz_type,
            "finality_branch": _fin_branch_electra,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    class LightClientFinalityUpdateElectra(Container):
        fields = {
            "attested_header": LightClientHeaderDeneb.ssz_type,
            "finalized_header": LightClientHeaderDeneb.ssz_type,
            "finality_branch": _fin_branch_electra,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    # ------------------------------------------------------------- exports

    for k, v in dict(locals()).items():
        if isinstance(v, type) and issubclass(v, Container) and v is not Container:
            setattr(ns, v.__name__, v)

    ns.Fork = Fork
    ns.block_body = _bodies
    ns.block = _blocks
    ns.signed_block = _signed_blocks

    # Per-era LC container sets.  The era key tracks BOTH axes that change
    # across forks: the header format (altair beacon-only; capella/deneb
    # execution header + execution_branch) and the state-branch depths
    # (electra: 6/7).  capella/deneb variants are generated here from the
    # altair shapes with the era's header substituted
    # (light_client_bootstrap.rs / light_client_update.rs per-fork structs).
    def _lc_variants(era_name, header_cls):
        out = {}
        for kind, base in (("bootstrap", LightClientBootstrap),
                           ("update", LightClientUpdate),
                           ("finality_update", LightClientFinalityUpdate),
                           ("optimistic_update", LightClientOptimisticUpdate)):
            fields = {}
            for fname, ftype in base.fields.items():
                if fname in ("header", "attested_header", "finalized_header"):
                    fields[fname] = header_cls.ssz_type
                else:
                    fields[fname] = ftype
            cls_name = base.__name__ + era_name.capitalize()
            cls = _ContainerMeta(cls_name, (Container,), {"fields": fields})
            setattr(ns, cls_name, cls)
            out[kind] = cls
        out["header"] = header_cls
        return out

    class LightClientOptimisticUpdateElectra(Container):
        fields = {
            "attested_header": LightClientHeaderDeneb.ssz_type,
            "sync_aggregate": SyncAggregate.ssz_type,
            "signature_slot": uint64,
        }

    ns.LightClientOptimisticUpdateElectra = LightClientOptimisticUpdateElectra
    ns.light_client = {
        "altair": {
            "header": LightClientHeader,
            "bootstrap": LightClientBootstrap,
            "update": LightClientUpdate,
            "finality_update": LightClientFinalityUpdate,
            "optimistic_update": LightClientOptimisticUpdate,
        },
        "capella": _lc_variants("capella", LightClientHeaderCapella),
        "deneb": _lc_variants("deneb", LightClientHeaderDeneb),
        "electra": {
            "header": LightClientHeaderDeneb,
            "bootstrap": LightClientBootstrapElectra,
            "update": LightClientUpdateElectra,
            "finality_update": LightClientFinalityUpdateElectra,
            "optimistic_update": LightClientOptimisticUpdateElectra,
        },
    }
    ns.blinded_block_body = _blinded_bodies
    ns.blinded_block = _blinded_blocks
    ns.signed_blinded_block = _signed_blinded_blocks
    ns.payload_header = {f: h for f, h in _payload_headers.items()}
    ns.execution_payload = {
        "bellatrix": ExecutionPayloadBellatrix,
        "capella": ExecutionPayloadCapella,
        "deneb": ExecutionPayloadDeneb,
        "electra": ExecutionPayloadDeneb,  # structurally deneb's
    }
    ns.builder_bid = _builder_bids
    ns.signed_builder_bid = _signed_builder_bids
    ns.state = _states
    for _f in _bodies:
        ns.attestation_by_fork[_f] = (
            AttestationElectra if _f == "electra" else Attestation
        )
    ns.indexed_attestation_by_fork = {
        _f: (IndexedAttestationElectra if _f == "electra" else IndexedAttestation)
        for _f in _bodies
    }
    return ns
