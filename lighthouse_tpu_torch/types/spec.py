"""Chain presets and runtime spec constants.

Two-level split mirroring the reference (``consensus/types``):

- ``Preset`` — the compile-time ``EthSpec`` typenum sizes (eth_spec.rs:53…):
  container capacities and epoch geometry.  Mainnet / Minimal / Gnosis.
- ``ChainSpec`` — runtime-tunable constants (chain_spec.rs:86…): fork schedule,
  balances, rewards, domains, time parameters.  Loadable/overridable from the
  standard config-YAML key set.

Values are the canonical consensus-spec presets (phase0 → deneb), the same data
the reference embeds from the specs repo.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields as dc_fields
from typing import Dict, Optional

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0

# BLS domain types (domain constants are identical across presets).
DOMAIN_BEACON_PROPOSER = bytes.fromhex("00000000")
DOMAIN_BEACON_ATTESTER = bytes.fromhex("01000000")
DOMAIN_RANDAO = bytes.fromhex("02000000")
DOMAIN_DEPOSIT = bytes.fromhex("03000000")
DOMAIN_VOLUNTARY_EXIT = bytes.fromhex("04000000")
DOMAIN_SELECTION_PROOF = bytes.fromhex("05000000")
DOMAIN_AGGREGATE_AND_PROOF = bytes.fromhex("06000000")
DOMAIN_SYNC_COMMITTEE = bytes.fromhex("07000000")
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = bytes.fromhex("08000000")
DOMAIN_CONTRIBUTION_AND_PROOF = bytes.fromhex("09000000")
DOMAIN_BLS_TO_EXECUTION_CHANGE = bytes.fromhex("0A000000")
DOMAIN_APPLICATION_BUILDER = bytes.fromhex("00000001")
DOMAIN_APPLICATION_MASK = bytes.fromhex("00000001")

# Altair participation flag indices / weights.
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
]


@dataclass(frozen=True)
class Preset:
    """Compile-time sizes (the reference's EthSpec trait, eth_spec.rs:53)."""

    name: str
    # Misc / geometry
    slots_per_epoch: int
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    shuffle_round_count: int
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5
    # State list lengths
    epochs_per_eth1_voting_period: int = 64
    slots_per_historical_root: int = 8192
    epochs_per_historical_vector: int = 65536
    epochs_per_slashings_vector: int = 8192
    historical_roots_limit: int = 2**24
    validator_registry_limit: int = 2**40
    # Max operations per block
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_deposits: int = 16
    max_voluntary_exits: int = 16
    # Altair
    sync_committee_size: int = 512
    epochs_per_sync_committee_period: int = 256
    min_sync_committee_participants: int = 1
    # Bellatrix (execution payload)
    max_bytes_per_transaction: int = 2**30
    max_transactions_per_payload: int = 2**20
    bytes_per_logs_bloom: int = 256
    max_extra_data_bytes: int = 32
    # Capella
    max_withdrawals_per_payload: int = 16
    max_validators_per_withdrawals_sweep: int = 16384
    max_bls_to_execution_changes: int = 16
    # Deneb
    max_blob_commitments_per_block: int = 4096
    field_elements_per_blob: int = 4096
    # Electra (EIP-7251/7549/7002/6110)
    max_attestations_electra: int = 8
    max_attester_slashings_electra: int = 1
    max_deposit_requests_per_payload: int = 8192
    max_withdrawal_requests_per_payload: int = 16
    max_consolidation_requests_per_payload: int = 2
    pending_deposits_limit: int = 2**27
    pending_partial_withdrawals_limit: int = 2**27
    pending_consolidations_limit: int = 2**18
    max_pending_partials_per_withdrawals_sweep: int = 8
    max_pending_deposits_per_epoch: int = 16


MAINNET_PRESET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    shuffle_round_count=90,
)

MINIMAL_PRESET = Preset(
    name="minimal",
    slots_per_epoch=8,
    max_committees_per_slot=4,
    target_committee_size=4,
    max_validators_per_committee=2048,
    shuffle_round_count=10,
    epochs_per_eth1_voting_period=4,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    max_withdrawals_per_payload=4,
    max_validators_per_withdrawals_sweep=16,
    max_blob_commitments_per_block=16,
    max_deposit_requests_per_payload=4,
    max_withdrawal_requests_per_payload=2,
    max_consolidation_requests_per_payload=1,
    max_pending_partials_per_withdrawals_sweep=1,
    pending_partial_withdrawals_limit=64,
    pending_consolidations_limit=64,
)

# Gnosis preset (presets/gnosis/*.yaml): mainnet sizes except the faster
# epoch geometry and smaller withdrawals sweep.
GNOSIS_PRESET = dataclasses.replace(
    MAINNET_PRESET,
    name="gnosis",
    slots_per_epoch=16,
    epochs_per_sync_committee_period=512,
    max_withdrawals_per_payload=8,
    max_validators_per_withdrawals_sweep=8192,
)


@dataclass
class ChainSpec:
    """Runtime constants (the reference's ChainSpec, chain_spec.rs:86…)."""

    preset: Preset = MAINNET_PRESET
    config_name: str = "mainnet"

    # Time
    seconds_per_slot: int = 12
    genesis_delay: int = 604800
    min_genesis_time: int = 1606824000
    eth1_follow_distance: int = 2048
    seconds_per_eth1_block: int = 14
    min_genesis_active_validator_count: int = 16384
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_epochs_to_inactivity_penalty: int = 4
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    # Fork schedule (version bytes + activation epochs)
    genesis_fork_version: bytes = bytes.fromhex("00000000")
    altair_fork_version: bytes = bytes.fromhex("01000000")
    altair_fork_epoch: Optional[int] = 74240
    bellatrix_fork_version: bytes = bytes.fromhex("02000000")
    bellatrix_fork_epoch: Optional[int] = 144896
    capella_fork_version: bytes = bytes.fromhex("03000000")
    capella_fork_epoch: Optional[int] = 194048
    deneb_fork_version: bytes = bytes.fromhex("04000000")
    deneb_fork_epoch: Optional[int] = 269568
    electra_fork_version: bytes = bytes.fromhex("05000000")
    electra_fork_epoch: Optional[int] = None
    # Balances / deposits (Gwei)
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    # Validator cycle
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_per_epoch_activation_churn_limit: int = 8
    # Rewards & penalties
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # Altair reward/penalty revisions
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # Bellatrix revisions
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3
    terminal_total_difficulty: int = 58750000000000000000000
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH
    # Fork choice
    intervals_per_slot: int = 3
    proposer_score_boost: int = 40
    reorg_head_weight_threshold: int = 20
    reorg_parent_weight_threshold: int = 160
    reorg_max_epochs_since_finalization: int = 2
    # Deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa")
    # Networking-adjacent constants used by validator duties
    target_aggregators_per_committee: int = 16
    attestation_subnet_count: int = 64
    sync_committee_subnet_count: int = 4
    target_aggregators_per_sync_subcommittee: int = 16
    # Deneb
    max_blobs_per_block: int = 6
    min_epochs_for_blob_sidecars_requests: int = 4096
    # Electra
    max_effective_balance_electra: int = 2048 * 10**9
    min_activation_balance: int = 32 * 10**9
    min_per_epoch_churn_limit_electra: int = 128 * 10**9
    max_per_epoch_activation_exit_churn_limit: int = 256 * 10**9
    min_slashing_penalty_quotient_electra: int = 4096
    whistleblower_reward_quotient_electra: int = 4096
    max_blobs_per_block_electra: int = 9
    full_exit_request_amount: int = 0
    compounding_withdrawal_prefix: bytes = b"\x02"
    unset_deposit_requests_start_index: int = FAR_FUTURE_EPOCH

    # ------------------------------------------------------------- helpers

    @property
    def slots_per_epoch(self) -> int:
        return self.preset.slots_per_epoch

    def fork_name_at_epoch(self, epoch: int) -> str:
        if self.electra_fork_epoch is not None and epoch >= self.electra_fork_epoch:
            return "electra"
        if self.deneb_fork_epoch is not None and epoch >= self.deneb_fork_epoch:
            return "deneb"
        if self.capella_fork_epoch is not None and epoch >= self.capella_fork_epoch:
            return "capella"
        if self.bellatrix_fork_epoch is not None and epoch >= self.bellatrix_fork_epoch:
            return "bellatrix"
        if self.altair_fork_epoch is not None and epoch >= self.altair_fork_epoch:
            return "altair"
        return "phase0"

    def fork_name_at_slot(self, slot: int) -> str:
        return self.fork_name_at_epoch(slot // self.slots_per_epoch)

    def attestation_includable(self, att_slot: int, state_slot: int) -> bool:
        """Is an attestation from ``att_slot`` includable in a block at
        ``state_slot``?  Pre-Deneb: within one epoch of slots.  Post-Deneb
        (EIP-7045): any current- or previous-epoch attestation.  Single source
        of truth for both the naive pool and the op pool."""
        if att_slot + self.min_attestation_inclusion_delay > state_slot:
            return False
        if self.fork_name_at_slot(state_slot) in (
            "phase0", "altair", "bellatrix", "capella",
        ):
            return att_slot + self.slots_per_epoch >= state_slot
        return (
            att_slot // self.slots_per_epoch + 1 >= state_slot // self.slots_per_epoch
        )

    def fork_version_for(self, fork_name: str) -> bytes:
        return {
            "phase0": self.genesis_fork_version,
            "altair": self.altair_fork_version,
            "bellatrix": self.bellatrix_fork_version,
            "capella": self.capella_fork_version,
            "deneb": self.deneb_fork_version,
            "electra": self.electra_fork_version,
        }[fork_name]

    def fork_epoch_for(self, fork_name: str) -> Optional[int]:
        return {
            "phase0": 0,
            "altair": self.altair_fork_epoch,
            "bellatrix": self.bellatrix_fork_epoch,
            "capella": self.capella_fork_epoch,
            "deneb": self.deneb_fork_epoch,
            "electra": self.electra_fork_epoch,
        }[fork_name]

    # Spec helper: integer_squareroot
    @staticmethod
    def integer_squareroot(n: int) -> int:
        import math

        return math.isqrt(n)


def mainnet_spec() -> ChainSpec:
    return ChainSpec()


def minimal_spec(**overrides) -> ChainSpec:
    """Minimal-preset spec as the reference test harness uses it: all forks
    enabled from genesis unless overridden (BeaconChainHarness defaults)."""
    base = dict(
        preset=MINIMAL_PRESET,
        config_name="minimal",
        seconds_per_slot=6,
        min_genesis_active_validator_count=64,
        churn_limit_quotient=32,
        shard_committee_period=64,
        min_validator_withdrawability_delay=256,
        # minimal-preset penalty parameters (presets/minimal/phase0.yaml —
        # they differ from mainnet and were silently inheriting it)
        inactivity_penalty_quotient=2**25,
        min_slashing_penalty_quotient=64,
        proportional_slashing_multiplier=2,
        altair_fork_epoch=0,
        bellatrix_fork_epoch=0,
        capella_fork_epoch=0,
        deneb_fork_epoch=0,
        electra_fork_epoch=None,
        altair_fork_version=bytes.fromhex("01000001"),
        bellatrix_fork_version=bytes.fromhex("02000001"),
        capella_fork_version=bytes.fromhex("03000001"),
        deneb_fork_version=bytes.fromhex("04000001"),
        electra_fork_version=bytes.fromhex("05000001"),
        genesis_fork_version=bytes.fromhex("00000001"),
    )
    base.update(overrides)
    return ChainSpec(**base)


def gnosis_spec() -> ChainSpec:
    return ChainSpec(
        preset=GNOSIS_PRESET,
        config_name="gnosis",
        seconds_per_slot=5,
        churn_limit_quotient=4096,
        genesis_fork_version=bytes.fromhex("00000064"),
        altair_fork_version=bytes.fromhex("01000064"),
        altair_fork_epoch=512,
        bellatrix_fork_version=bytes.fromhex("02000064"),
        bellatrix_fork_epoch=385536,
        capella_fork_version=bytes.fromhex("03000064"),
        capella_fork_epoch=648704,
        deneb_fork_version=bytes.fromhex("04000064"),
        deneb_fork_epoch=889856,
        base_reward_factor=25,
    )


SPECS: Dict[str, callable] = {
    "mainnet": mainnet_spec,
    "minimal": minimal_spec,
    "gnosis": gnosis_spec,
}

FORK_ORDER = ["phase0", "altair", "bellatrix", "capella", "deneb", "electra"]


def previous_fork(fork_name: str) -> str:
    i = FORK_ORDER.index(fork_name)
    return FORK_ORDER[max(0, i - 1)]
