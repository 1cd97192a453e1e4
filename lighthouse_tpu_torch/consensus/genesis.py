"""Genesis state construction.

Two paths, mirroring the reference:

- ``initialize_beacon_state_from_eth1`` — the spec path driven by real
  ``Deposit``s (``consensus/state_processing/src/genesis.rs``).
- ``interop_genesis_state`` — deterministic insecure keypairs + directly
  constructed registry, the test/dev path
  (``beacon_node/genesis/src/interop.rs`` + ``common/eth2_interop_keypairs``).
  Skips per-deposit signature checks (interop deposits are self-signed by
  construction) and builds validators in bulk — the fast path every harness
  test uses.

A copy of the JAX package's ``lighthouse_tpu/consensus/genesis.py``.
"""

from __future__ import annotations

from functools import lru_cache
from hashlib import sha256
from typing import List, Optional, Tuple

from ..crypto.bls import api as bls
from ..crypto.bls.params import R as CURVE_ORDER
from ..types.spec import FAR_FUTURE_EPOCH, GENESIS_EPOCH, ChainSpec
from ..types.ssz import hash_tree_root
from . import helpers as h
from .upgrades import upgrade_state

DEPOSIT_CONTRACT_TREE_DEPTH = 32


@lru_cache(maxsize=None)
def interop_secret_key(index: int) -> bls.SecretKey:
    """``common/eth2_interop_keypairs``: sk_i = int(sha256(le32(i))) mod r."""
    k = int.from_bytes(sha256(index.to_bytes(32, "little")).digest(), "little") % CURVE_ORDER
    return bls.SecretKey(k)


@lru_cache(maxsize=None)
def interop_keypair(index: int) -> Tuple[bls.SecretKey, bytes]:
    sk = interop_secret_key(index)
    return sk, sk.public_key().to_bytes()


def interop_withdrawal_credentials(pubkey: bytes) -> bytes:
    return b"\x00" + sha256(pubkey).digest()[1:]


def deposit_tree_root(deposit_data_list, types) -> bytes:
    """Root of List[DepositData, 2**DEPOSIT_CONTRACT_TREE_DEPTH]."""
    from ..types.ssz import List as SszList

    t = SszList(types.DepositData.ssz_type, 2**DEPOSIT_CONTRACT_TREE_DEPTH)
    return t.hash_tree_root(deposit_data_list)


def _empty_block_body_root(types, fork: str) -> bytes:
    return types.block_body[fork]().hash_tree_root()


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
    types,
    spec: ChainSpec,
):
    """Spec genesis: apply deposits one by one with incremental deposit root
    (genesis.rs ``initialize_beacon_state_from_eth1``)."""
    from .per_block import apply_deposit

    S = types.state["phase0"]
    state = S(
        genesis_time=eth1_timestamp + spec.genesis_delay,
        fork=types.Fork(
            previous_version=spec.genesis_fork_version,
            current_version=spec.genesis_fork_version,
            epoch=GENESIS_EPOCH,
        ),
        eth1_data=types.Eth1Data(
            deposit_root=bytes(32), deposit_count=len(deposits), block_hash=eth1_block_hash
        ),
        latest_block_header=types.BeaconBlockHeader(
            body_root=_empty_block_body_root(types, "phase0")
        ),
        randao_mixes=[eth1_block_hash] * spec.preset.epochs_per_historical_vector,
    )
    leaves = []
    for deposit in deposits:
        leaves.append(deposit.data)
        state.eth1_data.deposit_root = deposit_tree_root(leaves, types)
        apply_deposit(state, deposit, types, spec, verify_proof=True)

    _finalize_genesis_validators(state, spec)
    state.genesis_validators_root = state.fields["validators"].hash_tree_root(state.validators)
    return state


def _finalize_genesis_validators(state, spec: ChainSpec) -> None:
    from . import safe_arith as sa

    for index, v in enumerate(state.validators):
        balance = int(state.balances[index])
        v.effective_balance = min(
            sa.safe_sub(balance, sa.safe_mod(balance, spec.effective_balance_increment)),
            spec.max_effective_balance,
        )
        if v.effective_balance == spec.max_effective_balance:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH
    h.invalidate_caches(state)


def is_valid_genesis_state(state, spec: ChainSpec) -> bool:
    if state.genesis_time < spec.min_genesis_time:
        return False
    active = h.get_active_validator_indices(state, GENESIS_EPOCH)
    return len(active) >= spec.min_genesis_active_validator_count


def interop_genesis_state(
    n_validators: int,
    types,
    spec: ChainSpec,
    genesis_time: int = 1_600_000_000,
    fork: Optional[str] = None,
    eth1_block_hash: bytes = b"\x42" * 32,
):
    """Deterministic-keypair genesis at the requested fork (default: the fork
    active at genesis per the spec's schedule)."""
    S = types.state["phase0"]
    deposit_data = []
    validators = []
    balances = []
    for i in range(n_validators):
        _, pk = interop_keypair(i)
        deposit_data.append(
            types.DepositData(
                pubkey=pk,
                withdrawal_credentials=interop_withdrawal_credentials(pk),
                amount=spec.max_effective_balance,
            )
        )
        validators.append(
            types.Validator(
                pubkey=pk,
                withdrawal_credentials=interop_withdrawal_credentials(pk),
                effective_balance=spec.max_effective_balance,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH,
                activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        balances.append(spec.max_effective_balance)

    state = S(
        genesis_time=genesis_time,
        fork=types.Fork(
            previous_version=spec.genesis_fork_version,
            current_version=spec.genesis_fork_version,
            epoch=GENESIS_EPOCH,
        ),
        eth1_data=types.Eth1Data(
            deposit_root=deposit_tree_root(deposit_data, types),
            deposit_count=n_validators,
            block_hash=eth1_block_hash,
        ),
        eth1_deposit_index=n_validators,
        latest_block_header=types.BeaconBlockHeader(
            body_root=_empty_block_body_root(types, "phase0")
        ),
        randao_mixes=[eth1_block_hash] * spec.preset.epochs_per_historical_vector,
        validators=validators,
        balances=balances,
    )
    _finalize_genesis_validators(state, spec)
    state.genesis_validators_root = state.fields["validators"].hash_tree_root(state.validators)

    target_fork = fork if fork is not None else spec.fork_name_at_epoch(GENESIS_EPOCH)
    state = upgrade_state(state, target_fork, types, spec)
    if hasattr(state, "latest_execution_payload_header"):
        # Post-merge genesis: install a non-default execution header so the
        # merge transition is complete from slot 0 (the reference harness's
        # post-merge genesis does the same).
        hdr = state.latest_execution_payload_header
        hdr.block_hash = sha256(b"interop-execution-block" + eth1_block_hash).digest()
        hdr.prev_randao = eth1_block_hash
        hdr.timestamp = genesis_time
    return state
