"""Inputs for driving the port at a chosen shape, made from a seed.

- :func:`committee_sets`: signature sets for the verifier at a (sets,
  keys) shape.  One committee of ``n_keys`` keys signs ``n_sets`` distinct
  messages; each set's aggregate signature is the committee's summed
  secret key signing the message, which equals the aggregate of the
  members' signatures and costs one signing per set (the JAX package's
  ``bench.py:_build_sig_sets`` shape).
- :func:`random_state`, :func:`mutate_balances` and
  :func:`append_validators`: a Deneb ``BeaconState`` of the mainnet preset
  with a registry of any size, and one slot's worth of changes to it, for
  state tree hashing.  Every field that a node's state
  fills is filled (random roots, pubkeys and credentials, balances around
  32 ETH, participation flags, inactivity scores); pubkeys are random
  bytes, which hashing does not need to be valid keys.
- :func:`boundary_state`: such a state one slot before an epoch boundary,
  with work for every mask of the epoch transition (ejections, the
  activation queue, pending activations, slashings) and a finalized
  checkpoint set for an inactivity leak or not.
"""

from __future__ import annotations

import random

import numpy as np

from .crypto.bls import api
from .crypto.bls.params import R


def committee_sets(n_sets: int, n_keys: int, seed: int) -> list:
    rng = random.Random(seed)
    sks = [api.SecretKey(rng.randrange(1, R)) for _ in range(n_keys)]
    pks = [sk.public_key() for sk in sks]
    agg_sk = api.SecretKey(sum(sk.scalar for sk in sks) % R)
    sets = []
    for i in range(n_sets):
        msg = (i.to_bytes(2, "big") + bytes([seed & 0xFF])) * 10 + b"\x00\x00"
        sets.append(api.SignatureSet.multiple_pubkeys(agg_sk.sign(msg), pks, msg))
    return sets


#: Gwei of one effective-balance increment and of a full deposit.
_INCREMENT = 10 ** 9
_MAX_EFFECTIVE = 32 * _INCREMENT


def _validators(types, rng, n: int) -> list:
    keys = rng.integers(0, 256, (n, 48 + 32), dtype=np.uint8)
    eff = (rng.integers(16, 33, n) * _INCREMENT).tolist()
    far = 2 ** 64 - 1
    return [types.Validator(
        pubkey=keys[i, :48].tobytes(), withdrawal_credentials=keys[i, 48:].tobytes(),
        effective_balance=eff[i], slashed=False, activation_eligibility_epoch=0,
        activation_epoch=0, exit_epoch=far, withdrawable_epoch=far,
    ) for i in range(n)]


def random_state(n_validators: int, seed: int, preset: str = "mainnet"):
    """A Deneb ``BeaconState`` of ``preset`` with ``n_validators``
    validators, every field made from ``seed``; returns ``(state, types)``."""
    from .types.containers import build_types
    from .types.spec import MAINNET_PRESET, MINIMAL_PRESET

    types = build_types({"mainnet": MAINNET_PRESET, "minimal": MINIMAL_PRESET}[preset])
    P = types.preset
    rng = np.random.default_rng(seed)

    def roots(k: int) -> list:
        raw = rng.integers(0, 256, (k, 32), dtype=np.uint8)
        return [raw[i].tobytes() for i in range(k)]

    n = n_validators
    epoch = 300_000
    state = types.state["deneb"](
        genesis_time=1_606_824_023,
        genesis_validators_root=roots(1)[0],
        slot=epoch * P.slots_per_epoch,
        block_roots=roots(P.slots_per_historical_root),
        state_roots=roots(P.slots_per_historical_root),
        randao_mixes=roots(P.epochs_per_historical_vector),
        slashings=rng.integers(0, 2 ** 40, P.epochs_per_slashings_vector).tolist(),
        validators=_validators(types, rng, n),
        balances=(_MAX_EFFECTIVE + rng.integers(-2 ** 30, 2 ** 30, n)).tolist(),
        previous_epoch_participation=rng.integers(0, 8, n).tolist(),
        current_epoch_participation=rng.integers(0, 8, n).tolist(),
        inactivity_scores=rng.integers(0, 64, n).tolist(),
        eth1_deposit_index=n,
    )
    return state, types


def mutate_balances(state, seed: int, dirty_fraction: float = 0.01,
                    effective: int = 64) -> dict:
    """The balance side of one slot's changes to ``state``:
    ``dirty_fraction`` of the balances and ``effective`` validators'
    effective balances.  Returns the counts."""
    rng = np.random.default_rng(seed)
    n = len(state.balances)
    dirty = rng.choice(n, int(n * dirty_fraction), replace=False)
    for i, delta in zip(dirty.tolist(), rng.integers(1, 10 ** 6, dirty.size).tolist()):
        state.balances[i] += delta
    for i in rng.choice(n, effective, replace=False).tolist():
        state.validators[i].effective_balance -= _INCREMENT
    return {"balances": int(dirty.size), "effective_balances": effective}


def append_validators(state, types, seed: int, count: int = 16) -> dict:
    """The deposit side of one slot's changes: ``count`` new validators with
    their balances, participation and inactivity entries."""
    rng = np.random.default_rng(seed)
    state.validators.extend(_validators(types, rng, count))
    state.balances.extend([_MAX_EFFECTIVE] * count)
    state.previous_epoch_participation.extend([0] * count)
    state.current_epoch_participation.extend([0] * count)
    state.inactivity_scores.extend([0] * count)
    return {"appended": count}


def boundary_state(n_validators: int, seed: int, leak: bool, preset: str = "mainnet"):
    """A Deneb ``BeaconState`` of ``preset`` one slot before an epoch
    boundary, made from ``seed`` (:func:`random_state`); returns
    ``(state, types)``.  Effective balances follow the balances (32 ETH
    at most, as hysteresis leaves them), and a few validators in each 4,096
    give the transition's masks work: effective balances at the ejection
    balance, validators in the activation queue, validators eligible for
    activation, and slashed validators (withdrawable past this epoch's
    slashings penalty, so every balance stays as the fused boundary saw it
    and its proposers prime the duty cache).
    The finalized checkpoint is set for an inactivity leak or not
    (:func:`set_finality`).  The epoch after the boundary starts no
    sync-committee period (``random_state``'s pubkeys are not curve
    points) and no historical-summary period."""
    from .types.spec import FAR_FUTURE_EPOCH

    state, types = random_state(n_validators, seed, preset)
    P = types.preset
    current = state.slot // P.slots_per_epoch
    next_epoch = current + 1
    if next_epoch % P.epochs_per_sync_committee_period == 0 or \
            next_epoch % (P.slots_per_historical_root // P.slots_per_epoch) == 0:
        raise ValueError(f"epoch {next_epoch} starts a sync-committee or historical period")
    state.slot += P.slots_per_epoch - 1
    rng = np.random.default_rng(seed + 1)
    n = n_validators
    balances = np.asarray(state.balances, dtype=np.int64)
    eff = np.minimum(balances - balances % _INCREMENT, _MAX_EFFECTIVE)
    for v, e in zip(state.validators, eff.tolist()):
        v.effective_balance = e
    k = max(1, n // 4096)
    picks = rng.choice(n, 4 * k, replace=False).tolist()
    ejected, queued, pending, slashed = (picks[i * k:(i + 1) * k] for i in range(4))
    for i in ejected:
        state.validators[i].effective_balance = 16 * _INCREMENT
        state.balances[i] = 16 * _INCREMENT
    for i in queued + pending:
        v = state.validators[i]
        v.activation_eligibility_epoch = FAR_FUTURE_EPOCH if i in queued else 0
        v.activation_epoch = FAR_FUTURE_EPOCH
        v.effective_balance = _MAX_EFFECTIVE
    for i in slashed:
        v = state.validators[i]
        v.slashed = True
        v.exit_epoch = current + 2
        v.withdrawable_epoch = current + P.epochs_per_slashings_vector // 2 + 1
    set_finality(state, types, leak)
    return state, types


def set_finality(state, types, leak: bool) -> None:
    """Put ``state``'s finalized checkpoint ten epochs back (the boundary's
    transition then runs in an inactivity leak) or two, the justified
    checkpoints one and two epochs after it."""
    current = state.slot // types.preset.slots_per_epoch
    finalized = current - (10 if leak else 2)
    state.finalized_checkpoint = types.Checkpoint(epoch=finalized, root=bytes(32))
    state.previous_justified_checkpoint = types.Checkpoint(epoch=finalized, root=bytes(32))
    state.current_justified_checkpoint = types.Checkpoint(epoch=finalized + 1, root=bytes(32))
