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
