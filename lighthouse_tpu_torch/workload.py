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
- :func:`block_import_case`: such a state at the first slot of an epoch and
  the full block a mainnet proposer packs for the next slot, every
  signature real (:class:`BlockCase`); :func:`warm_pubkey_cache` and
  :func:`resign` go with it, and :func:`clone_state` copies such a state.
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass
from typing import NamedTuple

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


# ------------------------------------------------------------ block import

#: The shape of a full mainnet block (within the mainnet preset's limits:
#: 128 attestations, 16 withdrawals, 6 blobs): two aggregates a committee
#: of the attested slot, each member in each with this probability (about
#: 90 % of a committee in their union); the sync aggregate's bits set with
#: this probability; validators in the attester slashing; transactions in
#: the payload; blob commitments.
_AGGREGATES_PER_COMMITTEE = 2
_AGGREGATE_P = 0.7
_SYNC_P = 0.95
_SLASHED_ATTESTERS = 256
_TRANSACTIONS = 300
_BLOBS = 6


@dataclass
class CaseKeys:
    """The secret keys of a :class:`BlockCase` (``secret``: validator
    index -> scalar; ``withdrawal``: the BLS-change withdrawal key) and every
    public key a signature of the block needs, as points in G1 by
    construction (``points``: compressed bytes -> affine point)."""

    secret: dict
    withdrawal: int
    points: dict


class BlockCase(NamedTuple):
    """A pre-state, the signed block of its next slot, the types and spec,
    the keys, and the host's post-state (the pre-state's copy run through
    ``state_transition`` without verification, on the host tree-hash
    engines; the block's ``state_root`` is its root)."""

    pre_state: object
    signed_block: object
    types: object
    spec: object
    keys: CaseKeys
    host_state: object


def clone_state(state):
    """``state`` as ``copy.deepcopy`` copies it, its tree-hash and duty
    caches included, several times faster at a mainnet registry: the
    containers and lists are rebuilt and their int, bytes and bool leaves,
    which nothing changes in place, are shared."""
    from .types.ssz import Container

    def clone(value):
        if isinstance(value, Container):
            out = object.__new__(type(value))
            fields = value.fields
            out.__dict__ = {k: v if isinstance(v, (int, bytes)) else
                            clone(v) if k in fields else copy.deepcopy(v)
                            for k, v in value.__dict__.items()}
            return out
        if isinstance(value, list):
            if value and isinstance(value[0], (Container, list, np.ndarray)):
                return [clone(v) for v in value]
            return list(value)
        if isinstance(value, np.ndarray):
            return value.copy()
        return value

    return clone(state)


def _g1_chain(first: int, count: int) -> list:
    """``[first * G, (first + 1) * G, ...]``, ``count`` affine points: one
    scalar multiplication, then one point addition a key."""
    from .crypto.bls import curve

    pt = curve.mul(curve.G1, first)
    out = [pt]
    for _ in range(count - 1):
        pt = curve.add(pt, curve.G1)
        out.append(pt)
    return out


class _Signer:
    """Signs signing roots with sums of secret keys, hashing each message to
    G2 once (an aggregate of members' signatures over one message is the
    sum of their keys times the message's point)."""

    def __init__(self):
        self._points = {}

    def sign(self, message: bytes, scalar: int) -> bytes:
        from .crypto.bls import curve, serde
        from .crypto.bls.hash_to_curve import hash_to_g2
        from .crypto.bls.params import DST

        pt = self._points.get(message)
        if pt is None:
            pt = self._points[message] = hash_to_g2(message, DST)
        return serde.g2_compress(curve.mul(pt, scalar % R))


def resign(case: BlockCase, message):
    """``message`` (a block of ``case``'s slot, e.g. a changed copy of its
    block) signed by its proposer: a block whose body or state root was
    changed still carries a valid proposal signature."""
    from .consensus import helpers as h
    from .types.spec import DOMAIN_BEACON_PROPOSER

    state, spec = case.host_state, case.spec
    domain = h.get_domain(state, DOMAIN_BEACON_PROPOSER,
                          h.compute_epoch_at_slot(int(message.slot), spec), spec)
    root = h.compute_signing_root(message.hash_tree_root(), domain)
    sig = _Signer().sign(root, case.keys.secret[int(message.proposer_index)])
    return case.types.signed_block[type(message).fork_name](message=message, signature=sig)


def warm_pubkey_cache(keys: CaseKeys) -> int:
    """Put ``keys``' public keys into the pubkey cache of
    ``consensus.signature_sets`` (a running node's warm validator pubkey
    cache): the points are in G1 by construction, so no decompression or
    subgroup check runs.  Returns the number of keys."""
    from .consensus import signature_sets
    from .crypto.bls import api

    for raw, pt in keys.points.items():
        signature_sets._PUBKEY_CACHE[raw] = api.PublicKey(pt, _skip_checks=True)
    return len(keys.points)


def block_import_case(n_validators: int, seed: int) -> BlockCase:
    """A Deneb mainnet-preset state of ``n_validators`` validators at the
    first slot of an epoch (:func:`random_state`, its block at that slot
    imported) and the block a mainnet proposer packs for the next slot,
    every field and key made from ``seed``:

    - two aggregates for each committee of the attested slot (the state's
      slot; 64 committees at 2^20 validators), overlapping, about 90 % of
      each committee in their union;
    - a sync aggregate with about 95 % of its bits set (the state's current
      sync committee: distinct validators with real keys);
    - one proposer slashing, one attester slashing (a double vote by
      ``_SLASHED_ATTESTERS`` validators), one voluntary exit and one
      BLS-to-execution change;
    - an execution payload with the 16 withdrawals of the state's sweep, a
      few hundred transactions and 6 blob commitments;
    - no deposits (``eth1_data.deposit_count == eth1_deposit_index``).

    The state holds the eth1 votes of its voting period so far (one a
    slot).  Real BLS keys are made only where a signature needs them (the
    attested committees, the proposer, the sync committee and the subjects
    of the slashings, the exit and the change): key ``s + j`` for the
    ``j``-th of them, its public key one point addition from the last.
    The other validators keep random pubkey bytes.  The pre-state's
    committee cache of its epoch is warm; it has no tree-hash cache yet.
    """
    from .consensus import helpers as h
    from .consensus.per_block import BlockSignatureStrategy
    from .consensus.per_slot import process_slots
    from .consensus.state_transition import state_transition
    from .crypto.bls import curve, serde
    from .ops import tree_hash as th
    from .types.spec import mainnet_spec

    n = n_validators
    spec = mainnet_spec()
    state, types = random_state(n, seed)
    P = types.preset
    if n < 2 * P.sync_committee_size:
        raise ValueError(f"{n} validators: a block case needs at least "
                         f"{2 * P.sync_committee_size}")
    rng = np.random.default_rng([seed, 0xB10C])

    def roots(k: int) -> list:
        raw = rng.integers(0, 256, (k, 32), dtype=np.uint8)
        return [raw[i].tobytes() for i in range(k)]

    spe = spec.slots_per_epoch
    slot = state.slot
    epoch = slot // spe
    set_finality(state, types, leak=False)
    state.fork = types.Fork(previous_version=spec.capella_fork_version,
                            current_version=spec.deneb_fork_version,
                            epoch=spec.deneb_fork_epoch)
    eth1 = types.Eth1Data(deposit_root=roots(1)[0], deposit_count=n, block_hash=roots(1)[0])
    state.eth1_data = eth1
    period = P.epochs_per_eth1_voting_period
    state.eth1_data_votes = [copy.copy(eth1) for _ in range((epoch % period) * spe + 1)]
    parent_hash, header_roots = roots(1)[0], roots(4)
    state.latest_execution_payload_header = types.payload_header["deneb"](
        parent_hash=header_roots[0], fee_recipient=header_roots[1][:20],
        state_root=header_roots[2], receipts_root=header_roots[3],
        prev_randao=roots(1)[0], block_number=19_000_000, gas_limit=30_000_000,
        gas_used=14_000_000, timestamp=state.genesis_time + slot * spec.seconds_per_slot,
        base_fee_per_gas=10 ** 9, block_hash=parent_hash,
        transactions_root=roots(1)[0], withdrawals_root=roots(1)[0],
        blob_gas_used=3 * 131072, excess_blob_gas=0,
    )
    # The withdrawal sweep finds its 16 withdrawals in the window it scans.
    sweep = int(rng.integers(0, n))
    state.next_withdrawal_validator_index = sweep
    state.next_withdrawal_index = 10 ** 8
    withdrawing = [(sweep + 1 + 997 * k) % n for k in range(P.max_withdrawals_per_payload)]
    for i in withdrawing:
        v = state.validators[i]
        v.withdrawal_credentials = b"\x01" + bytes(11) + roots(1)[0][:20]
        v.effective_balance = spec.max_effective_balance
        state.balances[i] = spec.max_effective_balance + int(rng.integers(10 ** 6, 10 ** 8))
    # The block of this slot was imported: the header awaits its state root.
    state.latest_block_header = types.BeaconBlockHeader(
        slot=slot, proposer_index=h.get_beacon_proposer_index(state, spec),
        parent_root=roots(1)[0], state_root=bytes(32), body_root=roots(1)[0])

    # Who signs: the attested slot's committees, the next slot's proposer,
    # the sync committee and the operations' subjects.
    next_slot = slot + 1
    count = h.get_committee_count_per_slot(state, epoch, spec)
    committees = [h.get_beacon_committee(state, slot, c, spec) for c in range(count)]
    attesters = np.unique(np.concatenate(committees))
    proposer = h.get_beacon_proposer_index(state, spec, next_slot)
    others = rng.permutation(np.setdiff1d(
        np.arange(n), np.concatenate([attesters, [proposer], withdrawing])))
    sync_members = others[:P.sync_committee_size]
    rest = others[P.sync_committee_size:]
    slashed_proposer, exiting, changing = (int(x) for x in rest[:3])
    slashed_attesters = np.sort(rest[3:3 + min(_SLASHED_ATTESTERS, len(rest) - 3)])
    signers = np.unique(np.concatenate([
        attesters, [proposer, slashed_proposer, exiting], sync_members, slashed_attesters]))
    first = int(rng.integers(1, 2 ** 62))
    points = _g1_chain(first, len(signers))
    secret, by_bytes = {}, {}
    for j, (i, pt) in enumerate(zip(signers.tolist(), points)):
        raw = serde.g1_compress(pt)
        state.validators[i].pubkey = raw
        secret[i] = first + j
        by_bytes[raw] = pt
    withdrawal_sk = int(rng.integers(1, 2 ** 62))
    withdrawal_pt = curve.mul(curve.G1, withdrawal_sk)
    withdrawal_pk = serde.g1_compress(withdrawal_pt)
    by_bytes[withdrawal_pk] = withdrawal_pt
    state.validators[changing].withdrawal_credentials = b"\x00" + h.hash(withdrawal_pk)[1:]
    sync_points = [by_bytes[bytes(state.validators[int(i)].pubkey)] for i in sync_members]
    agg = None
    for pt in sync_points:
        agg = curve.add(agg, pt)
    state.current_sync_committee = types.SyncCommittee(
        pubkeys=[bytes(state.validators[int(i)].pubkey) for i in sync_members],
        aggregate_pubkey=serde.g1_compress(agg))
    keys = CaseKeys(secret=secret, withdrawal=withdrawal_sk, points=by_bytes)

    # The host's run: advance a copy to the block's slot, build the block
    # on it, apply it without verification and take the root.
    prev_enabled = th.enabled()
    th.configure(enabled=False)
    try:
        host = process_slots(clone_state(state), next_slot, types, spec)
        block = _block(host, types, spec, keys, committees, slot, proposer,
                       (slashed_proposer, slashed_attesters, exiting, changing),
                       withdrawal_pk, rng, roots)
        unsigned = types.signed_block["deneb"](message=block, signature=bytes(96))
        host = state_transition(host, unsigned, types, spec,
                                strategy=BlockSignatureStrategy.NO_VERIFICATION,
                                validate_result=False)
        block.state_root = host.hash_tree_root()
    finally:
        th.configure(enabled=prev_enabled)
    case = BlockCase(state, None, types, spec, keys, host)
    return case._replace(signed_block=resign(case, block))


def _block(state, types, spec, keys: CaseKeys, committees, att_slot: int, proposer: int,
           subjects, withdrawal_pk: bytes, rng, roots):
    """The unsigned block for ``state`` (advanced to its slot) whose
    signatures are all real: see :func:`block_import_case`."""
    from .consensus import helpers as h
    from .crypto.bls import curve, serde
    from .types.spec import (
        DOMAIN_BEACON_ATTESTER,
        DOMAIN_BEACON_PROPOSER,
        DOMAIN_BLS_TO_EXECUTION_CHANGE,
        DOMAIN_RANDAO,
        DOMAIN_SYNC_COMMITTEE,
        DOMAIN_VOLUNTARY_EXIT,
    )
    from .types.ssz import UintType

    signer = _Signer()
    sk = keys.secret
    slot, spe = int(state.slot), spec.slots_per_epoch
    epoch = slot // spe
    parent_root = state.latest_block_header.hash_tree_root()
    slashed_proposer, slashed_attesters, exiting, changing = subjects

    def signed(root: bytes, domain: bytes, scalar: int) -> bytes:
        return signer.sign(h.compute_signing_root(root, domain), scalar)

    attester_domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, epoch, spec)
    attestations = []
    for c, committee in enumerate(committees):
        data = types.AttestationData(
            slot=att_slot, index=c, beacon_block_root=parent_root,
            source=state.current_justified_checkpoint,
            target=types.Checkpoint(epoch=att_slot // spe, root=parent_root))
        data_root = data.hash_tree_root()
        for _ in range(_AGGREGATES_PER_COMMITTEE):
            bits = rng.random(len(committee)) < _AGGREGATE_P
            bits[rng.integers(0, len(committee))] = True
            scalar = sum(sk[int(v)] for v in committee[bits])
            attestations.append(types.Attestation(
                aggregation_bits=bits.tolist(), data=data,
                signature=signed(data_root, attester_domain, scalar)))

    # A proposer slashing: two headers of one earlier slot.
    header_slot = slot - 7
    header_domain = h.get_domain(state, DOMAIN_BEACON_PROPOSER, header_slot // spe, spec)
    headers = []
    for body_root in roots(2):
        header = types.BeaconBlockHeader(slot=header_slot, proposer_index=slashed_proposer,
                                         parent_root=roots(1)[0], state_root=roots(1)[0],
                                         body_root=body_root)
        headers.append(types.SignedBeaconBlockHeader(
            message=header,
            signature=signed(header.hash_tree_root(), header_domain, sk[slashed_proposer])))
    proposer_slashing = types.ProposerSlashing(signed_header_1=headers[0],
                                               signed_header_2=headers[1])

    # An attester slashing: a double vote in the previous epoch.
    prev = epoch - 1
    prev_domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, prev, spec)
    scalar = sum(sk[int(v)] for v in slashed_attesters)
    target = types.Checkpoint(epoch=prev, root=roots(1)[0])
    source = types.Checkpoint(epoch=prev - 1, root=roots(1)[0])
    indexed = []
    for head in roots(2):
        data = types.AttestationData(slot=prev * spe + 3, index=0, beacon_block_root=head,
                                     source=source, target=target)
        indexed.append(types.IndexedAttestation(
            attesting_indices=slashed_attesters.tolist(), data=data,
            signature=signed(data.hash_tree_root(), prev_domain, scalar)))
    attester_slashing = types.AttesterSlashing(attestation_1=indexed[0],
                                               attestation_2=indexed[1])

    # A voluntary exit (deneb: the capella fork's domain, EIP-7044) and a
    # BLS-to-execution change (the genesis fork's domain).
    exit_ = types.VoluntaryExit(epoch=epoch, validator_index=exiting)
    exit_domain = h.compute_domain(DOMAIN_VOLUNTARY_EXIT, spec.capella_fork_version,
                                   state.genesis_validators_root)
    signed_exit = types.SignedVoluntaryExit(
        message=exit_, signature=signed(exit_.hash_tree_root(), exit_domain, sk[exiting]))
    change = types.BLSToExecutionChange(validator_index=changing,
                                        from_bls_pubkey=withdrawal_pk,
                                        to_execution_address=roots(1)[0][:20])
    change_domain = h.compute_domain(DOMAIN_BLS_TO_EXECUTION_CHANGE, spec.genesis_fork_version,
                                     state.genesis_validators_root)
    signed_change = types.SignedBLSToExecutionChange(
        message=change,
        signature=signed(change.hash_tree_root(), change_domain, keys.withdrawal))

    # The sync aggregate over the previous slot's block root.
    committee = state.current_sync_committee
    index = {bytes(state.validators[i].pubkey): i for i in sk}
    members = [index[bytes(pk)] for pk in committee.pubkeys]
    bits = rng.random(len(members)) < _SYNC_P
    sync_domain = h.get_domain(state, DOMAIN_SYNC_COMMITTEE, (slot - 1) // spe, spec)
    sync_root = h.get_block_root_at_slot(state, slot - 1, spec)
    sync_aggregate = types.SyncAggregate(
        sync_committee_bits=bits.tolist(),
        sync_committee_signature=signed(
            sync_root, sync_domain, sum(sk[m] for m, b in zip(members, bits) if b)))

    # The execution payload: the sweep's withdrawals, seeded transactions.
    lengths = rng.integers(100, 700, _TRANSACTIONS)
    transactions = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes() for k in lengths]
    header = state.latest_execution_payload_header
    payload = types.execution_payload["deneb"](
        parent_hash=header.block_hash, fee_recipient=roots(1)[0][:20],
        state_root=roots(1)[0], receipts_root=roots(1)[0],
        logs_bloom=rng.integers(0, 256, 256, dtype=np.uint8).tobytes(),
        prev_randao=h.get_randao_mix(state, epoch, spec),
        block_number=int(header.block_number) + 1, gas_limit=int(header.gas_limit),
        gas_used=int(lengths.sum()) * 40, timestamp=state.genesis_time + slot * spec.seconds_per_slot,
        extra_data=b"lighthouse-tpu", base_fee_per_gas=int(header.base_fee_per_gas),
        block_hash=roots(1)[0], transactions=transactions,
        withdrawals=h.get_expected_withdrawals(state, types, spec),
        blob_gas_used=_BLOBS * 131072, excess_blob_gas=0)
    commitments = [serde.g1_compress(curve.mul(curve.G1, int(k)))
                   for k in rng.integers(1, 2 ** 62, _BLOBS)]

    randao_domain = h.get_domain(state, DOMAIN_RANDAO, epoch, spec)
    body = types.block_body["deneb"](
        randao_reveal=signed(UintType(8).hash_tree_root(epoch), randao_domain, sk[proposer]),
        eth1_data=state.eth1_data, graffiti=roots(1)[0],
        proposer_slashings=[proposer_slashing], attester_slashings=[attester_slashing],
        attestations=attestations, deposits=[], voluntary_exits=[signed_exit],
        sync_aggregate=sync_aggregate, execution_payload=payload,
        bls_to_execution_changes=[signed_change], blob_kzg_commitments=commitments)
    return types.block["deneb"](slot=slot, proposer_index=proposer, parent_root=parent_root,
                                state_root=bytes(32), body=body)
