"""The one generator of the benchmark's traffic: gossip signature sets of a
beacon-chain deployment, made from a seed.

A deployment (``lhbench/configs/<config>.json``) fixes the committees of a
slot: ``committees_per_slot`` committees of ``committee_size`` validators,
``aggregators_per_committee`` aggregators in each.  A traffic mix
(``lhbench/traffic/<mix>.json``) fixes what arrives and how: the kinds of
signature set one gossip item carries (``item_sets``), how many slots of
items are made, how many items one verify call carries, the rate at which
calls arrive and how many may be in flight, the aggregates' participation
and how many calls carry a tampered signature.

Set kinds:

- ``attestation``: one committee member signs its committee's attestation
  data root (an unaggregated attestation; one key).
- ``selection_proof``: an aggregator signs the slot (one key, one message a
  slot).
- ``aggregate``: a committee's participants sign its attestation data root
  (one key a participant).
- ``aggregate_and_proof``: an aggregator signs its ``AggregateAndProof``
  root (one key, a message of its own).

An item of ``attestation`` is one member of a committee, and a slot has
``committees_per_slot * committee_size`` of them; an item of the other
kinds is one aggregator, and a slot has ``committees_per_slot *
aggregators_per_committee``.  Items are shuffled within their slot, as
gossip from every subnet interleaves, and cut into calls in that order.

Keys: validator ``v``'s secret key is ``s0 + v * delta`` (mod r), so its
public key is ``pk_0 + v * D`` and a committee's signatures over one
message are a chain ``sig_{j+1} = sig_j + delta * H(m)``: one point
addition a key or a signature.  ``s0`` and ``delta`` come from the seed.
Committees are contiguous runs of validator indices; the verifier's work
does not depend on which indices sign.

The work is split by committee over worker processes (``make``); each
worker's part depends on the seed and its committee alone, so a seed gives
the same traffic whatever the number of workers.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import ec
from .reference.params import R

HERE = Path(__file__).resolve().parent

MEMBER_KINDS = ("attestation",)
AGGREGATOR_KINDS = ("selection_proof", "aggregate", "aggregate_and_proof")


@dataclass(frozen=True)
class Deployment:
    name: str
    active_validators: int
    committees_per_slot: int
    committee_size: int
    aggregators_per_committee: int

    @classmethod
    def load(cls, name: str) -> "Deployment":
        raw = json.loads((HERE / "configs" / f"{name}.json").read_text())
        return cls(name=name, active_validators=int(raw["active_validators"]),
                   committees_per_slot=int(raw["committees_per_slot"]),
                   committee_size=int(raw["committee_size"]),
                   aggregators_per_committee=int(raw["target_aggregators_per_committee"]))


@dataclass(frozen=True)
class Mix:
    name: str
    item_sets: Tuple[str, ...]
    slots: int
    offered_sets_per_s: float
    items_per_call: int
    max_in_flight_calls: int
    participation: Tuple[float, float]
    tampered_per_million: int
    warmup_s: float
    sample_calls: int

    @classmethod
    def load(cls, name: str) -> "Mix":
        raw = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        return cls.from_dict(name, raw)

    @classmethod
    def from_dict(cls, name: str, raw: dict) -> "Mix":
        kinds = tuple(raw["item_sets"])
        unknown = set(kinds) - set(MEMBER_KINDS) - set(AGGREGATOR_KINDS)
        if unknown or not kinds:
            raise ValueError(f"{name}: unknown set kinds {sorted(unknown)}")
        if set(kinds) & set(MEMBER_KINDS) and set(kinds) & set(AGGREGATOR_KINDS):
            raise ValueError(f"{name}: an item is a committee member or an aggregator, not both")
        lo, hi = raw.get("participation", (1.0, 1.0))
        return cls(name=name, item_sets=kinds, slots=int(raw["slots"]),
                   offered_sets_per_s=float(raw["offered_sets_per_s"]),
                   items_per_call=int(raw["items_per_call"]),
                   max_in_flight_calls=int(raw["max_in_flight_calls"]),
                   participation=(float(lo), float(hi)),
                   tampered_per_million=int(raw.get("tampered_per_million", 0)),
                   warmup_s=float(raw["warmup_s"]), sample_calls=int(raw["sample_calls"]))

    @property
    def per_member(self) -> bool:
        return self.item_sets[0] in MEMBER_KINDS

    @property
    def sets_per_call(self) -> int:
        return self.items_per_call * len(self.item_sets)


class Call:
    """One verify call: parallel lists, one entry a signature set, and
    whether every set in it is valid."""

    __slots__ = ("index", "sigs", "messages", "signers", "valid")

    def __init__(self, index: int, sigs: List[bytes], messages: List[bytes],
                 signers: List[Tuple[int, ...]], valid: bool = True):
        self.index = index
        self.sigs = sigs
        self.messages = messages
        self.signers = signers
        self.valid = valid

    @property
    def n_sets(self) -> int:
        return len(self.sigs)

    @property
    def n_keys(self) -> int:
        return sum(len(s) for s in self.signers)


@dataclass
class Traffic:
    deployment: Deployment
    mix: Mix
    seed: int
    calls: List[Call]
    #: affine public key ``(x, y)`` of each validator index ``0..len-1``
    keys: List[Tuple[int, int]]


# ----------------------------------------------------------- the secrets

def _key_params(seed: int) -> Tuple[int, int]:
    rng = random.Random(f"lhbench-keys-{seed}")
    return rng.randrange(1, R), rng.randrange(1, R)


def _secret(seed_params: Tuple[int, int], v: int) -> int:
    s0, delta = seed_params
    return (s0 + v * delta) % R


def _message(seed: int, *parts) -> bytes:
    tag = "/".join(str(p) for p in parts)
    return hashlib.sha256(f"lhbench/{seed}/{tag}".encode()).digest()


def _slot_base(dep: Deployment, slot: int) -> int:
    return slot * dep.committees_per_slot * dep.committee_size


# --------------------------------------------------------- worker tasks

def _keys_task(args) -> List[Tuple[int, int]]:
    seed, start, count = args
    params = _key_params(seed)
    step = ec.g1_affine([ec.mul(ec.G1_OPS, ec.G1, params[1])])[0]
    step = (step[0], step[1], 1)
    acc = ec.mul(ec.G1_OPS, ec.G1, _secret(params, start))
    out = [acc]
    for _ in range(count - 1):
        acc = ec._g1_add(acc, step)
        out.append(acc)
    return ec.g1_affine(out)


def _affine2(pt):
    a = ec.g2_affine([pt])[0]
    return (a[0], a[1], (1, 0))


def _member_chain(params, v0: int, count: int, h):
    """``[sk_{v0 + j}] H`` for ``j < count``, Jacobian."""
    step = _affine2(ec.mul(ec.G2_OPS, h, params[1]))
    acc = ec.mul(ec.G2_OPS, h, _secret(params, v0))
    out = [acc]
    for _ in range(count - 1):
        acc = ec._g2_add(acc, step)
        out.append(acc)
    return out


def _committee_task(args) -> List[tuple]:
    """Every item of committee ``c`` of ``slot``: a list of ``(sigs,
    messages, signers)`` with one entry a set kind of the mix."""
    seed, dep, mix, slot, c = args
    params = _key_params(seed)
    size = dep.committee_size
    v0 = _slot_base(dep, slot) + c * size
    m_c = _message(seed, "attestation-data", slot, c)
    h_c = ec.hash_to_g2(m_c)
    if mix.per_member:
        sigs = [ec.g2_compress(p) for p in ec.g2_affine(_member_chain(params, v0, size, h_c))]
        return [((sigs[j],), (m_c,), ((v0 + j,),)) for j in range(size)]

    rng = random.Random(f"lhbench-aggregators-{seed}-{slot}-{c}")
    positions = sorted(rng.sample(range(size), dep.aggregators_per_committee))
    kinds = set(mix.item_sets)
    points: List[object] = []   # Jacobian results, normalised together below
    items = []
    if "aggregate" in kinds:
        members = ec.g2_affine(_member_chain(params, v0, size, h_c))
        total = sum(_secret(params, v0 + j) for j in range(size)) % R
        everyone = ec.mul(ec.G2_OPS, h_c, total)
    if "selection_proof" in kinds:
        m_sel = _message(seed, "selection", slot)
        h_sel = ec.hash_to_g2(m_sel)
        sel_base = ec.mul(ec.G2_OPS, h_sel, params[0])
        sel_step = ec.mul(ec.G2_OPS, h_sel, params[1])
    lo, hi = mix.participation
    for t, pos in enumerate(positions):
        agg_v = v0 + pos
        entry = {}
        if "selection_proof" in kinds:
            points.append(ec._g2_add(sel_base, ec.mul(ec.G2_OPS, sel_step, agg_v)))
            entry["selection_proof"] = (len(points) - 1, m_sel, (agg_v,))
        if "aggregate" in kinds:
            n_part = max(1, round(size * rng.uniform(lo, hi)))
            missing = set(rng.sample(range(size), size - n_part))
            acc = everyone
            for j in sorted(missing):
                x, y = members[j]
                acc = ec._g2_add(acc, (x, ec.f2_neg(y), (1, 0)))
            points.append(acc)
            signers = tuple(v0 + j for j in range(size) if j not in missing)
            entry["aggregate"] = (len(points) - 1, m_c, signers)
        if "aggregate_and_proof" in kinds:
            m_o = _message(seed, "aggregate-and-proof", slot, c, t)
            points.append(ec.mul(ec.G2_OPS, ec.hash_to_g2(m_o), _secret(params, agg_v)))
            entry["aggregate_and_proof"] = (len(points) - 1, m_o, (agg_v,))
        items.append(entry)
    sigs = [ec.g2_compress(p) for p in ec.g2_affine(points)]
    out = []
    for entry in items:
        parts = [entry[k] for k in mix.item_sets]
        out.append((tuple(sigs[i] for i, _, _ in parts), tuple(m for _, m, _ in parts),
                    tuple(s for _, _, s in parts)))
    return out


# -------------------------------------------------------------- assembly

def pool_size() -> int:
    """Worker processes for set-up and the reference: the host's cores, at
    most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def run_tasks(fn, tasks: Sequence, workers: int) -> list:
    """``[fn(t) for t in tasks]``, over ``workers`` spawned processes when
    there is more than one; they are stopped and joined before this
    returns, and a worker that dies raises here."""
    if workers <= 1 or len(tasks) <= 1:
        return [fn(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, len(tasks)), mp_context=ctx) as pool:
        return list(pool.map(fn, tasks))


def make(dep: Deployment, mix: Mix, seed: int, workers: Optional[int] = None) -> Traffic:
    """The traffic of ``mix`` on ``dep`` for ``seed``."""
    workers = pool_size() if workers is None else workers
    n_keys = mix.slots * dep.committees_per_slot * dep.committee_size
    if n_keys > dep.active_validators:
        raise ValueError(f"{mix.name} on {dep.name}: {mix.slots} slots of distinct "
                         f"signers exceed the registry")
    chunk = -(-n_keys // max(1, workers * 4))
    key_tasks = [(seed, s, min(chunk, n_keys - s)) for s in range(0, n_keys, chunk)]
    committee_tasks = [(seed, dep, mix, slot, c) for slot in range(mix.slots)
                       for c in range(dep.committees_per_slot)]
    results = run_tasks(_generate, [("keys", t) for t in key_tasks]
                        + [("committee", t) for t in committee_tasks], workers)
    keys = [k for part in results[:len(key_tasks)] for k in part]
    by_slot: Dict[int, list] = {}
    for (_, _, _, slot, _), items in zip(committee_tasks, results[len(key_tasks):]):
        by_slot.setdefault(slot, []).extend(items)
    stream = []
    for slot in range(mix.slots):
        items = by_slot[slot]
        random.Random(f"lhbench-order-{seed}-{slot}").shuffle(items)
        stream.extend(items)
    calls = []
    for i in range(0, len(stream) - mix.items_per_call + 1, mix.items_per_call):
        chunk_items = stream[i:i + mix.items_per_call]
        calls.append(Call(len(calls),
                          [s for it in chunk_items for s in it[0]],
                          [m for it in chunk_items for m in it[1]],
                          [k for it in chunk_items for k in it[2]]))
    _tamper(calls, mix, seed)
    return Traffic(dep, mix, seed, calls, keys)


def _generate(task):
    kind, args = task
    return _keys_task(args) if kind == "keys" else _committee_task(args)


def _tamper(calls: List[Call], mix: Mix, seed: int) -> None:
    """Give ``tampered_per_million`` of a million calls (drawn from the
    seed) another set's signature in their first set: a valid point that
    signs another message, so the call must fail."""
    if not mix.tampered_per_million or len(calls) < 2:
        return
    rng = random.Random(f"lhbench-tamper-{seed}")
    for i, call in enumerate(calls):
        if rng.randrange(1_000_000) < mix.tampered_per_million:
            donor = calls[i + 1] if i + 1 < len(calls) else calls[i - 1]
            call.sigs[0] = donor.sigs[-1]
            call.valid = False
