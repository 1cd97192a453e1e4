"""The generator's arithmetic and traffic against the plain reference, and
the control against both."""

import random

import pytest

from lhbench import ec, gossip
from lhbench.reference import curve, hash_to_curve, serde
from lhbench.reference.params import DST, R
from lhbench.reference.verify import control_hash, verify_call

TINY = gossip.Deployment("tiny", 1 << 20, 2, 6, 2)
ATTESTATIONS = {"item_sets": ["attestation"], "slots": 1, "offered_sets_per_s": 20, "max_in_flight_calls": 4, "items_per_call": 3,
                "warmup_s": 0.3, "sample_calls": 2}
AGGREGATES = {"item_sets": ["selection_proof", "aggregate", "aggregate_and_proof"], "slots": 1,
              "offered_sets_per_s": 20, "max_in_flight_calls": 4, "items_per_call": 2, "participation": [0.5, 1.0],
              "warmup_s": 0.3, "sample_calls": 2}


def _g2(pt):
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(32), b"q" * 200])
def test_hash_to_g2_is_the_references(msg):
    assert ec.g2_affine([ec.hash_to_g2(msg)])[0] == _g2(hash_to_curve.hash_to_g2(msg, DST))


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, R - 1, 0xD201000000010000, 987654321987654321])
def test_scalar_multiplication_and_encodings_are_the_references(k):
    g1 = ec.g1_affine([ec.mul(ec.G1_OPS, ec.G1, k)])[0]
    ref1 = curve.mul(curve.G1, k)
    assert g1 == (ref1[0].n, ref1[1].n)
    assert ec.g1_compress(g1) == serde.g1_compress(ref1)
    g2 = ec.g2_affine([ec.mul(ec.G2_OPS, ec.G2, k)])[0]
    ref2 = curve.mul(curve.G2, k)
    assert g2 == _g2(ref2)
    assert ec.g2_compress(g2) == serde.g2_compress(ref2)


def test_point_addition_edge_cases():
    p = ec.mul(ec.G2_OPS, ec.G2, 5)
    assert ec.g2_affine([ec._g2_add(p, p)]) == ec.g2_affine([ec._g2_dbl(p)])
    assert ec._g2_add(p, ec._g2_neg(p)) is None
    q = ec.mul(ec.G1_OPS, ec.G1, 5)
    assert ec._g1_add(q, ec._g1_neg(q)) is None


def _verdicts(traffic, **kwargs):
    out = []
    for call in traffic.calls:
        keys = [[traffic.keys[v] for v in s] for s in call.signers]
        out.append(verify_call(call.sigs, call.messages, keys, random.Random(call.index), **kwargs))
    return out


@pytest.mark.parametrize("raw", [ATTESTATIONS, AGGREGATES], ids=["attestations", "aggregates"])
def test_reference_accepts_the_traffic_and_the_control_rejects_it(raw):
    traffic = gossip.make(TINY, gossip.Mix.from_dict("t", raw), 2**31 + 7, workers=1)
    assert traffic.calls and all(c.valid for c in traffic.calls)
    calls = traffic.calls[:2]
    traffic.calls = calls
    assert _verdicts(traffic) == [True, True]
    assert _verdicts(traffic, hash_fn=control_hash) == [False, False]


def test_a_tampered_call_fails_and_the_seed_fixes_the_traffic():
    mix = gossip.Mix.from_dict("t", dict(ATTESTATIONS, tampered_per_million=1_000_000))
    traffic = gossip.make(TINY, mix, 5, workers=1)
    assert not any(c.valid for c in traffic.calls)
    traffic.calls = traffic.calls[:1]
    assert _verdicts(traffic) == [False]
    again = gossip.make(TINY, mix, 5, workers=2)
    assert again.calls[0].sigs == traffic.calls[0].sigs and again.keys == traffic.keys


def test_aggregates_carry_their_participants():
    mix = gossip.Mix.from_dict("t", AGGREGATES)
    traffic = gossip.make(TINY, mix, 11, workers=1)
    for call in traffic.calls:
        kinds = call.signers[0::3], call.signers[1::3], call.signers[2::3]
        assert all(len(s) == 1 for s in kinds[0] + kinds[2])
        assert all(3 <= len(s) <= 6 for s in kinds[1])
    # every committee's aggregators and selection message come from the seed
    assert gossip.make(TINY, mix, 11, workers=1).calls[0].messages == traffic.calls[0].messages
