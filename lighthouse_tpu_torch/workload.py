"""Signature sets for driving the verifier at a chosen (sets, keys) shape.

One committee of ``n_keys`` keys signs ``n_sets`` distinct messages; each
set's aggregate signature is the committee's summed secret key signing the
message, which equals the aggregate of the members' signatures and costs one
signing per set (the JAX package's ``bench.py:_build_sig_sets`` shape).
"""

from __future__ import annotations

import random

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
