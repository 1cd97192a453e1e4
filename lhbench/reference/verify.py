"""The plain reference verdict of one verify call, and its control.

``verify_call`` is batch verification as the Ethereum consensus clients
define it (Lighthouse ``crypto/bls/src/impls/blst.rs:35-117``): an empty
call fails; each set's signature is decoded and subgroup-checked; a set with
no keys fails; each set's keys are summed; with a nonzero 64-bit random
weight ``r_i`` per set, one multi-pairing decides

    e(-g1, sum_i [r_i] sig_i) * prod_i e([r_i] aggpk_i, H(m_i)) == 1.

It runs on this package's frozen copy of the field, curve, pairing,
hash-to-curve and encoding arithmetic, on the benchmark's own inputs: the
signatures' bytes, the messages and the signers' affine public keys.  It
imports nothing of the program and takes nothing the program made.

``control_hash`` is the control: hash-to-G2 with the cofactor clearing left
out, so ``H(m)`` is a point of the twist but not of G2.  It breaks the
guarantee that messages hash into G2 by the ciphersuite's
``hash_to_curve``, the step a faster hash would be tempted to skip.
"""

from __future__ import annotations

import random
from typing import Callable, Sequence, Tuple

from . import curve, hash_to_curve, serde
from .fields import Fq
from .pairing import multi_pairing_is_one
from .params import DST, RAND_BITS


def control_hash(msg: bytes, dst: bytes):
    u0, u1 = hash_to_curve.hash_to_field_fq2(msg, 2, dst)
    q0 = hash_to_curve.iso_map(hash_to_curve.map_to_curve_simple_swu(u0))
    q1 = hash_to_curve.iso_map(hash_to_curve.map_to_curve_simple_swu(u1))
    return curve.add(q0, q1)


def verify_call(sigs: Sequence[bytes], messages: Sequence[bytes],
                keys: Sequence[Sequence[Tuple[int, int]]], rng: random.Random,
                hash_fn: Callable = hash_to_curve.hash_to_g2,
                subgroup_check: bool = True) -> bool:
    """The verdict on one call: ``sigs[i]`` (96 compressed bytes) over
    ``messages[i]`` by the affine public keys ``keys[i]``.  The weights are
    ``rng.getrandbits(64)``, redrawn while 0.  ``subgroup_check=False``
    leaves the signatures' G2 check out, a fault the benchmark's tests
    plant."""
    if not sigs:
        return False
    sig_acc = None
    pairs = []
    for raw, msg, signers in zip(sigs, messages, keys):
        try:
            sig = serde.g2_decompress(raw)
        except serde.DecodeError:
            return False
        if sig is None or (subgroup_check and not curve.in_g2(sig)):
            return False
        if not signers:
            return False
        agg = None
        for x, y in signers:
            agg = curve.add(agg, (Fq(x), Fq(y)))
        r = 0
        while r == 0:
            r = rng.getrandbits(RAND_BITS)
        sig_acc = curve.add(sig_acc, curve.mul(sig, r))
        pairs.append((curve.mul(agg, r), hash_fn(bytes(msg), DST)))
    pairs.append((curve.neg(curve.G1), sig_acc))
    return multi_pairing_is_one(pairs)
