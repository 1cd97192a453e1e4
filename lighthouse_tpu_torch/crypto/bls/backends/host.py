"""Host (pure-Python) batch verification backend — the golden model.

Exact port of the *semantics* of ``crypto/bls/src/impls/blst.rs:35-117``:
empty batch fails; each set contributes a nonzero 64-bit random weight; the
signature is subgroup-checked; sets with no signing keys fail; public keys are
aggregated per set; one multi-pairing decides the batch:

    e(-g1, sum_i r_i sig_i) * prod_i e([r_i] aggpk_i, H(m_i)) == 1
"""

from __future__ import annotations

import secrets
from typing import List, Optional

from .. import curve
from ..hash_to_curve import hash_to_g2
from ..pairing import multi_pairing_is_one
from ..params import DST


def _rand_scalars(n: int, seed: Optional[bytes]) -> List[int]:
    if seed is not None:
        import hashlib

        out = []
        ctr = 0
        while len(out) < n:
            r = int.from_bytes(
                hashlib.sha256(seed + ctr.to_bytes(4, "big")).digest()[:8], "big"
            )
            ctr += 1
            if r:
                out.append(r)
        return out
    out = []
    while len(out) < n:
        r = secrets.randbits(64)
        if r:
            out.append(r)
    return out


def verify_signature_sets(sets, seed: Optional[bytes] = None) -> bool:
    if not sets:
        return False
    rands = _rand_scalars(len(sets), seed)

    sig_acc = None  # sum_i [r_i] sig_i
    pairs = []
    for set_, r in zip(sets, rands):
        sig_pt = set_.signature.point
        if sig_pt is None:
            return False  # "empty" signature fails the batch
        if not curve.in_g2(sig_pt):
            return False
        if not set_.signing_keys:
            return False
        agg_pk = None
        for pk in set_.signing_keys:
            agg_pk = curve.add(agg_pk, pk.point)
        sig_acc = curve.add(sig_acc, curve.mul(sig_pt, r))
        pairs.append((curve.mul(agg_pk, r), hash_to_g2(set_.message, DST)))

    pairs.append((curve.neg(curve.G1), sig_acc))
    return multi_pairing_is_one(pairs)
