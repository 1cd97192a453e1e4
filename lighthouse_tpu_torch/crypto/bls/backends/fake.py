"""Always-valid backend, mirroring ``crypto/bls/src/impls/fake_crypto.rs``.

Decouples chain-logic tests from crypto cost: structural failures (empty batch,
missing keys, infinity signature) still fail, so scheduling/fallback logic keeps
its shape, but no pairing runs.  The reference uses the same trick to run its
entire test ladder without BLS cost (SURVEY.md §4, bls_setting gate).
"""

from __future__ import annotations

from typing import Optional


def verify_signature_sets(sets, seed: Optional[bytes] = None) -> bool:
    if not sets:
        return False
    for set_ in sets:
        if not set_.signing_keys:
            return False
    return True
