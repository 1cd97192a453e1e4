"""Graffiti source precedence for block production.

Equivalent of the reference's
``beacon_node/beacon_chain/src/graffiti_calculator.rs``: the graffiti that
lands in a produced block is chosen, in order, from

1. the validator client's per-request graffiti,
2. the operator's beacon-node flag (``--graffiti``),
3. a CALCULATED string carrying the EL client's name/version (via
   ``engine_getClientVersionV1``) next to our own version,
4. the bare client version as the last resort.

A copy of the JAX package's ``lighthouse_tpu/chain/graffiti_calculator.py``.
"""

from __future__ import annotations

from typing import Optional

from .. import __version__ as _CL_VERSION

GRAFFITI_BYTES_LEN = 32


def _to_graffiti_bytes(text: str) -> bytes:
    raw = text.encode()[:GRAFFITI_BYTES_LEN]
    return raw + b"\x00" * (GRAFFITI_BYTES_LEN - len(raw))


class GraffitiOrigin:
    USER_SPECIFIED = "user_specified"
    CALCULATED = "calculated"

    def __init__(self, graffiti: bytes, origin: str):
        self.graffiti = graffiti
        self.origin = origin

    @classmethod
    def user(cls, graffiti: bytes) -> "GraffitiOrigin":
        return cls(bytes(graffiti[:GRAFFITI_BYTES_LEN]).ljust(
            GRAFFITI_BYTES_LEN, b"\x00"), cls.USER_SPECIFIED)

    @classmethod
    def default(cls) -> "GraffitiOrigin":
        return cls(_to_graffiti_bytes(f"lighthouse-tpu/{_CL_VERSION}"),
                   cls.CALCULATED)


class GraffitiCalculator:
    # Retry a failed EL identity probe no sooner than this (the reference
    # refreshes on an epoch cadence in the background; block production
    # must never stall re-asking a flaky EL for a graffiti string).
    FAILURE_RETRY_SECONDS = 384.0

    def __init__(self, beacon_graffiti: Optional[GraffitiOrigin] = None,
                 execution_engine=None):
        self.beacon_graffiti = beacon_graffiti or GraffitiOrigin.default()
        self.execution_engine = execution_engine
        self._el_version_cache: Optional[str] = None
        self._el_failed_at: Optional[float] = None

    def _el_client_string(self) -> Optional[str]:
        import time

        engine = self.execution_engine
        if engine is None or not hasattr(engine, "get_client_version"):
            return None
        if self._el_version_cache is not None:
            return self._el_version_cache
        # Negative cache: while the EL is slow/flaky, one failure parks the
        # probe for FAILURE_RETRY_SECONDS instead of paying an RPC timeout
        # on every production attempt.
        if (self._el_failed_at is not None
                and time.monotonic() - self._el_failed_at
                < self.FAILURE_RETRY_SECONDS):
            return None
        try:
            info = engine.get_client_version()
        except Exception:
            info = None
        if not info:
            self._el_failed_at = time.monotonic()
            return None
        self._el_version_cache = (
            f"{info.get('code', info.get('name', '??'))}"
            f"{str(info.get('commit', ''))[:4]}"
        )
        return self._el_version_cache

    def get_graffiti(self, validator_graffiti: Optional[bytes] = None) -> bytes:
        # 1. the VC's wish always wins
        if validator_graffiti is not None and any(validator_graffiti):
            return bytes(validator_graffiti[:GRAFFITI_BYTES_LEN]).ljust(
                GRAFFITI_BYTES_LEN, b"\x00")
        # 2. an operator-pinned graffiti is next
        if self.beacon_graffiti.origin == GraffitiOrigin.USER_SPECIFIED:
            return self.beacon_graffiti.graffiti
        # 3. EL version + CL version, when the EL can tell us who it is
        el = self._el_client_string()
        if el:
            return _to_graffiti_bytes(f"{el}LH{_CL_VERSION[:8]}")
        # 4. plain CL version
        return self.beacon_graffiti.graffiti
