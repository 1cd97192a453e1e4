"""Per-validator graffiti loaded from a file.

Equivalent of the reference's ``validator_client/src/graffiti_file.rs``:
a flat file mapping pubkeys to graffiti with an optional default,

    default: Lighthouse
    0x<48-byte-pubkey-hex>: my graffiti
    ...

reloaded on EVERY lookup so operators can edit it without restarting the
VC (the reference's ``load_graffiti`` re-reads per proposal).  Graffiti is
UTF-8, at most 32 bytes, zero-padded for the block body.

A copy of the JAX package's ``lighthouse_tpu/validator_client/graffiti_file.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


class GraffitiFileError(Exception):
    pass


def _encode_graffiti(text: str) -> bytes:
    raw = text.encode()
    if len(raw) > 32:
        raise GraffitiFileError(f"graffiti exceeds 32 bytes: {text!r}")
    return raw.ljust(32, b"\x00")


class GraffitiFile:
    def __init__(self, path: str):
        self.path = path

    def _load(self):
        """Parse the file fresh.  Raises GraffitiFileError on a malformed
        line, an invalid pubkey, or oversize graffiti — a bad file must be
        LOUD, not silently skipped (reference Error::InvalidLine)."""
        default: Optional[bytes] = None
        per_key: Dict[bytes, bytes] = {}
        if not os.path.exists(self.path):
            raise GraffitiFileError(f"graffiti file missing: {self.path}")
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if ":" not in line:
                    raise GraffitiFileError(f"line {lineno}: missing ':'")
                key, _, value = line.partition(":")
                key = key.strip()
                value = value.strip()
                if key == "default":
                    default = _encode_graffiti(value)
                    continue
                hexkey = key[2:] if key.startswith("0x") else key
                try:
                    pubkey = bytes.fromhex(hexkey)
                except ValueError as e:
                    raise GraffitiFileError(
                        f"line {lineno}: bad pubkey hex: {e}") from e
                if len(pubkey) != 48:
                    raise GraffitiFileError(
                        f"line {lineno}: pubkey must be 48 bytes, got {len(pubkey)}")
                per_key[pubkey] = _encode_graffiti(value)
        return default, per_key

    def graffiti_for(self, pubkey: bytes) -> Optional[bytes]:
        """The graffiti for ``pubkey``: its own line, else the file default,
        else None (caller falls back to the VC-level graffiti)."""
        default, per_key = self._load()
        return per_key.get(bytes(pubkey), default)
