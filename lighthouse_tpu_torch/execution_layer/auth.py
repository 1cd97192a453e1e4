"""Engine-API JWT (HS256) authentication.

Equivalent of the reference's ``execution_layer/src/engine_api/auth.rs:71-79``
(``Auth::generate_token`` — HS256 over an ``iat`` claim, secret from the
jwt-secret file both sides share).  Pure stdlib: hmac + base64url.

A copy of the JAX package's ``lighthouse_tpu/execution_layer/auth.py``.
"""

from __future__ import annotations

import base64
import hmac
import json
import time
from hashlib import sha256
from typing import Optional

JWT_SECRET_LENGTH = 32
# Engine API spec: tokens older than this are rejected.
MAX_IAT_DRIFT_SECONDS = 60


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: bytes) -> bytes:
    pad = b"=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def strip_prefix(secret_hex: str) -> bytes:
    s = secret_hex.strip()
    if s.startswith("0x"):
        s = s[2:]
    secret = bytes.fromhex(s)
    if len(secret) != JWT_SECRET_LENGTH:
        raise JwtError(f"jwt secret must be {JWT_SECRET_LENGTH} bytes, got {len(secret)}")
    return secret


def generate_token(secret: bytes, iat: Optional[int] = None) -> str:
    """HS256 JWT with an ``iat`` claim (auth.rs generate_token)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = _b64url(json.dumps({"iat": int(time.time()) if iat is None else iat}).encode())
    signing_input = header + b"." + claims
    sig = hmac.new(secret, signing_input, sha256).digest()
    return (signing_input + b"." + _b64url(sig)).decode()


def validate_token(token: str, secret: bytes, now: Optional[int] = None) -> None:
    """Raise JwtError unless ``token`` is a valid, fresh HS256 JWT."""
    parts = token.encode().split(b".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    signing_input = parts[0] + b"." + parts[1]
    expect = hmac.new(secret, signing_input, sha256).digest()
    try:
        sig = _b64url_decode(parts[2])
    except Exception:
        raise JwtError("bad base64 in signature")
    if not hmac.compare_digest(expect, sig):
        raise JwtError("bad signature")
    try:
        claims = json.loads(_b64url_decode(parts[1]))
        if not isinstance(claims, dict):
            raise JwtError("claims not an object")
        iat = int(claims.get("iat", 0))
    except JwtError:
        raise
    except Exception:
        raise JwtError("bad claims")
    now = int(time.time()) if now is None else now
    if abs(now - iat) > MAX_IAT_DRIFT_SECONDS:
        raise JwtError(f"stale iat {iat} (now {now})")
