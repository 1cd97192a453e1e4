"""Public BLS API: keys, signatures, signature sets, batch verification.

Mirrors the reference's backend-swappable generic layer (``crypto/bls/src/lib.rs:84-139``
``define_mod!`` over ``impls::{blst, fake_crypto}``): every signature in the framework
funnels through ``SignatureSet`` + ``verify_signature_sets`` so the execution backend
(host | fake | torch) can be swapped at one seam.

Batch semantics are byte-for-byte those of ``crypto/bls/src/impls/blst.rs:35-117``:
empty batch -> False; per set: nonzero 64-bit random weight, signature subgroup
check, no-pubkeys -> False, pubkey aggregation; then one multi-pairing.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Iterable, List, Optional, Sequence

from . import curve, serde
from .curve import Point
from .hash_to_curve import hash_to_g2
from .params import DST, R, RAND_BITS

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32

INFINITY_SIGNATURE = bytes([0xC0]) + b"\x00" * 95
INFINITY_PUBLIC_KEY = bytes([0xC0]) + b"\x00" * 47


class BlsError(ValueError):
    pass


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    import hmac

    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    import hmac

    okm = b""
    t = b""
    i = 0
    while len(okm) < length:
        i += 1
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
    return okm[:length]


class SecretKey:
    """Scalar secret key (nonzero, < r). Reference: generic_secret_key.rs."""

    __slots__ = ("_k",)

    def __init__(self, k: int):
        if not 0 < k < R:
            raise BlsError("secret key out of range")
        self._k = k

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def random(cls) -> "SecretKey":
        while True:
            k = secrets.randbits(255) % R
            if k:
                return cls(k)

    @classmethod
    def key_gen(cls, ikm: bytes, key_info: bytes = b"") -> "SecretKey":
        """IETF BLS KeyGen (HKDF mod r), used by EIP-2333 derivation."""
        salt = b"BLS-SIG-KEYGEN-SALT-"
        while True:
            salt = hashlib.sha256(salt).digest()
            prk = _hkdf_extract(salt, ikm + b"\x00")
            okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
            k = int.from_bytes(okm, "big") % R
            if k:
                return cls(k)

    def to_bytes(self) -> bytes:
        return self._k.to_bytes(32, "big")

    @property
    def scalar(self) -> int:
        return self._k

    def public_key(self) -> "PublicKey":
        return PublicKey(point=curve.mul(curve.G1, self._k))

    def sign(self, message: bytes, dst: bytes = DST) -> "Signature":
        h = hash_to_g2(bytes(message), dst)
        return Signature(point=curve.mul(h, self._k))


class PublicKey:
    """A *validated* public key: decoded, non-infinity, in G1.

    Matches the reference invariant that `GenericPublicKey` is always
    subgroup-checked and infinity-checked on deserialization
    (impls/blst.rs `deserialize` + generic_public_key.rs infinity check).
    """

    __slots__ = ("point", "_bytes")

    def __init__(self, point: Point, _skip_checks: bool = False):
        if not _skip_checks:
            if point is None:
                raise BlsError("public key is the point at infinity")
            if not curve.in_g1(point):
                raise BlsError("public key not in G1")
        self.point = point
        self._bytes: Optional[bytes] = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        if len(data) != PUBLIC_KEY_BYTES_LEN:
            raise BlsError(f"public key must be 48 bytes, got {len(data)}")
        try:
            pt = serde.g1_decompress(data)
        except serde.DecodeError as e:
            raise BlsError(str(e)) from e
        return cls(pt)

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = serde.g1_compress(self.point)
        return self._bytes

    def __eq__(self, o):
        return isinstance(o, PublicKey) and self.point == o.point

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"PublicKey(0x{self.to_bytes().hex()})"


class AggregatePublicKey:
    """Sum of public keys in G1 (blst AggregatePublicKey equivalent)."""

    __slots__ = ("point",)

    def __init__(self, point: Point = None):
        self.point = point

    @classmethod
    def aggregate(cls, pubkeys: Sequence[PublicKey]) -> "AggregatePublicKey":
        acc: Point = None
        for pk in pubkeys:
            acc = curve.add(acc, pk.point)
        return cls(acc)

    def to_public_key(self) -> PublicKey:
        return PublicKey(point=self.point)


class Signature:
    """A signature point in G2 (possibly infinity; subgroup check at verify time,
    as in the reference where deserialize only curve-checks)."""

    __slots__ = ("point", "is_infinity", "_bytes")

    def __init__(self, point: Point = None, _bytes: Optional[bytes] = None):
        self.point = point
        self.is_infinity = point is None
        self._bytes = _bytes

    @classmethod
    def empty(cls) -> "Signature":
        return cls(None, INFINITY_SIGNATURE)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        if len(data) != SIGNATURE_BYTES_LEN:
            raise BlsError(f"signature must be 96 bytes, got {len(data)}")
        try:
            pt = serde.g2_decompress(data)
        except serde.DecodeError as e:
            raise BlsError(str(e)) from e
        return cls(pt, bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = serde.g2_compress(self.point)
        return self._bytes

    def subgroup_check(self) -> bool:
        return curve.in_g2(self.point)

    def verify(self, pubkey: PublicKey, message: bytes, dst: bytes = DST) -> bool:
        return fast_aggregate_verify([pubkey], message, self, dst)

    def __eq__(self, o):
        return isinstance(o, Signature) and self.point == o.point

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"Signature(0x{self.to_bytes().hex()})"


class AggregateSignature:
    """Accumulating aggregate signature (generic_aggregate_signature.rs)."""

    __slots__ = ("point",)

    def __init__(self, point: Point = None):
        self.point = point

    @classmethod
    def infinity(cls) -> "AggregateSignature":
        return cls(None)

    @classmethod
    def from_signature(cls, sig: Signature) -> "AggregateSignature":
        return cls(sig.point)

    @classmethod
    def from_bytes(cls, data: bytes) -> "AggregateSignature":
        return cls(Signature.from_bytes(data).point)

    def add_assign(self, sig: Signature) -> None:
        self.point = curve.add(self.point, sig.point)

    def add_assign_aggregate(self, other: "AggregateSignature") -> None:
        self.point = curve.add(self.point, other.point)

    def to_signature(self) -> Signature:
        return Signature(self.point)

    def to_bytes(self) -> bytes:
        return serde.g2_compress(self.point)

    @classmethod
    def aggregate(cls, sigs: Sequence[Signature]) -> "AggregateSignature":
        out = cls()
        for s in sigs:
            out.add_assign(s)
        return out


class SignatureSet:
    """(signature, message, signing_keys): one unit of the batch-verification IR
    (generic_signature_set.rs:61-121)."""

    __slots__ = ("signature", "message", "signing_keys")

    def __init__(self, signature, message: bytes, signing_keys: List[PublicKey]):
        if isinstance(signature, Signature):
            signature = AggregateSignature.from_signature(signature)
        self.signature: AggregateSignature = signature
        self.message = bytes(message)
        self.signing_keys = list(signing_keys)

    @classmethod
    def single_pubkey(cls, signature, signing_key: PublicKey, message: bytes) -> "SignatureSet":
        return cls(signature, message, [signing_key])

    @classmethod
    def multiple_pubkeys(cls, signature, signing_keys: List[PublicKey], message: bytes) -> "SignatureSet":
        return cls(signature, message, signing_keys)

    def verify(self) -> bool:
        return fast_aggregate_verify(
            self.signing_keys, self.message, self.signature.to_signature()
        )


# ---------------------------------------------------------------- verification

def _core_verify_pairs(pairs) -> bool:
    from .pairing import multi_pairing_is_one

    return multi_pairing_is_one(pairs)


def verify(pubkey: PublicKey, message: bytes, signature: Signature, dst: bytes = DST) -> bool:
    return fast_aggregate_verify([pubkey], message, signature, dst)


def fast_aggregate_verify(
    pubkeys: Sequence[PublicKey], message: bytes, signature: Signature, dst: bytes = DST
) -> bool:
    """All pubkeys signed the same message."""
    if not pubkeys:
        return False
    if signature.is_infinity or not signature.subgroup_check():
        return False
    agg = AggregatePublicKey.aggregate(pubkeys)
    h = hash_to_g2(message, dst)
    return _core_verify_pairs([
        (curve.neg(curve.G1), signature.point),
        (agg.point, h),
    ])


def aggregate_verify(
    pubkeys: Sequence[PublicKey], messages: Sequence[bytes], signature: Signature, dst: bytes = DST
) -> bool:
    """Each pubkey signed its own message (requires distinct messages per IETF,
    not enforced here — matches blst's aggregate_verify with grouped msgs)."""
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    if signature.is_infinity or not signature.subgroup_check():
        return False
    pairs = [(curve.neg(curve.G1), signature.point)]
    for pk, msg in zip(pubkeys, messages):
        pairs.append((pk.point, hash_to_g2(bytes(msg), dst)))
    return _core_verify_pairs(pairs)


def eth_fast_aggregate_verify(
    pubkeys: Sequence[PublicKey], message: bytes, signature: Signature, dst: bytes = DST
) -> bool:
    """Eth2 consensus-spec deviation: empty pubkeys + infinity signature is valid
    (used for empty sync aggregates)."""
    if not pubkeys and signature.to_bytes() == INFINITY_SIGNATURE:
        return True
    return fast_aggregate_verify(pubkeys, message, signature, dst)


def verify_signature_sets(
    signature_sets: Iterable[SignatureSet],
    seed: Optional[bytes] = None,
    device: Optional[str] = None,
) -> bool:
    """Batch verification via the active backend (impls/blst.rs:35-117 semantics).

    `seed` pins the random weights for reproducibility in tests; production use
    leaves it None (host CSPRNG — randomness must stay host-side, blst.rs:52-57).

    `device` is passed to the torch backend only; None leaves it at that
    backend's configured device, ``"cuda"`` unless
    ``torch_backend.configure(device=...)`` says otherwise.  The host and fake
    backends take no device.

    When the async device pipeline is enabled (``device_pipeline.enable()``,
    by the caller), seedless calls whose `device` is None or the pipeline's
    own submit their sets as ONE group to the persistent device worker and
    block on a future — the pipeline coalesces groups across work types into
    larger device batches.  Seeded calls, calls naming another device and
    oversized batches keep the direct (supervised) backend path.
    """
    from ... import device_pipeline, metrics, tracing
    from .backends import backend_name, get_backend

    sets = list(signature_sets)
    backend = get_backend()
    metrics.DEVICE_BATCH_INVOCATIONS.inc()
    metrics.SIGNATURE_SETS_VERIFIED.inc(len(sets))
    metrics.ATTESTATION_BATCH_SIZE.observe(len(sets))
    with tracing.span(
        "device_batch", hist=metrics.ATTESTATION_BATCH_SECONDS,
        n_sets=len(sets), backend=backend_name(),
    ):
        if device_pipeline.routes(sets, seed, device):
            try:
                return device_pipeline.verify(sets, device=device)
            except device_pipeline.PipelineShutdown:
                pass  # racing a shutdown: the direct path still answers
        if device is None:
            return backend.verify_signature_sets(sets, seed=seed)
        return backend.verify_signature_sets(sets, seed=seed, device=device)
