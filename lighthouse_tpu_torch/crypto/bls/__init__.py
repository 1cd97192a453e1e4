"""BLS12-381 signatures for the beacon chain (reference: ``crypto/bls``).

Public surface mirrors the reference's generic layer; the execution backend
(host golden model | fake | torch batched pairing on a CUDA card) is swappable at one seam,
exactly like the reference's ``define_mod!`` backend trait
(``crypto/bls/src/lib.rs:84-139``).
"""

from .api import (
    INFINITY_PUBLIC_KEY,
    INFINITY_SIGNATURE,
    PUBLIC_KEY_BYTES_LEN,
    SECRET_KEY_BYTES_LEN,
    SIGNATURE_BYTES_LEN,
    AggregatePublicKey,
    AggregateSignature,
    BlsError,
    PublicKey,
    SecretKey,
    Signature,
    SignatureSet,
    aggregate_verify,
    eth_fast_aggregate_verify,
    fast_aggregate_verify,
    verify,
    verify_signature_sets,
)
from .backends import backend_name, set_backend
from .params import DST, RAND_BITS

__all__ = [
    "AggregatePublicKey",
    "AggregateSignature",
    "BlsError",
    "DST",
    "INFINITY_PUBLIC_KEY",
    "INFINITY_SIGNATURE",
    "PUBLIC_KEY_BYTES_LEN",
    "PublicKey",
    "RAND_BITS",
    "SECRET_KEY_BYTES_LEN",
    "SIGNATURE_BYTES_LEN",
    "SecretKey",
    "Signature",
    "SignatureSet",
    "aggregate_verify",
    "backend_name",
    "eth_fast_aggregate_verify",
    "fast_aggregate_verify",
    "set_backend",
    "verify",
    "verify_signature_sets",
]
