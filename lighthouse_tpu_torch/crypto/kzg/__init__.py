"""KZG commitments for blob sidecars (reference: ``crypto/kzg``)."""

from .kzg import (
    BLS_MODULUS,
    BYTES_PER_FIELD_ELEMENT,
    FIELD_ELEMENTS_PER_BLOB,
    Kzg,
    KzgError,
    TrustedSetup,
    bit_reversal_permutation,
    blob_to_polynomial,
    bytes_to_bls_field,
    bls_field_to_bytes,
    compute_roots_of_unity,
    hash_to_bls_field,
    roots_of_unity_brp,
)

__all__ = [
    "BLS_MODULUS",
    "BYTES_PER_FIELD_ELEMENT",
    "FIELD_ELEMENTS_PER_BLOB",
    "Kzg",
    "KzgError",
    "TrustedSetup",
    "bit_reversal_permutation",
    "blob_to_polynomial",
    "bytes_to_bls_field",
    "bls_field_to_bytes",
    "compute_roots_of_unity",
    "hash_to_bls_field",
    "roots_of_unity_brp",
]
