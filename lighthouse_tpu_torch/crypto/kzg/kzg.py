"""KZG polynomial commitments for Deneb blob sidecars (EIP-4844).

The port's copy of ``lighthouse_tpu/crypto/kzg/kzg.py``, on the port's own
host BLS model (``crypto/bls``).  Role-equivalent of the reference's
``crypto/kzg`` crate (`crypto/kzg/src/lib.rs:32-144`: ``Kzg`` holding a
trusted setup with ``blob_to_kzg_commitment``, ``compute_blob_kzg_proof``,
``verify_blob_kzg_proof{,_batch}``, point-eval verify), which wraps the C
``c-kzg-4844`` library.  Polynomial math runs over dense int arrays with
Pippenger MSM on the host (``g1.py``); batch verification's MSMs and
2-pairing run as one PyTorch program on the Fq kernels
(``ops/kzg_device.py``), on the card by default.

Follows the consensus-specs Deneb ``polynomial-commitments.md`` functions
(compute_challenge / evaluate_polynomial_in_evaluation_form /
verify_kzg_proof_batch) with their exact Fiat-Shamir byte layouts, so
commitments/proofs are interoperable with c-kzg given the same trusted setup.

The engine is parameterized by the trusted setup:
 - ``TrustedSetup.from_json`` reads the c-kzg JSON format (the official
   ceremony file a node operator supplies);
 - ``TrustedSetup.insecure_dev_setup`` derives a setup from a known secret —
   the testing analog of the reference's bundled setup, valid for
   self-consistent prove/verify but NOT for mainnet data.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

from ..bls import curve, serde
from ..bls.fields import Fq, Fq2
from ..bls.pairing import multi_pairing_is_one
from ..bls.params import R
from . import g1

BLS_MODULUS = R
BYTES_PER_FIELD_ELEMENT = 32
FIELD_ELEMENTS_PER_BLOB = 4096  # mainnet & minimal presets alike
PRIMITIVE_ROOT_OF_UNITY = 7
# Domain tags, spec polynomial-commitments.md
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
KZG_ENDIANNESS = "big"

G1_GEN = (curve.G1[0].n, curve.G1[1].n)


class KzgError(ValueError):
    pass


def _inv(x: int) -> int:
    return pow(x, BLS_MODULUS - 2, BLS_MODULUS)


def _batch_inv(xs: Sequence[int]) -> List[int]:
    """Montgomery batch inversion: one modexp for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        if x == 0:
            raise KzgError("division by zero in batch inversion")
        prefix[i + 1] = prefix[i] * x % BLS_MODULUS
    inv_all = _inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % BLS_MODULUS
        inv_all = inv_all * xs[i] % BLS_MODULUS
    return out


@lru_cache(maxsize=8)
def compute_roots_of_unity(width: int) -> Tuple[int, ...]:
    if width <= 0 or width & (width - 1) != 0 or (BLS_MODULUS - 1) % width != 0:
        raise KzgError(f"domain width {width} is not a valid power of two")
    root = pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // width, BLS_MODULUS)
    out = [1] * width
    for i in range(1, width):
        out[i] = out[i - 1] * root % BLS_MODULUS
    return tuple(out)


@lru_cache(maxsize=8)
def _brp_indices(width: int) -> Tuple[int, ...]:
    bits = width.bit_length() - 1
    return tuple(int(format(i, f"0{bits}b")[::-1], 2) for i in range(width))


@lru_cache(maxsize=8)
def roots_of_unity_brp(width: int) -> Tuple[int, ...]:
    roots = compute_roots_of_unity(width)
    return tuple(roots[i] for i in _brp_indices(width))


def bit_reversal_permutation(seq: Sequence, width: Optional[int] = None) -> list:
    width = len(seq) if width is None else width
    return [seq[i] for i in _brp_indices(width)]


# ---------------------------------------------------------------------------
# Field / blob (de)serialization
# ---------------------------------------------------------------------------


def bytes_to_bls_field(b: bytes) -> int:
    if len(b) != BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"field element must be {BYTES_PER_FIELD_ELEMENT} bytes")
    x = int.from_bytes(b, KZG_ENDIANNESS)
    if x >= BLS_MODULUS:
        raise KzgError("field element not canonical")
    return x


def bls_field_to_bytes(x: int) -> bytes:
    return int.to_bytes(x, BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), KZG_ENDIANNESS) % BLS_MODULUS


def blob_to_polynomial(blob: bytes, width: int = FIELD_ELEMENTS_PER_BLOB) -> List[int]:
    if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {width * BYTES_PER_FIELD_ELEMENT} bytes")
    return [
        bytes_to_bls_field(blob[i * 32 : (i + 1) * 32]) for i in range(width)
    ]


def _bytes_to_g1(b: bytes) -> g1.Affine:
    """48-byte compressed G1 → int affine, with curve + subgroup checks
    (c-kzg ``validate_kzg_g1``)."""
    try:
        pt = serde.g1_decompress(b)
    except serde.DecodeError as e:
        raise KzgError(f"bad G1 encoding: {e}") from e
    if pt is None:
        return None
    if not curve.in_g1(pt):
        raise KzgError("point not in G1 subgroup")
    return (pt[0].n, pt[1].n)


def _g1_to_bytes(pt: g1.Affine) -> bytes:
    if pt is None:
        return serde.g1_compress(None)
    return serde.g1_compress((Fq(pt[0]), Fq(pt[1])))


def _g1_to_curve_point(pt: g1.Affine):
    if pt is None:
        return None
    return (Fq(pt[0]), Fq(pt[1]))


# ---------------------------------------------------------------------------
# Trusted setup
# ---------------------------------------------------------------------------


@dataclass
class TrustedSetup:
    """Lagrange-form G1 points + monomial G2 points (``[1]G2, [tau]G2, ...``).

    Reference: ``crypto/kzg/src/trusted_setup.rs`` (JSON loader feeding
    ``c_kzg::KzgSettings``)."""

    g1_lagrange: List[g1.Affine]
    g2_monomial: List[curve.Point]  # Fq2-based points
    width: int

    @classmethod
    def from_json(cls, text: str, validate: bool = True) -> "TrustedSetup":
        obj = json.loads(text)
        # Both historical key spellings are in circulation.
        g1_key = "g1_lagrange" if "g1_lagrange" in obj else "setup_G1_lagrange"
        g2_key = "g2_monomial" if "g2_monomial" in obj else "setup_G2"
        g1_pts = []
        for s in obj[g1_key]:
            raw = bytes.fromhex(s[2:] if s.startswith("0x") else s)
            g1_pts.append(_bytes_to_g1(raw) if validate else _unchecked_g1(raw))
        g2_pts = []
        for s in obj[g2_key]:
            raw = bytes.fromhex(s[2:] if s.startswith("0x") else s)
            try:
                pt = serde.g2_decompress(raw)
            except serde.DecodeError as e:
                raise KzgError(f"bad G2 encoding in trusted setup: {e}") from e
            if validate and not curve.in_g2(pt):
                raise KzgError("G2 setup point not in subgroup")
            g2_pts.append(pt)
        # The ceremony file stores Lagrange points in NATURAL root order;
        # evaluation-form math here uses the bit-reversed ordering, so the
        # loader applies the permutation exactly like c-kzg's
        # load_trusted_setup (caught by the vendored-official-setup KAT:
        # proofs verified under the dev setup but not the real file).
        g1_pts = bit_reversal_permutation(g1_pts)
        return cls(g1_lagrange=g1_pts, g2_monomial=g2_pts, width=len(g1_pts))

    @classmethod
    def insecure_dev_setup(
        cls, width: int = FIELD_ELEMENTS_PER_BLOB, secret: int = 1337
    ) -> "TrustedSetup":
        """Derive a setup from a known ``tau`` — test/bench only.

        Lagrange point i is ``[L_i(tau)]G1`` with
        ``L_i(x) = w_i (x^n - 1) / (n (x - w_i))`` over the bit-reversed root
        ordering, computed in the scalar field (no per-point MSM needed when
        tau is known)."""
        tau = secret % BLS_MODULUS
        roots = roots_of_unity_brp(width)
        zn = (pow(tau, width, BLS_MODULUS) - 1) % BLS_MODULUS
        denoms = _batch_inv([width * (tau - w) % BLS_MODULUS for w in roots])
        g1_pts = [
            g1.scalar_mul(G1_GEN, w * zn % BLS_MODULUS * d % BLS_MODULUS)
            for w, d in zip(roots, denoms)
        ]
        g2_pts = [curve.G2, curve.mul(curve.G2, tau)]
        return cls(g1_lagrange=g1_pts, g2_monomial=g2_pts, width=width)


def _unchecked_g1(raw: bytes) -> g1.Affine:
    try:
        pt = serde.g1_decompress(raw)
    except serde.DecodeError as e:
        raise KzgError(f"bad G1 encoding: {e}") from e
    return None if pt is None else (pt[0].n, pt[1].n)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class Kzg:
    """The reference's ``Kzg`` wrapper (``crypto/kzg/src/lib.rs:32``)."""

    def __init__(self, setup: TrustedSetup, device="cuda"):
        """``device`` is where batch verification of two or more blobs runs
        its MSMs and 2-pairing: ``"cuda"`` (the default) or ``"cpu"`` runs
        the device program of ``ops/kzg_device.py`` there (on the CPU the
        Fq kernels run as their plain versions), and asking for CUDA where
        there is no card raises; ``None`` selects the host golden model
        (:meth:`_verify_kzg_proof_batch_host`).  The device program runs
        under the device supervisor: a failure on the card raises into
        the caller (counted and breaker-tracked); with ``"cpu"`` a failure
        resolves on the host path.  Commit, prove, single-blob verify and
        point-evaluation verify (:meth:`verify_kzg_proof`) always run on
        the host."""
        if device is not None:
            from ...ops.devices import resolve_device

            device = resolve_device(device)
        self.setup = setup
        self.width = setup.width
        self.device = device
        self.roots_brp = roots_of_unity_brp(self.width)
        self._root_index = {w: i for i, w in enumerate(self.roots_brp)}

    # -------------------------------------------------------------- commit

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        poly = blob_to_polynomial(blob, self.width)
        return _g1_to_bytes(g1.msm(self.setup.g1_lagrange, poly))

    # ------------------------------------------------------------ evaluate

    def evaluate_polynomial_in_evaluation_form(self, poly: Sequence[int], z: int) -> int:
        """Barycentric evaluation at an arbitrary point (spec
        ``evaluate_polynomial_in_evaluation_form``)."""
        width = self.width
        idx = self._root_index.get(z)
        if idx is not None:
            return poly[idx]
        invs = _batch_inv([(z - w) % BLS_MODULUS for w in self.roots_brp])
        acc = 0
        for p, w, inv_zw in zip(poly, self.roots_brp, invs):
            acc += p * w % BLS_MODULUS * inv_zw
        acc %= BLS_MODULUS
        zn_minus_1 = (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS
        return acc * zn_minus_1 % BLS_MODULUS * _inv(width) % BLS_MODULUS

    # --------------------------------------------------------------- prove

    def _compute_kzg_proof_impl(self, poly: Sequence[int], z: int) -> Tuple[bytes, int]:
        y = self.evaluate_polynomial_in_evaluation_form(poly, z)
        shifted = [(p - y) % BLS_MODULUS for p in poly]
        quotient = [0] * self.width
        m = self._root_index.get(z)
        if m is None:
            invs = _batch_inv([(w - z) % BLS_MODULUS for w in self.roots_brp])
            for i in range(self.width):
                quotient[i] = shifted[i] * invs[i] % BLS_MODULUS
        else:
            # z is the m-th root: quotient at m via the in-domain formula
            # q_m = sum_{i != m} f_i w_i / (z (z - w_i)); elsewhere
            # q_i = f_i / (w_i - z) = -f_i * (z - w_i)^-1.
            zinv = _inv(z)
            invs = _batch_inv(
                [
                    (z - w) % BLS_MODULUS if i != m else 1
                    for i, w in enumerate(self.roots_brp)
                ]
            )
            qm = 0
            for i, w in enumerate(self.roots_brp):
                if i == m:
                    continue
                quotient[i] = -shifted[i] * invs[i] % BLS_MODULUS
                qm += shifted[i] * w % BLS_MODULUS * invs[i] % BLS_MODULUS * zinv
            quotient[m] = qm % BLS_MODULUS
        proof = _g1_to_bytes(g1.msm(self.setup.g1_lagrange, quotient))
        return proof, y

    def compute_kzg_proof(self, blob: bytes, z_bytes: bytes) -> Tuple[bytes, bytes]:
        poly = blob_to_polynomial(blob, self.width)
        proof, y = self._compute_kzg_proof_impl(poly, bytes_to_bls_field(z_bytes))
        return proof, bls_field_to_bytes(y)

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        _bytes_to_g1(commitment)  # validate
        poly = blob_to_polynomial(blob, self.width)
        challenge = self.compute_challenge(blob, commitment)
        proof, _ = self._compute_kzg_proof_impl(poly, challenge)
        return proof

    # ------------------------------------------------------------- verify

    def verify_kzg_proof(
        self, commitment: bytes, z_bytes: bytes, y_bytes: bytes, proof: bytes
    ) -> bool:
        """Point-evaluation verify (the EIP-4844 precompile semantics;
        reference ``crypto/kzg/src/lib.rs:128-144``)."""
        return self._verify_kzg_proof_impl(
            _bytes_to_g1(commitment),
            bytes_to_bls_field(z_bytes),
            bytes_to_bls_field(y_bytes),
            _bytes_to_g1(proof),
        )

    def _verify_kzg_proof_impl(
        self, commitment: g1.Affine, z: int, y: int, proof: g1.Affine
    ) -> bool:
        # e(C - [y]G1, -G2) * e(proof, [tau]G2 - [z]G2) == 1
        g2_tau = self.setup.g2_monomial[1]
        x_minus_z = curve.add(g2_tau, curve.neg(curve.mul(curve.G2, z)))
        p_minus_y = g1.add(commitment, g1.neg(g1.scalar_mul(G1_GEN, y)))
        return multi_pairing_is_one(
            [
                (_g1_to_curve_point(p_minus_y), curve.neg(curve.G2)),
                (_g1_to_curve_point(proof), x_minus_z),
            ]
        )

    def compute_challenge(self, blob: bytes, commitment: bytes) -> int:
        degree_poly = int.to_bytes(self.width, 16, KZG_ENDIANNESS)
        data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + blob + commitment
        return hash_to_bls_field(data)

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> bool:
        c_pt = _bytes_to_g1(commitment)
        p_pt = _bytes_to_g1(proof)
        poly = blob_to_polynomial(blob, self.width)
        challenge = self.compute_challenge(blob, commitment)
        y = self.evaluate_polynomial_in_evaluation_form(poly, challenge)
        return self._verify_kzg_proof_impl(c_pt, challenge, y, p_pt)

    def verify_blob_kzg_proof_batch(
        self, blobs: Sequence[bytes], commitments: Sequence[bytes], proofs: Sequence[bytes]
    ) -> bool:
        """Batch verify: one random linear combination, one 2-pairing check
        (reference hot path ``crypto/kzg/src/lib.rs:81-107`` →
        ``c_kzg::KzgProof::verify_blob_kzg_proof_batch``)."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("length mismatch")
        if len(blobs) == 0:
            return True
        if len(blobs) == 1:
            return self.verify_blob_kzg_proof(blobs[0], commitments[0], proofs[0])
        c_pts = [_bytes_to_g1(c) for c in commitments]
        p_pts = [_bytes_to_g1(p) for p in proofs]
        zs, ys = [], []
        for blob, commitment in zip(blobs, commitments):
            poly = blob_to_polynomial(blob, self.width)
            challenge = self.compute_challenge(blob, commitment)
            zs.append(challenge)
            ys.append(self.evaluate_polynomial_in_evaluation_form(poly, challenge))
        return self._verify_kzg_proof_batch(c_pts, commitments, zs, ys, p_pts, proofs)

    def _compute_r_powers(
        self,
        commitments_bytes: Sequence[bytes],
        zs: Sequence[int],
        ys: Sequence[int],
        proofs_bytes: Sequence[bytes],
    ) -> List[int]:
        n = len(commitments_bytes)
        data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
        data += int.to_bytes(self.width, 8, KZG_ENDIANNESS)
        data += int.to_bytes(n, 8, KZG_ENDIANNESS)
        for c, z, y, p in zip(commitments_bytes, zs, ys, proofs_bytes):
            data += c + bls_field_to_bytes(z) + bls_field_to_bytes(y) + p
        r = hash_to_bls_field(data)
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * r % BLS_MODULUS
        return powers

    def _verify_kzg_proof_batch(
        self, c_pts, commitments_bytes, zs, ys, p_pts, proofs_bytes
    ) -> bool:
        r_powers = self._compute_r_powers(commitments_bytes, zs, ys, proofs_bytes)
        if self.device is not None:
            from ...ops.kzg_device import verify_kzg_proof_batch_device

            # Supervised: off the card, the host MSM path below is the
            # golden model a hung or failing device leg (or an OPEN
            # kzg_batch breaker) resolves through; on the card they raise.
            return verify_kzg_proof_batch_device(
                [_g1_to_curve_point(c) for c in c_pts],
                [_g1_to_curve_point(p) for p in p_pts],
                r_powers, zs, ys, self.setup.g2_monomial[1],
                device=self.device,
                host_fn=lambda: self._verify_kzg_proof_batch_host(
                    c_pts, zs, ys, p_pts, r_powers
                ),
            )
        return self._verify_kzg_proof_batch_host(c_pts, zs, ys, p_pts, r_powers)

    def _verify_kzg_proof_batch_host(
        self, c_pts, zs, ys, p_pts, r_powers
    ) -> bool:
        proof_lincomb = g1.msm(p_pts, r_powers)
        proof_z_lincomb = g1.msm(
            p_pts, [r * z % BLS_MODULUS for r, z in zip(r_powers, zs)]
        )
        # sum r_i (C_i - [y_i]G1) = MSM(C, r) - [sum r_i y_i]G1: fold the
        # y-terms into one scalar so there's a single G1_GEN multiplication.
        c_lincomb = g1.msm(c_pts, r_powers)
        ry = sum(r * y % BLS_MODULUS for r, y in zip(r_powers, ys)) % BLS_MODULUS
        c_minus_y_lincomb = g1.add(c_lincomb, g1.neg(g1.scalar_mul(G1_GEN, ry)))
        rhs = g1.add(c_minus_y_lincomb, proof_z_lincomb)
        g2_tau = self.setup.g2_monomial[1]
        return multi_pairing_is_one(
            [
                (_g1_to_curve_point(proof_lincomb), g2_tau),
                (_g1_to_curve_point(g1.neg(rhs)), curve.G2),
            ]
        )
