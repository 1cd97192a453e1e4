"""Batched BLS12-381 base-field arithmetic on int32 limb tensors (PyTorch).

The counterpart of ``lighthouse_tpu/ops/fq.py`` with the same representation
and the same pipeline, so every limb this module produces equals the JAX
package's int32 path limb for limb.

**Representation.**  An Fq element is a vector of ``L16 = 25`` signed int32
limbs in radix 2^16 (little-endian), value = sum(limb[i] << 16*i).  The
representation is *redundant*: limbs may exceed 16 bits and may be negative;
only congruence mod p and limb-magnitude bounds are maintained.
Canonicalisation happens on the host at the edges (``to_limbs16`` /
``from_limbs16``).

**Multiplication.**  ``fq_mul`` folds both operands to ~16-bit limbs, splits
them into 54 radix-2^8 digits, convolves (54 x 54 -> 107 coefficients), folds
twice, reduces against ``REDMAT8[k] = limbs(2^8k mod p)`` (109 -> 48
positions), folds twice and recombines to 25 radix-2^16 limbs.  On a CUDA
tensor the whole pipeline is one hand-written kernel
(``cuda_fq.fq_mul``, source ``csrc/fq_mul.cu``); on a CPU tensor it is the
kernel's plain PyTorch version in the same module.

**Bound discipline** (derived in the JAX package's ``ops/fq.py``):
 - fold16_2 output limbs lie in [-1, 2^16] for any input with |limb| <= 2^25;
   fold8_2 output limbs lie in [-52, 307].
 - conv accumulators stay below 2^24; reduction accumulators below 2^23, so
   every intermediate is exact in int32.
 - ``fq_mul`` output: 25 limbs, |limb| < 2^16.3, for ANY inputs with
   |limb| <= 2^25 — so hundreds of additions may be chained between muls.

The JAX package's int8 lowering (``_fq_mul_int8``) is built for the TPU's
matrix unit and gives the same values as the int32 path; the CUDA kernel
covers that contract, so it has no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto.bls.params import P

# ------------------------------------------------------------------ constants

L16 = 25          # limbs per element, radix 2^16 (400 bits >= 381 + lazy slack)
FOLDED16 = L16 + 2           # fold16_2 grows length by 2
SPLIT8 = 2 * FOLDED16        # 54 radix-2^8 digits per operand
CONV8 = 2 * SPLIT8 - 1       # 107 convolution coefficients
RED_IN = CONV8 + 2           # 109 positions after fold8_2
RED_OUT = 48                 # 2^8k mod p fits 48 radix-2^8 positions


def red_rows(n: int) -> np.ndarray:
    """REDMAT8[k] = canonical radix-2^8 limbs of (2^(8k) mod p)."""
    rows = np.zeros((n, RED_OUT), np.int32)
    for k in range(n):
        v = pow(2, 8 * k, P)
        for j in range(RED_OUT):
            rows[k, j] = (v >> (8 * j)) & 0xFF
    return rows


#: The reduction table, (RED_IN, RED_OUT); the CUDA kernels hold it transposed
#: in constant memory.
REDMAT8 = red_rows(RED_IN)

_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on ``device`` (cached: the
    constants live for the life of the process, so their ids are stable)."""
    device = torch.device(device)
    key = (id(arr), device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(device)
        _CONSTS[key] = t
    return t


# ------------------------------------------------------------------ core ops


def fold8(x: torch.Tensor) -> torch.Tensor:
    """One exact carry-fold round in radix 2^8 (length grows by 1)."""
    lo = x & 0xFF
    hi = x >> 8  # arithmetic shift: exact for signed limbs
    return F.pad(lo, (0, 1)) + F.pad(hi, (1, 0))


def fold8_2(x: torch.Tensor) -> torch.Tensor:
    return fold8(fold8(x))


def fold16(x: torch.Tensor) -> torch.Tensor:
    """One exact carry-fold round in radix 2^16 (length grows by 1)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return F.pad(lo, (0, 1)) + F.pad(hi, (1, 0))


def fold16_2(x: torch.Tensor) -> torch.Tensor:
    return fold16(fold16(x))


def split16_to_8(x16: torch.Tensor) -> torch.Tensor:
    """Radix 2^16 -> radix 2^8, exact: (.., K) -> (.., 2K)."""
    lo = x16 & 0xFF
    hi = x16 >> 8
    return torch.stack([lo, hi], dim=-1).reshape(*x16.shape[:-1], -1)


def combine8_to_16(x8: torch.Tensor) -> torch.Tensor:
    """Radix 2^8 -> radix 2^16, exact: (.., 2K) -> (.., K). Length must be even."""
    return x8[..., 0::2] + (x8[..., 1::2] << 8)


def reduce8(c8: torch.Tensor) -> torch.Tensor:
    """Map any radix-2^8 vector (|coeff| <= ~2^9 after folding) to a congruent
    25-limb radix-2^16 element with |limb| < 2^16.3.

    The reduction is a product with the constant ``REDMAT8``; torch has no
    integer matrix product on CUDA, so it is a broadcast multiply and an
    int32 sum (exact: every partial sum stays below 2^23)."""
    red = const(REDMAT8, c8.device)[: c8.shape[-1]]
    r8 = (c8.unsqueeze(-1) * red).sum(dim=-2, dtype=torch.int32)
    r8 = fold8_2(r8)  # 48 -> 50 positions, limbs in [-52, 307]
    return combine8_to_16(r8)


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular multiply: (.., 25) x (.., 25) -> (.., 25), congruent mod p.

    Accepts any broadcastable inputs with |limb| <= 2^25; output limbs are
    < 2^16.3 in magnitude.  One launch of the Fq kernel on a CUDA tensor,
    the kernel's plain version on a CPU tensor.
    """
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    out = _kernels.fq_mul(a.reshape(-1, L16).contiguous(),
                          b.reshape(-1, L16).contiguous())
    return out.reshape(shape)


def fq_mul_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """Fuse independent modular products into ONE kernel launch.

    ``pairs`` holds (a, b) limb tensors — broadcastable within each pair,
    arbitrary batch shapes across pairs.  All operand rows are flattened and
    concatenated onto one leading axis.  Per-pair results are bit-identical
    to calling :func:`fq_mul` on each pair.
    """
    if not pairs:
        return []
    if len(pairs) == 1:
        a, b = pairs[0]
        return [fq_mul(a, b)]
    bcast = [torch.broadcast_tensors(a, b) for a, b in pairs]
    shapes = [a.shape for a, _ in bcast]
    lhs = torch.cat([a.reshape(-1, a.shape[-1]) for a, _ in bcast])
    rhs = torch.cat([b.reshape(-1, b.shape[-1]) for _, b in bcast])
    out = fq_mul(lhs, rhs)
    outs: List[torch.Tensor] = []
    off = 0
    for shape in shapes:
        n = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
        outs.append(out[off:off + n].reshape(shape))
        off += n
    return outs


def fq_mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small scalar constant (|k| <= ~64) — pure limbwise scale."""
    return a * k


def fq_pow_const(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a fixed positive exponent: MSB-first square-and-multiply.

    The exponent is a host constant, so the multiply is a host branch on
    each bit (the JAX package computes both sides and selects; the value is
    the same)."""
    if e <= 0:
        raise ValueError("fq_pow_const needs a positive exponent")
    r = x
    for bit in bin(e)[3:]:  # below the leading 1
        r = fq_mul(r, r)
        if bit == "1":
            r = fq_mul(r, x)
    return r


def fq_inv(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2). Only correct for x not == 0 mod p; callers mask zero cases."""
    return fq_pow_const(x, P - 2)


# ------------------------------------------------------------ host conversions


def to_limbs16(v: int) -> np.ndarray:
    """Canonical limbs of an integer in [0, p)."""
    v %= P
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(L16)], np.int32)


def to_numpy(arr) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def from_limbs16(arr) -> int:
    """Exact value mod p of a (possibly redundant, signed) limb vector."""
    a = to_numpy(arr).astype(object)
    return int(sum(int(a[i]) << (16 * i) for i in range(a.shape[-1]))) % P


FQ_ZERO = to_limbs16(0)
FQ_ONE = to_limbs16(1)

# The kernels' module imports the primitives above, so it is bound last.
from . import cuda_fq as _kernels  # noqa: E402
