"""Branch-free elliptic-curve group ops for G1(Fq) and G2(Fq2) (PyTorch).

The counterpart of ``lighthouse_tpu/ops/ec.py``: the *complete* projective
addition/doubling formulas for j-invariant-0 short-Weierstrass curves
(Renes–Costello–Batina 2015, algorithms 7/9), so one algebraic path covers
generic addition, doubling, inputs at infinity and P + (-P), with the
identity represented as (0 : 1 : 0).  Same formulas and the same fused
product rounds as the JAX package, so the limbs agree with it.

Points are tuples ``(X, Y, Z)`` of limb tensors; G1 coords are (..., 25),
G2 coords (..., 2, 25).  The functions are generic over the two fields via a
small op-table.  The JAX package's loops (``lax.scan`` / ``fori_loop``) are
host loops here, and its one-hot einsums (window digits, table select) are
shift-and-add and indexing: torch has no integer matrix product on CUDA.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..crypto.bls import fields as hf
from ..crypto.bls.params import G1_X, G1_Y, G2_X_C0, G2_X_C1, G2_Y_C0, G2_Y_C1, P
from . import fq as _fq
from . import tower as _tw


class FieldOps(NamedTuple):
    mul_by_b3: Callable      # multiply by 3*b of the curve
    zero: np.ndarray
    one: np.ndarray
    # many(muls, squares) -> (mul_results, square_results): all the round's
    # independent products fused into ONE kernel launch.
    many: Callable


def _g1_mul_by_b3(x):
    return _fq.fq_mul_small(x, 12)          # b = 4


def _g2_mul_by_b3(x):
    # b' = 4(1+u); 3b' = 12(1+u) = 12 * xi
    return _tw.fq2_mul_by_xi(_tw.fq2_mul_small(x, 12))


def _g1_many(muls=(), squares=()):
    # Fq squaring IS fq_mul(a, a) — fold the squares into the same launch.
    outs = _fq.fq_mul_many(list(muls) + [(s, s) for s in squares])
    return outs[: len(muls)], outs[len(muls):]


G1_OPS = FieldOps(_g1_mul_by_b3, _fq.FQ_ZERO, _fq.FQ_ONE, _g1_many)
G2_OPS = FieldOps(_g2_mul_by_b3, _tw.FQ2_ZERO, _tw.FQ2_ONE, _tw.fq2_many)


def identity(ops: FieldOps, batch_shape=(), device="cpu"):
    shape = tuple(batch_shape) + ops.zero.shape
    zero = _fq.const(ops.zero, device).expand(shape)
    one = _fq.const(ops.one, device).expand(shape)
    return (zero, one, zero)


def point_add(ops: FieldOps, p, q):
    """Complete addition (RCB15 algorithm 7, a = 0): 12 field products in
    TWO fused rounds of 6."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    b3 = ops.mul_by_b3
    (t0, t1, t2, t3, t4, x3), _ = ops.many(
        [(x1, x2), (y1, y2), (z1, z2),
         (x1 + y1, x2 + y2), (y1 + z1, y2 + z2), (x1 + z1, x2 + z2)])
    t3 = t3 - t0 - t1
    t4 = t4 - t1 - t2
    y3 = x3 - t0 - t2
    x3 = t0 + t0 + t0
    t2 = b3(t2)
    z3 = t1 + t2
    t1 = t1 - t2
    y3 = b3(y3)
    (m_t4y3, m_t3t1, m_y3x3, m_t1z3, m_x3t3, m_z3t4), _ = ops.many(
        [(t4, y3), (t3, t1), (y3, x3), (t1, z3), (x3, t3), (z3, t4)])
    return (m_t3t1 - m_t4y3, m_t1z3 + m_y3x3, m_z3t4 + m_x3t3)


def point_double(ops: FieldOps, p):
    """Complete doubling (RCB15 algorithm 9, a = 0) — 8 field products in
    THREE fused rounds."""
    x, y, z = p
    b3 = ops.mul_by_b3
    (t1,), (t0, t2) = ops.many([(y, z)], [y, z])
    z3 = t0 + t0
    z3 = z3 + z3
    z3 = z3 + z3
    t2 = b3(t2)
    y3 = t0 + t2
    (x3, z3o, xy), _ = ops.many([(t2, z3), (t1, z3), (x, y)])
    t0 = t0 - (t2 + t2 + t2)
    (y3o, x3o), _ = ops.many([(t0, y3), (t0, xy)])
    return (x3o + x3o, x3 + y3o, z3o)


def point_neg(p):
    """-P: the Y limbs negated one by one (int32 negation, no reduction),
    as the JAX package does, so the limbs stay identical."""
    x, y, z = p
    return (x, -y, z)


def point_select(flag, p, q):
    """flag ? p : q, broadcasting flag (bool, batch shape) over coords."""
    def sel(a, b):
        f = flag.reshape(tuple(flag.shape) + (1,) * (a.dim() - flag.dim()))
        return torch.where(f, a, b)
    return tuple(sel(a, b) for a, b in zip(p, q))


def scalar_mul_bits(ops: FieldOps, p, bits):
    """[k]P with k given MSB-first as an int32 bit tensor (..., NBITS).

    Fixed-length left-to-right double-and-add with a select, every step
    (double, complete add, select), as the JAX package's ``fori_loop``
    does; here the loop runs on the host over the bit columns.  Every step
    is row-wise, so rows of several scalar multiplications may be stacked
    into one call."""
    flags = bits.bool()
    acc = identity(ops, tuple(bits.shape[:-1]), bits.device)
    for i in range(bits.shape[-1]):
        acc = point_double(ops, acc)
        acc = point_select(flags[..., i], point_add(ops, acc, p), acc)
    return acc


def _window_digits(bits: torch.Tensor, window: int) -> torch.Tensor:
    """MSB-first bit tensor (..., NBITS) -> MSB-first base-2^window digits
    (..., NBITS/window), each in [0, 2^window)."""
    nbits = bits.shape[-1]
    if nbits % window:
        raise ValueError(f"{nbits} bits do not split into {window}-bit windows")
    grouped = bits.reshape(*bits.shape[:-1], nbits // window, window)
    digits = grouped[..., 0]
    for j in range(1, window):
        digits = (digits << 1) + grouped[..., j]
    return digits


def _window_table(ops: FieldOps, p, window: int):
    """Stacked multiples [0]P..[2^w-1]P: tuple of (2^w, ...) coord tensors,
    each row one complete addition after the previous (row 0 the identity)."""
    acc = identity(ops, p[0].shape[: p[0].dim() - ops.zero.ndim], p[0].device)
    rows = [acc]
    for _ in range((1 << window) - 1):
        acc = point_add(ops, acc, p)
        rows.append(acc)
    return tuple(torch.stack([r[c] for r in rows]) for c in range(3))


def _table_select(table, digits: torch.Tensor):
    """table: (2^w, N, ...) coords; digits: (N,) -> selected (N, ...) points."""
    cols = torch.arange(digits.shape[0], device=digits.device)
    return tuple(c[digits.long(), cols] for c in table)


def scalar_mul_windowed(ops: FieldOps, p, bits, window: int = 4):
    """Per-set [k]P via fixed 2^w windows: a per-set multiples table + NBITS/w
    ladder steps of (w doublings + one table-select + one add)."""
    digits = _window_digits(bits, window)  # (N, S) MSB-first
    table = _window_table(ops, p, window)  # (2^w, N, ...)
    acc = identity(ops, tuple(bits.shape[:-1]), bits.device)
    for s in range(digits.shape[-1]):
        for _ in range(window):
            acc = point_double(ops, acc)
        acc = point_add(ops, acc, _table_select(table, digits[..., s]))
    return acc


def msm_windowed(ops: FieldOps, pts, bits, window: int = 4):
    """Multi-scalar multiplication sum_i [k_i] P_i with one SHARED doubling
    ladder (the batch-verification W = sum [r_i] sig_i).

    Per ladder step: w doublings of ONE accumulator + a table select + a
    tree-sum across the batch."""
    n = pts[0].shape[0]
    if n & (n - 1):
        # Pad to the next power of two with identity points + zero scalars —
        # exact neutral contributions.
        pts = _pad_identity_rows(ops, pts, 0, n)
        pad = pts[0].shape[0] - n
        bits = torch.cat([bits, bits.new_zeros((pad,) + tuple(bits.shape[1:]))])
    digits = _window_digits(bits, window)  # (N, S)
    table = _window_table(ops, pts, window)  # (2^w, N, ...)
    acc = identity(ops, (), bits.device)
    for s in range(digits.shape[-1]):
        for _ in range(window):
            acc = point_double(ops, acc)
        contrib = _table_select(table, digits[..., s])  # (N, ...) points
        acc = point_add(ops, acc, tree_sum(ops, contrib, axis=0))
    return acc


def _pad_identity_rows(ops: FieldOps, pts, axis: int, n: int):
    """Grow ``axis`` from ``n`` to the next power of two with identity
    points (the group's exact neutral element)."""
    m = 1 << (n - 1).bit_length()
    device = pts[0].device
    out = []
    for c, idc in zip(pts, (ops.zero, ops.one, ops.zero)):
        shape = list(c.shape)
        shape[axis] = m - n
        pad_block = _fq.const(idc, device).expand(tuple(shape))
        out.append(torch.cat([c, pad_block], dim=axis))
    return tuple(out)


def tree_sum(ops: FieldOps, pts, axis: int = 0):
    """Sum points along a batch axis by halving rounds of complete additions
    (non-power-of-two lengths are first padded with identity rows)."""
    n = pts[0].shape[axis]
    if n & (n - 1):
        pts = _pad_identity_rows(ops, pts, axis, n)
        n = pts[0].shape[axis]
    while n > 1:
        half = n // 2
        lows = tuple(c.narrow(axis, 0, half) for c in pts)
        highs = tuple(c.narrow(axis, half, half) for c in pts)
        pts = point_add(ops, lows, highs)
        n = half
    return tuple(c.squeeze(axis) for c in pts)


# ------------------------------------------------------------ host conversion


def g1_to_limbs(pt) -> tuple:
    """Host affine G1 point (golden-model Fq pair or None) -> projective limbs."""
    if pt is None:
        return (_fq.FQ_ZERO, _fq.FQ_ONE, _fq.FQ_ZERO)
    x, y = pt
    return (_fq.to_limbs16(x.n), _fq.to_limbs16(y.n), _fq.to_limbs16(1))


def g2_to_limbs(pt) -> tuple:
    if pt is None:
        return (_tw.FQ2_ZERO, _tw.FQ2_ONE, _tw.FQ2_ZERO)
    x, y = pt
    one = hf.Fq2(1, 0)
    return (_tw.fq2_to_limbs(x), _tw.fq2_to_limbs(y), _tw.fq2_to_limbs(one))


def g1_from_limbs(p):
    """Projective limbs -> host affine golden-model point (exact, host-side)."""
    x = _fq.from_limbs16(p[0])
    y = _fq.from_limbs16(p[1])
    z = _fq.from_limbs16(p[2])
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    return (hf.Fq(x * zi % P), hf.Fq(y * zi % P))


def g2_from_limbs(p):
    x = _tw.fq2_from_limbs(p[0])
    y = _tw.fq2_from_limbs(p[1])
    z = _tw.fq2_from_limbs(p[2])
    if z.is_zero():
        return None
    zi = z.inv()
    return (x * zi, y * zi)


def bits_msb(k: int, nbits: int) -> np.ndarray:
    return np.array([(k >> (nbits - 1 - i)) & 1 for i in range(nbits)], np.int32)


G1_GEN_LIMBS = g1_to_limbs((hf.Fq(G1_X), hf.Fq(G1_Y)))
G2_GEN_LIMBS = g2_to_limbs((hf.Fq2(G2_X_C0, G2_X_C1), hf.Fq2(G2_Y_C0, G2_Y_C1)))
