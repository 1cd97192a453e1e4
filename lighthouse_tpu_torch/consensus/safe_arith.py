"""Checked u64 spec arithmetic (reference: ``consensus/safe_arith``).

Every balance/reward/slashing quantity in the spec is a ``uint64``; the
reference routes all spec arithmetic through ``SafeArith`` so an overflow
is a *typed error* that invalidates the block, never a silent wrap or a
panic (``consensus/safe_arith/src/lib.rs``: ``ArithError::Overflow`` ⇒
``BlockProcessingError``).  Python ints can't wrap, which hides the other
half of the contract: a result outside ``[0, 2**64)`` must be REJECTED,
because a real u64 implementation (and the SSZ encoding of the state)
cannot represent it.

``per_block_processing`` maps :class:`ArithError` to
``BlockProcessingError`` at its boundary, so an overflowing block is
invalid — not a crash, not a wrapped balance.

A copy of the JAX package's ``lighthouse_tpu/consensus/safe_arith.py``.
Raw arithmetic on spec-typed quantities in the port's ``consensus/``
routes through this module or carries a ``# safe-arith: ok(<reason>)``
pragma, as in the JAX package (whose static pass checks its own tree).
"""

from __future__ import annotations

U64_MAX = 2**64 - 1


class ArithError(ValueError):
    """A spec-arithmetic result left the u64 domain (overflow/underflow/
    division by zero).  Mapped to block-invalid at processing boundaries."""


def _check(value: int, op: str, a: int, b: int) -> int:
    if 0 <= value <= U64_MAX:
        return value
    kind = "underflow" if value < 0 else "overflow"
    raise ArithError(f"u64 {kind}: {a} {op} {b} = {value}")


def safe_add(a: int, b: int) -> int:
    """``a + b`` or :class:`ArithError` on u64 overflow."""
    return _check(int(a) + int(b), "+", a, b)


def safe_sub(a: int, b: int) -> int:
    """``a - b`` or :class:`ArithError` on underflow below zero."""
    return _check(int(a) - int(b), "-", a, b)


def saturating_sub(a: int, b: int) -> int:
    """``max(0, a - b)`` — the spec's explicitly-saturating decrease
    (e.g. ``decrease_balance``)."""
    return max(0, int(a) - int(b))


def safe_mul(a: int, b: int) -> int:
    """``a * b`` or :class:`ArithError` on u64 overflow."""
    return _check(int(a) * int(b), "*", a, b)


def safe_div(a: int, b: int) -> int:
    """Floor division; :class:`ArithError` on division by zero (the spec's
    ``ArithError::DivisionByZero``)."""
    if int(b) == 0:
        raise ArithError(f"division by zero: {a} // 0")
    return _check(int(a) // int(b), "//", a, b)


def safe_mod(a: int, b: int) -> int:
    if int(b) == 0:
        raise ArithError(f"modulo by zero: {a} % 0")
    return _check(int(a) % int(b), "%", a, b)


def safe_pow(a: int, b: int) -> int:
    """``a ** b`` with the exponent bounded up front: 2**64 is the largest
    representable power, so any exponent past 64 with base >= 2 is a
    guaranteed overflow — bail before computing a giant int."""
    a, b = int(a), int(b)
    if b < 0:
        raise ArithError(f"negative exponent: {a} ** {b}")
    if a >= 2 and b > 64:
        raise ArithError(f"u64 overflow: {a} ** {b}")
    return _check(a**b, "**", a, b)


def safe_shl(a: int, b: int) -> int:
    a, b = int(a), int(b)
    if b < 0 or b >= 64:
        raise ArithError(f"shift out of range: {a} << {b}")
    return _check(a << b, "<<", a, b)


def safe_shr(a: int, b: int) -> int:
    a, b = int(a), int(b)
    if b < 0 or b >= 64:
        # same contract as safe_shl / the reference's checked shifts: an
        # out-of-range shift amount is an arithmetic error, not a silent 0
        raise ArithError(f"shift out of range: {a} >> {b}")
    return _check(a >> b, ">>", a, b)


def checked_u64(value: int, what: str = "value") -> int:
    """Assert ``value`` is representable as u64; returns it unchanged.
    Use at ingestion boundaries (decoded integers, device readbacks)."""
    value = int(value)
    if not 0 <= value <= U64_MAX:
        raise ArithError(f"{what} outside u64 range: {value}")
    return value
