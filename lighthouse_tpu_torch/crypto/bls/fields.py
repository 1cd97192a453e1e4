"""BLS12-381 extension-field tower over Python integers (the golden model).

Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 1+u; Fp12 = Fp6[w]/(w^2 - v).

This is the bit-exact host reference against which the JAX/TPU kernels in
``lighthouse_tpu/ops`` are validated (the role the ``blst`` C library plays for the
reference client's ``crypto/bls/src/impls/blst.rs``).  Clarity over speed; used by
tests, key management, and as the CPU fallback backend.
"""

from __future__ import annotations

from .params import P


class Fq:
    """Element of the base field GF(p)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)

    def __add__(self, o: "Fq") -> "Fq":
        return Fq(self.n + o.n)

    def __sub__(self, o: "Fq") -> "Fq":
        return Fq(self.n - o.n)

    def __mul__(self, o: "Fq") -> "Fq":
        return Fq(self.n * o.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inv(self) -> "Fq":
        if self.n == 0:
            raise ZeroDivisionError("inverse of 0 in Fq")
        return Fq(pow(self.n, P - 2, P))

    def pow(self, e: int) -> "Fq":
        return Fq(pow(self.n, e, P))

    def is_zero(self) -> bool:
        return self.n == 0

    def is_square(self) -> bool:
        return self.n == 0 or pow(self.n, (P - 1) // 2, P) == 1

    def sqrt(self):
        """Square root (p ≡ 3 mod 4) or None if not a QR."""
        if self.n == 0:
            return Fq(0)
        c = pow(self.n, (P + 1) // 4, P)
        if c * c % P != self.n:
            return None
        return Fq(c)

    def sgn0(self) -> int:
        return self.n & 1

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self):
        return hash(("Fq", self.n))

    def __repr__(self):
        return f"Fq(0x{self.n:x})"


class Fq2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq2(t0 - t1, c1)

    def mul_scalar(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def conj(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def mul_by_xi(self) -> "Fq2":
        """Multiply by xi = 1 + u (the Fp6 non-residue)."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def inv(self) -> "Fq2":
        if self.is_zero():
            raise ZeroDivisionError("inverse of 0 in Fq2")
        d = pow(self.c0 * self.c0 + self.c1 * self.c1, P - 2, P)
        return Fq2(self.c0 * d, -self.c1 * d)

    def pow(self, e: int) -> "Fq2":
        if e < 0:
            return self.inv().pow(-e)
        r = Fq2.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def is_square(self) -> bool:
        # norm = c0^2 + c1^2 must be a square in Fp.
        n = (self.c0 * self.c0 + self.c1 * self.c1) % P
        return n == 0 or pow(n, (P - 1) // 2, P) == 1

    def sqrt(self):
        """Square root via the complex method (p ≡ 3 mod 4), or None."""
        if self.is_zero():
            return Fq2(0, 0)
        a0, a1 = self.c0, self.c1
        if a1 == 0:
            s = Fq(a0).sqrt()
            if s is not None:
                return Fq2(s.n, 0)
            # sqrt(a0) = i * sqrt(-a0)
            s = Fq(-a0).sqrt()
            if s is None:
                return None
            return Fq2(0, s.n)
        n = (a0 * a0 + a1 * a1) % P
        s = pow(n, (P + 1) // 4, P)
        if s * s % P != n:
            return None
        inv2 = pow(2, P - 2, P)
        d = (a0 + s) * inv2 % P
        x = Fq(d).sqrt()
        if x is None:
            d = (a0 - s) * inv2 % P
            x = Fq(d).sqrt()
            if x is None:
                return None
        if x.n == 0:
            return None
        y = a1 * inv2 % P * pow(x.n, P - 2, P) % P
        cand = Fq2(x.n, y)
        if cand.square() == self:
            return cand
        return None

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for m=2."""
        sign_0 = self.c0 & 1
        zero_0 = self.c0 == 0
        sign_1 = self.c1 & 1
        return sign_0 | (int(zero_0) & sign_1)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq2", self.c0, self.c1))

    def __repr__(self):
        return f"Fq2(0x{self.c0:x}, 0x{self.c1:x})"


class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = xi = 1+u."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_v(self) -> "Fq6":
        """Multiply by v (the Fp12 non-residue)."""
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        c0 = a0.square() - (a1 * a2).mul_by_xi()
        c1 = a2.square().mul_by_xi() - a0 * a1
        c2 = a1.square() - a0 * a2
        t = (a0 * c0 + (a2 * c1 + a1 * c2).mul_by_xi()).inv()
        return Fq6(c0 * t, c1 * t, c2 * t)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash(("Fq6", self.c0, self.c1, self.c2))

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"


# Frobenius coefficients gamma_i = xi^{i*(p-1)/6}, i = 1..5.
_XI = Fq2(1, 1)
GAMMA = [ _XI.pow(i * (P - 1) // 6) for i in range(6) ]  # GAMMA[0] unused (== 1)


class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def from_fq2(x: Fq2) -> "Fq12":
        return Fq12(Fq6(x, Fq2.zero(), Fq2.zero()), Fq6.zero())

    @staticmethod
    def w() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.one())

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c0 = t0 + t1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def conj(self) -> "Fq12":
        """Conjugation = Frobenius^6 (inverse on the cyclotomic subgroup)."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        t = (self.c0.square() - self.c1.square().mul_by_v()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def frobenius(self) -> "Fq12":
        """x -> x^p."""
        a0, a1, a2 = self.c0.c0, self.c0.c1, self.c0.c2
        b0, b1, b2 = self.c1.c0, self.c1.c1, self.c1.c2
        return Fq12(
            Fq6(a0.conj(), a1.conj() * GAMMA[2], a2.conj() * GAMMA[4]),
            Fq6(b0.conj() * GAMMA[1], b1.conj() * GAMMA[3], b2.conj() * GAMMA[5]),
        )

    def frobenius_n(self, n: int) -> "Fq12":
        r = self
        for _ in range(n % 12):
            r = r.frobenius()
        return r

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        r = Fq12.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def is_one(self) -> bool:
        return self.c0 == Fq6.one() and self.c1.is_zero()

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq12", self.c0, self.c1))

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"
