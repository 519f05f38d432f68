"""BLS12-381 field towers: Fq, Fq2, Fq6, Fq12 (pure-Python reference).

Copy of ``lighthouse_tpu/crypto/bls/fields.py`` kept by the port, which
imports nothing of the JAX package.

From-scratch implementation (no external crypto deps).  This is the
correctness oracle for the batched JAX/Pallas field kernels in
lighthouse_tpu/ops/bls_field.py — the reference's equivalent layer lives
inside the blst C library (consumed via crypto/bls/src/impls/blst.rs).

Tower:  Fq2 = Fq[u]/(u²+1),  Fq6 = Fq2[v]/(v³-ξ) with ξ=1+u,
        Fq12 = Fq6[w]/(w²-v).
"""

from __future__ import annotations

# Base field modulus and curve order.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (the curve is parameterized by this; negative).
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

_INV2 = pow(2, -1, P)


class Fq2:
    """a + b·u with u² = -1."""

    __slots__ = ("a", "b")
    ZERO: "Fq2"
    ONE: "Fq2"

    def __init__(self, a: int, b: int):
        self.a = a % P
        self.b = b % P

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.a + o.a, self.b + o.b)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.a - o.a, self.b - o.b)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.a, -self.b)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # Karatsuba: (a0+b0u)(a1+b1u) = a0a1-b0b1 + ((a0+b0)(a1+b1)-a0a1-b0b1)u
        t0 = self.a * o.a
        t1 = self.b * o.b
        t2 = (self.a + self.b) * (o.a + o.b)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def square(self) -> "Fq2":
        # (a+bu)² = (a+b)(a-b) + 2ab·u
        return Fq2((self.a + self.b) * (self.a - self.b), 2 * self.a * self.b)

    def scale(self, k: int) -> "Fq2":
        return Fq2(self.a * k, self.b * k)

    def inv(self) -> "Fq2":
        # pow(·, -1, P) is extended-gcd: ~20x faster than the P-2 modexp
        d = pow(self.a * self.a + self.b * self.b, -1, P)
        return Fq2(self.a * d, -self.b * d)

    def conj(self) -> "Fq2":
        """Frobenius x^p = conjugate (u^p = -u since p ≡ 3 mod 4)."""
        return Fq2(self.a, -self.b)

    def pow(self, e: int) -> "Fq2":
        out, base = Fq2.ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0

    def sgn0(self) -> int:
        """RFC 9380 sign for m=2: parity of a, or of b when a == 0."""
        s0, z0 = self.a & 1, self.a == 0
        return s0 | (z0 & (self.b & 1))

    def legendre_is_square(self) -> bool:
        # Euler criterion via the norm: x is a square in Fq2 iff
        # norm(x)^((p-1)/2) != -1  (norm = a² + b² maps to Fq).
        n = (self.a * self.a + self.b * self.b) % P
        return pow(n, (P - 1) // 2, P) != P - 1

    def sqrt(self) -> "Fq2 | None":
        """Square root (p ≡ 3 mod 4 fast path), None if not a square."""
        if self.is_zero():
            return Fq2(0, 0)
        # candidate = x^((p²+7)/16)?  Use the standard complex method:
        # for x = a+bu, norm n = a²+b²; s = sqrt(n) in Fq (exists iff x is a
        # square or -x is...); then y with y.a² = (a+s)/2.
        n = (self.a * self.a + self.b * self.b) % P
        s = pow(n, (P + 1) // 4, P)
        if (s * s - n) % P != 0:
            return None
        for sign in (1, -1):
            t = (self.a + sign * s) * _INV2 % P
            ya = pow(t, (P + 1) // 4, P)
            if (ya * ya - t) % P != 0:
                continue
            if ya == 0:
                yb_sq = (-self.a) % P
                yb = pow(yb_sq, (P + 1) // 4, P)
                if (yb * yb - yb_sq) % P == 0 and Fq2(0, yb).square() == self:
                    return Fq2(0, yb)
                continue
            yb = self.b * pow(2 * ya, -1, P) % P
            cand = Fq2(ya, yb)
            if cand.square() == self:
                return cand
        return None

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash((self.a, self.b))

    def __repr__(self):
        return f"Fq2({hex(self.a)}, {hex(self.b)})"


Fq2.ZERO = Fq2(0, 0)
Fq2.ONE = Fq2(1, 0)

XI = Fq2(1, 1)  # ξ = 1 + u, the Fq6 non-residue


class Fq6:
    """c0 + c1·v + c2·v² with v³ = ξ."""

    __slots__ = ("c0", "c1", "c2")
    ZERO: "Fq6"
    ONE: "Fq6"

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_fq2(self, k: Fq2):
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self):
        """multiply by v: (c0,c1,c2) -> (c2·ξ, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - b * c * XI
        t1 = c.square() * XI - a * b
        t2 = b.square() - a * c
        d = (a * t0 + (c * t1 + b * t2) * XI).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2
        )

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"


Fq6.ZERO = Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)
Fq6.ONE = Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)


class Fq12:
    """c0 + c1·w with w² = v."""

    __slots__ = ("c0", "c1")
    ZERO: "Fq12"
    ONE: "Fq12"

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c0 = t0 + t1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conj(self) -> "Fq12":
        """x^(p^6): w^(p^6) = -w, so negate the w-coefficient."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        d = (self.c0.square() - self.c1.square().mul_by_v()).inv()
        return Fq12(self.c0 * d, -(self.c1 * d))

    def pow(self, e: int) -> "Fq12":
        out, base = Fq12.ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def is_one(self):
        return self == Fq12.ONE

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"


Fq12.ZERO = Fq12(Fq6.ZERO, Fq6.ZERO)
Fq12.ONE = Fq12(Fq6.ONE, Fq6.ZERO)


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r).

    Easy part (p^6-1)(p^2+1) via conjugation/inversion/Frobenius-free pows,
    then the hard part (p^4-p^2+1)/r by plain square-and-multiply — this is
    the reference oracle, clarity over speed (final_exponentiation_fast is
    the production path).
    """
    g = f.conj() * f.inv()          # f^(p^6-1)
    g = g.pow(P * P) * g            # ^(p^2+1)
    h = (P**4 - P**2 + 1) // R
    return g.pow(h)


# --- fast final exponentiation ---------------------------------------------
#
# Frobenius maps + the BLS12 x-ladder.  With x the (negative) curve
# parameter and h = (p^4 - p^2 + 1)/r, the verified identity
#
#     3h = c0 + c1*p + c2*p^2 + c3*p^3,   c3 = (x-1)^2 = x(x-2)+1,
#     c2 = x*c3,  c1 = x*c2 - c3,  c0 = x*c1 + 3
#
# lets the hard part run as 5 x-exponentiations (63 squarings each) and a
# handful of products — ~25x fewer Fq12 ops than the plain 1270-bit pow.
# The result is the CUBE of the true final exponentiation; since the
# target lives in mu_r and gcd(3, r) = 1, cubing is a bijection there, so
# is_one() semantics are identical (blst ships the same cubed variant).

_FROB_G: list[Fq2] | None = None


def _frob_gamma() -> list[Fq2]:
    global _FROB_G
    if _FROB_G is None:
        e = (P - 1) // 6
        _FROB_G = [XI.pow(k * e) for k in range(6)]
    return _FROB_G


def frobenius(f: Fq12, n: int = 1) -> Fq12:
    """f^(p^n) via coefficient conjugation + ξ-power twists (v^p = γ2-ish,
    w^p = γ1·w)."""
    g = _frob_gamma()
    for _ in range(n):
        a0, a1, a2 = f.c0.c0, f.c0.c1, f.c0.c2
        b0, b1, b2 = f.c1.c0, f.c1.c1, f.c1.c2
        f = Fq12(
            Fq6(a0.conj(), a1.conj() * g[2], a2.conj() * g[4]),
            Fq6(b0.conj() * g[1], b1.conj() * g[3], b2.conj() * g[5]),
        )
    return f


def _pow_u_cyc(f: Fq12) -> Fq12:
    """f^|x| by square-and-multiply (cyclotomic-subgroup input)."""
    out = f
    for bit in bin(BLS_X)[3:]:
        out = out.square()
        if bit == "1":
            out = out * f
    return out


def final_exp_easy(f: Fq12) -> Fq12:
    """Easy part f^((p^6-1)(p^2+1)): one inversion, lands in the
    cyclotomic subgroup (where conj() is inversion)."""
    t = f.conj() * f.inv()            # f^(p^6 - 1)
    return frobenius(t, 2) * t        # ^(p^2 + 1)


def final_exp_hard(m: Fq12) -> Fq12:
    """Hard part (m^((p^4-p^2+1)/r))^3 via the x-ladder (m cyclotomic).

    This is the host oracle for ops/bls12_381.final_exp_hard_device —
    the device mirror runs the identical ladder."""
    # x < 0: f^x = conj(f^|x|) (conj inverts in the cyclotomic subgroup)
    px = lambda g: _pow_u_cyc(g).conj()   # noqa: E731  g^x
    t1 = px(m)                            # m^x
    g3 = px(t1) * t1.square().conj() * m  # m^(x^2 - 2x + 1)
    g2 = px(g3)                           # m^(x*c3)
    g1 = px(g2) * g3.conj()               # m^(x*c2 - c3)
    g0 = px(g1) * m.square() * m          # m^(x*c1 + 3)
    return g0 * frobenius(g1, 1) * frobenius(g2, 2) * frobenius(g3, 3)


def final_exponentiation_fast(f: Fq12) -> Fq12:
    """(f^((p^12-1)/r))^3 — same is_one() verdict, ~25x faster hard part."""
    return final_exp_hard(final_exp_easy(f))
