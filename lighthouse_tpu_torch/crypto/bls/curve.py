"""BLS12-381 curve groups G1/G2: point ops, serialization, pairing.

Copy of ``lighthouse_tpu/crypto/bls/curve.py`` kept by the port (it
imports nothing of the JAX package).  Decompression differs: it always
runs in the port's own host library (``_native``), which raises when it
cannot be built, so the pure-Python decompression of the copy is gone.

Pure-Python reference (the oracle for the device backend).  Reference
equivalent: the blst library underneath the reference client's
crypto/bls/src/impls/blst.rs.

G1: y² = x³ + 4 over Fq.       G2: y² = x³ + 4(1+u) over Fq2.
Serialization is the ZCash compressed format used by eth2 (48/96 bytes,
flag bits in the top 3 bits of the first byte).
"""

from __future__ import annotations

from lighthouse_tpu_torch.crypto.bls.fields import (
    BLS_X,
    BLS_X_IS_NEG,
    Fq2,
    Fq6,
    Fq12,
    P,
    R,
    final_exponentiation,
)

# Generators (standard, from the BLS12-381 spec).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    Fq2(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    Fq2(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

INF = None  # point at infinity sentinel


# --- generic affine ops (field-agnostic via duck typing) -------------------

class _IntField:
    """Adapter giving plain ints the same protocol as Fq2."""

    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def sq(a):
        return (a * a) % P

    @staticmethod
    def inv(a):
        # extended-gcd inverse: ~20x faster than the P-2 modexp
        return pow(a, -1, P)

    @staticmethod
    def neg(a):
        return (-a) % P

    @staticmethod
    def scale(a, k):
        return (a * k) % P

    @staticmethod
    def is_zero(a):
        return a % P == 0


class _Fq2Field:
    one = Fq2.ONE
    add = staticmethod(lambda a, b: a + b)
    sub = staticmethod(lambda a, b: a - b)
    mul = staticmethod(lambda a, b: a * b)
    sq = staticmethod(lambda a: a.square())
    inv = staticmethod(lambda a: a.inv())
    neg = staticmethod(lambda a: -a)
    scale = staticmethod(lambda a, k: a.scale(k))
    is_zero = staticmethod(lambda a: a.is_zero())


def _ec_double(pt, F):
    if pt is INF:
        return INF
    x, y = pt
    if F.is_zero(y):
        return INF
    lam = F.mul(F.scale(F.sq(x), 3), F.inv(F.scale(y, 2)))
    x3 = F.sub(F.sq(lam), F.scale(x, 2))
    y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
    return (x3, y3)


def _ec_add(p1, p2, F):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _ec_double(p1, F)
        return INF
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sq(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def _ec_neg(pt, F):
    if pt is INF:
        return INF
    return (pt[0], F.neg(pt[1]))


def _jac_double(p, F):
    # 2007 Bernstein-Lange doubling for a=0 curves, Jacobian (X, Y, Z)
    X, Y, Z = p
    A = F.sq(X)
    B = F.sq(Y)
    C = F.sq(B)
    D = F.scale(F.sub(F.sq(F.add(X, B)), F.add(A, C)), 2)
    E = F.scale(A, 3)
    Fv = F.sq(E)
    X3 = F.sub(Fv, F.scale(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.scale(C, 8))
    Z3 = F.scale(F.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add(p, q, F):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if F.is_zero(Z1):
        return q
    if F.is_zero(Z2):
        return p
    Z1Z1 = F.sq(Z1)
    Z2Z2 = F.sq(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _jac_double(p, F)
        return (F.add(U1, U1), F.add(S1, S1), F.sub(Z1, Z1))  # infinity (Z=0)
    H = F.sub(U2, U1)
    I = F.sq(F.scale(H, 2))
    J = F.mul(H, I)
    r = F.scale(F.sub(S2, S1), 2)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sq(r), J), F.scale(V, 2))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.scale(F.mul(S1, J), 2))
    Z3 = F.mul(F.scale(F.mul(Z1, Z2), 2), H)
    return (X3, Y3, Z3)


def _ec_mul(pt, k, F):
    """Scalar mult via Jacobian double-and-add (no field inversions in the
    loop; one inversion to return to affine).

    NOTE: no mod-R reduction — subgroup checks multiply by R itself and
    must see the true scalar (g1_mul(p, R) == INF iff p ∈ subgroup)."""
    if pt is INF or k == 0:
        return INF
    if k < 0:
        return _ec_mul(_ec_neg(pt, F), -k, F)
    zero = F.sub(pt[0], pt[0])
    base = (pt[0], pt[1], F.one)
    acc = (pt[0], pt[1], zero)  # Z=0 → Jacobian infinity
    while k:
        if k & 1:
            acc = _jac_add(acc, base, F)
        base = _jac_double(base, F)
        k >>= 1
    X, Y, Z = acc
    if F.is_zero(Z):
        return INF
    zinv = F.inv(Z)
    zinv2 = F.sq(zinv)
    return (F.mul(X, zinv2), F.mul(F.mul(Y, zinv2), zinv))


# --- G1 ---------------------------------------------------------------------

def g1_add(p1, p2):
    return _ec_add(p1, p2, _IntField)

def g1_double(p):
    return _ec_double(p, _IntField)

def g1_neg(p):
    return _ec_neg(p, _IntField)

def g1_mul(p, k):
    return _ec_mul(p, k, _IntField)

def g1_is_on_curve(p) -> bool:
    if p is INF:
        return True
    x, y = p
    return (y * y - (x * x * x + 4)) % P == 0

def g1_in_subgroup(p) -> bool:
    return g1_is_on_curve(p) and g1_mul(p, R) is INF

def g1_generator():
    return G1_GEN


# --- G2 ---------------------------------------------------------------------

B2 = Fq2(4, 4)

def g2_add(p1, p2):
    return _ec_add(p1, p2, _Fq2Field)

def g2_double(p):
    return _ec_double(p, _Fq2Field)

def g2_neg(p):
    return _ec_neg(p, _Fq2Field)

def g2_mul(p, k):
    return _ec_mul(p, k, _Fq2Field)

def g2_is_on_curve(p) -> bool:
    if p is INF:
        return True
    x, y = p
    return y.square() == x.square() * x + B2

def g2_in_subgroup(p) -> bool:
    """Definitional subgroup check [r]Q == INF (the slow oracle; the
    production path is g2_in_subgroup_fast)."""
    return g2_is_on_curve(p) and g2_mul(p, R) is INF


# ψ: the untwist-Frobenius-twist endomorphism on E'(Fq2),
# ψ(x, y) = (c_x·x̄, c_y·ȳ) with c_x = ξ^(-(p-1)/3), c_y = ξ^(-(p-1)/2)
# (x̄ = Frobenius conjugate).  On G2 it acts as multiplication by p ≡ x
# (mod r), giving the fast membership test ψ(Q) == [x]Q — proven complete
# for BLS12-381 by Scott 2021 ("A note on group membership tests", and
# what blst ships); tests/test_ec.py pins it against the [r]Q oracle on
# both members and cofactor points.
from lighthouse_tpu_torch.crypto.bls.fields import XI

PSI_CX = XI.pow((P - 1) // 3).inv()   # ξ^(-(p-1)/3)
PSI_CY = XI.pow((P - 1) // 2).inv()   # ξ^(-(p-1)/2)


def g2_psi(p):
    if p is INF:
        return INF
    x, y = p
    return (x.conj() * PSI_CX, y.conj() * PSI_CY)


def g2_in_subgroup_fast(p) -> bool:
    """ψ(Q) == [x]Q (x the signed curve parameter): a 64-bit scalar mul
    instead of the 255-bit [r]Q — ~4x faster on the host, and the form
    the batched device check mirrors (ops/ec.g2_subgroup_check_batch)."""
    if p is INF:
        return True
    if not g2_is_on_curve(p):
        return False
    lhs = g2_psi(p)
    rhs = g2_mul(p, -BLS_X if BLS_X_IS_NEG else BLS_X)
    return lhs == rhs

def g2_generator():
    return G2_GEN


# --- serialization (ZCash flags: compressed | infinity | y-sign) -----------

_HALF_P = (P - 1) // 2


def g1_to_bytes(p) -> bytes:
    if p is INF:
        return bytes([0xC0]) + b"\x00" * 47
    x, y = p
    flags = 0x80 | (0x20 if y > _HALF_P else 0)
    raw = x.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def _native():
    """The port's native host library (``ops.native_bls``, built from
    ``csrc/bls_host.cc``).  A failed build raises: the port has no
    silent pure-Python fallback for decompression."""
    from lighthouse_tpu_torch.ops import native_bls

    return native_bls


def g1_from_bytes(data: bytes, *, subgroup_check: bool = True):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    nb = _native()
    res = nb.g1_decompress(data)
    if res is None:
        raise ValueError("invalid G1 compressed point")
    if res == nb.G1_INF:
        return INF
    pt = res
    if subgroup_check and not g1_in_subgroup(pt):
        raise ValueError("G1 point not in subgroup")
    return pt


def g2_to_bytes(p) -> bytes:
    if p is INF:
        return bytes([0xC0]) + b"\x00" * 95
    x, y = p
    y_big = (y.b > _HALF_P) if y.b != 0 else (y.a > _HALF_P)
    flags = 0x80 | (0x20 if y_big else 0)
    raw = x.b.to_bytes(48, "big") + x.a.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def g2_from_bytes(data: bytes, *, subgroup_check: bool = True):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    nb = _native()
    res = nb.g2_decompress(data)
    if res is None:
        raise ValueError("invalid G2 compressed point")
    if res == nb.G2_INF:
        return INF
    (xa, xb), (ya, yb) = res
    pt = (Fq2(xa, xb), Fq2(ya, yb))
    if subgroup_check and not g2_in_subgroup_fast(pt):
        raise ValueError("G2 point not in subgroup")
    return pt


# --- pairing ----------------------------------------------------------------

def _untwist(q):
    """E'(Fq2) -> E(Fq12): (x', y') -> (x'/w², y'/w³)."""
    x, y = q
    # embed Fq2 scalars into Fq12 (as c0.c0 coefficient)
    def emb(f2):
        return Fq12(Fq6(f2, Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)

    w = Fq12(Fq6.ZERO, Fq6.ONE)
    w2_inv = (w * w).inv()
    w3_inv = (w * w * w).inv()
    return (emb(x) * w2_inv, emb(y) * w3_inv)


def miller_loop(p, q) -> Fq12:
    """Miller loop for the optimal ate pairing over embedded points.

    p: G1 affine (ints), q: G2 affine (Fq2).  Returns f (pre-final-exp).
    """
    if p is INF or q is INF:
        return Fq12.ONE

    def emb_int(v):
        return Fq12(Fq6(Fq2(v, 0), Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)

    p12 = (emb_int(p[0]), emb_int(p[1]))
    q12 = _untwist(q)

    f = Fq12.ONE
    t = q12
    F = _Fq12Field
    for bit in bin(BLS_X)[3:]:
        f = f.square() * _line12(t, t, p12)
        t = _ec_double(t, F)
        if bit == "1":
            f = f * _line12(t, q12, p12)
            t = _ec_add(t, q12, F)
    if BLS_X_IS_NEG:
        f = f.conj()
    return f


class _Fq12Field:
    add = staticmethod(lambda a, b: a + b)
    sub = staticmethod(lambda a, b: a - b)
    mul = staticmethod(lambda a, b: a * b)
    sq = staticmethod(lambda a: a.square())
    inv = staticmethod(lambda a: a.inv())
    neg = staticmethod(lambda a: -a)
    scale = staticmethod(lambda a, k: _fq12_scale(a, k))
    is_zero = staticmethod(lambda a: a == Fq12.ZERO)


def _fq12_scale(a: Fq12, k: int) -> Fq12:
    return Fq12(a.c0.mul_fq2(Fq2(k, 0)), a.c1.mul_fq2(Fq2(k, 0)))


def _line12(t, q, p12) -> Fq12:
    """Line through t and q (tangent when equal), evaluated at p12 (Fq12)."""
    xt, yt = t
    xq, yq = q
    xp, yp = p12
    if xt == xq and yt == yq:
        lam = _fq12_scale(xt * xt, 3) * _fq12_scale(yt, 2).inv()
    elif xt == xq:
        return xp - xt
    else:
        lam = (yq - yt) * (xq - xt).inv()
    return yp - yt - lam * (xp - xt)


def pairing(p, q) -> Fq12:
    """Full pairing e(p ∈ G1, q ∈ G2) ∈ Fq12 (final exponentiation applied)."""
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs) -> Fq12:
    """prod e(p_i, q_i): one Miller loop each, a single final exponentiation.

    The batch-verification core (reference blst
    verify_multiple_aggregate_signatures shape)."""
    f = Fq12.ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)
