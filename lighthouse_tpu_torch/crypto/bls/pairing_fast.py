r"""Inversion-free projective Miller loop with sparse line evaluation.

Copy of ``lighthouse_tpu/crypto/bls/pairing_fast.py`` kept by the port, which
imports nothing of the JAX package.

This is the algorithm the batched device backend implements
(lighthouse_tpu/ops/bls12_381.py); it lives here in scalar pure Python as
the bridge oracle between the slow-but-obviously-correct embedded loop in
curve.py (which inverts per step) and the JAX port.

Math (derived by denominator elimination, standard for even embedding
degree): with the M-twist untwist (x, y) = (x'/w², y'/w³), the line
through the running Jacobian point T = (X, Y, Z) over Fq2 evaluated at
P = (xp, yp) ∈ G1, cleared by the subfield-and-w factor 2YZ³·w³ (killed
by the final exponentiation), is

    l = (3X³ − 2Y²)  +  (−3X²Z²·xp)·w²  +  (2YZ³·yp)·w³
        \_ a0 ∈ Fq2 _/   \_ a1·v  ____/    \_ b1·v·w ___/

and the chord through T and affine Q = (xq, yq), cleared by D·w³ with
D = (X − xq·Z²)·Z and N = Y − yq·Z³:

    l = (N·xq − D·yq) + (−N·xp)·w² + (D·yp)·w³

Both are sparse in Fq12 basis positions (c0.c0, c0.c1, c1.c1) — the
"mul_by_014" shape every pairing library exploits.
"""

from __future__ import annotations

from lighthouse_tpu_torch.crypto.bls.fields import (
    BLS_X,
    BLS_X_IS_NEG,
    Fq2,
    Fq6,
    Fq12,
)

_X_BITS = bin(BLS_X)[3:]  # MSB-first, skipping the leading 1


def _sparse_line(a0: Fq2, a1: Fq2, b1: Fq2) -> Fq12:
    return Fq12(Fq6(a0, a1, Fq2.ZERO), Fq6(Fq2.ZERO, b1, Fq2.ZERO))


def _jac_double_fq2(X, Y, Z):
    """a=0 Jacobian doubling over Fq2 (dbl-2009-l)."""
    A = X.square()
    B = Y.square()
    C = B.square()
    D = ((X + B).square() - A - C).scale(2)
    E = A.scale(3)
    F = E.square()
    X3 = F - D.scale(2)
    Y3 = E * (D - X3) - C.scale(8)
    Z3 = (Y * Z).scale(2)
    return X3, Y3, Z3


def _jac_add_affine_fq2(X, Y, Z, xq, yq):
    """Mixed Jacobian + affine addition over Fq2 (madd-2007-bl).

    Assumes T != ±Q, which holds throughout the Miller loop for points of
    prime order r (the loop scalar |x| < r never hits T = ±Q)."""
    Z2 = Z.square()
    U2 = xq * Z2
    S2 = yq * Z * Z2
    H = U2 - X
    HH = H.square()
    I = HH.scale(4)
    J = H * I
    r = (S2 - Y).scale(2)
    V = X * I
    X3 = r.square() - J - V.scale(2)
    Y3 = r * (V - X3) - (Y * J).scale(2)
    Z3 = ((Z + H).square() - Z2 - HH)
    return X3, Y3, Z3


def miller_loop_fast(p, q) -> Fq12:
    """Projective Miller loop; equal to curve.miller_loop up to factors the
    final exponentiation kills (validated post-final-exp in tests)."""
    if p is None or q is None:
        return Fq12.ONE
    xp, yp = p
    xq, yq = q
    X, Y, Z = xq, yq, Fq2.ONE
    f = Fq12.ONE
    for bit in _X_BITS:
        # tangent line at T (before doubling), evaluated at P
        XX = X.square()
        YY = Y.square()
        ZZ = Z.square()
        a0 = (XX * X).scale(3) - YY.scale(2)
        a1 = (XX * ZZ).scale(-3).scale(xp)
        b1 = (Y * Z * ZZ).scale(2).scale(yp)
        f = f.square() * _sparse_line(a0, a1, b1)
        X, Y, Z = _jac_double_fq2(X, Y, Z)
        if bit == "1":
            # chord through (new) T and Q, evaluated at P
            ZZ = Z.square()
            N = Y - yq * (Z * ZZ)
            D = (X - xq * ZZ) * Z
            a0 = N * xq - D * yq
            a1 = N.scale(-1).scale(xp)
            b1 = D.scale(yp)
            f = f * _sparse_line(a0, a1, b1)
            X, Y, Z = _jac_add_affine_fq2(X, Y, Z, xq, yq)
    if BLS_X_IS_NEG:
        f = f.conj()
    return f


def multi_miller_fast(pairs) -> Fq12:
    f = Fq12.ONE
    for p, q in pairs:
        f = f * miller_loop_fast(p, q)
    return f
