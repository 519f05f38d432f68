"""Batched G1/G2 curve arithmetic: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/ops/ec.py``.  Points are Jacobian
``(X, Y, Z)`` tuples of Montgomery-word tensors: G1 coordinates are Fp
``[N, 12]``, G2 coordinates Fp2 ``[N, 2, 12]`` (int64 words here; int32 at
the kernel wrappers).  Infinity is ``Z == 0``; in the port every value is
fully reduced, so that is a plain word compare.

Every formula is the JAX package's, operation for operation, so that the
Jacobian coordinates (not only the points) equal it: the a = 0 doubling of
``_jac_double_multi``, the full addition ``_jac_add_full`` (incomplete at
H == 0: the callers' blinding keeps that chord out of reach, and this port
keeps the contract rather than completing the add), the window tables of
``_window_tables`` (entry e = 2·entry(e/2) for even e, entry(e-1) + base
for odd e), the double-and-add step ``_dbl_add_step`` of the ψ subgroup
check, and the lo/hi tree order of the segment and G2 sums.  The CUDA
kernels (``csrc/bls12_381.cu``) follow the same sequences.
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import BLS_X
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops.bls12_381 import MulQueue, fp2_conj, fp2_is_zero, fp2_mul, fp2_one_like


class _G1:
    """Field adapter over Fp lanes [N, 12]."""
    mul = staticmethod(bi.mont_mul)
    add = staticmethod(bi.add)
    sub = staticmethod(bi.sub)
    scale = staticmethod(bi.scale_small)
    is_zero = staticmethod(bi.is_zero)
    one_like = staticmethod(bi.one_like)
    ndim = 1


class _G2:
    """Field adapter over Fp2 lanes [N, 2, 12]."""
    mul = staticmethod(fp2_mul)
    add = staticmethod(bi.add)
    sub = staticmethod(bi.sub)
    scale = staticmethod(bi.scale_small)
    is_zero = staticmethod(fp2_is_zero)
    one_like = staticmethod(fp2_one_like)
    ndim = 2


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor, F) -> torch.Tensor:
    return torch.where(cond.reshape(cond.shape + (1,) * F.ndim), a, b)


def jac_double(F, p):
    """a = 0 Jacobian doubling (``ec._jac_double_multi``).  Z == 0 lanes
    stay at Z == 0."""
    X, Y, Z = p
    q = MulQueue(F.mul)
    r_xx, r_yy, r_yz = q(X, X), q(Y, Y), q(Y, Z)
    q.run()
    xx, yy, yz = q[r_xx], q[r_yy], q[r_yz]
    E = F.scale(xx, 3)
    Z3 = F.scale(yz, 2)
    xb = F.add(X, yy)
    q = MulQueue(F.mul)
    r_c4, r_t, r_ff = q(yy, yy), q(xb, xb), q(E, E)
    q.run()
    c4, t, ff = q[r_c4], q[r_t], q[r_ff]
    D = F.scale(F.sub(F.sub(t, xx), c4), 2)
    X3 = F.sub(ff, F.scale(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.scale(c4, 8))
    return X3, Y3, Z3


def jac_add_full(F, p, q2, infs=None):
    """Full Jacobian addition (``ec._jac_add_full``), complete when either
    side is infinity; incomplete at H == 0.  ``infs`` optionally replaces
    the Z == 0 probes with explicit (p_inf, q_inf) flags, as the windowed
    scan passes them."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q2
    q = MulQueue(F.mul)
    r_z11, r_z22 = q(Z1, Z1), q(Z2, Z2)
    q.run()
    z11, z22 = q[r_z11], q[r_z22]
    zs = F.add(Z1, Z2)
    q = MulQueue(F.mul)
    r = [q(X1, z22), q(X2, z11), q(Z1, z11), q(Z2, z22), q(zs, zs)]
    q.run()
    u1, u2, z1c, z2c, zz12 = (q[i] for i in r)
    h = F.sub(u2, u1)
    q = MulQueue(F.mul)
    r = [q(Y1, z2c), q(Y2, z1c), q(h, h)]
    q.run()
    s1, s2, hh = (q[i] for i in r)
    rv = F.scale(F.sub(s2, s1), 2)
    i4 = F.scale(hh, 4)
    zmul = F.sub(F.sub(zz12, z11), z22)
    q = MulQueue(F.mul)
    r = [q(h, i4), q(u1, i4), q(rv, rv), q(zmul, h)]
    q.run()
    j, v, rr, Z3 = (q[i] for i in r)
    X3 = F.sub(F.sub(rr, j), F.scale(v, 2))
    q = MulQueue(F.mul)
    r = [q(rv, F.sub(v, X3)), q(s1, j)]
    q.run()
    Y3 = F.sub(q[r[0]], F.scale(q[r[1]], 2))
    p_inf, q_inf = infs if infs is not None else (F.is_zero(Z1), F.is_zero(Z2))
    out = []
    for c1, c2, c3 in ((X1, X2, X3), (Y1, Y2, Y3), (Z1, Z2, Z3)):
        out.append(_select(p_inf, c2, _select(q_inf, c1, c3, F), F))
    return tuple(out)


def window_table(F, xb, yb, width: int = 4) -> list:
    """Jacobian multiples [0·B, 1·B, ..., (2^w - 1)·B] per lane, built as
    ``ec._window_tables`` builds them: 0·B is all zeros, 1·B is (x, y, 1),
    an even entry e doubles entry e/2, an odd one adds B to entry e - 1."""
    zero = torch.zeros_like(xb)
    base = (xb, yb, F.one_like(xb))
    tab = [(zero, zero.clone(), zero.clone()), base]
    for e in range(2, 1 << width):
        tab.append(jac_double(F, tab[e // 2]) if e % 2 == 0 else jac_add_full(F, tab[e - 1], base))
    return tab


def _table_pick(F, tab, digit: torch.Tensor):
    stacked = [torch.stack([t[c] for t in tab]) for c in range(3)]
    idx = digit.reshape((1, -1) + (1,) * F.ndim).expand((1,) + stacked[0].shape[1:])
    return tuple(s.gather(0, idx)[0] for s in stacked)


def scalar_mul_windowed(F, xb, yb, digits: torch.Tensor):
    """Σ-free windowed scalar mul of one track (``ec.gj_scalar_mul_windowed``
    is two of these sharing ``digits``): per digit (MSB first) four
    doublings, then a full add of the table entry with explicit infinity
    flags.  Lanes whose scalar is zero come back as exact zeros."""
    tab = window_table(F, xb, yb)
    zero = torch.zeros_like(xb)
    acc = (zero, zero, zero)
    inf = torch.ones(digits.shape[1:], dtype=torch.bool, device=xb.device)
    for d in range(digits.shape[0]):
        digit = digits[d]
        for _ in range(4):
            acc = jac_double(F, acc)
        pick = _table_pick(F, tab, digit)
        pick_inf = digit == 0
        acc = jac_add_full(F, acc, pick, infs=(inf, pick_inf))
        inf = inf & pick_inf
    return tuple(_select(inf, zero, c, F) for c in acc)


def g1_scalar_mul_windowed(xp, yp, digits):
    """r_i·P_i over affine G1 lanes (Fp [N, 12]) and MSB-first window
    digits [n_digits, N] of any width (``ec.g1_scalar_mul_windowed``; the
    KZG MSMs use 64 digits of 256-bit scalars).  Zero scalars give exact
    zeros."""
    return scalar_mul_windowed(_G1, xp, yp, digits)


def gj_scalar_mul_windowed(xp, yp, xq, yq, digits):
    """r_i·P_i (G1) and r_i·Q_i (G2) over the same window digits
    [16, N] (MSB first): ``ec.gj_scalar_mul_windowed``.  The G1 lanes run
    embedded in Fp2 as (x, 0) beside the G2 lanes, one track of 2N lanes:
    every Fp2 operation on a zero imaginary part is the Fp operation, so
    the coordinates are the G1 formulas' exactly."""
    n = xp.shape[0]
    emb = lambda a: torch.stack([a, torch.zeros_like(a)], -2)  # noqa: E731
    X, Y, Z = scalar_mul_windowed(_G2, torch.cat([emb(xp), xq]), torch.cat([emb(yp), yq]),
                                  torch.cat([digits, digits], 1))
    return ((X[:n, 0], Y[:n, 0], Z[:n, 0]), (X[n:], Y[n:], Z[n:]))


def _sum_halves(F, p, n_segments: int):
    """s-major tree sum: [S·G] lanes (lane s·G + g) -> G lanes, pairing the
    lo and hi halves at each level (``ec._sum_reduce``)."""
    X, Y, Z = p
    while X.shape[0] > n_segments:
        half = X.shape[0] // 2
        X, Y, Z = jac_add_full(F, (X[:half], Y[:half], Z[:half]), (X[half:], Y[half:], Z[half:]))
    return X, Y, Z


def g1_segment_sum(X, Y, Z, n_segments: int):
    total = X.shape[0]
    assert total % n_segments == 0
    s = total // n_segments
    assert s & (s - 1) == 0, "segment size must be a power of two"
    return _sum_halves(_G1, (X, Y, Z), n_segments)


def g2_sum_reduce(X, Y, Z):
    n = X.shape[0]
    assert n & (n - 1) == 0, "lane count must be a power of two"
    return _sum_halves(_G2, (X, Y, Z), 1)


# --------------------------------------------------------------------------
# ψ subgroup verdict (ec.g2_subgroup_verdict_batch)
# --------------------------------------------------------------------------

X_BITS64 = tuple(int(b) for b in bin(BLS_X)[2:])    # |x|, MSB first, 64 bits


def dbl_add_step(F, X, Y, Z, inf, xb, yb, bit: int):
    """One double-and-add step (``ec._dbl_add_step``): 2T, then the mixed
    add of the affine base, selected by ``bit``; ``inf`` is the explicit
    per-lane infinity flag of T."""
    q = MulQueue(F.mul)
    r = [q(X, X), q(Y, Y), q(Y, Z)]
    q.run()
    xx, yy, yz = (q[i] for i in r)
    E = F.scale(xx, 3)
    Z3 = F.scale(yz, 2)
    q = MulQueue(F.mul)
    xb_ = F.add(X, yy)
    r = [q(yy, yy), q(xb_, xb_), q(E, E), q(Z3, Z3)]
    q.run()
    c4, t, ff, zz = (q[i] for i in r)
    D = F.scale(F.sub(F.sub(t, xx), c4), 2)
    X3 = F.sub(ff, F.scale(D, 2))
    q = MulQueue(F.mul)
    r = [q(E, F.sub(D, X3)), q(xb, zz), q(Z3, zz)]
    q.run()
    ey, u2, zzz = (q[i] for i in r)
    Y3 = F.sub(ey, F.scale(c4, 8))
    H = F.sub(u2, X3)
    q = MulQueue(F.mul)
    r = [q(yb, zzz), q(H, H)]
    q.run()
    s2, hh = (q[i] for i in r)
    rv = F.scale(F.sub(s2, Y3), 2)
    zph = F.add(Z3, H)
    q = MulQueue(F.mul)
    r = [q(rv, rv), q(H, hh), q(X3, hh), q(zph, zph)]
    q.run()
    rr, j, v, zph2 = (q[i] for i in r)
    J = F.scale(j, 4)
    V = F.scale(v, 4)
    X3a = F.sub(F.sub(rr, J), F.scale(V, 2))
    q = MulQueue(F.mul)
    r = [q(rv, F.sub(V, X3a)), q(Y3, j)]
    q.run()
    Y3a = F.sub(q[r[0]], F.scale(q[r[1]], 8))
    Z3a = F.sub(F.sub(zph2, zz), hh)
    Xa = _select(inf, xb, X3a, F)
    Ya = _select(inf, yb, Y3a, F)
    Za = _select(inf, F.one_like(Z3), Z3a, F)
    if bit:
        return Xa, Ya, Za, torch.zeros_like(inf)
    return X3, Y3, Z3, inf


def _psi_consts(device):
    return (fq2_words(cv.PSI_CX, device), fq2_words(cv.PSI_CY, device))


def fq2_words(v, device) -> torch.Tensor:
    """Host Fq2 -> Montgomery words [2, 12] (int64 lanes)."""
    return bi.u64(bi.to_tensor(bi.ints_to_mont_limbs([v.a, v.b]), device))


def g2_subgroup_verdict_plain(xq: torch.Tensor, yq: torch.Tensor, bits=X_BITS64) -> torch.Tensor:
    """ψ(Q) == [x]Q per lane for affine G2 lanes (Fp2 [N, 2, 12], int64
    words) -> bool[N].  S = [|x|]Q by the double-and-add steps; the lane is
    in G2 iff x_ψ·Z² == X_S, y_ψ·Z³ == -Y_S and Z ≠ 0.  A small-order
    point that meets the H == 0 chord drives Z to zero and is rejected
    (fail closed, as ``ec.g2_subgroup_check_batch``)."""
    F = _G2
    zero = torch.zeros_like(xq)
    X, Y, Z = zero, zero, zero
    inf = torch.ones(xq.shape[0], dtype=torch.bool, device=xq.device)
    for bit in bits:
        X, Y, Z, inf = dbl_add_step(F, X, Y, Z, inf, xq, yq, bit)
    X, Y, Z = (_select(inf, zero, c, F) for c in (X, Y, Z))
    cx, cy = _psi_consts(xq.device)
    q = MulQueue()
    r = [q(fp2_conj(xq), cx), q(fp2_conj(yq), cy), q(Z, Z)]
    q.run()
    px, py, z2 = (q[i] for i in r)
    q = MulQueue()
    r = [q(px, z2), q(z2, Z)]
    q.run()
    xz, z3 = q[r[0]], q[r[1]]
    yz = fp2_mul(py, z3)
    d1 = bi.sub(xz, X)
    d2 = bi.add(yz, Y)
    return fp2_is_zero(d1) & fp2_is_zero(d2) & ~fp2_is_zero(Z)


# --------------------------------------------------------------------------
# G1 membership verdict (ec.g1_subgroup_verdict_batch)
# --------------------------------------------------------------------------

R_MINUS_1_BITS = tuple(int(b) for b in bin(cv.R - 1)[2:])     # 255 bits, MSB first


def g1_subgroup_verdict_plain(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """[r-1]P == -P per lane for affine G1 lanes (Fp [N, 12], int64 words)
    -> bool[N].  S = [r-1]P by the double-and-add steps over r - 1's bits
    (``ec._scalar_mul_batch``); the lane is in G1 iff x·Z² == X_S,
    y·Z³ == -Y_S and Z ≠ 0.  For a point of order d outside G1, r - 1 ≡ -1
    (mod d) would force d | r.  A small-order point that meets the H == 0
    chord drives Z to zero and is rejected (fail closed, as
    ``ec.g1_subgroup_check_batch``)."""
    F = _G1
    zero = torch.zeros_like(xp)
    X, Y, Z = zero, zero, zero
    inf = torch.ones(xp.shape[0], dtype=torch.bool, device=xp.device)
    for bit in R_MINUS_1_BITS:
        X, Y, Z, inf = dbl_add_step(F, X, Y, Z, inf, xp, yp, bit)
    X, Y, Z = (_select(inf, zero, c, F) for c in (X, Y, Z))
    z2 = bi.mont_mul(Z, Z)
    q = MulQueue(bi.mont_mul)
    r = [q(xp, z2), q(z2, Z)]
    q.run()
    xz, z3 = q[r[0]], q[r[1]]
    yz = bi.mont_mul(yp, z3)
    d1 = bi.sub(xz, X)
    d2 = bi.add(yz, Y)
    return bi.is_zero(d1) & bi.is_zero(d2) & ~bi.is_zero(Z)


# --------------------------------------------------------------------------
# inversion and affine conversion
# --------------------------------------------------------------------------

P_MINUS_2_BITS = tuple(int(b) for b in bin(bi.P_INT - 2)[2:])


def fq_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) (Montgomery domain) by square-and-multiply; 0 -> 0."""
    out = bi.one_like(a)
    for bit in P_MINUS_2_BITS:
        out = bi.mont_mul(out, out)
        if bit:
            out = bi.mont_mul(out, a)
    return out


def g1_jacobian_to_affine(X, Y, Z):
    """(X/Z², Y/Z³) per lane; Z == 0 lanes give (0, 0)."""
    zi = fq_inv_plain(Z)
    zi2 = bi.mont_mul(zi, zi)
    q = MulQueue(bi.mont_mul)
    r = [q(X, zi2), q(zi2, zi)]
    q.run()
    return q[r[0]], bi.mont_mul(Y, q[r[1]])


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------

def scalars_to_digits(scalars, n_bits: int = 64, w: int = 4) -> np.ndarray:
    """Scalars -> uint32[n_bits // w, n] MSB-first base-2^w window digits
    (copy of ``ec.scalars_to_digits``)."""
    n = len(scalars)
    n_dig = n_bits // w
    if n == 0:
        return np.zeros((n_dig, 0), np.uint32)
    n_bytes = (n_bits + 7) // 8
    buf = b"".join(int(s).to_bytes(n_bytes, "big") for s in scalars)
    byts = np.frombuffer(buf, np.uint8).reshape(n, n_bytes)
    bits = np.unpackbits(byts, axis=1, bitorder="big")[:, -n_bits:]
    weights = 1 << np.arange(w - 1, -1, -1, dtype=np.uint32)
    digs = (bits.reshape(n, n_dig, w).astype(np.uint32) * weights).sum(axis=2, dtype=np.uint32)
    return np.ascontiguousarray(digs.T)


def g1_words(points, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine G1 int points -> (x, y) Montgomery word tensors [N, 12] (int32)."""
    return (bi.to_tensor(bi.ints_to_mont_limbs([p[0] for p in points]), device),
            bi.to_tensor(bi.ints_to_mont_limbs([p[1] for p in points]), device))


def g2_words(points, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine G2 points -> (x, y) Montgomery word tensors [N, 2, 12] (int32)."""
    n = len(points)
    cols = bi.ints_to_mont_limbs([c for p in points for c in (p[0].a, p[0].b, p[1].a, p[1].b)])
    cols = cols.reshape(n, 2, 2, bi.L)
    return bi.to_tensor(cols[:, 0], device), bi.to_tensor(cols[:, 1], device)
