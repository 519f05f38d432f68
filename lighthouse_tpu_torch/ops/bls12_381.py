"""BLS12-381 tower fields and the batched Miller loop: plain PyTorch versions.

Counterpart of ``lighthouse_tpu/ops/bls12_381.py``.  Elements are tensors of
Montgomery words (``ops/bigint.py``) with the tower as trailing axes:

- Fp2  ``[..., 2, 12]``          (a, b) = a + b·u, u² = -1
- Fp6  ``[..., 3, 2, 12]``       (c0, c1, c2) over Fp2, v³ = ξ = 1 + u
- Fp12 ``[..., 2, 3, 2, 12]``    (c0, c1) over Fp6, w² = v

so an Fp12 flattens to its 12 Fp coefficients in the order c0.c0.a,
c0.c0.b, c0.c1.a, ..., c1.c2.b (``fq12_flat``), the layout of
``csrc/bls_host.cc`` and of the CUDA kernels' Fq12 rows ``[N, 12, 12]``.

A product in the tower has one value whatever formula computes it, so the
products here are written for few PyTorch calls (an Fp12 product is one
bilinear map over all 144 coefficient products with one lazy Montgomery
reduction per output coefficient).  What must follow the JAX package
formula for formula is everything whose value depends on the formula: the
Jacobian coordinates of the curve points and the Miller loop's line
scalings (``batch_miller_loop``).  Those are written here step for step as
``lighthouse_tpu/ops/bls12_381.py:348-556`` writes them, so that the
Miller values equal the JAX package's exactly, not only after the final
exponentiation.

``miller_reduce_device`` is the kernel wrapper of ``_miller_reduce_jit``
(``lh_miller`` with Zp = Zq = 1, then one ``lh_fq12_mul_halves`` launch per
tree level; ``csrc/bls12_381.cu``), under ``multi_pairing_device``.  Bound:
Fp products (``bls_cuda.miller_reduce_fp_muls``).

``final_exp_hard_device`` is the kernel wrapper of row 9, the hard part of
the final exponentiation (``lh_final_exp_hard``: the whole x-ladder in one
launch, one thread a lane), with ``final_exp_hard_plain`` beside it: the
Granger-Scott cyclotomic squaring, the Frobenius maps and the x-ladder of
``lighthouse_tpu/ops/bls12_381.py:631-714``.  Bound: Fp products
(``bls_cuda.FINAL_EXP_HARD_LANE`` a lane).
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.bls.fields import BLS_X, Fq2, Fq6, Fq12
from lighthouse_tpu_torch.ops import bigint as bi

# MSB-first bits of |x| after the leading one: the Miller loop's 63 steps
X_BITS = tuple(int(b) for b in bin(BLS_X)[3:])


# --------------------------------------------------------------------------
# Fp2 (componentwise ops are the Fp ops on the stacked pair)
# --------------------------------------------------------------------------

fp2_add = bi.add
fp2_sub = bi.sub
fp2_neg = bi.neg
fp2_scale = bi.scale_small


def fp2_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a + bu)(c + du) = (ac - bd) + (ad + bc)u, as one bilinear map with
    a lazy Montgomery reduction per coefficient (``_tower_mul``)."""
    return _tower_mul(x, y, 0)


def fp2_conj(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 0, :], bi.neg(x[..., 1, :])], -2)


def fp2_is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(-1).all(-1)


def fp2_one_like(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([bi.one_like(x[..., 0, :]), torch.zeros_like(x[..., 1, :])], -2)


class MulQueue:
    """Collects independent products of one dependency round and runs them
    as one stacked call (the JAX package's ``_MulQueue`` idea), so a round
    costs a fixed number of PyTorch calls whatever its width."""

    def __init__(self, mul=fp2_mul):
        self._mul = mul
        self._x: list = []
        self._y: list = []
        self._out = None

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> int:
        self._x.append(x)
        self._y.append(y)
        return len(self._x) - 1

    def run(self) -> "MulQueue":
        pairs = [torch.broadcast_tensors(x, y) for x, y in zip(self._x, self._y)]
        shape = torch.broadcast_shapes(*(x.shape for x, _ in pairs))
        xs = torch.stack([x.expand(shape) for x, _ in pairs])
        ys = torch.stack([y.expand(shape) for _, y in pairs])
        self._out = self._mul(xs, ys)
        return self

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._out[i]


# --------------------------------------------------------------------------
# Fp12 (and Fp6) products as one bilinear map each
# --------------------------------------------------------------------------

_SIZES = {0: 2, 1: 6, 2: 12}      # coefficients of Fp2, Fp6, Fp12


def _basis(n_fp6: int, i: int):
    """The i-th basis element of Fp2 (n_fp6 == 0), Fp6 (1) or Fp12 (2) as a
    host tower element: coefficient index i = (c6·3 + c2)·2 + ab."""
    vals = [0] * _SIZES[n_fp6]
    vals[i] = 1

    def fq6(v):
        return Fq6(Fq2(v[0], v[1]), Fq2(v[2], v[3]), Fq2(v[4], v[5]))

    if n_fp6 == 0:
        return Fq2(vals[0], vals[1])
    return fq6(vals) if n_fp6 == 1 else Fq12(fq6(vals[:6]), fq6(vals[6:]))


def _coeffs(x) -> list[int]:
    if isinstance(x, Fq2):
        out = [x.a, x.b]
    else:
        fq6s = [x] if isinstance(x, Fq6) else [x.c0, x.c1]
        out = [c for f6 in fq6s for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]
    return [c if c < bi.P_INT // 2 else c - bi.P_INT for c in out]


def _bilinear_table(n_fp6: int):
    """Integer tensor coef[k, i, j]: coefficient k of e_i·e_j (small ints)."""
    n = _SIZES[n_fp6]
    coef = np.zeros((n, n, n), np.int64)
    for i in range(n):
        for j in range(n):
            coef[:, i, j] = _coeffs(_basis(n_fp6, i) * _basis(n_fp6, j))
    return coef


_TABLES: dict = {}


def _table(n_fp6: int, device):
    key = (n_fp6, str(device))
    t = _TABLES.get(key)
    if t is None:
        coef = _bilinear_table(n_fp6)
        n = coef.shape[0]
        flat = coef.reshape(n, n * n)
        pos, neg = np.maximum(flat, 0), np.maximum(-flat, 0)
        k_neg = int(neg.sum(1).max())
        # digits of (k_neg·p²) so that pos - neg + offset stays non-negative
        off = np.array([((k_neg * bi.P_INT ** 2) >> (16 * d)) & bi.M16 for d in range(48)],
                       np.int64)
        off[0] += 1                 # the +1 of the two's complement of neg
        idx = np.arange(n * n)
        # the reduced value stays below (k_pos + k_neg)·p², and the
        # reduction's quotient below that over R, plus p
        k_all = int((pos + neg).sum(1).max())
        bound = 2 if k_all * bi.P_INT ** 2 // bi.R_INT + bi.P_INT < 2 * bi.P_INT else 8
        t = dict(pos=torch.tensor(pos, device=device), neg=torch.tensor(neg, device=device),
                 bound=bound,
                 off=torch.tensor(off, device=device),
                 i=torch.tensor(idx // n, device=device), j=torch.tensor(idx % n, device=device))
        _TABLES[key] = t
    return t


def _tower_mul(x: torch.Tensor, y: torch.Tensor, n_fp6: int) -> torch.Tensor:
    """x·y for flat coefficient rows [..., n, 12] (n = 2, 6 or 12): every
    coefficient product as unreduced 16-bit columns, the integer bilinear
    map, then one Montgomery reduction per output coefficient (the value
    stays below 48·p², inside the reduction's 7·p·R bound)."""
    tab = _table(n_fp6, x.device)
    x, y = torch.broadcast_tensors(x, y)
    cols = bi.poly_mul(bi._to16(x)[..., tab["i"], :], bi._to16(y)[..., tab["j"], :])
    pos = (cols.unsqueeze(-3) * tab["pos"][:, :, None]).sum(-2)
    neg = (cols.unsqueeze(-3) * tab["neg"][:, :, None]).sum(-2)
    both, _ = bi._normalize(torch.stack([pos, neg]), 16, 3)
    u, _ = bi._normalize(both[0] + (bi.M16 - both[1]) + tab["off"], 16, 2)
    return bi.redc(u, tab["bound"])


def fq12_flat(f: torch.Tensor) -> torch.Tensor:
    """[..., 2, 3, 2, 12] -> [..., 12, 12] coefficient rows (a view)."""
    return f.reshape(*f.shape[:-4], 12, 12)


def fq12_nested(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(*f.shape[:-2], 2, 3, 2, 12)


def fp12_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return fq12_nested(_tower_mul(fq12_flat(x), fq12_flat(y), 2))


def fp6_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    flat = lambda t: t.reshape(*t.shape[:-3], 6, 12)  # noqa: E731
    return _tower_mul(flat(x), flat(y), 1).reshape(*torch.broadcast_shapes(
        x.shape, y.shape)[:-3], 3, 2, 12)


def fp12_conj(f: torch.Tensor) -> torch.Tensor:
    return torch.stack([f[..., 0, :, :, :], bi.neg(f[..., 1, :, :, :])], -4)


def line_fp12(a0: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The sparse line a0 + a1·v + b1·v·w as a full Fp12 (zeros elsewhere)."""
    z = torch.zeros_like(a0)
    return torch.stack([torch.stack([a0, a1, z], -3), torch.stack([z, b1, z], -3)], -4)


def fp12_sparse_mul(f, a0, a1, b1):
    """f·(a0 + a1·v + b1·v·w), the line product of the Miller loop."""
    return fp12_mul(f, line_fp12(a0, a1, b1))


def fp12_one(batch: tuple, device) -> torch.Tensor:
    f = torch.zeros(*batch, 2, 3, 2, 12, dtype=torch.int64, device=device)
    f[..., 0, 0, 0, :] = bi._const("one", device)
    return f


# --------------------------------------------------------------------------
# Miller loop (formula for formula the JAX batch_miller_loop, zp and zq)
# --------------------------------------------------------------------------

def _fp_times_fp2(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fp scalar s [..., 12] broadcast as the Fp2 (s, 0) for a queued
    product with an Fp2 x: (s·x.a, s·x.b)."""
    return torch.stack([s, torch.zeros_like(s)], -2).expand(x.shape)


def batch_miller_loop_plain(xp, yp, zp, xq, yq, zq, bits=X_BITS) -> torch.Tensor:
    """Miller values of N lanes (int64 words): P Jacobian (xp, yp, zp: Fp
    [N, 12]), Q Jacobian (xq, yq, zq: Fp2 [N, 2, 12]).  Returns Fp12
    [N, 2, 3, 2, 12], conjugated for the negative x.

    Follows ``lighthouse_tpu/ops/bls12_381.py::batch_miller_loop`` with
    both ``zp`` and ``zq`` given, round by round: the tangent and chord
    lines carry the subfield factor Zp³ and the chord the Fq2 factor Zq⁵,
    which the final exponentiation removes.  ``bits`` defaults to the 63
    bits of |x|; tests shorten it."""
    n = xp.shape[0]
    f = fp12_one((n,), xp.device)
    X, Y, Z = xq, yq, zq
    # loop invariants
    q = MulQueue(bi.mont_mul)
    i_zp2, i_xz = q(zp, zp), q(xp, zp)
    q.run()
    zp2, xz = q[i_zp2], q[i_xz]
    zp3 = bi.mont_mul(zp2, zp)
    zxq = fp2_mul(_fp_times_fp2(zp3, xq), xq)
    zyq = fp2_mul(_fp_times_fp2(zp3, yq), yq)
    zq2 = fp2_mul(zq, zq)
    q = MulQueue()
    i_zq3, i_xzq2 = q(zq2, zq), q(_fp_times_fp2(xz, zq2), zq2)
    q.run()
    zq3, xzq2 = q[i_zq3], q[i_xzq2]
    ypq3 = fp2_mul(_fp_times_fp2(yp, zq3), zq3)
    zp3_2 = _fp_times_fp2(zp3, xq)
    xz_2 = _fp_times_fp2(xz, xq)
    yp_2 = _fp_times_fp2(yp, xq)

    for bit in bits:
        q1 = MulQueue()
        r_xx, r_yy, r_zz, r_yz = q1(X, X), q1(Y, Y), q1(Z, Z), q1(Y, Z)
        q1.run()
        fsq = fp12_mul(f, f)
        xx, yy, zz, yz = q1[r_xx], q1[r_yy], q1[r_zz], q1[r_yz]
        Z3 = fp2_scale(yz, 2)
        E = fp2_scale(xx, 3)

        q2 = MulQueue()
        xb = fp2_add(X, yy)
        r = [q2(xx, X), q2(xx, zz), q2(yz, zz), q2(yy, yy), q2(xb, xb), q2(E, E)]
        q2.run()
        xxx, xxzz, yzzz, c4, t, ff = (q2[i] for i in r)
        D = fp2_scale(fp2_sub(fp2_sub(t, xx), c4), 2)
        X3 = fp2_sub(ff, fp2_scale(D, 2))
        a0 = fp2_sub(fp2_scale(xxx, 3), fp2_scale(yy, 2))
        s_a1 = fp2_scale(xxzz, 3)
        s_b1 = fp2_scale(yzzz, 2)

        q3 = MulQueue()
        r = [q3(E, fp2_sub(D, X3)), q3(s_a1, xz_2), q3(s_b1, yp_2), q3(a0, zp3_2)]
        q3.run()
        ey, a1p, b1, a0s = (q3[i] for i in r)
        Y3 = fp2_sub(ey, fp2_scale(c4, 8))
        a1 = fp2_neg(a1p)

        f_dbl = fp12_sparse_mul(fsq, a0s, a1, b1)
        if not bit:
            # the add step's values would be discarded: skip them (the
            # kernel's Miller loop skips them too)
            f, X, Y, Z = f_dbl, X3, Y3, Z3
            continue

        q = MulQueue()
        r = [q(Z3, Z3), q(Z3, zq), q(X3, zq2)]
        q.run()
        zz2, z3zq, u1 = (q[i] for i in r)
        q = MulQueue()
        r = [q(Z3, zz2), q(xq, zz2)]
        q.run()
        zzz, xqzz2 = (q[i] for i in r)
        H = fp2_sub(xqzz2, u1)

        q4 = MulQueue()
        r = [q4(yq, zzz), q4(fp2_neg(H), Z3), q4(Y3, zq3), q4(z3zq, H)]
        q4.run()
        yqzzz, dl, s1, z3ah = (q4[i] for i in r)
        Nl = fp2_sub(s1, yqzzz)

        q5 = MulQueue()
        r = [q5(Nl, zxq), q5(dl, zyq), q5(Nl, xzq2), q5(dl, ypq3), q5(H, H)]
        q5.run()
        nxq, dyq, c1, d1a, hh = (q5[i] for i in r)
        c0a = fp2_sub(nxq, dyq)
        c1a = fp2_neg(c1)
        I4 = fp2_scale(hh, 4)
        r_vec = fp2_scale(fp2_sub(yqzzz, s1), 2)

        f_add = fp12_sparse_mul(f_dbl, c0a, c1a, d1a)
        q6 = MulQueue()
        r = [q6(H, I4), q6(u1, I4), q6(r_vec, r_vec)]
        q6.run()
        j, v, rr = (q6[i] for i in r)
        X3a = fp2_sub(fp2_sub(rr, j), fp2_scale(v, 2))

        q7 = MulQueue()
        r = [q7(r_vec, fp2_sub(v, X3a)), q7(s1, j)]
        q7.run()
        rv, yj = (q7[i] for i in r)
        Y3a = fp2_sub(rv, fp2_scale(yj, 2))
        Z3a = fp2_scale(z3ah, 2)
        f, X, Y, Z = f_add, X3a, Y3a, Z3a
    return fp12_conj(f)


def reduce_product_plain(f: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Product of the lanes' Fp12 values [N, ...] with masked-out lanes
    (mask False) taken as one -> [1, 2, 3, 2, 12]."""
    one = fp12_one((1,), f.device)
    f = torch.where(mask.reshape(-1, 1, 1, 1, 1), f, one)
    while f.shape[0] > 1:
        if f.shape[0] % 2:
            f = torch.cat([f, one])
        half = f.shape[0] // 2
        f = fp12_mul(f[:half], f[half:])
    return f


# --------------------------------------------------------------------------
# host boundary
# --------------------------------------------------------------------------

def fq12_to_words(f: Fq12) -> np.ndarray:
    """Python Fq12 -> Montgomery words uint32[12, 12] (coefficient rows)."""
    coeffs = [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]
    return bi.ints_to_mont_limbs(coeffs)


def fq12_from_words(words) -> Fq12:
    """Montgomery words [12, 12] (or [1, 12, 12], or nested) -> Python Fq12."""
    v = bi.mont_limbs_to_ints(np.asarray(words, np.uint32).reshape(12, 12))

    def fq6(k):
        return Fq6(Fq2(v[k], v[k + 1]), Fq2(v[k + 2], v[k + 3]), Fq2(v[k + 4], v[k + 5]))

    return Fq12(fq6(0), fq6(6))


# --------------------------------------------------------------------------
# row 10: Miller loops over affine pairs and their masked product
# --------------------------------------------------------------------------

def points_to_device(pairs):
    """[(G1 affine ints, G2 affine Fq2)] -> (xp, yp uint32 [n, 12], xq, yq
    uint32 [n, 2, 12] Montgomery words, mask bool [n]).  A pair with an
    infinity side is replaced by the generators and masked out: its Miller
    value is one (``bls12_381.points_to_device`` of the JAX package)."""
    from lighthouse_tpu_torch.crypto.bls import curve as cv

    n = len(pairs)
    mask = np.ones(n, bool)
    ps, qs = [], []
    for i, (p, q) in enumerate(pairs):
        if p is cv.INF or q is cv.INF:
            mask[i] = False
            p, q = cv.g1_generator(), cv.g2_generator()
        ps.append(p)
        qs.append(q)
    xp = bi.ints_to_mont_limbs([p[0] for p in ps])
    yp = bi.ints_to_mont_limbs([p[1] for p in ps])
    q = bi.ints_to_mont_limbs([c for p in qs for c in (p[0].a, p[0].b, p[1].a, p[1].b)])
    q = q.reshape(n, 2, 2, bi.L)
    return xp, yp, np.ascontiguousarray(q[:, 0]), np.ascontiguousarray(q[:, 1]), mask


def miller_reduce_plain(xp, yp, xq, yq, mask) -> torch.Tensor:
    """Plain version of ``miller_reduce_device`` (int32 words in, Fq12 row
    [1, 12, 12] out)."""
    xp, yp, xq, yq = (bi.u64(t) for t in (xp, yp, xq, yq))
    f = batch_miller_loop_plain(xp, yp, bi.one_like(xp), xq, yq, fp2_one_like(xq))
    return bi.i32(fq12_flat(reduce_product_plain(f, mask.bool())))


def miller_reduce_device(xp, yp, xq, yq, mask) -> torch.Tensor:
    """Π over lanes of miller(P_i, Q_i), masked lanes one: affine P (int32
    [n, 12]) and Q (int32 [n, 2, 12]) Montgomery words, mask bool [n], n a
    power of two -> Fq12 row [1, 12, 12].  One Miller launch (Zp = Zq = 1)
    and one product launch per tree level.  Replaces
    ``lighthouse_tpu/ops/bls12_381.py:779`` ``_miller_reduce_jit``."""
    from lighthouse_tpu_torch.ops import bls_cuda

    for name, t, tail in (("xp", xp, (bi.L,)), ("yp", yp, (bi.L,)),
                          ("xq", xq, (2, bi.L)), ("yq", yq, (2, bi.L))):
        bls_cuda.check(t, tail, f"miller_reduce {name}")
    dev = bls_cuda.same_device("miller_reduce", xp, yp, xq, yq, mask)
    n = xp.shape[0]
    if n & (n - 1) or mask.shape != (n,) or any(t.shape[0] != n for t in (yp, xq, yq)):
        raise ValueError(f"miller_reduce: {n} lanes (a power of two) and mask "
                         f"{list(mask.shape)} do not agree")
    if dev.type == "cpu":
        return miller_reduce_plain(xp, yp, xq, yq, mask)
    one_p = bi.one_like(xp)
    one_q = fp2_one_like(xq).contiguous()
    f = torch.empty((n, 12, bi.L), dtype=torch.int32, device=dev)
    bls_cuda.launch("lh_miller", xp, yp, one_p, xq, yq, one_q, mask.to(torch.uint8).contiguous(),
                    f, n, n, -1)
    launches = 1
    half = n // 2
    while half >= 1:
        bls_cuda.launch("lh_fq12_mul_halves", f, half)
        launches += 1
        half //= 2
    miller_reduce_device.launches += launches
    return f[:1].clone()


miller_reduce_device.launches = 0


def multi_pairing_device(pairs, device=None):
    """Multi-pairing Π e(P_i, Q_i) as a python Fq12 after the final
    exponentiation (compare with ``.is_one()``): the Miller loops and their
    product on ``device`` (row 10, lanes padded to a power of two, at least
    4, the padding masked), the final exponentiation on the host
    (``csrc/bls_host.cc``)."""
    from lighthouse_tpu_torch.device import resolve_device
    from lighthouse_tpu_torch.ops import native_bls

    dev = resolve_device(device)
    xp, yp, xq, yq, mask = points_to_device(pairs)
    n = len(pairs)
    padded = max(4, 1 << max(n - 1, 0).bit_length())
    if padded != n:
        xp, yp, xq, yq = (np.concatenate([c, np.repeat(c[-1:], padded - n, 0)])
                          for c in (xp, yp, xq, yq))
        mask = np.concatenate([mask, np.zeros(padded - n, bool)])
    f = miller_reduce_device(*(bi.to_tensor(c, dev) for c in (xp, yp, xq, yq)),
                             torch.from_numpy(mask).to(dev))
    return native_bls.final_exp(fq12_from_words(bi.to_numpy(f)))


# --------------------------------------------------------------------------
# row 9: the hard part of the final exponentiation
# --------------------------------------------------------------------------

def _fp2_mul_xi(x: torch.Tensor) -> torch.Tensor:
    """x·ξ with ξ = 1 + u: (a - b) + (a + b)u."""
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([bi.sub(a, b), bi.add(a, b)], -2)


_GAMMAS: dict = {}


def _frobenius_twists(device) -> torch.Tensor:
    """The Frobenius twist of each Fp12 coefficient [2, 3, 2, 12]: one for
    c0.c0, then γ2, γ4 (c0.c1, c0.c2) and γ1, γ3, γ5 (c1), with
    γ_k = ξ^(k(p-1)/6) (``fields._frob_gamma``)."""
    key = str(device)
    t = _GAMMAS.get(key)
    if t is None:
        from lighthouse_tpu_torch.crypto.bls.fields import _frob_gamma

        g = _frob_gamma()
        order = (0, 2, 4, 1, 3, 5)          # g[0] = ξ^0 = 1
        words = bi.ints_to_mont_limbs([c for k in order for c in (g[k].a, g[k].b)])
        t = bi.u64(bi.to_tensor(words, device)).reshape(2, 3, 2, bi.L)
        _GAMMAS[key] = t
    return t


def fp12_frobenius(f: torch.Tensor, n: int = 1) -> torch.Tensor:
    """f^(p^n): n rounds of coefficient conjugation and the γ twists
    (``fields.frobenius``; JAX ``fp12_frobenius``, ops/bls12_381.py:631)."""
    g = _frobenius_twists(f.device)
    for _ in range(n):
        f = fp2_mul(fp2_conj(f), g)
    return f


def fp12_cyclotomic_sqr(x: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring (JAX ``fp12_cyclotomic_sqr``,
    ops/bls12_381.py:649): right only for cyclotomic-subgroup elements.
    Coefficients x = (g0, g1, g2) + (g3, g4, g5)·w; the nine Fp2 squares
    run as one stacked product."""
    g0, g1, g2 = x[..., 0, 0, :, :], x[..., 0, 1, :, :], x[..., 0, 2, :, :]
    g3, g4, g5 = x[..., 1, 0, :, :], x[..., 1, 1, :, :], x[..., 1, 2, :, :]
    s = torch.stack([g4, g0, fp2_add(g4, g0), g2, g3, fp2_add(g2, g3),
                     g5, g1, fp2_add(g5, g1)])
    t0, t1, s04, t2, t3, s23, t4, t5, s51 = fp2_mul(s, s)
    t6 = fp2_sub(fp2_sub(s04, t0), t1)                      # 2 g0 g4
    t7 = fp2_sub(fp2_sub(s23, t2), t3)                      # 2 g2 g3
    t8 = _fp2_mul_xi(fp2_sub(fp2_sub(s51, t4), t5))        # 2 g1 g5 ξ
    a0 = fp2_add(_fp2_mul_xi(t0), t1)
    a2 = fp2_add(_fp2_mul_xi(t2), t3)
    a4 = fp2_add(_fp2_mul_xi(t4), t5)

    def out(a, g, op):
        return fp2_add(fp2_scale(op(a, g), 2), a)

    z = [out(a0, g0, fp2_sub), out(a2, g1, fp2_sub), out(a4, g2, fp2_sub),
         out(t8, g3, fp2_add), out(t6, g4, fp2_add), out(t7, g5, fp2_add)]
    return torch.stack([torch.stack(z[:3], -3), torch.stack(z[3:], -3)], -4)


def cyc_exp_x(f: torch.Tensor) -> torch.Tensor:
    """f^x for the negative curve parameter x, f cyclotomic (JAX
    ``_cyc_exp_x``, ops/bls12_381.py:687): a cyclotomic square per bit of
    |x| after the top one and a product on the set bits, then the
    conjugation for the sign.  The JAX program multiplies on every bit and
    selects; branching on the public constant gives the same values."""
    out = f
    for bit in X_BITS:
        out = fp12_cyclotomic_sqr(out)
        if bit:
            out = fp12_mul(out, f)
    return fp12_conj(out)


def final_exp_hard_nested(m: torch.Tensor) -> torch.Tensor:
    """(m^((p^4 - p^2 + 1)/r))^3 of cyclotomic m [..., 2, 3, 2, 12] (int64
    words), the composition of JAX ``final_exp_hard_device``
    (ops/bls12_381.py:702) and of the host oracle ``fields.final_exp_hard``."""
    t1 = cyc_exp_x(m)                                                    # m^x
    g3 = fp12_mul(fp12_mul(cyc_exp_x(t1), fp12_conj(fp12_cyclotomic_sqr(t1))), m)
    g2 = cyc_exp_x(g3)
    g1 = fp12_mul(cyc_exp_x(g2), fp12_conj(g3))
    g0 = fp12_mul(fp12_mul(cyc_exp_x(g1), fp12_cyclotomic_sqr(m)), m)
    out = fp12_mul(g0, fp12_frobenius(g1, 1))
    out = fp12_mul(out, fp12_frobenius(g2, 2))
    return fp12_mul(out, fp12_frobenius(g3, 3))


def final_exp_hard_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain version of ``final_exp_hard_device``: int32 Fq12 rows
    [N, 12, 12] in and out."""
    return bi.i32(fq12_flat(final_exp_hard_nested(fq12_nested(bi.u64(m)))))


def final_exp_hard_device(m: torch.Tensor) -> torch.Tensor:
    """Row 9: the hard part of the final exponentiation of N cyclotomic
    Fq12 lanes, int32 Montgomery rows [N, 12, 12] -> [N, 12, 12].  One
    ``lh_final_exp_hard`` launch (the whole ladder, one thread a lane).
    Replaces ``lighthouse_tpu/ops/bls_backend.py:395`` ``_final_exp_hard_jit``
    over ``ops/bls12_381.py:702`` ``final_exp_hard_device``.  A lane outside
    the cyclotomic subgroup gives a meaningless value, as in the JAX
    package: callers pass ``fields.final_exp_easy`` of their product."""
    from lighthouse_tpu_torch.ops import bls_cuda

    bls_cuda.check(m, (12, bi.L), "final_exp_hard m")
    if m.dim() != 3:
        raise ValueError(f"final_exp_hard: expected rows [N, 12, 12], got {list(m.shape)}")
    if m.device.type == "cpu":
        return final_exp_hard_plain(m)
    out = torch.empty_like(m)
    bls_cuda.launch("lh_final_exp_hard", m, out, m.shape[0])
    final_exp_hard_device.launches += 1
    return out


final_exp_hard_device.launches = 0
