"""The MSM plane: the pow2 bucket policy, the joint G1×G2 track of the fused
verify pipeline, the blinded pubkey fold, the plain G1 track of KZG and the
host lincomb seam.

Counterpart of ``lighthouse_tpu/ops/msm.py`` (``bucket`` :73,
``fold_segments_g1`` :89, ``fold_segments_gj`` :98, ``_fold_kernel`` :115,
``_blinded_fold`` :143, ``fold_device`` :166, ``blinded_fold_device`` :183,
``jacobian_rows_to_affine`` :191, ``host_lincomb_groups`` :210, ``msm_g1``
:273).  The calibration of the routing threshold and the gather track stay
out: ``msm_g1`` routes by the JAX package's static lane count
(``_STATIC_DEVICE_MIN``).

``fold_device`` is the kernel wrapper of row 13 (``lh_g1_scalar_mul`` then
``lh_g1_add_halves``, ``csrc/bls12_381.cu``): one thread per lane runs the
256-bit windowed scalar mul (64 digits), then one tree launch per level
sums the s-major segments.  Bound: Fp products
(``bls_cuda.g1_fold_fp_muls``).

``blinded_fold_device`` is the kernel wrapper of ``lh_blinded_fold``
(``csrc/bls12_381.cu``): for CUDA tensors it runs one tree launch per level
(rows i and i + half combined in place) and one final launch per segment
(add the known blinding total, Fermat inversion, affine, infinity flag);
for CPU tensors it runs ``blinded_fold_plain``.  Bound: integer multiply-
adds, 16 Fp products per tree node that joins two finite points (a node
with an infinity side costs none) and 614 per segment's inversion and
affine conversion (``bls_cuda.blinded_fold_fp_muls``).
"""

from __future__ import annotations

import torch

import numpy as np

from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import R as _R
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda, ec, native_bls

# lane count at or above which msm_g1 routes to the card (the JAX package's
# static default; its startup calibration is not ported)
_STATIC_DEVICE_MIN = 256


def bucket(n: int, floor: int = 1) -> int:
    """Next power of two of ``n``, at least ``floor`` (padding lanes carry
    zero scalars or infinity, the group identity)."""
    return max(int(floor), 1, 1 << max(int(n) - 1, 0).bit_length())


def fold_segments_gj(xp, yp, xq, yq, digits, n_segments: int):
    """Plain joint track: windowed scalar mul over G1 lanes (xp, yp) and G2
    lanes (xq, yq) sharing ``digits``, the s-major G1 segment fold
    (n_segments > 0; 0 keeps the lanes) and the G2 tree sum."""
    (Xp, Yp, Zp), (SX, SY, SZ) = ec.gj_scalar_mul_windowed(xp, yp, xq, yq, digits)
    if n_segments:
        Xp, Yp, Zp = ec.g1_segment_sum(Xp, Yp, Zp, n_segments)
    return (Xp, Yp, Zp), ec.g2_sum_reduce(SX, SY, SZ)


def blinded_fold_plain(X, Y, Z, ux, uy, n_segments: int):
    """Plain version of ``lh_blinded_fold``: int32 Jacobian rows [S·G, 12]
    (s-major, lane s·G + g) -> per segment the affine sum minus the
    blinding total, (xa, ya) int32 [G, 12] and the infinity flags bool[G]."""
    Xg, Yg, Zg = ec.g1_segment_sum(bi.u64(X), bi.u64(Y), bi.u64(Z), n_segments)
    u = (bi.u64(ux).expand(Xg.shape), bi.u64(uy).expand(Yg.shape), bi.one_like(Xg))
    Xr, Yr, Zr = ec.jac_add_full(ec._G1, (Xg, Yg, Zg), u)
    xa, ya = ec.g1_jacobian_to_affine(Xr, Yr, Zr)
    return bi.i32(xa), bi.i32(ya), bi.is_zero(Zr)


def blinded_fold_device(X, Y, Z, ux, uy, n_segments: int):
    """Segmented G1 sum of (pubkey + blinding) Jacobian lanes, plus the
    negated blinding total (ux, uy), in affine form with an infinity flag
    per segment.  Replaces ``lighthouse_tpu/ops/msm.py:143`` ``_blinded_fold``."""
    for name, t in (("X", X), ("Y", Y), ("Z", Z)):
        bls_cuda.check(t, (bi.L,), f"blinded_fold {name}")
    for name, t in (("ux", ux), ("uy", uy)):
        bls_cuda.check(t, (1, bi.L), f"blinded_fold {name}")
    dev = bls_cuda.same_device("blinded_fold", X, Y, Z, ux, uy)
    total = X.shape[0]
    if Y.shape[0] != total or Z.shape[0] != total or total % n_segments:
        raise ValueError(f"blinded_fold: {total} lanes do not split into {n_segments} segments")
    seg = total // n_segments
    if seg & (seg - 1):
        raise ValueError(f"blinded_fold: segment size {seg} is not a power of two")
    if dev.type == "cpu":
        return blinded_fold_plain(X, Y, Z, ux, uy, n_segments)
    X, Y, Z = X.clone(), Y.clone(), Z.clone()      # the tree works in place
    half = total // 2
    while half >= n_segments:
        bls_cuda.launch("lh_g1_add_halves", X, Y, Z, half)
        blinded_fold_device.launches += 1
        half //= 2
    xa = torch.empty((n_segments, bi.L), dtype=torch.int32, device=dev)
    ya = torch.empty_like(xa)
    inf = torch.empty(n_segments, dtype=torch.uint8, device=dev)
    bls_cuda.launch("lh_blinded_final", X, Y, Z, ux, uy, xa, ya, inf, n_segments)
    blinded_fold_device.launches += 1
    return xa, ya, inf.bool()


blinded_fold_device.launches = 0


# --------------------------------------------------------------------------
# the plain G1 track (row 13)
# --------------------------------------------------------------------------

def fold_segments_g1(xs, ys, digits, n_segments: int):
    """Plain G1 track over int64 words: windowed scalar mul of affine lanes,
    then the s-major segment sum -> Jacobian rows [n_segments, 12]."""
    X, Y, Z = ec.g1_scalar_mul_windowed(xs, ys, digits)
    return ec.g1_segment_sum(X, Y, Z, n_segments)


def fold_plain(xs, ys, digits, n_segments: int):
    """Plain version of ``fold_device`` (int32 words in and out)."""
    X, Y, Z = fold_segments_g1(bi.u64(xs), bi.u64(ys), digits.to(torch.int64), n_segments)
    return bi.i32(X), bi.i32(Y), bi.i32(Z)


def _check_fold(name: str, xs, ys, digits, n_segments: int) -> torch.device:
    bls_cuda.check(xs, (bi.L,), f"{name} xs")
    bls_cuda.check(ys, (bi.L,), f"{name} ys")
    bls_cuda.check(digits, (xs.shape[0],), f"{name} digits")
    dev = bls_cuda.same_device(name, xs, ys, digits)
    n = xs.shape[0]
    if ys.shape != xs.shape or digits.dim() != 2 or n_segments < 1 or n % n_segments:
        raise ValueError(f"{name}: {n} lanes, digits {list(digits.shape)}, "
                         f"{n_segments} segments do not agree")
    seg = n // n_segments
    if seg & (seg - 1):
        raise ValueError(f"{name}: segment size {seg} is not a power of two")
    return dev


def _fold_launch(xs, ys, digits, n_segments: int):
    """Launch row 13 on the card -> ((X, Y, Z) int32 [n, 12] whose first
    ``n_segments`` rows are the sums, number of launches)."""
    n = xs.shape[0]
    X, Y, Z = (torch.empty((n, bi.L), dtype=torch.int32, device=xs.device) for _ in range(3))
    bls_cuda.launch("lh_g1_scalar_mul", xs, ys, digits, X, Y, Z, n, digits.shape[0])
    launches = 1
    half = n // 2
    while half >= n_segments:
        bls_cuda.launch("lh_g1_add_halves", X, Y, Z, half)
        launches += 1
        half //= 2
    return (X, Y, Z), launches


def fold_device(xs, ys, digits, n_segments: int):
    """Windowed G1 MSM: affine Montgomery lanes xs, ys (int32 [n, 12], an
    identity lane has a zero scalar), MSB-first 4-bit digits (int32
    [n_digits, n]), lanes s-major over ``n_segments`` segments -> per
    segment the Jacobian sum (X, Y, Z) int32 [n_segments, 12].  Replaces
    ``lighthouse_tpu/ops/msm.py:115`` ``_fold_kernel``."""
    dev = _check_fold("fold", xs, ys, digits, n_segments)
    if dev.type == "cpu":
        return fold_plain(xs, ys, digits, n_segments)
    (X, Y, Z), launches = _fold_launch(xs, ys, digits, n_segments)
    fold_device.launches += launches
    return X[:n_segments], Y[:n_segments], Z[:n_segments]


fold_device.launches = 0


def jacobian_rows_to_affine(X, Y, Z) -> list:
    """HOST: Montgomery Jacobian word rows (uint32 [n, 12]) -> affine int
    points, ``cv.INF`` for identity rows."""
    out = []
    for x, y, z in zip(bi.mont_limbs_to_ints(X), bi.mont_limbs_to_ints(Y),
                       bi.mont_limbs_to_ints(Z)):
        if z == 0:
            out.append(cv.INF)
            continue
        zi = pow(z, -1, bi.P_INT)
        zi2 = zi * zi % bi.P_INT
        out.append((x * zi2 % bi.P_INT, y * zi2 % bi.P_INT * zi % bi.P_INT))
    return out


# --------------------------------------------------------------------------
# the host seam and the g1 lincomb front door
# --------------------------------------------------------------------------

def host_lincomb_groups(points, scalars, groups, n_groups: int) -> list:
    """Σ k·P per group over affine G1 int points on the HOST, through the
    native ``lhbls_g1_lincomb_groups`` (``csrc/bls_host.cc``).  ``groups``
    maps each lane to its group (None: one group).  Returns affine points,
    ``cv.INF`` for identity groups."""
    idx = groups if groups is not None else [0] * len(points)
    pts, ks, gs = [], [], []
    for p, k, g in zip(points, scalars, idx):
        k = k % _R
        if k and p is not cv.INF:
            pts.append(p)
            ks.append(k)
            gs.append(int(g))
    if not pts:
        return [cv.INF] * n_groups
    return [cv.INF if r is None else r
            for r in native_bls.g1_lincomb_groups(pts, ks, gs, n_groups)]


def host_lincomb_groups_g2(points, scalars, groups, n_groups: int) -> list:
    """The G2 half of the seam (native ``lhbls_g2_lincomb_groups``) over
    affine Fq2 points; returns affine Fq2 points, ``cv.INF`` for identity
    groups."""
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2

    idx = groups if groups is not None else [0] * len(points)
    pts, ks, gs = [], [], []
    for p, k, g in zip(points, scalars, idx):
        k = k % _R
        if k and p is not cv.INF:
            pts.append(((p[0].a, p[0].b), (p[1].a, p[1].b)))
            ks.append(k)
            gs.append(int(g))
    if not pts:
        return [cv.INF] * n_groups
    return [cv.INF if r is None else (Fq2(*r[0]), Fq2(*r[1]))
            for r in native_bls.g2_lincomb_groups(pts, ks, gs, n_groups)]


def _fold_lanes(points, scalars, padded: int, device):
    """Affine points and scalars -> (xs, ys, digits) tensors of ``padded``
    lanes; infinity points and zero scalars become identity lanes."""
    xs, ys, ks = [], [], []
    for p, k in zip(points, scalars):
        k = k % _R
        if p is cv.INF or k == 0:
            xs.append(0)
            ys.append(0)
            ks.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            ks.append(k)
    pad = padded - len(xs)
    digits = ec.scalars_to_digits(ks + [0] * pad, n_bits=256).astype(np.int32)
    return (bi.to_tensor(bi.ints_to_mont_limbs(xs + [0] * pad), device),
            bi.to_tensor(bi.ints_to_mont_limbs(ys + [0] * pad), device),
            torch.from_numpy(digits).to(device))


def msm_g1(points, scalars, *, device=None, pad_to: int | None = None):
    """Σ k_i·P_i over affine G1 int points.  Routing, as in the JAX package:
    below ``_STATIC_DEVICE_MIN`` lanes the host seam, otherwise row 13 on
    ``device`` (``cuda`` unless ``device="cpu"``, the plain version) over
    a pow2 lane bucket (``pad_to`` rounds it up).  Infinity points and zero
    scalars enter as identity lanes; scalars reduce mod the group order."""
    dev = resolve_device(device)
    n = len(points)
    if n < _STATIC_DEVICE_MIN:
        return host_lincomb_groups(points, scalars, None, 1)[0]
    padded = max(bucket(n), pad_to or 0)
    X, Y, Z = fold_device(*_fold_lanes(points, scalars, padded, dev), 1)
    return jacobian_rows_to_affine(*(bi.to_numpy(t) for t in (X, Y, Z)))[0]


def lincomb_per_point(points, scalars, *, device=None) -> list:
    """k_i·P_i for every lane on its own (one segment per lane): the host
    seam below ``_STATIC_DEVICE_MIN`` lanes, else row 13 on ``device``."""
    dev = resolve_device(device)
    n = len(points)
    if n < _STATIC_DEVICE_MIN:
        return host_lincomb_groups(points, scalars, range(n), n)
    padded = bucket(n)
    X, Y, Z = fold_device(*_fold_lanes(points, scalars, padded, dev), padded)
    return jacobian_rows_to_affine(*(bi.to_numpy(t[:n]) for t in (X, Y, Z)))
