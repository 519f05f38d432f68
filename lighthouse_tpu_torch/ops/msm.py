"""The MSM plane of the batch-verify path: the pow2 bucket policy, the
joint G1×G2 track of the fused pipeline, and the blinded pubkey fold.

Counterpart of ``lighthouse_tpu/ops/msm.py`` (``bucket`` :73,
``fold_segments_gj`` :98, ``_blinded_fold`` :143 and
``blinded_fold_device`` :183).  The calibration, the gather track and the
host lincomb seam stay out of this slice.

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

from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda, ec


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
