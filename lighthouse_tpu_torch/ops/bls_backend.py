"""The "cuda" BLS backend: the batch-verify data plane on the card.

Port of ``lighthouse_tpu/ops/bls_backend.py``.  Batch semantics are the
reference's: per-set nonzero 64-bit random scalars r_i, then one combined
check

    e(-g1, Σ r_i·sig_i) · Π e(r_i·agg_pk_i, H(m_i)) == 1

Division of labour, as in the JAX package:

- host: native C++ decompression, the final exponentiation's easy part,
  and on the CPU its hard part (``csrc/bls_host.cc``); on a CUDA device
  ``final_exp_is_one`` sends the hard part to the card (row 9;
  ``LHGPU_DEVICE_FINAL_EXP`` forces either route); the random scalars and
  blinding points (from ``secrets``: a predictable generator would let an
  attacker forge a batch), hash-to-G2 in Python (memoized), and the lane
  layout;
- card, per chunk, ``pipeline_device`` (``lh_bls_pipeline``): the joint
  windowed G1×G2 scalar mul, the per-message G1 segment fold, the G2 tree
  sum, every Miller loop and the Fq12 product tree;
- card, once per batch with fresh signatures, ``g2_subgroup_device``
  (``lh_g2_subgroup``): the ψ membership verdict, read only at the commit
  point after the pipeline chunks are queued behind it;
- card, for batches whose member keys exceed their sets by 16 or more,
  the blinded pubkey fold (``msm.blinded_fold_device``).

Beside the verifier: ``batch_subgroup_check_g1``, the [r-1]P membership
test of many G1 points at once (``g1_subgroup_device``, row 12), which the
trusted-setup load (``crypto/kzg.py``) runs over every setup point.

There is no supervisor: a failed build or launch raises, and nothing falls
back to the host or to the plain versions on a CUDA device.  On the CPU
(``device="cpu"``) every wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from typing import Sequence

import numpy as np
import torch

from lighthouse_tpu_torch.common.utils import LruCache
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_cuda, ec, native_bls
from lighthouse_tpu_torch.ops import dispatch_pipeline as dp
from lighthouse_tpu_torch.ops import msm

RAND_BITS = 64
N_DIGITS = RAND_BITS // 4

_H2C_CACHE = LruCache(capacity=1 << 16)


def _hash_to_g2_cached(message: bytes):
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2

    pt = _H2C_CACHE.get(message)
    if pt is None:
        pt = hash_to_g2(message)
        _H2C_CACHE.put(message, pt)
    return pt


def _nonzero_scalar(bits: int = RAND_BITS) -> int:
    r = 0
    while r == 0:
        r = secrets.randbits(bits)
    return r


def prepare_pairs(sets: Sequence[api.SignatureSet], scalars=None):
    """Host-only prep of the multi-pairing: [(r_i·agg_pk_i, H(m_i))] per set
    and the (-g1, Σ r_i·sig_i) pair, every multiplication in Python
    (``crypto/bls/curve.py``), each signature's subgroup check with its
    decompression.  None if any set is structurally invalid.  The pairs of
    the sharded backend (``parallel/bls_sharded.py``); ``scalars`` (tests
    only) replaces the random r_i.  Counterpart of
    ``lighthouse_tpu/ops/bls_backend.py:92``."""
    pairs = []
    sig_acc = cv.INF
    for i, s in enumerate(sets):
        if not s.pubkeys:
            return None
        try:
            sig_pt = s.signature.point
            agg_pk = s.aggregate_pubkey()
        except (api.BlsError, ValueError):
            return None
        if sig_pt is cv.INF:
            return None
        r = _nonzero_scalar() if scalars is None else scalars[i]
        sig_acc = cv.g2_add(sig_acc, cv.g2_mul(sig_pt, r))
        pairs.append((cv.g1_mul(agg_pk, r), _hash_to_g2_cached(s.message)))
    pairs.append((cv.g1_neg(cv.g1_generator()), sig_acc))
    return pairs


# --------------------------------------------------------------------------
# lh_bls_pipeline: plain version and kernel wrapper
# --------------------------------------------------------------------------

def _miller_inputs(P, S, hx, hy, g1x, g1y, lane_mask):
    """Miller lanes of the pipeline: the M grouped/flat P lanes with H(m),
    then (-g1, Σ r·sig) with Jacobian Q; the last lane's mask is Σ ≠ ∞."""
    Xp, Yp, Zp = P
    SX, SY, SZ = S
    m = hx.shape[0]
    xp = torch.cat([Xp[:m], g1x])
    yp = torch.cat([Yp[:m], g1y])
    zp = torch.cat([Zp[:m], bi.one_like(g1x)])
    one_q = t12.fp2_one_like(hx)
    xq = torch.cat([hx, SX[:1]])
    yq = torch.cat([hy, SY[:1]])
    zq = torch.cat([one_q, SZ[:1]])
    return xp, yp, zp, xq, yq, zq


def pipeline_plain(pkx, pky, sx, sy, hx, hy, digits, lane_mask, g1x, g1y, n_groups: int):
    """Plain version of ``lh_bls_pipeline`` (int32 word tensors in, one Fq12
    row [1, 12, 12] out)."""
    P, S = msm.fold_segments_gj(bi.u64(pkx), bi.u64(pky), bi.u64(sx), bi.u64(sy),
                                digits.to(torch.int64), n_groups)
    xp, yp, zp, xq, yq, zq = _miller_inputs(P, S, bi.u64(hx), bi.u64(hy), bi.u64(g1x),
                                            bi.u64(g1y), lane_mask)
    sum_ok = ~t12.fp2_is_zero(S[2][:1])
    mask = torch.cat([lane_mask.bool(), sum_ok])
    f = t12.batch_miller_loop_plain(xp, yp, zp, xq, yq, zq)
    f = t12.reduce_product_plain(f, mask)
    return bi.i32(t12.fq12_flat(f))


def pipeline_device(pkx, pky, sx, sy, hx, hy, digits, lane_mask, g1x, g1y,
                    n_groups: int) -> torch.Tensor:
    """The whole verify data plane of one chunk -> Fq12 row [1, 12, 12]:
    Π_lanes miller(r·pk, H(m)) · miller(-g1, Σ r·sig), masked lanes one.

    Inputs (int32 Montgomery words): pkx, pky [N, 12] G1 affine; sx, sy
    [N, 2, 12] G2 affine signatures; digits [16, N] the scalars' MSB-first
    4-bit windows (zero scalar: padding lane); hx, hy [M, 2, 12] H(m) per
    Miller lane; lane_mask bool [M]; g1x, g1y [1, 12] of -g1.  n_groups == 0
    is the flat layout (M == N); otherwise the N lanes are s-major segments
    of the M == n_groups message groups.  Replaces
    ``lighthouse_tpu/ops/bls_backend.py:124`` ``_pipeline_fused``."""
    for name, t, tail in (("pkx", pkx, (bi.L,)), ("pky", pky, (bi.L,)),
                          ("sx", sx, (2, bi.L)), ("sy", sy, (2, bi.L)),
                          ("hx", hx, (2, bi.L)), ("hy", hy, (2, bi.L)),
                          ("g1x", g1x, (1, bi.L)), ("g1y", g1y, (1, bi.L))):
        bls_cuda.check(t, tail, f"pipeline {name}")
    bls_cuda.check(digits, (digits.shape[-1],), "pipeline digits")
    dev = bls_cuda.same_device("pipeline", pkx, pky, sx, sy, hx, hy, digits, lane_mask, g1x, g1y)
    n, m = pkx.shape[0], hx.shape[0]
    if digits.shape != (N_DIGITS, n) or lane_mask.shape != (m,):
        raise ValueError(f"pipeline: digits {list(digits.shape)} / mask {list(lane_mask.shape)} "
                         f"do not match {n} scalar lanes and {m} Miller lanes")
    if n & (n - 1) or (m != (n_groups or n)) or (n_groups and n % n_groups):
        raise ValueError(f"pipeline: bad layout n={n}, m={m}, n_groups={n_groups}")
    if dev.type == "cpu":
        return pipeline_plain(pkx, pky, sx, sy, hx, hy, digits, lane_mask, g1x, g1y, n_groups)
    PX, PY, PZ = (torch.empty((n, bi.L), dtype=torch.int32, device=dev) for _ in range(3))
    SX, SY, SZ = (torch.empty((n, 2, bi.L), dtype=torch.int32, device=dev) for _ in range(3))
    bls_cuda.launch("lh_gj_scalar_mul", pkx, pky, sx, sy, digits, PX, PY, PZ, SX, SY, SZ,
                    n, N_DIGITS)
    launches = 1
    half = n // 2
    while n_groups and half >= n_groups:
        bls_cuda.launch("lh_g1_add_halves", PX, PY, PZ, half)
        launches += 1
        half //= 2
    half = n // 2
    while half >= 1:
        bls_cuda.launch("lh_g2_add_halves", SX, SY, SZ, half)
        launches += 1
        half //= 2
    xp, yp, zp, xq, yq, zq = (t.contiguous() for t in _miller_inputs(
        (PX, PY, PZ), (SX, SY, SZ), hx, hy, g1x, g1y, lane_mask))
    mask = torch.cat([lane_mask.to(torch.uint8), lane_mask.new_zeros(1, dtype=torch.uint8)])
    n_out = msm.bucket(m + 1)
    f = torch.empty((n_out, 12, bi.L), dtype=torch.int32, device=dev)
    bls_cuda.launch("lh_miller", xp, yp, zp, xq, yq, zq, mask, f, m + 1, n_out, m)
    launches += 1
    half = n_out // 2
    while half >= 1:
        bls_cuda.launch("lh_fq12_mul_halves", f, half)
        launches += 1
        half //= 2
    pipeline_device.launches += launches
    pipeline_device.calls += 1
    return f[:1].clone()


pipeline_device.launches = 0
pipeline_device.calls = 0            # calls: a tree kernel launches once per level


# --------------------------------------------------------------------------
# lh_g2_subgroup: plain version and kernel wrapper
# --------------------------------------------------------------------------

def g2_subgroup_plain(xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    return ec.g2_subgroup_verdict_plain(bi.u64(xq), bi.u64(yq))


def g2_subgroup_device(xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """ψ(Q) == [x]Q per affine G2 lane (int32 [N, 2, 12] each) -> bool[N].
    Replaces ``lighthouse_tpu/ops/bls_backend.py:175`` ``_g2_subgroup_kernel``.
    16 threads a lane run the scan's G2 doubling, mixed add and ψ tail from
    tapes; bound: ``bls_cuda.PSI_LANE`` Fp products a lane."""
    bls_cuda.check(xq, (2, bi.L), "g2_subgroup xq")
    bls_cuda.check(yq, (2, bi.L), "g2_subgroup yq")
    dev = bls_cuda.same_device("g2_subgroup", xq, yq)
    if xq.shape != yq.shape:
        raise ValueError("g2_subgroup: x and y rows differ in shape")
    if dev.type == "cpu":
        return g2_subgroup_plain(xq, yq)
    out = torch.empty(xq.shape[0], dtype=torch.uint8, device=dev)
    if xq.shape[0]:
        bls_cuda.launch("lh_g2_subgroup", xq, yq, out, xq.shape[0])
        g2_subgroup_device.launches += 1
    return out.bool()


g2_subgroup_device.launches = 0

# --------------------------------------------------------------------------
# lh_g1_subgroup: plain version and kernel wrapper
# --------------------------------------------------------------------------

def g1_subgroup_plain(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    return ec.g1_subgroup_verdict_plain(bi.u64(xp), bi.u64(yp))


def g1_subgroup_device(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """G1 membership per affine G1 lane (int32 [N, 12] each) -> bool[N],
    the verdict of ``g1_subgroup_plain`` ([r-1]P == -P) lane for lane.
    Replaces ``lighthouse_tpu/ops/bls_backend.py:207`` ``_g1_subgroup_kernel``.
    Four threads a lane run Scott's test sigma(P) == -[z^2]P over tapes
    (``csrc/bls12_381.cuh`` ``lane_g1_subgroup``); bound:
    ``bls_cuda.G1_SUBGROUP_LANE`` Fp products a lane."""
    bls_cuda.check(xp, (bi.L,), "g1_subgroup xp")
    bls_cuda.check(yp, (bi.L,), "g1_subgroup yp")
    dev = bls_cuda.same_device("g1_subgroup", xp, yp)
    if xp.shape != yp.shape:
        raise ValueError("g1_subgroup: x and y rows differ in shape")
    if dev.type == "cpu":
        return g1_subgroup_plain(xp, yp)
    out = torch.empty(xp.shape[0], dtype=torch.uint8, device=dev)
    if xp.shape[0]:
        bls_cuda.launch("lh_g1_subgroup", xp, yp, out, xp.shape[0])
        g1_subgroup_device.launches += 1
    return out.bool()


g1_subgroup_device.launches = 0


def batch_subgroup_check_g1(points, device=None) -> np.ndarray:
    """G1 membership of affine int points -> bool[n], on ``device``
    (``cuda`` unless ``device="cpu"``): the points padded with the
    generator to a power of two (at least 4), as the JAX package pads them,
    then one ``g1_subgroup_device`` launch.  Synchronous: the trusted-setup
    load reads the verdict at once."""
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    dev = resolve_device(device)
    padded = msm.bucket(n, floor=4)
    pts = list(points) + [cv.g1_generator()] * (padded - n)
    xp, yp = ec.g1_words(pts, dev)
    return g1_subgroup_device(xp, yp)[:n].cpu().numpy()


KERNELS = (pipeline_device, g2_subgroup_device, msm.blinded_fold_device, dp.fq12_mul_device)


# --------------------------------------------------------------------------
# the final exponentiation route (row 9)
# --------------------------------------------------------------------------

def device_final_exp(device) -> bool:
    """Does the hard part of the final exponentiation go to row 9 on
    ``device``?  ``LHGPU_DEVICE_FINAL_EXP=1`` sends it there, ``0`` keeps the
    native host final exponentiation (``csrc/bls_host.cc``), anything else
    raises.  Unset, a CUDA device takes row 9 (a group lane, faster on the
    H100 than the host's native one) and the CPU the native library (the
    plain ladder would be slow there), as the JAX package defaults to its
    device ladder on a TPU when its native library is absent."""
    env = os.environ.get("LHGPU_DEVICE_FINAL_EXP")
    if env is None:
        return torch.device(device).type == "cuda"
    if env not in ("0", "1"):
        raise ValueError(f"LHGPU_DEVICE_FINAL_EXP={env!r}: use 0 or 1")
    return env == "1"


def final_exp_is_one(f, device) -> bool:
    """Is the full final exponentiation of the Fq12 product ``f`` one?

    Port of ``_final_exp_is_one`` (``lighthouse_tpu/ops/bls_backend.py:419``),
    with one routing difference: the JAX package takes its native library
    first when it is present, then host Python, then the device ladder; the
    port always builds its native library, so here the route is
    ``device_final_exp(device)``: row 9 on a CUDA device unless
    ``LHGPU_DEVICE_FINAL_EXP=0``.  On that route the easy part runs on the host
    (``fields.final_exp_easy``, one inversion), the hard part on ``device``
    (``final_exp_hard_device``: row 9 on the card, its plain version on the
    CPU), and the result is compared with one.  A fault of row 9, or a
    result that is not a canonical field element, raises: nothing falls
    back to the native or Python path."""
    from lighthouse_tpu_torch.crypto.bls.fields import Fq12, final_exp_easy

    if not device_final_exp(device):
        return native_bls.final_exp_is_one(f)
    m = final_exp_easy(f)
    out = t12.final_exp_hard_device(bi.to_tensor(t12.fq12_to_words(m)[None], device))
    words = bi.to_numpy(out)
    if not all(bi.words_to_int(row) < bi.P_INT for row in words.reshape(12, bi.L)):
        raise RuntimeError("final_exp_hard: the card returned a non-canonical field element")
    return t12.fq12_from_words(words) == Fq12.ONE


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    pipeline_device.calls = msm.blinded_fold_device.calls = 0


# --------------------------------------------------------------------------
# host layout
# --------------------------------------------------------------------------

def _dispatch_g2_subgroup_kernel(points, device):
    """Launch the ψ verdict over affine G2 points, generator-padded to a
    power of two (floor 4) as the JAX package pads; the bool row stays on
    the card until the caller commits."""
    padded = msm.bucket(len(points), floor=4)
    pts = list(points) + [cv.g2_generator()] * (padded - len(points))
    xq, yq = ec.g2_words(pts, device)
    return g2_subgroup_device(xq, yq)


def _dispatch_subgroup_check(sigs, device):
    """Launch the ψ verdict for every signature not yet checked; an
    AsyncVerdict whose commit marks them checked on a pass, or None when a
    pending signature is the point at infinity."""
    pending = [s for s in sigs if not s.subgroup_checked()]
    if not pending:
        return dp.AsyncVerdict.immediate(True)
    pts = []
    for s in pending:
        pt = s.point_unchecked()
        if pt is cv.INF:
            return None
        pts.append(pt)
    ok = _dispatch_g2_subgroup_kernel(pts, device)

    def mark():
        for s in pending:
            s.mark_subgroup_checked()

    return dp.AsyncVerdict(ok, len(pts), on_pass=mark)


# blinding pool (bls_backend.py:243-320 of the JAX package): lane j carries
# B_j = [u_j]G beside the pubkeys and the known total is subtracted after the
# tree, so duplicate member keys (sync committees sample with replacement)
# never meet the incomplete H == 0 chord of the Jacobian add.
_BLIND_U: list[int] = []
_BLIND_ROWS: list[tuple[np.ndarray, np.ndarray]] = []
_BLIND_NEG_TOTAL: dict[int, tuple[np.ndarray, np.ndarray]] = {}
_BLIND_LOCK = threading.Lock()


def _blinding(max_k: int):
    with _BLIND_LOCK:
        while len(_BLIND_U) < max_k:
            u = _nonzero_scalar()
            pt = cv.g1_mul(cv.g1_generator(), u)
            _BLIND_U.append(u)
            _BLIND_ROWS.append(tuple(bi.ints_to_mont_limbs([pt[0], pt[1]])))
        neg = _BLIND_NEG_TOTAL.get(max_k)
        if neg is None:
            npt = cv.g1_neg(cv.g1_mul(cv.g1_generator(), sum(_BLIND_U[:max_k])))
            rows = bi.ints_to_mont_limbs([npt[0], npt[1]])
            neg = (rows[:1], rows[1:])
            _BLIND_NEG_TOTAL[max_k] = neg
        return _BLIND_ROWS[:max_k], neg


def fold_lanes(sets):
    """Host lane layout of the blinded pubkey fold -> (X, Y, Z, ux, uy,
    n_pad): Jacobian Montgomery rows uint32[2·max_k·n_pad, 12] and the
    negated blinding total.

    Layout (s-major, lane = j·n_pad + i): the first half of each segment
    holds the set's member keys (infinity-padded), the second half the
    blinding points B_0 .. B_{max_k - 1}, so every level-0 pair joins a key
    with a distinct blinding point."""
    n = len(sets)
    max_k = msm.bucket(max(len(s.pubkeys) for s in sets))
    n_pad = msm.bucket(n)
    blind, (ux, uy) = _blinding(max_k)
    X = np.zeros((2 * max_k * n_pad, bi.L), np.uint32)
    Y = np.zeros_like(X)
    Z = np.zeros_like(X)
    lanes, xs, ys = [], [], []
    for i, s in enumerate(sets):
        for j, pk in enumerate(s.pubkeys):
            xl, yl = pk.mont_limbs()
            lanes.append(j * n_pad + i)
            xs.append(xl)
            ys.append(yl)
    lanes = np.asarray(lanes, np.int64)
    X[lanes], Y[lanes], Z[lanes] = np.stack(xs), np.stack(ys), bi.ONE_M
    for j, (bx, by) in enumerate(blind):
        rows = slice((max_k + j) * n_pad, (max_k + j + 1) * n_pad)
        X[rows], Y[rows], Z[rows] = bx, by, bi.ONE_M
    return X, Y, Z, ux, uy, n_pad


def aggregate_pubkeys_device(sets, device=None):
    """Per-set pubkey aggregation as one blinded segment sum on ``device``
    (``fold_lanes``).  Returns (x_rows, y_rows, inf): affine Montgomery
    words uint32[n, 12] per set and bool[n] marking identity aggregates."""
    dev = resolve_device(device)
    X, Y, Z, ux, uy, n_pad = fold_lanes(sets)
    xa, ya, inf = msm.blinded_fold_device(*(bi.to_tensor(a, dev) for a in (X, Y, Z, ux, uy)),
                                          n_pad)
    n = len(sets)
    return bi.to_numpy(xa[:n]), bi.to_numpy(ya[:n]), inf[:n].cpu().numpy()


_G1_NEG_ROWS: np.ndarray | None = None


def _g1_neg_rows() -> np.ndarray:
    global _G1_NEG_ROWS
    if _G1_NEG_ROWS is None:
        gx, gy = cv.g1_neg(cv.g1_generator())
        _G1_NEG_ROWS = bi.ints_to_mont_limbs([gx, gy])
    return _G1_NEG_ROWS


def _grouped_layout(n: int, n_groups: int, max_sz: int) -> tuple[int | None, int, int]:
    """(seg, g_pad, padded_flat) for the grouped layout; seg is None for
    the flat one.  seg is one or two flat layouts' worth of lanes over the
    padded group count (``bls_backend._grouped_layout`` of the JAX
    package)."""
    g_pad = msm.bucket(n_groups, floor=2)
    padded_flat = msm.bucket(n, floor=4)
    if n_groups >= n:
        return None, g_pad, padded_flat
    for total in (padded_flat, 2 * padded_flat):
        seg = total // g_pad
        if seg >= max_sz:
            return seg, g_pad, padded_flat
    return None, g_pad, padded_flat


def _chunk_layout(sets, sig_pts, h2cs, pk_rows_x, pk_rows_y, scalars, device):
    """Host lane layout of one chunk -> the ``pipeline_device`` arguments.

    Sets sharing a message fold into one Miller lane
    (e(Σ r_i·pk_i, H(m)) = Π e(r_i·pk_i, H(m))) when the grouped layout
    fits; lanes are s-major over (segment, group); padding lanes carry zero
    scalars (infinity, the identity)."""
    n = len(sets)
    groups: dict[bytes, list[int]] = {}
    for i, s in enumerate(sets):
        groups.setdefault(s.message, []).append(i)
    n_groups = len(groups)
    seg, g_pad, padded_flat = _grouped_layout(n, n_groups, max(len(v) for v in groups.values()))
    sig_rows = bi.ints_to_mont_limbs(
        [c for p in sig_pts for c in (p[0].a, p[0].b, p[1].a, p[1].b)]).reshape(n, 2, 2, bi.L)
    if seg is not None:
        lanes = seg * g_pad
        lane_of = np.full(lanes, -1, np.int64)
        order = list(groups.values())
        for g, members in enumerate(order):
            lane_of[np.arange(len(members)) * g_pad + g] = members
        src = np.nonzero(lane_of >= 0)[0]

        def scatter(rows):
            out = np.zeros((lanes,) + rows.shape[1:], np.uint32)
            out[src] = rows[lane_of[src]]
            return out

        pkx, pky, sig = scatter(pk_rows_x), scatter(pk_rows_y), scatter(sig_rows)
        lane_scalars = [0] * lanes
        for lane in src:
            lane_scalars[lane] = scalars[lane_of[lane]]
        h_pts = [h2cs[members[0]] for members in order]
        m, n_real, n_seg = g_pad, n_groups, g_pad
    else:
        pad = padded_flat - n
        ext = lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:], np.uint32)])  # noqa: E731
        pkx, pky, sig = ext(pk_rows_x), ext(pk_rows_y), ext(sig_rows)
        lane_scalars = list(scalars) + [0] * pad
        h_pts = list(h2cs)
        lanes = m = padded_flat
        n_real, n_seg = n, 0
    h_rows = np.zeros((m, 2, 2, bi.L), np.uint32)
    h_rows[:len(h_pts)] = bi.ints_to_mont_limbs(
        [c for p in h_pts for c in (p[0].a, p[0].b, p[1].a, p[1].b)]).reshape(-1, 2, 2, bi.L)
    lane_mask = np.zeros(m, bool)
    lane_mask[:n_real] = True
    g1 = _g1_neg_rows()
    T = lambda a: bi.to_tensor(a, device)  # noqa: E731
    digits = torch.from_numpy(ec.scalars_to_digits(lane_scalars).astype(np.int32)).to(device)
    return (T(pkx), T(pky), T(np.ascontiguousarray(sig[:, 0])), T(np.ascontiguousarray(sig[:, 1])),
            T(np.ascontiguousarray(h_rows[:, 0])), T(np.ascontiguousarray(h_rows[:, 1])),
            digits, torch.from_numpy(lane_mask).to(device), T(g1[:1]), T(g1[1:]), n_seg)


# --------------------------------------------------------------------------
# the verifier
# --------------------------------------------------------------------------

def verify_signature_sets_device(sets: Sequence[api.SignatureSet], chunk_size: int | None = None,
                                 device=None, ledger: dict | None = None) -> bool:
    """The "cuda" backend: batch verification with the scalar work on
    ``device`` (see the module doc), ``cuda`` unless ``device="cpu"`` is
    given (the plain versions); raises when no card is present.

    Batches above the chunk size (``chunk_size`` > LHGPU_BLS_CHUNK >
    ``dispatch_pipeline.DEFAULT_CHUNK_SETS``; 0 disables) run as fixed
    power-of-two chunks whose partial products multiply down on the card.
    With ``ledger``, per-stage wall seconds are added under subgroup /
    aggregate / prep_host / limbs / pipeline / final_exp (device stages
    synchronized, so only pass one when profiling)."""
    return _verify_sets_pipeline(sets, ledger, chunk_size, device=resolve_device(device))


def _verify_sets_pipeline(sets, ledger=None, chunk_size=None, *, device, scalars=None) -> bool:
    """The verifier.  ``scalars`` (tests only) replaces the random r_i."""
    sync = (torch.cuda.synchronize if device.type == "cuda" and ledger is not None
            else (lambda: None))

    def mark(key, t0):
        if ledger is not None:
            sync()
            now = time.perf_counter()
            ledger[key] = ledger.get(key, 0.0) + now - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    n = len(sets)
    if n == 0:
        return False
    if not api.Signature.decompress_batch([s.signature for s in sets]):
        return False
    sig_pts, h2cs = [], []
    for s in sets:
        if not s.pubkeys:
            return False
        try:
            sig_pt = s.signature.point_unchecked()
        except (api.BlsError, ValueError):
            return False
        if sig_pt is cv.INF:
            return False
        sig_pts.append(sig_pt)
        h2cs.append(_hash_to_g2_cached(s.message))

    verdict = _dispatch_subgroup_check([s.signature for s in sets], device)
    if verdict is None:
        return False
    if ledger is not None and not verdict.commit():
        return False
    t0 = mark("subgroup", t0)

    try:
        if sum(len(s.pubkeys) for s in sets) - n >= 16:
            pk_rows_x, pk_rows_y, agg_inf = aggregate_pubkeys_device(sets, device)
            if agg_inf.any():
                return False
        else:
            agg_pks = [s.aggregate_pubkey() for s in sets]
            if any(p is cv.INF for p in agg_pks):
                return False
            pk_rows_x = bi.ints_to_mont_limbs([p[0] for p in agg_pks])
            pk_rows_y = bi.ints_to_mont_limbs([p[1] for p in agg_pks])
    except (api.BlsError, ValueError):
        return False
    t0 = mark("aggregate", t0)

    if scalars is None:
        scalars = [_nonzero_scalar() for _ in range(n)]
    t0 = mark("prep_host", t0)

    partials = []
    limbs_s = pipeline_s = 0.0
    for lo, hi in dp.plan_chunks(n, dp.chunk_size(chunk_size)):
        tc = time.perf_counter()
        args = _chunk_layout(sets[lo:hi], sig_pts[lo:hi], h2cs[lo:hi], pk_rows_x[lo:hi],
                             pk_rows_y[lo:hi], scalars[lo:hi], device)
        td = time.perf_counter()
        limbs_s += td - tc
        partials.append(pipeline_device(*args))
        sync()
        pipeline_s += time.perf_counter() - td
    if ledger is not None:
        ledger["limbs"] = ledger.get("limbs", 0.0) + limbs_s
        ledger["pipeline"] = ledger.get("pipeline", 0.0) + pipeline_s
    t0 = time.perf_counter()

    # commit point: the ψ row is read only now, with the chunks queued
    # behind it on the stream
    if not verdict.commit():
        return False
    f = dp.fq12_row_to_host(dp.combine_partials(partials))
    ok = final_exp_is_one(f, device)
    mark("final_exp", t0)
    return ok


api.register_backend("cuda", verify_signature_sets_device)
