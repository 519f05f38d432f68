"""PeerDAS data-availability-sampling cells and cell KZG proofs (EIP-7594
shape) on the card.

Port of ``lighthouse_tpu/crypto/das.py``: a blob's evaluations extend onto
the doubled domain (Reed-Solomon rate 1/2), cells are the bit-reversal
permuted cosets of that extended domain, any half of the cells recovers the
rest, and each cell carries a KZG multi-proof over the setup's monomial
points.  Same functions, arguments, values and ``KzgError`` messages; entry
points that reach the card take ``device`` (``cuda`` unless ``"cpu"``, the
plain versions).

Host work stays on the host, as in the JAX package: the FFTs, the cells,
recovery, the synthetic divisions and the interpolation coefficients
(Python integers mod r; ω powers come from exponent arithmetic and tables,
not ``pow`` calls in a loop, with the same values), and the lane packing of
the batched proofs (numpy).

Routing, as in the JAX package:

- ``compute_cells_and_kzg_proofs`` at width ``_CELL_PROOF_FUSED_MIN_WIDTH``
  (256) or more batches every cell's quotient MSM through row 13
  (``msm.fold_device``), lanes s-major (lane s·G + g: monomial point s
  weighted by cell g's coefficient s), in chunks of at most
  ``_CELL_PROOF_MAX_LANES`` (2^17) lanes: at width 4096, 128 cells of 64
  elements, quotients of 4,032 coefficients in 4,096 segments' worth of
  lanes, 32 cells a chunk, 4 chunks a blob; narrower setups take one
  ``kzg.g1_lincomb`` a cell;
- ``verify_cell_kzg_proof_batch`` with 8 cells or more folds the batch by a
  random linear combination into row 14 (``kzg.kzg_fused_device``) with
  τ^cs·G2 (``g2_monomial[cell_size]``) in the second pairing slot; fewer
  cells take ``verify_cell_kzg_proof`` each, one multi-pairing on the card
  (row 10).
"""

from __future__ import annotations

import hashlib
import secrets
import time
from functools import lru_cache

import numpy as np
import torch

from lighthouse_tpu_torch.crypto import kzg as _kzg
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.kzg import (
    BLS_MODULUS,
    PRIMITIVE_ROOT_OF_UNITY,
    KzgError,
    _bit_reversal_permutation,
    _compute_roots_of_unity,
    bls_field_to_bytes,
    bytes_to_bls_field,
)
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_backend, msm

# mainnet: 4096-wide blobs -> 8192 extended evaluations -> 128 cells of 64
# field elements; narrower (dev) widths shrink the cell, keeping 128 cells
# while the extension has at least 128 points
CELLS_PER_EXT_BLOB = 128

_CELL_PROOF_FUSED_MIN_WIDTH = 256   # batched proofs (row 13) from this width
_CELL_PROOF_MAX_LANES = 1 << 17     # lanes a chunk of the batched proofs
_BATCH_MIN_CELLS = 8                # fewer cells: the per-cell check


def _bytes_to_field_elements(data: bytes, count: int) -> list[int]:
    if len(data) != count * 32:
        raise KzgError(f"expected {count} field elements")
    return [bytes_to_bls_field(data[i:i + 32]) for i in range(0, len(data), 32)]


def _cell_geometry(width: int) -> tuple[int, int]:
    ext = 2 * width
    n_cells = min(CELLS_PER_EXT_BLOB, ext)
    return n_cells, ext // n_cells


@lru_cache(maxsize=8)
def _ext_domain(width: int) -> tuple[list[int], list[int]]:
    """(roots of unity of the doubled domain, natural position of each
    bit-reversed position)."""
    ext = 2 * width
    return _compute_roots_of_unity(ext), _bit_reversal_permutation(list(range(ext)))


def _fft(vals: list[int], roots: list[int], inverse: bool = False) -> list[int]:
    """Iterative radix-2 NTT over the scalar field; ``roots`` is the full
    n-th root-of-unity list for n == len(vals)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    assert n & (n - 1) == 0
    out = _bit_reversal_permutation(list(vals))
    step = 1
    while step < n:
        stride = n // (2 * step)
        ws = [roots[(n - k * stride) % n] if inverse else roots[k * stride] for k in range(step)]
        for start in range(0, n, 2 * step):
            for k in range(step):
                a = out[start + k]
                b = out[start + k + step] * ws[k] % BLS_MODULUS
                out[start + k] = (a + b) % BLS_MODULUS
                out[start + k + step] = (a - b) % BLS_MODULUS
        step *= 2
    if inverse:
        n_inv = pow(n, -1, BLS_MODULUS)
        out = [v * n_inv % BLS_MODULUS for v in out]
    return out


def _poly_coeffs_from_blob(blob: bytes, width: int) -> list[int]:
    """Blob evaluations (bit-reversed domain order) -> monomial coefficients."""
    evals = _bit_reversal_permutation(_bytes_to_field_elements(blob, width))
    return _fft(evals, _compute_roots_of_unity(width), inverse=True)


def _cells_of(ext_brp: list[int], n_cells: int, cell_size: int) -> list[bytes]:
    return [b"".join(bls_field_to_bytes(v) for v in ext_brp[c * cell_size:(c + 1) * cell_size])
            for c in range(n_cells)]


def compute_cells(blob: bytes, settings) -> list[bytes]:
    """Extend the blob onto the doubled domain and split it into cells: cell
    c holds the extended evaluations at positions [c·cs, (c+1)·cs) of the
    bit-reversed extended domain (each cell a coset)."""
    width = settings.width
    n_cells, cell_size = _cell_geometry(width)
    coeffs = _poly_coeffs_from_blob(blob, width)
    ext_roots, _ = _ext_domain(width)
    ext_evals = _fft(coeffs + [0] * width, ext_roots)
    return _cells_of(_bit_reversal_permutation(ext_evals), n_cells, cell_size)


def cells_to_blob(cells: list[bytes], settings) -> bytes:
    """The first half of the (bit-reversed) extended evaluations is the blob."""
    width = settings.width
    n_cells, _cell_size = _cell_geometry(width)
    if len(cells) != n_cells:
        raise KzgError(f"need all {n_cells} cells, got {len(cells)}")
    return b"".join(cells)[: width * 32]


def _cell_field_elements(cell: bytes, cell_size: int) -> list[int]:
    if len(cell) != cell_size * 32:
        raise KzgError("cell has the wrong size")
    return _bytes_to_field_elements(cell, cell_size)


def _powers(base: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % BLS_MODULUS
    return out


def recover_all_cells(cell_ids: list[int], cells: list[bytes], settings) -> list[bytes]:
    """Erasure recovery: any half of the cells or more gives all of them.
    Z(x) vanishes on the missing cells' cosets (a coset {h·w : w^cs = 1}
    has the sparse factor x^cs − h^cs); E·Z is divided by Z on a shifted
    coset where Z has no roots, and the quotient re-extended.  With more
    than half the cells, a received cell that disagrees raises."""
    width = settings.width
    ext = 2 * width
    n_cells, cell_size = _cell_geometry(width)
    if len(cell_ids) != len(cells):
        raise KzgError("cell_ids and cells length mismatch")
    if len(set(cell_ids)) != len(cell_ids):
        raise KzgError("duplicate cell ids")
    if any(not 0 <= c < n_cells for c in cell_ids):
        raise KzgError("cell id out of range")
    if len(cell_ids) < n_cells // 2:
        raise KzgError(f"need at least {n_cells // 2} cells, got {len(cell_ids)}")
    have = dict(zip(cell_ids, cells))
    if len(have) == n_cells:
        return [have[c] for c in range(n_cells)]

    ext_roots, nat_of_brp = _ext_domain(width)
    # received evaluations in natural order (0 at missing positions)
    e_nat = [0] * ext
    for cid, cell in have.items():
        for k, v in enumerate(_cell_field_elements(cell, cell_size)):
            e_nat[nat_of_brp[cid * cell_size + k]] = v

    # Z(x) = Π over missing cells of (x^cs − h_c^cs), h_c the first root of
    # the cell's coset; h_c^cs is the root at cs times its position
    z = [1]
    for cid in range(n_cells):
        if cid in have:
            continue
        hc = ext_roots[nat_of_brp[cid * cell_size] * cell_size % ext]
        nz = [0] * (len(z) + cell_size)
        for i, c in enumerate(z):
            nz[i] = (nz[i] - c * hc) % BLS_MODULUS
            nz[i + cell_size] = (nz[i + cell_size] + c) % BLS_MODULUS
        z = nz
    z_coeffs = z + [0] * (ext - len(z))

    z_evals = _fft(z_coeffs, ext_roots)
    ez_coeffs = _fft([e * zv % BLS_MODULUS for e, zv in zip(e_nat, z_evals)], ext_roots,
                     inverse=True)
    # divide on the coset shift·domain (the primitive root lies outside
    # every power-of-two root subgroup, so Z has no roots there)
    shift_pows = _powers(PRIMITIVE_ROOT_OF_UNITY, ext)
    ez_on_coset = _fft([c * s % BLS_MODULUS for c, s in zip(ez_coeffs, shift_pows)], ext_roots)
    z_on_coset = _fft([c * s % BLS_MODULUS for c, s in zip(z_coeffs, shift_pows)], ext_roots)
    d_on_coset = [e * zi % BLS_MODULUS
                  for e, zi in zip(ez_on_coset, _kzg._batch_inverse(z_on_coset))]
    d_shift = _fft(d_on_coset, ext_roots, inverse=True)
    inv_pows = _powers(pow(PRIMITIVE_ROOT_OF_UNITY, -1, BLS_MODULUS), ext)
    d_coeffs = [c * s % BLS_MODULUS for c, s in zip(d_shift, inv_pows)]
    if any(v != 0 for v in d_coeffs[width:]):
        raise KzgError("recovered polynomial exceeds blob degree (inconsistent cells)")

    full_brp = _bit_reversal_permutation(_fft(d_coeffs, ext_roots))
    out = [have.get(c) for c in range(n_cells)]
    for c in range(n_cells):
        if out[c] is None:
            out[c] = b"".join(bls_field_to_bytes(v)
                              for v in full_brp[c * cell_size:(c + 1) * cell_size])
    # received cells must agree with the recovered polynomial
    for cid, cell in have.items():
        if _cell_field_elements(cell, cell_size) != full_brp[cid * cell_size:
                                                             (cid + 1) * cell_size]:
            raise KzgError(f"cell {cid} inconsistent with recovery")
    return out


# --- cell KZG multi-proofs ---------------------------------------------------
#
# Proof for cell c: π_c = [q_c(τ)]₁ with q_c = (p − I_c) / Z_c, where I_c
# interpolates p on the cell's coset and Z_c(x) = x^cs − h_c^cs is the
# coset's vanishing polynomial (sparse: synthetic division is O(n)).
# Verification: e(C − [I_c(τ)]₁, −G₂) · e(π_c, [Z_c(τ)]₂) == 1 with
# [Z_c(τ)]₂ = τ^cs·G₂ − h_c^cs·G₂ from the setup's G2 monomials.


def _coset_start(cid: int, cell_size: int, ext_roots, nat_of_brp) -> int:
    return ext_roots[nat_of_brp[cid * cell_size]]


def _coset_vanishing_constant(cid: int, width: int) -> int:
    """h_c^cs: the root of the doubled domain at cs times the coset's first
    position."""
    _n_cells, cell_size = _cell_geometry(width)
    ext_roots, nat_of_brp = _ext_domain(width)
    return ext_roots[nat_of_brp[cid * cell_size] * cell_size % (2 * width)]


def _require_monomials(settings, cell_size: int):
    if settings.g1_monomial is None or settings.g2_monomial is None \
            or len(settings.g2_monomial) <= cell_size:
        raise KzgError("cell proofs need the setup's monomial points "
                       "(g1_monomial/g2_monomial in the ceremony file)")


def _add(ledger, key: str, t0: float, device) -> float:
    if ledger is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        ledger[key] = ledger.get(key, 0.0) + now - t0
    return time.perf_counter()


def cell_proof_lanes(q_lists: list[list[int]], mono_x: np.ndarray, mono_y: np.ndarray,
                     live: np.ndarray, seg_pad: int):
    """numpy lane layout of one chunk of the batched proofs -> (xs, ys
    uint32 [seg_pad·g_pad, 12], digits uint32 [64, seg_pad·g_pad], g_pad):
    lane s·g_pad + g holds monomial point s (Montgomery words ``mono_x``,
    ``mono_y`` [seg_pad, 12]) under cell g's coefficient s, MSB-first 4-bit
    digits; a zero coefficient or a missing point (``live`` False) is an
    identity lane (zero words, zero digits)."""
    g = len(q_lists)
    g_pad = msm.bucket(g)
    raw = np.zeros((g_pad, seg_pad, 32), np.uint8)
    for gi, q in enumerate(q_lists):
        buf = b"".join(k.to_bytes(32, "big") for k in q[:seg_pad])
        raw[gi, :len(q)] = np.frombuffer(buf, np.uint8).reshape(-1, 32)
    raw[:, ~live] = 0
    nz = raw.any(axis=2).T[..., None]                        # [seg_pad, g_pad, 1]
    nibbles = np.empty((64, seg_pad, g_pad), np.uint8)
    t = raw.transpose(2, 1, 0)                               # [32, seg_pad, g_pad]
    np.right_shift(t, 4, out=nibbles[0::2])
    np.bitwise_and(t, 0xF, out=nibbles[1::2])
    digits = nibbles.reshape(64, seg_pad * g_pad).astype(np.uint32)
    zero = np.uint32(0)
    xs = np.where(nz, mono_x[:, None, :], zero)
    ys = np.where(nz, mono_y[:, None, :], zero)
    return xs.reshape(-1, bi.L), ys.reshape(-1, bi.L), digits, g_pad


def _batched_cell_proof_msms(q_lists: list[list[int]], settings, device=None, *,
                             ledger: dict | None = None) -> list:
    """Every cell's quotient MSM through row 13 in chunks of at most
    ``_CELL_PROOF_MAX_LANES`` lanes (see the module doc) -> affine points
    (``cv.INF`` for the identity), one a cell.  With ``ledger``, seconds
    under ``lanes`` (numpy packing and copies), ``fold`` (row 13) and
    ``affine`` (the host's conversion)."""
    dev = resolve_device(device)
    seg_pad = msm.bucket(len(q_lists[0]))
    chunk = max(1, _CELL_PROOF_MAX_LANES // seg_pad)
    chunk = 1 << (chunk.bit_length() - 1)       # floor to a power of two
    n_mono = min(len(settings.g1_monomial), seg_pad)
    pts = settings.g1_monomial[:n_mono]
    live = np.zeros(seg_pad, bool)
    live[:n_mono] = [p is not cv.INF for p in pts]
    mono_x = np.zeros((seg_pad, bi.L), np.uint32)
    mono_y = np.zeros((seg_pad, bi.L), np.uint32)
    mono_x[:n_mono] = bi.ints_to_mont_limbs([p[0] if p is not cv.INF else 0 for p in pts])
    mono_y[:n_mono] = bi.ints_to_mont_limbs([p[1] if p is not cv.INF else 0 for p in pts])
    out = []
    for c0 in range(0, len(q_lists), chunk):
        t0 = time.perf_counter()
        qs = q_lists[c0:c0 + chunk]
        xs, ys, digits, g_pad = cell_proof_lanes(qs, mono_x, mono_y, live, seg_pad)
        args = (bi.to_tensor(xs, dev), bi.to_tensor(ys, dev),
                torch.from_numpy(digits.view(np.int32)).to(dev))
        t0 = _add(ledger, "lanes", t0, dev)
        X, Y, Z = msm.fold_device(*args, g_pad)
        t0 = _add(ledger, "fold", t0, dev)
        g = len(qs)
        out.extend(msm.jacobian_rows_to_affine(*(bi.to_numpy(t[:g]) for t in (X, Y, Z))))
        _add(ledger, "affine", t0, dev)
    return out


def _quotients(coeffs: list[int], width: int) -> list[list[int]]:
    """q_c = (p − I_c) / (x^cs − h_c^cs) for every cell by synthetic
    division, top down: q_j = p_{j+cs} + a·q_{j+cs}."""
    n_cells, cell_size = _cell_geometry(width)
    n_q = max(width - cell_size, 1)
    out = []
    for cid in range(n_cells):
        a = _coset_vanishing_constant(cid, width)
        q = [0] * n_q
        for j in range(width - cell_size - 1, -1, -1):
            carry = q[j + cell_size] if j + cell_size < n_q else 0
            q[j] = (coeffs[j + cell_size] + a * carry) % BLS_MODULUS
        out.append(q)
    return out


def compute_cells_and_kzg_proofs(blob: bytes, settings, device=None, *,
                                 ledger: dict | None = None) -> tuple[list[bytes], list[bytes]]:
    """The cells and one KZG multi-proof a cell: batched through row 13 at
    width ``_CELL_PROOF_FUSED_MIN_WIDTH`` or more, one ``g1_lincomb`` a
    cell below it.  With ``ledger``, seconds under ``host`` (FFTs, cells,
    quotients), then the batched path's ``lanes``, ``fold`` and
    ``affine``, or ``msm`` on the per-cell path."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    width = settings.width
    n_cells, cell_size = _cell_geometry(width)
    _require_monomials(settings, cell_size)
    coeffs = _poly_coeffs_from_blob(blob, width)
    ext_roots, _ = _ext_domain(width)
    ext_evals = _fft(coeffs + [0] * width, ext_roots)
    cells = _cells_of(_bit_reversal_permutation(ext_evals), n_cells, cell_size)
    q_lists = _quotients(coeffs, width)
    t0 = _add(ledger, "host", t0, dev)
    if width >= _CELL_PROOF_FUSED_MIN_WIDTH:
        pts = _batched_cell_proof_msms(q_lists, settings, dev, ledger=ledger)
    else:
        pts = [_kzg.g1_lincomb(settings.g1_monomial[:len(q)], q, device=dev) for q in q_lists]
        _add(ledger, "msm", t0, dev)
    return cells, [cv.g1_to_bytes(p) for p in pts]


def _interpolation_commitment(cell: bytes, cid: int, settings, device=None):
    """[I_c(τ)]₁ for the cell's claimed evaluations."""
    _n_cells, cell_size = _cell_geometry(settings.width)
    coeffs = _interpolation_coeffs(cell, cid, settings)
    return _kzg.g1_lincomb(settings.g1_monomial[:cell_size], coeffs, device=device)


@lru_cache(maxsize=4)
def _omega_powers(width: int) -> list[int]:
    """ω^j for j < cs, ω the cs-th root of unity of the doubled domain."""
    _n_cells, cell_size = _cell_geometry(width)
    ext_roots, _ = _ext_domain(width)
    step = 2 * width // cell_size
    return [ext_roots[j * step % (2 * width)] for j in range(cell_size)]


def _interpolation_coeffs(cell: bytes, cid: int, settings) -> list[int]:
    """Monomial coefficients of I_c: the coset's inverse transform of size
    cs, I_m = cs⁻¹·h⁻ᵐ·Σ_j v_j·ω^(−j·m), where position k of the cell is
    the point h·ω^(j_k), j_k read off the exponents of the doubled
    domain's roots."""
    width = settings.width
    _n_cells, cell_size = _cell_geometry(width)
    ext = 2 * width
    ext_roots, nat_of_brp = _ext_domain(width)
    vals = _cell_field_elements(cell, cell_size)
    base = nat_of_brp[cid * cell_size]
    h_inv = ext_roots[-base % ext]
    step = ext // cell_size
    reordered = [0] * cell_size
    for k in range(cell_size):
        reordered[(nat_of_brp[cid * cell_size + k] - base) % ext // step] = vals[k]
    coeffs = _fft(reordered, _omega_powers(width), inverse=True)
    h_pow = 1
    for m in range(cell_size):
        coeffs[m] = coeffs[m] * h_pow % BLS_MODULUS
        h_pow = h_pow * h_inv % BLS_MODULUS
    return coeffs


def verify_cell_kzg_proof(commitment_bytes: bytes, cell_id: int, cell: bytes, proof_bytes: bytes,
                          settings, device=None) -> bool:
    """e(C − [I(τ)]₁, −G₂) · e(π, [Z(τ)]₂) == 1, one multi-pairing on
    ``device`` (row 10)."""
    dev = resolve_device(device)
    width = settings.width
    n_cells, cell_size = _cell_geometry(width)
    _require_monomials(settings, cell_size)
    if not 0 <= int(cell_id) < n_cells:
        return False
    try:
        commitment, proof = _kzg._decode_g1_batch([commitment_bytes, proof_bytes])
        interp = _interpolation_commitment(cell, int(cell_id), settings, dev)
    except (ValueError, KzgError):
        return False
    a = _coset_vanishing_constant(int(cell_id), width)
    g2 = cv.g2_generator()
    z_tau_g2 = cv.g2_add(settings.g2_monomial[cell_size],
                         cv.g2_neg(msm.host_lincomb_groups_g2([g2], [a], None, 1)[0]))
    c_minus_i = cv.g1_add(commitment, cv.g1_neg(interp)) if interp is not cv.INF else commitment
    return _kzg._pairing_check([(c_minus_i, cv.g2_neg(g2)), (proof, z_tau_g2)], dev)


def _decode_unique(blobs: list[bytes]) -> list:
    """``kzg._decode_g1_batch`` over the distinct encodings only (a batch
    names each blob's commitment once a cell)."""
    uniq = list(dict.fromkeys(blobs))
    pts = dict(zip(uniq, _kzg._decode_g1_batch(uniq)))
    return [pts[b] for b in blobs]


def _batch_terms(commitments, cell_ids, cells, proofs, settings, r: int | None):
    """The batch's random linear combination -> (lhs points, lhs scalars,
    proof points, r powers), or None when an input does not decode (the
    batch is then invalid).  ``r`` None draws the verifier's secret."""
    width = settings.width
    n_cells, cell_size = _cell_geometry(width)
    n = len(commitments)
    try:
        cs_pts = _decode_unique(list(commitments))
        pi_pts = _kzg._decode_g1_batch(list(proofs))
        coeffs = []
        for cid, cell in zip(cell_ids, cells):
            if not 0 <= int(cid) < n_cells:
                return None
            coeffs.append(_interpolation_coeffs(cell, int(cid), settings))
    except (ValueError, KzgError):
        return None
    if r is None:
        seed = hashlib.sha256(
            b"LHTPU_RLC_CELL_BATCH_" + width.to_bytes(16, "big") + n.to_bytes(16, "big")
            + b"".join(commitments) + b"".join(proofs)
            + b"".join(int(c).to_bytes(8, "big") for c in cell_ids)
            + secrets.token_bytes(32)).digest()
        r = int.from_bytes(seed, "big") % BLS_MODULUS
    r_list = _powers(r, n + 1)[1:]
    mono_scalars = [0] * cell_size
    pi_scalars = []
    for ri, cid, cf in zip(r_list, cell_ids, coeffs):
        for m, cm in enumerate(cf):
            mono_scalars[m] = (mono_scalars[m] - ri * cm) % BLS_MODULUS
        pi_scalars.append(ri * _coset_vanishing_constant(int(cid), width) % BLS_MODULUS)
    lhs_points = list(cs_pts) + list(pi_pts) + list(settings.g1_monomial[:cell_size])
    return lhs_points, list(r_list) + pi_scalars + mono_scalars, pi_pts, r_list


def verify_cell_kzg_proof_batch(commitments: list[bytes], cell_ids: list[int], cells: list[bytes],
                                proofs: list[bytes], settings, device=None, *,
                                ledger: dict | None = None, r: int | None = None) -> bool:
    """Every (commitment, cell id, cell, proof) holds.  With 8 cells or
    more, one check by a random linear combination: each cell's
    e(C_i − I_i, −G₂)·e(π_i, (τ^cs − a_i)G₂) == 1 (a_i = h_i^cs) rewrites as
    e(C_i − I_i + a_i·π_i, −G₂)·e(π_i, τ^cs·G₂) == 1, so with r_i = r^(i+1)

      e(Σ r_i(C_i − I_i + a_i·π_i), −G₂) · e(Σ r_i·π_i, τ^cs·G₂) == 1,

    row 14 with ``g2_monomial[cell_size]`` in the second slot; the I_i fold
    onto the monomial points with the aggregated scalars −Σ_i r_i·coeff_im
    (cs lanes in all).  Fewer cells take ``verify_cell_kzg_proof`` each.
    With ``ledger``, seconds under ``host`` (decoding, interpolation and
    scalars), ``lanes``, ``fused`` (row 14) and ``final_exp``.  Tests only:
    ``r`` replaces the verifier's secret scalar."""
    dev = resolve_device(device)
    n = len(commitments)
    if not (n == len(cell_ids) == len(cells) == len(proofs)):
        return False
    if n < _BATCH_MIN_CELLS:
        return all(verify_cell_kzg_proof(c, cid, cell, pf, settings, dev)
                   for c, cid, cell, pf in zip(commitments, cell_ids, cells, proofs))
    t0 = time.perf_counter()
    try:
        _require_monomials(settings, _cell_geometry(settings.width)[1])
    except KzgError:
        return False
    terms = _batch_terms(commitments, cell_ids, cells, proofs, settings, r)
    if terms is None:
        return False
    t0 = _add(ledger, "host", t0, dev)
    try:
        lanes = _kzg.fused_lanes(*terms, dev)
    except KzgError:
        return False
    xq, yq = settings.g2_rows(dev, settings.g2_monomial[_cell_geometry(settings.width)[1]])
    t0 = _add(ledger, "lanes", t0, dev)
    f = _kzg.kzg_fused_device(*lanes, xq, yq)
    t0 = _add(ledger, "fused", t0, dev)
    ok = bls_backend.final_exp_is_one(t12.fq12_from_words(bi.to_numpy(f)), dev)
    _add(ledger, "final_exp", t0, dev)
    return ok


def verify_cells_match_blob(cells: list[bytes], cell_ids: list[int], blob: bytes,
                            settings) -> bool:
    """Check cells against the blob they claim to extend (the data-level
    check for a caller that holds the blob)."""
    n_cells, _ = _cell_geometry(settings.width)
    if len(cells) != len(cell_ids):
        return False
    if any(not 0 <= cid < n_cells for cid in cell_ids):
        return False
    expected = compute_cells(blob, settings)
    return all(expected[cid] == cell for cid, cell in zip(cell_ids, cells))


__all__ = [
    "CELLS_PER_EXT_BLOB",
    "cells_to_blob",
    "compute_cells",
    "recover_all_cells",
    "verify_cells_match_blob",
]
