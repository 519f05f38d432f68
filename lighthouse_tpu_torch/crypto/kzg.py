"""KZG polynomial commitments for EIP-4844 blobs (Deneb) on the card.

Port of ``lighthouse_tpu/crypto/kzg.py``: the math of the consensus specs'
polynomial-commitments.md over the port's BLS12-381 core.  Entry points run on ``cuda`` unless ``device="cpu"`` is
passed (the plain versions).

Routing, as in the JAX package:

- commitments and proofs are MSMs over the Lagrange setup points
  (``g1_lincomb`` -> ``ops/msm.msm_g1``): row 13 on the card at 256
  lanes or more (a 4096-wide blob), the native host seam below;
- ``verify_blob_kzg_proof_batch`` folds n proofs into one 2-pairing check
  by a random linear combination (the verifier-local scalar r).  Batches of
  at least ``_DEVICE_EVAL_MIN`` blobs take the FUSED plane: the blobs'
  canonicity checked in numpy, every barycentric evaluation on the card
  (rows 16 then 15, ``ops/fr.py``), both RLC MSMs and the pairing in one
  chain of launches with no host crossing (row 14, ``kzg_fused_device``:
  the folded points enter the Miller loop in Jacobian form).  Smaller
  batches, a Deneb block's at most 6 blobs, take the unfused path: host
  evaluations, ``g1_lincomb`` and ``_pairing_check`` (row 10, plus row 13
  for an MSM of 256 lanes or more);
- single proofs (``verify_kzg_proof``, ``verify_blob_kzg_proof``) run one
  multi-pairing (row 10);
- ``KzgSettings.load_trusted_setup(source, validate=True)``, which every
  Deneb node runs at startup, checks every G1 setup point's membership on
  the card (row 12, ``bls_backend.batch_subgroup_check_g1``).

Host work: G1 decompression and membership (native, batched), the
Fiat-Shamir challenges (hashlib), r and its powers (``secrets``), lane
packing, and the final exponentiation (``csrc/bls_host.cc``).  Nothing
falls back: a failed build or launch raises.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import time
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import R as BLS_MODULUS
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_backend, bls_cuda, ec, fr, msm, native_bls

BYTES_PER_FIELD_ELEMENT = 32
KZG_ENDIANNESS = "big"
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
PRIMITIVE_ROOT_OF_UNITY = 7

# below this many blobs the batch takes the unfused path (kzg.py:366 of the
# JAX package)
_DEVICE_EVAL_MIN = 8


class KzgError(ValueError):
    pass


def _bit_reversal_permutation(values: list) -> list:
    n = len(values)
    bits = n.bit_length() - 1
    assert 1 << bits == n, "length must be a power of two"
    return [values[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


def _compute_roots_of_unity(order: int) -> list[int]:
    root = pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // order, BLS_MODULUS)
    assert pow(root, order, BLS_MODULUS) == 1
    assert pow(root, order // 2, BLS_MODULUS) != 1
    out = [1]
    for _ in range(order - 1):
        out.append(out[-1] * root % BLS_MODULUS)
    return out


@dataclass
class KzgSettings:
    """Trusted setup in Lagrange form (bit-reversed order, like the spec).

    g1_lagrange_brp[i] = L_brp(i)(τ)·G1;  g2_tau = τ·G2.  A ceremony load
    also keeps the monomial points (``g1_monomial`` when the file has them,
    ``g2_monomial`` = [τ^i]·G2), which wait for a ported consumer (DAS)."""

    width: int
    g1_lagrange_brp: list          # affine G1 points (int pairs)
    g2_tau: object                 # τ·G2 (affine Fq2 point)
    roots_brp: list[int]
    _g2_rows: dict = field(default_factory=dict, repr=False, compare=False)
    g1_monomial: list | None = field(default=None, repr=False, compare=False)
    g2_monomial: list | None = field(default=None, repr=False, compare=False)

    @staticmethod
    @lru_cache(maxsize=4)
    def dev(width: int = 16, tau: int = 0x123456789ABCDEF, device=None) -> "KzgSettings":
        """INSECURE dev setup from a known τ (tests and benchmarks only):
        the Lagrange points and τ·G2 of the JAX package's ``KzgSettings.dev``,
        computed as one scalar multiple of the generator per lane
        (``msm.lincomb_per_point``: row 13 on ``device`` at 256 lanes or
        more, the native host seam below) instead of one Python scalar
        multiplication each."""
        device = resolve_device(device)
        roots_brp = _bit_reversal_permutation(_compute_roots_of_unity(width))
        tau_pow = pow(tau, width, BLS_MODULUS)
        lagrange_k = []
        for w_i in roots_brp:
            # L_i(τ) = w_i·(τ^n − 1) / (n·(τ − w_i))
            num = w_i * (tau_pow - 1) % BLS_MODULUS
            den = width * (tau - w_i) % BLS_MODULUS
            lagrange_k.append(num * pow(den, -1, BLS_MODULUS) % BLS_MODULUS)
        lagrange = msm.lincomb_per_point([cv.g1_generator()] * width, lagrange_k, device=device)
        g2_tau = msm.host_lincomb_groups_g2([cv.g2_generator()], [tau], None, 1)[0]
        return KzgSettings(width, lagrange, g2_tau, roots_brp)

    @staticmethod
    def from_setup_points(g1_lagrange_brp: list, g2_tau) -> "KzgSettings":
        """Wrap externally loaded ceremony points (already bit-reversed)."""
        width = len(g1_lagrange_brp)
        return KzgSettings(width, list(g1_lagrange_brp), g2_tau,
                           _bit_reversal_permutation(_compute_roots_of_unity(width)))

    @staticmethod
    def load_trusted_setup(source, validate: bool = True, device=None) -> "KzgSettings":
        """Load the ceremony output (the consensus specs'
        ``trusted_setup_4096.json`` format: ``g1_lagrange`` in natural order
        and ``g2_monomial``, compressed hex) from a dict or a JSON file.

        Checks the power-of-two width and that ``g2_monomial[0]`` is the G2
        generator.  With ``validate=True`` every G1 point (lagrange, then
        monomial when present) passes the batched membership test on
        ``device`` (row 12; ``cuda`` unless ``"cpu"``), and a failure raises
        ``KzgError`` naming the first bad index; with ``validate=False``
        only ``g1_lagrange[0]`` is checked, on the host.  The lagrange
        points are then bit-reversal permuted, as c-kzg does."""
        if isinstance(source, dict):
            d = source
        else:
            with open(source) as f:
                d = json.load(f)
        n = len(d.get("g1_lagrange", ()))
        if n == 0 or n & (n - 1):
            raise KzgError(f"g1_lagrange length {n} is not a power of two "
                           "(truncated trusted-setup file?)")

        def hexes(key):
            return [bytes.fromhex(h.removeprefix("0x")) for h in d[key]]

        def g1_points(blobs, what):
            out = native_bls.g1_decompress_batch(blobs)    # no membership check
            for i, p in enumerate(out):
                if p is None:
                    raise KzgError(f"{what}[{i}] is not a compressed G1 point")
                if p == native_bls.G1_INF:
                    out[i] = cv.INF
            return out

        g1 = g1_points(hexes("g1_lagrange"), "g1_lagrange")
        g1_monomial = (g1_points(hexes("g1_monomial"), "g1_monomial")
                       if "g1_monomial" in d else None)
        g2_raw = hexes("g2_monomial")
        g2_monomial = [cv.g2_from_bytes(b) for b in g2_raw]
        if g2_raw[0] != cv.g2_to_bytes(cv.g2_generator()):
            raise KzgError("g2_monomial[0] is not the G2 generator")
        if validate:
            pts = g1 if g1_monomial is None else g1 + g1_monomial
            ok = np.zeros(len(pts), bool)
            finite = [i for i, p in enumerate(pts) if p is not cv.INF]
            ok[finite] = bls_backend.batch_subgroup_check_g1([pts[i] for i in finite], device)
            if not ok.all():
                bad = np.nonzero(~ok)[0]
                raise KzgError(f"{bad.size} trusted-setup G1 points fail the subgroup check "
                               f"(first: index {int(bad[0])} of lagrange+monomial)")
        elif g1[0] is cv.INF or not cv.g1_in_subgroup(g1[0]):
            raise KzgError("g1_lagrange[0] fails the subgroup check")
        s = KzgSettings.from_setup_points(_bit_reversal_permutation(g1), g2_monomial[1])
        s.g1_monomial = g1_monomial
        s.g2_monomial = g2_monomial
        return s

    def g2_rows(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(−G2, τ·G2) as Montgomery words (xq, yq int32 [2, 2, 12]) on
        ``device``: the fused check's Q lanes, packed once per device."""
        key = str(device)
        rows = self._g2_rows.get(key)
        if rows is None:
            rows = ec.g2_words([cv.g2_neg(cv.g2_generator()), self.g2_tau], device)
            self._g2_rows[key] = rows
        return rows


# --- field element / blob codecs -------------------------------------------

def bytes_to_bls_field(b: bytes) -> int:
    v = int.from_bytes(b, KZG_ENDIANNESS)
    if v >= BLS_MODULUS:
        raise KzgError("field element not canonical")
    return v


def bls_field_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)


def blob_to_polynomial(blob: bytes, settings: KzgSettings) -> list[int]:
    if len(blob) != settings.width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {settings.width} field elements")
    return [bytes_to_bls_field(blob[i:i + 32]) for i in range(0, len(blob), 32)]


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % BLS_MODULUS


def compute_challenge(blob: bytes, commitment: bytes, settings: KzgSettings) -> int:
    degree = settings.width.to_bytes(16, KZG_ENDIANNESS)
    return hash_to_bls_field(FIAT_SHAMIR_PROTOCOL_DOMAIN + degree + blob + commitment)


def _decode_g1_batch(blobs: list[bytes]) -> list:
    """Compressed G1 points -> affine points (``cv.INF`` for the identity)
    with the subgroup check, in two native calls; raises KzgError on an
    invalid encoding or a point outside G1."""
    if any(len(b) != 48 for b in blobs):
        raise KzgError("G1 compressed point must be 48 bytes")
    pts = native_bls.g1_decompress_batch(blobs)
    if any(p is None for p in pts):
        raise KzgError("invalid G1 compressed point")
    pts = [cv.INF if p == native_bls.G1_INF else p for p in pts]
    finite = [p for p in pts if p is not cv.INF]
    if not all(v == 1 for v in native_bls.g1_in_subgroup_batch(finite)):
        raise KzgError("G1 point not in subgroup")
    return pts


# --- MSM --------------------------------------------------------------------

def g1_lincomb(points, scalars, *, device=None, pad_to: int | None = None):
    """Σ k_i·P_i (the c-kzg g1_lincomb seam) through ``ops/msm.msm_g1``:
    row 13 on ``device`` at 256 lanes or more, the native host seam below."""
    return msm.msm_g1(points, scalars, device=device, pad_to=pad_to)


# --- core KZG ---------------------------------------------------------------

def blob_to_kzg_commitment(blob: bytes, settings: KzgSettings, device=None) -> bytes:
    dev = resolve_device(device)
    poly = blob_to_polynomial(blob, settings)
    return cv.g1_to_bytes(g1_lincomb(settings.g1_lagrange_brp, poly, device=dev))


def _batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery batch inversion: one modular inverse + 3(n-1) products."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % BLS_MODULUS
    inv = pow(prefix[-1], -1, BLS_MODULUS)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % BLS_MODULUS
        inv = inv * vals[i] % BLS_MODULUS
    return out


def evaluate_polynomial_in_evaluation_form(poly: list[int], z: int,
                                           settings: KzgSettings) -> int:
    """Barycentric evaluation over the bit-reversed domain, on the host (the
    oracle of row 15, and the unfused path's evaluation)."""
    width = settings.width
    roots = settings.roots_brp
    if z in roots:
        return poly[roots.index(z)]
    inv_width = pow(width, -1, BLS_MODULUS)
    invs = _batch_inverse([(z - w_i) % BLS_MODULUS for w_i in roots])
    total = 0
    for p_i, w_i, d_i in zip(poly, roots, invs):
        total += p_i * w_i % BLS_MODULUS * d_i
    total %= BLS_MODULUS
    return total * (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS * inv_width % BLS_MODULUS


def compute_kzg_proof_impl(poly: list[int], z: int, settings: KzgSettings,
                           device=None) -> tuple[bytes, int]:
    """Proof that p(z) = y: quotient commitment [q(τ)]G1 in Lagrange form."""
    y = evaluate_polynomial_in_evaluation_form(poly, z, settings)
    roots = settings.roots_brp
    q = [0] * settings.width
    if z in roots:
        m = roots.index(z)
        for i, (p_i, w_i) in enumerate(zip(poly, roots)):
            if i == m:
                continue
            # q_i = (p_i − y)/(w_i − z); q_m = Σ_i≠m (p_i − y)·w_i/(z·(z − w_i))
            q[i] = (p_i - y) * pow((w_i - z) % BLS_MODULUS, -1, BLS_MODULUS) % BLS_MODULUS
            q[m] += (p_i - y) * w_i % BLS_MODULUS * pow(z * (z - w_i) % BLS_MODULUS, -1,
                                                         BLS_MODULUS)
            q[m] %= BLS_MODULUS
    else:
        invs = _batch_inverse([(w_i - z) % BLS_MODULUS for w_i in roots])
        for i, (p_i, d_i) in enumerate(zip(poly, invs)):
            q[i] = (p_i - y) * d_i % BLS_MODULUS
    proof = cv.g1_to_bytes(g1_lincomb(settings.g1_lagrange_brp, q, device=device))
    return proof, y


def compute_kzg_proof(blob: bytes, z_bytes: bytes, settings: KzgSettings,
                      device=None) -> tuple[bytes, bytes]:
    device = resolve_device(device)
    poly = blob_to_polynomial(blob, settings)
    proof, y = compute_kzg_proof_impl(poly, bytes_to_bls_field(z_bytes), settings, device)
    return proof, bls_field_to_bytes(y)


def compute_blob_kzg_proof(blob: bytes, commitment: bytes, settings: KzgSettings,
                           device=None) -> bytes:
    device = resolve_device(device)
    poly = blob_to_polynomial(blob, settings)
    z = compute_challenge(blob, commitment, settings)
    return compute_kzg_proof_impl(poly, z, settings, device)[0]


def _pairing_check(pairs, device) -> bool:
    return t12.multi_pairing_device(pairs, device).is_one()


def verify_kzg_proof_impl(commitment, z: int, y: int, proof, settings: KzgSettings,
                          device=None) -> bool:
    """e(C − y·G1, −G2) · e(π, τ·G2 − z·G2) == 1 (row 10)."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    p_minus_y = (cv.g1_add(commitment, cv.g1_neg(msm.host_lincomb_groups([g1], [y], None, 1)[0]))
                 if y else commitment)
    tau_minus_z = (cv.g2_add(settings.g2_tau,
                             cv.g2_neg(msm.host_lincomb_groups_g2([g2], [z], None, 1)[0]))
                   if z else settings.g2_tau)
    return _pairing_check([(p_minus_y, cv.g2_neg(g2)), (proof, tau_minus_z)], device)


def verify_kzg_proof(commitment_bytes: bytes, z_bytes: bytes, y_bytes: bytes,
                     proof_bytes: bytes, settings: KzgSettings, device=None) -> bool:
    dev = resolve_device(device)
    try:
        c, pi = _decode_g1_batch([commitment_bytes, proof_bytes])
        z = bytes_to_bls_field(z_bytes)
        y = bytes_to_bls_field(y_bytes)
    except (ValueError, KzgError):
        return False
    return verify_kzg_proof_impl(c, z, y, pi, settings, dev)


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, proof_bytes: bytes,
                          settings: KzgSettings, device=None) -> bool:
    dev = resolve_device(device)
    try:
        c, pi = _decode_g1_batch([commitment_bytes, proof_bytes])
        poly = blob_to_polynomial(blob, settings)
    except (ValueError, KzgError):
        return False
    z = compute_challenge(blob, commitment_bytes, settings)
    y = evaluate_polynomial_in_evaluation_form(poly, z, settings)
    return verify_kzg_proof_impl(c, z, y, pi, settings, dev)


def _blob_fields_canonical(raw: np.ndarray) -> bool:
    """Vectorized canonicity check of [N, W, 32] big-endian field bytes
    (< BLS_MODULUS)."""
    words = np.ascontiguousarray(raw).reshape(-1, 32).view(">u8")
    m = np.frombuffer(BLS_MODULUS.to_bytes(32, "big"), ">u8")
    lt = words < m
    eq = words == m
    ok = lt[:, 0] | (eq[:, 0] & (lt[:, 1] | (eq[:, 1] & (lt[:, 2] | (eq[:, 2] & lt[:, 3])))))
    return bool(ok.all())


# --------------------------------------------------------------------------
# row 14: both RLC MSMs and the 2-lane pairing, one chain of launches
# --------------------------------------------------------------------------

def kzg_fused_plain(xs, ys, digits, xq, yq) -> torch.Tensor:
    """Plain version of ``kzg_fused_device`` (int32 words in, Fq12 row
    [1, 12, 12] out)."""
    X, Y, Z = msm.fold_segments_g1(bi.u64(xs), bi.u64(ys), digits.to(torch.int64), 2)
    ok = ~bi.is_zero(Z)
    xq, yq = bi.u64(xq), bi.u64(yq)
    f = t12.batch_miller_loop_plain(X, Y, Z, xq, yq, t12.fp2_one_like(xq))
    return bi.i32(t12.fq12_flat(t12.reduce_product_plain(f, ok)))


def kzg_fused_device(xs, ys, digits, xq, yq) -> torch.Tensor:
    """The batch check's data plane: lanes interleaved s-major (even: the
    Σ r^i·(C_i − y_i·G1 + z_i·π_i) MSM, odd: the Σ r^i·π_i MSM; xs, ys int32
    [2m, 12] affine, digits int32 [64, 2m]), one windowed scan and a
    2-segment sum, then the Miller loops of the two sums in Jacobian form
    against (−G2, τ·G2) (xq, yq int32 [2, 2, 12]), a sum at infinity masked
    to one, and their product -> Fq12 row [1, 12, 12].  Replaces
    ``lighthouse_tpu/crypto/kzg.py:437`` ``_kzg_fused``."""
    dev = msm._check_fold("kzg_fused", xs, ys, digits, 2)
    bls_cuda.check(xq, (2, 2, bi.L), "kzg_fused xq")
    bls_cuda.check(yq, (2, 2, bi.L), "kzg_fused yq")
    bls_cuda.same_device("kzg_fused", xs, xq, yq)
    if dev.type == "cpu":
        return kzg_fused_plain(xs, ys, digits, xq, yq)
    (X, Y, Z), launches = msm._fold_launch(xs, ys, digits, 2)
    mask = (Z != 0).any(-1).to(torch.uint8)
    f = torch.empty((2, 12, bi.L), dtype=torch.int32, device=dev)
    bls_cuda.launch("lh_miller", X, Y, Z, xq, yq, t12.fp2_one_like(xq).contiguous(), mask, f,
                    2, 2, -1)
    bls_cuda.launch("lh_fq12_mul_halves", f, 1)
    kzg_fused_device.launches += launches + 2
    kzg_fused_device.calls += 1
    return f[:1].clone()


kzg_fused_device.launches = 0
kzg_fused_device.calls = 0

KERNELS = (fr.fr_to_mont_device, fr.eval_device, msm.fold_device, kzg_fused_device,
           t12.miller_reduce_device)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    msm.fold_device.calls = kzg_fused_device.calls = t12.miller_reduce_device.calls = 0


def fused_lanes(lhs_points, lhs_scalars, pis, r_pows, device):
    """Host lane layout of row 14 -> (xs, ys, digits) tensors: both MSMs
    padded to m = bucket(len(lhs_points)) lanes and interleaved (even lanes
    the lhs MSM), packed by ``msm._fold_lanes`` (infinity points and zero
    scalars are identity lanes)."""
    m = msm.bucket(len(lhs_points))
    if len(pis) > m:
        raise KzgError("lane overflow")
    points, scalars = [cv.INF] * (2 * m), [0] * (2 * m)
    points[0:2 * len(lhs_points):2], scalars[0:2 * len(lhs_scalars):2] = lhs_points, lhs_scalars
    points[1:2 * len(pis):2], scalars[1:2 * len(r_pows):2] = pis, r_pows
    return msm._fold_lanes(points, scalars, 2 * m, device)


def _kzg_fused_f(lhs_points, lhs_scalars, pis, r_pows, settings, device):
    """Row 14 on ``device`` -> the Miller product as a python Fq12 (before
    the final exponentiation)."""
    f = kzg_fused_device(*fused_lanes(lhs_points, lhs_scalars, pis, r_pows, device),
                         *settings.g2_rows(device))
    return t12.fq12_from_words(bi.to_numpy(f))


# --------------------------------------------------------------------------
# batch verification
# --------------------------------------------------------------------------

def rlc_terms(cs, pis, zs, ys, r: int):
    """The random linear combination of n proofs: (lhs points, lhs scalars,
    r powers) with Σ r^i·π_i and Σ r^i·(C_i − y_i·G1 + z_i·π_i) as MSMs."""
    r_pows = [pow(r, i, BLS_MODULUS) for i in range(len(cs))]
    lhs_points = list(cs) + list(pis) + [cv.g1_generator()]
    lhs_scalars = list(r_pows) + [ri * z % BLS_MODULUS for ri, z in zip(r_pows, zs)]
    y_comb = sum(ri * y % BLS_MODULUS for ri, y in zip(r_pows, ys)) % BLS_MODULUS
    lhs_scalars.append((-y_comb) % BLS_MODULUS)
    return lhs_points, lhs_scalars, r_pows


def verify_blob_kzg_proof_batch(blobs: list[bytes], commitment_bytes_list: list[bytes],
                                proof_bytes_list: list[bytes], settings: KzgSettings,
                                device=None, *, ledger: dict | None = None) -> bool:
    """RLC-fold n blob proofs into one 2-pairing check (BASELINE config 5):
    with challenges z_i, evaluations y_i and verifier powers r^i,

      e(Σ r^i(C_i − y_i·G1 + z_i·π_i), −G2) · e(Σ r^i·π_i, τ·G2) == 1.

    Runs on ``device`` (``cuda`` unless ``device="cpu"``), fused at
    ``_DEVICE_EVAL_MIN`` blobs or more (see the module doc).  With
    ``ledger``, wall seconds per stage are added (device stages
    synchronized, so pass one only when profiling): decompress (with the
    subgroup and canonicity checks), challenges, eval, then fused and
    final_exp, or msm and pairing on the unfused path."""
    return _verify_batch(blobs, commitment_bytes_list, proof_bytes_list, settings,
                         resolve_device(device), ledger=ledger)


def _verify_batch(blobs, commitment_bytes_list, proof_bytes_list, settings, device, *,
                  ledger=None, r=None, zs=None, probe=None) -> bool:
    """The verifier.  Tests only: ``r`` replaces the secret scalar, ``zs``
    the Fiat-Shamir challenges, and ``probe`` (a dict) receives the
    evaluations and, on the fused path, the Miller product."""
    sync = (torch.cuda.synchronize if device.type == "cuda" and ledger is not None
            else (lambda: None))
    t0 = time.perf_counter()

    def mark(key, t):
        if ledger is not None:
            sync()
            now = time.perf_counter()
            ledger[key] = ledger.get(key, 0.0) + now - t
        return time.perf_counter()

    n = len(blobs)
    if not (n == len(commitment_bytes_list) == len(proof_bytes_list)):
        return False
    if n == 0:
        return True
    fused = n >= _DEVICE_EVAL_MIN
    try:
        pts = _decode_g1_batch(list(commitment_bytes_list) + list(proof_bytes_list))
        cs, pis = pts[:n], pts[n:]
        if fused:
            width = settings.width
            if any(len(b) != width * BYTES_PER_FIELD_ELEMENT for b in blobs):
                return False
            raw = np.frombuffer(bytearray(b"".join(blobs)), np.uint8).reshape(n, width, 32)
            if not _blob_fields_canonical(raw):
                return False
        else:
            polys = [blob_to_polynomial(b, settings) for b in blobs]
    except (ValueError, KzgError):
        return False
    t0 = mark("decompress", t0)
    if zs is None:
        zs = [compute_challenge(b, c, settings) for b, c in zip(blobs, commitment_bytes_list)]
    t0 = mark("challenges", t0)
    if fused:
        ys = fr.evaluate_polynomials_batch(raw, zs, settings.roots_brp, device)
    else:
        ys = [evaluate_polynomial_in_evaluation_form(p, z, settings) for p, z in zip(polys, zs)]
    t0 = mark("eval", t0)
    if r is None:
        # verifier-local random linear combination (domain-separated hash
        # seed + fresh entropy: r need only be unpredictable to the prover)
        seed = hashlib.sha256(
            RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + settings.width.to_bytes(16, KZG_ENDIANNESS)
            + n.to_bytes(16, KZG_ENDIANNESS) + b"".join(commitment_bytes_list)
            + b"".join(proof_bytes_list) + secrets.token_bytes(32)).digest()
        r = int.from_bytes(seed, "big") % BLS_MODULUS
    lhs_points, lhs_scalars, r_pows = rlc_terms(cs, pis, zs, ys, r)
    if probe is not None:
        probe["ys"] = ys
    if fused:
        try:
            f = _kzg_fused_f(lhs_points, lhs_scalars, pis, r_pows, settings, device)
        except KzgError:         # lane overflow guard: bad input -> False
            return False
        t0 = mark("fused", t0)
        if probe is not None:
            probe["f"] = f
        ok = bls_backend.final_exp_is_one(f, device)
        mark("final_exp", t0)
        return ok
    # both MSMs padded to one lane count, as the JAX package pads them
    shared_pad = 1 << max(len(lhs_points) - 1, 0).bit_length()
    proof_comb = g1_lincomb(pis, r_pows, device=device, pad_to=shared_pad)
    lhs = g1_lincomb(lhs_points, lhs_scalars, device=device, pad_to=shared_pad)
    t0 = mark("msm", t0)
    # an INF combination is legal (a constant blob's zero quotient): its
    # pair is masked to one in points_to_device
    ok = _pairing_check([(lhs, cv.g2_neg(cv.g2_generator())), (proof_comb, settings.g2_tau)],
                        device)
    mark("pairing", t0)
    return ok
