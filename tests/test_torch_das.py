"""The port's PeerDAS cells and cell proofs (``lighthouse_tpu_torch.crypto.das``)
against the JAX package's ``crypto/das.py`` and host oracles, on the CPU.

The JAX package's ``KzgSettings.dev(64)`` (128 cells of one element) and
``dev(16)`` (32 cells of one element) are carried across with
``convert.kzg_settings_from_points``.  Tier-1 compares with the JAX
package's pure-host functions (``_cell_geometry``, ``compute_cells``,
``recover_all_cells``, ``_interpolation_coeffs``) and holds proofs to
[q_c(τ)]·G1 from the JAX curve on the dev τ, and verdicts (per cell, and a
batch at a fixed r) to host pairings with the JAX curve.  The batched proof
path (row 13's plain version) is reached at width 8 by lowering
``_CELL_PROOF_FUSED_MIN_WIDTH``, and its chunks at width 16 by lowering
``_CELL_PROOF_MAX_LANES`` too.  The A/Bs
against the JAX package's proof and verify functions compile XLA programs
for minutes and are marked ``slow``; the test marked ``cuda`` holds rows
13 and 14 at the cell shapes to their plain versions on the card.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import das as jdas
from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.bls import curve as jcv
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import das, kzg
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import msm

CPU = torch.device("cpu")
R = kzg.BLS_MODULUS
TAU = 0x123456789ABCDEF
FIXED_R = 0x2C0FFEE0DDBA11F00D5EED1234567890ABCDEF0123456789ABCDEF0123


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax64():
    return jkzg.KzgSettings.dev(64)


@pytest.fixture(scope="module")
def s64(jax64):
    return convert.kzg_settings_from_points(jax64)


def _blob(width: int, seed: int) -> bytes:
    raw = np.random.default_rng(seed).integers(0, 256, (width, 32), dtype=np.uint8)
    raw[:, 0] &= 0x3F                          # canonical: below 2^254
    return raw.tobytes()


@pytest.fixture(scope="module")
def blob64(s64):
    blob = _blob(64, 7)
    return blob, kzg.blob_to_kzg_commitment(blob, s64, CPU)


@pytest.fixture(scope="module")
def proofs64(s64, blob64):
    return das.compute_cells_and_kzg_proofs(blob64[0], s64, CPU)


def _ints(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _ints2(q):
    return (int(q[0].a), int(q[0].b), int(q[1].a), int(q[1].b))


def _q_tau(blob: bytes, width: int, cid: int) -> int:
    """q_c(τ) = (p(τ) − I_c(τ)) / (τ^cs − h^cs) from the JAX package's host
    functions: p(τ) by its barycentric evaluation, I_c(τ) from its
    interpolation coefficients."""
    js = jkzg.KzgSettings.dev(width)
    _n, cs = jdas._cell_geometry(width)
    poly = jkzg.blob_to_polynomial(blob, js)
    p_tau = jkzg.evaluate_polynomial_in_evaluation_form(poly, TAU, js)
    cell = jdas.compute_cells(blob, js)[cid]
    coeffs = jdas._interpolation_coeffs(cell, cid, js)
    i_tau = sum(c * pow(TAU, m, R) for m, c in enumerate(coeffs)) % R
    ext_roots = jkzg._compute_roots_of_unity(2 * width)
    nat = jkzg._bit_reversal_permutation(list(range(2 * width)))
    a = pow(ext_roots[nat[cid * cs]], cs, R)
    return (p_tau - i_tau) * pow((pow(TAU, cs, R) - a) % R, -1, R) % R


def _proof_oracle(blob: bytes, width: int, cid: int) -> bytes:
    return jcv.g1_to_bytes(jcv.g1_mul(jcv.g1_generator(), _q_tau(blob, width, cid)))


def _jax_pair_cell(commitment: bytes, cid: int, cell: bytes, proof: bytes, js) -> bool:
    """The per-cell pairing equation with the JAX curve on the host."""
    _n, cs = jdas._cell_geometry(js.width)
    try:
        c = jcv.g1_from_bytes(commitment)
        pi = jcv.g1_from_bytes(proof)
        coeffs = jdas._interpolation_coeffs(cell, cid, js)
    except (ValueError, jkzg.KzgError):
        return False
    interp = jcv.INF
    for m, k in enumerate(coeffs):
        if k:
            interp = jcv.g1_add(interp, jcv.g1_mul(js.g1_monomial[m], k))
    ext_roots = jkzg._compute_roots_of_unity(2 * js.width)
    nat = jkzg._bit_reversal_permutation(list(range(2 * js.width)))
    a = pow(ext_roots[nat[cid * cs]], cs, R)
    g2 = jcv.g2_generator()
    z_g2 = jcv.g2_add(js.g2_monomial[cs], jcv.g2_neg(jcv.g2_mul(g2, a)))
    lhs = jcv.g1_add(c, jcv.g1_neg(interp)) if interp is not jcv.INF else c
    return jcv.multi_pairing([(lhs, jcv.g2_neg(g2)), (pi, z_g2)]).is_one()


def _batch_oracle(commitments, cids, cells, proofs, js, r: int) -> bool:
    """The batch's random linear combination at ``r`` on the host with the
    JAX curve: e(Σ r_i(C_i − I_i + a_i·π_i), −G2) · e(Σ r_i·π_i, τ^cs·G2)."""
    _n, cs = jdas._cell_geometry(js.width)
    ext_roots = jkzg._compute_roots_of_unity(2 * js.width)
    nat = jkzg._bit_reversal_permutation(list(range(2 * js.width)))
    lhs, rhs = jcv.INF, jcv.INF
    for i, (cb, cid, cell, pb) in enumerate(zip(commitments, cids, cells, proofs)):
        ri = pow(r, i + 1, R)
        c, pi = jcv.g1_from_bytes(cb), jcv.g1_from_bytes(pb)
        a = pow(ext_roots[nat[cid * cs]], cs, R)
        lhs = jcv.g1_add(lhs, jcv.g1_mul(c, ri))
        lhs = jcv.g1_add(lhs, jcv.g1_mul(pi, ri * a % R))
        for m, k in enumerate(jdas._interpolation_coeffs(cell, cid, js)):
            if k:
                lhs = jcv.g1_add(lhs, jcv.g1_mul(js.g1_monomial[m], (-ri * k) % R))
        rhs = jcv.g1_add(rhs, jcv.g1_mul(pi, ri))
    g2 = jcv.g2_generator()
    return jcv.multi_pairing([(lhs, jcv.g2_neg(g2)), (rhs, js.g2_monomial[cs])]).is_one()


# -- the setup and the host functions -------------------------------------------

def test_dev_setup_carries_the_monomials(s64, jax64):
    port = kzg.KzgSettings.dev(64, device="cpu")
    assert len(port.g1_monomial) == 64 and len(port.g2_monomial) == 65
    assert [_ints(p) for p in port.g1_monomial] == [_ints(p) for p in jax64.g1_monomial]
    assert [_ints2(q) for q in port.g2_monomial] == [_ints2(q) for q in jax64.g2_monomial]
    assert [_ints2(q) for q in s64.g2_monomial] == [_ints2(q) for q in jax64.g2_monomial]
    assert port.g1_lagrange_brp == s64.g1_lagrange_brp and _ints2(port.g2_tau) == _ints2(s64.g2_tau)
    # dev(16): τ^i·G2 for i <= 16 only, as the JAX setup counts them
    assert len(kzg.KzgSettings.dev(16, device="cpu").g2_monomial) == 17


def test_g2_rows_are_packed_per_point(s64):
    """The blob path's (−G2, τ·G2) and the cell path's (−G2, τ^cs·G2) are
    cached apart; the same point finds its own rows again."""
    blob_rows = s64.g2_rows(CPU)
    cell_rows = s64.g2_rows(CPU, s64.g2_monomial[2])
    assert s64.g2_rows(CPU) is blob_rows and s64.g2_rows(CPU, s64.g2_monomial[2]) is cell_rows
    assert s64.g2_rows(CPU, s64.g2_monomial[1]) is blob_rows       # τ·G2 itself
    want = kzg.ec.g2_words([s64.g2_monomial[2]], CPU)
    assert torch.equal(cell_rows[0][1], want[0][0]) and torch.equal(cell_rows[1][1], want[1][0])
    assert torch.equal(cell_rows[0][0], blob_rows[0][0])             # −G2 in both
    assert not torch.equal(cell_rows[0][1], blob_rows[0][1])


@pytest.mark.parametrize("width", [1, 2, 16, 64, 128, 4096])
def test_cell_geometry_equals_jax(width):
    assert das._cell_geometry(width) == jdas._cell_geometry(width)


def test_cells_and_blob_equal_jax(s64, jax64):
    for seed in (1, 2):
        blob = _blob(64, seed)
        cells = das.compute_cells(blob, s64)
        assert cells == jdas.compute_cells(blob, jax64)
        assert das.cells_to_blob(cells, s64) == jdas.cells_to_blob(cells, jax64) == blob
        assert das.verify_cells_match_blob(cells[3:9], list(range(3, 9)), blob, s64)
        assert not das.verify_cells_match_blob(cells[3:9], list(range(4, 10)), blob, s64)
    with pytest.raises(kzg.KzgError, match="need all 128 cells, got 127"):
        das.cells_to_blob(cells[1:], s64)


def test_interpolation_coefficients_equal_jax(s64, jax64):
    blob = _blob(64, 3)
    cells = das.compute_cells(blob, s64)
    for cid in (0, 1, 77, 127):
        assert das._interpolation_coeffs(cells[cid], cid, s64) == \
            jdas._interpolation_coeffs(cells[cid], cid, jax64)
    # a 4-element cell (width 256: 128 cells of 4 over 512 points), on
    # arbitrary values
    wide_p = kzg.KzgSettings(256, [], None, [])
    wide_j = jkzg.KzgSettings(256, [], None, [])
    rng = np.random.default_rng(4)
    for cid in (0, 5, 127):
        cell = b"".join(int(rng.integers(0, 2**62)).to_bytes(32, "big") for _ in range(4))
        assert das._interpolation_coeffs(cell, cid, wide_p) == \
            jdas._interpolation_coeffs(cell, cid, wide_j)


@pytest.mark.parametrize("pick", ["even", "first_half", "random_64", "random_100"])
def test_recovery_equals_jax(s64, jax64, pick):
    blob = _blob(64, 5)
    cells = das.compute_cells(blob, s64)
    rng = np.random.default_rng(6)
    ids = {"even": list(range(0, 128, 2)), "first_half": list(range(64)),
           "random_64": sorted(rng.choice(128, 64, replace=False).tolist()),
           "random_100": rng.choice(128, 100, replace=False).tolist()}[pick]
    got = das.recover_all_cells(ids, [cells[i] for i in ids], s64)
    assert got == jdas.recover_all_cells(ids, [cells[i] for i in ids], jax64) == cells


def _raised(fn):
    try:
        fn()
    except kzg.KzgError as e:
        return str(e)
    except jkzg.KzgError as e:
        return str(e)
    return None


def test_recovery_errors_carry_the_jax_messages(s64, jax64):
    cells = das.compute_cells(_blob(64, 8), s64)
    bad = bytearray(cells[3])
    bad[-1] ^= 1
    cases = [
        (list(range(63)), [cells[i] for i in range(63)]),                  # too few
        (list(range(65)), [cells[i] for i in range(64)]),                  # lengths
        ([0] + list(range(64)), [cells[0]] + cells[:64]),                  # duplicate
        (list(range(63)) + [128], cells[:64]),                             # out of range
        (list(range(65)), cells[:3] + [bytes(bad)] + cells[4:65]),         # corrupted
        (list(range(64)), cells[:63] + [cells[63][:-1]]),                  # cell size
        (list(range(64)), cells[:63] + [b"\xff" * 32]),                    # not canonical
    ]
    msgs = []
    for ids, cs in cases:
        mine = _raised(lambda: das.recover_all_cells(ids, cs, s64))
        theirs = _raised(lambda: jdas.recover_all_cells(ids, cs, jax64))
        assert mine is not None and mine == theirs
        msgs.append(mine)
    assert msgs[0] == "need at least 64 cells, got 63"
    assert msgs[4] in ("cell 3 inconsistent with recovery",
                       "recovered polynomial exceeds blob degree (inconsistent cells)")


# -- proofs -----------------------------------------------------------------------

def test_proofs_equal_q_tau_times_g1(s64, blob64, proofs64):
    blob, _c = blob64
    cells, proofs = proofs64
    assert cells == das.compute_cells(blob, s64)
    for cid in (0, 1, 64, 127):
        assert proofs[cid] == _proof_oracle(blob, 64, cid)


def test_batched_proofs_equal_the_per_cell_path(monkeypatch):
    """Width 8 (16 cells, quotients of 7 coefficients in 8 segments' worth
    of lanes): with the thresholds lowered, one chunk of 128 lanes through
    row 13's plain version gives the per-cell path's proofs."""
    js = jkzg.KzgSettings.dev(8)
    s8 = convert.kzg_settings_from_points(js)
    blob = _blob(8, 9)
    cells, per_cell = das.compute_cells_and_kzg_proofs(blob, s8, CPU)
    monkeypatch.setattr(das, "_CELL_PROOF_FUSED_MIN_WIDTH", 8)
    calls = []
    real = msm.fold_plain
    monkeypatch.setattr(msm, "fold_plain", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    ledger: dict = {}
    cells2, batched = das.compute_cells_and_kzg_proofs(blob, s8, CPU, ledger=ledger)
    assert calls == [128]
    assert set(ledger) == {"host", "lanes", "fold", "affine"}
    assert cells2 == cells and batched == per_cell
    assert [batched[c] for c in (0, 9, 15)] == [_proof_oracle(blob, 8, c) for c in (0, 9, 15)]


@pytest.mark.parametrize("max_lanes,chunks", [(256, [(256, 16)] * 2), (100, [(64, 4)] * 8),
                                              (8, [(16, 1)] * 32)])
def test_batched_proofs_chunk_by_the_lane_cap(monkeypatch, max_lanes, chunks):
    """The chunk is the lane cap over the segment's lanes, floored to a
    power of two (at least one cell): the row 13 calls' lanes and
    segments."""
    s16 = convert.kzg_settings_from_points(jkzg.KzgSettings.dev(16))
    monkeypatch.setattr(das, "_CELL_PROOF_FUSED_MIN_WIDTH", 16)
    monkeypatch.setattr(das, "_CELL_PROOF_MAX_LANES", max_lanes)
    calls = []

    def fold(xs, ys, digits, n_segments):
        calls.append((xs.shape[0], n_segments))
        z = torch.zeros((n_segments, bi.L), dtype=torch.int32)
        return z, z, z

    monkeypatch.setattr(msm, "fold_device", fold)
    _cells, proofs = das.compute_cells_and_kzg_proofs(_blob(16, 9), s16, CPU)
    assert calls == chunks and len(proofs) == 32


def test_cell_proof_lanes_layout():
    """Lane s·g_pad + g holds point s under cell g's coefficient s; zero
    coefficients and missing points are identity lanes."""
    seg, L = 4, bi.L
    mono_x = np.arange(seg * L, dtype=np.uint32).reshape(seg, L) + 1
    mono_y = mono_x + 1000
    live = np.array([True, True, True, False])
    qs = [[5, 0, 7, 9], [0, 2**255 - 1, 3, 4], [1, 1, 1, 1]]
    xs, ys, digits, g_pad = das.cell_proof_lanes(qs, mono_x, mono_y, live, seg)
    assert g_pad == 4 and xs.shape == (16, L) and digits.shape == (64, 16)
    want = msm.ec.scalars_to_digits(
        [qs[g][s] if g < 3 and live[s] else 0 for s in range(seg) for g in range(4)], 256)
    assert np.array_equal(digits, want)
    for s in range(seg):
        for g in range(4):
            k = qs[g][s] if g < 3 and live[s] else 0
            assert np.array_equal(xs[s * 4 + g], mono_x[s] if k else np.zeros(L, np.uint32))
            assert np.array_equal(ys[s * 4 + g], mono_y[s] if k else np.zeros(L, np.uint32))


# -- verdicts -----------------------------------------------------------------------

def test_per_cell_verdicts_equal_the_host_pairing(s64, jax64, blob64, proofs64):
    blob, c = blob64
    cells, proofs = proofs64
    bad = bytearray(cells[5])
    bad[-1] ^= 1
    cases = [(c, 5, cells[5], proofs[5]), (c, 5, bytes(bad), proofs[5])]
    got = [das.verify_cell_kzg_proof(*x, s64, CPU) for x in cases]
    assert got == [_jax_pair_cell(*x, jax64) for x in cases] == [True, False]
    # rejected before any pairing
    assert not das.verify_cell_kzg_proof(c, 128, cells[5], proofs[5], s64, CPU)
    assert not das.verify_cell_kzg_proof(c, 5, cells[5][:-1], proofs[5], s64, CPU)
    assert not das.verify_cell_kzg_proof(c, 5, cells[5], b"\x00" * 48, s64, CPU)


@pytest.mark.parametrize("case", ["valid", "proofs_swapped"])
def test_batch_verdict_at_a_fixed_r_equals_the_host_oracle(s64, jax64, blob64, proofs64, case):
    blob, c = blob64
    cells, proofs = proofs64
    ids = [3, 9, 20, 33, 47, 64, 90, 127]
    prfs = [proofs[i] for i in ids]
    if case == "proofs_swapped":
        prfs[1], prfs[2] = prfs[2], prfs[1]
    args = ([c] * 8, ids, [cells[i] for i in ids], prfs)
    ledger: dict = {}
    got = das.verify_cell_kzg_proof_batch(*args, s64, CPU, ledger=ledger, r=FIXED_R)
    assert got == _batch_oracle(*args, jax64, FIXED_R) == (case == "valid")
    assert set(ledger) == {"host", "lanes", "fused", "final_exp"}


def test_batch_rejections_before_the_card(s64, blob64, proofs64, monkeypatch):
    """Mismatched lengths, an id out of range, a bad encoding or a cell of
    the wrong size give False without reaching row 14, and fewer than 8
    cells take the per-cell check."""
    blob, c = blob64
    cells, proofs = proofs64
    monkeypatch.setattr(kzg, "kzg_fused_device",
                        lambda *a: pytest.fail("a rejected batch reached row 14"))
    ids = list(range(8))
    base = ([c] * 8, ids, cells[:8], proofs[:8])
    assert not das.verify_cell_kzg_proof_batch(base[0], ids[:7], base[2], base[3], s64, CPU)
    assert not das.verify_cell_kzg_proof_batch(base[0], ids[:7] + [128], base[2], base[3], s64,
                                               CPU)
    assert not das.verify_cell_kzg_proof_batch(base[0], ids, base[2],
                                               base[3][:7] + [b"\x01" * 48], s64, CPU)
    assert not das.verify_cell_kzg_proof_batch(base[0], ids, base[2][:7] + [b"\x00" * 31],
                                               base[3], s64, CPU)
    seen = []
    monkeypatch.setattr(das, "verify_cell_kzg_proof",
                        lambda *a, **k: seen.append(a[1]) or True)
    assert das.verify_cell_kzg_proof_batch([c] * 7, ids[:7], cells[:7], proofs[:7], s64, CPU)
    assert seen == ids[:7]
    assert das.verify_cell_kzg_proof_batch([], [], [], [], s64, CPU)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(s64, blob64, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob, c = blob64
    with pytest.raises(RuntimeError, match="device='cpu'"):
        das.compute_cells_and_kzg_proofs(blob, s64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        das.verify_cell_kzg_proof_batch([c] * 8, list(range(8)), [b""] * 8, [b""] * 8, s64)


def test_missing_monomials_raise_the_jax_message(s64, blob64):
    bare = kzg.KzgSettings(64, s64.g1_lagrange_brp, s64.g2_tau, s64.roots_brp)
    msg = ("cell proofs need the setup's monomial points "
           "(g1_monomial/g2_monomial in the ceremony file)")
    with pytest.raises(kzg.KzgError) as e:
        das.compute_cells_and_kzg_proofs(blob64[0], bare, CPU)
    assert str(e.value) == msg
    assert not das.verify_cell_kzg_proof_batch([blob64[1]] * 8, list(range(8)), [b""] * 8,
                                               [b""] * 8, bare, CPU)


# -- A/B against the JAX package's proof and verify functions (XLA) ---------------

@pytest.mark.slow
def test_proofs_and_verdicts_equal_the_jax_functions(s64, jax64, blob64, proofs64):
    blob, c = blob64
    cells, proofs = proofs64
    assert (cells, proofs) == tuple(map(list, jdas.compute_cells_and_kzg_proofs(blob, jax64)))
    bad = bytearray(cells[5])
    bad[-1] ^= 1
    for cell in (cells[5], bytes(bad)):
        assert das.verify_cell_kzg_proof(c, 5, cell, proofs[5], s64, CPU) == \
            jdas.verify_cell_kzg_proof(c, 5, cell, proofs[5], jax64)
    ids = list(range(0, 128, 16))
    for prfs in ([proofs[i] for i in ids], [proofs[i] for i in ids[::-1]]):
        args = ([c] * 8, ids, [cells[i] for i in ids], prfs)
        assert das.verify_cell_kzg_proof_batch(*args, s64, CPU) == \
            jdas.verify_cell_kzg_proof_batch(*args, jax64)


@pytest.mark.slow
def test_batched_proofs_equal_the_jax_batched_path(monkeypatch):
    js = jkzg.KzgSettings.dev(16)
    s16 = convert.kzg_settings_from_points(js)
    blob = _blob(16, 10)
    for mod in (das, jdas):
        monkeypatch.setattr(mod, "_CELL_PROOF_FUSED_MIN_WIDTH", 16)
        monkeypatch.setattr(mod, "_CELL_PROOF_MAX_LANES", 256)
    assert das.compute_cells_and_kzg_proofs(blob, s16, CPU) == \
        tuple(map(list, jdas.compute_cells_and_kzg_proofs(blob, js)))


# -- the card ---------------------------------------------------------------------

@pytest.mark.cuda
def test_rows_13_and_14_at_the_cell_shapes_equal_plain_on_the_card():
    """Row 13 at the batched proofs' layout (width 4096: 4096 segments'
    worth of lanes, two cells' segments of a chunk) and row 14 at a 48-cell
    batch's 512 lanes with τ^64·G2, each against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    settings = kzg.KzgSettings.dev(4096, device=dev)
    blob = _blob(4096, 11)
    coeffs = das._poly_coeffs_from_blob(blob, 4096)
    qs = das._quotients(coeffs, 4096)[:2]
    seg = msm.bucket(len(qs[0]))
    mono = settings.g1_monomial[:seg]
    mx = bi.ints_to_mont_limbs([p[0] for p in mono])
    my = bi.ints_to_mont_limbs([p[1] for p in mono])
    xs, ys, digits, g_pad = das.cell_proof_lanes(qs, mx, my, np.ones(seg, bool), seg)
    args = (bi.to_tensor(xs, dev), bi.to_tensor(ys, dev),
            torch.from_numpy(digits.view(np.int32)).to(dev), g_pad)
    for got, want in zip(msm.fold_device(*args), msm.fold_plain(*args)):
        assert torch.equal(got, want)
    cells, proofs = das.compute_cells_and_kzg_proofs(blob, settings, dev)
    c = kzg.blob_to_kzg_commitment(blob, settings, dev)
    ids = list(range(0, 128, 16)) * 6
    assert das.verify_cell_kzg_proof_batch([c] * 48, ids, [cells[i] for i in ids],
                                           [proofs[i] for i in ids], settings, dev)
    cs_ = [das._interpolation_coeffs(cells[i], i, settings) for i in ids]
    lhs = [kzg.cv.g1_from_bytes(c)] * 48 + [kzg.cv.g1_from_bytes(proofs[i]) for i in ids] + \
        settings.g1_monomial[:64]
    scal = [FIXED_R * (i + 1) % R for i in range(160)]
    lanes = kzg.fused_lanes(lhs, scal, lhs[48:96], scal[:48], dev)
    assert lanes[0].shape[0] == 512 and len(cs_) == 48
    xq, yq = settings.g2_rows(dev, settings.g2_monomial[64])
    assert torch.equal(kzg.kzg_fused_device(*lanes, xq, yq), kzg.kzg_fused_plain(*lanes, xq, yq))
