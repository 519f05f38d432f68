"""The port's KZG blob verification (``lighthouse_tpu_torch.crypto.kzg``)
against the JAX package's ``crypto/kzg.py`` and a host pairing oracle, on
the JAX package's dev setup of width 16 carried across by
``convert.kzg_settings_from_points``.

Tier-1 tests run the port on the CPU (every kernel wrapper takes its plain
version) and compare with what is cheap in the JAX package: its setup, its
commitments and proofs (its MSMs take the host route at width 16) and its
host evaluations.  Verdicts are held to a host oracle: the RLC sums from the
native host lincomb, the copied ``pairing_fast`` Miller loops and the native
final exponentiation, with the same fixed r.  The verdict and Fq12 A/Bs
against the JAX package's own verifiers compile its Miller program (minutes
of XLA on the CPU) and are marked ``slow``; the oracle test stands beside
each.  ``tests/test_torch_kzg_kernels.py`` runs the batch on the card.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.pairing_fast import multi_miller_fast
from lighthouse_tpu_torch.ops import msm, native_bls

CPU = torch.device("cpu")
R = kzg.BLS_MODULUS
FIXED_R = 0x1D0B1E5A8C3F7729E0C4A5B6D7E8F90112233445566778899AABBCCDDEEFF00


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_settings():
    return jkzg.KzgSettings.dev(16)


@pytest.fixture(scope="module")
def settings(jax_settings):
    return convert.kzg_settings_from_points(jax_settings)


@pytest.fixture(scope="module")
def cell8(settings):
    return T.kzg_cell(16, 8, 1, 11, settings=settings, device="cpu")


@pytest.fixture(scope="module")
def cell3(settings):
    return T.kzg_cell(16, 3, 1, 12, settings=settings, device="cpu")


def _all_cases(cell):
    valid = dict(name="valid", blobs=cell["blobs"], commitments=cell["commitments"],
                 proofs=cell["proofs"], challenges=None, valid=True)
    return {v["name"]: v for v in [valid] + cell["variants"]}


def _oracle(case, settings, r=FIXED_R):
    """The batch verdict and GT element on the host: the RLC sums by the
    native lincomb, then pairing_fast's Miller loops and the native final
    exponentiation.  None when a point or field element fails to decode."""
    blobs, cbs, pbs = case["blobs"], case["commitments"], case["proofs"]
    try:
        cs = [cv.g1_from_bytes(b) for b in cbs]
        pis = [cv.g1_from_bytes(b) for b in pbs]
        polys = [kzg.blob_to_polynomial(b, settings) for b in blobs]
    except (ValueError, kzg.KzgError):
        return False, None
    zs = case["challenges"] or [kzg.compute_challenge(b, c, settings) for b, c in zip(blobs, cbs)]
    ys = [kzg.evaluate_polynomial_in_evaluation_form(p, z, settings) for p, z in zip(polys, zs)]
    lhs_points, lhs_scalars, r_pows = kzg.rlc_terms(cs, pis, zs, ys, r)
    lhs = msm.host_lincomb_groups(lhs_points, lhs_scalars, None, 1)[0]
    comb = msm.host_lincomb_groups(pis, r_pows, None, 1)[0]
    pairs = [(p, q) for p, q in ((lhs, cv.g2_neg(cv.g2_generator())), (comb, settings.g2_tau))
             if p is not cv.INF]
    from lighthouse_tpu_torch.crypto.bls.fields import Fq12

    gt = native_bls.final_exp(multi_miller_fast(pairs)) if pairs else Fq12.ONE
    return gt.is_one(), gt


def _port(case, settings, probe=None, r=FIXED_R):
    return kzg._verify_batch(case["blobs"], case["commitments"], case["proofs"], settings, CPU,
                             r=r, zs=case["challenges"], probe=probe)


def test_dev_setup_equals_jax_point_by_point(settings, jax_settings):
    own = kzg.KzgSettings.dev(16, device="cpu")
    assert own.roots_brp == jax_settings.roots_brp == settings.roots_brp
    assert own.g1_lagrange_brp == list(jax_settings.g1_lagrange_brp) == settings.g1_lagrange_brp
    assert own.g2_tau == settings.g2_tau
    assert cv.g2_to_bytes(own.g2_tau) == cv.g2_to_bytes(
        convert.kzg_settings_from_points(jax_settings).g2_tau)
    assert own == settings


def test_commitments_and_proofs_equal_jax(settings, jax_settings, cell3):
    uniq, cs, proofs = cell3["unique"]
    for blob, c, p in zip(uniq, cs, proofs):
        assert c == jkzg.blob_to_kzg_commitment(blob, jax_settings)
        assert p == jkzg.compute_blob_kzg_proof(blob, c, jax_settings)
    z_bytes = [kzg.bls_field_to_bytes(987654321), kzg.bls_field_to_bytes(settings.roots_brp[7])]
    for z in z_bytes:
        assert kzg.compute_kzg_proof(uniq[0], z, settings, "cpu") == \
            jkzg.compute_kzg_proof(uniq[0], z, jax_settings)
    const = (42).to_bytes(32, "big") * 16
    c = kzg.blob_to_kzg_commitment(const, settings, "cpu")
    assert c == jkzg.blob_to_kzg_commitment(const, jax_settings)
    assert kzg.compute_blob_kzg_proof(const, c, settings, "cpu") == cv.g1_to_bytes(cv.INF)


def test_batch_evaluations_equal_jax(settings, jax_settings, cell8):
    case = _all_cases(cell8)["challenge on a domain point"]
    zs = case["challenges"]
    raw = np.frombuffer(b"".join(case["blobs"]), np.uint8).reshape(8, 16, 32)
    ys = kzg.fr.evaluate_polynomials_batch(raw, zs, settings.roots_brp, "cpu")
    assert ys == [jkzg.evaluate_polynomial_in_evaluation_form(jkzg.blob_to_polynomial(b, jax_settings),
                                                              z, jax_settings)
                  for b, z in zip(case["blobs"], zs)]


@pytest.mark.parametrize("name", ["valid", "swapped proof", "constant blob, proof at infinity",
                                  "challenge on a domain point", "non-canonical element"])
def test_fused_batch_verdict_equals_the_host_oracle(settings, cell8, name):
    """n = 8 takes the fused plane (rows 16, 15, 14); the swapped proof also
    compares the GT element: the Miller product of the fused plane after the
    final exponentiation equals the host oracle's."""
    case = _all_cases(cell8)[name]
    probe = {}
    got = _port(case, settings, probe)
    want, gt = _oracle(case, settings)
    assert got == want == case["valid"]
    if name == "swapped proof":
        assert native_bls.final_exp(probe["f"]) == gt and not gt.is_one()


@pytest.mark.parametrize("name", ["valid", "changed blob element", "another blob's commitment"])
def test_unfused_batch_verdict_equals_the_host_oracle(settings, cell3, name):
    """n = 3 takes the unfused path: host evaluations and MSMs, row 10."""
    case = _all_cases(cell3)[name]
    assert _port(case, settings) == _oracle(case, settings)[0] == case["valid"]


def test_block_of_six_blobs_and_wrong_lengths(settings):
    cell6 = T.kzg_cell(16, 6, 1, 13, settings=settings, device="cpu")
    case = _all_cases(cell6)["valid"]
    assert kzg.verify_blob_kzg_proof_batch(case["blobs"], case["commitments"], case["proofs"],
                                           settings, "cpu")
    assert _oracle(case, settings)[0]
    assert not kzg.verify_blob_kzg_proof_batch(case["blobs"][:2], case["commitments"],
                                               case["proofs"], settings, "cpu")
    assert kzg.verify_blob_kzg_proof_batch([], [], [], settings, "cpu")


def test_single_proof_verifiers(settings, cell3):
    uniq, cs, proofs = cell3["unique"]
    assert kzg.verify_blob_kzg_proof(uniq[0], cs[0], proofs[0], settings, "cpu")
    z = kzg.bls_field_to_bytes(settings.roots_brp[3])
    proof, y = kzg.compute_kzg_proof(uniq[2], z, settings, "cpu")
    y_bad = kzg.bls_field_to_bytes((kzg.bytes_to_bls_field(y) + 1) % R)
    assert not kzg.verify_kzg_proof(cs[2], z, y_bad, proof, settings, "cpu")
    assert not kzg.verify_kzg_proof(cs[2], z, y, b"\x00" * 48, settings, "cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(settings, cell3, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uniq, cs, proofs = cell3["unique"]
    for call in (lambda: kzg.blob_to_kzg_commitment(uniq[0], settings),
                 lambda: kzg.verify_blob_kzg_proof_batch(uniq, cs, proofs, settings),
                 lambda: kzg.verify_blob_kzg_proof(uniq[0], cs[0], proofs[0], settings),
                 lambda: kzg.KzgSettings.dev(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------
# A/B against the JAX package's own verifiers (its Miller program compiles)
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_verdicts_equal_the_jax_verifiers(settings, jax_settings, cell8, cell3):
    for cell in (cell8, cell3):
        for name, case in _all_cases(cell).items():
            if case["challenges"] is not None:
                continue                       # the JAX verifier hashes its own
            want = jkzg.verify_blob_kzg_proof_batch(case["blobs"], case["commitments"],
                                                    case["proofs"], jax_settings)
            got = kzg.verify_blob_kzg_proof_batch(case["blobs"], case["commitments"],
                                                  case["proofs"], settings, "cpu")
            assert got == want == case["valid"], name
    uniq, cs, proofs = cell3["unique"]
    z = kzg.bls_field_to_bytes(123456789)
    proof, y = kzg.compute_kzg_proof(uniq[1], z, settings, "cpu")
    assert kzg.verify_kzg_proof(cs[1], z, y, proof, settings, "cpu") == \
        jkzg.verify_kzg_proof(cs[1], z, y, proof, jax_settings) is True


@pytest.mark.slow
def test_fused_fq12_equals_the_jax_program(settings, jax_settings, cell8, monkeypatch):
    """With r fixed, the port's fused Miller product and the JAX package's
    ``_kzg_fused`` output give the same GT element."""
    from lighthouse_tpu.ops import bls_backend as jbb

    case = _all_cases(cell8)["swapped proof"]
    probe = {}
    _port(case, settings, probe)
    captured = {}
    monkeypatch.setattr(jbb, "_final_exp_is_one",
                        lambda f: captured.setdefault("f", f) is None)
    cs = [cv.g1_from_bytes(b) for b in case["commitments"]]
    pis = [cv.g1_from_bytes(b) for b in case["proofs"]]
    zs = [kzg.compute_challenge(b, c, settings) for b, c in zip(case["blobs"], case["commitments"])]
    lhs_points, lhs_scalars, r_pows = kzg.rlc_terms(cs, pis, zs, probe["ys"], FIXED_R)
    jkzg._kzg_fused_check(lhs_points, lhs_scalars, pis, r_pows, jax_settings)
    f_jax = captured["f"]
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2, Fq6, Fq12

    def carry(f):
        f6 = lambda x: Fq6(*(Fq2(int(c.a), int(c.b)) for c in (x.c0, x.c1, x.c2)))  # noqa: E731
        return Fq12(f6(f.c0), f6(f.c1))

    assert native_bls.final_exp(carry(f_jax)) == native_bls.final_exp(probe["f"])
