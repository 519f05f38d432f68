"""Row 12 of the port (the G1 membership kernel, ``ops/bls_backend.py``
``g1_subgroup_device``) and the trusted-setup load that runs it
(``crypto/kzg.py`` ``KzgSettings.load_trusted_setup``), on the CPU.

- The plain verdict, the JAX package's ``batch_subgroup_check_g1`` and the
  kernel's lane code built for the host with g++ all equal the host oracle
  ``cv.g1_in_subgroup`` on members, points with a cofactor component and
  points of order 3; the lane code's products equal
  ``bls_cuda.G1_SUBGROUP_LANE`` a lane.
- ``load_trusted_setup(ceremony_dict(dev(16)), validate=True)`` gives the
  settings the JAX package loads from the same dict (``validate=False``
  there: no compile) and ``KzgSettings.dev(16)``; a point outside G1, a
  width that is not a power of two and a wrong G2 generator raise
  ``KzgError``; a fault inside row 12 propagates.
The test marked ``cuda`` runs the kernel itself.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.ops import bls_backend as jbb
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import bls_cuda, ec

CPU = torch.device("cpu")
G = cv.g1_generator()
POINTS = [cv.g1_mul(G, 5), T.non_g1_point(1), T.ORDER3_G1, cv.g1_mul(G, 2**200 + 7),
          cv.g1_neg(T.ORDER3_G1), T.non_g1_point(2), G, cv.g1_mul(G, cv.R - 1)]
WANT = [True, False, False, True, False, False, True, True]

HARNESS = r"""
#include "bls12_381.cuh"
namespace bls { unsigned long long bls_fp_mul_count = 0; }
extern "C" {
unsigned long long h_fp_count() { return bls::bls_fp_mul_count; }
void h_g1_subgroup(const uint32_t* xp, const uint32_t* yp, uint8_t* out, long n) {
    for (long i = 0; i < n; i++) bls::lane_g1_subgroup(i, xp, yp, out);
}
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_the_oracle_and_the_points():
    assert [cv.g1_is_on_curve(p) for p in POINTS] == [True] * len(POINTS)
    assert [cv.g1_in_subgroup(p) for p in POINTS] == WANT
    assert cv.g1_is_on_curve(cv.g1_mul(T.ORDER3_G1, 3)) and cv.g1_mul(T.ORDER3_G1, 3) is cv.INF


def test_plain_verdict_equals_the_jax_kernel_and_the_oracle():
    got = bb.batch_subgroup_check_g1(POINTS, device="cpu")
    assert got.tolist() == WANT
    assert jbb.batch_subgroup_check_g1(POINTS).tolist() == WANT


def test_g1_lanes_equal_the_plain_verdict_and_count_their_products(tmp_path):
    (tmp_path / "harness.cc").write_text(HARNESS)
    so = tmp_path / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DBLS_COUNT_FP_MULS", f"-I{native.CSRC}", str(tmp_path / "harness.cc"),
                    "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_fp_count.restype = ctypes.c_ulonglong
    xp, yp = (bi.to_numpy(t) for t in ec.g1_words(POINTS, CPU))
    out = np.zeros(len(POINTS), np.uint8)
    lib.h_g1_subgroup(ctypes.c_void_p(xp.ctypes.data), ctypes.c_void_p(yp.ctypes.data),
                      ctypes.c_void_p(out.ctypes.data), ctypes.c_long(len(POINTS)))
    assert lib.h_fp_count() == len(POINTS) * bls_cuda.G1_SUBGROUP_LANE
    assert out.astype(bool).tolist() == WANT
    plain = bb.g1_subgroup_plain(*ec.g1_words(POINTS, CPU))
    assert plain.tolist() == WANT


@pytest.fixture(scope="module")
def ceremony():
    settings = kzg.KzgSettings.dev(16, device="cpu")
    return settings, T.ceremony_dict(settings)


def test_load_trusted_setup_equals_the_jax_load_and_dev(ceremony):
    settings, d = ceremony
    loaded = kzg.KzgSettings.load_trusted_setup(d, validate=True, device="cpu")
    assert loaded == settings
    assert (loaded.width, loaded.g1_lagrange_brp, loaded.roots_brp) == \
        (settings.width, settings.g1_lagrange_brp, settings.roots_brp)
    want = jkzg.KzgSettings.load_trusted_setup(d, validate=False)
    assert loaded.width == want.width and loaded.roots_brp == list(want.roots_brp)
    assert loaded.g1_lagrange_brp == [(int(x), int(y)) for x, y in want.g1_lagrange_brp]

    def g2(q):
        return (int(q[0].a), int(q[0].b), int(q[1].a), int(q[1].b))

    assert g2(loaded.g2_tau) == g2(want.g2_tau)
    assert [g2(q) for q in loaded.g2_monomial] == [g2(q) for q in want.g2_monomial]
    assert len(loaded.g2_monomial) == 65


def test_tampered_ceremonies_raise(ceremony):
    _settings, d = ceremony
    bad = dict(d, g1_lagrange=list(d["g1_lagrange"]))
    bad["g1_lagrange"][5] = "0x" + cv.g1_to_bytes(T.non_g1_point(4)).hex()
    with pytest.raises(kzg.KzgError, match="index 5 "):
        kzg.KzgSettings.load_trusted_setup(bad, validate=True, device="cpu")
    with pytest.raises(kzg.KzgError, match="not a power of two"):
        kzg.KzgSettings.load_trusted_setup(dict(d, g1_lagrange=d["g1_lagrange"][:12]),
                                           device="cpu")
    with pytest.raises(kzg.KzgError, match="generator"):
        kzg.KzgSettings.load_trusted_setup(dict(d, g2_monomial=d["g2_monomial"][1:]),
                                           device="cpu")


def test_a_row_12_fault_propagates(ceremony, monkeypatch):
    _settings, d = ceremony

    def boom(*a, **k):
        raise RuntimeError("injected row-12 fault")

    monkeypatch.setattr(bb, "g1_subgroup_plain", boom)
    with pytest.raises(RuntimeError, match="injected row-12 fault"):
        kzg.KzgSettings.load_trusted_setup(d, validate=True, device="cpu")


@pytest.mark.cuda
def test_row_12_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    pts = POINTS * 40
    xp, yp = ec.g1_words(pts, dev)
    before = bb.g1_subgroup_device.launches
    got = bb.g1_subgroup_device(xp, yp)
    assert bb.g1_subgroup_device.launches == before + 1
    assert torch.equal(got.cpu(), bb.g1_subgroup_plain(xp, yp).cpu())
    assert got.cpu().tolist() == WANT * 40
