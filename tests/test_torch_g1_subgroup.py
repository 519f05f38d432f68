"""Row 12 of the port (the G1 membership kernel, ``ops/bls_backend.py``
``g1_subgroup_device``) and the trusted-setup load that runs it
(``crypto/kzg.py`` ``KzgSettings.load_trusted_setup``), on the CPU.

- The plain verdict, the JAX package's ``batch_subgroup_check_g1`` and the
  kernel's group lane built for the host with g++ (``host_g1_subgroup``,
  its threads in both orders) all equal the host oracle
  ``cv.g1_in_subgroup`` on members, points with a cofactor component, both
  points of order 3, random points off the curve and the tail's edge
  lanes; the lane's products equal ``bls_cuda.G1_SUBGROUP_LANE`` a lane,
  its tapes are at most 4 threads wide, and its beta is the cube root of
  unity that acts on G1 as [-z^2].
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
void h_g1_subgroup(const uint32_t* xp, const uint32_t* yp, uint8_t* out, long n, int reversed) {
    bls::level_order_reversed = reversed != 0;
    bls::host_g1_subgroup(xp, yp, out, n);
    bls::level_order_reversed = false;
}
}
"""
Z_ABS = 0xD201000000010000
# beta (csrc/bls12_381.cuh BETA_W) and the other primitive cube root of unity
BETA = 0x5F19672FDF76CE51BA69C6076A0F77EADDB3A93BE6F89688DE17D813620A00022E01FFFFFFFEFFFE
BETA_OTHER = BETA * BETA % cv.P


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


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("g1_lane")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DBLS_COUNT_FP_MULS", f"-I{native.CSRC}", str(d / "harness.cc"),
                    "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_fp_count.restype = ctypes.c_ulonglong
    return lib


def _host_lane(lib, points, reversed_=False) -> list:
    xp, yp = (bi.to_numpy(t) for t in ec.g1_words(points, CPU))
    out = np.zeros(len(points), np.uint8)
    lib.h_g1_subgroup(ctypes.c_void_p(xp.ctypes.data), ctypes.c_void_p(yp.ctypes.data),
                      ctypes.c_void_p(out.ctypes.data), ctypes.c_long(len(points)),
                      int(reversed_))
    return out.astype(bool).tolist()


def test_g1_lanes_equal_the_plain_verdict_and_count_their_products(lane_lib):
    for reversed_ in (False, True):
        before = lane_lib.h_fp_count()
        assert _host_lane(lane_lib, POINTS, reversed_=reversed_) == WANT
        assert lane_lib.h_fp_count() - before == len(POINTS) * bls_cuda.G1_SUBGROUP_LANE
    assert bls_cuda.G1_SUBGROUP_LANE == 1025
    plain = bb.g1_subgroup_plain(*ec.g1_words(POINTS, CPU))
    assert plain.tolist() == WANT


def _edge_points(seed: int) -> list:
    """Lanes at the σ test's edges, 8 to a JAX bucket: members, members
    plus a point of order 3, curve points outside G1, both points of order
    3, points off the curve (random, (0, 0), x = 0 with y != ±2, a member's
    x with y + 1), and members with small and large multiples."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(48), "big") % cv.P

    m = [cv.g1_mul(G, rand() % cv.R) for _ in range(3)]
    off = [(rand(), rand()) for _ in range(3)]
    return [m[0], cv.g1_add(m[1], T.ORDER3_G1), T.non_g1_point(seed), T.ORDER3_G1,
            off[0], (0, 0), cv.g1_mul(G, 2), cv.g1_neg(T.ORDER3_G1),
            cv.g1_add(m[2], cv.g1_neg(T.ORDER3_G1)), off[1], (0, 5), (m[0][0], m[0][1] + 1),
            cv.g1_mul(G, Z_ABS), T.non_g1_point(seed + 1), off[2], m[2]]


def test_group_lane_edges_equal_plain_jax_and_the_oracle(lane_lib):
    pts = _edge_points(1)
    want = [p is not cv.INF and cv.g1_is_on_curve(p) and cv.g1_in_subgroup(p) for p in pts]
    assert want.count(True) == 4 and want.count(False) == 12
    for reversed_ in (False, True):
        assert _host_lane(lane_lib, pts, reversed_) == want
    assert bb.batch_subgroup_check_g1(pts, device="cpu").tolist() == want     # the plain verdict
    jax_got = np.concatenate([jbb.batch_subgroup_check_g1(pts[k:k + 8]) for k in (0, 8)])
    assert jax_got.tolist() == want


def test_g1_tapes_are_four_wide_and_hold_the_counted_products():
    stats = bls_cuda.tape_stats()
    t = stats["tapes"]
    assert stats["kernels"]["k_g1_subgroup"]["width"] == 4
    assert [t[k]["products"] for k in ("gs_dbl", "gs_madd", "gs_add", "gs_tail")] == [
        bls_cuda.JAC_DOUBLE, bls_cuda.JAC_MADD, bls_cuda.JAC_ADD, 8]
    shape = bls_cuda.lane_shape(stats, bls_cuda.G1_SUBGROUP_TAPES,
                                bls_cuda.G1_SUBGROUP_OTHER_LEVELS)
    assert shape["products"] == bls_cuda.G1_SUBGROUP_LANE
    # rounds == product depth: no product level needs a second round of the
    # group's 4 threads (a doubling 3, an add 5, the tail 3); a lane 431,
    # where the one-thread [r-1]P scan ran 3,234 products one by one
    assert [t[k]["rounds"] for k in ("gs_dbl", "gs_madd", "gs_add", "gs_tail")] == [3, 5, 5, 3]
    assert shape["rounds"] == 431


def test_beta_acts_on_g1_as_minus_z_squared():
    """Of Fp's two primitive cube roots of unity only BETA passes members,
    and BETA_W holds its Montgomery form."""
    assert pow(BETA, 3, cv.P) == 1 and BETA != 1 and pow(BETA_OTHER, 3, cv.P) == 1
    src = (native.CSRC / "bls12_381.cuh").read_text()
    words = src.split("BETA_W[12] = {")[1].split("}")[0]
    mont = BETA * (1 << 384) % cv.P
    assert [int(w.strip().rstrip("u"), 16) for w in words.split(",")] == [
        (mont >> (32 * k)) & 0xFFFFFFFF for k in range(12)]
    z2 = Z_ABS * Z_ABS
    for p in (G, cv.g1_mul(G, 987654321)):
        minus = cv.g1_neg(cv.g1_mul(p, z2))
        assert (BETA * p[0] % cv.P, p[1]) == minus
        assert (BETA_OTHER * p[0] % cv.P, p[1]) != minus
    assert (-z2) % cv.R != 1 and pow(-z2, 3, cv.R) == 1


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
    pts = POINTS * 40 + _edge_points(1)[:5]          # 325 lanes: a last block of 5
    xp, yp = ec.g1_words(pts, dev)
    before = bb.g1_subgroup_device.launches
    got = bb.g1_subgroup_device(xp, yp)
    assert bb.g1_subgroup_device.launches == before + 1
    want = bb.g1_subgroup_plain(xp, yp).cpu()
    assert torch.equal(got.cpu(), want)
    assert got.cpu().tolist()[:320] == WANT * 40
