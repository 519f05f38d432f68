"""The BLS12-381 CUDA kernels' per-lane code (``csrc/bls12_381.cuh``)
compiled as host C++ with g++, against the plain PyTorch versions.

A CUDA kernel has no interpret mode, but every kernel here is a thin
``__global__`` loop over a ``lane_*`` function of the header, which also
compiles for the host.  Running those functions over the same inputs as
the plain versions checks the kernels' arithmetic (field, tower, curve
formulas, Miller loop, ψ check, affine conversion) bit for bit without a
card; the build with a multiply counter also checks the Fp multiplication
counts that bound the kernels' times (``ops/bls_cuda.py``).  The test
marked ``cuda`` runs the kernels themselves against the plain versions.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import native
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import P, Fq2, Fq6, Fq12
from lighthouse_tpu_torch.crypto.bls.pairing_fast import miller_loop_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import bls_cuda, ec, msm

CPU = torch.device("cpu")

HARNESS = r"""
#include "bls12_381.cuh"
using namespace bls;
namespace bls { unsigned long long bls_fp_mul_count = 0; }
extern "C" {
unsigned long long h_count() { return bls::bls_fp_mul_count; }
void h_fp(int op, const u32* a, const u32* b, u32* r, long n) {
    for (long i = 0; i < n; i++) {
        Fp x, y, z;
        ld(x, a, i);
        ld(y, b, i);
        if (op == 0) fp_mul(z, x, y); else if (op == 1) fp_add(z, x, y); else fp_sub(z, x, y);
        st(r, i, z);
    }
}
void h_fq12_mul(const u32* a, const u32* b, u32* out, long n) {
    for (long i = 0; i < n; i++) lane_fq12_mul(i, a, b, out);
}
void h_gj(const u32* pkx, const u32* pky, const u32* sx, const u32* sy, const int32_t* d,
          u32* PX, u32* PY, u32* PZ, u32* SX, u32* SY, u32* SZ, long n) {
    for (long i = 0; i < n; i++) lane_gj_scalar_mul(i, n, 16, pkx, pky, sx, sy, d, PX, PY, PZ, SX, SY, SZ);
}
void h_halves(int g2, u32* X, u32* Y, u32* Z, long half) {
    for (long i = 0; i < half; i++) {
        if (g2) lane_add_halves<Fp2>(i, half, X, Y, Z); else lane_add_halves<Fp>(i, half, X, Y, Z);
    }
}
void h_miller(const u32* xp, const u32* yp, const u32* zp, const u32* xq, const u32* yq,
              const u32* zq, const uint8_t* mask, u32* out, long n, long n_out, long sum_lane) {
    for (long i = 0; i < n_out; i++) lane_miller(i, n, sum_lane, xp, yp, zp, xq, yq, zq, mask, out);
}
void h_psi(const u32* xq, const u32* yq, uint8_t* out, long n) {
    for (long i = 0; i < n; i++) lane_g2_subgroup(i, xq, yq, out);
}
void h_blinded_final(const u32* X, const u32* Y, const u32* Z, const u32* ux, const u32* uy,
                     u32* xa, u32* ya, uint8_t* inf, long n) {
    for (long i = 0; i < n; i++) lane_blinded_final(i, X, Y, Z, ux, uy, xa, ya, inf);
}
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """The header's lane functions built for the host, with the Fp
    multiplication counter on."""
    d = tmp_path_factory.mktemp("lanes")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DBLS_COUNT_FP_MULS", f"-I{native.CSRC}", str(d / "harness.cc"),
                    "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_count.restype = ctypes.c_ulonglong
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(bi.to_numpy(t))


def _t(a: np.ndarray) -> torch.Tensor:
    return bi.u64(torch.from_numpy(a.astype(np.uint32).view(np.int32)))


def _counted(lib, fn, *args) -> int:
    before = lib.h_count()
    fn(*args)
    return lib.h_count() - before


def test_field_ops_and_fq12_product(lanes):
    rng = np.random.default_rng(1)
    a = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(5)]
    b = [P - 1, P - 1, 1] + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(5)]
    A, B, R = bi.ints_to_mont_limbs(a), bi.ints_to_mont_limbs(b), np.zeros((8, 12), np.uint32)
    for op, f in ((0, lambda x, y: x * y), (1, lambda x, y: x + y), (2, lambda x, y: x - y)):
        lanes.h_fp(op, _ptr(A), _ptr(B), _ptr(R), ctypes.c_long(8))
        assert bi.mont_limbs_to_ints(R) == [f(x, y) % P for x, y in zip(a, b)]
    rnd = lambda: Fq2(int.from_bytes(rng.bytes(48), "big") % P,  # noqa: E731
                      int.from_bytes(rng.bytes(48), "big") % P)
    xs = [Fq12(Fq6(rnd(), rnd(), rnd()), Fq6(rnd(), rnd(), rnd())) for _ in range(4)]
    X = np.stack([t12.fq12_to_words(x) for x in xs])
    Y = np.ascontiguousarray(X[::-1])
    out = np.zeros_like(X)
    n = _counted(lanes, lanes.h_fq12_mul, _ptr(X), _ptr(Y), _ptr(out), ctypes.c_long(4))
    assert n == 4 * bls_cuda.FP12_MUL
    assert [t12.fq12_from_words(o) for o in out] == [x * y for x, y in zip(xs, xs[::-1])]
    # a factor of one (a masked or padding Miller lane) costs no product
    X[1] = Y[2] = t12.fq12_to_words(Fq12.ONE)
    n = _counted(lanes, lanes.h_fq12_mul, _ptr(X), _ptr(Y), _ptr(out), ctypes.c_long(4))
    assert n == 2 * bls_cuda.FP12_MUL
    assert t12.fq12_from_words(out[1]) == xs[2] and t12.fq12_from_words(out[2]) == xs[2]


def test_scalar_mul_and_tree_levels_equal_plain(lanes):
    rng = np.random.default_rng(2)
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    n = 4
    ps = [cv.g1_mul(g1, 3 + i) for i in range(n - 1)] + [(0, 0)]
    qs = [cv.g2_mul(g2, 5 + i) for i in range(n - 1)] + [(Fq2(0, 0), Fq2(0, 0))]
    # a random scalar, one with leading and inner zero digits, a zero one
    scalars = [int(rng.integers(1, 1 << 63)), 0x0F00000000000301, int(rng.integers(1, 1 << 63)), 0]
    digits = ec.scalars_to_digits(scalars).astype(np.int32)
    px, py = (_np(t) for t in ec.g1_words(ps, CPU))
    qx, qy = (_np(t) for t in ec.g2_words(qs, CPU))
    outs = [np.zeros((n, 12), np.uint32) for _ in range(3)] + [np.zeros((n, 2, 12), np.uint32)
                                                             for _ in range(3)]
    count = _counted(lanes, lanes.h_gj, _ptr(px), _ptr(py), _ptr(qx), _ptr(qy), _ptr(digits),
                     *[_ptr(o) for o in outs], ctypes.c_long(n))
    assert count == bls_cuda.scalar_mul_fp_muls(digits)
    plain = ec.gj_scalar_mul_windowed(_t(px), _t(py), _t(qx), _t(qy),
                                      torch.from_numpy(digits.astype(np.int64)))
    for o, pl in zip(outs, list(plain[0]) + list(plain[1])):
        assert np.array_equal(o, _np(pl))
    # one tree level of each group: rows i and i + 2 -> row i (row 3, the
    # zero scalar, is infinity: its add costs nothing)
    adds = bls_cuda.tree_products(digits.any(axis=0), 2)[0]
    assert adds == 1
    for g2, tracks, F in ((0, outs[:3], ec._G1), (1, outs[3:], ec._G2)):
        level = [o.copy() for o in tracks]
        count = _counted(lanes, lanes.h_halves, g2, *[_ptr(o) for o in level], ctypes.c_long(2))
        assert count == adds * bls_cuda.JAC_ADD * (bls_cuda.FP2_MUL if g2 else 1)
        want = ec.jac_add_full(F, tuple(_t(o[:2]) for o in tracks), tuple(_t(o[2:]) for o in tracks))
        for got, w in zip(level, want):
            assert np.array_equal(got[:2], _np(w))


def test_miller_lanes_equal_plain_and_pairing_fast(lanes):
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    n, n_out = 3, 4
    ps = [cv.g1_mul(g1, 7 + i) for i in range(n)]
    qs = [cv.g2_mul(g2, 9 + i) for i in range(n)]
    xp, yp = (_np(t) for t in ec.g1_words(ps, CPU))
    xq, yq = (_np(t) for t in ec.g2_words(qs, CPU))
    one = np.tile(bi.ONE_M, (n, 1))
    one_q = np.zeros((n, 2, 12), np.uint32)
    one_q[:, 0] = bi.ONE_M
    mask = np.array([1, 0, 1], np.uint8)
    out = np.zeros((n_out, 12, 12), np.uint32)
    count = _counted(lanes, lanes.h_miller, _ptr(xp), _ptr(yp), _ptr(one), _ptr(xq), _ptr(yq),
                     _ptr(one_q), _ptr(mask), _ptr(out), ctypes.c_long(n), ctypes.c_long(n_out),
                     ctypes.c_long(-1))
    assert count == 2 * bls_cuda.MILLER_LANE                    # the masked lane is skipped
    fs = [t12.fq12_from_words(o) for o in out]
    assert fs[0] == miller_loop_fast(ps[0], qs[0]) and fs[2] == miller_loop_fast(ps[2], qs[2])
    assert fs[1] == fs[3] == Fq12.ONE
    # Jacobian P and Q lanes: equal to the plain version word for word; the
    # sum lane (index 2) takes its mask from Zq != 0
    zp = bi.ints_to_mont_limbs([5, 6, 7])
    zq = np.ascontiguousarray(np.stack([xq[0], xq[1], np.zeros((2, 12), np.uint32)]))
    lanes.h_miller(_ptr(xp), _ptr(yp), _ptr(zp), _ptr(xq), _ptr(yq), _ptr(zq),
                   _ptr(np.ones(n, np.uint8)), _ptr(out), ctypes.c_long(n), ctypes.c_long(n_out),
                   ctypes.c_long(2))
    plain = t12.batch_miller_loop_plain(_t(xp[:2]), _t(yp[:2]), _t(zp[:2]), _t(xq[:2]),
                                        _t(yq[:2]), _t(zq[:2]))
    assert np.array_equal(out[:2], _np(t12.fq12_flat(plain)))
    assert t12.fq12_from_words(out[2]) == Fq12.ONE


def test_psi_lanes_fail_closed_and_equal_plain(lanes):
    g2 = cv.g2_generator()
    pts = [g2, T.SMALL_ORDER_G2, cv.g2_mul(g2, 77), T.non_subgroup_point(9)]
    xq, yq = (_np(t) for t in ec.g2_words(pts, CPU))
    ok = np.zeros(4, np.uint8)
    count = _counted(lanes, lanes.h_psi, _ptr(xq), _ptr(yq), _ptr(ok), ctypes.c_long(4))
    assert count == 4 * bls_cuda.PSI_LANE
    assert ok.tolist() == [1, 0, 1, 0]
    assert bb.g2_subgroup_plain(torch.from_numpy(xq.view(np.int32)),
                                torch.from_numpy(yq.view(np.int32))).tolist() == [True, False,
                                                                                  True, False]


def test_blinded_final_lanes_equal_plain(lanes):
    pks = T.consecutive_pubkeys(900, 3)
    pts = [pk.point for pk in pks] + [cv.g1_neg(pks[0].point)]
    X = bi.ints_to_mont_limbs([p[0] for p in pts])
    Y = bi.ints_to_mont_limbs([p[1] for p in pts])
    Z = np.tile(bi.ONE_M, (4, 1))
    u = cv.g1_mul(cv.g1_generator(), 12345)
    ux, uy = bi.ints_to_mont_limbs([u[0]]), bi.ints_to_mont_limbs([u[1]])
    xa, ya = np.zeros((2, 12), np.uint32), np.zeros((2, 12), np.uint32)
    inf = np.zeros(2, np.uint8)
    # two segments of two lanes (s-major): segment 0 = pk0 + pk2, 1 = pk1 - pk0
    Xl, Yl, Zl = X.copy(), Y.copy(), Z.copy()
    count = _counted(lanes, lanes.h_halves, 0, _ptr(Xl), _ptr(Yl), _ptr(Zl), ctypes.c_long(2))
    count += _counted(lanes, lanes.h_blinded_final, _ptr(Xl), _ptr(Yl), _ptr(Zl), _ptr(ux),
                      _ptr(uy), _ptr(xa), _ptr(ya), _ptr(inf), ctypes.c_long(2))
    assert count == bls_cuda.blinded_fold_fp_muls(np.ones(4, bool), 2)
    as_t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    pxa, pya, pinf = msm.blinded_fold_plain(as_t(X), as_t(Y), as_t(Z), as_t(ux), as_t(uy), 2)
    assert np.array_equal(xa, bi.to_numpy(pxa)) and np.array_equal(ya, bi.to_numpy(pya))
    assert inf.tolist() == pinf.to(torch.uint8).tolist() == [0, 0]
    want = cv.g1_add(cv.g1_add(pts[0], pts[2]), u)
    assert (bi.from_mont(xa[0]), bi.from_mont(ya[0])) == want
    # an infinity lane (a set with fewer keys) joins its segment with no product
    Z[2] = 0
    Xl, Yl, Zl = X.copy(), Y.copy(), Z.copy()
    count = _counted(lanes, lanes.h_halves, 0, _ptr(Xl), _ptr(Yl), _ptr(Zl), ctypes.c_long(2))
    count += _counted(lanes, lanes.h_blinded_final, _ptr(Xl), _ptr(Yl), _ptr(Zl), _ptr(ux),
                      _ptr(uy), _ptr(xa), _ptr(ya), _ptr(inf), ctypes.c_long(2))
    assert count == bls_cuda.blinded_fold_fp_muls(Z.any(axis=1), 2)
    pxa, pya, _ = msm.blinded_fold_plain(as_t(X), as_t(Y), as_t(Z), as_t(ux), as_t(uy), 2)
    assert np.array_equal(xa, bi.to_numpy(pxa)) and np.array_equal(ya, bi.to_numpy(pya))
    assert (bi.from_mont(xa[0]), bi.from_mont(ya[0])) == cv.g1_add(pts[0], u)


def test_multiply_counts_of_the_path_shapes():
    """The bound's work at the shapes of the main path (see PERF.md), by
    hand: per live scalar lane with 16 nonzero digits two window tables of
    161, 15 x 4 doublings of 7 and 15 adds of 16 (G2 x 3); a Miller lane
    17 + 63 x 114 + 5 x 96; an Fq12 product 54."""
    assert (bls_cuda.FP12_MUL, bls_cuda.MILLER_LANE, bls_cuda.PSI_LANE) == (54, 7679, 1505)
    lane = (161 + 15 * 4 * 7 + 15 * 16) * 4
    digits = np.zeros((16, 256), np.int32)
    digits[:, :131] = 7
    mask = np.arange(256) < 131
    block = bls_cuda.pipeline_fp_muls(digits, 0, mask)
    assert block == 131 * lane + 130 * 48 + 132 * 7679 + 131 * 54
    chunk = bls_cuda.pipeline_fp_muls(np.full((16, 512), 7, np.int32), 64, np.ones(64, bool))
    assert chunk == 512 * lane + 448 * 16 + 511 * 48 + 65 * 7679 + 64 * 54
    live = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    assert bls_cuda.blinded_fold_fp_muls(live, 2) == (3 + 2 + 2) * 16 + 2 * (610 + 4)
    assert bls_cuda.IMADS_PER_FP_MUL == 300


@pytest.mark.cuda
def test_every_bls_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    from lighthouse_tpu_torch.ops import dispatch_pipeline as dp

    bb.reset_launches()
    sets = T.microbench_sets(16)
    assert bb.verify_signature_sets_device(T.fresh(sets), chunk_size=8)
    assert not bb.verify_signature_sets_device(T.with_wrong_message(T.fresh(sets), 3))
    block = T.block_signature_sets(3, 1 << 12)
    assert bb.verify_signature_sets_device(T.fresh(block))
    assert not bb.verify_signature_sets_device(T.with_identity_aggregate(T.fresh(block), 5))
    assert all(k.launches > 0 for k in bb.KERNELS), {k.__name__: k.launches for k in bb.KERNELS}
    a = bi.to_tensor(np.stack([t12.fq12_to_words(Fq12.ONE)] * 2), "cuda")
    assert torch.equal(dp.fq12_mul_device(a, a).cpu(), dp.fq12_mul_plain(a.cpu(), a.cpu()))
