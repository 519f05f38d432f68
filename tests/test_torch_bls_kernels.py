"""The BLS12-381 CUDA kernels' per-lane code (``csrc/bls12_381.cuh``)
compiled as host C++ with g++, against the plain PyTorch versions.

A CUDA kernel has no interpret mode, but every kernel here is a thin
``__global__`` loop over a ``lane_*`` function of the header, which also
compiles for the host: a one-thread lane directly, a group lane (scalar
multiplications, Miller loop, Fq12 product) through the header's host
versions of the group kernels, which run a group's threads one after
another.  Running them over the same inputs as the plain versions checks
the kernels' arithmetic (field, tower, curve formulas, Miller loop, ψ
check, affine conversion) bit for bit without a card, the group lanes (the
ψ check's too, against its one-thread lane) with
their threads in ascending and in descending order (an operation reading a
slot another thread writes in the same level would differ); the build with
a multiply counter also checks
the Fp multiplication counts that bound the kernels' times
(``ops/bls_cuda.py``).  The group lanes are also held to the JAX package's
host oracles (curve multiples in affine form, Miller values), imported in
those tests only.  The test marked ``cuda`` runs the kernels themselves
against the plain versions.
"""

import contextlib
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import native
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import P, Fq2, Fq6, Fq12
from lighthouse_tpu_torch.crypto.bls.pairing_fast import miller_loop_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import bls_cuda, ec, msm
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")

CPU = torch.device("cpu")

HARNESS = r"""
#include "bls12_381.cuh"
using namespace bls;
namespace bls { unsigned long long bls_fp_mul_count = 0; }
namespace modinv { unsigned long long modinv_muladd_count = 0; }
extern "C" {
unsigned long long h_count() { return bls::bls_fp_mul_count; }
unsigned long long h_muladds() { return modinv::modinv_muladd_count; }
void h_fp(int op, const u32* a, const u32* b, u32* r, long n) {
    for (long i = 0; i < n; i++) {
        Fp x, y, z;
        ld(x, a, i);
        ld(y, b, i);
        if (op == 0) fp_mul(z, x, y); else if (op == 1) fp_add(z, x, y); else fp_sub(z, x, y);
        st(r, i, z);
    }
}
void h_reverse(int on) { level_order_reversed = on != 0; }
void h_fq12_mul(const u32* a, const u32* b, u32* out, long n) { host_fq12_mul(a, b, out, n); }
void h_gj(const u32* pkx, const u32* pky, const u32* sx, const u32* sy, const int32_t* d,
          u32* PX, u32* PY, u32* PZ, u32* SX, u32* SY, u32* SZ, long n) {
    host_gj_scalar_mul(pkx, pky, sx, sy, d, PX, PY, PZ, SX, SY, SZ, n, 16);
}
void h_halves(int g2, u32* X, u32* Y, u32* Z, long half) {
    for (long i = 0; i < half; i++) {
        if (g2) lane_add_halves<Fp2>(i, half, X, Y, Z); else lane_add_halves<Fp>(i, half, X, Y, Z);
    }
}
void h_miller(const u32* xp, const u32* yp, const u32* zp, const u32* xq, const u32* yq,
              const u32* zq, const uint8_t* mask, u32* out, long n, long n_out, long sum_lane) {
    host_miller(xp, yp, zp, xq, yq, zq, mask, out, n, n_out, sum_lane);
}
void h_psi(const u32* xq, const u32* yq, uint8_t* out, long n) {
    for (long i = 0; i < n; i++) lane_g2_subgroup(i, xq, yq, out);
}
void h_psi_group(const u32* xq, const u32* yq, uint8_t* out, long n) {
    host_g2_subgroup(xq, yq, out, n);
}
// S = [|x|]Q of the psi scan, rows [n, 3, 2, 12]: the group lane's
// workspace after the lane (group 1) or the one-thread scan (group 0)
void h_psi_scan(int group, const u32* xq, const u32* yq, u32* S, long n) {
    std::vector<Fp> ws(PSI_WS);
    uint8_t ok;
    for (long i = 0; i < n; i++) {
        Jac<Fp2> T;
        if (group) {
            lane_g2_subgroup<PSI_W>(Grp{0, 0}, host_view(), ws.data(), 0, xq + i * 24, yq + i * 24,
                                    &ok);
            for (int c = 0; c < 2; c++) {
                T.X.c[c] = ws[PS_T + c];
                T.Y.c[c] = ws[PS_T + 2 + c];
                T.Z.c[c] = ws[PS_T + 4 + c];
            }
        } else {
            Fp2 x, y;
            ld(x, xq, i);
            ld(y, yq, i);
            jac_zero(T);
            bool inf = true;
            for (int b = 63; b >= 0; b--) dbl_add_step(T, inf, x, y, (int)((BLS_X_ABS >> b) & 1));
            if (inf) jac_zero(T);
        }
        st(S, 3 * i, T.X);
        st(S, 3 * i + 1, T.Y);
        st(S, 3 * i + 2, T.Z);
    }
}
void h_blinded_final(const u32* X, const u32* Y, const u32* Z, const u32* ux, const u32* uy,
                     u32* xa, u32* ya, uint8_t* inf, long n, int rows) {
    host_blinded_final(X, Y, Z, ux, uy, xa, ya, inf, n, rows);
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
                    "-DBLS_COUNT_FP_MULS", "-DMODINV_COUNT_MULADDS", f"-I{native.CSRC}",
                    str(d / "harness.cc"),
                    "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_count.restype = ctypes.c_ulonglong
    lib.h_muladds.restype = ctypes.c_ulonglong
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


@contextlib.contextmanager
def _level_order(lib, reverse: bool):
    """Run the group lanes' level loops in descending order if ``reverse``."""
    lib.h_reverse(int(reverse))
    try:
        yield
    finally:
        lib.h_reverse(0)


def _g2_affine(X, Y, Z) -> list:
    """Jacobian G2 word rows [n, 2, 12] -> affine points, ``cv.INF`` at Z = 0."""
    out = []
    for x, y, z in zip(*((Fq2(*bi.mont_limbs_to_ints(r)) for r in rows) for rows in (X, Y, Z))):
        if z == Fq2(0, 0):
            out.append(cv.INF)
            continue
        zi = z.inv()
        out.append((x * zi * zi, y * zi * zi * zi))
    return out


def _jax_g2(q):
    from lighthouse_tpu.crypto.bls.fields import Fq2 as JFq2
    return None if q is cv.INF else (JFq2(q[0].a, q[0].b), JFq2(q[1].a, q[1].b))


def _from_jax_g2(q):
    return cv.INF if q is None else (Fq2(q[0].a, q[0].b), Fq2(q[1].a, q[1].b))


def _coeffs(f) -> list:
    """An Fq12 of either package as canonical integers."""
    return [int(c) for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]


ORDERS = pytest.mark.parametrize("reverse", [False, True], ids=["ascending", "descending"])


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


@pytest.fixture(scope="module")
def psi_case():
    """Affine G2 lanes for the ψ check: multiples of the generator, a point
    of order 13 (its scan meets the H == 0 chord at bit 60, where T = 12Q =
    -Q, and drives Z to 0), a point on the curve outside G2, and the
    generator padding of a batch; their plain verdicts and the plain scan's
    S = [|x|]Q word rows [n, 3, 2, 12]."""
    g2 = cv.g2_generator()
    pts = [cv.g2_mul(g2, 77), T.SMALL_ORDER_G2, cv.g2_mul(g2, 5), T.non_subgroup_point(9), g2, g2]
    xq, yq = (_np(t) for t in ec.g2_words(pts, CPU))
    xt, yt = _t(xq), _t(yq)
    F, zero = ec._G2, torch.zeros_like(xt)
    X, Y, Z = zero, zero, zero
    inf = torch.ones(len(pts), dtype=torch.bool)
    for bit in ec.X_BITS64:
        X, Y, Z, inf = ec.dbl_add_step(F, X, Y, Z, inf, xt, yt, bit)
    scan = np.ascontiguousarray(np.stack([_np(ec._select(inf, zero, c, F)) for c in (X, Y, Z)], 1))
    plain = bb.g2_subgroup_plain(torch.from_numpy(xq.view(np.int32)),
                                 torch.from_numpy(yq.view(np.int32))).tolist()
    return xq, yq, scan, plain


@ORDERS
def test_psi_group_lanes_equal_the_one_thread_lanes_and_plain(lanes, psi_case, reverse):
    """Row 6's group lane (host build, 16 threads in either order): the same
    verdicts as the one-thread lane and the plain version, S word for word
    with both scans, the order-13 lane's Z driven to 0 by the H == 0 chord
    (read False, fail closed), and PSI_LANE products a lane."""
    xq, yq, scan, plain = psi_case
    n = xq.shape[0]
    assert plain == [True, False, True, False, True, True]
    group, one = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    with _level_order(lanes, reverse):
        count = _counted(lanes, lanes.h_psi_group, _ptr(xq), _ptr(yq), _ptr(group),
                         ctypes.c_long(n))
    lanes.h_psi(_ptr(xq), _ptr(yq), _ptr(one), ctypes.c_long(n))
    assert count == n * bls_cuda.PSI_LANE
    assert group.tolist() == one.tolist() == [int(v) for v in plain]
    s_group, s_one = np.zeros_like(scan), np.zeros_like(scan)
    with _level_order(lanes, reverse):
        lanes.h_psi_scan(1, _ptr(xq), _ptr(yq), _ptr(s_group), ctypes.c_long(n))
    lanes.h_psi_scan(0, _ptr(xq), _ptr(yq), _ptr(s_one), ctypes.c_long(n))
    assert np.array_equal(s_group, scan) and np.array_equal(s_one, scan)
    assert not scan[1, 2].any() and all(scan[i, 2].any() for i in (0, 2, 3, 4))


def _blinded_fold(lanes, X, Y, Z, ux, uy, n_seg: int) -> tuple:
    """``msm.blinded_fold_device``'s launches on the host, by its plan: the
    tree levels (``lane_add_halves``), then the tail (``host_blinded_final``,
    a warp's lanes in turn) -> (xa, ya, inf, Fp products, multiply-adds)."""
    X, Y, Z = (np.ascontiguousarray(a, np.uint32).copy() for a in (X, Y, Z))
    halves, rows = msm.blinded_fold_plan(X.shape[0], n_seg)
    xa, ya = np.zeros((n_seg, 12), np.uint32), np.zeros((n_seg, 12), np.uint32)
    inf = np.zeros(n_seg, np.uint8)
    p0, m0 = lanes.h_count(), lanes.h_muladds()
    for half in halves:
        lanes.h_halves(0, _ptr(X), _ptr(Y), _ptr(Z), ctypes.c_long(half))
    lanes.h_blinded_final(_ptr(X), _ptr(Y), _ptr(Z), _ptr(ux), _ptr(uy), _ptr(xa), _ptr(ya),
                          _ptr(inf), ctypes.c_long(n_seg), ctypes.c_int(rows))
    return xa, ya, inf, lanes.h_count() - p0, lanes.h_muladds() - m0


def _blinded_work(X, Y, Z, ux, uy, n_seg: int) -> tuple:
    """What the bound counts for these lanes: (Fp products besides the
    inversions, all multiply-adds), the inversions on the plain sums' Z."""
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))  # noqa: E731
    zs = _np(msm.blinded_sum_plain(as_t(X), as_t(Y), as_t(Z), as_t(ux), as_t(uy), n_seg)[2])
    live = np.asarray(Z).any(axis=1)
    return (bls_cuda.blinded_fold_fp_muls(live, n_seg),
            bls_cuda.blinded_fold_muladds(live, zs))


def test_blinded_final_lanes_equal_plain(lanes):
    pks = T.consecutive_pubkeys(900, 3)
    pts = [pk.point for pk in pks] + [cv.g1_neg(pks[0].point)]
    X = bi.ints_to_mont_limbs([p[0] for p in pts])
    Y = bi.ints_to_mont_limbs([p[1] for p in pts])
    Z = np.tile(bi.ONE_M, (4, 1))
    u = cv.g1_mul(cv.g1_generator(), 12345)
    ux, uy = bi.ints_to_mont_limbs([u[0]]), bi.ints_to_mont_limbs([u[1]])
    as_t = lambda a: torch.from_numpy(a.view(np.int32))  # noqa: E731
    # two segments of two lanes (s-major): segment 0 = pk0 + pk2, 1 = pk1 - pk0
    xa, ya, inf, count, adds = _blinded_fold(lanes, X, Y, Z, ux, uy, 2)
    fp_muls, muladds = _blinded_work(X, Y, Z, ux, uy, 2)
    assert count == fp_muls + 2 and fp_muls == bls_cuda.blinded_fold_fp_muls(np.ones(4, bool), 2)
    assert count * bls_cuda.IMADS_PER_FP_MUL + adds == muladds
    pxa, pya, pinf = msm.blinded_fold_plain(as_t(X), as_t(Y), as_t(Z), as_t(ux), as_t(uy), 2)
    assert np.array_equal(xa, bi.to_numpy(pxa)) and np.array_equal(ya, bi.to_numpy(pya))
    assert inf.tolist() == pinf.to(torch.uint8).tolist() == [0, 0]
    want = cv.g1_add(cv.g1_add(pts[0], pts[2]), u)
    assert (bi.from_mont(xa[0]), bi.from_mont(ya[0])) == want
    # an infinity lane (a set with fewer keys) joins its segment with no product
    Z[2] = 0
    xa, ya, inf, count, adds = _blinded_fold(lanes, X, Y, Z, ux, uy, 2)
    fp_muls, muladds = _blinded_work(X, Y, Z, ux, uy, 2)
    assert count == fp_muls + 2 and fp_muls == bls_cuda.blinded_fold_fp_muls(Z.any(axis=1), 2)
    assert count * bls_cuda.IMADS_PER_FP_MUL + adds == muladds
    pxa, pya, _ = msm.blinded_fold_plain(as_t(X), as_t(Y), as_t(Z), as_t(ux), as_t(uy), 2)
    assert np.array_equal(xa, bi.to_numpy(pxa)) and np.array_equal(ya, bi.to_numpy(pya))
    assert (bi.from_mont(xa[0]), bi.from_mont(ya[0])) == cv.g1_add(pts[0], u)


@pytest.mark.parametrize("seg", [4, 32, 64])
@ORDERS
def test_blinded_tail_equals_plain(lanes, seg, reverse):
    """The row 8 tail at segments of 4 and 32 rows (the tail takes them
    whole) and 64 (one tree launch first), in the real lane layout
    (``bb.fold_lanes``): a full set, a set whose keys P and -P cancel (the
    segment reads as the identity once the blinding total is added), a set
    of one key (padding lanes) and a segment with no set at all; the warp's
    lanes in both orders."""
    max_k = seg // 2
    pks = T.consecutive_pubkeys(700 + seg, max_k + 1)
    neg = cv.g1_neg(pks[0].point)
    sig = api.Signature(bytes([0xC0]) + bytes(95))
    sets = [api.SignatureSet(sig, pks[1:max_k + 1], b"m"),
            api.SignatureSet(sig, [pks[0], api.PublicKey(cv.g1_to_bytes(neg), neg)], b"m"),
            api.SignatureSet(sig, pks[:1], b"m")]
    X, Y, Z, ux, uy, n_pad = bb.fold_lanes(sets)
    assert n_pad == 4 and X.shape[0] == seg * n_pad
    with _level_order(lanes, reverse):
        xa, ya, inf, count, adds = _blinded_fold(lanes, X, Y, Z, ux, uy, n_pad)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))  # noqa: E731
    pxa, pya, pinf = msm.blinded_fold_plain(*(as_t(a) for a in (X, Y, Z, ux, uy)), n_pad)
    assert np.array_equal(xa, bi.to_numpy(pxa)) and np.array_equal(ya, bi.to_numpy(pya))
    assert inf.tolist() == pinf.to(torch.uint8).tolist() == [0, 1, 0, 1]
    assert not xa[1].any() and not ya[1].any() and not xa[3].any()
    for i in (0, 2):
        assert (bi.from_mont(xa[i]), bi.from_mont(ya[i])) == sets[i].aggregate_pubkey()
    fp_muls, muladds = _blinded_work(X, Y, Z, ux, uy, n_pad)
    assert count == fp_muls + n_pad
    assert count * bls_cuda.IMADS_PER_FP_MUL + adds == muladds


@ORDERS
def test_joint_scalar_mul_lanes_equal_plain_and_the_jax_curve(lanes, reverse):
    """The G1 x G2 lanes in both level orders: a random scalar, a zero one,
    leading and inner zero digits, all digits 15, one; a G1 point of order 3
    (6P: its table's entries 3 and 6 are infinity, so its track runs apart
    from the G2 one), a G2 point of order 13 (26Q sums to infinity) and Q =
    (0, 0) (its doubling is infinity: the G2 track apart).  Equal to the
    plain version word for word; each track of a point in its group equals
    the JAX package's curve multiple."""
    from lighthouse_tpu.crypto.bls import curve as jcv

    rng = np.random.default_rng(12)
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    ps = [cv.g1_mul(g1, 3 + i) for i in range(8)]
    qs = [cv.g2_mul(g2, 5 + i) for i in range(8)]
    ks = [int(rng.integers(1, 1 << 63)), 0, 0x0F00000000000301, 6, 26, (1 << 64) - 1, 1, 5]
    ps[3] = T.ORDER3_G1
    qs[4] = T.SMALL_ORDER_G2
    qs[7] = (Fq2(0, 0), Fq2(0, 0))
    n = len(ks)
    digits = ec.scalars_to_digits(ks).astype(np.int32)
    px, py = (_np(t) for t in ec.g1_words(ps, CPU))
    qx, qy = (_np(t) for t in ec.g2_words(qs, CPU))
    outs = [np.zeros((n, 12), np.uint32) for _ in range(3)] + [np.zeros((n, 2, 12), np.uint32)
                                                             for _ in range(3)]
    with _level_order(lanes, reverse):
        lanes.h_gj(_ptr(px), _ptr(py), _ptr(qx), _ptr(qy), _ptr(digits),
                   *[_ptr(o) for o in outs], ctypes.c_long(n))
    plain = ec.gj_scalar_mul_windowed(_t(px), _t(py), _t(qx), _t(qy),
                                      torch.from_numpy(digits.astype(np.int64)))
    for o, pl in zip(outs, list(plain[0]) + list(plain[1])):
        assert np.array_equal(o, _np(pl))
    g1s = msm.jacobian_rows_to_affine(*outs[:3])
    g2s = _g2_affine(*outs[3:])
    for i, k in enumerate(ks):
        assert g1s[i] == jcv.g1_mul(ps[i], k)
        if i != 7:
            assert g2s[i] == _from_jax_g2(jcv.g2_mul(_jax_g2(qs[i]), k))
    assert g1s[1] is g2s[1] is g1s[3] is g2s[4] is cv.INF


@ORDERS
def test_miller_lanes_in_both_orders_equal_plain_and_the_jax_oracle(lanes, reverse):
    """Miller lanes as the pipeline launches them, in both level orders:
    affine lanes 0 and 3, a masked lane 1, lane 2 with P and Q Jacobian
    (Zp = 5, Zq random), the Σ lane 4 with Zq = 0 (off), padding lanes 5-7.
    The live lanes equal the plain version word for word; the affine ones
    equal the JAX package's ``miller_loop_fast``, the Jacobian one after the
    final exponentiation; then the Fq12 tree over the 8 lanes equals the
    plain product and, after the final exponentiation, the JAX package's
    ``multi_miller_fast`` of the live pairs."""
    from lighthouse_tpu.crypto.bls import fields as jfields
    from lighthouse_tpu.crypto.bls import pairing_fast as jpf
    from lighthouse_tpu_torch.ops import native_bls

    g1, g2 = cv.g1_generator(), cv.g2_generator()
    n, n_out = 5, 8
    ps = [cv.g1_mul(g1, 7 + 3 * i) for i in range(n)]
    qs = [cv.g2_mul(g2, 9 + 2 * i) for i in range(n)]
    xp, yp = (_np(t) for t in ec.g1_words(ps, CPU))
    xq, yq = (_np(t) for t in ec.g2_words(qs, CPU))
    zp = np.tile(bi.ONE_M, (n, 1))
    zq = np.zeros((n, 2, 12), np.uint32)
    zq[:, 0] = bi.ONE_M
    # lane 2 in Jacobian form: (x z^2, y z^3, z) for P, the same over Fq2 for Q
    z, w = 5, Fq2(0x1234567, 0x89ABCDEF)
    xp[2], yp[2], zp[2] = (bi.ints_to_mont_limbs([v % P])[0]
                           for v in (ps[2][0] * z * z, ps[2][1] * z ** 3, z))
    jq = (qs[2][0] * w * w, qs[2][1] * w * w * w, w)
    for rows, v in zip((xq, yq, zq), jq):
        rows[2] = bi.ints_to_mont_limbs([v.a, v.b])
    zq[4] = 0
    mask = np.array([1, 0, 1, 1, 1], np.uint8)
    out = np.zeros((n_out, 12, 12), np.uint32)
    with _level_order(lanes, reverse):
        count = _counted(lanes, lanes.h_miller, _ptr(xp), _ptr(yp), _ptr(zp), _ptr(xq), _ptr(yq),
                         _ptr(zq), _ptr(mask), _ptr(out), ctypes.c_long(n),
                         ctypes.c_long(n_out), ctypes.c_long(4))
    live = np.array([1, 0, 1, 1, 0, 0, 0, 0], bool)
    assert count == int(live.sum()) * bls_cuda.MILLER_LANE
    plain = t12.fq12_flat(t12.batch_miller_loop_plain(*(_t(a) for a in (xp, yp, zp, xq, yq, zq))))
    one = t12.fq12_to_words(Fq12.ONE)
    for i in range(n_out):
        assert np.array_equal(out[i], _np(plain[i]) if live[i] else one), i
    fs = [t12.fq12_from_words(o) for o in out]
    jps = [(p, _jax_g2(q)) for p, q in zip(ps, qs)]
    for i in (0, 3):
        assert _coeffs(fs[i]) == _coeffs(jpf.miller_loop_fast(*jps[i]))

    def fe(f):
        return _coeffs(native_bls.final_exp(f))

    def jax_fe(f):
        return _coeffs(jfields.final_exponentiation_fast(f))

    assert fe(fs[2]) == jax_fe(jpf.miller_loop_fast(*jps[2]))
    # the Fq12 tree: rows i and i + half -> row i, a factor of one costing nothing
    tree = out.copy()
    half, count = n_out // 2, 0
    with _level_order(lanes, reverse):
        while half >= 1:
            count += _counted(lanes, lanes.h_fq12_mul, _ptr(tree), _ptr(tree[half:]), _ptr(tree),
                              ctypes.c_long(half))
            half //= 2
    assert count == bls_cuda.miller_reduce_fp_muls(live) - int(live.sum()) * bls_cuda.MILLER_LANE
    want = t12.reduce_product_plain(t12.fq12_nested(_t(out)), torch.from_numpy(live))
    assert np.array_equal(tree[0], _np(t12.fq12_flat(want))[0])
    assert fe(t12.fq12_from_words(tree[0])) == jax_fe(
        jpf.multi_miller_fast([jps[i] for i in (0, 2, 3)]))


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
    # the tree's 3 + 2 adds, 2 blinding adds and 4 affine products a segment;
    # the inversions (divsteps, then one product by R^3) count apart
    assert bls_cuda.blinded_fold_fp_muls(live, 2) == (3 + 2 + 2) * 16 + 2 * 4
    z_one = np.tile(bi.ONE_M, (2, 1))
    inv_one = bls_cuda.fp_inv_muladds(z_one[:1])
    assert bls_cuda.blinded_fold_muladds(live, z_one) == (
        ((3 + 2 + 2) * 16 + 2 * 4) * 300 + 2 * inv_one)
    assert 300 < inv_one < bls_cuda.FP_INV * 300 // 10
    assert bls_cuda.IMADS_PER_FP_MUL == 300


def test_group_lane_tapes_of_rows_9_and_6():
    """The tapes rows 9 and 6 run hold the products their bounds count
    (FINAL_EXP_HARD_LANE and PSI_LANE a lane), each product level within
    one round of the group's width (a warp for row 9, 16 threads for the
    ψ check)."""
    stats = bls_cuda.tape_stats()
    t = stats["tapes"]
    shape = bls_cuda.lane_shape(stats, bls_cuda.FINAL_EXP_HARD_TAPES,
                                bls_cuda.FINAL_EXP_HARD_OTHER_LEVELS)
    assert shape["products"] == bls_cuda.FINAL_EXP_HARD_LANE
    assert bls_cuda.lane_shape(stats, bls_cuda.PSI_TAPES, 0)["products"] == bls_cuda.PSI_LANE
    assert [t[k]["products"] for k in ("cyc_sqr", "frob1", "frob2", "frob3")] == [
        bls_cuda.CYC_SQR] + [n * bls_cuda.FROBENIUS_ROUND for n in (1, 2, 3)]
    assert [t[k]["products"] for k in ("psi_dbl", "psi_add")] == [
        bls_cuda.JAC_DOUBLE * bls_cuda.FP2_MUL, 11 * bls_cuda.FP2_MUL]
    # rounds == product depth: no product level needs a second round
    assert [t[k]["rounds"] for k in ("cyc_sqr", "frob1", "frob2", "frob3", "psi_dbl",
                                     "psi_add", "psi_tail")] == [1, 1, 2, 3, 3, 5, 3]
    kernels = stats["kernels"]
    assert (kernels["k_final_exp_hard"]["width"], kernels["k_g2_subgroup"]["width"]) == (32, 16)


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
    # the group kernels' edge batches: one lane, every Miller lane masked,
    # every scalar zero; an Fq12 factor of one
    rng = np.random.default_rng(5)
    eight, one = (_pipeline_args(T.microbench_sets(k), rng) for k in (8, 1))
    for args in (one, eight[:7] + (torch.zeros_like(eight[7]),) + eight[8:],
                 eight[:6] + (torch.zeros_like(eight[6]),) + eight[7:]):
        host = tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in args)
        assert torch.equal(bb.pipeline_device(*args).cpu(), bb.pipeline_plain(*host))
    f = bi.to_tensor(np.stack([t12.fq12_to_words(Fq12(Fq6(Fq2(3, 4), Fq2(5, 6), Fq2(7, 8)),
                                                      Fq6(Fq2(9, 1), Fq2(2, 3), Fq2(4, 5))))]),
                     "cuda")
    for x, y in ((f, a[:1]), (a[:1], f)):
        assert torch.equal(dp.fq12_mul_device(x, y).cpu(), dp.fq12_mul_plain(x.cpu(), y.cpu()))


def _pipeline_args(sets, rng):
    """``pipeline_device`` arguments on the card for single-key sets."""
    sig_pts = [s.signature.point for s in sets]
    h2 = [bb._hash_to_g2_cached(s.message) for s in sets]
    px, py = (bi.ints_to_mont_limbs([s.pubkeys[0].point[k] for s in sets]) for k in (0, 1))
    scalars = [int(r) for r in rng.integers(1, 1 << 63, len(sets))]
    return bb._chunk_layout(sets, sig_pts, h2, px, py, scalars, torch.device("cuda"))
