"""The KZG kernels' per-thread code (``csrc/fr.cuh`` and the G1 and Miller
lane functions of ``csrc/bls12_381.cuh``) compiled as host C++ with g++,
against the plain PyTorch versions.

Every kernel of the KZG path is a thin ``__global__`` loop over functions of
those headers (``k_fr_eval`` runs its phases with a barrier between them;
the harness here runs each phase as a loop over the block's threads; the
group lanes of the G1 scalar multiplication, the Miller loop and the Fq12
product run through the header's host versions of those kernels, their
threads in the order the tests set).  Running them on the same inputs as
the plain versions checks the kernels' arithmetic bit for bit without a
card; the build with multiply counters also checks the Fr and Fp product
counts that bound the kernels' times.  The test marked ``cuda`` runs the
kernels themselves.
"""

import contextlib
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import native
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.pairing_fast import miller_loop_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_cuda, ec, fr, msm

R = fr.R_INT
CPU = torch.device("cpu")

HARNESS = r"""
#include <cstddef>
#include <vector>
#include "fr.cuh"
using std::size_t;
#include "bls12_381.cuh"
namespace fr { unsigned long long fr_mul_count = 0; }
namespace bls { unsigned long long bls_fp_mul_count = 0; }
namespace modinv { unsigned long long modinv_muladd_count = 0; }
extern "C" {
unsigned long long h_fr_count() { return fr::fr_mul_count; }
unsigned long long h_muladd_count() { return modinv::modinv_muladd_count; }
unsigned long long h_fp_count() { return bls::bls_fp_mul_count; }
void h_fr(int op, const uint32_t* a, const uint32_t* b, uint32_t* r, long n) {
    for (long i = 0; i < n; i++) {
        fr::Fr x, y, z;
        fr::ld(x, a, i);
        fr::ld(y, b, i);
        if (op == 0) fr::fr_mul(z, x, y);
        else if (op == 1) fr::fr_add(z, x, y);
        else if (op == 2) fr::fr_sub(z, x, y);
        else fr::fr_inv(z, x);
        fr::st(r, i, z);
    }
}
void h_to_mont(const uint8_t* raw, uint32_t* out, long n) { fr::host_fr_to_mont(raw, out, n, 256); }
// k_fr_to_mont's grid: every thread of its blocks of `threads`
void h_to_mont_grid(const uint8_t* raw, uint32_t* out, long n, long threads) {
    fr::host_fr_to_mont(raw, out, n, threads);
}
int h_to_mont_per() { return FR_TO_MONT_PER; }
// k_fr_eval for every blob: fr.cuh's host version, its phases as loops over
// the block's T threads at the kernel's chunk (width / T)
void h_eval(const uint32_t* f, const uint32_t* zs, const uint32_t* roots, const uint32_t* inv_w,
            uint32_t* y, long n, long width, int T) {
    fr::host_eval(f, zs, roots, inv_w, y, n, width, T);
}
void h_reverse(int on) { bls::level_order_reversed = on != 0; }
void h_g1_mul(const uint32_t* xs, const uint32_t* ys, const int32_t* d, uint32_t* X, uint32_t* Y,
              uint32_t* Z, long n, int n_digits) {
    bls::host_g1_scalar_mul(xs, ys, nullptr, d, X, Y, Z, n, n_digits);
}
void h_halves(uint32_t* X, uint32_t* Y, uint32_t* Z, long half) {
    for (long i = 0; i < half; i++) bls::lane_add_halves<bls::Fp>(i, half, X, Y, Z);
}
void h_miller(const uint32_t* xp, const uint32_t* yp, const uint32_t* zp, const uint32_t* xq,
              const uint32_t* yq, const uint32_t* zq, const uint8_t* mask, uint32_t* out, long n,
              long n_out) {
    bls::host_miller(xp, yp, zp, xq, yq, zq, mask, out, n, n_out, -1);
}
void h_fq12_halves(uint32_t* f, long half) {
    bls::host_fq12_mul(f, f + (size_t)half * 144, f, half);
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
    """The headers' lane functions built for the host, with the Fr and Fp
    multiplication counters on."""
    d = tmp_path_factory.mktemp("kzg_lanes")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DFR_COUNT_MULS", "-DBLS_COUNT_FP_MULS", "-DMODINV_COUNT_MULADDS",
                    f"-I{native.CSRC}",
                    str(d / "harness.cc"), "-o", str(so)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_fr_count.restype = ctypes.c_ulonglong
    lib.h_fp_count.restype = ctypes.c_ulonglong
    lib.h_muladd_count.restype = ctypes.c_ulonglong
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


def _counted(counter, fn, *args) -> int:
    before = counter()
    fn(*args)
    return counter() - before


@contextlib.contextmanager
def _level_order(lib, reverse: bool):
    """Run the group lanes' level loops in descending order if ``reverse``."""
    lib.h_reverse(int(reverse))
    try:
        yield
    finally:
        lib.h_reverse(0)


def _fr_vals(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n - 3)]


def test_fr_lane_ops_equal_ints(lanes):
    a, b = _fr_vals(8, 1), _fr_vals(8, 2)[::-1]
    A, B, out = fr.to_mont_host(a), fr.to_mont_host(b), np.zeros((8, 8), np.uint32)
    for op, f in ((0, lambda x, y: x * y), (1, lambda x, y: x + y), (2, lambda x, y: x - y)):
        n = _counted(lanes.h_fr_count, lanes.h_fr, op, _ptr(A), _ptr(B), _ptr(out),
                     ctypes.c_long(8))
        assert n == (8 if op == 0 else 0)
        assert fr.FR.mont_limbs_to_ints(out) == [f(x, y) % R for x, y in zip(a, b)]
    n = _counted(lanes.h_fr_count, lanes.h_fr, 3, _ptr(A), _ptr(B), _ptr(out), ctypes.c_long(8))
    assert n == 8 * fr.FR_INV
    assert fr.FR.mont_limbs_to_ints(out) == [pow(x, -1, R) if x else 0 for x in a]
    plain = fr.mont_mul(bi.u64(_t(A)), bi.u64(_t(B)))
    lanes.h_fr(0, _ptr(A), _ptr(B), _ptr(out), ctypes.c_long(8))
    assert np.array_equal(out, bi.to_numpy(plain))


def test_to_mont_lanes_equal_plain(lanes):
    vals = _fr_vals(6, 3) + [R, (1 << 256) - 1]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals), np.uint8).reshape(8, 32)
    raw = raw.copy()
    out = np.zeros((8, 8), np.uint32)
    n = _counted(lanes.h_fr_count, lanes.h_to_mont, _ptr(raw), _ptr(out), ctypes.c_long(8))
    assert n == 8
    assert np.array_equal(out, bi.to_numpy(fr.fr_to_mont_plain(torch.from_numpy(raw))))
    assert fr.FR.mont_limbs_to_ints(out) == [v % R for v in vals]


EDGE_VALUES = [0, 1, R - 1, R, R + 1, (1 << 256) - 1]


@pytest.mark.parametrize("threads", [1, 3, 8, 64])
def test_to_mont_grid_equals_plain_and_the_jax_program(lanes, threads):
    """Row 16's vector path: every thread of the kernel's grid
    (FR_TO_MONT_PER elements a thread, a block's width apart, as two 16-byte
    loads each, all loads before the first product) over a count that is
    not a multiple of the elements a thread, with the edge values among
    random ones: grids of 1 to 69 blocks."""
    from lighthouse_tpu.ops import fr as jfr

    per = lanes.h_to_mont_per()
    vals = EDGE_VALUES + _fr_vals(131, 11)      # 137 elements
    assert len(vals) % per
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals), np.uint8)
    raw = raw.reshape(-1, 32).copy()
    out = np.full((len(vals), 8), 0xDEADBEEF, np.uint32)
    n = _counted(lanes.h_fr_count, lanes.h_to_mont_grid, _ptr(raw), _ptr(out),
                 ctypes.c_long(len(vals)), ctypes.c_long(threads))
    assert n == len(vals)                       # one product an element, each once
    assert np.array_equal(out, bi.to_numpy(fr.fr_to_mont_plain(torch.from_numpy(raw))))
    want = [v % R for v in vals]
    assert fr.FR.mont_limbs_to_ints(out) == want
    jax_m = jfr._TO_MONT_JIT(jfr.be32_bytes_to_limbs(raw))
    assert [int(v) for v in jfr.from_mont_host(np.asarray(jax_m))] == want


def test_to_mont_wrapper_raises_on_a_misaligned_view():
    buf = torch.zeros(32 * 4 + 16, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    fr.fr_to_mont_device(buf[16:16 + 32 * 4].view(4, 32))      # aligned: runs
    with pytest.raises(ValueError, match="16-byte aligned"):
        fr.fr_to_mont_device(buf[1:1 + 32 * 4].view(4, 32))


@pytest.mark.parametrize("width", [16, 64, 2, 4, 8, 512])
def test_eval_phases_equal_plain_with_a_root_hit(lanes, width):
    """The kernel's phases at each chunk its template takes: W = 2, 4, 8
    and 16 run one thread of W points per blob, W = 64 four threads of 16
    points (a product tree of two levels), W = 512 32 threads of 16; blob
    1's challenge is a domain point, whose row both versions finish with
    zero inverses.  The work: the Fr products of ``eval_fr_muls`` plus one
    (by R^3) a blob, and each root's divsteps as ``eval_muladds`` counts
    them."""
    settings = kzg.KzgSettings.dev(width, device="cpu")
    rng = np.random.default_rng(width)
    n = 3
    f = fr.to_mont_host([int.from_bytes(rng.bytes(32), "big") % R for _ in range(n * width)])
    f = f.reshape(n, width, 8)
    zs = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    zs[1] = settings.roots_brp[5 % width]
    z = fr.to_mont_host(zs)
    roots = fr.to_mont_host(settings.roots_brp)
    inv_w = fr.to_mont_host([pow(width, -1, R)])
    y = np.zeros((n, 8), np.uint32)
    threads, _ = fr.eval_threads(width)
    adds = lanes.h_muladd_count()
    count = _counted(lanes.h_fr_count, lanes.h_eval, _ptr(f), _ptr(z), _ptr(roots), _ptr(inv_w),
                     _ptr(y), ctypes.c_long(n), ctypes.c_long(width), ctypes.c_int(threads))
    adds = lanes.h_muladd_count() - adds
    assert count == fr.eval_fr_muls(n, width) + n
    assert count * fr.IMADS_PER_FR_MUL + adds == fr.eval_muladds(zs, width)
    plain = fr.eval_plain(_t(f), _t(z), _t(roots), _t(inv_w))
    assert np.array_equal(y, bi.to_numpy(plain))
    polys = [fr.FR.mont_limbs_to_ints(f[i]) for i in range(n)]
    for i in (0, 2):
        assert fr.FR.from_mont(y[i]) == kzg.evaluate_polynomial_in_evaluation_form(
            polys[i], zs[i], settings)
    assert fr.FR.from_mont(y[1]) == 0


def test_eval_product_count_at_the_cell():
    """768 blobs of 4096: 256 threads of 16 points, 5 products a point less
    3 a thread, 3 per tree node, 12 squarings and 2; the root's inversion,
    now divsteps, counts apart as multiply-adds (a challenge on the domain
    has a zero root: the product by R^3 alone).  Fermat's fr_inv (255
    squarings, 164 set bits of r - 2) stays for its own callers."""
    assert fr.FR_INV == 255 + 164
    per_blob = 256 * (5 * 16 - 3) + 3 * 255 + 12 + 2
    assert fr.eval_fr_muls(768, 4096) == 768 * per_blob
    assert fr.IMADS_PER_FR_MUL == 136
    roots = kzg._bit_reversal_permutation(kzg._compute_roots_of_unity(4096))
    zs = [5, roots[77]]
    root5 = (pow(5, 4096, R) - 1) * fr.RADIX % R
    assert fr.eval_muladds(zs, 4096) == (2 * per_blob * 136 + fr.inv_muladds(root5) + 136)
    assert 136 < fr.inv_muladds(root5) < 419 * 136 // 10


def test_g1_scalar_mul_and_fold_lanes_equal_plain(lanes):
    g1 = cv.g1_generator()
    rng = np.random.default_rng(4)
    n = 8
    pts = [cv.g1_mul(g1, 11 + 3 * i) for i in range(n)]
    # random 255-bit scalars, one with leading and inner zero digits, a zero one
    ks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    ks[2] = 0x0F000000000000000000000000000000000000000000000000000000000301
    ks[5] = 0
    xs, ys, digits = (t.numpy() for t in msm._fold_lanes(pts, ks, n, CPU))
    xs, ys = xs.view(np.uint32), ys.view(np.uint32)
    X, Y, Z = (np.zeros((n, 12), np.uint32) for _ in range(3))
    count = _counted(lanes.h_fp_count, lanes.h_g1_mul, _ptr(xs), _ptr(ys), _ptr(digits), _ptr(X),
                     _ptr(Y), _ptr(Z), ctypes.c_long(n), ctypes.c_int(64))
    assert count == bls_cuda.g1_scalar_mul_fp_muls(digits)
    plain = ec.g1_scalar_mul_windowed(bi.u64(_t(xs)), bi.u64(_t(ys)),
                                      torch.from_numpy(digits.astype(np.int64)))
    for got, want in zip((X, Y, Z), plain):
        assert np.array_equal(got, bi.to_numpy(want))
    assert msm.jacobian_rows_to_affine(X, Y, Z) == [cv.g1_mul(p, k) if k else cv.INF
                                                    for p, k in zip(pts, ks)]
    # the tree down to 2 segments (s-major): the wrapper's add-halves levels
    count = 0
    half = n // 2
    while half >= 2:
        count += _counted(lanes.h_fp_count, lanes.h_halves, _ptr(X), _ptr(Y), _ptr(Z),
                          ctypes.c_long(half))
        half //= 2
    assert bls_cuda.g1_scalar_mul_fp_muls(digits) + count == bls_cuda.g1_fold_fp_muls(digits, 2)
    Xp, Yp, Zp = msm.fold_plain(_t(xs), _t(ys), torch.from_numpy(digits), 2)
    for got, want in zip((X, Y, Z), (Xp, Yp, Zp)):
        assert np.array_equal(got[:2], bi.to_numpy(want))
    want = [msm.host_lincomb_groups(pts, ks, [i % 2 for i in range(n)], 2)[g] for g in (0, 1)]
    assert msm.jacobian_rows_to_affine(X[:2], Y[:2], Z[:2]) == want


@pytest.mark.parametrize("reverse", [False, True], ids=["ascending", "descending"])
def test_g1_scalar_mul_lanes_in_both_orders_equal_plain_and_the_jax_curve(lanes, reverse):
    """The G1 lanes of row 13 in both level orders, at 255-bit scalars: a
    random one, zero, r (the last add sums P and -P to infinity), r - 1, one,
    leading and inner zero digits, and a point of order 3 times 3 (its
    table's entries 3, 6, 10 and 12 are infinity, so 7, 11 and 13 copy the
    base).  Equal to the
    plain version word for word and, in affine form, to the JAX package's
    ``g1_mul``; the products are those ``bls_cuda`` counts for every lane
    whose table has no infinity entry, and the order-3 lane's table."""
    from lighthouse_tpu.crypto.bls import curve as jcv

    g1 = cv.g1_generator()
    rng = np.random.default_rng(14)
    pts = [cv.g1_mul(g1, 5 + 7 * i) for i in range(8)]
    ks = [int.from_bytes(rng.bytes(32), "big") % R, 0, R, R - 1, 1,
          0x0F000000000000000000000000000000000000000000000000000000000301,
          int.from_bytes(rng.bytes(32), "big") % R, 3]
    pts[7] = T.ORDER3_G1
    n = len(ks)
    xs, ys = (bi.to_numpy(t) for t in ec.g1_words(pts, CPU))
    digits = ec.scalars_to_digits(ks, n_bits=256).astype(np.int32)
    X, Y, Z = (np.zeros((n, 12), np.uint32) for _ in range(3))
    with _level_order(lanes, reverse):
        count = _counted(lanes.h_fp_count, lanes.h_g1_mul, _ptr(xs), _ptr(ys), _ptr(digits),
                         _ptr(X), _ptr(Y), _ptr(Z), ctypes.c_long(n), ctypes.c_int(64))
    plain = ec.g1_scalar_mul_windowed(bi.u64(_t(xs)), bi.u64(_t(ys)),
                                      torch.from_numpy(digits.astype(np.int64)))
    for got, want in zip((X, Y, Z), plain):
        assert np.array_equal(got, bi.to_numpy(want))
    got = msm.jacobian_rows_to_affine(X, Y, Z)
    assert got == [jcv.g1_mul(p, k) for p, k in zip(pts, ks)]
    assert got[1] is got[2] is got[7] is cv.INF and got[3] == cv.g1_neg(pts[3])
    # lane 7: the table's 7 doublings and the adds to entries 3, 5, 9 and 15
    # (entries 6, 10 and 12 are infinity, so 7, 11 and 13 copy the base)
    assert count == bls_cuda.g1_scalar_mul_fp_muls(digits[:, :7]) + 7 * bls_cuda.JAC_DOUBLE + \
        4 * bls_cuda.JAC_ADD


def test_msm_g1_tensor_route_equals_the_host_seam(monkeypatch):
    """``msm_g1`` through row 13's plain version (forced at 16 lanes, padded
    to 32) gives the commitment the native host seam gives."""
    settings = kzg.KzgSettings.dev(16, device="cpu")
    blob = T.kzg_blob(16, np.random.default_rng(9))
    want = kzg.blob_to_kzg_commitment(blob, settings, "cpu")
    monkeypatch.setattr(msm, "_STATIC_DEVICE_MIN", 1)
    poly = kzg.blob_to_polynomial(blob, settings)
    got = msm.msm_g1(settings.g1_lagrange_brp, poly, device="cpu", pad_to=32)
    assert cv.g1_to_bytes(got) == want
    assert msm.lincomb_per_point(settings.g1_lagrange_brp[:3], [5, 0, 7], device="cpu") == \
        msm.host_lincomb_groups(settings.g1_lagrange_brp[:3], [5, 0, 7], range(3), 3)


def test_miller_jp_lanes_mask_infinity_and_equal_plain(lanes):
    """The Miller lane as ``kzg_fused_device`` launches it (Zq = 1, mask
    Z != 0).  Lane 0: P in Jacobian form (Z = 5), lane 1: P at infinity
    (Z = 0, one, no products), lanes 2-3: padding.  Lane 0 equals the plain
    Miller loop word for word and, after the final exponentiation, the
    affine pairing_fast oracle; then the product levels."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    p = cv.g1_mul(g1, 21)
    q = [cv.g2_neg(g2), cv.g2_mul(g2, 33)]
    z = 5
    xp = bi.ints_to_mont_limbs([p[0] * z * z % bi.P_INT, 0])
    yp = bi.ints_to_mont_limbs([p[1] * z ** 3 % bi.P_INT, 0])
    zp = bi.ints_to_mont_limbs([z, 0])
    xq, yq = (bi.to_numpy(t) for t in ec.g2_words(q, CPU))
    zq = bi.to_numpy(t12.fp2_one_like(_t(xq)).contiguous())
    mask = (zp != 0).any(-1).astype(np.uint8)
    out = np.zeros((4, 12, 12), np.uint32)
    count = _counted(lanes.h_fp_count, lanes.h_miller, _ptr(xp), _ptr(yp), _ptr(zp), _ptr(xq),
                     _ptr(yq), _ptr(zq), _ptr(mask), _ptr(out), ctypes.c_long(2),
                     ctypes.c_long(4))
    live = np.array([True, False, False, False])
    assert count == bls_cuda.MILLER_LANE
    one = t12.fq12_to_words(t12.Fq12.ONE)
    assert all(np.array_equal(out[i], one) for i in (1, 2, 3))
    plain = t12.batch_miller_loop_plain(bi.u64(_t(xp[:1])), bi.u64(_t(yp[:1])), bi.u64(_t(zp[:1])),
                                        bi.u64(_t(xq[:1])), bi.u64(_t(yq[:1])),
                                        t12.fp2_one_like(bi.u64(_t(xq[:1]))))
    assert np.array_equal(out[0], bi.to_numpy(t12.fq12_flat(plain))[0])
    from lighthouse_tpu_torch.ops import native_bls
    assert native_bls.final_exp(t12.fq12_from_words(out[0])) == \
        native_bls.final_exp(miller_loop_fast(p, q[0]))
    count = _counted(lanes.h_fp_count, lanes.h_fq12_halves, _ptr(out), ctypes.c_long(2))
    count += _counted(lanes.h_fp_count, lanes.h_fq12_halves, _ptr(out), ctypes.c_long(1))
    assert count == 0 == bls_cuda.miller_reduce_fp_muls(live) - bls_cuda.MILLER_LANE
    assert np.array_equal(out[0], bi.to_numpy(t12.fq12_flat(plain))[0])


def test_fused_lane_layout_interleaves_both_msms():
    g1 = cv.g1_generator()
    lhs = [cv.g1_mul(g1, 3), cv.INF, cv.g1_mul(g1, 4)]
    pis = [cv.g1_mul(g1, 5), cv.g1_mul(g1, 6)]
    xs, ys, digits = kzg.fused_lanes(lhs, [7, 8, 0], pis, [1, R + 2], CPU)
    assert xs.shape == (8, 12) and digits.shape == (64, 8)
    ints = bi.mont_limbs_to_ints(bi.to_numpy(xs))
    assert ints[0::2] == [lhs[0][0], 0, 0, 0]           # INF and a zero scalar: identity lanes
    assert ints[1::2] == [pis[0][0], pis[1][0], 0, 0]
    ks = ec.scalars_to_digits([7, 5 * 0 + 1, 0, 2, 0, 0, 0, 0], n_bits=256)
    assert np.array_equal(digits.numpy(), ks.astype(np.int32))
    with pytest.raises(kzg.KzgError):
        kzg.fused_lanes(lhs, [1, 1, 1], pis * 3, [1] * 6, CPU)


@pytest.mark.cuda
def test_every_kzg_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    kzg.reset_launches()
    cell = T.kzg_cell(256, 8, 1, 5, device="cuda")
    settings = cell["settings"]
    tau, roots = 0x123456789ABCDEF, settings.roots_brp
    lagrange_k = [w_i * (pow(tau, 256, R) - 1) * pow(256 * (tau - w_i), -1, R) % R
                  for w_i in roots[:8]]
    assert settings.g1_lagrange_brp[:8] == msm.host_lincomb_groups(
        [cv.g1_generator()] * 8, lagrange_k, range(8), 8)
    uniq, cs, _ = cell["unique"]
    for blob, c in zip(uniq[:2], cs[:2]):
        want = msm.host_lincomb_groups(settings.g1_lagrange_brp,
                                       kzg.blob_to_polynomial(blob, settings), None, 1)[0]
        assert c == cv.g1_to_bytes(want)
    assert kzg.verify_blob_kzg_proof_batch(cell["blobs"], cell["commitments"], cell["proofs"],
                                           settings)
    for v in cell["variants"]:
        assert kzg._verify_batch(v["blobs"], v["commitments"], v["proofs"], settings,
                                 torch.device("cuda"), zs=v["challenges"]) == v["valid"], v["name"]
    assert kzg.verify_blob_kzg_proof_batch(cell["blobs"][:3], cell["commitments"][:3],
                                           cell["proofs"][:3], settings)
    assert all(k.launches > 0 for k in kzg.KERNELS), {k.__name__: k.launches for k in kzg.KERNELS}
    # the group kernels' edge batches: one lane, every scalar zero, every
    # Miller lane masked
    g1 = cv.g1_generator()
    pts = [cv.g1_mul(g1, 3 + i) for i in range(8)]
    xs, ys, digits = msm._fold_lanes(pts, [R - 1 - i for i in range(8)], 8, torch.device("cuda"))
    zero = torch.zeros_like(digits)
    xq, yq = settings.g2_rows(torch.device("cuda"))
    cases = [(msm.fold_device, msm.fold_plain, (xs[:1], ys[:1], digits[:, :1].contiguous(), 1)),
             (msm.fold_device, msm.fold_plain, (xs, ys, zero, 2)),
             (kzg.kzg_fused_device, kzg.kzg_fused_plain, (xs[:2], ys[:2],
                                                          digits[:, :2].contiguous(), xq, yq)),
             (kzg.kzg_fused_device, kzg.kzg_fused_plain, (xs, ys, zero, xq, yq))]
    mp = t12.points_to_device([(pts[0], cv.g2_generator()), (pts[1], cv.g2_generator())])
    mr = tuple(bi.to_tensor(c, "cuda") for c in mp[:4]) + (torch.from_numpy(mp[4]).cuda(),)
    cases += [(t12.miller_reduce_device, t12.miller_reduce_plain, tuple(x[:1] for x in mr)),
              (t12.miller_reduce_device, t12.miller_reduce_plain,
               mr[:4] + (torch.zeros_like(mr[4]),))]
    # raw to Montgomery over counts that are not a multiple of the kernel's
    # elements a thread, the edge values among them
    vals = EDGE_VALUES + _fr_vals(4099, 12)
    raw = torch.from_numpy(np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                                         np.uint8).reshape(-1, 32).copy()).cuda()
    cases += [(fr.fr_to_mont_device, fr.fr_to_mont_plain, (raw[:k],)) for k in (1, 7, len(vals))]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fr.fr_to_mont_device(raw.view(-1)[8:8 + 32 * 4].view(4, 32))
    for kernel, plain, args in cases:
        got, want = kernel(*args), plain(*(x.cpu() if isinstance(x, torch.Tensor) else x
                                           for x in args))
        for g_, w_ in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert torch.equal(g_.cpu(), w_), kernel.__name__
    assert fr.FR.mont_limbs_to_ints(bi.to_numpy(fr.fr_to_mont_device(raw))) == [v % R for v in vals]
