"""Row 9, the hard part of the final exponentiation, and its route.

``ops/bls12_381.final_exp_hard_device`` (``lh_final_exp_hard`` in
``csrc/bls12_381.cu``) against its plain version, the host oracle
``fields.final_exp_hard`` and the JAX package's ``final_exp_hard_device``,
on cyclotomic lanes m = ``final_exp_easy(f)`` (the Granger-Scott square is
right only there).  Values are compared as canonical integers, tolerance 0.
The kernel's lane code is built for the host with g++ and held to the
oracle piece by piece, with the Fp product count behind its bound: the
group lane the kernel runs (a warp's threads run one after another, in
ascending and in descending order) word for word against the one-thread
lane, the plain version and the oracle.  The
JAX package's host ``final_exp_hard``, ``frobenius`` and ``_pow_u_cyc``
are the cheap reference in every run; its jitted device function (an XLA
compile of about 90 s) is the ``slow`` A/B.  The
route (``bls_backend.final_exp_is_one`` under ``LHGPU_DEVICE_FINAL_EXP``)
gives the native verdicts on the CPU, defaults to the device on a CUDA
device and to the native library on the CPU, and a fault in row 9 raises.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import fields as jfields
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls import fields
from lighthouse_tpu_torch.crypto.bls.fields import P, Fq2, Fq6, Fq12
from lighthouse_tpu_torch.crypto.bls.pairing_fast import miller_loop_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import bls_cuda, native_bls

CPU = torch.device("cpu")

HARNESS = r"""
#include "bls12_381.cuh"
using namespace bls;
namespace bls { unsigned long long bls_fp_mul_count = 0; }
extern "C" {
unsigned long long h_count() { return bls::bls_fp_mul_count; }
void h_reverse(int on) { level_order_reversed = on != 0; }
// the group lane the kernel runs (a warp's threads in turn)
void h_fe_group(const u32* in, u32* out, long n) { host_final_exp_hard(in, out, n); }
// op 0: the whole hard part; 1: cyclotomic square; 2: x-ladder;
// 3..5: Frobenius p, p^2, p^3
void h_fe(int op, const u32* in, u32* out, long n) {
    for (long i = 0; i < n; i++) {
        if (op == 0) { lane_final_exp_hard(i, in, out); continue; }
        Fp12 m, r;
        ld(m, in, i);
        if (op == 1) fp12_cyclotomic_sqr(r, m);
        else if (op == 2) cyc_exp_x(r, m);
        else fp12_frobenius(r, m, op - 2);
        st(out, i, r);
    }
}
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cyclotomic(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)

    def f2():
        return Fq2(int.from_bytes(rng.bytes(48), "big") % P,
                   int.from_bytes(rng.bytes(48), "big") % P)

    return [fields.final_exp_easy(Fq12(Fq6(f2(), f2(), f2()), Fq6(f2(), f2(), f2())))
            for _ in range(n)]


def _rows(ms) -> np.ndarray:
    return np.ascontiguousarray(np.stack([t12.fq12_to_words(m) for m in ms]).astype(np.uint32))


def _values(rows) -> list:
    rows = np.asarray(rows, np.uint32)
    return [t12.fq12_from_words(rows[i]) for i in range(rows.shape[0])]


def _coeffs(f) -> list:
    return [int(c) for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]


def _to_jax(m):
    c = _coeffs(m)
    f2s = [jfields.Fq2(c[k], c[k + 1]) for k in range(0, 12, 2)]
    return jfields.Fq12(jfields.Fq6(*f2s[:3]), jfields.Fq6(*f2s[3:]))


def _jax_hard(m) -> list:
    """The JAX package's host final_exp_hard of m, as canonical integers."""
    return _coeffs(jfields.final_exp_hard(_to_jax(m)))


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    d = tmp_path_factory.mktemp("final_exp_lanes")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DBLS_COUNT_FP_MULS", f"-I{native.CSRC}", str(d / "harness.cc"),
                    "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_count.restype = ctypes.c_ulonglong
    return lib


def _run_lanes(lib, op: int, rows: np.ndarray) -> tuple[np.ndarray, int]:
    out = np.zeros_like(rows)
    before = lib.h_count()
    lib.h_fe(ctypes.c_int(op), ctypes.c_void_p(rows.ctypes.data), ctypes.c_void_p(out.ctypes.data),
             ctypes.c_long(rows.shape[0]))
    return out, lib.h_count() - before


def test_plain_version_equals_the_host_oracle():
    ms = _cyclotomic(1, 3) + [Fq12.ONE]
    got = _values(bi.to_numpy(t12.final_exp_hard_device(bi.to_tensor(_rows(ms), CPU))))  # plain
    assert got == [fields.final_exp_hard(m) for m in ms]
    assert [_coeffs(g) for g in got] == [_jax_hard(m) for m in ms]
    assert got[-1] == Fq12.ONE


def test_plain_pieces_equal_the_host_tower():
    (m,) = _cyclotomic(2, 1)
    x = t12.fq12_nested(bi.u64(bi.to_tensor(_rows([m]), CPU)))

    def val(t):
        return _values(bi.to_numpy(bi.i32(t12.fq12_flat(t))))[0]

    assert val(t12.fp12_cyclotomic_sqr(x)) == m.square()
    for n in (1, 2, 3):
        assert val(t12.fp12_frobenius(x, n)) == fields.frobenius(m, n)
        assert _coeffs(val(t12.fp12_frobenius(x, n))) == _coeffs(jfields.frobenius(_to_jax(m), n))
    assert val(t12.cyc_exp_x(x)) == fields._pow_u_cyc(m).conj()
    assert _coeffs(val(t12.cyc_exp_x(x))) == _coeffs(jfields._pow_u_cyc(_to_jax(m)).conj())


def test_lane_code_equals_the_oracle_and_its_product_count(lanes):
    ms = _cyclotomic(3, 2) + [Fq12.ONE]
    rows = _rows(ms)
    out, count = _run_lanes(lanes, 0, rows)
    assert _values(out) == [fields.final_exp_hard(m) for m in ms]
    assert [_coeffs(v) for v in _values(out)] == [_jax_hard(m) for m in ms]
    assert count == len(ms) * bls_cuda.FINAL_EXP_HARD_LANE
    sq, sq_count = _run_lanes(lanes, 1, rows[:2])
    assert _values(sq) == [m.square() for m in ms[:2]]
    assert sq_count == 2 * bls_cuda.CYC_SQR
    ladder, ladder_count = _run_lanes(lanes, 2, rows[:1])
    assert _values(ladder)[0] == fields._pow_u_cyc(ms[0]).conj()
    assert _coeffs(_values(ladder)[0]) == _coeffs(jfields._pow_u_cyc(_to_jax(ms[0])).conj())
    assert ladder_count == bls_cuda.CYC_EXP_X
    for n in (1, 2, 3):
        frob, frob_count = _run_lanes(lanes, 2 + n, rows[:1])
        assert _values(frob)[0] == fields.frobenius(ms[0], n)
        assert _coeffs(_values(frob)[0]) == _coeffs(jfields.frobenius(_to_jax(ms[0]), n))
        assert frob_count == n * bls_cuda.FROBENIUS_ROUND


@pytest.fixture(scope="module")
def group_case():
    """Random cyclotomic lanes, the conjugate (inverse) of the first, and one,
    with the plain version's rows and the host oracle's values."""
    ms = _cyclotomic(6, 2)
    ms += [ms[0].conj(), Fq12.ONE]
    rows = _rows(ms)
    plain = np.ascontiguousarray(bi.to_numpy(t12.final_exp_hard_plain(bi.to_tensor(rows, CPU))))
    return ms, rows, plain, [fields.final_exp_hard(m) for m in ms]


@pytest.mark.parametrize("reverse", [False, True], ids=["ascending", "descending"])
def test_group_lane_equals_the_one_thread_lane_plain_and_oracle(lanes, group_case, reverse):
    """The kernel's group lane (host build, the warp's threads in either
    order) word for word against the one-thread lane and the plain version,
    equal to fields.final_exp_hard and the JAX package's host final_exp_hard,
    with FINAL_EXP_HARD_LANE products a lane."""
    ms, rows, plain, oracle = group_case
    out = np.zeros_like(rows)
    lanes.h_reverse(int(reverse))
    try:
        before = lanes.h_count()
        lanes.h_fe_group(ctypes.c_void_p(rows.ctypes.data), ctypes.c_void_p(out.ctypes.data),
                         ctypes.c_long(rows.shape[0]))
        count = lanes.h_count() - before
    finally:
        lanes.h_reverse(0)
    one_thread, _ = _run_lanes(lanes, 0, rows)
    assert np.array_equal(out, one_thread)
    assert np.array_equal(out, plain)
    assert _values(out) == oracle
    assert [_coeffs(v) for v in _values(out)] == [_jax_hard(m) for m in ms]
    assert oracle[2] == oracle[0].conj() and oracle[3] == Fq12.ONE
    assert count == len(ms) * bls_cuda.FINAL_EXP_HARD_LANE


def test_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        t12.final_exp_hard_device(bi.u64(bi.to_tensor(_rows([Fq12.ONE]), CPU)))
    with pytest.raises(ValueError):
        t12.final_exp_hard_device(bi.to_tensor(_rows([Fq12.ONE]), CPU)[0])


def _pairing_products():
    """Miller products whose final exponentiation is one (e(P, Q) e(-P, Q))
    and is not (e(P, Q) alone)."""
    p, q = cv.g1_mul(cv.g1_generator(), 7), cv.g2_mul(cv.g2_generator(), 11)
    f_pq = miller_loop_fast(p, q)
    return f_pq * miller_loop_fast(cv.g1_neg(p), q), f_pq


def test_route_gives_the_native_verdicts_on_the_cpu(monkeypatch):
    one, not_one = _pairing_products()
    monkeypatch.delenv("LHGPU_DEVICE_FINAL_EXP", raising=False)
    assert not bb.device_final_exp(CPU)
    native_verdicts = [bb.final_exp_is_one(f, CPU) for f in (one, not_one)]
    assert native_verdicts == [True, False]
    monkeypatch.setenv("LHGPU_DEVICE_FINAL_EXP", "1")
    assert bb.device_final_exp(CPU)
    monkeypatch.setattr(native_bls, "final_exp_is_one",
                        lambda f: pytest.fail("the device route called the native library"))
    assert [bb.final_exp_is_one(f, CPU) for f in (one, not_one)] == native_verdicts
    monkeypatch.setenv("LHGPU_DEVICE_FINAL_EXP", "2")
    with pytest.raises(ValueError):
        bb.device_final_exp(CPU)


def test_route_default_on_the_cpu_is_native(monkeypatch):
    """Unset, the route follows the device: the CPU keeps the native host
    final exponentiation (not the plain ladder); 0 and 1 force a route."""
    one, not_one = _pairing_products()
    monkeypatch.delenv("LHGPU_DEVICE_FINAL_EXP", raising=False)
    assert bb.device_final_exp("cpu") is False
    monkeypatch.setattr(t12, "final_exp_hard_plain",
                        lambda m: pytest.fail("the CPU default ran the device route"))
    assert [bb.final_exp_is_one(f, CPU) for f in (one, not_one)] == [True, False]
    for env, want in (("0", False), ("1", True)):
        monkeypatch.setenv("LHGPU_DEVICE_FINAL_EXP", env)
        assert bb.device_final_exp(CPU) is want
        assert bb.device_final_exp(torch.device("cuda")) is want


def test_route_default_on_a_cuda_device_is_the_device(monkeypatch):
    """Unset, a CUDA device takes row 9 (the card here stands in: its
    tensors are made on the CPU and row 9 is its plain version), the easy
    part on the host, and never the native library."""
    one, not_one = _pairing_products()
    monkeypatch.delenv("LHGPU_DEVICE_FINAL_EXP", raising=False)
    cuda = torch.device("cuda")
    assert bb.device_final_exp(cuda) is True
    assert bb.device_final_exp("cuda:0") is True
    to_tensor, seen = bi.to_tensor, []
    monkeypatch.setattr(bi, "to_tensor", lambda a, device: seen.append(torch.device(device))
                        or to_tensor(a, CPU))
    monkeypatch.setattr(t12, "final_exp_hard_device",
                        lambda m: seen.append("row 9") or t12.final_exp_hard_plain(m))
    monkeypatch.setattr(native_bls, "final_exp_is_one",
                        lambda f: pytest.fail("the CUDA default called the native library"))
    assert [bb.final_exp_is_one(f, cuda) for f in (one, not_one)] == [True, False]
    assert seen == [cuda, "row 9"] * 2


def test_batch_verify_on_the_device_route(monkeypatch):
    monkeypatch.setenv("LHGPU_DEVICE_FINAL_EXP", "1")
    sets = T.microbench_sets(2)
    calls = []
    plain = t12.final_exp_hard_plain
    monkeypatch.setattr(t12, "final_exp_hard_plain", lambda m: calls.append(1) or plain(m))
    assert bls.verify_signature_sets(T.fresh(sets), backend="cuda", device="cpu")
    assert not bls.verify_signature_sets(T.with_wrong_message(T.fresh(sets), 1), backend="cuda",
                                         device="cpu")
    assert len(calls) == 2


def test_a_fault_in_row_9_raises_and_nothing_falls_back(monkeypatch):
    one, _ = _pairing_products()
    monkeypatch.setenv("LHGPU_DEVICE_FINAL_EXP", "1")
    monkeypatch.setattr(native_bls, "final_exp_is_one",
                        lambda f: pytest.fail("a row 9 fault fell back to the native library"))

    def boom(m):
        raise RuntimeError("injected row 9 fault")

    monkeypatch.setattr(t12, "final_exp_hard_plain", boom)
    with pytest.raises(RuntimeError, match="injected row 9 fault"):
        bb.final_exp_is_one(one, CPU)
    # garbage words (not a field element) raise too
    monkeypatch.setattr(t12, "final_exp_hard_plain", lambda m: torch.full_like(m, -1))
    with pytest.raises(RuntimeError, match="non-canonical"):
        bb.final_exp_is_one(one, CPU)


@pytest.mark.slow
def test_plain_version_equals_the_jax_device_function():
    """The JAX package's final_exp_hard_device jitted on the CPU (its XLA
    compile takes about 90 s), lane by lane, against the plain version."""
    import jax

    from lighthouse_tpu.ops import bls12_381 as jdev

    ms = _cyclotomic(4, 2) + [Fq12.ONE]
    got = _values(bi.to_numpy(t12.final_exp_hard_plain(bi.to_tensor(_rows(ms), CPU))))
    run = jax.jit(jdev.final_exp_hard_device)
    for m, g in zip(ms, got):
        out = run(jdev.fq12_to_device(_to_jax(m)))
        want = jdev.fq12_from_device(jax.tree_util.tree_map(np.asarray, out))
        assert _coeffs(want) == _coeffs(g)


@pytest.mark.cuda
def test_row_9_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    ms = _cyclotomic(5, 3) + [Fq12.ONE]
    x = bi.to_tensor(_rows(ms), dev)
    before = t12.final_exp_hard_device.launches
    got = t12.final_exp_hard_device(x)
    want = t12.final_exp_hard_plain(x)
    torch.cuda.synchronize()
    assert t12.final_exp_hard_device.launches == before + 1
    assert torch.equal(got, want)
    assert _values(bi.to_numpy(got)) == [fields.final_exp_hard(m) for m in ms]
