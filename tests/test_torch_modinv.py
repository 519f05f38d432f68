"""The divstep inversion of ``csrc/modinv.cuh`` compiled as host C++ with
g++, for both of its moduli (p of BLS12-381's base field, 13 limbs; r of
its scalar field, 9 limbs), against ``pow(a, -1, m)``, the Fermat lanes
(``fp_inv``, ``fr_inv``) and the Python model of its work
(``ops/modinv.py``), value for value.

``fp_inv_var`` and ``fr_inv_var`` are the Montgomery-domain wrappers the
row 8 and row 15 kernels call: the divsteps on aR, then a product by R^3.
The build counts the header's 32-bit multiply-adds
(``MODINV_COUNT_MULADDS``) and the fields' products, which the kernels'
bounds count from the model.
"""

import ctypes
import subprocess

import numpy as np
import pytest

from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda, fr, modinv

P, R = bi.P_INT, fr.R_INT

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
unsigned long long h_muladds() { return modinv::modinv_muladd_count; }
unsigned long long h_products() { return fr::fr_mul_count + bls::bls_fp_mul_count; }
// op 0: the divsteps alone; 1: the Montgomery wrapper; 2: Fermat
void h_inv_p(int op, const uint32_t* a, uint32_t* out, long n) {
    for (long i = 0; i < n; i++) {
        bls::Fp x, y;
        bls::ld(x, a, i);
        if (op == 0) modinv::inv_var<13, 12>(y.w, x.w, bls::P30, P_INV30);
        else if (op == 1) bls::fp_inv_var(y, x);
        else bls::fp_inv(y, x);
        bls::st(out, i, y);
    }
}
void h_inv_r(int op, const uint32_t* a, uint32_t* out, long n) {
    for (long i = 0; i < n; i++) {
        fr::Fr x, y;
        fr::ld(x, a, i);
        if (op == 0) modinv::inv_var<9, 8>(y.w, x.w, fr::R30, R_INV30);
        else if (op == 1) fr::fr_inv_var(y, x);
        else fr::fr_inv(y, x);
        fr::st(out, i, y);
    }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("modinv")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DMODINV_COUNT_MULADDS", "-DFR_COUNT_MULS", "-DBLS_COUNT_FP_MULS",
                    f"-I{native.CSRC}", str(d / "harness.cc"), "-o", str(so)], check=True,
                   capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    h.h_muladds.restype = ctypes.c_ulonglong
    h.h_products.restype = ctypes.c_ulonglong
    return h


# modulus, words, R, the harness function, multiply-adds of a field product
FIELDS = {"p": (P, 12, 1 << 384, "h_inv_p", bls_cuda.IMADS_PER_FP_MUL),
          "r": (R, 8, 1 << 256, "h_inv_r", fr.IMADS_PER_FR_MUL)}


def _values(m: int, radix: int, seed: int) -> list[int]:
    """0, 1, m - 1, R mod m, powers of two below m and 64 seeded values."""
    rng = np.random.default_rng(seed)
    nbytes = (m.bit_length() + 7) // 8
    return ([0, 1, m - 1, radix % m] + [1 << k for k in range(0, m.bit_length() - 1, 23)]
            + [int.from_bytes(rng.bytes(nbytes), "little") % m for _ in range(64)])


def _words(vals: list[int], n_words: int) -> np.ndarray:
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(n_words)] for v in vals],
                    np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in words]


def _run(lib, fn: str, op: int, a: np.ndarray) -> tuple[np.ndarray, list, list]:
    """Each row inverted alone -> (outputs, multiply-adds, products) per row."""
    out = np.zeros_like(a)
    adds, prods = [], []
    for i in range(a.shape[0]):
        m0, p0 = lib.h_muladds(), lib.h_products()
        getattr(lib, fn)(op, ctypes.c_void_p(a[i:].ctypes.data),
                         ctypes.c_void_p(out[i:].ctypes.data), ctypes.c_long(1))
        adds.append(lib.h_muladds() - m0)
        prods.append(lib.h_products() - p0)
    return out, adds, prods


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_divsteps_equal_pow_and_the_model(lib, field):
    m, n_words, radix, fn, _ = FIELDS[field]
    vals = _values(m, radix, seed=len(field) + m % 97)
    out, adds, prods = _run(lib, fn, 0, _words(vals, n_words))
    assert _ints(out) == [pow(v, -1, m) if v else 0 for v in vals]
    model = [modinv.inverse(v, m) for v in vals]
    assert [x for x, _ in model] == _ints(out)
    assert adds == [c for _, c in model]
    assert adds[0] == 0 and min(adds[1:]) > 0 and set(prods) == {0}
    # 30 divsteps a batch (10N + 2 multiply-adds a batch besides the steps)
    n = modinv.n_limbs(m)
    assert n == {"p": 13, "r": 9}[field]
    assert all(c % 2 == 0 for c in adds) and max(adds) < 60 * (10 * n + 2 + 4 * 30)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_montgomery_wrapper_equals_the_fermat_lane(lib, field):
    """fp_inv_var / fr_inv_var on aR give a^-1 R, as the Fermat lanes do,
    with the divsteps' multiply-adds and one field product (by R^3)."""
    m, n_words, radix, fn, imads = FIELDS[field]
    vals = _values(m, radix, seed=7)
    mont = _words([v * radix % m for v in vals], n_words)
    var, adds, prods = _run(lib, fn, 1, mont)
    fermat, fermat_adds, _ = _run(lib, fn, 2, mont)
    assert np.array_equal(var, fermat)
    assert _ints(var) == [pow(v, -1, m) * radix % m if v else 0 for v in vals]
    assert set(fermat_adds) == {0} and set(prods) == {1}
    model = (bls_cuda.fp_inv_muladds(mont) if field == "p"
             else sum(fr.inv_muladds(x) for x in _ints(mont)))
    assert sum(adds) + len(vals) * imads == model


def test_model_rejects_what_the_header_does_not_take():
    with pytest.raises(ValueError):
        modinv.inverse(R, R)
    with pytest.raises(ValueError):
        modinv.inverse(6, 9)
