"""Row 11 of the port (the gather fold, ``ops/msm.py`` and
``ops/pubkey_kernels.py``) and the pubkey plane's table residency
(``chain/pubkey_plane.py``), on the CPU.

- The plain gather fold equals the JAX package's ``pubkey_kernels.gather_fold``
  (one shape: its XLA compile costs about 30 s) as canonical affine points
  with the same identity flags, over non-power-of-two groups, a repeated
  row, an empty group and a group whose keys cancel.
- It equals the host oracle (the native segment MSM) at several shapes.
- The table's append, rebuild and prefix semantics match the JAX plane's.
- The kernel's lane code (``csrc/bls12_381.cuh``), built for the host with
  g++ and a multiply counter, equals the plain version, and its products
  equal ``bls_cuda.gather_fold_fp_muls``.
- An error inside the fold that is not a device fault (a bug) raises; a
  device fault is recovered on the reference rung and counted in the BLS
  supervisor's ``faults()`` and ``recoveries()``.
The test marked ``cuda`` runs the kernel itself against the plain version.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lighthouse_tpu.chain import pubkey_plane as jplane
from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu.ops import pubkey_kernels as jpk
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.chain import pubkey_plane
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda, msm, native_bls, pubkey_kernels

CPU = torch.device("cpu")
G = cv.g1_generator()

HARNESS = r"""
#include "bls12_381.cuh"
namespace bls { unsigned long long bls_fp_mul_count = 0; }
extern "C" {
unsigned long long h_fp_count() { return bls::bls_fp_mul_count; }
void h_gather(const uint32_t* tx, const uint32_t* ty, const int32_t* idx, const int32_t* d,
              uint32_t* X, uint32_t* Y, uint32_t* Z, long n, int n_digits) {
    bls::host_g1_scalar_mul(tx, ty, idx, d, X, Y, Z, n, n_digits);
}
void h_halves(uint32_t* X, uint32_t* Y, uint32_t* Z, long half) {
    for (long i = 0; i < half; i++) bls::lane_add_halves<bls::Fp>(i, half, X, Y, Z);
}
void h_affine(const uint32_t* X, const uint32_t* Y, const uint32_t* Z, uint32_t* xa,
              uint32_t* ya, uint8_t* inf, long n) {
    for (long g = 0; g < n; g++) bls::lane_g1_affine(g, X, Y, Z, xa, ya, inf);
}
}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _points(n: int, start: int = 3) -> list:
    out, p = [], cv.g1_mul(G, start)
    for _ in range(n):
        out.append(p)
        p = cv.g1_add(p, G)
    return out


def _scalars(n: int, seed: int) -> list:
    return [int(v) for v in np.random.default_rng(seed).integers(1, 1 << 63, n, dtype=np.int64)]


def _oracle(points, rows, ks, groups, n_groups):
    return native_bls.g1_lincomb_groups([points[r] for r in rows], ks, groups, n_groups)


def _port_fold(points, rows, ks, groups, n_groups):
    xa, ya, inf = pubkey_kernels.gather_fold(pubkey_kernels.build_table(points, CPU),
                                             np.asarray(rows), np.asarray(ks, np.uint64),
                                             np.asarray(groups), n_groups)
    xs, ys = bi.mont_limbs_to_ints(xa), bi.mont_limbs_to_ints(ya)
    return [None if inf[g] else (xs[g], ys[g]) for g in range(n_groups)]


def test_plain_gather_fold_equals_the_jax_gather_fold():
    """5 groups (g_pad 8): group 0 cancels (P and -P under one scalar),
    group 3 is empty, group 1 repeats a row; the JAX program compiles once
    for (16 rows, 32 lanes, 8 groups)."""
    pts = _points(15) + [None]
    pts[15] = cv.g1_neg(pts[0])
    rows = [0, 15, 2, 2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 4]
    groups = [0, 0, 1, 1, 1, 2, 2, 4, 4, 4, 4, 2, 1, 4]
    ks = _scalars(len(rows), 1)
    ks[1] = ks[0]
    want_x, want_y, want_inf = jpk.gather_fold(jpk.build_table(pts), np.asarray(rows),
                                               np.asarray(ks, np.uint64), np.asarray(groups), 5)
    got = _port_fold(pts, rows, ks, groups, 5)
    assert [p is None for p in got] == [bool(v) for v in want_inf] == \
        [True, False, False, True, False]
    for g in (1, 2, 4):
        assert got[g] == (int(jbi.from_mont(want_x[g])), int(jbi.from_mont(want_y[g])))
    assert got == _oracle(pts, rows[2:], ks[2:], groups[2:], 5)


@pytest.mark.parametrize("n_lanes,n_groups", [(8, 1), (20, 3), (48, 7), (33, 16)])
def test_plain_gather_fold_equals_the_host_oracle(n_lanes, n_groups):
    rng = np.random.default_rng(n_lanes)
    pts = _points(40, start=7)
    rows = [int(r) for r in rng.integers(0, 40, n_lanes)]
    groups = [int(g) for g in rng.integers(0, n_groups, n_lanes)]
    ks = _scalars(n_lanes, n_groups)
    assert _port_fold(pts, rows, ks, groups, n_groups) == \
        _oracle(pts, rows, ks, groups, n_groups)


class _Reg:
    def __init__(self, points):
        self.pubkeys = np.frombuffer(b"".join(cv.g1_to_bytes(p) for p in points),
                                     np.uint8).reshape(len(points), 48).copy()

    def __len__(self):
        return self.pubkeys.shape[0]


def test_table_append_rebuild_and_prefix_match_the_jax_plane():
    pts = _points(12, start=21)
    steps = [("rebuild", _Reg(pts[:6])), ("append", _Reg(pts[:9])),
             ("rebuild", _Reg([pts[11]] + pts[1:9])), (None, _Reg([pts[11]] + pts[1:4])),
             ("append", _Reg([pts[11]] + pts[1:12]))]
    port, jax_plane = pubkey_plane.PubkeyPlane(CPU), jplane.PubkeyPlane()
    for kind, reg in steps:
        before = dict(port.refreshes)
        port.ensure_table(reg)
        assert jax_plane.ensure_table(reg)
        changed = [k for k in port.refreshes if port.refreshes[k] != before[k]]
        assert changed == ([kind] if kind else [])
        assert port.table_rows == jax_plane._table_rows
        rows = [tuple(bi.mont_limbs_to_ints(r)) for r in port._rows]
        jrows = [tuple(int(v) for v in jbi.from_mont(r)) for r in jax_plane._rows]
        assert rows == jrows
        tx, ty = port._table
        assert tx.shape[0] == msm.bucket(port.table_rows)


def _failing_fold(monkeypatch, exc):
    monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", "device")
    plane = pubkey_plane.PubkeyPlane(CPU)

    def boom(*a, **k):
        raise exc

    monkeypatch.setattr(msm, "gather_fold_plain", boom)
    reg = _Reg(_points(4))
    return plane, (reg, np.arange(4), np.asarray(_scalars(4, 3), np.uint64), np.zeros(4, int), 1)


def test_a_fault_inside_the_fold_propagates(monkeypatch):
    """An error that is not a device fault is a bug: it raises, and
    nothing is counted or recovered."""
    from lighthouse_tpu_torch.crypto.bls import api

    plane, args = _failing_fold(monkeypatch, RuntimeError("injected row-11 fault"))
    counted = api.faults(), api.recoveries()
    with pytest.raises(RuntimeError, match="injected row-11 fault"):
        plane.fold(*args)
    assert (api.faults(), api.recoveries()) == counted


def test_a_device_fault_inside_the_fold_is_recovered_and_counted(monkeypatch):
    """A device fault goes to the BLS supervisor's counters, not to the
    caller: the fold is done again on the reference rung and gives its
    answer, one fault and one recovery counted."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import faults

    plane, args = _failing_fold(monkeypatch, faults.InjectedFault("injected row-11 fault"))
    faults0, rec0 = api.faults(), api.recoveries()
    got = plane.fold(*args)
    assert plane.folds == {"device": 0, "reference": 1}
    assert got == pubkey_plane.PubkeyPlane._fold_host(*args)
    assert api.faults()[("pubkey_device", "raise")] == faults0.get(("pubkey_device", "raise"),
                                                                   0) + 1
    assert api.recoveries()["pubkey_plane"] == rec0.get("pubkey_plane", 0) + 1
    api.reset_supervisor()                  # close the pubkey breaker the fault opened


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    d = tmp_path_factory.mktemp("gather_lanes")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-DBLS_COUNT_FP_MULS", f"-I{native.CSRC}", str(d / "harness.cc"), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.h_fp_count.restype = ctypes.c_ulonglong
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


def test_gather_lanes_equal_the_plain_version_and_count_their_products(lanes):
    pts = _points(12)
    pts[11] = cv.g1_neg(pts[0])
    rows = [0, 11, 3, 3, 5, 6, 7, 9, 2]
    groups = [0, 0, 1, 1, 1, 2, 2, 2, 4]
    ks = _scalars(len(rows), 5)
    ks[1] = ks[0]
    lane_idx, digits, g_pad = pubkey_kernels.lane_layout(
        np.asarray(rows), np.asarray(ks, np.uint64), np.asarray(groups), 5)
    tx, ty = pubkey_kernels.mont_rows(pts)
    n = lane_idx.shape[0]
    X, Y, Z = (np.zeros((n, bi.L), np.uint32) for _ in range(3))
    xa, ya = np.zeros((g_pad, bi.L), np.uint32), np.zeros((g_pad, bi.L), np.uint32)
    inf = np.zeros(g_pad, np.uint8)
    before = lanes.h_fp_count()
    lanes.h_gather(_ptr(tx), _ptr(ty), _ptr(lane_idx), _ptr(digits), _ptr(X), _ptr(Y), _ptr(Z),
                   ctypes.c_long(n), ctypes.c_int(digits.shape[0]))
    half = n // 2
    while half >= g_pad:
        lanes.h_halves(_ptr(X), _ptr(Y), _ptr(Z), ctypes.c_long(half))
        half //= 2
    lanes.h_affine(_ptr(X), _ptr(Y), _ptr(Z), _ptr(xa), _ptr(ya), _ptr(inf), ctypes.c_long(g_pad))
    assert lanes.h_fp_count() - before == bls_cuda.gather_fold_fp_muls(digits, g_pad)
    want = msm.gather_fold_plain(*(bi.to_tensor(a, CPU) for a in (tx, ty)),
                                 torch.from_numpy(lane_idx), torch.from_numpy(digits), g_pad)
    assert np.array_equal(xa, bi.to_numpy(want[0])) and np.array_equal(ya, bi.to_numpy(want[1]))
    assert inf.astype(bool).tolist() == want[2].tolist()
    assert inf.astype(bool).tolist()[:5] == [True, False, False, True, False]


@pytest.mark.cuda
def test_row_11_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    pts = _points(300)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 300, 1000)
    groups = rng.integers(0, 13, 1000)
    lane_idx, digits, g_pad = pubkey_kernels.lane_layout(
        rows, np.asarray(_scalars(1000, 9), np.uint64), groups, 13)
    tx, ty = pubkey_kernels.build_table(pts, dev)
    args = (tx, ty, torch.from_numpy(lane_idx).to(dev), torch.from_numpy(digits).to(dev), g_pad)
    before = msm.gather_fold_device.launches
    got = msm.gather_fold_device(*args)
    want = msm.gather_fold_plain(*args)
    assert msm.gather_fold_device.launches > before
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().long(), b.cpu().long())
