"""The port's BLS12-381 field and tower (``lighthouse_tpu_torch.ops.bigint``,
``ops.bls12_381``) and its host library (``csrc/bls_host.cc``) against the
JAX package.

The two packages keep different limbs (27 x 15-bit redundant, R = 2^405
against 12 x 32-bit fully reduced, R = 2^384), so every comparison is on
canonical integers, with tolerance 0.  The JAX functions run eagerly on the
CPU at four lanes (no whole-program compile).  The test marked ``cuda``
holds the kernel's field and tower arithmetic against the plain versions on
a card.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import fields as jfields
from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu.ops import bls12_381 as jb12
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.crypto.bls.fields import Fq2, Fq6, Fq12
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import native_bls

P = bi.P_INT
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _vals(n: int, seed: int, edges=(0, 1, P - 1)) -> list[int]:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n - len(edges))]
    return list(edges) + rand


def _port(vals) -> torch.Tensor:
    """Canonical ints -> the port's Montgomery words (int64 lanes)."""
    return bi.u64(bi.to_tensor(bi.ints_to_mont_limbs(vals), CPU))


def _jax(vals) -> jnp.ndarray:
    return jnp.asarray(jbi.to_mont(np.array(vals, dtype=object)))


def _port_ints(t: torch.Tensor) -> list[int]:
    return bi.mont_limbs_to_ints(bi.to_numpy(t))


def _jax_ints(x) -> list[int]:
    return [int(v) for v in np.ravel(jbi.from_mont(np.asarray(x)))]


def test_limb_bridge_round_trips_through_canonical_ints():
    vals = _vals(8, seed=1)
    words = bi.ints_to_mont_limbs(vals)
    assert words.dtype == np.uint32 and words.shape == (8, 12)
    assert bi.mont_limbs_to_ints(words) == vals
    assert [bi.from_mont(bi.to_mont(v)) for v in vals] == vals
    # the JAX package's limbs reach the same canonical values
    assert _jax_ints(_jax(vals)) == vals
    assert bi.words_to_int(bi.ONE_M) == (1 << 384) % P
    assert bi.NPRIME32 * P % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub", "neg"])
def test_fp_ops_match_jax(op):
    a, b = _vals(12, seed=2), _vals(12, seed=3, edges=(P - 1, 0, 1))
    ta, tb, ja, jb = _port(a), _port(b), _jax(a), _jax(b)
    if op == "neg":
        got, want = bi.neg(ta), jbi.neg(ja)
    else:
        got, want = getattr(bi, op)(ta, tb), getattr(jbi, op)(ja, jb)
    got_ints = _port_ints(got)
    assert got_ints == _jax_ints(want)
    expect = {"mont_mul": [x * y % P for x, y in zip(a, b)],
              "add": [(x + y) % P for x, y in zip(a, b)],
              "sub": [(x - y) % P for x, y in zip(a, b)],
              "neg": [-x % P for x in a]}[op]
    assert got_ints == expect
    # fully reduced: every output word row is below p
    assert all(v < P for v in bi.words_to_ints(bi.to_numpy(got)))


def _fq2(rng) -> Fq2:
    return Fq2(int.from_bytes(rng.bytes(48), "little") % P, int.from_bytes(rng.bytes(48), "little") % P)


def _fq12(rng) -> Fq12:
    return Fq12(Fq6(_fq2(rng), _fq2(rng), _fq2(rng)), Fq6(_fq2(rng), _fq2(rng), _fq2(rng)))


def _coeffs(x) -> list[int]:
    f6s = [x] if isinstance(x, Fq6) else [x.c0, x.c1]
    return [c for f6 in f6s for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]


def _jax_tower(coeffs: list[list[int]], shape: str):
    """Per-lane coefficient lists -> the JAX package's nested limb pytree."""
    cols = [_jax([lane[k] for lane in coeffs]) for k in range(len(coeffs[0]))]
    fq2 = [(cols[2 * k], cols[2 * k + 1]) for k in range(len(cols) // 2)]
    if shape == "fp2":
        return fq2[0]
    fq6 = [tuple(fq2[3 * k:3 * k + 3]) for k in range(len(fq2) // 3)]
    return fq6[0] if shape == "fp6" else (fq6[0], fq6[1])


def _jax_tower_ints(x) -> list[list[int]]:
    leaves = jax.tree_util.tree_leaves(x)
    cols = [_jax_ints(leaf) for leaf in leaves]
    return [[col[i] for col in cols] for i in range(len(cols[0]))]


def _port_tower(coeffs: list[list[int]], shape: str) -> torch.Tensor:
    t = _port([c for lane in coeffs for c in lane]).reshape(len(coeffs), len(coeffs[0]), 12)
    return {"fp2": lambda: t.reshape(-1, 2, 12), "fp6": lambda: t.reshape(-1, 3, 2, 12),
            "fp12": lambda: t12.fq12_nested(t)}[shape]()


def _port_tower_ints(t: torch.Tensor, n: int) -> list[list[int]]:
    ints = _port_ints(t.reshape(-1, 12))
    return [ints[i * n:(i + 1) * n] for i in range(len(ints) // n)]


@pytest.mark.parametrize("kind", ["fp2_mul", "fp6_mul", "fp12_mul", "fp12_sparse_mul"])
def test_tower_products_match_jax(kind):
    rng = np.random.default_rng(5)
    lanes = 4
    if kind == "fp2_mul":
        xs = [_fq2(rng) for _ in range(lanes)]
        ys = [_fq2(rng) for _ in range(lanes)]
        xs[0] = Fq2(0, 0)
        ys[1] = Fq2(P - 1, 1)
        cx, cy, shape, n = [[x.a, x.b] for x in xs], [[y.a, y.b] for y in ys], "fp2", 2
        want_host = [[(x * y).a, (x * y).b] for x, y in zip(xs, ys)]
    elif kind == "fp6_mul":
        xs = [_fq12(rng).c0 for _ in range(lanes)]
        ys = [_fq12(rng).c1 for _ in range(lanes)]
        cx, cy, shape, n = [_coeffs(x) for x in xs], [_coeffs(y) for y in ys], "fp6", 6
        want_host = [_coeffs(x * y) for x, y in zip(xs, ys)]
    else:
        xs = [_fq12(rng) for _ in range(lanes)]
        ys = [_fq12(rng) for _ in range(lanes)]
        if kind == "fp12_sparse_mul":     # the line a0 + a1 v + b1 v w
            ys = [Fq12(Fq6(y.c0.c0, y.c0.c1, Fq2.ZERO), Fq6(Fq2.ZERO, y.c1.c1, Fq2.ZERO))
                  for y in ys]
        xs[0] = Fq12.ONE
        cx, cy, shape, n = [_coeffs(x) for x in xs], [_coeffs(y) for y in ys], "fp12", 12
        want_host = [_coeffs(x * y) for x, y in zip(xs, ys)]
    tx, ty = _port_tower(cx, shape), _port_tower(cy, shape)
    jx, jy = _jax_tower(cx, shape), _jax_tower(cy, shape)
    if kind == "fp12_sparse_mul":
        a0, a1, b1 = ty[:, 0, 0], ty[:, 0, 1], ty[:, 1, 1]
        got = t12.fp12_sparse_mul(tx, a0, a1, b1)
        want = jb12.fp12_sparse_mul(jx, jy[0][0], jy[0][1], jy[1][1])
    else:
        got = getattr(t12, kind)(tx, ty)
        want = getattr(jb12, kind)(jx, jy)
    got_ints = _port_tower_ints(got, n)
    assert got_ints == want_host
    jax_ints = _jax_tower_ints(want)
    assert got_ints == [lane[:n] for lane in jax_ints]


def test_fq12_words_round_trip_and_conjugate():
    rng = np.random.default_rng(6)
    f = _fq12(rng)
    words = t12.fq12_to_words(f)
    assert words.shape == (12, 12)
    assert t12.fq12_from_words(words) == f
    t = t12.fq12_nested(bi.u64(bi.to_tensor(words, CPU)))
    assert t12.fq12_from_words(bi.to_numpy(t12.fp12_conj(t))) == f.conj()


def test_host_library_final_exp_matches_jax_fields():
    rng = np.random.default_rng(7)
    for _ in range(2):
        f = _fq12(rng)
        jf = jfields.Fq12(*[jfields.Fq6(*[jfields.Fq2(c.a, c.b) for c in (x.c0, x.c1, x.c2)])
                            for x in (f.c0, f.c1)])
        want = jfields.final_exponentiation_fast(jf)
        got = native_bls.final_exp(f)
        assert _coeffs(got) == _coeffs(want)
        assert native_bls.final_exp_is_one(f) == want.is_one()
    assert native_bls.final_exp_is_one(Fq12.ONE)


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("bls12_381.cu", "bls12_381.cuh"):
        (csrc / name).write_text((native.CSRC / name).read_text())
    monkeypatch.setattr(native, "CSRC", csrc)
    src = csrc / "bls12_381.cu"
    key = native.build_key(src, native.NVCC_FLAGS)
    assert [p.name for p in native._sources(src)] == ["bls12_381.cu", "bls12_381.cuh"]
    assert native.build_key(src, native.NVCC_FLAGS) == key
    hdr = csrc / "bls12_381.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    edited = native.build_key(src, native.NVCC_FLAGS)
    assert edited != key
    assert native.build_key(src, native.GXX_FLAGS) != edited


@pytest.mark.cuda
def test_fq12_mul_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    from lighthouse_tpu_torch.ops import dispatch_pipeline as dp

    rng = np.random.default_rng(8)
    fs = np.stack([t12.fq12_to_words(_fq12(rng)) for _ in range(6)])
    a = bi.to_tensor(fs[:3], "cuda")
    b = bi.to_tensor(fs[3:], "cuda")
    dp.fq12_mul_device.launches = 0
    got = dp.fq12_mul_device(a, b)
    assert dp.fq12_mul_device.launches == 1
    assert torch.equal(got.cpu(), dp.fq12_mul_plain(a.cpu(), b.cpu()))
