"""The port's scalar field Fr and barycentric evaluation
(``lighthouse_tpu_torch.ops.fr``) against the JAX package's ``ops/fr.py``
and Python integers.

The two packages keep different limbs (18 x 15-bit redundant, radix 2^270
against 8 x 32-bit fully reduced, R = 2^256), so every comparison is on
canonical integers, with tolerance 0 (integer arithmetic).  The JAX device
functions run jitted on the CPU at four lanes; its evaluation program at
N = 8 blobs of W = 16.  The test marked ``cuda`` runs the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.ops import fr as jfr
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import fr

R = fr.R_INT
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _vals(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    edges = [0, 1, R - 1]
    return edges + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n - len(edges))]


def _port(vals) -> torch.Tensor:
    return bi.u64(bi.to_tensor(fr.to_mont_host(vals), CPU))


def _port_ints(t: torch.Tensor) -> list[int]:
    return fr.FR.mont_limbs_to_ints(bi.to_numpy(t))


def _jax(vals):
    return jnp.asarray(jfr.to_mont_host(vals))


def _jax_ints(x) -> list[int]:
    return [int(v) for v in np.ravel(jfr.from_mont_host(np.asarray(x)))]


def test_constants_and_host_codecs():
    assert fr.R_INT == jfr.R_INT == kzg.BLS_MODULUS
    assert fr.FR.NPRIME32 == 0xFFFFFFFF
    assert fr.FR.words_to_int(fr.FR.ONE_M) == (1 << 256) % R
    vals = _vals(8, 1)
    assert [fr.from_mont_host(fr.to_mont_host(v)) for v in vals] == vals
    assert list(fr.from_mont_host(fr.to_mont_host(vals))) == vals
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals), np.uint8).reshape(2, 4, 32)
    words = fr.be32_bytes_to_words(raw)
    assert words.shape == (2, 4, 8)
    assert fr.FR.words_to_ints(words) == vals
    # the JAX package's limb codec reads the same bytes as the same ints
    assert [jfr._limbs_to_int(x) for x in jfr.be32_bytes_to_limbs(raw).reshape(-1, jfr.L)] == vals


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_equal_jax_and_ints(op):
    a, b = _vals(4, 2), _vals(4, 3)[::-1]
    got = _port_ints(getattr(fr, op)(_port(a), _port(b)))
    want = _jax_ints(jax.jit(getattr(jfr, op))(_jax(a), _jax(b)))
    f = {"mont_mul": lambda x, y: x * y, "add": lambda x, y: x + y,
         "sub": lambda x, y: x - y}[op]
    assert got == want == [f(x, y) % R for x, y in zip(a, b)]


def test_inversions_equal_jax_and_ints():
    vals = _vals(4, 4)
    got = _port_ints(fr.inv_mont(_port(vals)))
    assert got == _jax_ints(jax.jit(jfr.inv_mont)(_jax(vals)))
    assert got == [pow(v, -1, R) if v else 0 for v in vals]
    nonzero = [v for v in _vals(9, 5) if v][:8]
    got = _port_ints(fr.batch_inv_mont(_port(nonzero)[None]))
    assert got == _jax_ints(jax.jit(jfr.batch_inv_mont)(_jax(nonzero)[None]))
    assert got == [pow(v, -1, R) for v in nonzero]
    # a zero lane zeroes its whole tree (the caller excludes it on the host)
    assert _port_ints(fr.batch_inv_mont(_port([3, 0, 5, 7])[None])) == [0, 0, 0, 0]


def test_to_mont_plain_takes_any_256_bit_value():
    vals = _vals(6, 6) + [R, (1 << 256) - 1]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals), np.uint8).reshape(-1, 32)
    out = fr.fr_to_mont_device(torch.from_numpy(raw.copy()))
    assert out.dtype == torch.int32 and out.shape == (8, 8)
    assert _port_ints(out) == [v % R for v in vals]


def test_evaluate_polynomials_batch_equals_jax_with_a_root_hit():
    settings = jkzg.KzgSettings.dev(16)
    rng = np.random.default_rng(7)
    n, w = 8, 16
    polys = [[int(v) % R for v in rng.integers(0, 2**62, w)] for _ in range(n)]
    polys[5] = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(w)]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for p in polys for v in p),
                        np.uint8).reshape(n, w, 32)
    zs = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    zs[2] = settings.roots_brp[11]               # z on the domain: the host override
    got = fr.evaluate_polynomials_batch(raw, zs, settings.roots_brp, "cpu")
    want = jfr.evaluate_polynomials_batch(jfr.be32_bytes_to_limbs(raw), zs, settings.roots_brp)
    assert got == [int(v) for v in want]
    assert got == [jkzg.evaluate_polynomial_in_evaluation_form(p, z, settings)
                   for p, z in zip(polys, zs)]
    assert got[2] == polys[2][11]


def test_eval_wrapper_checks_its_inputs():
    f = torch.zeros((2, 16, 8), dtype=torch.int32)
    z = torch.zeros((2, 8), dtype=torch.int32)
    roots = torch.zeros((16, 8), dtype=torch.int32)
    inv_w = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fr.eval_device(f, z[:1], roots, inv_w)
    with pytest.raises(TypeError):
        fr.eval_device(f.long(), z, roots, inv_w)
    with pytest.raises(ValueError):
        fr.eval_threads(24)
    assert fr.eval_threads(4096) == (256, 16) and fr.eval_threads(16) == (1, 16)
    with pytest.raises(TypeError):
        fr.fr_to_mont_device(torch.zeros((2, 32), dtype=torch.int32))


@pytest.mark.cuda
def test_fr_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    rng = np.random.default_rng(8)
    n, w = 5, 64
    raw = rng.integers(0, 256, (n, w, 32), dtype=np.uint8)
    raw[..., 0] &= 0x3F
    settings = kzg.KzgSettings.dev(w, device="cpu")
    zs = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    zs[1] = settings.roots_brp[9]
    raw_t = torch.from_numpy(raw)
    f_dev = fr.fr_to_mont_device(raw_t.cuda())
    assert torch.equal(f_dev.cpu(), fr.fr_to_mont_plain(raw_t))
    z = bi.to_tensor(fr.to_mont_host(zs), "cuda")
    roots = bi.to_tensor(fr.to_mont_host(settings.roots_brp), "cuda")
    inv_w = bi.to_tensor(fr.to_mont_host([pow(w, -1, R)]), "cuda")
    y = fr.eval_device(f_dev, z, roots, inv_w)
    assert torch.equal(y.cpu(), fr.eval_plain(f_dev.cpu(), z.cpu(), roots.cpu(), inv_w.cpu()))
    assert fr.evaluate_polynomials_batch(raw, zs, settings.roots_brp, "cuda") == \
        fr.evaluate_polynomials_batch(raw, zs, settings.roots_brp, "cpu")
