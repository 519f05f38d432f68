"""The port's verify pipeline (``bls_backend.pipeline_device``: windowed
scalar mul, segment fold, G2 sum, Miller loop, product tree), its chunk
layout and the chunk-partial product against the JAX package and the host
oracles.

The Miller values follow the JAX package formula for formula, so on affine
lanes they equal ``crypto/bls/pairing_fast.miller_loop_fast`` exactly, and
the pipeline's Fq12 equals the JAX ``_pipeline_fused`` exactly (the slow
A/B: that program costs minutes of XLA compile on the CPU).  In the default
run the pipeline's Fq12 is held to the host multi-pairing after the final
exponentiation, which removes only the Jacobian line factors.  Tolerance 0
throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu.ops import bls_backend as jbb
from lighthouse_tpu.ops import bls12_381 as jb12
from lighthouse_tpu.ops import dispatch_pipeline as jdp
from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.convert import signature_sets_from_bytes
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import P, Fq2, final_exponentiation_fast
from lighthouse_tpu_torch.crypto.bls.pairing_fast import miller_loop_fast, multi_miller_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import dispatch_pipeline as dp
from lighthouse_tpu_torch.ops import ec
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")

CPU = torch.device("cpu")
SCALARS = [0x9E3779B97F4A7C15, 0x1234567890ABCDEF, 0xFEDCBA9876543210, 0x0F0F0F0F0F0F0F0F,
           0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
           0x1F83D9ABFB41BD6B]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _coeffs(f) -> list[int]:
    return [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]


def _words(vals):
    return bi.u64(bi.to_tensor(bi.ints_to_mont_limbs(vals), CPU))


def test_miller_loop_matches_pairing_fast_exactly_on_affine_lanes():
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    ps = [cv.g1_mul(g1, 7), cv.g1_mul(g1, 1234567)]
    qs = [cv.g2_mul(g2, 9), cv.g2_mul(g2, 7654321)]
    xp, yp = (bi.u64(t) for t in ec.g1_words(ps, CPU))
    xq, yq = (bi.u64(t) for t in ec.g2_words(qs, CPU))
    f = t12.batch_miller_loop_plain(xp, yp, bi.one_like(xp), xq, yq, t12.fp2_one_like(xq))
    for i in range(2):
        assert t12.fq12_from_words(bi.to_numpy(f[i])) == miller_loop_fast(ps[i], qs[i])


def test_miller_loop_jacobian_lanes_match_affine_after_final_exp():
    """The zp / zq paths: P and Q given in Jacobian coordinates with random
    Z; the line factors they add die in the final exponentiation."""
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    p, q = cv.g1_mul(g1, 31), cv.g2_mul(g2, 5)
    zp, zq = 0x1234567, Fq2(3, 11)
    xp, yp, zpw = _words([p[0] * zp * zp % P]), _words([p[1] * zp ** 3 % P]), _words([zp])
    jq = [q[0] * zq * zq, q[1] * zq * zq * zq, zq]
    xq, yq, zqw = (_words([c.a, c.b]).reshape(1, 2, 12) for c in jq)
    f = t12.batch_miller_loop_plain(xp, yp, zpw, xq, yq, zqw)
    got = t12.fq12_from_words(bi.to_numpy(f[0]))
    assert got != miller_loop_fast(p, q)
    assert final_exponentiation_fast(got) == final_exponentiation_fast(miller_loop_fast(p, q))


def _jax_sets(kind: str):
    """Sets of the JAX package: flat (distinct messages, 5 sets) or grouped
    (9 single-key sets over 3 messages)."""
    sks = [jbls.SecretKey(11 + i) for i in range(9)]
    if kind == "flat":
        msgs = [bytes([i]) * 32 for i in range(5)]
        return [jbls.SignatureSet(sks[i].sign(m), [sks[i].public_key()], m)
                for i, m in enumerate(msgs)]
    msgs = [bytes([40 + i]) * 32 for i in range(3)]
    return [jbls.SignatureSet(sks[i].sign(msgs[i % 3]), [sks[i].public_key()], msgs[i % 3])
            for i in range(9)]


def _carry(jsets):
    return signature_sets_from_bytes(
        ([pk.to_bytes() for pk in s.pubkeys], s.signature.to_bytes(), s.message) for s in jsets)


def _port_args(sets, scalars):
    sig_pts = [s.signature.point for s in sets]
    h2 = [bb._hash_to_g2_cached(s.message) for s in sets]
    agg = [s.aggregate_pubkey() for s in sets]
    return bb._chunk_layout(sets, sig_pts, h2, bi.ints_to_mont_limbs([a[0] for a in agg]),
                            bi.ints_to_mont_limbs([a[1] for a in agg]), scalars, CPU)


def _host_product(sets, scalars):
    """Π e(r_i·pk_i, H(m_i)) · e(-g1, Σ r_i·sig_i) on the host oracle."""
    pairs, acc = [], cv.INF
    for s, r in zip(sets, scalars):
        acc = cv.g2_add(acc, cv.g2_mul(s.signature.point, r))
        pairs.append((cv.g1_mul(s.aggregate_pubkey(), r), bb._hash_to_g2_cached(s.message)))
    pairs.append((cv.g1_neg(cv.g1_generator()), acc))
    return multi_miller_fast(pairs)


@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_pipeline_matches_host_multi_pairing_after_final_exp(kind):
    sets = _carry(_jax_sets(kind))
    scalars = SCALARS[:len(sets)]
    args = _port_args(sets, scalars)
    assert args[-1] == (0 if kind == "flat" else 4)
    f = bb.pipeline_device(*args)
    assert f.shape == (1, 12, 12) and f.dtype == torch.int32
    got = dp.fq12_row_to_host(f)
    want = _host_product(sets, scalars)
    assert final_exponentiation_fast(got) == final_exponentiation_fast(want)
    assert final_exponentiation_fast(got).is_one()       # the sets are valid


def _jax_args(jsets, scalars):
    sig_pts = [s.signature.point for s in jsets]
    h2 = [jbb._hash_to_g2_cached(s.message) for s in jsets]
    agg = [s.aggregate_pubkey() for s in jsets]
    from lighthouse_tpu.ops import ec as jec

    return jbb._chunk_layout(jsets, sig_pts, h2, jec.ints_to_mont_limbs([a[0] for a in agg]),
                             jec.ints_to_mont_limbs([a[1] for a in agg]), scalars)


def _jints(x) -> list[int]:
    return [int(v) for v in np.ravel(jbi.from_mont(np.asarray(x)))]


@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_chunk_layout_matches_jax(kind):
    jsets = _jax_sets(kind)
    scalars = SCALARS[:len(jsets)]
    jargs = _jax_args(jsets, scalars)
    args = _port_args(_carry(jsets), scalars)
    ints = lambda t: bi.mont_limbs_to_ints(bi.to_numpy(t).reshape(-1, 12))  # noqa: E731
    pkx, pky, sx, sy, hx, hy, digits, mask, g1x, g1y, n_seg = args
    (jpkx, jpky, jsxa, jsxb, jsya, jsyb, jhxa, jhxb, jhya, jhyb, jbits, jmask, jg1x, jg1y,
     jn_seg) = jargs
    assert n_seg == jn_seg
    assert ints(pkx) == _jints(jpkx) and ints(pky) == _jints(jpky)
    pair = lambda a, b: [v for ab in zip(_jints(a), _jints(b)) for v in ab]  # noqa: E731
    assert ints(sx) == pair(jsxa, jsxb) and ints(sy) == pair(jsya, jsyb)
    assert ints(hx) == pair(jhxa, jhxb) and ints(hy) == pair(jhya, jhyb)
    assert digits.tolist() == np.asarray(jbits).astype(np.int64).tolist()
    assert mask.tolist() == np.asarray(jmask).tolist()
    assert ints(g1x) == _jints(jg1x) and ints(g1y) == _jints(jg1y)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_pipeline_fq12_equals_jax_pipeline_fused_exactly(kind):
    jsets = _jax_sets(kind)
    scalars = SCALARS[:len(jsets)]
    want = jb12.fq12_from_device(jax.device_get(jbb._pipeline_fused(*_jax_args(jsets, scalars))))
    got = dp.fq12_row_to_host(bb.pipeline_device(*_port_args(_carry(jsets), scalars)))
    assert _coeffs(got) == [int(c) for c in _coeffs(want)]


def test_fq12_mul_pair_matches_jax():
    rng = np.random.default_rng(4)
    rows = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)] for _ in range(2)]
    a, b = (bi.to_tensor(bi.ints_to_mont_limbs(r).reshape(1, 12, 12), CPU) for r in rows)
    got = bi.mont_limbs_to_ints(bi.to_numpy(dp.fq12_mul_device(a, b)).reshape(12, 12))

    def jx(r):
        c = [jnp.asarray(jbi.to_mont(v)[None, :]) for v in r]
        f2 = [(c[2 * k], c[2 * k + 1]) for k in range(6)]
        return (tuple(f2[:3]), tuple(f2[3:]))

    want = jax.jit(jdp._fp12_mul_q)(jx(rows[0]), jx(rows[1]))
    assert got == [_jints(leaf)[0] for leaf in jax.tree_util.tree_leaves(want)]
    assert dp.combine_partials([a]) is a
    assert torch.equal(dp.combine_partials([a, b, a]),
                       dp.fq12_mul_device(dp.fq12_mul_device(a, b), a))


def test_chunk_planning_matches_jax(monkeypatch):
    for n, chunk in ((0, 512), (1, 512), (512, 512), (513, 512), (1024, 512), (1000, 300),
                     (7, 0), (9, 4), (5, -1)):
        assert dp.plan_chunks(n, chunk) == jdp.plan_chunks(n, chunk)
    assert dp.DEFAULT_CHUNK_SETS == jdp.DEFAULT_CHUNK_SETS == 512
    monkeypatch.delenv("LHGPU_BLS_CHUNK", raising=False)
    monkeypatch.delenv("LHTPU_BLS_CHUNK", raising=False)
    assert dp.chunk_size() == jdp.chunk_size() == 512
    assert dp.chunk_size(64) == 64
    monkeypatch.setenv("LHGPU_BLS_CHUNK", "0")
    monkeypatch.setenv("LHTPU_BLS_CHUNK", "128")
    assert dp.chunk_size() == 0                    # the port reads its own knob only
    for n, g, m in ((131, 131, 1), (1024, 64, 16), (512, 64, 8), (13, 4, 4), (8, 8, 1),
                    (100, 3, 90), (40, 5, 8)):
        assert bb._grouped_layout(n, g, m) == jbb._grouped_layout(n, g, m)


def test_async_verdict_commits_once_and_marks_on_pass():
    marks = []
    v = dp.AsyncVerdict(torch.tensor([True, True, False]), 2, on_pass=lambda: marks.append(1))
    assert v.commit() and v.commit() and marks == [1]
    v = dp.AsyncVerdict(torch.tensor([True, False]), 2, on_pass=lambda: marks.append(2))
    assert not v.commit() and marks == [1]
    assert dp.AsyncVerdict.immediate(True).commit()


@pytest.mark.cuda
def test_pipeline_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    for kind in ("flat", "grouped"):
        sets = _carry(_jax_sets(kind))
        args = _port_args(sets, SCALARS[:len(sets)])
        dev_args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
        bb.pipeline_device.launches = 0
        got = bb.pipeline_device(*dev_args)
        assert bb.pipeline_device.launches > 0
        assert torch.equal(got.cpu(), bb.pipeline_plain(*args))
    sets = T.microbench_sets(8)
    assert bb.verify_signature_sets_device(T.fresh(sets))
