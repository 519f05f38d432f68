"""The port's G1/G2 curve arithmetic (``lighthouse_tpu_torch.ops.ec``), ψ
subgroup verdict and blinded pubkey fold against the JAX package and its
host oracles.

Jacobian coordinates are compared as canonical integers, tolerance 0: the
port keeps the JAX package's formulas, so the coordinates (not only the
points) agree.  The JAX device functions that run a ``lax.scan`` (the
windowed scalar mul, the ψ check, the blinded fold's inversion) cost
minutes of XLA compile on the CPU, so those A/B tests are marked ``slow``
and a test against the host oracles (``crypto/bls/curve.py``) in the
default run stands beside each.  Tests marked ``cuda`` hold the kernels
against the plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import curve as jcv
from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu.ops import ec as jec
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.fields import P, Fq2
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_backend as bb
from lighthouse_tpu_torch.ops import ec
from lighthouse_tpu_torch import testing as T

CPU = torch.device("cpu")

SMALL_ORDER = T.SMALL_ORDER_G2     # exact order 13 (tests/test_ec.py:205)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port(vals) -> torch.Tensor:
    return bi.u64(bi.to_tensor(bi.ints_to_mont_limbs(vals), CPU))


def _ints(t: torch.Tensor) -> list[int]:
    return bi.mont_limbs_to_ints(bi.to_numpy(t).reshape(-1, 12))


def _jax(vals):
    return jnp.asarray(jbi.to_mont(np.array(vals, dtype=object)))


def _jints(x) -> list[int]:
    return [int(v) for v in np.ravel(jbi.from_mont(np.asarray(x)))]


def _g1_jac(points_z):
    """[(affine point or INF, z)] -> Jacobian coordinate int lists."""
    xs, ys, zs = [], [], []
    for p, z in points_z:
        if p is cv.INF:
            xs.append(0), ys.append(0), zs.append(0)
        else:
            xs.append(p[0] * z * z % P), ys.append(p[1] * z ** 3 % P), zs.append(z)
    return xs, ys, zs


def _g2_jac(points_z):
    out = ([], [], [])
    for p, z in points_z:
        if p is cv.INF:
            coords = (Fq2(0, 0), Fq2(0, 0), Fq2(0, 0))
        else:
            coords = (p[0] * z * z, p[1] * z * z * z, z)
        for lst, c in zip(out, coords):
            lst.extend([c.a, c.b])
    return out


def _to_affine(x: int, y: int, z: int):
    if z == 0:
        return cv.INF
    zi = pow(z, -1, P)
    return x * zi * zi % P, y * zi ** 3 % P


def _pairs_g1(n, seed):
    rng = np.random.default_rng(seed)
    g = cv.g1_generator()
    return [(cv.g1_mul(g, int(rng.integers(2, 1 << 30))), int.from_bytes(rng.bytes(40), "big"))
            for _ in range(n)]


def _pairs_g2(n, seed):
    rng = np.random.default_rng(seed)
    g = cv.g2_generator()
    return [(cv.g2_mul(g, int(rng.integers(2, 1 << 30))),
             Fq2(int(rng.integers(2, 1 << 62)), int(rng.integers(2, 1 << 62)))) for _ in range(n)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_jac_add_full_matches_jax_with_infinity_lanes(group):
    """Lanes: generic, p = ∞, q = ∞, both ∞."""
    if group == "g1":
        ps, qs = _pairs_g1(4, 1), _pairs_g1(4, 2)
        ps[1] = (cv.INF, 0)
        qs[2] = (cv.INF, 0)
        ps[3] = qs[3] = (cv.INF, 0)
        a, b = _g1_jac(ps), _g1_jac(qs)
        F, JF = ec._G1, jec._FpAdapter
        port = lambda c: _port(c)  # noqa: E731
        jx = lambda c: _jax(c)  # noqa: E731
    else:
        ps, qs = _pairs_g2(4, 3), _pairs_g2(4, 4)
        ps[1] = (cv.INF, None)
        qs[2] = (cv.INF, None)
        ps[3] = qs[3] = (cv.INF, None)
        a, b = _g2_jac(ps), _g2_jac(qs)
        F, JF = ec._G2, jec._Fq2Adapter
        port = lambda c: _port(c).reshape(-1, 2, 12)  # noqa: E731
        jx = lambda c: (_jax(c[0::2]), _jax(c[1::2]))  # noqa: E731
    got = ec.jac_add_full(F, tuple(port(c) for c in a), tuple(port(c) for c in b))
    want = jax.jit(lambda p, q: jec._jac_add_full(JF, p, q))(
        tuple(jx(c) for c in a), tuple(jx(c) for c in b))
    for g, w in zip(got, want):
        leaves = jax.tree_util.tree_leaves(w)
        w_ints = [v for pair in zip(*[_jints(leaf) for leaf in leaves]) for v in pair]
        assert _ints(g) == w_ints
    # and the points are the sums (the port's coordinates, made affine)
    xs, ys, zs = (_ints(c) for c in got)
    if group == "g1":
        for i, ((p, _), (q, _)) in enumerate(zip(ps, qs)):
            assert _to_affine(xs[i], ys[i], zs[i]) == cv.g1_add(p, q)


def test_windowed_scalar_mul_matches_host_oracle():
    rng = np.random.default_rng(11)
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    n = 4
    ps = [cv.g1_mul(g1, 3 + i) for i in range(n)]
    qs = [cv.g2_mul(g2, 5 + i) for i in range(n)]
    scalars = [int(s) for s in rng.integers(1, 1 << 63, n)]
    scalars[2] = 0                           # a padding lane: exact zeros
    scalars[3] = 15                          # one nonzero digit
    xp, yp = (bi.u64(t) for t in ec.g1_words(ps, CPU))
    xq, yq = (bi.u64(t) for t in ec.g2_words(qs, CPU))
    digits = torch.from_numpy(ec.scalars_to_digits(scalars).astype(np.int64))
    (X, Y, Z), (SX, SY, SZ) = ec.gj_scalar_mul_windowed(xp, yp, xq, yq, digits)
    for i, k in enumerate(scalars):
        x, y, z = _ints(X[i])[0], _ints(Y[i])[0], _ints(Z[i])[0]
        assert _to_affine(x, y, z) == (cv.g1_mul(ps[i], k) if k else cv.INF)
        sz = _ints(SZ[i])
        if k == 0:
            assert torch.count_nonzero(torch.stack([SX[i], SY[i], SZ[i]])) == 0
            continue
        zi = Fq2(*sz).inv()
        sx, sy = Fq2(*_ints(SX[i])), Fq2(*_ints(SY[i]))
        assert (sx * zi * zi, sy * zi * zi * zi) == cv.g2_mul(qs[i], k)


def test_segment_and_g2_sums_match_jax():
    # G1: 8 lanes in 2 segments, s-major (lane = s·2 + g), one infinity lane
    ps = _pairs_g1(8, 5)
    ps[5] = (cv.INF, 0)
    cols = _g1_jac(ps)
    got = ec.g1_segment_sum(*(_port(c) for c in cols), 2)
    want = jax.jit(jec.g1_segment_sum, static_argnums=3)(*(_jax(c) for c in cols), 2)
    for g, w in zip(got, want):
        assert _ints(g) == _jints(w)
    xs, ys, zs = (_ints(c) for c in got)
    for seg in range(2):
        acc = cv.INF
        for s in range(4):
            acc = cv.g1_add(acc, ps[2 * s + seg][0])
        assert _to_affine(xs[seg], ys[seg], zs[seg]) == acc
    # G2: 4 lanes with infinity padding
    qs = _pairs_g2(4, 6)
    qs[1] = qs[3] = (cv.INF, None)
    cols = _g2_jac(qs)
    got = ec.g2_sum_reduce(*(_port(c).reshape(-1, 2, 12) for c in cols))
    want = jax.jit(jec.g2_sum_reduce)(*((_jax(c[0::2]), _jax(c[1::2])) for c in cols))
    for g, w in zip(got, want):
        assert _ints(g) == [v for pair in zip(_jints(w[0]), _jints(w[1])) for v in pair]


def test_dbl_add_step_matches_jax():
    """The ψ check's double-and-add step, from infinity and from a finite T,
    with bit 1 and bit 0."""
    qs = _pairs_g2(4, 7)
    base = _g2_jac([(q, Fq2(1, 0)) for q, _ in qs])
    t = _g2_jac(qs)
    inf = np.array([True, False, False, True])
    F = ec._G2
    port = lambda c: _port(c).reshape(-1, 2, 12)  # noqa: E731
    jx = lambda c: (_jax(c[0::2]), _jax(c[1::2]))  # noqa: E731
    step = jax.jit(lambda *args: jec._dbl_add_step(jec._Fq2Adapter, *args))
    for bit in (0, 1):
        got = ec.dbl_add_step(F, *(port(c) for c in t), torch.from_numpy(inf),
                              port(base[0]), port(base[1]), bit)
        want = step(*(jx(c) for c in t), jnp.asarray(inf), jx(base[0]), jx(base[1]),
                    jnp.full(4, bit, jnp.uint32))
        for g, w in zip(got[:3], want[:3]):
            assert _ints(g) == [v for pair in zip(_jints(w[0]), _jints(w[1])) for v in pair]
        assert got[3].tolist() == np.asarray(want[3]).tolist()


def _psi_points():
    g2 = cv.g2_generator()
    return [g2, SMALL_ORDER, cv.g2_mul(g2, 123456789), T.non_subgroup_point(9)]


def test_psi_verdict_matches_host_oracle_and_fails_closed():
    pts = _psi_points()
    assert cv.g2_mul(SMALL_ORDER, 13) is cv.INF
    xq, yq = ec.g2_words(pts, CPU)
    got = bb.g2_subgroup_device(xq, yq).tolist()
    assert got == [cv.g2_in_subgroup_fast(p) for p in pts] == [True, False, True, False]
    # the dispatch pads to a power of two (floor 4) with generators
    assert bb._dispatch_g2_subgroup_kernel(pts[:3], CPU).tolist() == [True, False, True, True]


@pytest.mark.slow
def test_psi_verdict_matches_jax_device_program():
    from lighthouse_tpu.ops.bls_backend import batch_subgroup_check_g2

    pts = _psi_points()
    jpts = [(jcv.Fq2(p[0].a, p[0].b), jcv.Fq2(p[1].a, p[1].b)) for p in pts]
    want = batch_subgroup_check_g2(jpts).tolist()
    xq, yq = ec.g2_words(pts, CPU)
    assert bb.g2_subgroup_device(xq, yq).tolist() == want


@pytest.mark.slow
def test_windowed_scalar_mul_matches_jax_device_program():
    rng = np.random.default_rng(12)
    g1, g2 = cv.g1_generator(), cv.g2_generator()
    ps = [cv.g1_mul(g1, 3 + i) for i in range(4)]
    qs = [cv.g2_mul(g2, 5 + i) for i in range(4)]
    scalars = [int(s) for s in rng.integers(1, 1 << 63, 4)]
    scalars[1] = 0
    dig = ec.scalars_to_digits(scalars)
    xp, yp = (bi.u64(t) for t in ec.g1_words(ps, CPU))
    xq, yq = (bi.u64(t) for t in ec.g2_words(qs, CPU))
    got = ec.gj_scalar_mul_windowed(xp, yp, xq, yq, torch.from_numpy(dig.astype(np.int64)))
    jq = lambda v: jnp.asarray(jec.ints_to_mont_limbs(v))  # noqa: E731
    want = jax.jit(jec.gj_scalar_mul_windowed)(
        jq([p[0] for p in ps]), jq([p[1] for p in ps]),
        (jq([q[0].a for q in qs]), jq([q[0].b for q in qs])),
        (jq([q[1].a for q in qs]), jq([q[1].b for q in qs])), jnp.asarray(dig))
    for g, w in zip(got[0], want[0]):
        assert _ints(g) == _jints(w)
    for g, w in zip(got[1], want[1]):
        assert _ints(g) == [v for pair in zip(_jints(w[0]), _jints(w[1])) for v in pair]


def _fold_sets():
    """Ragged member lists with duplicate keys (a sync committee samples
    with replacement) and one identity aggregate."""
    pks = T.consecutive_pubkeys(500, 12)
    sig = api.Signature(bytes([0xC0]) + bytes(95))
    sets = [api.SignatureSet(sig, pks[:k], b"m") for k in (1, 5, 12)]
    sets.append(api.SignatureSet(sig, [pks[2], pks[2]] + [pks[1]] * 8 + pks[3:7], b"m"))
    return T.with_identity_aggregate(sets + [api.SignatureSet(sig, pks[:3], b"m")], 4)


def test_blinded_fold_matches_host_oracle():
    sets = _fold_sets()
    xa, ya, inf = bb.aggregate_pubkeys_device(sets, "cpu")
    assert inf.tolist() == [False, False, False, False, True]
    for i, s in enumerate(sets[:4]):
        assert (bi.from_mont(xa[i]), bi.from_mont(ya[i])) == s.aggregate_pubkey()


@pytest.mark.slow
def test_blinded_fold_matches_jax_device_program():
    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu.ops.bls_backend import aggregate_pubkeys_device as jax_fold

    sets = _fold_sets()
    jsets = [jbls.SignatureSet(jbls.Signature(s.signature.to_bytes()),
                               [jbls.PublicKey(pk.to_bytes()) for pk in s.pubkeys], s.message)
             for s in sets]
    jxa, jya, jinf = jax_fold(jsets)
    xa, ya, inf = bb.aggregate_pubkeys_device(sets, "cpu")
    assert inf.tolist() == np.asarray(jinf).tolist()
    for i in range(len(sets)):
        if not inf[i]:
            assert bi.from_mont(xa[i]) == int(jbi.from_mont(np.asarray(jxa[i])))
            assert bi.from_mont(ya[i]) == int(jbi.from_mont(np.asarray(jya[i])))


@pytest.mark.cuda
def test_curve_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    from lighthouse_tpu_torch.ops import msm

    pts = _psi_points()
    xq, yq = ec.g2_words(pts, "cuda")
    assert bb.g2_subgroup_device(xq, yq).tolist() == [True, False, True, False]
    sets = _fold_sets()
    msm.blinded_fold_device.launches = 0
    on_card = bb.aggregate_pubkeys_device(sets, "cuda")
    assert msm.blinded_fold_device.launches > 0
    plain = bb.aggregate_pubkeys_device(sets, "cpu")
    for g, w in zip(on_card, plain):
        assert np.array_equal(g, w)
