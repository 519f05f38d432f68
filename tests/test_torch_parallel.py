"""The port's multi-device rungs (``lighthouse_tpu_torch/parallel/``) against
the JAX package's, on the CPU.

A mesh of the port is a list of torch devices; here it names the CPU N
times, so every shard runs its kernels' plain versions in this process, as
the JAX package's mesh rungs run on the 8 virtual CPU devices that
``tests/conftest.py`` gives.  Tolerance 0 throughout (canonical integers
and SHA-256 words):

- row 19, ``sharded_miller_reduce``, over meshes of 1, 2 and 4 on 5 and 8
  seeded pairs (5 pads to 8 lanes, the padding masked) and one pair over 4
  (three shards all masked): the canonical Fq12 equals the single-device
  plain version and the host oracle's product of Miller loops
  (``pairing_fast.multi_miller_fast``); ``-m slow`` holds it to the JAX
  ``_sharded_miller_reduce`` on the JAX package's own columns (a Miller
  program's XLA compile per mesh);
- ``verify_signature_sets_sharded`` on the cases of
  ``tests/test_bls_sharded.py`` against their known verdicts (``-m slow``:
  against the JAX sharded backend);
- row 20, ``sharded_fold_to_root``, over meshes of 1, 2, 3, 4 and 8 against
  the JAX ``fold_to_root_device`` of each block and of the zero-padded top,
  and against hashlib;
- ``epoch_pass_sharded`` over 4 against the JAX ``epoch_pass_sharded`` on 4
  virtual devices, and the ``sharded`` epoch rung across a boundary;
- ``gather_fold_sharded`` over 4 against the single-device fold and the
  host lincomb (``-m slow``: against the JAX rung on 4 virtual devices),
  and the pubkey plane's ``sharded`` rung;
- meshes that are empty, mixed, or (for BLS) not a power of two raise.

``tests/test_torch_parallel_card.py`` holds each sharded function to its
plain version on the card.
"""

import functools
import importlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.bls import curve as jcv
from lighthouse_tpu.ops import bls12_381 as jb12
from lighthouse_tpu.ops import pubkey_kernels as jpk
from lighthouse_tpu.ops import sha256 as jsha
from lighthouse_tpu.state_transition import epoch_device as jed
from lighthouse_tpu.state_transition import epoch_processing as jep
from lighthouse_tpu.testing import randomized_registry_state
from lighthouse_tpu_torch.chain import pubkey_plane
from lighthouse_tpu_torch.convert import signature_sets_from_bytes, state_from_ssz
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.crypto.bls.pairing_fast import multi_miller_fast
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as t12
from lighthouse_tpu_torch.ops import native_bls, pubkey_kernels
from lighthouse_tpu_torch.ops import sha256 as sha
from lighthouse_tpu_torch.parallel import bls_sharded as bs
from lighthouse_tpu_torch.parallel import dryrun_worker as dw
from lighthouse_tpu_torch.parallel import epoch_sharded as es
from lighthouse_tpu_torch.parallel import mesh as pm
from lighthouse_tpu_torch.parallel import msm_sharded as ms
from lighthouse_tpu_torch.state_transition import epoch_device, per_slot_processing
from lighthouse_tpu_torch.types import ChainSpec
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("no_recovery")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mesh(n: int) -> list:
    return [CPU] * n


def _coeffs(f) -> list[int]:
    return [c for f6 in (f.c0, f.c1) for f2 in (f6.c0, f6.c1, f6.c2) for c in (f2.a, f2.b)]


def _row_fq12(f: torch.Tensor):
    return t12.fq12_from_words(bi.to_numpy(f).reshape(12, 12))


# --------------------------------------------------------------------------
# row 19: the sharded Miller reduce
# --------------------------------------------------------------------------

def _scalar_pairs(n: int, seed: int) -> list[tuple[int, int]]:
    rng = np.random.default_rng(seed)
    return [(int(a), int(b)) for a, b in rng.integers(1, 1 << 62, (n, 2))]


def _port_pairs(ks):
    return [(cv.g1_mul(cv.g1_generator(), a), cv.g2_mul(cv.g2_generator(), b)) for a, b in ks]


@functools.lru_cache
def _single_device(n_pairs: int):
    """The single-device plain Miller product of the seeded pairs."""
    cols, mask = bs.lane_columns(_port_pairs(_scalar_pairs(n_pairs, n_pairs)), 1)
    return _row_fq12(t12.miller_reduce_plain(*cols, mask))


@pytest.mark.parametrize("n_pairs,n_dev", [(5, 1), (5, 4), (8, 2), (1, 4)])
def test_sharded_miller_reduce_equals_single_device_and_host_oracle(n_pairs, n_dev):
    pairs = _port_pairs(_scalar_pairs(n_pairs, n_pairs))
    cols, mask = bs.lane_columns(pairs, n_dev)
    per_dev = 1 << max((n_pairs + n_dev - 1) // n_dev - 1, 0).bit_length()
    assert cols[0].shape[0] == mask.shape[0] == per_dev * n_dev
    assert mask.tolist() == [True] * n_pairs + [False] * (per_dev * n_dev - n_pairs)
    got = _row_fq12(bs.sharded_miller_reduce(cols, mask, _mesh(n_dev)))
    assert got == multi_miller_fast(pairs)
    if n_pairs == 5:
        assert got == _single_device(n_pairs)


@pytest.mark.slow
@pytest.mark.parametrize("n_pairs", [5, 8])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_miller_reduce_equals_the_jax_program(n_pairs, n_dev):
    from lighthouse_tpu.parallel.bls_sharded import _sharded_miller_reduce

    ks = _scalar_pairs(n_pairs, n_pairs)
    jpairs = [(jcv.g1_mul(jcv.g1_generator(), a), jcv.g2_mul(jcv.g2_generator(), b))
              for a, b in ks]
    jcols, jmask = jb12.points_to_device(jpairs)
    cols, mask = bs.lane_columns(_port_pairs(ks), n_dev)
    padded = mask.shape[0]
    jcols = [np.concatenate([c, np.tile(c[-1:], (padded - n_pairs, 1))]) for c in jcols]
    jmask = np.concatenate([jmask, np.zeros(padded - n_pairs, bool)])
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("data",))
    want = jb12.fq12_from_device(jax.device_get(
        _sharded_miller_reduce(mesh, padded // n_dev)(*jcols, jmask)))
    got = _row_fq12(bs.sharded_miller_reduce(cols, mask, _mesh(n_dev)))
    assert _coeffs(got) == _coeffs(want)


def test_fq12_tree_plain_is_the_product_of_its_rows():
    rng = np.random.default_rng(9)
    vals = [int(v) % bi.P_INT for v in rng.integers(1, 1 << 62, 48)]
    rows = bi.to_tensor(bi.ints_to_mont_limbs(vals).reshape(4, 12, 12), CPU)
    want = _row_fq12(rows[:1])
    for k in range(1, 4):
        want = want * _row_fq12(rows[k:k + 1])
    assert _row_fq12(bs.fq12_tree_plain(rows)) == want


# --------------------------------------------------------------------------
# the sharded backend: the cases of tests/test_bls_sharded.py
# --------------------------------------------------------------------------

def _jax_sets(n, distinct_msgs=2):
    sks = [jbls.SecretKey.from_bytes(int(300 + i).to_bytes(32, "big")) for i in range(n)]
    msgs = [bytes([m]) * 32 for m in range(distinct_msgs)]
    return sks, [jbls.SignatureSet(sk.sign(msgs[i % distinct_msgs]), [sk.public_key()],
                                   msgs[i % distinct_msgs]) for i, sk in enumerate(sks)]


def _carry(jsets):
    return signature_sets_from_bytes(
        [([pk.to_bytes() for pk in s.pubkeys], s.signature.to_bytes(), s.message) for s in jsets])


def _cases():
    """(name, JAX sets, expected verdict) of ``tests/test_bls_sharded.py``."""
    sks, sets = _jax_sets(6)
    bad = list(sets)
    bad[3] = jbls.SignatureSet(sks[0].sign(sets[3].message), sets[3].pubkeys, sets[3].message)
    _, agree = _jax_sets(5, distinct_msgs=3)
    _, nokey = _jax_sets(2)
    nokey[1] = jbls.SignatureSet(nokey[1].signature, [], nokey[1].message)
    return [("pass", sets, True), ("wrong key", bad, False), ("five sets", agree, True),
            ("empty", [], False), ("no pubkeys", nokey, False)]


@pytest.mark.parametrize("case", [0, 1, 3, 4])
def test_sharded_backend_verdicts(case):
    name, jsets, want = _cases()[case]
    ledger: dict = {}
    got = bs.verify_signature_sets_sharded(_carry(jsets), mesh=_mesh(2), ledger=ledger)
    assert got is want, name
    if name in ("pass", "wrong key"):
        assert set(ledger) == {"prepare_pairs", "prep_host", "h2d", "kernel", "d2h",
                               "final_exp"}
    if name == "pass":      # the api seam reaches the backend; device="cpu" is a mesh of it
        assert bls.verify_signature_sets(_carry(jsets), backend="sharded", device="cpu")


def test_sharded_backend_chunks_and_prepared_pairs():
    """A chunked run (2-pair chunks, partials multiplied on mesh[0]) gives
    the monolithic verdict; ``prepare_pairs`` with fixed scalars gives the
    host batch equation's pairs."""
    _, jsets = _jax_sets(3)
    sets = _carry(jsets)
    assert bs.verify_signature_sets_sharded(sets, mesh=_mesh(2), chunk_size=2)
    from lighthouse_tpu_torch.ops.bls_backend import prepare_pairs

    pairs = prepare_pairs(sets, scalars=[3, 5, 7])
    assert len(pairs) == 4
    assert pairs[0][0] == cv.g1_mul(sets[0].pubkeys[0].point, 3)
    assert pairs[3] == (cv.g1_neg(cv.g1_generator()),
                        cv.g2_add(cv.g2_add(cv.g2_mul(sets[0].signature.point, 3),
                                            cv.g2_mul(sets[1].signature.point, 5)),
                                  cv.g2_mul(sets[2].signature.point, 7)))
    assert native_bls.final_exp(multi_miller_fast(pairs)).is_one()


@pytest.mark.slow
@pytest.mark.parametrize("case", range(5))
def test_sharded_backend_verdicts_equal_the_jax_sharded_backend(case):
    from lighthouse_tpu.parallel.bls_sharded import verify_signature_sets_sharded

    name, jsets, want = _cases()[case]
    assert verify_signature_sets_sharded(jsets, n_devices=2) is want, name
    assert bs.verify_signature_sets_sharded(_carry(jsets), mesh=_mesh(2)) is want, name


# --------------------------------------------------------------------------
# row 20: the sharded merkle fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_sharded_fold_equals_jax_folds_and_hashlib(n_dev):
    n = n_dev * dw.LEAVES_PER_SHARD
    leaves = np.arange(n * 8, dtype=np.uint32).reshape(n, 8)
    root = dw.merkle_dryrun(_mesh(n_dev))            # raises unless == hashlib
    subs = [np.asarray(jsha.fold_to_root_device(jax.numpy.asarray(b)))
            for b in np.split(leaves, n_dev)]
    top = np.zeros((1 << max(n_dev - 1, 0).bit_length(), 8), np.uint32)
    top[:n_dev] = np.concatenate(subs)
    want = np.asarray(jsha.fold_to_root_device(jax.numpy.asarray(top)))
    np.testing.assert_array_equal(root, want)
    np.testing.assert_array_equal(root, dw.host_root(leaves, n_dev))
    got = dw.sharded_fold_to_root_plain(sha.to_tensor(leaves, CPU), _mesh(n_dev))
    np.testing.assert_array_equal(sha.to_numpy(got), want)


def test_sharded_fold_at_other_widths_and_the_dry_run(capsys):
    rng = np.random.default_rng(20)
    leaves = rng.integers(0, 2**32, (3 * 512, 8), dtype=np.uint64).astype(np.uint32)
    root = dw.merkle_dryrun(_mesh(3), leaves)
    np.testing.assert_array_equal(root, dw.host_root(leaves, 3))
    assert dw.main(["1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2] == "mesh of 1: ['cpu']"
    assert lines[-1].startswith('{"ok": true, "n_devices": 1, "root": "')
    with pytest.raises(ValueError, match="power of two"):
        dw.sharded_fold_to_root(sha.to_tensor(leaves[:3 * 100], CPU), _mesh(3))


# --------------------------------------------------------------------------
# the epoch pass over a mesh
# --------------------------------------------------------------------------

@pytest.fixture
def jax_epoch_sharded(monkeypatch):
    """The JAX package's ``parallel/epoch_sharded`` and its epoch kernels,
    imported for the length of the test: they need
    ``jax.experimental.enable_x64``, a name the installed JAX no longer
    has, so it is set to ``jax.enable_x64`` here and the modules are
    removed afterwards (as ``tests/test_torch_epoch.py`` does)."""
    import jax.experimental
    import lighthouse_tpu.ops as jops
    import lighthouse_tpu.parallel as jpar
    from lighthouse_tpu.ops import program_store

    names = {"lighthouse_tpu.ops.epoch_kernels": (jops, "epoch_kernels"),
             "lighthouse_tpu.parallel.epoch_sharded": (jpar, "epoch_sharded")}
    had = {name for name in names if name in sys.modules}
    registered = dict(program_store._REGISTERED)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    mods = [importlib.import_module(name) for name in names]
    yield mods
    for name, (pkg, attr) in names.items():
        if name not in had:
            sys.modules.pop(name, None)
            if hasattr(pkg, attr):
                delattr(pkg, attr)
    program_store._REGISTERED.clear()
    program_store._REGISTERED.update(registered)


def test_epoch_pass_sharded_equals_the_jax_sharded_pass(jax_epoch_sharded):
    jek, jes = jax_epoch_sharded

    st, spec = randomized_registry_state(777, "deneb", seed=11, leak=False)
    leak = jep.is_in_inactivity_leak(st, spec)
    n = len(st.validators)
    bucket = jek.bucket_size(n, jed.bucket_floor())
    want = jes.epoch_pass_sharded(jed.build_columns(st, spec, bucket),
                                  jed.build_tables(st, spec, "deneb", leak=leak),
                                  jed.build_params(st, spec, "deneb", leak=leak),
                                  apply_eb=True, mesh=jes.epoch_mesh(4))
    pst = state_from_ssz(st.serialize(), "deneb", "minimal")
    pspec = ChainSpec.minimal().with_forks_at(0, "deneb")
    args = (epoch_device.build_columns(pst, pspec),
            epoch_device.build_tables(pst, pspec, leak=leak),
            epoch_device.build_params(pst, pspec, leak=leak))
    got = es.epoch_pass_sharded(*args, mesh=_mesh(4))
    single = epoch_device.epoch_pass(*args, CPU)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, np.asarray(w)[:n])
        np.testing.assert_array_equal(g, s)


def test_epoch_rung_choice_and_the_sharded_rung_across_a_boundary(monkeypatch):
    assert epoch_device.epoch_backend(CPU) == "device"
    monkeypatch.setenv("LHGPU_EPOCH_BACKEND", "bogus")
    with pytest.raises(ValueError, match="LHGPU_EPOCH_BACKEND"):
        epoch_device.epoch_backend(CPU)
    st, _ = randomized_registry_state(300, "deneb", seed=12, leak=True)
    pspec = ChainSpec.minimal().with_forks_at(0, "deneb")
    a, b = (state_from_ssz(st.serialize(), "deneb", "minimal") for _ in range(2))
    meshes = []
    real = es.epoch_pass_sharded

    def spy(*args, mesh=None):
        meshes.append(mesh)
        return real(*args, mesh=mesh)

    monkeypatch.setattr(es, "epoch_pass_sharded", spy)
    monkeypatch.setenv("LHGPU_EPOCH_BACKEND", "device")
    per_slot_processing(a, pspec, CPU)
    monkeypatch.setenv("LHGPU_EPOCH_BACKEND", "sharded")
    per_slot_processing(b, pspec, CPU)
    assert meshes == [[CPU]]
    assert a.hash_tree_root(CPU) == b.hash_tree_root(CPU)


@pytest.mark.parametrize("n,want", [(0, [(0, 0)] * 4), (3, [(0, 1), (1, 2), (2, 3), (3, 3)]),
                                    (10, [(0, 3), (3, 6), (6, 9), (9, 10)]),
                                    (777, [(0, 195), (195, 390), (390, 585), (585, 777)])])
def test_epoch_rows_split_with_the_remainder_last(n, want):
    assert pm.bounds(n, 4) == want


# --------------------------------------------------------------------------
# the gather fold over a mesh, and the pubkey plane's rung
# --------------------------------------------------------------------------

def _points(n: int, start: int) -> list:
    out, p = [], cv.g1_mul(cv.g1_generator(), start)
    for _ in range(n):
        out.append(p)
        p = cv.g1_add(p, cv.g1_generator())
    return out


def _fold_case(seed: int, n_lanes: int, n_groups: int):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 24, n_lanes).astype(np.int64)
    groups = rng.integers(0, n_groups, n_lanes).astype(np.int64)
    groups[groups == 2] = 3                       # an empty group
    ks = rng.integers(1, 1 << 63, n_lanes, dtype=np.uint64)
    return rows, ks, groups


def test_gather_fold_sharded_equals_single_device_and_host():
    """12 groups over 4 shards: group 2 empty, the last groups without
    lanes (a shard of identities)."""
    n_groups = 12
    pts = _points(24, start=5)
    rows, ks, groups = _fold_case(9, 9, n_groups)
    table = pubkey_kernels.build_table(pts, CPU)
    got = ms.gather_fold_sharded(table, rows, ks, groups, n_groups, mesh=_mesh(4))
    want = pubkey_kernels.gather_fold(table, rows, ks, groups, n_groups)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    xs, ys = bi.mont_limbs_to_ints(got[0]), bi.mont_limbs_to_ints(got[1])
    oracle = native_bls.g1_lincomb_groups([pts[r] for r in rows], [int(k) for k in ks],
                                          [int(g) for g in groups], n_groups)
    assert [None if got[2][g] else (xs[g], ys[g]) for g in range(n_groups)] == oracle
    empty = ms.gather_fold_sharded(table, [], [], [], n_groups, mesh=_mesh(4))
    assert [a.shape[0] for a in empty] == [0, 0, 0]


def test_table_replicas_are_made_once_per_device_and_dropped_with_the_table():
    import gc

    table = pubkey_kernels.build_table(_points(4, start=5), CPU)
    assert ms._replica(table, CPU) is table
    meta = torch.device("meta")
    copy = ms._replica(table, meta)
    assert copy[0].device == meta and copy[0].shape == table[0].shape
    assert ms._replica(table, meta) is copy
    key = id(table[0])
    assert key in ms._REPLICAS
    del table, copy
    gc.collect()
    assert key not in ms._REPLICAS


def test_group_ranges_balance_lanes_and_keep_groups_whole():
    groups = np.repeat(np.arange(8), [10, 1, 1, 1, 10, 1, 1, 7])
    assert ms.group_ranges(groups, 8, 4) == [(0, 1), (1, 5), (5, 6), (6, 8)]
    assert ms.group_ranges(np.zeros(5, np.int64), 3, 4) == [(0, 1), (1, 1), (1, 1), (1, 3)]


@pytest.mark.slow
def test_gather_fold_sharded_equals_the_jax_rung():
    from lighthouse_tpu.parallel import msm_sharded as jms

    pts = _points(24, start=5)
    rows, ks, groups = _fold_case(40, 40, 7)
    want = jms.gather_fold_sharded(jpk.build_table(pts), rows, ks, groups, 7,
                                   mesh=jms.msm_mesh(4))
    got = ms.gather_fold_sharded(pubkey_kernels.build_table(pts, CPU), rows, ks, groups, 7,
                                 mesh=_mesh(4))
    assert [bool(v) for v in got[2]] == [bool(v) for v in np.asarray(want[2])]
    from lighthouse_tpu.ops import bigint as jbi

    for g in range(7):
        if not got[2][g]:
            assert bi.mont_limbs_to_ints(got[0][g:g + 1]) == [int(jbi.from_mont(want[0][g]))]
            assert bi.mont_limbs_to_ints(got[1][g:g + 1]) == [int(jbi.from_mont(want[1][g]))]


class _Reg:
    def __init__(self, points):
        self.pubkeys = np.frombuffer(b"".join(cv.g1_to_bytes(p) for p in points),
                                     np.uint8).reshape(len(points), 48).copy()

    def __len__(self):
        return self.pubkeys.shape[0]


def test_pubkey_plane_sharded_rung(monkeypatch):
    pts = _points(24, start=5)
    rows, ks, groups = _fold_case(40, 40, 7)
    plane = pubkey_plane.reset_pubkey_plane(CPU)
    try:
        assert plane.resolve_rung(4096) == "reference"
        calls = []
        real = ms.gather_fold_sharded

        def spy(*args, mesh=None):
            calls.append(mesh)
            return real(*args, mesh=mesh)

        monkeypatch.setattr(ms, "gather_fold_sharded", spy)
        out = {}
        for rung in ("device", "sharded"):
            monkeypatch.setenv("LHGPU_PUBKEY_BACKEND", rung)
            out[rung] = plane.fold(_Reg(pts), rows, ks, groups, 7)
        assert out["sharded"] == out["device"]
        assert calls == [[CPU]]
        assert plane.folds == {"device": 1, "reference": 0, "sharded": 1}
    finally:
        pubkey_plane.reset_pubkey_plane()


# --------------------------------------------------------------------------
# meshes that raise
# --------------------------------------------------------------------------

def test_bad_meshes_raise():
    cols, mask = bs.lane_columns(_port_pairs(_scalar_pairs(3, 3)), 1)
    with pytest.raises(ValueError, match="power of two"):
        bs.sharded_miller_reduce(cols, mask, _mesh(3))
    with pytest.raises(ValueError, match="power of two"):
        bs.verify_signature_sets_sharded([], mesh=_mesh(3))
    with pytest.raises(ValueError, match="power of two"):
        bs.sharded_miller_reduce(cols[:1] * 4, mask[:3], _mesh(1))
    for bad in ([], "cpu", [CPU, torch.device("cuda")], [CPU, "meta"]):
        with pytest.raises(ValueError):
            pm.check_mesh(bad)
        with pytest.raises(ValueError):
            dw.merkle_dryrun(bad)
    with pytest.raises(ValueError, match="mix"):
        es.epoch_pass_sharded({}, {}, None, mesh=["cpu", "cuda"])
    assert pm.device_mesh(2, devices=["cpu"] * 4) == _mesh(2)
    with pytest.raises(ValueError):
        pm.device_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pm.device_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bs.verify_signature_sets_sharded([])
