"""The port's multi-device rungs on the card: each sharded function over a
mesh that names the card 1 to 4 times against its plain version (tolerance
0), and against the single-device rung it splits.  Every test is marked
``cuda`` and skips without a card; ``tests/test_torch_parallel.py`` holds
the same functions to the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import testing as T
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import curve as cv
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import pubkey_kernels
from lighthouse_tpu_torch.ops import sha256 as sha
from lighthouse_tpu_torch.parallel import bls_sharded as bs
from lighthouse_tpu_torch.parallel import dryrun_worker as dw
from lighthouse_tpu_torch.parallel import epoch_sharded as es
from lighthouse_tpu_torch.parallel import msm_sharded as ms
from lighthouse_tpu_torch.state_transition import epoch_device, epoch_processing
from torch_no_recovery import no_recovery  # noqa: F401  (a fixture)

pytestmark = [pytest.mark.cuda, pytest.mark.usefixtures("no_recovery")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


def _pairs(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(cv.g1_mul(cv.g1_generator(), int(a)), cv.g2_mul(cv.g2_generator(), int(b)))
            for a, b in rng.integers(1, 1 << 62, (n, 2))]


@pytest.mark.parametrize("n_pairs,n_dev", [(133, 1), (133, 2), (133, 4), (1, 4)])
def test_sharded_miller_reduce_equals_plain_on_the_card(card, n_pairs, n_dev):
    cols, mask = bs.lane_columns(_pairs(n_pairs, n_pairs), n_dev)
    cols = tuple(c.to(card) for c in cols)
    mask = mask.to(card)
    before = bs.sharded_miller_reduce.launches
    got = bs.sharded_miller_reduce(cols, mask, [card] * n_dev)
    want = bs.sharded_miller_reduce_plain(cols, mask, [card] * n_dev)
    torch.cuda.synchronize()
    assert bs.sharded_miller_reduce.launches > before
    assert torch.equal(got.cpu(), want.cpu())


def test_sharded_backend_on_the_card(card):
    sets = T.microbench_sets(8)
    for n_dev in (1, 4):
        ledger: dict = {}
        assert bs.verify_signature_sets_sharded(T.fresh(sets), mesh=[card] * n_dev,
                                                ledger=ledger)
        assert ledger["kernel"] > 0
        assert not bs.verify_signature_sets_sharded(T.with_wrong_message(T.fresh(sets), 2),
                                                    mesh=[card] * n_dev)
    assert bls.verify_signature_sets(T.fresh(sets), backend="sharded")


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_sharded_fold_equals_plain_and_hashlib_on_the_card(card, n_dev):
    rng = np.random.default_rng(n_dev)
    leaves = rng.integers(0, 2**32, (n_dev * 4096, 8), dtype=np.uint64).astype(np.uint32)
    x = sha.to_tensor(leaves, card)
    got = dw.sharded_fold_to_root(x, [card] * n_dev)
    want = dw.sharded_fold_to_root_plain(x, [card] * n_dev)
    assert torch.equal(got.cpu(), want.cpu())
    np.testing.assert_array_equal(sha.to_numpy(got), dw.host_root(leaves, n_dev))
    dw.merkle_dryrun([card] * n_dev)


def test_epoch_pass_sharded_equals_the_single_pass_on_the_card(card):
    state, spec = T.epoch_state(1 << 12, 5, "minimal")
    leak = epoch_processing.is_in_inactivity_leak(state, spec)
    args = (epoch_device.build_columns(state, spec),
            epoch_device.build_tables(state, spec, leak=leak),
            epoch_device.build_params(state, spec, leak=leak))
    got = es.epoch_pass_sharded(*args, mesh=[card] * 4)
    for want in (epoch_device.epoch_pass(*args, card),
                 epoch_device.epoch_pass(*args, torch.device("cpu"))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_gather_fold_sharded_equals_the_single_fold_on_the_card(card):
    pts = [cv.g1_mul(cv.g1_generator(), k + 3) for k in range(64)]
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 64, 512).astype(np.int64)
    groups = rng.integers(0, 16, 512).astype(np.int64)
    ks = rng.integers(1, 1 << 63, 512, dtype=np.uint64)
    table = pubkey_kernels.build_table(pts, card)
    got = ms.gather_fold_sharded(table, rows, ks, groups, 16, mesh=[card] * 4)
    for dev in (card, torch.device("cpu")):
        want = pubkey_kernels.gather_fold(pubkey_kernels.build_table(pts, dev), rows, ks,
                                          groups, 16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert bi.mont_limbs_to_ints(got[0][:1])[0] != 0
