"""The port's epoch boundary (``per_slot_processing`` across the last slot
of an epoch, ``process_epoch``, ``compute_committee_shuffle``) against the
JAX package, on the CPU at the minimal preset.

A Deneb state from the JAX package's seeded registry fill is carried into
the port through its SSZ bytes; both packages then cross the same epoch
boundary, the JAX package under both of its epoch backends
(``LHTPU_EPOCH_BACKEND=reference``, its numpy stages, and ``=device``, its
fused XLA pass), the port through its kernels' plain versions.  The
post-states must hash to the same root and carry the same registry digest
(the JAX package's ``registry_state_digest``, applied to the port's
columns), and the new epoch's committee shuffles must be equal.

The JAX device rung needs ``jax.experimental.enable_x64``, a name the
installed JAX no longer has; the fixture ``jax_device_rung`` sets it for
the length of a test and removes the imported module afterwards.
"""

import dataclasses
import importlib
import sys

import jax
import numpy as np
import pytest
import torch

from lighthouse_tpu import types as JT
from lighthouse_tpu.state_transition import misc as jmisc
from lighthouse_tpu.state_transition import per_slot_processing as jax_per_slot_processing
from lighthouse_tpu.state_transition import shuffle as jshuffle
from lighthouse_tpu.testing import Harness, randomized_registry_state, registry_state_digest
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.ops import epoch_kernels as ek
from lighthouse_tpu_torch.ops import sha256 as tsha
from lighthouse_tpu_torch.ssz.tree_cache import enable_tree_cache
from lighthouse_tpu_torch.state_transition import (
    misc,
    per_slot_processing,
    process_epoch,
    state_advance,
)
from lighthouse_tpu_torch.state_transition.shuffle import shuffle_list
from lighthouse_tpu_torch.testing import epoch_state
from lighthouse_tpu_torch.testing import registry_state_digest as port_digest
from lighthouse_tpu_torch.types import ChainSpec

CPU = torch.device("cpu")
N = 777
JAX_EK = "lighthouse_tpu.ops.epoch_kernels"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jax_device_rung(monkeypatch):
    """Import the JAX package's epoch kernels for the length of the test
    and spy on its device pass, so that a silent fallback to its numpy
    stages cannot pass for the device rung."""
    import jax.experimental
    import lighthouse_tpu.ops as jops
    from lighthouse_tpu.ops import program_store
    from lighthouse_tpu.state_transition import epoch_device as jdev

    had = JAX_EK in sys.modules
    registered = dict(program_store._REGISTERED)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    importlib.import_module(JAX_EK)
    ran = []
    real = jdev.prepare_and_run

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        ran.append(out is not None)
        return out

    monkeypatch.setattr(jdev, "prepare_and_run", spy)
    yield ran
    if not had:
        sys.modules.pop(JAX_EK, None)
        if hasattr(jops, "epoch_kernels"):
            delattr(jops, "epoch_kernels")
        program_store._REGISTERED.clear()
        program_store._REGISTERED.update(registered)


def _deneb(spec) -> ChainSpec:
    """The port's spec for a JAX spec with every fork through Deneb at 0."""
    assert spec.fork_at_epoch(0) == "deneb" and spec.preset.name == "minimal"
    return ChainSpec.minimal().with_forks_at(0, "deneb")


def _carry(st):
    return state_from_ssz(st.serialize(), "deneb", "minimal")


def _cross_and_compare(st, spec, monkeypatch, backend: str):
    """Cross the boundary at st.slot in both packages; compare the post
    states and the new epoch's committee shuffle."""
    pst, pspec = _carry(st), _deneb(spec)
    assert pst.serialize() == st.serialize()
    monkeypatch.setenv("LHTPU_EPOCH_BACKEND", backend)
    jax_per_slot_processing(st, spec)
    per_slot_processing(pst, pspec, CPU)
    assert port_digest(pst) == registry_state_digest(pst) == registry_state_digest(st)
    assert pst.hash_tree_root(CPU) == st.hash_tree_root()
    assert pst.serialize() == st.serialize()
    epoch = int(st.slot) // spec.slots_per_epoch
    want = jmisc.compute_committee_shuffle(st, spec, epoch, device=False)
    got = misc.compute_committee_shuffle(pst, pspec, epoch, device=CPU)
    np.testing.assert_array_equal(got, want)
    per_slot = misc.get_committee_count_per_slot(pspec, got.shape[0])
    assert per_slot == jmisc.get_committee_count_per_slot(spec, want.shape[0])
    for slot in (int(st.slot), int(st.slot) + 5):
        for index in range(per_slot):
            np.testing.assert_array_equal(
                misc.get_beacon_committee(pst, pspec, slot, index, got),
                jmisc.get_beacon_committee(st, spec, slot, index, want))
    if backend == "device" and want.shape[0] >= 256:
        indices = jmisc.get_active_validator_indices(st, epoch)
        seed = jmisc.get_seed(st, spec, epoch, spec.domain_beacon_attester)
        np.testing.assert_array_equal(got, jshuffle.shuffle_list_device(
            indices, seed, spec.preset.shuffle_round_count))
    return pst, pspec


@pytest.mark.parametrize("leak", [False, True])
def test_boundary_matches_jax_reference_rung(monkeypatch, leak):
    st, spec = randomized_registry_state(N, "deneb", seed=3, leak=leak)
    _cross_and_compare(st, spec, monkeypatch, "reference")


@pytest.mark.parametrize("leak", [False, True])
def test_boundary_matches_jax_device_rung(monkeypatch, jax_device_rung, leak):
    st, spec = randomized_registry_state(N, "deneb", seed=4, leak=leak)
    _cross_and_compare(st, spec, monkeypatch, "device")
    assert jax_device_rung == [True]


def test_genesis_epoch_crossing_matches_jax(monkeypatch):
    """The genesis epoch skips inactivity and rewards but runs slashings
    and hysteresis; the port keeps its pass on the path with them gated."""
    st, spec = randomized_registry_state(N, "deneb", seed=5)
    st.slot = spec.slots_per_epoch - 1
    scores = st.inactivity_scores.copy()
    _cross_and_compare(st, spec, monkeypatch, "reference")
    np.testing.assert_array_equal(st.inactivity_scores, scores)


def test_sync_committee_period_crossing_matches_jax(monkeypatch):
    """The end of epoch 7 (minimal: 8-epoch periods) rotates the sync
    committees; the next one is sampled and aggregated from real keys."""
    h = Harness(n_validators=64, fork="deneb")
    st, spec = h.state, h.spec
    st.slot = 8 * spec.slots_per_epoch - 1
    rng = np.random.default_rng(7)
    st.previous_epoch_participation = rng.integers(0, 8, 64, dtype=np.uint8)
    st.current_epoch_participation = rng.integers(0, 8, 64, dtype=np.uint8)
    before = st.next_sync_committee.hash_tree_root()
    pst, _ = _cross_and_compare(st, spec, monkeypatch, "reference")
    assert pst.current_sync_committee.hash_tree_root(CPU) == before
    assert pst.next_sync_committee.hash_tree_root(CPU) != before


@pytest.mark.parametrize("seed", [1, 2])
def test_mainnet_fill_boundary_matches_jax(monkeypatch, seed):
    """The port's mainnet-shaped fill, carried into the JAX package by SSZ,
    crosses its boundary to the same post-state in both."""
    pst, pspec = epoch_state(N, seed, preset="minimal", fill="mainnet")
    spec = JT.ChainSpec.minimal().with_forks_at(0, "deneb")
    st = JT.make_types(spec.preset).BeaconStateDeneb.deserialize(pst.serialize())
    _cross_and_compare(st, spec, monkeypatch, "reference")


def test_mainnet_fill_is_a_live_chains_boundary():
    """The mainnet fill finalizes, ejects a quarter of one epoch's churn
    behind twelve full epochs of queued exits, activates one epoch's
    activation churn, and leaves all but a few effective balances alone."""
    st, spec = epoch_state(4096, seed=3, preset="minimal", fill="mainnet")
    before = st.copy()
    epoch = misc.current_epoch(st, spec)
    churn = misc.get_validator_churn_limit(st, spec)
    activations = misc.get_validator_activation_churn_limit(st, spec)
    process_epoch(st, spec, CPU)
    v0, v1 = before.validators, st.validators
    assert int(st.finalized_checkpoint.epoch) == int(before.finalized_checkpoint.epoch) + 1
    new_exits = v1.exit_epoch != v0.exit_epoch
    assert new_exits.sum() == max(1, churn // 4)
    assert (v1.exit_epoch[new_exits] == np.uint64(epoch + 13)).all()
    assert (v0.effective_balance[new_exits] == np.uint64(spec.ejection_balance)).all()
    assert (v1.activation_epoch != v0.activation_epoch).sum() == activations
    changed = v1.effective_balance != v0.effective_balance
    assert 0 < changed.sum() < len(v1) // 100
    assert (st.balances > before.balances).mean() > 0.9


def test_cached_root_after_the_boundary_equals_the_uncached_root():
    pst, pspec = epoch_state(N, seed=8, preset="minimal")
    enable_tree_cache(pst, CPU)
    pst.hash_tree_root()
    ek.reset_launches()
    tsha.reset_launches()
    roots = [per_slot_processing(pst, pspec) for _ in range(3)]
    copy = pst.copy()
    del copy._tree_cache
    assert pst.hash_tree_root() == copy.hash_tree_root(CPU)
    assert roots[1] != roots[0]
    assert [k.launches for k in ek.KERNELS] == [0, 0]     # the plain versions ran


def test_epoch_state_engages_every_stage():
    """The fill reaches the activation queue, the exit queue's epochs,
    slashed lanes on the slashings target, and hysteresis both ways."""
    st, spec = epoch_state(2048, seed=1, preset="minimal")
    before = st.copy()
    stages = process_epoch(st, spec, CPU)
    assert set(stages) == {"prep_host_ms", "dispatch_ms"}
    v0, v1 = before.validators, st.validators
    assert (v1.activation_epoch != v0.activation_epoch).any()
    assert (v1.activation_eligibility_epoch != v0.activation_eligibility_epoch).any()
    target = int(before.slot) // spec.slots_per_epoch + spec.preset.epochs_per_slashings_vector // 2
    hit = v0.slashed & (v0.withdrawable_epoch == np.uint64(target))
    assert hit.any() and (st.balances[hit] < before.balances[hit]).any()
    assert (v1.effective_balance > v0.effective_balance).any()
    assert (v1.effective_balance < v0.effective_balance).any()
    assert (st.inactivity_scores != before.inactivity_scores).any()


def test_state_advance_crosses_two_epochs():
    pst, pspec = epoch_state(300, seed=2, preset="minimal")
    start = int(pst.slot)
    state_advance(pst, pspec, start + 2 * pspec.slots_per_epoch, CPU)
    assert int(pst.slot) == start + 2 * pspec.slots_per_epoch
    with pytest.raises(ValueError):
        state_advance(pst, pspec, start, CPU)


def test_int64_guard_raises_before_any_write():
    pst, pspec = epoch_state(300, seed=3, preset="minimal")
    pst.inactivity_scores[5] = np.uint64(2**40)
    before = pst.serialize()
    with pytest.raises(ValueError, match="int64 guard"):
        process_epoch(pst, pspec, CPU)
    assert pst.serialize() == before
    pst.inactivity_scores[5] = 0
    pst.balances[7] = np.uint64(1 << 62)
    with pytest.raises(ValueError, match="int64 guard"):
        process_epoch(pst, pspec, CPU)
    pst.balances[7] = 0
    pst.validators.effective_balance[3] = np.uint64(33 * 10**9)
    with pytest.raises(ValueError, match="int64 guard"):
        process_epoch(pst, pspec, CPU)


def test_other_forks_raise_not_implemented():
    pst, pspec = epoch_state(300, seed=4, preset="minimal")
    before = pst.serialize()
    with pytest.raises(NotImplementedError):
        per_slot_processing(pst, ChainSpec.minimal(), CPU)     # phase0 by that schedule
    electra_next = dataclasses.replace(pspec, electra_fork_epoch=int(pst.slot) // 8 + 1)
    with pytest.raises(NotImplementedError):
        per_slot_processing(pst, electra_next, CPU)
    assert pst.serialize() == before


def test_entry_points_need_a_card_unless_cpu_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pst, pspec = epoch_state(300, seed=5, preset="minimal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_epoch(pst, pspec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        misc.compute_committee_shuffle(pst, pspec, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shuffle_list(np.arange(10), b"\x01" * 32, 10)


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_chain_spec_fields_match_jax(preset):
    ours = getattr(ChainSpec, preset)()
    theirs = getattr(JT.ChainSpec, preset)()
    for f in dataclasses.fields(ours):
        if f.name == "preset":
            for pf in dataclasses.fields(ours.preset):
                assert getattr(ours.preset, pf.name) == getattr(theirs.preset, pf.name), pf.name
        else:
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for epoch in (0, 74240, 269567, 269568, 10**7):
        assert ours.fork_at_epoch(epoch) == theirs.fork_at_epoch(epoch)
        assert ours.compute_activation_exit_epoch(epoch) == \
            theirs.compute_activation_exit_epoch(epoch)
    deneb = ours.with_forks_at(0, "deneb")
    assert deneb == dataclasses.replace(ours, **{
        f: getattr(theirs.with_forks_at(0, "deneb"), f)
        for f in ("altair_fork_epoch", "bellatrix_fork_epoch", "capella_fork_epoch",
                  "deneb_fork_epoch", "electra_fork_epoch")})


@pytest.mark.cuda
def test_boundary_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    dev = torch.device("cuda")
    st, spec = epoch_state(1 << 14, seed=9, preset="mainnet")   # 5,220 source messages
    ref = st.copy()
    enable_tree_cache(st, dev)
    ek.reset_launches()
    tsha.reset_launches()
    per_slot_processing(st, spec)
    epoch = misc.current_epoch(st, spec)
    got = misc.compute_committee_shuffle(st, spec, epoch)
    assert [k.launches for k in ek.KERNELS] == [1, 1]
    assert tsha.sha256_block_device.launches == 1
    per_slot_processing(ref, spec, CPU)
    assert port_digest(st) == port_digest(ref)
    assert st.hash_tree_root() == ref.hash_tree_root(CPU)
    np.testing.assert_array_equal(got, misc.compute_committee_shuffle(ref, spec, epoch,
                                                                      device=CPU))


@pytest.mark.parametrize("queued", [0, 3, 4, 9])
def test_batched_exits_match_the_scalar_exits_in_order(queued):
    """The exit queue as column arithmetic places each validator where the
    JAX package's scalar ``initiate_validator_exit``, called in registry
    order, does: from an empty, a part-full, an exactly full and an
    overfull tail epoch (minimal churn: 4 a epoch at this size)."""
    from lighthouse_tpu.state_transition import epoch_processing as jep

    from lighthouse_tpu_torch.state_transition import epoch_processing as tep

    st, spec = randomized_registry_state(300, "deneb", seed=queued, eject_frac=0.0)
    v = st.validators
    far = np.uint64(JT.FAR_FUTURE_EPOCH)
    v.exit_epoch[v.slashed] = far                       # an empty queue ...
    v.withdrawable_epoch[v.slashed] = far
    v.exit_epoch[(v.exit_epoch != far)] = np.uint64(3)  # ... below the activation-exit epoch
    tail = spec.compute_activation_exit_epoch(int(st.slot) // spec.slots_per_epoch) + 2
    open_rows = np.nonzero(v.exit_epoch == far)[0]
    v.exit_epoch[open_rows[:queued]] = np.uint64(tail)
    pst, pspec = _carry(st), _deneb(spec)
    rows = np.sort(np.random.default_rng(queued).choice(300, 40, replace=False))
    for i in rows:
        jep.initiate_validator_exit(st, spec, int(i))
    tep.initiate_validator_exits(pst, pspec, rows)
    np.testing.assert_array_equal(pst.validators.exit_epoch, v.exit_epoch)
    np.testing.assert_array_equal(pst.validators.withdrawable_epoch, v.withdrawable_epoch)
    assert len(set(v.exit_epoch[rows].tolist())) > 3
