"""The port's Deneb state root and ``process_slot`` against the JAX package.

A minimal-preset Deneb state from the JAX package's seeded registry
state function is carried into the port through its SSZ bytes
(``convert.state_from_ssz``); both packages then hash the same state.  The
port's routing thresholds are lowered so that every level takes the tensor
path (the kernels' plain versions on the CPU).  Roots are compared bit for
bit.
"""

import re
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from lighthouse_tpu.ssz.tree_cache import enable_tree_cache as jax_enable_tree_cache
from lighthouse_tpu.state_transition import process_slot as jax_process_slot
from lighthouse_tpu.testing import randomized_registry_state
from lighthouse_tpu_torch import device as tdevice
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.ops import sha256 as tsha
from lighthouse_tpu_torch.ssz.tree_cache import enable_tree_cache
from lighthouse_tpu_torch.state_transition import per_slot_processing, process_slot
from lighthouse_tpu_torch.testing import build_state
from lighthouse_tpu_torch.types import ChainSpec, Validator, Validators

CPU = torch.device("cpu")
N = 256
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tensor_path(monkeypatch):
    """Route every level and fold to the tensor path."""
    monkeypatch.setattr(tsha, "_DEVICE_MIN_PAIRS", 1)
    monkeypatch.setattr(tsha, "_DEVICE_FOLD_MIN_LEAVES", 1)


def _pair(seed: int = 11):
    """The JAX package's state and the port's copy of it."""
    st, spec = randomized_registry_state(N, "deneb", seed)
    return st, spec, state_from_ssz(st.serialize(), "deneb", "minimal")


def test_state_carries_across_byte_for_byte():
    st, _, pst = _pair()
    assert type(pst).__name__ == "BeaconStateDeneb"
    assert pst.serialize() == st.serialize()
    with pytest.raises(NotImplementedError):
        state_from_ssz(st.serialize(), "electra", "minimal")


@pytest.mark.parametrize("route", ["fold", "levels"])
def test_state_root_matches_jax(monkeypatch, route):
    monkeypatch.setattr(tsha, "_DEVICE_MIN_PAIRS", 1)
    if route == "fold":
        monkeypatch.setattr(tsha, "_DEVICE_FOLD_MIN_LEAVES", 1)
    st, _, pst = _pair()
    assert pst.hash_tree_root(CPU) == st.hash_tree_root()


def test_state_root_on_host_path_matches_jax():
    st, _, pst = _pair(seed=12)
    assert pst.hash_tree_root("cpu") == st.hash_tree_root()


def test_validator_view_root_matches_registry_row_and_jax(tensor_path):
    """The object view of one registry row hashes to the row's columnar
    root, in both packages."""
    st, _, pst = _pair()
    i = 17
    v = pst.validators
    view = Validator(**{f: (bytes(getattr(v, c)[i]) if getattr(v, c).ndim == 2
                            else getattr(v, c)[i].item())
                        for f, c in zip(Validator.fields, Validators._COLUMNS)})
    row_roots = pst.fields["validators"].batch_roots(v, CPU)
    assert view.hash_tree_root(CPU) == tsha.words_to_bytes(row_roots[i])
    jax_roots = type(st).fields["validators"].batch_roots(st.validators)
    np.testing.assert_array_equal(row_roots, jax_roots)


def _mutate(rng, states, step):
    """Equal block-shaped column writes on both packages' states."""
    idx = rng.choice(N, 16, replace=False)
    flags = rng.integers(0, 8, 16).astype(np.uint8)
    bal = rng.integers(0, 40 * 10**9, 16).astype(np.uint64)
    for s in states:
        s.current_epoch_participation[idx] = flags
        s.balances[idx] = bal
        s.inactivity_scores[idx[:4]] += np.uint64(step + 1)
        if step == 1:
            s.validators.effective_balance[idx[:3]] = np.uint64(7 * 10**9)
            s.randao_mixes[step] = np.full(32, step, np.uint8)


@pytest.mark.parametrize("cached", [False, True])
def test_process_slot_matches_jax(tensor_path, cached):
    st, spec, pst = _pair(seed=13)
    if cached:
        jax_enable_tree_cache(st)
        enable_tree_cache(pst, CPU)
    pspec = ChainSpec.minimal()
    rng = np.random.default_rng(5)
    for step in range(3):
        _mutate(rng, (st, pst), step)
        assert process_slot(pst, pspec, CPU) == jax_process_slot(st, spec), step
        np.testing.assert_array_equal(pst.state_roots, st.state_roots)
        np.testing.assert_array_equal(pst.block_roots, st.block_roots)
        assert pst.latest_block_header.state_root == st.latest_block_header.state_root
        st.slot += 1
        pst.slot += 1
    assert pst.hash_tree_root(CPU) == st.hash_tree_root()


def _uncached_root(state) -> bytes:
    copy = state.copy()
    del copy._tree_cache
    return copy.hash_tree_root(CPU)


def test_tree_cache_follows_registry_growth(tensor_path):
    """Appended validators grow the cached trees past their power of two;
    the cached root still equals an uncached one."""
    pst, spec = build_state(40, seed=3, preset="minimal")
    enable_tree_cache(pst, CPU)
    pst.hash_tree_root()
    grown = build_state(70, seed=4, preset="minimal")[0]
    cols = {c: np.concatenate([getattr(pst.validators, c), getattr(grown.validators, c)[40:]])
            for c in Validators._COLUMNS}
    pst.validators = Validators.from_columns(cols)
    for f in ("balances", "previous_epoch_participation", "current_epoch_participation",
              "inactivity_scores"):
        setattr(pst, f, np.concatenate([getattr(pst, f), getattr(grown, f)[40:]]))
    assert pst.hash_tree_root() == _uncached_root(pst)
    per_slot_processing(pst, spec)
    assert pst.hash_tree_root() == _uncached_root(pst)


def test_per_slot_processing_stops_at_an_epoch_boundary():
    """Under a schedule where the epoch is not Deneb (the minimal config's
    forks are all far in the future) the boundary raises before anything
    is written; Deneb epochs cross (tests/test_torch_epoch.py)."""
    _, _, pst = _pair()
    spec = ChainSpec.minimal()
    assert int(pst.slot) % spec.slots_per_epoch == spec.slots_per_epoch - 1
    before = pst.serialize()
    with pytest.raises(NotImplementedError):
        per_slot_processing(pst, spec, CPU)
    assert pst.serialize() == before
    pst.slot = int(pst.slot) + 1
    root = pst.hash_tree_root(CPU)
    assert per_slot_processing(pst, spec, CPU) == root
    assert int(pst.slot) % spec.slots_per_epoch == 1


def test_entry_points_need_a_card_unless_cpu_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pst = _pair()
    spec = ChainSpec.minimal()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pst.hash_tree_root()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_slot(pst, spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enable_tree_cache(pst)
    assert tdevice.resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|lighthouse_tpu(?!_torch))\b",
                         re.M)
    files = sorted((REPO / "lighthouse_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(REPO / "lighthouse_tpu_torch")) for f in files[:-1]}
    assert {"ops/epoch_kernels.py", "state_transition/epoch_device.py",
            "state_transition/epoch_processing.py", "state_transition/misc.py",
            "state_transition/shuffle.py", "ops/fr.py", "crypto/kzg.py", "parallel/mesh.py",
            "parallel/bls_sharded.py", "parallel/dryrun_worker.py", "parallel/epoch_sharded.py",
            "parallel/msm_sharded.py", "crypto/das.py", "ops/faults.py",
            "crypto/bls/api.py", "fork_choice/proto_array.py"} <= names
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


@pytest.mark.cuda
def test_state_root_on_the_card_matches_hashlib(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    state, _ = build_state(1 << 13, seed=5, preset="mainnet")
    tsha.reset_launches()
    on_card = state.hash_tree_root("cuda")
    assert all(k.launches > 0 for k in (tsha.hash_pairs_device, tsha.fold_to_root_device))
    monkeypatch.setattr(tsha, "_DEVICE_MIN_PAIRS", 1 << 62)
    monkeypatch.setattr(tsha, "_DEVICE_FOLD_MIN_LEAVES", 1 << 62)
    assert on_card == state.hash_tree_root("cuda")
