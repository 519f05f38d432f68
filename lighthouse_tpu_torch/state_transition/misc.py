"""Spec helper functions over the columnar state: epochs, seeds, active
sets, churn, committees and the next sync committee.

Port of the part of ``lighthouse_tpu/state_transition/misc.py`` that epoch
processing, the committee shuffle, attestation signing roots and block
processing use (proposer selection, deposit branches).  The shuffle of a whole epoch's
active set (``compute_committee_shuffle``) runs on the card through
``state_transition.shuffle``.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np

from lighthouse_tpu_torch.state_transition.shuffle import compute_shuffled_index, shuffle_list
from lighthouse_tpu_torch.types import GENESIS_EPOCH, ChainSpec, ForkData, SigningData, make_types


def current_epoch(state, spec: ChainSpec) -> int:
    return spec.compute_epoch_at_slot(int(state.slot))


def previous_epoch(state, spec: ChainSpec) -> int:
    cur = current_epoch(state, spec)
    return cur - 1 if cur > GENESIS_EPOCH else GENESIS_EPOCH


def get_block_root_at_slot(state, spec: ChainSpec, slot: int) -> bytes:
    if not slot < int(state.slot) <= slot + spec.preset.slots_per_historical_root:
        raise ValueError(f"slot {slot} out of block_roots range at {state.slot}")
    return state.block_roots[slot % spec.preset.slots_per_historical_root].tobytes()


def get_block_root(state, spec: ChainSpec, epoch: int) -> bytes:
    return get_block_root_at_slot(state, spec, spec.compute_start_slot_at_epoch(epoch))


def get_randao_mix(state, spec: ChainSpec, epoch: int) -> bytes:
    return state.randao_mixes[epoch % spec.preset.epochs_per_historical_vector].tobytes()


def get_seed(state, spec: ChainSpec, epoch: int, domain_type: int) -> bytes:
    mix = get_randao_mix(
        state, spec,
        epoch + spec.preset.epochs_per_historical_vector - spec.min_seed_lookahead - 1)
    return hashlib.sha256(
        domain_type.to_bytes(4, "little") + epoch.to_bytes(8, "little") + mix).digest()


# --- domains and signing roots (JAX misc.py:25-70) --------------------------
# The containers hashed here are two to eight chunks: hashlib on the host,
# which is where the sha256 module routes a merkle tree this small anyway.

@functools.lru_cache(maxsize=256)
def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return ForkData(current_version=bytes(current_version),
                    genesis_validators_root=bytes(genesis_validators_root)).hash_tree_root("cpu")


@functools.lru_cache(maxsize=256)
def _compute_domain_cached(domain_type: int, fork_version: bytes,
                           genesis_validators_root: bytes) -> bytes:
    root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type.to_bytes(4, "little") + root[:28]


def compute_domain(domain_type: int, fork_version, genesis_validators_root) -> bytes:
    """Memoized per (domain, fork version, network)."""
    return _compute_domain_cached(int(domain_type), bytes(fork_version),
                                  bytes(genesis_validators_root))


def get_domain(state, spec: ChainSpec, domain_type: int, epoch: int | None = None) -> bytes:
    e = epoch if epoch is not None else current_epoch(state, spec)
    fork = state.fork
    version = fork.previous_version if e < int(fork.epoch) else fork.current_version
    return compute_domain(domain_type, version, state.genesis_validators_root)


def compute_signing_root(obj_root: bytes, domain: bytes) -> bytes:
    return SigningData(object_root=obj_root, domain=domain).hash_tree_root("cpu")


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    return np.nonzero(state.validators.is_active(epoch))[0]


def get_total_active_balance(state, spec: ChainSpec) -> int:
    active = state.validators.is_active(current_epoch(state, spec))
    total = int(state.validators.effective_balance[active].sum())
    return max(spec.effective_balance_increment, total)


def get_validator_churn_limit(state, spec: ChainSpec) -> int:
    active = int(state.validators.is_active(current_epoch(state, spec)).sum())
    return max(spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient)


def get_validator_activation_churn_limit(state, spec: ChainSpec) -> int:
    """Deneb caps per-epoch activations below the churn limit."""
    return min(spec.max_per_epoch_activation_churn_limit,
               get_validator_churn_limit(state, spec))


def get_committee_count_per_slot(spec: ChainSpec, active_count: int) -> int:
    return max(1, min(spec.preset.max_committees_per_slot,
                      active_count // spec.preset.slots_per_epoch
                      // spec.preset.target_committee_size))


def compute_committee_shuffle(state, spec: ChainSpec, epoch: int, *, device=None) -> np.ndarray:
    """The shuffled active-validator list of ``epoch`` (committees are
    contiguous slices of it): one ``shuffle_list`` over the whole active
    set, on ``device`` (default ``cuda``)."""
    indices = get_active_validator_indices(state, epoch)
    seed = get_seed(state, spec, epoch, spec.domain_beacon_attester)
    return shuffle_list(indices, seed, spec.preset.shuffle_round_count, device=device)


def get_beacon_committee(state, spec: ChainSpec, slot: int, index: int,
                         shuffled: np.ndarray | None = None, *, device=None) -> np.ndarray:
    """Committee ``index`` of ``slot``.  Pass ``shuffled`` (from
    ``compute_committee_shuffle``) to share one shuffle over an epoch."""
    epoch = spec.compute_epoch_at_slot(slot)
    if shuffled is None:
        shuffled = compute_committee_shuffle(state, spec, epoch, device=device)
    count = shuffled.shape[0]
    per_slot = get_committee_count_per_slot(spec, count)
    if index >= per_slot:
        raise ValueError(f"committee index {index} >= committees per slot {per_slot}")
    committees_per_epoch = per_slot * spec.preset.slots_per_epoch
    committee_index = (slot % spec.preset.slots_per_epoch) * per_slot + index
    start = count * committee_index // committees_per_epoch
    end = count * (committee_index + 1) // committees_per_epoch
    return shuffled[start:end]


def compute_proposer_index(state, spec: ChainSpec, indices: np.ndarray, seed: bytes) -> int:
    """Rejection-sample a proposer weighted by effective balance (host
    swap-or-not per candidate, as in the JAX package)."""
    if indices.shape[0] == 0:
        raise ValueError("no active validators")
    max_eb = spec.max_effective_balance
    total = indices.shape[0]
    i = 0
    while True:
        cand = int(indices[compute_shuffled_index(
            i % total, total, seed, spec.preset.shuffle_round_count)])
        rand = hashlib.sha256(seed + (i // 32).to_bytes(8, "little")).digest()[i % 32]
        if int(state.validators.effective_balance[cand]) * 255 >= max_eb * rand:
            return cand
        i += 1


def get_beacon_proposer_index(state, spec: ChainSpec, slot: int | None = None) -> int:
    s = int(state.slot) if slot is None else slot
    epoch = spec.compute_epoch_at_slot(s)
    seed = hashlib.sha256(
        get_seed(state, spec, epoch, spec.domain_beacon_proposer) + s.to_bytes(8, "little")
    ).digest()
    return compute_proposer_index(state, spec, get_active_validator_indices(state, epoch), seed)


def get_next_sync_committee_indices(state, spec: ChainSpec) -> list[int]:
    """The spec's balance-weighted sample of the next period's sync
    committee (scalar shuffled indices, as in the JAX package)."""
    epoch = current_epoch(state, spec) + 1
    indices = get_active_validator_indices(state, epoch)
    seed = get_seed(state, spec, epoch, spec.domain_sync_committee)
    total = indices.shape[0]
    max_eb = spec.max_effective_balance
    out: list[int] = []
    i = 0
    while len(out) < spec.preset.sync_committee_size:
        cand = int(indices[compute_shuffled_index(
            i % total, total, seed, spec.preset.shuffle_round_count)])
        rand = hashlib.sha256(seed + (i // 32).to_bytes(8, "little")).digest()[i % 32]
        if int(state.validators.effective_balance[cand]) * 255 >= max_eb * rand:
            out.append(cand)
        i += 1
    return out


def get_next_sync_committee(state, spec: ChainSpec):
    """The next period's ``SyncCommittee``: its members' keys and their
    aggregate, summed with host G1 adds."""
    from lighthouse_tpu_torch.crypto.bls import curve as cv

    pubkeys = [state.validators.pubkeys[i].tobytes()
               for i in get_next_sync_committee_indices(state, spec)]
    pt = cv.INF
    for pk in pubkeys:
        pt = cv.g1_add(pt, cv.g1_from_bytes(pk))
    return make_types(spec.preset).SyncCommittee(
        pubkeys=pubkeys, aggregate_pubkey=cv.g1_to_bytes(pt))


def integer_squareroot(n: int) -> int:
    return math.isqrt(n)


def is_valid_merkle_branch(leaf: bytes, branch: list[bytes], depth: int, index: int,
                           root: bytes) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hashlib.sha256(branch[i] + value).digest()
        else:
            value = hashlib.sha256(value + branch[i]).digest()
    return value == root


def attestation_committee_index(attestation) -> int:
    """The committee an attestation covers: ``data.index`` before Electra
    (Electra's committee bits are not ported, ROADMAP A 16)."""
    if hasattr(attestation, "committee_bits"):
        raise NotImplementedError("Electra attestations are not ported (ROADMAP A 16)")
    return int(attestation.data.index)
