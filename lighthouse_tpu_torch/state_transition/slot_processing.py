"""Per-slot processing and state advance.

Port of ``lighthouse_tpu/state_transition/slot_processing.py``: caching the
slot's state and block roots, and the Deneb epoch transition on the last
slot of each epoch (``epoch_processing.process_epoch``).  Fork upgrades
are not ported: a slot whose epoch, or the next, is not Deneb raises
``NotImplementedError`` before anything is written.
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.state_transition.epoch_processing import process_epoch
from lighthouse_tpu_torch.types import BeaconBlockHeader, ChainSpec


def process_slot(state, spec: ChainSpec, device=None) -> bytes:
    """Cache the state/block roots for the current slot.  Returns the state
    root that was cached.  With a tree cache attached, the cache's device
    is used."""
    if getattr(state, "_tree_cache", None) is not None:
        device = state._tree_cache.device if device is None else device
    device = resolve_device(device)
    sphr = spec.preset.slots_per_historical_root
    state_root = state.hash_tree_root(device)
    state.state_roots[int(state.slot) % sphr] = np.frombuffer(state_root, np.uint8)
    header = state.latest_block_header
    if header.state_root == b"\x00" * 32:
        state.latest_block_header = BeaconBlockHeader(
            slot=header.slot, proposer_index=header.proposer_index,
            parent_root=header.parent_root, state_root=state_root,
            body_root=header.body_root)
    block_root = state.latest_block_header.hash_tree_root(device)
    state.block_roots[int(state.slot) % sphr] = np.frombuffer(block_root, np.uint8)
    return state_root


def per_slot_processing(state, spec: ChainSpec, device=None) -> bytes:
    """Advance the state by one slot, running the epoch transition when the
    slot ends an epoch; returns the state root cached for the slot it
    leaves.  With a tree cache attached, the cache's device is used."""
    if getattr(state, "_tree_cache", None) is not None:
        device = state._tree_cache.device if device is None else device
    device = resolve_device(device)
    ends_epoch = (int(state.slot) + 1) % spec.preset.slots_per_epoch == 0
    if ends_epoch:
        epoch = spec.compute_epoch_at_slot(int(state.slot))
        forks = (spec.fork_at_epoch(epoch), spec.fork_at_epoch(epoch + 1))
        if forks != ("deneb", "deneb"):
            raise NotImplementedError(
                f"slot {int(state.slot)} ends epoch {epoch} ({forks[0]}, next {forks[1]}): "
                "only Deneb epochs are ported, without fork upgrades")
    state_root = process_slot(state, spec, device)
    if ends_epoch:
        process_epoch(state, spec, device)
    state.slot = int(state.slot) + 1
    return state_root


def state_advance(state, spec: ChainSpec, target_slot: int, device=None) -> None:
    """Run per-slot processing up to ``target_slot`` (complete state
    advance)."""
    if target_slot < int(state.slot):
        raise ValueError("cannot advance backwards")
    while int(state.slot) < target_slot:
        per_slot_processing(state, spec, device)
