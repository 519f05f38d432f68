"""Per-slot processing.

Port of ``lighthouse_tpu/state_transition/slot_processing.py``: caching the
slot's state and block roots.  Epoch processing is not ported yet, so
``per_slot_processing`` refuses to cross an epoch boundary.
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.device import resolve_device
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
    """Advance the state by one slot within an epoch; returns the state
    root cached for the slot it leaves.  Raises ``NotImplementedError``
    when the next slot starts an epoch: epoch processing is not ported."""
    if (int(state.slot) + 1) % spec.preset.slots_per_epoch == 0:
        raise NotImplementedError(
            f"slot {int(state.slot)} ends an epoch and epoch processing is "
            "not ported yet")
    state_root = process_slot(state, spec, device)
    state.slot = int(state.slot) + 1
    return state_root
