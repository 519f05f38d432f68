"""Swap-or-not shuffle: the spec's ``compute_shuffled_index`` and the
whole-list shuffle of an epoch's active set.

Port of ``lighthouse_tpu/state_transition/shuffle.py``.  The whole-list
shuffle runs every round over every position at once: the per-round source
hashes hash(seed ‖ round ‖ chunk) of all rounds and chunks go through one
``sha256_block`` kernel call (``ops.sha256.sha256_msgs``), then all rounds
run in one ``shuffle_rounds`` kernel call.  The pivots, one hash per round,
stay on hashlib, as in the JAX package.

Routing by size, kept from the JAX package and not a fallback: a list of
fewer than ``BUCKET_FLOOR`` positions runs its hashes and rounds on the host,
through the kernels' plain versions on CPU tensors (a card launch per tiny
conformance shuffle costs more than it saves).
Everything larger runs on the given device, and a kernel fault raises.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import epoch_kernels as ek
from lighthouse_tpu_torch.ops import sha256 as sha_ops

#: lists below this many positions shuffle on the host (the JAX package's
#: epoch bucket floor, ``epoch_device.BUCKET_FLOOR_DEFAULT``)
BUCKET_FLOOR = 256


def compute_shuffled_index(index: int, count: int, seed: bytes, rounds: int) -> int:
    """Single-index forward shuffle (spec semantics, scalar)."""
    if not 0 <= index < count:
        raise ValueError(f"index {index} outside [0, {count})")
    for r in range(rounds):
        pivot = int.from_bytes(hashlib.sha256(seed + bytes([r])).digest()[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = hashlib.sha256(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")).digest()
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def _shuffle_hash_sweep(seed: bytes, rounds: int, count: int, device: torch.device):
    """All per-round pivots and source bytes of one shuffle.

    Returns (pivots int64[rounds], src uint8[rounds, n_chunks * 32]) where
    ``src[r][p >> 3]`` holds position p's decision byte for round r.  The
    source messages hash on ``device`` in one batch (``sha256_msgs``)."""
    digests = sha_ops.sha256_msgs(source_messages(seed, rounds, count), device=device)
    return shuffle_pivots(seed, rounds, count), digests.reshape(rounds, -1)


def shuffle_pivots(seed: bytes, rounds: int, count: int) -> np.ndarray:
    """int64[rounds]: each round's pivot, hash(seed ‖ round)[:8] mod count."""
    return np.array(
        [int.from_bytes(hashlib.sha256(seed + bytes([r])).digest()[:8], "little") % count
         for r in range(rounds)], dtype=np.int64)


def source_messages(seed: bytes, rounds: int, count: int) -> np.ndarray:
    """uint8[rounds * n_chunks, 37]: seed ‖ round ‖ chunk for every round
    and every 256-position chunk, round-major."""
    n_chunks = (count - 1) // 256 + 1
    msgs = np.zeros((rounds * n_chunks, 37), np.uint8)
    msgs[:, :32] = np.frombuffer(seed, np.uint8)
    msgs[:, 32] = np.repeat(np.arange(rounds, dtype=np.uint8), n_chunks)
    msgs[:, 33:37] = np.tile(np.arange(n_chunks, dtype="<u4"), rounds).view(np.uint8).reshape(-1, 4)
    return msgs


def shuffle_list(indices: np.ndarray, seed: bytes, rounds: int, *, device=None) -> np.ndarray:
    """The shuffled list: ``out[i] = indices[compute_shuffled_index(i, ...)]``.

    ``device`` (default ``cuda``) runs the source hashes and the rounds;
    lists of fewer than ``BUCKET_FLOOR`` positions run on the host (routing
    by size, not a fallback: the device is still resolved, and raises
    without a card)."""
    device = resolve_device(device)
    count = indices.shape[0]
    if count <= 1:
        return indices.copy()
    if count < BUCKET_FLOOR:
        device = torch.device("cpu")
    pivots, src = _shuffle_hash_sweep(seed, rounds, count, device)
    fwd = ek.shuffle_rounds(torch.from_numpy(pivots.astype(np.int32)).to(device),
                            torch.from_numpy(src).to(device), count)
    return indices[fwd.cpu().numpy()]
