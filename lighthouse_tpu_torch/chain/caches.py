"""Chain caches of the attestation and block paths: committee shuffles,
the observed-attester bitmaps and the observed block producers.

Port of ``ShufflingCache`` (:21), ``EpochIndexedSeen`` (:106-160),
``SlotIndexedSeen`` (:161-180) and ``ObservedDigests`` (:183-205) of
``lighthouse_tpu/chain/caches.py``.
Observed attesters are epoch-keyed boolean numpy columns over validator
index, so a batch is one vectorised gather or scatter.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


class ShufflingCache:
    """Committee shuffles keyed by (epoch, key), least recently used out."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._d: OrderedDict[tuple[int, bytes], np.ndarray] = OrderedDict()

    def get(self, epoch: int, key: bytes) -> np.ndarray | None:
        shuffle = self._d.get((epoch, key))
        if shuffle is not None:
            self._d.move_to_end((epoch, key))
        return shuffle

    def insert(self, epoch: int, key: bytes, shuffle: np.ndarray):
        self._d[(epoch, key)] = shuffle
        self._d.move_to_end((epoch, key))
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)


class EpochIndexedSeen:
    """Epoch-keyed seen bitmaps over validator index."""

    def __init__(self, retained_epochs: int = 4):
        self.retained = retained_epochs
        self._by_epoch: dict[int, np.ndarray] = {}

    def _bitmap(self, epoch: int, n: int) -> np.ndarray:
        bm = self._by_epoch.get(epoch)
        if bm is None:
            bm = np.zeros(max(n, 1024), bool)
            self._by_epoch[epoch] = bm
            for e in [e for e in self._by_epoch if e + self.retained < epoch]:
                del self._by_epoch[e]
        elif bm.shape[0] < n:
            bm = np.concatenate([bm, np.zeros(n - bm.shape[0], bool)])
            self._by_epoch[epoch] = bm
        return bm

    def observe_batch(self, epoch: int, indices: np.ndarray) -> np.ndarray:
        """Mark indices seen; returns the mask of those ALREADY seen."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0:
            return np.zeros(0, bool)
        bm = self._bitmap(epoch, int(idx.max()) + 1)
        already = bm[idx].copy()
        bm[idx] = True
        return already

    def seen_mask(self, epoch: int, indices: np.ndarray) -> np.ndarray:
        """Read-only: which of ``indices`` are already seen.  Dup checks run
        before signature verification and marks are claimed only after it
        succeeds, so unauthenticated input cannot poison the cache."""
        idx = np.asarray(indices, np.int64)
        out = np.zeros(idx.shape[0], bool)
        bm = self._by_epoch.get(epoch)
        if bm is None or idx.size == 0:
            return out
        inb = idx < bm.shape[0]
        out[inb] = bm[idx[inb]]
        return out

    def seen_indices(self, epoch: int) -> np.ndarray:
        """The validator indices marked seen in ``epoch``."""
        bm = self._by_epoch.get(epoch)
        return np.zeros(0, np.int64) if bm is None else np.nonzero(bm)[0]


class SlotIndexedSeen:
    """(slot, validator index) pairs seen, slot-keyed: the observed block
    producers that ``verify_block_for_gossip`` checks."""

    def __init__(self, retained_slots: int = 64):
        self.retained = retained_slots
        self._by_slot: dict[int, set[int]] = {}

    def observe(self, slot: int, index: int) -> bool:
        """Mark (slot, index) seen; True if it already was."""
        s = self._by_slot.setdefault(slot, set())
        for old in [x for x in self._by_slot if x + self.retained < slot]:
            del self._by_slot[old]
        if index in s:
            return True
        s.add(index)
        return False

    def is_seen(self, slot: int, index: int) -> bool:
        """Read-only probe, for the check before the proposer's signature."""
        return index in self._by_slot.get(slot, ())


class ObservedDigests:
    """Epoch-keyed digests of seen objects (the blob sidecars a chain has
    accepted: block root and index)."""

    def __init__(self, retained_epochs: int = 4):
        self.retained = retained_epochs
        self._by_epoch: dict[int, set[bytes]] = {}

    def observe(self, epoch: int, data: bytes) -> bool:
        """Mark ``data`` seen in ``epoch``; True if it already was."""
        d = hashlib.sha256(data).digest()
        seen = self._by_epoch.setdefault(epoch, set())
        for old in [e for e in self._by_epoch if e + self.retained < epoch]:
            del self._by_epoch[old]
        if d in seen:
            return True
        seen.add(d)
        return False

    def is_seen(self, epoch: int, data: bytes) -> bool:
        """Read-only probe, for the checks before the signature."""
        return hashlib.sha256(data).digest() in self._by_epoch.get(epoch, ())
