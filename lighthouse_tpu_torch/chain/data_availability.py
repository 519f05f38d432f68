"""The data-availability checker (Deneb): a block that carries blob
commitments imports only once every commitment has a verified sidecar.

Port of ``lighthouse_tpu/chain/data_availability.py``: pending blocks and
sidecars are held per block root, least recently used out past
``capacity``; finalization prunes blocks below the finalized slot.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field


@dataclass
class PendingComponents:
    block: object | None = None
    blobs: dict[int, object] = field(default_factory=dict)     # index -> sidecar

    def num_expected(self) -> int | None:
        if self.block is None:
            return None
        return len(self.block.message.body.blob_kzg_commitments)


@dataclass
class Availability:
    """Available (the block and its sidecars in index order) or still
    missing components (no block)."""

    block_root: bytes
    block: object | None = None
    blobs: list | None = None

    @property
    def is_available(self) -> bool:
        return self.block is not None


class DataAvailabilityChecker:
    def __init__(self, spec, capacity: int = 64):
        self.spec = spec
        self.capacity = capacity
        self._pending: OrderedDict[bytes, PendingComponents] = OrderedDict()

    def _entry(self, block_root: bytes) -> PendingComponents:
        entry = self._pending.get(block_root)
        if entry is None:
            entry = self._pending[block_root] = PendingComponents()
            while len(self._pending) > self.capacity:
                self._pending.popitem(last=False)
        else:
            self._pending.move_to_end(block_root)
        return entry

    def _check(self, block_root: bytes) -> Availability:
        entry = self._pending.get(block_root)
        if entry is None:
            return Availability(block_root)
        expected = entry.num_expected()
        if expected is None or len(entry.blobs) < expected:
            return Availability(block_root)
        blobs = [entry.blobs[i] for i in sorted(entry.blobs)][:expected]
        self._pending.pop(block_root, None)
        return Availability(block_root, entry.block, blobs)

    def put_verified_blobs(self, block_root: bytes, verified_blobs) -> Availability:
        """Record verified sidecars (``VerifiedBlob`` or the sidecars
        themselves) -> the block's availability."""
        entry = self._entry(block_root)
        for vb in verified_blobs:
            sidecar = getattr(vb, "sidecar", vb)
            entry.blobs[int(sidecar.index)] = sidecar
        return self._check(block_root)

    def put_pending_executed_block(self, block_root: bytes, block) -> Availability:
        """Record a fully verified block that waits for its sidecars."""
        entry = self._entry(block_root)
        entry.block = block
        return self._check(block_root)

    def has_block(self, block_root: bytes) -> bool:
        entry = self._pending.get(block_root)
        return entry is not None and entry.block is not None

    def missing_blob_indices(self, block_root: bytes) -> list[int] | None:
        entry = self._pending.get(block_root)
        if entry is None or entry.block is None:
            return None
        return [i for i in range(entry.num_expected() or 0) if i not in entry.blobs]

    def prune_finalized(self, finalized_slot: int) -> None:
        for root in list(self._pending):
            entry = self._pending[root]
            if entry.block is not None and int(entry.block.message.slot) < finalized_slot:
                del self._pending[root]

    def __len__(self) -> int:
        return len(self._pending)
