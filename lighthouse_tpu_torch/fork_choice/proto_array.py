"""The proto-array node store: what attestation verification reads of it.

Port of the part of ``lighthouse_tpu/fork_choice/proto_array.py`` that the
gossip attestation path runs: the struct-of-arrays node columns, adding a
node (the anchor, and later blocks), membership (``__contains__`` :74),
``indices``, ``slots`` and ``get_ancestor`` (:253).  Weights, viability and
the head walk come with block import.
"""

from __future__ import annotations

import numpy as np

NONE = -1


class ProtoArrayError(ValueError):
    pass


class ProtoArray:
    """Insertion-ordered nodes: every parent precedes its children."""

    _GROW = 1024

    def __init__(self):
        self.n_nodes = 0
        self.slots = np.zeros(self._GROW, np.int64)
        self.parents = np.full(self._GROW, NONE, np.int32)
        self.roots: list[bytes] = []
        self.indices: dict[bytes, int] = {}

    def __len__(self) -> int:
        return self.n_nodes

    def __contains__(self, root: bytes) -> bool:
        return root in self.indices

    def add_block(self, root: bytes, parent_root: bytes | None, slot: int) -> int:
        if root in self.indices:
            return self.indices[root]
        parent = self.indices.get(parent_root, NONE) if parent_root else NONE
        if parent_root is not None and parent == NONE and self.n_nodes > 0:
            raise ProtoArrayError(f"unknown parent {parent_root.hex()[:16]}")
        if self.n_nodes == self.slots.shape[0]:
            self.slots = np.concatenate([self.slots, np.zeros_like(self.slots)])
            self.parents = np.concatenate([self.parents, np.full_like(self.parents, NONE)])
        i = self.n_nodes
        self.n_nodes += 1
        self.slots[i] = slot
        self.parents[i] = parent
        self.roots.append(root)
        self.indices[root] = i
        return i

    def get_ancestor(self, root: bytes, slot: int) -> bytes | None:
        """The block of ``root``'s chain at or below ``slot``."""
        i = self.indices.get(root)
        if i is None:
            return None
        while i != NONE and self.slots[i] > slot:
            i = self.parents[i]
        return self.roots[i] if i != NONE else None
