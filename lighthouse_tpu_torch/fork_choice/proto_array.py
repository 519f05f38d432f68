"""The proto-array node store: what attestation verification and block
import read and write of it.

Port of the part of ``lighthouse_tpu/fork_choice/proto_array.py`` that the
gossip attestation path and block import run: the struct-of-arrays node
columns with each node's justified, finalized and unrealized checkpoint
epochs and execution status, adding a node (``add_block`` :92),
membership (``__contains__`` :74), ``indices``, ``slots`` and
``get_ancestor`` (:253).  Weights, viability and the head walk are not
ported (ROADMAP A 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NONE = -1
EXEC_IRRELEVANT = 0  # no payload to verify (no execution engine wired)


@dataclass(frozen=True)
class CheckpointKey:
    epoch: int
    root: bytes


class ProtoArrayError(ValueError):
    pass


class ProtoArray:
    """Insertion-ordered nodes: every parent precedes its children."""

    _GROW = 1024

    _COLUMNS = {"slots": (np.int64, 0), "parents": (np.int32, NONE),
                "justified_epoch": (np.int64, 0), "finalized_epoch": (np.int64, 0),
                "unrealized_justified_epoch": (np.int64, 0),
                "unrealized_finalized_epoch": (np.int64, 0),
                "execution_status": (np.int8, 0)}

    def __init__(self):
        self.n_nodes = 0
        for name, (dtype, fill) in self._COLUMNS.items():
            setattr(self, name, np.full(self._GROW, fill, dtype))
        self.roots: list[bytes] = []
        self.indices: dict[bytes, int] = {}
        self.justified_roots: list[bytes] = []
        self.unrealized_justified_roots: list[bytes] = []

    def __len__(self) -> int:
        return self.n_nodes

    def __contains__(self, root: bytes) -> bool:
        return root in self.indices

    def add_block(self, root: bytes, parent_root: bytes | None, slot: int,
                  justified: CheckpointKey, finalized: CheckpointKey,
                  unrealized_justified: CheckpointKey | None = None,
                  unrealized_finalized: CheckpointKey | None = None,
                  execution_status: int = EXEC_IRRELEVANT) -> int:
        if root in self.indices:
            return self.indices[root]
        parent = self.indices.get(parent_root, NONE) if parent_root else NONE
        if parent_root is not None and parent == NONE and self.n_nodes > 0:
            raise ProtoArrayError(f"unknown parent {parent_root.hex()[:16]}")
        if self.n_nodes == self.slots.shape[0]:
            for name, (dtype, fill) in self._COLUMNS.items():
                col = getattr(self, name)
                setattr(self, name, np.concatenate([col, np.full(col.shape[0], fill, dtype)]))
        i = self.n_nodes
        self.n_nodes += 1
        uj = unrealized_justified or justified
        uf = unrealized_finalized or finalized
        self.slots[i] = slot
        self.parents[i] = parent
        self.justified_epoch[i] = justified.epoch
        self.finalized_epoch[i] = finalized.epoch
        self.unrealized_justified_epoch[i] = uj.epoch
        self.unrealized_finalized_epoch[i] = uf.epoch
        self.execution_status[i] = execution_status
        self.roots.append(root)
        self.indices[root] = i
        self.justified_roots.append(justified.root)
        self.unrealized_justified_roots.append(uj.root)
        return i

    def node(self, root: bytes) -> dict:
        """One node's columns, by block root (parent as a root, or None)."""
        i = self.indices[root]
        parent = int(self.parents[i])
        return dict(root=root, parent=self.roots[parent] if parent != NONE else None,
                    slot=int(self.slots[i]), justified_epoch=int(self.justified_epoch[i]),
                    finalized_epoch=int(self.finalized_epoch[i]),
                    unrealized_justified_epoch=int(self.unrealized_justified_epoch[i]),
                    unrealized_finalized_epoch=int(self.unrealized_finalized_epoch[i]),
                    justified_root=self.justified_roots[i],
                    execution_status=int(self.execution_status[i]))

    def get_ancestor(self, root: bytes, slot: int) -> bytes | None:
        """The block of ``root``'s chain at or below ``slot``."""
        i = self.indices.get(root)
        if i is None:
            return None
        while i != NONE and self.slots[i] > slot:
            i = self.parents[i]
        return self.roots[i] if i != NONE else None
