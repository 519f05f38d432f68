"""The proto-array node store: block insertion, ancestry and the head.

Port of ``lighthouse_tpu/fork_choice/proto_array.py``: the struct-of-arrays
node columns with each node's weight, best child and best descendant,
justified, finalized and unrealized checkpoint epochs and execution status,
adding a node (``add_block`` :92), membership (``__contains__`` :74),
``indices``, ``slots``, the head's viability filter, score changes and walk
(``_viable_mask`` :131, ``apply_score_changes`` :169, ``find_head`` :233)
and ``get_ancestor`` (:253).  Pruning and the execution-status updates are
not ported (ROADMAP A 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NONE = -1
EXEC_IRRELEVANT = 0  # no payload to verify (no execution engine wired)
EXEC_INVALID = 3


@dataclass(frozen=True)
class CheckpointKey:
    epoch: int
    root: bytes


class ProtoArrayError(ValueError):
    pass


class ProtoArray:
    """Insertion-ordered nodes: every parent precedes its children."""

    _GROW = 1024

    _COLUMNS = {"slots": (np.int64, 0), "parents": (np.int32, NONE), "weights": (np.int64, 0),
                "best_child": (np.int32, NONE), "best_descendant": (np.int32, NONE),
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

    # -- the head -------------------------------------------------------------

    def _viable_mask(self, justified: CheckpointKey, finalized: CheckpointKey,
                     current_epoch: int) -> np.ndarray:
        """Each node's ``node_is_viable_for_head``: its voting source is the
        store's justified epoch, or was pulled up to it, or is within two
        epochs; it descends from the finalized block (one forward sweep:
        parents precede children); its payload is not invalid."""
        n = self.n_nodes
        je = self.justified_epoch[:n]
        uje = self.unrealized_justified_epoch[:n]
        ok_j = ((justified.epoch == 0) | (je == justified.epoch) | (uje >= justified.epoch)
                | (je + 2 >= current_epoch))
        if finalized.epoch == 0 or finalized.root not in self.indices:
            ok_f = np.ones(n, bool)
        else:
            fin = self.indices[finalized.root]
            ok_f = np.zeros(n, bool)
            ok_f[fin] = True
            parents = self.parents[:n]
            for i in range(fin + 1, n):
                p = parents[i]
                if p != NONE and ok_f[p]:
                    ok_f[i] = True
        return ok_j & ok_f & (self.execution_status[:n] != EXEC_INVALID)

    def apply_score_changes(self, deltas: np.ndarray, justified: CheckpointKey,
                            finalized: CheckpointKey, current_epoch: int) -> None:
        """Add ``deltas`` (int64[n_nodes]) to the weights, carried from
        child to parent in one reverse sweep, then rebuild the best child
        and best descendant pointers in a second (ties to the larger
        root)."""
        n = self.n_nodes
        if n == 0:
            return
        if deltas.shape[0] != n:
            raise ProtoArrayError("delta length mismatch")
        d = deltas.astype(np.int64, copy=True)
        parents = self.parents[:n]
        for i in range(n - 1, 0, -1):
            if parents[i] != NONE:
                d[parents[i]] += d[i]
        self.weights[:n] += d
        viable = self._viable_mask(justified, finalized, current_epoch)
        weights = self.weights[:n]
        best_child = np.full(n, NONE, np.int32)
        best_descendant = np.full(n, NONE, np.int32)
        for i in range(n - 1, -1, -1):
            p = parents[i]
            if p == NONE or (not viable[i] and best_descendant[i] == NONE):
                continue
            cur = best_child[p]
            if cur == NONE:
                take = True
            elif weights[i] != weights[cur]:
                take = weights[i] > weights[cur]
            else:
                take = self.roots[i] > self.roots[cur]
            if take:
                best_child[p] = i
                bd = best_descendant[i]
                best_descendant[p] = bd if bd != NONE else (i if viable[i] else NONE)
        own = (best_descendant == NONE) & viable
        best_descendant[own] = np.nonzero(own)[0]
        self.best_child[:n] = best_child
        self.best_descendant[:n] = best_descendant
        self._viable = viable

    def find_head(self, justified_root: bytes) -> bytes:
        """The best descendant of the justified node (the node itself when
        it has none, or when that descendant is not viable)."""
        if justified_root not in self.indices:
            raise ProtoArrayError(f"unknown justified root {justified_root.hex()[:16]}")
        start = self.indices[justified_root]
        bd = self.best_descendant[start]
        head = bd if bd != NONE else start
        viable = getattr(self, "_viable", None)
        if viable is not None and head < viable.shape[0] and not viable[head]:
            head = start
        return self.roots[head]

    def get_ancestor(self, root: bytes, slot: int) -> bytes | None:
        """The block of ``root``'s chain at or below ``slot``."""
        i = self.indices.get(root)
        if i is None:
            return None
        while i != NONE and self.slots[i] > slot:
            i = self.parents[i]
        return self.roots[i] if i != NONE else None
