"""Incremental tree-hash cache for the state root.

Port of ``lighthouse_tpu/ssz/tree_cache.py``.  Every heavy state field
keeps a snapshot of its leaf chunks plus its full merkle tree; an update
rebuilds the leaf chunks from the live columns, diffs them against the
snapshot to find the dirty leaves, and rehashes only their paths, one
batched pair-hash call per level.  SHA-256 work per slot therefore scales
with the diff, not with the state.

Placement differs from the JAX package, which keeps every level in host
numpy arrays: here the host keeps only the leaf snapshot the diff needs,
while the leaves and all interior levels live as tensors on the cache's
device.  A full build is one fold-levels kernel call on the uploaded
leaves; an update uploads only the dirty leaf rows and their path indices,
and the rehash runs on the pair-hash kernel with no host round trip
between levels.  The JAX thresholds that keep small levels on the host do
not apply: they weigh a transfer that this placement no longer makes.
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import sha256 as sha_ops
from lighthouse_tpu_torch.ssz.core import _next_pow2
from lighthouse_tpu_torch.types import registry as reg

_ZERO = sha_ops.ZERO_HASH_WORDS  # uint32[depth + 1, 8] ladder


class IncrementalTree:
    """Merkle tree over uint32[n, 8] leaf chunks with dirty-path updates.

    Levels are stored padded to the power of two above the live leaf count;
    padded nodes hold the zero-subtree ladder, so every sibling is in the
    array.  The virtual depth up to ``limit`` is climbed with ladder
    constants at ``root_words`` time (log2(limit) host hashes).
    """

    __slots__ = ("limit", "n", "device", "leaves", "nodes")

    def __init__(self, leaves: np.ndarray, limit: int, device: torch.device):
        self.limit = max(int(limit), 1)
        self.device = device
        self._build(leaves)

    def _build(self, leaves: np.ndarray) -> None:
        n = leaves.shape[0]
        if n > self.limit:
            raise ValueError(f"{n} leaves exceed limit {self.limit}")
        self.n = n
        padded = np.zeros((_next_pow2(max(n, 1)), 8), dtype=np.uint32)
        padded[:n] = leaves
        self.leaves = padded                      # host snapshot for the diff
        dev_leaves = sha_ops.to_tensor(padded, self.device)
        self.nodes = [dev_leaves] + sha_ops.fold_levels(dev_leaves)

    def update(self, new_leaves: np.ndarray, dirty: np.ndarray | None = None) -> None:
        """Re-root after mutation.  ``new_leaves`` is the full current leaf
        array; ``dirty`` optionally names the changed rows (skips the diff).
        Shrinks trigger a full rebuild (list truncation never happens in
        the spec)."""
        n_new = new_leaves.shape[0]
        if n_new > self.limit:
            raise ValueError(f"{n_new} leaves exceed limit {self.limit}")
        if n_new < self.n:
            self._build(new_leaves)
            return
        pow2 = _next_pow2(max(n_new, 1))
        if pow2 != self.leaves.shape[0]:
            self._grow(pow2)

        if dirty is None:
            same = (self.leaves[: self.n] == new_leaves[: self.n]).all(axis=1)
            dirty = np.nonzero(~same)[0]
        else:
            dirty = np.asarray(dirty, dtype=np.int64)
            dirty = dirty[dirty < self.n]
        if n_new > self.n:
            dirty = np.concatenate([dirty, np.arange(self.n, n_new, dtype=np.int64)])
        self.n = n_new
        if dirty.size == 0:
            return

        self.leaves[dirty] = new_leaves[dirty]
        # every level's dirty rows, computed on the host and uploaded at once
        rows = [dirty.astype(np.int64)]
        for _ in range(len(self.nodes) - 1):
            rows.append(np.unique(rows[-1] >> 1))
        idx = torch.from_numpy(np.concatenate(rows)).to(self.device)
        idx_levels = torch.split(idx, [r.shape[0] for r in rows])
        self.nodes[0].index_copy_(
            0, idx_levels[0], sha_ops.to_tensor(new_leaves[dirty], self.device))
        for k in range(1, len(self.nodes)):
            pairs = self.nodes[k - 1].view(-1, 16).index_select(0, idx_levels[k])
            self.nodes[k].index_copy_(0, idx_levels[k], sha_ops.hash_pairs_device(pairs))

    def _grow(self, pow2: int) -> None:
        """Extend padded storage to a larger power of two; new regions hold
        zero-subtree constants (real values arrive via dirty paths)."""
        old = self.leaves
        self.leaves = np.zeros((pow2, 8), dtype=np.uint32)
        self.leaves[: old.shape[0]] = old
        nodes, size = [], pow2
        for k in range(pow2.bit_length()):
            ext = sha_ops.to_tensor(np.broadcast_to(_ZERO[k], (size, 8)), self.device)
            if k < len(self.nodes):
                ext[: self.nodes[k].shape[0]] = self.nodes[k]
            nodes.append(ext)
            size //= 2
        self.nodes = nodes

    def root_words(self) -> np.ndarray:
        """uint32[8] root at the virtual ``limit`` depth."""
        depth = max(self.limit - 1, 0).bit_length()
        node = sha_ops.to_numpy(self.nodes[-1])[0]
        for k in range(len(self.nodes) - 1, depth):
            node = sha_ops.hash_pairs_np(np.concatenate([node, _ZERO[k]])[None, :])[0]
        return node

    def root(self) -> bytes:
        return sha_ops.words_to_bytes(self.root_words())


class _FieldCache:
    """Incremental root for one flat columnar field."""

    __slots__ = ("tree", "mixin_len")

    def __init__(self, leaves, limit_chunks, mixin_len, device):
        self.tree = IncrementalTree(leaves, limit_chunks, device)
        self.mixin_len = mixin_len

    def root(self, length: int) -> bytes:
        r = self.tree.root()
        return sha_ops.mix_in_length(r, length) if self.mixin_len else r


class ValidatorsCache:
    """Incremental registry root: column diff -> per-validator re-root.

    The column snapshots find exactly which rows changed, so only those
    rows re-root (batched), then the element-root tree updates along the
    dirty paths.
    """

    __slots__ = ("snap", "element_roots", "tree")

    def __init__(self, typ, validators, device: torch.device):
        self.snap = {c: getattr(validators, c).copy() for c in reg.Validators._COLUMNS}
        self.element_roots = typ.batch_roots(validators, device).copy()
        self.tree = IncrementalTree(self.element_roots, typ.limit, device)

    def _dirty_rows(self, v) -> np.ndarray:
        m = min(self.snap["effective_balance"].shape[0], len(v))
        changed = np.zeros(m, dtype=bool)
        for c in reg.Validators._COLUMNS:
            d = getattr(v, c)[:m] != self.snap[c][:m]
            changed |= d.any(axis=1) if d.ndim == 2 else d
        return np.nonzero(changed)[0]

    def root(self, typ, validators) -> bytes:
        device = self.tree.device
        n_old = self.snap["effective_balance"].shape[0]
        n_new = len(validators)
        if n_new < n_old:
            self.__init__(typ, validators, device)  # shrink: rebuild (never in spec)
        else:
            dirty = self._dirty_rows(validators)
            rows = np.concatenate([dirty, np.arange(n_old, n_new, dtype=np.int64)])
            if rows.size:
                sub = reg.Validators.from_columns(
                    {c: getattr(validators, c)[rows] for c in reg.Validators._COLUMNS})
                new_roots = typ.batch_roots(sub, device)
                if n_new > n_old:
                    grown = np.zeros((n_new, 8), dtype=np.uint32)
                    grown[:n_old] = self.element_roots
                    self.element_roots = grown
                    for c in reg.Validators._COLUMNS:
                        self.snap[c] = np.concatenate(
                            [self.snap[c], getattr(validators, c)[n_old:n_new].copy()])
                self.element_roots[rows] = new_roots
                for c in reg.Validators._COLUMNS:
                    self.snap[c][dirty] = getattr(validators, c)[dirty]
                self.tree.update(self.element_roots, dirty=rows)
        return sha_ops.mix_in_length(self.tree.root(), n_new)


_FLAT_TYPES = (reg.U64List, reg.U64Vector, reg.U8List, reg.RootsVector, reg.RootsList)
_MIXIN_TYPES = (reg.U64List, reg.U8List, reg.RootsList)


class StateTreeCache:
    """Per-state field-root cache on ``device``: heavy columnar fields
    update incrementally, small fields recompute (they are O(1))."""

    def __init__(self, device: torch.device):
        self.device = device
        self.fields: dict[str, object] = {}

    def field_root(self, fname: str, ftype, value) -> bytes:
        if isinstance(ftype, reg.ValidatorRegistryType):
            c = self.fields.get(fname)
            if c is None:
                c = self.fields[fname] = ValidatorsCache(ftype, value, self.device)
            return c.root(ftype, value)
        if not isinstance(ftype, _FLAT_TYPES):
            return ftype.hash_tree_root(value, self.device)
        leaves = ftype.leaf_words(value)
        c = self.fields.get(fname)
        if c is None:
            c = self.fields[fname] = _FieldCache(
                leaves, ftype.chunk_count(), isinstance(ftype, _MIXIN_TYPES), self.device)
        else:
            c.tree.update(leaves)
        return c.root(ftype._as_array(value).shape[0])

    def state_root(self, state) -> bytes:
        cls = type(state)
        roots = b"".join(self.field_root(fname, ftype, getattr(state, fname))
                         for fname, ftype in cls.fields.items())
        return sha_ops.merkleize(roots, len(cls.fields), device=self.device)


def enable_tree_cache(state, device=None) -> None:
    """Attach an incremental cache on ``device`` (default ``cuda``); copies
    of the state deep-copy it, so child states keep the parent's tree as
    their diff baseline."""
    device = resolve_device(device)
    if getattr(state, "_tree_cache", None) is None:
        state._tree_cache = StateTreeCache(device)


__all__ = ["IncrementalTree", "StateTreeCache", "ValidatorsCache", "enable_tree_cache"]
