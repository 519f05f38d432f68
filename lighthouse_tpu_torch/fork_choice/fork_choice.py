"""Fork choice: the store anchored at a state, the clock, block insertion
with the justified, finalized and unrealized checkpoints, the LMD vote
columns and the head.

Port of ``lighthouse_tpu/fork_choice/fork_choice.py``: ``ForkChoice``
built from an anchor with its balance snapshots (:50-131), ``update_time``
with the epoch tick's pull-up and ``_dequeue`` (:131-154), ``on_block``
with ``_compute_unrealized`` and ``_update_checkpoints`` (:155-262),
``on_attestation`` and ``_apply_attestation`` (:262-304),
``on_attester_slashing`` (:305), and ``get_head`` with its vote deltas and
proposer boost (:316-376).  Votes are numpy columns over validator index
(vote node, vote epoch, the vote the weights hold, its balance,
equivocation), so a batch of attesters is one vectorised scatter.
``prune`` (:411-428) prunes the proto-array at finalization, re-maps the
votes and drops the balance snapshots of pruned roots.  Not ported
(ROADMAP A 15): the proposer re-org head, execution-status updates and
persistence.
"""

from __future__ import annotations

import numpy as np

from typing import Callable

from lighthouse_tpu_torch.fork_choice.proto_array import (
    EXEC_IRRELEVANT,
    NONE,
    CheckpointKey,
    ProtoArray,
)
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.state_transition.epoch_processing import (
    process_justification_and_finalization,
)
from lighthouse_tpu_torch.types import GENESIS_EPOCH


class ForkChoiceError(ValueError):
    pass


def _ckpt(cp) -> CheckpointKey:
    return CheckpointKey(int(cp.epoch), bytes(cp.root))


class QueuedAttestation:
    __slots__ = ("slot", "indices", "root", "target_epoch")

    def __init__(self, slot, indices, root, target_epoch):
        self.slot, self.indices = slot, indices
        self.root, self.target_epoch = root, target_epoch


class ForkChoice:
    """The protocol store over a proto-array, anchored at ``anchor_root``."""

    def __init__(self, spec, anchor_root: bytes, anchor_state,
                 balances_fn: Callable[[bytes], np.ndarray]):
        self.spec = spec
        self.proto = ProtoArray()
        self.time_slot = int(anchor_state.slot)
        anchor_cp = CheckpointKey(spec.compute_epoch_at_slot(int(anchor_state.slot)), anchor_root)
        jc, fc = anchor_state.current_justified_checkpoint, anchor_state.finalized_checkpoint
        self.justified = _ckpt(jc) if int(jc.epoch) else anchor_cp
        self.finalized = _ckpt(fc) if int(fc.epoch) else anchor_cp
        # the anchor must be findable by the justified and finalized roots
        if self.justified.root != anchor_root:
            self.justified = anchor_cp
        if self.finalized.root != anchor_root:
            self.finalized = anchor_cp
        # effective balances of active validators at justified-checkpoint
        # candidates, by block root (the head weighs votes by the justified
        # checkpoint's); balances_fn answers for any other root
        self._balances_fn = balances_fn
        anchor_epoch = spec.compute_epoch_at_slot(int(anchor_state.slot))
        eb = np.asarray(anchor_state.validators.effective_balance, np.int64).copy()
        eb[~anchor_state.validators.is_active(anchor_epoch)] = 0
        self._balance_snapshots: dict[bytes, np.ndarray] = {anchor_root: eb}
        self.justified_balances = self._balances_for(self.justified.root)
        nv = len(anchor_state.validators)
        self._vote_current = np.full(nv, NONE, np.int32)        # what the weights hold
        self._vote_next = np.full(nv, NONE, np.int32)
        self._vote_next_epoch = np.full(nv, -1, np.int64)      # -1: no vote yet
        self._old_balances = np.zeros(nv, np.int64)
        self.equivocating = np.zeros(nv, bool)
        self.proposer_boost_root: bytes | None = None
        self._applied_boost_root: bytes | None = None
        self._applied_boost_amount = 0
        self._queued: list[QueuedAttestation] = []
        # best unrealized checkpoints seen this epoch, pulled into the store
        # at the next epoch tick
        self._best_unrealized_j = self.justified
        self._best_unrealized_f = self.finalized
        self.proto.add_block(anchor_root, None, int(anchor_state.slot), self.justified,
                             self.finalized, execution_status=EXEC_IRRELEVANT)

    def _balances_for(self, root: bytes) -> np.ndarray:
        if root in self._balance_snapshots:
            return self._balance_snapshots[root]
        b = np.asarray(self._balances_fn(root), np.int64)
        self._balance_snapshots[root] = b
        return b

    def _grow_votes(self, n: int):
        pad = n - self._vote_next.shape[0]
        if pad <= 0:
            return
        self._vote_current = np.concatenate([self._vote_current, np.full(pad, NONE, np.int32)])
        self._vote_next = np.concatenate([self._vote_next, np.full(pad, NONE, np.int32)])
        self._vote_next_epoch = np.concatenate([self._vote_next_epoch,
                                                np.full(pad, -1, np.int64)])
        self._old_balances = np.concatenate([self._old_balances, np.zeros(pad, np.int64)])
        self.equivocating = np.concatenate([self.equivocating, np.zeros(pad, bool)])

    def votes(self) -> tuple[np.ndarray, np.ndarray, list]:
        """(vote node, vote target epoch) per validator index, and the
        queued votes as (slot, sorted indices, root, target epoch)."""
        queued = [(q.slot, tuple(np.sort(q.indices).tolist()), q.root, q.target_epoch)
                  for q in self._queued]
        return self._vote_next.copy(), self._vote_next_epoch.copy(), queued

    # -- time ---------------------------------------------------------------

    def update_time(self, current_slot: int) -> None:
        if current_slot > self.time_slot:
            prev_epoch = self.spec.compute_epoch_at_slot(self.time_slot)
            self.time_slot = current_slot
            self.proposer_boost_root = None     # the boost lasts one slot
            if self.spec.compute_epoch_at_slot(current_slot) > prev_epoch:
                self._update_checkpoints(self._best_unrealized_j, self._best_unrealized_f)
            self._dequeue(current_slot)

    def _dequeue(self, current_slot: int):
        still = []
        for q in self._queued:
            if q.slot < current_slot:
                self._apply_attestation(q.indices, q.root, q.target_epoch)
            else:
                still.append(q)
        self._queued = still

    # -- blocks ---------------------------------------------------------------

    def on_block(self, current_slot: int, block, block_root: bytes, state,
                 execution_status: int = EXEC_IRRELEVANT, is_timely: bool = False) -> None:
        """Insert an imported block under ``block_root`` as a child of its
        parent; ``state`` is its post-state, from which the unrealized
        checkpoints are weighed (on the live participation, then restored)."""
        spec = self.spec
        self.update_time(max(current_slot, self.time_slot))
        slot = int(block.slot)
        if block_root in self.proto:
            return
        parent_root = bytes(block.parent_root)
        if parent_root not in self.proto:
            raise ForkChoiceError(f"unknown parent {parent_root.hex()[:16]}")
        if slot > current_slot:
            raise ForkChoiceError("block from the future")
        fin_slot = spec.compute_start_slot_at_epoch(self.finalized.epoch)
        if slot <= fin_slot:
            raise ForkChoiceError("block slot not beyond finalized slot")
        if self.proto.get_ancestor(parent_root, fin_slot) != self.finalized.root:
            raise ForkChoiceError("block does not descend from finalized root")

        justified = _ckpt(state.current_justified_checkpoint)
        finalized = _ckpt(state.finalized_checkpoint)
        unrealized_j, unrealized_f = self._compute_unrealized(state, justified, finalized)
        if spec.compute_epoch_at_slot(slot) < spec.compute_epoch_at_slot(current_slot):
            # blocks of a past epoch take their unrealized checkpoints at once
            node_j, node_f = unrealized_j, unrealized_f
        else:
            node_j, node_f = justified, finalized
        self._update_checkpoints(node_j, node_f)
        if unrealized_j.epoch > self._best_unrealized_j.epoch:
            self._best_unrealized_j = unrealized_j
        if unrealized_f.epoch > self._best_unrealized_f.epoch:
            self._best_unrealized_f = unrealized_f
        # balances only for justified-checkpoint candidates (a block that
        # opens a new epoch on its branch); balances_fn answers the rest
        parent_epoch = spec.compute_epoch_at_slot(
            int(self.proto.slots[self.proto.indices[parent_root]]))
        block_epoch = spec.compute_epoch_at_slot(slot)
        if block_epoch > parent_epoch:
            eb = np.asarray(state.validators.effective_balance, np.int64).copy()
            eb[~state.validators.is_active(block_epoch)] = 0
            self._balance_snapshots[block_root] = eb
        self._grow_votes(len(state.validators))
        if is_timely and slot == current_slot and self.proposer_boost_root is None:
            self.proposer_boost_root = block_root
        self.proto.add_block(block_root, parent_root, slot, node_j, node_f, unrealized_j,
                             unrealized_f, execution_status)

    def _compute_unrealized(self, state, justified, finalized):
        if misc.current_epoch(state, self.spec) <= GENESIS_EPOCH + 1:
            return justified, finalized
        snap = (state.previous_justified_checkpoint, state.current_justified_checkpoint,
                state.finalized_checkpoint, list(state.justification_bits))
        try:
            process_justification_and_finalization(state, self.spec)
            uj = _ckpt(state.current_justified_checkpoint)
            uf = _ckpt(state.finalized_checkpoint)
        finally:
            (state.previous_justified_checkpoint, state.current_justified_checkpoint,
             state.finalized_checkpoint) = snap[:3]
            state.justification_bits = snap[3]
        return uj, uf

    def _update_checkpoints(self, justified: CheckpointKey, finalized: CheckpointKey) -> None:
        if justified.epoch > self.justified.epoch:
            self.justified = justified
            self.justified_balances = self._balances_for(justified.root)
        if finalized.epoch > self.finalized.epoch:
            self.finalized = finalized

    def prune(self) -> None:
        """Prune the proto-array to the finalized block and its descendants,
        re-map both vote columns through its index mapping (a vote for a
        pruned node becomes NONE), and drop the balance snapshots of pruned
        roots (the justified root's stays)."""
        mapping = self.proto.prune(self.finalized.root)
        lut = np.full(max(mapping, default=0) + 1, NONE, np.int32)
        for old, new in mapping.items():
            lut[old] = new
        for name in ("_vote_current", "_vote_next"):
            col = getattr(self, name)
            ok = (col != NONE) & (col < lut.shape[0])
            out = np.full_like(col, NONE)
            out[ok] = lut[col[ok]]
            setattr(self, name, out)
        live = set(self.proto.indices)
        live.add(self.justified.root)
        self._balance_snapshots = {r: b for r, b in self._balance_snapshots.items()
                                   if r in live}

    def on_attester_slashing(self, attesting_indices: np.ndarray) -> None:
        """Zero equivocating validators out of fork choice for good."""
        idx = np.asarray(attesting_indices, np.int64)
        if idx.size == 0:
            return
        self._grow_votes(int(idx.max()) + 1)
        self.equivocating[idx] = True

    # -- attestations ---------------------------------------------------------

    def on_attestation(self, current_slot: int, attesting_indices: np.ndarray,
                       beacon_block_root: bytes, target_epoch: int, att_slot: int,
                       is_from_block: bool = False) -> None:
        """Register LMD votes.  Committee membership and the signature are
        the caller's checks; here: a known head block, a current or
        previous target, and the one-slot delay of gossip votes (queued
        until the next slot)."""
        spec = self.spec
        self.update_time(max(current_slot, self.time_slot))
        current_epoch = spec.compute_epoch_at_slot(current_slot)
        if not is_from_block and target_epoch not in (current_epoch, max(current_epoch - 1, 0)):
            raise ForkChoiceError("attestation target epoch not current/previous")
        if beacon_block_root not in self.proto:
            raise ForkChoiceError("attestation for unknown block")
        i = self.proto.indices[beacon_block_root]
        if int(self.proto.slots[i]) > att_slot:
            raise ForkChoiceError("attestation for block newer than attestation slot")
        idx = np.asarray(attesting_indices, np.int64)
        if not is_from_block and att_slot >= current_slot:
            self._queued.append(QueuedAttestation(att_slot, idx, beacon_block_root, target_epoch))
            return
        self._apply_attestation(idx, beacon_block_root, target_epoch)

    def _apply_attestation(self, idx: np.ndarray, root: bytes, target_epoch: int):
        node = self.proto.indices.get(root)
        if node is None:
            return
        self._grow_votes(int(idx.max()) + 1 if idx.size else 0)
        newer = target_epoch > self._vote_next_epoch[idx]
        sel = idx[newer & ~self.equivocating[idx]]
        self._vote_next[sel] = node
        self._vote_next_epoch[sel] = target_epoch

    # -- the head -------------------------------------------------------------

    def _compute_deltas(self) -> np.ndarray:
        """Each validator's old balance off its current vote's node, its
        justified balance onto its next vote's node, then next becomes
        current; equivocators weigh nothing and vote no more."""
        n_nodes = len(self.proto)
        deltas = np.zeros(n_nodes, np.int64)
        nv = self._vote_current.shape[0]
        new_bal = np.zeros(nv, np.int64)
        jb = self.justified_balances
        m = min(nv, jb.shape[0])
        new_bal[:m] = jb[:m]
        new_bal[self.equivocating] = 0
        self._vote_next[self.equivocating] = NONE
        cur, nxt = self._vote_current, self._vote_next
        has_cur = (cur != NONE) & (cur < n_nodes)
        has_nxt = nxt != NONE
        np.add.at(deltas, cur[has_cur], -self._old_balances[has_cur])
        np.add.at(deltas, nxt[has_nxt], new_bal[has_nxt])
        self._vote_current = np.where(has_nxt, nxt, NONE).astype(np.int32)
        self._old_balances = np.where(has_nxt, new_bal, 0)
        return deltas

    def _proposer_boost_amount(self) -> int:
        committee_weight = int(self.justified_balances.sum()) // self.spec.slots_per_epoch
        return committee_weight * self.spec.proposer_score_boost // 100

    def get_head(self, current_slot: int | None = None) -> bytes:
        """LMD-GHOST from the justified checkpoint: the vote deltas and the
        proposer boost (the last applied boost taken off first) into the
        weights, then the best descendant's root."""
        if current_slot is not None:
            self.update_time(current_slot)
        current_epoch = self.spec.compute_epoch_at_slot(self.time_slot)
        deltas = self._compute_deltas()
        if self._applied_boost_root is not None:
            i = self.proto.indices.get(self._applied_boost_root)
            if i is not None:
                deltas[i] -= self._applied_boost_amount
            self._applied_boost_root = None
            self._applied_boost_amount = 0
        if self.proposer_boost_root is not None:
            i = self.proto.indices.get(self.proposer_boost_root)
            if i is not None:
                amount = self._proposer_boost_amount()
                deltas[i] += amount
                self._applied_boost_root = self.proposer_boost_root
                self._applied_boost_amount = amount
        self.proto.apply_score_changes(deltas, self.justified, self.finalized, current_epoch)
        return self.proto.find_head(self.justified.root)
