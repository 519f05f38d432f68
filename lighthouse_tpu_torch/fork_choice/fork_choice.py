"""Fork choice's attestation side: the store anchored at a state, the
clock, and the LMD vote columns.

Port of the part of ``lighthouse_tpu/fork_choice/fork_choice.py`` that the
gossip attestation path runs: ``ForkChoice`` built from an anchor (:50-131),
``update_time`` and ``_dequeue`` (:144-154), ``on_attestation`` and
``_apply_attestation`` (:262-304).  Votes are three numpy columns over
validator index (vote node, vote epoch, equivocation), so a batch of
attesters is one vectorised scatter.  ``on_block``, ``get_head`` and the
justified and finalized checkpoints come with block import.
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.fork_choice.proto_array import NONE, ProtoArray


class ForkChoiceError(ValueError):
    pass


class QueuedAttestation:
    __slots__ = ("slot", "indices", "root", "target_epoch")

    def __init__(self, slot, indices, root, target_epoch):
        self.slot, self.indices = slot, indices
        self.root, self.target_epoch = root, target_epoch


class ForkChoice:
    """The protocol store over a proto-array, anchored at ``anchor_root``."""

    def __init__(self, spec, anchor_root: bytes, anchor_state):
        self.spec = spec
        self.proto = ProtoArray()
        self.time_slot = int(anchor_state.slot)
        nv = len(anchor_state.validators)
        self._vote_next = np.full(nv, NONE, np.int32)
        self._vote_next_epoch = np.full(nv, -1, np.int64)      # -1: no vote yet
        self.equivocating = np.zeros(nv, bool)
        self._queued: list[QueuedAttestation] = []
        self.proto.add_block(anchor_root, None, int(anchor_state.slot))

    def _grow_votes(self, n: int):
        pad = n - self._vote_next.shape[0]
        if pad <= 0:
            return
        self._vote_next = np.concatenate([self._vote_next, np.full(pad, NONE, np.int32)])
        self._vote_next_epoch = np.concatenate([self._vote_next_epoch,
                                                np.full(pad, -1, np.int64)])
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
            self.time_slot = current_slot
            self._dequeue(current_slot)

    def _dequeue(self, current_slot: int):
        still = []
        for q in self._queued:
            if q.slot < current_slot:
                self._apply_attestation(q.indices, q.root, q.target_epoch)
            else:
                still.append(q)
        self._queued = still

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
