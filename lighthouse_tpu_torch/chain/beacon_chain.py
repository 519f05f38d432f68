"""BeaconChain: the gossip attestation surface and block import of a
beacon node.

Port of the attestation part of ``lighthouse_tpu/chain/beacon_chain.py``
(:45-212, :749-955): an anchor state and its block root, the slot clock,
fork choice, the committee shuffle cache, the observed attesters, the
naive aggregation pool and the validator monitor, and the batch pipeline
of ``verify_attestations_for_gossip`` (prepare under the import lock, BLS
outside it, commit under it again).  And of block import (:212-348,
:396-470): ``process_block`` runs the gossip stage, the signature batch
(outside the lock), execution, the Deneb data-availability gate
(``chain/data_availability.py``: a block with blob commitments waits for
its sidecars, which ``process_gossip_blob`` verifies through
``chain/blob_verification.py``) and ``import_block`` (fork choice's
``on_block``, the block's attestations as votes, its attester slashings,
the post-state and blob data kept by block root, the head recomputed).
Not ported (ROADMAP A 15): the store (post-states and blob data live in a
bounded in-memory map), the light client, events, the slasher
(``slasher`` is None), the validator monitor's block hooks, and the
execution layer: its check is skipped, as the JAX chain skips it when
``execution_layer`` is None.

The BLS backend is named per chain (``bls_backend``, ``cuda`` by default:
the batch verifier on the card; ``reference`` is the host check), and
``device`` (``cuda`` unless ``"cpu"`` is given) is where the shuffle, the
state root and the ``cuda`` backend run.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from lighthouse_tpu_torch.chain import attestation_verification as att_verify
from lighthouse_tpu_torch.chain import blob_verification as blobv
from lighthouse_tpu_torch.chain import block_verification as bv
from lighthouse_tpu_torch.chain.caches import (
    EpochIndexedSeen,
    ObservedDigests,
    ShufflingCache,
    SlotIndexedSeen,
)
from lighthouse_tpu_torch.chain.data_availability import DataAvailabilityChecker
from lighthouse_tpu_torch.chain.validator_monitor import ValidatorMonitor
from lighthouse_tpu_torch.common.slot_clock import ManualSlotClock
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.fork_choice import ForkChoice, ForkChoiceError
from lighthouse_tpu_torch.pool.naive_aggregation import NaiveAggregationPool
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.state_transition.block_processing import get_attesting_indices
from lighthouse_tpu_torch.state_transition.slot_processing import state_advance
from lighthouse_tpu_torch.types import BeaconBlockHeader, make_types


def anchor_block_root(state, device=None) -> bytes:
    """The block root an anchor state answers to (``store/hot_cold.py:72``):
    the latest block header, with the state root patched in when the state
    was taken at the block's own slot."""
    header = state.latest_block_header
    if bytes(header.state_root) == b"\x00" * 32:
        header = BeaconBlockHeader(slot=header.slot, proposer_index=header.proposer_index,
                                   parent_root=header.parent_root,
                                   state_root=state.hash_tree_root(device),
                                   body_root=header.body_root)
    return header.hash_tree_root("cpu")


class BeaconChain:
    POST_STATES = 16            # imported blocks' post-states kept in memory

    def __init__(self, spec, anchor_state, *, bls_backend: str = "cuda", device=None,
                 verify_signatures: bool = True, kzg_settings=None):
        self.spec = spec
        self.t = make_types(spec.preset)
        self.device = resolve_device(device)
        self.bls_backend = bls_backend
        self.verify_signatures = verify_signatures
        # chain mutation is single-writer: gossip batches prepare and commit
        # under this lock and run their BLS work outside it
        self._import_lock = threading.RLock()
        self.slot_clock = ManualSlotClock(int(anchor_state.genesis_time), spec.seconds_per_slot)
        self.anchor_root = anchor_block_root(anchor_state, self.device)
        self.anchor_state = anchor_state
        self.head_root = self.anchor_root
        self.head_state = anchor_state
        self.fork_choice = ForkChoice(spec, self.anchor_root, anchor_state,
                                      balances_fn=self._balances_for_checkpoint)
        self.shuffling_cache = ShufflingCache()
        self.observed_attesters = EpochIndexedSeen()
        self.observed_block_producers = SlotIndexedSeen()
        # post-states of imported blocks by block root, most recent last
        self._post_states: OrderedDict[bytes, object] = OrderedDict()
        self.block_times: dict[bytes, dict] = {}
        self.naive_pool = NaiveAggregationPool()
        self.validator_monitor = ValidatorMonitor()
        self.slasher = None
        self._advanced_states: dict[bytes, object] = {}
        # blobs: the KZG setup, accepted sidecars, blocks waiting for theirs
        # and the blob data of the imported blocks whose post-states are kept
        self.kzg_settings = kzg_settings
        self.observed_blob_sidecars = ObservedDigests()
        self.da_checker = DataAvailabilityChecker(spec)
        self._pending_executed: dict[bytes, bv.ExecutionPendingBlock] = {}
        self._blobs: dict[bytes, bytes] = {}
        self.blob_times: dict[tuple[bytes, int], dict] = {}
        self._pruned_finalized_epoch = self.fork_choice.finalized.epoch

    # -- plumbing -----------------------------------------------------------

    def current_slot(self) -> int:
        return self.slot_clock.current_slot()

    def verify_sets(self, sets) -> bool:
        """One batch verify on this chain's backend and device."""
        return bls.verify_signature_sets(sets, backend=self.bls_backend, device=self.device)

    def committee_shuffle(self, state, epoch: int) -> np.ndarray:
        """The epoch's shuffled active set, computed once per (epoch, seed,
        active count) and cached: the seed pins the randao mix, so equal
        keys give equal shuffles across branches."""
        seed = misc.get_seed(state, self.spec, epoch, self.spec.domain_beacon_attester)
        # the active count of (epoch, registry length, slot) is stable: the
        # O(n) scan runs once per state, not once per attestation
        memo = state.__dict__.setdefault("_active_count_memo", {})
        mkey = (epoch, len(state.validators), int(state.slot))
        n_active = memo.get(mkey)
        if n_active is None:
            n_active = int(state.validators.is_active(epoch).sum())
            if len(memo) > 8:
                memo.clear()
            memo[mkey] = n_active
        key = seed + n_active.to_bytes(8, "little")
        shuffle = self.shuffling_cache.get(epoch, key)
        if shuffle is None:
            shuffle = misc.compute_committee_shuffle(state, self.spec, epoch, device=self.device)
            self.shuffling_cache.insert(epoch, key, shuffle)
        return shuffle

    def state_for_block(self, block_root: bytes):
        """Post-state of ``block_root``: the anchor's, or an imported block's
        while it is among the ``POST_STATES`` most recent."""
        if block_root == self.anchor_root:
            return self.anchor_state
        return self._post_states.get(block_root)

    def _balances_for_checkpoint(self, block_root: bytes) -> np.ndarray:
        """Fork choice's balances at a checkpoint: the effective balances of
        the block's post-state (the head's if it is gone), zero for the
        inactive."""
        st = self.state_for_block(block_root)
        if st is None:
            st = self.head_state
        eb = np.asarray(st.validators.effective_balance, np.int64).copy()
        eb[~st.validators.is_active(self.spec.compute_epoch_at_slot(int(st.slot)))] = 0
        return eb

    def recompute_head(self) -> bytes:
        """Fork choice's head; the chain's head follows it when its
        post-state is kept."""
        head = self.fork_choice.get_head(self.current_slot())
        if head != self.head_root:
            st = self.state_for_block(head)
            if st is not None:
                self.head_root, self.head_state = head, st
        return self.head_root

    def block_exists(self, block_root: bytes) -> bool:
        return block_root == self.anchor_root or block_root in self._post_states

    def _attestation_state(self, item):
        """The state to check an attestation against: its head block's
        post-state, advanced to the target epoch when older (committees come
        from the target epoch's shuffle)."""
        data = item.data
        root = bytes(data.beacon_block_root)
        st = self.state_for_block(root)
        if st is None:
            st = self.head_state
        target_epoch = int(data.target.epoch)
        spec = self.spec
        if spec.compute_epoch_at_slot(int(st.slot)) < target_epoch:
            key = root + target_epoch.to_bytes(8, "little")
            cached = self._advanced_states.get(key)
            if cached is None:
                cached = st.copy()
                state_advance(cached, spec, spec.compute_start_slot_at_epoch(target_epoch),
                              self.device)
                if len(self._advanced_states) > 8:
                    self._advanced_states.clear()
                self._advanced_states[key] = cached
            st = cached
        return st

    # -- the gossip batch pipeline --------------------------------------------

    def verify_attestations_for_gossip(self, attestations: list):
        """Batch-verify unaggregated gossip attestations -> (verified,
        [(item, reason)]); the verified ones are already in fork choice,
        the naive pool and the validator monitor."""

        def insert(v):
            self.naive_pool.insert(v.attestation)
            self.validator_monitor.on_gossip_attestation(v.indexed_indices, v.attestation.data,
                                                         self.spec)

        return self._batch_pipeline(attestations, att_verify.verify_unaggregated_for_gossip,
                                    on_verified=insert)

    def _batch_pipeline(self, items, verify_fn, on_verified=None):
        candidates, rejects = self._prepare_batch(items, verify_fn)
        if self.verify_signatures:
            att_verify.batch_verify(self, candidates)       # outside the lock
        else:
            for c in candidates:
                c.ok = True
        with self._import_lock:
            verified = self._commit_batch(candidates, rejects)
            if on_verified is not None:
                for v in verified:
                    on_verified(v)
        return verified, rejects

    def _prepare_batch(self, items, verify_fn):
        """Gossip checks and signature sets, under the import lock."""
        candidates, rejects = [], []
        with self._import_lock:
            for item in items:
                state = self._attestation_state(item)
                try:
                    candidates.append(verify_fn(self, item, state))
                except att_verify.AttestationError as e:
                    rejects.append((item, e.reason))
        return candidates, rejects

    def _commit_batch(self, candidates, rejects):
        """Claim the dup marks and apply the survivors to fork choice; the
        caller holds the import lock, so batches whose BLS ran concurrently
        still reject cross-batch duplicates."""
        verified = []
        for c in candidates:
            if not c.ok:
                rejects.append((c.item, "invalid_signature"))
                continue
            if not att_verify.commit_observations(self, c):
                rejects.append((c.item, "duplicate_in_batch"))
                continue
            verified.append(c)
            data = c.attestation.data
            self.apply_votes(c.indexed_indices, bytes(data.beacon_block_root),
                             int(data.target.epoch), int(data.slot))
        return verified

    def apply_votes(self, indices, head_root: bytes, target_epoch: int, slot: int) -> None:
        """Verified attesters' votes into fork choice.  A vote fork choice
        refuses (a block newer than the attestation, a stale target) leaves
        the attestation verified, as in the JAX package; nothing else is
        caught."""
        try:
            self.fork_choice.on_attestation(self.current_slot(), indices, head_root,
                                            target_epoch, slot)
        except ForkChoiceError:
            pass

    # -- block import -------------------------------------------------------

    def process_block(self, signed_block, blobs_ssz: bytes | None = None,
                      source: str = "gossip") -> bytes | None:
        """Gossip checks, the signature batch, execution, the availability
        gate and import; returns the block root, or None when the block
        carries blob commitments whose sidecars have not all arrived: it
        waits in ``da_checker`` and imports when the last one does
        (``process_gossip_blob``).  A caller that already holds the block's
        blob data (``blobs_ssz``, its sidecars' SSZ end to end, as sync
        fetches it) imports at once.  The import lock is held for the
        gossip stage and for execute-and-import; the signature batch runs
        between the two holds.  ``block_times[root]`` gets the seconds of
        ``gossip``, ``signatures``, ``copy``, ``advance``, ``transition``,
        ``state_root``, ``import`` (of which ``head``, fork choice's head
        recomputed) and ``total`` of a block this call imports."""
        t0 = time.perf_counter()
        with self._import_lock:
            gossip = bv.verify_block_for_gossip(self, signed_block, source)
        t1 = time.perf_counter()
        sigv = bv.verify_block_signatures(self, gossip)
        t2 = time.perf_counter()
        with self._import_lock:
            if self.block_exists(sigv.block_root):
                raise bv.BlockError("duplicate")
            pending = bv.execute_block(self, sigv)
            t3 = time.perf_counter()
            root = self._gate_and_import(pending, blobs_ssz)
        t4 = time.perf_counter()
        if root is not None:
            self.block_times[root] = dict(gossip=t1 - t0, signatures=t2 - t1, **pending.timings,
                                          **{"import": t4 - t3, "total": t4 - t0})
        return root

    def _gate_and_import(self, pending: bv.ExecutionPendingBlock, blobs_ssz):
        """The data-availability gate, under the import lock: a block with
        blob commitments and no blob data waits for its sidecars (its
        executed state kept in ``_pending_executed``, in step with the
        checker's capacity); any other imports now."""
        root = pending.block_root
        if len(pending.signed_block.message.body.blob_kzg_commitments) and blobs_ssz is None:
            self._pending_executed[root] = pending
            while len(self._pending_executed) > self.da_checker.capacity:
                del self._pending_executed[next(iter(self._pending_executed))]
            availability = self.da_checker.put_pending_executed_block(root,
                                                                      pending.signed_block)
            return self._import_available(availability) if availability.is_available else None
        # a copy of this block parked for its sidecars goes, or late
        # sidecars would complete it and import the root again
        self._pending_executed.pop(root, None)
        return self.import_block(pending, blobs_ssz)

    def process_gossip_blob(self, sidecar) -> bytes | None:
        """Verify one gossip blob sidecar; import its block if that
        completes the block's availability (returns its root) and None
        otherwise.  The gossip checks and the header signature hold the
        import lock, the KZG proof check runs outside it, and the duplicate
        mark and the checker's commit take the lock again: the mark lands
        only after the whole check passed, so a corrupted copy cannot
        block the honest sidecar, and only the first of two concurrent
        copies commits.  ``blob_times[(root, index)]`` (the newest
        sidecars') gets the seconds of ``gossip``, ``proposer``,
        ``signature``, ``kzg``, ``commit`` (the import included when this
        sidecar completes the block) and ``total``."""
        t0 = time.perf_counter()
        timings: dict = {}
        with self._import_lock:
            verified = blobv.verify_blob_sidecar_for_gossip(self, sidecar, timings)
        t1 = time.perf_counter()
        if not blobv.validate_blobs(self.kzg_settings, [sidecar.kzg_commitment], [sidecar.blob],
                                    [sidecar.kzg_proof], self.device):
            raise blobv.BlobError("invalid_kzg_proof")
        t2 = time.perf_counter()
        root = None
        with self._import_lock:
            epoch = self.spec.compute_epoch_at_slot(int(sidecar.signed_block_header.message.slot))
            if self.observed_blob_sidecars.observe(
                    epoch, blobv.sidecar_digest(verified.block_root, sidecar)):
                # a concurrent copy won the commit while this one's KZG
                # check ran: only the first mark may feed the checker
                return None
            availability = self.da_checker.put_verified_blobs(verified.block_root, [verified])
            if availability.is_available:
                root = self._import_available(availability)
        t3 = time.perf_counter()
        self.blob_times[(verified.block_root, int(sidecar.index))] = dict(
            gossip=t1 - t0 - timings["proposer"] - timings["signature"], **timings,
            kzg=t2 - t1, commit=t3 - t2, total=t3 - t0)
        while len(self.blob_times) > self.POST_STATES * self.spec.preset.max_blobs_per_block:
            del self.blob_times[next(iter(self.blob_times))]
        return root

    def _import_available(self, availability) -> bytes | None:
        pending = self._pending_executed.pop(availability.block_root, None)
        if pending is None:
            return None             # the block came by another path already
        blobs_ssz = b"".join(s.serialize() for s in (availability.blobs or []))
        return self.import_block(pending, blobs_ssz or None)

    def get_blobs(self, block_root: bytes) -> bytes | None:
        """The blob sidecars of an imported block, SSZ end to end in index
        order, while its post-state is among the ``POST_STATES`` most
        recent (the JAX chain's ``store.get_blobs``)."""
        return self._blobs.get(block_root)

    def import_block(self, pending: bv.ExecutionPendingBlock,
                     blobs_ssz: bytes | None = None) -> bytes:
        """Fork choice's ``on_block``, the block's attestations as votes
        and its attester slashings, then the post-state (and the blob
        data, if any) under the root, the head recomputed; a finalized
        checkpoint that moved prunes the availability checker."""
        block = pending.signed_block.message
        root = pending.block_root
        state = pending.post_state
        current_slot = max(self.current_slot(), int(block.slot))
        is_timely = (int(block.slot) == self.slot_clock.current_slot()
                     and self.slot_clock.is_timely_for_boost())
        self.fork_choice.on_block(current_slot, block, root, state, is_timely=is_timely)
        for att in block.body.attestations:
            # an attestation fork choice refuses stays in the imported
            # block, as in the JAX chain
            try:
                shuffle = self.committee_shuffle(state, int(att.data.target.epoch))
                indices = get_attesting_indices(state, self.spec, att, shuffle)
                self.fork_choice.on_attestation(
                    current_slot, indices, bytes(att.data.beacon_block_root),
                    int(att.data.target.epoch), int(att.data.slot), is_from_block=True)
            except (ForkChoiceError, ValueError):
                continue
        for slashing in block.body.attester_slashings:
            both = np.intersect1d(np.asarray(slashing.attestation_1.attesting_indices, np.int64),
                                  np.asarray(slashing.attestation_2.attesting_indices, np.int64))
            if both.size:
                self.fork_choice.on_attester_slashing(both)
        self._post_states[root] = state
        if blobs_ssz is not None:
            self._blobs[root] = blobs_ssz
        while len(self._post_states) > self.POST_STATES:
            old, _ = self._post_states.popitem(last=False)
            self._blobs.pop(old, None)
        t0 = time.perf_counter()
        self.recompute_head()
        pending.timings["head"] = time.perf_counter() - t0
        self._on_finalized()
        return root

    def _on_finalized(self) -> None:
        """Once fork choice's finalized checkpoint moves: fork choice prunes
        its proto-array, votes and balance snapshots to the finalized block,
        and blocks waiting for sidecars below the finalized slot go, from
        the checker and from ``_pending_executed`` (the JAX chain's
        ``_on_finalized``)."""
        epoch = self.fork_choice.finalized.epoch
        if epoch <= self._pruned_finalized_epoch:
            return
        self._pruned_finalized_epoch = epoch
        fin_slot = self.spec.compute_start_slot_at_epoch(epoch)
        self.fork_choice.prune()
        self.da_checker.prune_finalized(fin_slot)
        self._pending_executed = {r: p for r, p in self._pending_executed.items()
                                  if int(p.signed_block.message.slot) >= fin_slot}
