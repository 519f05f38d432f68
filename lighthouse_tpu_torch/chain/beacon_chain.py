"""BeaconChain: the gossip attestation surface of a beacon node.

Port of the attestation part of ``lighthouse_tpu/chain/beacon_chain.py``
(:45-212, :749-955): an anchor state and its block root, the slot clock,
fork choice's attestation side, the committee shuffle cache, the observed
attesters, the naive aggregation pool and the validator monitor, and the
batch pipeline of ``verify_attestations_for_gossip`` (prepare under the
import lock, BLS outside it, commit under it again).  Block import, the
store and the slasher come with block verification: ``slasher`` is None.

The BLS backend is named per chain (``bls_backend``, ``cuda`` by default:
the batch verifier on the card; ``reference`` is the host check), and
``device`` (``cuda`` unless ``"cpu"`` is given) is where the shuffle, the
state root and the ``cuda`` backend run.
"""

from __future__ import annotations

import threading

import numpy as np

from lighthouse_tpu_torch.chain import attestation_verification as att_verify
from lighthouse_tpu_torch.chain.caches import EpochIndexedSeen, ShufflingCache
from lighthouse_tpu_torch.chain.validator_monitor import ValidatorMonitor
from lighthouse_tpu_torch.common.slot_clock import ManualSlotClock
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.fork_choice import ForkChoice, ForkChoiceError
from lighthouse_tpu_torch.pool.naive_aggregation import NaiveAggregationPool
from lighthouse_tpu_torch.state_transition import misc
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
    def __init__(self, spec, anchor_state, *, bls_backend: str = "cuda", device=None,
                 verify_signatures: bool = True):
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
        self.head_root = self.anchor_root
        self.head_state = anchor_state
        self.fork_choice = ForkChoice(spec, self.anchor_root, anchor_state)
        self.shuffling_cache = ShufflingCache()
        self.observed_attesters = EpochIndexedSeen()
        self.naive_pool = NaiveAggregationPool()
        self.validator_monitor = ValidatorMonitor()
        self.slasher = None
        self._advanced_states: dict[bytes, object] = {}

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
        """Post-state of ``block_root``; the anchor is the only block yet."""
        return self.head_state if block_root == self.anchor_root else None

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
