"""Typestate block verification: gossip, signatures, execution.

Port of ``lighthouse_tpu/chain/block_verification.py``.  A block moves
through

    SignedBeaconBlock
      -> GossipVerifiedBlock      (slot, parent, proposer index, the
                                   proposer's signature as a 1-set batch)
      -> SignatureVerifiedBlock   (every other signature in one batch)
      -> ExecutionPendingBlock    (state transition, state-root check)

and each stage holds what the next needs, so no block reaches import
without passing every stage.  Both batches run on the chain's BLS backend
and device (``BeaconChain.verify_sets``: the card's batch verifier by
default), the committee shuffles come from the chain's shuffle cache, and
the post-state root from the state's tree cache when one is attached.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.state_transition import signature_sets as sigs
from lighthouse_tpu_torch.state_transition.block_processing import (
    SignatureStrategy,
    process_block,
)
from lighthouse_tpu_torch.state_transition.slot_processing import state_advance


class BlockError(ValueError):
    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


@dataclass
class GossipVerifiedBlock:
    signed_block: object
    block_root: bytes
    parent_state: object  # the parent's post-state advanced to the block's slot


@dataclass
class SignatureVerifiedBlock:
    signed_block: object
    block_root: bytes
    parent_state: object


@dataclass
class ExecutionPendingBlock:
    signed_block: object
    block_root: bytes
    post_state: object
    state_root: bytes
    timings: dict = field(default_factory=dict)


def verify_block_for_gossip(chain, signed_block, source: str = "gossip") -> GossipVerifiedBlock:
    """The gossip checks and the proposer's signature.  ``source="rpc"``
    skips the gossip-only repeat-proposal checks."""
    spec = chain.spec
    block = signed_block.message
    slot = int(block.slot)
    if slot > chain.current_slot():
        raise BlockError("future_slot")
    if slot <= spec.compute_start_slot_at_epoch(chain.fork_choice.finalized.epoch):
        raise BlockError("finalized_slot")
    block_root = block.hash_tree_root(chain.device)
    if chain.block_exists(block_root):
        raise BlockError("duplicate")
    proposer = int(block.proposer_index)
    # read-only probe: the slot is marked only after the proposer's
    # signature verifies, so unauthenticated blocks cannot block the real one
    if source == "gossip" and chain.observed_block_producers.is_seen(slot, proposer):
        raise BlockError("repeat_proposal")
    parent_root = bytes(block.parent_root)
    if parent_root not in chain.fork_choice.proto:
        raise BlockError("unknown_parent")
    parent_state = chain.state_for_block(parent_root)
    if parent_state is None:
        raise BlockError("parent_state_unavailable")
    if int(parent_state.slot) < slot:
        parent_state = parent_state.copy()
        state_advance(parent_state, spec, slot, chain.device)
    if proposer != misc.get_beacon_proposer_index(parent_state, spec, slot):
        raise BlockError("incorrect_proposer")
    if chain.verify_signatures:
        sset = sigs.block_proposal_set(parent_state, spec, signed_block, block_root)
        if not chain.verify_sets([sset]):
            raise BlockError("proposer_signature_invalid")
    if chain.observed_block_producers.observe(slot, proposer) and source == "gossip":
        raise BlockError("repeat_proposal")
    return GossipVerifiedBlock(signed_block, block_root, parent_state)


def verify_block_signatures(chain, gossip_block: GossipVerifiedBlock) -> SignatureVerifiedBlock:
    """Every signature of the block but the proposal (checked at the gossip
    stage) in one batch."""
    if chain.verify_signatures:
        try:
            sets = sigs.include_all_signatures(
                gossip_block.parent_state, chain.spec, gossip_block.signed_block,
                gossip_block.block_root, include_proposal=False,
                shuffle_fn=chain.committee_shuffle, device=chain.device)
        except ValueError as e:
            raise BlockError(f"invalid_signature_structure: {e}") from e
        if sets and not chain.verify_sets(sets):
            raise BlockError("batch_signature_invalid")
    return SignatureVerifiedBlock(gossip_block.signed_block, gossip_block.block_root,
                                  gossip_block.parent_state)


def execute_block(chain, sig_block: SignatureVerifiedBlock) -> ExecutionPendingBlock:
    """Copy the parent state, advance it, run the block with no signature
    checks (they passed), then check the claimed state root.  ``timings``
    holds the seconds of ``copy``, ``advance``, ``transition`` and
    ``state_root``."""
    spec = chain.spec
    block = sig_block.signed_block.message
    t0 = time.perf_counter()
    state = sig_block.parent_state.copy()
    t1 = time.perf_counter()
    if int(state.slot) < int(block.slot):
        state_advance(state, spec, int(block.slot), chain.device)
    t2 = time.perf_counter()
    process_block(state, spec, sig_block.signed_block, SignatureStrategy.NO_VERIFICATION,
                  shuffle_fn=chain.committee_shuffle, device=chain.device)
    t3 = time.perf_counter()
    state_root = state.hash_tree_root(chain.device)
    if state_root != bytes(block.state_root):
        raise BlockError("state_root_mismatch")
    t4 = time.perf_counter()
    return ExecutionPendingBlock(
        sig_block.signed_block, sig_block.block_root, state, state_root,
        timings={"copy": t1 - t0, "advance": t2 - t1, "transition": t3 - t2,
                 "state_root": t4 - t3})
