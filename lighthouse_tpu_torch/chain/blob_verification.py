"""Blob sidecar verification (Deneb): the gossip checks of one sidecar and
the KZG proof check of a block's blobs.

Port of ``lighthouse_tpu/chain/blob_verification.py``: structural and
timing checks per sidecar, the commitment's inclusion proof against the
block header's body root (``misc.is_valid_merkle_branch``), the expected
proposer, the proposer's header signature (one set on the chain's BLS
backend, ``cuda`` by default), then the KZG proofs
(``crypto/kzg.verify_blob_kzg_proof_batch`` on the chain's device).  The
checks run in the JAX package's order and raise its reasons.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.state_transition.slot_processing import state_advance

# a Deneb BeaconBlockBody has 12 fields, padded to 16 leaves (depth 4);
# blob_kzg_commitments is field 11
_BODY_FIELDS = 16
_BODY_DEPTH = 4
_COMMITMENTS_FIELD_INDEX = 11


class BlobError(ValueError):
    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


def _inclusion_depth(spec) -> int:
    list_depth = max(spec.preset.max_blob_commitments_per_block - 1, 1).bit_length()
    return _BODY_DEPTH + 1 + list_depth


def _zero_hashes(depth: int) -> list[bytes]:
    zero = [b"\x00" * 32]
    for _ in range(depth):
        zero.append(hashlib.sha256(zero[-1] * 2).digest())
    return zero


def _commitment_leaf(commitment: bytes) -> bytes:
    """hash_tree_root of a Bytes48: its two chunks, the second zero-padded."""
    return hashlib.sha256(commitment + b"\x00" * 16).digest()


def _list_subtree_nodes(commitments: list[bytes], depth: int) -> list[list[bytes]]:
    """The levels of the commitments' chunk tree, leaves first, each level
    only as wide as its nonzero part (at least one pair); the last level
    is the chunks' root."""
    zero = _zero_hashes(depth)
    level = [_commitment_leaf(c) for c in commitments]
    levels = []
    for d in range(depth):
        levels.append(level)
        nxt = []
        for i in range(0, max(len(level), 2), 2):
            left = level[i] if i < len(level) else zero[d]
            right = level[i + 1] if i + 1 < len(level) else zero[d]
            nxt.append(hashlib.sha256(left + right).digest())
        level = nxt
    levels.append(level)
    return levels


def compute_kzg_inclusion_proof(body, index: int, spec, device=None) -> list[bytes]:
    """The branch proving ``body.blob_kzg_commitments[index]`` under the
    body root: the commitments' chunk tree, the list's length mix-in, then
    field 11's siblings among the body's 16 field roots (depth 4 + 1 +
    log2(max commitments), 17 in both presets)."""
    commitments = [bytes(c) for c in body.blob_kzg_commitments]
    list_depth = _inclusion_depth(spec) - _BODY_DEPTH - 1
    levels = _list_subtree_nodes(commitments, list_depth)
    zero = _zero_hashes(list_depth)
    branch = []
    idx = index
    for d in range(list_depth):
        sib = idx ^ 1
        branch.append(levels[d][sib] if sib < len(levels[d]) else zero[d])
        idx >>= 1
    branch.append(len(commitments).to_bytes(32, "little"))
    nodes = [ftype.hash_tree_root(getattr(body, name), device)
             for name, ftype in type(body).fields.items()]
    nodes += [b"\x00" * 32] * (_BODY_FIELDS - len(nodes))
    idx = _COMMITMENTS_FIELD_INDEX
    for _ in range(_BODY_DEPTH):
        branch.append(nodes[idx ^ 1])
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
        idx >>= 1
    return branch


def verify_kzg_inclusion_proof(sidecar, spec) -> bool:
    depth = _inclusion_depth(spec)
    list_depth = depth - _BODY_DEPTH - 1
    index = int(sidecar.index) | (_COMMITMENTS_FIELD_INDEX << (list_depth + 1))
    return misc.is_valid_merkle_branch(
        _commitment_leaf(bytes(sidecar.kzg_commitment)),
        [bytes(b) for b in sidecar.kzg_commitment_inclusion_proof], depth, index,
        bytes(sidecar.signed_block_header.message.body_root))


@dataclass
class VerifiedBlob:
    sidecar: object
    block_root: bytes


def verify_blob_sidecar_for_gossip(chain, sidecar, timings: dict) -> VerifiedBlob:
    """The gossip checks of one sidecar, in the JAX package's order.  Its
    KZG proof is checked by the caller (``validate_blobs``), and the
    caller marks the sidecar seen only after that passes: the blob's bytes
    are not covered by the header signature, so a mark here would let a
    corrupted copy block the honest one.  ``timings`` gets the seconds of
    the ``proposer`` check and the header ``signature``."""
    spec = chain.spec
    header = sidecar.signed_block_header.message
    slot = int(header.slot)
    epoch = spec.compute_epoch_at_slot(slot)
    if int(sidecar.index) >= spec.preset.max_blobs_per_block:
        raise BlobError("invalid_subnet_index")
    if slot > chain.current_slot():
        raise BlobError("future_slot")
    if epoch < chain.fork_choice.finalized.epoch:
        raise BlobError("past_finalized_slot")
    parent_root = bytes(header.parent_root)
    if parent_root not in chain.fork_choice.proto:
        raise BlobError("unknown_parent")
    block_root = header.hash_tree_root(chain.device)
    if chain.observed_blob_sidecars.is_seen(epoch, sidecar_digest(block_root, sidecar)):
        raise BlobError("repeat_blob")
    if not verify_kzg_inclusion_proof(sidecar, spec):
        raise BlobError("invalid_inclusion_proof")
    t0 = time.perf_counter()
    if not check_expected_proposer(chain, header):
        raise BlobError("invalid_proposer")
    t1 = time.perf_counter()
    timings["proposer"] = t1 - t0
    timings["signature"] = 0.0
    if chain.verify_signatures:
        state = chain.state_for_block(parent_root)
        if state is None:
            raise BlobError("parent_state_unavailable")
        proposer = int(header.proposer_index)
        if proposer >= len(state.validators):
            raise BlobError("unknown_proposer")
        domain = misc.get_domain(state, spec, spec.domain_beacon_proposer, epoch)
        sset = bls.SignatureSet(
            bls.Signature(bytes(sidecar.signed_block_header.signature)),
            [bls.PublicKey.interned(state.validators.pubkeys[proposer].tobytes())],
            misc.compute_signing_root(block_root, domain))
        if not chain.verify_sets([sset]):
            raise BlobError("invalid_proposer_signature")
        timings["signature"] = time.perf_counter() - t1
    return VerifiedBlob(sidecar, block_root)


def sidecar_digest(block_root: bytes, sidecar) -> bytes:
    """What the duplicate cache keys a sidecar by."""
    return block_root + int(sidecar.index).to_bytes(8, "little")


def check_expected_proposer(chain, header) -> bool:
    """``header.proposer_index`` must be the slot's proposer, or any
    validator's key could flood the availability checker with self-signed
    sidecars under made-up block roots.  The parent's post-state is copied
    and advanced to the slot, once a sidecar, as in the JAX package."""
    state = chain.state_for_block(bytes(header.parent_root))
    if state is None:
        return False
    slot = int(header.slot)
    if int(state.slot) < slot:
        state = state.copy()
        state_advance(state, chain.spec, slot, chain.device)
    return int(header.proposer_index) == misc.get_beacon_proposer_index(state, chain.spec)


def validate_blobs(settings: kzg.KzgSettings, commitments, blobs, proofs, device=None) -> bool:
    """The KZG proofs of a block's blobs in one batch."""
    if not blobs:
        return True
    return kzg.verify_blob_kzg_proof_batch(
        [bytes(b) for b in blobs], [bytes(c) for c in commitments],
        [bytes(p) for p in proofs], settings, device)
