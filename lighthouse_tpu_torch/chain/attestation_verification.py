"""Gossip verification of unaggregated attestations: the scalar lane.

Port of ``lighthouse_tpu/chain/attestation_verification.py:59-241`` for
single-bit attestations (aggregates come with block verification): gossip
checks per item, then ONE batched ``verify_signature_sets`` over the
pre-BLS coalesced sets, with recursive bisection over the original sets
attributing a failed batch.  Dup caches are only read before signature
verification and written after it succeeds, so unauthenticated garbage
cannot suppress an honest validator's later message.  The columnar lane
(``chain/columnar_ingest.py``) hands this lane the rows it does not take.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.pool.pre_aggregation import coalesce_sets
from lighthouse_tpu_torch.state_transition import misc


class AttestationError(ValueError):
    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


@dataclass
class VerifiedAttestation:
    item: object                # what the caller submitted
    attestation: object
    indexed_indices: np.ndarray
    sets: list
    observations: list = field(default_factory=list)    # deferred cache marks
    ok: bool = False


def verify_signature_sets_with_bisection(sets: Sequence[bls.SignatureSet], *,
                                         backend: str = "cuda", device=None) -> np.ndarray:
    """Per-set validity after a failed batch: recursive bisection, each
    half one batch verify on ``backend``."""
    out = np.zeros(len(sets), bool)

    def rec(lo: int, hi: int, known_failed: bool):
        if lo >= hi:
            return
        if not known_failed and bls.verify_signature_sets(sets[lo:hi], backend=backend,
                                                          device=device):
            out[lo:hi] = True
            return
        if hi - lo == 1:
            return
        mid = (lo + hi) // 2
        rec(lo, mid, False)
        rec(mid, hi, False)

    rec(0, len(sets), True)     # callers come here after the whole batch failed
    return out


def get_attesting_indices(state, spec, attestation, shuffled=None) -> np.ndarray:
    committee = misc.get_beacon_committee(state, spec, int(attestation.data.slot),
                                          int(attestation.data.index), shuffled)
    bits = attestation.aggregation_bits
    if len(bits) != committee.shape[0]:
        raise AttestationError("aggregation_bits_length")
    return committee[np.asarray(bits, dtype=bool)]


def _gossip_checks(chain, attestation, state) -> np.ndarray:
    """Timing and structure checks; the attesting validator indices."""
    spec = chain.spec
    data = attestation.data
    att_slot = int(data.slot)
    current_slot = chain.current_slot()
    if att_slot > current_slot:
        raise AttestationError("future_slot")
    if att_slot + spec.slots_per_epoch < current_slot:
        raise AttestationError("past_slot")
    target_epoch = int(data.target.epoch)
    if target_epoch != spec.compute_epoch_at_slot(att_slot):
        raise AttestationError("target_epoch_mismatch")
    head_root = bytes(data.beacon_block_root)
    proto = chain.fork_choice.proto
    if head_root not in proto:
        raise AttestationError("unknown_head_block")
    target_root = bytes(data.target.root)
    if target_root not in proto:
        raise AttestationError("unknown_target_root")
    if proto.get_ancestor(head_root, spec.compute_start_slot_at_epoch(target_epoch)) \
            != target_root:
        raise AttestationError("invalid_target_root")
    shuffle = chain.committee_shuffle(state, target_epoch)
    indices = get_attesting_indices(state, spec, attestation, shuffle)
    if indices.size == 0:
        raise AttestationError("empty_aggregation_bits")
    return indices


def indexed_attestation_set(state, spec, indices: np.ndarray, data, signature: bytes):
    """The signature set of an attestation over its sorted attesters."""
    domain = misc.get_domain(state, spec, spec.domain_beacon_attester, int(data.target.epoch))
    signing_root = misc.compute_signing_root(data.hash_tree_root("cpu"), domain)
    pubkeys = [bls.PublicKey.interned(state.validators.pubkeys[int(i)].tobytes())
               for i in np.sort(indices)]
    return bls.SignatureSet(bls.Signature(bytes(signature)), pubkeys, signing_root)


def verify_unaggregated_for_gossip(chain, attestation, state) -> VerifiedAttestation:
    """Checks of a single-bit gossip attestation; the dup check reads only,
    the mark waits for the signature."""
    indices = _gossip_checks(chain, attestation, state)
    if indices.size != 1:
        raise AttestationError("not_unaggregated")
    epoch = int(attestation.data.target.epoch)
    if chain.observed_attesters.seen_mask(epoch, indices).any():
        raise AttestationError("prior_attestation_known")
    sset = indexed_attestation_set(state, chain.spec, indices, attestation.data,
                                   attestation.signature)
    return VerifiedAttestation(attestation, attestation, indices, [sset],
                               observations=[("attesters", epoch, indices)])


def commit_observations(chain, verified: VerifiedAttestation) -> bool:
    """Mark the dup caches of a signature-verified item; False if an
    earlier item of the batch already claimed a mark."""
    ok = True
    for _kind, epoch, payload in verified.observations:
        if chain.observed_attesters.observe_batch(epoch, payload).any():
            ok = False
    return ok


def batch_verify(chain, candidates: list[VerifiedAttestation]) -> list[VerifiedAttestation]:
    """One batch verification over every candidate's sets after the pre-BLS
    coalescing; on failure, bisection over the ORIGINAL sets attributes it
    per item."""
    all_sets: list = []
    spans: list[tuple[int, int]] = []
    for c in candidates:
        spans.append((len(all_sets), len(all_sets) + len(c.sets)))
        all_sets.extend(c.sets)
    if not all_sets:
        return candidates
    if chain.verify_sets(coalesce_sets(all_sets)):
        for c in candidates:
            c.ok = True
        return candidates
    mask = verify_signature_sets_with_bisection(all_sets, backend=chain.bls_backend,
                                                device=chain.device)
    for c, (lo, hi) in zip(candidates, spans):
        c.ok = bool(mask[lo:hi].all())
    return candidates
