"""Signature-set constructors: (state, operation) -> ``bls.SignatureSet``.

Port of ``lighthouse_tpu/state_transition/signature_sets.py`` (the
constructors that block processing and ``include_all_signatures`` use).
Each block operation yields one or more sets, which the block's bulk
verifier gathers into one ``verify_signature_sets`` call on the card.

Keys come through ``PublicKey.interned`` (one object per key bytes,
process-wide), so a validator's key is decompressed and checked once
whichever state or block it appears in; the JAX package makes new objects
for the sync committee's and the change's keys, which gives equal sets.
The operation containers hashed here are a few chunks each and hash on
the host (``"cpu"``), where the SHA-256 module routes trees this small for
any device; the block root, whose body holds lists, hashes on ``device``.
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch import ssz
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.types import DepositMessage

HOST = "cpu"
INFINITY_SIGNATURE = b"\xc0" + b"\x00" * 95


def _pubkey(state, index: int) -> bls.PublicKey:
    return bls.PublicKey.interned(state.validators.pubkeys[int(index)].tobytes())


def block_proposal_set(state, spec, signed_block, block_root: bytes | None = None,
                       device=None):
    block = signed_block.message
    root = block_root if block_root is not None else block.hash_tree_root(device)
    domain = misc.get_domain(state, spec, spec.domain_beacon_proposer,
                             spec.compute_epoch_at_slot(int(block.slot)))
    return bls.SignatureSet(bls.Signature(signed_block.signature),
                            [_pubkey(state, block.proposer_index)],
                            misc.compute_signing_root(root, domain))


def randao_set(state, spec, block):
    epoch = spec.compute_epoch_at_slot(int(block.slot))
    domain = misc.get_domain(state, spec, spec.domain_randao, epoch)
    return bls.SignatureSet(bls.Signature(block.body.randao_reveal),
                            [_pubkey(state, block.proposer_index)],
                            misc.compute_signing_root(ssz.uint64.hash_tree_root(epoch, HOST),
                                                      domain))


def proposer_slashing_sets(state, spec, slashing):
    out = []
    for signed_header in (slashing.signed_header_1, slashing.signed_header_2):
        header = signed_header.message
        domain = misc.get_domain(state, spec, spec.domain_beacon_proposer,
                                 spec.compute_epoch_at_slot(int(header.slot)))
        out.append(bls.SignatureSet(
            bls.Signature(signed_header.signature), [_pubkey(state, header.proposer_index)],
            misc.compute_signing_root(header.hash_tree_root(HOST), domain)))
    return out


def indexed_attestation_set(state, spec, indexed):
    domain = misc.get_domain(state, spec, spec.domain_beacon_attester,
                             int(indexed.data.target.epoch))
    signing_root = misc.compute_signing_root(indexed.data.hash_tree_root(HOST), domain)
    pubkeys = [_pubkey(state, i) for i in np.asarray(indexed.attesting_indices)]
    return bls.SignatureSet(bls.Signature(indexed.signature), pubkeys, signing_root)


def deposit_set(spec, deposit_data):
    """Deposit signatures use the genesis fork version and an empty
    genesis validators root (they predate the chain)."""
    domain = misc.compute_domain(spec.domain_deposit, spec.genesis_fork_version, b"\x00" * 32)
    msg = DepositMessage(pubkey=deposit_data.pubkey,
                         withdrawal_credentials=deposit_data.withdrawal_credentials,
                         amount=deposit_data.amount)
    return bls.SignatureSet(bls.Signature(deposit_data.signature),
                            [bls.PublicKey.interned(bytes(deposit_data.pubkey))],
                            misc.compute_signing_root(msg.hash_tree_root(HOST), domain))


def voluntary_exit_set(state, spec, signed_exit):
    """Deneb exits are signed with the Capella fork's domain (EIP-7044)."""
    exit_ = signed_exit.message
    fork = spec.fork_at_epoch(misc.current_epoch(state, spec))
    if fork in ("deneb", "electra"):
        domain = misc.compute_domain(spec.domain_voluntary_exit, spec.capella_fork_version,
                                     state.genesis_validators_root)
    else:
        domain = misc.get_domain(state, spec, spec.domain_voluntary_exit, int(exit_.epoch))
    return bls.SignatureSet(bls.Signature(signed_exit.signature),
                            [_pubkey(state, exit_.validator_index)],
                            misc.compute_signing_root(exit_.hash_tree_root(HOST), domain))


def bls_to_execution_change_set(state, spec, signed_change):
    """Signed with the genesis fork version whatever the current fork."""
    change = signed_change.message
    domain = misc.compute_domain(spec.domain_bls_to_execution_change,
                                 spec.genesis_fork_version, state.genesis_validators_root)
    return bls.SignatureSet(bls.Signature(signed_change.signature),
                            [bls.PublicKey.interned(bytes(change.from_bls_pubkey))],
                            misc.compute_signing_root(change.hash_tree_root(HOST), domain))


def sync_aggregate_set(state, spec, sync_aggregate, block_slot: int):
    """The participating current sync committee members over the previous
    slot's block root -> (set, member keys)."""
    previous_slot = max(int(block_slot), 1) - 1
    domain = misc.get_domain(state, spec, spec.domain_sync_committee,
                             spec.compute_epoch_at_slot(previous_slot))
    block_root = misc.get_block_root_at_slot(state, spec, previous_slot)
    pubkeys = [bls.PublicKey.interned(bytes(pk))
               for pk, bit in zip(state.current_sync_committee.pubkeys,
                                  sync_aggregate.sync_committee_bits) if bit]
    return bls.SignatureSet(bls.Signature(sync_aggregate.sync_committee_signature), pubkeys,
                            misc.compute_signing_root(block_root, domain)), pubkeys


def include_all_signatures(state, spec, signed_block, block_root=None,
                           include_proposal: bool = True, *, shuffle_fn=None, device=None):
    """Every signature set of a block, for one batched verify: proposal,
    randao, proposer and attester slashings, attestations, exits, the sync
    aggregate and BLS-to-execution changes.  Deposit signatures are left
    out on purpose: an invalid one skips the deposit, not the block.

    ``state`` is the parent state advanced to the block's slot.
    ``shuffle_fn(state, epoch)`` supplies the committee shuffle of an epoch
    (a chain passes its shuffle cache); without one the shuffle is
    computed on ``device``, as the JAX function computes it."""
    from lighthouse_tpu_torch.state_transition.block_processing import (
        committee_shuffler,
        to_indexed_attestation,
    )
    from lighthouse_tpu_torch.types import make_types

    block = signed_block.message
    body = block.body
    t = make_types(spec.preset)
    shuffle = committee_shuffler(spec, shuffle_fn, device)
    sets = [randao_set(state, spec, block)]
    if include_proposal:
        sets.insert(0, block_proposal_set(state, spec, signed_block, block_root, device))
    for slashing in body.proposer_slashings:
        sets.extend(proposer_slashing_sets(state, spec, slashing))
    for slashing in body.attester_slashings:
        sets.append(indexed_attestation_set(state, spec, slashing.attestation_1))
        sets.append(indexed_attestation_set(state, spec, slashing.attestation_2))
    for att in body.attestations:
        epoch = spec.compute_epoch_at_slot(int(att.data.slot))
        indexed = to_indexed_attestation(state, spec, att, t, shuffle(state, epoch))
        sets.append(indexed_attestation_set(state, spec, indexed))
    for signed_exit in body.voluntary_exits:
        sets.append(voluntary_exit_set(state, spec, signed_exit))
    if any(body.sync_aggregate.sync_committee_bits):
        sets.append(sync_aggregate_set(state, spec, body.sync_aggregate, int(block.slot))[0])
    elif bytes(body.sync_aggregate.sync_committee_signature) != INFINITY_SIGNATURE:
        # zero participation must carry the G2 infinity signature
        raise ValueError("empty sync aggregate without infinity signature")
    for change in body.bls_to_execution_changes:
        sets.append(bls_to_execution_change_set(state, spec, change))
    return sets
