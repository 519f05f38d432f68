"""Deneb block processing: ``process_block`` and its operations.

Port of the Deneb path of ``lighthouse_tpu/state_transition/block_processing.py``
(the header, withdrawals, the execution payload header, randao, eth1 data,
proposer and attester slashings, attestations with participation flags,
deposits with proofs, exits, BLS-to-execution changes and the sync
aggregate), with its error strings.  Blocks of another fork raise
``NotImplementedError`` (Electra and the rest are ROADMAP A 16).

Signature policy follows the reference's BlockSignatureStrategy: with
``VERIFY_BULK`` every operation adds its signature sets to one
``BulkVerifier``, verified once at the end on the named BLS backend (the
card's ``cuda`` backend by default: the block's GPU seam).

Where the JAX code recomputes per operation what a block cannot change,
it is computed once per block with the same result: the proposer index
(its seed reads an old randao mix; no operation changes the active set or
the effective balances of the current epoch), the active count and total
active balance that attestations read, and the committee shuffle of an
epoch, which ``shuffle_fn`` may supply from a cache.  The withdrawals
sweep and the sync committee's registry lookup run as numpy column
operations instead of Python loops, with identical results.
"""

from __future__ import annotations

import hashlib
import time
from enum import Enum

import numpy as np

from lighthouse_tpu_torch import ssz
from lighthouse_tpu_torch.crypto.bls import api as bls
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.state_transition import signature_sets as sigs
from lighthouse_tpu_torch.state_transition.epoch_processing import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    base_reward_per_increment,
    has_flag,
    initiate_validator_exits,
)
from lighthouse_tpu_torch.types import FAR_FUTURE_EPOCH, BeaconBlockHeader, Withdrawal, make_types

PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2
ETH1_ADDRESS_WITHDRAWAL_PREFIX = 0x01
BLS_WITHDRAWAL_PREFIX = 0x00
HOST = sigs.HOST


class SignatureStrategy(Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_BULK = "verify_bulk"


class BlockProcessingError(ValueError):
    pass


def _err(cond: bool, msg: str):
    if not cond:
        raise BlockProcessingError(msg)


def add_flag(participation: np.ndarray, idx: np.ndarray, flag_index: int) -> None:
    participation[idx] |= np.uint8(1 << flag_index)


class BulkVerifier:
    """Gathers a block's signature sets for one batched verify on
    ``backend`` and ``device`` (the reference's BlockSignatureVerifier).
    With ``ledger`` (a dict) the ``cuda`` backend adds its stage seconds
    under ``ledger["bls"]`` (device stages synchronized: profiling only)."""

    def __init__(self, backend: str = "cuda", device=None, ledger: dict | None = None):
        self.sets: list[bls.SignatureSet] = []
        self.backend = backend
        self.device = device
        self.ledger = ledger

    def add(self, s) -> None:
        if isinstance(s, list):
            self.sets.extend(s)
        else:
            self.sets.append(s)

    def verify_sets(self, sets) -> bool:
        if self.ledger is not None and self.backend == "cuda":
            from lighthouse_tpu_torch.ops import bls_backend

            return bls_backend.verify_signature_sets_device(
                sets, device=self.device, ledger=self.ledger.setdefault("bls", {}))
        return bls.verify_signature_sets(sets, backend=self.backend, device=self.device)

    def verify(self) -> bool:
        if not self.sets:
            return True
        return self.verify_sets(self.sets)


class _Block:
    """What one ``process_block`` call carries through its operations: the
    strategy and verifier, the device, the committee shuffles, the values a
    block cannot change, and the stage clock."""

    def __init__(self, spec, strategy, verifier, shuffle_fn, device, ledger):
        self.strategy, self.verifier, self.device = strategy, verifier, device
        self.shuffle = committee_shuffler(spec, shuffle_fn, device, ledger)
        self.ledger = ledger
        self.proposer: int | None = None
        self.active_counts: dict[int, int] = {}
        self.total_active: int | None = None

    def accumulate(self, make) -> None:
        """Add the sets ``make()`` builds (VERIFY_BULK) or verify them one
        by one (VERIFY_INDIVIDUAL); nothing under NO_VERIFICATION."""
        if self.strategy is SignatureStrategy.NO_VERIFICATION:
            return
        t0 = time.perf_counter()
        sset = make()
        if self.ledger is not None:
            self.ledger["sets"] = self.ledger.get("sets", 0.0) + time.perf_counter() - t0
        if self.strategy is SignatureStrategy.VERIFY_BULK:
            self.verifier.add(sset)
            return
        for s in (sset if isinstance(sset, list) else [sset]):
            _err(self.verifier.verify_sets([s]), "signature verification failed")


def committee_shuffler(spec, shuffle_fn=None, device=None, ledger: dict | None = None):
    """``shuffle(state, epoch)``: the epoch's shuffled active set, once per
    epoch within a block, from ``shuffle_fn`` (a chain's shuffle cache) or
    computed on ``device`` as the JAX block path computes it; with
    ``ledger`` its seconds add up under ``ledger["shuffle"]``."""
    memo: dict[int, np.ndarray] = {}

    def shuffle(state, epoch: int) -> np.ndarray:
        got = memo.get(epoch)
        if got is None:
            t0 = time.perf_counter()
            got = (shuffle_fn(state, epoch) if shuffle_fn is not None
                   else misc.compute_committee_shuffle(state, spec, epoch, device=device))
            if ledger is not None:
                ledger["shuffle"] = ledger.get("shuffle", 0.0) + time.perf_counter() - t0
            memo[epoch] = got
        return got

    return shuffle


def process_block(state, spec, signed_block,
                  strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK, *,
                  verify_block_root: bytes | None = None, shuffle_fn=None, device=None,
                  bls_backend: str = "cuda", ledger: dict | None = None) -> None:
    """Apply a signed Deneb block to ``state``, already advanced to the
    block's slot.  Raises ``BlockProcessingError`` on any invalid condition.

    ``device`` (``cuda`` unless ``"cpu"`` is given) runs the committee
    shuffle, the block body's root and the ``cuda`` BLS backend;
    ``bls_backend`` names the backend of the bulk verify; ``shuffle_fn``
    (state, epoch) -> shuffle supplies committee shuffles; ``ledger`` (a
    dict) collects stage seconds: ``shuffle``, ``sets``, ``verify`` (with
    the backend's own split under ``bls``) and ``total``."""
    t_start = time.perf_counter()
    block = signed_block.message
    fork = spec.fork_at_epoch(spec.compute_epoch_at_slot(int(block.slot)))
    if fork != "deneb":
        raise NotImplementedError(
            f"block processing of fork {fork!r}: only Deneb is ported (ROADMAP A 16)")
    verifier = BulkVerifier(bls_backend, device, ledger)
    ctx = _Block(spec, strategy, verifier, shuffle_fn, device, ledger)

    ctx.accumulate(lambda: sigs.block_proposal_set(state, spec, signed_block,
                                                   verify_block_root, device))
    process_block_header(state, spec, block, ctx)
    process_withdrawals(state, spec, block.body.execution_payload)
    process_execution_payload(state, spec, block.body, device)
    process_randao(state, spec, block, ctx)
    process_eth1_data(state, spec, block.body)
    process_operations(state, spec, block.body, ctx)
    process_sync_aggregate(state, spec, block.body.sync_aggregate, int(block.slot), ctx)

    if strategy is SignatureStrategy.VERIFY_BULK:
        t0 = time.perf_counter()
        ok = verifier.verify()
        if ledger is not None:
            ledger["verify"] = ledger.get("verify", 0.0) + time.perf_counter() - t0
        _err(ok, "bulk signature verification failed")
    if ledger is not None:
        ledger["total"] = ledger.get("total", 0.0) + time.perf_counter() - t_start


def _proposer(state, spec, ctx) -> int:
    if ctx.proposer is None:
        ctx.proposer = misc.get_beacon_proposer_index(state, spec)
    return ctx.proposer


def process_block_header(state, spec, block, ctx) -> None:
    _err(int(block.slot) == int(state.slot), "block slot != state slot")
    _err(int(block.slot) > int(state.latest_block_header.slot),
         "block not newer than latest header")
    proposer = _proposer(state, spec, ctx)
    _err(int(block.proposer_index) == proposer, "wrong proposer index")
    _err(bytes(block.parent_root) == state.latest_block_header.hash_tree_root(HOST),
         "parent root mismatch")
    _err(not bool(state.validators.slashed[proposer]), "proposer is slashed")
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot, proposer_index=block.proposer_index, parent_root=block.parent_root,
        state_root=b"\x00" * 32, body_root=block.body.hash_tree_root(ctx.device))


def process_randao(state, spec, block, ctx) -> None:
    ctx.accumulate(lambda: sigs.randao_set(state, spec, block))
    epoch = misc.current_epoch(state, spec)
    mix = misc.get_randao_mix(state, spec, epoch)
    new_mix = bytes(a ^ b for a, b in zip(mix, hashlib.sha256(block.body.randao_reveal).digest()))
    state.randao_mixes[epoch % spec.preset.epochs_per_historical_vector] = np.frombuffer(
        new_mix, np.uint8)


def process_eth1_data(state, spec, body) -> None:
    votes = list(state.eth1_data_votes)
    votes.append(body.eth1_data)
    state.eth1_data_votes = votes
    period_slots = spec.preset.epochs_per_eth1_voting_period * spec.preset.slots_per_epoch
    if sum(1 for v in votes if v == body.eth1_data) * 2 > period_slots:
        state.eth1_data = body.eth1_data


def process_operations(state, spec, body, ctx) -> None:
    expected_deposits = min(spec.preset.max_deposits,
                            max(0, int(state.eth1_data.deposit_count)
                                - int(state.eth1_deposit_index)))
    _err(len(body.deposits) == expected_deposits,
         f"expected {expected_deposits} deposits, got {len(body.deposits)}")
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, spec, ps, ctx)
    for asl in body.attester_slashings:
        process_attester_slashing(state, spec, asl, ctx)
    for att in body.attestations:
        process_attestation(state, spec, att, ctx)
    for dep in body.deposits:
        process_deposit(state, spec, dep, ctx.verifier)
    for exit_ in body.voluntary_exits:
        process_voluntary_exit(state, spec, exit_, ctx)
    for change in body.bls_to_execution_changes:
        process_bls_to_execution_change(state, spec, change, ctx)


# --- slashings --------------------------------------------------------------

def slash_validator(state, spec, index: int, ctx, whistleblower: int | None = None) -> None:
    epoch = misc.current_epoch(state, spec)
    initiate_validator_exits(state, spec, np.array([index]))
    v = state.validators
    v.slashed[index] = True
    v.withdrawable_epoch[index] = max(int(v.withdrawable_epoch[index]),
                                      epoch + spec.preset.epochs_per_slashings_vector)
    state.slashings[epoch % spec.preset.epochs_per_slashings_vector] += v.effective_balance[index]
    penalty = int(v.effective_balance[index]) // spec.min_slashing_penalty_quotient_bellatrix
    state.balances[index] = max(0, int(state.balances[index]) - penalty)

    proposer = _proposer(state, spec, ctx)
    if whistleblower is None:
        whistleblower = proposer
    wb_reward = int(v.effective_balance[index]) // spec.whistleblower_reward_quotient
    proposer_reward = wb_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    state.balances[proposer] += np.uint64(proposer_reward)
    state.balances[whistleblower] += np.uint64(wb_reward - proposer_reward)


def process_proposer_slashing(state, spec, slashing, ctx) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    _err(int(h1.slot) == int(h2.slot), "proposer slashing: slots differ")
    _err(int(h1.proposer_index) == int(h2.proposer_index), "proposer slashing: proposers differ")
    _err(h1 != h2, "proposer slashing: headers identical")
    idx = int(h1.proposer_index)
    _err(idx < len(state.validators), "proposer slashing: unknown validator")
    _err(bool(state.validators.is_slashable(misc.current_epoch(state, spec))[idx]),
         "proposer slashing: not slashable")
    ctx.accumulate(lambda: sigs.proposer_slashing_sets(state, spec, slashing))
    slash_validator(state, spec, idx, ctx)


def is_slashable_attestation_data(d1, d2) -> bool:
    double = d1 != d2 and int(d1.target.epoch) == int(d2.target.epoch)
    surround = (int(d1.source.epoch) < int(d2.source.epoch)
                and int(d2.target.epoch) < int(d1.target.epoch))
    return double or surround


def _validate_indexed_attestation(state, spec, indexed, ctx) -> None:
    idxs = np.asarray(indexed.attesting_indices, dtype=np.int64)
    _err(idxs.size > 0, "indexed attestation: empty indices")
    _err(idxs.size <= spec.preset.max_validators_per_committee,
         "indexed attestation: too many indices")
    _err(bool((np.diff(idxs) > 0).all()), "indices not sorted/unique")
    _err(int(idxs.max(initial=0)) < len(state.validators), "unknown validator index")
    ctx.accumulate(lambda: sigs.indexed_attestation_set(state, spec, indexed))


def process_attester_slashing(state, spec, slashing, ctx) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    _err(is_slashable_attestation_data(a1.data, a2.data), "attestations not slashable")
    _validate_indexed_attestation(state, spec, a1, ctx)
    _validate_indexed_attestation(state, spec, a2, ctx)
    slashable = state.validators.is_slashable(misc.current_epoch(state, spec))
    common = np.intersect1d(np.asarray(a1.attesting_indices, np.int64),
                            np.asarray(a2.attesting_indices, np.int64))
    slashed_any = False
    for idx in common:
        if slashable[idx]:
            slash_validator(state, spec, int(idx), ctx)
            slashed_any = True
    _err(slashed_any, "attester slashing: nobody slashed")


# --- attestations -----------------------------------------------------------

def get_attesting_indices(state, spec, attestation, shuffled=None) -> np.ndarray:
    if hasattr(attestation, "committee_bits"):
        raise NotImplementedError("Electra attestations are not ported (ROADMAP A 16)")
    committee = misc.get_beacon_committee(state, spec, int(attestation.data.slot),
                                          int(attestation.data.index), shuffled)
    bits = attestation.aggregation_bits
    _err(len(bits) == committee.shape[0], "aggregation bits length mismatch")
    return committee[np.asarray(bits, dtype=bool)]


def to_indexed_attestation(state, spec, attestation, types_ns, shuffled=None):
    indices = np.sort(get_attesting_indices(state, spec, attestation, shuffled))
    return types_ns.IndexedAttestation(attesting_indices=indices.astype(np.uint64),
                                       data=attestation.data, signature=attestation.signature)


def get_attestation_participation_flag_indices(state, spec, data, inclusion_delay: int) -> list:
    cur = misc.current_epoch(state, spec)
    if int(data.target.epoch) == cur:
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = data.source == justified
    _err(is_matching_source, "attestation source does not match justified checkpoint")
    is_matching_target = is_matching_source and (
        bytes(data.target.root) == misc.get_block_root(state, spec, int(data.target.epoch)))
    is_matching_head = is_matching_target and (
        bytes(data.beacon_block_root) == misc.get_block_root_at_slot(state, spec, int(data.slot)))
    flags = []
    if is_matching_source and inclusion_delay <= misc.integer_squareroot(
            spec.preset.slots_per_epoch):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target:                     # Deneb: no inclusion bound (EIP-7045)
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_attestation(state, spec, attestation, ctx) -> None:
    data = attestation.data
    cur = misc.current_epoch(state, spec)
    prev = misc.previous_epoch(state, spec)
    target_epoch = int(data.target.epoch)
    _err(target_epoch in (prev, cur), "attestation target epoch out of range")
    _err(target_epoch == spec.compute_epoch_at_slot(int(data.slot)),
         "target epoch != slot epoch")
    delay = int(state.slot) - int(data.slot)
    _err(delay >= spec.min_attestation_inclusion_delay, "attestation too fresh")
    active_count = ctx.active_counts.get(target_epoch)
    if active_count is None:
        active_count = int(state.validators.is_active(target_epoch).sum())
        ctx.active_counts[target_epoch] = active_count
    _err(int(data.index) < misc.get_committee_count_per_slot(spec, active_count),
         "committee index out of range")

    flag_indices = get_attestation_participation_flag_indices(state, spec, data, delay)
    indexed = to_indexed_attestation(state, spec, attestation, make_types(spec.preset),
                                     ctx.shuffle(state, target_epoch))
    _validate_indexed_attestation(state, spec, indexed, ctx)

    participation = (state.current_epoch_participation if target_epoch == cur
                     else state.previous_epoch_participation)
    if ctx.total_active is None:
        ctx.total_active = misc.get_total_active_balance(state, spec)
    brpi = base_reward_per_increment(spec, ctx.total_active)
    idxs = np.asarray(indexed.attesting_indices, dtype=np.int64)
    increments = state.validators.effective_balance[idxs] // np.uint64(
        spec.effective_balance_increment)
    base_rewards = increments.astype(np.int64) * brpi

    proposer_reward_numerator = 0
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        if flag_index in flag_indices:
            fresh = ~has_flag(participation[idxs], flag_index)
            proposer_reward_numerator += int((base_rewards[fresh] * weight).sum())
            add_flag(participation, idxs[fresh], flag_index)
    proposer_reward = proposer_reward_numerator // (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT)
    state.balances[_proposer(state, spec, ctx)] += np.uint64(proposer_reward)


# --- deposits ---------------------------------------------------------------

def get_validator_from_deposit(spec, pubkey, withdrawal_credentials, amount) -> dict:
    eff = min(amount - amount % spec.effective_balance_increment, spec.max_effective_balance)
    return dict(pubkey=pubkey, withdrawal_credentials=withdrawal_credentials,
                effective_balance=eff, slashed=False,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH, activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH, withdrawable_epoch=FAR_FUTURE_EPOCH)


def apply_deposit(state, spec, deposit_data, verifier: BulkVerifier,
                  check_signature: bool = True) -> None:
    pubkey = bytes(deposit_data.pubkey)
    amount = int(deposit_data.amount)
    matches = np.nonzero((state.validators.pubkeys == np.frombuffer(pubkey, np.uint8))
                         .all(axis=1))[0]
    if matches.size:
        state.balances[int(matches[0])] += np.uint64(amount)
        return
    if check_signature and not verifier.verify_sets([sigs.deposit_set(spec, deposit_data)]):
        return  # an invalid proof of possession skips the deposit, not the block
    state.validators.append(**get_validator_from_deposit(
        spec, pubkey, bytes(deposit_data.withdrawal_credentials), amount))
    state.balances = np.append(state.balances, np.uint64(amount))
    state.previous_epoch_participation = np.append(state.previous_epoch_participation,
                                                   np.uint8(0))
    state.current_epoch_participation = np.append(state.current_epoch_participation,
                                                  np.uint8(0))
    state.inactivity_scores = np.append(state.inactivity_scores, np.uint64(0))


def process_deposit(state, spec, deposit, verifier: BulkVerifier,
                    check_proof: bool = True) -> None:
    if check_proof:
        _err(misc.is_valid_merkle_branch(
            deposit.data.hash_tree_root(HOST), [bytes(b) for b in deposit.proof],
            33,  # DEPOSIT_CONTRACT_TREE_DEPTH + 1 (the length mix-in)
            int(state.eth1_deposit_index), bytes(state.eth1_data.deposit_root)),
            "invalid deposit merkle proof")
    state.eth1_deposit_index = int(state.eth1_deposit_index) + 1
    apply_deposit(state, spec, deposit.data, verifier)


# --- exits and BLS-to-execution changes ---------------------------------------

def process_voluntary_exit(state, spec, signed_exit, ctx) -> None:
    exit_ = signed_exit.message
    idx = int(exit_.validator_index)
    cur = misc.current_epoch(state, spec)
    v = state.validators
    _err(idx < len(v), "exit: unknown validator")
    _err(bool(v.is_active(cur)[idx]), "exit: validator not active")
    _err(int(v.exit_epoch[idx]) == FAR_FUTURE_EPOCH, "exit: already exiting")
    _err(cur >= int(exit_.epoch), "exit: epoch in future")
    _err(cur >= int(v.activation_epoch[idx]) + spec.shard_committee_period, "exit: too young")
    ctx.accumulate(lambda: sigs.voluntary_exit_set(state, spec, signed_exit))
    initiate_validator_exits(state, spec, np.array([idx]))


def process_bls_to_execution_change(state, spec, signed_change, ctx) -> None:
    change = signed_change.message
    idx = int(change.validator_index)
    _err(idx < len(state.validators), "bls change: unknown validator")
    creds = state.validators.withdrawal_credentials[idx]
    _err(int(creds[0]) == BLS_WITHDRAWAL_PREFIX, "bls change: not BLS credentials")
    expect = hashlib.sha256(bytes(change.from_bls_pubkey)).digest()[1:]
    _err(creds[1:].tobytes() == expect, "bls change: pubkey hash mismatch")
    ctx.accumulate(lambda: sigs.bls_to_execution_change_set(state, spec, signed_change))
    new_creds = (bytes([ETH1_ADDRESS_WITHDRAWAL_PREFIX]) + b"\x00" * 11
                 + bytes(change.to_execution_address))
    state.validators.withdrawal_credentials[idx] = np.frombuffer(new_creds, np.uint8)


# --- withdrawals --------------------------------------------------------------

def get_expected_withdrawals(state, spec) -> list:
    """The Capella/Deneb sweep over at most MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
    validators from ``next_withdrawal_validator_index``, as columns: the
    same withdrawals, in sweep order, as the JAX package's loop."""
    epoch = misc.current_epoch(state, spec)
    n = len(state.validators)
    bound = min(n, spec.preset.max_validators_per_withdrawals_sweep)
    pos = (int(state.next_withdrawal_validator_index) + np.arange(bound, dtype=np.int64)) % n
    v = state.validators
    creds = v.withdrawal_credentials[pos]
    balance = state.balances[pos].astype(np.int64)
    eth1 = creds[:, 0] == ETH1_ADDRESS_WITHDRAWAL_PREFIX
    max_bal = spec.max_effective_balance
    full = eth1 & (v.withdrawable_epoch[pos] <= np.uint64(epoch)) & (balance > 0)
    partial = (eth1 & ~full & (v.effective_balance[pos] == np.uint64(max_bal))
               & (balance > max_bal))
    take = np.nonzero(full | partial)[0][:spec.preset.max_withdrawals_per_payload]
    idx = int(state.next_withdrawal_index)
    return [Withdrawal(index=idx + k, validator_index=int(pos[j]),
                       address=creds[j, 12:].tobytes(),
                       amount=int(balance[j]) if full[j] else int(balance[j]) - max_bal)
            for k, j in enumerate(take)]


def process_withdrawals(state, spec, payload) -> None:
    expected = get_expected_withdrawals(state, spec)
    got = list(payload.withdrawals)
    _err(len(got) == len(expected), "withdrawals count mismatch")
    for g, e in zip(got, expected):
        _err(g == e, "withdrawal mismatch")
    for w in expected:
        state.balances[int(w.validator_index)] -= np.uint64(int(w.amount))
    if expected:
        state.next_withdrawal_index = int(expected[-1].index) + 1
    n = len(state.validators)
    if len(expected) == spec.preset.max_withdrawals_per_payload:
        state.next_withdrawal_validator_index = (int(expected[-1].validator_index) + 1) % n
    else:
        # the cursor advances by the raw sweep constant even when the
        # registry is smaller (Capella spec process_withdrawals)
        state.next_withdrawal_validator_index = (
            int(state.next_withdrawal_validator_index)
            + spec.preset.max_validators_per_withdrawals_sweep) % n


# --- execution payload (header only; no execution engine) -----------------------

def compute_timestamp_at_slot(state, spec) -> int:
    return int(state.genesis_time) + int(state.slot) * spec.seconds_per_slot


def process_execution_payload(state, spec, body, device=None) -> None:
    payload = body.execution_payload
    header = state.latest_execution_payload_header
    _err(bytes(payload.parent_hash) == bytes(header.block_hash), "payload parent hash mismatch")
    _err(bytes(payload.prev_randao) == misc.get_randao_mix(state, spec,
                                                           misc.current_epoch(state, spec)),
         "payload prev_randao mismatch")
    _err(int(payload.timestamp) == compute_timestamp_at_slot(state, spec),
         "payload timestamp mismatch")
    t = make_types(spec.preset)
    withdrawals = ssz.List(Withdrawal, spec.preset.max_withdrawals_per_payload)
    state.latest_execution_payload_header = t.ExecutionPayloadHeaderDeneb(
        parent_hash=payload.parent_hash, fee_recipient=payload.fee_recipient,
        state_root=payload.state_root, receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom, prev_randao=payload.prev_randao,
        block_number=payload.block_number, gas_limit=payload.gas_limit,
        gas_used=payload.gas_used, timestamp=payload.timestamp, extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas, block_hash=payload.block_hash,
        transactions_root=t.Transactions.hash_tree_root(payload.transactions, device),
        withdrawals_root=withdrawals.hash_tree_root(payload.withdrawals, device),
        blob_gas_used=payload.blob_gas_used, excess_blob_gas=payload.excess_blob_gas)


# --- sync aggregate -------------------------------------------------------------

# The sync committee is fixed for a period (256 epochs on mainnet), so its
# key -> validator index resolution is cached across blocks, keyed by a
# digest of the committee's keys (the registry is append-only).
_SYNC_COMMITTEE_INDEX_CACHE: dict[bytes, list[int]] = {}


def sync_committee_validator_indices(state) -> list[int]:
    pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    key = hashlib.sha256(b"".join(pubkeys)).digest()
    cached = _SYNC_COMMITTEE_INDEX_CACHE.get(key)
    if cached is not None:
        return cached
    # candidates by the first 8 key bytes, then whole keys; the last row
    # of a repeated key wins, as the JAX package's dict comprehension does
    reg = state.validators.pubkeys
    first = np.ascontiguousarray(reg[:, :8]).view("<u8").ravel()
    want = np.frombuffer(b"".join(pk[:8] for pk in pubkeys), "<u8")
    index_of = {reg[i].tobytes(): int(i) for i in np.nonzero(np.isin(first, want))[0]}
    out = []
    for pk in pubkeys:
        vidx = index_of.get(pk)
        _err(vidx is not None, "sync committee pubkey not in registry")
        out.append(vidx)
    if len(_SYNC_COMMITTEE_INDEX_CACHE) > 8:
        _SYNC_COMMITTEE_INDEX_CACHE.clear()
    _SYNC_COMMITTEE_INDEX_CACHE[key] = out
    return out


def process_sync_aggregate(state, spec, aggregate, block_slot: int, ctx) -> None:
    if ctx.strategy is not SignatureStrategy.NO_VERIFICATION:
        if any(aggregate.sync_committee_bits):
            ctx.accumulate(lambda: sigs.sync_aggregate_set(state, spec, aggregate,
                                                           block_slot)[0])
        else:
            _err(bytes(aggregate.sync_committee_signature) == sigs.INFINITY_SIGNATURE,
                 "empty sync aggregate must carry infinity signature")

    total = misc.get_total_active_balance(state, spec)
    brpi = base_reward_per_increment(spec, total)
    total_base_rewards = brpi * (total // spec.effective_balance_increment)
    max_participant_rewards = (total_base_rewards * SYNC_REWARD_WEIGHT
                               // WEIGHT_DENOMINATOR // spec.preset.slots_per_epoch)
    participant_reward = max_participant_rewards // spec.preset.sync_committee_size
    proposer_reward = participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR
                                                               - PROPOSER_WEIGHT)
    proposer = _proposer(state, spec, ctx)
    for vidx, bit in zip(sync_committee_validator_indices(state),
                         aggregate.sync_committee_bits):
        if bit:
            state.balances[vidx] += np.uint64(participant_reward)
            state.balances[proposer] += np.uint64(proposer_reward)
        else:
            state.balances[vidx] = max(0, int(state.balances[vidx]) - participant_reward)
