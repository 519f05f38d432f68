"""Deneb epoch processing over the columnar state, with the per-validator
core on the card.

Port of the Deneb path of
``lighthouse_tpu/state_transition/epoch_processing.py:process_epoch``.
The four per-validator stages (inactivity updates, rewards and penalties,
slashings, effective-balance hysteresis) run as one ``fused_epoch_pass``
launch (``epoch_device``); the rest is host column arithmetic as in the
JAX package: justification and finalization, registry updates with the
batched exit queue, and the resets and rotations at the end.

Why running slashings before the registry updates gives the spec's
result: registry updates change only the epochs of validators whose exit
epoch is unset, and a slashed validator's exit epoch is always set, so the
slashings mask (slashed and withdrawable == target) reads columns that the
registry pass cannot touch; registry updates read only effective balances,
whose new values the pass hands back deferred and which are applied at the
spec's effective-balance-update point, after registry updates.

Deneb only, as the port's containers are: another fork raises
``NotImplementedError``.  There is no fallback: a kernel fault, or a state
that int64 lanes cannot hold, raises before the pass writes anything.
"""

from __future__ import annotations

import numpy as np

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.state_transition import epoch_device, misc
from lighthouse_tpu_torch.types import (
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    ChainSpec,
    Checkpoint,
    HistoricalSummary,
    RootsVector,
)

# Participation flag indices and weights (altair).
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = (TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT)


def has_flag(participation: np.ndarray, flag_index: int) -> np.ndarray:
    return (participation >> np.uint8(flag_index)) & np.uint8(1) != 0


def base_reward_per_increment(spec: ChainSpec, total_active_balance: int) -> int:
    return (spec.effective_balance_increment * spec.base_reward_factor
            // misc.integer_squareroot(total_active_balance))


def is_in_inactivity_leak(state, spec: ChainSpec) -> bool:
    prev = misc.previous_epoch(state, spec)
    return prev - int(state.finalized_checkpoint.epoch) > spec.min_epochs_to_inactivity_penalty


def process_epoch(state, spec: ChainSpec, device=None) -> dict:
    """The Deneb epoch transition of ``state`` in place, the per-validator
    core on ``device`` (default ``cuda``).  Returns the core's host stage
    times: ``prep_host_ms`` (tables and columns) and ``dispatch_ms``
    (upload, launch, fetch)."""
    device = resolve_device(device)
    cur = misc.current_epoch(state, spec)
    fork = spec.fork_at_epoch(cur)
    if fork != "deneb":
        raise NotImplementedError(f"epoch {cur} is {fork}: only Deneb epochs are ported")
    epoch_device.check_int64_lanes(state, spec)
    process_justification_and_finalization(state, spec)
    deferred_eff, stages = epoch_device.prepare_and_run(state, spec, device)
    process_registry_updates(state, spec)
    process_eth1_data_reset(state, spec)
    # the pass's hysteresis output, at the spec's effective-balance point
    state.validators.effective_balance = deferred_eff
    process_slashings_reset(state, spec)
    process_randao_mixes_reset(state, spec)
    process_historical_update(state, spec, device)
    process_participation_flag_updates(state)
    process_sync_committee_updates(state, spec)
    return stages


# --- justification and finalization ----------------------------------------

def _unslashed_participating_balance(state, spec, flag_index: int, epoch: int) -> int:
    cur = misc.current_epoch(state, spec)
    part = (state.current_epoch_participation if epoch == cur
            else state.previous_epoch_participation)
    v = state.validators
    mask = v.is_active(epoch) & ~v.slashed & has_flag(part, flag_index)
    return max(spec.effective_balance_increment, int(v.effective_balance[mask].sum()))


def process_justification_and_finalization(state, spec: ChainSpec) -> None:
    cur = misc.current_epoch(state, spec)
    if cur <= GENESIS_EPOCH + 1:
        return
    prev = misc.previous_epoch(state, spec)
    total = misc.get_total_active_balance(state, spec)
    prev_target = _unslashed_participating_balance(state, spec, TIMELY_TARGET_FLAG_INDEX, prev)
    cur_target = _unslashed_participating_balance(state, spec, TIMELY_TARGET_FLAG_INDEX, cur)
    weigh_justification_and_finalization(state, spec, total, prev_target, cur_target)


def weigh_justification_and_finalization(state, spec: ChainSpec, total: int,
                                         prev_target: int, cur_target: int) -> None:
    cur = misc.current_epoch(state, spec)
    prev = misc.previous_epoch(state, spec)
    old_prev_justified = state.previous_justified_checkpoint
    old_cur_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = old_cur_justified
    bits = [False] + list(state.justification_bits)[:-1]
    if prev_target * 3 >= total * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=prev, root=misc.get_block_root(state, spec, prev))
        bits[1] = True
    if cur_target * 3 >= total * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=cur, root=misc.get_block_root(state, spec, cur))
        bits[0] = True
    state.justification_bits = bits

    if all(bits[1:4]) and int(old_prev_justified.epoch) + 3 == cur:
        state.finalized_checkpoint = old_prev_justified
    if all(bits[1:3]) and int(old_prev_justified.epoch) + 2 == cur:
        state.finalized_checkpoint = old_prev_justified
    if all(bits[0:3]) and int(old_cur_justified.epoch) + 2 == cur:
        state.finalized_checkpoint = old_cur_justified
    if all(bits[0:2]) and int(old_cur_justified.epoch) + 1 == cur:
        state.finalized_checkpoint = old_cur_justified


# --- registry updates -------------------------------------------------------

def initiate_validator_exits(state, spec: ChainSpec, indices: np.ndarray) -> None:
    """``initiate_validator_exit`` over ``indices`` (ascending registry
    order) with the spec's sequential queue semantics, as column
    arithmetic.  The queue's tail epoch, its occupancy and the churn limit
    (the active count now, which an exit never changes: exit epochs land
    in the future) are set up once; the j-th validator that still has no
    exit then lands in epoch tail + (occupancy + j) // churn, where a full
    tail first opens the next epoch, exactly as the scalar calls in order
    would place it."""
    v = state.validators
    far = np.uint64(FAR_FUTURE_EPOCH)
    todo = np.asarray(indices, dtype=np.int64)
    todo = todo[v.exit_epoch[todo] == far]
    if todo.size == 0:
        return
    activation_exit = spec.compute_activation_exit_epoch(misc.current_epoch(state, spec))
    churn = misc.get_validator_churn_limit(state, spec)
    exiting = v.exit_epoch[v.exit_epoch != far]
    queue_epoch = max(int(exiting.max()) if exiting.size else 0, activation_exit)
    queue_count = int((exiting == np.uint64(queue_epoch)).sum())
    if queue_count >= churn:
        queue_epoch, queue_count = queue_epoch + 1, 0
    epochs = (np.uint64(queue_epoch)
              + (np.arange(todo.size, dtype=np.uint64) + np.uint64(queue_count)) // np.uint64(churn))
    v.exit_epoch[todo] = epochs
    v.withdrawable_epoch[todo] = epochs + np.uint64(spec.min_validator_withdrawability_delay)


def process_registry_updates(state, spec: ChainSpec) -> None:
    v = state.validators
    cur = misc.current_epoch(state, spec)
    eligible = v.is_eligible_for_activation_queue(spec.max_effective_balance)
    v.activation_eligibility_epoch[eligible] = cur + 1
    eject = v.is_active(cur) & (v.effective_balance <= np.uint64(spec.ejection_balance))
    eject_idx = np.nonzero(eject)[0]
    if eject_idx.size:
        initiate_validator_exits(state, spec, eject_idx)
    # activation queue: by eligibility epoch then index, bounded by
    # finality and the Deneb activation churn
    pending = ((v.activation_eligibility_epoch <= np.uint64(int(state.finalized_checkpoint.epoch)))
               & (v.activation_epoch == np.uint64(FAR_FUTURE_EPOCH)))
    idxs = np.nonzero(pending)[0]
    order = np.lexsort((idxs, v.activation_eligibility_epoch[idxs]))
    dequeued = idxs[order][:misc.get_validator_activation_churn_limit(state, spec)]
    v.activation_epoch[dequeued] = spec.compute_activation_exit_epoch(cur)


# --- resets and rotations ---------------------------------------------------

def process_eth1_data_reset(state, spec: ChainSpec) -> None:
    next_epoch = misc.current_epoch(state, spec) + 1
    if next_epoch % spec.preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def process_slashings_reset(state, spec: ChainSpec) -> None:
    next_epoch = misc.current_epoch(state, spec) + 1
    state.slashings[next_epoch % spec.preset.epochs_per_slashings_vector] = 0


def process_randao_mixes_reset(state, spec: ChainSpec) -> None:
    cur = misc.current_epoch(state, spec)
    n = spec.preset.epochs_per_historical_vector
    state.randao_mixes[(cur + 1) % n] = state.randao_mixes[cur % n]


def process_historical_update(state, spec: ChainSpec, device) -> None:
    next_epoch = misc.current_epoch(state, spec) + 1
    sphr = spec.preset.slots_per_historical_root
    if next_epoch % (sphr // spec.preset.slots_per_epoch) == 0:
        roots = RootsVector(sphr)
        summary = HistoricalSummary(
            block_summary_root=roots.hash_tree_root(state.block_roots, device),
            state_summary_root=roots.hash_tree_root(state.state_roots, device))
        state.historical_summaries = list(state.historical_summaries) + [summary]


def process_participation_flag_updates(state) -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = np.zeros(len(state.validators), dtype=np.uint8)


def process_sync_committee_updates(state, spec: ChainSpec) -> None:
    next_epoch = misc.current_epoch(state, spec) + 1
    if next_epoch % spec.preset.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = misc.get_next_sync_committee(state, spec)
