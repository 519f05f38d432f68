"""Host side of the fused epoch pass: exact tables, clamped columns, one
launch, an all-or-nothing apply.

Port of ``lighthouse_tpu/state_transition/epoch_device.py`` for Deneb.
Every spec quantity that depends only on a validator's effective-balance
increment count (per-flag reward, per-flag penalty, proportional slashing
penalty) is computed here with Python integers over all
``max_effective_balance // increment + 1`` counts, and the kernel gathers
it by lane: no runtime total is ever divided on the card, so the pass is
bit-identical to the spec's integer arithmetic.

Differences from the JAX package, on purpose:
- a state that int64 lanes cannot hold raises ``ValueError``
  (``check_int64_lanes``; the JAX package's ``build_tables`` returns None
  there and it runs its numpy stages);
- the genesis epoch runs the pass too, with ``P_REWARDS`` = 0, so slashings
  and hysteresis stay on the kernel while the spec's inactivity and reward
  stages are skipped (the JAX package runs its numpy stages there);
- there is no fault recovery: a kernel fault raises before anything is
  written back.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from lighthouse_tpu_torch.ops import epoch_kernels as ek
from lighthouse_tpu_torch.state_transition import misc
from lighthouse_tpu_torch.types import GENESIS_EPOCH, ChainSpec

#: epoch columns are clamped to this before entering int64 lanes
#: (FAR_FUTURE_EPOCH = 2**64-1 maps here; every comparison the pass makes
#: is kept because real epochs are far below it, and epoch + 1 cannot
#: overflow)
EPOCH_CLAMP = 1 << 62


def _clamp_epochs(col: np.ndarray) -> np.ndarray:
    return np.minimum(col, np.uint64(EPOCH_CLAMP)).astype(np.int64)


def check_int64_lanes(state, spec: ChainSpec) -> None:
    """The int64 guard: raise ``ValueError`` for a state that int64 lanes
    cannot hold, an effective balance above the maximum (its table index
    would fall outside the tables), an inactivity product eff * score that
    could reach 2^63, or a balance at 2^62.  No real state comes near it:
    scores would need some 3 * 10^8 epochs of leak."""
    max_eff = spec.max_effective_balance
    if int(state.validators.effective_balance.max(initial=0)) > max_eff:
        raise ValueError("int64 guard: an effective balance exceeds "
                         f"MAX_EFFECTIVE_BALANCE ({max_eff})")
    max_score = int(state.inactivity_scores.max(initial=0))
    if max_eff * (max_score + spec.inactivity_score_bias) >= 2**63:
        raise ValueError(f"int64 guard: inactivity score {max_score} makes the "
                         "inactivity penalty product overflow int64")
    if int(state.balances.max(initial=0)) >= EPOCH_CLAMP:
        raise ValueError(f"int64 guard: a balance reaches 2^62 ({EPOCH_CLAMP})")


def build_tables(state, spec: ChainSpec, *, leak: bool) -> dict:
    """Exact per-increment gather tables (Python integers on the host):
    ``reward`` and ``penalty`` int64[3, k], ``slash`` int64[k], for a state
    that ``check_int64_lanes`` passed."""
    from lighthouse_tpu_torch.state_transition import epoch_processing as ep

    v = state.validators
    incr = spec.effective_balance_increment
    k_count = spec.max_effective_balance // incr + 1
    total = misc.get_total_active_balance(state, spec)
    brpi = ep.base_reward_per_increment(spec, total)
    total_increments = total // incr
    reward_t = np.zeros((3, k_count), np.int64)
    penalty_t = np.zeros((3, k_count), np.int64)
    ks = range(k_count)
    unslashed_active = v.is_active(misc.previous_epoch(state, spec)) & ~v.slashed
    for flag_index, weight in enumerate(ep.PARTICIPATION_FLAG_WEIGHTS):
        participated = unslashed_active & ep.has_flag(
            state.previous_epoch_participation, flag_index)
        unslashed_bal = int(v.effective_balance[participated].sum())
        u_incr = max(unslashed_bal, incr) // incr
        denom = total_increments * ep.WEIGHT_DENOMINATOR
        if not leak:
            reward_t[flag_index] = [(k * brpi * weight * u_incr) // denom for k in ks]
        if flag_index != ep.TIMELY_HEAD_FLAG_INDEX:
            penalty_t[flag_index] = [k * brpi * weight // ep.WEIGHT_DENOMINATOR for k in ks]

    adjusted = min(int(state.slashings.sum()) * spec.proportional_slashing_multiplier_bellatrix,
                   total)
    slash_t = np.array([(k * adjusted) // total * incr for k in ks], np.int64)
    return {"reward": reward_t, "penalty": penalty_t, "slash": slash_t}


def build_columns(state, spec: ChainSpec) -> dict:
    """The pass's lane columns, one row per validator (no padding)."""
    v = state.validators
    return {
        "eff_incr": (v.effective_balance // np.uint64(spec.effective_balance_increment)
                     ).astype(np.int32),
        "balances": state.balances.astype(np.int64),
        "scores": state.inactivity_scores.astype(np.int64),
        "prev_part": np.ascontiguousarray(state.previous_epoch_participation, np.uint8),
        "slashed": v.slashed.astype(np.uint8),
        "activation": _clamp_epochs(v.activation_epoch),
        "exit_epoch": _clamp_epochs(v.exit_epoch),
        "withdrawable": _clamp_epochs(v.withdrawable_epoch),
    }


#: the order in which ``fused_epoch_pass`` takes the columns
COLUMNS = ("eff_incr", "balances", "scores", "prev_part", "slashed", "activation",
           "exit_epoch", "withdrawable")


def build_params(state, spec: ChainSpec, *, leak: bool) -> np.ndarray:
    cur = misc.current_epoch(state, spec)
    incr = spec.effective_balance_increment
    hysteresis_increment = incr // spec.hysteresis_quotient
    params = np.zeros(ek.N_PARAMS, np.int64)
    params[ek.P_PREV_EPOCH] = misc.previous_epoch(state, spec)
    params[ek.P_LEAK] = int(leak)
    params[ek.P_SCORE_BIAS] = spec.inactivity_score_bias
    params[ek.P_SCORE_RECOVERY] = spec.inactivity_score_recovery_rate
    params[ek.P_INACT_DENOM] = (spec.inactivity_score_bias
                                * spec.inactivity_penalty_quotient_bellatrix)
    params[ek.P_SLASH_TARGET] = cur + spec.preset.epochs_per_slashings_vector // 2
    params[ek.P_INCREMENT] = incr
    params[ek.P_HYST_DOWN] = hysteresis_increment * spec.hysteresis_downward_multiplier
    params[ek.P_HYST_UP] = hysteresis_increment * spec.hysteresis_upward_multiplier
    params[ek.P_MAX_EFF] = spec.max_effective_balance
    params[ek.P_REWARDS] = int(cur != GENESIS_EPOCH)
    return params


#: the epoch pass's rungs: one device, or the rows split over a mesh
#: (``parallel/epoch_sharded.py``)
EPOCH_BACKENDS = ("device", "sharded")


def epoch_backend(device: torch.device) -> str:
    """The rung that runs the pass on ``device``: ``LHGPU_EPOCH_BACKEND``
    (``device`` or ``sharded``; another value raises) when set, else
    ``sharded`` when more than one card is visible and the pass runs on a
    card, else ``device``.  Counterpart of ``LHTPU_EPOCH_BACKEND`` and the
    auto choice of ``lighthouse_tpu/state_transition/epoch_processing.py``
    (:195-211)."""
    forced = os.environ.get("LHGPU_EPOCH_BACKEND")
    if forced:
        if forced not in EPOCH_BACKENDS:
            raise ValueError(f"LHGPU_EPOCH_BACKEND={forced!r}: use one of {EPOCH_BACKENDS}")
        return forced
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return "sharded"
    return "device"


def epoch_pass(columns: dict, tables: dict, params: np.ndarray, device: torch.device
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One upload, one ``fused_epoch_pass`` launch on ``device`` and one
    fetch of its outputs: host columns (``build_columns``), tables and
    params in, host int64 (scores, balances, effective balances) out."""
    ins = [torch.from_numpy(columns[c]).to(device) for c in COLUMNS]
    ins += [torch.from_numpy(a).to(device) for a in (tables["reward"], tables["penalty"],
                                                     tables["slash"], params)]
    return tuple(t.cpu().numpy() for t in ek.fused_epoch_pass(*ins))


def prepare_and_run(state, spec: ChainSpec, device: torch.device) -> tuple[np.ndarray, dict]:
    """Tables and columns on the host, then the pass on the rung
    ``epoch_backend`` picks (``epoch_pass`` on ``device``, or
    ``epoch_pass_sharded`` over every visible card; over a mesh of
    ``device`` alone when that is the CPU), then the apply: scores and
    balances are written to ``state`` only after every output has
    arrived.  Returns the effective balances, deferred until after the
    registry updates, and the host stage times.  The caller has run
    ``check_int64_lanes``."""
    from lighthouse_tpu_torch.state_transition import epoch_processing as ep

    t0 = time.perf_counter()
    leak = ep.is_in_inactivity_leak(state, spec)
    tables = build_tables(state, spec, leak=leak)
    columns = build_columns(state, spec)
    params = build_params(state, spec, leak=leak)
    t1 = time.perf_counter()
    if epoch_backend(device) == "sharded":
        from lighthouse_tpu_torch.parallel.epoch_sharded import epoch_pass_sharded
        from lighthouse_tpu_torch.parallel.mesh import rung_mesh

        sc, bal, eff = epoch_pass_sharded(columns, tables, params, mesh=rung_mesh(device))
    else:
        sc, bal, eff = epoch_pass(columns, tables, params, device)
    t2 = time.perf_counter()
    state.inactivity_scores = sc.astype(np.uint64)
    state.balances = bal.astype(np.uint64)
    return eff.astype(np.uint64), {
        "prep_host_ms": (t1 - t0) * 1e3,
        "dispatch_ms": (t2 - t1) * 1e3,
    }
