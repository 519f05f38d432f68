"""Epoch kernels: the fused lane pass of epoch processing and the
swap-or-not shuffle rounds, as CUDA kernels and plain PyTorch versions.

Port of ``lighthouse_tpu/ops/epoch_kernels.py``.  ``fused_epoch_pass`` runs,
in spec order over every validator lane, the inactivity-score update, the
flag rewards and penalties (gathered from exact per-increment tables built
on the host with Python integers), the score-scaled inactivity penalty,
proportional slashings and effective-balance hysteresis.  The kernel never
divides by a runtime total, so it is bit-identical to the spec's integer
arithmetic.  ``shuffle_rounds`` runs every swap-or-not round for every
position of a committee shuffle, round by round, each round's window of
decision bytes (the half of its row that the round can read) staged in
shared memory.

Column, table and parameter layouts are the JAX package's, with one more
parameter, ``P_REWARDS``, that gates the inactivity and reward stages off
in the genesis epoch (the JAX package runs its numpy stages there instead).
Deneb's hysteresis always runs in the pass (the JAX ``apply_eb`` is False
only for Electra).  The JAX package pads lanes to power-of-two buckets to
bound its jit cache; a CUDA kernel takes any lane count, so the port
launches exactly the registry's lanes and has no bucket.

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``
and, for CUDA tensors, launches its kernel (``csrc/epoch.cu``) and counts
the launch on its ``launches`` attribute; for CPU tensors it runs the plain
version beside it.  A kernel fault raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from lighthouse_tpu_torch.native import build_cuda_lib

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

# index layout of the int64 parameter vector (csrc/epoch.cuh enum Param)
P_PREV_EPOCH = 0
P_LEAK = 1
P_SCORE_BIAS = 2
P_SCORE_RECOVERY = 3
P_INACT_DENOM = 4       # inactivity_score_bias * inactivity_penalty_quotient
P_SLASH_TARGET = 5      # cur + EPOCHS_PER_SLASHINGS_VECTOR // 2
P_INCREMENT = 6
P_HYST_DOWN = 7
P_HYST_UP = 8
P_MAX_EFF = 9
P_REWARDS = 10          # 0 in the genesis epoch: no inactivity or reward stage
N_PARAMS = 11

# Bytes the fused pass must move per lane: eff_incr 4, balances, scores and
# the three epoch columns 8 each, prev_part and slashed 1 each read; scores,
# balances and effective balances 8 each written.
EPOCH_BYTES_PER_LANE = 4 + 5 * 8 + 2 + 3 * 8
# About as many int32 operations per lane: some 40 int64 compares, adds
# and selects (two int32 operations each) and one 64-bit division (a
# software sequence of about 40).  The pass is bound by its bytes either way.
EPOCH_OPS_PER_LANE = 120
# int32 operations per shuffle round and position: the flip, its
# conditional add, the max, the byte address and bit extraction, the select.
SHUFFLE_OPS_PER_ROUND = 10
# the most positions ``shuffle_rounds`` takes (csrc/epoch.cuh
# SHUFFLE_CAPACITY): a round's decision bytes must fit the slices of one
# cluster's shared memory
SHUFFLE_CAPACITY = 1 << 22


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def fused_epoch_pass_plain(eff_incr, balances, scores, prev_part, slashed, activation,
                           exit_epoch, withdrawable, reward_t, penalty_t, slash_t, params):
    """Plain version of ``fused_epoch_pass``: the JAX program's arithmetic
    in int64 tensors.  Returns (scores, balances, effective balances)."""
    p = params
    k = slash_t.shape[0]
    prev = p[P_PREV_EPOCH]
    kidx = eff_incr.long().clamp(0, k - 1)      # jnp's gather clamps
    eff = eff_incr.long() * p[P_INCREMENT]
    sl = slashed != 0
    part = prev_part.long()

    def has_flag(idx: int) -> torch.Tensor:
        return ((part >> idx) & 1) != 0

    active_prev = (activation <= prev) & (prev < exit_epoch)
    eligible = active_prev | (sl & (prev + 1 < withdrawable))
    unslashed_active = active_prev & ~sl
    target = unslashed_active & has_flag(TIMELY_TARGET_FLAG_INDEX)
    rewards_on = p[P_REWARDS] != 0

    # inactivity updates
    sc = torch.where(eligible & target, scores - scores.clamp(max=1), scores)
    sc = torch.where(eligible & ~target, sc + p[P_SCORE_BIAS], sc)
    sc = torch.where((p[P_LEAK] == 0) & eligible, sc - torch.minimum(p[P_SCORE_RECOVERY], sc), sc)
    sc = torch.where(rewards_on, sc, scores)

    # rewards and penalties
    delta = torch.zeros_like(balances)
    for flag_index in range(3):
        participated = unslashed_active & has_flag(flag_index)
        delta = delta + torch.where(eligible & participated, reward_t[flag_index][kidx], 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            delta = delta - torch.where(eligible & ~participated, penalty_t[flag_index][kidx], 0)
    penalty = torch.div(eff * sc, p[P_INACT_DENOM], rounding_mode="floor")
    delta = delta - torch.where(eligible & ~target, penalty, 0)
    bal = torch.where(rewards_on, (balances + delta).clamp(min=0), balances)

    # slashings
    bal = torch.where(sl & (withdrawable == p[P_SLASH_TARGET]),
                      (bal - slash_t[kidx]).clamp(min=0), bal)

    # effective-balance hysteresis
    update = (bal + p[P_HYST_DOWN] < eff) | (eff + p[P_HYST_UP] < bal)
    new_eff = torch.minimum(bal - torch.remainder(bal, p[P_INCREMENT]), p[P_MAX_EFF])
    return sc, bal, torch.where(update, new_eff, eff)


def shuffle_rounds_plain(pivots: torch.Tensor, src: torch.Tensor, count: int) -> torch.Tensor:
    """Plain version of ``shuffle_rounds``: the forward swap-or-not map of
    positions [0, count) as int32[count]."""
    cur = torch.arange(count, dtype=torch.int64, device=src.device)
    piv = pivots.long()
    for r in range(pivots.shape[0]):
        flip = torch.remainder(piv[r] - cur, count)
        position = torch.maximum(cur, flip)
        byte = src[r][position >> 3].long()
        cur = torch.where(((byte >> (position & 7)) & 1) == 1, flip, cur)
    return cur.to(torch.int32)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = build_cuda_lib("epoch")
    if lib.lh_fused_epoch_pass.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lh_fused_epoch_pass.argtypes = [i64, i32] + [ptr] * 15 + [ptr]
        lib.lh_shuffle_rounds.argtypes = [i64, i32, i64, ptr, ptr, ptr, ptr]
        for fn in (lib.lh_fused_epoch_pass, lib.lh_shuffle_rounds):
            fn.restype = ctypes.c_int
        lib.lh_epoch_error_string.argtypes = [ctypes.c_int]
        lib.lh_epoch_error_string.restype = ctypes.c_char_p
    return lib


def _launch(fn_name: str, *args) -> None:
    lib = _lib()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name}: CUDA error {rc}: {lib.lh_epoch_error_string(rc).decode()}")


def _check(x, dtype: torch.dtype, shape: tuple, name: str, device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device} like the other inputs")


def fused_epoch_pass(eff_incr, balances, scores, prev_part, slashed, activation, exit_epoch,
                     withdrawable, reward_t, penalty_t, slash_t, params):
    """The fused epoch pass over n validator lanes.

    Columns: ``eff_incr`` int32[n] (effective balance / increment),
    ``balances``, ``scores``, ``activation``, ``exit_epoch``,
    ``withdrawable`` int64[n] (epochs clamped below 2^62), ``prev_part``
    and ``slashed`` uint8[n].  Tables: ``reward_t`` and ``penalty_t``
    int64[3, k], ``slash_t`` int64[k]; ``params`` int64[N_PARAMS].
    Returns (scores, balances, effective balances), int64[n] each.
    Replaces ``lighthouse_tpu/ops/epoch_kernels.py:101`` (jitted at :172).
    """
    dev = balances.device
    n = balances.shape[0]
    k = slash_t.shape[0] if isinstance(slash_t, torch.Tensor) else 0
    for x, dtype, name in ((eff_incr, torch.int32, "eff_incr"), (balances, torch.int64, "balances"),
                           (scores, torch.int64, "scores"), (prev_part, torch.uint8, "prev_part"),
                           (slashed, torch.uint8, "slashed"),
                           (activation, torch.int64, "activation"),
                           (exit_epoch, torch.int64, "exit_epoch"),
                           (withdrawable, torch.int64, "withdrawable")):
        _check(x, dtype, (n,), name, dev)
    _check(reward_t, torch.int64, (3, k), "reward_t", dev)
    _check(penalty_t, torch.int64, (3, k), "penalty_t", dev)
    _check(slash_t, torch.int64, (k,), "slash_t", dev)
    _check(params, torch.int64, (N_PARAMS,), "params", dev)
    if k < 1:
        raise ValueError("fused_epoch_pass: the tables need at least one entry")
    if dev.type == "cpu":
        return fused_epoch_pass_plain(eff_incr, balances, scores, prev_part, slashed, activation,
                                      exit_epoch, withdrawable, reward_t, penalty_t, slash_t,
                                      params)
    # the outputs start at the inputs' lane parity, so that a view into the
    # columns (a mesh shard) still runs in aligned pairs
    at = (balances.data_ptr() // 8) % 2
    outs = tuple(torch.empty(n + 1, dtype=torch.int64, device=dev)[at:at + n]
                 for _ in range(3))
    if n:
        ins = (reward_t, penalty_t, slash_t, params, eff_incr, balances, scores, prev_part,
               slashed, activation, exit_epoch, withdrawable) + outs
        with torch.cuda.device(dev):
            _launch("lh_fused_epoch_pass", n, k, *(t.data_ptr() for t in ins),
                    torch.cuda.current_stream(dev).cuda_stream)
        fused_epoch_pass.launches += 1
    return outs


def shuffle_rounds(pivots: torch.Tensor, src: torch.Tensor, count: int) -> torch.Tensor:
    """All swap-or-not rounds for positions [0, count): ``pivots``
    int32[rounds] in [0, count), ``src`` uint8[rounds, row_bytes] with
    row_bytes >= ceil(count / 8) (position p's decision bit of round r at
    byte p >> 3, bit p & 7).  Returns int32[count]: out[i] is
    ``compute_shuffled_index(i, count, seed, rounds)``.  Replaces
    ``lighthouse_tpu/ops/epoch_kernels.py:224`` (jitted at :250).

    At most ``SHUFFLE_CAPACITY`` positions, on either device.  The kernel
    copies rows with 16-byte bulk copies, so on the card ``src`` and
    ``row_bytes`` must be 16-byte aligned."""
    dev = src.device
    if src.dim() != 2:
        raise ValueError(f"shuffle_rounds: src must be [rounds, row_bytes], got {list(src.shape)}")
    rounds, row_bytes = src.shape
    _check(pivots, torch.int32, (rounds,), "pivots", dev)
    _check(src, torch.uint8, (rounds, row_bytes), "src", dev)
    if not 0 <= count < 2**31 or row_bytes * 8 < count or rounds > 256:
        raise ValueError(f"shuffle_rounds: count {count} with {rounds} rounds of "
                         f"{row_bytes} source bytes")
    if count > SHUFFLE_CAPACITY:
        raise ValueError(f"shuffle_rounds: {count} positions exceed the kernel's capacity of "
                         f"{SHUFFLE_CAPACITY}")
    if dev.type == "cpu":
        return shuffle_rounds_plain(pivots, src, count)
    if row_bytes % 16 or src.data_ptr() % 16:
        raise ValueError(f"shuffle_rounds: src rows of {row_bytes} bytes at an address "
                         f"{src.data_ptr() % 16} bytes past a boundary: the kernel's bulk "
                         f"copies need both 16-byte aligned")
    out = torch.empty(count, dtype=torch.int32, device=dev)
    if count:
        with torch.cuda.device(dev):
            _launch("lh_shuffle_rounds", count, rounds, row_bytes, pivots.data_ptr(),
                    src.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        shuffle_rounds.launches += 1
    return out


KERNELS = (fused_epoch_pass, shuffle_rounds)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launches()
