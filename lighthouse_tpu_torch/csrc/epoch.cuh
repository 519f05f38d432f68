// Per-lane code of the epoch kernels of csrc/epoch.cu (sm_90a): the fused
// epoch pass and the swap-or-not shuffle rounds.
//
// Counterpart of lighthouse_tpu/ops/epoch_kernels.py.  Everything a kernel
// computes per lane is a function lane_*() here, so the same code also
// compiles as host C++ (g++ -x c++), which the CPU tests use to hold it to
// the plain PyTorch versions (lighthouse_tpu_torch/ops/epoch_kernels.py)
// without a card.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace epoch {

// Index layout of the int64 parameter vector: the JAX package's
// (epoch_kernels.py P_*), plus P_REWARDS, which gates the inactivity and
// reward stages off in the genesis epoch (the spec skips both there while
// slashings and hysteresis still run).
enum Param {
    P_PREV_EPOCH = 0,
    P_LEAK = 1,
    P_SCORE_BIAS = 2,
    P_SCORE_RECOVERY = 3,
    P_INACT_DENOM = 4,     // inactivity_score_bias * inactivity_penalty_quotient
    P_SLASH_TARGET = 5,    // current epoch + EPOCHS_PER_SLASHINGS_VECTOR / 2
    P_INCREMENT = 6,
    P_HYST_DOWN = 7,
    P_HYST_UP = 8,
    P_MAX_EFF = 9,
    P_REWARDS = 10,
    N_PARAMS = 11,
};

constexpr int TIMELY_TARGET_FLAG_INDEX = 1;
constexpr int TIMELY_HEAD_FLAG_INDEX = 2;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// Lane i of k_fused_epoch_pass, in spec order: inactivity-score update,
// flag rewards and penalties gathered from the per-increment tables, the
// score-scaled inactivity penalty, proportional slashings, effective-balance
// hysteresis.  Tables: reward and penalty int64[3, k], slash int64[k],
// params int64[N_PARAMS].  Epoch columns arrive clamped below 2^62, so
// prev + 1 cannot overflow.  The table index is clamped to [0, k) as JAX's
// gather clamps (the host guard keeps every increment count in range).
//
// Division: jnp's // and % floor, C++'s / and % truncate.  They agree here
// because every operand is non-negative: eff * sc with eff >= 0 and a score
// that never drops below zero (each decrement is a min with the score), and
// bal after max(..., 0).
__device__ __forceinline__ void lane_fused_epoch_pass(
    long long i, int k, const int64_t* reward, const int64_t* penalty, const int64_t* slash,
    const int64_t* params, const int32_t* eff_incr, const int64_t* balances,
    const int64_t* scores, const uint8_t* prev_part, const uint8_t* slashed,
    const int64_t* activation, const int64_t* exit_epoch, const int64_t* withdrawable,
    int64_t* scores_out, int64_t* balances_out, int64_t* eff_out) {
    const int64_t prev = params[P_PREV_EPOCH];
    const int32_t incr_count = eff_incr[i];
    const int kidx = incr_count < 0 ? 0 : (incr_count >= k ? k - 1 : incr_count);
    const int64_t eff = (int64_t)incr_count * params[P_INCREMENT];
    const bool is_slashed = slashed[i] != 0;
    const unsigned part = prev_part[i];
    const int64_t wd = withdrawable[i];

    const bool active_prev = activation[i] <= prev && prev < exit_epoch[i];
    const bool eligible = active_prev || (is_slashed && prev + 1 < wd);
    const bool unslashed_active = active_prev && !is_slashed;
    const bool target = unslashed_active && ((part >> TIMELY_TARGET_FLAG_INDEX) & 1u);

    int64_t sc = scores[i];
    int64_t bal = balances[i];
    if (params[P_REWARDS] != 0) {
        // inactivity updates
        if (eligible && target) sc -= min64(1, sc);
        if (eligible && !target) sc += params[P_SCORE_BIAS];
        if (params[P_LEAK] == 0 && eligible) sc -= min64(params[P_SCORE_RECOVERY], sc);
        // rewards and penalties
        int64_t delta = 0;
        for (int f = 0; f < 3; ++f) {
            const bool participated = unslashed_active && ((part >> f) & 1u);
            if (eligible && participated) delta += reward[f * k + kidx];
            if (f != TIMELY_HEAD_FLAG_INDEX && eligible && !participated)
                delta -= penalty[f * k + kidx];
        }
        if (eligible && !target) delta -= (eff * sc) / params[P_INACT_DENOM];
        bal = max64(bal + delta, 0);
    }
    // proportional slashings
    if (is_slashed && wd == params[P_SLASH_TARGET]) bal = max64(bal - slash[kidx], 0);
    // effective-balance hysteresis
    const int64_t incr = params[P_INCREMENT];
    const bool update = bal + params[P_HYST_DOWN] < eff || eff + params[P_HYST_UP] < bal;
    scores_out[i] = sc;
    balances_out[i] = bal;
    eff_out[i] = update ? min64(bal - bal % incr, params[P_MAX_EFF]) : eff;
}

// Lane i of k_shuffle_rounds: the forward swap-or-not walk of position i
// through `rounds` rounds.  pivots int32[rounds] in [0, count); src
// uint8[rounds, row_bytes] with position p's decision bit of round r at
// byte p >> 3, bit p & 7 of row r.  cur and the pivot both lie in
// [0, count), so jnp.mod(pivot - cur, count) is one conditional add.
__device__ __forceinline__ void lane_shuffle(long long i, int rounds, int32_t count,
                                             long long row_bytes, const int32_t* pivots,
                                             const uint8_t* src, int32_t* out) {
    int32_t cur = (int32_t)i;
    for (int r = 0; r < rounds; ++r) {
        int32_t flip = pivots[r] - cur;
        if (flip < 0) flip += count;
        const int32_t position = cur > flip ? cur : flip;
        const uint8_t byte = src[(long long)r * row_bytes + (position >> 3)];
        if ((byte >> (position & 7)) & 1) cur = flip;
    }
    out[i] = cur;
}

}  // namespace epoch
