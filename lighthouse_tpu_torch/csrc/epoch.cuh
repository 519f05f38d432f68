// Per-lane and per-thread code of the epoch kernels of csrc/epoch.cu
// (sm_90a): the fused epoch pass and the swap-or-not shuffle rounds.
//
// Counterpart of lighthouse_tpu/ops/epoch_kernels.py.  Everything a kernel
// computes per lane or thread is a function here, and the shuffle's launch
// plan too, so the same code also compiles as host C++ (g++ -x c++), which
// the CPU tests use to hold it to the plain PyTorch versions
// (lighthouse_tpu_torch/ops/epoch_kernels.py) without a card:
// host_fused_epoch_pass and host_shuffle_rounds run k_fused_epoch_pass's
// and k_shuffle_rounds's blocks and threads on the host.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#include <algorithm>
#include <vector>
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

// The columns of one fused-pass launch: eff_incr int32[n], balances,
// scores, activation, exit_epoch, withdrawable int64[n] (epochs clamped
// below 2^62, so prev + 1 cannot overflow), prev_part and slashed uint8[n];
// the three int64[n] outputs.
struct EpochCols {
    const int32_t* eff_incr;
    const int64_t* balances;
    const int64_t* scores;
    const uint8_t* prev_part;
    const uint8_t* slashed;
    const int64_t* activation;
    const int64_t* exit_epoch;
    const int64_t* withdrawable;
    int64_t* scores_out;
    int64_t* balances_out;
    int64_t* eff_out;
};

// The tables and parameters of a launch: reward and penalty int64[3, k],
// slash int64[k], params int64[N_PARAMS].
struct EpochTables {
    const int64_t* reward;
    const int64_t* penalty;
    const int64_t* slash;
    const int64_t* params;
};

struct EpochLane {
    int64_t sc, bal, eff;
};

// One validator lane of the fused pass, in spec order: inactivity-score
// update, flag rewards and penalties gathered from the per-increment
// tables, the score-scaled inactivity penalty, proportional slashings,
// effective-balance hysteresis.  The table index is clamped to [0, k) as
// JAX's gather clamps (the host guard keeps every increment count in
// range).
//
// Division: jnp's // and % floor, C++'s / and % truncate.  They agree here
// because every operand is non-negative: eff * sc with eff >= 0 and a score
// that never drops below zero (each decrement is a min with the score), and
// bal after max(..., 0).  Both are 64-bit divisions by per-launch
// constants: a multiply by a reciprocal worked out once a block measured
// slower at small launches and 2% faster at 2^20 lanes (PERF.md, section 6).
__device__ __forceinline__ EpochLane epoch_lane(
    int k, const EpochTables& t, int32_t incr_count, int64_t bal, int64_t sc, unsigned part,
    bool is_slashed, int64_t activation, int64_t exit_epoch, int64_t wd) {
    const int64_t* params = t.params;
    const int64_t prev = params[P_PREV_EPOCH];
    const int kidx = incr_count < 0 ? 0 : (incr_count >= k ? k - 1 : incr_count);
    const int64_t incr = params[P_INCREMENT];
    const int64_t eff = (int64_t)incr_count * incr;

    const bool active_prev = activation <= prev && prev < exit_epoch;
    const bool eligible = active_prev || (is_slashed && prev + 1 < wd);
    const bool unslashed_active = active_prev && !is_slashed;
    const bool target = unslashed_active && ((part >> TIMELY_TARGET_FLAG_INDEX) & 1u);

    if (params[P_REWARDS] != 0) {
        // inactivity updates
        if (eligible && target) sc -= min64(1, sc);
        if (eligible && !target) sc += params[P_SCORE_BIAS];
        if (params[P_LEAK] == 0 && eligible) sc -= min64(params[P_SCORE_RECOVERY], sc);
        // rewards and penalties
        int64_t delta = 0;
        for (int f = 0; f < 3; ++f) {
            const bool participated = unslashed_active && ((part >> f) & 1u);
            if (eligible && participated) delta += t.reward[f * k + kidx];
            if (f != TIMELY_HEAD_FLAG_INDEX && eligible && !participated)
                delta -= t.penalty[f * k + kidx];
        }
        if (eligible && !target) delta -= (eff * sc) / params[P_INACT_DENOM];
        bal = max64(bal + delta, 0);
    }
    // proportional slashings
    if (is_slashed && wd == params[P_SLASH_TARGET]) bal = max64(bal - t.slash[kidx], 0);
    // effective-balance hysteresis
    EpochLane out{sc, bal, eff};
    if (bal + params[P_HYST_DOWN] < eff || eff + params[P_HYST_UP] < bal)
        out.eff = min64(bal - bal % incr, params[P_MAX_EFF]);
    return out;
}

// Lane i alone, in narrow loads and stores: the head and tail of a launch.
__device__ __forceinline__ void lane_fused_epoch_pass(long long i, int k, const EpochTables& t,
                                                      const EpochCols& c) {
    const EpochLane o = epoch_lane(k, t, c.eff_incr[i], c.balances[i], c.scores[i],
                                   c.prev_part[i], c.slashed[i] != 0, c.activation[i],
                                   c.exit_epoch[i], c.withdrawable[i]);
    c.scores_out[i] = o.sc;
    c.balances_out[i] = o.bal;
    c.eff_out[i] = o.eff;
}

// Lanes a thread takes together.  Two make a warp's 16-byte loads of an
// int64 column contiguous (512 bytes); 4 and 8 measured 15-45% slower
// (PERF.md, section 6).
constexpr int EPOCH_LANES = 2;

// A column's two values at src in one streaming load (evict first: each
// column byte is read once) of 16, 8 or 2 bytes, into registers; src
// aligned to the load's width.
__device__ __forceinline__ void load_pair(int64_t (&dst)[2], const int64_t* src) {
#ifdef __CUDACC__
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
#else
    dst[0] = src[0];
    dst[1] = src[1];
#endif
}

__device__ __forceinline__ void load_pair(int32_t (&dst)[2], const int32_t* src) {
#ifdef __CUDACC__
    const int2 v = __ldcs(reinterpret_cast<const int2*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
#else
    dst[0] = src[0];
    dst[1] = src[1];
#endif
}

__device__ __forceinline__ void load_pair(uint32_t (&dst)[2], const uint8_t* src) {
#ifdef __CUDACC__
    const uint32_t v = __ldcs(reinterpret_cast<const unsigned short*>(src));
    dst[0] = v & 0xff;
    dst[1] = v >> 8;
#else
    dst[0] = src[0];
    dst[1] = src[1];
#endif
}

// Two int64 values to dst in one 16-byte streaming store; dst 16-byte
// aligned.
__device__ __forceinline__ void store_pair(int64_t* dst, const int64_t (&src)[2]) {
#ifdef __CUDACC__
    __stcs(reinterpret_cast<longlong2*>(dst), make_longlong2(src[0], src[1]));
#else
    dst[0] = src[0];
    dst[1] = src[1];
#endif
}

// Lanes i0 and i0 + 1 of the fused pass: every column's two values in one
// load each, all issued before any arithmetic, then the three outputs in
// one 16-byte store each.  Every column's lane i0 is aligned to two
// elements (see epoch_split).
__device__ __forceinline__ void pair_fused_epoch_pass(long long i0, int k, const EpochTables& t,
                                                      const EpochCols& c) {
    int32_t incr[2];
    int64_t bal[2], sc[2], act[2], ex[2], wd[2];
    uint32_t part[2], sl[2];
    load_pair(incr, c.eff_incr + i0);
    load_pair(bal, c.balances + i0);
    load_pair(sc, c.scores + i0);
    load_pair(act, c.activation + i0);
    load_pair(ex, c.exit_epoch + i0);
    load_pair(wd, c.withdrawable + i0);
    load_pair(part, c.prev_part + i0);
    load_pair(sl, c.slashed + i0);
    int64_t o_sc[2], o_bal[2], o_eff[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const EpochLane o = epoch_lane(k, t, incr[j], bal[j], sc[j], part[j], sl[j] != 0, act[j],
                                       ex[j], wd[j]);
        o_sc[j] = o.sc;
        o_bal[j] = o.bal;
        o_eff[j] = o.eff;
    }
    store_pair(c.scores_out + i0, o_sc);
    store_pair(c.balances_out + i0, o_bal);
    store_pair(c.eff_out + i0, o_eff);
}

// How a launch over n lanes splits: lanes [0, head) and [head + 2 * pairs,
// n) run one at a time (lane_fused_epoch_pass), the pairs between them two at
// a time (pair_fused_epoch_pass).  A column's lane phase is its address in
// elements mod 2; where all eleven columns share a phase p, the pairs start
// at lane p, where every column is aligned to two elements (so to 16 bytes
// for the int64 ones).  Columns of unequal phase (views into different
// offsets of their storage) run every lane alone.
struct EpochSplit {
    long long head, pairs;
};

inline EpochSplit epoch_split(long long n, const EpochCols& c) {
    auto phase = [](const void* p, unsigned size) {
        return (long long)((reinterpret_cast<uintptr_t>(p) / size) % EPOCH_LANES);
    };
    const long long ph[] = {
        phase(c.eff_incr, 4), phase(c.balances, 8), phase(c.scores, 8),
        phase(c.prev_part, 1), phase(c.slashed, 1), phase(c.activation, 8),
        phase(c.exit_epoch, 8), phase(c.withdrawable, 8), phase(c.scores_out, 8),
        phase(c.balances_out, 8), phase(c.eff_out, 8)};
    for (long long p : ph)
        if (p != ph[0]) return EpochSplit{n, 0};
    const long long head = ph[0] < n ? ph[0] : n;
    return EpochSplit{head, (n - head) / EPOCH_LANES};
}

// Thread t of a launch of `stride` threads: pairs t, t + stride, ..., then
// the head and tail lanes, one at a time, in the same stride.  PAIRS
// false leaves the pair loop out (a split with no pairs).
template <bool PAIRS>
__device__ __forceinline__ void thread_fused_epoch_pass(long long t, long long stride,
                                                        long long n, const EpochSplit& s, int k,
                                                        const EpochTables& tab,
                                                        const EpochCols& c) {
    if constexpr (PAIRS)
        for (long long g = t; g < s.pairs; g += stride)
            pair_fused_epoch_pass(s.head + g * EPOCH_LANES, k, tab, c);
    const long long body_end = s.head + s.pairs * EPOCH_LANES;
    const long long rest = s.head + (n - body_end);
    for (long long r = t; r < rest; r += stride)
        lane_fused_epoch_pass(r < s.head ? r : body_end + (r - s.head), k, tab, c);
}

#ifndef __CUDACC__
// k_fused_epoch_pass on the host: every thread of a grid of `blocks` x
// `threads` in turn, after the split's check that each pair's loads and
// stores are aligned to their widths.  Returns 0, or -1 if one is not.
inline int host_fused_epoch_pass(long long n, int k, const int64_t* reward,
                                 const int64_t* penalty, const int64_t* slash,
                                 const int64_t* params, const EpochCols& c, long long blocks,
                                 int threads) {
    const EpochSplit s = epoch_split(n, c);
    if (s.pairs) {
        const long long i = s.head;
        auto at = [](const void* p, uintptr_t align) {
            return reinterpret_cast<uintptr_t>(p) % align == 0;
        };
        if (!(at(c.eff_incr + i, 8) && at(c.balances + i, 16) && at(c.scores + i, 16) &&
              at(c.prev_part + i, 2) && at(c.slashed + i, 2) && at(c.activation + i, 16) &&
              at(c.exit_epoch + i, 16) && at(c.withdrawable + i, 16) &&
              at(c.scores_out + i, 16) && at(c.balances_out + i, 16) && at(c.eff_out + i, 16)))
            return -1;
    }
    const EpochTables tab{reward, penalty, slash, params};
    const long long stride = blocks * threads;
    for (long long t = 0; t < stride; ++t)
        thread_fused_epoch_pass<true>(t, stride, n, s, k, tab, c);
    return 0;
}
#endif

// ---- the swap-or-not rounds (k_shuffle_rounds) -----------------------------
// pivots int32[rounds] in [0, count); src uint8[rounds, row_bytes] with
// position p's decision bit of round r at byte p >> 3, bit p & 7 of row r.
// cur and the pivot both lie in [0, count), so jnp.mod(pivot - cur, count)
// is one conditional add.
//
// A round reads half of its row.  A position at or below the pivot pairs
// with flip = pivot - cur, so max(cur, flip) lies in [pivot / 2, pivot]; one
// above it pairs with flip = pivot + count - cur, so max(cur, flip) lies in
// [(pivot + count) / 2, count).  The round's window is those two byte
// ranges, widened to 16-byte bounds (a bulk copy moves multiples of 16),
// laid end to end: at most count / 16 + 80 bytes.  The kernel copies each
// round's window into shared memory and walks round by round; a window that
// one block cannot hold (past about 3.6M positions) is split over a
// cluster of two blocks, slice k of the window in block k.

constexpr int SHUFFLE_THREADS = 512;        // threads a block
constexpr int SHUFFLE_MAX_PER = 32;         // positions a thread
constexpr long long SHUFFLE_SMEM = 225 * 1024;   // dynamic shared memory a block
// the most positions the wrapper takes (a window of 262,224 bytes: two
// slices of one row buffer each)
constexpr long long SHUFFLE_CAPACITY = 1LL << 22;

struct ShuffleWindow {
    uint32_t start_a, len_a;    // the low range's first byte and length
    uint32_t start_b, len_b;    // the high range's; start_b past every byte if empty
};

__device__ __forceinline__ ShuffleWindow shuffle_window(int32_t pivot, int32_t count) {
    ShuffleWindow w;
    w.start_a = ((uint32_t)(pivot + 1) >> 1 >> 3) & ~15u;
    w.len_a = (((uint32_t)pivot >> 3) + 16 & ~15u) - w.start_a;
    if (pivot + 1 < count) {
        w.start_b = ((uint32_t)(((long long)pivot + count + 1) >> 1) >> 3) & ~15u;
        w.len_b = (((uint32_t)(count - 1) >> 3) + 16 & ~15u) - w.start_b;
    } else {
        w.start_b = 0xffffffffu;
        w.len_b = 0;
    }
    return w;
}

// the bound on a window's bytes for `count` positions
inline long long shuffle_window_max(long long count) { return (count / 16 + 80 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t umulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDACC__
    return __umulhi(a, b);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

__device__ __forceinline__ int32_t shuffle_flip(int32_t cur, int32_t pivot, int32_t count) {
    int32_t flip = pivot - cur;
    if (flip < 0) flip += count;
    return flip;
}

// the byte index of the decision bit of the pair (cur, flip)
__device__ __forceinline__ uint32_t shuffle_byte(int32_t cur, int32_t flip) {
    return (uint32_t)(cur > flip ? cur : flip) >> 3;
}

__device__ __forceinline__ int32_t shuffle_pick(int32_t cur, int32_t flip, uint32_t byte) {
    const int32_t position = cur > flip ? cur : flip;
    return ((byte >> (position & 7)) & 1) ? flip : cur;
}

// One round of a thread's positions cur[0, active) in groups of 8: each
// position's decision byte b goes to its window offset, then to (slice,
// offset in the slice) with slices of `slice` bytes (magic = ceil(2^32 /
// (slice / 16)): an exact quotient for windows below 2^19 bytes); each
// group's bytes are fetched (byte(slice, offset)) before the first of them
// is used, so a thread has 8 lookups in flight.
template <int PER, class Fetch>
__device__ __forceinline__ void thread_shuffle_round(int32_t* cur, int active, int32_t pivot,
                                                     int32_t count, const ShuffleWindow& w,
                                                     uint32_t slice, uint32_t magic,
                                                     Fetch byte) {
    constexpr int G = PER < 8 ? PER : 8;
#pragma unroll
    for (int g = 0; g < PER; g += G) {
        uint32_t b[G];
#pragma unroll
        for (int j = 0; j < G; j++) {
            if (g + j < active) {
                const uint32_t at = shuffle_byte(cur[g + j], shuffle_flip(cur[g + j], pivot, count));
                const uint32_t off = at >= w.start_b ? w.len_a + (at - w.start_b) : at - w.start_a;
                const uint32_t k = umulhi32(off >> 4, magic);
                b[j] = byte(k, off - k * slice);
            }
        }
#pragma unroll
        for (int j = 0; j < G; j++)
            if (g + j < active)
                cur[g + j] = shuffle_pick(cur[g + j], shuffle_flip(cur[g + j], pivot, count), b[j]);
    }
}

// The pieces of a round's window that block `rank` holds: window bytes
// [rank * slice, (rank + 1) * slice), as up to two runs of the row (from
// the low range, then from the high one), each (row offset, slice offset,
// bytes), multiples of 16.
struct ShufflePieces {
    uint32_t src[2], dst[2], bytes[2];
};

__device__ __forceinline__ ShufflePieces shuffle_pieces(const ShuffleWindow& w, uint32_t slice,
                                                        uint32_t rank) {
    ShufflePieces p;
    const uint32_t lo = rank * slice, hi = lo + slice, len = w.len_a + w.len_b;
    const uint32_t a_end = hi < w.len_a ? hi : w.len_a;
    p.src[0] = w.start_a + lo;
    p.dst[0] = 0;
    p.bytes[0] = a_end > lo ? a_end - lo : 0;
    const uint32_t b_lo = lo > w.len_a ? lo : w.len_a, b_hi = hi < len ? hi : len;
    p.src[1] = w.start_b + (b_lo - w.len_a);
    p.dst[1] = b_lo - lo;
    p.bytes[1] = b_hi > b_lo ? b_hi - b_lo : 0;
    return p;
}

// How a launch splits the work: clusters of `cluster` blocks of `threads`,
// `stages` row buffers of `slice` bytes a block (two when they fit, so the
// next round's copy overlaps this round's lookups; one cluster of two only
// when one block cannot hold a window); `per_block` consecutive positions a
// block, thread t holding its positions t + j * threads, j < per (a power
// of two, at least the positions a thread has).  cluster: 0 for the
// kernel's own choice (a test may force 2).  max_clusters is what the card
// holds at once: the positions spread over as many clusters as that
// allows (fewer for a short list), and past SHUFFLE_MAX_PER a thread the
// grid grows instead.
struct ShufflePlan {
    long long blocks, per_block;
    int per, cluster, stages;
    uint32_t slice, magic;
};

inline ShufflePlan shuffle_plan(long long count, long long max_clusters, int threads,
                                int cluster = 0) {
    ShufflePlan p;
    const long long window = shuffle_window_max(count);
    if (!cluster) cluster = window <= SHUFFLE_SMEM ? 1 : 2;
    p.cluster = cluster;
    p.slice = (uint32_t)(((window + cluster - 1) / cluster + 15) / 16 * 16);
    p.stages = 2 * (long long)p.slice <= SHUFFLE_SMEM ? 2 : 1;
    p.magic = (uint32_t)(((1ULL << 32) + p.slice / 16 - 1) / (p.slice / 16));
    const long long cluster_span = (long long)cluster * threads;
    long long clusters = (count + cluster_span - 1) / cluster_span;
    if (clusters > max_clusters) clusters = max_clusters;
    if (clusters < 1) clusters = 1;
    p.per_block = (count + clusters * cluster - 1) / (clusters * cluster);
    if (p.per_block > (long long)SHUFFLE_MAX_PER * threads) {
        p.per_block = (long long)SHUFFLE_MAX_PER * threads;
        clusters = (count + cluster_span * SHUFFLE_MAX_PER - 1) / (cluster_span * SHUFFLE_MAX_PER);
    }
    if (p.per_block < 1) p.per_block = 1;
    p.blocks = clusters * cluster;
    p.per = 1;
    while ((long long)p.per * threads < p.per_block) p.per *= 2;
    return p;
}

// the positions a block holds: thread t's first `active` of its `per`
__device__ __forceinline__ int shuffle_active(long long count, long long block,
                                              long long per_block, int t, int threads, int per) {
    long long mine = count - block * per_block;
    if (mine > per_block) mine = per_block;
    int active = 0;
    for (int j = 0; j < per; j++)
        if ((long long)j * threads + t < mine) active = j + 1;
    return active;
}

#ifndef __CUDACC__
// k_shuffle_rounds on the host, cluster by cluster: each round, every
// block's pieces of the window copied into its slice as the kernel's bulk
// copies copy them (the rest of a slice left at a filler byte), then every
// thread of every block of the cluster in turn.  Returns 0, or -1 if a
// window outgrew its slices or a lookup read a byte that no copy wrote.
template <int PER>
inline int host_shuffle_cluster(long long c, const ShufflePlan& p, long long count, int rounds,
                                long long row_bytes, int threads, const int32_t* pivots,
                                const uint8_t* src, int32_t* out) {
    const int cl = p.cluster;
    std::vector<uint8_t> rows((size_t)cl * p.slice);
    std::vector<uint8_t> written((size_t)cl * p.slice);
    std::vector<int32_t> cur((size_t)cl * threads * PER);
    bool stray = false;
    for (int k = 0; k < cl; k++)
        for (int t = 0; t < threads; t++)
            for (int j = 0; j < PER; j++)
                cur[((size_t)k * threads + t) * PER + j] =
                    (int32_t)((c * cl + k) * p.per_block + (long long)j * threads + t);
    auto fetch = [&](uint32_t s, uint32_t off) -> uint32_t {
        if (s >= (uint32_t)cl || off >= p.slice || !written[(size_t)s * p.slice + off]) {
            stray = true;
            return 0;
        }
        return rows[(size_t)s * p.slice + off];
    };
    for (int r = 0; r < rounds; r++) {
        const ShuffleWindow w = shuffle_window(pivots[r], (int32_t)count);
        if ((long long)w.len_a + w.len_b > (long long)cl * p.slice ||
            (long long)w.len_a + w.len_b > shuffle_window_max(count))
            return -1;
        std::fill(rows.begin(), rows.end(), (uint8_t)0xA5);
        std::fill(written.begin(), written.end(), (uint8_t)0);
        for (int k = 0; k < cl; k++) {
            const ShufflePieces pc = shuffle_pieces(w, p.slice, k);
            for (int q = 0; q < 2; q++) {
                if (!pc.bytes[q]) continue;
                if (pc.bytes[q] % 16 || pc.src[q] % 16 || pc.dst[q] % 16 ||
                    (long long)pc.src[q] + pc.bytes[q] > row_bytes ||
                    pc.dst[q] + pc.bytes[q] > p.slice)
                    return -1;
                std::copy_n(src + (long long)r * row_bytes + pc.src[q], pc.bytes[q],
                            rows.begin() + (size_t)k * p.slice + pc.dst[q]);
                std::fill_n(written.begin() + (size_t)k * p.slice + pc.dst[q], pc.bytes[q], 1);
            }
        }
        for (int k = 0; k < cl; k++)
            for (int t = 0; t < threads; t++)
                thread_shuffle_round<PER>(
                    &cur[((size_t)k * threads + t) * PER],
                    shuffle_active(count, c * cl + k, p.per_block, t, threads, PER), pivots[r],
                    (int32_t)count, w, p.slice, p.magic, fetch);
    }
    for (int k = 0; k < cl; k++) {
        const long long b = c * cl + k;
        for (int t = 0; t < threads; t++) {
            const int active = shuffle_active(count, b, p.per_block, t, threads, PER);
            for (int j = 0; j < active; j++)
                out[b * p.per_block + (long long)j * threads + t] =
                    cur[((size_t)k * threads + t) * PER + j];
        }
    }
    return stray ? -1 : 0;
}

// the whole launch on the host, its plan for a card that holds max_clusters
// clusters at once (cluster 0: the kernel's own choice)
inline int host_shuffle_rounds(long long count, int rounds, long long row_bytes,
                               const int32_t* pivots, const uint8_t* src, int32_t* out,
                               long long max_clusters, int threads, int cluster) {
    const ShufflePlan p = shuffle_plan(count, max_clusters, threads, cluster);
    int rc = 0;
    for (long long c = 0; c < p.blocks / p.cluster; c++) {
#define HOST_SHUFFLE_CASE(P)                                                                \
    case P:                                                                                 \
        rc |= host_shuffle_cluster<P>(c, p, count, rounds, row_bytes, threads, pivots, src, \
                                      out);                                                 \
        break;
        switch (p.per) {
            HOST_SHUFFLE_CASE(1)
            HOST_SHUFFLE_CASE(2)
            HOST_SHUFFLE_CASE(4)
            HOST_SHUFFLE_CASE(8)
            HOST_SHUFFLE_CASE(16)
            default: HOST_SHUFFLE_CASE(32)
        }
#undef HOST_SHUFFLE_CASE
    }
    return rc;
}
#endif

}  // namespace epoch
