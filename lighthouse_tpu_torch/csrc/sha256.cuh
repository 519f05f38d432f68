// SHA-256 compression for the kernels of csrc/sha256.cu (sm_90a).
//
// Counterpart of the round function of lighthouse_tpu/ops/sha256.py.  Words
// are uint32 in big-endian SHA order.  Everything a kernel computes per
// lane is a function here, so the same code also compiles as host C++
// (g++ -x c++), which the CPU tests use to check k_sha256_block's lane
// without a card.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

namespace sha {

__constant__ uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

// Message schedule of the padding block of a 64-byte message (0x80, zeros,
// bit length 512): the same for every lane (ops/sha256.py _PAD_W).
__constant__ uint32_t PAD_W[64] = {
    0x80000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000200u, 0x80000000u, 0x01400000u,
    0x00205000u, 0x00005088u, 0x22000800u, 0x22550014u, 0x05089742u, 0xA0000020u,
    0x5A880000u, 0x005C9400u, 0x0016D49Du, 0xFA801F00u, 0xD33225D0u, 0x11675959u,
    0xF6E6BFDAu, 0xB30C1549u, 0x08B2B050u, 0x9D7C4C27u, 0x0CE2A393u, 0x88E6E1EAu,
    0xA52B4335u, 0x67A16F49u, 0xD732016Fu, 0x4EEB2E91u, 0x5DBF55E5u, 0x8EEE2335u,
    0xE2BC5EC2u, 0xA83F4394u, 0x45AD78F7u, 0x36F3D0CDu, 0xD99C05E8u, 0xB0511DC7u,
    0x69BC7AC4u, 0xBD11375Bu, 0xE3BA71E5u, 0x3B209FF2u, 0x18FEEE17u, 0xE25AD9E7u,
    0x13375046u, 0x0515089Du, 0x4F0D0F04u, 0x2627484Eu, 0x310128D2u, 0xC668B434u,
    0x420841CCu, 0x62D311B8u, 0xE59BA771u, 0x85A7A484u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
}

__device__ __forceinline__ void round_step(uint32_t& a, uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e, uint32_t& f,
                                           uint32_t& g, uint32_t& h, uint32_t kw) {
    uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + (g ^ (e & (f ^ g))) + kw;
    uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
}

// One compression of the data block w[0..15] into the chaining state
// st[0..7]: the message schedule is expanded in place in a rolling 16-word
// window, and the feed-forward adds the rounds' result to st.
__device__ __forceinline__ void compress_block(uint32_t st[8], uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        if (t >= 16) {
            uint32_t x = w[(t + 1) & 15], y = w[(t + 14) & 15];
            w[t & 15] += (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(t + 9) & 15]
                       + (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
        }
        round_step(a, b, c, d, e, f, g, h, K[t] + w[t & 15]);
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of one 64-byte message w[0..15] into out[0..7]: the data block,
// then the constant padding block with its precomputed schedule.  The
// compression of the three merkle kernels.
__device__ __forceinline__ void sha256_pair(uint32_t w[16], uint32_t out[8]) {
    uint32_t m[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                     0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    compress_block(m, w);
    uint32_t a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        round_step(a, b, c, d, e, f, g, h, K[t] + PAD_W[t]);
    }
    out[0] = m[0] + a; out[1] = m[1] + b; out[2] = m[2] + c; out[3] = m[3] + d;
    out[4] = m[4] + e; out[5] = m[5] + f; out[6] = m[6] + g; out[7] = m[7] + h;
}

// Lane i of k_sha256_block: out[i] = compress(state[i], block[i]), with
// state uint32[n, 8] and block uint32[n, 16] (one padded message block per
// lane, its schedule computed here, per lane).
__device__ __forceinline__ void lane_sha256_block(long long i, const uint32_t* state,
                                                  const uint32_t* block, uint32_t* out) {
    uint32_t st[8], w[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = state[8 * i + j];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = block[16 * i + j];
    compress_block(st, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[8 * i + j] = st[j];
}

// ---- the whole-tree fold (k_fold_subtrees) -----------------------------------
//
// A pass folds `nodes` nodes (a power of two, at least 2) over a grid of
// blocks: each active thread folds `per` consecutive nodes to their subroot
// alone (fold_serial), then the block folds its threads' subroots: level by
// level in shared memory (fold_pair) until 32 remain, then warp 0 by
// shuffles (fold_step at offsets 1, 2, ..., 16).  With one block that is
// the tree's root; else each block's root is one of the
// pass's block roots, and the last block to finish runs a second pass over
// them.

// the layout of a pass: nodes a thread, active threads a block, blocks
struct FoldShape {
    long long per, threads, blocks;
};

// the first pass over n leaves: 2^log_per leaves a thread (all n when the
// tree is smaller), at most max_threads threads a block
__host__ __device__ __forceinline__ FoldShape fold_shape(long long n, int log_per,
                                                        long long max_threads) {
    const long long per = n < (1LL << log_per) ? n : 1LL << log_per;
    const long long threads = n / per < max_threads ? n / per : max_threads;
    return FoldShape{per, threads, n / (per * threads)};
}

// The leaves a thread for a tree of n leaves, as 2^k: the fastest of
// chip_ab.py's sweep at every width 2^12 to 2^20 (PERF.md): 2 up to 2^16
// leaves, where a fold is the latency of its levels, then twice as many a
// thread for each doubling of the tree, up to 32 from 2^20 on.
__host__ __device__ __forceinline__ int fold_log_per(long long n) {
    int lg = 0;
    while ((2LL << lg) <= n) lg++;
    return lg <= 16 ? 1 : lg >= 20 ? 5 : lg - 15;
}

// the second pass, over a grid's `blocks` block roots in one block of
// `threads` threads: at least 2 roots a thread
__host__ __device__ __forceinline__ FoldShape fold_top_shape(long long blocks,
                                                            long long threads) {
    const long long per = blocks / threads > 2 ? blocks / threads : 2;
    return FoldShape{per, blocks / per, 1};
}

// the most leaves one launch folds to its root: the second pass's threads
// take at most 2^log_per roots each
__host__ __device__ __forceinline__ long long fold_capacity(int log_per,
                                                           long long max_threads) {
    return (max_threads << log_per) * (max_threads << log_per);
}

// Fold `per` consecutive nodes (a power of two, 2 <= per <= 2^K) to their
// subroot h in post-order: pair i of nodes (2i, 2i + 1) is hashed, then
// merged with the left subtrees that the stack holds while the bits of i
// say one waits (level j waits when bit j of i is set).  One hash a step,
// so the compression is inlined once; the stack's entries are selected by
// an unrolled loop (constant register indices).  load(i, w) puts nodes 2i
// and 2i + 1 in w[0..15].
template <int K, class Load>
__device__ __forceinline__ void fold_serial(long long per, Load load, uint32_t h[8]) {
    constexpr int S = K > 1 ? K - 1 : 1;      // left subtrees waiting: at most K - 1
    uint32_t stk[S][8];
    long long i = 0;
    int lvl = -1;                              // >= 0: the next step merges h with stk[lvl]
#pragma unroll 1
    for (long long s = 0; s < per - 1; s++) {
        uint32_t w[16];
        if (lvl < 0) {
            load(i, w);
        } else {
#pragma unroll
            for (int j = 0; j < S; j++)
                if (j == lvl) {
#pragma unroll
                    for (int q = 0; q < 8; q++) w[q] = stk[j][q];
                }
#pragma unroll
            for (int q = 0; q < 8; q++) w[8 + q] = h[q];
        }
        sha256_pair(w, h);
        const int next = lvl + 1;                  // h is a subtree of 2^(next + 1) pairs' level
        if ((i >> next) & 1) {
            lvl = next;
        } else {
#pragma unroll
            for (int j = 0; j < S; j++)
                if (j == next) {
#pragma unroll
                    for (int q = 0; q < 8; q++) stk[j][q] = h[q];
                }
            lvl = -1;
            i++;
        }
    }
}

// nodes left and right (8 words each) -> their parent h
__device__ __forceinline__ void fold_pair(const uint32_t* left, const uint32_t* right,
                                          uint32_t h[8]) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 8; q++) {
        w[q] = left[q];
        w[8 + q] = right[q];
    }
    sha256_pair(w, h);
}

// One level of a warp's fold, at offset `off` (1, 2, 4, ...): lane l with
// l % (2 off) == 0 hashes its node h with lane l + off's (`right`).
__device__ __forceinline__ void fold_step(int lane, int off, uint32_t h[8],
                                          const uint32_t right[8]) {
    if (lane & (2 * off - 1)) return;
    fold_pair(h, right, h);
}

#ifndef __CUDACC__
// One pass of k_fold_subtrees on the host (the CPU tests' model of
// csrc/sha256.cu): each block's threads and levels as loops, the block's
// levels in shared memory until 32 nodes remain, then warp 0's shuffles, a
// lane's shuffle partner read from the level's values (a lane that hashes
// reads one that does not write in that level).  -> a block root each.
template <int K>
inline void host_fold_pass(const uint32_t* src, const FoldShape& sh, uint32_t* roots) {
    std::vector<uint32_t> h(8 * sh.threads), level(8 * sh.threads);
    for (long long b = 0; b < sh.blocks; b++) {
        for (long long t = 0; t < sh.threads; t++) {
            const uint32_t* mine = src + 8 * (b * sh.threads + t) * sh.per;
            fold_serial<K>(sh.per, [&](long long i, uint32_t w[16]) {
                for (int q = 0; q < 16; q++) w[q] = mine[16 * i + q];
            }, &h[8 * t]);
        }
        long long act = sh.threads;
        for (; act > 32; act >>= 1) {
            level = h;
            for (long long j = 0; j < act / 2; j++)
                fold_pair(&level[16 * j], &level[16 * j + 8], &h[8 * j]);
        }
        for (int off = 1; off < act; off <<= 1)
            for (long long l = 0; l + off < act; l++)
                fold_step((int)l, off, &h[8 * l], &h[8 * (l + off)]);
        for (int q = 0; q < 8; q++) roots[8 * b + q] = h[q];
    }
}

// k_fold_subtrees' passes on the host: leaves uint32[n, 8] (n a power of
// two, 2 <= n <= fold_capacity) -> root[8]
template <int K>
inline void host_fold_subtrees(const uint32_t* leaves, long long n, long long max_threads,
                               uint32_t* root) {
    const FoldShape sh = fold_shape(n, K, max_threads);
    std::vector<uint32_t> block_roots(8 * sh.blocks);
    host_fold_pass<K>(leaves, sh, block_roots.data());
    if (sh.blocks == 1) {
        for (int q = 0; q < 8; q++) root[q] = block_roots[q];
        return;
    }
    host_fold_pass<K>(block_roots.data(), fold_top_shape(sh.blocks, sh.threads), root);
}
#endif

}  // namespace sha
