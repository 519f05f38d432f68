// SHA-256 merkle kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).  Word layout is the JAX package's: uint32
// big-endian SHA words, carried in torch.int32 storage of the same bits.
//
// Replaces (lighthouse_tpu/ops/sha256.py):
//   hash_pairs_device   (:167)  -> k_hash_pairs      via lh_hash_pairs
//   _fold_levels_device (:196)  -> k_hash_pairs x L  via lh_fold_levels
//   _fold_to_root_jit   (:410)  -> k_fold_subtrees   via lh_fold_subtrees (one launch)
//   sha256_block        (:157)  -> k_sha256_block    via lh_sha256_block
//
// What bounds them: integer issue.  One 64-byte pair hash is two
// compressions (the data block and the constant padding block) of 64 rounds;
// reckoned in the fewest sm_90 instructions (SHF funnel shift per rotation,
// LOP3 per 3-input logic, IADD3 per 3-term add) that is 14 per round, 10 per
// extended schedule word and 8 per feed-forward: 2 * (64 * 14 + 8) + 48 * 10
// = 2,288 int32 operations against 96 bytes of device memory traffic, i.e.
// ~24 operations per byte.  The design therefore keeps everything in
// registers: one thread per lane, the state and a rolling 16-word schedule
// window fully unrolled into registers, rotations as __funnelshift_r, and
// the padding block's precomputed schedule in __constant__ memory (all lanes
// read the same word each round, which the constant cache broadcasts).
// wgmma and TMA have nothing to offer integer hashing.  The round function,
// the tables and the compressions live in sha256.cuh.
//
// k_sha256_block is one compression of a (chaining state, message block)
// pair per lane: 64 * 14 + 8 + 48 * 10 = 1,384 int32 operations against 128
// bytes (state and block read, state written), ~11 operations per byte, so
// it too is issue-bound.  Its schedule is the lane's own (the shuffle's
// source hashes pad each 37-byte message into its one block on the host).

// k_fold_subtrees (the whole-tree fold, rows 3 and 20) does the same
// hashes as a flat pass over the tree's levels, but its upper levels have
// fewer hashes than the card has threads, and each is a hash's latency
// (about 3 us for a warp alone on an H100, PERF.md).  Its former design (one
// 512-thread block a 1,024-leaf subtree, a barrier a level, then a second
// launch over the subroots) kept whole blocks resident while 256, 128, ...,
// 1 threads worked.  Now each thread folds 2^k consecutive leaves alone
// (fold_serial: a stack of at most k - 1 subroots in registers, one hash a
// step), the block folds its threads' subroots in shared memory level by
// level, thread j hashing nodes 2j and 2j + 1, so that each level's hashes
// fill whole warps, until 32 remain, which warp 0 folds by shuffles; the
// last block to finish (a ticket counter the launcher zeroes on the call's
// stream) folds the block roots in the same launch.  k follows the tree
// (fold_log_per): 2 leaves a thread up to 2^16 leaves, where the fold is
// the latency of its levels, up to 32 at 2^20, where its hashes fill the
// card.  Of the designs timed on an H100 (PERF.md section 6: each warp
// folding its own subroots by shuffles first, with or without staging the
// leaves in shared memory, and the top in a second launch), this one was
// as fast or faster at every width 2^12 to 2^20.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

using namespace sha;

namespace {

__device__ __forceinline__ void load16(const uint32_t* __restrict__ src, uint32_t w[16]) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint4 v = s[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
}

__device__ __forceinline__ void store8(uint32_t* __restrict__ dst, const uint32_t h[8]) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(h[0], h[1], h[2], h[3]);
    d[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// One lane per thread: pairs[i] (16 words) -> out[i] (8 words).
__global__ void k_hash_pairs(const uint32_t* __restrict__ pairs,
                             uint32_t* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t w[16], h[8];
    load16(pairs + 16 * i, w);
    sha256_pair(w, h);
    store8(out + 8 * i, h);
}

// One lane per thread: out[i] = compress(state[i], block[i]).
__global__ void k_sha256_block(const uint32_t* __restrict__ state,
                               const uint32_t* __restrict__ block,
                               uint32_t* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) lane_sha256_block(i, state, block, out);
}

// ---- k_fold_subtrees: a whole tree to its root in one launch ----------------

constexpr int kFoldThreads = 256;   // threads a block (fewer for a tree of fewer leaves)

// two nodes (16 words) from a pass's source: pass 0's leaves through L1,
// the block roots of pass 1 from L2 (other blocks wrote them: no stale L1
// line)
__device__ __forceinline__ void load16_of(const uint32_t* __restrict__ src, uint32_t w[16],
                                          bool l2) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint4 v = l2 ? __ldcg(s + i) : s[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
}

// A pass of fold_serial and the block's fold (sha256.cuh), then the
// grid's top: with one block its root goes to out; else to block_roots,
// and the last block to take a ticket from `counter` (zeroed by the
// launcher on the launch's stream) runs the second pass over them.  Every
// thread of the block reaches every barrier; one past a pass's active ones
// folds nothing.
template <int K>
__global__ void __launch_bounds__(kFoldThreads)
k_fold_subtrees(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ out,
                uint32_t* block_roots, unsigned* counter, long long n) {
    __shared__ uint32_t nodes[kFoldThreads][8];
    __shared__ int last;
    const int tid = threadIdx.x, lane = tid & 31;
    const int width = blockDim.x < 32 ? blockDim.x : 32;
    const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1;
    FoldShape sh = fold_shape(n, K, blockDim.x);
    const uint32_t* src = leaves + 8 * sh.per * sh.threads * blockIdx.x;
#pragma unroll 1
    for (int pass = 0;; pass++) {
        uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (tid < sh.threads) {
            const uint32_t* mine = src + 8 * sh.per * tid;
            fold_serial<K>(sh.per, [&](long long i, uint32_t w[16]) {
                load16_of(mine + 16 * i, w, pass > 0);
            }, h);
        }
        // the block's levels in shared memory until 32 nodes remain
        for (int act = (int)sh.threads; act > 32; act >>= 1) {
            if (tid < act) {
#pragma unroll
                for (int q = 0; q < 8; q++) nodes[tid][q] = h[q];
            }
            __syncthreads();
            if (tid < act / 2) fold_pair(nodes[2 * tid], nodes[2 * tid + 1], h);
            __syncthreads();    // every read of the level before the next one's writes
        }
        // then warp 0's shuffle levels over them
        if (tid < 32) {
            const int lanes = sh.threads < 32 ? (int)sh.threads : 32;
            for (int off = 1; off < lanes; off <<= 1) {
                uint32_t r[8];
#pragma unroll
                for (int q = 0; q < 8; q++) r[q] = __shfl_down_sync(mask, h[q], off);
                fold_step(lane, off, h, r);
            }
        }
        if (pass == 1 || gridDim.x == 1) {
            if (tid == 0) store8(out, h);
            return;
        }
        if (tid == 0) {
            store8(block_roots + 8LL * blockIdx.x, h);
            __threadfence();    // the root is visible before the ticket
            last = atomicAdd(counter, 1u) == gridDim.x - 1;
        }
        __syncthreads();
        if (!last) return;
        sh = fold_top_shape(gridDim.x, blockDim.x);
        src = block_roots;
    }
}

// The fold of n leaves (a power of two, 2 <= n <= fold_capacity) to its
// root in out by k_fold_subtrees<K>; scratch holds 8 words a block root and
// the counter after them.
template <int K>
cudaError_t launch_fold(const uint32_t* leaves, uint32_t* out, uint32_t* scratch, long long n,
                        cudaStream_t stream) {
    if (n < 2 || (n & (n - 1)) || n > fold_capacity(K, kFoldThreads))
        return cudaErrorInvalidValue;
    const FoldShape sh = fold_shape(n, K, kFoldThreads);
    uint32_t* block_roots = nullptr;
    unsigned* counter = nullptr;
    if (sh.blocks > 1) {
        block_roots = scratch;
        counter = reinterpret_cast<unsigned*>(scratch + 8 * sh.blocks);
        cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
        if (e != cudaSuccess) return e;
    }
    k_fold_subtrees<K><<<(unsigned)sh.blocks, (unsigned)sh.threads, 0, stream>>>(
        leaves, out, block_roots, counter, n);
    return cudaGetLastError();
}

constexpr int kPairThreads = 256;

cudaError_t launch_pairs(const uint32_t* pairs, uint32_t* out, long long n,
                         cudaStream_t stream) {
    if (n > 0) {
        long long blocks = (n + kPairThreads - 1) / kPairThreads;
        k_hash_pairs<<<(unsigned)blocks, kPairThreads, 0, stream>>>(pairs, out, n);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lh_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// SHA-256 of n 64-byte messages: pairs uint32[n, 16] -> out uint32[n, 8].
int lh_hash_pairs(const void* pairs, void* out, long long n, void* stream) {
    return (int)launch_pairs(static_cast<const uint32_t*>(pairs),
                             static_cast<uint32_t*>(out), n,
                             static_cast<cudaStream_t>(stream));
}

// One SHA-256 compression per lane: state uint32[n, 8], block uint32[n, 16]
// -> out uint32[n, 8].
int lh_sha256_block(const void* state, const void* block, void* out, long long n,
                    void* stream) {
    if (n > 0) {
        long long blocks = (n + kPairThreads - 1) / kPairThreads;
        k_sha256_block<<<(unsigned)blocks, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(state), static_cast<const uint32_t*>(block),
            static_cast<uint32_t*>(out), n);
    }
    return (int)cudaGetLastError();
}

// Every interior level of a tree of n leaves (n a power of two): leaves
// uint32[n, 8] -> levels uint32[n - 1, 8], level 1 first (n/2 rows), the root
// last.  One launch per level on `stream`, no host synchronisation between.
int lh_fold_levels(const void* leaves, void* levels, long long n, void* stream) {
    const uint32_t* src = static_cast<const uint32_t*>(leaves);
    uint32_t* dst = static_cast<uint32_t*>(levels);
    for (long long m = n / 2; m >= 1; m /= 2) {
        cudaError_t err = launch_pairs(src, dst, m, static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return (int)err;
        src = dst;
        dst += 8 * m;
    }
    return (int)cudaGetLastError();
}

// The whole-tree fold's plan for n leaves: [leaves a thread (fold_log_per),
// threads a block, blocks, the most leaves one launch folds at that many a
// thread] (the wrapper sizes its scratch by the blocks and raises past the
// capacity).
void lh_fold_plan(long long n, long long* plan) {
    const int k = fold_log_per(n);
    const FoldShape sh = fold_shape(n, k, kFoldThreads);
    plan[0] = sh.per;
    plan[1] = sh.threads;
    plan[2] = sh.blocks;
    plan[3] = fold_capacity(k, kFoldThreads);
}

// A tree of n leaves (a power of two, 2 <= n <= the plan's capacity) to its
// root in one launch, 2^fold_log_per(n) leaves a thread, the blocks' levels
// first: leaves uint32[n, 8] -> root uint32[1, 8]; scratch uint32[8 *
// blocks + 1] (the block roots and the last block's counter).
int lh_fold_subtrees(const void* leaves, void* root, void* scratch, long long n, void* stream) {
    const uint32_t* l = static_cast<const uint32_t*>(leaves);
    uint32_t *o = static_cast<uint32_t*>(root), *sc = static_cast<uint32_t*>(scratch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (fold_log_per(n)) {
        case 1: return (int)launch_fold<1>(l, o, sc, n, s);
        case 2: return (int)launch_fold<2>(l, o, sc, n, s);
        case 3: return (int)launch_fold<3>(l, o, sc, n, s);
        case 4: return (int)launch_fold<4>(l, o, sc, n, s);
        default: return (int)launch_fold<5>(l, o, sc, n, s);
    }
}

}  // extern "C"
