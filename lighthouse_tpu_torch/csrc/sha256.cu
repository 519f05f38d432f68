// SHA-256 merkle kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).  Word layout is the JAX package's: uint32
// big-endian SHA words, carried in torch.int32 storage of the same bits.
//
// Replaces (lighthouse_tpu/ops/sha256.py):
//   hash_pairs_device   (:167)  -> k_hash_pairs      via lh_hash_pairs
//   _fold_levels_device (:196)  -> k_hash_pairs x L  via lh_fold_levels
//   _fold_to_root_jit   (:410)  -> k_fold_subtrees   via lh_fold_subtrees
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

constexpr int kMaxFoldThreads = 512;

// Each block folds one subtree of 2 * blockDim.x leaves to its root: the
// first level reads the pairs from device memory, every later level stays in
// shared memory, with a barrier between levels.  The caller repeats the
// launch over the subroots until one node is left.
__global__ void __launch_bounds__(kMaxFoldThreads)
k_fold_subtrees(const uint32_t* __restrict__ leaves, uint32_t* __restrict__ roots) {
    extern __shared__ uint32_t level[];  // blockDim.x rows of 8 words
    const int tid = threadIdx.x;
    uint32_t w[16], h[8];
    load16(leaves + (16LL * blockDim.x) * blockIdx.x + 16 * tid, w);
    sha256_pair(w, h);
    for (int m = blockDim.x >> 1; m >= 1; m >>= 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) level[8 * tid + j] = h[j];
        __syncthreads();
        if (tid < m) {
#pragma unroll
            for (int j = 0; j < 16; ++j) w[j] = level[16 * tid + j];
        }
        __syncthreads();  // every read of this level is done before the next write
        if (tid < m) sha256_pair(w, h);
    }
    if (tid == 0) store8(roots + 8LL * blockIdx.x, h);
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

// One pass of the whole-tree fold: n_blocks subtrees of `width` leaves each
// (width a power of two, 2 <= width <= 1024) -> n_blocks subroots.
int lh_fold_subtrees(const void* leaves, void* roots, long long n_blocks,
                     int width, void* stream) {
    if (width < 2 || width > 2 * kMaxFoldThreads || (width & (width - 1)))
        return (int)cudaErrorInvalidValue;
    if (n_blocks > 0) {
        int threads = width / 2;
        k_fold_subtrees<<<(unsigned)n_blocks, threads, threads * 8 * sizeof(uint32_t),
                          static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(leaves), static_cast<uint32_t*>(roots));
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
