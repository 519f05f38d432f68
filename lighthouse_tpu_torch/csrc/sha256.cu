// SHA-256 merkle kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).  Word layout is the JAX package's: uint32
// big-endian SHA words, carried in torch.int32 storage of the same bits.
//
// Replaces (lighthouse_tpu/ops/sha256.py):
//   hash_pairs_device   (:167)  -> k_hash_pairs      via lh_hash_pairs
//   _fold_levels_device (:196)  -> k_hash_pairs x L  via lh_fold_levels
//   _fold_to_root_jit   (:410)  -> k_fold_subtrees   via lh_fold_subtrees
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
// wgmma and TMA have nothing to offer integer hashing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
    return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void round_step(uint32_t& a, uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e, uint32_t& f,
                                           uint32_t& g, uint32_t& h, uint32_t kw) {
    uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + (g ^ (e & (f ^ g))) + kw;
    uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
}

// SHA-256 of one 64-byte message w[0..15] (big-endian words) into out[0..7]:
// the shared compression of all three kernels.
__device__ __forceinline__ void sha256_pair(uint32_t w[16], uint32_t out[8]) {
    const uint32_t H0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                            0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    uint32_t a = H0[0], b = H0[1], c = H0[2], d = H0[3];
    uint32_t e = H0[4], f = H0[5], g = H0[6], h = H0[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        if (t >= 16) {
            uint32_t x = w[(t + 1) & 15], y = w[(t + 14) & 15];
            w[t & 15] += (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(t + 9) & 15]
                       + (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
        }
        round_step(a, b, c, d, e, f, g, h, K[t] + w[t & 15]);
    }
    uint32_t m[8] = {H0[0] + a, H0[1] + b, H0[2] + c, H0[3] + d,
                     H0[4] + e, H0[5] + f, H0[6] + g, H0[7] + h};
    a = m[0]; b = m[1]; c = m[2]; d = m[3]; e = m[4]; f = m[5]; g = m[6]; h = m[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        round_step(a, b, c, d, e, f, g, h, K[t] + PAD_W[t]);
    }
    out[0] = m[0] + a; out[1] = m[1] + b; out[2] = m[2] + c; out[3] = m[3] + d;
    out[4] = m[4] + e; out[5] = m[5] + f; out[6] = m[6] + g; out[7] = m[7] + h;
}

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
