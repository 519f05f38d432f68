// Fr kernels of KZG blob verification for sm_90a, bound with ctypes
// (lighthouse_tpu_torch/ops/fr.py).  Field and per-thread pieces live in
// fr.cuh.
//
// Replaces the JAX package's device programs:
//   k_fr_to_mont -> ops/fr.py:332 _TO_MONT_JIT (wrapper fr.fr_to_mont_device)
//   k_fr_eval    -> ops/fr.py:297 _eval_kernel (wrapper fr.eval_device)
//
// k_fr_to_mont: one element per thread, 32 bytes in and 32 out around one
// Montgomery product; bound by the bytes it moves.  k_fr_eval: one block of
// T threads per blob (T = W / 16 up to 256), each thread a chunk of the
// domain: running products of the denominators d = z - w_i (Montgomery's
// trick), a product tree over the T chunk products in shared memory with ONE
// Fermat inversion at its root, the down-sweep, then each thread's inverses
// and its share of sum f_i * w_i / d_i, a shared-memory sum, and thread 0's
// scale by (z^W - 1)/W.  Bound by its Fr products (ops/fr.py eval_fr_muls).
// Each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "fr.cuh"

using namespace fr;

namespace {

constexpr int kBlock = 256;
constexpr int kEvalMaxThreads = 256;
constexpr int kEvalMaxChunk = 16;

__global__ void k_fr_to_mont(long n, const uint8_t* raw, u32* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_fr_to_mont(i, raw, out);
}

__global__ void k_fr_eval(long width, int chunk, const u32* f, const u32* zs, const u32* roots,
                          const u32* inv_w, u32* y) {
    __shared__ Fr tree[2 * kEvalMaxThreads];
    Fr pre[kEvalMaxChunk];
    const long b = blockIdx.x;
    const int t = threadIdx.x;
    const int T = blockDim.x;
    const long lo = (long)t * chunk;
    const u32* f_row = f + (size_t)b * width * 8;
    Fr z;
    ld(z, zs, b);
    Fr prod;
    eval_leaf(prod, pre, z, roots, lo, chunk);
    tree[T + t] = prod;
    __syncthreads();
    for (int k = T / 2; k >= 1; k >>= 1) {
        if (t < k) eval_up(tree, k + t);
        __syncthreads();
    }
    if (t == 0) eval_root(tree);
    __syncthreads();
    for (int k = 1; k < T; k <<= 1) {
        if (t < k) eval_down(tree, k + t);
        __syncthreads();
    }
    Fr sum;
    eval_terms(sum, pre, tree[T + t], z, f_row, roots, lo, chunk);
    tree[T + t] = sum;          // only thread t reads or writes slot T + t here
    __syncthreads();
    for (int k = T / 2; k >= 1; k >>= 1) {
        if (t < k) fr_add(tree[T + t], tree[T + t], tree[T + t + k]);
        __syncthreads();
    }
    if (t == 0) {
        Fr iw, out;
        ld(iw, inv_w, 0);
        eval_scale(out, tree[T], z, iw, width);
        st(y, b, out);
    }
}

inline cudaStream_t S(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// raw: n elements of 32 big-endian bytes; out: Montgomery words [n, 8]
int lh_fr_to_mont(const uint8_t* raw, u32* out, long long n, void* stream) {
    k_fr_to_mont<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, S(stream)>>>(n, raw, out);
    return (int)cudaGetLastError();
}

// f [n, width, 8], zs [n, 8], roots [width, 8], inv_w [1, 8] -> y [n, 8];
// threads (a power of two, at most 256) per blob, width / threads <= 16
int lh_fr_eval(const u32* f, const u32* zs, const u32* roots, const u32* inv_w, u32* y,
               long long n, long long width, long long threads, void* stream) {
    if (threads < 1 || threads > kEvalMaxThreads || (threads & (threads - 1)) ||
        width % threads || width / threads > kEvalMaxChunk)
        return (int)cudaErrorInvalidValue;
    k_fr_eval<<<(unsigned)n, (unsigned)threads, 0, S(stream)>>>(width, (int)(width / threads), f,
                                                                zs, roots, inv_w, y);
    return (int)cudaGetLastError();
}

const char* lh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
