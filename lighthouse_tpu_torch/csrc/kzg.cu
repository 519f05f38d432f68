// Fr kernels of KZG blob verification for sm_90a, bound with ctypes
// (lighthouse_tpu_torch/ops/fr.py).  Field and per-thread pieces live in
// fr.cuh.
//
// Replaces the JAX package's device programs:
//   k_fr_to_mont -> ops/fr.py:332 _TO_MONT_JIT (wrapper fr.fr_to_mont_device)
//   k_fr_eval    -> ops/fr.py:297 _eval_kernel (wrapper fr.eval_device)
//
// k_fr_to_mont: 32 bytes in and 32 out around one Montgomery product an
// element, bound by the bytes it moves (64 an element; its products take
// under half of that time at the card's multiply-add rate).  An element
// moves as two 16-byte streaming loads and two 16-byte streaming stores
// (each byte is read once and written once) where the parent made 32
// one-byte loads and 8 word stores, its byte order reversed in registers;
// a thread takes FR_TO_MONT_PER = 2 elements a block's width apart and
// issues both elements' loads before its first product, on a grid over
// all elements (csrc/fr.cuh thread_fr_to_mont).  Measured against it on
// the card: 4 elements a thread, a grid sized to the card walking the
// elements, the next step's loads before this step's products, and warp-
// contiguous 512-byte accesses through a shared-memory stage were all as
// fast or slower, and the same kernel without its product no faster.
//
// k_fr_eval: one block of T threads per blob (T = W / 16 up to 256), each thread a chunk of the
// domain: running products of the denominators d = z - w_i (Montgomery's
// trick), a product tree over the T chunk products in shared memory with ONE
// divstep inversion at its root (csrc/modinv.cuh), the down-sweep, then each
// thread's inverses and its share of sum f_i * w_i / d_i, a shared-memory
// sum, and thread 0's scale by (z^W - 1)/W.  Bound by its Fr products
// (ops/fr.py eval_muladds).
//
// Design.  The products are register-held PTX carry chains, inlined, and
// the loops run over the chunk with compile-time bounds (eval_blob<CHUNK>),
// so nothing sits in local memory: of a thread's 15 prefix products the
// last 4 stay in registers and 11 in shared memory.  A blob's W prefix
// products (128 KB at W = 4096) cannot all stay on chip for two blobs an SM;
// this split (104 KB of shared memory and at most 128 registers a thread
// for a block of 256) does, so one block's one-thread root inversion and
// narrow tree levels overlap another block's wide phases.  The inversion
// itself is a loop of a few thousand independent limb products where
// Fermat's a^(r-2) was 419 dependent Fr products on thread 0.
// Each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "fr.cuh"

using namespace fr;

namespace {

constexpr int kToMontThreads = 256;
constexpr int kEvalMaxThreads = 256;
constexpr int kEvalMaxChunk = 16;
// blocks of k_fr_eval the register budget is set for on one SM
constexpr int kEvalBlocksPerSM = 2;

__global__ void __launch_bounds__(kToMontThreads)
    k_fr_to_mont(long n, const uint8_t* __restrict__ raw, u32* __restrict__ out) {
    thread_fr_to_mont(blockIdx.x, threadIdx.x, kToMontThreads, n, raw, out);
}

__global__ void __launch_bounds__(kEvalMaxThreads, kEvalBlocksPerSM)
    k_fr_eval(long width, int chunk, const u32* f, const u32* zs, const u32* roots,
              const u32* inv_w, u32* y) {
    extern __shared__ Fr eval_smem[];
    const long b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x;
    switch (chunk) {
        case 16: eval_blob<16>(b, t, T, width, f, zs, roots, inv_w, y, eval_smem); break;
        case 8: eval_blob<8>(b, t, T, width, f, zs, roots, inv_w, y, eval_smem); break;
        case 4: eval_blob<4>(b, t, T, width, f, zs, roots, inv_w, y, eval_smem); break;
        case 2: eval_blob<2>(b, t, T, width, f, zs, roots, inv_w, y, eval_smem); break;
        default: eval_blob<1>(b, t, T, width, f, zs, roots, inv_w, y, eval_smem); break;
    }
}

inline cudaStream_t S(void* s) { return reinterpret_cast<cudaStream_t>(s); }

// the dynamic shared memory of a k_fr_eval block, allowed (above 48 KB only
// with the attribute) and preferred over L1, or 0 for a shape it refuses
size_t eval_prepare(long long width, long long threads, cudaError_t* err) {
    *err = cudaErrorInvalidValue;
    if (threads < 1 || threads > kEvalMaxThreads || (threads & (threads - 1)) ||
        width % threads || width / threads > kEvalMaxChunk ||
        ((width / threads) & (width / threads - 1)))
        return 0;
    const size_t bytes = (size_t)eval_shared_slots(threads, width / threads) * sizeof(Fr);
    if ((*err = cudaFuncSetAttribute(k_fr_eval, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes)) != cudaSuccess ||
        (*err = cudaFuncSetAttribute(k_fr_eval, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
        return 0;
    return bytes;
}

}  // namespace

extern "C" {

// raw: n elements of 32 big-endian bytes; out: Montgomery words [n, 8];
// both 16-byte aligned
int lh_fr_to_mont(const uint8_t* raw, u32* out, long long n, void* stream) {
    if ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(out)) & 15)
        return (int)cudaErrorMisalignedAddress;
    const long long span = (long long)FR_TO_MONT_PER * kToMontThreads;
    if (n > 0)
        k_fr_to_mont<<<(unsigned)((n + span - 1) / span), kToMontThreads, 0, S(stream)>>>(
            n, raw, out);
    return (int)cudaGetLastError();
}

// f [n, width, 8], zs [n, 8], roots [width, 8], inv_w [1, 8] -> y [n, 8];
// threads (a power of two, at most 256) per blob, width / threads a power
// of two up to 16
int lh_fr_eval(const u32* f, const u32* zs, const u32* roots, const u32* inv_w, u32* y,
               long long n, long long width, long long threads, void* stream) {
    cudaError_t err;
    const size_t bytes = eval_prepare(width, threads, &err);
    if (!bytes) return (int)err;
    k_fr_eval<<<(unsigned)n, (unsigned)threads, bytes, S(stream)>>>(
        width, (int)(width / threads), f, zs, roots, inv_w, y);
    return (int)cudaGetLastError();
}

// blocks of k_fr_eval resident on one SM at this shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks
int lh_fr_eval_occupancy(int* blocks, long long width, long long threads, void* stream) {
    (void)stream;
    cudaError_t err;
    const size_t bytes = eval_prepare(width, threads, &err);
    if (!bytes) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k_fr_eval, (int)threads,
                                                              bytes);
}

const char* lh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
