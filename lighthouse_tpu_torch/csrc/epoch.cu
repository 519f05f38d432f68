// Epoch kernels for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes, lighthouse_tpu_torch/ops/epoch_kernels.py).  The
// per-lane code lives in epoch.cuh.
//
// Replaces (lighthouse_tpu/ops/epoch_kernels.py):
//   _fused_epoch_pass (:101, jitted at :172) -> k_fused_epoch_pass via lh_fused_epoch_pass
//   _shuffle_rounds   (:224, jitted at :250) -> k_shuffle_rounds   via lh_shuffle_rounds
//
// k_fused_epoch_pass: one thread per validator lane.  It reads 46 bytes of
// columns and writes 24 bytes per lane, against a few dozen int64 operations
// and one 64-bit division, so it is bound by device memory (about 70 bytes
// per lane).  The three gather tables and the parameters (7 * k + 11 int64,
// 1,936 bytes for Deneb's k = 33) are copied into shared memory by every
// block, so each lane's gathers hit shared memory, not device memory.
//
// k_shuffle_rounds: one thread per position walks all rounds.  The pivots
// sit in shared memory; the per-round source-byte plane (rounds x count / 8
// bytes, 11.8 MB at 2^20 positions and 90 rounds) is read through L2, which
// holds it whole.  About 10 int32 operations per round and lane against one
// byte load: bound by integer issue.  The rounds of one position are a
// dependent chain; the card hides the load latency with other warps.
//
// Each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "epoch.cuh"

using namespace epoch;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRounds = 256;   // the round number is one byte of the source message

__global__ void __launch_bounds__(kThreads)
k_fused_epoch_pass(long long n, int k, const int64_t* __restrict__ reward,
                   const int64_t* __restrict__ penalty, const int64_t* __restrict__ slash,
                   const int64_t* __restrict__ params, const int32_t* __restrict__ eff_incr,
                   const int64_t* __restrict__ balances, const int64_t* __restrict__ scores,
                   const uint8_t* __restrict__ prev_part, const uint8_t* __restrict__ slashed,
                   const int64_t* __restrict__ activation, const int64_t* __restrict__ exit_epoch,
                   const int64_t* __restrict__ withdrawable, int64_t* __restrict__ scores_out,
                   int64_t* __restrict__ balances_out, int64_t* __restrict__ eff_out) {
    extern __shared__ int64_t tables[];   // reward 3k | penalty 3k | slash k | params
    const int total = 7 * k + N_PARAMS;
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
        int64_t v;
        if (j < 3 * k) v = reward[j];
        else if (j < 6 * k) v = penalty[j - 3 * k];
        else if (j < 7 * k) v = slash[j - 6 * k];
        else v = params[j - 7 * k];
        tables[j] = v;
    }
    __syncthreads();
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n)
        lane_fused_epoch_pass(i, k, tables, tables + 3 * k, tables + 6 * k, tables + 7 * k,
                              eff_incr, balances, scores, prev_part, slashed, activation,
                              exit_epoch, withdrawable, scores_out, balances_out, eff_out);
}

__global__ void __launch_bounds__(kThreads)
k_shuffle_rounds(long long count, int rounds, long long row_bytes,
                 const int32_t* __restrict__ pivots, const uint8_t* __restrict__ src,
                 int32_t* __restrict__ out) {
    __shared__ int32_t piv[kMaxRounds];
    for (int r = threadIdx.x; r < rounds; r += blockDim.x) piv[r] = pivots[r];
    __syncthreads();
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < count) lane_shuffle(i, rounds, (int32_t)count, row_bytes, piv, src, out);
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* lh_epoch_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The fused epoch pass over n lanes with k-entry tables (see epoch.cuh).
int lh_fused_epoch_pass(long long n, int k, const void* reward, const void* penalty,
                        const void* slash, const void* params, const void* eff_incr,
                        const void* balances, const void* scores, const void* prev_part,
                        const void* slashed, const void* activation, const void* exit_epoch,
                        const void* withdrawable, void* scores_out, void* balances_out,
                        void* eff_out, void* stream) {
    const size_t smem = (size_t)(7 * k + N_PARAMS) * sizeof(int64_t);
    if (k < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        k_fused_epoch_pass<<<blocks(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            n, k, static_cast<const int64_t*>(reward), static_cast<const int64_t*>(penalty),
            static_cast<const int64_t*>(slash), static_cast<const int64_t*>(params),
            static_cast<const int32_t*>(eff_incr), static_cast<const int64_t*>(balances),
            static_cast<const int64_t*>(scores), static_cast<const uint8_t*>(prev_part),
            static_cast<const uint8_t*>(slashed), static_cast<const int64_t*>(activation),
            static_cast<const int64_t*>(exit_epoch), static_cast<const int64_t*>(withdrawable),
            static_cast<int64_t*>(scores_out), static_cast<int64_t*>(balances_out),
            static_cast<int64_t*>(eff_out));
    }
    return (int)cudaGetLastError();
}

// All `rounds` swap-or-not rounds for positions [0, count): out int32[count].
int lh_shuffle_rounds(long long count, int rounds, long long row_bytes, const void* pivots,
                      const void* src, void* out, void* stream) {
    if (rounds < 0 || rounds > kMaxRounds || count >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (count > 0) {
        k_shuffle_rounds<<<blocks(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            count, rounds, row_bytes, static_cast<const int32_t*>(pivots),
            static_cast<const uint8_t*>(src), static_cast<int32_t*>(out));
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
