// Epoch kernels for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes, lighthouse_tpu_torch/ops/epoch_kernels.py).  The
// per-lane code lives in epoch.cuh.
//
// Replaces (lighthouse_tpu/ops/epoch_kernels.py):
//   _fused_epoch_pass (:101, jitted at :172) -> k_fused_epoch_pass via lh_fused_epoch_pass
//   _shuffle_rounds   (:224, jitted at :250) -> k_shuffle_rounds   via lh_shuffle_rounds
//
// k_fused_epoch_pass: bound by device memory.  A lane reads 46 bytes of
// columns and writes 24 (70 bytes) against a few dozen int64 operations and
// two 64-bit divisions by per-launch constants.  The parent ran a thread a
// lane in 4,096 blocks of 256 at 2^20 lanes, each staging the tables (7 k +
// 11 int64, 1,936 bytes at k = 33) behind a barrier, each thread making
// nine narrow loads (1, 4 and 8 bytes).  Above half the L2's worth of
// columns a grid of the card's SMs times the blocks resident on one stages
// the tables once a block and walks the lanes two a thread: each column's
// pair in one streaming load (16 bytes for an int64 column, so a warp's
// loads are 512 contiguous bytes), all issued before the arithmetic, and
// each output pair in one 16-byte streaming store (epoch.cuh
// pair_fused_epoch_pass).  Any count and any offset: the lane before the
// columns' first even-aligned lane and the last odd one run alone in the
// same launch (epoch_split), and columns whose offsets disagree run every
// lane alone.  Below half the L2 (a mesh shard, whose columns may still be
// in it from their upload) every lane runs alone, a thread a lane, the
// launch latency-bound.  Four and eight lanes a thread, a reciprocal
// multiply in place of the divisions, and cached pairs at 2^20 lanes all
// measured slower (PERF.md, section 6).
//
// k_shuffle_rounds: every round of every position, round by round.  One
// byte load per round and position at a data-dependent address.  Read
// through L2 (the parent's design: a thread per position walking all
// rounds), each load is a 32-byte sector request that uses 1 byte, 2.7 GB of
// requests for the 10.6 MB plane at 944,080 positions: the L2's request
// rate set its time (the same kernel reading every round from one cached
// row took a fifth of it).  Here a block's positions stay in registers (up
// to SHUFFLE_MAX_PER a thread) and each round's window, the half of its row
// that the round can read (csrc/epoch.cuh shuffle_window: 59 KB at 944,080
// positions), is copied into shared memory by bulk copies (cp.async.bulk,
// completing on an mbarrier), so every lookup reads on-chip memory.  Two
// row buffers a block where they fit (to about 1.8M positions), so the next
// round's copy runs under this round's lookups; one above that; past one
// block's 225 KB (about 3.6M positions) the window is split over a cluster
// of two blocks and a lookup may read the other block's half over the
// SM-to-SM network (mapa, ld.shared::cluster).  Splitting at every size, as
// clusters of 2, 4 and 8, measured slower than the parent: a scattered
// one-byte remote read costs several cycles of its SM.  A block barrier a
// round frees the buffer the next copy overwrites (a cluster barrier, and
// one more after the copy lands, when split).  Bound: the copies, a
// window a block a round from L2, under the lookups' shared-memory reads.
//
// Each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "epoch.cuh"

using namespace epoch;

namespace {

constexpr int kThreads = 256;
constexpr long long kEpochBytesPerLane = 70;   // 46 read, 24 written
constexpr int kMaxRounds = 256;   // the round number is one byte of the source message

// PAIRS false: every lane alone (split.pairs is 0); an instantiation of its
// own, so that its registers, and with them its blocks resident an SM, are
// the lane loop's alone
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads)
k_fused_epoch_pass(long long n, EpochSplit split, int k, const int64_t* __restrict__ reward,
                   const int64_t* __restrict__ penalty, const int64_t* __restrict__ slash,
                   const int64_t* __restrict__ params, EpochCols cols) {
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
    const EpochTables tab{tables, tables + 3 * k, tables + 6 * k, tables + 7 * k};
    thread_fused_epoch_pass<PAIRS>(blockIdx.x * (long long)blockDim.x + threadIdx.x,
                                   (long long)gridDim.x * blockDim.x, n, split, k, tab, cols);
}

constexpr int kMaxStages = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Thread 0: this block's pieces of row r's window into the stage buffer at
// buf, completing on the stage's barrier (a plain arrival if it holds none)
__device__ __forceinline__ void copy_window(uint32_t buf, uint32_t bar, const uint8_t* row,
                                            const ShufflePieces& pc) {
    const uint32_t bytes = pc.bytes[0] + pc.bytes[1];
    if (!bytes) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
        return;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    for (int q = 0; q < 2; q++)
        if (pc.bytes[q])
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                         "[%0], [%1], %2, [%3];"
                         :: "r"(buf + pc.dst[q]), "l"(row + pc.src[q]), "r"(pc.bytes[q]),
                            "r"(bar)
                         : "memory");
}

// byte `local` (a shared address of this block's layout) of block `rank`
__device__ __forceinline__ uint32_t ld_cluster_u8(uint32_t local, uint32_t rank) {
    uint32_t remote, v;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("ld.shared::cluster.u8 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
    return v;
}

// A block of k_shuffle_rounds at PER positions a thread (csrc/epoch.cuh
// shuffle_plan), on the kernel's shared memory: `stages` row buffers of
// `slice` bytes, their barriers and the pivots.  CLUSTERED: the window is
// split over a cluster and a lookup may read another block's slice.  Every
// block of the cluster reaches every barrier.
template <int PER, bool CLUSTERED>
__device__ __forceinline__ void shuffle_block(long long count, int rounds, long long row_bytes,
                                              long long per_block, int stages, uint32_t slice,
                                              uint32_t magic, const int32_t* __restrict__ pivots,
                                              const uint8_t* __restrict__ src,
                                              int32_t* __restrict__ out, uint8_t* rows,
                                              uint64_t* full, int32_t* piv) {
    const int t = threadIdx.x, T = blockDim.x;
    uint32_t rank = 0;
    if (CLUSTERED) asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    const uint32_t rows0 = smem_addr(rows), bar0 = smem_addr(full);
    const int32_t n = (int32_t)count;
    for (int r = t; r < rounds; r += T) piv[r] = pivots[r];
    if (t == 0) {
        for (int s = 0; s < stages; s++)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0 + 8 * s) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    const long long first = (long long)blockIdx.x * per_block + t;
    const int active = shuffle_active(count, blockIdx.x, per_block, t, T, PER);
    int32_t cur[PER];
#pragma unroll
    for (int j = 0; j < PER; j++) cur[j] = (int32_t)(first + (long long)j * T);
    auto sync_all = [] {
        if (CLUSTERED) cluster_sync();
        else __syncthreads();
    };
    auto issue = [&](int r) {
        const int s = r % stages;
        copy_window(rows0 + s * slice, bar0 + 8 * s, src + r * row_bytes,
                    shuffle_pieces(shuffle_window(piv[r], n), slice, rank));
    };
    sync_all();     // barriers ready, pivots staged, every block of the cluster running
    if (t == 0)
        for (int r = 0; r < stages - 1 && r < rounds; r++) issue(r);
#pragma unroll 1
    for (int r = 0; r < rounds; r++) {
        const int s = r % stages;
        if (r > 0) sync_all();      // every block done with round r - 1: its buffer is free
        if (t == 0 && r + stages - 1 < rounds) issue(r + stages - 1);
        bar_wait(bar0 + 8 * s, (uint32_t)(r / stages) & 1);
        if (CLUSTERED) cluster_sync();      // every slice of row r's window is in
        const ShuffleWindow w = shuffle_window(piv[r], n);
        if (CLUSTERED) {
            const uint32_t base = rows0 + s * slice;
            thread_shuffle_round<PER>(cur, active, piv[r], n, w, slice, magic,
                                      [base](uint32_t k, uint32_t off) {
                                          return ld_cluster_u8(base + off, k);
                                      });
        } else {
            const uint8_t* base = rows + s * slice;
            thread_shuffle_round<PER>(cur, active, piv[r], n, w, slice, magic,
                                      [base](uint32_t, uint32_t off) {
                                          return (uint32_t)base[off];
                                      });
        }
    }
    if (CLUSTERED) cluster_sync();  // no block leaves while another reads its slices
#pragma unroll
    for (int j = 0; j < PER; j++)
        if (j < active) out[first + (long long)j * T] = cur[j];
}

__global__ void __launch_bounds__(SHUFFLE_THREADS)
k_shuffle_rounds(long long count, int rounds, long long row_bytes, long long per_block,
                 int per, int cluster, int stages, uint32_t slice, uint32_t magic,
                 const int32_t* __restrict__ pivots, const uint8_t* __restrict__ src,
                 int32_t* __restrict__ out) {
    extern __shared__ __align__(128) uint8_t rows[];
    __shared__ __align__(8) uint64_t full[kMaxStages];
    __shared__ int32_t piv[kMaxRounds];
#define SHUFFLE_CASE(P)                                                                     \
    case P:                                                                                 \
        if (cluster > 1)                                                                    \
            shuffle_block<P, true>(count, rounds, row_bytes, per_block, stages, slice, magic, \
                                   pivots, src, out, rows, full, piv);                      \
        else                                                                                \
            shuffle_block<P, false>(count, rounds, row_bytes, per_block, stages, slice,     \
                                    magic, pivots, src, out, rows, full, piv);              \
        break;
    switch (per) {
        SHUFFLE_CASE(1)
        SHUFFLE_CASE(2)
        SHUFFLE_CASE(4)
        SHUFFLE_CASE(8)
        SHUFFLE_CASE(16)
        SHUFFLE_CASE(32)
    }
#undef SHUFFLE_CASE
}

// k_shuffle_rounds over `count` positions by shuffle_plan
cudaError_t launch_shuffle(long long count, int rounds, long long row_bytes, const void* pivots,
                           const void* src, void* out, cudaStream_t stream) {
    if (rounds < 0 || rounds > kMaxRounds || count < 0 || row_bytes * 8 < count ||
        count > SHUFFLE_CAPACITY || (row_bytes & 15) || (reinterpret_cast<uintptr_t>(src) & 15))
        return cudaErrorInvalidValue;
    if (count == 0) return cudaGetLastError();
    static bool attr[64];
    int dev = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (dev >= 64 || !attr[dev]) {
        if ((err = cudaFuncSetAttribute(k_shuffle_rounds,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)SHUFFLE_SMEM)) != cudaSuccess)
            return err;
        if (dev < 64) attr[dev] = true;
    }
    ShufflePlan plan = shuffle_plan(count, 1, SHUFFLE_THREADS);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = plan.cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    cfg.blockDim = dim3(SHUFFLE_THREADS);
    cfg.gridDim = dim3(plan.cluster);
    cfg.dynamicSmemBytes = (size_t)plan.stages * plan.slice;
    cfg.stream = stream;
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, k_shuffle_rounds, &cfg)) != cudaSuccess)
        return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    plan = shuffle_plan(count, clusters, SHUFFLE_THREADS);
    cfg.gridDim = dim3((unsigned)plan.blocks);
    if ((err = cudaLaunchKernelEx(&cfg, k_shuffle_rounds, count, rounds, row_bytes,
                                  plan.per_block, plan.per, plan.cluster, plan.stages,
                                  plan.slice, plan.magic, static_cast<const int32_t*>(pivots),
                                  static_cast<const uint8_t*>(src),
                                  static_cast<int32_t*>(out))) != cudaSuccess)
        return err;
    return cudaGetLastError();
}

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
    if (n <= 0) return (int)cudaGetLastError();
    // the card's L2 and the grid (the SMs times the blocks resident on one),
    // once a device and table size
    static int l2[64], grid[64], grid_smem[64];
    int dev = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (grid_smem[dev] != (int)smem) {
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess ||
            (err = cudaDeviceGetAttribute(&l2[dev], cudaDevAttrL2CacheSize, dev)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, k_fused_epoch_pass<true>, kThreads, smem)) != cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        grid[dev] = sms * per_sm;
        grid_smem[dev] = (int)smem;
    }
    const EpochCols cols{static_cast<const int32_t*>(eff_incr),
                         static_cast<const int64_t*>(balances),
                         static_cast<const int64_t*>(scores),
                         static_cast<const uint8_t*>(prev_part),
                         static_cast<const uint8_t*>(slashed),
                         static_cast<const int64_t*>(activation),
                         static_cast<const int64_t*>(exit_epoch),
                         static_cast<const int64_t*>(withdrawable),
                         static_cast<int64_t*>(scores_out),
                         static_cast<int64_t*>(balances_out),
                         static_cast<int64_t*>(eff_out)};
    const auto* rw = static_cast<const int64_t*>(reward);
    const auto* pn = static_cast<const int64_t*>(penalty);
    const auto* sl = static_cast<const int64_t*>(slash);
    const auto* pr = static_cast<const int64_t*>(params);
    const auto st = static_cast<cudaStream_t>(stream);
    // columns that fit half the L2 (a mesh shard) may still be there from
    // their upload: every lane alone, a thread a lane, as many blocks as
    // that takes; above that, streamed pairs on a grid the card holds
    if (n * kEpochBytesPerLane <= l2[dev] / 2) {
        k_fused_epoch_pass<false><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, smem,
                                    st>>>(n, EpochSplit{n, 0}, k, rw, pn, sl, pr, cols);
    } else {
        const EpochSplit split = epoch_split(n, cols);
        const long long rest = n - split.pairs * EPOCH_LANES;
        const long long work = split.pairs > rest ? split.pairs : rest;
        long long blocks = (work + kThreads - 1) / kThreads;
        if (blocks > grid[dev]) blocks = grid[dev];
        k_fused_epoch_pass<true><<<(unsigned)blocks, kThreads, smem, st>>>(n, split, k, rw, pn,
                                                                             sl, pr, cols);
    }
    return (int)cudaGetLastError();
}

// All `rounds` swap-or-not rounds for positions [0, count): out int32[count];
// count at most SHUFFLE_CAPACITY, src and row_bytes 16-byte aligned.
int lh_shuffle_rounds(long long count, int rounds, long long row_bytes, const void* pivots,
                      const void* src, void* out, void* stream) {
    return (int)launch_shuffle(count, rounds, row_bytes, pivots, src, out,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
