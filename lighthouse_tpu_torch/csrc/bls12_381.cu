// BLS12-381 batch-verify kernels for sm_90a, bound with ctypes
// (lighthouse_tpu_torch/ops/bls_cuda.py).  Field, tower, curve, the tapes
// and the per-lane routines live in bls12_381.cuh.
//
// Replaces the JAX package's device programs on the verify path:
//   lh_gj_scalar_mul + lh_g1/g2_add_halves + lh_miller + lh_fq12_mul_halves
//       -> ops/bls_backend.py:124 _pipeline_fused (wrapper
//          bls_backend.pipeline_device)
//   lh_g2_subgroup      -> ops/bls_backend.py:175 _g2_subgroup_kernel (wrapper
//                          bls_backend.g2_subgroup_device): group lanes of 16
//   lh_g1_add_halves + lh_blinded_final
//                       -> ops/msm.py:143 _blinded_fold
//   lh_fq12_mul         -> ops/dispatch_pipeline.py:162 _fq12_mul_pair
//   lh_g1_scalar_mul + lh_g1_add_halves
//                       -> ops/msm.py:115 _fold_kernel (wrapper msm.fold_device)
//   lh_miller + lh_fq12_mul_halves
//                       -> ops/bls12_381.py:779 _miller_reduce_jit (wrapper
//                          bls12_381.miller_reduce_device)
//   lh_g1_scalar_mul + lh_g1_add_halves + lh_miller + lh_fq12_mul_halves
//                       -> crypto/kzg.py:437 _kzg_fused (wrapper
//                          kzg.kzg_fused_device)
//   lh_g1_gather_scalar_mul + lh_g1_add_halves + lh_g1_affine
//                       -> ops/msm.py:127 _gather_fold (wrapper
//                          msm.gather_fold_device)
//   lh_g1_subgroup      -> ops/bls_backend.py:207 _g1_subgroup_kernel (wrapper
//                          bls_backend.g1_subgroup_device): Scott's sigma test,
//                          group lanes of 4
//   lh_final_exp_hard   -> ops/bls_backend.py:395 _final_exp_hard_jit over
//                          ops/bls12_381.py:702 final_exp_hard_device (wrapper
//                          bls12_381.final_exp_hard_device): the whole x-ladder
//                          in one launch, a warp a lane
//
// Bound: 32-bit integer multiply-adds.  Every Fp product is a 12-word CIOS
// Montgomery multiply (2*12^2 + 12 multiply-adds); the data moved is a few
// hundred bytes per lane against thousands of products, so no kernel is
// near the memory bound.  No kernel computes a product that it then
// discards: an add with an infinity side, a product by one and the add
// steps on clear bits of |x| are skipped (ops/bls_cuda.py counts the
// products that remain).
//
// Design.  A lane's products mostly do not depend on each other, and the
// lanes are few (the block batch has 132 Miller lanes, the KZG check 2, the
// final exponentiation 1), so one thread a lane leaves the card idle.  The
// scalar multiplications, the Miller loop, the Fq12 product tree, the psi
// check and the final exponentiation's hard part give each lane a group of
// threads (a warp; 16 threads for the psi check, two lanes a warp; 4
// threads for the G1 scalar multiplication and membership): the lane's
// state (window
// table and accumulator; f, T and the Miller constants; T and the base;
// the ladder's Fq12 values) lives in dynamic shared memory, and each step
// runs from a tape of levels, thread t of the group taking positions t,
// t + width, ... of a level (csrc/bls12_381.cuh).  A block is one warp; a
// Miller, joint scalar-multiplication or final-exponentiation lane is one
// block, so that 132 lanes reach 132 SMs.  The tapes are built on the host
// (csrc/bls_tapes.cc, the code the CPU tests run), copied to each device
// before its first group launch, and staged by each block in shared memory
// after its lanes' workspaces.  The G1 membership check (row 12) was a
// 255-bit [r-1]P scan of one thread a lane in 64-thread blocks: 3,234
// dependent products, each a product's latency, on 64 of the 132 SMs
// (5.38 ms at 4,096 lanes).  It is now Scott's sigma test (bls12_381.cuh
// lane_g1_subgroup: two 64-bit scans, 1,025 products) as a group of 4
// threads a lane over the G1 membership tapes, 8 lanes a warp-sized block,
// so the trusted setup's 4,096 lanes fill 512 warps on all SMs.  What
// bounds it is still latency: about one warp a scheduler, each running 431
// product rounds and 1,256 linear rows a lane one after another.  Making
// the second scan's base affine (one thread's divstep inversion, then the
// mixed add) measured about 1% slower on an H100 (PERF.md), so the second
// scan keeps the full add.  The segment, G2 and affine steps run one
// thread a lane, with the same register-held Fp product; the trees launch
// once per level, each thread or group combining rows i and i + half in
// place.  The blinded fold's tree stops at 32 rows a segment: its tail
// (k_blinded_final) folds them a warp a segment in shared memory, 8 groups
// of 4 threads over the G1 add's tape, adds the blinding total and inverts
// Z by divsteps (csrc/modinv.cuh: about 4,300 multiply-adds in batches of
// independent limb products, where Fermat's a^(p-2) was a chain of 610
// dependent Fp products on one thread).  Each launcher returns
// cudaGetLastError() of its launch, or the error of the tapes' copy.

#include <cuda_runtime.h>

#include <cstring>
#include <mutex>

#include "bls12_381.cuh"

using namespace bls;

namespace {

constexpr int kBlock = 64;
// the group kernels have no valid tapes (see lh_set_tapes)
constexpr int kErrTapes = 10001;

inline unsigned blocks(long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

__device__ Tapes g_tapes;

extern __shared__ Fp lh_smem[];

// the tapes a group kernel runs: operations [op0, op0 + nops), levels
// [lv0, lv0 + nlv)
struct Span {
    int op0, nops, lv0, nlv;
};

// the block's copy of a span's operations and level starts, in shared
// memory at `at` (after the lanes' workspaces)
__device__ __forceinline__ TapeView stage(const Span& sp, Fp* at) {
    Op* ops = reinterpret_cast<Op*>(at);
    uint16_t* ls = reinterpret_cast<uint16_t*>(ops + sp.nops);
    for (int i = threadIdx.x; i < sp.nops; i += blockDim.x) ops[i] = g_tapes.ops[sp.op0 + i];
    for (int i = threadIdx.x; i <= sp.nlv; i += blockDim.x)
        ls[i] = (uint16_t)(g_tapes.level_start[sp.lv0 + i] - sp.op0);
    __syncthreads();
    return TapeView{ops, ls, sp.lv0, g_tapes.info};
}

// the calling thread's group of W in a warp-sized block, and its lane's
// index in the block
template <int W> __device__ __forceinline__ Grp group(int& lane) {
    Grp g;
    g.t = threadIdx.x % W;
    g.mask = W == 32 ? 0xffffffffu : ((1u << (W % 32)) - 1) << (threadIdx.x % 32 / W * W);
    lane = threadIdx.x / W;
    return g;
}

__global__ void k_gj_scalar_mul(long n, int n_digits, const u32* pkx, const u32* pky,
                                const u32* sx, const u32* sy, const int32_t* digits, u32* PX,
                                u32* PY, u32* PZ, u32* SX, u32* SY, u32* SZ, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / GJ_W) * GJ_WS);
    int lane;
    Grp g = group<GJ_W>(lane);
    long i = (long)blockIdx.x * (32 / GJ_W) + lane;
    if (i < n)
        lane_scalar_mul<GJ_W, true>(g, tv, lh_smem + lane * GJ_WS, i, n, n_digits, pkx, pky, i,
                                    sx, sy, digits, PX, PY, PZ, SX, SY, SZ);
}

__global__ void k_g1_scalar_mul(long n, int n_digits, const u32* xs, const u32* ys,
                                const int32_t* digits, u32* X, u32* Y, u32* Z, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / G1_W) * G1_WS);
    int lane;
    Grp g = group<G1_W>(lane);
    long i = (long)blockIdx.x * (32 / G1_W) + lane;
    if (i < n)
        lane_scalar_mul<G1_W, false>(g, tv, lh_smem + lane * G1_WS, i, n, n_digits, xs, ys, i,
                                     nullptr, nullptr, digits, X, Y, Z, nullptr, nullptr, nullptr);
}

__global__ void k_g1_gather_scalar_mul(long n, int n_digits, const u32* tx, const u32* ty,
                                       const int32_t* idx, const int32_t* digits, u32* X,
                                       u32* Y, u32* Z, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / G1_W) * G1_WS);
    int lane;
    Grp g = group<G1_W>(lane);
    long i = (long)blockIdx.x * (32 / G1_W) + lane;
    if (i < n)
        lane_scalar_mul<G1_W, false>(g, tv, lh_smem + lane * G1_WS, i, n, n_digits, tx, ty,
                                     (long)idx[i], nullptr, nullptr, digits, X, Y, Z, nullptr,
                                     nullptr, nullptr);
}

__global__ void k_miller(long n, long n_out, long sum_lane, const u32* xp, const u32* yp,
                         const u32* zp, const u32* xq, const u32* yq, const u32* zq,
                         const uint8_t* mask, u32* out, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / MILLER_W) * MILLER_WS);
    int lane;
    Grp g = group<MILLER_W>(lane);
    long i = (long)blockIdx.x * (32 / MILLER_W) + lane;
    if (i < n_out)
        lane_miller<MILLER_W>(g, tv, lh_smem + lane * MILLER_WS, i, n, sum_lane, xp, yp, zp, xq,
                              yq, zq, mask, out);
}

__global__ void k_fq12_mul_halves(long half, u32* f, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / FQ12_W) * FQ12_WS);
    int lane;
    Grp g = group<FQ12_W>(lane);
    long i = (long)blockIdx.x * (32 / FQ12_W) + lane;
    if (i < half)
        lane_fq12_mul<FQ12_W>(g, tv, lh_smem + lane * FQ12_WS, i, f, f + (size_t)half * 144, f);
}

__global__ void k_fq12_mul(long n, const u32* a, const u32* b, u32* out, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / FQ12_W) * FQ12_WS);
    int lane;
    Grp g = group<FQ12_W>(lane);
    long i = (long)blockIdx.x * (32 / FQ12_W) + lane;
    if (i < n) lane_fq12_mul<FQ12_W>(g, tv, lh_smem + lane * FQ12_WS, i, a, b, out);
}

// Fp product latency (a measurement, on no path): each thread runs a chain
// of iters dependent products x <- x * y and records its clock64 cycles
__global__ void k_fp_mul_chain(long n, int iters, const u32* a, const u32* b, u32* out,
                               long long* cycles) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fp x, y;
    ld(x, a, i);
    ld(y, b, i);
    long long t0 = clock64();
    for (int k = 0; k < iters; k++) fp_mul(x, x, y);
    long long t1 = clock64();
    st(out, i, x);
    cycles[i] = t1 - t0;
}

__global__ void k_g1_affine(long n, const u32* X, const u32* Y, const u32* Z, u32* xa, u32* ya,
                            uint8_t* inf) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < n) lane_g1_affine(g, X, Y, Z, xa, ya, inf);
}

// row 12: G1 membership, 4 threads a lane over the G1 membership tapes
// (bls12_381.cuh lane_g1_subgroup)
__global__ void k_g1_subgroup(long n, const u32* xp, const u32* yp, uint8_t* out, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / G1_W) * GS_WS);
    int lane;
    Grp g = group<G1_W>(lane);
    long i = (long)blockIdx.x * (32 / G1_W) + lane;
    if (i < n) lane_g1_subgroup<G1_W>(g, tv, lh_smem + lane * GS_WS, i, xp, yp, out);
}

__global__ void k_g1_add_halves(long half, u32* X, u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < half) lane_add_halves<Fp>(i, half, X, Y, Z);
}

__global__ void k_g2_add_halves(long half, u32* X, u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < half) lane_add_halves<Fp2>(i, half, X, Y, Z);
}

__global__ void k_g2_subgroup(long n, const u32* xq, const u32* yq, uint8_t* out, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / PSI_W) * PSI_WS);
    int lane;
    Grp g = group<PSI_W>(lane);
    long i = (long)blockIdx.x * (32 / PSI_W) + lane;
    if (i < n) lane_g2_subgroup<PSI_W>(g, tv, lh_smem + lane * PSI_WS, i, xq, yq, out);
}

// the blinded fold's tail: a warp a segment, 8 groups over the G1 add's
// tape (bls12_381.cuh blinded_tail_*)
__global__ void k_blinded_final(long n_seg, int n_rows, const u32* X, const u32* Y, const u32* Z,
                                const u32* ux, const u32* uy, u32* xa, u32* ya, uint8_t* inf,
                                Span sp) {
    const TapeView tv = stage(sp, lh_smem + TAIL_WS);
    Fp* ws = lh_smem;
    int j;
    Grp g = group<G1_W>(j);
    const long seg = blockIdx.x;
    blinded_tail_load(ws, threadIdx.x, n_rows, seg, n_seg, X, Y, Z);
    for (int h = n_rows; h >= 1; h >>= 1) {
        if (h == 1) blinded_tail_blind(ws, threadIdx.x, ux, uy);
        __syncwarp();
        blinded_tail_step<G1_W>(g, tv, ws, j, h);
        __syncwarp();
    }
    if (threadIdx.x == 0) blinded_tail_out(ws, seg, xa, ya, inf);
}

__global__ void k_final_exp_hard(long n, const u32* in, u32* out, Span sp) {
    const TapeView tv = stage(sp, lh_smem + (32 / FE_W) * FE_WS);
    int lane;
    Grp g = group<FE_W>(lane);
    long i = (long)blockIdx.x * (32 / FE_W) + lane;
    if (i < n) lane_final_exp_hard<FE_W>(g, tv, lh_smem + lane * FE_WS, i, in, out);
}

inline cudaStream_t S(void* s) { return reinterpret_cast<cudaStream_t>(s); }

// the group kernels' lanes' workspaces in a warp-sized block, and the tapes
// each stages after them
enum GroupKernel { GK_GJ, GK_G1, GK_MILLER, GK_FQ12, GK_FE, GK_PSI, GK_TAIL, GK_G1S, N_GK };
constexpr size_t kWorkspace[N_GK] = {
    (32 / GJ_W) * GJ_WS * sizeof(Fp),         (32 / G1_W) * G1_WS * sizeof(Fp),
    (32 / MILLER_W) * MILLER_WS * sizeof(Fp), (32 / FQ12_W) * FQ12_WS * sizeof(Fp),
    (32 / FE_W) * FE_WS * sizeof(Fp),         (32 / PSI_W) * PSI_WS * sizeof(Fp),
    TAIL_WS * sizeof(Fp),                     (32 / G1_W) * GS_WS * sizeof(Fp)};
// each kernel's tapes: a range of TapeId
constexpr int kTapesOf[N_GK][2] = {{TAPE_G1_ADD, TAPE_G1G2_ADD},
                                   {TAPE_G1_DBL, TAPE_G1_ADD},
                                   {TAPE_MILLER_SETUP, TAPE_MILLER_ADD},
                                   {TAPE_FQ12_MUL, TAPE_FQ12_MUL},
                                   {TAPE_FQ12_MUL, TAPE_FROB3},
                                   {TAPE_PSI_DBL, TAPE_PSI_TAIL},
                                   {TAPE_G1_ADD, TAPE_G1_ADD},
                                   {TAPE_GS_DBL, TAPE_GS_TAIL}};
Span spans[N_GK];

inline size_t smem_of(int k) {
    size_t tapes = spans[k].nops * sizeof(Op) + (spans[k].nlv + 1) * sizeof(uint16_t);
    return kWorkspace[k] + (tapes + 15) / 16 * 16;
}

template <class K> cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The tapes, as the host built them (lh_set_tapes), copied to each device
// once before its first group launch; each group kernel may then take its
// shared memory (above 48 KB only with the attribute).
std::mutex tape_mu;
Tapes* host_tapes_copy = nullptr;
bool tapes_on[64];

int ensure_tapes(cudaStream_t s) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    std::lock_guard<std::mutex> lock(tape_mu);
    if (!host_tapes_copy || dev >= 64) return kErrTapes;
    if (tapes_on[dev]) return 0;
    if ((e = cudaMemcpyToSymbolAsync(g_tapes, host_tapes_copy, sizeof(Tapes), 0,
                                     cudaMemcpyHostToDevice, s)) != cudaSuccess ||
        (e = cudaStreamSynchronize(s)) != cudaSuccess ||
        (e = allow_smem(k_gj_scalar_mul, smem_of(GK_GJ))) != cudaSuccess ||
        (e = allow_smem(k_g1_scalar_mul, smem_of(GK_G1))) != cudaSuccess ||
        (e = allow_smem(k_g1_gather_scalar_mul, smem_of(GK_G1))) != cudaSuccess ||
        (e = allow_smem(k_miller, smem_of(GK_MILLER))) != cudaSuccess ||
        (e = allow_smem(k_fq12_mul_halves, smem_of(GK_FQ12))) != cudaSuccess ||
        (e = allow_smem(k_fq12_mul, smem_of(GK_FQ12))) != cudaSuccess ||
        (e = allow_smem(k_final_exp_hard, smem_of(GK_FE))) != cudaSuccess ||
        (e = allow_smem(k_g2_subgroup, smem_of(GK_PSI))) != cudaSuccess ||
        (e = allow_smem(k_blinded_final, smem_of(GK_TAIL))) != cudaSuccess ||
        (e = allow_smem(k_g1_subgroup, smem_of(GK_G1S))) != cudaSuccess)
        return (int)e;
    tapes_on[dev] = true;
    return 0;
}

}  // namespace

extern "C" {

// the tapes built by csrc/bls_tapes.cc (size bytes of a Tapes); before any
// group launch
int lh_set_tapes(const void* tapes, long long size) {
    if (size != (long long)sizeof(Tapes) || reinterpret_cast<const Tapes*>(tapes)->error)
        return kErrTapes;
    std::lock_guard<std::mutex> lock(tape_mu);
    if (!host_tapes_copy) host_tapes_copy = new Tapes;
    std::memcpy(host_tapes_copy, tapes, sizeof(Tapes));
    const Tapes& t = *host_tapes_copy;
    for (int k = 0; k < N_GK; k++) {
        const TapeInfo &a = t.info[kTapesOf[k][0]], &b = t.info[kTapesOf[k][1]];
        const int lv0 = a.first_level, lv1 = b.first_level + b.n_levels;
        const int op0 = t.level_start[lv0];
        spans[k] = Span{op0, t.level_start[lv1] - op0, lv0, lv1 - lv0};
    }
    for (bool& on : tapes_on) on = false;
    return 0;
}

// P, S outputs: G1 rows [n, 12] and G2 rows [n, 2, 12]; digits [n_digits, n]
int lh_gj_scalar_mul(const u32* pkx, const u32* pky, const u32* sx, const u32* sy,
                     const int32_t* digits, u32* PX, u32* PY, u32* PZ, u32* SX, u32* SY,
                     u32* SZ, long long n, long long n_digits, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_gj_scalar_mul<<<(unsigned)((n + 32 / GJ_W - 1) / (32 / GJ_W)), 32, smem_of(GK_GJ),
                      S(stream)>>>(n, (int)n_digits, pkx, pky, sx, sy, digits, PX, PY, PZ, SX, SY,
                                   SZ, spans[GK_GJ]);
    return (int)cudaGetLastError();
}

// G1 lanes xs, ys [n, 12] affine, digits [n_digits, n] -> X, Y, Z [n, 12]
int lh_g1_scalar_mul(const u32* xs, const u32* ys, const int32_t* digits, u32* X, u32* Y, u32* Z,
                     long long n, long long n_digits, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_g1_scalar_mul<<<(unsigned)((n + 32 / G1_W - 1) / (32 / G1_W)), 32, smem_of(GK_G1),
                      S(stream)>>>(n, (int)n_digits, xs, ys, digits, X, Y, Z, spans[GK_G1]);
    return (int)cudaGetLastError();
}

int lh_g1_add_halves(u32* X, u32* Y, u32* Z, long long half, void* stream) {
    k_g1_add_halves<<<blocks(half), kBlock, 0, S(stream)>>>(half, X, Y, Z);
    return (int)cudaGetLastError();
}

int lh_g2_add_halves(u32* X, u32* Y, u32* Z, long long half, void* stream) {
    k_g2_add_halves<<<blocks(half), kBlock, 0, S(stream)>>>(half, X, Y, Z);
    return (int)cudaGetLastError();
}

int lh_miller(const u32* xp, const u32* yp, const u32* zp, const u32* xq, const u32* yq,
              const u32* zq, const uint8_t* mask, u32* out, long long n, long long n_out,
              long long sum_lane, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_miller<<<(unsigned)((n_out + 32 / MILLER_W - 1) / (32 / MILLER_W)), 32,
               smem_of(GK_MILLER), S(stream)>>>(n, n_out, sum_lane, xp, yp, zp, xq, yq, zq, mask,
                                                out, spans[GK_MILLER]);
    return (int)cudaGetLastError();
}

int lh_fq12_mul_halves(u32* f, long long half, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_fq12_mul_halves<<<(unsigned)((half + 32 / FQ12_W - 1) / (32 / FQ12_W)), 32,
                        smem_of(GK_FQ12), S(stream)>>>(half, f, spans[GK_FQ12]);
    return (int)cudaGetLastError();
}

int lh_fq12_mul(const u32* a, const u32* b, u32* out, long long n, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_fq12_mul<<<(unsigned)((n + 32 / FQ12_W - 1) / (32 / FQ12_W)), 32, smem_of(GK_FQ12),
                 S(stream)>>>(n, a, b, out, spans[GK_FQ12]);
    return (int)cudaGetLastError();
}

// affine G2 lanes xq, yq [n, 2, 12] -> psi membership verdict out [n]
int lh_g2_subgroup(const u32* xq, const u32* yq, uint8_t* out, long long n, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_g2_subgroup<<<(unsigned)((n + 32 / PSI_W - 1) / (32 / PSI_W)), 32, smem_of(GK_PSI),
                    S(stream)>>>(n, xq, yq, out, spans[GK_PSI]);
    return (int)cudaGetLastError();
}

// Jacobian rows X, Y, Z holding `rows` partial sums a segment (a power of
// two up to BLINDED_TAIL_ROWS), s-major over n segments, and the blinding
// total (ux, uy) -> affine xa, ya [n, 12] and inf [n]; a warp a segment
int lh_blinded_final(const u32* X, const u32* Y, const u32* Z, const u32* ux, const u32* uy,
                     u32* xa, u32* ya, uint8_t* inf, long long n, long long rows, void* stream) {
    if (rows < 1 || rows > BLINDED_TAIL_ROWS || (rows & (rows - 1)))
        return (int)cudaErrorInvalidValue;
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_blinded_final<<<(unsigned)n, 32, smem_of(GK_TAIL), S(stream)>>>(
        n, (int)rows, X, Y, Z, ux, uy, xa, ya, inf, spans[GK_TAIL]);
    return (int)cudaGetLastError();
}

// gathered G1 lanes: table rows tx, ty [T, 12], lane rows idx [n], digits
// [n_digits, n] -> X, Y, Z [n, 12]; the lanes of lh_g1_scalar_mul
int lh_g1_gather_scalar_mul(const u32* tx, const u32* ty, const int32_t* idx,
                            const int32_t* digits, u32* X, u32* Y, u32* Z, long long n,
                            long long n_digits, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_g1_gather_scalar_mul<<<(unsigned)((n + 32 / G1_W - 1) / (32 / G1_W)), 32, smem_of(GK_G1),
                             S(stream)>>>(n, (int)n_digits, tx, ty, idx, digits, X, Y, Z,
                                          spans[GK_G1]);
    return (int)cudaGetLastError();
}

// the first n Jacobian rows of X, Y, Z -> affine xa, ya [n, 12] and inf [n]
int lh_g1_affine(const u32* X, const u32* Y, const u32* Z, u32* xa, u32* ya, uint8_t* inf,
                 long long n, void* stream) {
    k_g1_affine<<<blocks(n), kBlock, 0, S(stream)>>>(n, X, Y, Z, xa, ya, inf);
    return (int)cudaGetLastError();
}

// affine G1 lanes xp, yp [n, 12] -> membership verdict out [n]; 4 threads a
// lane, 8 lanes a warp-sized block
int lh_g1_subgroup(const u32* xp, const u32* yp, uint8_t* out, long long n, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_g1_subgroup<<<(unsigned)((n + 32 / G1_W - 1) / (32 / G1_W)), 32, smem_of(GK_G1S),
                    S(stream)>>>(n, xp, yp, out, spans[GK_G1S]);
    return (int)cudaGetLastError();
}

// cyclotomic Fq12 rows [n, 12, 12] -> (m^((p^4 - p^2 + 1)/r))^3 rows [n, 12, 12];
// a warp a lane, one lane a block
int lh_final_exp_hard(const u32* in, u32* out, long long n, void* stream) {
    if (int rc = ensure_tapes(S(stream))) return rc;
    k_final_exp_hard<<<(unsigned)((n + 32 / FE_W - 1) / (32 / FE_W)), 32, smem_of(GK_FE),
                       S(stream)>>>(n, in, out, spans[GK_FE]);
    return (int)cudaGetLastError();
}

// x_i * y_i^iters * R^-iters for rows x, y [n, 12] -> out [n, 12], and
// each thread's cycles; 32-thread blocks
int lh_fp_mul_chain(const u32* a, const u32* b, u32* out, long long* cycles, long long n,
                    long long iters, void* stream) {
    k_fp_mul_chain<<<(unsigned)((n + 31) / 32), 32, 0, S(stream)>>>(n, (int)iters, a, b, out,
                                                                   cycles);
    return (int)cudaGetLastError();
}

const char* lh_error_string(int code) {
    if (code == kErrTapes) return "no valid tapes (lh_set_tapes) for the group kernels";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
