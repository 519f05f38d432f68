// BLS12-381 batch-verify kernels for sm_90a, bound with ctypes
// (lighthouse_tpu_torch/ops/bls_cuda.py).  Field, tower, curve and the
// per-lane routines live in bls12_381.cuh.
//
// Replaces the JAX package's device programs on the verify path:
//   lh_gj_scalar_mul + lh_g1/g2_add_halves + lh_miller + lh_fq12_mul_halves
//       -> ops/bls_backend.py:124 _pipeline_fused (wrapper
//          bls_backend.pipeline_device)
//   lh_g2_subgroup      -> ops/bls_backend.py:175 _g2_subgroup_kernel
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
//                          bls_backend.g1_subgroup_device)
//
// Bound: 32-bit integer multiply-adds.  Every Fp product is a 12-word CIOS
// Montgomery multiply (2*12^2 + 12 multiply-adds); the data moved is a few
// hundred bytes per lane against thousands of products, so no kernel is
// near the memory bound.  No kernel computes a product that it then
// discards: an add with an infinity side, a product by one and the add
// steps on clear bits of |x| are skipped (ops/bls_cuda.py counts the
// products that remain).  Design (first version: simple and right): one
// thread per lane for the scalar multiplications, the psi check, the Miller
// loop and the final affine conversion, with window tables and Miller state
// in per-thread local memory; the segment, G2 and Fq12 reductions are trees
// with one launch per level, each thread combining rows i and i + half in
// place.  Each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

namespace {

constexpr int kBlock = 64;

inline unsigned blocks(long n) { return (unsigned)((n + kBlock - 1) / kBlock); }

__global__ void k_gj_scalar_mul(long n, int n_digits, const u32* pkx, const u32* pky,
                                const u32* sx, const u32* sy, const int32_t* digits, u32* PX,
                                u32* PY, u32* PZ, u32* SX, u32* SY, u32* SZ) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_gj_scalar_mul(i, n, n_digits, pkx, pky, sx, sy, digits, PX, PY, PZ, SX, SY, SZ);
}

__global__ void k_g1_scalar_mul(long n, int n_digits, const u32* xs, const u32* ys,
                                const int32_t* digits, u32* X, u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_g1_scalar_mul(i, n, n_digits, xs, ys, digits, X, Y, Z);
}

__global__ void k_g1_gather_scalar_mul(long n, int n_digits, const u32* tx, const u32* ty,
                                       const int32_t* idx, const int32_t* digits, u32* X,
                                       u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_g1_gather_scalar_mul(i, n, n_digits, tx, ty, idx, digits, X, Y, Z);
}

__global__ void k_g1_affine(long n, const u32* X, const u32* Y, const u32* Z, u32* xa, u32* ya,
                            uint8_t* inf) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < n) lane_g1_affine(g, X, Y, Z, xa, ya, inf);
}

__global__ void k_g1_subgroup(long n, const u32* xp, const u32* yp, uint8_t* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_g1_subgroup(i, xp, yp, out);
}

__global__ void k_g1_add_halves(long half, u32* X, u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < half) lane_add_halves<Fp>(i, half, X, Y, Z);
}

__global__ void k_g2_add_halves(long half, u32* X, u32* Y, u32* Z) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < half) lane_add_halves<Fp2>(i, half, X, Y, Z);
}

__global__ void k_miller(long n, long n_out, long sum_lane, const u32* xp, const u32* yp,
                         const u32* zp, const u32* xq, const u32* yq, const u32* zq,
                         const uint8_t* mask, u32* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_out) lane_miller(i, n, sum_lane, xp, yp, zp, xq, yq, zq, mask, out);
}

__global__ void k_fq12_mul_halves(long half, u32* f) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < half) lane_fq12_mul(i, f, f + (size_t)half * 144, f);
}

__global__ void k_fq12_mul(long n, const u32* a, const u32* b, u32* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_fq12_mul(i, a, b, out);
}

__global__ void k_g2_subgroup(long n, const u32* xq, const u32* yq, uint8_t* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lane_g2_subgroup(i, xq, yq, out);
}

__global__ void k_blinded_final(long n, const u32* X, const u32* Y, const u32* Z,
                                const u32* ux, const u32* uy, u32* xa, u32* ya, uint8_t* inf) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < n) lane_blinded_final(g, X, Y, Z, ux, uy, xa, ya, inf);
}

inline cudaStream_t S(void* s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// P, S outputs: G1 rows [n, 12] and G2 rows [n, 2, 12]; digits [n_digits, n]
int lh_gj_scalar_mul(const u32* pkx, const u32* pky, const u32* sx, const u32* sy,
                     const int32_t* digits, u32* PX, u32* PY, u32* PZ, u32* SX, u32* SY,
                     u32* SZ, long long n, long long n_digits, void* stream) {
    k_gj_scalar_mul<<<blocks(n), kBlock, 0, S(stream)>>>(n, (int)n_digits, pkx, pky, sx, sy,
                                                         digits, PX, PY, PZ, SX, SY, SZ);
    return (int)cudaGetLastError();
}

// G1 lanes xs, ys [n, 12] affine, digits [n_digits, n] -> X, Y, Z [n, 12];
// 32-thread blocks, so that a few thousand lanes reach every SM
int lh_g1_scalar_mul(const u32* xs, const u32* ys, const int32_t* digits, u32* X, u32* Y, u32* Z,
                     long long n, long long n_digits, void* stream) {
    k_g1_scalar_mul<<<(unsigned)((n + 31) / 32), 32, 0, S(stream)>>>(n, (int)n_digits, xs, ys,
                                                                     digits, X, Y, Z);
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
    k_miller<<<blocks(n_out), kBlock, 0, S(stream)>>>(n, n_out, sum_lane, xp, yp, zp, xq, yq,
                                                      zq, mask, out);
    return (int)cudaGetLastError();
}

int lh_fq12_mul_halves(u32* f, long long half, void* stream) {
    k_fq12_mul_halves<<<blocks(half), kBlock, 0, S(stream)>>>(half, f);
    return (int)cudaGetLastError();
}

int lh_fq12_mul(const u32* a, const u32* b, u32* out, long long n, void* stream) {
    k_fq12_mul<<<blocks(n), kBlock, 0, S(stream)>>>(n, a, b, out);
    return (int)cudaGetLastError();
}

int lh_g2_subgroup(const u32* xq, const u32* yq, uint8_t* out, long long n, void* stream) {
    k_g2_subgroup<<<blocks(n), kBlock, 0, S(stream)>>>(n, xq, yq, out);
    return (int)cudaGetLastError();
}

int lh_blinded_final(const u32* X, const u32* Y, const u32* Z, const u32* ux, const u32* uy,
                     u32* xa, u32* ya, uint8_t* inf, long long n, void* stream) {
    k_blinded_final<<<blocks(n), kBlock, 0, S(stream)>>>(n, X, Y, Z, ux, uy, xa, ya, inf);
    return (int)cudaGetLastError();
}

// gathered G1 lanes: table rows tx, ty [T, 12], lane rows idx [n], digits
// [n_digits, n] -> X, Y, Z [n, 12]; 32-thread blocks as lh_g1_scalar_mul
int lh_g1_gather_scalar_mul(const u32* tx, const u32* ty, const int32_t* idx,
                            const int32_t* digits, u32* X, u32* Y, u32* Z, long long n,
                            long long n_digits, void* stream) {
    k_g1_gather_scalar_mul<<<(unsigned)((n + 31) / 32), 32, 0, S(stream)>>>(
        n, (int)n_digits, tx, ty, idx, digits, X, Y, Z);
    return (int)cudaGetLastError();
}

// the first n Jacobian rows of X, Y, Z -> affine xa, ya [n, 12] and inf [n]
int lh_g1_affine(const u32* X, const u32* Y, const u32* Z, u32* xa, u32* ya, uint8_t* inf,
                 long long n, void* stream) {
    k_g1_affine<<<blocks(n), kBlock, 0, S(stream)>>>(n, X, Y, Z, xa, ya, inf);
    return (int)cudaGetLastError();
}

// affine G1 lanes xp, yp [n, 12] -> membership verdict out [n]
int lh_g1_subgroup(const u32* xp, const u32* yp, uint8_t* out, long long n, void* stream) {
    k_g1_subgroup<<<blocks(n), kBlock, 0, S(stream)>>>(n, xp, yp, out);
    return (int)cudaGetLastError();
}

const char* lh_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
