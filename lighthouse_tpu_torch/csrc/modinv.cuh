// Modular inversion by divsteps, variable time, one thread a value: the
// inversion of the blinded pubkey fold's affine step (csrc/bls12_381.cuh,
// modulus p) and of the barycentric evaluation's root (csrc/fr.cuh,
// modulus r).
//
// Bernstein and Yang's safegcd ("Fast constant-time gcd computation and
// modular inversion", 2019) in the variable-time form of libsecp256k1's
// secp256k1_modinv32_var: signed 30-bit limbs, batches of 30 divsteps
// whose 2x2 transition matrix (scaled by 2^30) is computed on the low bits
// of f and g alone, then applied to the full f, g and to the Bezout
// coefficients d, e, until g = 0.  A batch skips runs of zero bits at once
// and cancels up to 8 low bits of g per step with a table of inverses mod
// 256.  Unlike libsecp256k1, f and g always keep all N limbs: every array
// index is a constant after unrolling, so the values stay in registers.
//
// Variable time is sound for its callers: every input is public (an
// aggregate pubkey's Z coordinate, a blob's evaluation challenge).  The
// work a value takes is data-dependent; ops/modinv.py runs the same steps
// on Python integers and counts them (a CPU test holds the two to each
// other and to pow(a, -1, m)).
//
// The callers work in the Montgomery domain: from aR they get (aR)^-1 here,
// then one Montgomery product by R^3 mod m gives a^-1 R.  Zero maps to zero
// (as Fermat's a^(m-2) does).
//
// The same code compiles as host C++ (g++), which the CPU tests build with
// MODINV_COUNT_MULADDS to count its 32-bit multiply-adds.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#ifndef __device__
#define __device__
#endif
#ifndef __forceinline__
#define __forceinline__ inline
#endif
#ifndef __constant__
#define __constant__
#endif
#endif

namespace modinv {

typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;

#define MODINV_M30 0x3fffffff

// Host builds may count the 32-bit multiply-adds (ops/modinv.py counts the
// same: 4 a divstep that cancels bits of g, and per batch 6N + 2 for d, e
// and 4N for f, g)
#ifdef MODINV_COUNT_MULADDS
extern unsigned long long modinv_muladd_count;
#define MODINV_COUNT(n) (modinv_muladd_count += (n))
#else
#define MODINV_COUNT(n)
#endif

// NEG_INV256[i] = -(2i + 1)^-1 mod 256
__constant__ uint8_t NEG_INV256[128] = {
    0xFF, 0x55, 0x33, 0x49, 0xC7, 0x5D, 0x3B, 0x11, 0x0F, 0xE5, 0xC3, 0x59, 0xD7, 0xED, 0xCB,
    0x21, 0x1F, 0x75, 0x53, 0x69, 0xE7, 0x7D, 0x5B, 0x31, 0x2F, 0x05, 0xE3, 0x79, 0xF7, 0x0D,
    0xEB, 0x41, 0x3F, 0x95, 0x73, 0x89, 0x07, 0x9D, 0x7B, 0x51, 0x4F, 0x25, 0x03, 0x99, 0x17,
    0x2D, 0x0B, 0x61, 0x5F, 0xB5, 0x93, 0xA9, 0x27, 0xBD, 0x9B, 0x71, 0x6F, 0x45, 0x23, 0xB9,
    0x37, 0x4D, 0x2B, 0x81, 0x7F, 0xD5, 0xB3, 0xC9, 0x47, 0xDD, 0xBB, 0x91, 0x8F, 0x65, 0x43,
    0xD9, 0x57, 0x6D, 0x4B, 0xA1, 0x9F, 0xF5, 0xD3, 0xE9, 0x67, 0xFD, 0xDB, 0xB1, 0xAF, 0x85,
    0x63, 0xF9, 0x77, 0x8D, 0x6B, 0xC1, 0xBF, 0x15, 0xF3, 0x09, 0x87, 0x1D, 0xFB, 0xD1, 0xCF,
    0xA5, 0x83, 0x19, 0x97, 0xAD, 0x8B, 0xE1, 0xDF, 0x35, 0x13, 0x29, 0xA7, 0x3D, 0x1B, 0xF1,
    0xEF, 0xC5, 0xA3, 0x39, 0xB7, 0xCD, 0xAB, 0x01};

// the transition matrix of 30 divsteps, scaled by 2^30
struct Trans {
    i32 u, v, q, r;
};

__device__ __forceinline__ int ctz32(u32 x) {
#ifdef __CUDACC__
    return __ffs((int)x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// 30 divsteps from eta (= -delta) on the low bits f0 (odd) and g0 -> the
// matrix t with t * [f, g] = 2^30 [f', g'] on these bits, and the new eta
__device__ __forceinline__ i32 divsteps_30(i32 eta, u32 f0, u32 g0, Trans& t) {
    u32 u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
    int i = 30;
#pragma unroll 1
    for (;;) {
        // a sentinel bit at i counts zeros only up to i; they all halve g
        const int zeros = ctz32(g | (0xffffffffu << i));
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        // g is odd: with eta < 0, swap to (g, -f) and negate eta
        if (eta < 0) {
            u32 tmp;
            eta = -eta;
            tmp = f; f = g; g = 0u - tmp;
            tmp = u; u = q; q = 0u - tmp;
            tmp = v; v = r; r = 0u - tmp;
        }
        // cancel the low min(eta + 1, i, 8) bits of g with a multiple of f
        const int limit = (eta + 1) > i ? i : (eta + 1);
        const u32 m = (0xffffffffu >> (32 - limit)) & 255u;
        const u32 w = (g * NEG_INV256[(f >> 1) & 127]) & m;
        g += f * w;
        q += u * w;
        r += v * w;
        MODINV_COUNT(4);
    }
    t.u = (i32)u;
    t.v = (i32)v;
    t.q = (i32)q;
    t.r = (i32)r;
    return eta;
}

// [d, e] <- t [d, e] / 2^30 mod m, adding the multiples of m that clear the
// low 30 bits; d, e stay in (-2m, m) (secp256k1_modinv32_update_de_30)
template <int N>
__device__ __forceinline__ void update_de(i32* d, i32* e, const Trans& t, const i32* M,
                                          u32 inv30) {
    const i32 sd = d[N - 1] >> 31, se = e[N - 1] >> 31;
    i32 md = (t.u & sd) + (t.v & se);
    i32 me = (t.q & sd) + (t.r & se);
    i64 cd = (i64)t.u * d[0] + (i64)t.v * e[0];
    i64 ce = (i64)t.q * d[0] + (i64)t.r * e[0];
    md -= (i32)((inv30 * (u32)cd + (u32)md) & MODINV_M30);
    me -= (i32)((inv30 * (u32)ce + (u32)me) & MODINV_M30);
    cd += (i64)M[0] * md;
    ce += (i64)M[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < N; i++) {
        cd += (i64)t.u * d[i] + (i64)t.v * e[i] + (i64)M[i] * md;
        ce += (i64)t.q * d[i] + (i64)t.r * e[i] + (i64)M[i] * me;
        d[i - 1] = (i32)cd & MODINV_M30;
        e[i - 1] = (i32)ce & MODINV_M30;
        cd >>= 30;
        ce >>= 30;
    }
    d[N - 1] = (i32)cd;
    e[N - 1] = (i32)ce;
    MODINV_COUNT(6 * N + 2);
}

// [f, g] <- t [f, g] / 2^30 over all N limbs (exact)
template <int N>
__device__ __forceinline__ void update_fg(i32* f, i32* g, const Trans& t) {
    i64 cf = (i64)t.u * f[0] + (i64)t.v * g[0];
    i64 cg = (i64)t.q * f[0] + (i64)t.r * g[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < N; i++) {
        cf += (i64)t.u * f[i] + (i64)t.v * g[i];
        cg += (i64)t.q * f[i] + (i64)t.r * g[i];
        f[i - 1] = (i32)cf & MODINV_M30;
        g[i - 1] = (i32)cg & MODINV_M30;
        cf >>= 30;
        cg >>= 30;
    }
    f[N - 1] = (i32)cf;
    g[N - 1] = (i32)cg;
    MODINV_COUNT(4 * N);
}

// carry each limb's bits above 30 into the next (the top limb keeps the sign)
template <int N> __device__ __forceinline__ void carry30(i32* x) {
#pragma unroll
    for (int i = 0; i < N - 1; i++) {
        x[i + 1] += x[i] >> 30;
        x[i] &= MODINV_M30;
    }
}

// x in (-2m, m) -> sign * x mod m in [0, m), for sign (the sign of f) = +-1
// (secp256k1_modinv32_normalize_30)
template <int N>
__device__ __forceinline__ void normalize(i32* x, i32 sign, const i32* M) {
    i32 add = x[N - 1] >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) x[i] += M[i] & add;
    const i32 neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) x[i] = (x[i] ^ neg) - neg;
    carry30<N>(x);
    add = x[N - 1] >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) x[i] += M[i] & add;
    carry30<N>(x);
}

// out = a^-1 mod m (0 -> 0) for a canonical a < m in W 32-bit little-endian
// words; m in N signed 30-bit limbs M (each below 2^30), inv30 = m^-1 mod
// 2^30.  N = bits(m) / 30 + 1: 13 for p, 9 for r.
template <int N, int W>
__device__ __forceinline__ void inv_var(u32* out, const u32* a, const i32* M, u32 inv30) {
    i32 d[N], e[N], f[N], g[N];
    u32 any = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
        const int bit = 30 * i, w = bit / 32, off = bit % 32;
        u32 x = w < W ? a[w] >> off : 0u;
        if (off > 2 && w + 1 < W) x |= a[w + 1] << (32 - off);
        g[i] = (i32)(x & MODINV_M30);
        f[i] = M[i];
        d[i] = 0;
        e[i] = i == 0;
        any |= x;
    }
    if (any == 0) {
#pragma unroll
        for (int k = 0; k < W; k++) out[k] = 0;
        return;
    }
    i32 eta = -1;
#pragma unroll 1
    for (;;) {
        Trans t;
        eta = divsteps_30(eta, (u32)f[0], (u32)g[0], t);
        update_de<N>(d, e, t, M, inv30);
        update_fg<N>(f, g, t);
        i32 nz = 0;
#pragma unroll
        for (int i = 0; i < N; i++) nz |= g[i];
        if (nz == 0) break;
    }
    // g = 0, f = +-gcd = +-1, d = +-a^-1
    normalize<N>(d, f[N - 1], M);
#pragma unroll
    for (int k = 0; k < W; k++) {
        const int bit = 32 * k, l = bit / 30, off = bit % 30;
        u32 x = (u32)d[l] >> off;
        if (l + 1 < N) x |= (u32)d[l + 1] << (30 - off);      // off <= 28: two limbs suffice
        out[k] = x;
    }
}

}  // namespace modinv
