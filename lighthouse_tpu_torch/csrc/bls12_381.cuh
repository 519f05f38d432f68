// BLS12-381 field, tower, curve and per-lane routines for the batch-verify
// kernels of csrc/bls12_381.cu (sm_90a).
//
// Counterpart of lighthouse_tpu/ops/{bigint,bls12_381,ec}.py.  Elements are
// 12 x 32-bit little-endian words, FULLY REDUCED in [0, p), Montgomery
// R = 2^384: a value has one encoding, so "is zero" and equality are word
// compares.  Multiplication is word-serial CIOS Montgomery in 64-bit
// accumulators; every add, sub and product ends fully reduced.
//
// The tower products may use any formula (their value is unique).  The
// curve formulas and the Miller loop's line scalings follow the JAX package
// operation for operation, so the Jacobian coordinates and the Miller
// values equal it exactly (lighthouse_tpu_torch/ops/ec.py and
// ops/bls12_381.py hold the same sequences as plain PyTorch).
//
// Everything a kernel computes per lane is a function lane_*() here, so the
// same code also compiles as host C++ (g++ -x c++), which the CPU tests use
// to check the arithmetic without a card.  Products from Fp2 upward are
// __noinline__ and the long loops are not unrolled, to keep nvcc's compile
// time and the code size of the Miller kernel bounded.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#endif

namespace bls {

typedef uint32_t u32;
typedef uint64_t u64;

struct Fp { u32 w[12]; };
struct Fp2 { Fp c[2]; };
struct Fp6 { Fp2 c[3]; };
struct Fp12 { Fp6 c[2]; };

__constant__ u32 P_W[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p: the Montgomery form of 1
__constant__ u32 ONE_W[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// p - 2: the Fermat inversion exponent
__constant__ u32 PM2_W[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// -p^-1 mod 2^32
__constant__ u32 NP32 = 0xfffcfffdu;
// psi constants (Montgomery): c_x = xi^-((p-1)/3), c_y = xi^-((p-1)/2)
__constant__ u32 PSI_CX_W[2][12] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
     0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};
__constant__ u32 PSI_CY_W[2][12] = {
    {0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u,
     0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu},
    {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
     0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}};
// |x| of the curve; the Miller loop runs bits 62..0, the psi check 63..0
#define BLS_X_ABS 0xd201000000010000ull
// r - 1 (little-endian words, 255 bits): the G1 membership scan's exponent
__constant__ u32 RM1_W[8] = {
    0x00000000u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u,
    0x299d7d48u, 0x73eda753u};
#define BLS_RM1_BITS 255

// Host builds may count Fp multiplications (the CPU tests check the counts
// that bound the kernels' times against this code).
#ifdef BLS_COUNT_FP_MULS
extern unsigned long long bls_fp_mul_count;
#define BLS_COUNT_FP_MUL() (bls_fp_mul_count++)
#else
#define BLS_COUNT_FP_MUL()
#endif

// ---- Fp ---------------------------------------------------------------------

__device__ __forceinline__ void fp_zero(Fp& r) {
    for (int i = 0; i < 12; i++) r.w[i] = 0;
}
__device__ __forceinline__ void fp_one(Fp& r) {
    for (int i = 0; i < 12; i++) r.w[i] = ONE_W[i];
}
__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
    u32 acc = 0;
    for (int i = 0; i < 12; i++) acc |= a.w[i];
    return acc == 0;
}

// r = s - p if s >= p else s, for s < 2^384 (words in t)
__device__ __forceinline__ void fp_reduce_once(Fp& r, const u32* s) {
    u32 d[12];
    u64 br = 0;
    for (int i = 0; i < 12; i++) {
        u64 t = (u64)s[i] - P_W[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
    for (int i = 0; i < 12; i++) r.w[i] = br ? s[i] : d[i];
}

__device__ __noinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
    u32 s[12];
    u64 c = 0;
    for (int i = 0; i < 12; i++) {
        c += (u64)a.w[i] + b.w[i];
        s[i] = (u32)c;
        c >>= 32;
    }
    fp_reduce_once(r, s);      // a + b < 2p < 2^382: no carry out
}

__device__ __noinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
    u32 d[12];
    u64 br = 0;
    for (int i = 0; i < 12; i++) {
        u64 t = (u64)a.w[i] - b.w[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
    u32 mask = br ? 0xffffffffu : 0u;   // a < b: add p back
    u64 c = 0;
    for (int i = 0; i < 12; i++) {
        c += (u64)d[i] + (P_W[i] & mask);
        r.w[i] = (u32)c;
        c >>= 32;
    }
}

__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
    Fp z;
    fp_zero(z);
    fp_sub(r, z, a);
}

// CIOS Montgomery product a*b*2^-384 mod p
__device__ __noinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
    BLS_COUNT_FP_MUL();
    u32 t[14];
    for (int i = 0; i < 14; i++) t[i] = 0;
#pragma unroll 1
    for (int i = 0; i < 12; i++) {
        u64 c = 0;
        u32 bi = b.w[i];
        for (int j = 0; j < 12; j++) {
            c += (u64)a.w[j] * bi + t[j];
            t[j] = (u32)c;
            c >>= 32;
        }
        c += t[12];
        t[12] = (u32)c;
        t[13] = (u32)(c >> 32);
        u32 m = t[0] * NP32;
        c = ((u64)m * P_W[0] + t[0]) >> 32;
        for (int j = 1; j < 12; j++) {
            c += (u64)m * P_W[j] + t[j];
            t[j - 1] = (u32)c;
            c >>= 32;
        }
        c += t[12];
        t[11] = (u32)c;
        t[12] = t[13] + (u32)(c >> 32);
    }
    fp_reduce_once(r, t);      // t < 2p, t[12] == 0
}

// k*a for a small positive k, by double-and-add over k's bits
__device__ __noinline__ void fp_scale(Fp& r, const Fp& a, int k) {
    Fp acc = a;
    int top = 0;
    while ((k >> (top + 1)) != 0) top++;
    for (int b = top - 1; b >= 0; b--) {
        fp_add(acc, acc, acc);
        if ((k >> b) & 1) fp_add(acc, acc, a);
    }
    r = acc;
}

// ---- Fp2 = Fp[u]/(u^2 + 1) --------------------------------------------------

__device__ __forceinline__ void fp2_zero(Fp2& r) { fp_zero(r.c[0]); fp_zero(r.c[1]); }
__device__ __forceinline__ void fp2_one(Fp2& r) { fp_one(r.c[0]); fp_zero(r.c[1]); }
__device__ __forceinline__ bool fp2_is_zero(const Fp2& a) {
    return fp_is_zero(a.c[0]) && fp_is_zero(a.c[1]);
}
__device__ __forceinline__ void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
    fp_add(r.c[0], a.c[0], b.c[0]);
    fp_add(r.c[1], a.c[1], b.c[1]);
}
__device__ __forceinline__ void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
    fp_sub(r.c[0], a.c[0], b.c[0]);
    fp_sub(r.c[1], a.c[1], b.c[1]);
}
__device__ __forceinline__ void fp2_neg(Fp2& r, const Fp2& a) {
    fp_neg(r.c[0], a.c[0]);
    fp_neg(r.c[1], a.c[1]);
}
__device__ __forceinline__ void fp2_scale(Fp2& r, const Fp2& a, int k) {
    fp_scale(r.c[0], a.c[0], k);
    fp_scale(r.c[1], a.c[1], k);
}
__device__ __forceinline__ void fp2_conj(Fp2& r, const Fp2& a) {
    r.c[0] = a.c[0];
    fp_neg(r.c[1], a.c[1]);
}
// Karatsuba: (a + bu)(c + du) = ac - bd + ((a + b)(c + d) - ac - bd)u
__device__ __noinline__ void fp2_mul(Fp2& r, const Fp2& x, const Fp2& y) {
    Fp t0, t1, t2, sa, sb;
    fp_mul(t0, x.c[0], y.c[0]);
    fp_mul(t1, x.c[1], y.c[1]);
    fp_add(sa, x.c[0], x.c[1]);
    fp_add(sb, y.c[0], y.c[1]);
    fp_mul(t2, sa, sb);
    fp_sub(r.c[0], t0, t1);
    fp_sub(t2, t2, t0);
    fp_sub(r.c[1], t2, t1);
}
// (a + bu) * s for an Fp scalar s
__device__ __forceinline__ void fp2_mul_fp(Fp2& r, const Fp2& x, const Fp& s) {
    fp_mul(r.c[0], x.c[0], s);
    fp_mul(r.c[1], x.c[1], s);
}
// times xi = 1 + u: (a - b) + (a + b)u
__device__ __forceinline__ void fp2_mul_xi(Fp2& r, const Fp2& x) {
    Fp t;
    fp_sub(t, x.c[0], x.c[1]);
    fp_add(r.c[1], x.c[0], x.c[1]);
    r.c[0] = t;
}

// ---- Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v) ------------------------

__device__ __forceinline__ void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
    for (int i = 0; i < 3; i++) fp2_add(r.c[i], a.c[i], b.c[i]);
}
__device__ __forceinline__ void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
    for (int i = 0; i < 3; i++) fp2_sub(r.c[i], a.c[i], b.c[i]);
}
// Karatsuba (ops/bls12_381.fp6_mul of the JAX package): 6 Fp2 products
__device__ __noinline__ void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
    Fp2 t0, t1, t2, sa, sb, m, c0, c1, c2;
    fp2_mul(t0, a.c[0], b.c[0]);
    fp2_mul(t1, a.c[1], b.c[1]);
    fp2_mul(t2, a.c[2], b.c[2]);
    fp2_add(sa, a.c[1], a.c[2]);
    fp2_add(sb, b.c[1], b.c[2]);
    fp2_mul(m, sa, sb);
    fp2_sub(m, m, t1);
    fp2_sub(m, m, t2);
    fp2_mul_xi(m, m);
    fp2_add(c0, t0, m);
    fp2_add(sa, a.c[0], a.c[1]);
    fp2_add(sb, b.c[0], b.c[1]);
    fp2_mul(m, sa, sb);
    fp2_sub(m, m, t0);
    fp2_sub(m, m, t1);
    fp2_mul_xi(c1, t2);
    fp2_add(c1, m, c1);
    fp2_add(sa, a.c[0], a.c[2]);
    fp2_add(sb, b.c[0], b.c[2]);
    fp2_mul(m, sa, sb);
    fp2_sub(m, m, t0);
    fp2_sub(m, m, t2);
    fp2_add(c2, m, t1);
    r.c[0] = c0;
    r.c[1] = c1;
    r.c[2] = c2;
}
// a * (b0 + b1 v): 5 Fp2 products
__device__ __noinline__ void fp6_mul_01(Fp6& r, const Fp6& a, const Fp2& b0, const Fp2& b1) {
    Fp2 t0, t1, s, u, c0, c1, c2;
    fp2_mul(t0, a.c[0], b0);
    fp2_mul(t1, a.c[1], b1);
    fp2_add(s, a.c[1], a.c[2]);
    fp2_mul(s, s, b1);
    fp2_sub(s, s, t1);
    fp2_mul_xi(s, s);
    fp2_add(c0, t0, s);
    fp2_add(s, a.c[0], a.c[1]);
    fp2_add(u, b0, b1);
    fp2_mul(s, s, u);
    fp2_sub(s, s, t0);
    fp2_sub(c1, s, t1);
    fp2_add(s, a.c[0], a.c[2]);
    fp2_mul(s, s, b0);
    fp2_sub(s, s, t0);
    fp2_add(c2, s, t1);
    r.c[0] = c0;
    r.c[1] = c1;
    r.c[2] = c2;
}
// a * (b1 v) = (xi a2 b1, a0 b1, a1 b1): 3 Fp2 products
__device__ __noinline__ void fp6_mul_1(Fp6& r, const Fp6& a, const Fp2& b1) {
    Fp2 c0, c1, c2;
    fp2_mul(c0, a.c[2], b1);
    fp2_mul_xi(c0, c0);
    fp2_mul(c1, a.c[0], b1);
    fp2_mul(c2, a.c[1], b1);
    r.c[0] = c0;
    r.c[1] = c1;
    r.c[2] = c2;
}
// (c0, c1, c2) * v = (xi c2, c0, c1)
__device__ __forceinline__ void fp6_mul_v(Fp6& r, const Fp6& a) {
    Fp2 t;
    fp2_mul_xi(t, a.c[2]);
    r.c[2] = a.c[1];
    r.c[1] = a.c[0];
    r.c[0] = t;
}
// Karatsuba over w: c0 = a0b0 + v a1b1, c1 = (a0 + a1)(b0 + b1) - a0b0 - a1b1
__device__ __noinline__ void fp12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
    Fp6 t0, t1, sa, sb, c1;
    fp6_mul(t0, a.c[0], b.c[0]);
    fp6_mul(t1, a.c[1], b.c[1]);
    fp6_add(sa, a.c[0], a.c[1]);
    fp6_add(sb, b.c[0], b.c[1]);
    fp6_mul(c1, sa, sb);
    fp6_sub(c1, c1, t0);
    fp6_sub(r.c[1], c1, t1);
    fp6_mul_v(t1, t1);
    fp6_add(r.c[0], t0, t1);
}
__device__ __forceinline__ void fp12_one(Fp12& r) {
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++) fp2_zero(r.c[i].c[j]);
    fp_one(r.c[0].c[0].c[0]);
}
__device__ __forceinline__ void fp12_conj(Fp12& r, const Fp12& a) {
    r.c[0] = a.c[0];
    for (int j = 0; j < 3; j++) fp2_neg(r.c[1].c[j], a.c[1].c[j]);
}
// (a0 + a1 w)^2 = a0^2 + v a1^2 + 2 a0 a1 w, with
// a0^2 + v a1^2 = (a0 + a1)(a0 + v a1) - a0 a1 - v a0 a1: 2 Fp6 products
__device__ __noinline__ void fp12_sqr(Fp12& r, const Fp12& a) {
    Fp6 ab, s, t;
    fp6_mul(ab, a.c[0], a.c[1]);
    fp6_add(s, a.c[0], a.c[1]);
    fp6_mul_v(t, a.c[1]);
    fp6_add(t, a.c[0], t);
    fp6_mul(s, s, t);
    fp6_sub(s, s, ab);
    fp6_mul_v(t, ab);
    fp6_sub(r.c[0], s, t);
    fp6_add(r.c[1], ab, ab);
}
__device__ __forceinline__ bool fp12_is_one(const Fp12& a) {
    u32 acc = 0;
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++)
            for (int k = 0; k < 2; k++)
                for (int w = 0; w < 12; w++)
                    acc |= a.c[i].c[j].c[k].w[w] ^ (i == 0 && j == 0 && k == 0 ? ONE_W[w] : 0u);
    return acc == 0;
}
// f * (a0 + a1 v + b1 v w), the Miller loop's line product: Karatsuba over
// w with the line's sparse Fp6 halves A = a0 + a1 v and B = b1 v,
// 5 + 3 + 5 = 13 Fp2 products
__device__ __noinline__ void fp12_mul_line(Fp12& r, const Fp12& f, const Fp2& a0,
                                           const Fp2& a1, const Fp2& b1) {
    Fp6 t0, t1, s;
    Fp2 u;
    fp6_mul_01(t0, f.c[0], a0, a1);
    fp6_mul_1(t1, f.c[1], b1);
    fp6_add(s, f.c[0], f.c[1]);
    fp2_add(u, a1, b1);
    fp6_mul_01(s, s, a0, u);
    fp6_sub(s, s, t0);
    fp6_sub(r.c[1], s, t1);
    fp6_mul_v(t1, t1);
    fp6_add(r.c[0], t0, t1);
}

// ---- generic field ops for the curve templates ------------------------------

__device__ __forceinline__ void f_add(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
__device__ __forceinline__ void f_add(Fp2& r, const Fp2& a, const Fp2& b) { fp2_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
__device__ __forceinline__ void f_sub(Fp2& r, const Fp2& a, const Fp2& b) { fp2_sub(r, a, b); }
__device__ __forceinline__ void f_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
__device__ __forceinline__ void f_mul(Fp2& r, const Fp2& a, const Fp2& b) { fp2_mul(r, a, b); }
__device__ __forceinline__ void f_scale(Fp& r, const Fp& a, int k) { fp_scale(r, a, k); }
__device__ __forceinline__ void f_scale(Fp2& r, const Fp2& a, int k) { fp2_scale(r, a, k); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool f_is_zero(const Fp2& a) { return fp2_is_zero(a); }
__device__ __forceinline__ void f_zero(Fp& r) { fp_zero(r); }
__device__ __forceinline__ void f_zero(Fp2& r) { fp2_zero(r); }
__device__ __forceinline__ void f_one(Fp& r) { fp_one(r); }
__device__ __forceinline__ void f_one(Fp2& r) { fp2_one(r); }

template <class F> struct Jac { F X, Y, Z; };

template <class F> __device__ __forceinline__ void jac_zero(Jac<F>& r) {
    f_zero(r.X);
    f_zero(r.Y);
    f_zero(r.Z);
}

// a = 0 Jacobian doubling (ec._jac_double_multi); Z == 0 stays Z == 0
template <class F> __device__ __noinline__ void jac_double(Jac<F>& r, const Jac<F>& p) {
    F xx, yy, yz, E, Z3, xb, c4, t, ff, D, X3, Y3, tmp;
    f_mul(xx, p.X, p.X);
    f_mul(yy, p.Y, p.Y);
    f_mul(yz, p.Y, p.Z);
    f_scale(E, xx, 3);
    f_scale(Z3, yz, 2);
    f_add(xb, p.X, yy);
    f_mul(c4, yy, yy);
    f_mul(t, xb, xb);
    f_mul(ff, E, E);
    f_sub(D, t, xx);
    f_sub(D, D, c4);
    f_scale(D, D, 2);
    f_scale(tmp, D, 2);
    f_sub(X3, ff, tmp);
    f_sub(tmp, D, X3);
    f_mul(Y3, E, tmp);
    f_scale(tmp, c4, 8);
    f_sub(Y3, Y3, tmp);
    r.X = X3;
    r.Y = Y3;
    r.Z = Z3;
}

// Full Jacobian add (ec._jac_add_full), complete when either side is
// infinity (the other side is returned, with no product), INCOMPLETE at
// H == 0 (the callers' contract).  p_inf / q_inf: 1 or 0 for an explicit
// flag, -1 to probe Z == 0.
template <class F>
__device__ __noinline__ void jac_add_full(Jac<F>& r, const Jac<F>& p, const Jac<F>& q,
                                          int p_inf, int q_inf) {
    if (p_inf < 0 ? f_is_zero(p.Z) : p_inf != 0) {
        r = q;
        return;
    }
    if (q_inf < 0 ? f_is_zero(q.Z) : q_inf != 0) {
        r = p;
        return;
    }
    F z11, z22, zs, u1, u2, z1c, z2c, zz12, h, s1, s2, hh, rv, i4, zmul, j, v, rr, tmp;
    Jac<F> o;
    f_mul(z11, p.Z, p.Z);
    f_mul(z22, q.Z, q.Z);
    f_add(zs, p.Z, q.Z);
    f_mul(u1, p.X, z22);
    f_mul(u2, q.X, z11);
    f_mul(z1c, p.Z, z11);
    f_mul(z2c, q.Z, z22);
    f_mul(zz12, zs, zs);
    f_sub(h, u2, u1);
    f_mul(s1, p.Y, z2c);
    f_mul(s2, q.Y, z1c);
    f_mul(hh, h, h);
    f_sub(rv, s2, s1);
    f_scale(rv, rv, 2);
    f_scale(i4, hh, 4);
    f_sub(zmul, zz12, z11);
    f_sub(zmul, zmul, z22);
    f_mul(j, h, i4);
    f_mul(v, u1, i4);
    f_mul(rr, rv, rv);
    f_mul(o.Z, zmul, h);
    f_sub(o.X, rr, j);
    f_scale(tmp, v, 2);
    f_sub(o.X, o.X, tmp);
    f_sub(tmp, v, o.X);
    f_mul(o.Y, rv, tmp);
    f_mul(tmp, s1, j);
    f_scale(tmp, tmp, 2);
    f_sub(o.Y, o.Y, tmp);
    r = o;
}

// One double-and-add step of the psi check (ec._dbl_add_step): 2T, then the
// mixed add of the affine base (xb, yb) when bit is set; inf is T's flag.
// The doubling is skipped while T is infinity and the add on a clear bit,
// where the JAX program computes and discards them (same values).
template <class F>
__device__ __noinline__ void dbl_add_step(Jac<F>& T, bool& inf, const F& xb, const F& yb,
                                          int bit) {
    if (!inf) jac_double(T, T);
    if (!bit) return;
    if (inf) {
        T.X = xb;
        T.Y = yb;
        f_one(T.Z);
        inf = false;
        return;
    }
    F zz, u2, zzz, H, s2, hh, rv, zph, rr, j, v, zph2, J, V, X3a, Y3a, Z3a, tmp;
    f_mul(zz, T.Z, T.Z);
    f_mul(u2, xb, zz);
    f_mul(zzz, T.Z, zz);
    f_sub(H, u2, T.X);
    f_mul(s2, yb, zzz);
    f_mul(hh, H, H);
    f_sub(rv, s2, T.Y);
    f_scale(rv, rv, 2);
    f_add(zph, T.Z, H);
    f_mul(rr, rv, rv);
    f_mul(j, H, hh);
    f_mul(v, T.X, hh);
    f_mul(zph2, zph, zph);
    f_scale(J, j, 4);
    f_scale(V, v, 4);
    f_sub(X3a, rr, J);
    f_scale(tmp, V, 2);
    f_sub(X3a, X3a, tmp);
    f_sub(tmp, V, X3a);
    f_mul(Y3a, rv, tmp);
    f_mul(tmp, T.Y, j);
    f_scale(tmp, tmp, 8);
    f_sub(Y3a, Y3a, tmp);
    f_sub(Z3a, zph2, zz);
    f_sub(Z3a, Z3a, hh);
    T.X = X3a;
    T.Y = Y3a;
    T.Z = Z3a;
}

// ---- global memory rows -----------------------------------------------------

__device__ __forceinline__ void ld(Fp& r, const u32* p, long i) {
    for (int k = 0; k < 12; k++) r.w[k] = p[i * 12 + k];
}
__device__ __forceinline__ void st(u32* p, long i, const Fp& a) {
    for (int k = 0; k < 12; k++) p[i * 12 + k] = a.w[k];
}
__device__ __forceinline__ void ld(Fp2& r, const u32* p, long i) {
    ld(r.c[0], p, 2 * i);
    ld(r.c[1], p, 2 * i + 1);
}
__device__ __forceinline__ void st(u32* p, long i, const Fp2& a) {
    st(p, 2 * i, a.c[0]);
    st(p, 2 * i + 1, a.c[1]);
}
// Fp12 rows [N, 12, 12]: coefficient (c6*3 + c2)*2 + ab
__device__ __forceinline__ void ld(Fp12& r, const u32* p, long i) {
    for (int a = 0; a < 2; a++)
        for (int b = 0; b < 3; b++) ld(r.c[a].c[b], p, i * 6 + a * 3 + b);
}
__device__ __forceinline__ void st(u32* p, long i, const Fp12& f) {
    for (int a = 0; a < 2; a++)
        for (int b = 0; b < 3; b++) st(p, i * 6 + a * 3 + b, f.c[a].c[b]);
}
template <class F> __device__ __forceinline__ void ld(Jac<F>& r, const u32* X, const u32* Y,
                                                      const u32* Z, long i) {
    ld(r.X, X, i);
    ld(r.Y, Y, i);
    ld(r.Z, Z, i);
}
template <class F> __device__ __forceinline__ void st(u32* X, u32* Y, u32* Z, long i,
                                                      const Jac<F>& p) {
    st(X, i, p.X);
    st(Y, i, p.Y);
    st(Z, i, p.Z);
}

// ---- per-lane routines (one thread each in csrc/bls12_381.cu) ---------------

// window table [0..15]*B (ec._window_tables): even e doubles entry e/2, odd e
// adds B to entry e - 1
template <class F> __device__ __forceinline__ void window_table(Jac<F>* tab, const F& x,
                                                                const F& y) {
    jac_zero(tab[0]);
    tab[1].X = x;
    tab[1].Y = y;
    f_one(tab[1].Z);
#pragma unroll 1
    for (int e = 2; e < 16; e++) {
        if (e % 2 == 0) jac_double(tab[e], tab[e / 2]);
        else jac_add_full(tab[e], tab[e - 1], tab[1], -1, -1);
    }
}

// r*P (G1) and r*Q (G2) for lane i over shared MSB-first 4-bit digits
// [n_digits, n] (ec.gj_scalar_mul_windowed); zero scalars give exact zeros
// and no work, and the accumulator is not doubled while it is infinity
__device__ __forceinline__ void lane_gj_scalar_mul(long i, long n, int n_digits, const u32* pkx,
                                                   const u32* pky, const u32* sx, const u32* sy,
                                                   const int32_t* digits, u32* PX, u32* PY,
                                                   u32* PZ, u32* SX, u32* SY, u32* SZ) {
    Jac<Fp> a1;
    Jac<Fp2> a2;
    jac_zero(a1);
    jac_zero(a2);
    int any = 0;
    for (int d = 0; d < n_digits; d++) any |= digits[(long)d * n + i] & 15;
    if (!any) {
        st(PX, PY, PZ, i, a1);
        st(SX, SY, SZ, i, a2);
        return;
    }
    Jac<Fp> tab1[16];
    Jac<Fp2> tab2[16];
    Fp x1, y1;
    Fp2 x2, y2;
    ld(x1, pkx, i);
    ld(y1, pky, i);
    ld(x2, sx, i);
    ld(y2, sy, i);
    window_table(tab1, x1, y1);
    window_table(tab2, x2, y2);
    bool inf = true;
#pragma unroll 1
    for (int d = 0; d < n_digits; d++) {
        int digit = digits[(long)d * n + i] & 15;
#pragma unroll 1
        for (int k = 0; k < 4 && !inf; k++) {
            jac_double(a1, a1);
            jac_double(a2, a2);
        }
        bool pick_inf = digit == 0;
        jac_add_full(a1, a1, tab1[digit], inf, pick_inf);
        jac_add_full(a2, a2, tab2[digit], inf, pick_inf);
        inf = inf && pick_inf;
    }
    st(PX, PY, PZ, i, a1);
    st(SX, SY, SZ, i, a2);
}

// r*P for G1 lane i, P the affine row ``row`` of (xs, ys), over MSB-first
// 4-bit digits [n_digits, n] (the G1 half of lane_gj_scalar_mul;
// ec.g1_scalar_mul_windowed): a zero scalar gives exact zeros and no work
// (its row is never read), and the accumulator is not doubled while it is
// infinity
__device__ __forceinline__ void g1_scalar_mul_row(long i, long n, int n_digits, const u32* xs,
                                                  const u32* ys, long row,
                                                  const int32_t* digits, u32* X, u32* Y,
                                                  u32* Z) {
    Jac<Fp> a1;
    jac_zero(a1);
    int any = 0;
    for (int d = 0; d < n_digits; d++) any |= digits[(long)d * n + i] & 15;
    if (!any) {
        st(X, Y, Z, i, a1);
        return;
    }
    Jac<Fp> tab1[16];
    Fp x1, y1;
    ld(x1, xs, row);
    ld(y1, ys, row);
    window_table(tab1, x1, y1);
    bool inf = true;
#pragma unroll 1
    for (int d = 0; d < n_digits; d++) {
        int digit = digits[(long)d * n + i] & 15;
#pragma unroll 1
        for (int k = 0; k < 4 && !inf; k++) jac_double(a1, a1);
        bool pick_inf = digit == 0;
        jac_add_full(a1, a1, tab1[digit], inf, pick_inf);
        inf = inf && pick_inf;
    }
    st(X, Y, Z, i, a1);
}

// r*P for G1 lane i over its own affine row of (xs, ys)
__device__ __forceinline__ void lane_g1_scalar_mul(long i, long n, int n_digits, const u32* xs,
                                                   const u32* ys, const int32_t* digits, u32* X,
                                                   u32* Y, u32* Z) {
    g1_scalar_mul_row(i, n, n_digits, xs, ys, i, digits, X, Y, Z);
}

// r*P for G1 lane i, P read straight from row idx[i] of the resident table
// (tx, ty) with no gathered copy (msm._gather_fold's gather + windowed scan)
__device__ __forceinline__ void lane_g1_gather_scalar_mul(long i, long n, int n_digits,
                                                          const u32* tx, const u32* ty,
                                                          const int32_t* idx,
                                                          const int32_t* digits, u32* X, u32* Y,
                                                          u32* Z) {
    g1_scalar_mul_row(i, n, n_digits, tx, ty, (long)idx[i], digits, X, Y, Z);
}

// rows i and i + half of a G1 (or G2) lane array -> row i (one tree level)
template <class F> __device__ __forceinline__ void lane_add_halves(long i, long half, u32* X,
                                                                   u32* Y, u32* Z) {
    Jac<F> p, q;
    ld(p, X, Y, Z, i);
    ld(q, X, Y, Z, i + half);
    jac_add_full(p, p, q, -1, -1);
    st(X, Y, Z, i, p);
}

// Miller loop of lane i (ops/bls12_381.py batch_miller_loop with zp and zq)
__device__ __noinline__ void miller(Fp12& f, const Fp& xp, const Fp& yp, const Fp& zp,
                                    const Fp2& xq, const Fp2& yq, const Fp2& zq) {
    Fp zp2, xz, zp3;
    Fp2 zxq, zyq, zq2, zq3, xzq2, ypq3;
    fp_mul(zp2, zp, zp);
    fp_mul(xz, xp, zp);
    fp_mul(zp3, zp2, zp);
    fp2_mul_fp(zxq, xq, zp3);
    fp2_mul_fp(zyq, yq, zp3);
    fp2_mul(zq2, zq, zq);
    fp2_mul(zq3, zq2, zq);
    fp2_mul_fp(xzq2, zq2, xz);
    fp2_mul_fp(ypq3, zq3, yp);
    Fp2 X = xq, Y = yq, Z = zq;
    fp12_one(f);
#pragma unroll 1
    for (int b = 62; b >= 0; b--) {
        int bit = (int)((BLS_X_ABS >> b) & 1);
        Fp2 xx, yy, zz, yz, Z3, E, xxx, xxzz, yzzz, c4, xb, t, ff, zz2, z3zq, D, X3, a0, s_a1,
            s_b1, ey, a1, b1, a0s, zzz, xqzz2, u1, Y3, H, yqzzz, dl, s1, z3ah, Nl, nxq, dyq,
            c1a, d1a, hh, c0a, I4, rvec, j, v, rr, X3a, rv, yj, Y3a, Z3a, tmp;
        Fp12 fsq, fdbl;
        fp2_mul(xx, X, X);
        fp2_mul(yy, Y, Y);
        fp2_mul(zz, Z, Z);
        fp2_mul(yz, Y, Z);
        fp12_sqr(fsq, f);
        fp2_scale(Z3, yz, 2);
        fp2_scale(E, xx, 3);
        fp2_add(xb, X, yy);
        fp2_mul(xxx, xx, X);
        fp2_mul(xxzz, xx, zz);
        fp2_mul(yzzz, yz, zz);
        fp2_mul(c4, yy, yy);
        fp2_mul(t, xb, xb);
        fp2_mul(ff, E, E);
        fp2_sub(D, t, xx);
        fp2_sub(D, D, c4);
        fp2_scale(D, D, 2);
        fp2_scale(tmp, D, 2);
        fp2_sub(X3, ff, tmp);
        fp2_scale(a0, xxx, 3);
        fp2_scale(tmp, yy, 2);
        fp2_sub(a0, a0, tmp);
        fp2_scale(s_a1, xxzz, 3);
        fp2_scale(s_b1, yzzz, 2);
        fp2_sub(tmp, D, X3);
        fp2_mul(ey, E, tmp);
        fp2_mul_fp(a1, s_a1, xz);
        fp2_neg(a1, a1);
        fp2_mul_fp(b1, s_b1, yp);
        fp2_mul_fp(a0s, a0, zp3);
        fp2_scale(tmp, c4, 8);
        fp2_sub(Y3, ey, tmp);
        fp12_mul_line(fdbl, fsq, a0s, a1, b1);
        if (!bit) {
            f = fdbl;
            X = X3;
            Y = Y3;
            Z = Z3;
            continue;
        }
        // add step: the chord through 2T and Q (computed only on set bits)
        fp2_mul(zz2, Z3, Z3);
        fp2_mul(z3zq, Z3, zq);
        fp2_mul(zzz, Z3, zz2);
        fp2_mul(xqzz2, xq, zz2);
        fp2_mul(u1, X3, zq2);
        fp2_sub(H, xqzz2, u1);
        fp2_mul(yqzzz, yq, zzz);
        fp2_neg(tmp, H);
        fp2_mul(dl, tmp, Z3);
        fp2_mul(s1, Y3, zq3);
        fp2_mul(z3ah, z3zq, H);
        fp2_sub(Nl, s1, yqzzz);
        fp2_mul(nxq, Nl, zxq);
        fp2_mul(dyq, dl, zyq);
        fp2_mul(c1a, Nl, xzq2);
        fp2_neg(c1a, c1a);
        fp2_mul(d1a, dl, ypq3);
        fp2_mul(hh, H, H);
        fp2_sub(c0a, nxq, dyq);
        fp2_scale(I4, hh, 4);
        fp2_sub(rvec, yqzzz, s1);
        fp2_scale(rvec, rvec, 2);
        fp12_mul_line(f, fdbl, c0a, c1a, d1a);
        fp2_mul(j, H, I4);
        fp2_mul(v, u1, I4);
        fp2_mul(rr, rvec, rvec);
        fp2_sub(X3a, rr, j);
        fp2_scale(tmp, v, 2);
        fp2_sub(X3a, X3a, tmp);
        fp2_sub(tmp, v, X3a);
        fp2_mul(rv, rvec, tmp);
        fp2_mul(yj, s1, j);
        fp2_scale(tmp, yj, 2);
        fp2_sub(Y3a, rv, tmp);
        fp2_scale(Z3a, z3ah, 2);
        X = X3a;
        Y = Y3a;
        Z = Z3a;
    }
    fp12_conj(f, f);
}

// Miller lanes [0, n): P Jacobian (xp, yp, zp), Q Jacobian (xq, yq, zq);
// lanes with mask 0 give one, and lane sum_lane takes its mask from zq != 0
// (the Σ r·sig lane of bls_backend._pipeline_fused).  Lanes [n, n_out) are
// the product tree's padding: one.
__device__ __forceinline__ void lane_miller(long i, long n, long sum_lane, const u32* xp,
                                            const u32* yp, const u32* zp, const u32* xq,
                                            const u32* yq, const u32* zq, const uint8_t* mask,
                                            u32* out) {
    Fp12 f;
    fp12_one(f);
    if (i < n) {
        Fp2 zqi;
        ld(zqi, zq, i);
        bool m = i == sum_lane ? !fp2_is_zero(zqi) : mask[i] != 0;
        if (m) {
            Fp a, b, c;
            Fp2 x, y;
            ld(a, xp, i);
            ld(b, yp, i);
            ld(c, zp, i);
            ld(x, xq, i);
            ld(y, yq, i);
            miller(f, a, b, c, x, y, zqi);
        }
    }
    st(out, i, f);
}

// one Fq12 product; a factor equal to one (a masked or padding Miller
// lane) returns the other with no product
__device__ __forceinline__ void lane_fq12_mul(long i, const u32* a, const u32* b, u32* out) {
    Fp12 x, y;
    ld(x, a, i);
    ld(y, b, i);
    if (fp12_is_one(x)) x = y;
    else if (!fp12_is_one(y)) fp12_mul(x, x, y);
    st(out, i, x);
}

// psi membership of affine G2 lane i (ec.g2_subgroup_verdict_batch)
__device__ __forceinline__ void lane_g2_subgroup(long i, const u32* xq, const u32* yq,
                                                 uint8_t* out) {
    Fp2 x, y, px, py, z2, z3, xz, yz, d1, d2, cx, cy;
    ld(x, xq, i);
    ld(y, yq, i);
    Jac<Fp2> T;
    jac_zero(T);
    bool inf = true;
#pragma unroll 1
    for (int b = 63; b >= 0; b--) dbl_add_step(T, inf, x, y, (int)((BLS_X_ABS >> b) & 1));
    if (inf) jac_zero(T);
    for (int k = 0; k < 12; k++) {
        cx.c[0].w[k] = PSI_CX_W[0][k];
        cx.c[1].w[k] = PSI_CX_W[1][k];
        cy.c[0].w[k] = PSI_CY_W[0][k];
        cy.c[1].w[k] = PSI_CY_W[1][k];
    }
    fp_mul(px.c[0], x.c[1], cx.c[1]);      // conj(x) * cx with cx = c u
    fp_mul(px.c[1], x.c[0], cx.c[1]);
    fp2_conj(py, y);
    fp2_mul(py, py, cy);
    fp2_mul(z2, T.Z, T.Z);
    fp2_mul(xz, px, z2);
    fp2_mul(z3, z2, T.Z);
    fp2_mul(yz, py, z3);
    fp2_sub(d1, xz, T.X);
    fp2_add(d2, yz, T.Y);
    out[i] = fp2_is_zero(d1) && fp2_is_zero(d2) && !fp2_is_zero(T.Z);
}

// a^(p-2) (0 -> 0), square-and-multiply over the exponent's bits
__device__ __noinline__ void fp_inv(Fp& r, const Fp& a) {
    Fp out;
    fp_one(out);
#pragma unroll 1
    for (int b = 380; b >= 0; b--) {
        fp_mul(out, out, out);
        if ((PM2_W[b / 32] >> (b % 32)) & 1) fp_mul(out, out, a);
    }
    r = out;
}

// Jacobian p -> affine row g of (xa, ya) and its infinity flag; an infinity
// row (Z == 0, whose inverse is 0) comes out as zeros
__device__ __forceinline__ void g1_affine_out(long g, const Jac<Fp>& p, u32* xa, u32* ya,
                                              uint8_t* inf) {
    Fp zi, zi2, zi3, x, y;
    fp_inv(zi, p.Z);
    fp_mul(zi2, zi, zi);
    fp_mul(x, p.X, zi2);
    fp_mul(zi3, zi2, zi);
    fp_mul(y, p.Y, zi3);
    st(xa, g, x);
    st(ya, g, y);
    inf[g] = fp_is_zero(p.Z);
}

// segment g of the blinded fold after its tree: add the known blinding
// total -U = (ux, uy, 1), convert to affine, flag infinity
// (msm._blinded_fold)
__device__ __forceinline__ void lane_blinded_final(long g, const u32* X, const u32* Y,
                                                   const u32* Z, const u32* ux, const u32* uy,
                                                   u32* xa, u32* ya, uint8_t* inf) {
    Jac<Fp> p, u;
    ld(p, X, Y, Z, g);
    ld(u.X, ux, 0);
    ld(u.Y, uy, 0);
    fp_one(u.Z);
    jac_add_full(p, p, u, -1, -1);
    g1_affine_out(g, p, xa, ya, inf);
}

// segment g of the gather fold after its tree: affine and the infinity flag
// (msm._gather_fold's g1_jacobian_to_affine_batch and is_zero_mod_p)
__device__ __forceinline__ void lane_g1_affine(long g, const u32* X, const u32* Y, const u32* Z,
                                               u32* xa, u32* ya, uint8_t* inf) {
    Jac<Fp> p;
    ld(p, X, Y, Z, g);
    g1_affine_out(g, p, xa, ya, inf);
}

// G1 membership of affine lane i (ec.g1_subgroup_verdict_batch): S = [r-1]P
// by the fixed MSB-first double-and-add scan of ec._scalar_mul_batch, then
// d1 = x*Z^2 - X and d2 = y*Z^3 + Y; a member gives S = -P, so d1 == d2 == 0
// with Z != 0.  Fail-closed: a small-order point that meets the H == 0
// chord mid-scan drives Z to 0 for good and reads false.
__device__ __forceinline__ void lane_g1_subgroup(long i, const u32* xp, const u32* yp,
                                                 uint8_t* out) {
    Fp x, y, z2, z3, xz, yz, d1, d2;
    ld(x, xp, i);
    ld(y, yp, i);
    Jac<Fp> T;
    jac_zero(T);
    bool inf = true;
#pragma unroll 1
    for (int b = BLS_RM1_BITS - 1; b >= 0; b--)
        dbl_add_step(T, inf, x, y, (int)((RM1_W[b / 32] >> (b % 32)) & 1));
    if (inf) jac_zero(T);
    fp_mul(z2, T.Z, T.Z);
    fp_mul(xz, x, z2);
    fp_mul(z3, z2, T.Z);
    fp_mul(yz, y, z3);
    fp_sub(d1, xz, T.X);
    fp_add(d2, yz, T.Y);
    out[i] = fp_is_zero(d1) && fp_is_zero(d2) && !fp_is_zero(T.Z);
}

// ---- row 9: the hard part of the final exponentiation ------------------------
//
// (m^((p^4 - p^2 + 1)/r))^3 for a cyclotomic m, the x-ladder of
// ops/bls12_381.py:702 final_exp_hard_device (JAX package) with its host
// oracle crypto/bls/fields.final_exp_hard: five m^x exponentiations, a few
// Fq12 products and the Frobenius maps p, p^2, p^3.

// gamma_k = xi^(k (p-1)/6), k = 1..5 (Montgomery), the Frobenius twists
__constant__ u32 FROB_G_W[5][2][12] = {
    {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
      0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
     {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
      0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
      0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}},
    {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
    {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
      0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
      0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu},
     {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
      0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}}};

// (a + bu)^2 = (a + b)(a - b) + 2ab u: 2 Fp products
__device__ __noinline__ void fp2_sqr(Fp2& r, const Fp2& x) {
    Fp s, d, ab;
    fp_add(s, x.c[0], x.c[1]);
    fp_sub(d, x.c[0], x.c[1]);
    fp_mul(ab, x.c[0], x.c[1]);
    fp_mul(r.c[0], s, d);
    fp_add(r.c[1], ab, ab);
}

// 3a - 2g (sub) or 3a + 2g (add): the Granger-Scott output combination
__device__ __forceinline__ void gs_out(Fp2& z, const Fp2& a, const Fp2& g, bool add) {
    Fp2 t;
    if (add) fp2_add(t, a, g);
    else fp2_sub(t, a, g);
    fp2_add(t, t, t);
    fp2_add(z, t, a);
}

// Granger-Scott squaring of a cyclotomic element (JAX fp12_cyclotomic_sqr,
// ops/bls12_381.py:649): coefficients x = (g0, g1, g2) + (g3, g4, g5) w,
// 9 Fp2 squarings.  Wrong for an element outside the cyclotomic subgroup.
__device__ __noinline__ void fp12_cyclotomic_sqr(Fp12& r, const Fp12& x) {
    const Fp2 &g0 = x.c[0].c[0], &g1 = x.c[0].c[1], &g2 = x.c[0].c[2];
    const Fp2 &g3 = x.c[1].c[0], &g4 = x.c[1].c[1], &g5 = x.c[1].c[2];
    Fp2 t0, t1, t2, t3, t4, t5, t6, t7, t8, s, a0, a2, a4;
    fp2_sqr(t0, g4);
    fp2_sqr(t1, g0);
    fp2_add(s, g4, g0);
    fp2_sqr(t6, s);
    fp2_sub(t6, t6, t0);
    fp2_sub(t6, t6, t1);                    // 2 g0 g4
    fp2_sqr(t2, g2);
    fp2_sqr(t3, g3);
    fp2_add(s, g2, g3);
    fp2_sqr(t7, s);
    fp2_sub(t7, t7, t2);
    fp2_sub(t7, t7, t3);                    // 2 g2 g3
    fp2_sqr(t4, g5);
    fp2_sqr(t5, g1);
    fp2_add(s, g5, g1);
    fp2_sqr(t8, s);
    fp2_sub(t8, t8, t4);
    fp2_sub(t8, t8, t5);
    fp2_mul_xi(t8, t8);                     // 2 g1 g5 xi
    fp2_mul_xi(a0, t0);
    fp2_add(a0, a0, t1);                    // g4^2 xi + g0^2
    fp2_mul_xi(a2, t2);
    fp2_add(a2, a2, t3);
    fp2_mul_xi(a4, t4);
    fp2_add(a4, a4, t5);
    Fp12 z;
    gs_out(z.c[0].c[0], a0, g0, false);
    gs_out(z.c[0].c[1], a2, g1, false);
    gs_out(z.c[0].c[2], a4, g2, false);
    gs_out(z.c[1].c[0], t8, g3, true);
    gs_out(z.c[1].c[1], t6, g4, true);
    gs_out(z.c[1].c[2], t7, g5, true);
    r = z;
}

__device__ __forceinline__ void frob_gamma(Fp2& g, int k) {
    for (int w = 0; w < 12; w++) {
        g.c[0].w[w] = FROB_G_W[k - 1][0][w];
        g.c[1].w[w] = FROB_G_W[k - 1][1][w];
    }
}

// f^(p^n) (JAX fp12_frobenius, ops/bls12_381.py:631): n rounds of
// coefficient conjugation and the gamma twists, 5 Fp2 products a round
__device__ __noinline__ void fp12_frobenius(Fp12& r, const Fp12& f, int n) {
    Fp12 x = f;
    Fp2 g, c;
#pragma unroll 1
    for (int i = 0; i < n; i++) {
        fp2_conj(x.c[0].c[0], x.c[0].c[0]);
        const int ks[5] = {2, 4, 1, 3, 5};      // a1, a2, b0, b1, b2
        for (int j = 0; j < 5; j++) {
            Fp2& e = x.c[(j + 1) / 3].c[(j + 1) % 3];
            frob_gamma(g, ks[j]);
            fp2_conj(c, e);
            fp2_mul(e, c, g);
        }
    }
    r = x;
}

// f^x for the negative curve parameter x, f cyclotomic (JAX _cyc_exp_x,
// ops/bls12_381.py:687): a cyclotomic squaring per bit of |x| after the
// top one, a product on the 5 set bits (the kernel branches on the public
// constant where the JAX program multiplies on every bit and selects:
// same values), then the conjugation for the sign
__device__ __noinline__ void cyc_exp_x(Fp12& r, const Fp12& f) {
    Fp12 out = f;
#pragma unroll 1
    for (int b = 62; b >= 0; b--) {
        fp12_cyclotomic_sqr(out, out);
        if ((BLS_X_ABS >> b) & 1) fp12_mul(out, out, f);
    }
    fp12_conj(r, out);
}

// lane i of Fq12 rows [N, 12, 12]: out = (m^((p^4 - p^2 + 1)/r))^3
__device__ __forceinline__ void lane_final_exp_hard(long i, const u32* in, u32* out) {
    Fp12 m, t1, a, g3, g2, g1, g0;
    ld(m, in, i);
    cyc_exp_x(t1, m);                       // m^x
    cyc_exp_x(g3, t1);
    fp12_cyclotomic_sqr(a, t1);
    fp12_conj(a, a);
    fp12_mul(g3, g3, a);
    fp12_mul(g3, g3, m);                    // m^(x^2 - 2x + 1)
    cyc_exp_x(g2, g3);                      // m^(x c3)
    cyc_exp_x(g1, g2);
    fp12_conj(a, g3);
    fp12_mul(g1, g1, a);                    // m^(x c2 - c3)
    cyc_exp_x(g0, g1);
    fp12_cyclotomic_sqr(a, m);
    fp12_mul(g0, g0, a);
    fp12_mul(g0, g0, m);                    // m^(x c1 + 3)
    fp12_frobenius(a, g1, 1);
    fp12_mul(g0, g0, a);
    fp12_frobenius(a, g2, 2);
    fp12_mul(g0, g0, a);
    fp12_frobenius(a, g3, 3);
    fp12_mul(g0, g0, a);
    st(out, i, g0);
}

}  // namespace bls
