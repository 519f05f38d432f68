// BLS12-381 scalar field Fr and the per-thread pieces of the KZG kernels of
// csrc/kzg.cu (sm_90a).
//
// Counterpart of lighthouse_tpu/ops/fr.py.  Elements are 8 x 32-bit
// little-endian words, FULLY REDUCED in [0, r), Montgomery R = 2^256:
// a value has one encoding, so "is zero" and equality are word compares.
// Multiplication is word-serial CIOS Montgomery in 64-bit accumulators
// (-r^-1 mod 2^32 = 0xffffffff, since r = 1 mod 2^32); every add, sub and
// product ends fully reduced.  lighthouse_tpu_torch/ops/fr.py holds the same
// arithmetic as plain PyTorch.
//
// Everything a kernel computes per thread is a function here, so the same
// code also compiles as host C++ (g++ -x c++), which the CPU tests use to
// check the arithmetic without a card.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#endif

namespace fr {

typedef uint32_t u32;
typedef uint64_t u64;

struct Fr { u32 w[8]; };

__constant__ u32 R_W[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                           0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// 2^256 mod r: the Montgomery form of 1
__constant__ u32 ONE_W[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                             0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// 2^512 mod r: mont_mul(x, R2) = x in Montgomery form
__constant__ u32 R2_W[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                            0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
// r - 2: the Fermat inversion exponent (bit 254 is its top bit)
__constant__ u32 RM2_W[8] = {0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
                             0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
#define FR_NP32 0xffffffffu

// Host builds may count Fr multiplications (the CPU tests check the counts
// that bound the kernels' times against this code).
#ifdef FR_COUNT_MULS
extern unsigned long long fr_mul_count;
#define FR_COUNT_MUL() (fr_mul_count++)
#else
#define FR_COUNT_MUL()
#endif

__device__ __forceinline__ void fr_zero(Fr& r) {
    for (int i = 0; i < 8; i++) r.w[i] = 0;
}
__device__ __forceinline__ void fr_one(Fr& r) {
    for (int i = 0; i < 8; i++) r.w[i] = ONE_W[i];
}

// r = s - r_mod if s >= r_mod else s, for s < 2^256
__device__ __forceinline__ void fr_reduce_once(Fr& r, const u32* s) {
    u32 d[8];
    u64 br = 0;
    for (int i = 0; i < 8; i++) {
        u64 t = (u64)s[i] - R_W[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
    for (int i = 0; i < 8; i++) r.w[i] = br ? s[i] : d[i];
}

__device__ __forceinline__ void fr_add(Fr& r, const Fr& a, const Fr& b) {
    u32 s[8];
    u64 c = 0;
    for (int i = 0; i < 8; i++) {
        c += (u64)a.w[i] + b.w[i];
        s[i] = (u32)c;
        c >>= 32;
    }
    fr_reduce_once(r, s);      // a + b < 2r < 2^256: no carry out
}

__device__ __forceinline__ void fr_sub(Fr& r, const Fr& a, const Fr& b) {
    u32 d[8];
    u64 br = 0;
    for (int i = 0; i < 8; i++) {
        u64 t = (u64)a.w[i] - b.w[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
    u32 mask = br ? 0xffffffffu : 0u;   // a < b: add r back
    u64 c = 0;
    for (int i = 0; i < 8; i++) {
        c += (u64)d[i] + (R_W[i] & mask);
        r.w[i] = (u32)c;
        c >>= 32;
    }
}

// CIOS Montgomery product a*b*2^-256 mod r, for a < 2^256 and b < r
__device__ __noinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
    FR_COUNT_MUL();
    u32 t[10];
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll 1
    for (int i = 0; i < 8; i++) {
        u64 c = 0;
        u32 bi = b.w[i];
        for (int j = 0; j < 8; j++) {
            c += (u64)a.w[j] * bi + t[j];
            t[j] = (u32)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (u32)c;
        t[9] = (u32)(c >> 32);
        u32 m = t[0] * FR_NP32;
        c = ((u64)m * R_W[0] + t[0]) >> 32;
        for (int j = 1; j < 8; j++) {
            c += (u64)m * R_W[j] + t[j];
            t[j - 1] = (u32)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (u32)c;
        t[8] = t[9] + (u32)(c >> 32);
    }
    fr_reduce_once(r, t);      // t < 2r, t[8] == 0
}

// a^(r-2) (0 -> 0), square-and-multiply over the exponent's bits
__device__ __noinline__ void fr_inv(Fr& r, const Fr& a) {
    Fr out;
    fr_one(out);
#pragma unroll 1
    for (int b = 254; b >= 0; b--) {
        fr_mul(out, out, out);
        if ((RM2_W[b / 32] >> (b % 32)) & 1) fr_mul(out, out, a);
    }
    r = out;
}

__device__ __forceinline__ void ld(Fr& r, const u32* p, long i) {
    for (int k = 0; k < 8; k++) r.w[k] = p[i * 8 + k];
}
__device__ __forceinline__ void st(u32* p, long i, const Fr& a) {
    for (int k = 0; k < 8; k++) p[i * 8 + k] = a.w[k];
}

// ---- row 16: raw big-endian bytes -> Montgomery words -----------------------

__device__ __forceinline__ void lane_fr_to_mont(long i, const uint8_t* raw, u32* out) {
    const uint8_t* b = raw + i * 32;
    Fr x, r2;
    for (int k = 0; k < 8; k++) {
        x.w[k] = (u32)b[31 - 4 * k] | ((u32)b[30 - 4 * k] << 8) | ((u32)b[29 - 4 * k] << 16) |
                 ((u32)b[28 - 4 * k] << 24);
        r2.w[k] = R2_W[k];
    }
    fr_mul(x, x, r2);
    st(out, i, x);
}

// ---- row 15: the barycentric evaluation of one blob, by phases --------------
// A blob's domain is split into T chunks of `chunk` points, thread t owning
// [t*chunk, (t+1)*chunk).  tree[] holds 2T elements: leaves at [T, 2T), node
// k the product of nodes 2k and 2k + 1 (root 1).  The kernel runs the
// phases with a barrier between them; the CPU test runs them in loops.

// phase 1: d_j = z - w_j over the chunk; pre[j] = prod_{i<j} d_i (pre[0] = 1,
// no product), prod = the chunk's product
__device__ __forceinline__ void eval_leaf(Fr& prod, Fr* pre, const Fr& z, const u32* roots,
                                          long lo, int chunk) {
#pragma unroll 1
    for (int j = 0; j < chunk; j++) {
        Fr w, d;
        ld(w, roots, lo + j);
        fr_sub(d, z, w);
        if (j == 0) {
            fr_one(pre[0]);
            prod = d;
        } else {
            pre[j] = prod;
            fr_mul(prod, prod, d);
        }
    }
}

// phase 2, up-sweep node k: tree[k] = tree[2k] * tree[2k + 1]
__device__ __forceinline__ void eval_up(Fr* tree, long k) {
    fr_mul(tree[k], tree[2 * k], tree[2 * k + 1]);
}

// phase 3, the root: ONE Fermat inversion per blob (a zero product, a
// challenge on the domain, gives zero inverses everywhere)
__device__ __forceinline__ void eval_root(Fr* tree) { fr_inv(tree[1], tree[1]); }

// phase 4, down-sweep node k (tree[k] already inverted):
// inv(a) = b * inv(ab), inv(b) = a * inv(ab)
__device__ __forceinline__ void eval_down(Fr* tree, long k) {
    Fr a = tree[2 * k], b = tree[2 * k + 1], inv = tree[k];
    fr_mul(tree[2 * k], b, inv);
    fr_mul(tree[2 * k + 1], a, inv);
}

// phase 5: from the inverse of the chunk's product, each 1/d_j backwards
// (1/d_j = acc * pre[j], then acc *= d_j), and the sum of f_j * w_j / d_j
__device__ __forceinline__ void eval_terms(Fr& sum, const Fr* pre, const Fr& inv_chunk,
                                           const Fr& z, const u32* f_row, const u32* roots,
                                           long lo, int chunk) {
    Fr acc = inv_chunk;
    fr_zero(sum);
#pragma unroll 1
    for (int j = chunk - 1; j >= 0; j--) {
        Fr w, fj, invd, t;
        ld(w, roots, lo + j);
        ld(fj, f_row, lo + j);
        if (j > 0) {
            Fr d;
            fr_mul(invd, acc, pre[j]);
            fr_sub(d, z, w);
            fr_mul(acc, acc, d);
        } else {
            invd = acc;
        }
        fr_mul(t, fj, w);
        fr_mul(t, t, invd);
        fr_add(sum, sum, t);
    }
}

// phase 7: y = total * (z^W - 1) * inv_w (log2 W squarings)
__device__ __forceinline__ void eval_scale(Fr& y, const Fr& total, const Fr& z, const Fr& inv_w,
                                           long width) {
    Fr zw = z, one;
#pragma unroll 1
    for (long k = width; k > 1; k >>= 1) fr_mul(zw, zw, zw);
    fr_one(one);
    fr_sub(zw, zw, one);
    fr_mul(zw, zw, inv_w);
    fr_mul(y, total, zw);
}

}  // namespace fr
