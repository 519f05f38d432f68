// BLS12-381 scalar field Fr and the per-thread pieces of the KZG kernels of
// csrc/kzg.cu (sm_90a).
//
// Counterpart of lighthouse_tpu/ops/fr.py.  Elements are 8 x 32-bit
// little-endian words, FULLY REDUCED in [0, r), Montgomery R = 2^256:
// a value has one encoding, so "is zero" and equality are word compares.
// Multiplication is word-serial CIOS Montgomery (-r^-1 mod 2^32 =
// 0xffffffff, since r = 1 mod 2^32) with operands and accumulator in
// registers: PTX carry chains on the card, inlined; 64-bit accumulators in
// the host build.  Every add, sub and product ends fully reduced.
// lighthouse_tpu_torch/ops/fr.py holds the same arithmetic as plain
// PyTorch.
//
// Everything a kernel computes per thread is a function here, so the same
// code also compiles as host C++ (g++ -x c++), which the CPU tests use to
// check the arithmetic without a card.

#pragma once
#include <cstdint>

#include "modinv.cuh"

#ifndef __CUDACC__
#include <cstring>
#include <vector>
#define __host__
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
// r in signed 30-bit limbs and r^-1 mod 2^30 (csrc/modinv.cuh), and R^3 mod
// r: a Montgomery product by it turns (aR)^-1 into a^-1 R
__constant__ int32_t R30[9] = {0x00000001, 0x3ffffffc, 0x3fe5bfef, 0x2f6900bf, 0x21d80553,
                               0x27602026, 0x17d48333, 0x29d4ca67, 0x000073ed};
#define R_INV30 0x1u
__constant__ u32 R3_W[8] = {0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u,
                            0xc7b5f418u, 0x73d13c71u, 0xc8db33e9u, 0x6e2a5bb9u};

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
#ifdef __CUDACC__
// In registers: per word b_i of b, t += a*b_i as a carry chain of low
// halves and one of high halves, then t += m*r with m = t_0 * (-r^-1) and a
// shift by one word; each chain is one asm statement (PTX keeps the carry
// flag only inside a statement).  With a < 2^256 the rows stay below 2^289,
// so 10 words hold t and no chain carries out of its last word.
__device__ __forceinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
    u32 t[10];
#pragma unroll
    for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        u32 bi = b.w[i];
        asm("{\n\t"
            "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
            "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
            "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
            "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
            "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
            "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
            "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
            "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
            "addc.cc.u32 %8, %8, 0;\n\t"
            "addc.u32 %9, %9, 0;"
            "\n\t}"
            : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
              "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
            : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
              "r"(a.w[6]), "r"(a.w[7]), "r"(bi));
        asm("{\n\t"
            "mad.hi.cc.u32 %0, %9, %17, %0;\n\t"
            "madc.hi.cc.u32 %1, %10, %17, %1;\n\t"
            "madc.hi.cc.u32 %2, %11, %17, %2;\n\t"
            "madc.hi.cc.u32 %3, %12, %17, %3;\n\t"
            "madc.hi.cc.u32 %4, %13, %17, %4;\n\t"
            "madc.hi.cc.u32 %5, %14, %17, %5;\n\t"
            "madc.hi.cc.u32 %6, %15, %17, %6;\n\t"
            "madc.hi.cc.u32 %7, %16, %17, %7;\n\t"
            "addc.u32 %8, %8, 0;"
            "\n\t}"
            : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
              "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
            : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
              "r"(a.w[6]), "r"(a.w[7]), "r"(bi));
        u32 m = t[0] * FR_NP32;
        asm("{\n\t"
            "mad.lo.cc.u32 %0, %10, 0x00000001, %0;\n\t"
            "madc.lo.cc.u32 %1, %10, 0xffffffff, %1;\n\t"
            "madc.lo.cc.u32 %2, %10, 0xfffe5bfe, %2;\n\t"
            "madc.lo.cc.u32 %3, %10, 0x53bda402, %3;\n\t"
            "madc.lo.cc.u32 %4, %10, 0x09a1d805, %4;\n\t"
            "madc.lo.cc.u32 %5, %10, 0x3339d808, %5;\n\t"
            "madc.lo.cc.u32 %6, %10, 0x299d7d48, %6;\n\t"
            "madc.lo.cc.u32 %7, %10, 0x73eda753, %7;\n\t"
            "addc.cc.u32 %8, %8, 0;\n\t"
            "addc.u32 %9, %9, 0;"
            "\n\t}"
            : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
              "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
            : "r"(m));
        asm("{\n\t"
            "mad.hi.cc.u32 %0, %9, 0x00000001, %0;\n\t"
            "madc.hi.cc.u32 %1, %9, 0xffffffff, %1;\n\t"
            "madc.hi.cc.u32 %2, %9, 0xfffe5bfe, %2;\n\t"
            "madc.hi.cc.u32 %3, %9, 0x53bda402, %3;\n\t"
            "madc.hi.cc.u32 %4, %9, 0x09a1d805, %4;\n\t"
            "madc.hi.cc.u32 %5, %9, 0x3339d808, %5;\n\t"
            "madc.hi.cc.u32 %6, %9, 0x299d7d48, %6;\n\t"
            "madc.hi.cc.u32 %7, %9, 0x73eda753, %7;\n\t"
            "addc.u32 %8, %8, 0;"
            "\n\t}"
            : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
              "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
            : "r"(m));
#pragma unroll
        for (int j = 0; j < 9; j++) t[j] = t[j + 1];
        t[9] = 0;
    }
    // t < 2r: subtract r once unless that borrows
    u32 d[8], bw;
    asm("{\n\t"
        "sub.cc.u32 %0, %9, 0x00000001;\n\t"
        "subc.cc.u32 %1, %10, 0xffffffff;\n\t"
        "subc.cc.u32 %2, %11, 0xfffe5bfe;\n\t"
        "subc.cc.u32 %3, %12, 0x53bda402;\n\t"
        "subc.cc.u32 %4, %13, 0x09a1d805;\n\t"
        "subc.cc.u32 %5, %14, 0x3339d808;\n\t"
        "subc.cc.u32 %6, %15, 0x299d7d48;\n\t"
        "subc.cc.u32 %7, %16, 0x73eda753;\n\t"
        "mov.u32 %8, 0;\n\t"
        "subc.u32 %8, %8, 0;"
        "\n\t}"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
          "=r"(d[7]), "=r"(bw)
        : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
          "r"(t[7]));
#pragma unroll
    for (int j = 0; j < 8; j++) r.w[j] = bw ? t[j] : d[j];
}
#else
// The host build's product: the same CIOS rows in 64-bit accumulators
inline void fr_mul(Fr& r, const Fr& a, const Fr& b) {
    FR_COUNT_MUL();
    u32 t[10];
    for (int i = 0; i < 10; i++) t[i] = 0;
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
#endif

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

// a^-1 (0 -> 0) by the divstep inversion (csrc/modinv.cuh) of aR, then the
// Montgomery product by R^3
__device__ __forceinline__ void fr_inv_var(Fr& r, const Fr& a) {
    Fr t, r3;
    modinv::inv_var<9, 8>(t.w, a.w, R30, R_INV30);
    for (int k = 0; k < 8; k++) r3.w[k] = R3_W[k];
    fr_mul(r, t, r3);
}

__device__ __forceinline__ void ld(Fr& r, const u32* p, long i) {
    for (int k = 0; k < 8; k++) r.w[k] = p[i * 8 + k];
}
__device__ __forceinline__ void st(u32* p, long i, const Fr& a) {
    for (int k = 0; k < 8; k++) p[i * 8 + k] = a.w[k];
}

// ---- row 16: raw big-endian bytes -> Montgomery words -----------------------
// An element is two 16-byte chunks in (32 big-endian bytes) and two out (8
// words), each byte read once and each word written once, streamed past
// the caches; both pointers 16-byte aligned (the wrapper checks).  A load's
// words are little-endian, so word k of the value is the byte swap of
// loaded word 7 - k.  A thread of k_fr_to_mont takes FR_TO_MONT_PER
// elements a block's width apart and issues all their loads before its
// first product.

#define FR_TO_MONT_PER 2

struct W4 { u32 x, y, z, w; };

__device__ __forceinline__ W4 ld16_stream(const uint8_t* p) {
#ifdef __CUDACC__
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    return {v.x, v.y, v.z, v.w};
#else
    W4 v;
    std::memcpy(&v, p, 16);
    return v;
#endif
}

__device__ __forceinline__ void st16_stream(u32* p, const W4& v) {
#ifdef __CUDACC__
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v.x, v.y, v.z, v.w));
#else
    std::memcpy(p, &v, 16);
#endif
}

__device__ __forceinline__ u32 bswap32(u32 v) {
#ifdef __CUDACC__
    return __byte_perm(v, 0, 0x0123);
#else
    return __builtin_bswap32(v);
#endif
}

// element i, loaded as (lo, hi) -> x·R mod r into out's words [i*8, i*8 + 8)
__device__ __forceinline__ void fr_to_mont_store(const W4& lo, const W4& hi, const Fr& r2,
                                                 u32* out, long i) {
    Fr x;
    x.w[0] = bswap32(hi.w);
    x.w[1] = bswap32(hi.z);
    x.w[2] = bswap32(hi.y);
    x.w[3] = bswap32(hi.x);
    x.w[4] = bswap32(lo.w);
    x.w[5] = bswap32(lo.z);
    x.w[6] = bswap32(lo.y);
    x.w[7] = bswap32(lo.x);
    fr_mul(x, x, r2);
    st16_stream(out + i * 8, {x.w[0], x.w[1], x.w[2], x.w[3]});
    st16_stream(out + i * 8 + 4, {x.w[4], x.w[5], x.w[6], x.w[7]});
}

// Thread t of block b, `threads` a block: elements
// (b * FR_TO_MONT_PER + j) * threads + t, j < FR_TO_MONT_PER, those below n;
// every load, then the products.
__device__ __forceinline__ void thread_fr_to_mont(long b, long t, long threads, long n,
                                                  const uint8_t* raw, u32* out) {
    W4 lo[FR_TO_MONT_PER], hi[FR_TO_MONT_PER];
#pragma unroll
    for (int j = 0; j < FR_TO_MONT_PER; j++) {
        const long i = (b * FR_TO_MONT_PER + j) * threads + t;
        if (i < n) {
            lo[j] = ld16_stream(raw + i * 32);
            hi[j] = ld16_stream(raw + i * 32 + 16);
        }
    }
    Fr r2;
#pragma unroll
    for (int k = 0; k < 8; k++) r2.w[k] = R2_W[k];
#pragma unroll
    for (int j = 0; j < FR_TO_MONT_PER; j++) {
        const long i = (b * FR_TO_MONT_PER + j) * threads + t;
        if (i < n) fr_to_mont_store(lo[j], hi[j], r2, out, i);
    }
}

#ifndef __CUDACC__
// k_fr_to_mont on the host: every thread of its grid (blocks of `threads`
// over the n elements), one after another
inline void host_fr_to_mont(const uint8_t* raw, u32* out, long n, long threads) {
    const long blocks = (n + threads * FR_TO_MONT_PER - 1) / (threads * FR_TO_MONT_PER);
    for (long b = 0; b < blocks; b++)
        for (long t = 0; t < threads; t++) thread_fr_to_mont(b, t, threads, n, raw, out);
}
#endif

// ---- row 15: the barycentric evaluation of one blob, by phases --------------
// A blob's domain is split into T chunks of CHUNK points, thread t owning
// [t*CHUNK, (t+1)*CHUNK).  tree[] holds 2T elements: leaves at [T, 2T), node
// k the product of nodes 2k and 2k + 1 (root 1).  The kernel runs the
// phases with a barrier between them; host_eval runs them in loops.

// The prefix products pre[j] = prod_{i<j} d_i a thread keeps from phase 1
// to phase 5, j = 1 .. CHUNK - 1 (pre[0] = 1 is never used): the last
// stored (j <= KREG) in registers, pushed and popped with constant indices
// so they stay there, the others in shared memory at
// sm[(j - KREG - 1) * stride] (the block's threads side by side).
#define EVAL_PRE_REGS 4
template <int CHUNK> struct EvalPre {
    static constexpr int KREG = CHUNK - 1 < EVAL_PRE_REGS ? CHUNK - 1 : EVAL_PRE_REGS;
    // shared Fr slots a thread needs
    static constexpr int SHARED = CHUNK - 1 - KREG;
    Fr reg[KREG > 0 ? KREG : 1];
    Fr* sm;
    int stride;

    // pre[j] for j = 1, 2, ... in turn
    __device__ __forceinline__ void push(int j, const Fr& v) {
        if (j <= KREG) {
#pragma unroll
            for (int k = KREG - 1; k > 0; k--) reg[k] = reg[k - 1];
            reg[0] = v;
        } else {
            sm[(j - KREG - 1) * stride] = v;
        }
    }
    // pre[j] for j = CHUNK - 1, CHUNK - 2, ... in turn
    __device__ __forceinline__ void pop(int j, Fr& v) {
        if (j <= KREG) {
            v = reg[0];
#pragma unroll
            for (int k = 0; k < KREG - 1; k++) reg[k] = reg[k + 1];
        } else {
            v = sm[(j - KREG - 1) * stride];
        }
    }
};

// phase 1: d_j = z - w_j over the chunk; pre[j] = prod_{i<j} d_i (no
// product for j = 0), prod = the chunk's product
template <int CHUNK>
__device__ __forceinline__ void eval_leaf(Fr& prod, EvalPre<CHUNK>& pre, const Fr& z,
                                          const u32* roots, long lo) {
    Fr w;
    ld(w, roots, lo);
    fr_sub(prod, z, w);
#pragma unroll 1
    for (int j = 1; j < CHUNK; j++) {
        Fr d;
        ld(w, roots, lo + j);
        fr_sub(d, z, w);
        pre.push(j, prod);
        fr_mul(prod, prod, d);
    }
}

// phase 2, up-sweep node k: tree[k] = tree[2k] * tree[2k + 1]
__device__ __forceinline__ void eval_up(Fr* tree, long k) {
    fr_mul(tree[k], tree[2 * k], tree[2 * k + 1]);
}

// phase 3, the root: ONE divstep inversion per blob (a zero product, a
// challenge on the domain, gives zero inverses everywhere)
__device__ __forceinline__ void eval_root(Fr* tree) { fr_inv_var(tree[1], tree[1]); }

// phase 4, down-sweep node k (tree[k] already inverted):
// inv(a) = b * inv(ab), inv(b) = a * inv(ab)
__device__ __forceinline__ void eval_down(Fr* tree, long k) {
    Fr a = tree[2 * k], b = tree[2 * k + 1], inv = tree[k];
    fr_mul(tree[2 * k], b, inv);
    fr_mul(tree[2 * k + 1], a, inv);
}

// phase 5: from the inverse of the chunk's product, each 1/d_j backwards
// (1/d_j = acc * pre[j], then acc *= d_j), and the sum of f_j * w_j / d_j
template <int CHUNK>
__device__ __forceinline__ void eval_terms(Fr& sum, EvalPre<CHUNK>& pre, const Fr& inv_chunk,
                                           const Fr& z, const u32* f_row, const u32* roots,
                                           long lo) {
    Fr acc = inv_chunk, w, fj, t;
    fr_zero(sum);
#pragma unroll 1
    for (int j = CHUNK - 1; j > 0; j--) {
        Fr pj, invd, d;
        ld(w, roots, lo + j);
        ld(fj, f_row, lo + j);
        pre.pop(j, pj);
        fr_mul(invd, acc, pj);
        fr_sub(d, z, w);
        fr_mul(acc, acc, d);
        fr_mul(t, fj, w);
        fr_mul(t, t, invd);
        fr_add(sum, sum, t);
    }
    ld(w, roots, lo);
    ld(fj, f_row, lo);
    fr_mul(t, fj, w);
    fr_mul(t, t, acc);
    fr_add(sum, sum, t);
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

// shared Fr slots of a block of T threads: the tree, then the prefix
// products' shared slots (EvalPre<CHUNK>::SHARED a thread)
__host__ __device__ __forceinline__ long eval_shared_slots(long threads, long chunk) {
    const long kreg = chunk - 1 < EVAL_PRE_REGS ? chunk - 1 : EVAL_PRE_REGS;
    return 2 * threads + (chunk - 1 - kreg) * threads;
}

// one blob: the phases for thread t of T (a barrier between phases), the
// block's shared memory at smem (eval_shared_slots)
#ifdef __CUDACC__
template <int CHUNK>
__device__ __forceinline__ void eval_blob(long b, int t, int T, long width, const u32* f,
                                          const u32* zs, const u32* roots, const u32* inv_w,
                                          u32* y, Fr* smem) {
    Fr* tree = smem;
    EvalPre<CHUNK> pre;
    pre.sm = smem + 2 * T + t;
    pre.stride = T;
    const long lo = (long)t * CHUNK;
    const u32* f_row = f + (size_t)b * width * 8;
    Fr z;
    ld(z, zs, b);
    Fr prod;
    eval_leaf<CHUNK>(prod, pre, z, roots, lo);
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
    eval_terms<CHUNK>(sum, pre, tree[T + t], z, f_row, roots, lo);
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
#else
// k_fr_eval on the host: per blob the same phases as loops over the block's
// T threads, on shared memory laid out as the kernel lays it out
template <int CHUNK>
inline void host_eval_chunk(const u32* f, const u32* zs, const u32* roots, const u32* inv_w,
                            u32* y, long n, long width) {
    const int T = (int)(width / CHUNK);
    std::vector<Fr> smem((size_t)eval_shared_slots(T, CHUNK));
    std::vector<EvalPre<CHUNK>> pre((size_t)T);
    Fr* tree = smem.data();
    for (long b = 0; b < n; b++) {
        Fr z;
        ld(z, zs, b);
        const u32* f_row = f + (size_t)b * width * 8;
        for (int t = 0; t < T; t++) {
            pre[t].sm = smem.data() + 2 * T + t;
            pre[t].stride = T;
            eval_leaf<CHUNK>(tree[T + t], pre[t], z, roots, (long)t * CHUNK);
        }
        for (int k = T / 2; k >= 1; k >>= 1)
            for (int t = 0; t < k; t++) eval_up(tree, k + t);
        eval_root(tree);
        for (int k = 1; k < T; k <<= 1)
            for (int t = 0; t < k; t++) eval_down(tree, k + t);
        for (int t = 0; t < T; t++) {
            Fr sum;
            eval_terms<CHUNK>(sum, pre[t], tree[T + t], z, f_row, roots, (long)t * CHUNK);
            tree[T + t] = sum;
        }
        for (int k = T / 2; k >= 1; k >>= 1)
            for (int t = 0; t < k; t++) fr_add(tree[T + t], tree[T + t], tree[T + t + k]);
        Fr iw, out;
        ld(iw, inv_w, 0);
        eval_scale(out, tree[T], z, iw, width);
        st(y, b, out);
    }
}

// host_eval_chunk at the kernel's chunk (width / threads, a power of two up
// to 16)
inline void host_eval(const u32* f, const u32* zs, const u32* roots, const u32* inv_w, u32* y,
                      long n, long width, int threads) {
    switch (width / threads) {
        case 16: host_eval_chunk<16>(f, zs, roots, inv_w, y, n, width); break;
        case 8: host_eval_chunk<8>(f, zs, roots, inv_w, y, n, width); break;
        case 4: host_eval_chunk<4>(f, zs, roots, inv_w, y, n, width); break;
        case 2: host_eval_chunk<2>(f, zs, roots, inv_w, y, n, width); break;
        default: host_eval_chunk<1>(f, zs, roots, inv_w, y, n, width); break;
    }
}
#endif

}  // namespace fr
