// BLS12-381 field, tower, curve and per-lane routines for the batch-verify
// kernels of csrc/bls12_381.cu (sm_90a).
//
// Counterpart of lighthouse_tpu/ops/{bigint,bls12_381,ec}.py.  Elements are
// 12 x 32-bit little-endian words, FULLY REDUCED in [0, p), Montgomery
// R = 2^384: a value has one encoding, so "is zero" and equality are word
// compares.  Multiplication is CIOS Montgomery with operands and
// accumulator in registers (PTX carry chains on the card, 64-bit
// accumulators in the host build); every add, sub and product ends fully
// reduced.
//
// The tower products may use any formula (their value is unique).  The
// curve formulas and the Miller loop's line scalings follow the JAX package
// operation for operation, so the Jacobian coordinates and the Miller
// values equal it exactly (lighthouse_tpu_torch/ops/ec.py and
// ops/bls12_381.py hold the same sequences as plain PyTorch).
//
// Two ways to run a lane:
//
// - One thread a lane (the G1 membership check, the segment and G2 trees,
//   the affine conversion): the tower and curve routines below on values in
//   the thread's registers and stack.  Products from Fp2 upward, and the G1
//   curve routines' Fp product, are called rather than inlined, to bound the
//   code size and nvcc's time.  The one-thread psi check and final
//   exponentiation stay here as the host oracles of their group lanes.
// - A group of threads a lane (the scalar multiplications, the Miller loop,
//   the Fq12 product tree, the psi check, the final exponentiation's hard
//   part): the lane's state lives in shared memory, and
//   each step of its formula sequence runs from a tape.  The tower and curve
//   routines are templates over the base field, so the same source, run
//   once on the host on traced values (TV), records a step as Fp
//   operations; a scheduler cuts them into levels of operations that do not
//   depend on each other, lays each level out over the group's threads and
//   gives every value a shared-memory slot (csrc/bls_tapes.cc hands the
//   tapes to the card).  Thread t of the group runs positions t, t + width,
//   ... of a level in order, then the group syncs.  The products and their
//   values are those of the one-thread formulas; only where they run
//   differs.
//
// Everything a kernel computes per lane is a function here, so the same
// code also compiles as host C++ (g++ -x c++), which the CPU tests use to
// check the arithmetic without a card: a group's threads run one after
// another on the host, in an order the tests can reverse.

#pragma once
#include <cstdint>

#include "modinv.cuh"

#ifndef __CUDACC__
#include <algorithm>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#endif

namespace bls {

typedef uint32_t u32;
typedef uint64_t u64;

// 16-byte aligned, so that a slot in shared memory loads as three vectors
struct alignas(16) Fp { u32 w[12]; };

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
#define NP32 0xfffcfffdu
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
// beta, the primitive cube root of unity of Fp whose map (x, y) -> (beta x, y)
// acts on G1 as [-z^2] (Montgomery; the other root acts as [z^2 - 1]), and
// the curve's b = 4: the G1 membership lane's constants
__constant__ u32 BETA_W[12] = {
    0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
    0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu};
__constant__ u32 B4_W[12] = {
    0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au,
    0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
// p in signed 30-bit limbs and p^-1 mod 2^30 (csrc/modinv.cuh), and R^3 mod
// p: a Montgomery product by it turns (aR)^-1 into a^-1 R
__constant__ int32_t P30[13] = {
    0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da, 0x112bf673,
    0x12e13ce1, 0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9, 0x001a0111};
#define P_INV30 0x30003u
__constant__ u32 R3_W[12] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
    0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

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
#pragma unroll
    for (int i = 0; i < 12; i++) r.w[i] = 0;
}
__device__ __forceinline__ void fp_one(Fp& r) {
#pragma unroll
    for (int i = 0; i < 12; i++) r.w[i] = ONE_W[i];
}
__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
    u32 acc = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) acc |= a.w[i];
    return acc == 0;
}

// r = s - p if s >= p else s, for s < 2^384 (words in s)
__device__ __forceinline__ void fp_reduce_once(Fp& r, const u32* s) {
    u32 d[12];
    u64 br = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        u64 t = (u64)s[i] - P_W[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
#pragma unroll
    for (int i = 0; i < 12; i++) r.w[i] = br ? s[i] : d[i];
}

// The linear operations a tape holds (OP_LIN): r = X + Y with X = x or 0
// and Y = y or p - y, by these flags
enum LinFlags { LIN_X = 1, LIN_NEG_Y = 2 };

#ifdef __CUDACC__
// The card's adds and subtracts: PTX carry chains, each one asm statement.
__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
    u32 s[12], d[12], bw;
#pragma unroll
    for (int j = 0; j < 12; j++) s[j] = a.w[j];
    asm("{\n\t"
        "add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;"
        "\n\t}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
          "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11])
        : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]),
          "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]), "r"(b.w[10]), "r"(b.w[11]));
    // a + b < 2p < 2^382: subtract p unless that borrows
    asm("{\n\t"
        "sub.cc.u32 %0, %13, 0xffffaaab;\n\t"
        "subc.cc.u32 %1, %14, 0xb9feffff;\n\t"
        "subc.cc.u32 %2, %15, 0xb153ffff;\n\t"
        "subc.cc.u32 %3, %16, 0x1eabfffe;\n\t"
        "subc.cc.u32 %4, %17, 0xf6b0f624;\n\t"
        "subc.cc.u32 %5, %18, 0x6730d2a0;\n\t"
        "subc.cc.u32 %6, %19, 0xf38512bf;\n\t"
        "subc.cc.u32 %7, %20, 0x64774b84;\n\t"
        "subc.cc.u32 %8, %21, 0x434bacd7;\n\t"
        "subc.cc.u32 %9, %22, 0x4b1ba7b6;\n\t"
        "subc.cc.u32 %10, %23, 0x397fe69a;\n\t"
        "subc.cc.u32 %11, %24, 0x1a0111ea;\n\t"
        "mov.u32 %12, 0;\n\t"
        "subc.u32 %12, %12, 0;"
        "\n\t}"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
          "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(bw)
        : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]),
          "r"(s[6]), "r"(s[7]), "r"(s[8]), "r"(s[9]), "r"(s[10]), "r"(s[11]));
#pragma unroll
    for (int j = 0; j < 12; j++) r.w[j] = bw ? s[j] : d[j];
}

__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
    u32 d[12], bw;
#pragma unroll
    for (int j = 0; j < 12; j++) d[j] = a.w[j];
    asm("{\n\t"
        "sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "mov.u32 %12, 0;\n\t"
        "subc.u32 %12, %12, 0;"
        "\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(bw)
        : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]),
          "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]), "r"(b.w[10]), "r"(b.w[11]));
    // a < b: add p back (bw is all ones)
    asm("{\n\t"
        ".reg .u32 k;\n\t"
        "and.b32 k, %12, 0xffffaaab;\n\t"
        "add.cc.u32 %0, %0, k;\n\t"
        "and.b32 k, %12, 0xb9feffff;\n\t"
        "addc.cc.u32 %1, %1, k;\n\t"
        "and.b32 k, %12, 0xb153ffff;\n\t"
        "addc.cc.u32 %2, %2, k;\n\t"
        "and.b32 k, %12, 0x1eabfffe;\n\t"
        "addc.cc.u32 %3, %3, k;\n\t"
        "and.b32 k, %12, 0xf6b0f624;\n\t"
        "addc.cc.u32 %4, %4, k;\n\t"
        "and.b32 k, %12, 0x6730d2a0;\n\t"
        "addc.cc.u32 %5, %5, k;\n\t"
        "and.b32 k, %12, 0xf38512bf;\n\t"
        "addc.cc.u32 %6, %6, k;\n\t"
        "and.b32 k, %12, 0x64774b84;\n\t"
        "addc.cc.u32 %7, %7, k;\n\t"
        "and.b32 k, %12, 0x434bacd7;\n\t"
        "addc.cc.u32 %8, %8, k;\n\t"
        "and.b32 k, %12, 0x4b1ba7b6;\n\t"
        "addc.cc.u32 %9, %9, k;\n\t"
        "and.b32 k, %12, 0x397fe69a;\n\t"
        "addc.cc.u32 %10, %10, k;\n\t"
        "and.b32 k, %12, 0x1a0111ea;\n\t"
        "addc.u32 %11, %11, k;"
        "\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "r"(bw));
#pragma unroll
    for (int j = 0; j < 12; j++) r.w[j] = d[j];
}

// X + Y mod p with X = x or 0 and Y = y or p - y (LinFlags): every linear
// operation of a tape in one code path, so a level's threads do not
// diverge.  s = X + (y or ~y + 1) carries c1 (for -y: no borrow); then
// u = s - p (an add: s - p as s + ~p + 1, carry c2: s >= p) or u = s + p;
// the result is u when s >= p, or when X - y borrowed.
__device__ __forceinline__ void fp_lin(Fp& r, const Fp& x, const Fp& y, int flags) {
    const u32 m = flags & LIN_NEG_Y ? 0xffffffffu : 0u, keep = flags & LIN_X ? 0xffffffffu : 0u;
    u32 s[12], yy[12], u[12], c1, c2;
#pragma unroll
    for (int j = 0; j < 12; j++) {
        s[j] = x.w[j] & keep;
        yy[j] = y.w[j] ^ m;
    }
    asm("{\n\t"
        "add.cc.u32 %12, %25, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "mov.u32 %12, 0;\n\t"
        "addc.u32 %12, %12, 0;"
        "\n\t}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
          "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11]), "=r"(c1)
        : "r"(yy[0]), "r"(yy[1]), "r"(yy[2]), "r"(yy[3]), "r"(yy[4]), "r"(yy[5]),
          "r"(yy[6]), "r"(yy[7]), "r"(yy[8]), "r"(yy[9]), "r"(yy[10]), "r"(yy[11]), "r"(m & 1u));
    asm("{\n\t"
        ".reg .u32 k;\n\t"
        "add.cc.u32 %12, %26, 0xffffffff;\n\t"
        "xor.b32 k, %25, 0xffffaaab;\n\t"
        "addc.cc.u32 %0, %13, k;\n\t"
        "xor.b32 k, %25, 0xb9feffff;\n\t"
        "addc.cc.u32 %1, %14, k;\n\t"
        "xor.b32 k, %25, 0xb153ffff;\n\t"
        "addc.cc.u32 %2, %15, k;\n\t"
        "xor.b32 k, %25, 0x1eabfffe;\n\t"
        "addc.cc.u32 %3, %16, k;\n\t"
        "xor.b32 k, %25, 0xf6b0f624;\n\t"
        "addc.cc.u32 %4, %17, k;\n\t"
        "xor.b32 k, %25, 0x6730d2a0;\n\t"
        "addc.cc.u32 %5, %18, k;\n\t"
        "xor.b32 k, %25, 0xf38512bf;\n\t"
        "addc.cc.u32 %6, %19, k;\n\t"
        "xor.b32 k, %25, 0x64774b84;\n\t"
        "addc.cc.u32 %7, %20, k;\n\t"
        "xor.b32 k, %25, 0x434bacd7;\n\t"
        "addc.cc.u32 %8, %21, k;\n\t"
        "xor.b32 k, %25, 0x4b1ba7b6;\n\t"
        "addc.cc.u32 %9, %22, k;\n\t"
        "xor.b32 k, %25, 0x397fe69a;\n\t"
        "addc.cc.u32 %10, %23, k;\n\t"
        "xor.b32 k, %25, 0x1a0111ea;\n\t"
        "addc.cc.u32 %11, %24, k;\n\t"
        "mov.u32 %12, 0;\n\t"
        "addc.u32 %12, %12, 0;"
        "\n\t}"
        : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3]), "=r"(u[4]), "=r"(u[5]),
          "=r"(u[6]), "=r"(u[7]), "=r"(u[8]), "=r"(u[9]), "=r"(u[10]), "=r"(u[11]), "=r"(c2)
        : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]),
          "r"(s[6]), "r"(s[7]), "r"(s[8]), "r"(s[9]), "r"(s[10]), "r"(s[11]), "r"(~m),
          "r"(~m & 1u));
    const bool use_u = m ? c1 == 0 : c2 != 0;
#pragma unroll
    for (int j = 0; j < 12; j++) r.w[j] = use_u ? u[j] : s[j];
}
#else
// The host build's adds and subtracts: 64-bit accumulators
inline void fp_add(Fp& r, const Fp& a, const Fp& b) {
    u32 s[12];
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        c += (u64)a.w[i] + b.w[i];
        s[i] = (u32)c;
        c >>= 32;
    }
    fp_reduce_once(r, s);      // a + b < 2p < 2^382: no carry out
}

inline void fp_sub(Fp& r, const Fp& a, const Fp& b) {
    u32 d[12];
    u64 br = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        u64 t = (u64)a.w[i] - b.w[i] - br;
        d[i] = (u32)t;
        br = (t >> 63) & 1;
    }
    u32 mask = br ? 0xffffffffu : 0u;   // a < b: add p back
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        c += (u64)d[i] + (P_W[i] & mask);
        r.w[i] = (u32)c;
        c >>= 32;
    }
}

// X + Y mod p with X = x or 0 and Y = y or p - y (LinFlags)
inline void fp_lin(Fp& r, const Fp& x, const Fp& y, int flags) {
    u32 s[12];
    u64 br = 0, c = 0;
    const u32 neg = flags & LIN_NEG_Y ? 0xffffffffu : 0u, keep = flags & LIN_X ? 0xffffffffu : 0u;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        u64 t = (u64)(P_W[i] & neg) - (y.w[i] & neg) - br;     // p - y, or 0
        br = (t >> 63) & 1;
        c += (u64)(x.w[i] & keep) + ((u32)t | (y.w[i] & ~neg));
        s[i] = (u32)c;
        c >>= 32;
    }
    fp_reduce_once(r, s);      // X + Y < 2p
}
#endif

__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
    Fp z;
    fp_zero(z);
    fp_sub(r, z, a);
}

#ifdef __CUDACC__
// CIOS Montgomery product a*b*2^-384 mod p in registers: per word b_i of b,
// t += a*b_i as a carry chain of low halves and one of high halves, then
// t += m*p with m = t_0 * (-p^-1) and a shift by one word.  Each chain is
// one asm statement (PTX keeps the carry flag only inside a statement);
// ptxas interleaves the four chains of a row.  p < 2^381 keeps t below 2^414,
// so 13 words hold it and no chain carries out of its last word.
__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
    u32 t[13];
#pragma unroll
    for (int j = 0; j < 13; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        u32 bi = b.w[i];
        asm("{\n\t"
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
          "r"(a.w[6]), "r"(a.w[7]), "r"(a.w[8]), "r"(a.w[9]), "r"(a.w[10]), "r"(a.w[11]), "r"(bi));
        asm("{\n\t"
        "mad.hi.cc.u32 %0, %12, %24, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
        "madc.hi.u32 %11, %23, %24, %11;"
        "\n\t}"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]),
          "r"(a.w[6]), "r"(a.w[7]), "r"(a.w[8]), "r"(a.w[9]), "r"(a.w[10]), "r"(a.w[11]), "r"(bi));
        u32 m = t[0] * NP32;
        asm("{\n\t"
        "mad.lo.cc.u32 %0, %13, 0xffffaaab, %0;\n\t"
        "madc.lo.cc.u32 %1, %13, 0xb9feffff, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, 0xb153ffff, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, 0x1eabfffe, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, 0xf6b0f624, %4;\n\t"
        "madc.lo.cc.u32 %5, %13, 0x6730d2a0, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, 0xf38512bf, %6;\n\t"
        "madc.lo.cc.u32 %7, %13, 0x64774b84, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, 0x434bacd7, %8;\n\t"
        "madc.lo.cc.u32 %9, %13, 0x4b1ba7b6, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, 0x397fe69a, %10;\n\t"
        "madc.lo.cc.u32 %11, %13, 0x1a0111ea, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(m));
        asm("{\n\t"
        "mad.hi.cc.u32 %0, %12, 0xffffaaab, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, 0xb9feffff, %1;\n\t"
        "madc.hi.cc.u32 %2, %12, 0xb153ffff, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, 0x1eabfffe, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, 0xf6b0f624, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, 0x6730d2a0, %5;\n\t"
        "madc.hi.cc.u32 %6, %12, 0xf38512bf, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, 0x64774b84, %7;\n\t"
        "madc.hi.cc.u32 %8, %12, 0x434bacd7, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, 0x4b1ba7b6, %9;\n\t"
        "madc.hi.cc.u32 %10, %12, 0x397fe69a, %10;\n\t"
        "madc.hi.u32 %11, %12, 0x1a0111ea, %11;"
        "\n\t}"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(m));
#pragma unroll
        for (int j = 0; j < 12; j++) t[j] = t[j + 1];
        t[12] = 0;
    }
    // t < 2p: subtract p once unless that borrows
    u32 d[12], bw;
    asm("{\n\t"
        "sub.cc.u32 %0, %13, 0xffffaaab;\n\t"
        "subc.cc.u32 %1, %14, 0xb9feffff;\n\t"
        "subc.cc.u32 %2, %15, 0xb153ffff;\n\t"
        "subc.cc.u32 %3, %16, 0x1eabfffe;\n\t"
        "subc.cc.u32 %4, %17, 0xf6b0f624;\n\t"
        "subc.cc.u32 %5, %18, 0x6730d2a0;\n\t"
        "subc.cc.u32 %6, %19, 0xf38512bf;\n\t"
        "subc.cc.u32 %7, %20, 0x64774b84;\n\t"
        "subc.cc.u32 %8, %21, 0x434bacd7;\n\t"
        "subc.cc.u32 %9, %22, 0x4b1ba7b6;\n\t"
        "subc.cc.u32 %10, %23, 0x397fe69a;\n\t"
        "subc.cc.u32 %11, %24, 0x1a0111ea;\n\t"
        "mov.u32 %12, 0;\n\t"
        "subc.u32 %12, %12, 0;"
        "\n\t}"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
          "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(bw)
        : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
          "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]));
#pragma unroll
    for (int j = 0; j < 12; j++) r.w[j] = bw ? t[j] : d[j];
}
#endif
#ifndef __CUDACC__
// The host build's product: the same CIOS rows in 64-bit accumulators
inline void fp_mul(Fp& r, const Fp& a, const Fp& b) {
    BLS_COUNT_FP_MUL();
    u32 t[14] = {0};
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
#endif

// k*a for a small positive k, by double-and-add over k's bits
__device__ __forceinline__ void fp_scale(Fp& r, const Fp& a, int k) {
    Fp acc = a;
    int top = 0;
    while ((k >> (top + 1)) != 0) top++;
    for (int b = top - 1; b >= 0; b--) {
        fp_add(acc, acc, acc);
        if ((k >> b) & 1) fp_add(acc, acc, a);
    }
    r = acc;
}

// ---- Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v) --
//
// Templates over the base field B: Fp computes, TV records.

template <class B> struct Fp2T { B c[2]; };
template <class B> struct Fp6T { Fp2T<B> c[3]; };
template <class B> struct Fp12T { Fp6T<B> c[2]; };
typedef Fp2T<Fp> Fp2;
typedef Fp6T<Fp> Fp6;
typedef Fp12T<Fp> Fp12;

__device__ __forceinline__ void fp2_zero(Fp2& r) { fp_zero(r.c[0]); fp_zero(r.c[1]); }
__device__ __forceinline__ void fp2_one(Fp2& r) { fp_one(r.c[0]); fp_zero(r.c[1]); }
__device__ __forceinline__ bool fp2_is_zero(const Fp2& a) {
    return fp_is_zero(a.c[0]) && fp_is_zero(a.c[1]);
}
template <class B> __device__ __forceinline__ void fp2_add(Fp2T<B>& r, const Fp2T<B>& a,
                                                         const Fp2T<B>& b) {
    fp_add(r.c[0], a.c[0], b.c[0]);
    fp_add(r.c[1], a.c[1], b.c[1]);
}
template <class B> __device__ __forceinline__ void fp2_sub(Fp2T<B>& r, const Fp2T<B>& a,
                                                         const Fp2T<B>& b) {
    fp_sub(r.c[0], a.c[0], b.c[0]);
    fp_sub(r.c[1], a.c[1], b.c[1]);
}
template <class B> __device__ __forceinline__ void fp2_neg(Fp2T<B>& r, const Fp2T<B>& a) {
    fp_neg(r.c[0], a.c[0]);
    fp_neg(r.c[1], a.c[1]);
}
template <class B> __device__ __forceinline__ void fp2_scale(Fp2T<B>& r, const Fp2T<B>& a, int k) {
    fp_scale(r.c[0], a.c[0], k);
    fp_scale(r.c[1], a.c[1], k);
}
template <class B> __device__ __forceinline__ void fp2_conj(Fp2T<B>& r, const Fp2T<B>& a) {
    r.c[0] = a.c[0];
    fp_neg(r.c[1], a.c[1]);
}
// Karatsuba: (a + bu)(c + du) = ac - bd + ((a + b)(c + d) - ac - bd)u
template <class B> __device__ __noinline__ void fp2_mul(Fp2T<B>& r, const Fp2T<B>& x,
                                                      const Fp2T<B>& y) {
    B t0, t1, t2, sa, sb;
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
template <class B> __device__ __forceinline__ void fp2_mul_fp(Fp2T<B>& r, const Fp2T<B>& x,
                                                            const B& s) {
    fp_mul(r.c[0], x.c[0], s);
    fp_mul(r.c[1], x.c[1], s);
}
// times xi = 1 + u: (a - b) + (a + b)u
template <class B> __device__ __forceinline__ void fp2_mul_xi(Fp2T<B>& r, const Fp2T<B>& x) {
    B t;
    fp_sub(t, x.c[0], x.c[1]);
    fp_add(r.c[1], x.c[0], x.c[1]);
    r.c[0] = t;
}

template <class B> __device__ __forceinline__ void fp6_add(Fp6T<B>& r, const Fp6T<B>& a,
                                                         const Fp6T<B>& b) {
    for (int i = 0; i < 3; i++) fp2_add(r.c[i], a.c[i], b.c[i]);
}
template <class B> __device__ __forceinline__ void fp6_sub(Fp6T<B>& r, const Fp6T<B>& a,
                                                         const Fp6T<B>& b) {
    for (int i = 0; i < 3; i++) fp2_sub(r.c[i], a.c[i], b.c[i]);
}
// Karatsuba (ops/bls12_381.fp6_mul of the JAX package): 6 Fp2 products
template <class B> __device__ __noinline__ void fp6_mul(Fp6T<B>& r, const Fp6T<B>& a,
                                                      const Fp6T<B>& b) {
    Fp2T<B> t0, t1, t2, sa, sb, m, c0, c1, c2;
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
template <class B> __device__ __noinline__ void fp6_mul_01(Fp6T<B>& r, const Fp6T<B>& a,
                                                         const Fp2T<B>& b0, const Fp2T<B>& b1) {
    Fp2T<B> t0, t1, s, u, c0, c1, c2;
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
template <class B> __device__ __noinline__ void fp6_mul_1(Fp6T<B>& r, const Fp6T<B>& a,
                                                        const Fp2T<B>& b1) {
    Fp2T<B> c0, c1, c2;
    fp2_mul(c0, a.c[2], b1);
    fp2_mul_xi(c0, c0);
    fp2_mul(c1, a.c[0], b1);
    fp2_mul(c2, a.c[1], b1);
    r.c[0] = c0;
    r.c[1] = c1;
    r.c[2] = c2;
}
// (c0, c1, c2) * v = (xi c2, c0, c1)
template <class B> __device__ __forceinline__ void fp6_mul_v(Fp6T<B>& r, const Fp6T<B>& a) {
    Fp2T<B> t;
    fp2_mul_xi(t, a.c[2]);
    r.c[2] = a.c[1];
    r.c[1] = a.c[0];
    r.c[0] = t;
}
// Karatsuba over w: c0 = a0b0 + v a1b1, c1 = (a0 + a1)(b0 + b1) - a0b0 - a1b1
template <class B> __device__ __noinline__ void fp12_mul(Fp12T<B>& r, const Fp12T<B>& a,
                                                       const Fp12T<B>& b) {
    Fp6T<B> t0, t1, sa, sb, c1;
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
template <class B> __device__ __forceinline__ void fp12_conj(Fp12T<B>& r, const Fp12T<B>& a) {
    r.c[0] = a.c[0];
    for (int j = 0; j < 3; j++) fp2_neg(r.c[1].c[j], a.c[1].c[j]);
}
// (a0 + a1 w)^2 = a0^2 + v a1^2 + 2 a0 a1 w, with
// a0^2 + v a1^2 = (a0 + a1)(a0 + v a1) - a0 a1 - v a0 a1: 2 Fp6 products
template <class B> __device__ __noinline__ void fp12_sqr(Fp12T<B>& r, const Fp12T<B>& a) {
    Fp6T<B> ab, s, t;
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
template <class B> __device__ __noinline__ void fp12_mul_line(Fp12T<B>& r, const Fp12T<B>& f,
                                                            const Fp2T<B>& a0, const Fp2T<B>& a1,
                                                            const Fp2T<B>& b1) {
    Fp6T<B> t0, t1, s;
    Fp2T<B> u;
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

template <class B> __device__ __forceinline__ void f_add(B& r, const B& a, const B& b) {
    fp_add(r, a, b);
}
template <class B> __device__ __forceinline__ void f_add(Fp2T<B>& r, const Fp2T<B>& a,
                                                       const Fp2T<B>& b) {
    fp2_add(r, a, b);
}
template <class B> __device__ __forceinline__ void f_sub(B& r, const B& a, const B& b) {
    fp_sub(r, a, b);
}
template <class B> __device__ __forceinline__ void f_sub(Fp2T<B>& r, const Fp2T<B>& a,
                                                       const Fp2T<B>& b) {
    fp2_sub(r, a, b);
}
// The one-thread curve routines over Fp call one copy of the product: the
// same register-held code, without a copy at each of their dozens of
// products (which overran the instruction cache)
__device__ __noinline__ void fp_mul_call(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
__device__ __forceinline__ void f_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul_call(r, a, b); }
template <class B> __device__ __forceinline__ void f_mul(B& r, const B& a, const B& b) {
    fp_mul(r, a, b);
}
template <class B> __device__ __forceinline__ void f_mul(Fp2T<B>& r, const Fp2T<B>& a,
                                                       const Fp2T<B>& b) {
    fp2_mul(r, a, b);
}
template <class B> __device__ __forceinline__ void f_scale(B& r, const B& a, int k) {
    fp_scale(r, a, k);
}
template <class B> __device__ __forceinline__ void f_scale(Fp2T<B>& r, const Fp2T<B>& a, int k) {
    fp2_scale(r, a, k);
}
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

// The full Jacobian add (ec._jac_add_full) of two points that are not
// infinity; INCOMPLETE at H == 0 (the callers' contract)
template <class F> __device__ __noinline__ void jac_add_formula(Jac<F>& r, const Jac<F>& p,
                                                              const Jac<F>& q) {
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

// Full Jacobian add, complete when either side is infinity (the other side
// is returned, with no product).  p_inf / q_inf: 1 or 0 for an explicit
// flag, -1 to probe Z == 0.
template <class F>
__device__ __forceinline__ void jac_add_full(Jac<F>& r, const Jac<F>& p, const Jac<F>& q,
                                             int p_inf, int q_inf) {
    if (p_inf < 0 ? f_is_zero(p.Z) : p_inf != 0) {
        r = q;
        return;
    }
    if (q_inf < 0 ? f_is_zero(q.Z) : q_inf != 0) {
        r = p;
        return;
    }
    jac_add_formula(r, p, q);
}

// ---- Miller loop steps (ops/bls12_381.py batch_miller_loop with zp, zq) ------
//
// The precomputation, the doubling step with its tangent line and the add
// step with its chord line through Q, in the JAX package's operation order
// and line scalings (the line of the doubling is scaled by zp^3, the chord's
// by the Jacobian Zs of P and Q), so the Miller values equal it exactly.

template <class B>
__device__ __forceinline__ void miller_setup(B& xz, B& zp3, Fp2T<B>& zxq, Fp2T<B>& zyq,
                                             Fp2T<B>& zq2, Fp2T<B>& zq3, Fp2T<B>& xzq2,
                                             Fp2T<B>& ypq3, const B& xp, const B& yp, const B& zp,
                                             const Fp2T<B>& xq, const Fp2T<B>& yq,
                                             const Fp2T<B>& zq) {
    B zp2;
    fp_mul(zp2, zp, zp);
    fp_mul(xz, xp, zp);
    fp_mul(zp3, zp2, zp);
    fp2_mul_fp(zxq, xq, zp3);
    fp2_mul_fp(zyq, yq, zp3);
    fp2_mul(zq2, zq, zq);
    fp2_mul(zq3, zq2, zq);
    fp2_mul_fp(xzq2, zq2, xz);
    fp2_mul_fp(ypq3, zq3, yp);
}

// f <- f^2 * tangent line at T, T <- 2T
template <class B>
__device__ __forceinline__ void miller_dbl(Fp12T<B>& f, Fp2T<B>& X, Fp2T<B>& Y, Fp2T<B>& Z,
                                           const B& xz, const B& yp, const B& zp3) {
    Fp2T<B> xx, yy, zz, yz, Z3, E, xxx, xxzz, yzzz, c4, xb, t, ff, D, X3, a0, s_a1, s_b1, ey, a1,
        b1, a0s, Y3, tmp;
    Fp12T<B> fsq;
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
    fp12_mul_line(f, fsq, a0s, a1, b1);
    X = X3;
    Y = Y3;
    Z = Z3;
}

// on a set bit of |x|, after miller_dbl: f <- f * chord through T and Q,
// T <- T + Q
template <class B>
__device__ __forceinline__ void miller_add(Fp12T<B>& f, Fp2T<B>& X, Fp2T<B>& Y, Fp2T<B>& Z,
                                           const Fp2T<B>& xq, const Fp2T<B>& yq,
                                           const Fp2T<B>& zq, const Fp2T<B>& zq2,
                                           const Fp2T<B>& zq3, const Fp2T<B>& zxq,
                                           const Fp2T<B>& zyq, const Fp2T<B>& xzq2,
                                           const Fp2T<B>& ypq3) {
    Fp2T<B> zz2, z3zq, zzz, xqzz2, u1, H, yqzzz, dl, s1, z3ah, Nl, nxq, dyq, c1a, d1a, hh, c0a,
        I4, rvec, j, v, rr, X3a, rv, yj, Y3a, Z3a, tmp;
    fp2_mul(zz2, Z, Z);
    fp2_mul(z3zq, Z, zq);
    fp2_mul(zzz, Z, zz2);
    fp2_mul(xqzz2, xq, zz2);
    fp2_mul(u1, X, zq2);
    fp2_sub(H, xqzz2, u1);
    fp2_mul(yqzzz, yq, zzz);
    fp2_neg(tmp, H);
    fp2_mul(dl, tmp, Z);
    fp2_mul(s1, Y, zq3);
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
    fp12_mul_line(f, f, c0a, c1a, d1a);
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

// ---- tapes ----------------------------------------------------------------------
//
// A tape is one step of a group lane (a Miller doubling, a Jacobian add of
// both scalar-mul tracks, an Fq12 product, ...) as Fp operations cut into
// levels.  An operand is a slot of the lane's shared-memory workspace: 3
// bits select its base (absolute, the two inputs, the output and the
// temporaries of the step, given at each run) and 13 bits its offset in Fp
// elements.

// operations as recorded (INPUT .. MOV) and as a tape holds them: MUL, LIN
// (r = X + Y with X = a or 0 and Y = b or p - b, by the flags in k: ADD,
// SUB, NEG and MOV in one code path) and NOP (a filler)
enum OpKind : uint8_t { OP_INPUT, OP_MUL, OP_ADD, OP_SUB, OP_NEG, OP_MOV, OP_LIN, OP_NOP };

enum LocBase { LOC_ABS = 0, LOC_IN0 = 1 << 13, LOC_IN1 = 2 << 13, LOC_OUT = 3 << 13,
               LOC_TMP = 4 << 13 };

struct alignas(8) Op {
    uint16_t dst, a, b;
    uint8_t kind, k;
};

enum TapeId {
    TAPE_MILLER_SETUP, TAPE_MILLER_DBL, TAPE_MILLER_ADD,   // Miller lane, absolute slots
    TAPE_G1_DBL, TAPE_G1_ADD, TAPE_G2_ADD,                 // in0 (+ in1) -> out
    TAPE_G1G2_DBL, TAPE_G1G2_ADD,                          // G1 and G2 track together
    TAPE_FQ12_MUL,                                         // in0 * in1 -> out
    TAPE_CYC_SQR,                                          // in0 -> out
    TAPE_FROB1, TAPE_FROB2, TAPE_FROB3,                    // final exp lane, absolute slots
    TAPE_PSI_DBL, TAPE_PSI_ADD, TAPE_PSI_TAIL,             // psi lane, absolute slots
    TAPE_GS_DBL, TAPE_GS_MADD, TAPE_GS_ADD, TAPE_GS_TAIL,  // G1 membership lane
    N_TAPES
};

// a tape's levels, the threads its levels are laid out for (a group of at
// least that many runs it), and its shape
struct TapeInfo {
    uint16_t first_level, n_levels, width, temps, muls, rounds;
};

#define LH_TAPE_OPS 8192
#define LH_TAPE_LEVELS 1024

struct Tapes {
    Op ops[LH_TAPE_OPS];
    uint16_t level_start[LH_TAPE_LEVELS + 1];   // level g: ops [level_start[g], level_start[g + 1])
    TapeInfo info[N_TAPES];
    int n_ops, n_levels;
    int error;                                  // nonzero: a tape did not fit its bounds
};

// Group widths (threads a lane; compile-time constants, not options).  The
// Miller loop's levels hold up to 42 products, the Fq12 product's 54 and
// the joint G1 and G2 scalar multiplication's 16, with linear chains beside
// them: a warp a lane, and the block batch's lanes (at most 132 live ones)
// one to an SM.  The G1 scalar multiplication's levels hold at most 4
// products: 4 threads a lane, 8 lanes a warp, so that a fold of thousands of
// lanes keeps about one warp on each of the card's schedulers and few
// threads idle.  The final exponentiation's cyclotomic square holds its 18
// products in one level (and runs 317 times a lane): a warp a lane, one
// round a square.  The psi check's levels hold at most 9 products (a G2
// doubling's first two, 3 Fp2 products each; the mixed add's widest is
// also 9): 16 threads a lane take each in one round, two lanes a warp, so
// the block batch's 256 lanes fill 128 warps on 128 SMs.
#define MILLER_W 32
#define GJ_W 32
#define FQ12_W 32
#define G1_W 4
#define FE_W 32
#define PSI_W 16

// Workspace layouts (Fp slots).  Miller: f, T = (X, Y, Z), the lane's
// inputs and the setup's constants, then the temporaries.
enum {
    MS_F = 0, MS_T = 12, MS_XP = 18, MS_YP = 19, MS_ZP = 20, MS_XQ = 21, MS_YQ = 23, MS_ZQ = 25,
    MS_XZ = 27, MS_ZP3 = 28, MS_ZXQ = 29, MS_ZYQ = 31, MS_ZQ2 = 33, MS_ZQ3 = 35, MS_XZQ2 = 37,
    MS_YPQ3 = 39, MS_TMP = 41
};
// Scalar multiplication: the window table's 16 entries, the accumulator,
// then the temporaries; an entry is a G1 point (X, Y, Z) and, on the joint
// track, a G2 point (X, Y, Z in Fp2) after it.
#define SM_ENTRY(g2) ((g2) ? 9 : 3)
#define SM_ACC(g2) (16 * SM_ENTRY(g2))
#define SM_TMP(g2) (17 * SM_ENTRY(g2))
// Fq12 product: x, y, then the temporaries
#define FQ_TMP 24
// Final exponentiation: the Frobenius twists gamma_1..5 (Fp2), the lane's
// Fq12 values m, t1, g3, g2, g1, g0 and a scratch a, then the temporaries
enum {
    FE_GAMMA = 0, FE_M = 10, FE_T1 = 22, FE_G3 = 34, FE_G2 = 46, FE_G1 = 58, FE_G0 = 70,
    FE_A = 82, FE_TMP = 94
};
// psi check: the affine base x, y (Fp2), the constants c (of c_x = c u)
// and c_y, T = (X, Y, Z), the residues d1, d2, then the temporaries
enum { PS_X = 0, PS_Y = 2, PS_CX = 4, PS_CY = 5, PS_T = 7, PS_D = 13, PS_TMP = 17 };
// G1 membership: the lane's affine x, y, the constants beta and b = 4, the
// second scan's base B (Jacobian), T, the residues d1, d2, d3, then the
// temporaries
enum { GS_X = 0, GS_Y = 1, GS_BETA = 2, GS_B4 = 3, GS_B = 4, GS_T = 7, GS_D = 10, GS_TMP = 13 };

// most temporaries a step may take, per lane layout (the builder fails
// past them)
#define MILLER_TEMPS 128
#define GJ_TEMPS 48
#define G1_TEMPS 16
#define FQ12_TEMPS 144
#define FE_TEMPS FQ12_TEMPS      // the lane runs the Fq12 product's tape too
#define PSI_TEMPS 48
#define GS_TEMPS 24
#define MILLER_WS (MS_TMP + MILLER_TEMPS)
#define GJ_WS (SM_TMP(1) + GJ_TEMPS)
#define G1_WS (SM_TMP(0) + G1_TEMPS)
#define FQ12_WS (FQ_TMP + FQ12_TEMPS)
#define FE_WS (FE_TMP + FE_TEMPS)
#define PSI_WS (PS_TMP + PSI_TEMPS)
#define GS_WS (GS_TMP + GS_TEMPS)

// ---- global memory rows -----------------------------------------------------

__device__ __forceinline__ void ld(Fp& r, const u32* p, long i) {
#pragma unroll
    for (int k = 0; k < 12; k++) r.w[k] = p[i * 12 + k];
}
__device__ __forceinline__ void st(u32* p, long i, const Fp& a) {
#pragma unroll
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

// ---- group execution ----------------------------------------------------------
//
// A group is W threads of one warp working on one lane; t is the thread's
// index in it and mask its threads' bits in the warp.  par(g, W, n, fn) is
// the level loop: on the card thread t runs fn(t), fn(t + W), ... then the
// group syncs (shared memory written in the level is visible to the next);
// on the host one loop runs the W threads' sequences one after another, in
// ascending or, when the tests set level_order_reversed, descending thread
// order, so that an operation that read a slot another thread writes in the
// same level would give another value.

struct Grp {
    int t;
    unsigned mask;
};

#ifndef __CUDACC__
inline bool level_order_reversed = false;
#endif

// the level loop over the group's first w threads (a tape laid out for
// fewer threads than the group has leaves the others idle)
template <class Fn> __device__ __forceinline__ void par(const Grp& g, int w, int n, Fn fn) {
#ifdef __CUDACC__
    if (g.t < w)
        for (int k = g.t; k < n; k += w) fn(k);
    __syncwarp(g.mask);
#else
    (void)g;
    for (int j = 0; j < w; j++)
        for (int k = level_order_reversed ? w - 1 - j : j; k < n; k += w) fn(k);
#endif
}

// the lane's slot of an operand, from its base and offset
__device__ __forceinline__ int slot(int x, int in0, int in1, int out, int tmp) {
    int sel = x >> 13, base = 0;
    base = sel == 1 ? in0 : base;
    base = sel == 2 ? in1 : base;
    base = sel == 3 ? out : base;
    base = sel == 4 ? tmp : base;
    return base + (x & 0x1fff);
}

// one operation of a level: operands from shared memory into registers,
// the result back
__device__ __forceinline__ void run_op(const Op& op, Fp* ws, int in0, int in1, int out, int tmp) {
    if (op.kind == OP_NOP) return;
    Fp x = ws[slot(op.a, in0, in1, out, tmp)], y = ws[slot(op.b, in0, in1, out, tmp)], r;
    if (op.kind == OP_MUL) fp_mul(r, x, y);
    else fp_lin(r, x, y, op.k);
    ws[slot(op.dst, in0, in1, out, tmp)] = r;
}

// The tapes as a group kernel reads them: its operations and level starts
// (staged in shared memory on the card, levels from lv0 on, offsets from
// its first operation) and every tape's info
struct TapeView {
    const Op* ops;
    const uint16_t* level_start;
    int lv0;
    const TapeInfo* info;
};

// run tape ``id`` on the lane's workspace ws with the given bases (Fp slots)
__device__ __forceinline__ void run_tape(const Grp& g, const TapeView& T, int id, Fp* ws, int in0,
                                         int in1, int out, int tmp) {
    const TapeInfo info = T.info[id];
    const int end = info.first_level + info.n_levels - T.lv0;
    for (int l = info.first_level - T.lv0; l < end; l++) {
        const int start = T.level_start[l];
        par(g, info.width, T.level_start[l + 1] - start,
            [&](int k) { run_op(T.ops[start + k], ws, in0, in1, out, tmp); });
    }
}

// ---- group lane routines -----------------------------------------------------

// r*P (G1) and, on the joint track (G2), r*Q for lane i over shared MSB-first
// 4-bit digits [n_digits, n] (ec.gj_scalar_mul_windowed, ec.g1_scalar_mul_windowed):
// P is row ``row`` of (x1, y1), Q row i of (x2, y2).  A zero scalar gives
// exact zeros and no work (its rows are never read); the accumulator is not
// doubled while it is infinity.  The window table [0..15]*B
// (ec._window_tables): even e doubles entry e/2, odd e adds B to entry
// e - 1, a track whose entry e - 1 is infinity copying B.
template <int W, bool G2>
__device__ __forceinline__ void lane_scalar_mul(const Grp& g, const TapeView& T, Fp* ws, long i,
                                                long n, int n_digits, const u32* x1,
                                                const u32* y1, long row, const u32* x2,
                                                const u32* y2, const int32_t* digits, u32* X1,
                                                u32* Y1, u32* Z1, u32* X2, u32* Y2, u32* Z2) {
    const int E = SM_ENTRY(G2), ACC = SM_ACC(G2), TMP = SM_TMP(G2);
    const int DBL = G2 ? TAPE_G1G2_DBL : TAPE_G1_DBL, ADD = G2 ? TAPE_G1G2_ADD : TAPE_G1_ADD;
    int any = 0;
    for (int d = 0; d < n_digits; d++) any |= digits[(long)d * n + i] & 15;
    if (any) {
        // entries 0 and 1: zero, and B with Z = one
        u32* w = ws[0].w;
        par(g, W, 2 * E * 12, [&](int k) {
            int s = k / 12, e = s / E, c = s % E, q = k % 12;
            u32 v = 0;
            if (e == 1) {
                if (c == 0) v = x1[row * 12 + q];
                else if (c == 1) v = y1[row * 12 + q];
                else if (c == 2 || c == 7) v = ONE_W[q];
                else if (c == 3 || c == 4) v = x2[i * 24 + (c - 3) * 12 + q];
                else if (c == 5 || c == 6) v = y2[i * 24 + (c - 5) * 12 + q];
            }
            w[k] = v;
        });
        for (int e = 2; e < 16; e++) {
            if (e % 2 == 0) {
                run_tape(g, T, DBL, ws, (e / 2) * E, 0, e * E, TMP);
                continue;
            }
            const int p = (e - 1) * E;
            bool inf1 = fp_is_zero(ws[p + 2]);
            bool inf2 = G2 && fp_is_zero(ws[p + 7]) && fp_is_zero(ws[p + 8]);
            if (!inf1 && !inf2) {
                run_tape(g, T, ADD, ws, p, E, e * E, TMP);
                continue;
            }
            // a track at infinity copies B (words of its slots), the other adds
            u32 *dst = ws[e * E].w, *src = ws[E].w;
            if (inf1) par(g, W, 36, [&](int k) { dst[k] = src[k]; });
            else run_tape(g, T, TAPE_G1_ADD, ws, p, E, e * E, TMP);
            if (G2) {
                if (inf2) par(g, W, 72, [&](int k) { dst[36 + k] = src[36 + k]; });
                else run_tape(g, T, TAPE_G2_ADD, ws, p + 3, E + 3, e * E + 3, TMP);
            }
        }
        bool inf = true;
        for (int d = 0; d < n_digits; d++) {
            const int digit = digits[(long)d * n + i] & 15;
            if (!inf)
                for (int k = 0; k < 4; k++) run_tape(g, T, DBL, ws, ACC, 0, ACC, TMP);
            if (inf) {      // infinity + entry: the entry (zeros for digit 0)
                u32 *dst = ws[ACC].w, *src = ws[digit * E].w;
                par(g, W, E * 12, [&](int k) { dst[k] = src[k]; });
            } else if (digit) {
                run_tape(g, T, ADD, ws, ACC, digit * E, ACC, TMP);
            }
            inf = inf && digit == 0;
        }
    }
    par(g, W, E * 12, [&](int k) {
        int s = k / 12, q = k % 12;
        u32 v = any ? ws[ACC + s].w[q] : 0u;
        if (s < 3) (s == 0 ? X1 : s == 1 ? Y1 : Z1)[i * 12 + q] = v;
        else (s < 5 ? X2 : s < 7 ? Y2 : Z2)[i * 24 + ((s - 3) % 2) * 12 + q] = v;
    });
}

// Miller lanes [0, n): P Jacobian (xp, yp, zp), Q Jacobian (xq, yq, zq);
// lanes with mask 0 give one, and lane sum_lane takes its mask from zq != 0
// (the Sigma r*sig lane of bls_backend._pipeline_fused).  Lanes [n, n_out)
// are the product tree's padding: one.  The loop runs the doubling step on
// bits 62..0 of |x| and the add step on its set bits, then conjugates.
template <int W>
__device__ __forceinline__ void lane_miller(const Grp& g, const TapeView& T, Fp* ws, long i, long n,
                                            long sum_lane, const u32* xp, const u32* yp,
                                            const u32* zp, const u32* xq, const u32* yq,
                                            const u32* zq, const uint8_t* mask, u32* out) {
    bool m = false;
    if (i < n) {
        if (i == sum_lane) {
            u32 acc = 0;
            for (int k = 0; k < 24; k++) acc |= zq[i * 24 + k];
            m = acc != 0;
        } else {
            m = mask[i] != 0;
        }
    }
    if (m) {
        // f = one, T = Q, and the lane's inputs: xp yp zp | xq yq zq
        u32* w = ws[0].w;
        par(g, W, (MS_XZ - MS_F) * 12, [&](int k) {
            int s = k / 12, q = k % 12;
            u32 v;
            if (s < MS_T) v = s == 0 ? ONE_W[q] : 0u;
            else if (s < MS_XP)
                v = (s < MS_T + 2 ? xq : s < MS_T + 4 ? yq : zq)[i * 24 + (s - MS_T) % 2 * 12 + q];
            else if (s == MS_XP) v = xp[i * 12 + q];
            else if (s == MS_YP) v = yp[i * 12 + q];
            else if (s == MS_ZP) v = zp[i * 12 + q];
            else v = (s < MS_YQ ? xq : s < MS_ZQ ? yq : zq)[i * 24 + (s - MS_XQ) % 2 * 12 + q];
            w[k] = v;
        });
        run_tape(g, T, TAPE_MILLER_SETUP, ws, 0, 0, 0, MS_TMP);
        for (int b = 62; b >= 0; b--) {
            run_tape(g, T, TAPE_MILLER_DBL, ws, 0, 0, 0, MS_TMP);
            if ((BLS_X_ABS >> b) & 1) run_tape(g, T, TAPE_MILLER_ADD, ws, 0, 0, 0, MS_TMP);
        }
    }
    // out = conj(f): the w coefficients negated; one where the lane is off
    par(g, W, 12, [&](int s) {
        Fp v;
        if (m) {
            v = ws[MS_F + s];
            if (s >= 6) fp_neg(v, v);
        } else if (s == 0) {
            fp_one(v);
        } else {
            fp_zero(v);
        }
        st(out, i * 12 + s, v);
    });
}

// one Fq12 product of rows i of a and b into row i of out; a factor equal
// to one (a masked or padding Miller lane) returns the other with no product
template <int W>
__device__ __forceinline__ void lane_fq12_mul(const Grp& g, const TapeView& T, Fp* ws, long i,
                                              const u32* a, const u32* b, u32* out) {
    u32* w = ws[0].w;
    par(g, W, 288, [&](int k) { w[k] = k < 144 ? a[i * 144 + k] : b[i * 144 + k - 144]; });
    u32 xa = 0, ya = 0;
    for (int k = 0; k < 144; k++) {
        u32 one = k < 12 ? ONE_W[k] : 0u;
        xa |= w[k] ^ one;
        ya |= w[144 + k] ^ one;
    }
    int res = 0;
    if (xa == 0) res = 12;
    else if (ya != 0) run_tape(g, T, TAPE_FQ12_MUL, ws, 0, 12, 0, FQ_TMP);
    par(g, W, 144, [&](int k) { out[i * 144 + k] = w[res * 12 + k]; });
}

// ---- the psi check -----------------------------------------------------------------

// The mixed add of the affine base (xb, yb) to T, the add of the psi and G1
// membership scans (ec._dbl_add_step).  INCOMPLETE at H == 0, where T is
// +-B: Z comes out 0, and the doublings keep it 0 (the fail-closed chord).
template <class F>
__device__ __forceinline__ void jac_madd(Jac<F>& T, const F& xb, const F& yb) {
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
    jac_madd(T, xb, yb);
}

// The psi comparison of affine lane (x, y) with S = T = [|x|](x, y):
// d1 = x_psi Z^2 - X and d2 = y_psi Z^3 + Y, where psi(x, y) =
// (conj(x) c_x, conj(y) c_y) and c_x = c u, so x_psi = (x1 c, x0 c)
template <class B>
__device__ __forceinline__ void psi_tail(Fp2T<B>& d1, Fp2T<B>& d2, const Fp2T<B>& x,
                                         const Fp2T<B>& y, const Jac<Fp2T<B> >& T, const B& cx,
                                         const Fp2T<B>& cy) {
    Fp2T<B> px, py, z2, z3, xz, yz;
    fp_mul(px.c[0], x.c[1], cx);
    fp_mul(px.c[1], x.c[0], cx);
    fp2_conj(py, y);
    fp2_mul(py, py, cy);
    fp2_mul(z2, T.Z, T.Z);
    fp2_mul(xz, px, z2);
    fp2_mul(z3, z2, T.Z);
    fp2_mul(yz, py, z3);
    fp2_sub(d1, xz, T.X);
    fp2_add(d2, yz, T.Y);
}

// psi membership of affine G2 lane i (ec.g2_subgroup_verdict_batch), one
// thread: the host oracle of the group lane below
__device__ __forceinline__ void lane_g2_subgroup(long i, const u32* xq, const u32* yq,
                                                 uint8_t* out) {
    Fp2 x, y, cy, d1, d2;
    Fp cx;
    ld(x, xq, i);
    ld(y, yq, i);
    Jac<Fp2> T;
    jac_zero(T);
    bool inf = true;
#pragma unroll 1
    for (int b = 63; b >= 0; b--) dbl_add_step(T, inf, x, y, (int)((BLS_X_ABS >> b) & 1));
    if (inf) jac_zero(T);
    for (int k = 0; k < 12; k++) {
        cx.w[k] = PSI_CX_W[1][k];
        cy.c[0].w[k] = PSI_CY_W[0][k];
        cy.c[1].w[k] = PSI_CY_W[1][k];
    }
    psi_tail(d1, d2, x, y, T, cx, cy);
    out[i] = fp2_is_zero(d1) && fp2_is_zero(d2) && !fp2_is_zero(T.Z);
}

// The same check as a group lane: x, y, the constants and T in the lane's
// workspace (PS_*), the doubling, the mixed add and the tail from tapes.
// The branches are the one-thread scan's, uniform across the lanes (they
// read only |x|'s bits and T's flag): no doubling while T is infinity, the
// first set bit loads the base, a clear bit skips the add.
template <int W>
__device__ __forceinline__ void lane_g2_subgroup(const Grp& g, const TapeView& T, Fp* ws, long i,
                                                 const u32* xq, const u32* yq, uint8_t* out) {
    u32* w = ws[0].w;
    par(g, W, PS_T * 12, [&](int k) {
        const int s = k / 12, q = k % 12;
        u32 v;
        if (s < PS_Y) v = xq[i * 24 + s * 12 + q];
        else if (s < PS_CX) v = yq[i * 24 + (s - PS_Y) * 12 + q];
        else if (s == PS_CX) v = PSI_CX_W[1][q];
        else v = PSI_CY_W[s - PS_CY][q];
        w[k] = v;
    });
    bool inf = true;
    for (int b = 63; b >= 0; b--) {
        if (!inf) run_tape(g, T, TAPE_PSI_DBL, ws, 0, 0, 0, PS_TMP);
        if (!((BLS_X_ABS >> b) & 1)) continue;
        if (inf) {      // T = (x, y, 1)
            par(g, W, 72, [&](int k) {
                const int s = k / 12;
                w[PS_T * 12 + k] = s < 4 ? w[k] : s == 4 ? ONE_W[k % 12] : 0u;
            });
            inf = false;
        } else {
            run_tape(g, T, TAPE_PSI_ADD, ws, 0, 0, 0, PS_TMP);
        }
    }
    if (inf) par(g, W, 72, [&](int k) { w[PS_T * 12 + k] = 0u; });
    run_tape(g, T, TAPE_PSI_TAIL, ws, 0, 0, 0, PS_TMP);
    par(g, 1, 1, [&](int) {
        const bool d0 = fp_is_zero(ws[PS_D]) && fp_is_zero(ws[PS_D + 1]) &&
                        fp_is_zero(ws[PS_D + 2]) && fp_is_zero(ws[PS_D + 3]);
        out[i] = d0 && !(fp_is_zero(ws[PS_T + 4]) && fp_is_zero(ws[PS_T + 5]));
    });
}

// ---- one-thread lane routines (one thread a lane in csrc/bls12_381.cu) -------

// rows i and i + half of a G1 (or G2) lane array -> row i (one tree level)
template <class F> __device__ __forceinline__ void lane_add_halves(long i, long half, u32* X,
                                                                   u32* Y, u32* Z) {
    Jac<F> p, q;
    ld(p, X, Y, Z, i);
    ld(q, X, Y, Z, i + half);
    jac_add_full(p, p, q, -1, -1);
    st(X, Y, Z, i, p);
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

// a^-1 (0 -> 0) by the divstep inversion (csrc/modinv.cuh) of aR, then
// the Montgomery product by R^3
__device__ __forceinline__ void fp_inv_var(Fp& r, const Fp& a) {
    Fp t, r3;
    modinv::inv_var<13, 12>(t.w, a.w, P30, P_INV30);
#pragma unroll
    for (int k = 0; k < 12; k++) r3.w[k] = R3_W[k];
    fp_mul(r, t, r3);
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

// ---- the blinded fold's tail (msm._blinded_fold): a warp a segment ---------
//
// The tree launches leave n_rows <= BLINDED_TAIL_ROWS partial sums a segment
// (s-major: row s of segment g at s * n_seg + g).  One warp loads them into
// its workspace (row s at slots 3s .. 3s + 2) and folds them as 8 groups of
// G1_W threads over the G1 add's tape: at the step where h rows remain,
// add a < h/2 (group a % 8) combines rows a and a + h/2 as lane_add_halves
// does, with the same infinity skips, so every value equals the plain
// tree's; the last step (h = 1) adds the known blinding total -U =
// (ux, uy, 1), put in row 1, to row 0.  Thread 0 then inverts Z by divsteps
// and runs the 4 affine products in a loop over workspace slots.  The
// products go through three copies of the register-held code (run_op's,
// fp_inv_var's and the loop's), which keeps the kernel small enough for the
// instruction cache (an inlined add's 16 copies were not), and no value
// goes through a call's stack.

#define BLINDED_TAIL_ROWS 32
#define TAIL_GROUPS (32 / G1_W)
#define TAIL_TMP (3 * BLINDED_TAIL_ROWS)            // each group's G1_TEMPS after the rows
#define TAIL_WS (TAIL_TMP + TAIL_GROUPS * G1_TEMPS)

// the affine step's products after the inversion, (dst, a, b) over slots
// (X = 0, Y = 1; T = TAIL_TMP holds Z^-1): Z^-2, x = X Z^-2, Z^-3, y = Y Z^-3
__constant__ uint8_t TAIL_AFFINE[4][3] = {{TAIL_TMP + 1, TAIL_TMP, TAIL_TMP},
                                          {TAIL_TMP + 2, 0, TAIL_TMP + 1},
                                          {TAIL_TMP + 3, TAIL_TMP + 1, TAIL_TMP},
                                          {TAIL_TMP + 4, 1, TAIL_TMP + 3}};

// thread t of the warp's part of loading the segment's rows
__device__ __forceinline__ void blinded_tail_load(Fp* ws, int t, int n_rows, long g, long n_seg,
                                                  const u32* X, const u32* Y, const u32* Z) {
    for (int k = t; k < n_rows * 36; k += 32) {
        const int s = k / 36, c = k / 12 % 3, q = k % 12;
        ws[3 * s + c].w[q] = (c == 0 ? X : c == 1 ? Y : Z)[(s * n_seg + g) * 12 + q];
    }
}

// thread t of the warp's part of putting -U = (ux, uy, 1) in row 1
__device__ __forceinline__ void blinded_tail_blind(Fp* ws, int t, const u32* ux, const u32* uy) {
    for (int k = t; k < 36; k += 32)
        ws[3 + k / 12].w[k % 12] = k < 12 ? ux[k] : k < 24 ? uy[k - 12] : ONE_W[k - 24];
}

// group j's part of the step at which h rows remain
template <int W>
__device__ __forceinline__ void blinded_tail_step(const Grp& g, const TapeView& T, Fp* ws, int j,
                                                  int h) {
    const int half = h > 1 ? h / 2 : 1;
    for (int a = j; a < half; a += TAIL_GROUPS) {
        const int p = 3 * a, q = 3 * (a + half);
        if (fp_is_zero(ws[p + 2])) {              // infinity + row q: a copy
            u32 *dst = ws[p].w;
            const u32* src = ws[q].w;
            par(g, W, 36, [&](int k) { dst[k] = src[k]; });
        } else if (!fp_is_zero(ws[q + 2])) {
            run_tape(g, T, TAPE_G1_ADD, ws, p, q, p, TAIL_TMP + j * G1_TEMPS);
        }
    }
}

// thread 0: row 0 to affine row g of (xa, ya) and its infinity flag (a Z of
// 0, whose inverse is 0, gives zeros), as g1_affine_out does
__device__ __forceinline__ void blinded_tail_out(Fp* ws, long g, u32* xa, u32* ya,
                                                 uint8_t* inf) {
    fp_inv_var(ws[TAIL_TMP], ws[2]);
#pragma unroll 1
    for (int k = 0; k < 4; k++)
        fp_mul(ws[TAIL_AFFINE[k][0]], ws[TAIL_AFFINE[k][1]], ws[TAIL_AFFINE[k][2]]);
    st(xa, g, ws[TAIL_TMP + 2]);
    st(ya, g, ws[TAIL_TMP + 4]);
    inf[g] = fp_is_zero(ws[2]);
}

// segment g of the gather fold after its tree: affine and the infinity flag
// (msm._gather_fold's g1_jacobian_to_affine_batch and is_zero_mod_p)
__device__ __forceinline__ void lane_g1_affine(long g, const u32* X, const u32* Y, const u32* Z,
                                               u32* xa, u32* ya, uint8_t* inf) {
    Jac<Fp> p;
    ld(p, X, Y, Z, g);
    g1_affine_out(g, p, xa, ya, inf);
}

// ---- row 12: G1 membership by the sigma endomorphism ---------------------------
//
// Scott's test ("A note on group membership tests for G1, G2 and GT on BLS
// pairing-friendly curves", 2021; blst's G1 check): a point P of E(Fp) is
// in G1 exactly when sigma(P) = (beta x, y) equals -[z^2]P, z = -|z| the
// curve's x.  On G1, sigma is [lambda] for a cube root of unity lambda mod
// r, and r = z^4 - z^2 + 1 makes -z^2 one of the two: beta is the root of
// Fp whose sigma gives lambda = -z^2 (the other gives z^2 - 1, and no
// member passes with it; the CPU tests try both).  [z^2]P is two MSB-first
// double-and-add scans over |z| (64 bits, 6 set): T1 = [|z|]P from the
// affine P by the mixed add, then [|z|]T1 by the full Jacobian add.  The
// tail compares Z^2 beta x with X and Z^3 y with -Y, and checks y^2 = x^3 +
// 4.
//
// Why the verdict is the JAX scan's ([r-1]P == -P,
// ec.g1_subgroup_verdict_batch), lane for lane:
// - a member: every add of both scans adds B to [k]B with 2 <= k < 2^64,
//   never +-B (B has order r > 2^254), and a doubling meets Y = 0 only at
//   order 2 (r is odd), so no formula meets its exceptional case, both
//   scans compute [z^2]P and the test reads true, as the JAX scan does;
// - a point of E(Fp) outside G1: if no formula met its exceptional case,
//   the scans computed [z^2]P and Scott's theorem reads false; if one did
//   (an add at T = +-B gives H == 0, a doubling Y == 0), Z became 0, and a
//   Jacobian double or add of Z == 0 keeps Z == 0 (Z3 = 2YZ; Z3 = 2 Z1 Z2 H
//   in both adds), so the verdict's Z != 0 reads false; the JAX scan reads
//   false there too (fail-closed, or [r-1]P == -P forcing the order to
//   divide r);
// - a point off the curve: y^2 != x^3 + 4 reads false; the JAX scan runs
//   its formulas on the curve y^2 = x^3 + b' through the point, where
//   [r-1]P == -P needs P's order there to divide r, and for the random
//   points the tests and the ceremony's decoding can give it reads false.
// So the lane reads true exactly for members (off-curve points: on the
// inputs above).  The branches read only |z|'s bits: uniform across lanes.
template <int W>
__device__ __forceinline__ void lane_g1_subgroup(const Grp& g, const TapeView& T, Fp* ws, long i,
                                                 const u32* xp, const u32* yp, uint8_t* out) {
    u32* w = ws[0].w;
    par(g, W, GS_B * 12, [&](int k) {
        const int s = k / 12, q = k % 12;
        w[k] = s == GS_X ? xp[i * 12 + q] : s == GS_Y ? yp[i * 12 + q]
             : s == GS_BETA ? BETA_W[q] : B4_W[q];
    });
    for (int scan = 0; scan < 2; scan++) {
        for (int b = 63; b >= 0; b--) {
            if (b < 63) run_tape(g, T, TAPE_GS_DBL, ws, 0, 0, 0, GS_TMP);
            if (!((BLS_X_ABS >> b) & 1)) continue;
            if (b == 63) {          // the top bit: T = the base (P with Z = 1, or B)
                par(g, W, 36, [&](int k) {
                    w[GS_T * 12 + k] = scan ? w[GS_B * 12 + k]
                                     : k < 24 ? w[GS_X * 12 + k] : ONE_W[k % 12];
                });
            } else if (scan == 0) {
                run_tape(g, T, TAPE_GS_MADD, ws, GS_X, 0, 0, GS_TMP);
            } else {
                run_tape(g, T, TAPE_GS_ADD, ws, 0, 0, 0, GS_TMP);
            }
        }
        if (scan == 0) par(g, W, 36, [&](int k) { w[GS_B * 12 + k] = w[GS_T * 12 + k]; });
    }
    run_tape(g, T, TAPE_GS_TAIL, ws, 0, 0, 0, GS_TMP);
    par(g, 1, 1, [&](int) {
        out[i] = fp_is_zero(ws[GS_D]) && fp_is_zero(ws[GS_D + 1]) && fp_is_zero(ws[GS_D + 2]) &&
                 !fp_is_zero(ws[GS_T + 2]);
    });
}

// The tail's residues of T = [z^2]P against sigma(P) and the curve:
// d1 = beta x Z^2 - X, d2 = y Z^3 + Y, d3 = y^2 - x^3 - 4
template <class B>
__device__ __forceinline__ void g1_sigma_tail(B& d1, B& d2, B& d3, const B& x, const B& y,
                                              const B& beta, const B& b4, const Jac<B>& t) {
    B z2, bx, xz, z3, yz, y2, x2, x3;
    fp_mul(z2, t.Z, t.Z);
    fp_mul(bx, beta, x);
    fp_mul(y2, y, y);
    fp_mul(x2, x, x);
    fp_mul(xz, bx, z2);
    fp_mul(z3, z2, t.Z);
    fp_mul(x3, x2, x);
    fp_mul(yz, y, z3);
    fp_sub(d1, xz, t.X);
    fp_add(d2, yz, t.Y);
    fp_sub(d3, y2, x3);
    fp_sub(d3, d3, b4);
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

// (a + bu)^2 = (a + b)(a - b) + (2a)b u: 2 Fp products, and no linear
// operation after them
template <class B> __device__ __noinline__ void fp2_sqr(Fp2T<B>& r, const Fp2T<B>& x) {
    B s, d, a2, re;
    fp_add(s, x.c[0], x.c[1]);
    fp_sub(d, x.c[0], x.c[1]);
    fp_add(a2, x.c[0], x.c[0]);
    fp_mul(re, s, d);
    fp_mul(r.c[1], a2, x.c[1]);
    r.c[0] = re;
}

// 3a - 2g (sub) or 3a + 2g (add) from g2 = 2g: (a + a) + (a -+ g2), two
// linear levels after a: the Granger-Scott output combination
template <class B>
__device__ __forceinline__ void gs_out(Fp2T<B>& z, const Fp2T<B>& a, const Fp2T<B>& g2,
                                       bool add) {
    Fp2T<B> t, a2;
    if (add) fp2_add(t, a, g2);
    else fp2_sub(t, a, g2);
    fp2_add(a2, a, a);
    fp2_add(z, a2, t);
}

// Granger-Scott squaring of a cyclotomic element (JAX fp12_cyclotomic_sqr,
// ops/bls12_381.py:649): coefficients x = (g0, g1, g2) + (g3, g4, g5) w,
// 9 Fp2 squarings.  Wrong for an element outside the cyclotomic subgroup.
// The doubled inputs are taken before the squarings, so the deepest
// output is five linear operations after its product (it is a field
// element: any order of the same sums gives the same words).
template <class B> __device__ __noinline__ void fp12_cyclotomic_sqr(Fp12T<B>& r, const Fp12T<B>& x) {
    const Fp2T<B> &g0 = x.c[0].c[0], &g1 = x.c[0].c[1], &g2 = x.c[0].c[2];
    const Fp2T<B> &g3 = x.c[1].c[0], &g4 = x.c[1].c[1], &g5 = x.c[1].c[2];
    Fp2T<B> t0, t1, t2, t3, t4, t5, t6, t7, t8, s, a0, a2, a4, d[6];
    for (int k = 0; k < 6; k++) fp2_add(d[k], x.c[k / 3].c[k % 3], x.c[k / 3].c[k % 3]);
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
    Fp12T<B> z;
    gs_out(z.c[0].c[0], a0, d[0], false);
    gs_out(z.c[0].c[1], a2, d[1], false);
    gs_out(z.c[0].c[2], a4, d[2], false);
    gs_out(z.c[1].c[0], t8, d[3], true);
    gs_out(z.c[1].c[1], t6, d[4], true);
    gs_out(z.c[1].c[2], t7, d[5], true);
    r = z;
}

// f^(p^n) (JAX fp12_frobenius, ops/bls12_381.py:631): n rounds of
// coefficient conjugation and the twists gam[k - 1] = gamma_k, 5 Fp2
// products a round
template <class B>
__device__ __noinline__ void fp12_frobenius(Fp12T<B>& r, const Fp12T<B>& f, int n,
                                            const Fp2T<B>* gam) {
    Fp12T<B> x = f;
    Fp2T<B> c;
#pragma unroll 1
    for (int i = 0; i < n; i++) {
        fp2_conj(x.c[0].c[0], x.c[0].c[0]);
        const int ks[5] = {2, 4, 1, 3, 5};      // a1, a2, b0, b1, b2
        for (int j = 0; j < 5; j++) {
            Fp2T<B>& e = x.c[(j + 1) / 3].c[(j + 1) % 3];
            fp2_conj(c, e);
            fp2_mul(e, c, gam[ks[j] - 1]);
        }
    }
    r = x;
}

__device__ __noinline__ void fp12_frobenius(Fp12& r, const Fp12& f, int n) {
    Fp2 gam[5];
    for (int k = 0; k < 5; k++)
        for (int w = 0; w < 12; w++) {
            gam[k].c[0].w[w] = FROB_G_W[k][0][w];
            gam[k].c[1].w[w] = FROB_G_W[k][1][w];
        }
    fp12_frobenius(r, f, n, gam);
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

// lane i of Fq12 rows [N, 12, 12]: out = (m^((p^4 - p^2 + 1)/r))^3, one
// thread: the host oracle of the group lane below
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

// The same hard part as a group lane: the steps of lane_final_exp_hard over
// the lane's Fq12 slots (FE_*), each one of
//   FE_LADDER  dst = src^x: dst = src, per bit of |x| after the top one a
//              cyclotomic square of dst and, on a set bit, dst = dst * src;
//              then dst = conj(dst)
//   FE_SQR     dst = src^2 (cyclotomic)     FE_MUL   dst = dst * src
//   FE_CONJ    dst = conj(src)              FE_FROB  a = g_n^(p^n), n = 1..3
enum FeKind : uint8_t { FE_LADDER, FE_SQR, FE_MUL, FE_CONJ, FE_FROB };
struct FeStep {
    uint8_t kind, src, dst;
};
#define FE_STEPS 20
__constant__ FeStep FE_PROG[FE_STEPS] = {
    {FE_LADDER, FE_M, FE_T1},  {FE_LADDER, FE_T1, FE_G3}, {FE_SQR, FE_T1, FE_A},
    {FE_CONJ, FE_A, FE_A},     {FE_MUL, FE_A, FE_G3},     {FE_MUL, FE_M, FE_G3},
    {FE_LADDER, FE_G3, FE_G2}, {FE_LADDER, FE_G2, FE_G1}, {FE_CONJ, FE_G3, FE_A},
    {FE_MUL, FE_A, FE_G1},     {FE_LADDER, FE_G1, FE_G0}, {FE_SQR, FE_M, FE_A},
    {FE_MUL, FE_A, FE_G0},     {FE_MUL, FE_M, FE_G0},     {FE_FROB, FE_G1, FE_A},
    {FE_MUL, FE_A, FE_G0},     {FE_FROB, FE_G2, FE_A},    {FE_MUL, FE_A, FE_G0},
    {FE_FROB, FE_G3, FE_A},    {FE_MUL, FE_A, FE_G0}};

// Lane i: the twists and m into the workspace, then the steps, each one
// tape run (the Frobenius tapes read g1, g2, g3 and write a at fixed slots)
// or one copy level (a conjugation negates the w half), from one call site
// of each so that the lane's code stays small; g0 out.
template <int W>
__device__ __forceinline__ void lane_final_exp_hard(const Grp& g, const TapeView& T, Fp* ws,
                                                    long i, const u32* in, u32* out) {
    u32* w = ws[0].w;
    par(g, W, (FE_M + 12) * 12, [&](int k) {
        const int s = k / 12;
        w[k] = s < FE_M ? FROB_G_W[s / 2][s % 2][k % 12] : in[i * 144 + k - FE_M * 12];
    });
    int st = 0, b = 63;     // the step, and a ladder's bit (63: not begun)
    bool mul = false;       // a ladder's product of the bit b is next
    while (st < FE_STEPS) {
        const FeStep s = FE_PROG[st];
        int tape = -1, in0 = s.src, in1 = s.src, neg = 0;
        if (s.kind == FE_LADDER) {
            if (b == 63) {                      // dst = src
                b = 62;
            } else if (mul) {
                tape = TAPE_FQ12_MUL;
                in0 = s.dst;
                mul = false;
                b--;
            } else if (b >= 0) {
                tape = TAPE_CYC_SQR;
                in0 = s.dst;
                if ((BLS_X_ABS >> b) & 1) mul = true;
                else b--;
            } else {                            // dst = conj(dst)
                in0 = s.dst;
                neg = 1;
                b = 63;
                st++;
            }
        } else {
            tape = s.kind == FE_SQR ? TAPE_CYC_SQR : s.kind == FE_MUL ? TAPE_FQ12_MUL : -1;
            if (s.kind == FE_MUL) in0 = s.dst;
            if (s.kind == FE_FROB) tape = TAPE_FROB1 + (FE_G1 - s.src) / 12;   // g1, g2, g3
            neg = s.kind == FE_CONJ;
            st++;
        }
        if (tape >= 0) {
            run_tape(g, T, tape, ws, in0, in1, s.dst, FE_TMP);
        } else {
            par(g, W, 12, [&](int c) {
                Fp v = ws[in0 + c];
                if (neg && c >= 6) fp_neg(v, v);
                ws[s.dst + c] = v;
            });
        }
    }
    par(g, W, 144, [&](int k) { out[i * 144 + k] = w[FE_G0 * 12 + k]; });
}

// ---- recording and scheduling the tapes (host only) ---------------------------
//
// csrc/bls_tapes.cc builds the tapes with this code and hands them to the
// card; the CPU tests run the group lanes on the same tapes.

#ifndef __CUDACC__

// ---- traced values ------------------------------------------------------------
//
// A TV is a value of a step being recorded (on the host, by host_tapes()):
// fp_mul and the linear operations on TVs append an operation to the
// builder (tb_emit, below) instead of computing.

struct Builder;
inline int tb_emit(Builder* b, int kind, int x, int y);

struct TV {
    int v;
    Builder* b;
};

inline void fp_mul(TV& r, const TV& a, const TV& c) {
    r.v = tb_emit(a.b, OP_MUL, a.v, c.v);
    r.b = a.b;
}
inline void fp_add(TV& r, const TV& a, const TV& c) {
    r.v = tb_emit(a.b, OP_ADD, a.v, c.v);
    r.b = a.b;
}
inline void fp_sub(TV& r, const TV& a, const TV& c) {
    r.v = tb_emit(a.b, OP_SUB, a.v, c.v);
    r.b = a.b;
}
inline void fp_neg(TV& r, const TV& a) {
    r.v = tb_emit(a.b, OP_NEG, a.v, -1);
    r.b = a.b;
}
// k*a as fp_scale computes it: double-and-add over k's bits
inline void fp_scale(TV& r, const TV& a, int k) {
    TV acc = a;
    int top = 0;
    while ((k >> (top + 1)) != 0) top++;
    for (int i = top - 1; i >= 0; i--) {
        fp_add(acc, acc, acc);
        if ((k >> i) & 1) fp_add(acc, acc, a);
    }
    r = acc;
}

#define LH_TB_VALS 2048
#define LH_TB_OUTS 32
#define LH_TB_PLEVELS 64
#define LH_TB_SLOTS 256
// a product's weight against a linear operation's in a thread's load
#define LH_TB_MUL_COST 8

// The tape builder: a step traced on TVs (kind, operands a and c, the
// input slots), then scheduled.  Per value: pa its product depth as soon as
// possible, need the products after it on its longest path, plev a
// product's level, mp the latest product level it depends on, dl a linear
// operation's deadline, lev / thr / seq its level, thread and place, last
// the last level that reads it, placed whether its slot is fixed.
struct Builder {
    int n, n_out, error;
    uint8_t kind[LH_TB_VALS], placed[LH_TB_VALS];
    int16_t a[LH_TB_VALS], c[LH_TB_VALS];
    uint16_t loc[LH_TB_VALS];
    int16_t pa[LH_TB_VALS], need[LH_TB_VALS], mp[LH_TB_VALS], plev[LH_TB_VALS],
        lev[LH_TB_VALS], last[LH_TB_VALS];
    int16_t out_v[LH_TB_OUTS];
    uint16_t out_loc[LH_TB_OUTS];
    int16_t dl[LH_TB_VALS], seq[LH_TB_VALS], cnt[LH_TB_PLEVELS], slot_last[LH_TB_SLOTS];
    int8_t thr[LH_TB_VALS];
};

inline int tb_emit(Builder* b, int kind, int x, int y) {
    if (b->n >= LH_TB_VALS) {
        b->error = 1;
        return 0;
    }
    int v = b->n++;
    b->kind[v] = (uint8_t)kind;
    b->a[v] = (int16_t)x;
    b->c[v] = (int16_t)y;
    b->loc[v] = 0;
    return v;
}

inline void tb_begin(Builder& b) {
    b.n = 0;
    b.n_out = 0;
}

// bind a traced value (or a tower element / Jacobian point of them) to
// consecutive input slots from loc on
inline void tb_in(Builder& b, TV& x, int loc) {
    x.v = tb_emit(&b, OP_INPUT, -1, -1);
    x.b = &b;
    b.loc[x.v] = (uint16_t)loc;
}
template <class X> inline void tb_in(Builder& b, Fp2T<X>& x, int loc) {
    tb_in(b, x.c[0], loc);
    tb_in(b, x.c[1], loc + 1);
}
template <class X> inline void tb_in(Builder& b, Fp6T<X>& x, int loc) {
    for (int i = 0; i < 3; i++) tb_in(b, x.c[i], loc + 2 * i);
}
template <class X> inline void tb_in(Builder& b, Fp12T<X>& x, int loc) {
    for (int i = 0; i < 2; i++) tb_in(b, x.c[i], loc + 6 * i);
}
template <class F> inline void tb_in(Builder& b, Jac<F>& p, int loc) {
    const int s = (int)(sizeof(F) / sizeof(TV));
    tb_in(b, p.X, loc);
    tb_in(b, p.Y, loc + s);
    tb_in(b, p.Z, loc + 2 * s);
}

// mark a traced value (...) as the step's output at consecutive slots
inline void tb_out(Builder& b, const TV& x, int loc) {
    if (b.n_out >= LH_TB_OUTS) {
        b.error = 1;
        return;
    }
    b.out_v[b.n_out] = (int16_t)x.v;
    b.out_loc[b.n_out++] = (uint16_t)loc;
}
template <class X> inline void tb_out(Builder& b, const Fp2T<X>& x, int loc) {
    tb_out(b, x.c[0], loc);
    tb_out(b, x.c[1], loc + 1);
}
template <class X> inline void tb_out(Builder& b, const Fp6T<X>& x, int loc) {
    for (int i = 0; i < 3; i++) tb_out(b, x.c[i], loc + 2 * i);
}
template <class X> inline void tb_out(Builder& b, const Fp12T<X>& x, int loc) {
    for (int i = 0; i < 2; i++) tb_out(b, x.c[i], loc + 6 * i);
}
template <class F> inline void tb_out(Builder& b, const Jac<F>& p, int loc) {
    const int s = (int)(sizeof(F) / sizeof(TV));
    tb_out(b, p.X, loc);
    tb_out(b, p.Y, loc + s);
    tb_out(b, p.Z, loc + 2 * s);
}

// May a write to slot x land while slot y is still read?  Slots alias when
// their offsets match on the same base, or when one is the output base and
// the other an input base (a step may run in place).  Absolute slots and
// temporaries never alias a relocated one.
inline bool tb_alias(int x, int y) {
    if ((x & 0x1fff) != (y & 0x1fff)) return false;
    int bx = x & ~0x1fff, by = y & ~0x1fff;
    if (bx == by) return true;
    bool rx = bx == LOC_IN0 || bx == LOC_IN1, ry = by == LOC_IN0 || by == LOC_IN1;
    return (bx == LOC_OUT && ry) || (by == LOC_OUT && rx);
}

inline bool tb_linear(const Builder& b, int v) {
    return b.kind[v] != OP_INPUT && b.kind[v] != OP_MUL;
}

// are the operands of v produced before ``level``?
inline bool tb_ready(const Builder& b, int v, int level) {
    for (int o = 0; o < 2; o++) {
        int x = o ? b.c[v] : b.a[v];
        if (x >= 0 && (b.lev[x] == -2 || b.lev[x] >= level)) return false;
    }
    return true;
}

// Schedule the traced step into tape ``id`` of T, for groups of W threads:
// products into product levels by depth (one with slack where the level's
// last round of W has room), then levels and threads for every operation
// (below), outputs written straight to their slots where no later read
// forbids it (else by a last level of moves), temporaries in the lowest
// slot free since the level after their last read.  A level's operations
// are laid out as rows of W (thread t runs positions t, t + W, ... in
// order), no-ops as filler.  Without ``chains`` a linear operation never
// joins the level of an operand: each level is then operations that do not
// depend on each other, a row or two wide, where chains may stack a
// dependent run of linear operations on one thread of a level.
inline void tb_finish(Builder& b, Tapes& T, int id, int W, int max_temps, bool chains = true) {
    const int n = b.n;
    if (b.error) {
        T.error = 1;
        return;
    }
    // product depth, as soon as possible, and products still needed after
    int D = 0;
    for (int v = 0; v < n; v++) {
        int p = 0;
        if (b.kind[v] != OP_INPUT) {
            p = b.pa[b.a[v]];
            if (b.c[v] >= 0 && b.pa[b.c[v]] > p) p = b.pa[b.c[v]];
            if (b.kind[v] == OP_MUL) p++;
        }
        b.pa[v] = (int16_t)p;
        if (b.kind[v] == OP_MUL && p > D) D = p;
        b.need[v] = 0;
    }
    if (D + 2 >= LH_TB_PLEVELS) {
        T.error = 1;
        return;
    }
    for (int v = n - 1; v >= 0; v--) {
        if (b.kind[v] == OP_INPUT) continue;
        int nd = b.need[v] + (b.kind[v] == OP_MUL ? 1 : 0);
        if (b.need[b.a[v]] < nd) b.need[b.a[v]] = (int16_t)nd;
        if (b.c[v] >= 0 && b.need[b.c[v]] < nd) b.need[b.c[v]] = (int16_t)nd;
    }
    // product levels: those without slack first, then the others in trace
    // order, where a round has room
    for (int l = 0; l <= D; l++) b.cnt[l] = 0;
    for (int v = 0; v < n; v++)
        if (b.kind[v] == OP_MUL && b.pa[v] == D - b.need[v]) {
            b.plev[v] = b.pa[v];
            b.cnt[b.pa[v]]++;
        }
    for (int v = 0; v < n; v++) {
        int m = 0;
        if (b.kind[v] != OP_INPUT) {
            m = b.mp[b.a[v]];
            if (b.c[v] >= 0 && b.mp[b.c[v]] > m) m = b.mp[b.c[v]];
        }
        if (b.kind[v] == OP_MUL) {
            int lo = m + 1, hi = D - b.need[v];
            if (lo > hi) {
                T.error = 1;
                return;
            }
            if (b.pa[v] != hi) {
                int best = -1;
                for (int l = lo; l <= hi && best < 0; l++)
                    if (b.cnt[l] % W != 0) best = l;
                if (best < 0) {
                    best = lo;
                    for (int l = lo; l <= hi; l++)
                        if (b.cnt[l] < b.cnt[best]) best = l;
                }
                b.plev[v] = (int16_t)best;
                b.cnt[best]++;
            }
            m = b.plev[v];
        }
        b.mp[v] = (int16_t)m;
    }
    // deadline of each linear operation: the product level of the first
    // product that needs it (through linear operations), past D if none
    for (int v = 0; v < n; v++) b.dl[v] = (int16_t)(D + 1);
    for (int v = n - 1; v >= 0; v--) {
        if (b.kind[v] == OP_INPUT) continue;
        const int d = b.kind[v] == OP_MUL ? b.plev[v] : b.dl[v];
        for (int o = 0; o < 2; o++) {
            int x = o ? b.c[v] : b.a[v];
            if (x >= 0 && tb_linear(b, x) && b.dl[x] > d) b.dl[x] = (int16_t)d;
        }
    }
    // levels, and the thread of each operation in its level: the products of
    // product level pl once all are ready, round robin; then the linear
    // operations the next product level needs; then others where they do not
    // lengthen the level.  A linear operation whose operands in the level
    // are all on one thread follows them there; else it starts on the least
    // loaded thread.
    int left = 0, seq = 0;
    for (int v = 0; v < n; v++) {
        b.lev[v] = (int16_t)(b.kind[v] == OP_INPUT ? -1 : -2);
        b.placed[v] = b.kind[v] == OP_INPUT;
        left += b.kind[v] != OP_INPUT;
    }
    int L = -1;
    for (int level = 0, pl = 1; left > 0; level++) {
        int load[32] = {0}, cap = 0, placed = 0;
        bool go = pl <= D;
        for (int v = 0; v < n && go; v++)
            if (b.kind[v] == OP_MUL && b.plev[v] == pl && !tb_ready(b, v, level)) go = false;
        for (int v = 0, i = 0; v < n && go; v++)
            if (b.kind[v] == OP_MUL && b.plev[v] == pl) {
                const int t = i++ % W;
                b.lev[v] = (int16_t)level;
                b.thr[v] = (int8_t)t;
                b.seq[v] = (int16_t)seq++;
                load[t] += LH_TB_MUL_COST;
                if (load[t] > cap) cap = load[t];
                placed++;
            }
        for (int pass = 0; pass < 2; pass++)
            for (int v = 0; v < n; v++) {
                if (b.lev[v] != -2 || !tb_linear(b, v)) continue;
                if ((b.dl[v] <= pl) != (pass == 0)) continue;
                int t = -1;
                bool ok = true;
                for (int o = 0; o < 2 && ok; o++) {
                    int x = o ? b.c[v] : b.a[v];
                    if (x < 0 || (b.lev[x] != -2 && b.lev[x] < level)) continue;
                    if (!chains || b.lev[x] != level || (t >= 0 && b.thr[x] != t)) ok = false;
                    else t = b.thr[x];
                }
                if (!ok) continue;
                if (t < 0)
                    for (int q = t = 0; q < W; q++)
                        if (load[q] < load[t]) t = q;
                if (pass == 1 && load[t] + 1 > cap) continue;
                b.lev[v] = (int16_t)level;
                b.thr[v] = (int8_t)t;
                b.seq[v] = (int16_t)seq++;
                if (++load[t] > cap) cap = load[t];
                placed++;
            }
        if (go) pl++;
        if (!placed) {
            T.error = 1;
            return;
        }
        left -= placed;
        L = level;
    }
    for (int v = 0; v < n; v++) b.last[v] = b.lev[v];
    for (int v = 0; v < n; v++)
        for (int o = 0; o < 2; o++) {
            int x = b.kind[v] == OP_INPUT ? -1 : (o ? b.c[v] : b.a[v]);
            if (x >= 0 && b.last[x] < b.lev[v]) b.last[x] = b.lev[v];
        }
    // outputs: straight to their slots where safe, else moved at level L + 1
    const int Lm = L + 1;
    int nn = n;
    for (int pass = 0; pass < 2; pass++)
        for (int o = 0; o < b.n_out; o++) {
            int v = b.out_v[o], dst = b.out_loc[o];
            if ((b.kind[v] == OP_INPUT) != (pass == 0)) continue;
            if (b.kind[v] == OP_INPUT && b.loc[v] == dst) continue;
            bool direct = false;
            if (b.kind[v] != OP_INPUT && !b.placed[v]) {
                direct = true;
                for (int u = 0; u < n && direct; u++)
                    if (b.kind[u] == OP_INPUT && tb_alias(b.loc[u], dst) && b.last[u] >= b.lev[v])
                        direct = false;
            }
            if (direct) {
                b.loc[v] = (uint16_t)dst;
                b.placed[v] = 1;
                continue;
            }
            if (nn >= LH_TB_VALS) {
                T.error = 1;
                return;
            }
            if (b.kind[v] == OP_INPUT)      // a pass-through must not read a written slot
                for (int q = 0; q < b.n_out; q++)
                    if (tb_alias(b.loc[v], b.out_loc[q])) T.error = 1;
            b.kind[nn] = OP_MOV;
            b.a[nn] = (int16_t)v;
            b.c[nn] = -1;
            b.lev[nn] = (int16_t)Lm;
            b.last[nn] = (int16_t)Lm;
            b.thr[nn] = (int8_t)((nn - n) % W);
            b.seq[nn] = (int16_t)seq++;
            b.loc[nn] = (uint16_t)dst;
            b.placed[nn] = 1;
            if (b.last[v] < Lm) b.last[v] = (int16_t)Lm;
            nn++;
        }
    const int Lend = nn > n ? Lm : L;
    // temporaries, level by level: the lowest slot whose value was last read
    // before the level
    if (max_temps > LH_TB_SLOTS) max_temps = LH_TB_SLOTS;
    for (int s = 0; s < max_temps; s++) b.slot_last[s] = -2;
    int temps = 0;
    for (int l = 0; l <= Lend; l++)
        for (int v = 0; v < nn; v++) {
            if (b.placed[v] || b.lev[v] != l) continue;
            int s = 0;
            while (s < max_temps && b.slot_last[s] >= l) s++;
            if (s >= max_temps) {
                T.error = 1;
                return;
            }
            b.slot_last[s] = b.last[v];
            b.loc[v] = (uint16_t)(LOC_TMP | s);
            if (s + 1 > temps) temps = s + 1;
        }
    // emit, level by level, as rows of W
    TapeInfo info;
    info.first_level = (uint16_t)T.n_levels;
    info.n_levels = 0;
    info.width = (uint16_t)W;
    info.temps = (uint16_t)temps;
    info.muls = 0;
    info.rounds = 0;
    for (int l = 0; l <= Lend; l++) {
        // the level's operations in placement order, each down its thread's column
        std::vector<std::pair<int, int> > order;
        int muls = 0;
        for (int v = 0; v < nn; v++)
            if (b.kind[v] != OP_INPUT && b.lev[v] == l) {
                order.push_back({b.seq[v], v});
                muls += b.kind[v] == OP_MUL;
            }
        std::sort(order.begin(), order.end());
        std::vector<std::vector<int> > col(W);
        for (const auto& sv : order) col[b.thr[sv.second]].push_back(sv.second);
        int rows = 0;
        for (int t = 0; t < W; t++)
            if ((int)col[t].size() > rows) rows = (int)col[t].size();
        if (!rows) continue;
        int count = 0;                      // positions up to the last operation
        for (int r = 0; r < rows; r++)
            for (int t = 0; t < W; t++)
                if (r < (int)col[t].size()) count = r * W + t + 1;
        if (T.n_ops + count > LH_TAPE_OPS || T.n_levels >= LH_TAPE_LEVELS) {
            T.error = 1;
            return;
        }
        T.level_start[T.n_levels++] = (uint16_t)T.n_ops;
        for (int i = 0; i < count; i++) {
            int r = i / W, t = i % W;
            Op& op = T.ops[T.n_ops++];
            if (r >= (int)col[t].size()) {
                op = Op{0, 0, 0, OP_NOP, 0};
                continue;
            }
            int v = col[t][r];
            const int kind = b.kind[v];
            op.dst = b.loc[v];
            op.a = b.loc[b.a[v]];
            op.b = b.c[v] >= 0 ? b.loc[b.c[v]] : op.a;
            op.kind = kind == OP_MUL ? OP_MUL : OP_LIN;
            op.k = kind == OP_ADD ? LIN_X : kind == OP_SUB ? LIN_X | LIN_NEG_Y
                 : kind == OP_NEG ? LIN_NEG_Y : 0;
        }
        info.n_levels++;
        info.muls += muls;
        info.rounds += (muls + W - 1) / W;
    }
    T.level_start[T.n_levels] = (uint16_t)T.n_ops;
    T.info[id] = info;
}

// Trace and schedule every tape (on the host: host_tapes(), whose result
// csrc/bls_tapes.cc hands to the card).
void build_tapes(Tapes& T, Builder& b) {
    T.n_ops = 0;
    T.n_levels = 0;
    T.error = 0;
    b.error = 0;
    {   // Miller setup: the lane's constants
        TV xp, yp, zp, xz, zp3;
        Fp2T<TV> xq, yq, zq, zxq, zyq, zq2, zq3, xzq2, ypq3;
        tb_begin(b);
        tb_in(b, xp, MS_XP);
        tb_in(b, yp, MS_YP);
        tb_in(b, zp, MS_ZP);
        tb_in(b, xq, MS_XQ);
        tb_in(b, yq, MS_YQ);
        tb_in(b, zq, MS_ZQ);
        miller_setup(xz, zp3, zxq, zyq, zq2, zq3, xzq2, ypq3, xp, yp, zp, xq, yq, zq);
        tb_out(b, xz, MS_XZ);
        tb_out(b, zp3, MS_ZP3);
        tb_out(b, zxq, MS_ZXQ);
        tb_out(b, zyq, MS_ZYQ);
        tb_out(b, zq2, MS_ZQ2);
        tb_out(b, zq3, MS_ZQ3);
        tb_out(b, xzq2, MS_XZQ2);
        tb_out(b, ypq3, MS_YPQ3);
        tb_finish(b, T, TAPE_MILLER_SETUP, MILLER_W, MILLER_TEMPS);
    }
    {   // Miller doubling step
        Fp12T<TV> f;
        Fp2T<TV> X, Y, Z;
        TV xz, yp, zp3;
        tb_begin(b);
        tb_in(b, f, MS_F);
        tb_in(b, X, MS_T);
        tb_in(b, Y, MS_T + 2);
        tb_in(b, Z, MS_T + 4);
        tb_in(b, xz, MS_XZ);
        tb_in(b, yp, MS_YP);
        tb_in(b, zp3, MS_ZP3);
        miller_dbl(f, X, Y, Z, xz, yp, zp3);
        tb_out(b, f, MS_F);
        tb_out(b, X, MS_T);
        tb_out(b, Y, MS_T + 2);
        tb_out(b, Z, MS_T + 4);
        tb_finish(b, T, TAPE_MILLER_DBL, MILLER_W, MILLER_TEMPS);
    }
    {   // Miller add step
        Fp12T<TV> f;
        Fp2T<TV> X, Y, Z, xq, yq, zq, zq2, zq3, zxq, zyq, xzq2, ypq3;
        tb_begin(b);
        tb_in(b, f, MS_F);
        tb_in(b, X, MS_T);
        tb_in(b, Y, MS_T + 2);
        tb_in(b, Z, MS_T + 4);
        tb_in(b, xq, MS_XQ);
        tb_in(b, yq, MS_YQ);
        tb_in(b, zq, MS_ZQ);
        tb_in(b, zq2, MS_ZQ2);
        tb_in(b, zq3, MS_ZQ3);
        tb_in(b, zxq, MS_ZXQ);
        tb_in(b, zyq, MS_ZYQ);
        tb_in(b, xzq2, MS_XZQ2);
        tb_in(b, ypq3, MS_YPQ3);
        miller_add(f, X, Y, Z, xq, yq, zq, zq2, zq3, zxq, zyq, xzq2, ypq3);
        tb_out(b, f, MS_F);
        tb_out(b, X, MS_T);
        tb_out(b, Y, MS_T + 2);
        tb_out(b, Z, MS_T + 4);
        tb_finish(b, T, TAPE_MILLER_ADD, MILLER_W, MILLER_TEMPS);
    }
    {   // G1 doubling, G1 add, G2 add (the G1 lanes, and the joint lanes'
        // tracks apart where only one is at infinity)
        Jac<TV> p, q;
        Jac<Fp2T<TV> > p2, q2;
        tb_begin(b);
        tb_in(b, p, LOC_IN0);
        jac_double(p, p);
        tb_out(b, p, LOC_OUT);
        tb_finish(b, T, TAPE_G1_DBL, G1_W, G1_TEMPS);
        tb_begin(b);
        tb_in(b, p, LOC_IN0);
        tb_in(b, q, LOC_IN1);
        jac_add_formula(p, p, q);
        tb_out(b, p, LOC_OUT);
        tb_finish(b, T, TAPE_G1_ADD, G1_W, G1_TEMPS);
        tb_begin(b);
        tb_in(b, p2, LOC_IN0);
        tb_in(b, q2, LOC_IN1);
        jac_add_formula(p2, p2, q2);
        tb_out(b, p2, LOC_OUT);
        tb_finish(b, T, TAPE_G2_ADD, GJ_W, GJ_TEMPS);
        // the joint track: G1 at +0, G2 at +3
        tb_begin(b);
        tb_in(b, p, LOC_IN0);
        tb_in(b, p2, LOC_IN0 + 3);
        jac_double(p, p);
        jac_double(p2, p2);
        tb_out(b, p, LOC_OUT);
        tb_out(b, p2, LOC_OUT + 3);
        tb_finish(b, T, TAPE_G1G2_DBL, GJ_W, GJ_TEMPS);
        tb_begin(b);
        tb_in(b, p, LOC_IN0);
        tb_in(b, p2, LOC_IN0 + 3);
        tb_in(b, q, LOC_IN1);
        tb_in(b, q2, LOC_IN1 + 3);
        jac_add_formula(p, p, q);
        jac_add_formula(p2, p2, q2);
        tb_out(b, p, LOC_OUT);
        tb_out(b, p2, LOC_OUT + 3);
        tb_finish(b, T, TAPE_G1G2_ADD, GJ_W, GJ_TEMPS);
    }
    {   // Fq12 product
        Fp12T<TV> x, y;
        tb_begin(b);
        tb_in(b, x, LOC_IN0);
        tb_in(b, y, LOC_IN1);
        fp12_mul(x, x, y);
        tb_out(b, x, LOC_OUT);
        tb_finish(b, T, TAPE_FQ12_MUL, FQ12_W, FQ12_TEMPS);
    }
    {   // the final exponentiation's cyclotomic square (in0 -> out), and its
        // Frobenius maps p, p^2, p^3 of g1, g2, g3 into a (absolute slots)
        Fp12T<TV> x;
        Fp2T<TV> gam[5];
        tb_begin(b);
        tb_in(b, x, LOC_IN0);
        fp12_cyclotomic_sqr(x, x);
        tb_out(b, x, LOC_OUT);
        // without chains: chains would stack a square's output sums on a
        // few threads of a level
        tb_finish(b, T, TAPE_CYC_SQR, FE_W, FE_TEMPS, false);
        for (int n = 1; n <= 3; n++) {
            tb_begin(b);
            for (int k = 0; k < 5; k++) tb_in(b, gam[k], FE_GAMMA + 2 * k);
            tb_in(b, x, FE_G1 - 12 * (n - 1));
            fp12_frobenius(x, x, n, gam);
            tb_out(b, x, FE_A);
            tb_finish(b, T, TAPE_FROB1 + n - 1, FE_W, FE_TEMPS);
        }
    }
    {   // the psi check's doubling, mixed add and tail (absolute slots)
        Jac<Fp2T<TV> > t;
        Fp2T<TV> x, y, cy, d1, d2;
        TV cx;
        tb_begin(b);
        tb_in(b, t, PS_T);
        jac_double(t, t);
        tb_out(b, t, PS_T);
        tb_finish(b, T, TAPE_PSI_DBL, PSI_W, PSI_TEMPS);
        tb_begin(b);
        tb_in(b, t, PS_T);
        tb_in(b, x, PS_X);
        tb_in(b, y, PS_Y);
        jac_madd(t, x, y);
        tb_out(b, t, PS_T);
        tb_finish(b, T, TAPE_PSI_ADD, PSI_W, PSI_TEMPS);
        tb_begin(b);
        tb_in(b, x, PS_X);
        tb_in(b, y, PS_Y);
        tb_in(b, cx, PS_CX);
        tb_in(b, cy, PS_CY);
        tb_in(b, t, PS_T);
        psi_tail(d1, d2, x, y, t, cx, cy);
        tb_out(b, d1, PS_D);
        tb_out(b, d2, PS_D + 2);
        tb_finish(b, T, TAPE_PSI_TAIL, PSI_W, PSI_TEMPS);
    }
    {   // the G1 membership lane's doubling, mixed add (of the affine base at
        // in0), full add (of the Jacobian base B) and tail (absolute slots)
        Jac<TV> t, q;
        TV x, y, beta, b4, d1, d2, d3;
        tb_begin(b);
        tb_in(b, t, GS_T);
        jac_double(t, t);
        tb_out(b, t, GS_T);
        tb_finish(b, T, TAPE_GS_DBL, G1_W, GS_TEMPS);
        tb_begin(b);
        tb_in(b, t, GS_T);
        tb_in(b, x, LOC_IN0);
        tb_in(b, y, LOC_IN0 + 1);
        jac_madd(t, x, y);
        tb_out(b, t, GS_T);
        tb_finish(b, T, TAPE_GS_MADD, G1_W, GS_TEMPS);
        tb_begin(b);
        tb_in(b, t, GS_T);
        tb_in(b, q, GS_B);
        jac_add_formula(t, t, q);
        tb_out(b, t, GS_T);
        tb_finish(b, T, TAPE_GS_ADD, G1_W, GS_TEMPS);
        tb_begin(b);
        tb_in(b, x, GS_X);
        tb_in(b, y, GS_Y);
        tb_in(b, beta, GS_BETA);
        tb_in(b, b4, GS_B4);
        tb_in(b, t, GS_T);
        g1_sigma_tail(d1, d2, d3, x, y, beta, b4, t);
        tb_out(b, d1, GS_D);
        tb_out(b, d2, GS_D + 1);
        tb_out(b, d3, GS_D + 2);
        tb_finish(b, T, TAPE_GS_TAIL, G1_W, GS_TEMPS);
    }
    if (b.error) T.error = 1;
}

// The tapes' shape for reports and checks: [error, operations, levels],
// then per tape [levels, temporaries, products, rounds, positions
// (operations and fillers), rows (a level's positions over the width,
// rounded up: the operations its busiest thread runs in turn)].
inline void tape_stats(const Tapes& T, int* out) {
    out[0] = T.error;
    out[1] = T.n_ops;
    out[2] = T.n_levels;
    for (int t = 0; t < N_TAPES; t++) {
        const TapeInfo& f = T.info[t];
        int* o = out + 3 + 6 * t;
        o[0] = f.n_levels;
        o[1] = f.temps;
        o[2] = f.muls;
        o[3] = f.rounds;
        o[4] = T.level_start[f.first_level + f.n_levels] - T.level_start[f.first_level];
        o[5] = 0;
        for (int l = f.first_level; l < f.first_level + f.n_levels; l++)
            o[5] += (T.level_start[l + 1] - T.level_start[l] + f.width - 1) / f.width;
    }
}
#define TAPE_STATS (3 + 6 * bls::N_TAPES)

// ---- the group kernels on the host --------------------------------------------
//
// The tapes, built once; csrc/bls_tapes.cc exports them to the card.  The
// host build runs every lane of a group kernel in turn, each on its own
// workspace, with the same arguments as the kernel's launcher: the CPU
// tests' equivalent of csrc/bls12_381.cu.

inline const Tapes& host_tapes();

inline TapeView host_view() {
    const Tapes& t = host_tapes();
    return TapeView{t.ops, t.level_start, 0, t.info};
}

inline const Tapes& host_tapes() {
    static Tapes* tapes = nullptr;
    if (!tapes) {
        tapes = new Tapes();
        Builder* b = new Builder();
        build_tapes(*tapes, *b);
        delete b;
    }
    return *tapes;
}

inline void host_gj_scalar_mul(const u32* pkx, const u32* pky, const u32* sx, const u32* sy,
                               const int32_t* digits, u32* PX, u32* PY, u32* PZ, u32* SX,
                               u32* SY, u32* SZ, long n, int n_digits) {
    std::vector<Fp> ws(GJ_WS);
    for (long i = 0; i < n; i++)
        lane_scalar_mul<GJ_W, true>(Grp{0, 0}, host_view(), ws.data(), i, n, n_digits, pkx, pky,
                                    i, sx, sy, digits, PX, PY, PZ, SX, SY, SZ);
}

inline void host_g1_scalar_mul(const u32* xs, const u32* ys, const int32_t* idx,
                               const int32_t* digits, u32* X, u32* Y, u32* Z, long n,
                               int n_digits) {
    std::vector<Fp> ws(G1_WS);
    for (long i = 0; i < n; i++)
        lane_scalar_mul<G1_W, false>(Grp{0, 0}, host_view(), ws.data(), i, n, n_digits, xs, ys,
                                     idx ? (long)idx[i] : i, nullptr, nullptr, digits, X, Y, Z,
                                     nullptr, nullptr, nullptr);
}

inline void host_miller(const u32* xp, const u32* yp, const u32* zp, const u32* xq,
                        const u32* yq, const u32* zq, const uint8_t* mask, u32* out, long n,
                        long n_out, long sum_lane) {
    std::vector<Fp> ws(MILLER_WS);
    for (long i = 0; i < n_out; i++)
        lane_miller<MILLER_W>(Grp{0, 0}, host_view(), ws.data(), i, n, sum_lane, xp, yp, zp, xq,
                              yq, zq, mask, out);
}

inline void host_fq12_mul(const u32* a, const u32* b, u32* out, long n) {
    std::vector<Fp> ws(FQ12_WS);
    for (long i = 0; i < n; i++)
        lane_fq12_mul<FQ12_W>(Grp{0, 0}, host_view(), ws.data(), i, a, b, out);
}

inline void host_final_exp_hard(const u32* in, u32* out, long n) {
    std::vector<Fp> ws(FE_WS);
    for (long i = 0; i < n; i++)
        lane_final_exp_hard<FE_W>(Grp{0, 0}, host_view(), ws.data(), i, in, out);
}

inline void host_g2_subgroup(const u32* xq, const u32* yq, uint8_t* out, long n) {
    std::vector<Fp> ws(PSI_WS);
    for (long i = 0; i < n; i++)
        lane_g2_subgroup<PSI_W>(Grp{0, 0}, host_view(), ws.data(), i, xq, yq, out);
}

// k_g1_subgroup
inline void host_g1_subgroup(const u32* xp, const u32* yp, uint8_t* out, long n) {
    std::vector<Fp> ws(GS_WS);
    for (long i = 0; i < n; i++)
        lane_g1_subgroup<G1_W>(Grp{0, 0}, host_view(), ws.data(), i, xp, yp, out);
}

// k_blinded_final: per segment the warp's steps, its groups one after
// another in each step (descending with level_order_reversed), each group's
// threads as host_view's tapes run them
inline void host_blinded_final(const u32* X, const u32* Y, const u32* Z, const u32* ux,
                               const u32* uy, u32* xa, u32* ya, uint8_t* inf, long n_seg,
                               int n_rows) {
    std::vector<Fp> ws(TAIL_WS);
    for (long g = 0; g < n_seg; g++) {
        for (int t = 0; t < 32; t++) blinded_tail_load(ws.data(), t, n_rows, g, n_seg, X, Y, Z);
        for (int h = n_rows; h >= 1; h >>= 1) {
            if (h == 1)
                for (int t = 0; t < 32; t++) blinded_tail_blind(ws.data(), t, ux, uy);
            for (int k = 0; k < TAIL_GROUPS; k++)
                blinded_tail_step<G1_W>(Grp{0, 0}, host_view(), ws.data(),
                                        level_order_reversed ? TAIL_GROUPS - 1 - k : k, h);
        }
        blinded_tail_out(ws.data(), g, xa, ya, inf);
    }
}
#endif

}  // namespace bls
