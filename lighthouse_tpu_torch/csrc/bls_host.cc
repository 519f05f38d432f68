// Native host-side BLS12-381 helpers: point decompression and the final
// exponentiation — the two host-python stages the round-4 TPU ledger
// showed dominating the batch-verify critical path
// (BLS_LEDGER_TPU_r04.json: "subgroup" 5.9s of which ~all is python
// G2 decompression, "final_exp" 1.9s on a single underutilized device
// lane).  The reference keeps this layer inside blst (C/assembly,
// crypto/bls/src/impls/blst.rs); this is the same altitude rebuilt from
// the repo's own pure-Python oracle (crypto/bls/fields.py, curve.py) —
// 6x64-bit Montgomery arithmetic, tower fields, complex-method Fq2 sqrt,
// and the cubed x-ladder final exponentiation.
//
// Pure C++17 + __int128, no external deps; bound via ctypes
// (ops/native_bls.py).  Every exported verdict is differential-tested
// against the python oracle in tests/test_native_bls.py.

#include <cstdint>
#include <cstring>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

namespace {

constexpr int L = 6;  // 384 bits = 6 x 64

struct Fp { u64 l[L]; };

// p, little-endian limbs
constexpr Fp P = {{0xB9FEFFFFFFFFAAABull, 0x1EABFFFEB153FFFFull,
                   0x6730D2A0F6B0F624ull, 0x64774B84F38512BFull,
                   0x4B1BA7B6434BACD7ull, 0x1A0111EA397FE69Aull}};

u64 N0;            // -p^{-1} mod 2^64
Fp R2;             // (2^384)^2 mod p
Fp ONE_M;          // to_mont(1) = 2^384 mod p
Fp ZERO = {{0, 0, 0, 0, 0, 0}};

// big-endian byte exponents, filled by init
uint8_t EXP_P_MINUS_2[48];   // for Fermat inversion
uint8_t EXP_SQRT[48];        // (p+1)/4
uint8_t EXP_PM3_4[48];       // (p-3)/4: u = t^((p-3)/4) gives sqrt AND
                             // inverse at once (ya = u·t, 1/ya = u)
uint8_t EXP_FROB[48];        // (p-1)/6

inline bool geq(const Fp& a, const Fp& b) {
    for (int i = L - 1; i >= 0; i--) {
        if (a.l[i] != b.l[i]) return a.l[i] > b.l[i];
    }
    return true;
}

inline bool is_zero(const Fp& a) {
    u64 acc = 0;
    for (int i = 0; i < L; i++) acc |= a.l[i];
    return acc == 0;
}

inline bool eq(const Fp& a, const Fp& b) {
    u64 acc = 0;
    for (int i = 0; i < L; i++) acc |= a.l[i] ^ b.l[i];
    return acc == 0;
}

inline void sub_nored(Fp& r, const Fp& a, const Fp& b) {
    u128 borrow = 0;
    for (int i = 0; i < L; i++) {
        u128 d = (u128)a.l[i] - b.l[i] - borrow;
        r.l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

inline void add(Fp& r, const Fp& a, const Fp& b) {
    u128 carry = 0;
    for (int i = 0; i < L; i++) {
        u128 s = (u128)a.l[i] + b.l[i] + carry;
        r.l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(r, P)) sub_nored(r, r, P);
}

inline void sub(Fp& r, const Fp& a, const Fp& b) {
    u128 borrow = 0;
    Fp t;
    for (int i = 0; i < L; i++) {
        u128 d = (u128)a.l[i] - b.l[i] - borrow;
        t.l[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < L; i++) {
            u128 s = (u128)t.l[i] + P.l[i] + carry;
            t.l[i] = (u64)s;
            carry = s >> 64;
        }
    }
    r = t;
}

inline void neg(Fp& r, const Fp& a) {
    if (is_zero(a)) { r = a; return; }
    sub_nored(r, P, a);
}

// CIOS Montgomery multiplication
void mont_mul(Fp& out, const Fp& a, const Fp& b) {
    u64 t[L + 2] = {0};
    for (int i = 0; i < L; i++) {
        u128 c = 0;
        for (int j = 0; j < L; j++) {
            u128 s = (u128)t[j] + (u128)a.l[j] * b.l[i] + c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[L] + c;
        t[L] = (u64)s;
        t[L + 1] = (u64)(s >> 64);

        u64 m = t[0] * N0;
        c = ((u128)t[0] + (u128)m * P.l[0]) >> 64;
        for (int j = 1; j < L; j++) {
            s = (u128)t[j] + (u128)m * P.l[j] + c;
            t[j - 1] = (u64)s;
            c = s >> 64;
        }
        s = (u128)t[L] + c;
        t[L - 1] = (u64)s;
        t[L] = t[L + 1] + (u64)(s >> 64);
        t[L + 1] = 0;
    }
    Fp r;
    std::memcpy(r.l, t, sizeof(r.l));
    if (t[L] || geq(r, P)) sub_nored(r, r, P);
    out = r;
}

inline void mont_sqr(Fp& out, const Fp& a) { mont_mul(out, a, a); }

// modexp over a big-endian byte exponent (value in Montgomery domain).
// Fixed 4-bit window: 14 table muls + 1 mul per nonzero nibble beats the
// ~190 muls of bit-at-a-time for the 381-bit exponents every
// decompression runs (sqrt + inversion are the host hot path).
void fp_pow(Fp& out, const Fp& base, const uint8_t* exp, int nbytes) {
    Fp tbl[16];
    tbl[1] = base;
    for (int i = 2; i < 16; i++) mont_mul(tbl[i], tbl[i - 1], base);
    Fp acc = ONE_M;
    bool started = false;
    for (int i = 0; i < nbytes; i++) {
        for (int half = 1; half >= 0; half--) {
            int nib = (exp[i] >> (4 * half)) & 0xF;
            if (started) {
                mont_sqr(acc, acc);
                mont_sqr(acc, acc);
                mont_sqr(acc, acc);
                mont_sqr(acc, acc);
                if (nib) mont_mul(acc, acc, tbl[nib]);
            } else if (nib) {
                acc = tbl[nib];
                started = true;
            }
        }
    }
    out = started ? acc : ONE_M;
}

inline void fp_inv(Fp& out, const Fp& a) {
    fp_pow(out, a, EXP_P_MINUS_2, 48);
}

// bytes (big-endian 48) <-> Fp
bool fp_from_bytes(Fp& out, const uint8_t* in) {
    Fp raw;
    for (int i = 0; i < L; i++) {
        u64 v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | in[(L - 1 - i) * 8 + j];
        raw.l[i] = v;
    }
    if (geq(raw, P)) return false;   // canonical range is [0, p)
    mont_mul(out, raw, R2);
    return true;
}

void fp_to_bytes(uint8_t* out, const Fp& a) {
    Fp raw;
    Fp one_int = {{1, 0, 0, 0, 0, 0}};
    mont_mul(raw, a, one_int);  // from Montgomery
    for (int i = 0; i < L; i++) {
        u64 v = raw.l[L - 1 - i];
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(v >> (56 - 8 * j));
    }
}

// lexicographic "y > (p-1)/2" on the integer value
bool fp_is_big(const Fp& a) {
    Fp raw;
    Fp one_int = {{1, 0, 0, 0, 0, 0}};
    mont_mul(raw, a, one_int);
    // 2*raw > p-1  <=>  2*raw >= p+1  <=>  2*raw > p (p odd)
    Fp dbl;
    u128 carry = 0;
    for (int i = 0; i < L; i++) {
        u128 s = ((u128)raw.l[i] << 1) | carry;
        dbl.l[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry) return true;
    return geq(dbl, P) && !eq(dbl, P);
}

// ---- Fq2 = Fq[u]/(u^2+1) --------------------------------------------------

struct Fp2 { Fp a, b; };

Fp2 XI_M;        // 1 + u
Fp INV2_M;       // to_mont(2^-1)
Fp2 FROB_G[6];   // gamma[k] = XI^(k*(p-1)/6)
Fp2 PSI_CX_M;    // xi^(-(p-1)/3)  (curve.py PSI_CX)
Fp2 PSI_CY_M;    // xi^(-(p-1)/2)  (curve.py PSI_CY)

inline void f2_add(Fp2& r, const Fp2& x, const Fp2& y) {
    add(r.a, x.a, y.a);
    add(r.b, x.b, y.b);
}

inline void f2_sub(Fp2& r, const Fp2& x, const Fp2& y) {
    sub(r.a, x.a, y.a);
    sub(r.b, x.b, y.b);
}

inline void f2_neg(Fp2& r, const Fp2& x) {
    neg(r.a, x.a);
    neg(r.b, x.b);
}

void f2_mul(Fp2& r, const Fp2& x, const Fp2& y) {
    Fp t0, t1, t2, sa, sb;
    mont_mul(t0, x.a, y.a);
    mont_mul(t1, x.b, y.b);
    add(sa, x.a, x.b);
    add(sb, y.a, y.b);
    mont_mul(t2, sa, sb);
    Fp ra;
    sub(ra, t0, t1);
    Fp rb;
    sub(rb, t2, t0);
    sub(rb, rb, t1);
    r.a = ra;
    r.b = rb;
}

void f2_sqr(Fp2& r, const Fp2& x) {
    // (a+b)(a-b), 2ab
    Fp s, d, ab;
    add(s, x.a, x.b);
    sub(d, x.a, x.b);
    mont_mul(ab, x.a, x.b);
    mont_mul(r.a, s, d);
    add(r.b, ab, ab);
}

inline void f2_mul_fp(Fp2& r, const Fp2& x, const Fp& k) {
    mont_mul(r.a, x.a, k);
    mont_mul(r.b, x.b, k);
}

inline void f2_conj(Fp2& r, const Fp2& x) {
    r.a = x.a;
    neg(r.b, x.b);
}

inline bool f2_is_zero(const Fp2& x) { return is_zero(x.a) && is_zero(x.b); }

inline bool f2_eq(const Fp2& x, const Fp2& y) {
    return eq(x.a, y.a) && eq(x.b, y.b);
}

void f2_inv(Fp2& r, const Fp2& x) {
    Fp n, t, d;
    mont_sqr(n, x.a);
    mont_sqr(t, x.b);
    add(n, n, t);
    fp_inv(d, n);
    mont_mul(r.a, x.a, d);
    Fp nb;
    neg(nb, x.b);
    mont_mul(r.b, nb, d);
}

void f2_pow(Fp2& out, const Fp2& base, const uint8_t* exp, int nbytes) {
    Fp2 acc = {ONE_M, ZERO};
    bool started = false;
    for (int i = 0; i < nbytes; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) f2_sqr(acc, acc);
            if ((exp[i] >> bit) & 1) {
                if (started) f2_mul(acc, acc, base);
                else { acc = base; started = true; }
            }
        }
    }
    out = started ? acc : Fp2{ONE_M, ZERO};
}

// complex-method sqrt mirroring crypto/bls/fields.py Fq2.sqrt; returns
// false when x is a non-square
bool f2_sqrt(Fp2& out, const Fp2& x) {
    if (f2_is_zero(x)) { out = {ZERO, ZERO}; return true; }
    Fp n, t, s;
    mont_sqr(n, x.a);
    mont_sqr(t, x.b);
    add(n, n, t);                   // norm = a^2 + b^2
    fp_pow(s, n, EXP_SQRT, 48);
    Fp chk;
    mont_sqr(chk, s);
    if (!eq(chk, n)) return false;
    for (int sign = 0; sign < 2; sign++) {
        Fp base;
        if (sign == 0) add(base, x.a, s);
        else sub(base, x.a, s);
        mont_mul(base, base, INV2_M);       // t = (a ± s)/2
        // ONE exponentiation gives both the sqrt and the inverse:
        // u = t^((p-3)/4)  =>  ya = u·t = t^((p+1)/4), and for a QR t,
        // ya·u = t^((p-1)/2) = 1 so 1/ya = u — no Fermat inversion pow
        Fp u, ya;
        fp_pow(u, base, EXP_PM3_4, 48);
        mont_mul(ya, u, base);
        mont_sqr(chk, ya);
        if (!eq(chk, base)) continue;
        if (is_zero(ya)) {
            Fp yb_sq, yb;
            neg(yb_sq, x.a);
            fp_pow(yb, yb_sq, EXP_SQRT, 48);
            mont_sqr(chk, yb);
            if (!eq(chk, yb_sq)) continue;
            Fp2 cand = {ZERO, yb};
            Fp2 sq;
            f2_sqr(sq, cand);
            if (f2_eq(sq, x)) { out = cand; return true; }
            continue;
        }
        Fp yb;                              // yb = b/(2 ya) = b·u·2^-1
        mont_mul(yb, x.b, u);
        mont_mul(yb, yb, INV2_M);
        Fp2 cand = {ya, yb};
        Fp2 sq;
        f2_sqr(sq, cand);
        if (f2_eq(sq, x)) { out = cand; return true; }
    }
    return false;
}

// ---- Fq6 = Fq2[v]/(v^3 - xi),  Fq12 = Fq6[w]/(w^2 - v) --------------------

struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

inline void f6_add(Fp6& r, const Fp6& x, const Fp6& y) {
    f2_add(r.c0, x.c0, y.c0);
    f2_add(r.c1, x.c1, y.c1);
    f2_add(r.c2, x.c2, y.c2);
}

inline void f6_sub(Fp6& r, const Fp6& x, const Fp6& y) {
    f2_sub(r.c0, x.c0, y.c0);
    f2_sub(r.c1, x.c1, y.c1);
    f2_sub(r.c2, x.c2, y.c2);
}

inline void f6_neg(Fp6& r, const Fp6& x) {
    f2_neg(r.c0, x.c0);
    f2_neg(r.c1, x.c1);
    f2_neg(r.c2, x.c2);
}

void f6_mul(Fp6& r, const Fp6& x, const Fp6& y) {
    Fp2 t0, t1, t2, s1, s2, u;
    f2_mul(t0, x.c0, y.c0);
    f2_mul(t1, x.c1, y.c1);
    f2_mul(t2, x.c2, y.c2);
    // c0 = t0 + ((a1+a2)(b1+b2) - t1 - t2) * xi
    f2_add(s1, x.c1, x.c2);
    f2_add(s2, y.c1, y.c2);
    f2_mul(u, s1, s2);
    f2_sub(u, u, t1);
    f2_sub(u, u, t2);
    f2_mul(u, u, XI_M);
    Fp2 c0;
    f2_add(c0, t0, u);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + t2*xi
    f2_add(s1, x.c0, x.c1);
    f2_add(s2, y.c0, y.c1);
    f2_mul(u, s1, s2);
    f2_sub(u, u, t0);
    f2_sub(u, u, t1);
    Fp2 v;
    f2_mul(v, t2, XI_M);
    Fp2 c1;
    f2_add(c1, u, v);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    f2_add(s1, x.c0, x.c2);
    f2_add(s2, y.c0, y.c2);
    f2_mul(u, s1, s2);
    f2_sub(u, u, t0);
    f2_sub(u, u, t2);
    f2_add(r.c2, u, t1);
    r.c0 = c0;
    r.c1 = c1;
}

inline void f6_mul_by_v(Fp6& r, const Fp6& x) {
    Fp2 c0;
    f2_mul(c0, x.c2, XI_M);
    Fp2 old0 = x.c0, old1 = x.c1;
    r.c0 = c0;
    r.c1 = old0;
    r.c2 = old1;
}

void f6_inv(Fp6& r, const Fp6& x) {
    Fp2 t0, t1, t2, u, v, d;
    // t0 = a^2 - b*c*xi
    f2_sqr(t0, x.c0);
    f2_mul(u, x.c1, x.c2);
    f2_mul(u, u, XI_M);
    f2_sub(t0, t0, u);
    // t1 = c^2*xi - a*b
    f2_sqr(t1, x.c2);
    f2_mul(t1, t1, XI_M);
    f2_mul(u, x.c0, x.c1);
    f2_sub(t1, t1, u);
    // t2 = b^2 - a*c
    f2_sqr(t2, x.c1);
    f2_mul(u, x.c0, x.c2);
    f2_sub(t2, t2, u);
    // d = a*t0 + (c*t1 + b*t2)*xi
    f2_mul(u, x.c2, t1);
    f2_mul(v, x.c1, t2);
    f2_add(u, u, v);
    f2_mul(u, u, XI_M);
    f2_mul(v, x.c0, t0);
    f2_add(u, u, v);
    f2_inv(d, u);
    f2_mul(r.c0, t0, d);
    f2_mul(r.c1, t1, d);
    f2_mul(r.c2, t2, d);
}

void f12_mul(Fp12& r, const Fp12& x, const Fp12& y) {
    Fp6 t0, t1, s0, s1, u;
    f6_mul(t0, x.c0, y.c0);
    f6_mul(t1, x.c1, y.c1);
    f6_add(s0, x.c0, x.c1);
    f6_add(s1, y.c0, y.c1);
    f6_mul(u, s0, s1);
    f6_sub(u, u, t0);
    f6_sub(u, u, t1);
    Fp6 tv;
    f6_mul_by_v(tv, t1);
    f6_add(r.c0, t0, tv);
    r.c1 = u;
}

inline void f12_sqr(Fp12& r, const Fp12& x) { f12_mul(r, x, x); }

inline void f12_conj(Fp12& r, const Fp12& x) {
    r.c0 = x.c0;
    f6_neg(r.c1, x.c1);
}

void f12_inv(Fp12& r, const Fp12& x) {
    Fp6 t0, t1, d;
    f6_mul(t0, x.c0, x.c0);
    f6_mul(t1, x.c1, x.c1);
    Fp6 tv;
    f6_mul_by_v(tv, t1);
    f6_sub(t0, t0, tv);
    f6_inv(d, t0);
    f6_mul(r.c0, x.c0, d);
    Fp6 nd;
    f6_neg(nd, d);
    f6_mul(r.c1, x.c1, nd);
}

bool f12_is_one(const Fp12& x) {
    return f2_eq(x.c0.c0, Fp2{ONE_M, ZERO}) && f2_is_zero(x.c0.c1) &&
           f2_is_zero(x.c0.c2) && f2_is_zero(x.c1.c0) &&
           f2_is_zero(x.c1.c1) && f2_is_zero(x.c1.c2);
}

// Frobenius f^(p^n) via coefficient conjugation + gamma twists
// (fields.py frobenius)
void f12_frob(Fp12& r, const Fp12& x, int n) {
    Fp12 f = x;
    for (int k = 0; k < n; k++) {
        Fp12 o;
        f2_conj(o.c0.c0, f.c0.c0);
        f2_conj(o.c0.c1, f.c0.c1);
        f2_mul(o.c0.c1, o.c0.c1, FROB_G[2]);
        f2_conj(o.c0.c2, f.c0.c2);
        f2_mul(o.c0.c2, o.c0.c2, FROB_G[4]);
        f2_conj(o.c1.c0, f.c1.c0);
        f2_mul(o.c1.c0, o.c1.c0, FROB_G[1]);
        f2_conj(o.c1.c1, f.c1.c1);
        f2_mul(o.c1.c1, o.c1.c1, FROB_G[3]);
        f2_conj(o.c1.c2, f.c1.c2);
        f2_mul(o.c1.c2, o.c1.c2, FROB_G[5]);
        f = o;
    }
    r = f;
}

// f^|x| by square-and-multiply, x = 0xD201000000010000 (cyclotomic input,
// fields.py _pow_u_cyc); then conj for the negative sign
constexpr u64 BLS_X = 0xD201000000010000ull;

void f12_pow_x_conj(Fp12& r, const Fp12& f) {
    Fp12 out = f;
    bool started = false;
    for (int bit = 63; bit >= 0; bit--) {
        if (!started) {
            if ((BLS_X >> bit) & 1) started = true;
            continue;
        }
        f12_sqr(out, out);
        if ((BLS_X >> bit) & 1) f12_mul(out, out, f);
    }
    f12_conj(r, out);
}

// (f^((p^12-1)/r))^3 — fields.py final_exponentiation_fast
void final_exp_fast(Fp12& r, const Fp12& f) {
    // easy: t = conj(f) * inv(f); t = frob^2(t) * t
    Fp12 t, inv, c;
    f12_inv(inv, f);
    f12_conj(c, f);
    f12_mul(t, c, inv);
    Fp12 fr;
    f12_frob(fr, t, 2);
    Fp12 m;
    f12_mul(m, fr, t);
    // hard: x-ladder
    Fp12 t1, g3, g2, g1, g0, tmp, sq;
    f12_pow_x_conj(t1, m);                  // m^x
    f12_pow_x_conj(tmp, t1);                // m^(x^2)
    f12_sqr(sq, t1);
    f12_conj(sq, sq);
    f12_mul(g3, tmp, sq);
    f12_mul(g3, g3, m);                     // m^(x^2-2x+1)
    f12_pow_x_conj(g2, g3);
    f12_pow_x_conj(g1, g2);
    f12_conj(tmp, g3);
    f12_mul(g1, g1, tmp);
    f12_pow_x_conj(g0, g1);
    f12_sqr(sq, m);
    f12_mul(g0, g0, sq);
    f12_mul(g0, g0, m);
    f12_frob(tmp, g1, 1);
    f12_mul(r, g0, tmp);
    f12_frob(tmp, g2, 2);
    f12_mul(r, r, tmp);
    f12_frob(tmp, g3, 3);
    f12_mul(r, r, tmp);
}

// ---- byte-exponent helpers -------------------------------------------------

void limbs_to_be_bytes(uint8_t* out, const Fp& a) {
    for (int i = 0; i < L; i++) {
        u64 v = a.l[L - 1 - i];
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(v >> (56 - 8 * j));
    }
}

// divide the raw (non-Montgomery) limb value by the small constant d
void limbs_div_small(Fp& r, const Fp& a, u64 d) {
    u128 rem = 0;
    for (int i = L - 1; i >= 0; i--) {
        u128 cur = (rem << 64) | a.l[i];
        r.l[i] = (u64)(cur / d);
        rem = cur % d;
    }
}

bool INITED = false;

void do_init() {
    if (INITED) return;
    // N0 = -p^{-1} mod 2^64 (Newton)
    u64 inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - P.l[0] * inv;
    N0 = ~inv + 1;
    // ONE_M = 2^384 mod p: start at 1, double 384 times
    Fp r = {{1, 0, 0, 0, 0, 0}};
    for (int i = 0; i < 384; i++) add(r, r, r);
    ONE_M = r;
    // R2 = 2^768 mod p: double 384 more
    for (int i = 0; i < 384; i++) add(r, r, r);
    R2 = r;
    // exponents
    Fp e;
    sub_nored(e, P, Fp{{2, 0, 0, 0, 0, 0}});
    limbs_to_be_bytes(EXP_P_MINUS_2, e);
    Fp p1 = P;  // p+1 (no overflow: top limb 0x1A01... has headroom)
    p1.l[0] += 1;
    limbs_div_small(e, p1, 4);
    limbs_to_be_bytes(EXP_SQRT, e);
    Fp pm3;
    sub_nored(pm3, P, Fp{{3, 0, 0, 0, 0, 0}});
    limbs_div_small(e, pm3, 4);
    limbs_to_be_bytes(EXP_PM3_4, e);
    Fp pm1;
    sub_nored(pm1, P, Fp{{1, 0, 0, 0, 0, 0}});
    limbs_div_small(e, pm1, 6);
    limbs_to_be_bytes(EXP_FROB, e);
    // constants
    XI_M = {ONE_M, ONE_M};                       // 1 + u
    Fp half;                                     // 2^-1 = (p+1)/2
    limbs_div_small(half, p1, 2);
    mont_mul(INV2_M, half, R2);
    // frobenius gammas: g[k] = XI^(k*(p-1)/6) = g[1]^k
    FROB_G[0] = {ONE_M, ZERO};
    f2_pow(FROB_G[1], XI_M, EXP_FROB, 48);
    for (int k = 2; k < 6; k++) f2_mul(FROB_G[k], FROB_G[k - 1], FROB_G[1]);
    // psi endomorphism coefficients: FROB_G[2] = xi^((p-1)/3),
    // FROB_G[3] = xi^((p-1)/2) — the psi constants are their inverses
    f2_inv(PSI_CX_M, FROB_G[2]);
    f2_inv(PSI_CY_M, FROB_G[3]);
    INITED = true;
}

// ---- decompression ---------------------------------------------------------

// G1: y^2 = x^3 + 4
int g1_decompress_one(const uint8_t* in, uint8_t* out) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return -1;
    if (flags & 0x40) {
        if (flags & 0x3F) return -1;
        for (int i = 1; i < 48; i++) if (in[i]) return -1;
        return 1;  // infinity
    }
    uint8_t xb[48];
    std::memcpy(xb, in, 48);
    xb[0] = flags & 0x1F;
    Fp x;
    if (!fp_from_bytes(x, xb)) return -1;
    Fp y2, t;
    mont_sqr(t, x);
    mont_mul(y2, t, x);
    Fp four_m;
    Fp four_int = {{4, 0, 0, 0, 0, 0}};
    mont_mul(four_m, four_int, R2);
    add(y2, y2, four_m);
    Fp y;
    fp_pow(y, y2, EXP_SQRT, 48);
    Fp chk;
    mont_sqr(chk, y);
    if (!eq(chk, y2)) return -1;
    bool want_big = (flags & 0x20) != 0;
    if (want_big != fp_is_big(y)) neg(y, y);
    fp_to_bytes(out, x);
    fp_to_bytes(out + 48, y);
    return 0;
}

// G2: y^2 = x^3 + 4(1+u); input x encoded x.b||x.a (curve.py g2_to_bytes)
int g2_decompress_one(const uint8_t* in, uint8_t* out) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return -1;
    if (flags & 0x40) {
        if (flags & 0x3F) return -1;
        for (int i = 1; i < 96; i++) if (in[i]) return -1;
        return 1;
    }
    uint8_t x1b[48];
    std::memcpy(x1b, in, 48);
    x1b[0] = flags & 0x1F;
    Fp2 x;
    if (!fp_from_bytes(x.b, x1b)) return -1;     // first half is x.b
    if (!fp_from_bytes(x.a, in + 48)) return -1;
    Fp2 y2, t;
    f2_sqr(t, x);
    f2_mul(y2, t, x);
    // B2 = 4*(1+u) = Fq2(4, 4)
    Fp four_m;
    Fp four_int = {{4, 0, 0, 0, 0, 0}};
    mont_mul(four_m, four_int, R2);
    Fp2 b2 = {four_m, four_m};
    f2_add(y2, y2, b2);
    Fp2 y;
    if (!f2_sqrt(y, y2)) return -1;
    bool y_big = is_zero(y.b) ? fp_is_big(y.a) : fp_is_big(y.b);
    bool want_big = (flags & 0x20) != 0;
    if (want_big != y_big) f2_neg(y, y);
    fp_to_bytes(out, x.a);
    fp_to_bytes(out + 48, x.b);
    fp_to_bytes(out + 96, y.a);
    fp_to_bytes(out + 144, y.b);
    return 0;
}

// ---- G2 subgroup check (psi) ----------------------------------------------
// psi(x, y) = (conj(x)*PSI_CX, conj(y)*PSI_CY); Q is in the prime-order
// subgroup iff psi(Q) == [BLS_X]Q with BLS_X = -0xd201000000010000,
// i.e. [|BLS_X|]Q == -psi(Q)  (mirrors curve.py g2_in_subgroup_fast).

struct G2j { Fp2 X, Y, Z; bool inf; };

// dbl-2009-l (a = 0); alias-safe: all reads precede the writes
void g2j_dbl(G2j& r, const G2j& p) {
    if (p.inf) { r.inf = true; return; }
    Fp2 A, B, C, D, E, F, X3, Y3, Z3, t;
    f2_sqr(A, p.X);
    f2_sqr(B, p.Y);
    f2_sqr(C, B);
    f2_add(t, p.X, B); f2_sqr(t, t); f2_sub(t, t, A); f2_sub(t, t, C);
    f2_add(D, t, t);
    f2_add(E, A, A); f2_add(E, E, A);
    f2_sqr(F, E);
    f2_sub(X3, F, D); f2_sub(X3, X3, D);
    f2_sub(t, D, X3); f2_mul(Y3, E, t);
    f2_add(t, C, C); f2_add(t, t, t); f2_add(t, t, t);   // 8C
    f2_sub(Y3, Y3, t);
    f2_mul(Z3, p.Y, p.Z); f2_add(Z3, Z3, Z3);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = f2_is_zero(Z3);   // Y == 0: 2-torsion doubles to infinity
}

// madd-2007-bl mixed addition (Z2 = 1); adversarial inputs may hit the
// equal/opposite edge cases, both handled exactly
void g2j_madd(G2j& r, const G2j& p, const Fp2& qx, const Fp2& qy) {
    if (p.inf) {
        r.X = qx; r.Y = qy; r.Z = {ONE_M, ZERO}; r.inf = false;
        return;
    }
    Fp2 Z1Z1, U2, S2, H, HH, I, J, rr, V, X3, Y3, Z3, t;
    f2_sqr(Z1Z1, p.Z);
    f2_mul(U2, qx, Z1Z1);
    f2_mul(t, p.Z, Z1Z1); f2_mul(S2, qy, t);
    f2_sub(H, U2, p.X);
    f2_sub(rr, S2, p.Y); f2_add(rr, rr, rr);
    if (f2_is_zero(H)) {
        if (f2_is_zero(rr)) { g2j_dbl(r, p); return; }
        r.inf = true; return;                     // P + (-P)
    }
    f2_sqr(HH, H);
    f2_add(I, HH, HH); f2_add(I, I, I);
    f2_mul(J, H, I);
    f2_mul(V, p.X, I);
    f2_sqr(X3, rr); f2_sub(X3, X3, J);
    f2_sub(X3, X3, V); f2_sub(X3, X3, V);
    f2_sub(t, V, X3); f2_mul(Y3, rr, t);
    f2_mul(t, p.Y, J); f2_add(t, t, t);
    f2_sub(Y3, Y3, t);
    f2_add(t, p.Z, H); f2_sqr(t, t);
    f2_sub(t, t, Z1Z1); f2_sub(Z3, t, HH);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = f2_is_zero(Z3);
}

void g2j_mul_u64(G2j& r, const Fp2& qx, const Fp2& qy, u64 k) {
    r.inf = true;
    bool started = false;
    for (int i = 63; i >= 0; i--) {
        if (started) g2j_dbl(r, r);
        if ((k >> i) & 1) {
            if (!started) {
                r.X = qx; r.Y = qy; r.Z = {ONE_M, ZERO};
                r.inf = false; started = true;
            } else {
                g2j_madd(r, r, qx, qy);
            }
        }
    }
}

// ---- G1 Jacobian (same formulas over Fp; y^2 = x^3 + 4) --------------------

struct G1j { Fp X, Y, Z; bool inf; };

void g1j_dbl(G1j& r, const G1j& p) {
    if (p.inf) { r.inf = true; return; }
    Fp A, B, C, D, E, F, X3, Y3, Z3, t;
    mont_sqr(A, p.X);
    mont_sqr(B, p.Y);
    mont_sqr(C, B);
    add(t, p.X, B); mont_sqr(t, t); sub(t, t, A); sub(t, t, C);
    add(D, t, t);
    add(E, A, A); add(E, E, A);
    mont_sqr(F, E);
    sub(X3, F, D); sub(X3, X3, D);
    sub(t, D, X3); mont_mul(Y3, E, t);
    add(t, C, C); add(t, t, t); add(t, t, t);
    sub(Y3, Y3, t);
    mont_mul(Z3, p.Y, p.Z); add(Z3, Z3, Z3);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = is_zero(Z3);
}

void g1j_madd(G1j& r, const G1j& p, const Fp& qx, const Fp& qy) {
    if (p.inf) {
        r.X = qx; r.Y = qy; r.Z = ONE_M; r.inf = false;
        return;
    }
    Fp Z1Z1, U2, S2, H, HH, I, J, rr, V, X3, Y3, Z3, t;
    mont_sqr(Z1Z1, p.Z);
    mont_mul(U2, qx, Z1Z1);
    mont_mul(t, p.Z, Z1Z1); mont_mul(S2, qy, t);
    sub(H, U2, p.X);
    sub(rr, S2, p.Y); add(rr, rr, rr);
    if (is_zero(H)) {
        if (is_zero(rr)) { g1j_dbl(r, p); return; }
        r.inf = true; return;
    }
    mont_sqr(HH, H);
    add(I, HH, HH); add(I, I, I);
    mont_mul(J, H, I);
    mont_mul(V, p.X, I);
    mont_sqr(X3, rr); sub(X3, X3, J);
    sub(X3, X3, V); sub(X3, X3, V);
    sub(t, V, X3); mont_mul(Y3, rr, t);
    mont_mul(t, p.Y, J); add(t, t, t);
    sub(Y3, Y3, t);
    add(t, p.Z, H); mont_sqr(t, t);
    sub(t, t, Z1Z1); sub(Z3, t, HH);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = is_zero(Z3);
}

// MSB-first double-and-add over a 32-byte big-endian scalar (the
// segment-lincomb entries carry collapsed mod-R blinder sums: 64-bit
// in the common case, wider only for honest in-lane duplicates —
// cost scales with the top set bit)
void g1j_mul_be(G1j& r, const Fp& qx, const Fp& qy, const uint8_t* k) {
    r.inf = true;
    bool started = false;
    for (int i = 0; i < 32; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) g1j_dbl(r, r);
            if ((k[i] >> bit) & 1) {
                if (!started) {
                    r.X = qx; r.Y = qy; r.Z = ONE_M;
                    r.inf = false; started = true;
                } else {
                    g1j_madd(r, r, qx, qy);
                }
            }
        }
    }
}

void g2j_mul_be(G2j& r, const Fp2& qx, const Fp2& qy, const uint8_t* k) {
    r.inf = true;
    bool started = false;
    for (int i = 0; i < 32; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) g2j_dbl(r, r);
            if ((k[i] >> bit) & 1) {
                if (!started) {
                    r.X = qx; r.Y = qy; r.Z = {ONE_M, ZERO};
                    r.inf = false; started = true;
                } else {
                    g2j_madd(r, r, qx, qy);
                }
            }
        }
    }
}

void g2j_add(G2j& r, const G2j& p, const G2j& q) {
    if (p.inf) { r = q; return; }
    if (q.inf) { r = p; return; }
    // general Jacobian addition via madd on the affinized q would cost
    // an inversion; use add-2007-bl
    Fp2 Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, X3, Y3, Z3, t;
    f2_sqr(Z1Z1, p.Z);
    f2_sqr(Z2Z2, q.Z);
    f2_mul(U1, p.X, Z2Z2);
    f2_mul(U2, q.X, Z1Z1);
    f2_mul(t, q.Z, Z2Z2); f2_mul(S1, p.Y, t);
    f2_mul(t, p.Z, Z1Z1); f2_mul(S2, q.Y, t);
    f2_sub(H, U2, U1);
    f2_sub(rr, S2, S1); f2_add(rr, rr, rr);
    if (f2_is_zero(H)) {
        if (f2_is_zero(rr)) { g2j_dbl(r, p); return; }
        r.inf = true; return;
    }
    f2_add(I, H, H); f2_sqr(I, I);
    f2_mul(J, H, I);
    f2_mul(V, U1, I);
    f2_sqr(X3, rr); f2_sub(X3, X3, J);
    f2_sub(X3, X3, V); f2_sub(X3, X3, V);
    f2_sub(t, V, X3); f2_mul(Y3, rr, t);
    f2_mul(t, S1, J); f2_add(t, t, t);
    f2_sub(Y3, Y3, t);
    f2_add(t, p.Z, q.Z); f2_sqr(t, t);
    f2_sub(t, t, Z1Z1); f2_sub(t, t, Z2Z2);
    f2_mul(Z3, t, H);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = f2_is_zero(Z3);
}

void g1j_add(G1j& r, const G1j& p, const G1j& q) {
    if (p.inf) { r = q; return; }
    if (q.inf) { r = p; return; }
    Fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, X3, Y3, Z3, t;
    mont_sqr(Z1Z1, p.Z);
    mont_sqr(Z2Z2, q.Z);
    mont_mul(U1, p.X, Z2Z2);
    mont_mul(U2, q.X, Z1Z1);
    mont_mul(t, q.Z, Z2Z2); mont_mul(S1, p.Y, t);
    mont_mul(t, p.Z, Z1Z1); mont_mul(S2, q.Y, t);
    sub(H, U2, U1);
    sub(rr, S2, S1); add(rr, rr, rr);
    if (is_zero(H)) {
        if (is_zero(rr)) { g1j_dbl(r, p); return; }
        r.inf = true; return;
    }
    add(I, H, H); mont_sqr(I, I);
    mont_mul(J, H, I);
    mont_mul(V, U1, I);
    mont_sqr(X3, rr); sub(X3, X3, J);
    sub(X3, X3, V); sub(X3, X3, V);
    sub(t, V, X3); mont_mul(Y3, rr, t);
    mont_mul(t, S1, J); add(t, t, t);
    sub(Y3, Y3, t);
    add(t, p.Z, q.Z); mont_sqr(t, t);
    sub(t, t, Z1Z1); sub(t, t, Z2Z2);
    mont_mul(Z3, t, H);
    r.X = X3; r.Y = Y3; r.Z = Z3;
    r.inf = is_zero(Z3);
}

// in[192] = x.a||x.b||y.a||y.b big-endian 48-byte coords (the
// decompress output layout); -1 = coord out of range, 1 = in
// subgroup, 0 = on-curve-or-not but NOT in the subgroup (callers
// only hand us decompressed on-curve points)
int g2_in_subgroup_one(const uint8_t* in) {
    Fp2 x, y;
    if (!fp_from_bytes(x.a, in)) return -1;
    if (!fp_from_bytes(x.b, in + 48)) return -1;
    if (!fp_from_bytes(y.a, in + 96)) return -1;
    if (!fp_from_bytes(y.b, in + 144)) return -1;
    Fp2 px, py, t;
    f2_conj(t, x); f2_mul(px, t, PSI_CX_M);
    f2_conj(t, y); f2_mul(py, t, PSI_CY_M);
    G2j R;
    g2j_mul_u64(R, x, y, 0xD201000000010000ULL);
    if (R.inf) return 0;     // finite psi(Q) can never equal infinity
    Fp2 zz, zzz, lx, ly;
    f2_sqr(zz, R.Z);
    f2_mul(zzz, zz, R.Z);
    f2_mul(lx, px, zz);
    f2_neg(py, py);
    f2_mul(ly, py, zzz);
    return (f2_eq(lx, R.X) && f2_eq(ly, R.Y)) ? 1 : 0;
}

// Fq12 from 576 bytes: coefficient order c0.c0.a, c0.c0.b, c0.c1.a, ...
// c1.c2.b, each a big-endian 48-byte Fq value
bool f12_from_bytes(Fp12& out, const uint8_t* in) {
    Fp* coeffs[12] = {
        &out.c0.c0.a, &out.c0.c0.b, &out.c0.c1.a, &out.c0.c1.b,
        &out.c0.c2.a, &out.c0.c2.b, &out.c1.c0.a, &out.c1.c0.b,
        &out.c1.c1.a, &out.c1.c1.b, &out.c1.c2.a, &out.c1.c2.b};
    for (int i = 0; i < 12; i++) {
        if (!fp_from_bytes(*coeffs[i], in + i * 48)) return false;
    }
    return true;
}

void f12_to_bytes(uint8_t* out, const Fp12& f) {
    const Fp* coeffs[12] = {
        &f.c0.c0.a, &f.c0.c0.b, &f.c0.c1.a, &f.c0.c1.b,
        &f.c0.c2.a, &f.c0.c2.b, &f.c1.c0.a, &f.c1.c0.b,
        &f.c1.c1.a, &f.c1.c1.b, &f.c1.c2.a, &f.c1.c2.b};
    for (int i = 0; i < 12; i++) fp_to_bytes(out + i * 48, *coeffs[i]);
}

}  // namespace

extern "C" {

int lhbls_init() {
    do_init();
    return 0;
}

// 48-byte compressed -> 96-byte x||y (big-endian).  0 ok, 1 infinity,
// -1 invalid.
int lhbls_g1_decompress(const uint8_t* in, uint8_t* out) {
    do_init();
    return g1_decompress_one(in, out);
}

// 96-byte compressed -> 192-byte x.a||x.b||y.a||y.b.
int lhbls_g2_decompress(const uint8_t* in, uint8_t* out) {
    do_init();
    return g2_decompress_one(in, out);
}

// batch G2: st[i] in {0, 1, -1}; returns count of invalid points
long lhbls_g2_decompress_batch(const uint8_t* in, long n, uint8_t* out,
                               int8_t* st) {
    do_init();
    long bad = 0;
    for (long i = 0; i < n; i++) {
        int r = g2_decompress_one(in + i * 96, out + i * 192);
        st[i] = (int8_t)r;
        if (r < 0) bad++;
    }
    return bad;
}

long lhbls_g1_decompress_batch(const uint8_t* in, long n, uint8_t* out,
                               int8_t* st) {
    do_init();
    long bad = 0;
    for (long i = 0; i < n; i++) {
        int r = g1_decompress_one(in + i * 48, out + i * 96);
        st[i] = (int8_t)r;
        if (r < 0) bad++;
    }
    return bad;
}

// batch G2 psi subgroup check over affine coordinate rows (192 bytes
// per point, the decompress output layout); out[i] in {1, 0, -1} =
// {in subgroup, not in subgroup, coord out of range}; returns n
long lhbls_g2_in_subgroup_batch(const uint8_t* in, long n, int8_t* out) {
    do_init();
    for (long i = 0; i < n; i++)
        out[i] = (int8_t)g2_in_subgroup_one(in + i * 192);
    return n;
}

// batch G1 subgroup check over affine coordinate rows (96 bytes per
// point): [r]P == INF with r the prime group order — slower than an
// endomorphism check but dependency-free, and still ~14x the python
// per-point path.  out[i] in {1, 0, -1} as for the G2 variant.
long lhbls_g1_in_subgroup_batch(const uint8_t* in, long n, int8_t* out) {
    do_init();
    static const uint8_t R_BE[32] = {
        0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48,
        0x33, 0x39, 0xd8, 0x08, 0x09, 0xa1, 0xd8, 0x05,
        0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe, 0x5b, 0xfe,
        0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};
    for (long i = 0; i < n; i++) {
        Fp qx, qy;
        if (!fp_from_bytes(qx, in + i * 96) ||
            !fp_from_bytes(qy, in + i * 96 + 48)) {
            out[i] = -1;
            continue;
        }
        G1j r;
        g1j_mul_be(r, qx, qy, R_BE);
        out[i] = r.inf ? 1 : 0;
    }
    return n;
}

// segment-summed linear combination: out[g] = sum_{i: groups[i]==g}
// scalars[i] * P_i.  Affine points 96 (G1: x||y) / 192 (G2:
// x.a||x.b||y.a||y.b) big-endian bytes per row, 32-byte big-endian
// scalars, int64 group ids in [0, n_groups).  Output affine rows per
// group + flags[g] in {1 finite, 0 identity, -1 bad input row (whole
// call poisoned: callers fall back to the host loop)}.  This is the
// reference-rung fold of the merged-set premerge: one native crossing
// instead of one ~2.5 ms python scalar mul per unique signature.
int lhbls_g1_lincomb_groups(const uint8_t* pts, const uint8_t* scalars,
                            const long long* groups, long n,
                            long n_groups, uint8_t* out, int8_t* flags) {
    do_init();
    std::vector<G1j> acc(n_groups);
    for (long g = 0; g < n_groups; g++) acc[g].inf = true;
    for (long i = 0; i < n; i++) {
        long long g = groups[i];
        if (g < 0 || g >= n_groups) return -1;
        Fp qx, qy;
        if (!fp_from_bytes(qx, pts + i * 96)) return -1;
        if (!fp_from_bytes(qy, pts + i * 96 + 48)) return -1;
        G1j term;
        g1j_mul_be(term, qx, qy, scalars + i * 32);
        G1j sum;
        g1j_add(sum, acc[g], term);
        acc[g] = sum;
    }
    for (long g = 0; g < n_groups; g++) {
        if (acc[g].inf) {
            flags[g] = 0;
            std::memset(out + g * 96, 0, 96);
            continue;
        }
        Fp zi, zi2, zi3, x, y;
        fp_inv(zi, acc[g].Z);
        mont_sqr(zi2, zi);
        mont_mul(zi3, zi2, zi);
        mont_mul(x, acc[g].X, zi2);
        mont_mul(y, acc[g].Y, zi3);
        fp_to_bytes(out + g * 96, x);
        fp_to_bytes(out + g * 96 + 48, y);
        flags[g] = 1;
    }
    return 0;
}

int lhbls_g2_lincomb_groups(const uint8_t* pts, const uint8_t* scalars,
                            const long long* groups, long n,
                            long n_groups, uint8_t* out, int8_t* flags) {
    do_init();
    std::vector<G2j> acc(n_groups);
    for (long g = 0; g < n_groups; g++) acc[g].inf = true;
    for (long i = 0; i < n; i++) {
        long long g = groups[i];
        if (g < 0 || g >= n_groups) return -1;
        Fp2 qx, qy;
        if (!fp_from_bytes(qx.a, pts + i * 192)) return -1;
        if (!fp_from_bytes(qx.b, pts + i * 192 + 48)) return -1;
        if (!fp_from_bytes(qy.a, pts + i * 192 + 96)) return -1;
        if (!fp_from_bytes(qy.b, pts + i * 192 + 144)) return -1;
        G2j term;
        g2j_mul_be(term, qx, qy, scalars + i * 32);
        G2j sum;
        g2j_add(sum, acc[g], term);
        acc[g] = sum;
    }
    for (long g = 0; g < n_groups; g++) {
        if (acc[g].inf) {
            flags[g] = 0;
            std::memset(out + g * 192, 0, 192);
            continue;
        }
        Fp2 zi, zi2, zi3, x, y;
        f2_inv(zi, acc[g].Z);
        f2_sqr(zi2, zi);
        f2_mul(zi3, zi2, zi);
        f2_mul(x, acc[g].X, zi2);
        f2_mul(y, acc[g].Y, zi3);
        fp_to_bytes(out + g * 192, x.a);
        fp_to_bytes(out + g * 192 + 48, x.b);
        fp_to_bytes(out + g * 192 + 96, y.a);
        fp_to_bytes(out + g * 192 + 144, y.b);
        flags[g] = 1;
    }
    return 0;
}

// full (cubed) final exponentiation, 576-byte Fq12 in/out; -1 on a
// non-canonical input coefficient
int lhbls_final_exp(const uint8_t* in, uint8_t* out) {
    do_init();
    Fp12 f;
    if (!f12_from_bytes(f, in)) return -1;
    Fp12 r;
    final_exp_fast(r, f);
    f12_to_bytes(out, r);
    return 0;
}

// 1 if final_exp(f) == 1, 0 if not, -1 on bad input
int lhbls_final_exp_is_one(const uint8_t* in) {
    do_init();
    Fp12 f;
    if (!f12_from_bytes(f, in)) return -1;
    Fp12 r;
    final_exp_fast(r, f);
    return f12_is_one(r) ? 1 : 0;
}

}  // extern "C"
