"""The divstep inversion of ``csrc/modinv.cuh`` on Python integers: its
result and the 32-bit multiply-adds it takes for a given input.

The inversion is variable time, so the work of a kernel that runs it
depends on its data; the bounds of the kernels that invert (the blinded
pubkey fold's affine step, ``bls_cuda.blinded_fold_muladds``, and the
barycentric evaluation's root, ``fr.eval_muladds``) count it here on the
run's own values.  A CPU test holds ``inverse`` to the counter build of the
header (the same count, value for value) and to ``pow(a, -1, m)``.

Steps, as in the header: batches of 30 divsteps on the low bits of f and g
give a 2x2 transition matrix (4 multiply-adds for each divstep that cancels
bits of g), applied to d, e (6N + 2) and to f, g over all N signed 30-bit
limbs (4N) until g = 0.  Zero takes no step and maps to zero.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
_M30 = (1 << 30) - 1
# -(2i + 1)^-1 mod 256
_NEG_INV256 = tuple((-pow(2 * i + 1, -1, 256)) % 256 for i in range(128))


def n_limbs(m: int) -> int:
    """Signed 30-bit limbs the header keeps for modulus ``m``."""
    return m.bit_length() // 30 + 1


def _signed32(x: int) -> int:
    return x - (1 << 32) if x >> 31 else x


def divsteps_30(eta: int, f0: int, g0: int) -> tuple[int, tuple, int]:
    """30 divsteps on the low 32 bits of f and g (``modinv::divsteps_30``)
    -> (new eta, transition matrix (u, v, q, r) scaled by 2^30, multiply-
    adds)."""
    u, v, q, r = 1, 0, 0, 1
    f, g = f0 & _M32, g0 & _M32
    i, count = 30, 0
    while True:
        x = g | ((_M32 << i) & _M32)
        zeros = (x & -x).bit_length() - 1
        g >>= zeros
        u, v = (u << zeros) & _M32, (v << zeros) & _M32
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        if eta < 0:
            eta = -eta
            f, g = g, -f & _M32
            u, q = q, -u & _M32
            v, r = r, -v & _M32
        limit = min(eta + 1, i)
        m = (_M32 >> (32 - limit)) & 255
        w = (g * _NEG_INV256[(f >> 1) & 127]) & m
        g, q, r = (g + f * w) & _M32, (q + u * w) & _M32, (r + v * w) & _M32
        count += 4
    return eta, tuple(map(_signed32, (u, v, q, r))), count


def inverse(a: int, m: int) -> tuple[int, int]:
    """(a^-1 mod m, 0 for a = 0; the header's multiply-adds) for a
    canonical ``a`` < m and an odd modulus m."""
    if not 0 <= a < m:
        raise ValueError("inverse: a must be canonical")
    if a == 0:
        return 0, 0
    n = n_limbs(m)
    per_batch = 6 * n + 2 + 4 * n
    inv30 = pow(m, -1, 1 << 30)
    d, e, f, g, eta, count = 0, 1, m, a, -1, 0
    while True:
        eta, (u, v, q, r), steps = divsteps_30(eta, f, g)
        count += steps + per_batch
        md = (u if d < 0 else 0) + (v if e < 0 else 0)
        me = (q if d < 0 else 0) + (r if e < 0 else 0)
        cd, ce = u * d + v * e, q * d + r * e
        md -= (inv30 * cd + md) & _M30
        me -= (inv30 * ce + me) & _M30
        d, e = (cd + m * md) >> 30, (ce + m * me) >> 30
        f, g = (u * f + v * g) >> 30, (q * f + r * g) >> 30
        if g == 0:
            break
    if abs(f) != 1:
        raise ValueError("inverse: a is not invertible mod m")
    return d * f % m, count
