"""Montgomery fields in 32-bit words: the port's limb format, the int <-> limb
bridge, and the plain PyTorch versions of the arithmetic.  ``MontField``
holds them for any odd modulus below half its radix; ``FP`` is the
BLS12-381 base field, whose names this module also exports at top level,
and ``ops/fr.py`` builds the scalar field Fr on the same class.

Counterpart of ``lighthouse_tpu/ops/bigint.py``.  The formats differ and
only canonical integers are ever compared between the two packages:

- JAX package: 27 x 15-bit redundant limbs, Montgomery R = 2^405;
- this port: 12 x 32-bit little-endian words, FULLY REDUCED in [0, p),
  Montgomery R = 2^384.  A value has one encoding, so "is zero" and
  equality are plain word compares, on the card and here.

Tensors carry the words as ``torch.int32`` with the same bits
(``[..., 12]``); numpy arrays as uint32.  The plain versions compute in
int64 lanes: words masked to 32 bits, and 16-bit digits inside products so
that every partial product and column sum fits in int64.  They are the
CPU path of every kernel wrapper and the reference the CUDA kernels
(``csrc/bls12_381.cuh``) are held to on the card.

Carries are resolved without a data-dependent loop: a fixed number of
shift passes brings every word to at most its base, then one carry
look-ahead (generate / propagate bit masks added as integers) finishes
the ripple exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

W = 32                  # bits per word
M32 = (1 << W) - 1
M16 = (1 << 16) - 1


# --------------------------------------------------------------------------
# numpy <-> tensor (any word count)
# --------------------------------------------------------------------------

def to_tensor(words, device) -> torch.Tensor:
    """uint32 words (numpy) -> int32 tensor of the same bits on ``device``
    (always a copy)."""
    arr = np.array(words, dtype=np.uint32, copy=True, order="C")
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 (or int64 word) tensor -> uint32 numpy array on the host."""
    return (t.detach().to("cpu", torch.int64) & M32).numpy().astype(np.uint32)


def u64(t: torch.Tensor) -> torch.Tensor:
    """int32 word bits -> int64 lanes holding the unsigned words."""
    return t.to(torch.int64) & M32


def i32(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding unsigned words -> int32 word bits."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


# --------------------------------------------------------------------------
# Digit helpers shared by every modulus (int64 lanes)
# --------------------------------------------------------------------------

_SHARED: dict = {}


def _shared_const(name: str, device) -> torch.Tensor:
    """Bit weights ``w<n>`` (1 << i, i < n) and shifts ``s<n>`` (0..n-1)."""
    key = (name, str(device))
    t = _SHARED.get(key)
    if t is None:
        n = int(name[1:])
        if name[0] == "w":
            t = torch.tensor([1 << i for i in range(n)], dtype=torch.int64, device=device)
        elif name[0] == "s":
            t = torch.arange(n, dtype=torch.int64, device=device)
        else:
            raise KeyError(name)
        _SHARED[key] = t
    return t


def _digits16(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & M16 for i in range(n)], np.int64)


def _lookahead(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Finish the carry ripple of digits ``w`` (each in [0, 2^bits]):
    a digit equal to 2^bits generates a carry, one equal to 2^bits - 1
    propagates one.  The carries are the bits changed by adding the
    generate mask (shifted up one) to the propagate mask, as integers.
    Returns (digits mod 2^bits, carry out of the top)."""
    n = w.shape[-1]
    wt, sh = _shared_const(f"w{n}", w.device), _shared_const(f"s{n}", w.device)
    gen = ((w >> bits) * wt).sum(-1)
    prop = ((w == (1 << bits) - 1).to(torch.int64) * wt).sum(-1)
    carries = (prop + (gen << 1)) ^ prop
    cin = (carries.unsqueeze(-1) >> sh) & 1
    return (w + cin) & ((1 << bits) - 1), (carries >> n) & 1


def _normalize(w: torch.Tensor, bits: int, passes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative digits -> digits in [0, 2^bits) with the same value
    modulo 2^(bits * n), plus the carry out of the top digit.  ``passes``
    shift passes must bring every digit to at most 2^bits first; the
    look-ahead runs only when a digit is still 2^bits (on random data,
    rarely), since otherwise no carry is left."""
    mask = (1 << bits) - 1
    out = None
    for _ in range(passes):
        hi = w >> bits
        w = w & mask
        w[..., 1:] += hi[..., :-1]
        out = hi[..., -1] if out is None else out + hi[..., -1]
    if bool((w >> bits).any()):
        w, c = _lookahead(w, bits)
        out = out + c
    return w, out


def _to16(w: torch.Tensor) -> torch.Tensor:
    """[..., n] 32-bit words -> [..., 2n] 16-bit digits."""
    return torch.stack([w & M16, w >> 16], -1).flatten(-2)


def _from16(d: torch.Tensor) -> torch.Tensor:
    d = d.unflatten(-1, (d.shape[-1] // 2, 2))
    return d[..., 0] | (d[..., 1] << 16)


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of digit vectors [..., n] x [..., m] -> [..., n + m]
    unnormalized columns: the outer product, each a_i·b_j added into column
    i + j."""
    n, m = a.shape[-1], b.shape[-1]
    outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    out = outer.new_zeros(outer.shape[:-1] + (n + m,))
    return out.index_add_(-1, _column_index(n, m, a.device), outer)


_COLUMNS: dict = {}


def _column_index(n: int, m: int, device) -> torch.Tensor:
    key = (n, m, str(device))
    idx = _COLUMNS.get(key)
    if idx is None:
        idx = (torch.arange(n)[:, None] + torch.arange(m)[None, :]).flatten().to(device)
        _COLUMNS[key] = idx
    return idx


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


# --------------------------------------------------------------------------
# One Montgomery field: words, host bridge and plain arithmetic
# --------------------------------------------------------------------------

class MontField:
    """Montgomery arithmetic modulo an odd ``modulus`` held in ``n_words``
    32-bit words, fully reduced, Montgomery R = 2^(32·n_words).  The Fp of
    BLS12-381 is ``FP`` below (12 words); its scalar field Fr is
    ``ops/fr.py``'s (8 words).  Plain PyTorch versions over int64 lanes
    holding the unsigned words ``[..., n_words]``."""

    def __init__(self, modulus: int, n_words: int):
        self.P_INT = modulus
        self.L = n_words
        self.R_BITS = W * n_words
        self.R_INT = 1 << self.R_BITS
        assert modulus % 2 == 1 and 2 * modulus < self.R_INT
        self.NPRIME_INT = (-pow(modulus, -1, self.R_INT)) % self.R_INT   # plain REDC
        self.NPRIME32 = (-pow(modulus, -1, 1 << W)) % (1 << W)            # CIOS
        self.ONE_M_INT = self.R_INT % modulus                              # Montgomery 1
        self.R_INV = pow(self.R_INT, -1, modulus)
        self.ONE_M = self.int_to_words(self.ONE_M_INT)
        self.P_WORDS = self.int_to_words(modulus)
        self._consts: dict = {}

    # -- int <-> words (host) -------------------------------------------------

    def int_to_words(self, v: int) -> np.ndarray:
        """int in [0, R) -> uint32[L], little-endian words."""
        return np.frombuffer(int(v).to_bytes(4 * self.L, "little"), "<u4").astype(np.uint32)

    @staticmethod
    def words_to_int(words) -> int:
        return int.from_bytes(np.asarray(words, np.uint32).astype("<u4").tobytes(), "little")

    def ints_to_words(self, vals) -> np.ndarray:
        """[v_0, ...] (each < R) -> uint32[n, L] (vectorized)."""
        vals = list(vals)
        if not vals:
            return np.zeros((0, self.L), np.uint32)
        nb = 4 * self.L
        buf = b"".join(int(v).to_bytes(nb, "little") for v in vals)
        return np.frombuffer(buf, "<u4").astype(np.uint32).reshape(len(vals), self.L)

    def words_to_ints(self, arr) -> list[int]:
        """uint32[..., L] -> flat list of ints (row-major over the leading dims)."""
        nb = 4 * self.L
        raw = np.ascontiguousarray(
            np.asarray(arr, np.uint32).reshape(-1, self.L)).astype("<u4").tobytes()
        return [int.from_bytes(raw[nb * i:nb * (i + 1)], "little") for i in range(len(raw) // nb)]

    def to_mont(self, v: int) -> np.ndarray:
        """Canonical int -> Montgomery words uint32[L]."""
        return self.int_to_words(int(v) * self.R_INT % self.P_INT)

    def from_mont(self, words) -> int | list[int]:
        """Montgomery words -> canonical int (one row) or list of ints."""
        arr = np.asarray(words, np.uint32)
        vals = [v * self.R_INV % self.P_INT for v in self.words_to_ints(arr)]
        return vals[0] if arr.ndim == 1 else vals

    def ints_to_mont_limbs(self, vals) -> np.ndarray:
        """Canonical ints -> Montgomery words uint32[n, L]."""
        return self.ints_to_words([int(v) * self.R_INT % self.P_INT for v in vals])

    def mont_limbs_to_ints(self, arr) -> list[int]:
        return [v * self.R_INV % self.P_INT for v in self.words_to_ints(arr)]

    # -- plain arithmetic (int64 lanes, words in [0, 2^32)) -------------------

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        t = self._consts.get(key)
        if t is None:
            n16 = 2 * self.L
            src = {
                "p": self.P_WORDS, "negp": self.int_to_words(self.R_INT - self.P_INT),
                "one": self.ONE_M,
                "p16": _digits16(self.P_INT, n16), "np16": _digits16(self.NPRIME_INT, n16),
            }
            if name in src:
                t = torch.tensor(src[name].astype(np.int64), device=device)
            elif name.startswith("kp"):            # k*p as words, k = 1, 2, 4
                k = int(name[2:])
                t = torch.tensor(self.int_to_words(k * self.P_INT).astype(np.int64),
                                 device=device)
            else:
                raise KeyError(name)
            self._consts[key] = t
        return t

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(a + b) mod p for words in [0, p)."""
        s = a + b
        both, carry = _normalize(torch.stack([s, s + self._const("negp", s.device)]), W, 2)
        return torch.where(carry[1].bool().unsqueeze(-1), both[1], both[0])

    def _plus_one(self, t: torch.Tensor) -> torch.Tensor:
        return t + F.pad(torch.ones_like(t[..., :1]), (0, self.L - 1))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(a - b) mod p: a + ~b + 1 = a - b + R, whose carry out says a >= b."""
        t = self._plus_one(a + (M32 - b))
        both, carry = _normalize(torch.stack([t, t + self._const("p", t.device)]), W, 2)
        return torch.where(carry[0].bool().unsqueeze(-1), both[0], both[1])

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def scale_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """k·a mod p for a small positive k (double-and-add over k's bits)."""
        assert k > 0
        out = a
        for bit in bin(k)[3:]:
            out = self.add(out, out)
            if bit == "1":
                out = self.add(out, a)
        return out

    def redc(self, t: torch.Tensor, bound: int = 8) -> torch.Tensor:
        """Montgomery reduction of 16-bit-digit columns ``t`` ([..., 4L],
        non-negative, each < 2^40, value < (bound - 1)·p·R, bound a power of
        two up to 8) -> words [..., L] of t·R^-1 mod p, fully reduced (the
        quotient is < bound·p before the final conditional subtractions)."""
        dev = t.device
        h = 2 * self.L                       # 16-bit digits of R
        m, _ = _normalize(poly_mul(t[..., :h], self._const("np16", dev))[..., :h], 16, 4)
        u = t + poly_mul(m, self._const("p16", dev))
        for _ in range(3):                   # every digit now at most 2^16
            hi = u >> 16
            u = u & M16
            u[..., 1:] += hi[..., :-1]
        # u ≡ 0 (mod R), so the low digits are worth 0 or exactly R: they
        # carry one into the high half iff any is nonzero
        high = u[..., h:2 * h].clone()
        high[..., 0] += (u[..., :h] != 0).any(-1).to(high.dtype)
        high, _ = _normalize(high, 16, 1)
        return self.reduce_below(_from16(high), bound)

    def reduce_below(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """x in [0, k·p) (k a power of two, words) -> x mod p, by conditional
        subtraction of k/2·p, ..., p."""
        while k > 1:
            k //= 2
            t = self._plus_one(x + (M32 - self._const(f"kp{k}", x.device)))
            t, carry = _normalize(t, W, 2)
            x = torch.where(carry.bool().unsqueeze(-1), t, x)
        return x

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·R^-1 mod p (fully reduced), any broadcastable
        leading shape."""
        a, b = torch.broadcast_tensors(a, b)
        return self.redc(poly_mul(_to16(a), _to16(b)), 2)   # a·b < p² < p·R

    is_zero = staticmethod(is_zero)

    def one_like(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery one in the shape, device and word dtype (int64 lanes or
        int32 bits) of ``a``."""
        t = self._const("one", a.device).expand(a.shape)
        return t.clone() if a.dtype == torch.int64 else i32(t)


# --------------------------------------------------------------------------
# Fp: the field and its names
# --------------------------------------------------------------------------

FP = MontField(P_INT, 12)

L = FP.L                # words per element
R_BITS = FP.R_BITS      # 384
R_INT = FP.R_INT        # Montgomery R
NPRIME_INT = FP.NPRIME_INT
NPRIME32 = FP.NPRIME32
ONE_M_INT = FP.ONE_M_INT
R_INV = FP.R_INV
ONE_M = FP.ONE_M
P_WORDS = FP.P_WORDS

int_to_words = FP.int_to_words
words_to_int = FP.words_to_int
ints_to_words = FP.ints_to_words
words_to_ints = FP.words_to_ints
to_mont = FP.to_mont
from_mont = FP.from_mont
ints_to_mont_limbs = FP.ints_to_mont_limbs
mont_limbs_to_ints = FP.mont_limbs_to_ints

_const = FP._const
add = FP.add
sub = FP.sub
neg = FP.neg
scale_small = FP.scale_small
redc = FP.redc
reduce_below = FP.reduce_below
mont_mul = FP.mont_mul
one_like = FP.one_like
