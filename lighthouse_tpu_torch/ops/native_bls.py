"""ctypes bindings for the port's host BLS helpers (``csrc/bls_host.cc``).

Port of the entry points of ``lighthouse_tpu/ops/native_bls.py`` that the
batch-verify and KZG paths use: G1/G2 point decompression, the batched G1
membership test, the segment-summed G1/G2 linear combinations and the final
exponentiation.  ``csrc/bls_host.cc`` is the port's own copy of
the JAX package's C++ source, built with ``g++`` into ``_build/`` at first
use (``native.build_host_lib``).  This is host code, not a kernel.  A
failed build raises: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import threading

from lighthouse_tpu_torch.native import build_host_lib

_lib = None
_lock = threading.Lock()

# sentinel for the infinity encoding, as in crypto/bls/curve.py's callers
G1_INF = "inf"
G2_INF = "inf"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = build_host_lib("bls_host")
            lib.lhbls_init.restype = ctypes.c_int
            for fn in (lib.lhbls_g1_decompress, lib.lhbls_g2_decompress):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
                fn.restype = ctypes.c_int
            lib.lhbls_g2_decompress_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int8)]
            lib.lhbls_g2_decompress_batch.restype = ctypes.c_long
            lib.lhbls_g1_decompress_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int8)]
            lib.lhbls_g1_decompress_batch.restype = ctypes.c_long
            lib.lhbls_g1_in_subgroup_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int8)]
            lib.lhbls_g1_in_subgroup_batch.restype = ctypes.c_long
            for fn in (lib.lhbls_g1_lincomb_groups, lib.lhbls_g2_lincomb_groups):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_longlong), ctypes.c_long,
                               ctypes.c_long, ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int8)]
                fn.restype = ctypes.c_int
            lib.lhbls_final_exp.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.lhbls_final_exp.restype = ctypes.c_int
            lib.lhbls_final_exp_is_one.argtypes = [ctypes.c_char_p]
            lib.lhbls_final_exp_is_one.restype = ctypes.c_int
            if lib.lhbls_init() != 0:
                raise RuntimeError("lhbls_init failed")
            _lib = lib
    return _lib


def _g2_from_raw(o: bytes):
    return ((int.from_bytes(o[0:48], "big"), int.from_bytes(o[48:96], "big")),
            (int.from_bytes(o[96:144], "big"), int.from_bytes(o[144:192], "big")))


def g1_decompress(data: bytes):
    """48-byte compressed G1 -> (x, y) ints, ``G1_INF``, or None (invalid)."""
    out = ctypes.create_string_buffer(96)
    r = _load().lhbls_g1_decompress(bytes(data), out)
    if r < 0:
        return None
    if r == 1:
        return G1_INF
    raw = out.raw
    return int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big")


def g2_decompress(data: bytes):
    """96-byte compressed G2 -> ((x.a, x.b), (y.a, y.b)) ints, ``G2_INF``,
    or None (invalid).  No subgroup check."""
    out = ctypes.create_string_buffer(192)
    r = _load().lhbls_g2_decompress(bytes(data), out)
    if r < 0:
        return None
    if r == 1:
        return G2_INF
    return _g2_from_raw(out.raw)


def g2_decompress_batch(blobs: list[bytes]) -> list:
    """Batched G2 decompression in one call: results as in g2_decompress."""
    n = len(blobs)
    if n == 0:
        return []
    out = ctypes.create_string_buffer(192 * n)
    st = (ctypes.c_int8 * n)()
    _load().lhbls_g2_decompress_batch(b"".join(bytes(b) for b in blobs), n, out, st)
    raw = out.raw
    res = []
    for i in range(n):
        if st[i] < 0:
            res.append(None)
        elif st[i] == 1:
            res.append(G2_INF)
        else:
            res.append(_g2_from_raw(raw[i * 192:(i + 1) * 192]))
    return res


def g1_decompress_batch(blobs: list[bytes]) -> list:
    """Batched G1 decompression in one call: results as in g1_decompress
    (no subgroup check)."""
    n = len(blobs)
    if n == 0:
        return []
    out = ctypes.create_string_buffer(96 * n)
    st = (ctypes.c_int8 * n)()
    _load().lhbls_g1_decompress_batch(b"".join(bytes(b) for b in blobs), n, out, st)
    raw = out.raw
    res = []
    for i in range(n):
        if st[i] < 0:
            res.append(None)
        elif st[i] == 1:
            res.append(G1_INF)
        else:
            res.append((int.from_bytes(raw[96 * i:96 * i + 48], "big"),
                        int.from_bytes(raw[96 * i + 48:96 * (i + 1)], "big")))
    return res


def g1_in_subgroup_batch(points) -> list[int]:
    """G1 membership ([r]P == INF) of affine (x, y) int points, one native
    call: per point 1 (member), 0 (not) or -1 (a coordinate out of range)."""
    n = len(points)
    if n == 0:
        return []
    buf = b"".join(int(x).to_bytes(48, "big") + int(y).to_bytes(48, "big") for x, y in points)
    out = (ctypes.c_int8 * n)()
    _load().lhbls_g1_in_subgroup_batch(buf, n, out)
    return [int(v) for v in out]


def _lincomb_groups(fn, width: int, pts: bytes, scalars, groups, n_groups: int) -> list:
    """Per group the affine output row as a tuple of 48-byte ints, or None
    for the identity."""
    n = len(groups)
    garr = (ctypes.c_longlong * n)(*[int(g) for g in groups])
    sc = b"".join(int(k).to_bytes(32, "big") for k in scalars)
    out = ctypes.create_string_buffer(width * n_groups)
    flags = (ctypes.c_int8 * n_groups)()
    if fn(pts, sc, garr, n, n_groups, out, flags) != 0:
        raise ValueError("lincomb: a point coordinate or group id is out of range")
    raw = out.raw
    return [tuple(int.from_bytes(raw[width * g + k:width * g + k + 48], "big")
                  for k in range(0, width, 48)) if flags[g] else None
            for g in range(n_groups)]


def g1_lincomb_groups(points, scalars, groups, n_groups: int) -> list:
    """Segment-summed MSM on the host: out[g] = Σ_{i: groups[i] == g} k_i·P_i
    over affine G1 (x, y) int points and scalars < 2^256 -> per group an
    affine (x, y) or None (identity)."""
    pts = b"".join(int(x).to_bytes(48, "big") + int(y).to_bytes(48, "big") for x, y in points)
    return _lincomb_groups(_load().lhbls_g1_lincomb_groups, 96, pts, scalars, groups, n_groups)


def g2_lincomb_groups(points, scalars, groups, n_groups: int) -> list:
    """The G2 half: affine points ((x.a, x.b), (y.a, y.b)) as ints ->
    per group ((x.a, x.b), (y.a, y.b)) or None (identity)."""
    pts = b"".join(int(c).to_bytes(48, "big") for (xa, xb), (ya, yb) in points
                   for c in (xa, xb, ya, yb))
    rows = _lincomb_groups(_load().lhbls_g2_lincomb_groups, 192, pts, scalars, groups, n_groups)
    return [None if r is None else ((r[0], r[1]), (r[2], r[3])) for r in rows]


def fq12_bytes(f) -> bytes:
    """Python Fq12 -> 576 bytes, coefficients c0.c0.a, c0.c0.b, ... c1.c2.b,
    each big-endian 48 bytes (the layout of ``csrc/bls_host.cc``)."""
    return b"".join(c.to_bytes(48, "big")
                    for c6 in (f.c0, f.c1) for c2 in (c6.c0, c6.c1, c6.c2)
                    for c in (c2.a, c2.b))


def final_exp(f):
    """The (cubed) final exponentiation of a python Fq12, as python Fq12,
    with the verdict semantics of ``fields.final_exponentiation_fast``."""
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2, Fq6, Fq12

    out = ctypes.create_string_buffer(576)
    if _load().lhbls_final_exp(fq12_bytes(f), out) != 0:
        raise ValueError("non-canonical Fq12 input")
    v = [int.from_bytes(out.raw[48 * i:48 * (i + 1)], "big") for i in range(12)]

    def fq6(k):
        return Fq6(Fq2(v[k], v[k + 1]), Fq2(v[k + 2], v[k + 3]), Fq2(v[k + 4], v[k + 5]))

    return Fq12(fq6(0), fq6(6))


def final_exp_is_one(f) -> bool:
    """Whether the final exponentiation of a python Fq12 is one."""
    r = _load().lhbls_final_exp_is_one(fq12_bytes(f))
    if r < 0:
        raise ValueError("non-canonical Fq12 input")
    return bool(r)
