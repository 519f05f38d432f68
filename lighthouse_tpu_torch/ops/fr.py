"""BLS12-381 scalar field Fr and the KZG barycentric evaluation: the Fr core,
two kernel wrappers (``csrc/kzg.cu``) and their plain PyTorch versions.

Counterpart of ``lighthouse_tpu/ops/fr.py``.  The formats differ and only
canonical integers are compared between the two packages:

- JAX package: 18 x 15-bit redundant limbs, Montgomery radix 2^270;
- this port: 8 x 32-bit little-endian words, FULLY REDUCED in [0, r),
  Montgomery R = 2^256 (``bigint.MontField``; -r^-1 mod 2^32 = 0xFFFFFFFF,
  since r = 1 mod 2^32).

Kernels (launch counts on each wrapper's ``launches``):

- ``fr_to_mont_device`` (``k_fr_to_mont``) replaces ``lighthouse_tpu/ops/
  fr.py:332`` ``_TO_MONT_JIT``: one element per thread, its 32 big-endian
  bytes to words, then one Montgomery product by R² mod r.  Bound: bytes
  (32 in, 32 out against one 136-multiply-add product).
- ``eval_device`` (``k_fr_eval``) replaces ``lighthouse_tpu/ops/fr.py:297``
  ``_eval_kernel``: one block per blob.  Each thread takes a chunk of the
  domain, forms d = z - w_i and their running products (Montgomery's trick),
  a product tree over the block's chunk products in shared memory is
  inverted with ONE Fermat inversion per blob at its root and swept back
  down, then each thread recovers its d_i^-1, sums f_i·w_i·d_i^-1 and the
  block adds the sums; thread 0 scales by (z^W - 1)/W.  Any batch inversion
  gives the same canonical inverses, so the JAX product tree is not copied
  level by level.  Bound: Fr products (``eval_fr_muls``), 136 multiply-adds
  each.  A zero denominator (z on the domain) zeroes its blob's inverses:
  the row finishes with a wrong value and the caller overrides it on the
  host (``evaluate_polynomials_batch``), as the JAX package does.

On CPU tensors each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls_cuda

R_INT = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

FR = bi.MontField(R_INT, 8)
L = FR.L
RADIX = FR.R_INT                              # Montgomery radix 2^256
R2_INT = RADIX * RADIX % R_INT                # to_mont(x) = mont_mul(x, R²)

add = FR.add
sub = FR.sub
mont_mul = FR.mont_mul

# Fr products, counted from csrc/fr.cuh / csrc/kzg.cu (a CPU test builds the
# lane code with a counter and checks them).  One 8-word CIOS Montgomery
# product is 2·8² + 8 = 136 32-bit multiply-adds.
IMADS_PER_FR_MUL = 2 * L ** 2 + L
RM2_BITS = tuple(int(b) for b in bin(R_INT - 2)[2:])     # MSB first, 255 bits
FR_INV = len(RM2_BITS) + sum(RM2_BITS)                   # square and multiply
EVAL_MAX_THREADS = 256                         # threads per blob (k_fr_eval)
EVAL_MAX_CHUNK = 16                            # domain points per thread


# --------------------------------------------------------------------------
# host boundary
# --------------------------------------------------------------------------

def to_mont_host(v) -> np.ndarray:
    """Canonical int -> words uint32[8]; a sequence -> uint32[n, 8]."""
    if isinstance(v, (int, np.integer)):
        return FR.to_mont(int(v))
    return FR.ints_to_mont_limbs([int(x) for x in v])


def from_mont_host(words):
    """Montgomery words [8] -> int; [..., 8] -> object array of ints."""
    arr = np.asarray(words, np.uint32)
    if arr.ndim == 1:
        return FR.from_mont(arr)
    return np.array(FR.mont_limbs_to_ints(arr), dtype=object).reshape(arr.shape[:-1])


def be32_bytes_to_words(raw: np.ndarray) -> np.ndarray:
    """32-byte big-endian values [..., 32] -> raw (not Montgomery) words
    uint32[..., 8], little-endian word order (the port's counterpart of
    ``be32_bytes_to_limbs``)."""
    u8 = np.ascontiguousarray(np.asarray(raw, np.uint8))
    words = u8.view(">u4").reshape(u8.shape[:-1] + (L,))
    return np.ascontiguousarray(words[..., ::-1]).astype(np.uint32)


# --------------------------------------------------------------------------
# inversion (plain)
# --------------------------------------------------------------------------

def inv_mont(a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion a^(r-2) of Montgomery lanes (int64 words); 0 -> 0."""
    acc = FR.one_like(a)
    for bit in RM2_BITS:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


def batch_inv_mont(d: torch.Tensor) -> torch.Tensor:
    """Simultaneous inversion over axis -2 (a power of two) by a product
    tree: pairwise up-sweep, ONE Fermat inversion at the root, then the
    down-sweep inv(a) = b·inv(ab), inv(b) = a·inv(ab).  A zero lane zeroes
    every inverse of its tree."""
    levels = [d]
    cur = d
    while cur.shape[-2] > 1:
        cur = mont_mul(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    inv = inv_mont(cur)
    for lev in reversed(levels[:-1]):
        a, b = lev[..., 0::2, :], lev[..., 1::2, :]
        inv = torch.stack([mont_mul(b, inv), mont_mul(a, inv)], -2).reshape(lev.shape)
    return inv


# --------------------------------------------------------------------------
# row 16: raw -> Montgomery
# --------------------------------------------------------------------------

def fr_to_mont_plain(raw: torch.Tensor) -> torch.Tensor:
    """Plain version of ``k_fr_to_mont``: big-endian bytes uint8 [..., 32]
    -> Montgomery words int32 [..., 8] (x·R mod r; any 256-bit x)."""
    le = raw.to(torch.int64).flip(-1).unflatten(-1, (L, 4))
    words = le[..., 0] | (le[..., 1] << 8) | (le[..., 2] << 16) | (le[..., 3] << 24)
    r2 = torch.tensor(FR.int_to_words(R2_INT).astype(np.int64), device=raw.device)
    return bi.i32(mont_mul(words, r2))


def fr_to_mont_device(raw: torch.Tensor) -> torch.Tensor:
    """Raw field elements as big-endian bytes (uint8 [..., 32]) -> Montgomery
    words int32 [..., 8].  Replaces ``lighthouse_tpu/ops/fr.py:332``
    ``_TO_MONT_JIT``."""
    bls_cuda.check(raw, (32,), "fr_to_mont raw", dtype=torch.uint8)
    if raw.device.type == "cpu":
        return fr_to_mont_plain(raw)
    out = torch.empty(raw.shape[:-1] + (L,), dtype=torch.int32, device=raw.device)
    n = out.numel() // L
    if n:
        bls_cuda.launch("lh_fr_to_mont", raw, out, n, library="kzg")
        fr_to_mont_device.launches += 1
    return out


fr_to_mont_device.launches = 0


# --------------------------------------------------------------------------
# row 15: barycentric evaluation
# --------------------------------------------------------------------------

def eval_plain(f: torch.Tensor, z: torch.Tensor, roots: torch.Tensor,
               inv_w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``k_fr_eval`` (``_eval_kernel`` step for step):
    f [N, W, 8], z [N, 8], roots [W, 8], inv_w [1, 8] Montgomery words
    (int32) -> y [N, 8] with y_i = p_i(z_i)."""
    f, z, roots, inv_w = (bi.u64(t) for t in (f, z, roots, inv_w))
    n, w, _ = f.shape
    d = sub(z[:, None, :].expand(f.shape), roots[None].expand(f.shape))
    d_inv = batch_inv_mont(d)
    terms = mont_mul(mont_mul(f, roots[None]), d_inv)
    acc, k = terms, w
    while k > 1:
        k //= 2
        acc = add(acc[:, :k], acc[:, k:2 * k])
    total = acc[:, 0]
    zw = z
    for _ in range(w.bit_length() - 1):
        zw = mont_mul(zw, zw)
    factor = mont_mul(sub(zw, FR.one_like(zw)), inv_w)
    return bi.i32(mont_mul(total, factor))


def eval_threads(width: int) -> tuple[int, int]:
    """(threads per blob, domain points per thread) of ``k_fr_eval``."""
    threads = max(1, min(EVAL_MAX_THREADS, width // 16))
    chunk = width // threads
    if width & (width - 1) or chunk > EVAL_MAX_CHUNK:
        raise ValueError(f"fr_eval: width {width} must be a power of two up to "
                         f"{EVAL_MAX_THREADS * EVAL_MAX_CHUNK}")
    return threads, chunk


def eval_fr_muls(n_blobs: int, width: int) -> int:
    """Fr products of one ``k_fr_eval`` launch: per blob, 5 per domain point
    less 3 per thread (the running products, two backward products each and
    the two term products; products by one skipped), the tree's 3 per inner
    node, one Fermat inversion, log2(W) squarings and 2 for the scale."""
    threads, chunk = eval_threads(width)
    per_blob = (threads * (5 * chunk - 3) + 3 * (threads - 1) + FR_INV
                + width.bit_length() - 1 + 2)
    return n_blobs * per_blob


def eval_device(f: torch.Tensor, z: torch.Tensor, roots: torch.Tensor,
                inv_w: torch.Tensor) -> torch.Tensor:
    """Barycentric evaluation of N blobs at their challenges: f [N, W, 8],
    z [N, 8], roots [W, 8] (bit-reversed domain), inv_w [1, 8], Montgomery
    words (int32) -> y [N, 8].  A blob whose challenge is a domain point
    gets a wrong row (its inverses are zero); the caller overrides it.
    Replaces ``lighthouse_tpu/ops/fr.py:297`` ``_eval_kernel``."""
    for name, t in (("f", f), ("z", z), ("roots", roots), ("inv_w", inv_w)):
        bls_cuda.check(t, (L,), f"fr_eval {name}")
    dev = bls_cuda.same_device("fr_eval", f, z, roots, inv_w)
    n, w = f.shape[:2] if f.dim() == 3 else (-1, -1)
    if f.dim() != 3 or z.shape != (n, L) or roots.shape != (w, L) or inv_w.shape != (1, L):
        raise ValueError(f"fr_eval: shapes f {list(f.shape)}, z {list(z.shape)}, "
                         f"roots {list(roots.shape)}, inv_w {list(inv_w.shape)} do not agree")
    threads, chunk = eval_threads(w)
    if dev.type == "cpu":
        return eval_plain(f, z, roots, inv_w)
    y = torch.empty((n, L), dtype=torch.int32, device=dev)
    if n:
        bls_cuda.launch("lh_fr_eval", f, z, roots, inv_w, y, n, w, threads, library="kzg")
        eval_device.launches += 1
    return y


eval_device.launches = 0


def evaluate_polynomials_batch(raw: np.ndarray, zs: list[int], roots: list[int],
                               device) -> list[int]:
    """y_i = p_i(z_i) for every blob polynomial on ``device``: ``raw`` the
    blobs' field elements as big-endian bytes uint8 [N, W, 32] (canonical),
    ``zs`` the N challenges, ``roots`` the W bit-reversed roots of unity.
    Row 16 then row 15; a challenge on the domain takes the host override
    y = f at that root (the degenerate barycentric case)."""
    n, w, _ = raw.shape
    dev = torch.device(device)
    f_m = fr_to_mont_device(torch.from_numpy(np.require(raw, np.uint8, ["C", "W"])).to(dev))
    roots_m = bi.to_tensor(to_mont_host(roots), dev)
    zs_m = bi.to_tensor(to_mont_host(zs), dev)
    invw_m = bi.to_tensor(to_mont_host([pow(w, -1, R_INT)]), dev)
    ys = from_mont_host(bi.to_numpy(eval_device(f_m, zs_m, roots_m, invw_m)))
    root_pos = {int(v): k for k, v in enumerate(roots)}
    out = []
    for i in range(n):
        hit = root_pos.get(int(zs[i]))
        if hit is None:
            out.append(int(ys[i]))
        else:
            out.append(int.from_bytes(raw[i, hit].tobytes(), "big") % R_INT)
    return out


KERNELS = (fr_to_mont_device, eval_device)
