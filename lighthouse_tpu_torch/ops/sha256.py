"""Batched SHA-256 for SSZ merkleization: CUDA kernels and host helpers.

Port of ``lighthouse_tpu/ops/sha256.py``.  Every (left, right) node pair of
a tree level is one lane of a 64-byte SHA-256; three kernels of
``csrc/sha256.cu`` hash a batch of pairs, build every interior level of a
power-of-two tree, and fold a tree to its root.  A fourth runs one
compression per lane (``sha256_block``): the single-block messages of the
swap-or-not shuffle's source hashes (``sha256_msgs``).

Words are the JAX package's: uint32 SHA-256 words in big-endian order,
``uint32[N, 16]`` per pair batch and ``uint32[N, 8]`` per node.  Tensors
carry them as ``torch.int32`` with the same bits; numpy arrays as uint32.

Each kernel wrapper checks its input, allocates its output with
``torch.empty`` and, for a CUDA tensor, launches the kernel and counts the
launch on its ``launches`` attribute; for a CPU tensor it runs the plain
PyTorch version beside it.  Small trees and levels stay on the host
(hashlib) below the same static routing thresholds as the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch

from lighthouse_tpu_torch.native import build_cuda_lib

# FIPS 180-4 round constants and initial state.
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)
_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)
_M32 = 0xFFFFFFFF


def _py_rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _np_schedule(block: np.ndarray) -> np.ndarray:
    """Host-side message-schedule expansion (for the constant padding block)."""
    w = [int(v) for v in block]
    for t in range(16, 64):
        s0 = _py_rotr(w[t - 15], 7) ^ _py_rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _py_rotr(w[t - 2], 17) ^ _py_rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    return np.array(w, dtype=np.uint32)


# Padding block for a message of exactly 64 bytes: 0x80 then zeros, bit length
# 512 in the final 64-bit field.  Its schedule is message-independent
# (csrc/sha256.cu keeps the same table in __constant__ memory).
_PAD_BLOCK = np.zeros(16, dtype=np.uint32)
_PAD_BLOCK[0] = 0x80000000
_PAD_BLOCK[15] = 512
_PAD_W = _np_schedule(_PAD_BLOCK)  # uint32[64]

# Least int32 operations per 64-byte pair hash in sm_90 instructions (see
# csrc/sha256.cu): 2 compressions x (64 rounds x 14 + 8) + 48 schedule words x 10.
OPS_PER_PAIR = 2 * (64 * 14 + 8) + 48 * 10
# ... and per single-block compression (``sha256_block``): one compression
# and its 48 extended schedule words.
OPS_PER_BLOCK = 64 * 14 + 8 + 48 * 10


# --------------------------------------------------------------------------
# numpy <-> tensor words
# --------------------------------------------------------------------------

def to_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words (numpy) -> int32 tensor of the same bits on ``device``
    (a copy: it never shares memory with ``words``)."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    if device.type == "cpu" or not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor of word bits -> uint32 numpy array on the host (a copy)."""
    return words.to("cpu", copy=True).numpy().view(np.uint32)


# --------------------------------------------------------------------------
# Plain PyTorch versions (int64 lanes masked to 32 bits: torch has no
# unsigned 32-bit arithmetic and int32 >> is arithmetic)
# --------------------------------------------------------------------------

def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: list[torch.Tensor], kw) -> list[torch.Tensor]:
    """64 rounds; kw(t) gives K[t] + W[t] (tensor or int)."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + kw(t)
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _data_kw(block: torch.Tensor):
    """kw(t) = K[t] + W[t] of int64 data blocks [N, 16], the schedule
    expanded in a rolling 16-word window."""
    w = [block[:, i] for i in range(16)]

    def kw(t: int):
        if t >= 16:
            w15, w2 = w[(t + 1) % 16], w[(t + 14) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[t % 16] = (w[t % 16] + s0 + w[(t + 9) % 16] + s1) & _M32
        return w[t % 16] + int(_K[t])

    return kw


def _int32_words(words: list[torch.Tensor]) -> torch.Tensor:
    """Eight int64 lanes of 32-bit values -> int32[N, 8] of the same bits."""
    out64 = torch.stack(words, dim=1)
    return ((out64 ^ 0x80000000) - 0x80000000).to(torch.int32)


def hash_pairs_plain(pairs: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``hash_pairs`` kernel: int32[N, 16] -> int32[N, 8]."""
    x = pairs.to(torch.int64) & _M32
    h0 = [torch.full((x.shape[0],), int(v), dtype=torch.int64, device=x.device)
          for v in _H0]
    mid = _compress(h0, _data_kw(x))
    return _int32_words(_compress(mid, lambda t: int(_K[t]) + int(_PAD_W[t])))


def sha256_block_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``sha256_block`` kernel: one compression per
    lane, int32[N, 8] chaining state and int32[N, 16] block -> int32[N, 8]."""
    st = state.to(torch.int64) & _M32
    kw = _data_kw(block.to(torch.int64) & _M32)
    return _int32_words(_compress([st[:, i] for i in range(8)], kw))


def fold_levels_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fold_levels``: int32[n, 8] -> int32[n - 1, 8]."""
    levels, x = [], leaves
    while x.shape[0] > 1:
        x = hash_pairs_plain(x.reshape(-1, 16))
        levels.append(x)
    if not levels:
        return leaves.new_empty((0, 8))
    return torch.cat(levels)


def fold_to_root_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fold_to_root``: int32[n, 8] -> int32[1, 8]."""
    x = leaves
    while x.shape[0] > 1:
        x = hash_pairs_plain(x.reshape(-1, 16))
    return x.clone()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = build_cuda_lib("sha256")
    if lib.lh_hash_pairs.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.lh_hash_pairs.argtypes = [ptr, ptr, i64, ptr]
        lib.lh_fold_levels.argtypes = [ptr, ptr, i64, ptr]
        lib.lh_fold_subtrees.argtypes = [ptr, ptr, ptr, i64, ptr]
        lib.lh_sha256_block.argtypes = [ptr, ptr, ptr, i64, ptr]
        for fn in (lib.lh_hash_pairs, lib.lh_fold_levels, lib.lh_fold_subtrees,
                   lib.lh_sha256_block):
            fn.restype = ctypes.c_int
        lib.lh_fold_plan.argtypes = [i64, ptr]
        lib.lh_fold_plan.restype = None
        lib.lh_error_string.argtypes = [ctypes.c_int]
        lib.lh_error_string.restype = ctypes.c_char_p
    return lib


def _check_words(x: torch.Tensor, width: int, name: str, *, pow2: bool = False) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 word bits, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{name}: expected shape [N, {width}], got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    n = x.shape[0]
    if pow2 and (n < 1 or n & (n - 1)):
        raise ValueError(f"{name}: leaf count {n} is not a power of two")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be 16-byte aligned")


def _launch(fn_name: str, *args) -> None:
    lib = _lib()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name}: CUDA error {rc}: {lib.lh_error_string(rc).decode()}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def hash_pairs_device(pairs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N 64-byte messages: int32[N, 16] (left || right node) ->
    int32[N, 8].  Replaces ``lighthouse_tpu/ops/sha256.py:167``; any N."""
    _check_words(pairs, 16, "hash_pairs")
    if pairs.device.type == "cpu":
        return hash_pairs_plain(pairs)
    out = torch.empty((pairs.shape[0], 8), dtype=torch.int32, device=pairs.device)
    if pairs.shape[0]:
        with torch.cuda.device(pairs.device):
            _launch("lh_hash_pairs", pairs.data_ptr(), out.data_ptr(),
                    pairs.shape[0], _stream(pairs))
        hash_pairs_device.launches += 1
    return out


def fold_levels_device(leaves: torch.Tensor) -> torch.Tensor:
    """Every interior level of a tree of n leaves (n a power of two):
    int32[n, 8] -> int32[n - 1, 8], level 1 (n/2 rows) first, the root last.
    Replaces ``lighthouse_tpu/ops/sha256.py:196``: one launch per level into
    one buffer, with no host synchronisation between levels."""
    _check_words(leaves, 8, "fold_levels", pow2=True)
    if leaves.device.type == "cpu":
        return fold_levels_plain(leaves)
    n = leaves.shape[0]
    out = torch.empty((n - 1, 8), dtype=torch.int32, device=leaves.device)
    if n > 1:
        with torch.cuda.device(leaves.device):
            _launch("lh_fold_levels", leaves.data_ptr(), out.data_ptr(), n,
                    _stream(leaves))
        fold_levels_device.launches += n.bit_length() - 1
        fold_levels_device.calls += 1
    return out


@functools.lru_cache(maxsize=None)
def fold_plan(n: int) -> dict:
    """``k_fold_subtrees``' layout for a tree of n leaves: leaves a thread,
    threads a block, blocks, and the most leaves one launch folds."""
    plan = (ctypes.c_longlong * 4)()
    _lib().lh_fold_plan(n, plan)
    return dict(zip(("per", "threads", "blocks", "capacity"), plan))


def fold_to_root_device(leaves: torch.Tensor) -> torch.Tensor:
    """Whole-tree fold: int32[n, 8] (n a power of two) -> int32[1, 8].
    Replaces ``lighthouse_tpu/ops/sha256.py:410``: one launch; each thread
    folds 2 to 32 leaves (``fold_plan``), each block its threads' subroots,
    and the last block to finish the block roots (``csrc/sha256.cu``); a
    tree past one launch's capacity (2^26 leaves) raises."""
    _check_words(leaves, 8, "fold_to_root", pow2=True)
    if leaves.device.type == "cpu":
        return fold_to_root_plain(leaves)
    n = leaves.shape[0]
    if n == 1:
        return leaves.clone()
    with torch.cuda.device(leaves.device):
        plan = fold_plan(n)
        if n > plan["capacity"]:
            raise ValueError(f"fold_to_root: {n} leaves exceed one launch's "
                             f"{plan['capacity']}")
        # the root, then the block roots and the last block's counter
        buf = torch.empty(8 * (plan["blocks"] + 1) + 1, dtype=torch.int32, device=leaves.device)
        _launch("lh_fold_subtrees", leaves.data_ptr(), buf.data_ptr(), buf.data_ptr() + 32, n,
                _stream(leaves))
    fold_to_root_device.launches += 1
    fold_to_root_device.calls += 1
    return buf[:8].view(1, 8)


def sha256_block_device(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression per lane: int32[N, 8] chaining state and
    int32[N, 16] message block -> int32[N, 8].  Replaces
    ``lighthouse_tpu/ops/sha256.py:157``; any N (no power-of-two padding)."""
    _check_words(state, 8, "sha256_block state")
    _check_words(block, 16, "sha256_block block")
    if state.shape[0] != block.shape[0] or state.device != block.device:
        raise ValueError(f"sha256_block: state {list(state.shape)} on {state.device} and "
                         f"block {list(block.shape)} on {block.device} do not pair up")
    if block.device.type == "cpu":
        return sha256_block_plain(state, block)
    out = torch.empty_like(state)
    if block.shape[0]:
        with torch.cuda.device(block.device):
            _launch("lh_sha256_block", state.data_ptr(), block.data_ptr(), out.data_ptr(),
                    block.shape[0], _stream(block))
        sha256_block_device.launches += 1
    return out


# the merkle kernels of the state root; ``sha256_block_device`` (the
# shuffle's source hashes) counts its launches beside them
KERNELS = (hash_pairs_device, fold_levels_device, fold_to_root_device)


def reset_launches() -> None:
    for k in KERNELS + (sha256_block_device,):
        k.launches = 0
    fold_levels_device.calls = fold_to_root_device.calls = 0


reset_launches()


# --------------------------------------------------------------------------
# Host hashing and byte <-> word helpers
# --------------------------------------------------------------------------

def hash_pairs_np(pairs: np.ndarray) -> np.ndarray:
    """Host pair hashing with hashlib: uint32[N, 16] -> uint32[N, 8]."""
    n = pairs.shape[0]
    data = np.ascontiguousarray(pairs, dtype=np.uint32).astype(">u4").tobytes()
    digests = b"".join(hashlib.sha256(data[64 * i: 64 * (i + 1)]).digest()
                       for i in range(n))
    return np.frombuffer(digests, dtype=">u4").astype(np.uint32).reshape(n, 8)


def chunks_to_words(data: bytes) -> np.ndarray:
    """bytes (len % 32 == 0) -> uint32[n_chunks, 8] in SHA-256 word order."""
    if len(data) % 32:
        raise ValueError("chunk data must be a multiple of 32 bytes")
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def words_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def _zero_hash_ladder(depth: int = 64) -> list[bytes]:
    zh = [b"\x00" * 32]
    for _ in range(depth):
        zh.append(hashlib.sha256(zh[-1] + zh[-1]).digest())
    return zh


ZERO_HASHES: list[bytes] = _zero_hash_ladder()
ZERO_HASH_WORDS: np.ndarray = np.stack(
    [np.frombuffer(h, dtype=">u4").astype(np.uint32) for h in ZERO_HASHES]
)


# --------------------------------------------------------------------------
# Merkleization
# --------------------------------------------------------------------------

# Static routing thresholds of the JAX package: a level with fewer pairs,
# or a fold with fewer leaves, stays on the host (hashlib).  Tests lower
# them to reach the tensor path at small sizes.
_DEVICE_MIN_PAIRS = 2048
_DEVICE_FOLD_MIN_LEAVES = 1 << 12


def batch_hash_pairs(pairs: np.ndarray, *, device: torch.device) -> np.ndarray:
    """Batched pair hash: uint32[N, 16] -> uint32[N, 8], on ``device`` from
    ``_DEVICE_MIN_PAIRS`` pairs up, with hashlib below."""
    if pairs.shape[0] >= _DEVICE_MIN_PAIRS:
        return to_numpy(hash_pairs_device(to_tensor(pairs, device)))
    return hash_pairs_np(pairs)


def sha256_msgs(msgs: np.ndarray, *, device: torch.device) -> np.ndarray:
    """SHA-256 of N equal-length short messages: uint8[N, L] -> uint8[N, 32],
    L <= 55, so each message pads into one 64-byte block on the host.

    Batches of at least ``_DEVICE_MIN_PAIRS`` messages are one
    ``sha256_block`` call on ``device``; smaller ones hash with hashlib.
    That is the JAX package's routing by size, not a fallback: the kernel
    never hands a batch to the host."""
    n, length = msgs.shape
    if length > 55:
        raise ValueError("sha256_msgs handles single-block messages only")
    if n < _DEVICE_MIN_PAIRS:
        data = np.ascontiguousarray(msgs, dtype=np.uint8)
        out = np.empty((n, 32), dtype=np.uint8)
        for i in range(n):
            out[i] = np.frombuffer(hashlib.sha256(data[i].tobytes()).digest(), np.uint8)
        return out
    state = to_tensor(np.broadcast_to(_H0, (n, 8)), device)
    block = to_tensor(single_block_words(msgs), device)
    digest = to_numpy(sha256_block_device(state, block))
    return digest.astype(">u4").view(np.uint8).reshape(n, 32)


def single_block_words(msgs: np.ndarray) -> np.ndarray:
    """uint8[N, L] messages, L <= 55, each padded into its one SHA-256
    block: uint32[N, 16] big-endian words (0x80, zeros, the bit length)."""
    n, length = msgs.shape
    if length > 55:
        raise ValueError(f"a {length}-byte message does not fit one SHA-256 block")
    blocks = np.zeros((n, 64), dtype=np.uint8)
    blocks[:, :length] = msgs
    blocks[:, length] = 0x80
    blocks[:, 56:64] = np.frombuffer((length * 8).to_bytes(8, "big"), np.uint8)
    return blocks.view(">u4").astype(np.uint32)


def fold_levels(leaves: torch.Tensor) -> list[torch.Tensor]:
    """Build every interior level of a power-of-two-leaf merkle tree on the
    leaves' device: int32[n, 8] -> [level1, ..., root], level k with n/2^k
    rows, all views of the one buffer the fold-levels kernel fills."""
    buf = fold_levels_device(leaves)
    levels, start, size = [], 0, leaves.shape[0] // 2
    while size >= 1:
        levels.append(buf[start:start + size])
        start += size
        size //= 2
    return levels


def merkleize_words(leaves: np.ndarray, limit: int | None = None, *,
                    device: torch.device) -> np.ndarray:
    """SSZ merkleize: uint32[n, 8] leaf chunks -> uint32[8] root.

    Pads the leaf count to the next power of two (or to ``limit``) with the
    zero-subtree ladder.  Trees of at least ``_DEVICE_FOLD_MIN_LEAVES``
    leaves fold on ``device`` in one call; smaller ones level by level."""
    n = leaves.shape[0]
    size = max(limit if limit is not None else n, 1)
    depth = max(size - 1, 0).bit_length()
    if limit is not None and n > limit:
        raise ValueError(f"{n} leaves exceed limit {limit}")
    if n == 0:
        return ZERO_HASH_WORDS[depth].copy()

    level = np.ascontiguousarray(leaves, dtype=np.uint32)
    n_pow2 = 1 << max(n - 1, 0).bit_length()
    if n_pow2 >= _DEVICE_FOLD_MIN_LEAVES:
        # one whole-fold call (padding the leaf level with zero chunks is
        # ladder-equivalent), then the rest of the zero-subtree ladder on
        # the host
        if n_pow2 != n:
            level = np.concatenate(
                [level, np.zeros((n_pow2 - n, 8), np.uint32)])
        node = to_numpy(fold_to_root_device(to_tensor(level, device)))[0]
        for dd in range(n_pow2.bit_length() - 1, depth):
            pair = np.concatenate([node, ZERO_HASH_WORDS[dd]])[None, :]
            node = hash_pairs_np(pair)[0]
        return node
    for d in range(depth):
        if level.shape[0] % 2:
            level = np.concatenate([level, ZERO_HASH_WORDS[d][None]], axis=0)
        pairs = level.reshape(level.shape[0] // 2, 16)
        level = batch_hash_pairs(pairs, device=device)
        # entirely-zero right subtrees above the data fold with the ladder
        # once a single node remains
        if level.shape[0] == 1 and d + 1 < depth:
            node = level[0]
            for dd in range(d + 1, depth):
                pair = np.concatenate([node, ZERO_HASH_WORDS[dd]])[None, :]
                node = hash_pairs_np(pair)[0]
            return node
    return level[0]


def _merkleize_small(data: bytes, limit: int | None) -> bytes:
    """Scalar hashlib fold for tiny trees (containers of <= 16 chunks)."""
    n_chunks = max(len(data) // 32, 1)
    if limit is not None and len(data) // 32 > limit:
        raise ValueError(f"{len(data) // 32} leaves exceed limit {limit}")
    n_leaves = max(limit if limit is not None else n_chunks, 1)
    depth = max(n_leaves - 1, 0).bit_length()
    nodes = [data[i:i + 32] for i in range(0, len(data), 32)] or [b"\x00" * 32]
    for d in range(depth):
        nxt = []
        for i in range(0, len(nodes), 2):
            left = nodes[i]
            right = nodes[i + 1] if i + 1 < len(nodes) else ZERO_HASHES[d]
            nxt.append(hashlib.sha256(left + right).digest())
        nodes = nxt
    return nodes[0]


def merkleize(data: bytes, limit: int | None = None, *,
              device: torch.device) -> bytes:
    """SSZ merkleize over packed 32-byte chunks -> 32-byte root."""
    if len(data) % 32:
        data = data + b"\x00" * (32 - len(data) % 32)
    if len(data) <= 512 and (limit is None or limit <= 16):
        return _merkleize_small(data, limit)
    leaves = chunks_to_words(data) if data else np.zeros((0, 8), np.uint32)
    return words_to_bytes(merkleize_words(leaves, limit, device=device))


def mix_in_length(root: bytes, length: int) -> bytes:
    return hashlib.sha256(root + length.to_bytes(32, "little")).digest()
