"""Columnar (struct-of-arrays) state collections.

Port of ``lighthouse_tpu/types/registry.py``.  The validator registry,
balances, participation flags and inactivity scores stay flat numpy
columns, so serialization matches the JAX package byte for byte; their
leaf chunk words are packed on the host and cross to the device, where the
merkle levels run through the SHA-256 kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from lighthouse_tpu_torch.device import resolve_device
from lighthouse_tpu_torch.ops import sha256 as sha_ops
from lighthouse_tpu_torch.ssz.core import SSZType, _batch_merkleize_subtrees
from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH


def _words(chunks: np.ndarray) -> np.ndarray:
    """uint8[N, 32] chunk bytes -> uint32[N, 8] SHA-256 words."""
    return chunks.view(">u4").astype(np.uint32).reshape(-1, 8)


def u64_chunk_words(arr: np.ndarray) -> np.ndarray:
    """uint64[N] -> uint32[N, 8]: one chunk per value (LE value in the
    first 8 bytes, BE word order), as a validator field root."""
    n = arr.shape[0]
    chunk = np.zeros((n, 32), dtype=np.uint8)
    chunk[:, :8] = np.asarray(arr, dtype="<u8").view(np.uint8).reshape(n, 8)
    return _words(chunk)


def bytes_chunk_words(col: np.ndarray) -> np.ndarray:
    """uint8[N, width <= 32] -> uint32[N, 8], zero-padded chunks."""
    n, width = col.shape
    chunk = np.zeros((n, 32), dtype=np.uint8)
    chunk[:, :width] = col
    return _words(chunk)


def packed_words(raw: np.ndarray, per_chunk: int) -> np.ndarray:
    """A packed basic column (uint64 or uint8 values, ``per_chunk`` to a
    chunk) -> uint32[ceil(n / per_chunk), 8] leaf words, zero-padded."""
    n = raw.shape[0]
    n_chunks = (n + per_chunk - 1) // per_chunk
    padded = np.zeros(n_chunks * per_chunk, dtype=raw.dtype)
    padded[:n] = raw
    return padded.view(np.uint8).view(">u4").astype(np.uint32).reshape(n_chunks, 8)


def roots_words(arr: np.ndarray) -> np.ndarray:
    """uint8[N, 32] roots -> uint32[N, 8] leaf words."""
    return _words(np.ascontiguousarray(arr, dtype=np.uint8))


class U64List(SSZType):
    """SSZ List[uint64, limit] stored as a numpy uint64 column."""

    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def _as_array(self, value) -> np.ndarray:
        arr = np.asarray(value, dtype=np.uint64)
        if arr.ndim != 1:
            raise ValueError("U64List expects a 1-D sequence")
        if arr.shape[0] > self.limit:
            raise ValueError(f"U64List over limit {self.limit}")
        return arr

    def serialize(self, value) -> bytes:
        return self._as_array(value).astype("<u8").tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        if len(data) % 8:
            raise ValueError("u64 list misalignment")
        arr = np.frombuffer(data, dtype="<u8").astype(np.uint64)
        if arr.shape[0] > self.limit:
            raise ValueError("U64List over limit")
        return arr

    def chunk_count(self) -> int:
        return (self.limit * 8 + 31) // 32

    def leaf_words(self, value) -> np.ndarray:
        return packed_words(self._as_array(value).astype("<u8"), 4)

    def hash_tree_root(self, value, device=None) -> bytes:
        device = resolve_device(device)
        root = sha_ops.merkleize_words(self.leaf_words(value), self.chunk_count(),
                                       device=device)
        return sha_ops.mix_in_length(sha_ops.words_to_bytes(root), len(value))

    def default(self) -> np.ndarray:
        return np.zeros(0, dtype=np.uint64)

    def __repr__(self):
        return f"U64List[{self.limit}]"


class U64Vector(SSZType):
    """SSZ Vector[uint64, length] as a numpy column (e.g. slashings)."""

    def __init__(self, length: int):
        self.length = length
        self.fixed_size = 8 * length

    def _as_array(self, value) -> np.ndarray:
        arr = np.asarray(value, dtype=np.uint64)
        if arr.shape != (self.length,):
            raise ValueError(f"U64Vector length {self.length} mismatch")
        return arr

    def serialize(self, value) -> bytes:
        return self._as_array(value).astype("<u8").tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        if len(data) != self.fixed_size:
            raise ValueError("U64Vector size mismatch")
        return np.frombuffer(data, dtype="<u8").astype(np.uint64)

    def chunk_count(self) -> int:
        return (self.length * 8 + 31) // 32

    def leaf_words(self, value) -> np.ndarray:
        return packed_words(self._as_array(value).astype("<u8"), 4)

    def hash_tree_root(self, value, device=None) -> bytes:
        return sha_ops.words_to_bytes(sha_ops.merkleize_words(
            self.leaf_words(value), self.chunk_count(),
            device=resolve_device(device)))

    def default(self) -> np.ndarray:
        return np.zeros(self.length, dtype=np.uint64)

    def __repr__(self):
        return f"U64Vector[{self.length}]"


class U8List(SSZType):
    """SSZ List[uint8, limit] as a numpy column (participation flags)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def _as_array(self, value) -> np.ndarray:
        arr = np.asarray(value, dtype=np.uint8)
        if arr.shape[0] > self.limit:
            raise ValueError("U8List over limit")
        return arr

    def serialize(self, value) -> bytes:
        return self._as_array(value).tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        if len(data) > self.limit:
            raise ValueError("U8List over limit")
        return np.frombuffer(data, dtype=np.uint8).copy()

    def chunk_count(self) -> int:
        return (self.limit + 31) // 32

    def leaf_words(self, value) -> np.ndarray:
        return packed_words(self._as_array(value), 32)

    def hash_tree_root(self, value, device=None) -> bytes:
        device = resolve_device(device)
        root = sha_ops.merkleize_words(self.leaf_words(value), self.chunk_count(),
                                       device=device)
        return sha_ops.mix_in_length(sha_ops.words_to_bytes(root), len(value))

    def default(self) -> np.ndarray:
        return np.zeros(0, dtype=np.uint8)

    def __repr__(self):
        return f"U8List[{self.limit}]"


class RootsVector(SSZType):
    """SSZ Vector[Bytes32, length] as uint8[length, 32] (block/state roots,
    randao mixes)."""

    def __init__(self, length: int):
        self.length = length
        self.fixed_size = 32 * length

    def _as_array(self, value) -> np.ndarray:
        if isinstance(value, np.ndarray):
            arr = value
        else:
            arr = np.frombuffer(b"".join(value), dtype=np.uint8).reshape(-1, 32)
        if arr.shape != (self.length, 32):
            raise ValueError(f"RootsVector shape {arr.shape} != ({self.length}, 32)")
        return np.ascontiguousarray(arr, dtype=np.uint8)

    def serialize(self, value) -> bytes:
        return self._as_array(value).tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        if len(data) != self.fixed_size:
            raise ValueError("RootsVector size mismatch")
        return np.frombuffer(data, dtype=np.uint8).reshape(self.length, 32).copy()

    def chunk_count(self) -> int:
        return self.length

    def leaf_words(self, value) -> np.ndarray:
        return roots_words(self._as_array(value))

    def hash_tree_root(self, value, device=None) -> bytes:
        return sha_ops.words_to_bytes(sha_ops.merkleize_words(
            self.leaf_words(value), self.length, device=resolve_device(device)))

    def default(self) -> np.ndarray:
        return np.zeros((self.length, 32), dtype=np.uint8)

    def __repr__(self):
        return f"RootsVector[{self.length}]"


class RootsList(SSZType):
    """SSZ List[Bytes32, limit] as uint8[n, 32] (historical roots)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def _as_array(self, value) -> np.ndarray:
        if isinstance(value, np.ndarray):
            arr = value.reshape(-1, 32)
        elif len(value) == 0:
            arr = np.zeros((0, 32), dtype=np.uint8)
        else:
            arr = np.frombuffer(b"".join(value), dtype=np.uint8).reshape(-1, 32)
        if arr.shape[0] > self.limit:
            raise ValueError("RootsList over limit")
        return np.ascontiguousarray(arr, dtype=np.uint8)

    def serialize(self, value) -> bytes:
        return self._as_array(value).tobytes()

    def deserialize(self, data: bytes) -> np.ndarray:
        if len(data) % 32:
            raise ValueError("RootsList misalignment")
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32).copy()

    def chunk_count(self) -> int:
        return self.limit

    def leaf_words(self, value) -> np.ndarray:
        return roots_words(self._as_array(value))

    def hash_tree_root(self, value, device=None) -> bytes:
        device = resolve_device(device)
        words = self.leaf_words(value)
        root = sha_ops.merkleize_words(words, self.limit, device=device)
        return sha_ops.mix_in_length(sha_ops.words_to_bytes(root), words.shape[0])

    def default(self) -> np.ndarray:
        return np.zeros((0, 32), dtype=np.uint8)

    def __repr__(self):
        return f"RootsList[{self.limit}]"


# ---------------------------------------------------------------------------
# Validator registry
# ---------------------------------------------------------------------------

_VALIDATOR_RECORD_SIZE = 48 + 32 + 8 + 1 + 8 * 4  # = 121 bytes, SSZ field order
_EPOCH_COLUMNS = ("activation_eligibility_epoch", "activation_epoch",
                  "exit_epoch", "withdrawable_epoch")


class Validators:
    """Columnar validator registry (mutable, numpy-backed).  Element and
    mask writes go through the column arrays; whole-column assignment must
    keep the column's shape."""

    _COLUMNS = ("pubkeys", "withdrawal_credentials", "effective_balance",
                "slashed") + _EPOCH_COLUMNS

    __slots__ = tuple("_" + c for c in _COLUMNS)

    def __init__(self, n: int = 0):
        self._pubkeys = np.zeros((n, 48), dtype=np.uint8)
        self._withdrawal_credentials = np.zeros((n, 32), dtype=np.uint8)
        self._effective_balance = np.zeros(n, dtype=np.uint64)
        self._slashed = np.zeros(n, dtype=bool)
        for c in _EPOCH_COLUMNS:
            setattr(self, "_" + c, np.zeros(n, dtype=np.uint64))

    @classmethod
    def from_columns(cls, columns: dict[str, np.ndarray]) -> "Validators":
        """A registry holding ``columns`` as they are (no copy)."""
        out = cls.__new__(cls)
        for c in cls._COLUMNS:
            setattr(out, "_" + c, columns[c])
        return out

    def __len__(self) -> int:
        return self._effective_balance.shape[0]

    def copy(self) -> "Validators":
        return Validators.from_columns({c: getattr(self, c).copy() for c in self._COLUMNS})

    def __eq__(self, other) -> bool:
        return isinstance(other, Validators) and all(
            np.array_equal(getattr(self, f), getattr(other, f)) for f in self._COLUMNS)

    def is_active(self, epoch: int) -> np.ndarray:
        """bool[n]: the spec's ``is_active_validator`` at ``epoch``, per row."""
        e = np.uint64(epoch)
        return (self.activation_epoch <= e) & (e < self.exit_epoch)

    def is_eligible_for_activation_queue(self, max_effective_balance: int) -> np.ndarray:
        """bool[n]: not yet queued and at the maximum effective balance."""
        return ((self.activation_eligibility_epoch == np.uint64(FAR_FUTURE_EPOCH))
                & (self.effective_balance == np.uint64(max_effective_balance)))


def _column_property(col: str) -> property:
    backing = "_" + col

    def get(self):
        return getattr(self, backing)

    def set_(self, value):
        current = getattr(self, backing)
        arr = np.asarray(value, dtype=current.dtype)
        if arr.shape != current.shape:
            raise ValueError(f"{col}: column assignment must keep shape "
                             f"{current.shape}, got {arr.shape}")
        current[...] = arr

    return property(get, set_)


for _c in Validators._COLUMNS:
    setattr(Validators, _c, _column_property(_c))


class ValidatorRegistryType(SSZType):
    """SSZ List[Validator, limit] over the columnar ``Validators`` store."""

    def __init__(self, limit: int):
        self.limit = limit
        self.fixed_size = None

    def serialize(self, value: Validators) -> bytes:
        n = len(value)
        rec = np.zeros((n, _VALIDATOR_RECORD_SIZE), dtype=np.uint8)
        rec[:, 0:48] = value.pubkeys
        rec[:, 48:80] = value.withdrawal_credentials
        rec[:, 80:88] = value.effective_balance.astype("<u8").view(np.uint8).reshape(n, 8)
        rec[:, 88] = value.slashed.astype(np.uint8)
        off = 89
        for c in _EPOCH_COLUMNS:
            rec[:, off: off + 8] = getattr(value, c).astype("<u8").view(np.uint8).reshape(n, 8)
            off += 8
        return rec.tobytes()

    def deserialize(self, data: bytes) -> Validators:
        if len(data) % _VALIDATOR_RECORD_SIZE:
            raise ValueError("validator record misalignment")
        n = len(data) // _VALIDATOR_RECORD_SIZE
        if n > self.limit:
            raise ValueError("registry over limit")
        rec = np.frombuffer(data, dtype=np.uint8).reshape(n, _VALIDATOR_RECORD_SIZE)
        if (rec[:, 88] > 1).any():
            raise ValueError("invalid slashed boolean")

        def u64(off):
            return rec[:, off: off + 8].copy().view("<u8").reshape(n).astype(np.uint64)

        cols = {"pubkeys": rec[:, 0:48].copy(),
                "withdrawal_credentials": rec[:, 48:80].copy(),
                "effective_balance": u64(80),
                "slashed": rec[:, 88] == 1}
        for i, c in enumerate(_EPOCH_COLUMNS):
            cols[c] = u64(89 + 8 * i)
        return Validators.from_columns(cols)

    def chunk_count(self) -> int:
        return self.limit

    def batch_roots(self, value: Validators, device: torch.device) -> np.ndarray:
        """All validator roots as one lockstep merkleization on ``device``."""
        n = len(value)
        if n == 0:
            return np.zeros((0, 8), dtype=np.uint32)
        # the pubkey (48 bytes) root is one pre-hash of its 2 chunks
        pk = np.zeros((n, 64), dtype=np.uint8)
        pk[:, :48] = value.pubkeys
        pk_pairs = pk.view(">u4").astype(np.uint32)
        leaves = np.zeros((n, 8, 8), dtype=np.uint32)
        leaves[:, 0] = sha_ops.batch_hash_pairs(pk_pairs, device=device)
        leaves[:, 1] = bytes_chunk_words(value.withdrawal_credentials)
        leaves[:, 2] = u64_chunk_words(value.effective_balance)
        leaves[:, 3] = bytes_chunk_words(value.slashed.astype(np.uint8).reshape(n, 1))
        for i, c in enumerate(_EPOCH_COLUMNS):
            leaves[:, 4 + i] = u64_chunk_words(getattr(value, c))
        return _batch_merkleize_subtrees(leaves, device)

    def hash_tree_root(self, value: Validators, device=None) -> bytes:
        device = resolve_device(device)
        roots = self.batch_roots(value, device)
        root = sha_ops.merkleize_words(roots, self.limit, device=device)
        return sha_ops.mix_in_length(sha_ops.words_to_bytes(root), len(value))

    def default(self) -> Validators:
        return Validators(0)

    def __repr__(self):
        return f"ValidatorRegistry[{self.limit}]"
